"""The port's ``CheckpointManager`` against the reference's: the twins of
``tests/test_infra.py``'s checkpoint tests, and checkpoints that cross
between the packages in both directions (the same npz format: ``leaf_i`` in
sorted-key flatten order, bf16 upcast to float32), on the CPU.

Tolerances: a restored leaf equals the saved one bit for bit (float32
stores bf16 exactly); the resume twin keeps the reference's atol 1e-6 and,
the port's CPU steps being deterministic, also expects equal bits.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.configs import get_config as ref_config
from repro.optim.adamw import OptConfig as RefOptConfig
from repro.train import step as rstep
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.checkpoint import host_copy
from repro_torch.configs import get_config
from repro_torch.convert import train_state_from_numpy, train_state_to_numpy
from repro_torch.models.params import ParamTree, leaves, tree_leaves
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.step import (TrainSpec, init_train_state, make_train_step,
                                    microbatch_reshape)

torch.set_num_threads(1)


def test_checkpoint_roundtrip(tmp_path):
    """Twin of ``tests/test_infra.py::test_checkpoint_roundtrip``."""
    state = {"w": torch.arange(12.0).reshape(3, 4), "step": torch.tensor(7)}
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    mgr.save(1, state, extra={"step": 1})
    mgr.save(2, {k: v + 1 for k, v in state.items()}, extra={"step": 2})
    mgr.save(3, {k: v + 2 for k, v in state.items()}, extra={"step": 3})
    assert mgr.all_steps() == [2, 3]  # keep-last-2 GC
    restored, extra = mgr.restore(state)
    assert extra["step"] == 3
    np.testing.assert_allclose(restored["w"].numpy(), np.arange(12.0).reshape(3, 4) + 2)
    assert restored["step"].dtype == torch.int64 and int(restored["step"]) == 9
    # no stray tmp dirs (atomic publish)
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]
    assert mgr.latest_step() == 3
    with open(tmp_path / "step_3" / "meta.json") as f:
        meta = json.load(f)
    assert meta["n_leaves"] == 2 and meta["step"] == 3


def test_checkpoint_async_save_snapshots_before_the_io(tmp_path):
    """The snapshot is taken in ``save``: a tensor changed in place after it
    returns is restored as it was; ``restore`` casts to the structure's
    dtypes (bf16 back from the stored float32) and raises without a
    checkpoint."""
    w = torch.randn(5, 3).to(torch.bfloat16)
    state = {"p": ParamTree({"w": w.clone()}), "step": torch.tensor(2, dtype=torch.int32)}
    mgr = CheckpointManager(str(tmp_path / "c"), async_save=True)
    with pytest.raises(FileNotFoundError):
        mgr.restore(state)
    mgr.save(2, state, extra={"pipeline": {"cursor": 4, "epoch": 0, "seed": 0}})
    state["p"]["w"].data.add_(1)
    mgr.wait()
    restored, extra = mgr.restore(state)
    assert isinstance(restored["p"], ParamTree)
    assert restored["p"]["w"].dtype == torch.bfloat16 and torch.equal(restored["p"]["w"], w)
    assert restored["step"].dtype == torch.int32 and extra["pipeline"]["cursor"] == 4
    data = np.load(tmp_path / "c" / "step_2" / "shard_host0.npz")
    assert data["leaf_0"].dtype == np.float32  # bf16 upcast, as the reference stores it
    assert host_copy(w).dtype == np.float32


def test_checkpoint_resume_training_equivalence(tmp_path):
    """Twin of ``tests/test_infra.py::test_checkpoint_resume_training_equivalence``:
    train 4 steps straight == train 2, checkpoint, restore, train 2 (atol
    1e-6, and equal bits on the CPU)."""
    cfg = get_config("stablelm-1.6b", smoke=True)
    spec = TrainSpec(microbatch=1, opt=OptConfig(total_steps=10))
    step = make_train_step(cfg, spec)

    def batches(n):
        rng = np.random.default_rng(100)
        return [microbatch_reshape(
            {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32))},
            1) for _ in range(n)]

    bs = batches(4)
    s_a = init_train_state(cfg, spec, seed=1, device="cpu")
    for b in bs:
        s_a, _ = step(s_a, b)

    s_b = init_train_state(cfg, spec, seed=1, device="cpu")
    for b in bs[:2]:
        s_b, _ = step(s_b, b)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(2, s_b)
    s_b2, _ = mgr.restore(s_b)
    for b in bs[2:]:
        s_b2, _ = step(s_b2, b)

    for a, b in zip(tree_leaves(s_a), tree_leaves(s_b2)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), atol=1e-6)
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(s_b2["opt"]["step"]) == 4


def _ref_state(dtype: str):
    rcfg = ref_config("stablelm-1.6b", smoke=True)
    rcfg = type(rcfg)(**{**rcfg.__dict__, "dtype": dtype})
    cfg = get_config("stablelm-1.6b", smoke=True)
    cfg = type(cfg)(**{**cfg.__dict__, "dtype": dtype})
    rspec = rstep.TrainSpec(microbatch=2, opt=RefOptConfig(total_steps=10))
    spec = TrainSpec(microbatch=2, opt=OptConfig(total_steps=10))
    rstate = jax.jit(lambda k: rstep.init_train_state(k, rcfg, rspec))(jax.random.PRNGKey(2))
    # Moments and step that are not zero, so every leaf carries information.
    rstate = jax.tree_util.tree_map(
        lambda x: x + jnp.asarray(0.5, x.dtype) if jnp.issubdtype(x.dtype, jnp.floating)
        else x + 3, rstate)
    return rcfg, rstate, cfg, spec


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_checkpoints_cross_between_the_packages(tmp_path, dtype):
    """A train state saved by the port restores in
    ``repro.checkpoint.CheckpointManager`` into the reference's structure,
    and one saved by the reference restores in the port, bit for bit, bf16
    parameters included, with the same ``extra``."""
    _, rstate, cfg, spec = _ref_state(dtype)
    state = train_state_from_numpy(jax.tree_util.tree_map(np.asarray, rstate), cfg, spec,
                                   device="cpu")
    extra = {"step": 3, "pipeline": {"cursor": 24, "epoch": 1, "seed": 0}}

    CheckpointManager(str(tmp_path / "port"), async_save=False).save(3, state, extra=extra)
    got, got_extra = RefCheckpointManager(str(tmp_path / "port"), async_save=False).restore(rstate)
    assert got_extra == extra
    for (pa, a), (pb, b) in zip(leaves(got), leaves(rstate)):
        assert pa == pb and a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)),
                                      np.asarray(b.astype(jnp.float32)))

    RefCheckpointManager(str(tmp_path / "ref"), async_save=False).save(5, rstate, extra=extra)
    back, back_extra = CheckpointManager(str(tmp_path / "ref")).restore(state)
    assert back_extra == extra
    for a, b in zip(tree_leaves(back), tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert isinstance(back["params"], ParamTree)
    want = train_state_to_numpy(state)
    assert [p for p, _ in leaves(want)] == [p for p, _ in leaves(train_state_to_numpy(back))]
