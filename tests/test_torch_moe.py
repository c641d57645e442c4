"""The port's MoE FFN against the reference's, on the CPU: ``layers.moe``
(and its routing) against ``repro.models.layers.moe`` and against the
port's plain one-hot version ``moe_plain``, its gradients, the MoE
parameter tree across ``convert``, and the MoE entry points (both CLIs)
on both MoE smoke configs.  The model-level twins
(prefill, decode, ``loss_fn``, the train step, ``serve()``) are in
``tests/test_torch_models.py``, ``tests/test_torch_train.py`` and
``tests/test_torch_serve.py``; the card's tests in
``tests/test_torch_moe_card.py``.

Inputs come from numpy seeds; the reference's weights cross with
``convert``.  Tolerances: float32 outputs ``rtol = 1e-5`` and ``atol =
1e-5`` times the larger of 1 and the reference's largest magnitude (the
router's float32 product, the expert products and the combine sum in other
orders than XLA's), the aux loss ``rtol = 1e-5`` (a mean over positions in
another order); bf16 outputs against the reference run op by op
(``jax.disable_jit``, which rounds where the port rounds) within one bf16
ulp of the output's scale, ``2**-7`` (the combine's float32 sum may round
the other way once); ``moe`` against ``moe_plain``: the picks, kept slots
and aux equal, the output within ``1e-6`` of its scale in float32 and one
bf16 ulp in bf16 (the two sum a position's kept slots in other orders).
Gradients: float32 each leaf ``1e-4`` relative in norm, bf16 each leaf
elementwise ``2e-2`` of its scale (``tests/test_torch_train.py``'s).
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import layers as RL
from repro.models import lm as rlm
from repro.models.params import init_params as ref_init_params
from repro.models.params import n_params as ref_n_params
from repro.optim import adamw as radamw
from repro.train import step as rstep
from repro_torch.configs import get_config
from repro_torch.convert import (lm_params_from_numpy, lm_params_to_numpy, train_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as TL
from repro_torch.models import lm as tlm
from repro_torch.models.params import ParamTree, leaves, n_params, tree_leaves, tree_unflatten
from repro_torch.optim import adamw as tadamw
from repro_torch.train import step as tstep

torch.set_num_threads(1)  # small tensors; leave the cores to the other xdist workers

MOE_ARCHS = ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
F32_TOL = 1e-5
AUX_RTOL = 1e-5
BF16_ULP = 2.0 ** -7
PLAIN_F32_TOL = 1e-6
GRAD_RTOL_F32, BF16_GRAD_TOL = 1e-4, 2e-2

# (batch, positions, group_size, capacity_factor, router): a short sequence
# in one group; groups of 4 over 13 positions (3 padded positions, whose
# probabilities all tie and which enter the aux loss); a capacity factor
# that drops picks; a zero router (every expert ties: the picks are experts
# 0..k-1); one position (a decode step: groups of 1, capacity 1).
CASES = {
    "short": (2, 7, 4096, 1.25, "random"),
    "padded": (2, 13, 4, 1.25, "random"),
    "drops": (2, 24, 4096, 0.3, "random"),
    "zero_router": (2, 9, 4096, 1.25, "zero"),
    "decode": (3, 1, 4096, 1.25, "random"),
}


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _port_tree(tree) -> ParamTree:
    """A reference parameter (sub)tree as the port's, bit for bit."""
    out = {}
    for path, x in leaves(tree):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.from_numpy(_f32(x).copy()).to(
            torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32)
    return ParamTree(out)


def _layer(arch: str, dtype: str, case: str):
    """(reference cfg, params, x; port cfg, params, x; group_size) for one
    MoE layer of ``arch``'s smoke config at ``case``."""
    b, s, group_size, cf, router = CASES[case]
    rcfg = dataclasses.replace(ref_config(arch, smoke=True), dtype=dtype, capacity_factor=cf)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype, capacity_factor=cf)
    jd, td = DTYPES[dtype]
    jp = ref_init_params(jax.random.PRNGKey(7), RL.moe_params(rcfg), jnp.float32)
    if router == "zero":
        jp = {**jp, "router": jnp.zeros_like(jp["router"])}
    jp = jax.tree_util.tree_map(lambda x: x.astype(jd), jp)
    x = np.random.default_rng(s * 31 + b).standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return rcfg, jp, jnp.asarray(x, jd), cfg, _port_tree(jp), torch.from_numpy(x).to(td), group_size


def _reference_moe(rcfg, jp, jx, dtype, group_size):
    if dtype == "float32":
        return jax.jit(lambda p, xx: RL.moe(p, rcfg, xx, group_size=group_size))(jp, jx)
    with jax.disable_jit():
        return RL.moe(jp, rcfg, jx, group_size=group_size)


def _assert_case_shape(cfg, route, case: str) -> None:
    """The case exercises what it is named for."""
    k = cfg.experts_per_token
    if case == "drops":
        assert not bool(route.keep.all())
    if case == "padded":
        assert route.idx.shape[1] * route.idx.shape[2] > route.s
        tail = route.idx.reshape(route.idx.shape[0], -1, k)[:, route.s:]
        assert bool((tail == torch.arange(k)).all())  # tied padded positions pick 0..k-1
    if case == "zero_router":
        assert bool((route.idx == torch.arange(k)).all())
    if case == "decode":
        assert route.cap == 1 and route.idx.shape[2] == 1


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_matches_reference(arch, dtype, case):
    """The layer's output (and its FFN part, output minus input) and aux
    loss against the reference's on the same weights and input."""
    rcfg, jp, jx, cfg, tp, x, group_size = _layer(arch, dtype, case)
    want, waux = _reference_moe(rcfg, jp, jx, dtype, group_size)
    got, aux = TL.moe(tp, cfg, x, group_size=group_size)
    assert got.dtype == x.dtype and got.shape == x.shape and aux.dtype == torch.float32
    _, route = TL.moe_route(tp, cfg, TL.rmsnorm(tp["ln"], x), group_size)
    _assert_case_shape(cfg, route, case)
    w, g = _f32(want), _f32(got)
    for label, a, b in (("output", g, w), ("ffn", g - _f32(x), w - _f32(jx))):
        scale = max(1.0, float(np.abs(b).max()))
        if dtype == "float32":
            np.testing.assert_allclose(a, b, rtol=F32_TOL, atol=F32_TOL * scale, err_msg=label)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=BF16_ULP * float(np.abs(w).max()),
                                       err_msg=label)
    np.testing.assert_allclose(float(aux), float(waux), rtol=AUX_RTOL)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_matches_moe_plain(arch, dtype, case):
    """``moe`` (sort, slot gather, three batched products, gathered
    combine) against ``moe_plain`` (k rounds of argmax, the one-hot
    einsums): equal picks, kept slots and aux; the output within its
    tolerance."""
    _, _, _, cfg, tp, x, group_size = _layer(arch, dtype, case)
    h = TL.rmsnorm(tp["ln"], x)
    _, r = TL.moe_route(tp, cfg, h, group_size)
    _, rp = TL.moe_route_plain(tp, cfg, h, group_size)
    assert torch.equal(r.idx, rp.idx) and torch.equal(r.keep, rp.keep)
    assert torch.equal(torch.where(r.keep, r.pos, -1), torch.where(rp.keep, rp.pos, -1))
    assert torch.equal(r.mask, rp.mask) and torch.equal(r.gates, rp.gates) and r.cap == rp.cap
    got, aux = TL.moe(tp, cfg, x, group_size=group_size)
    want, paux = TL.moe_plain(tp, cfg, x, group_size=group_size)
    assert torch.equal(aux, paux)
    tol = PLAIN_F32_TOL if dtype == "float32" else BF16_ULP
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0,
                               atol=tol * float(want.abs().max()))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ties_go_to_the_lower_expert_like_lax_top_k(arch):
    """Router columns copied so that pairs of experts tie exactly: both
    routings pick what ``jax.lax.top_k`` picks from the same probabilities,
    the lower index of a tied pair first."""
    _, _, _, cfg, tp, x, group_size = _layer(arch, "float32", "short")
    router = tp["router"].detach().clone()
    router[:, 3] = router[:, 1]
    router[:, 4] = router[:, 0]
    tp = ParamTree({**{k: tp[k] for k in tp.keys() if k != "router"}, "router": router})
    h = TL.rmsnorm(tp["ln"], x)
    _, r = TL.moe_route(tp, cfg, h, group_size)
    _, rp = TL.moe_route_plain(tp, cfg, h, group_size)
    vals, idx = jax.lax.top_k(jnp.asarray(r.probs.numpy()), cfg.experts_per_token)
    np.testing.assert_array_equal(r.idx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(rp.idx.numpy(), np.asarray(idx))
    probs = r.probs.numpy()
    assert np.array_equal(probs[..., 3], probs[..., 1]) and np.isin([1, 3], r.idx.numpy()).all()


@pytest.mark.parametrize("case", ["padded", "drops"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_grads_match_reference(arch, dtype, case):
    """Gradients of ``sum(y * dy) + aux`` with respect to the layer's input
    and every weight (router, experts, shared expert, norm) against
    ``jax.vjp`` of the reference's ``moe`` on the same input; bf16 against
    the reference run op by op."""
    rcfg, jp, jx, cfg, tp, x, group_size = _layer(arch, dtype, case)
    jd, td = DTYPES[dtype]
    dy = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    jdy = jnp.asarray(dy, jd)

    def ref(p, xx):
        y, aux = RL.moe(p, rcfg, xx, group_size=group_size)
        return y, aux

    with jax.disable_jit(dtype == "bfloat16"):
        (_, _), vjp = jax.vjp(ref, jp, jx)
        rgp, rgx = vjp((jdy, jnp.ones((), jnp.float32)))
    flat = [t.detach().requires_grad_() for t in tree_leaves(tp)]
    xx = x.detach().requires_grad_()
    y, aux = TL.moe(tree_unflatten(tp, flat, dicts=True), cfg, xx, group_size=group_size)
    grads = torch.autograd.grad((y * torch.from_numpy(dy).to(td)).sum() + aux, [xx, *flat])
    want = [rgx, *[w for _, w in leaves(rgp)]]
    names = ["x", *["/".join(p) for p, _ in leaves(rgp)]]
    for name, g, w in zip(names, grads, want):
        g, w = _f32(g), _f32(w)
        if dtype == "float32":
            err, scale = float(np.linalg.norm(g - w)), float(np.linalg.norm(w))
            assert err <= GRAD_RTOL_F32 * scale + 1e-7 * np.sqrt(w.size), (name, err, scale)
        else:
            np.testing.assert_allclose(g, w, rtol=BF16_GRAD_TOL,
                                       atol=BF16_GRAD_TOL * float(np.abs(w).max()), err_msg=name)


# ---------------------------------------------------------------------------
# The MoE parameter tree across convert
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_param_spec_matches_the_reference(arch):
    """Full-size specs (shapes only): the same leaves, shapes, inits and
    scales, ``ffn/shared`` included; ``n_params`` equal (qwen2-moe:
    15,146,403,840 with its 64 padded experts)."""
    ours = dict(leaves(tlm.build_param_spec(get_config(arch))))
    theirs = dict(leaves(rlm.build_param_spec(ref_config(arch))))
    assert set(ours) == set(theirs)
    for path, p in ours.items():
        q = theirs[path]
        assert (p.shape, p.axes, p.init, p.scale) == (q.shape, q.axes, q.init, q.scale), path
    assert n_params(tlm.build_param_spec(get_config(arch))) == ref_n_params(
        rlm.build_param_spec(ref_config(arch)))
    assert (("periods", "b0", "ffn", "shared", "wo") in ours) == (arch == "qwen2-moe-a2.7b")
    if arch == "qwen2-moe-a2.7b":
        assert n_params(tlm.build_param_spec(get_config(arch))) == 15_146_403_840


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_params_and_train_state_round_trip_exactly(arch, dtype):
    """The reference's MoE parameter tree and train state carried across and
    back bit for bit (``ffn/shared``, the router, the stacked experts)."""
    rcfg = dataclasses.replace(ref_config(arch, smoke=True), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    rspec = rstep.TrainSpec(microbatch=2, opt=radamw.OptConfig(total_steps=4))
    spec = tstep.TrainSpec(microbatch=2, opt=tadamw.OptConfig(total_steps=4))
    rstate = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda k: rstep.init_train_state(k, rcfg, rspec))(jax.random.PRNGKey(2)))
    params = lm_params_from_numpy(rstate["params"], cfg, device="cpu")
    back = dict(leaves(lm_params_to_numpy(params)))
    want = dict(leaves(rstate["params"]))
    assert set(back) == set(want) and ("periods", "b0", "ffn", "router") in want
    for path, x in want.items():
        assert back[path].dtype == x.dtype and back[path].shape == x.shape, path
        np.testing.assert_array_equal(back[path].view(np.uint8), x.view(np.uint8), str(path))
    state = train_state_from_numpy(rstate, cfg, spec, device="cpu")
    tree = train_state_to_numpy(state)
    for (pa, a), (pb, b) in zip(leaves(rstate), leaves(tree)):
        assert pa == pb and a.dtype == b.dtype and a.shape == b.shape
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), pa


# ---------------------------------------------------------------------------
# The entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_cli_serves_and_trains_on_the_cpu(arch, tmp_path, monkeypatch, capsys):
    """``launch.serve --arch <moe> --smoke --device cpu`` prints the
    reference's lines with finite logits, and ``launch.train`` takes two
    steps with a checkpoint."""
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch, "--smoke", "--requests", "2",
                                      "--prompt-len", "8", "--gen", "2", "--device", "cpu"])
    tserve.main()
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith("[serve] B=2 prefill(8 tok)=")
    assert out[2] == "[serve] finite logits: True"
    monkeypatch.setattr(sys, "argv", ["train", "--arch", arch, "--smoke", "--device", "cpu",
                                      "--steps", "2", "--batch", "4", "--seq", "16",
                                      "--ckpt", str(tmp_path / "ckpt")])
    ttrain.main()
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"[train] arch={arch}-smoke params={get_config(arch, True).param_count():,}"
    assert out[-1].startswith("[train] done: loss ") and out[-1].endswith("ckpts=[2]")


def test_moe_entry_points_raise_without_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    cfg = get_config("qwen2-moe-a2.7b", smoke=True)
    tree = lm_params_to_numpy(tlm.concrete_params(cfg, device="cpu"))
    for call in (lambda: tlm.concrete_params(cfg),
                 lambda: lm_params_from_numpy(tree, cfg),
                 lambda: tlm.init_cache(cfg, 1, 4),
                 lambda: tserve.serve(cfg, requests=2, prompt_len=8, gen=1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
