"""The port's serving path against the reference's: configs and parameter
conversion, the sketched data pipeline, and ``serve()`` on the CPU, plus the
device rule of the new entry points.

Tolerance: float32 logits ``rtol = 1e-4``, ``atol = 1e-4`` times the larger
of 1 and the reference's largest magnitude (the packages sum in other
orders); everything else (configs, parameters, admitted documents, tokens)
is compared for equality.
"""
import contextlib
import dataclasses
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_config
from repro.data import pipeline as rpipe
from repro.models import lm as rlm
from repro.models.params import n_params as ref_n_params
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from repro_torch.models.params import leaves, n_params

torch.set_num_threads(1)  # small tensors; leave the cores to the other xdist workers


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=1e-4,
                               atol=1e-4 * max(1.0, float(np.abs(want).max())))


# ---------------------------------------------------------------------------
# Configs and parameter conversion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_the_reference(smoke):
    assert ARCHS == REF_ARCHS
    for arch in ARCHS:
        ours, theirs = get_config(arch, smoke=smoke), ref_config(arch, smoke=smoke)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs), arch
        assert ours.param_count() == theirs.param_count(), arch
        assert ours.param_count(active_only=True) == theirs.param_count(active_only=True)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "internlm2-20b", "gemma3-27b", "qwen1.5-32b"])
def test_param_spec_and_count_match_the_reference(arch):
    """Full-size specs (shapes only, nothing allocated): the same leaves,
    shapes, inits and scales; ``n_params`` equal, and equal to
    ``ModelConfig.param_count`` plus the reference's padding and norms."""
    cfg = get_config(arch)
    ours = dict(leaves(tlm.build_param_spec(cfg)))
    theirs = dict(leaves(rlm.build_param_spec(ref_config(arch))))
    assert set(ours) == set(theirs)
    for path, p in ours.items():
        q = theirs[path]
        assert (p.shape, p.axes, p.init, p.scale) == (q.shape, q.axes, q.init, q.scale), path
    assert n_params(tlm.build_param_spec(cfg)) == ref_n_params(rlm.build_param_spec(ref_config(arch)))


@pytest.fixture(scope="module")
def gemma_tree():
    """A reference parameter tree of gemma3's smoke config (stacked periods
    of three blocks and a remainder), float32, from ``concrete_params``."""
    rcfg = dataclasses.replace(ref_config("gemma3-27b", smoke=True), dtype="float32")
    params = jax.jit(lambda k: rlm.concrete_params(k, rcfg))(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_params_round_trip_exactly(gemma_tree, dtype):
    """float32 leaves, and the bf16 (ml_dtypes) leaves of the reference's
    bf16 cast, carried across and back bit for bit."""
    rcfg = dataclasses.replace(ref_config("gemma3-27b", smoke=True), dtype=dtype)
    cfg = dataclasses.replace(get_config("gemma3-27b", smoke=True), dtype=dtype)
    tree = jax.tree_util.tree_map(lambda x: np.asarray(jnp.asarray(x, dtype)), gemma_tree)
    params = lm_params_from_numpy(tree, cfg, device="cpu")
    assert n_params(params) == ref_n_params(rlm.build_param_spec(rcfg))
    back = dict(leaves(lm_params_to_numpy(params)))
    want = dict(leaves(tree))
    assert set(back) == set(want) and ("rem", "r0", "mixer", "wq") in want
    for path, x in want.items():
        assert back[path].dtype == x.dtype and back[path].shape == x.shape, path
        np.testing.assert_array_equal(back[path].view(np.uint8), x.view(np.uint8), str(path))
    assert "periods.b2.mixer.wq" in params.state_dict()


def test_lm_params_from_numpy_refuses_a_foreign_tree():
    cfg = dataclasses.replace(get_config("stablelm-1.6b", smoke=True), dtype="float32")
    tree = lm_params_to_numpy(tlm.concrete_params(cfg, device="cpu"))
    with pytest.raises(ValueError, match="does not match"):
        lm_params_from_numpy({k: v for k, v in tree.items() if k != "lm_head"}, cfg, device="cpu")
    tree["embed"] = tree["embed"][:, :8]
    with pytest.raises(ValueError, match="embed"):
        lm_params_from_numpy(tree, cfg, device="cpu")


def test_concrete_params_scales():
    """The port's own init: the reference's scales (std 1/sqrt(fan_in), 0.02
    for the embedding, ones for norms), reproducible from the seed."""
    cfg = dataclasses.replace(get_config("stablelm-1.6b", smoke=True), dtype="float32")
    a = tlm.concrete_params(cfg, seed=3, device="cpu")
    b = tlm.concrete_params(cfg, seed=3, device="cpu")
    for (_, x), (_, y) in zip(leaves(a), leaves(b)):
        assert torch.equal(x, y)
    assert abs(float(a["embed"].std()) - 0.02) < 0.002
    wg = a["periods"]["b0"]["ffn"]["wg"]  # (periods, d, ff): fan_in d
    assert abs(float(wg.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.05
    assert torch.equal(a["final_norm"]["scale"], torch.ones(cfg.d_model))


# ---------------------------------------------------------------------------
# The sketched pipeline
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pipelines():
    def make(pkg, **kw):
        meta = pkg.make_corpus_metadata(n_docs=5_000, seed=0, **kw)
        return pkg.SketchedDataPipeline(meta, pkg.CurationSpec(), 16, 64, 256, seed=0, **kw)

    return make(rpipe), make(tpipe, device="cpu")


def test_pipeline_admits_the_reference_documents(pipelines):
    ref, port = pipelines
    assert port.run_info.attr == ref.run_info.attr
    assert port.run_info.created == ref.run_info.created
    assert (port.sketch is None) == (ref.sketch is None)
    np.testing.assert_array_equal(port.selected_docs, ref.selected_docs)
    assert port.skipped_fraction == ref.skipped_fraction
    assert 0.0 < port.skipped_fraction < 1.0  # the sketch skipped a real share


def test_pipeline_batches_and_state_round_trip(pipelines):
    ref, port = pipelines
    for _ in range(3):
        np.testing.assert_array_equal(next(port)["tokens"], next(ref)["tokens"])
    assert port.state() == ref.state()
    saved = port.state()
    ahead = [next(port)["tokens"] for _ in range(2)]
    port.restore(saved)
    assert port.state() == saved
    for want in ahead:
        np.testing.assert_array_equal(next(port)["tokens"], want)


# ---------------------------------------------------------------------------
# serve() on the CPU
# ---------------------------------------------------------------------------


def _reference_serve(rcfg, params, requests, prompt_len, gen, seed):
    """``repro/launch/serve.py``'s main path (its CLI cannot serve from given
    weights): admission, prefill, teacher-forced then greedy decode."""
    meta = rpipe.make_corpus_metadata(n_docs=5_000, seed=seed)
    pipe = rpipe.SketchedDataPipeline(meta, rpipe.CurationSpec(), requests, prompt_len,
                                      rcfg.vocab_size, seed=seed)
    tokens = jnp.asarray(next(iter(pipe))["tokens"])
    logits = jax.jit(lambda p, bb: rlm.prefill(p, rcfg, bb))(params, {"tokens": tokens})
    total = prompt_len + gen
    cache = rlm.init_cache(rcfg, tokens.shape[0], total)
    decode = jax.jit(lambda p, c, t, pos: rlm.decode_step(p, rcfg, c, t, pos))
    tok, out = tokens[:, 0], []
    for i in range(total - 1):
        step_logits, cache = decode(params, cache, tok, jnp.asarray(i, jnp.int32))
        if i + 1 < prompt_len:
            tok = tokens[:, i + 1]
        else:
            tok = jnp.argmax(step_logits, -1).astype(jnp.int32)
            out.append(np.asarray(tok))
    return np.asarray(tokens), np.asarray(logits), np.stack(out, axis=1), pipe


def test_serve_on_the_cpu_matches_the_reference():
    """The smoke config in float32: the same admitted prompts, prefill
    logits within tolerance, the same greedy tokens; decode at the last
    prompt position agrees with prefill."""
    _check_serve("stablelm-1.6b")


def test_moe_serve_on_the_cpu_matches_the_reference():
    """:func:`test_serve_on_the_cpu_matches_the_reference` for qwen2-moe's
    smoke config, but for decode against prefill: prefill routes groups of
    16 positions at capacity 5, which drops picks, and decode each position
    alone at capacity 1, which drops none (the reference's semantics), so
    the two need not agree."""
    _check_serve("qwen2-moe-a2.7b")


def _check_serve(arch: str) -> None:
    rcfg = dataclasses.replace(ref_config(arch, smoke=True), dtype="float32")
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    rparams = jax.jit(lambda k: rlm.concrete_params(k, rcfg))(jax.random.PRNGKey(0))
    params = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, rparams), cfg, device="cpu")
    requests, prompt_len, gen = 4, 16, 6
    tokens, logits, generated, pipe = _reference_serve(rcfg, rparams, requests, prompt_len, gen,
                                                       seed=0)
    res = tserve.serve(cfg, requests=requests, prompt_len=prompt_len, gen=gen, seed=0,
                       device="cpu", params=params)
    np.testing.assert_array_equal(res.prompt.numpy(), tokens)
    _close(res.prefill_logits.numpy(), logits)
    if not cfg.n_experts:
        _close(res.decode_logits.numpy(), res.prefill_logits.numpy())
    np.testing.assert_array_equal(res.generated.numpy(), generated)
    assert res.run_info.attr == pipe.run_info.attr
    assert res.skipped_fraction == pipe.skipped_fraction
    assert res.n_decode_steps == prompt_len + gen - 1 and res.tokens_per_s > 0


def test_serve_cli_prints_the_reference_lines(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve", "--smoke", "--requests", "2", "--prompt-len", "8",
                                      "--gen", "2", "--device", "cpu"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserve.main()
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("[serve] admission sketch on ")
    assert lines[1].startswith("[serve] B=2 prefill(8 tok)=") and "tok/s" in lines[1]
    assert lines[2] == "[serve] finite logits: True"


def test_new_entry_points_raise_without_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    cfg = get_config("stablelm-1.6b", smoke=True)
    tree = lm_params_to_numpy(tlm.concrete_params(cfg, device="cpu"))
    meta = tpipe.make_corpus_metadata(n_docs=500, device="cpu")
    for call in (lambda: tlm.concrete_params(cfg),
                 lambda: lm_params_from_numpy(tree, cfg),
                 lambda: tlm.init_cache(cfg, 1, 4),
                 lambda: tpipe.make_corpus_metadata(n_docs=500),
                 lambda: tpipe.SketchedDataPipeline(meta, tpipe.CurationSpec(), 2, 8, 256),
                 lambda: tserve.serve(cfg, requests=2, prompt_len=8, gen=1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert tlm.concrete_params(cfg, device="cpu")["embed"].device == torch.device("cpu")
