"""The port's recurrent mixers (``repro_torch/models/ssm.py``) against the
reference's, on the CPU at the smoke configs' widths: every function of
``ssm.py`` with the reference's weights carried across, the plain scans
against the reference's scans, twins of ``tests/test_ssm_numerics.py`` on
the port, parameter conversion, and ``serve()`` and both CLIs on the two
smoke configs that have these mixers (xlstm-350m: mLSTM and sLSTM;
jamba-1.5-large-398b: mamba beside attention and MoE).  The scan kernels
run only on the card (``tests/test_torch_ssm_card.py``).

Tolerances:
- float32 against the reference: ``rtol = 1e-4`` and ``atol = 1e-4`` times
  the larger of 1 and the reference tensor's largest magnitude
  (``tests/test_torch_models.py``'s form): the packages sum matrix products
  in other orders, and XLA's and torch's float32 ``exp``/``log1p`` differ
  in the last bit;
- bfloat16 against the reference run op by op (``jax.disable_jit``, which
  rounds where the port rounds): 2e-2 relative and of the output's scale
  (``BF16_ATTN_TOL``, a few bf16 ulps: a product accumulated in float32 in
  another order may round one ulp apart, and later roundings carry it);
- the port against itself (chunked against unchunked, decode against
  train, the sLSTM gradients): ``tests/test_ssm_numerics.py``'s own.
"""
import dataclasses
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import lm as rlm
from repro.models import ssm as RS
from repro.models.params import init_params as ref_init_params
from repro.models.params import n_params as ref_n_params
from repro_torch.configs import get_config
from repro_torch.convert import (lm_params_from_numpy, lm_params_to_numpy, train_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.kernels import ref
from repro_torch.kernels import selective_scan as TK
from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.kernels.slstm_scan import slstm_scan
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as TS
from repro_torch.models.params import ParamTree, leaves, n_params, tree_leaves
from repro_torch.train import step as tstep

torch.set_num_threads(1)  # small tensors; leave the cores to the other xdist workers

SSM_ARCHS = ["xlstm-350m", "jamba-1.5-large-398b"]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BF16_TOL = 2e-2
NUMERICS_TOL = dict(atol=2e-4, rtol=1e-3)  # tests/test_ssm_numerics.py's decode vs train


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_close(got, want, dtype: str, what: str = ""):
    got, want = _f32(got), _f32(want)
    scale = max(1.0, float(np.abs(want).max()))
    tol = 1e-4 if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=what)


def _torch(x) -> torch.Tensor:
    """A reference array as a torch tensor of its dtype, bit for bit."""
    arr = np.array(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _tree(tree):
    """A reference (sub)tree of arrays as nested dicts of torch tensors."""
    if isinstance(tree, dict):
        return {k: _tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree(v) for v in tree)
    return _torch(tree)


MIXERS = {  # mixer -> (config, params, train, decode)
    "mamba": ("jamba-1.5-large-398b", "mamba_params", "mamba_train", "mamba_decode"),
    "mlstm": ("xlstm-350m", "mlstm_params", "mlstm_train", "mlstm_decode"),
    "slstm": ("xlstm-350m", "slstm_params", "slstm_train", "slstm_decode"),
}


def _mixer(mixer: str, dtype: str, seed: int = 0):
    """(reference cfg, params; port cfg, params) of one mixer at its smoke
    config, the reference's float32 init cast to ``dtype``."""
    arch, params_fn, _, _ = MIXERS[mixer]
    rcfg = dataclasses.replace(ref_config(arch, smoke=True), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    rp = ref_init_params(jax.random.PRNGKey(seed), getattr(RS, params_fn)(rcfg), jnp.float32)
    rp = jax.tree_util.tree_map(lambda x: x.astype(DTYPES[dtype][0]), rp)
    return rcfg, rp, cfg, _tree(rp)


def _x(cfg, b: int, s: int, dtype: str, seed: int = 1):
    x = np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x, DTYPES[dtype][0]), torch.from_numpy(x).to(DTYPES[dtype][1])


def _ref_cache(mixer: str, rcfg, b: int, dtype: str):
    if mixer == "mamba":
        return RS.init_mamba_cache(rcfg, b, DTYPES[dtype][0])
    return RS.init_mlstm_cache(rcfg, b) if mixer == "mlstm" else RS.init_slstm_cache(rcfg, b)


def _port_cache(mixer: str, cfg, b: int, dtype: str):
    if mixer == "mamba":
        return TS.init_mamba_cache(cfg, b, DTYPES[dtype][1], torch.device("cpu"))
    init = TS.init_mlstm_cache if mixer == "mlstm" else TS.init_slstm_cache
    return init(cfg, b, torch.device("cpu"))


def _state_leaves(tree):
    """(name, leaf) pairs of a mixer's state: dicts by key, tuples by index."""
    if isinstance(tree, dict):
        return [(f"{k}/{n}", x) for k in sorted(tree) for n, x in _state_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [(f"{i}/{n}", x) for i, v in enumerate(tree) for n, x in _state_leaves(v)]
    return [("", tree)]


# ---------------------------------------------------------------------------
# Each function of ssm.py against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mixer", list(MIXERS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixer_train_matches_reference(mixer, dtype):
    """``<mixer>_train`` at S = 20 with a chunk of 8 for mamba and mLSTM
    (two full chunks and a ragged one: the reference pads the last chunk,
    mLSTM's input gate there at -1e30), float32 under ``jit`` and bf16 op by
    op."""
    rcfg, rp, cfg, tp = _mixer(mixer, dtype)
    _, _, train, _ = MIXERS[mixer]
    jx, x = _x(cfg, 2, 20, dtype)
    kw = {} if mixer == "slstm" else {"chunk": 8}
    fn = lambda p, xx: getattr(RS, train)(p, rcfg, xx, **kw)
    if dtype == "float32":
        want = jax.jit(fn)(rp, jx)
    else:
        with jax.disable_jit():
            want = fn(rp, jx)
    got = getattr(TS, train)(tp, cfg, x, **kw)
    assert got.dtype == x.dtype and tuple(got.shape) == tuple(want.shape)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("mixer", list(MIXERS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixer_decode_matches_reference(mixer, dtype):
    """``<mixer>_decode`` for 6 steps from ``init_<mixer>_cache``: every
    step's output and the state after the last (mamba's conv tail in the
    cache dtype, every recurrent state float32, m from -1e30)."""
    rcfg, rp, cfg, tp = _mixer(mixer, dtype)
    _, _, _, decode = MIXERS[mixer]
    jx, x = _x(cfg, 2, 6, dtype, seed=2)
    rc, tc = _ref_cache(mixer, rcfg, 2, dtype), _port_cache(mixer, cfg, 2, dtype)
    assert [(n, tuple(v.shape), v.dtype) for n, v in _state_leaves(_tree(rc))] == [
        (n, tuple(v.shape), v.dtype) for n, v in _state_leaves(tc)]
    rstep = getattr(RS, decode)
    step = (jax.jit(lambda p, xx, c: rstep(p, rcfg, xx, c)) if dtype == "float32"
            else lambda p, xx, c: rstep(p, rcfg, xx, c))
    with jax.disable_jit(dtype == "bfloat16"):
        for t in range(6):
            want, rc = step(rp, jx[:, t:t + 1], rc)
            got, tc = getattr(TS, decode)(tp, cfg, x[:, t:t + 1], tc)
            assert_close(got, want, dtype, f"step {t}")
    for (name, w), (_, g) in zip(_state_leaves(rc), _state_leaves(tc)):
        assert g.dtype == _torch(w).dtype, name
        assert_close(g, w, dtype, name)


def test_ref_scans_match_the_reference_scans():
    """``selective_scan_plain`` against the reference's chunked scans
    (``mamba_train``'s ``chunk_step``/``step``, transcribed here around the
    reference's own ``_mamba_gates``) and ``slstm_scan_plain`` against
    ``_slstm_scan_p``, float32, on the same inputs; S = 37 with a chunk of
    16 (two full chunks and a ragged one); the wrappers on CPU tensors are
    the plain versions."""
    rcfg, rp, cfg, _ = _mixer("mamba", "float32")
    rng = np.random.default_rng(3)
    b, s, di = 2, 37, cfg.ssm_expand * cfg.d_model
    x1 = rng.standard_normal((b, s, di)).astype(np.float32)

    def ref_scan(p, x1, chunk):
        c = min(chunk, x1.shape[1])
        pad = -x1.shape[1] % c
        xc = jnp.moveaxis(jnp.pad(x1, ((0, 0), (0, pad), (0, 0))).reshape(b, -1, c, di), 1, 0)

        def chunk_step(hst, x_chunk):
            bmat, cmat, dtv, a = RS._mamba_gates(p, x_chunk)
            decay = jnp.exp(dtv[..., None] * a)
            drive = (dtv * x_chunk)[..., None] * bmat[..., None, :]

            def step(hh, inp):
                dec, drv, cm = inp
                hh = hh * dec + drv
                return hh, jnp.einsum("bin,bn->bi", hh, cm)

            hst, ys = jax.lax.scan(step, hst, (jnp.moveaxis(decay, 1, 0),
                                               jnp.moveaxis(drive, 1, 0),
                                               jnp.moveaxis(cmat, 1, 0)))
            return hst, jnp.moveaxis(ys, 0, 1)

        _, ys = jax.lax.scan(chunk_step, jnp.zeros((b, di, rcfg.ssm_state)), xc)
        return jnp.moveaxis(ys, 0, 1).reshape(b, -1, di)[:, :x1.shape[1]]

    want = jax.jit(ref_scan, static_argnums=2)(rp, jnp.asarray(x1), 16)
    bmat, cmat, dt, a = TS._mamba_gates(_tree(rp), torch.from_numpy(x1))
    for got in (ref.selective_scan_plain(torch.from_numpy(x1), dt, a, bmat, cmat, chunk=16),
                selective_scan(torch.from_numpy(x1), dt, a, bmat, cmat, chunk=16)):
        assert got.dtype == torch.float32 and tuple(got.shape) == (b, s, di)
        assert_close(got, want, "float32")
    unchunked = ref.selective_scan_plain(torch.from_numpy(x1), dt, a, bmat, cmat, chunk=s)
    assert_close(unchunked, want, "float32")

    rcfg, rp, cfg, tp = _mixer("slstm", "float32")
    hh, uh = cfg.n_heads, cfg.d_model // cfg.n_heads
    xproj = rng.standard_normal((b, s, 4 * cfg.d_model)).astype(np.float32)
    want = jax.jit(lambda xp, w, bi: RS._slstm_scan_p(xp, w, bi, hh, uh))(
        jnp.asarray(xproj), rp["wr"], rp["bias"])
    for got in (ref.slstm_scan_plain(torch.from_numpy(xproj), tp["wr"], tp["bias"]),
                slstm_scan(torch.from_numpy(xproj), tp["wr"], tp["bias"])):
        assert got.dtype == torch.float32 and tuple(got.shape) == (b, s, hh, uh)
        assert_close(got, want, "float32")


def _gated_args(b: int, s: int, di: int, n: int, dtype: torch.dtype, seed: int):
    """Seeded numpy inputs of ``selective_scan_gated`` as CPU tensors: x1, z,
    the raw dt, dt_bias, a, bmat, cmat, dd."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x1 = ref.silu(f(b, s, di)).to(dtype)
    z = f(b, s, di).to(dtype)
    a = -torch.exp(torch.from_numpy(rng.uniform(0, 2, (di, n)).astype(np.float32)))
    return x1, z, f(b, s, di) - 1, f(di) * 0.5, a, f(b, s, n), f(b, s, n), f(di)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_gated_on_the_cpu_is_mamba_trains_old_composition(dtype):
    """On a CPU tensor the gated entry is, bit for bit, what ``mamba_train``
    ran around the scan before the gate moved into the kernel: the softplus
    of the raw dt plus its bias, the plain scan, the skip term, the gate and
    the cast."""
    x1, z, dt_raw, dt_bias, a, bmat, cmat, dd = _gated_args(2, 37, 24, 4, dtype, 21)
    ys = ref.selective_scan_plain(x1, ref.softplus(dt_raw + dt_bias), a, bmat, cmat, chunk=16)
    y = ys + dd * x1.to(torch.float32)
    want = (y * ref.silu(z.to(torch.float32))).to(dtype)
    got = TK.selective_scan_gated(x1, z, dt_raw, dt_bias, a, bmat, cmat, dd, dtype, chunk=16)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_train_is_unchanged_on_the_cpu(dtype):
    """``mamba_train`` through the gated entry equals, bit for bit, the
    scan-only entry with the skip term, gate, cast and projection as torch
    ops (what it ran before), at the jamba smoke config."""
    _, _, cfg, p = _mixer("mamba", dtype)
    x = _x(cfg, 2, 19, dtype)[1]
    x1, z, dtv, a, bmat, cmat = TS.mamba_scan_inputs(p, cfg, x)
    y = selective_scan(x1, dtv, a, bmat, cmat, chunk=8)
    y = y + p["dd"].to(torch.float32) * x1.to(torch.float32)
    y = (y * ref.silu(z.to(torch.float32))).to(x.dtype)
    want = x + torch.einsum("bsi,id->bsd", y, p["out_proj"].to(x.dtype))
    assert torch.equal(TS.mamba_train(p, cfg, x, chunk=8), want)


def _refusal_cases():
    """(entry, arguments, error) the wrappers refuse on any device."""
    base = _gated_args(1, 4, 8, 4, torch.float32, 22)
    x1, z, dt, bias, a, bmat, cmat, dd = base
    cases = []
    for n in (0, 17):
        an, bn = torch.zeros((8, n)), torch.zeros((1, 4, n))
        cases += [("scan", (x1, dt, an, bn, bn), ValueError),
                  ("gated", (x1, z, dt, bias, an, bn, bn, dd), ValueError)]
    cases += [
        ("scan", (x1.half(), dt, a, bmat, cmat), TypeError),
        ("scan", (x1, dt.to(torch.bfloat16), a, bmat, cmat), TypeError),
        ("scan", (x1, dt[:, :3], a, bmat, cmat), ValueError),
        ("scan", (x1, dt, a[:4], bmat, cmat), ValueError),
        ("scan", (x1, dt, a, bmat, cmat[..., :3]), ValueError),
        ("gated", (x1, z.to(torch.bfloat16), dt, bias, a, bmat, cmat, dd), TypeError),
        ("gated", (x1, z, dt, bias, a, bmat, cmat, dd, torch.bfloat16), TypeError),
        ("gated", (x1, z, dt, bias.double(), a, bmat, cmat, dd), TypeError),
        ("gated", (x1, z[:, :2], dt, bias, a, bmat, cmat, dd), ValueError),
        ("gated", (x1, z, dt, bias[:4], a, bmat, cmat, dd), ValueError),
        ("gated", (x1, z, dt, bias, a, bmat, cmat, dd[:7]), ValueError),
    ]
    return cases


@pytest.mark.parametrize("case", range(len(_refusal_cases())))
def test_selective_scan_wrappers_refuse_what_the_kernel_does_not_take(case):
    """Both entries refuse, on the CPU as on the card, 0 or 17 states, a
    wrong dtype and mismatched shapes (the kernel would; the plain versions
    never see them)."""
    entry, args, error = _refusal_cases()[case]
    fn = selective_scan if entry == "scan" else TK.selective_scan_gated
    with pytest.raises(error):
        fn(*args)


# The shapes of tests/test_torch_ssm_card.py and of xlstm-350m's layer: (B, H, uh).
PLAN_SHAPES = [(2, 4, 16), (3, 2, 8), (1, 1, 1), (2, 3, 40), (2, 4, 256), (16, 4, 256),
               (3, 4, 256), (5, 4, 256), (2, 2, 70), (1, 4, 256), (64, 4, 256), (9, 2, 200)]
SCAN_TOL = 1e-5  # tests/test_torch_ssm_card.py's and chip_smoke.py's, of the output's scale


@pytest.mark.parametrize("w_bytes", [4, 2])
@pytest.mark.parametrize("b,hh,uh", PLAN_SHAPES)
def test_slstm_scan_plan_covers_every_shape(b, hh, uh, w_bytes):
    """``slstm_scan.plan`` for every shape the card tests and xlstm-350m
    run, float32 and bfloat16 wr: a portable cluster of at most uh CTAs;
    each unit owned by exactly one CTA, at most MAX_SHARE; each batch row
    by exactly one (group, half), at most ``rows`` <= MAX_ROWS; the shared
    memory the source's formula gives, within the H100's 232,448 bytes; the
    grid's y within 65,535; the slices of u covering uh, a multiple of 4
    each, and fitting the half's threads; the same plan under the card's
    resident clusters when they are the default."""
    from repro_torch.kernels import slstm_scan as SS

    p = SS.plan(b, hh, uh, w_bytes)
    assert 1 <= p.cluster <= SS.MAX_CLUSTER and p.cluster <= uh
    units = p.units(uh)
    assert [u for first, count in units for u in range(first, first + count)] == list(range(uh))
    assert all(1 <= count <= SS.MAX_SHARE for _, count in units)
    ranges = p.row_ranges(b)
    assert [r for first, count in ranges for r in range(first, first + count)] == list(range(b))
    assert all(1 <= count <= p.rows <= SS.MAX_ROWS for _, count in ranges)
    assert p.halves in (1, 2) and 1 <= p.groups <= 65535
    assert p.smem == SS.smem_bytes(uh, p.cluster, p.rows, p.halves, w_bytes)
    assert SS.ONE_PER_SM <= p.smem <= SS.MAX_SMEM
    half_threads = p.threads // p.halves
    assert half_threads % 32 == 0 and half_threads >= 4 * units[0][1]
    assert p.slice % 4 == 0 and (p.slices - 1) * p.slice < uh <= p.slices * p.slice
    assert -(-4 * -(-uh // p.cluster) // 8) * p.slices <= half_threads
    assert SS.plan(b, hh, uh, w_bytes, lambda c, *_: SS.RESIDENT[c]) == p


@pytest.mark.parametrize("args", [(1, 1, 0, 4), (1, 1, 257, 2), (0, 4, 256, 2), (2, 0, 8, 4),
                                  (2, 1, 8, 3), (8 * 65535 + 1, 1, 8, 4)])
def test_slstm_scan_plan_refuses_what_the_kernel_does_not_take(args):
    from repro_torch.kernels import slstm_scan as SS

    with pytest.raises(ValueError):
        SS.plan(*args)


def _split_order_scan(xproj, wr, bias, slice_):
    """``slstm_scan_plain`` with the kernel's recurrent product: per output,
    fmaf chains over consecutive slices of ``slice_`` u (u ascending, from
    0; an fmaf emulated as the float64 sum of the exact product, rounded to
    float32), added in slice order; then ``(x + rec) + bias`` and
    ``ref.slstm_cell``'s gates."""
    b, s, _ = xproj.shape
    hh, uh, g4 = wr.shape
    k = -(-uh // slice_)
    w = torch.zeros((hh, k * slice_, g4), dtype=torch.float64)
    w[:, :uh] = wr.to(torch.float64)
    w = w.reshape(hh, k, slice_, g4)
    bi = bias.reshape(hh, g4).to(torch.float32)
    z = torch.zeros((b, hh, uh), dtype=torch.float32)
    h, c, n, m = z, z, z, torch.full_like(z, -1e30)
    hs = []
    for t in range(s):
        hp = torch.zeros((b, hh, k * slice_), dtype=torch.float64)
        hp[..., :uh] = h.to(torch.float64)
        hp = hp.reshape(b, hh, k, slice_)
        acc = torch.zeros((b, hh, k, g4), dtype=torch.float32)
        for j in range(slice_):
            acc = (hp[..., j, None] * w[None, :, :, j] + acc.to(torch.float64)).to(torch.float32)
        rec = acc[:, :, 0]
        for i in range(1, k):
            rec = rec + acc[:, :, i]
        pre = (xproj[:, t].reshape(b, hh, g4).to(torch.float32) + rec) + bi
        zt, it, ft, ot = torch.split(pre, uh, dim=-1)
        logf = ref.log_sigmoid(ft)
        m_new = torch.maximum(logf + m, it)
        i_p, f_p = torch.exp(it - m_new), torch.exp(logf + m - m_new)
        c = f_p * c + i_p * torch.tanh(zt)
        n = f_p * n + i_p
        m = m_new
        h = ref.sigmoid(ot) * c / torch.clamp_min(n, 1e-6)
        hs.append(h)
    return torch.stack(hs, dim=1)


def test_slstm_scan_split_order_matches_the_reference():
    """The kernel's order of the recurrent product (``plan``'s 8 slices of
    32 u at xlstm-350m's 4 heads of 256 units), emulated, against
    ``slstm_scan_plain`` and the reference's ``_slstm_scan_p`` (under JAX on
    the CPU) within SCAN_TOL of the output's scale: 2 rows of 32 positions
    (S cut from the layer's 2,048), float32, wr at the model's initial scale
    1/sqrt(uh), a random bias."""
    from repro_torch.kernels import slstm_scan as SS

    cfg = get_config("xlstm-350m")
    hh, uh = cfg.n_heads, cfg.d_model // cfg.n_heads
    p = SS.plan(16, hh, uh, 2)
    assert (p.slice, p.slices) == (32, 8)
    rng = np.random.default_rng(11)
    xproj = rng.standard_normal((2, 32, 4 * hh * uh)).astype(np.float32)
    wr = (rng.standard_normal((hh, uh, 4 * uh)) / uh ** 0.5).astype(np.float32)
    bias = (rng.standard_normal(4 * hh * uh) * 0.1).astype(np.float32)
    got = _split_order_scan(*(torch.from_numpy(a) for a in (xproj, wr, bias)), p.slice)
    plain = ref.slstm_scan_plain(*(torch.from_numpy(a) for a in (xproj, wr, bias)))
    want = np.asarray(jax.jit(lambda a, w, c: RS._slstm_scan_p(a, w, c, hh, uh))(
        jnp.asarray(xproj), jnp.asarray(wr), jnp.asarray(bias)))
    for other in (plain.numpy(), want):
        scale = float(np.abs(other).max())
        assert float(np.abs(got.numpy() - other).max()) <= SCAN_TOL * scale


def test_scan_probe_patches_apply():
    """``kernels/scan_probe.py`` patches the scan kernels' sources by text:
    every variant of the sLSTM scan and of the selective scan still finds
    its anchors and differs from the kernel and from the others, and the
    sLSTM's instrumented copy marks every section once."""
    from repro_torch.kernels import scan_probe

    sources = scan_probe.all_patches()
    kernel = sources.pop("kernel")
    assert kernel == scan_probe.SOURCE.read_text()
    assert set(sources) == set(scan_probe.VARIANTS) - {"kernel"} | {"sections"}
    assert all(text != kernel for text in sources.values())
    assert len(set(sources.values())) == len(sources)
    marks = [int(m) for m in re.findall(r"MARK\((\d+)\);", sources["sections"])]
    assert sorted(marks) == list(range(len(scan_probe.SECTIONS)))
    sel = scan_probe.sel_patches()
    kernel = sel.pop("kernel")
    assert kernel == scan_probe.SEL_SOURCE.read_text()
    assert set(sel) == set(scan_probe.SEL_VARIANTS) - {"kernel"}
    assert all(text != kernel for text in sel.values())
    assert len(set(sel.values())) == len(sel)


def test_activations_round_where_jax_rounds_in_bf16():
    """In bfloat16 the port's ``sigmoid``, ``silu``, ``softplus`` and
    ``log_sigmoid`` equal ``jax.nn``'s op by op bit for bit (XLA rounds each
    step of their expansions to the dtype); in float32 within 4 ulps (the two
    libraries' ``exp`` and ``log1p`` each within an ulp, and the roundings
    of the sums and products after them)."""
    x = (np.random.default_rng(4).standard_normal(4096) * 4).astype(np.float32)
    for jd, td, exact in ((jnp.bfloat16, torch.bfloat16, True),
                          (jnp.float32, torch.float32, False)):
        jx, tx = jnp.asarray(x, jd), torch.from_numpy(x).to(td)
        with jax.disable_jit():
            for name in ("sigmoid", "silu", "softplus", "log_sigmoid"):
                want, got = _f32(getattr(jax.nn, name)(jx)), _f32(getattr(ref, name)(tx))
                if exact:
                    np.testing.assert_array_equal(got, want, err_msg=name)
                else:
                    np.testing.assert_allclose(got, want, rtol=4 * 2.0 ** -23, atol=1e-30,
                                               err_msg=name)


# ---------------------------------------------------------------------------
# Twins of tests/test_ssm_numerics.py on the port (the smoke xlstm config
# for every mixer, as there; the inputs and weights from numpy)
# ---------------------------------------------------------------------------


def _numerics(params_fn: str, b: int, s: int, seed: int):
    cfg = dataclasses.replace(get_config("xlstm-350m", smoke=True), dtype="float32")
    rcfg = ref_config("xlstm-350m", smoke=True)
    rp = ref_init_params(jax.random.PRNGKey(seed), getattr(RS, params_fn)(rcfg), jnp.float32)
    return cfg, _tree(rp), _x(cfg, b, s, "float32", seed=seed)[1]


def _decode_all(decode, init, cfg, p, x):
    cache = init(cfg, x.shape[0], torch.device("cpu"))
    outs = []
    for t in range(x.shape[1]):
        o, cache = decode(p, cfg, x[:, t:t + 1], cache)
        outs.append(o)
    return torch.cat(outs, 1)


def test_mamba_chunked_equals_unchunked():
    cfg, p, x = _numerics("mamba_params", 2, 40, 0)
    np.testing.assert_allclose(TS.mamba_train(p, cfg, x, chunk=40).numpy(),
                               TS.mamba_train(p, cfg, x, chunk=8).numpy(), atol=1e-5)


def test_mamba_decode_matches_train():
    cfg, p, x = _numerics("mamba_params", 2, 16, 1)
    init = lambda c, bb, dev: TS.init_mamba_cache(c, bb, torch.float32, dev)
    np.testing.assert_allclose(_decode_all(TS.mamba_decode, init, cfg, p, x).numpy(),
                               TS.mamba_train(p, cfg, x, chunk=16).numpy(), **NUMERICS_TOL)


def test_mlstm_chunked_equals_quadratic():
    cfg, p, x = _numerics("mlstm_params", 2, 48, 2)
    np.testing.assert_allclose(TS.mlstm_train(p, cfg, x, chunk=48).numpy(),
                               TS.mlstm_train(p, cfg, x, chunk=8).numpy(), atol=1e-4)


def test_mlstm_decode_matches_train():
    cfg, p, x = _numerics("mlstm_params", 2, 24, 3)
    np.testing.assert_allclose(
        _decode_all(TS.mlstm_decode, TS.init_mlstm_cache, cfg, p, x).numpy(),
        TS.mlstm_train(p, cfg, x, chunk=8).numpy(), **NUMERICS_TOL)


def test_slstm_grads_match_autodiff_of_the_step_loop_and_the_reference():
    """The twin of ``test_slstm_custom_vjp_grads_match_autodiff``: the port's
    ``slstm_train`` (autograd through the plain scan) against autograd of a
    loop of ``_slstm_step`` (outputs 1e-5, gradients ``atol=5e-4,
    rtol=1e-3``, the reference test's), and both against the reference's
    custom-VJP gradients at the same weights and input (``rtol`` as there)."""
    cfg, p, x = _numerics("slstm_params", 2, 20, 4)
    b, s, d = x.shape
    hh, uh = cfg.n_heads, d // cfg.n_heads

    def step_train(p, x):
        hin = TS.rmsnorm(p["ln"], x)
        xproj = torch.einsum("bsd,dg->bsg", hin, p["wx"])
        z = torch.zeros((b, hh, uh))
        state, hs = (z, z, z, torch.full((b, hh, uh), -1e30)), []
        for t in range(s):
            state = TS._slstm_step(p, cfg, xproj[:, t], state)
            hs.append(state[0])
        return x + torch.einsum("bsd,dg->bsg", torch.stack(hs, 1).reshape(b, s, d), p["out"])

    def grads(fn):
        flat = [t.clone().requires_grad_() for _, t in leaves(p)]
        tree = {}
        for (path, _), t in zip(leaves(p), flat):
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = t
        y = fn(tree, x)
        return y.detach(), torch.autograd.grad((y ** 2).sum(), flat)

    y1, g1 = grads(lambda pp, xx: TS.slstm_train(pp, cfg, xx))
    y2, g2 = grads(step_train)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-5)
    rcfg = ref_config("xlstm-350m", smoke=True)
    rp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), p)
    rg = jax.grad(lambda pp: (RS.slstm_train(pp, rcfg, jnp.asarray(x.numpy())) ** 2).sum())(rp)
    for (path, w), a, c in zip(leaves(rg), g1, g2):
        name = "/".join(path)
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=5e-4, rtol=1e-3, err_msg=name)
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=1e-4 * max(1.0, float(np.abs(w).max())), err_msg=name)


def test_slstm_decode_matches_train():
    cfg, p, x = _numerics("slstm_params", 2, 12, 5)
    np.testing.assert_allclose(
        _decode_all(TS.slstm_decode, TS.init_slstm_cache, cfg, p, x).numpy(),
        TS.slstm_train(p, cfg, x).numpy(), **NUMERICS_TOL)


# ---------------------------------------------------------------------------
# Parameters, conversion and the entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_param_spec_matches_the_reference(arch):
    """Full-size specs (shapes only, nothing allocated): the same leaves,
    shapes, axes, inits and scales, ``ffn``-less xLSTM blocks included, and
    the same count.  ``ModelConfig.param_count`` undercounts xlstm-350m in
    both packages, 0.393 B against the tree's 0.455 B: per period it omits
    the sLSTM's ``out`` (d^2) and the mLSTM's ``wog`` (f^2) and counts ``wif``
    as 3f where it holds 2f; it also omits the final norm (d)."""
    cfg = get_config(arch)
    ours = dict(leaves(tlm.build_param_spec(cfg)))
    theirs = dict(leaves(rlm.build_param_spec(ref_config(arch))))
    assert set(ours) == set(theirs)
    for path, p in ours.items():
        q = theirs[path]
        assert (p.shape, p.axes, p.init, p.scale) == (q.shape, q.axes, q.init, q.scale), path
    count = n_params(tlm.build_param_spec(cfg))
    assert count == ref_n_params(rlm.build_param_spec(ref_config(arch)))
    if arch == "xlstm-350m":
        d, f = cfg.d_model, int(cfg.xlstm_proj_factor * cfg.d_model)
        assert count == cfg.param_count() + cfg.n_periods * (d * d + f * f - f) + d
        assert (cfg.param_count(), count) == (392_577_024, 455_468_032)
        assert ("periods", "b0", "mixer", "wog") in ours and not any(
            k[2] == "ffn" for k in ours if k[0] == "periods")


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_params_and_train_state_round_trip_exactly(arch, dtype):
    """``lm_params_{from,to}_numpy`` and ``train_state_{from,to}_numpy``
    carry the SSM trees (``wr`` (H, uh, 4 uh), ``a_log``, the conv weights)
    both ways bit for bit."""
    rcfg = dataclasses.replace(ref_config(arch, smoke=True), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    rparams = jax.tree_util.tree_map(np.asarray, jax.jit(lambda k: rlm.concrete_params(k, rcfg))(
        jax.random.PRNGKey(0)))
    params = lm_params_from_numpy(rparams, cfg, device="cpu")
    assert isinstance(params, ParamTree)
    back = lm_params_to_numpy(params)
    for (pa, a), (pb, x) in zip(leaves(rparams), leaves(back)):
        assert pa == pb and a.dtype == x.dtype and a.shape == x.shape
        np.testing.assert_array_equal(a.view(np.uint8), x.view(np.uint8), err_msg=str(pa))
    spec = tstep.TrainSpec(microbatch=1)
    state = tstep.init_train_state(cfg, spec, seed=0, device="cpu")
    again = train_state_from_numpy(train_state_to_numpy(state), cfg, spec, device="cpu")
    for a, x in zip(tree_leaves(state), tree_leaves(again)):
        assert a.dtype == x.dtype and torch.equal(a, x)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_serve_on_the_cpu_matches_the_reference(arch):
    """``serve()`` on the CPU, float32, at 4 requests of 12 tokens and 4
    generated: the same admitted prompts, prefill logits within tolerance,
    the same greedy tokens as the reference's main path; for xlstm (no MoE)
    teacher-forced decode at the last prompt position agrees with prefill
    (jamba's MoE routes prefill's groups at capacity and decode's positions
    alone, so the two need not agree)."""
    from repro.data import pipeline as rpipe

    rcfg = dataclasses.replace(ref_config(arch, smoke=True), dtype="float32")
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    rparams = jax.jit(lambda k: rlm.concrete_params(k, rcfg))(jax.random.PRNGKey(0))
    params = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, rparams), cfg, device="cpu")
    requests, prompt_len, gen = 4, 12, 4
    meta = rpipe.make_corpus_metadata(n_docs=5_000, seed=0)
    pipe = rpipe.SketchedDataPipeline(meta, rpipe.CurationSpec(), requests, prompt_len,
                                      rcfg.vocab_size, seed=0)
    tokens = jnp.asarray(next(iter(pipe))["tokens"])
    want = jax.jit(lambda p, t: rlm.prefill(p, rcfg, {"tokens": t}))(rparams, tokens)
    cache = rlm.init_cache(rcfg, requests, prompt_len + gen)
    decode = jax.jit(lambda p, c, t, i: rlm.decode_step(p, rcfg, c, t, i))
    tok, generated = tokens[:, 0], []
    for i in range(prompt_len + gen - 1):
        logits, cache = decode(rparams, cache, tok, jnp.asarray(i, jnp.int32))
        if i + 1 < prompt_len:
            tok = tokens[:, i + 1]
        else:
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            generated.append(np.asarray(tok))
    res = tserve.serve(cfg, requests=requests, prompt_len=prompt_len, gen=gen, seed=0,
                       device="cpu", params=params)
    np.testing.assert_array_equal(res.prompt.numpy(), np.asarray(tokens))
    assert_close(res.prefill_logits, want, "float32")
    np.testing.assert_array_equal(res.generated.numpy(), np.stack(generated, 1))
    if not cfg.n_experts:
        assert_close(res.decode_logits, res.prefill_logits, "float32")
    assert res.n_decode_steps == prompt_len + gen - 1


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_cli_serves_and_trains_on_the_cpu(arch, tmp_path, monkeypatch, capsys):
    """``launch.serve --arch <arch> --smoke --device cpu`` prints the
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


def test_ssm_entry_points_raise_without_cuda_unless_asked_for_cpu():
    """With no card and no explicit ``"cpu"`` the SSM configs' entry points
    raise rather than run on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    for arch in SSM_ARCHS:
        cfg = get_config(arch, smoke=True)
        tree = lm_params_to_numpy(tlm.concrete_params(cfg, device="cpu"))
        for call in (lambda: tlm.concrete_params(cfg),
                     lambda: lm_params_from_numpy(tree, cfg),
                     lambda: tlm.init_cache(cfg, 1, 4),
                     lambda: tserve.serve(cfg, requests=2, prompt_len=8, gen=1)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()


def test_unknown_mixers_and_ffns_are_refused():
    """``check_supported`` takes every mixer and FFN the reference has and
    refuses a name it does not know (the reference's ``ValueError``)."""
    cfg = get_config("xlstm-350m", smoke=True)
    tlm.check_supported(dataclasses.replace(cfg, pattern=(("mamba", "none"), ("swa", "moe"))))
    with pytest.raises(ValueError):
        tlm.check_supported(dataclasses.replace(cfg, pattern=(("rwkv", "none"),)))
    with pytest.raises(ValueError):
        tlm.check_supported(dataclasses.replace(cfg, pattern=(("mlstm", "glu"),)))
