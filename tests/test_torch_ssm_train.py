"""The recurrent scans' backwards on the CPU (the plain versions the card's
backward kernels are held to, ``kernels/ref.py``): each against autograd
of its plain forward and against the reference's gradients under JAX on
the CPU, the sLSTM backward kernel's order of the recurrent product
emulated, the backward plan, the wrappers' refusals and the residuals'
switch.  The kernels themselves run only on the card
(``tests/test_torch_ssm_card.py``).

Tolerances:
- float32, a plain backward against autograd of its plain forward: 1e-5
  of each gradient's largest magnitude (the same float32 formulas; the
  sums over channels, positions and k run in other orders);
- bfloat16 inputs: the float32 gradients as above; a gradient rounded to
  bfloat16 (dx1, dz, dxproj) also within one bf16 ulp of each element,
  2^-7 of it, as two float32 values that close may round to neighbouring
  bf16 values; the gated scan's against autograd on float32 copies, since
  autograd rounds x1's two uses' gradients to bf16 apart;
- against the reference: the sLSTM's ``jax.vjp`` of ``_slstm_scan_p`` at
  ``atol=5e-4, rtol=1e-3`` (``test_slstm_custom_vjp_grads_match_autodiff``'s);
  mamba's layer gradients at ``test_torch_ssm.py``'s ``assert_close``
  (float32 1e-4 of the scale, bfloat16 2e-2: a few bf16 ulps, as the
  reference under ``jit`` rounds in other places);
- the kernel's order of the sLSTM backward's product, emulated: within
  the card's SCAN_GRAD_TOL = 1e-4 of each gradient's scale of the plain
  backward and the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import ssm as RS
from repro_torch.configs import get_config
from repro_torch.kernels import ref, residuals
from repro_torch.kernels import selective_scan as SEL
from repro_torch.kernels import slstm_scan as SS
from repro_torch.models import ssm as TS
from repro_torch.models.params import leaves, tree_unflatten

torch.set_num_threads(1)  # small tensors; leave the cores to the other xdist workers

GRAD_TOL = 1e-5  # a plain backward against autograd of its plain forward, f32
SCAN_GRAD_TOL = 1e-4  # tests/test_torch_ssm_card.py's and chip_smoke.py's
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _grad_close(got, want, tol: float, what: str = ""):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    g, w = got.double(), want.double()
    slack = tol * float(w.abs().max()) + (2.0 ** -7 * w.abs() if got.dtype == torch.bfloat16
                                           else 0)
    assert bool(torch.isfinite(g).all()) and not bool(((g - w).abs() > slack).any()), (
        what, float((g - w).abs().max()), float(w.abs().max()))


def _slstm_args(b, s, hh, uh, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    xproj = torch.randn((b, s, 4 * hh * uh), generator=gen).to(dtype)
    wr = (torch.randn((hh, uh, 4 * uh), generator=gen) / uh ** 0.5).to(dtype)
    bias = (torch.randn((4 * hh * uh,), generator=gen) * 0.3).to(dtype)
    dhs = torch.randn((b, s, hh, uh), generator=gen)
    return xproj, wr, bias, dhs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slstm_scan_bwd_plain_matches_autograd(dtype):
    """``slstm_scan_bwd_plain`` from ``slstm_scan_fwd_plain``'s residuals
    against autograd of ``slstm_scan_plain``; the residuals' ``hs`` is that
    forward's bit for bit; the wrapper on a CPU tensor is the plain pair."""
    xproj, wr, bias, dhs = _slstm_args(2, 11, 2, 8, dtype, 1)
    leaves_ = [t.clone().requires_grad_() for t in (xproj, wr, bias)]
    hs = ref.slstm_scan_plain(*leaves_)
    want = torch.autograd.grad(hs, leaves_, dhs)
    got_hs, pre, states = SS.slstm_scan_residuals(xproj, wr, bias)
    assert torch.equal(got_hs, hs.detach()) and pre.shape == xproj.shape
    got = SS.slstm_scan_bwd(xproj, wr, bias, pre, states, got_hs, dhs)
    for name, g, w in zip(("dxproj", "dwr", "dbias"), got, want):
        _grad_close(g, w, GRAD_TOL, name)


def test_slstm_scan_bwd_plain_matches_the_reference_vjp():
    """The counterpart of ``_slstm_scan_bwd`` against ``jax.vjp`` of the
    reference's ``_slstm_scan_p`` on the same inputs (float32)."""
    xproj, wr, bias, dhs = _slstm_args(2, 13, 2, 8, torch.float32, 2)
    hh, uh = 2, 8
    hs, pre, states = ref.slstm_scan_fwd_plain(xproj, wr, bias)
    got = ref.slstm_scan_bwd_plain(xproj, wr, bias, pre, states, hs, dhs)
    _, vjp = jax.vjp(lambda a, w, c: RS._slstm_scan_p(a, w, c, hh, uh),
                     *(jnp.asarray(t.numpy()) for t in (xproj, wr, bias)))
    want = vjp(jnp.asarray(dhs.numpy()))
    for name, g, w in zip(("dxproj", "dwr", "dbias"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4, rtol=1e-3, err_msg=name)


def _split_order_bwd(xproj, wr, bias, pre, states, hs, dhs, cluster, slice_):
    """``slstm_scan_bwd_plain`` with the backward kernel's recurrent
    product, a reduce-scatter over the cluster: CTA k of ``cluster`` owns
    units [k uh / C, (k + 1) uh / C) and their 4 gate columns, in its local
    order (gate, then unit; padded with zero columns to whole slices); its
    partial dh of every unit of the head is the sum, in slice order, of fmaf
    chains over consecutive slices of ``slice_`` of its columns (ascending;
    an fmaf emulated as the float64 sum of the exact product, rounded to
    float32); a unit's dh adds the cluster's partials in rank order, then
    the position's ``dhs`` (the last position's dh is its ``dhs``)."""
    b, s, _ = xproj.shape
    hh, uh, g4 = wr.shape
    share = -(-uh // cluster)
    slices = -(-4 * share // slice_)
    cols = []
    for k in range(cluster):
        lo, n = k * uh // cluster, (k + 1) * uh // cluster - k * uh // cluster
        own = [q * uh + lo + i for q in range(4) for i in range(n)]
        cols.append(own + [g4] * (slices * slice_ - len(own)))  # g4: a zero column
    cols = torch.tensor(cols)  # (C, slices x slice)
    w = torch.cat([wr.to(torch.float64), torch.zeros((hh, uh, 1), dtype=torch.float64)], dim=2)
    w = w[:, :, cols].permute(0, 2, 3, 1).reshape(hh, cluster, slices, slice_, uh)
    c, n, m = states
    pre4 = pre.reshape(b, s, hh, g4)
    dpre = torch.empty_like(pre4)
    z = torch.zeros((b, hh, uh))
    dh_next, dst = None, (z, z, z)
    for t in reversed(range(s)):
        prev = (c[:, t - 1], n[:, t - 1], m[:, t - 1]) if t else (z, z, torch.full_like(z, -1e30))
        dh = dhs[:, t] if dh_next is None else dh_next + dhs[:, t]
        dp, dst = ref.slstm_cell_bwd(pre4[:, t], prev, (c[:, t], n[:, t], m[:, t]), dh, dst)
        dpre[:, t] = dp
        x = torch.cat([dp.to(torch.float64), torch.zeros((b, hh, 1), dtype=torch.float64)],
                      dim=2)[:, :, cols].reshape(b, hh, cluster, slices, slice_)
        acc = torch.zeros((b, hh, cluster, slices, uh), dtype=torch.float32)
        for j in range(slice_):
            acc = (x[..., j, None] * w[None, :, :, :, j] + acc.to(torch.float64)).to(torch.float32)
        part = acc[:, :, :, 0]
        for i in range(1, slices):
            part = part + acc[:, :, :, i]
        dh_next = part[:, :, 0]
        for k in range(1, cluster):
            dh_next = dh_next + part[:, :, k]
    dwr, dbias = ref.slstm_weight_grads(hs, dpre)
    return dpre.reshape(b, s, -1), dwr, dbias


def _check_split_order_bwd(hh, uh, cut):
    """The emulated order at ``plan(4, hh, uh, 2, backward=True)`` (its
    ``(cluster, slice, slices)`` is ``cut``) against the plain backward and
    the reference's ``jax.vjp``: 2 rows of 16 positions, float32, wr at the
    model's initial scale 1/sqrt(uh)."""
    p = SS.plan(4, hh, uh, 2, backward=True)
    assert (p.cluster, p.slice, p.slices) == cut
    xproj, wr, bias, dhs = _slstm_args(2, 16, hh, uh, torch.float32, 3)
    hs, pre, states = ref.slstm_scan_fwd_plain(xproj, wr, bias)
    got = _split_order_bwd(xproj, wr, bias, pre, states, hs, dhs, p.cluster, p.slice)
    plain = ref.slstm_scan_bwd_plain(xproj, wr, bias, pre, states, hs, dhs)
    _, vjp = jax.vjp(lambda a, w, c: RS._slstm_scan_p(a, w, c, hh, uh),
                     *(jnp.asarray(t.numpy()) for t in (xproj, wr, bias)))
    want = [torch.from_numpy(np.array(g)) for g in vjp(jnp.asarray(dhs.numpy()))]
    for other in (plain, want):
        for name, g, w in zip(("dxproj", "dwr", "dbias"), got, other):
            _grad_close(g, w, SCAN_GRAD_TOL, name)


def test_slstm_scan_bwd_split_order_matches_the_plain_and_the_reference():
    """The backward kernel's order of ``dpre wr^T`` at xlstm-350m's 4 heads
    of 256 units (clusters of 8, each CTA's 128 gate columns in 4 slices of
    32, the 8 CTAs' partials added in rank order), emulated, against
    ``slstm_scan_bwd_plain`` and the reference's ``jax.vjp`` within
    SCAN_GRAD_TOL of each gradient's scale (S cut from the layer's 2,048)."""
    cfg = get_config("xlstm-350m")
    _check_split_order_bwd(cfg.n_heads, cfg.d_model // cfg.n_heads, (8, 32, 4))


def test_slstm_scan_bwd_split_order_at_an_uneven_share():
    """The same at 2 heads of 70 units: 4 CTAs of 17 or 18 units (their
    columns padded to 9 slices of 8), so the partials go to owners one unit
    at a time."""
    _check_split_order_bwd(2, 70, (4, 8, 9))


def _scan_args(b, s, di, n, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    x1 = ref.silu(torch.randn((b, s, di), generator=gen)).to(dtype)
    z = torch.randn((b, s, 2 * di), generator=gen).to(dtype)[..., di:]
    dt_raw = torch.randn((b, s, di), generator=gen) - 1
    dt_bias = torch.randn((di,), generator=gen) * 0.5
    a = -torch.exp(torch.rand((di, n), generator=gen) * 2)
    bmat, cmat = torch.randn((b, s, n), generator=gen), torch.randn((b, s, n), generator=gen)
    dd = torch.randn((di,), generator=gen)
    dout = torch.randn((b, s, di), generator=gen).to(dtype)
    return (x1, z, dt_raw, dt_bias, a, bmat, cmat, dd), dout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_bwd_plains_match_autograd(dtype):
    """The scan-only and gated plain backwards (from the saved states, a
    span of SCAN_SPAN positions at a time, S = 11 ragged) against autograd
    of ``selective_scan_plain`` and ``selective_scan_gated_plain`` (the
    latter on float32 copies of bf16 inputs); the saved states at a span's start equal the forward's; the wrappers on a
    CPU tensor are the plain pairs."""
    args, dout = _scan_args(2, 11, 16, 4, dtype, 4)
    x1, z, dt_raw, dt_bias, a, bmat, cmat, dd = args
    dt = ref.softplus(dt_raw + dt_bias)
    ys, hsave = SEL.selective_scan_states_of(x1, dt, a, bmat, cmat)
    assert hsave.shape == SEL.states_shape(x1, a) == (2, 3, 4, 16)
    assert torch.equal(hsave[:, 0], torch.zeros_like(hsave[:, 0]))
    leaves_ = [t.clone().requires_grad_() for t in (x1, dt, a, bmat, cmat)]
    dys = dout.float()
    want = torch.autograd.grad(ref.selective_scan_plain(*leaves_), leaves_, dys)
    got = SEL.selective_scan_bwd(x1, dt, a, bmat, cmat, dys, hsave)
    for name, g, w in zip(("dx1", "ddt", "da", "dbmat", "dcmat"), got, want):
        _grad_close(g, w, GRAD_TOL, name)
    out, hsave = SEL.selective_scan_states_of(x1, dt_raw, a, bmat, cmat, z, dt_bias, dd)
    assert torch.equal(out, SEL.selective_scan_gated(*args))
    # On float32 copies (the same values): autograd would round x1's two
    # uses' gradients to bf16 apart and add them in bf16.
    leaves_ = [t.float().requires_grad_() for t in args]
    want = torch.autograd.grad(ref.selective_scan_gated_plain(*leaves_, torch.float32), leaves_,
                               dout.float())
    got = SEL.selective_scan_gated_bwd(*args, dout, hsave)
    for name, g, w in zip(("dx1", "dz", "ddt_raw", "ddt_bias", "da", "dbmat", "dcmat", "ddd"),
                          got, want):
        _grad_close(g, w.to(g.dtype), GRAD_TOL, name)


class _PlainGated(torch.autograd.Function):
    """``selective_scan_gated_plain`` whose backward is
    ``selective_scan_gated_bwd_plain``: the card's autograd function with
    the plain versions in the kernels' places."""

    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return ref.selective_scan_gated_plain(*args, args[0].dtype)

    @staticmethod
    def backward(ctx, dout):
        return ref.selective_scan_gated_bwd_plain(*ctx.saved_tensors, dout)


def _init(rng, shape, name):
    """Seeded weights at a layer's scales: a_log 1 (a = -e), dt_bias 0.1, dd
    0.5, the rest normal over the fan-in."""
    if name in ("a_log", "dt_bias", "dd"):
        return np.full(shape, {"a_log": 1.0, "dt_bias": 0.1, "dd": 0.5}[name], np.float32)
    return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_grads_through_the_plain_backward_match_the_reference(dtype, monkeypatch):
    """``mamba_train``'s gradients (input and every leaf) with the gated
    scan's backward the plain backward, against ``jax.grad`` of the
    reference's ``mamba_train`` at the same weights and input (under
    ``jit``): jamba's smoke widths, 2 rows of 8 positions, seeded weights."""
    rcfg = dataclasses.replace(ref_config("jamba-1.5-large-398b", smoke=True), dtype=dtype)
    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b", smoke=True), dtype=dtype)
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(5)
    rp = {k: jnp.asarray(_init(rng, v.shape, k)).astype(jdt) for k, v in
          RS.mamba_params(rcfg).items() if k != "ln"}
    rp["ln"] = {"scale": jnp.ones((cfg.d_model,), jdt)}
    x = np.random.default_rng(6).standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    flat = [torch.from_numpy(np.array(t.astype(jnp.float32))).to(tdt).requires_grad_()
            for _, t in leaves(rp)]
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    monkeypatch.setattr(TS, "selective_scan_gated",
                        lambda *a, chunk=1024: _PlainGated.apply(*a[:8]))
    y = TS.mamba_train(tree_unflatten(rp, flat, dicts=True), cfg, xt)
    gy = np.random.default_rng(7).standard_normal(y.shape).astype(np.float32)
    got = torch.autograd.grad(y, [xt, *flat], torch.from_numpy(gy).to(tdt))

    def loss(p, xx):
        return (RS.mamba_train(p, rcfg, xx).astype(jnp.float32) * jnp.asarray(gy)).sum()

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(rp, jnp.asarray(x).astype(jdt))
    want = [gx, *(w for _, w in leaves(gp))]
    names = ["x", *("/".join(path) for path, _ in leaves(rp))]
    tol = 1e-4 if dtype == "float32" else 2e-2
    for name, g, w in zip(names, got, want):
        w = np.asarray(jnp.asarray(w).astype(jnp.float32))
        g = g.detach().float().numpy()
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * scale, err_msg=name)


@pytest.mark.parametrize("w_bytes", [4, 2])
@pytest.mark.parametrize("b,hh,uh", [(2, 4, 16), (3, 2, 8), (1, 1, 1), (2, 3, 40), (4, 4, 256),
                                     (16, 4, 256), (5, 4, 256), (2, 2, 70), (9, 2, 200)])
def test_slstm_scan_bwd_plan_covers_every_shape(b, hh, uh, w_bytes):
    """``plan(backward=True)`` for the card tests' shapes and xlstm-350m's:
    the forward's cluster; a half's threads are the forward's product
    threads and half as many cell threads (warps each), the product threads
    holding every (8 of the head's units, slice) product and, 8 items each
    at most, the reduce-scatter's items, the cell threads every (row, unit)
    cell, two each at most; the slices cover the CTA's 4 share gate columns,
    a multiple of 4 each; the shared memory the source's BwdLayout gives,
    within the H100's 232,448 bytes (float32 wr at 4 x 256 by fewer rows)."""
    p = SS.plan(b, hh, uh, w_bytes, backward=True)
    f = SS.plan(b, hh, uh, w_bytes)
    assert p.cluster == f.cluster
    share = -(-uh // p.cluster)
    product = f.threads // f.halves
    cell = p.threads // p.halves - product
    assert product % 32 == 0 and cell % 32 == 0 and 2 * cell >= product
    assert p.rows * share <= 2 * cell and -(-uh // 8) * p.slices <= product
    width = 4 if uh % (4 * p.cluster) == 0 else 1
    assert p.rows * uh // width <= 8 * product
    assert p.slice % 4 == 0 and (p.slices - 1) * p.slice < 4 * share <= p.slices * p.slice
    assert p.smem == SS.smem_bytes(uh, p.cluster, p.rows, p.halves, w_bytes, backward=True)
    assert SS.ONE_PER_SM <= p.smem <= SS.MAX_SMEM
    ranges = p.row_ranges(b)
    assert [r for first, count in ranges for r in range(first, first + count)] == list(range(b))


def _bwd_refusals():
    """(entry, arguments, error) the backward wrappers refuse on any device."""
    xproj, wr, bias, dhs = _slstm_args(1, 4, 2, 8, torch.float32, 8)
    hs, pre, states = ref.slstm_scan_fwd_plain(xproj, wr, bias)
    cases = [
        ("slstm", (xproj, wr, bias, pre[:, :3], states, hs, dhs), ValueError),
        ("slstm", (xproj, wr, bias, pre.double(), states, hs, dhs), TypeError),
        ("slstm", (xproj, wr, bias, pre, states[:2], hs, dhs), ValueError),
        ("slstm", (xproj, wr, bias, pre, states, hs, dhs.to(torch.bfloat16)), TypeError),
        ("slstm", (xproj, wr, bias, pre, states, hs[..., :4], dhs), ValueError),
        ("slstm", (xproj, wr[..., :8], bias, pre, states, hs, dhs), ValueError),
        # what a forward under residuals.skipped saves: refused, never read
        ("slstm", (xproj, wr, bias, residuals.placeholder(pre.shape, pre.device), states, hs,
                   dhs), ValueError),
        ("slstm", (xproj, wr, bias, pre, (residuals.placeholder(hs.shape, hs.device),
                                          *states[1:]), hs, dhs), ValueError),
    ]
    args, dout = _scan_args(1, 6, 8, 4, torch.float32, 9)
    x1, z, dt_raw, dt_bias, a, bmat, cmat, dd = args
    hsave = ref.selective_scan_states(x1, dt_raw, a, bmat)
    cases += [
        ("scan", (x1, dt_raw, a, bmat, cmat, dout.to(torch.bfloat16), hsave), TypeError),
        ("scan", (x1, dt_raw, a, bmat, cmat, dout[:, :5], hsave), ValueError),
        ("scan", (x1, dt_raw, a, bmat, cmat, dout, hsave[:, :1]), ValueError),
        ("scan", (x1, dt_raw, a, bmat, cmat, dout, hsave.double()), TypeError),
        ("scan", (x1, dt_raw, a[:, :2], bmat, cmat, dout, hsave), ValueError),
        ("gated", (*args, dout.to(torch.bfloat16), hsave), TypeError),
        ("gated", (*args, dout, hsave.transpose(2, 3)), ValueError),
        ("gated", (x1, z.to(torch.bfloat16), dt_raw, dt_bias, a, bmat, cmat, dd, dout, hsave),
         TypeError),
        ("scan", (x1, dt_raw, a, bmat, cmat, dout,
                  residuals.placeholder(hsave.shape, hsave.device)), ValueError),
        ("gated", (*args, dout, residuals.placeholder(hsave.shape, hsave.device)), ValueError),
    ]
    # a one-element placeholder too: B = 1, S <= 4, n = 1, di = 1
    args, dout = _scan_args(1, 3, 1, 1, torch.float32, 9)
    cases.append(("gated", (*args, dout, residuals.placeholder((1, 1, 1, 1), dout.device)),
                  ValueError))
    return cases


@pytest.mark.parametrize("case", range(19))
def test_the_backward_wrappers_refuse_what_the_kernels_do_not_take(case):
    """The backward entries refuse, on the CPU as on the card, residuals,
    saved states and output gradients of the wrong shape or dtype, what
    the forward entries refuse, and the placeholders of a forward that
    wrote no residuals."""
    cases = _bwd_refusals()
    assert len(cases) == 19
    entry, args, error = cases[case]
    fn = {"slstm": SS.slstm_scan_bwd, "scan": SEL.selective_scan_bwd,
          "gated": SEL.selective_scan_gated_bwd}[entry]
    with pytest.raises(error):
        fn(*args)


def test_scan_probe_bwd_patches_apply():
    """``scan_probe --bwd --split`` patches the sLSTM backward's source by
    text: every variant still finds its anchors and differs from the kernel
    and from the others, and the instrumented copy marks every section
    once, its product threads' and its cell threads' positions counted."""
    import re

    from repro_torch.kernels import scan_probe

    src = scan_probe.BWD_SOURCE.read_text()
    design = scan_probe.bwd_design(src)
    assert design["sections"] == scan_probe.BWD_SECTIONS
    sources = scan_probe.bwd_patches(src)
    kernel = sources.pop("kernel")
    assert kernel == src
    assert set(sources) == set(design["variants"]) - {"kernel"} | {"sections"}
    assert {"no product", "no exchange", "no cell math", "no residual prefetch"} <= set(sources)
    assert all(text != kernel for text in sources.values())
    assert len(set(sources.values())) == len(sources)
    marks = [int(m) for m in re.findall(r"MARK\((\d+)\);", sources["sections"])]
    assert sorted(marks) == list(range(len(scan_probe.BWD_SECTIONS)))
    assert sources["sections"].count("probe[15] += 1;") == 1
    assert sources["sections"].count("probe[14] += 1;") == 1


def test_scan_probe_selective_bwd_patches_apply():
    """``scan_probe --bwd --split selective`` patches the selective
    backward's source by text: every variant still finds its anchors and
    differs from the kernel and from the others, and the instrumented copy
    marks every section once and counts the stages' positions once."""
    import re

    from repro_torch.kernels import scan_probe

    sources = scan_probe.sel_bwd_patches()
    kernel = sources.pop("kernel")
    assert kernel == scan_probe.SEL_BWD_SOURCE.read_text()
    assert set(sources) == set(scan_probe.SEL_BWD_VARIANTS) - {"kernel"} | {"sections"}
    assert {"no recompute", "no exponential", "no channel sums",
            "no part stores, no second launch", "no saved-state loads"} <= set(sources)
    assert all(text != kernel for text in sources.values())
    assert len(set(sources.values())) == len(sources)
    marks = [int(m) for m in re.findall(r"MARK\((\d+)\);", sources["sections"])]
    assert sorted(marks) == list(range(len(scan_probe.SEL_BWD_SECTIONS)))
    assert sources["sections"].count("probe[15] += np;") == 1


def test_residuals_are_skipped_only_inside_the_context():
    """``residuals.skipped`` (what ``lm._remat``'s first forward runs under)
    nests and restores; a placeholder owns no memory."""
    assert residuals.wanted()
    with residuals.skipped():
        assert not residuals.wanted()
        with residuals.skipped():
            assert not residuals.wanted()
        assert not residuals.wanted()
    assert residuals.wanted()
    ph = residuals.placeholder((3, 4, 5), torch.device("cpu"))
    assert ph.shape == (3, 4, 5) and ph.dtype == torch.float32 and ph.stride() == (0, 0, 0)
