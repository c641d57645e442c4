"""The recurrent mixers' scan kernels on the card: ``selective_scan`` and
``slstm_scan`` against their plain versions (``kernels/ref.py``) on CUDA
tensors at small shapes, at a ragged sequence length and at one full-width
layer of each config (jamba-1.5-large's mamba, xlstm-350m's sLSTM), equal
bits on reruns; the backward kernels against their plain backwards at the
same shapes and widths, through autograd and under remat; the gated
``selective_scan_gated`` against the same ops around the scan-only kernel,
bit for bit (the kernel rounds the softplus, skip, gate and cast as torch's
CUDA ops do: ``expf``, ``log1pf`` and IEEE division, no contraction).  Needs an
NVIDIA GPU (``cuda`` marker; skips without one).  Imports nothing of JAX:
the CPU twins against the reference are in ``test_torch_ssm.py``.

Tolerance, float32, of the output's largest magnitude: ``SCAN_TOL`` 1e-5.
selective_scan: the states equal the plain version's bit for bit (the same
float32 products, ``expf`` and sums, none contracted into an FMA); the
output adds its n <= 16 terms in another order than cuBLAS's einsum, at
most 2 gamma_16 = 1.9e-6 of their absolute sum.  slstm_scan: the recurrent
product adds its uh <= 256 terms in another order than cuBLAS's (fmaf
chains over slices of u, added in slice order: ``slstm_scan.plan``'s
``slice``, which depends on uh alone); the layer's recurrence does not
amplify that (two float32 orders of the same product stay within 3.6e-7 of
the scale over 2,048 steps at xlstm-350m's width and initial scales; the
CPU emulation of the kernel's order is held against the reference in
``test_torch_ssm.py``), and the gates round as the plain version does.
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import measure, ref
from repro_torch.kernels import selective_scan as SEL
from repro_torch.kernels import slstm_scan as SS
from repro_torch.kernels.selective_scan import selective_scan, selective_scan_gated
from repro_torch.kernels.slstm_scan import slstm_scan
from repro_torch.models import ssm
from repro_torch.models.params import init_params
from repro_torch.runtime.guards import LAUNCH_COUNTS

SCAN_TOL = 1e-5
# The backward kernels against their plain backwards, float32, of each
# gradient's largest magnitude (chip_smoke.py's TRAIN_TOL["float32"]): the
# sums over channels, positions, rows and gate columns run in other orders
# than torch's, and the sLSTM's recurrent product's order reaches every
# earlier position's gradient.
SCAN_GRAD_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _mamba_inputs(b, s, di, n, x_dtype, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x1 = ref.silu(torch.randn((b, s, di), generator=gen, device=dev)).to(x_dtype)
    dt = ref.softplus(torch.randn((b, s, di), generator=gen, device=dev) - 1)
    a = -torch.exp(torch.rand((di, n), generator=gen, device=dev) * 2)
    bmat = torch.randn((b, s, n), generator=gen, device=dev)
    cmat = torch.randn((b, s, n), generator=gen, device=dev)
    return x1, dt, a, bmat, cmat


def _gated_inputs(b, s, di, n, dtype, seed, dev):
    """x1, z (a view of a (B, S, 2 di) in_proj output, as mamba_train's),
    the raw dt, dt_bias, a, bmat, cmat and dd."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x1 = ref.silu(torch.randn((b, s, di), generator=gen, device=dev)).to(dtype)
    z = torch.randn((b, s, 2 * di), generator=gen, device=dev).to(dtype)[..., di:]
    dt_raw = torch.randn((b, s, di), generator=gen, device=dev) - 1
    dt_bias = torch.randn((di,), generator=gen, device=dev) * 0.5
    a = -torch.exp(torch.rand((di, n), generator=gen, device=dev) * 2)
    bmat = torch.randn((b, s, n), generator=gen, device=dev)
    cmat = torch.randn((b, s, n), generator=gen, device=dev)
    dd = torch.randn((di,), generator=gen, device=dev)
    return x1, z, dt_raw, dt_bias, a, bmat, cmat, dd


def _composition(*args):
    """mamba_train's ops around the scan-only kernel: ref.softplus, the
    kernel, the skip term, the gate and the cast, as torch's ops round them."""
    return ref.selective_scan_gated_plain(*args, args[0].dtype, scan=selective_scan)


def _slstm_inputs(b, s, hh, uh, dtype, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    xproj = torch.randn((b, s, 4 * hh * uh), generator=gen, device=dev).to(dtype)
    wr = (torch.randn((hh, uh, 4 * uh), generator=gen, device=dev) / uh ** 0.5).to(dtype)
    bias = (torch.randn((4 * hh * uh,), generator=gen, device=dev) * 0.1).to(dtype)
    return xproj, wr, bias


def _close(got, want):
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= SCAN_TOL * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,di,n", [(2, 40, 128, 4), (3, 37, 200, 16), (1, 1, 64, 1),
                                      (2, 70, 96, 7)])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_kernel_matches_plain(cuda, b, s, di, n, x_dtype):
    """Small shapes, ragged S (37, 70: not a multiple of the kernel's
    64-position rounds), di off the block's 128, n from 1 to 16; one launch
    counted; equal bits on a rerun."""
    args = _mamba_inputs(b, s, di, n, x_dtype, 1, cuda)
    before = LAUNCH_COUNTS["selective_scan"]
    got = selective_scan(*args)
    assert LAUNCH_COUNTS["selective_scan"] == before + 1
    _close(got, ref.selective_scan_plain(*args, chunk=16))
    assert torch.equal(got, selective_scan(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,di,n", [(2, 40, 128, 4), (3, 37, 200, 16), (1, 1, 64, 1),
                                      (2, 70, 96, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_gated_kernel_equals_the_composition(cuda, b, s, di, n, dtype):
    """The gated entry (softplus of the raw dt, the scan, skip, gate and
    cast in one kernel) against the same ops around the scan-only kernel:
    equal bits; one launch counted a call, and no memory allocated but the
    output (z read in place as a view, no float32 dt or ys); equal bits on
    a rerun."""
    args = _gated_inputs(b, s, di, n, dtype, 13, cuda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before, held = LAUNCH_COUNTS["selective_scan"], torch.cuda.memory_allocated()
    got = selective_scan_gated(*args)
    assert LAUNCH_COUNTS["selective_scan"] == before + 1
    assert torch.cuda.max_memory_allocated() - held == torch.cuda.memory_allocated() - held
    assert torch.cuda.memory_allocated() - held >= got.numel() * got.element_size()
    assert got.dtype == dtype and got.shape == (b, s, di) and bool(torch.isfinite(got).all())
    assert torch.equal(got, _composition(*args))
    assert torch.equal(got, selective_scan_gated(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,hh,uh", [(2, 20, 4, 16), (3, 37, 2, 8), (1, 1, 1, 1),
                                       (2, 9, 3, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slstm_scan_kernel_matches_plain(cuda, b, s, hh, uh, dtype):
    """Small shapes, ragged S, 4 uh off a warp's 32 (uh 1, 8, 40); one
    launch counted; equal bits on a rerun."""
    args = _slstm_inputs(b, s, hh, uh, dtype, 2, cuda)
    before = LAUNCH_COUNTS["slstm_scan"]
    got = slstm_scan(*args)
    assert LAUNCH_COUNTS["slstm_scan"] == before + 1
    _close(got, ref.slstm_scan_plain(*args))
    assert torch.equal(got, slstm_scan(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,hh,uh,dtype", [
    (16, 64, 4, 256, torch.float32),  # f32 wr at uh = 256: the largest shared memory
    (3, 40, 4, 256, torch.bfloat16),  # B = 3 at xlstm-350m's 4 x 256
    (5, 40, 4, 256, torch.bfloat16),  # groups of 1, 2 and 2 rows: the first not filled
    (2, 33, 2, 70, torch.bfloat16),   # 70 units over 4 CTAs (17, 18, 17, 18): unaligned h stores
    (2, 33, 2, 70, torch.float32),
])
def test_slstm_scan_kernel_at_the_plans_edges(cuda, b, s, hh, uh, dtype):
    """The plans' edges: the largest shared memory, row groups the batch
    does not fill, a uh the cluster does not divide; against the plain
    version, one launch counted and one device event a call, equal bits on
    a rerun."""
    args = _slstm_inputs(b, s, hh, uh, dtype, 11, cuda)
    p = SS.card_plan(cuda.index or 0, SS._DTYPE_CODES[dtype], SS._DTYPE_CODES[dtype], b, hh, uh)
    if (b, uh) == (5, 256):
        assert min(count for _, count in p.row_ranges(b)) < p.rows
    if uh == 70:
        assert p.cluster == 4 and uh % p.cluster
    before = LAUNCH_COUNTS["slstm_scan"]
    got = slstm_scan(*args)
    assert LAUNCH_COUNTS["slstm_scan"] == before + 1
    _close(got, ref.slstm_scan_plain(*args))
    assert torch.equal(got, slstm_scan(*args))
    assert measure.device_events(torch, lambda: slstm_scan(*args)) == 1


@pytest.mark.cuda
def test_slstm_scan_rows_do_not_depend_on_the_plan(cuda):
    """The sum's order depends on uh alone, so a row's hs is the same bits
    whatever batch (and so plan) it runs in: 16 rows (two halves of three
    groups) against each row alone and against the first five."""
    x, wr, bias = _slstm_inputs(16, 48, 4, 256, torch.bfloat16, 12, cuda)
    full = slstm_scan(x, wr, bias)
    assert torch.equal(full[:5], slstm_scan(x[:5], wr, bias))
    for i in (0, 7, 15):
        assert torch.equal(full[i:i + 1], slstm_scan(x[i:i + 1], wr, bias))


@pytest.mark.cuda
def test_selective_scan_at_jamba_width(cuda):
    """One jamba-1.5-large mamba layer's scan at full width (di 16,384, n
    16), bf16 x1, 2 rows of 300 positions, on the layer's own gates from
    random bf16 weights."""
    cfg = get_config("jamba-1.5-large-398b")
    p = init_params(ssm.mamba_params(cfg), torch.bfloat16, seed=3, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(4)
    x1 = ref.silu(torch.randn((2, 300, cfg.ssm_expand * cfg.d_model), generator=gen,
                              device=cuda)).to(torch.bfloat16)
    bmat, cmat, dt, a = ssm._mamba_gates(p, x1)
    got = selective_scan(x1, dt, a, bmat, cmat)
    _close(got, ref.selective_scan_plain(x1, dt, a, bmat, cmat, chunk=128))
    assert torch.equal(got, selective_scan(x1, dt, a, bmat, cmat))


@pytest.mark.cuda
def test_selective_scan_gated_at_jamba_width(cuda):
    """One jamba-1.5-large mamba layer at full width through mamba_train's
    own inputs (bf16 weights, 2 rows of 300 positions): the gated entry
    against the composition around the scan-only kernel, equal bits, and
    the scan-only kernel against its plain version."""
    cfg = get_config("jamba-1.5-large-398b")
    p = init_params(ssm.mamba_params(cfg), torch.bfloat16, seed=3, device=cuda)
    p = {**p, "dt_bias": p["dt_bias"] + 0.1, "dd": p["dd"] * 0.5}  # neither 0 nor 1
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((2, 300, cfg.d_model), generator=gen, device=cuda).to(torch.bfloat16)
    args = ssm.mamba_gated_inputs(p, cfg, x)
    got = selective_scan_gated(*args, torch.bfloat16)
    assert torch.equal(got, _composition(*args))
    x1, _, dt, a, bmat, cmat = ssm.mamba_scan_inputs(p, cfg, x)
    _close(selective_scan(x1, dt, a, bmat, cmat),
           ref.selective_scan_plain(x1, dt, a, bmat, cmat, chunk=128))


@pytest.mark.cuda
def test_slstm_scan_at_xlstm_width(cuda):
    """One xlstm-350m sLSTM layer's scan at full width (4 heads of 256
    units), bf16 weights at the model's initial scales, 2 rows of 300
    positions of the layer's input projection."""
    cfg = get_config("xlstm-350m")
    p = init_params(ssm.slstm_params(cfg), torch.bfloat16, seed=5, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn((2, 300, cfg.d_model), generator=gen, device=cuda).to(torch.bfloat16)
    xproj = torch.einsum("bsd,dg->bsg", ssm.rmsnorm(p["ln"], x), p["wx"])
    got = slstm_scan(xproj, p["wr"], p["bias"])
    _close(got, ref.slstm_scan_plain(xproj, p["wr"], p["bias"]))
    assert torch.equal(got, slstm_scan(xproj, p["wr"], p["bias"]))


def _grad_close(got, want, what=""):
    """A gradient against its plain version: float32 within SCAN_GRAD_TOL
    of the gradient's largest magnitude; a bfloat16 one (dx1, dz, dxproj
    of bf16 inputs, rounded once from float32) also within one bf16 ulp of
    each element, 2^-7 of it, as two float32 values that close may round to
    neighbouring bf16 values."""
    assert got.dtype == want.dtype and got.shape == want.shape, what
    g, w = got.float(), want.float()
    assert bool(torch.isfinite(g).all()), what
    scale = float(w.abs().max())
    slack = SCAN_GRAD_TOL * scale + (2.0 ** -7 * w.abs() if got.dtype == torch.bfloat16 else 0)
    err = (g - w).abs() - slack
    assert not bool((err > 0).any()), (what, float((g - w).abs().max()), scale)


SLSTM_BWD_SHAPES = [(2, 20, 4, 16), (3, 37, 2, 8), (1, 1, 1, 1), (2, 9, 3, 40), (2, 33, 2, 70),
                    (5, 40, 4, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,hh,uh", SLSTM_BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slstm_scan_bwd_kernel_matches_plain(cuda, b, s, hh, uh, dtype):
    """The backward kernel (from the forward kernel's residuals) against
    the plain backward (from the plain forward's), ragged S, uh off the
    cluster's division (70 over 4 CTAs), 5 rows in uneven groups; the
    residuals against the plain forward's, hs with residuals the same bits
    as without; one counted launch a call; equal bits on a rerun."""
    xproj, wr, bias = _slstm_inputs(b, s, hh, uh, dtype, 21, cuda)
    hs, pre, states = SS.slstm_scan_residuals(xproj, wr, bias)
    assert torch.equal(hs, slstm_scan(xproj, wr, bias))
    p_hs, p_pre, p_states = ref.slstm_scan_fwd_plain(xproj, wr, bias)
    for got, want in zip((hs, pre, *states[:2]), (p_hs, p_pre, *p_states[:2])):
        _close(got, want)
    dhs = torch.randn(hs.shape, generator=torch.Generator(device=cuda).manual_seed(22),
                      device=cuda)
    before = LAUNCH_COUNTS["slstm_scan_bwd"]
    got = SS.slstm_scan_bwd(xproj, wr, bias, pre, states, hs, dhs)
    assert LAUNCH_COUNTS["slstm_scan_bwd"] == before + 1
    want = ref.slstm_scan_bwd_plain(xproj, wr, bias, p_pre, p_states, p_hs, dhs)
    for name, g, w in zip(("dxproj", "dwr", "dbias"), got, want):
        _grad_close(g, w, name)
    again = SS.slstm_scan_bwd(xproj, wr, bias, pre, states, hs, dhs)
    assert all(torch.equal(g, g2) for g, g2 in zip(got, again))


def _slstm_bwd_case(b, s, hh, uh, dtype, seed, dev):
    """Inputs, the forward kernel's residuals and a seeded dhs."""
    xproj, wr, bias = _slstm_inputs(b, s, hh, uh, dtype, seed, dev)
    hs, pre, states = SS.slstm_scan_residuals(xproj, wr, bias)
    dhs = torch.randn(hs.shape, generator=torch.Generator(device=dev).manual_seed(seed + 1),
                      device=dev)
    return xproj, wr, bias, hs, pre, states, dhs


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,hh,uh,dtype", [
    (16, 64, 4, 256, torch.float32),  # f32 wr at uh = 256: the largest shared memory
    (3, 40, 4, 256, torch.bfloat16),  # B = 3 at xlstm-350m's 4 x 256
    (5, 40, 4, 256, torch.bfloat16),  # groups of 1, 2 and 2 rows: the first not filled
    (2, 33, 2, 70, torch.bfloat16),   # 70 units over 4 CTAs (17, 18, 17, 18): scalar sends
    (2, 33, 2, 70, torch.float32),
])
def test_slstm_scan_bwd_kernel_at_the_plans_edges(cuda, b, s, hh, uh, dtype):
    """The backward plan's edges, as the forward's: the largest shared
    memory, row groups the batch does not fill, a uh the cluster does not
    divide (each unit's partial sent to its owner alone); against the plain
    backward, one launch counted a call, equal bits on a rerun, and the dpre
    kernel allocating nothing but dpre (no copy of a contiguous input; the
    allocator may round dpre's block up)."""
    xproj, wr, bias, hs, pre, states, dhs = _slstm_bwd_case(b, s, hh, uh, dtype, 31, cuda)
    p = SS.card_plan(cuda.index or 0, 0, SS._DTYPE_CODES[dtype], b, hh, uh, backward=True)
    if (b, uh) == (5, 256):
        assert min(count for _, count in p.row_ranges(b)) < p.rows
    if uh == 70:
        assert p.cluster == 4 and uh % p.cluster
    before = LAUNCH_COUNTS["slstm_scan_bwd"]
    got = SS.slstm_scan_bwd(xproj, wr, bias, pre, states, hs, dhs)
    assert LAUNCH_COUNTS["slstm_scan_bwd"] == before + 1
    p_hs, p_pre, p_states = ref.slstm_scan_fwd_plain(xproj, wr, bias)
    want = ref.slstm_scan_bwd_plain(xproj, wr, bias, p_pre, p_states, p_hs, dhs)
    for name, g, w in zip(("dxproj", "dwr", "dbias"), got, want):
        _grad_close(g, w, name)
    again = SS.slstm_scan_bwd(xproj, wr, bias, pre, states, hs, dhs)
    assert all(torch.equal(g, g2) for g, g2 in zip(got, again))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    dpre = SS._launch_bwd(wr, pre, states, dhs)
    assert torch.cuda.max_memory_allocated() == torch.cuda.memory_allocated()
    assert torch.cuda.memory_allocated() - held >= dpre.numel() * 4


@pytest.mark.cuda
def test_slstm_scan_bwd_rows_do_not_depend_on_the_plan(cuda):
    """The backward's sums run in an order that depends on uh alone, so a
    row's dpre is the same bits whatever batch (and so plan) it runs in: 16
    rows against each row alone and against the first five."""
    xproj, wr, bias, hs, pre, states, dhs = _slstm_bwd_case(16, 48, 4, 256, torch.bfloat16, 12,
                                                            cuda)
    full = SS._launch_bwd(wr, pre, states, dhs)

    def rows(i, j):
        return SS._launch_bwd(wr, pre[i:j], tuple(t[i:j] for t in states), dhs[i:j])

    assert torch.equal(full[:5], rows(0, 5))
    for i in (0, 7, 15):
        assert torch.equal(full[i:i + 1], rows(i, i + 1))


@pytest.mark.cuda
def test_slstm_scan_bwd_reruns_give_equal_bits(cuda):
    """No float atomics: three runs of the backward at xlstm-350m's width
    and training microbatch (4 rows of 300 positions, bf16) give equal bits
    in all three gradients, and through autograd the same bits again."""
    xproj, wr, bias, hs, pre, states, dhs = _slstm_bwd_case(4, 300, 4, 256, torch.bfloat16, 41,
                                                            cuda)
    runs = [SS.slstm_scan_bwd(xproj, wr, bias, pre, states, hs, dhs) for _ in range(3)]
    assert all(torch.equal(a, b) for run in runs[1:] for a, b in zip(runs[0], run))
    leaves = [t.clone().requires_grad_() for t in (xproj, wr, bias)]
    got = torch.autograd.grad(slstm_scan(*leaves), leaves, dhs)
    assert all(torch.equal(a, b) for a, b in zip(runs[0], got))


# Ragged S against the 4-position stage (37, 1, 70, 6, 33), di off the
# backward's 64-channel tile (200, 96, 72), n of 1, 7, 13 and 16 (a lane
# holding 1, 2, 4 and 4 of a channel's states, padded), and a full-width
# row whose 64 units are fewer than the card's SMs (4,096 channels).
SEL_BWD_SHAPES = [(2, 40, 128, 4), (3, 37, 200, 16), (1, 1, 64, 1), (2, 70, 96, 7),
                  (1, 6, 72, 16), (2, 33, 64, 13), (1, 300, 4096, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,di,n", SEL_BWD_SHAPES)
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_bwd_kernel_matches_plain(cuda, b, s, di, n, x_dtype):
    """The scan-only backward: the saved states equal
    ``ref.selective_scan_states`` bit for bit and ys is the same bits with
    them; the kernel's gradients against the plain backward's; one counted
    call; equal bits on a rerun.  Ragged S, di off the 128-channel tile, n
    1 to 16 (n 1 and 7 take the plain loads, not the bulk copies)."""
    x1, dt, a, bmat, cmat = _mamba_inputs(b, s, di, n, x_dtype, 23, cuda)
    ys, hsave = SEL.selective_scan_states_of(x1, dt, a, bmat, cmat)
    assert torch.equal(ys, selective_scan(x1, dt, a, bmat, cmat))
    assert torch.equal(hsave, ref.selective_scan_states(x1, dt, a, bmat))
    dys = torch.randn(ys.shape, generator=torch.Generator(device=cuda).manual_seed(24),
                      device=cuda)
    before = LAUNCH_COUNTS["selective_scan_bwd"]
    got = SEL.selective_scan_bwd(x1, dt, a, bmat, cmat, dys, hsave)
    assert LAUNCH_COUNTS["selective_scan_bwd"] == before + 1
    want = ref.selective_scan_bwd_plain(x1, dt, a, bmat, cmat, dys)
    for name, g, w in zip(("dx1", "ddt", "da", "dbmat", "dcmat"), got, want):
        _grad_close(g, w, name)
    again = SEL.selective_scan_bwd(x1, dt, a, bmat, cmat, dys, hsave)
    assert all(torch.equal(g, g2) for g, g2 in zip(got, again))


def _gated_states(args):
    """The gated forward's output and saved states for selective_scan_gated's
    arguments (x1, z, dt_raw, dt_bias, a, bmat, cmat, dd)."""
    x1, z, dt_raw, dt_bias, a, bmat, cmat, dd = args
    return SEL.selective_scan_states_of(x1, dt_raw, a, bmat, cmat, z, dt_bias, dd)


GATED_GRADS = ("dx1", "dz", "ddt_raw", "ddt_bias", "da", "dbmat", "dcmat", "ddd")


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,di,n", SEL_BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_gated_bwd_kernel_matches_plain(cuda, b, s, di, n, dtype):
    """The gated backward (the epilogue and the softplus differentiated in
    the kernel; z a view of the in_proj output) against the plain
    backward's eight gradients; the gated output is the same bits with the
    states saved; one counted call; equal bits on a rerun."""
    args = _gated_inputs(b, s, di, n, dtype, 25, cuda)
    out, hsave = _gated_states(args)
    assert torch.equal(out, selective_scan_gated(*args))
    dout = torch.randn(out.shape, generator=torch.Generator(device=cuda).manual_seed(26),
                       device=cuda).to(dtype)
    before = LAUNCH_COUNTS["selective_scan_bwd"]
    got = SEL.selective_scan_gated_bwd(*args, dout, hsave)
    assert LAUNCH_COUNTS["selective_scan_bwd"] == before + 1
    want = ref.selective_scan_gated_bwd_plain(*args, dout)
    for name, g, w in zip(GATED_GRADS, got, want):
        _grad_close(g, w, name)
    again = SEL.selective_scan_gated_bwd(*args, dout, hsave)
    assert all(torch.equal(g, g2) for g, g2 in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("gated", [False, True])
def test_selective_scan_bwd_rows_do_not_depend_on_the_batch(cuda, gated):
    """A row's gradients are the same bits alone as inside a batch of 3
    (ragged S, di off the tile, bf16): every gradient but the sums over
    rows (da, and gated ddd and ddt_bias)."""
    b, s, di, n = 3, 70, 200, 16
    if gated:
        args = _gated_inputs(b, s, di, n, torch.bfloat16, 31, cuda)
        _, hsave = _gated_states(args)
        dout = torch.randn((b, s, di), generator=torch.Generator(device=cuda).manual_seed(32),
                           device=cuda).to(torch.bfloat16)
        grad, per_row = SEL.selective_scan_gated_bwd, GATED_GRADS
        shared = (3, 4, 7)  # ddt_bias, da, ddd
    else:
        x1, dt, a, bmat, cmat = _mamba_inputs(b, s, di, n, torch.bfloat16, 31, cuda)
        args = (x1, dt, a, bmat, cmat)
        _, hsave = SEL.selective_scan_states_of(*args)
        dout = torch.randn((b, s, di), generator=torch.Generator(device=cuda).manual_seed(32),
                           device=cuda)
        grad, per_row = SEL.selective_scan_bwd, ("dx1", "ddt", "da", "dbmat", "dcmat")
        shared = (2,)  # da
    full = grad(*args, dout, hsave)
    for i in range(b):
        rows = [t[i:i + 1] if t.dim() == 3 else t for t in args]
        alone = grad(*rows, dout[i:i + 1], hsave[i:i + 1])
        for j, name in enumerate(per_row):
            if j not in shared:
                assert torch.equal(full[j][i:i + 1], alone[j]), (i, name)


@pytest.mark.cuda
def test_backward_kernels_at_full_width(cuda):
    """One xlstm-350m sLSTM layer (4 heads of 256 units, bf16 weights at the
    model's initial scales, 2 rows of 300 positions) and one
    jamba-1.5-large mamba layer (di 16,384, n 16, 1 row of 300, through
    mamba_train's own inputs): each backward kernel against its plain
    backward."""
    cfg = get_config("xlstm-350m")
    p = init_params(ssm.slstm_params(cfg), torch.bfloat16, seed=5, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn((2, 300, cfg.d_model), generator=gen, device=cuda).to(torch.bfloat16)
    xproj = ssm.slstm_scan_input(p, x)
    hs, pre, states = SS.slstm_scan_residuals(xproj, p["wr"], p["bias"])
    dhs = torch.randn(hs.shape, generator=gen, device=cuda)
    got = SS.slstm_scan_bwd(xproj, p["wr"], p["bias"], pre, states, hs, dhs)
    p_hs, p_pre, p_states = ref.slstm_scan_fwd_plain(xproj, p["wr"], p["bias"])
    want = ref.slstm_scan_bwd_plain(xproj, p["wr"], p["bias"], p_pre, p_states, p_hs, dhs)
    for name, g, w in zip(("dxproj", "dwr", "dbias"), got, want):
        _grad_close(g, w, name)
    cfg = get_config("jamba-1.5-large-398b")
    p = init_params(ssm.mamba_params(cfg), torch.bfloat16, seed=3, device=cuda)
    p = {**p, "dt_bias": p["dt_bias"] + 0.1, "dd": p["dd"] * 0.5}
    x = torch.randn((1, 300, cfg.d_model), generator=gen, device=cuda).to(torch.bfloat16)
    args = ssm.mamba_gated_inputs(p, cfg, x)
    out, hsave = _gated_states(args)
    dout = torch.randn(out.shape, generator=gen, device=cuda).to(torch.bfloat16)
    got = SEL.selective_scan_gated_bwd(*args, dout, hsave)
    want = ref.selective_scan_gated_bwd_plain(*args, dout)
    for name, g, w in zip(GATED_GRADS, got, want):
        _grad_close(g, w, name)


@pytest.mark.cuda
def test_a_gradient_through_either_kernel_runs_its_backward_kernel(cuda):
    """A CUDA tensor that needs a gradient runs the kernel under autograd:
    the forward writes its residuals, the backward launches the backward
    kernel once, and the gradients are the explicit backward's bits."""
    x1, dt, a, bmat, cmat = _mamba_inputs(1, 8, 32, 4, torch.float32, 7, cuda)
    dt.requires_grad_()
    before = {k: LAUNCH_COUNTS[k] for k in ("selective_scan", SEL.RESIDUALS_COUNTER,
                                           "selective_scan_bwd")}
    ys = selective_scan(x1, dt, a, bmat, cmat)
    dys = torch.randn_like(ys)
    (g,) = torch.autograd.grad(ys, dt, dys)
    assert {k: LAUNCH_COUNTS[k] - v for k, v in before.items()} == {
        "selective_scan": 1, SEL.RESIDUALS_COUNTER: 1, "selective_scan_bwd": 1}
    _, hsave = SEL.selective_scan_states_of(x1, dt.detach(), a, bmat, cmat)
    assert torch.equal(g, SEL.selective_scan_bwd(x1, dt.detach(), a, bmat, cmat, dys,
                                                 hsave)[1])
    args = _gated_inputs(1, 8, 32, 4, torch.bfloat16, 7, cuda)
    args[3].requires_grad_()  # dt_bias
    out = selective_scan_gated(*args)
    dout = torch.randn_like(out)
    (g,) = torch.autograd.grad(out, args[3], dout)
    plain = [t.detach() for t in args]
    _, hsave = _gated_states(plain)
    assert torch.equal(g, SEL.selective_scan_gated_bwd(*plain, dout, hsave)[3])
    xproj, wr, bias = _slstm_inputs(1, 8, 2, 8, torch.float32, 8, cuda)
    wr.requires_grad_()
    before = LAUNCH_COUNTS["slstm_scan_bwd"]
    hs = slstm_scan(xproj, wr, bias)
    dhs = torch.randn_like(hs)
    (g,) = torch.autograd.grad(hs, wr, dhs)
    assert LAUNCH_COUNTS["slstm_scan_bwd"] == before + 1
    w = wr.detach()
    _, pre, states = SS.slstm_scan_residuals(xproj, w, bias)
    assert torch.equal(g, SS.slstm_scan_bwd(xproj, w, bias, pre, states, hs.detach(), dhs)[1])


@pytest.mark.cuda
def test_a_backward_from_a_forward_that_skipped_its_residuals_raises(cuda):
    """Outside a checkpoint, a forward under ``residuals.skipped`` saves
    placeholders; the backward refuses them rather than read zeros."""
    from repro_torch.kernels import residuals

    x1, dt, a, bmat, cmat = _mamba_inputs(1, 8, 32, 4, torch.float32, 7, cuda)
    dt.requires_grad_()
    xproj, wr, bias = _slstm_inputs(1, 8, 2, 8, torch.float32, 8, cuda)
    wr.requires_grad_()
    with residuals.skipped():
        ys = selective_scan(x1, dt, a, bmat, cmat)
        hs = slstm_scan(xproj, wr, bias)
    before = {k: LAUNCH_COUNTS[k] for k in ("selective_scan_bwd", "slstm_scan_bwd")}
    with pytest.raises(ValueError, match="placeholder"):
        torch.autograd.grad(ys, dt, torch.ones_like(ys))
    with pytest.raises(ValueError, match="placeholder"):
        torch.autograd.grad(hs, wr, torch.ones_like(hs))
    assert {k: LAUNCH_COUNTS[k] for k in before} == before


@pytest.mark.cuda
def test_remat_writes_residuals_only_in_the_recomputation(cuda):
    """xlstm-350m's smoke config and a one-block (mamba, MLP) cut of
    jamba-1.5-large's under ``remat="full"``: a loss gradient runs each
    scan's forward twice (the checkpointed forward, the recomputation),
    writes residuals once (the recomputation's), runs each backward kernel
    once, and gives the bits of ``remat="none"``."""
    import dataclasses

    from repro_torch.models import lm
    from repro_torch.models.params import tree_leaves, tree_unflatten

    jamba = get_config("jamba-1.5-large-398b", smoke=True)
    cut = dataclasses.replace(jamba, n_layers=1, n_periods=1, pattern=(("mamba", "mlp"),))
    for cfg, scan in ((get_config("xlstm-350m", smoke=True), SS), (cut, SEL)):
        params = lm.concrete_params(cfg, seed=3, device=cuda)
        tokens = torch.randint(0, cfg.vocab_size, (2, 24), device=cuda,
                               generator=torch.Generator(device=cuda).manual_seed(4))
        layers = sum(1 for m, _ in cfg.all_blocks if m in ("mamba", "slstm"))
        grads = {}
        for remat in ("full", "none"):
            c = dataclasses.replace(cfg, remat=remat)
            flat = [x.detach().requires_grad_() for x in tree_leaves(params)]
            names = (scan.NAME, scan.RESIDUALS_COUNTER, scan.BWD_NAME)
            before = {k: LAUNCH_COUNTS[k] for k in names}
            loss = lm.loss_fn(tree_unflatten(params, flat, dicts=True), c, {"tokens": tokens})
            grads[remat] = torch.autograd.grad(loss, flat)
            got = [LAUNCH_COUNTS[k] - before[k] for k in names]
            assert got == [layers * (2 if remat == "full" else 1), layers, layers], (remat, got)
        assert all(torch.equal(g, h) for g, h in zip(grads["full"], grads["none"]))


@pytest.mark.cuda
def test_the_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x1, dt, a, bmat, cmat = _mamba_inputs(1, 4, 32, 17, torch.float32, 9, cuda)
    with pytest.raises(ValueError):
        selective_scan(x1, dt, a, bmat, cmat)  # n = 17 > 16 states
    with pytest.raises(TypeError):
        selective_scan(x1, dt.half(), a, bmat, cmat)
    for n in (0, 17):
        x1, z, dt, bias, a, bmat, cmat, dd = _gated_inputs(1, 4, 32, 4, torch.bfloat16, 9, cuda)
        a = torch.zeros((32, n), device=cuda)
        bmat = cmat = torch.zeros((1, 4, n), device=cuda)
        with pytest.raises(ValueError):
            selective_scan_gated(x1, z, dt, bias, a, bmat, cmat, dd)
    x1, z, dt, bias, a, bmat, cmat, dd = _gated_inputs(1, 4, 32, 4, torch.bfloat16, 9, cuda)
    with pytest.raises(TypeError):
        selective_scan_gated(x1, z.float(), dt, bias, a, bmat, cmat, dd)
    with pytest.raises(TypeError):
        selective_scan_gated(x1, z, dt, bias, a, bmat, cmat, dd, torch.float32)
    with pytest.raises(ValueError):
        selective_scan_gated(x1, z, dt, bias[:16], a, bmat, cmat, dd)
    xproj, wr, bias = _slstm_inputs(1, 4, 1, 257, torch.float32, 10, cuda)
    with pytest.raises(ValueError):
        slstm_scan(xproj, wr, bias)  # uh = 257 > 256 units
