"""The recurrent mixers' scan kernels on the card: ``selective_scan`` and
``slstm_scan`` against their plain versions (``kernels/ref.py``) on CUDA
tensors at small shapes, at a ragged sequence length and at one full-width
layer of each config (jamba-1.5-large's mamba, xlstm-350m's sLSTM), equal
bits on reruns, and a backward through either kernel raising; the gated
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
from repro_torch.kernels import slstm_scan as SS
from repro_torch.kernels.selective_scan import selective_scan, selective_scan_gated
from repro_torch.kernels.slstm_scan import slstm_scan
from repro_torch.models import ssm
from repro_torch.models.params import init_params
from repro_torch.runtime.guards import LAUNCH_COUNTS

SCAN_TOL = 1e-5


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


@pytest.mark.cuda
def test_a_gradient_through_either_kernel_raises(cuda):
    """A CUDA tensor that needs a gradient runs the kernel under autograd,
    and the backward raises, naming ROADMAP A7.4b: no plain fallback."""
    x1, dt, a, bmat, cmat = _mamba_inputs(1, 8, 32, 4, torch.float32, 7, cuda)
    dt.requires_grad_()
    before = LAUNCH_COUNTS["selective_scan"]
    ys = selective_scan(x1, dt, a, bmat, cmat)
    assert LAUNCH_COUNTS["selective_scan"] == before + 1 and ys.requires_grad
    with pytest.raises(NotImplementedError, match="ROADMAP A7.4b"):
        ys.sum().backward()
    args = _gated_inputs(1, 8, 32, 4, torch.bfloat16, 7, cuda)
    args[3].requires_grad_()  # dt_bias
    before = LAUNCH_COUNTS["selective_scan"]
    out = selective_scan_gated(*args)
    assert LAUNCH_COUNTS["selective_scan"] == before + 1 and out.requires_grad
    with pytest.raises(NotImplementedError, match="ROADMAP A7.4b"):
        out.float().sum().backward()
    xproj, wr, bias = _slstm_inputs(1, 8, 2, 8, torch.float32, 8, cuda)
    wr.requires_grad_()
    hs = slstm_scan(xproj, wr, bias)
    with pytest.raises(NotImplementedError, match="ROADMAP A7.4b"):
        hs.sum().backward()


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
