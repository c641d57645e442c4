"""The port's LM stack against the reference's: the plain flash-attention
version, the dense layers, ``lm.prefill`` and ``lm.decode_step`` on the
smoke configs, all on the CPU with the reference's weights carried across.
The flash-attention kernel itself runs only on the card (``cuda`` marker).

Tolerances: float32 variants ``rtol = 1e-4`` and ``atol = 1e-4`` times the
larger of 1 and the reference tensor's largest magnitude (the packages sum
in other orders, and the random smoke weights drive activations to ~20);
bf16 attention outputs 2e-2 (one bf16 ulp of values up to 2, the
reference's own interpret-vs-oracle bound in ``tests/test_kernels.py``);
bf16 models ``atol=0.15, rtol=0.05`` (``tests/test_models.py``'s).  A bf16
decode is held against the reference run op by op (``jax.disable_jit``),
which rounds where the port rounds: under ``jit`` XLA's fusions skip some
bf16 roundings, and the random smoke weights' sharp attention amplifies
those past the tolerance in gemma3's deeper blocks.
"""
import dataclasses
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as RL
from repro.models import lm as rlm
from repro.models.params import init_params as ref_init_params
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels.flash_attention import MAX_HEAD_DIM, flash_attention
from repro_torch.models import layers as TL
from repro_torch.models import lm as tlm
from repro_torch.models.params import ParamTree, leaves
from repro_torch.runtime.guards import LAUNCH_COUNTS

torch.set_num_threads(1)  # small tensors; leave the cores to the other xdist workers

F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_ATTN_TOL = dict(rtol=2e-2, atol=2e-2)
BF16_MODEL_TOL = dict(rtol=0.05, atol=0.15)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def assert_close(got, want, dtype: str, bf16=BF16_MODEL_TOL, err_msg: str = ""):
    got, want = _f32(got), _f32(want)
    if dtype == "float32":
        tol = dict(rtol=1e-4, atol=1e-4 * max(1.0, float(np.abs(want).max())))
    else:
        tol = bf16
    np.testing.assert_allclose(got, want, **tol, err_msg=err_msg)


def _pair(x: np.ndarray, dtype: str):
    """The same values as a jnp array and a torch tensor of ``dtype`` (both
    round float32 to bf16 to nearest even)."""
    jd, td = DTYPES[dtype]
    x = np.asarray(x, np.float32)
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


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
        node[path[-1]] = torch.from_numpy(_f32(x)).to(
            torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32)
    return ParamTree(out)


# ---------------------------------------------------------------------------
# Flash attention: the plain version (CPU) and the kernel (card)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,t", [(64, 64), (96, 96), (1, 96)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 32), (False, 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_reference(s, t, causal, window, dtype):
    """At ``tests/test_kernels.py::test_flash_attention``'s grid: the port's
    plain version against the reference's oracle and its Pallas kernel in
    interpret mode."""
    rng = np.random.default_rng(s * 1000 + t + 7 * window + causal)
    b, h, d = 2, 3, 64
    (jq, q), (jk, k), (jv, v) = (_pair(rng.standard_normal((b, h, n, d)), dtype)
                                 for n in (s, t, t))
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == (b, h, s, d)
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    pallas = jops.flash_attention(jq, jk, jv, causal=causal, window=window, backend="interpret")
    assert_close(got, want, dtype, BF16_ATTN_TOL)
    assert_close(got, pallas, dtype, BF16_ATTN_TOL)


def test_flash_attention_plain_takes_kv_groups_and_the_bshd_layout():
    """The plain version computes ``gqa_chunked``'s prefill call: grouped kv
    heads, (B, S, H, D) tensors, S < T, a window."""
    rng = np.random.default_rng(3)
    b, s, t, hq, hkv, d = 2, 9, 21, 6, 2, 16
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, s, hq, d), (b, t, hkv, d), (b, t, hkv, d)))
    for causal, window in ((True, 0), (True, 5), (False, 4)):
        want = RL.gqa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                              window=window, chunk=8)
        got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              causal=causal, window=window, layout="bshd")
        assert_close(got, want, "float32")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# (B, S, T, Hq, Hkv, D, causal, window): MHA and GQA, the specialised widths
# 64 and 128 and the general path (12, 168), S < T, ragged tiles.
KERNEL_CASES = [
    (2, 64, 64, 3, 3, 64, True, 0),
    (2, 96, 96, 3, 3, 64, True, 32),
    (2, 1, 96, 3, 3, 64, True, 0),
    (2, 96, 96, 3, 3, 64, False, 0),
    (1, 130, 200, 8, 2, 128, True, 0),
    (1, 77, 77, 4, 1, 168, True, 24),
    (3, 40, 65, 6, 3, 12, False, 17),
    (1, 300, 300, 4, 4, 256, True, 70),
    (1, 260, 260, 48, 8, 128, True, 0),  # internlm2-20b's heads: GQA 48 on 8, D=128
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", KERNEL_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_flash_attention_kernel_matches_plain(cuda, case, dtype, layout):
    """The kernel against its plain version on the card, on strided views
    (slices of one packed tensor, as a fused qkv projection gives them)."""
    b, s, t, hq, hkv, d, causal, window = case
    gen = torch.Generator(device=cuda).manual_seed(s * 31 + t)
    if layout == "bhsd":
        packed_q = torch.randn((b, hq, s, d + 8), generator=gen, device=cuda).to(dtype)
        packed_kv = torch.randn((b, hkv, t, 2, d), generator=gen, device=cuda).to(dtype)
        q, k, v = packed_q[..., :d], packed_kv[..., 0, :], packed_kv[..., 1, :]
        qp, kp, vp = q, k, v
    else:
        packed_q = torch.randn((b, s, hq, d + 8), generator=gen, device=cuda).to(dtype)
        packed_kv = torch.randn((b, t, 2, hkv, d), generator=gen, device=cuda).to(dtype)
        q, k, v = packed_q[..., :d], packed_kv[:, :, 0], packed_kv[:, :, 1]
        qp, kp, vp = (x.transpose(1, 2) for x in (q, k, v))
    assert not q.is_contiguous() and not k.is_contiguous()
    before = LAUNCH_COUNTS["flash_attention"]
    before_tc = LAUNCH_COUNTS[FA.TC_COUNTER]
    got = flash_attention(q, k, v, causal=causal, window=window, layout=layout)
    assert LAUNCH_COUNTS["flash_attention"] == before + 1
    # bf16 runs the tensor-core kernel, f32 the SIMT kernel.
    assert LAUNCH_COUNTS[FA.TC_COUNTER] == before_tc + (dtype == torch.bfloat16)
    want = ref.flash_attention_ref(qp, kp, vp, causal, window)
    if layout == "bshd":
        want = want.transpose(1, 2)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    tol = F32_TOL if dtype == torch.float32 else BF16_ATTN_TOL
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
def test_flash_attention_kernel_constants_and_refusals(cuda):
    lib = build.library("flash_attention")
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        assert lib.flash_attention_block_q(code) == FA.BLOCK_Q[dtype]
        for d in (1, 12, 64, 100, 128, 168, 192, 200, 256):
            width = lib.flash_attention_padded_dim(code, d)
            assert width == FA.launch_plan(dtype, (1, 1, 1, d), 1, 1, {}).width
            assert lib.flash_attention_block_k(code, d) == FA.block_k(dtype, width)
    assert lib.flash_attention_max_head_dim() == MAX_HEAD_DIM
    q = torch.randn((1, 2, 8, 16), device=cuda)
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :, :4], q[:, :, :4])  # S > T
    with pytest.raises(ValueError):
        flash_attention(q[..., ::2], q[..., ::2], q[..., ::2])  # D not contiguous
    with pytest.raises(NotImplementedError):
        TL.gqa_chunked(q, q, q, causal=True, q_positions=torch.arange(2, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [KERNEL_CASES[0], KERNEL_CASES[5], KERNEL_CASES[-1]])
def test_flash_attention_bf16_reruns_give_equal_bits(cuda, case):
    """Each row's sums run in a fixed order (no split over blocks, no
    atomics), so two launches on the same inputs agree bit for bit."""
    b, s, t, hq, hkv, d, causal, window = case
    gen = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn((b, s, hq, d), generator=gen, device=cuda).bfloat16()
    k, v = (torch.randn((b, t, hkv, d), generator=gen, device=cuda).bfloat16() for _ in "kv")
    first = flash_attention(q, k, v, causal=causal, window=window, layout="bshd")
    second = flash_attention(q, k, v, causal=causal, window=window, layout="bshd")
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_flash_attention_bf16_misaligned_views_are_copied(cuda):
    """At D=12 q's rows are 40 bytes apart and v starts 24 bytes into its
    packed tensor: TMA refuses both, so the wrapper copies them (and only
    them), and the result still matches the plain version."""
    b, s, t, hq, hkv, d = 3, 40, 65, 6, 3, 12
    gen = torch.Generator(device=cuda).manual_seed(12)
    packed_q = torch.randn((b, hq, s, d + 8), generator=gen, device=cuda).bfloat16()
    packed_kv = torch.randn((b, hkv, t, 2, d), generator=gen, device=cuda).bfloat16()
    q, k, v = packed_q[..., :d], packed_kv[..., 0, :], packed_kv[..., 1, :]
    before = LAUNCH_COUNTS[FA.COPY_COUNTER]
    got = flash_attention(q, k, v, causal=False, window=17)
    assert LAUNCH_COUNTS[FA.COPY_COUNTER] == before + 2
    want = ref.flash_attention_ref(q, k, v, False, 17)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **BF16_ATTN_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "internlm2-20b", "gemma3-27b"])
def test_prefill_on_the_card_matches_the_plain_chunked_loop(cuda, arch):
    """``lm.prefill`` through the kernel (every layer) against the same
    weights through ``gqa_chunked_plain`` on the card, float32."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    params = tlm.concrete_params(cfg, seed=1, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda)
    before = LAUNCH_COUNTS["flash_attention"]
    got = tlm.prefill(params, cfg, {"tokens": tokens})
    assert LAUNCH_COUNTS["flash_attention"] == before + cfg.n_layers
    kernel = TL.gqa_chunked
    try:
        TL.gqa_chunked = TL.gqa_chunked_plain
        want = tlm.prefill(params, cfg, {"tokens": tokens})
    finally:
        TL.gqa_chunked = kernel
    torch.testing.assert_close(got, want, **F32_TOL)


# ---------------------------------------------------------------------------
# The bf16 kernel's launch planning and rounding, on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,bf16_width,f32_width", [
    (1, 64, 64), (12, 64, 64), (64, 64, 64), (65, 128, 128), (128, 128, 128),
    (168, 192, 256), (192, 192, 256), (200, 256, 256), (256, 256, 256),
])
def test_flash_attention_plan_pads_the_head_dim(d, bf16_width, f32_width):
    tc = FA.launch_plan(torch.bfloat16, (2, 3, 300, d), 3, 300, {})
    simt = FA.launch_plan(torch.float32, (2, 3, 300, d), 3, 300, {})
    assert (tc.tensor_cores, tc.width, tc.block_q) == (True, bf16_width, 128)
    assert tc.block_k == (128 if bf16_width <= 128 else 64)
    assert (simt.tensor_cores, simt.width, simt.block_q, simt.block_k) == (False, f32_width, 64, 64)


@pytest.mark.parametrize("b,h,s", [(16, 32, 2048), (2, 3, 1), (1, 48, 129), (3, 6, 40)])
def test_flash_attention_plan_grid(b, h, s):
    """One work item per (b*h, q tile): 128-row tiles for bf16 (spread over
    persistent blocks), 64-row tiles for f32 (a block each)."""
    tc = FA.launch_plan(torch.bfloat16, (b, h, s, 64), h, s, {})
    simt = FA.launch_plan(torch.float32, (b, h, s, 64), h, s, {})
    assert tc.q_tiles == math.ceil(s / 128) and tc.work_items == tc.q_tiles * b * h
    assert simt.q_tiles == math.ceil(s / 64) and simt.work_items == simt.q_tiles * b * h
    with pytest.raises(ValueError):
        FA.launch_plan(torch.float32, (1, 1, 64 * 65536, 64), 1, 64 * 65536, {})
    with pytest.raises(ValueError):
        FA.launch_plan(torch.bfloat16, (1 << 16, 1 << 8, 128 * 256, 64), 1 << 8, 128 * 256, {})


def _views(q, k, v, layout):
    return {n: (x.data_ptr(), FA._dims(x, layout)[0][:3], FA._dims(x, layout)[1])
            for n, x in (("q", q), ("k", k), ("v", v))}


@pytest.mark.parametrize("layout,d,copies", [
    ("bhsd", 12, ("q", "v")), ("bshd", 12, ("q", "k", "v")),
    ("bhsd", 64, ()), ("bshd", 64, ()), ("bhsd", 128, ()), ("bshd", 128, ()),
    ("bhsd", 168, ()), ("bshd", 168, ()),
])
def test_flash_attention_plan_aligned_copies(layout, d, copies):
    """The cuda tests' strided views (slices of packed tensors): at D=12 q's
    rows are 40 bytes apart and v starts 24 bytes in (and in (B, S, H, D),
    k's heads are 24 bytes apart), so TMA needs copies; the serving widths
    need none.  Float32 never copies."""
    b, s, t, hq, hkv = 3, 40, 65, 6, 3
    if layout == "bhsd":
        packed_q = torch.zeros((b, hq, s, d + 8), dtype=torch.bfloat16)
        packed_kv = torch.zeros((b, hkv, t, 2, d), dtype=torch.bfloat16)
        q, k, v = packed_q[..., :d], packed_kv[..., 0, :], packed_kv[..., 1, :]
    else:
        packed_q = torch.zeros((b, s, hq, d + 8), dtype=torch.bfloat16)
        packed_kv = torch.zeros((b, t, 2, hkv, d), dtype=torch.bfloat16)
        q, k, v = packed_q[..., :d], packed_kv[:, :, 0], packed_kv[:, :, 1]
    views = _views(q, k, v, layout)
    assert FA.launch_plan(torch.bfloat16, (b, hq, s, d), hkv, t, views).copies == copies
    assert FA.launch_plan(torch.float32, (b, hq, s, d), hkv, t, views).copies == ()
    for name in copies:
        x = {"q": q, "k": k, "v": v}[name]
        y = FA._aligned_copy(x, layout)
        assert y.shape == FA._dims(x, layout)[0] and torch.equal(
            y, x.transpose(1, 2) if layout == "bshd" else x)
        assert not FA.needs_aligned_copy(y.data_ptr(), y.shape[:3], y.stride()[:3])
        assert y.stride()[:3] == FA._copy_strides(y.shape[:3], d)


@pytest.mark.parametrize("sizes,strides,want", [
    ((16, 32, 2048), (2048 * 32 * 64, 64, 32 * 64),  # (B, S, H, D) contiguous
     (32, 2048, 16, 64, 2048, 2048 * 32 * 64, 1 | 0 << 2 | 2 << 4)),
    ((2, 3, 96), (3 * 96 * 64, 96 * 64, 64),  # (B, H, S, D) contiguous
     (96, 3, 2, 64, 96 * 64, 3 * 96 * 64, 0 | 1 << 2 | 2 << 4)),
    ((1, 4, 1), (999, 24, 5),  # size-1 batch and rows: packed strides, last
     (4, 1, 1, 24, 96, 96, 1 | 0 << 2 | 2 << 4)),
])
def test_flash_attention_tma_axes(sizes, strides, want):
    assert FA.tma_axes(sizes, strides) == want


def _tc_emulation(q, k, v, causal, window):
    """The bf16 tensor-core kernel's arithmetic in plain torch, tile by tile:
    bf16 operands, f32 scores scaled after the product in the log2 domain,
    the online softmax over the kernel's k tiles (zero rows past T, masked
    logits -1e30), P rounded to bf16 before P V, l summing the f32
    probabilities, f32 accumulators and a bf16 output.  (B, H, S, D) q,
    (B, Hkv, T, D) k and v.  Sums run in another order than the tensor
    cores', and exp2 keeps results below 2^-126 that the kernel flushes."""
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    plan = FA.launch_plan(torch.bfloat16, (b, h, s, d), hkv, t, {})
    bq, bn = plan.block_q, plan.block_k
    scale_log2 = torch.tensor(math.log2(math.e) / math.sqrt(d), dtype=torch.float32)
    n_kt = -(-t // bn)
    pad = n_kt * bn - t
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad)).repeat_interleave(h // hkv, 1)
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad)).repeat_interleave(h // hkv, 1)
    out = torch.empty_like(q)
    for q0 in range(0, s, bq):
        pos = torch.arange(q0, min(q0 + bq, s)) + (t - s)
        q_lo, q_hi = int(pos[0]), int(pos[-1])
        kt_end = min(n_kt, q_hi // bn + 1) if causal else n_kt
        kt_begin = max(0, (q_lo - window + 1) // bn) if window > 0 else 0
        qf = q[:, :, q0:q0 + bq].float()
        m = torch.full(qf.shape[:3], -1e30)
        l = torch.zeros(qf.shape[:3])
        acc = torch.zeros(qf.shape)
        for kt in range(kt_begin, kt_end):
            keys = torch.arange(kt * bn, (kt + 1) * bn)
            x = torch.einsum("bhsd,bhtd->bhst", qf, kf[:, :, kt * bn:(kt + 1) * bn]) * scale_log2
            live = keys[None, :] < t
            if causal:
                live = live & (keys[None, :] <= pos[:, None])
            if window > 0:
                live = live & (keys[None, :] > pos[:, None] - window)
            x = torch.where(live, x, torch.tensor(-1e30))
            mx = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2(m - mx)
            p = torch.exp2(x - mx[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhst,bhtd->bhsd", p.to(torch.bfloat16).float(), vf[:, :, kt * bn:(kt + 1) * bn])
            m = mx
        out[:, :, q0:q0 + bq] = (acc / torch.clamp(l, min=1e-30)[..., None]).to(torch.bfloat16)
    return out


@pytest.mark.parametrize("s,t", [(64, 64), (96, 96), (1, 96)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 32), (False, 0)])
def test_flash_attention_tc_rounding_within_bf16_tolerance(s, t, causal, window):
    """At ``tests/test_kernels.py::test_flash_attention``'s grid, the
    rounding the tensor-core design adds (P in bf16, the scale on the f32
    scores) stays within BF16_ATTN_TOL of the reference's oracle and of its
    Pallas kernel in interpret mode."""
    rng = np.random.default_rng(s * 1000 + t + 7 * window + causal)
    b, h, d = 2, 3, 64
    (jq, q), (jk, k), (jv, v) = (_pair(rng.standard_normal((b, h, n, d)), "bfloat16")
                                 for n in (s, t, t))
    got = _tc_emulation(q, k, v, causal, window)
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    pallas = jops.flash_attention(jq, jk, jv, causal=causal, window=window, backend="interpret")
    assert_close(got, want, "bfloat16", BF16_ATTN_TOL)
    assert_close(got, pallas, "bfloat16", BF16_ATTN_TOL)


@pytest.mark.parametrize("case", KERNEL_CASES)
def test_flash_attention_tc_rounding_at_the_kernel_cases(case):
    """The same emulation at the ``cuda`` tests' shapes (widths 12-256, GQA,
    S < T, windows, ragged tiles) against the port's plain version."""
    b, s, t, hq, hkv, d, causal, window = case
    gen = torch.Generator().manual_seed(s * 31 + t)
    q = torch.randn((b, hq, s, d), generator=gen).bfloat16()
    k, v = (torch.randn((b, hkv, t, d), generator=gen).bfloat16() for _ in "kv")
    got = _tc_emulation(q, k, v, causal, window)
    want = ref.flash_attention_ref(q, k, v, causal, window)
    torch.testing.assert_close(got.float(), want.float(), **BF16_ATTN_TOL)


def test_flash_probe_patches_apply():
    """``kernels/flash_probe.py`` patches the kernel sources by text: every
    patch of the forward and of the backward still finds its anchor, each
    variant differs from the kernel and from the others, the instrumented
    copy marks every section once, and the probe's backward shapes are
    ``chip_smoke.py``'s."""
    import importlib.util

    from repro_torch.kernels import flash_probe

    sources = flash_probe.all_patches()
    kernel = sources.pop("kernel")
    assert kernel == flash_probe.SOURCE.read_text()
    assert all(text != kernel for text in sources.values())
    marks = [int(m) for m in re.findall(r"MARK\((\d+)\);", sources["sections"])]
    assert sorted(marks) == sorted([*range(len(flash_probe.LOOP_SECTIONS)),
                                    *flash_probe.ITEM_SECTIONS, 14])
    bwd = flash_probe.all_bwd_patches()
    kernel = bwd.pop("kernel")
    assert kernel == flash_probe.BWD_SOURCE.read_text()
    assert all(text != kernel for text in bwd.values())
    assert len(set(bwd.values())) == len(bwd)
    assert "exp2_ftz(fmaf(" not in bwd["no exps"]
    assert "wgmma_ss<N>(" not in bwd["no products"] and "wgmma_rs_n64(" not in bwd["no products"]
    assert "load_box(q_st" not in bwd["no exps, no products, no loads"]
    assert "load_box(k_st" not in bwd["no exps, no products, no loads"]
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert tuple(flash_probe.BWD_SHAPES.values()) == chip_smoke.FLASH_BWD_SHAPES


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_rope_and_mlp(dtype):
    cfg = dataclasses.replace(get_config("stablelm-1.6b", smoke=True), dtype=dtype)
    rng = np.random.default_rng(0)
    jx, x = _pair(rng.standard_normal((2, 7, cfg.d_model)) * 3, dtype)
    scale = rng.uniform(0.5, 1.5, cfg.d_model)
    jp = {"scale": jnp.asarray(scale, DTYPES[dtype][0])}
    assert_close(TL.rmsnorm(_port_tree(jp), x), jax.jit(RL.rmsnorm)(jp, jx), dtype)

    jh, h = _pair(rng.standard_normal((2, 7, 3, 16)), dtype)
    for offset in (0, 1000):
        want = jax.jit(RL.rope, static_argnums=2)(jh, jnp.arange(7) + offset, cfg.rope_theta)
        assert_close(TL.rope(h, torch.arange(7) + offset, cfg.rope_theta), want, dtype)

    mp = ref_init_params(jax.random.PRNGKey(1), RL.mlp_params(cfg), DTYPES[dtype][0])
    want = jax.jit(lambda p, xx: RL.mlp(p, cfg, xx))(mp, jx)
    assert_close(TL.mlp(_port_tree(mp), cfg, x), want, dtype)


@pytest.mark.parametrize("d_model", [60, 64, 2048])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_matches_reference_bit_for_bit(d_model, dtype):
    """The embedding times sqrt(d_model), whose weak-typed scale the
    reference rounds to the dtype first (sqrt(2048) = 45.25 in bf16; 60 is
    qwen1.5's smoke width, 64 a power of 4, 2048 the MoE configs')."""
    cfg = dataclasses.replace(get_config("qwen1.5-32b", smoke=True), d_model=d_model, dtype=dtype)
    rcfg = dataclasses.replace(ref_config("qwen1.5-32b", smoke=True), d_model=d_model,
                               dtype=dtype)
    rng = np.random.default_rng(d_model)
    jt, t = _pair(rng.standard_normal((cfg.vocab_size, d_model)) * 0.02, dtype)
    tokens = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    want = rlm._embed(rcfg, {"embed": jt}, jnp.asarray(tokens))
    got = tlm._embed(cfg, {"embed": t}, torch.from_numpy(tokens))
    assert got.dtype == t.dtype
    np.testing.assert_array_equal(_f32(got), _f32(want))


# (B, S, T, Hq, Hkv, causal, window, chunk)
GQA_CASES = [
    (2, 12, 12, 4, 4, True, 0, 16),    # MHA, one chunk
    (2, 12, 12, 4, 2, True, 5, 4),     # GQA g=2, window, several chunks
    (1, 5, 37, 8, 2, True, 0, 16),     # S < T, T not a multiple of the chunk
    (2, 9, 9, 6, 3, False, 0, 4),      # non-causal
    (1, 20, 20, 4, 1, True, 8, 6),     # g=4, window, ragged chunk
]


@pytest.mark.parametrize("case", GQA_CASES)
def test_gqa_chunked_matches_reference(case):
    b, s, t, hq, hkv, causal, window, chunk = case
    rng = np.random.default_rng(sum(case))
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, s, hq, 16), (b, t, hkv, 16), (b, t, hkv, 16)))
    want = RL.gqa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                          window=window, chunk=chunk)
    got = TL.gqa_chunked(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                         causal=causal, window=window, chunk=chunk)
    assert_close(got, want, "float32")


@pytest.mark.parametrize("arch,window,dtype", [
    ("stablelm-1.6b", 0, "float32"), ("internlm2-20b", 5, "float32"),
    ("qwen1.5-32b", 0, "bfloat16"), ("internlm2-20b", 0, "bfloat16"),
])
def test_attention_train_matches_reference(arch, window, dtype):
    """Causal and sliding-window attention, MHA and GQA; qwen1.5 adds the
    qkv biases."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    rcfg = dataclasses.replace(ref_config(arch, smoke=True), dtype=dtype)
    jp = ref_init_params(jax.random.PRNGKey(2), RL.attn_params(rcfg), DTYPES[dtype][0])
    if cfg.qkv_bias:  # zeros at init: give the biases values
        jp = {**jp, **{n: jnp.asarray(np.random.default_rng(5).standard_normal(jp[n].shape),
                                      jp[n].dtype) for n in ("bq", "bk", "bv")}}
    jx, x = _pair(np.random.default_rng(4).standard_normal((2, 11, cfg.d_model)), dtype)
    want = jax.jit(lambda p, xx: RL.attention_train(p, rcfg, xx, window=window))(jp, jx)
    assert_close(TL.attention_train(_port_tree(jp), cfg, x, window=window), want, dtype)


@pytest.mark.parametrize("window,t,pos", [(0, 8, 5), (4, 4, 9), (4, 4, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_decode_matches_reference(window, t, pos, dtype):
    """A full cache, and a ring buffer past (and before) the window."""
    cfg = dataclasses.replace(get_config("internlm2-20b", smoke=True), dtype=dtype)
    rcfg = dataclasses.replace(ref_config("internlm2-20b", smoke=True), dtype=dtype)
    jp = ref_init_params(jax.random.PRNGKey(3), RL.attn_params(rcfg), DTYPES[dtype][0])
    rng = np.random.default_rng(window + t + pos)
    jx, x = _pair(rng.standard_normal((2, 1, cfg.d_model)), dtype)
    shape = (2, t, cfg.kv_heads_p, cfg.hd)
    (jk, k), (jv, v) = (_pair(rng.standard_normal(shape), dtype) for _ in range(2))
    want, wcache = jax.jit(lambda p, xx, c, i: RL.attention_decode(p, rcfg, xx, c, i,
                                                                    window=window))(
        jp, jx, {"k": jk, "v": jv}, jnp.asarray(pos, jnp.int32))
    got, gcache = TL.attention_decode(_port_tree(jp), cfg, x, {"k": k, "v": v}, pos,
                                      window=window)
    assert_close(got, want, dtype)
    for name in ("k", "v"):
        assert_close(gcache[name], wcache[name], dtype)


# ---------------------------------------------------------------------------
# The LM: prefill and decode with the reference's weights
# ---------------------------------------------------------------------------

_REF_PARAMS = {}


def _models(arch: str, dtype: str):
    """(reference cfg, params; port cfg, params): one reference init per
    architecture (jit-compiled once), cast for bf16 as the reference's own
    bf16 init casts its float32 draws."""
    rcfg = dataclasses.replace(ref_config(arch, smoke=True), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    if arch not in _REF_PARAMS:
        f32 = dataclasses.replace(rcfg, dtype="float32")
        _REF_PARAMS[arch] = jax.jit(lambda key: rlm.concrete_params(key, f32))(
            jax.random.PRNGKey(0))
    rp = jax.tree_util.tree_map(lambda x: x.astype(DTYPES[dtype][0]), _REF_PARAMS[arch])
    return rcfg, rp, cfg, lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, rp), cfg,
                                               device="cpu")


def _cache_leaves(tree):
    """(path, tensor) pairs of a decode cache, the sLSTM's (h, c, n, m)
    tuple by index."""
    for path, x in leaves(tree):
        if isinstance(x, tuple):
            yield from ((path + (str(i),), t) for i, t in enumerate(x))
        else:
            yield path, x


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "internlm2-20b", "gemma3-27b",
                                  "qwen2-moe-a2.7b", "qwen3-moe-30b-a3b", "xlstm-350m",
                                  "jamba-1.5-large-398b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(arch, dtype):
    """Prefill's logits, then teacher-forced decode: every step's logits and
    the whole cache after the last step (periods and remainder; the mamba,
    mLSTM and sLSTM states of xlstm-350m and jamba).  The MoE configs route
    each decode step's single position alone (capacity 1)."""
    rcfg, rp, cfg, tp = _models(arch, dtype)
    b, s = 2, 6
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    want = jax.jit(lambda p, t: rlm.prefill(p, rcfg, {"tokens": t}))(rp, jnp.asarray(tokens))
    got = tlm.prefill(tp, cfg, {"tokens": torch.from_numpy(tokens)})
    assert got.dtype == torch.float32 and got.shape == (b, cfg.vocab_p)
    assert_close(got, want, dtype)

    # bf16: the reference decodes op by op, rounding where the port rounds.
    decode = (jax.jit(lambda p, c, t, i: rlm.decode_step(p, rcfg, c, t, i))
              if dtype == "float32" else lambda *a: rlm.decode_step(a[0], rcfg, *a[1:]))
    tcache = tlm.init_cache(cfg, b, s, device="cpu")
    with jax.disable_jit(dtype == "bfloat16"):
        rcache = rlm.init_cache(rcfg, b, s)
        for i in range(s):
            want, rcache = decode(rp, rcache, jnp.asarray(tokens[:, i]),
                                  jnp.asarray(i, jnp.int32))
            got, tcache = tlm.decode_step(tp, cfg, tcache, torch.from_numpy(tokens[:, i]), i)
            assert_close(got, want, dtype, err_msg=f"step {i}")
    ref_leaves, port_leaves = dict(_cache_leaves(rcache)), dict(_cache_leaves(tcache))
    assert set(ref_leaves) == set(port_leaves)
    for path, x in ref_leaves.items():
        assert tuple(port_leaves[path].shape) == x.shape, path
        assert_close(port_leaves[path], x, dtype, err_msg=str(path))


def test_decode_matches_full_forward_attention():
    """Twin of ``tests/test_models.py``'s: teacher-forced decode logits ==
    full-sequence forward logits (dense), bf16, its tolerance."""
    _, _, cfg, params = _models("stablelm-1.6b", "bfloat16")
    b, s = 1, 12
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s)))
    full_logits = tlm.prefill(params, cfg, {"tokens": tokens})
    cache = tlm.init_cache(cfg, b, s, device="cpu")
    for i in range(s):
        logits, cache = tlm.decode_step(params, cfg, cache, tokens[:, i], i)
    np.testing.assert_allclose(logits.numpy(), full_logits.numpy(), atol=0.15, rtol=0.05)


def test_sliding_window_cache_ring_buffer():
    """Twin of ``tests/test_models.py``'s: gemma3-style local attention, the
    ring buffer gives the full forward's logits once positions pass the
    window (8 in the smoke config)."""
    _, _, cfg, params = _models("gemma3-27b", "bfloat16")
    b, s = 1, 24
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s)))
    cache = tlm.init_cache(cfg, b, s, device="cpu")
    assert cache["periods"]["b0"]["kv"]["k"].shape[2] == cfg.sliding_window
    for i in range(s):
        logits, cache = tlm.decode_step(params, cfg, cache, tokens[:, i], i)
    full = tlm.prefill(params, cfg, {"tokens": tokens})
    np.testing.assert_allclose(logits.numpy(), full.numpy(), atol=0.2, rtol=0.08)


UNPORTED = ["llava-next-mistral-7b", "seamless-m4t-medium"]


@pytest.mark.parametrize("arch", UNPORTED)
def test_unported_configs_raise(arch):
    """The vision and encoder-decoder configs wait for their slice:
    parameters, caches, prefill and the training loss raise."""
    cfg = get_config(arch, smoke=True)
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        tlm.concrete_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        tlm.init_cache(cfg, 1, 4, device="cpu")
    with pytest.raises(NotImplementedError):
        tlm.prefill({}, cfg, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        tlm.loss_fn({}, cfg, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})


def test_every_arch_is_either_ported_or_refused():
    assert set(ARCHS) == set(UNPORTED) | {"stablelm-1.6b", "internlm2-20b", "gemma3-27b",
                                          "qwen1.5-32b", "qwen2-moe-a2.7b", "qwen3-moe-30b-a3b",
                                          "xlstm-350m", "jamba-1.5-large-398b"}
