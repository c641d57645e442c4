"""Flash attention: the wrappers of ``csrc/flash_attention.cu`` (forward)
and ``csrc/flash_attention_bwd.cu`` (backward), and the autograd function
that joins them.

The forward replaces ``repro/kernels/flash_attention.py::flash_attention_pallas``
and serves ``models/layers.py::gqa_chunked``'s prefill calls; the backward
replaces no Pallas kernel (the reference differentiates its XLA chunk loop)
and serves the training path through :func:`flash_attention_train`.  The
sources say how the kernels are built and what bounds them.  A CPU tensor
goes to the plain versions (``ref.flash_attention_ref``,
``ref.flash_attention_lse_ref``, ``ref.flash_attention_bwd_ref``); a CUDA
tensor goes to a kernel, or the call raises.  The dtype picks the kernels,
forward and backward alike: bfloat16 runs the tensor-core kernels (wgmma,
TMA loads), float32 the SIMT kernels (the f32 parity surface); neither is a
fallback for the other.  :func:`launch_plan` decides everything about a
launch that does not need the card (the backward's tiles: :func:`bwd_plan`),
so the CPU tests can check it.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (flash_attention_bwd_ref, flash_attention_lse_ref,
                                     flash_attention_ref)
from repro_torch.runtime.guards import LAUNCH_COUNTS

NAME = "flash_attention"
BWD_NAME = "flash_attention_bwd"
TC_COUNTER = "flash_attention.tc"  # launches of the tensor-core (bf16) kernel
COPY_COUNTER = "flash_attention.aligned_copy"  # q, k or v copied for TMA's alignment
BWD_TC_COUNTER = "flash_attention_bwd.tc"  # launches of the tensor-core (bf16) backward
BWD_COPY_COUNTER = "flash_attention_bwd.aligned_copy"  # q, k, v or dO copied for TMA
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
LAYOUTS = ("bhsd", "bshd")
# Per dtype: q rows a block, k rows a tile, and the padded widths compiled.
BLOCK_Q = {torch.float32: 64, torch.bfloat16: 128}
WIDTHS = {torch.float32: (64, 128, 256), torch.bfloat16: (64, 128, 192, 256)}
MAX_Q_TILES = 65535  # grid axis y of the float32 kernel
MAX_ITEMS = (1 << 31) - 1  # work items (and float32 grid axis x), int32 in the kernels
TMA_ALIGN = 16  # bytes: a tensor map's base and strides


def block_k(dtype: torch.dtype, width: int) -> int:
    if dtype == torch.bfloat16:
        return 128 if width <= 128 else 64
    return 64


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    tensor_cores: bool
    width: int  # padded head dim of the compiled kernel
    block_q: int
    block_k: int
    q_tiles: int
    # (b*h, q tile) pairs: float32 launches a block for each on grid
    # (b*h, q_tiles); bfloat16 spreads them over one persistent block an SM.
    work_items: int
    copies: Tuple[str, ...]  # names among q, k, v that need the aligned copy


def needs_aligned_copy(ptr: int, sizes: Sequence[int], strides: Sequence[int],
                       item: int = 2) -> bool:
    """A TMA tensor map needs a 16-byte-aligned base and, on every axis
    longer than 1, a stride that is a multiple of 16 bytes."""
    if ptr % TMA_ALIGN:
        return True
    return any(n > 1 and (st * item) % TMA_ALIGN for n, st in zip(sizes, strides))


def launch_plan(dtype: torch.dtype, q_dims: Sequence[int], kv_heads: int, t: int,
                views: Dict[str, Tuple[int, Sequence[int], Sequence[int]]]) -> LaunchPlan:
    """How a call with q (B, H, S, D) and k/v (B, ``kv_heads``, ``t``, D)
    launches.  ``views`` maps q, k, v to (data pointer, sizes, strides) of
    their (B, H, S) axes (elements).  Raises when the grid is too large."""
    b, h, s, d = q_dims
    width = next(w for w in WIDTHS[dtype] if d <= w)
    bq = BLOCK_Q[dtype]
    q_tiles = -(-s // bq)
    tc = dtype == torch.bfloat16
    if q_tiles * b * h > MAX_ITEMS or (not tc and q_tiles > MAX_Q_TILES):
        raise ValueError(f"grid too large for B*H={b * h}, S={s}")
    copies = tuple(name for name, (ptr, sizes, strides) in views.items()
                   if tc and needs_aligned_copy(ptr, sizes, strides))
    return LaunchPlan(tc, width, bq, block_k(dtype, width), q_tiles, q_tiles * b * h, copies)


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """The bf16 backward's tiles for one head dim (``csrc/flash_attention_bwd.cu``'s
    ``tc::Plan``, which ``flash_attention_bwd_plan`` reports)."""
    width: int  # padded head dim
    kv_rows: int  # bwd_dkdv_tc: keys a block (two warpgroups of 64)
    q_rows: int  # bwd_dkdv_tc: q rows a stage of its ring
    passes: int  # bwd_dkdv_tc's q loops: 1 (dV and dK together) or 2 (dV, then dK)
    dq_rows: int  # bwd_dq_tc: q rows a block
    dq_k_rows: int  # bwd_dq_tc: k rows a stage
    row_pad: int  # lse and D rows of the workspace padded to a multiple
    stages: int  # each kernel's ring of q (dkdv) or k (dq) tiles


def bwd_plan(d: int) -> BwdPlan:
    """The bf16 backward's plan for head dim ``d``: each kernel's tiles fit
    227 KB of shared memory and its accumulators a consumer's registers."""
    width = next(w for w in WIDTHS[torch.bfloat16] if d <= w)
    return BwdPlan(width=width, kv_rows=128, q_rows=32 if width == 256 else 64,
                   passes=1 if width <= 128 else 2, dq_rows=128,
                   dq_k_rows={64: 128, 128: 64, 192: 64, 256: 32}[width], row_pad=128, stages=2)


def tma_axes(sizes: Sequence[int], strides: Sequence[int]) -> Tuple[int, ...]:
    """The 7 values ``flash_attention_bf16_launch`` takes for one tensor:
    the sizes and element strides of its axes in the order of the tensor
    map, and that order (two bits an axis: 0 row, 1 head, 2 batch).  Axes
    are sorted by stride, ties and size-1 axes last; a size-1 axis gets the
    stride a packed layout would give it (its coordinate is always 0)."""
    b, h, s = sizes
    sb, sh, ss = strides
    axes = [(s, ss, 0), (h, sh, 1), (b, sb, 2)]  # (size, stride, role)
    long = sorted((a for a in axes if a[0] > 1), key=lambda a: a[1])
    packed = max([n * st for n, st, _ in long], default=8)
    ordered = long + [(1, packed, role) for n, _, role in axes if n == 1]
    order = sum(role << (2 * i) for i, (_, _, role) in enumerate(ordered))
    return (*(n for n, _, _ in ordered), *(st for _, st, _ in ordered), order)


def _copy_strides(sizes: Sequence[int], d: int) -> Tuple[int, int, int]:
    """Strides of the (B, H, S) axes of :func:`_aligned_copy`'s result."""
    _, h, s = sizes
    d8 = -(-d // 8) * 8
    return (h * s * d8, s * d8, d8)


@functools.lru_cache(maxsize=256)
def _bf16_launch(dims: Tuple[int, ...], kv_heads: int, t: int, views: Tuple) -> Tuple:
    """(plan, the tensor-map values) of a bfloat16 call, by shapes, strides
    and alignment (``views``: (sizes, strides, aligned) of q, k, v, and for
    the backward dO): 7 values a tensor.  Cached: a serving loop repeats a
    handful of these, and planning costs more host time than the launch."""
    names = ("q", "k", "v", "do")[:len(views)]
    plan = launch_plan(torch.bfloat16, dims, kv_heads, t,
                       {n: (0 if aligned else 1, sizes, strides)
                        for n, (sizes, strides, aligned) in zip(names, views)})
    axes = []
    for n, (sizes, strides, _) in zip(names, views):
        axes += tma_axes(sizes, _copy_strides(sizes, dims[3]) if n in plan.copies else strides)
    return plan, (ctypes.c_longlong * len(axes))(*axes)


def _dims(x: torch.Tensor, layout: str):
    """(B, H, S, D) and the element strides of the B, H and S axes."""
    if layout == "bhsd":
        b, h, s, d = x.shape
        return (b, h, s, d), (x.stride(0), x.stride(1), x.stride(2))
    b, s, h, d = x.shape
    return (b, h, s, d), (x.stride(0), x.stride(2), x.stride(1))


def _aligned_copy(x: torch.Tensor, layout: str) -> torch.Tensor:
    """x as a (B, H, S, D) view into a zeroed contiguous tensor whose rows
    are padded to a multiple of 8 elements (16 bytes)."""
    if layout == "bshd":
        x = x.transpose(1, 2)
    d = x.shape[-1]
    buf = torch.zeros((*x.shape[:-1], -(-d // 8) * 8), dtype=x.dtype, device=x.device)
    buf[..., :d].copy_(x)
    return buf[..., :d]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, layout: str, window: int):
    """Validate a call's q, k and v: (B, H, S, D), their B/H/S strides, and
    k's (B, Hkv, T, D) and strides.  Raises on what the kernels do not take."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    dev = q.device
    (b, h, s, d), q_st = _dims(q, layout)
    (bk, hkv, t, dk), k_st = _dims(k, layout)
    v_dims, v_st = _dims(v, layout)
    for name, x in (("k", k), ("v", v)):
        if x.device != dev:
            raise ValueError(f"{name} lies on {x.device}, expected {dev}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {x.dtype}, q has {q.dtype}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    if v_dims != (bk, hkv, t, dk) or bk != b or dk != d:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         f"do not match for layout {layout}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must lie in [1, {MAX_HEAD_DIM}], got {d}")
    if hkv == 0 or h % hkv:
        raise ValueError(f"{h} query heads are not a multiple of {hkv} kv heads")
    if s > t:
        raise ValueError(f"q has {s} rows, more than k's {t}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("the head dim of q, k and v must be contiguous")
    return (b, h, s, d), q_st, (hkv, t), k_st, v_st


def _bhsd(fn, layout: str, *xs: torch.Tensor):
    """``fn`` of (B, H, S, D) views of ``xs``, its tensor results in ``layout``."""
    if layout == "bhsd":
        return fn(*xs)
    out = fn(*(x.transpose(1, 2) for x in xs))
    return tuple(y.transpose(1, 2).contiguous() for y in out)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, layout: str = "bhsd",
                    return_lse: bool = False):
    """softmax(q k^T / sqrt(D)) v, q rows end-aligned with k.

    ``layout="bhsd"``: q (B, H, S, D), k/v (B, Hkv, T, D); ``"bshd"``: q
    (B, S, H, D), k/v (B, T, Hkv, D).  ``H % Hkv == 0``; query head ``h``
    reads kv head ``h // (H // Hkv)``.  Any strides with a contiguous D axis;
    the output is a new tensor in q's layout and dtype (float32 or bfloat16).
    A bfloat16 view whose base or strides are not 16-byte aligned (TMA's
    rule) is first copied into a zero-padded contiguous tensor; each copy
    adds one to ``LAUNCH_COUNTS["flash_attention.aligned_copy"]``.  With
    ``return_lse`` the result is ``(out, lse)``: lse (B, H, S) float32, each
    query row's log-sum-exp of its scaled, masked logits, which
    :func:`flash_attention_bwd` takes.
    """
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.device.type == "cpu":
        out = _bhsd(lambda *x: (flash_attention_ref(*x, causal, window),), layout, q, k, v)[0]
        if not return_lse:
            return out
        qh, kh = (q, k) if layout == "bhsd" else (q.transpose(1, 2), k.transpose(1, 2))
        return out, flash_attention_lse_ref(qh, kh, causal, window)
    (b, h, s, d), q_st, (hkv, t), k_st, v_st = _check(q, k, v, layout, window)
    dev = q.device
    tensors = {"q": q, "k": k, "v": v}
    if q.dtype == torch.bfloat16:
        views = tuple((size, st, x.data_ptr() % TMA_ALIGN == 0) for size, st, x in (
            ((b, h, s), q_st, q), ((b, hkv, t), k_st, k), ((b, hkv, t), v_st, v)))
        plan, axes = _bf16_launch((b, h, s, d), hkv, t, views)
    else:
        plan = launch_plan(q.dtype, (b, h, s, d), hkv, t, {})
    out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=dev) if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    lse_ptr = None if lse is None else lse.data_ptr()
    _, o_st = _dims(out, layout)
    lib = build.library(NAME)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = build.stream_handle(dev)
    if plan.tensor_cores:
        for n in plan.copies:
            tensors[n] = _aligned_copy(tensors[n], layout)
            LAUNCH_COUNTS[COPY_COUNTER] += 1
        scale_log2 = ctypes.c_float(math.log2(math.e) / math.sqrt(d))
        err = lib.flash_attention_bf16_launch(
            index, stream, tensors["q"].data_ptr(), tensors["k"].data_ptr(),
            tensors["v"].data_ptr(), out.data_ptr(), axes, b, h, h // hkv, s, t, d, *o_st,
            int(causal), int(window), scale_log2, lse_ptr)
        build.check(err, NAME)
        LAUNCH_COUNTS[TC_COUNTER] += 1
    else:
        scale = ctypes.c_float(1.0 / math.sqrt(d))
        err = lib.flash_attention_f32_launch(
            index, stream, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
            h // hkv, s, t, d, *q_st, *k_st, *v_st, *o_st, int(causal), int(window), scale,
            lse_ptr)
        build.check(err, NAME)
    LAUNCH_COUNTS[NAME] += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        do: torch.Tensor, lse: torch.Tensor, *, causal: bool = True,
                        window: int = 0, layout: str = "bhsd"):
    """(dq, dk, dv) of ``flash_attention(q, k, v)`` = ``o`` for the output
    gradient ``do``, from the forward's ``lse`` (``return_lse=True``).

    Shapes and layouts as :func:`flash_attention` (``o`` and ``do`` like q;
    any strides with a contiguous D axis); each gradient is a new
    contiguous tensor in its input's layout and dtype.  dk and dv of a kv
    head sum over the query heads that read it, in a fixed order (no
    atomics: reruns give equal bits).  bfloat16 runs the tensor-core
    kernels: a view of q, k, v or ``do`` whose base or strides are not
    16-byte aligned is first copied (``LAUNCH_COUNTS["flash_attention_bwd.
    aligned_copy"]``).  A CPU tensor takes ``ref.flash_attention_bwd_ref``,
    which recomputes what lse carries.
    """
    (b, h, s, d), q_st, (hkv, t), k_st, v_st = _check(q, k, v, layout, window)
    for name, x in (("o", o), ("do", do)):
        if tuple(x.shape) != tuple(q.shape) or x.device != q.device:
            raise ValueError(f"{name} {tuple(x.shape)} on {x.device} does not match q "
                             f"{tuple(q.shape)} on {q.device}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {x.dtype}, q has {q.dtype}")
    if tuple(lse.shape) != (b, h, s) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 {(b, h, s)}, got {lse.dtype} {tuple(lse.shape)}")
    if q.device.type == "cpu":
        return _bhsd(lambda *x: flash_attention_bwd_ref(*x, causal, window), layout,
                     q, k, v, o, do)
    dev = q.device
    if do.stride(-1) != 1:
        do = do.contiguous()
    if o.stride(-1) != 1:
        o = o.contiguous()
    lse = lse.contiguous()
    tc = q.dtype == torch.bfloat16
    if not tc and (-(-s // 32) > 65535 or -(-t // 32) > 65535):
        raise ValueError(f"grid too large for S={s}, T={t}")
    dq = torch.empty(q.shape, dtype=q.dtype, device=dev)
    dk = torch.empty(k.shape, dtype=q.dtype, device=dev)
    dv = torch.empty(v.shape, dtype=q.dtype, device=dev)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    tensors = {"q": q, "k": k, "v": v, "do": do}
    dims = {"q": (b, h, s), "k": (b, hkv, t), "v": (b, hkv, t), "do": (b, h, s)}
    st = {"q": q_st, "k": k_st, "v": v_st, "do": _dims(do, layout)[1]}
    axes = None
    if tc:
        views = tuple((dims[n], st[n], x.data_ptr() % TMA_ALIGN == 0)
                      for n, x in tensors.items())
        plan, axes = _bf16_launch((b, h, s, d), hkv, t, views)
        for n in plan.copies:
            tensors[n] = _aligned_copy(tensors[n], layout)
            st[n] = _copy_strides(dims[n], d)
            LAUNCH_COUNTS[BWD_COPY_COUNTER] += 1
        pad = bwd_plan(d).row_pad
        s_pad = -(-s // pad) * pad
        ws = torch.empty((2, b * h, s_pad), dtype=torch.float32, device=dev)
    else:
        ws = torch.empty((b, h, s), dtype=torch.float32, device=dev)
    strides = (*st["q"], *st["k"], *st["v"], *_dims(o, layout)[1], *st["do"],
               *_dims(dq, layout)[1], *_dims(dk, layout)[1], *_dims(dv, layout)[1])
    lib = build.library(BWD_NAME)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    err = lib.flash_attention_bwd_launch(
        index, build.stream_handle(dev), _DTYPE_CODES[q.dtype], tensors["q"].data_ptr(),
        tensors["k"].data_ptr(), tensors["v"].data_ptr(), o.data_ptr(), tensors["do"].data_ptr(),
        lse.data_ptr(), ws.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h,
        h // hkv, s, t, d, (ctypes.c_longlong * 24)(*strides), axes, int(causal), int(window),
        ctypes.c_float(1.0 / math.sqrt(d)))
    build.check(err, BWD_NAME)
    if tc:
        LAUNCH_COUNTS[BWD_TC_COUNTER] += 1
    LAUNCH_COUNTS[BWD_NAME] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward kernel with lse; backward kernel from q, k, v, o and lse."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                window: int, layout: str):
        out, lse = flash_attention(q, k, v, causal=causal, window=window, layout=layout,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, layout)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, layout = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do.to(q.dtype), lse, causal=causal,
                                         window=window, layout=layout)
        return dq, dk, dv, None, None, None


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int = 0,
                          layout: str = "bhsd") -> torch.Tensor:
    """:func:`flash_attention` with a gradient: the forward kernel (which
    also stores lse) under autograd, and :func:`flash_attention_bwd` as its
    backward.  On the CPU both run their plain versions."""
    return _FlashAttention.apply(q, k, v, causal, window, layout)
