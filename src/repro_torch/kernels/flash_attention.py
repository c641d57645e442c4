"""Flash attention forward: the wrapper of ``csrc/flash_attention.cu``.

Replaces ``repro/kernels/flash_attention.py::flash_attention_pallas`` and
serves ``models/layers.py::gqa_chunked``'s prefill calls; the source says
how the kernel is built and what bounds it.  A CPU tensor goes to the plain
version (``ref.flash_attention_ref``); a CUDA tensor goes to the kernel, or
the call raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.runtime.guards import LAUNCH_COUNTS

NAME = "flash_attention"
MAX_HEAD_DIM = 256
BLOCK_Q = 64
MAX_Q_TILES = 65535  # grid axis y
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
LAYOUTS = ("bhsd", "bshd")


def _dims(x: torch.Tensor, layout: str):
    """(B, H, S, D) and the element strides of the B, H and S axes."""
    if layout == "bhsd":
        b, h, s, d = x.shape
        return (b, h, s, d), (x.stride(0), x.stride(1), x.stride(2))
    b, s, h, d = x.shape
    return (b, h, s, d), (x.stride(0), x.stride(2), x.stride(1))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    layout: str = "bhsd") -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v, q rows end-aligned with k.

    ``layout="bhsd"``: q (B, H, S, D), k/v (B, Hkv, T, D); ``"bshd"``: q
    (B, S, H, D), k/v (B, T, Hkv, D).  ``H % Hkv == 0``; query head ``h``
    reads kv head ``h // (H // Hkv)``.  Any strides with a contiguous D axis;
    the output is a new tensor in q's layout and dtype (float32 or bfloat16).
    """
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.device.type == "cpu":
        if layout == "bshd":
            out = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2), causal, window)
            return out.transpose(1, 2).contiguous()
        return flash_attention_ref(q, k, v, causal, window)
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
    if -(-s // BLOCK_Q) > MAX_Q_TILES or b * h >= 1 << 31:
        raise ValueError(f"grid too large for B*H={b * h}, S={s}")
    out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    _, o_st = _dims(out, layout)
    lib = build.library(NAME)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    scale = ctypes.c_float(1.0 / math.sqrt(d))
    err = lib.flash_attention_launch(
        index, build.stream_handle(dev), _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), b, h, h // hkv, s, t, d, *q_st, *k_st, *v_st, *o_st,
        int(causal), int(window), scale)
    build.check(err, NAME)
    LAUNCH_COUNTS[NAME] += 1
    return out
