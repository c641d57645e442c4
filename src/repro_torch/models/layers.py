"""Transformer building blocks, dense part (the port of
``repro/models/layers.py``): norms, RoPE, GQA attention (full and sliding
window; train/prefill and decode paths) and the SwiGLU MLP.

All forwards are plain functions over a parameter tree (``P`` specs, then a
``ParamTree`` of tensors; see ``params.py``).  Full-sequence attention goes
through :func:`gqa_chunked`: on a CUDA tensor it launches the hand-written
flash-attention kernel (``kernels/csrc/flash_attention.cu``, the port of the
Pallas kernel the reference names as the TPU-native version of the same
schedule), and under autograd the kernel with its hand-written backward
(``kernels/csrc/flash_attention_bwd.cu``, the gradient the reference gets by
differentiating its chunk loop); on a CPU tensor it runs
:func:`gqa_chunked_plain`, a line-by-line port of the reference's
online-softmax, KV-chunked loop, which autograd differentiates as the
reference's autodiff does.  Decode attention
stays plain PyTorch on both devices, as the reference computes it with
einsums outside any kernel.  The MoE FFN and cross-attention wait for their
slice.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention, flash_attention_train
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import P

NEG_INF = -1e30

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name (``cfg.dtype``, ``cfg.kv_dtype``)."""
    return DTYPES[name]


# ---------------------------------------------------------------------------
# Norms & RoPE
# ---------------------------------------------------------------------------


def norm_params(d: int) -> Dict[str, P]:
    return {"scale": P((d,), ("embed",), init="ones")}


def rmsnorm(p, x: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + 1e-6)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


def _rope_angles(positions: torch.Tensor, half: int, theta: float):
    """cos and sin of the rotation angles, (..., S, 1, half) each."""
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs  # (..., S, half)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, H, hd); positions broadcastable to (..., S)."""
    return _apply_rope(x, *_rope_angles(positions, x.shape[-1] // 2, theta))


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def attn_params(cfg: ModelConfig, cross: bool = False) -> Dict[str, Any]:
    d, hq, hkv, hd = cfg.d_model, cfg.heads_p, cfg.kv_heads_p, cfg.hd
    p: Dict[str, Any] = {
        "ln": norm_params(d),
        "wq": P((d, hq, hd), ("embed", "q_heads", "head_dim")),
        "wk": P((d, hkv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": P((d, hkv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": P((hq, hd, d), ("q_heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = P((hq, hd), ("q_heads", "head_dim"), init="zeros")
        p["bk"] = P((hkv, hd), ("kv_heads", "head_dim"), init="zeros")
        p["bv"] = P((hkv, hd), ("kv_heads", "head_dim"), init="zeros")
    if cross:
        p["ln_kv"] = norm_params(d)
    return p


def _qkv(p, cfg: ModelConfig, x: torch.Tensor):
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("btd,dhk->bthk", x, p["wk"].to(dt))
    v = torch.einsum("btd,dhk->bthk", x, p["wv"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return q, k, v


def gqa_chunked(
    q: torch.Tensor,  # (B, S, Hq, hd)
    k: torch.Tensor,  # (B, T, Hkv, hd)
    v: torch.Tensor,
    *,
    causal: bool,
    window: int = 0,
    q_positions: Optional[torch.Tensor] = None,
    k_valid: Optional[torch.Tensor] = None,
    k_positions: Optional[torch.Tensor] = None,
    chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax GQA; never materializes (S, T).

    A CUDA tensor launches the flash-attention kernel on the (B, S, H, D)
    tensors as they are (no transposed copy, no expanded k/v); when grad is
    enabled and an input requires it, through :func:`flash_attention_train`,
    whose backward is the backward kernel, else the forward alone (prefill
    and serving).  The kernels take end-aligned positions and no validity
    mask: that is every prefill and training call; explicit positions or
    ``k_valid`` come only from cross-attention, which waits with the
    encoder-decoder configs, and raise on the card.
    """
    if q.device.type == "cpu":
        return gqa_chunked_plain(q, k, v, causal=causal, window=window,
                                 q_positions=q_positions, k_valid=k_valid,
                                 k_positions=k_positions, chunk=chunk)
    if q_positions is not None or k_positions is not None or k_valid is not None:
        raise NotImplementedError(
            "gqa_chunked on the card takes end-aligned positions and no k_valid mask "
            "(cross-attention waits with the encoder-decoder configs, ROADMAP A7)")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return flash_attention_train(q, k, v, causal=causal, window=window, layout="bshd")
    return flash_attention(q, k, v, causal=causal, window=window, layout="bshd")


def gqa_chunked_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    window: int = 0,
    q_positions: Optional[torch.Tensor] = None,
    k_valid: Optional[torch.Tensor] = None,
    k_positions: Optional[torch.Tensor] = None,
    chunk: int = 1024,
) -> torch.Tensor:
    """The plain version of :func:`gqa_chunked` on any device: the
    reference's chunk loop, in float32 on a float32 cast of q (cast, then
    scaled, as the reference's numpy-scalar promotion does)."""
    b, s, hq, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    dev = q.device
    scale = 1.0 / np.sqrt(hd)
    qg = (q.to(torch.float32) * scale).reshape(b, s, hkv, g, hd)

    if q_positions is None:
        q_positions = torch.arange(s, device=dev) + (t - s)
    if k_positions is None:
        k_positions = torch.arange(t, device=dev)

    chunk = min(chunk, t)
    pad = -t % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_positions = F.pad(k_positions, (0, pad), value=-1)
        k_valid = torch.ones((b, t), dtype=torch.bool, device=dev) if k_valid is None else k_valid
        k_valid = F.pad(k_valid, (0, pad))
    n_chunks = (t + pad) // chunk
    kc = k.reshape(b, n_chunks, chunk, hkv, hd)
    vc = v.reshape(b, n_chunks, chunk, hkv, hd)
    pc = k_positions.reshape(n_chunks, chunk)
    valc = None if k_valid is None else k_valid.reshape(b, n_chunks, chunk)

    m = torch.full((b, s, hkv, g), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, s, hkv, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, s, hkv, g, hd), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        kci, vci, pci = kc[:, c], vc[:, c], pc[c]
        logits = torch.einsum("bskgd,btkd->bskgt", qg, kci.to(torch.float32))
        mask = (pci >= 0)[None, None, :]
        if valc is not None:
            mask = mask & valc[:, c][:, None, :]
        mask = mask[:, :, None, None, :]  # (B,S,1,1,chunk)
        rel = q_positions[None, :, None] - pci[None, None, :]  # (1,S,chunk)
        if causal:
            mask = mask & (rel >= 0)[:, :, None, None, :]
        if window and window > 0:
            mask = mask & (rel < window)[:, :, None, None, :]
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        probs = torch.exp(logits - m_new[..., None])
        l = l * alpha + probs.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bskgt,btkd->bskgd", probs, vci.to(torch.float32))
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, s, hq, hd).to(q.dtype)


def attention_train(p, cfg: ModelConfig, x: torch.Tensor, *, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """Full-sequence self-attention (prefill compute)."""
    h = rmsnorm(p["ln"], x)
    q, k, v = _qkv(p, cfg, h)
    pos = torch.arange(x.shape[1], device=x.device)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    out = gqa_chunked(q, k, v, causal=causal, window=window, chunk=cfg.attn_chunk)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return x + y


def init_attn_cache(cfg: ModelConfig, batch: int, length: int, window: int, dtype: torch.dtype,
                    device: torch.device) -> Dict[str, torch.Tensor]:
    t = min(length, window) if window else length
    shape = (batch, t, cfg.kv_heads_p, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


@functools.lru_cache(maxsize=16)
def _decode_tables(pos: int, t: int, window: int, half: int, theta: float,
                   device: torch.device):
    """The rotation of position ``pos`` and the cache slots' validity, the
    same for every layer of a decode step: computed once a step, not once
    a layer (each costs a dozen small launches)."""
    cos, sin = _rope_angles(torch.tensor([pos], device=device), half, theta)
    idx = torch.arange(t, device=device)
    if window:
        # Ring buffer: slot s holds absolute position pos - ((pos - s) mod W).
        abs_pos = pos - torch.remainder(pos - idx, window)
        valid = abs_pos >= 0
    else:
        valid = idx <= pos
    return cos, sin, valid


def attention_decode(
    p, cfg: ModelConfig, x: torch.Tensor, cache: Dict[str, torch.Tensor], pos: int,
    *, window: int = 0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step. x (B, 1, d); cache k/v (B, T, Hkv, hd); pos an int.

    Writes the new key and value into the cache tensors in place (the
    reference returns updated copies; one cache buffer is what it gets from
    XLA's in-place carry update too) and returns the same dict.  The
    arithmetic copies the reference's casts: q scaled in float32 and rounded
    to the compute dtype, scores and the value product accumulated in
    float32 from compute-dtype operands, probabilities rounded to the
    compute dtype.
    """
    h = rmsnorm(p["ln"], x)
    q, k_new, v_new = _qkv(p, cfg, h)
    k, v = cache["k"], cache["v"]
    t = k.shape[1]
    cos, sin, valid = _decode_tables(pos, t, window, cfg.hd // 2, cfg.rope_theta, x.device)
    q = _apply_rope(q, cos, sin)
    k_new = _apply_rope(k_new, cos, sin)

    slot = min(pos % max(window, 1) if window else pos, t - 1)
    k[:, slot] = k_new[:, 0].to(k.dtype)
    v[:, slot] = v_new[:, 0].to(v.dtype)

    b, hq = q.shape[0], q.shape[2]
    hkv = k.shape[2]
    g = hq // hkv
    scale = 1.0 / np.sqrt(cfg.hd)
    cdt = x.dtype
    qs = (q[:, 0].to(torch.float32) * scale).reshape(b, hkv, g, cfg.hd).to(cdt)
    logits = torch.einsum("bkgd,btkd->bkgt", qs.to(torch.float32),
                          k.to(cdt).to(torch.float32))
    logits = torch.where(valid[None, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", probs.to(cdt).to(torch.float32),
                       v.to(cdt).to(torch.float32))
    out = out.reshape(b, 1, hq, cfg.hd).to(x.dtype)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return x + y, cache


# ---------------------------------------------------------------------------
# FFN: dense SwiGLU
# ---------------------------------------------------------------------------


def mlp_params(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict[str, Any]:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    return {
        "ln": norm_params(d),
        "wg": P((d, ff), ("embed", "ffn")),
        "wi": P((d, ff), ("embed", "ffn")),
        "wo": P((ff, d), ("ffn", "embed")),
    }


def mlp(p, cfg: ModelConfig, x: torch.Tensor, residual: bool = True) -> torch.Tensor:
    h = rmsnorm(p["ln"], x)
    dt = x.dtype
    g = torch.einsum("bsd,df->bsf", h, p["wg"].to(dt))
    u = torch.einsum("bsd,df->bsf", h, p["wi"].to(dt))
    # silu as XLA computes it: x * 1 / (1 + exp(-x)), each step rounded to the
    # dtype (in bf16, torch.sigmoid rounds once and so differs from it).
    y = torch.einsum("bsf,fd->bsd", g * (1 / (1 + torch.exp(-g))) * u, p["wo"].to(dt))
    return x + y if residual else y
