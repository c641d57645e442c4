"""Transformer building blocks (the port of ``repro/models/layers.py``):
norms, RoPE, GQA attention (full and sliding window; train/prefill and
decode paths), the SwiGLU MLP and the capacity-based MoE FFN.

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
einsums outside any kernel; so does the MoE FFN (routing, dispatch, the
expert products and combine are einsums outside any Pallas kernel in the
reference).  Cross-attention waits for its slice.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

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
    mask: that is every prefill and training call, and cross-attention too,
    which is non-causal with T != S.  No reference caller passes explicit
    positions or ``k_valid`` (only ``gqa_chunked``'s own signature names
    them); on the card they raise.
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
# FFN: dense SwiGLU + capacity-based MoE
# ---------------------------------------------------------------------------


def mlp_params(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict[str, Any]:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    return {
        "ln": norm_params(d),
        "wg": P((d, ff), ("embed", "ffn")),
        "wi": P((d, ff), ("embed", "ffn")),
        "wo": P((ff, d), ("ffn", "embed")),
    }


def silu(x: torch.Tensor) -> torch.Tensor:
    """silu as XLA computes it: x * 1 / (1 + exp(-x)), each step rounded to
    the dtype (in bf16, torch.sigmoid rounds once and so differs from it)."""
    return x * (1 / (1 + torch.exp(-x)))


def _swiglu(p, h: torch.Tensor) -> torch.Tensor:
    dt = h.dtype
    g = torch.einsum("bsd,df->bsf", h, p["wg"].to(dt))
    u = torch.einsum("bsd,df->bsf", h, p["wi"].to(dt))
    return torch.einsum("bsf,fd->bsd", silu(g) * u, p["wo"].to(dt))


def mlp(p, cfg: ModelConfig, x: torch.Tensor, residual: bool = True) -> torch.Tensor:
    y = _swiglu(p, rmsnorm(p["ln"], x))
    return x + y if residual else y


def moe_params(cfg: ModelConfig) -> Dict[str, Any]:
    d, e, ffe = cfg.d_model, cfg.experts_p, cfg.moe_d_ff
    p: Dict[str, Any] = {
        "ln": norm_params(d),
        "router": P((d, e), ("embed", "experts")),
        "wg": P((e, d, ffe), ("experts", "embed", "moe_ffn")),
        "wi": P((e, d, ffe), ("experts", "embed", "moe_ffn")),
        "wo": P((e, ffe, d), ("experts", "moe_ffn", "embed")),
    }
    if cfg.shared_d_ff:
        p["shared"] = {
            "wg": P((d, cfg.shared_d_ff), ("embed", "ffn")),
            "wi": P((d, cfg.shared_d_ff), ("embed", "ffn")),
            "wo": P((cfg.shared_d_ff, d), ("ffn", "embed")),
        }
    return p


class MoeRoute(NamedTuple):
    """One MoE call's routing over its (B, G, gs) group positions, padded
    positions included (the aux loss averages over them)."""

    probs: torch.Tensor  # (B, G, gs, E) float32, the router's softmax
    mask: torch.Tensor  # (B, G, gs, E) float32, 1 where the position picked the expert
    idx: torch.Tensor  # (B, G, gs, k) int64, the picks by descending probability
    gates: torch.Tensor  # (B, G, gs, k) float32, the picks' probabilities over their sum
    pos: torch.Tensor  # (B, G, gs, k) int64, the pick's slot in its expert
    keep: torch.Tensor  # (B, G, gs, k) bool, pos < cap: a dropped pick adds nothing
    cap: int  # an expert's slots in a group
    s: int  # the real positions of a batch row; the group tail past them is padding


def _moe_groups(cfg: ModelConfig, h: torch.Tensor, group_size: int):
    """``h`` (B, S, d) as groups of ``gs = min(group_size, S)`` positions,
    (B, G, gs, d), the last zero-padded; and an expert's capacity a group,
    ``max(1, ceil(gs k / E cf))``."""
    b, s, d = h.shape
    gs = min(group_size, s)
    pad = -s % gs
    hp = F.pad(h, (0, 0, 0, pad)) if pad else h
    cap = max(1, math.ceil(gs * cfg.experts_per_token / cfg.experts_p * cfg.capacity_factor))
    return hp.reshape(b, (s + pad) // gs, gs, d), cap


def _router_probs(p, cfg: ModelConfig, hg: torch.Tensor, s: int) -> torch.Tensor:
    """The router's softmax in float32 (float32 operands: with TF32 off, as
    torch leaves it, the picks cannot flip between runs); padded experts and
    padded positions get logits of -1e30."""
    logits = torch.einsum("bgsd,de->bgse", hg.to(torch.float32), p["router"].to(torch.float32))
    if cfg.padded_experts and cfg.padded_experts > cfg.n_experts:
        logits = logits.masked_fill(
            torch.arange(cfg.experts_p, device=hg.device) >= cfg.n_experts, NEG_INF)
    _, ng, gs, _ = hg.shape
    if ng * gs > s:  # padded positions route nowhere
        valid = (torch.arange(ng * gs, device=hg.device) < s).reshape(1, ng, gs, 1)
        logits = logits.masked_fill(~valid, NEG_INF)
    return torch.softmax(logits, dim=-1)


def _moe_check(cfg: ModelConfig) -> None:
    # Padded experts' probabilities are 0 and ties go to the lower index, so
    # with k <= n_experts no pick lands on a padded expert (moe skips them).
    if not 0 < cfg.experts_per_token <= cfg.n_experts:
        raise ValueError(f"{cfg.name}: top-{cfg.experts_per_token} of {cfg.n_experts} experts")


def moe_route(p, cfg: ModelConfig, h: torch.Tensor, group_size: int = 4096):
    """The routing :func:`moe` runs on the normed input ``h`` (B, S, d):
    ``(hg, route)``, ``hg`` the groups (B, G, gs, d).  Top-k as a stable
    descending sort of the probabilities, so ties go to the lower expert
    index as in ``jax.lax.top_k`` (``torch.topk`` does not promise that; a
    padded position's probabilities all tie); a pick's slot is the count of
    the group's earlier positions routed to its expert."""
    _moe_check(cfg)
    hg, cap = _moe_groups(cfg, h, group_size)
    probs = _router_probs(p, cfg, hg, h.shape[1])
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    vals, idx = vals[..., :k], idx[..., :k]
    mask = torch.zeros_like(probs).scatter_(-1, idx, 1.0)
    pos = (torch.cumsum(mask, dim=2) - mask).gather(-1, idx).to(torch.int64)
    gates = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    return hg, MoeRoute(probs, mask, idx, gates, pos, pos < cap, cap, h.shape[1])


def moe_aux(cfg: ModelConfig, r: MoeRoute) -> torch.Tensor:
    """Switch-style load-balance loss over the real experts: ``n_experts *
    sum(f_e p_e)``, ``f_e`` the share of positions that picked expert e
    before capacity, ``p_e`` its mean probability, both over every position
    (padded ones too), float32 0-d."""
    e = cfg.n_experts
    f_e = r.mask[..., :e].mean(dim=(0, 1, 2))
    p_e = r.probs[..., :e].mean(dim=(0, 1, 2))
    return e * torch.sum(f_e * p_e)


def _moe_out(p, cfg: ModelConfig, x: torch.Tensor, h: torch.Tensor, y: torch.Tensor,
             r: MoeRoute) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed output (B, G gs, d) cut to the real positions, the shared
    expert's added in the dtype, then the residual; and the aux loss."""
    y = y[:, :x.shape[1]]
    if "shared" in p:
        y = y + _swiglu(p["shared"], h)
    return x + y, moe_aux(cfg, r)


def moe(p, cfg: ModelConfig, x: torch.Tensor, group_size: int = 4096
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard-style top-k dispatch with capacity groups (the reference's
    ``moe``): ``(x + y, aux)``.

    Where the reference multiplies (B, G, gs, E, C) one-hots, this gathers:
    the (B G, E, C) slots, expert-major, each take an exact copy of the one
    position routed there (a zero row where none is; no slot is written
    twice), the experts run as three batched products over their slots in
    the dtype (the padded experts, which no pick reaches, are skipped), and
    each position gathers its kept slots' outputs, sums ``gate * out`` in
    float32 in pick order with the gate rounded to the dtype first, and
    rounds once: no ``index_add_``, no float atomics, so reruns give equal
    bits.  The same arithmetic as :func:`moe_plain` but for the order of
    that float32 sum.
    """
    b, s, d = x.shape
    h = rmsnorm(p["ln"], x)
    hg, r = moe_route(p, cfg, h, group_size)
    _, ng, gs, _ = hg.shape
    n, k, e, cap, dt, dev = b * ng, cfg.experts_per_token, cfg.n_experts, r.cap, x.dtype, x.device
    tok, n_slots = n * gs, e * n * cap
    keep = r.keep.reshape(tok, k)
    row = torch.arange(n, device=dev).repeat_interleave(gs)[:, None]  # each position's group
    slot = (r.idx.reshape(tok, k) * n + row) * cap + r.pos.reshape(tok, k)
    # Which position fills each slot: position ``tok``, a zero row, where none
    # does; dropped picks write it into one spare slot past the end.
    src = torch.full((n_slots + 1,), tok, dtype=torch.int64, device=dev)
    pos_id = torch.arange(tok, device=dev)[:, None].expand(tok, k)
    src.scatter_(0, torch.where(keep, slot, n_slots).reshape(-1),
                 torch.where(keep, pos_id, tok).reshape(-1))
    rows = torch.cat([hg.reshape(tok, d), hg.new_zeros(1, d)])
    xin = rows[src[:n_slots]].view(e, n * cap, d)
    g = torch.bmm(xin, p["wg"][:e].to(dt))
    u = torch.bmm(xin, p["wi"][:e].to(dt))
    out = torch.bmm(silu(g) * u, p["wo"][:e].to(dt)).view(n_slots, d)
    gate = torch.where(keep, r.gates.reshape(tok, k).to(dt), 0).to(torch.float32)
    slot = torch.where(keep, slot, 0)  # a dropped pick reads slot 0 at gate 0
    y = gate[:, 0, None] * out[slot[:, 0]].to(torch.float32)
    for j in range(1, k):
        y = y + gate[:, j, None] * out[slot[:, j]].to(torch.float32)
    return _moe_out(p, cfg, x, h, y.to(dt).view(b, ng * gs, d), r)


def moe_route_plain(p, cfg: ModelConfig, h: torch.Tensor, group_size: int = 4096):
    """:func:`moe_route` as the reference writes it: top-k as k rounds of
    argmax (the first of equal maxima: ``lax.top_k``'s order), the picks'
    one-hot sum as the mask, slots from its cumulative sum."""
    _moe_check(cfg)
    hg, cap = _moe_groups(cfg, h, group_size)
    probs = _router_probs(p, cfg, hg, h.shape[1])
    rest, picks = probs, []
    for _ in range(cfg.experts_per_token):
        i = torch.argmax(rest, dim=-1, keepdim=True)
        picks.append(i)
        rest = rest.scatter(-1, i, float("-inf"))
    idx = torch.cat(picks, dim=-1)
    vals = probs.gather(-1, idx)
    gates = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    mask = F.one_hot(idx, cfg.experts_p).to(torch.float32).sum(3)
    pos_in_e = torch.cumsum(mask, dim=2) - mask
    keep = (pos_in_e < cap) * mask
    return hg, MoeRoute(probs, mask, idx, gates, pos_in_e.gather(-1, idx).to(torch.int64),
                        keep.gather(-1, idx) > 0, cap, h.shape[1])


def moe_plain(p, cfg: ModelConfig, x: torch.Tensor, group_size: int = 4096
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`moe`: the reference's one-hot dispatch and
    combine einsums line by line, over every expert, padded ones included.
    The combine sums in float32 and rounds once (the rounding :func:`moe`
    keeps).  For tests and checks; no serving or training path calls it."""
    b, s, d = x.shape
    h = rmsnorm(p["ln"], x)
    hg, r = moe_route_plain(p, cfg, h, group_size)
    dt = x.dtype
    sel = F.one_hot(r.idx, cfg.experts_p).to(torch.float32)  # (B,G,gs,k,E)
    gate_e = torch.einsum("bgske,bgsk->bgse", sel, r.gates)
    pos_in_e = torch.cumsum(r.mask, dim=2) - r.mask
    keep = (pos_in_e < r.cap) * r.mask
    one_hot_pos = pos_in_e[..., None] == torch.arange(r.cap, device=x.device)
    dispatch = one_hot_pos.to(dt) * keep[..., None].to(dt)  # (B,G,gs,E,C)
    combine = dispatch * gate_e[..., None].to(dt)
    xin = torch.einsum("bgsec,bgsd->bgecd", dispatch, hg)
    gsw = silu(torch.einsum("bgecd,edf->bgecf", xin, p["wg"].to(dt)))
    up = torch.einsum("bgecd,edf->bgecf", xin, p["wi"].to(dt))
    out_e = torch.einsum("bgecf,efd->bgecd", gsw * up, p["wo"].to(dt))
    y = torch.einsum("bgsec,bgecd->bgsd", combine.to(torch.float32), out_e.to(torch.float32))
    return _moe_out(p, cfg, x, h, y.to(dt).reshape(b, -1, d), r)
