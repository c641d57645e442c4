"""Plain PyTorch versions of the ported kernels (the correctness contract).

Counterparts of ``repro/kernels/ref.py``'s jnp oracles.  The CPU path of
every kernel wrapper runs these; ``chip_smoke.py`` holds each CUDA kernel
against them on the card.  Nothing on the engine's path calls them for a
CUDA tensor.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def fragment_bitmap_ref(prov: torch.Tensor, bucket: torch.Tensor, n_ranges: int) -> torch.Tensor:
    """bits[r] = OR over rows in fragment r of the provenance mask."""
    hits = torch.zeros(n_ranges, dtype=torch.int32, device=bucket.device)
    hits.scatter_reduce_(0, bucket.long(), prov.to(torch.int32), reduce="amax")
    return hits > 0


def fragment_bitmap_batch_ref(provs: torch.Tensor, bucket: torch.Tensor,
                              n_ranges: int) -> torch.Tensor:
    """bits[b, r] = OR over rows in fragment r of provenance mask b (one
    ``scatter_reduce_`` over a (B, n_ranges) output).  Rows whose bucket lies
    outside ``[0, n_ranges)`` set nothing, as ``segment_max`` drops them."""
    b = int(provs.shape[0])
    idx = bucket.long()
    flags = provs.to(torch.int32)
    ok = (idx >= 0) & (idx < n_ranges)
    if not bool(ok.all()):
        idx, flags = idx[ok], flags[:, ok]
    hits = torch.zeros((b, n_ranges), dtype=torch.int32, device=bucket.device)
    hits.scatter_reduce_(1, idx.expand(b, -1), flags, reduce="amax")
    return hits > 0


def sketch_filter_ref(bucket: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """keep[i] = bits[bucket[i]] — the sketch's disjunction of ranges."""
    return bits.to(torch.bool)[bucket.long()]


def segment_aggregate_ref(
    values: torch.Tensor, gid: torch.Tensor, n_groups: int,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums, counts) per group with optional row weights (WHERE mask).

    Accumulates in float32 in row order (``index_add_`` on the CPU adds its
    rows one after another, as XLA-CPU's ``segment_sum`` does), so the CPU
    results equal the reference's bit for bit.  Rows whose gid lies outside
    ``[0, n_groups)`` are dropped, like ``segment_sum``'s out-of-range ids.
    """
    v = values.to(torch.float32)
    w = torch.ones_like(v) if weights is None else weights.to(torch.float32)
    g = gid.long()
    ok = (g >= 0) & (g < n_groups)
    if not bool(ok.all()):
        g, v, w = g[ok], v[ok], w[ok]
    sums = torch.zeros(n_groups, dtype=torch.float32, device=v.device).index_add_(0, g, v * w)
    counts = torch.zeros(n_groups, dtype=torch.float32, device=v.device).index_add_(0, g, w)
    return sums, counts


def segment_aggregate_batch_ref(
    values: torch.Tensor, gid: torch.Tensor, n_groups: int,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums, counts) as (B, n_groups): row ``b`` is
    ``segment_aggregate_ref`` of row ``b``.  One ``index_add_`` over the
    flattened rows with ids ``gid + b * n_groups`` adds each row's values in
    row order, as the unbatched version does; out-of-range gids are dropped
    per row."""
    b = int(values.shape[0])
    v = values.to(torch.float32)
    w = torch.ones_like(v) if weights is None else weights.to(torch.float32)
    g = gid.long()
    ok = (g >= 0) & (g < n_groups)
    flat = (g + n_groups * torch.arange(b, device=g.device)[:, None])[ok]
    out = torch.zeros(2, b * n_groups, dtype=torch.float32, device=v.device)
    out[0].index_add_(0, flat, (v * w)[ok])
    out[1].index_add_(0, flat, w[ok])
    return out[0].view(b, n_groups), out[1].view(b, n_groups)


NEG_INF = -1e30  # the masked logit of the reference (``kernels/flash_attention.py``)


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True, window: int = 0
) -> torch.Tensor:
    """O = softmax(QK^T / sqrt(d)) V with optional causal/sliding-window mask.

    Shapes: q (B, H, S, D), k/v (B, Hkv, T, D) with ``H % Hkv == 0`` (query
    head ``h`` reads kv head ``h // (H // Hkv)``; the reference's oracle
    takes ``Hkv == H`` only).  q rows are end-aligned with k (position
    ``s + T - S``).  Float32 math on float32 casts of the inputs (a bf16 q
    is cast before it is scaled, as the reference's promotion does); the
    output has q's dtype.
    """
    qf, kf, vf = q.to(torch.float32), k.to(torch.float32), v.to(torch.float32)
    group = qf.shape[1] // kf.shape[1]
    if group > 1:
        kf = kf.repeat_interleave(group, dim=1)
        vf = vf.repeat_interleave(group, dim=1)
    scale = 1.0 / torch.sqrt(torch.tensor(float(qf.shape[-1]), dtype=torch.float32))
    logits = torch.einsum("bhsd,bhtd->bhst", qf, kf) * scale.to(qf.device)
    s, t = qf.shape[2], kf.shape[2]
    qpos = torch.arange(s, device=q.device)[:, None] + (t - s)
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window and window > 0:
        mask &= kpos > qpos - window
    logits = torch.where(mask[None, None], logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p, vf).to(q.dtype)
