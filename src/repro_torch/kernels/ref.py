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
