"""Public entry points of the ported kernels (the port of
``repro/kernels/ops.py``).

Each function casts its inputs to the kernel's types and goes to the
kernel wrapper, which launches the CUDA kernel for a CUDA tensor and runs
the plain version (``kernels/ref.py``) for a CPU tensor.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import flash_attention as _flash_attention
from repro_torch.kernels.fragment_bitmap import fragment_bitmap as _fragment_bitmap
from repro_torch.kernels.fragment_bitmap import (
    fragment_bitmap_batch as _fragment_bitmap_batch,
)
from repro_torch.kernels.segment_aggregate import segment_aggregate as _segment_aggregate
from repro_torch.kernels.segment_aggregate import (
    segment_aggregate_batch as _segment_aggregate_batch,
)
from repro_torch.kernels.sketch_filter import sketch_filter as _sketch_filter


def fragment_bitmap(prov: torch.Tensor, bucket: torch.Tensor, n_ranges: int) -> torch.Tensor:
    return _fragment_bitmap(prov.to(torch.bool).contiguous(),
                            bucket.to(torch.int32).contiguous(), n_ranges)


def fragment_bitmap_batch(provs: torch.Tensor, bucket: torch.Tensor,
                          n_ranges: int) -> torch.Tensor:
    """B stacked provenance masks -> B sketch bitvectors, one scan."""
    return _fragment_bitmap_batch(provs.to(torch.bool).contiguous(),
                                  bucket.to(torch.int32).contiguous(), n_ranges)


def sketch_filter(bucket: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    return _sketch_filter(bucket.to(torch.int32).contiguous(), bits.to(torch.bool).contiguous())


def segment_aggregate(
    values: torch.Tensor,
    gid: torch.Tensor,
    n_groups: int,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    values = values.to(torch.float32).contiguous()
    gid = gid.to(torch.int32).contiguous()
    weights = (torch.ones_like(values) if weights is None
               else weights.to(torch.float32).contiguous())
    return _segment_aggregate(values, gid, n_groups, weights)


def segment_aggregate_batch(
    values: torch.Tensor,
    gid: torch.Tensor,
    n_groups: int,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, n) inputs -> (B, n_groups) sums and counts, one launch."""
    values = values.to(torch.float32).contiguous()
    gid = gid.to(torch.int32).contiguous()
    weights = (torch.ones_like(values) if weights is None
               else weights.to(torch.float32).contiguous())
    return _segment_aggregate_batch(values, gid, n_groups, weights)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """softmax(QK^T/sqrt(d))V for q (B, H, S, D), k/v (B, H, T, D), f32 or bf16."""
    return _flash_attention(q, k, v, causal=causal, window=window, layout="bhsd")
