"""Range partitions (Def. 2 of the paper); port of ``repro/core/ranges.py``.

``bucketize`` compares in float32, as ``jnp.searchsorted`` does with x64
off: a float64 search would move boundary-adjacent values to another
fragment than the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.table import ColumnTable
from repro_torch.device import to_host


@dataclasses.dataclass(frozen=True)
class RangeSet:
    """Equi-depth range partitioning of an attribute domain.

    ``bounds`` are the n-1 interior split points of n ranges:
    fragment i covers [bounds[i-1], bounds[i]) with -inf / +inf at the ends.
    """

    attr: str
    bounds: np.ndarray  # shape (n_ranges - 1,), sorted ascending

    @property
    def n_ranges(self) -> int:
        return int(self.bounds.shape[0]) + 1

    def bucketize(self, values: torch.Tensor) -> torch.Tensor:
        """Fragment id per value (int32): searchsorted against the interior
        bounds, right side, in float32."""
        bounds = torch.as_tensor(self.bounds, dtype=torch.float32).to(values.device)
        return torch.searchsorted(bounds, values.to(torch.float32), right=True).to(torch.int32)

    def key(self) -> Tuple:
        """Hashable identity of the partition (attr + exact bounds)."""
        return (self.attr, self.n_ranges, self.bounds.tobytes())


def equi_depth_ranges(table: ColumnTable, attr: str, n_ranges: int) -> RangeSet:
    """Equi-depth histogram bounds (what Postgres keeps in pg_stats)."""
    col = to_host(table[attr]).astype(np.float64)
    qs = np.linspace(0.0, 1.0, n_ranges + 1)[1:-1]
    bounds = np.quantile(col, qs, method="lower")
    return RangeSet(attr=attr, bounds=np.unique(bounds))


def equi_width_ranges(table: ColumnTable, attr: str, n_ranges: int) -> RangeSet:
    col = to_host(table[attr]).astype(np.float64)
    lo, hi = float(col.min()), float(col.max())
    if hi <= lo:
        hi = lo + 1.0
    bounds = np.linspace(lo, hi, n_ranges + 1)[1:-1]
    return RangeSet(attr=attr, bounds=np.unique(bounds))


def fragment_sizes(table: ColumnTable, ranges: RangeSet) -> torch.Tensor:
    """#R_r for every fragment r (int32, on the table's device)."""
    bucket = ranges.bucketize(table[ranges.attr])
    return torch.bincount(bucket, minlength=ranges.n_ranges).to(torch.int32)
