"""Stratified reservoir sampling (Sec. 7.1); port of ``repro/aqp/sampling.py``.

Efraimidis–Spirakis: keeping the k rows with the largest random keys draws a
uniform k-reservoir, which vectorizes to a sort + segmented rank.  Every
group gets its own reservoir of ``max(min_per_group, floor(theta * #g))``
rows; when there are more groups than the sample budget a plain uniform
reservoir is drawn instead.  The random keys come from the port's threefry
(bit-exact with ``jax.random``) on the table's device; the index math runs
on the host, as in the reference.  Extending a cached sample after an
append waits for the maintenance slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.device import to_host


@dataclasses.dataclass(frozen=True)
class SampleSet:
    """A stratified sample with the catalog info estimators need."""

    table: str
    groupby: Tuple[str, ...]
    theta: float
    indices: np.ndarray  # row ids into the base table, shape (m,)
    sample_gid: np.ndarray  # dense group id per sampled row, shape (m,)
    n_groups: int
    group_sizes: np.ndarray  # #g for every group, shape (n_groups,)
    sample_sizes: np.ndarray  # #s_g for every group, shape (n_groups,)
    group_values: Dict[str, np.ndarray]  # group key values, per group
    stratified: bool

    @property
    def num_samples(self) -> int:
        return int(self.indices.shape[0])


def _draw(key: torch.Tensor, table: "ColumnTable") -> np.ndarray:
    """One float32 uniform per row, drawn on the table's device; the host
    reservoir math needs them (a reference merge point)."""
    return to_host(prng.uniform(key, (table.num_rows,), device=table.device))


def stratified_reservoir_sample(
    key: torch.Tensor,
    table: "ColumnTable",
    groupby: Tuple[str, ...],
    theta: float,
    min_per_group: int = 1,
) -> SampleSet:
    """Per-group reservoirs of size max(min_per_group, floor(theta * #g))."""
    from repro_torch.core.table import encode_groups

    n = table.num_rows
    gid, n_groups, group_values = encode_groups(table, groupby)
    stratified = bool(groupby) and n_groups <= max(1, int(theta * n))
    if not stratified:
        return uniform_reservoir_sample(key, table, groupby, theta, gid, n_groups, group_values)

    u = _draw(key, table)
    # Sort by (group, descending key): the first k_g rows of each segment are
    # a uniform k_g-reservoir of that group.
    order = np.lexsort((-u, gid))
    gid_sorted = gid[order]
    group_sizes = np.bincount(gid, minlength=n_groups)
    starts = np.concatenate([[0], np.cumsum(group_sizes)[:-1]])
    rank = np.arange(n) - starts[gid_sorted]
    k_g = np.maximum(min_per_group, (theta * group_sizes).astype(np.int64))
    k_g = np.minimum(k_g, group_sizes)
    keep = rank < k_g[gid_sorted]
    idx = order[keep]
    return SampleSet(
        table=table.name,
        groupby=tuple(groupby),
        theta=theta,
        indices=idx,
        sample_gid=gid[idx],
        n_groups=n_groups,
        group_sizes=group_sizes,
        sample_sizes=np.bincount(gid[idx], minlength=n_groups),
        group_values=group_values,
        stratified=True,
    )


def uniform_reservoir_sample(
    key: torch.Tensor,
    table: "ColumnTable",
    groupby: Tuple[str, ...],
    theta: float,
    gid: Optional[np.ndarray] = None,
    n_groups: Optional[int] = None,
    group_values: Optional[Dict[str, np.ndarray]] = None,
) -> SampleSet:
    """Plain k-reservoir over the whole table (no-group-by / too-many-groups)."""
    from repro_torch.core.table import encode_groups

    n = table.num_rows
    if gid is None:
        gid, n_groups, group_values = encode_groups(table, groupby)
    k = max(1, int(theta * n))
    u = _draw(key, table)
    idx = np.argpartition(-u, k - 1)[:k] if k < n else np.arange(n)
    idx = np.sort(idx)
    return SampleSet(
        table=table.name,
        groupby=tuple(groupby),
        theta=theta,
        indices=idx,
        sample_gid=gid[idx],
        n_groups=n_groups,
        group_sizes=np.bincount(gid, minlength=n_groups),
        sample_sizes=np.bincount(gid[idx], minlength=n_groups),
        group_values=group_values,
        stratified=False,
    )


class SampleCache:
    """Sec. 7.1 reuse: cache stratified samples keyed by (table, group-by,
    theta), valid for the exact table object they were drawn from."""

    def __init__(self):
        self._cache: Dict[Tuple[str, Tuple[str, ...], float], Tuple[SampleSet, "ColumnTable"]] = {}
        self.hits = 0
        self.misses = 0

    def get_or_create(
        self,
        key: torch.Tensor,
        table: "ColumnTable",
        groupby: Tuple[str, ...],
        theta: float,
    ) -> SampleSet:
        ck = (table.name, tuple(groupby), theta)
        cached = self._cache.get(ck)
        if cached is not None and cached[1] is table:
            self.hits += 1
            return cached[0]
        self.misses += 1
        s = stratified_reservoir_sample(key, table, groupby, theta)
        self._cache[ck] = (s, table)
        return s


def aqr_cache_key(q: "Query", table: "ColumnTable", theta: float) -> Tuple:
    """Cross-query AQR identity: everything ``aqr_estimates`` consumes
    (the inner-block signature excludes the HAVING chain)."""
    return (table.uid, table.version, theta) + q.inner_signature()


class AQRCache:
    """Sec. 7.1 reuse, one level up: cache AQR estimate passes per (table
    version, inner-block signature, theta), with the per-group ever-sampled
    mask of the sample they were computed from."""

    def __init__(self, max_entries: int = 256):
        self._cache: Dict[Tuple, Tuple[object, np.ndarray]] = {}
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get_or_compute(
        self,
        key: torch.Tensor,
        q: "Query",
        db: "Database",
        samples: SampleSet,
        theta: float,
        cfg,
    ) -> Tuple[object, np.ndarray]:
        """(GroupEstimates, per-group sampled mask) for ``q``'s inner block."""
        from repro_torch.aqp.size_estimation import aqr_estimates

        ck = aqr_cache_key(q, db[q.table], theta)
        hit = self._cache.get(ck)
        if hit is not None:
            self.hits += 1
            return hit
        self.misses += 1
        est = aqr_estimates(key, q, db, samples, cfg)
        entry = (est, samples.sample_sizes > 0)
        if len(self._cache) >= self.max_entries:
            self._cache.pop(next(iter(self._cache)))
            self.evictions += 1
        self._cache[ck] = entry
        return entry
