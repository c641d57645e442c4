"""Stratified reservoir sampling (Sec. 7.1); port of ``repro/aqp/sampling.py``.

Efraimidis–Spirakis: keeping the k rows with the largest random keys draws a
uniform k-reservoir, which vectorizes to a sort + segmented rank.  Every
group gets its own reservoir of ``max(min_per_group, floor(theta * #g))``
rows; when there are more groups than the sample budget a plain uniform
reservoir is drawn instead.  The random keys come from the port's threefry
(bit-exact with ``jax.random``) on the table's device; the index math runs
on the host, as in the reference.  After an append, a cached sample is
extended by a delta pass over the appended rows instead of being redrawn.
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


def extend_sample_for_append(
    key: torch.Tensor,
    s: SampleSet,
    batches: "Tuple[ColumnTable, ...]",
    row_offsets: Tuple[int, ...],
) -> SampleSet:
    """Delta pass: fold appended batches into a cached sample.

    Each new row is Bernoulli(theta)-included (a group with no sampled row
    keeps its first batch row, the stratified ``min_per_group=1`` floor),
    group sizes count *all* delta rows, and unseen group keys are numbered
    after the existing ones (``map_group_keys``).  Old rows are never displaced;
    estimators only need per-group uniformity, which Bernoulli inclusion
    keeps.  One ``prng.split`` per batch, as the reference splits.
    """
    from repro_torch.core.catalog import extend_group_values, map_group_keys

    indices = [s.indices]
    sample_gid = [s.sample_gid]
    group_sizes = s.group_sizes.copy()
    sample_sizes = s.sample_sizes.copy()
    group_values = {a: v.copy() for a, v in s.group_values.items()}
    n_groups = s.n_groups
    key_index: Dict[Tuple, int] = {}
    if s.groupby:
        cols = [group_values[a].tolist() for a in s.groupby]
        key_index = {k: g for g, k in enumerate(zip(*cols))}

    for batch, offset in zip(batches, row_offsets):
        m = batch.num_rows
        if m == 0:
            continue
        if s.groupby:
            stacked = np.stack([to_host(batch[a]) for a in s.groupby], axis=1)
            gid_b, new_keys, n_groups = map_group_keys(stacked, key_index, n_groups)
            group_values = extend_group_values(group_values, s.groupby, new_keys)
        else:
            gid_b = np.zeros(m, dtype=np.int64)
        if n_groups > group_sizes.shape[0]:
            pad = n_groups - group_sizes.shape[0]
            group_sizes = np.concatenate([group_sizes, np.zeros(pad, dtype=group_sizes.dtype)])
            sample_sizes = np.concatenate([sample_sizes, np.zeros(pad, dtype=sample_sizes.dtype)])
        np.add.at(group_sizes, gid_b, 1)
        key, k_b = prng.split(key)
        take = _draw(k_b, batch) < s.theta
        # Unsampled groups keep their first batch row (the stratified floor).
        uniq_g, first_idx = np.unique(gid_b, return_index=True)
        force = first_idx[sample_sizes[uniq_g] == 0]
        take[force] = True
        np.add.at(sample_sizes, gid_b[take], 1)
        indices.append(np.nonzero(take)[0] + offset)
        sample_gid.append(gid_b[take])

    return SampleSet(
        table=s.table, groupby=s.groupby, theta=s.theta,
        indices=np.concatenate(indices),
        sample_gid=np.concatenate(sample_gid).astype(s.sample_gid.dtype),
        n_groups=n_groups, group_sizes=group_sizes, sample_sizes=sample_sizes,
        group_values=group_values, stratified=s.stratified,
    )


class SampleCache:
    """Sec. 7.1 reuse: cache stratified samples keyed by (table, group-by,
    theta).

    Version-aware: an entry remembers the table object it was drawn from.  A
    lookup with a *newer* version of the same relation extends the sample
    with a delta pass when every step between them is an append; deletes
    (which invalidate row indices) and lineage changes redraw.
    """

    def __init__(self):
        self._cache: Dict[Tuple[str, Tuple[str, ...], float], Tuple[SampleSet, "ColumnTable"]] = {}
        self.hits = 0
        self.misses = 0
        self.extended = 0

    def get_or_create(
        self,
        key: torch.Tensor,
        table: "ColumnTable",
        groupby: Tuple[str, ...],
        theta: float,
    ) -> SampleSet:
        ck = (table.name, tuple(groupby), theta)
        cached = self._cache.get(ck)
        if cached is not None:
            s, src = cached
            if src is table:
                self.hits += 1
                return s
            if src.uid == table.uid and src.version < table.version:
                # Walk the delta chain back to the sampled version; extend if
                # it is appends all the way down.
                batches, offsets = [], []
                t = table
                ok = True
                while t is not src and t.version > src.version:
                    if t.delta is None or t.delta.kind != "append":
                        ok = False
                        break
                    batches.append(t.delta.appended)
                    offsets.append(t.delta.parent.num_rows)
                    t = t.delta.parent
                if ok and t is src:
                    s2 = extend_sample_for_append(
                        key, s, tuple(reversed(batches)), tuple(reversed(offsets)))
                    self._cache[ck] = (s2, table)
                    self.extended += 1
                    return s2
        self.misses += 1
        s = stratified_reservoir_sample(key, table, groupby, theta)
        self._cache[ck] = (s, table)
        return s

    def invalidate(self, table_name: str) -> None:
        """Drop cached samples of one table (its delta history was dropped)."""
        for ck in [ck for ck in self._cache if ck[0] == table_name]:
            del self._cache[ck]


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

    def invalidate(self, table_name: str) -> None:
        # Key layout: (uid, version, theta) + inner_signature, whose first
        # element is the table name.
        for ck in [ck for ck in self._cache if ck[3] == table_name]:
            del self._cache[ck]
