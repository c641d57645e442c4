"""Cross-query catalog: the per-query host work, done once (port of
``repro/core/catalog.py``).

Per table it caches the dictionary encoding of every seen GROUP BY tuple
(host gids, their device copy and the per-group key values), the
bucketization of every candidate partition under a ``RangeSet`` (a device
tensor shared by capture, application and estimation), per-fragment sizes
and summary statistics, WHERE masks, per-sketch *instances* (the filtered
relation D_P) and cheap per-attribute statistics.  Entries key by object
identity and hold a strong reference so the id stays valid.

A sketch instance remembers the base-table row of each of its rows, so its
group encodings and WHERE masks derive from the base table's cached ones by
a gather instead of fresh host passes.

Not in this slice: the delta refresh of mutated tables, join layouts and
the stacked shard cache.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import TYPE_CHECKING, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.table import ColumnTable, encode_groups
from repro_torch.device import to_host

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.ranges import RangeSet


@dataclasses.dataclass
class GroupEncoding:
    """Cached dictionary encoding of one GROUP BY tuple on one table."""

    gid: np.ndarray  # dense group id per row (host)
    gid_dev: torch.Tensor  # same, on the table's device
    n_groups: int
    group_values: Dict[str, np.ndarray]  # per-group key values


class Catalog:
    """Cross-query cache of encodings, bucketizations and instances.

    Every map is bounded FIFO (``max_entries`` per map): entries hold strong
    table references to keep their id() keys valid.
    """

    def __init__(self, max_entries: int = 512):
        self.stats: collections.Counter = collections.Counter()
        self.max_entries = max_entries
        self._groups: Dict[Tuple[int, Tuple[str, ...]], Tuple[ColumnTable, GroupEncoding]] = {}
        self._buckets: Dict[Tuple[int, Tuple], Tuple[ColumnTable, torch.Tensor]] = {}
        self._frag_sizes: Dict[Tuple[int, Tuple], Tuple[ColumnTable, np.ndarray]] = {}
        self._instances: Dict[Tuple[int, int], Tuple[object, ColumnTable, ColumnTable]] = {}
        self._distinct: Dict[Tuple[int, str], Tuple[ColumnTable, int]] = {}
        self._nonneg: Dict[Tuple[int, str], Tuple[ColumnTable, bool]] = {}
        self._wheres: Dict[Tuple[int, Tuple], Tuple[ColumnTable, torch.Tensor]] = {}
        # Fragment id per group, keyed by *value* (uid, version, group-by,
        # partition): a pure function of the group dictionary and the bounds.
        self._frag_groups: Dict[Tuple, np.ndarray] = {}
        # Instance -> (instance, base table, base-row index per instance row).
        self._instance_rows: Dict[int, Tuple[ColumnTable, ColumnTable, np.ndarray]] = {}

    def _put(self, cache: Dict, key, value) -> None:
        if len(cache) >= self.max_entries:
            cache.pop(next(iter(cache)))  # FIFO eviction (insertion-ordered)
            self.stats["evictions"] += 1
        cache[key] = value

    # -- group-by dictionary encodings --------------------------------------
    def groups(self, table: ColumnTable, attrs: Tuple[str, ...]) -> GroupEncoding:
        key = (id(table), tuple(attrs))
        hit = self._groups.get(key)
        if hit is not None and hit[0] is table:
            self.stats["encode_groups_hit"] += 1
            return hit[1]
        parent = self._instance_parent(table) if attrs else None
        if parent is not None:
            # Sketch instance: restrict the base table's lexicographic
            # numbering to the present groups (order-preserving), which
            # reproduces a from-scratch encode of the instance bit for bit.
            base, rows = parent
            base_enc = self.groups(base, attrs)
            gid_rows = base_enc.gid[rows]
            present = np.bincount(gid_rows, minlength=base_enc.n_groups) > 0
            new_of_base = np.cumsum(present) - 1
            gid = new_of_base[gid_rows].astype(np.int32)
            group_values = {a: v[present] for a, v in base_enc.group_values.items()}
            enc = GroupEncoding(gid, torch.from_numpy(gid).to(table.device),
                                int(present.sum()), group_values)
            self.stats["encode_groups_instance"] += 1
            self._put(self._groups, key, (table, enc))
            return enc
        self.stats["encode_groups"] += 1
        gid, n_groups, group_values = encode_groups(table, attrs)
        enc = GroupEncoding(gid, torch.from_numpy(gid).to(table.device), n_groups,
                            group_values)
        self._put(self._groups, key, (table, enc))
        return enc

    # -- partition-attribute bucketizations ----------------------------------
    def bucketize(self, table: ColumnTable, ranges: "RangeSet") -> torch.Tensor:
        key = (id(table), ranges.key())
        hit = self._buckets.get(key)
        if hit is not None and hit[0] is table:
            self.stats["bucketize_hit"] += 1
            return hit[1]
        self.stats["bucketize"] += 1
        bucket = ranges.bucketize(table[ranges.attr])
        self._put(self._buckets, key, (table, bucket))
        return bucket

    def frag_of_group(
        self,
        table: ColumnTable,
        ranges: "RangeSet",
        groupby: Tuple[str, ...],
        group_values: Dict[str, np.ndarray],
    ) -> np.ndarray:
        """Fragment id per *group* under a partition on a group-by attribute
        (the CB-OPT-GB fast path's vector), cached per (table version,
        group-by, partition).  The group values are host metadata, so they
        are bucketized on the host with the device's float32 comparison."""
        key = (table.uid, table.version, tuple(groupby), ranges.key())
        hit = self._frag_groups.get(key)
        n_groups = len(next(iter(group_values.values()))) if group_values else 1
        if hit is not None and hit.shape[0] == n_groups:
            self.stats["frag_of_group_hit"] += 1
            return hit
        self.stats["frag_of_group"] += 1
        frag = to_host(ranges.bucketize(torch.from_numpy(
            np.ascontiguousarray(group_values[ranges.attr]))))
        if len(self._frag_groups) >= self.max_entries:
            self._frag_groups.pop(next(iter(self._frag_groups)))
        self._frag_groups[key] = frag
        return frag

    def cached_bucket(self, table: ColumnTable, ranges: "RangeSet") -> Optional[torch.Tensor]:
        """The full bucket vector iff it is cached (no full-table work)."""
        hit = self._buckets.get((id(table), ranges.key()))
        if hit is not None and hit[0] is table:
            return hit[1]
        return None

    def fragment_sizes(self, table: ColumnTable, ranges: "RangeSet") -> np.ndarray:
        """Rows per fragment (host int32), from the cached bucketization."""
        key = (id(table), ranges.key())
        hit = self._frag_sizes.get(key)
        if hit is not None and hit[0] is table:
            self.stats["fragment_sizes_hit"] += 1
            return hit[1]
        self.stats["fragment_sizes"] += 1
        bucket = self.bucketize(table, ranges)
        sizes = to_host(torch.bincount(bucket, minlength=ranges.n_ranges).to(torch.int32))
        self._put(self._frag_sizes, key, (table, sizes))
        return sizes

    def frag_stats(self, table: ColumnTable, ranges: "RangeSet") -> Tuple[int, float, float]:
        """``(n_nonempty, max_frac, min_frac)`` over the nonempty fragments."""
        sizes = self.fragment_sizes(table, ranges)
        total = max(int(sizes.sum()), 1)
        nonempty = sizes[sizes > 0]
        if nonempty.size == 0:
            return (0, 0.0, 0.0)
        return (int(nonempty.size),
                float(nonempty.max()) / total,
                float(nonempty.min()) / total)

    # -- predicate-pushdown WHERE masks --------------------------------------
    def where_mask(self, table: ColumnTable, pred) -> torch.Tensor:
        """The row mask of ``pred`` over ``table``, cached per (table,
        predicate); an instance's mask is gathered from its base table's."""
        key = (id(table), (pred.attr, pred.op, pred.value))
        hit = self._wheres.get(key)
        if hit is not None and hit[0] is table:
            self.stats["where_mask_hit"] += 1
            return hit[1]
        parent = self._instance_parent(table)
        if parent is not None:
            base, rows = parent
            mask = self.where_mask(base, pred).index_select(
                0, torch.from_numpy(rows).to(table.device))
            self.stats["where_mask_instance"] += 1
            self._put(self._wheres, key, (table, mask))
            return mask
        self.stats["where_mask"] += 1
        mask = pred.mask(table)
        self._put(self._wheres, key, (table, mask))
        return mask

    # -- sketch instances (D_P) ----------------------------------------------
    def get_instance(self, sketch: object, table: ColumnTable) -> Optional[ColumnTable]:
        key = (id(sketch), id(table))
        hit = self._instances.get(key)
        if hit is not None and hit[0] is sketch and hit[1] is table:
            self.stats["instance_hit"] += 1
            return hit[2]
        return None

    def put_instance(self, sketch: object, table: ColumnTable,
                     instance: ColumnTable, rows: Optional[np.ndarray] = None) -> None:
        self.stats["instance_build"] += 1
        self._put(self._instances, (id(sketch), id(table)), (sketch, table, instance))
        if rows is not None:
            self._put(self._instance_rows, id(instance),
                      (instance, table, np.asarray(rows)))

    def _instance_parent(
        self, table: ColumnTable
    ) -> Optional[Tuple[ColumnTable, np.ndarray]]:
        hit = self._instance_rows.get(id(table))
        if hit is not None and hit[0] is table:
            return hit[1], hit[2]
        return None

    # -- cheap per-attribute statistics ---------------------------------------
    def distinct_count(self, table: ColumnTable, attr: str) -> int:
        key = (id(table), attr)
        hit = self._distinct.get(key)
        if hit is not None and hit[0] is table:
            return hit[1]
        self.stats["distinct_count"] += 1
        n = int(np.unique(to_host(table[attr])).shape[0])
        self._put(self._distinct, key, (table, n))
        return n

    def column_nonnegative(self, table: ColumnTable, attr: str) -> bool:
        key = (id(table), attr)
        hit = self._nonneg.get(key)
        if hit is not None and hit[0] is table:
            return hit[1]
        self.stats["column_stats"] += 1
        ok = not bool((table[attr] < 0).any())
        self._put(self._nonneg, key, (table, ok))
        return ok


_DEFAULT = Catalog()


def default_catalog() -> Catalog:
    """Process-wide catalog used when callers don't thread their own."""
    return _DEFAULT
