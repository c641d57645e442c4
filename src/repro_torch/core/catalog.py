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

A relation evolves through versions (``ColumnTable.append``/``.delete``),
each carrying a ``TableDelta`` back to its parent.  A miss on a table with a
delta is refreshed from the parent's entry (bucketize the batch and
concatenate, number the batch's unseen group keys after the existing ones,
add or subtract per-fragment counts, gather the kept rows)
instead of redoing the full-table host work.  The ``*_delta`` stat counters
separate that delta-sized work from full misses.

Join layouts (``join``): the materialized equi-join of a fact table with a
dimension (the right key unique) and each joined row's fact row.  The key
sort and ``searchsorted`` run on the host, as in the reference, the column
gathers on the tables' device.  A mutated fact table joins only its delta:
an append joins the batch and is built as an append of the parent's joined
table (so the joined relation's encodings delta-refresh like a base
table's), a delete drops the joined rows of the deleted fact rows.

The sharded engine (``repro_torch.core.shard``) also keeps its stacked
shard-major launch inputs here, keyed by registration and guarded by a
freshness token (``get_stacked``/``put_stacked``/``drop_stacked``).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import TYPE_CHECKING, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.ranges import cross_product_id, parts_of
from repro_torch.core.table import ColumnTable, encode_groups, unique_rows
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
    _key_index: Optional[Dict[Tuple, int]] = None  # lazy key-tuple -> gid

    def key_index(self, attrs: Tuple[str, ...]) -> Dict[Tuple, int]:
        """key tuple -> gid, built lazily (delta refresh needs the lookup)."""
        if self._key_index is None:
            cols = [self.group_values[a].tolist() for a in attrs]
            self._key_index = {key: g for g, key in enumerate(zip(*cols))} if cols else {(): 0}
        return self._key_index


def map_group_keys(
    stacked: np.ndarray, key_index: Dict[Tuple, int], n_groups: int,
    grow: bool = True,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Map a batch of stacked group-key rows through an existing dictionary.

    Known keys take their existing gid; unseen ones get fresh ids in the
    order ``unique_rows`` lists them (``key_index`` is mutated in place), or
    raise ``KeyError`` when ``grow=False``.  The shared primitive of the
    catalog's encoding refresh, sketch maintainers and sample extension.
    Returns ``(gid per batch row, unseen unique key rows in assignment
    order, new group count)``.
    """
    uniq, inv = unique_rows(stacked)
    mapped = np.empty(uniq.shape[0], dtype=np.int64)
    new_rows = []
    for i, row in enumerate(uniq):
        key = tuple(row.tolist())
        g = key_index.get(key)
        if g is None:
            if not grow:
                raise KeyError(key)
            g = n_groups
            key_index[key] = g
            n_groups += 1
            new_rows.append(i)
        mapped[i] = g
    return mapped[inv], uniq[new_rows], n_groups


def extend_group_values(
    group_values: Dict[str, np.ndarray],
    attrs: Tuple[str, ...],
    new_keys: np.ndarray,
) -> Dict[str, np.ndarray]:
    """Append freshly assigned groups' key values (dtype-preserving); a new
    dict, since the inputs are shared with live cache entries."""
    if not len(new_keys):
        return group_values
    return {
        a: np.concatenate([group_values[a],
                           new_keys[:, j].astype(group_values[a].dtype, copy=False)])
        for j, a in enumerate(attrs)
    }


def extend_encoding(
    parent: GroupEncoding, batch: ColumnTable, attrs: Tuple[str, ...]
) -> GroupEncoding:
    """Dictionary-encode ``batch`` against ``parent``'s group dictionary:
    known keys keep their gid, unseen keys get fresh ids appended.  Work is
    O(batch + new groups), never O(table)."""
    if not attrs:
        gid = np.concatenate([parent.gid, np.zeros(batch.num_rows, dtype=np.int32)])
        return GroupEncoding(gid, torch.from_numpy(gid).to(batch.device), parent.n_groups,
                             parent.group_values)
    stacked = np.stack([to_host(batch[a]) for a in attrs], axis=1)
    key_index = dict(parent.key_index(attrs))  # copy: parent entry stays valid
    delta_gid, new_keys, n_groups = map_group_keys(stacked, key_index, parent.n_groups)
    group_values = extend_group_values(parent.group_values, attrs, new_keys)
    gid = np.concatenate([parent.gid, delta_gid]).astype(np.int32)
    return GroupEncoding(gid, torch.from_numpy(gid).to(batch.device), n_groups,
                         group_values, key_index)


def join_rows(
    fact_cols: Dict[str, torch.Tensor],
    right: ColumnTable,
    left_key: str,
    right_key: str,
) -> Tuple[Dict[str, torch.Tensor], np.ndarray, np.ndarray]:
    """Inner equi-join of a column batch against ``right`` (right key unique).

    Returns ``(joined columns, matched batch row ids, right row ids)``; the
    joined rows keep the batch's row order.  A right column whose name the
    batch already has becomes ``<right>.<attr>``, so a delta batch joins
    byte-compatibly with its parent layout.  The key sort and search run on
    the host, the column gathers on the columns' device.
    """
    lk = to_host(fact_cols[left_key])
    rk = to_host(right[right_key])
    order = np.argsort(rk, kind="stable")
    rk_sorted = rk[order]
    pos = np.searchsorted(rk_sorted, lk)
    pos_clip = np.minimum(pos, len(rk_sorted) - 1)
    matched = rk_sorted[pos_clip] == lk
    fact_idx = np.nonzero(matched)[0]
    right_idx = order[pos_clip[fact_idx]]

    cols: Dict[str, torch.Tensor] = {}
    fact_take = torch.from_numpy(fact_idx).to(fact_cols[left_key].device)
    right_take = torch.from_numpy(right_idx).to(right.device)
    for a in sorted(fact_cols):
        cols[a] = fact_cols[a].index_select(0, fact_take)
    for a in right.schema:
        name = a if a not in cols else f"{right.name}.{a}"
        cols[name] = right[a].index_select(0, right_take)
    return cols, fact_idx, right_idx


class Catalog:
    """Cross-query cache of encodings, bucketizations, joins and instances.

    Every map is bounded FIFO (``max_entries`` per map): entries hold strong
    table references to keep their id() keys valid.
    """

    def __init__(self, max_entries: int = 512):
        self.stats: collections.Counter = collections.Counter()
        self.max_entries = max_entries
        self._groups: Dict[Tuple[int, Tuple[str, ...]], Tuple[ColumnTable, GroupEncoding]] = {}
        self._buckets: Dict[Tuple[int, Tuple], Tuple[ColumnTable, torch.Tensor]] = {}
        self._frag_sizes: Dict[Tuple[int, Tuple], Tuple[ColumnTable, np.ndarray]] = {}
        self._joins: Dict[Tuple[int, int, str, str],
                          Tuple[ColumnTable, ColumnTable, ColumnTable, np.ndarray]] = {}
        self._instances: Dict[Tuple[int, int], Tuple[object, ColumnTable, ColumnTable]] = {}
        self._distinct: Dict[Tuple[int, str], Tuple[ColumnTable, int, np.ndarray]] = {}
        self._nonneg: Dict[Tuple[int, str], Tuple[ColumnTable, bool]] = {}
        self._wheres: Dict[Tuple[int, Tuple], Tuple[ColumnTable, torch.Tensor]] = {}
        # Fragment id per group, keyed by *value* (uid, version, group-by,
        # partition): a pure function of the group dictionary and the bounds.
        self._frag_groups: Dict[Tuple, np.ndarray] = {}
        # Instance -> (instance, base table, base-row index per instance row).
        self._instance_rows: Dict[int, Tuple[ColumnTable, ColumnTable, np.ndarray]] = {}
        # Stacked shard-major launch inputs, keyed by registration (and table
        # lineage and plan) with a token guard (per-shard table versions and
        # the sketch bits); the values are opaque here.
        self._stacked: Dict[Tuple, Tuple[Tuple, object]] = {}

    def _put(self, cache: Dict, key, value) -> None:
        if len(cache) >= self.max_entries:
            cache.pop(next(iter(cache)))  # FIFO eviction (insertion-ordered)
            self.stats["evictions"] += 1
        cache[key] = value

    def invalidate_table(self, table: ColumnTable) -> None:
        """Drop every entry keyed to ``table`` (it was replaced): entries of
        a dead object can never hit again but would pin its columns."""
        tid = id(table)
        for cache in (self._groups, self._buckets, self._frag_sizes,
                      self._distinct, self._nonneg, self._wheres):
            for k in [k for k in cache if k[0] == tid]:
                del cache[k]
        for k in [k for k in self._joins if tid in (k[0], k[1])]:
            del self._joins[k]
        for k in [k for k in self._instances if k[1] == tid]:
            del self._instances[k]
        for k in [k for k, v in self._instance_rows.items()
                  if k == tid or v[1] is table]:
            del self._instance_rows[k]

    def invalidate_chain(self, table: ColumnTable) -> None:
        """Invalidate ``table`` and every ancestor on its delta chain (the
        companion of ``ColumnTable.collapse``)."""
        t = table
        while t is not None:
            self.invalidate_table(t)
            t = t.delta.parent if t.delta is not None else None

    # -- stacked shard-major instances ---------------------------------------
    def get_stacked(self, key: Tuple, token: Tuple) -> Optional[object]:
        hit = self._stacked.get(key)
        if hit is not None and hit[0] == token:
            self.stats["stacked_hit"] += 1
            return hit[1]
        return None

    def put_stacked(self, key: Tuple, token: Tuple, value: object) -> None:
        self.stats["stacked_build"] += 1
        self._put(self._stacked, key, (token, value))

    def drop_stacked(self, key_prefix: Tuple) -> None:
        """Drop the stacked entries whose key starts with ``key_prefix`` (an
        evicted registration's stack must stop pinning device memory)."""
        for k in [k for k in self._stacked if k[: len(key_prefix)] == key_prefix]:
            del self._stacked[k]

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
        d = table.delta
        if d is not None and attrs:
            parent_enc = self.groups(d.parent, attrs)
            if d.kind == "append":
                enc = extend_encoding(parent_enc, d.appended, tuple(attrs))
            else:
                gid = parent_enc.gid[d.kept_idx].astype(np.int32)
                # Group numbering survives a delete; emptied groups simply
                # stop appearing (the executor's present-mask hides them).
                enc = GroupEncoding(gid, torch.from_numpy(gid).to(table.device),
                                    parent_enc.n_groups, parent_enc.group_values,
                                    parent_enc._key_index)
            self.stats["encode_groups_delta"] += 1
            self._put(self._groups, key, (table, enc))
            return enc
        self.stats["encode_groups"] += 1
        gid, n_groups, group_values = encode_groups(table, attrs)
        enc = GroupEncoding(gid, torch.from_numpy(gid).to(table.device), n_groups,
                            group_values)
        self._put(self._groups, key, (table, enc))
        return enc

    # -- partition-attribute bucketizations ----------------------------------
    @staticmethod
    def _bucketize_raw(table: ColumnTable, ranges) -> torch.Tensor:
        """Bucketize one table under a single-attribute or composite
        partition."""
        return cross_product_id(parts_of(ranges), lambda r: r.bucketize(table[r.attr]))

    def bucketize(self, table: ColumnTable, ranges: "RangeSet") -> torch.Tensor:
        key = (id(table), ranges.key())
        hit = self._buckets.get(key)
        if hit is not None and hit[0] is table:
            self.stats["bucketize_hit"] += 1
            return hit[1]
        d = table.delta
        if d is not None:
            parent_bucket = self.bucketize(d.parent, ranges)
            if d.kind == "append":
                bucket = torch.cat([parent_bucket, self._bucketize_raw(d.appended, ranges)])
            else:
                bucket = parent_bucket.index_select(
                    0, torch.from_numpy(d.kept_idx).to(table.device))
            self.stats["bucketize_delta"] += 1
            self._put(self._buckets, key, (table, bucket))
            return bucket
        self.stats["bucketize"] += 1
        bucket = self._bucketize_raw(table, ranges)
        self._put(self._buckets, key, (table, bucket))
        return bucket

    def frag_of_group(
        self,
        table: ColumnTable,
        ranges: "RangeSet",
        groupby: Tuple[str, ...],
        group_values: Dict[str, np.ndarray],
    ) -> np.ndarray:
        """Fragment id per *group* under a partition on group-by attributes
        (the CB-OPT-GB and CB-OPT-GB2 fast path's vector), cached per (table
        version, group-by, partition).  The group values are host metadata,
        so they are bucketized on the host with the device's float32
        comparison; a composite partition assembles the row-major
        cross-product id part by part."""
        key = (table.uid, table.version, tuple(groupby), ranges.key())
        hit = self._frag_groups.get(key)
        n_groups = len(next(iter(group_values.values()))) if group_values else 1
        if hit is not None and hit.shape[0] == n_groups:
            self.stats["frag_of_group_hit"] += 1
            return hit
        self.stats["frag_of_group"] += 1
        frag = cross_product_id(parts_of(ranges), lambda r: to_host(r.bucketize(
            torch.from_numpy(np.ascontiguousarray(group_values[r.attr])))))
        if len(self._frag_groups) >= self.max_entries:
            self._frag_groups.pop(next(iter(self._frag_groups)))
        self._frag_groups[key] = frag
        return frag

    def cached_bucket(self, table: ColumnTable, ranges: "RangeSet") -> Optional[torch.Tensor]:
        """The full bucket vector iff it is available without full-table
        work: cached, or delta-refreshable from a cached ancestor."""
        t = table
        while True:
            hit = self._buckets.get((id(t), ranges.key()))
            if hit is not None and hit[0] is t:
                return self.bucketize(table, ranges)  # delta-refresh the chain
            if t.delta is None:
                return None
            t = t.delta.parent

    def fragment_sizes(self, table: ColumnTable, ranges: "RangeSet") -> np.ndarray:
        """Rows per fragment (host int32), from the cached bucketization."""
        key = (id(table), ranges.key())
        hit = self._frag_sizes.get(key)
        if hit is not None and hit[0] is table:
            self.stats["fragment_sizes_hit"] += 1
            return hit[1]
        d = table.delta
        if d is not None:
            parent_sizes = self.fragment_sizes(d.parent, ranges)
            if d.kind == "append":
                # Refresh the full bucket vector through the delta path: its
                # batch-sized tail feeds the counts, and the cached vector is
                # what sketch application gathers from next.
                delta_bucket = to_host(self.bucketize(table, ranges)[d.parent.num_rows:])
                sign = 1
            else:
                delta_bucket = to_host(self.bucketize(d.parent, ranges).index_select(
                    0, torch.from_numpy(d.deleted_idx).to(table.device)))
                sign = -1
            counts = np.bincount(delta_bucket, minlength=ranges.n_ranges)
            sizes = parent_sizes + sign * counts.astype(parent_sizes.dtype)
            self.stats["fragment_sizes_delta"] += 1
            self._put(self._frag_sizes, key, (table, sizes))
            return sizes
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
        predicate); an instance's mask is gathered from its base table's, and
        a mutated version's is refreshed from its parent's (appends evaluate
        the batch alone, deletes gather the kept rows)."""
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
        d = table.delta
        if d is not None:
            parent_mask = self.where_mask(d.parent, pred)
            if d.kind == "append":
                mask = torch.cat([parent_mask, pred.mask(d.appended)])
            else:
                mask = parent_mask.index_select(
                    0, torch.from_numpy(d.kept_idx).to(table.device))
            self.stats["where_mask_delta"] += 1
            self._put(self._wheres, key, (table, mask))
            return mask
        self.stats["where_mask"] += 1
        mask = pred.mask(table)
        self._put(self._wheres, key, (table, mask))
        return mask

    # -- join layouts ---------------------------------------------------------
    def join(
        self, fact: ColumnTable, right: ColumnTable, left_key: str, right_key: str
    ) -> Tuple[ColumnTable, np.ndarray]:
        """Materialized equi-join (right key unique) and the fact row of each
        joined row.  Fact rows with no partner are dropped (inner join);
        right columns are prefixed with ``<right>.`` when their name
        collides."""
        key = (id(fact), id(right), left_key, right_key)
        hit = self._joins.get(key)
        if hit is not None and hit[0] is fact and hit[1] is right:
            self.stats["join_hit"] += 1
            return hit[2], hit[3]
        d = fact.delta
        if d is not None:
            p_joined, p_fact_idx = self.join(d.parent, right, left_key, right_key)
            if d.kind == "append":
                cols_new, b_idx, _ = join_rows(d.appended.columns, right, left_key, right_key)
                # The new joined table is an append of its parent, so the
                # joined relation has a delta chain of its own.
                joined = p_joined.append({a: to_host(cols_new[a]) for a in p_joined.schema})
                fact_idx = np.concatenate([p_fact_idx, b_idx + d.parent.num_rows])
            else:
                keep_row = np.zeros(d.parent.num_rows, dtype=bool)
                keep_row[d.kept_idx] = True
                old_to_new = np.cumsum(keep_row) - 1
                joined_keep = keep_row[p_fact_idx]
                joined = p_joined.delete(~joined_keep)
                fact_idx = old_to_new[p_fact_idx[joined_keep]]
            self.stats["join_delta"] += 1
            self._put(self._joins, key, (fact, right, joined, fact_idx))
            return joined, fact_idx
        self.stats["join_materialize"] += 1
        cols, fact_idx, _ = join_rows(fact.columns, right, left_key, right_key)
        joined = ColumnTable(f"{fact.name}_join_{right.name}", cols, fact.primary_key)
        self._put(self._joins, key, (fact, right, joined, fact_idx))
        return joined, fact_idx

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
            self.note_subset(instance, table, rows)

    def note_subset(self, subset: ColumnTable, table: ColumnTable, rows: np.ndarray) -> None:
        """Record that row i of ``subset`` is row ``rows[i]`` of ``table``, so
        the subset's group encodings and WHERE masks derive from ``table``'s
        by a gather."""
        self._put(self._instance_rows, id(subset), (subset, table, np.asarray(rows)))

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
        d = table.delta
        if d is not None and d.kind == "append":
            parent_hit = self._distinct.get((id(d.parent), attr))
            if parent_hit is not None and parent_hit[0] is d.parent:
                uniq = np.union1d(parent_hit[2], to_host(d.appended[attr]))
                self.stats["distinct_count_delta"] += 1
                self._put(self._distinct, key, (table, int(uniq.shape[0]), uniq))
                return int(uniq.shape[0])
        # Deletes may or may not remove a value's last occurrence, so they
        # recompute; appends without a cached parent do too.
        self.stats["distinct_count"] += 1
        uniq = np.unique(to_host(table[attr]))
        self._put(self._distinct, key, (table, int(uniq.shape[0]), uniq))
        return int(uniq.shape[0])

    def column_nonnegative(self, table: ColumnTable, attr: str) -> bool:
        key = (id(table), attr)
        hit = self._nonneg.get(key)
        if hit is not None and hit[0] is table:
            return hit[1]
        d = table.delta
        if d is not None:
            parent_hit = self._nonneg.get((id(d.parent), attr))
            if parent_hit is not None and parent_hit[0] is d.parent:
                parent_ok = parent_hit[1]
                if d.kind == "append":
                    ok = parent_ok and not bool((d.appended[attr] < 0).any())
                    self.stats["column_stats_delta"] += 1
                    self._put(self._nonneg, key, (table, ok))
                    return ok
                if parent_ok:  # removing rows cannot introduce negatives
                    self.stats["column_stats_delta"] += 1
                    self._put(self._nonneg, key, (table, True))
                    return True
        self.stats["column_stats"] += 1
        ok = not bool((table[attr] < 0).any())
        self._put(self._nonneg, key, (table, ok))
        return ok


_DEFAULT = Catalog()


def default_catalog() -> Catalog:
    """Process-wide catalog used when callers don't thread their own."""
    return _DEFAULT
