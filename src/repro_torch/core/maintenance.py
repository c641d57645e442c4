"""Incremental maintenance of provenance sketches under appends and deletes
(port of ``repro/core/maintenance.py``).

Without maintenance every insert or delete would invalidate every sketch,
and the only recovery is a full re-capture.  Following the counter-based
scheme of "In-memory Incremental Maintenance of Provenance Sketches", a
``SketchMaintainer`` keeps just enough per-sketch state to repair the bits
with delta-sized work:

  * a private copy of the group dictionary of the query's GROUP BY,
  * per-group aggregate state: float64 sums and int64 WHERE-passing counts,
    updated from the delta rows alone,
  * per-(group, fragment) incidence counters over WHERE-passing rows, and a
    per-fragment provenance counter ``frag_prov`` — a bit is set iff its
    counter is positive,
  * the surviving-group vector, recomputed from the maintained aggregates by
    ``queries.provenance_group_keep``, the same group-level code a capture
    runs, so maintained bits equal re-captured bits whenever the aggregate
    arithmetic is exact (integral columns within float32 range).

For monotone-*unsafe* queries (``safety.monotone_safe``) a group flipping to
"not surviving" does not clear bits (the conservative keep-bit fallback):
a stale set bit merely skips less, a wrongly cleared one would be unsafe.

The state lives on the host with the reference's dtypes (float64
``np.add.at``, int64 ``bincount``, a dict of dicts for the incidence), so
the counters are equal bits to the reference's.  The delta rows come from
the table's device once per delta.

Join templates are maintained for mutations of the *fact* table: the delta
batch alone is joined against the dimension table, held by identity.  A
mutated dimension table raises ``MaintenanceError`` and ``repair_sketch``
re-captures.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.catalog import (
    Catalog,
    default_catalog,
    extend_group_values,
    join_rows,
    map_group_keys,
)
from repro_torch.core.queries import _OPS, Query, provenance_group_keep
from repro_torch.core.ranges import RangeSet
from repro_torch.core.safety import monotone_safe
from repro_torch.core.sketch import ProvenanceSketch
from repro_torch.core.table import ColumnTable, Database, TableDelta
from repro_torch.device import to_host


class MaintenanceError(RuntimeError):
    """Raised when a delta cannot be maintained; callers re-capture."""


def _predicate_mask(q: Query, cols: Dict[str, np.ndarray], n: int) -> np.ndarray:
    if q.where is None:
        return np.ones(n, dtype=bool)
    return np.asarray(_OPS[q.where.op](cols[q.where.attr], q.where.value))


def _pair_counts(gid: np.ndarray, frag: np.ndarray,
                 n_ranges: int) -> Tuple[np.ndarray, np.ndarray]:
    """Deduped (group, fragment) pairs in lexicographic order and their row
    counts: the reference's ``np.unique(axis=0)`` over the stacked pairs,
    computed as a 1-D ``np.unique`` of ``gid * n_ranges + frag`` (the same
    order, since every fragment id lies in ``[0, n_ranges)``)."""
    if not gid.size:
        return np.empty((0, 2), dtype=np.int64), np.empty(0, dtype=np.int64)
    keys, cnts = np.unique(gid.astype(np.int64) * n_ranges + frag, return_counts=True)
    return np.stack([keys // n_ranges, keys % n_ranges], axis=1), cnts


def _is_integral(col: torch.Tensor) -> bool:
    return bool(np.issubdtype(to_host(col[:0]).dtype, np.integer))


class SketchMaintainer:
    """Delta-maintained state for one (query, range partition) sketch."""

    def __init__(self, q: Query, db: Database, ranges: RangeSet,
                 catalog: Optional[Catalog] = None):
        if not isinstance(ranges, RangeSet):
            raise MaintenanceError("only single-attribute RangeSet partitions "
                                   "are maintainable; composite sketches re-capture")
        catalog = catalog or default_catalog()
        self.q = q
        self.ranges = ranges
        fact = db[q.table]
        self.device = fact.device
        self.table_uid = fact.uid
        self.version = fact.version
        self.exact = monotone_safe(q, db, catalog)
        self.conservative = False
        self.right = db[q.join.right] if q.join is not None else None

        if q.join is not None:
            flat, fact_idx = catalog.join(fact, self.right, q.join.left_key,
                                          q.join.right_key)
        else:
            flat, fact_idx = fact, None
        enc = catalog.groups(flat, q.groupby)
        bucket = to_host(catalog.bucketize(fact, ranges))
        frag = bucket if fact_idx is None else bucket[fact_idx]
        where = _predicate_mask(
            q, {a: to_host(flat[a]) for a in ([q.where.attr] if q.where else [])},
            flat.num_rows)
        if q.agg.fn == "count":
            values = np.ones(flat.num_rows, dtype=np.float64)
            self._values_integral = True
        else:
            values = to_host(flat[q.agg.attr]).astype(np.float64)
            self._values_integral = _is_integral(flat[q.agg.attr])

        # Private copies: the maintainer must outlive catalog evictions.
        self.n_groups = enc.n_groups
        self.key_index: Dict[Tuple, int] = dict(enc.key_index(q.groupby))
        self.group_values = {a: v.copy() for a, v in enc.group_values.items()}
        self.sums = np.zeros(self.n_groups, dtype=np.float64)
        np.add.at(self.sums, enc.gid[where], values[where])
        self.counts = np.bincount(enc.gid[where], minlength=self.n_groups).astype(np.int64)
        # incidence[g] = {fragment: count of WHERE-passing rows}: group flips
        # touch one row; the build loops over deduped (group, fragment) pairs.
        self.incidence: List[Dict[int, int]] = [dict() for _ in range(self.n_groups)]
        # All rows start owned; ``clone_for`` flips rows to shared (copy on
        # write) so same-signature maintainers do not copy every row.
        self._row_owned = np.ones(self.n_groups, dtype=bool)
        pairs, cnts = _pair_counts(enc.gid[where], frag[where], ranges.n_ranges)
        for (g, f), c in zip(pairs, cnts):
            self.incidence[int(g)][int(f)] = int(c)
        self.passing = provenance_group_keep(
            q, self._agg_f32(), self.group_values, self.n_groups, self.device)
        # counted[g]: g's incidence row is currently folded into frag_prov.
        self.counted = self.passing.copy()
        sel = self.counted[pairs[:, 0]] if len(pairs) else np.zeros(0, dtype=bool)
        self.frag_prov = np.bincount(
            pairs[sel, 1], weights=cnts[sel], minlength=ranges.n_ranges
        ).astype(np.int64)

    def clone_for(self, q: Query, db: Database,
                  catalog: Optional[Catalog] = None) -> "SketchMaintainer":
        """A maintainer for ``q`` sharing this one's threshold-independent
        counting state (sums, counts, incidence), which depends only on the
        inner-block signature and the partition.  The surviving set,
        ``frag_prov`` and monotone safety are derived per query as a fresh
        build would, so a clone equals ``SketchMaintainer(q, ...)``."""
        m = object.__new__(SketchMaintainer)
        m.q = q
        m.ranges = self.ranges
        m.device = self.device
        m.table_uid = self.table_uid
        m.version = self.version
        m.exact = monotone_safe(q, db, catalog or default_catalog())
        m.conservative = False
        m.right = self.right
        m._values_integral = self._values_integral
        m.n_groups = self.n_groups
        m.key_index = dict(self.key_index)
        m.group_values = self.group_values  # replaced on growth, never mutated
        m.sums = self.sums.copy()
        m.counts = self.counts.copy()
        # Copy-on-write incidence: clones share the row dicts and
        # ``_own_row`` copies a row only when a delta touches it.
        m.incidence = list(self.incidence)
        m._row_owned = np.zeros(self.n_groups, dtype=bool)
        self._row_owned[:] = False
        m.passing = provenance_group_keep(q, m._agg_f32(), m.group_values, m.n_groups,
                                          m.device)
        m.counted = m.passing.copy()
        m.frag_prov = np.zeros_like(self.frag_prov)
        for g in np.nonzero(m.counted)[0]:
            for f, c in m.incidence[int(g)].items():
                m.frag_prov[f] += c
        return m

    # -- replication -----------------------------------------------------------
    def state_dict(self) -> dict:
        """Portable counter state: per-group aggregates, the deduped (group,
        fragment) incidence and the threshold products, pinned to the fact
        table's (uid, version), and the join dimension's when there is one,
        so a restore can delta-replay forward with ``apply``.  ``key_index``
        is rebuilt on restore."""
        gs: List[int] = []
        fs: List[int] = []
        cs: List[int] = []
        for g, row in enumerate(self.incidence):
            for f, c in row.items():
                gs.append(g)
                fs.append(f)
                cs.append(c)
        return {
            "table_uid": self.table_uid,
            "version": self.version,
            "exact": bool(self.exact),
            "conservative": bool(self.conservative),
            "values_integral": bool(self._values_integral),
            "right_uid": None if self.right is None else self.right.uid,
            "right_version": None if self.right is None else self.right.version,
            "n_groups": int(self.n_groups),
            "group_values": {a: v.copy() for a, v in self.group_values.items()},
            "sums": self.sums.copy(),
            "counts": self.counts.copy(),
            "incidence": (np.asarray(gs, dtype=np.int64),
                          np.asarray(fs, dtype=np.int64),
                          np.asarray(cs, dtype=np.int64)),
            "passing": self.passing.copy(),
            "counted": self.counted.copy(),
            "frag_prov": self.frag_prov.copy(),
        }

    @classmethod
    def from_state(cls, q: Query, db: Database, ranges: RangeSet,
                   state: dict) -> "SketchMaintainer":
        """Resurrect a maintainer from ``state_dict`` output; raises
        ``MaintenanceError`` when the state is for another lineage or its
        join dimension is at another version than the counters were folded
        against."""
        if not isinstance(ranges, RangeSet):
            raise MaintenanceError("only single-attribute RangeSet partitions "
                                   "are maintainable; composite sketches re-capture")
        fact = db[q.table]
        if state["table_uid"] != fact.uid:
            raise MaintenanceError(
                f"replicated maintainer is for table uid {state['table_uid']}, "
                f"not {fact.uid}")
        m = object.__new__(cls)
        m.q = q
        m.ranges = ranges
        m.device = fact.device
        m.table_uid = state["table_uid"]
        m.version = int(state["version"])
        m.exact = bool(state["exact"])
        m.conservative = bool(state["conservative"])
        m._values_integral = bool(state["values_integral"])
        if q.join is not None:
            right = db[q.join.right]
            if (right.uid != state["right_uid"]
                    or right.version != state["right_version"]):
                raise MaintenanceError("join dimension table moved since the "
                                       "state was replicated; re-capture")
            m.right = right
        else:
            m.right = None
        m.n_groups = int(state["n_groups"])
        m.group_values = {a: np.asarray(v).copy()
                          for a, v in state["group_values"].items()}
        cols = [m.group_values[a].tolist() for a in q.groupby]
        m.key_index = ({key: g for g, key in enumerate(zip(*cols))}
                       if cols else {(): 0})
        m.sums = np.asarray(state["sums"], dtype=np.float64).copy()
        m.counts = np.asarray(state["counts"], dtype=np.int64).copy()
        m.incidence = [dict() for _ in range(m.n_groups)]
        gs, fs, cs = state["incidence"]
        for g, f, c in zip(gs.tolist(), fs.tolist(), cs.tolist()):
            m.incidence[g][f] = c
        m._row_owned = np.ones(m.n_groups, dtype=bool)
        m.passing = np.asarray(state["passing"], dtype=bool).copy()
        m.counted = np.asarray(state["counted"], dtype=bool).copy()
        m.frag_prov = np.asarray(state["frag_prov"], dtype=np.int64).copy()
        return m

    # -- group-aggregate bookkeeping ------------------------------------------
    def _agg_f32(self) -> np.ndarray:
        """Per-group aggregate values with the executor's float32 semantics."""
        sums = self.sums.astype(np.float32)
        counts = self.counts.astype(np.float32)
        if self.q.agg.fn == "count":
            return counts
        if self.q.agg.fn == "sum":
            return sums
        return sums / np.maximum(counts, np.float32(1.0))

    def _own_row(self, g: int) -> Dict[int, int]:
        """The group's incidence row, copied first if shared with a clone."""
        row = self.incidence[g]
        if not self._row_owned[g]:
            row = dict(row)
            self.incidence[g] = row
            self._row_owned[g] = True
        return row

    def _grow_groups(self, new_keys: np.ndarray, n_groups: int) -> None:
        """Extend per-group state for freshly assigned gids (appends only)."""
        n_new = n_groups - self.n_groups
        if not n_new:
            return
        self.n_groups = n_groups
        self.incidence.extend(dict() for _ in range(n_new))
        self._row_owned = np.concatenate(
            [self._row_owned, np.ones(n_new, dtype=bool)])
        self.sums = np.concatenate([self.sums, np.zeros(n_new)])
        self.counts = np.concatenate([self.counts, np.zeros(n_new, dtype=np.int64)])
        self.passing = np.concatenate([self.passing, np.zeros(n_new, dtype=bool)])
        self.counted = np.concatenate([self.counted, np.zeros(n_new, dtype=bool)])
        self.group_values = extend_group_values(self.group_values, self.q.groupby,
                                                new_keys)

    def _delta_products(
        self, cols: Dict[str, np.ndarray], grow: bool
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(gid, where, values) for one delta batch's rows."""
        n = len(next(iter(cols.values()))) if cols else 0
        where = _predicate_mask(self.q, cols, n)
        if self.q.agg.fn == "count":
            values = np.ones(n, dtype=np.float64)
        else:
            values = np.asarray(cols[self.q.agg.attr], dtype=np.float64)
        if not self.q.groupby:
            return np.zeros(n, dtype=np.int64), where, values
        stacked = np.stack([np.asarray(cols[a]) for a in self.q.groupby], axis=1)
        try:
            gid, new_keys, n_groups = map_group_keys(
                stacked, self.key_index, self.n_groups, grow=grow)
        except KeyError as e:  # pragma: no cover - state corruption guard
            raise MaintenanceError(f"unknown group key in delta: {e}") from None
        if grow:
            self._grow_groups(new_keys, n_groups)
        return gid, where, values

    def _delta_cols(self, batch: ColumnTable) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """A delta batch's flat columns on the host, and the fragment id of
        each flat row's fact row (bucketized on the batch's device, in
        float32 as every capture is).  With a join the flat rows are the
        batch rows that have a partner, joined."""
        frag = to_host(self.ranges.bucketize(batch[self.ranges.attr]))
        if self.q.join is None:
            return {a: to_host(batch[a]) for a in batch.schema}, frag
        cols, b_idx, _ = join_rows(batch.columns, self.right, self.q.join.left_key,
                                   self.q.join.right_key)
        return {a: to_host(v) for a, v in cols.items()}, frag[b_idx]

    # -- delta application -----------------------------------------------------
    def _update_rows(self, gid: np.ndarray, frag: np.ndarray, where: np.ndarray,
                     values: np.ndarray, sign: int) -> None:
        """Fold one batch of rows into the counters (sign=+1/-1)."""
        g_w, f_w, v_w = gid[where], frag[where], values[where]
        np.add.at(self.sums, g_w, sign * v_w)
        np.add.at(self.counts, g_w, sign)
        if g_w.size:
            pairs, cnts = _pair_counts(g_w, f_w, self.ranges.n_ranges)
            for (g, f), c in zip(pairs, cnts):
                g, f, c = int(g), int(f), int(c) * sign
                row = self._own_row(g)
                row[f] = row.get(f, 0) + c
                if row[f] == 0:
                    del row[f]
                if self.counted[g]:
                    self.frag_prov[f] += c

    def _clears_trustworthy(self) -> bool:
        """May a group flip to "not surviving" clear its fragments' bits?

        Only when the float64 aggregates reproduce the executor's float32
        arithmetic bit for bit: monotone-safe query, integral aggregation
        column, and every sum the executor forms under 2**24.  Outside that
        envelope bits are kept instead (slack, never wrong).
        """
        if not (self.exact and self._values_integral):
            return False
        limit = 2.0 ** 24
        if self.counts.size and float(self.counts.max()) >= limit:
            return False
        if self.q.agg.fn != "count" and self.sums.size \
                and float(np.abs(self.sums).max()) >= limit:
            return False
        if self.q.outer_groupby is not None:
            # Outer sums accumulate the inner values; bound their total.
            inner_mag = self.counts if self.q.agg.fn == "count" else np.abs(self.sums)
            if float(inner_mag.sum()) >= limit:
                return False
        return True

    def _reconcile_passing(self) -> None:
        """Recompute the surviving-group set and fold flips into frag_prov."""
        passing = provenance_group_keep(
            self.q, self._agg_f32(), self.group_values, self.n_groups, self.device)
        trust_clears = self._clears_trustworthy()
        for g in np.nonzero(passing != self.counted)[0]:
            g = int(g)
            if passing[g]:
                for f, c in self.incidence[g].items():
                    self.frag_prov[f] += c
                self.counted[g] = True
            elif trust_clears:
                for f, c in self.incidence[g].items():
                    self.frag_prov[f] -= c
                self.counted[g] = False
            else:
                # Conservative keep-bit fallback: a stale bit is slack, a
                # clear on a possibly rounding-divergent aggregate is not safe.
                self.conservative = True
        self.passing = passing

    def _apply_one(self, delta: TableDelta) -> None:
        if delta.kind == "append":
            cols, frag = self._delta_cols(delta.appended)
            gid, where, values = self._delta_products(cols, grow=True)
            self._update_rows(gid, frag, where, values, +1)
        else:
            cols, frag = self._delta_cols(delta.parent.gather(delta.deleted_idx))
            gid, where, values = self._delta_products(cols, grow=False)
            self._update_rows(gid, frag, where, values, -1)
        self._reconcile_passing()

    def apply(self, table: ColumnTable, db: Database) -> None:
        """Advance the maintained state to ``table``'s version via its deltas."""
        if table.uid != self.table_uid:
            raise MaintenanceError(
                f"table lineage changed (uid {table.uid} != {self.table_uid})")
        if self.q.join is not None and db[self.q.join.right] is not self.right:
            raise MaintenanceError("join dimension table mutated; re-capture")
        chain: List[TableDelta] = []
        t = table
        while t.version > self.version:
            if t.delta is None:
                raise MaintenanceError(
                    f"no delta chain from v{self.version} to v{t.version}")
            chain.append(t.delta)
            t = t.delta.parent
        for delta in reversed(chain):
            self._apply_one(delta)
        self.version = table.version

    # -- products --------------------------------------------------------------
    def repair(self) -> None:
        """Re-derive frag_prov exactly from the counters (drops conservatism)."""
        for g in np.nonzero(self.counted & ~self.passing)[0]:
            g = int(g)
            for f, c in self.incidence[g].items():
                self.frag_prov[f] -= c
            self.counted[g] = False
        self.conservative = False

    def bits(self) -> np.ndarray:
        return self.frag_prov > 0

    def to_sketch(self, table: ColumnTable,
                  catalog: Optional[Catalog] = None) -> ProvenanceSketch:
        """Materialize the maintained state as a sketch for ``table``."""
        if table.version != self.version or table.uid != self.table_uid:
            raise MaintenanceError("maintainer not at the table's version")
        catalog = catalog or default_catalog()
        bits = self.bits()
        sizes = catalog.fragment_sizes(table, self.ranges)
        return ProvenanceSketch(
            table=self.q.table, ranges=self.ranges, bits=bits,
            size_rows=int(sizes[bits].sum()), total_rows=table.num_rows,
            table_uid=table.uid, table_version=table.version,
        )


def build_maintainer(q: Query, db: Database, ranges: RangeSet,
                     catalog: Optional[Catalog] = None) -> SketchMaintainer:
    """Build maintenance state for a just-captured sketch (cached products)."""
    return SketchMaintainer(q, db, ranges, catalog)


def maintainer_for(
    q: Query,
    db: Database,
    ranges: RangeSet,
    catalog: Optional[Catalog],
    pool: List[SketchMaintainer],
) -> SketchMaintainer:
    """A maintainer for ``q``, cloned from a pool-mate with the same
    inner-block signature, partition and table version, else built fresh."""
    fact = db[q.table]
    sig = q.inner_signature()
    for m in pool:
        if (m.q.inner_signature() == sig
                and m.ranges.key() == ranges.key()
                and m.table_uid == fact.uid and m.version == fact.version):
            return m.clone_for(q, db, catalog)
    return SketchMaintainer(q, db, ranges, catalog)


@dataclasses.dataclass
class RepairResult:
    sketch: ProvenanceSketch
    maintained: bool  # False => fell back to full re-capture


def repair_sketch(
    q: Query,
    db: Database,
    sketch: ProvenanceSketch,
    maintainer: Optional[SketchMaintainer],
    catalog: Optional[Catalog] = None,
) -> Tuple[RepairResult, Optional[SketchMaintainer]]:
    """Bring a stale sketch up to the current table version: delta
    maintenance first; on ``MaintenanceError`` a full re-capture, with a
    rebuilt maintainer so the next mutation is cheap again."""
    from repro_torch.core.sketch import capture_sketch

    catalog = catalog or default_catalog()
    table = db[q.table]
    try:
        if maintainer is None:
            raise MaintenanceError("no maintainer")
        maintainer.apply(table, db)
        sk = maintainer.to_sketch(table, catalog)
        catalog.stats["sketch_maintained"] += 1
        return RepairResult(sk, True), maintainer
    except MaintenanceError:
        sk = capture_sketch(q, db, sketch.ranges, catalog=catalog)
        catalog.stats["sketch_recaptured"] += 1
        try:
            maintainer = build_maintainer(q, db, sketch.ranges, catalog)
        except MaintenanceError:
            maintainer = None
        return RepairResult(sk, False), maintainer
