"""Query IR + executor for the paper's templates (port of
``repro/core/queries.py``).

Templates: Q-AGH (aggregation-groupby-having, optional WHERE/HAVING),
Q-AJGH (with an equi-join of the fact table against a dimension whose key
is unique), and the nested Q-AAGH and Q-AAJGH.  Group-by encodings, join
layouts and bucketizations are catalog state; per-row aggregation runs on
the tables' device through ``repro_torch.kernels.ops.segment_aggregate``
(the CUDA kernel on the card, its plain version on the CPU).  The inner
FROM/WHERE/GROUP BY/agg block is evaluated once per query and shared between
the result and the provenance (``execute_and_provenance``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.catalog import Catalog, default_catalog
from repro_torch.core.table import PAD_VALID, ColumnTable, Database, unique_rows
from repro_torch.device import to_host
from repro_torch.runtime.guards import hot_path

_OPS = {
    ">": lambda x, v: x > v,
    ">=": lambda x, v: x >= v,
    "<": lambda x, v: x < v,
    "<=": lambda x, v: x <= v,
    "=": lambda x, v: x == v,
}


@dataclasses.dataclass(frozen=True)
class Predicate:
    """Row-level WHERE predicate ``attr op value``."""

    attr: str
    op: str
    value: float

    def mask(self, table: ColumnTable) -> torch.Tensor:
        return _OPS[self.op](table[self.attr], self.value)


@dataclasses.dataclass(frozen=True)
class Having:
    op: str
    value: float

    def mask(self, agg_values):
        return _OPS[self.op](agg_values, self.value)


@dataclasses.dataclass(frozen=True)
class Aggregate:
    fn: str  # 'sum' | 'avg' | 'count'
    attr: Optional[str] = None  # None for count(*)


@dataclasses.dataclass(frozen=True)
class JoinSpec:
    """Equi-join ``fact.left_key = right.right_key`` (right key unique)."""

    right: str
    left_key: str
    right_key: str


@dataclasses.dataclass(frozen=True)
class Query:
    table: str
    groupby: Tuple[str, ...]
    agg: Aggregate
    where: Optional[Predicate] = None
    having: Optional[Having] = None
    join: Optional[JoinSpec] = None
    # Nested templates (Q-AAGH / Q-AAJGH): outer block over the inner result.
    outer_groupby: Optional[Tuple[str, ...]] = None
    outer_agg: Optional[Aggregate] = None
    outer_having: Optional[Having] = None

    @property
    def template(self) -> str:
        nested = self.outer_groupby is not None
        joined = self.join is not None
        if nested and joined:
            return "Q-AAJGH"
        if nested:
            return "Q-AAGH"
        if joined:
            return "Q-AJGH"
        return "Q-AGH"

    @property
    def relevant_attrs(self) -> Tuple[str, ...]:
        """Attributes the query 'touches' (for RAND-REL-ALL / CB-OPT-REL)."""
        attrs = list(self.groupby)
        if self.agg.attr:
            attrs.append(self.agg.attr)
        if self.where is not None:
            attrs.append(self.where.attr)
        if self.join is not None:
            attrs.append(self.join.left_key)
        if self.outer_groupby:
            attrs.extend(self.outer_groupby)
        seen, out = set(), []
        for a in attrs:
            if a not in seen:
                seen.add(a)
                out.append(a)
        return tuple(out)

    def groupby_on_fact(self, db: "Database") -> Tuple[str, ...]:
        """Group-by attributes that live on the sketched (fact) relation."""
        fact = db[self.table]
        return tuple(a for a in self.groupby if fact.has(a))

    def inner_signature(self) -> Tuple:
        """Hashable identity of the inner block (FROM/WHERE/GROUP BY/agg)."""
        return (
            self.table,
            self.groupby,
            (self.agg.fn, self.agg.attr),
            dataclasses.astuple(self.where) if self.where else None,
            dataclasses.astuple(self.join) if self.join else None,
        )

    def signature(self) -> Tuple:
        """Hashable identity used by the sketch index."""
        return (
            self.table,
            self.groupby,
            (self.agg.fn, self.agg.attr),
            dataclasses.astuple(self.where) if self.where else None,
            dataclasses.astuple(self.having) if self.having else None,
            dataclasses.astuple(self.join) if self.join else None,
            self.outer_groupby,
            (self.outer_agg.fn, self.outer_agg.attr) if self.outer_agg else None,
            dataclasses.astuple(self.outer_having) if self.outer_having else None,
        )


@dataclasses.dataclass(frozen=True)
class QueryResult:
    group_values: Dict[str, np.ndarray]  # per surviving group
    values: np.ndarray  # aggregate per surviving group

    def canonical(self) -> Tuple[Tuple, ...]:
        """Order-independent representation for result-equality tests."""
        attrs = sorted(self.group_values)
        rows = []
        for i in range(len(self.values)):
            rows.append(
                tuple(float(self.group_values[a][i]) for a in attrs)
                + (round(float(self.values[i]), 6),)
            )
        return tuple(sorted(rows))


# ---------------------------------------------------------------------------
# Aggregation primitives
# ---------------------------------------------------------------------------


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


def _pad(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.cat([x, x.new_zeros(n - x.shape[0])])


def segment_sums_counts(
    values: torch.Tensor, gid: torch.Tensor, n_groups: int,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-group sums, per-group counts) via the segment-aggregate kernel.

    Row and group dimensions are padded to powers of two (padded rows carry
    weight 0 into group 0), as in the reference, so the kernel sees a few
    size classes.
    """
    from repro_torch.kernels import ops as kops

    n = int(values.shape[0])
    n_pad = _next_pow2(max(n, 1))
    g_pad = _next_pow2(max(n_groups, 1))
    values = values.to(torch.float32)
    w = (torch.ones(n, dtype=torch.float32, device=values.device) if weights is None
         else weights.to(torch.float32))
    gid = gid.to(torch.int32)
    if n_pad != n:
        values, gid, w = _pad(values, n_pad), _pad(gid, n_pad), _pad(w, n_pad)
    sums, counts = kops.segment_aggregate(values, gid, g_pad, w)
    return sums[:n_groups], counts[:n_groups]


def _finalize_aggregate(fn: str, sums: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    if fn == "count":
        return counts
    if fn == "sum":
        return sums
    if fn == "avg":
        return sums / torch.clamp_min(counts, 1.0)
    raise ValueError(f"unknown aggregate {fn!r}")


@hot_path
def segment_aggregate(
    values: torch.Tensor, gid: torch.Tensor, n_groups: int, fn: str,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-group aggregate; ``weights`` is the row inclusion mask (WHERE)."""
    sums, counts = segment_sums_counts(values, gid, n_groups, weights)
    return _finalize_aggregate(fn, sums, counts)


# ---------------------------------------------------------------------------
# Join materialization (right key unique, e.g. orders.orderkey)
# ---------------------------------------------------------------------------


def materialize_join(
    db: Database, q: Query, catalog: Optional[Catalog] = None
) -> Tuple[ColumnTable, np.ndarray]:
    """The joined flat table and, per joined row, its fact-table row; built
    once per (fact, right, keys) in the catalog."""
    catalog = catalog or default_catalog()
    return catalog.join(db[q.table], db[q.join.right], q.join.left_key, q.join.right_key)


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class InnerBlock:
    """Products of the FROM/WHERE/GROUP BY/agg inner block, computed once.

    ``fact_idx`` maps flat rows back to fact-table rows (``None`` means the
    identity: no join).  ``present[g]`` is True iff group ``g`` has at least
    one row passing WHERE.
    """

    flat: ColumnTable
    fact_idx: Optional[np.ndarray]
    gid: np.ndarray
    n_groups: int
    group_values: Dict[str, np.ndarray]
    agg_np: np.ndarray
    present: np.ndarray
    where_np: np.ndarray


def inner_block_arrays(q: Query, flat: ColumnTable, catalog: Catalog):
    """The per-row inputs of the inner block's aggregation:
    ``(enc, where_mask, vals)`` (WHERE ∧ pad-validity, group encoding,
    aggregate values)."""
    where_mask = (
        catalog.where_mask(flat, q.where)
        if q.where is not None
        else torch.ones(flat.num_rows, dtype=torch.bool, device=flat.device)
    )
    if flat.has(PAD_VALID):
        # Pow2-padded sketch instance: the tail rows must contribute nothing.
        where_mask = where_mask & flat[PAD_VALID]
    enc = catalog.groups(flat, q.groupby)
    if q.agg.fn == "count":
        vals = torch.ones(flat.num_rows, dtype=torch.float32, device=flat.device)
    else:
        vals = flat[q.agg.attr]
    return enc, where_mask, vals


def inner_group_partials(q: Query, flat: ColumnTable, catalog: Catalog):
    """WHERE mask, group encoding and per-group sums/counts over one flat
    table: ``(enc, where_mask, sums, counts)``.  A fragment shard's partial
    aggregate is this over its sketch instance."""
    enc, where_mask, vals = inner_block_arrays(q, flat, catalog)
    sums, counts = segment_sums_counts(vals, enc.gid_dev, enc.n_groups, weights=where_mask)
    return enc, where_mask, sums, counts


def _inner_block(db: Database, q: Query, catalog: Optional[Catalog] = None) -> InnerBlock:
    """Evaluate the inner block once; one fused segment pass yields both the
    aggregate values and group presence."""
    catalog = catalog or default_catalog()
    if q.join is not None:
        flat, fact_idx = materialize_join(db, q, catalog)
    else:
        flat, fact_idx = db[q.table], None
    enc, where_mask, sums, counts = inner_group_partials(q, flat, catalog)
    agg = _finalize_aggregate(q.agg.fn, sums, counts)
    return InnerBlock(
        flat=flat,
        fact_idx=fact_idx,
        gid=enc.gid,
        n_groups=enc.n_groups,
        group_values=enc.group_values,
        agg_np=to_host(agg),
        # Groups whose every row fails the WHERE do not appear in the result.
        present=to_host(counts) > 0,
        where_np=to_host(where_mask),
    )


def _outer_values(q: Query, inner_vals: np.ndarray, ogid: np.ndarray, n_outer: int,
                  device: torch.device) -> np.ndarray:
    """The nested templates' outer aggregate over the surviving inner groups,
    on the tables' device; returns to the host for the outer HAVING."""
    out = segment_aggregate(
        torch.from_numpy(np.ascontiguousarray(inner_vals)).to(device),
        torch.from_numpy(ogid.reshape(-1).astype(np.int32)).to(device),
        n_outer,
        q.outer_agg.fn if q.outer_agg else "sum",
    )
    return to_host(out)


def result_from_group_state(
    q: Query,
    group_values: Dict[str, np.ndarray],
    agg_np: np.ndarray,
    present: np.ndarray,
    device: torch.device,
) -> QueryResult:
    """Finish a query from per-group state alone (HAVING chain + outer
    block)."""
    if q.outer_groupby is None:
        keep = present.copy()
        if q.having is not None:
            keep &= np.asarray(q.having.mask(agg_np))
        idx = np.nonzero(keep)[0]
        return QueryResult(
            group_values={a: v[idx] for a, v in group_values.items()},
            values=agg_np[idx],
        )

    # Nested templates: inner HAVING filters inner groups, then the outer
    # block aggregates result1 over outer_groupby (subset of inner groupby).
    inner_keep = present.copy()
    if q.having is not None:
        inner_keep &= np.asarray(q.having.mask(agg_np))
    inner_idx = np.nonzero(inner_keep)[0]
    inner_vals = agg_np[inner_idx]
    inner_gv = {a: v[inner_idx] for a, v in group_values.items()}

    stacked = np.stack([inner_gv[a] for a in q.outer_groupby], axis=1)
    if stacked.shape[0] == 0:
        return QueryResult(group_values={a: np.empty(0) for a in q.outer_groupby},
                           values=np.empty(0))
    uniq, ogid = unique_rows(stacked)
    n_outer = uniq.shape[0]
    outer_np = _outer_values(q, inner_vals, ogid, n_outer, device)
    keep = np.ones(n_outer, dtype=bool)
    if q.outer_having is not None:
        keep &= np.asarray(q.outer_having.mask(outer_np))
    idx = np.nonzero(keep)[0]
    return QueryResult(
        group_values={a: uniq[:, i][idx] for i, a in enumerate(q.outer_groupby)},
        values=outer_np[idx],
    )


def _result_from_inner(q: Query, ib: InnerBlock) -> QueryResult:
    return result_from_group_state(q, ib.group_values, ib.agg_np, ib.present,
                                   ib.flat.device)


def provenance_group_keep(
    q: Query,
    agg_np: np.ndarray,
    group_values: Dict[str, np.ndarray],
    n_groups: int,
    device: torch.device,
) -> np.ndarray:
    """Which (inner) groups survive the HAVING chain, per-group state only."""
    inner_keep = np.ones(n_groups, dtype=bool)
    if q.having is not None:
        inner_keep &= np.asarray(q.having.mask(agg_np))

    if q.outer_groupby is not None:
        inner_idx = np.nonzero(inner_keep)[0]
        if inner_idx.shape[0]:
            stacked = np.stack(
                [group_values[a][inner_idx] for a in q.outer_groupby], axis=1
            )
            uniq, ogid = unique_rows(stacked)
            outer_vals = _outer_values(q, agg_np[inner_idx], ogid, uniq.shape[0], device)
            outer_keep = np.ones(uniq.shape[0], dtype=bool)
            if q.outer_having is not None:
                outer_keep &= np.asarray(q.outer_having.mask(outer_vals))
            surviving_inner = np.zeros(n_groups, dtype=bool)
            surviving_inner[inner_idx] = outer_keep[ogid]
            inner_keep = surviving_inner
        else:
            inner_keep = np.zeros(n_groups, dtype=bool)
    return inner_keep


def _provenance_from_inner(q: Query, ib: InnerBlock, n_fact_rows: int) -> np.ndarray:
    """The provenance over the fact table's ``n_fact_rows`` rows: a joined
    block's kept rows scattered back to their fact rows, so a fact row with
    no partner is never in it."""
    inner_keep = provenance_group_keep(q, ib.agg_np, ib.group_values, ib.n_groups,
                                       ib.flat.device)
    row_keep = inner_keep[ib.gid] & ib.where_np
    if ib.fact_idx is None:
        return row_keep
    mask = np.zeros(n_fact_rows, dtype=bool)
    mask[ib.fact_idx[row_keep]] = True
    return mask


# Public names for the inner-block products: batched admission
# (``repro_torch.core.admission``) evaluates the shared FROM/WHERE/GROUP
# BY/agg block once per signature group and derives every member's result
# and provenance from the same ``InnerBlock``; the group-level tails are pure
# functions of it, so sharing is bit-exact.
inner_block = _inner_block
result_from_inner = _result_from_inner
provenance_from_inner = _provenance_from_inner


@hot_path
def execute(q: Query, db: Database, catalog: Optional[Catalog] = None) -> QueryResult:
    return _result_from_inner(q, _inner_block(db, q, catalog))


def provenance_mask(q: Query, db: Database, catalog: Optional[Catalog] = None) -> np.ndarray:
    """Lineage P(Q, D) as a boolean mask over the fact table's rows: a row is
    in it iff it satisfies WHERE, joins (for the join templates) and its
    group survives the HAVING chain."""
    return _provenance_from_inner(q, _inner_block(db, q, catalog), db[q.table].num_rows)


@hot_path
def execute_and_provenance(
    q: Query, db: Database, catalog: Optional[Catalog] = None
) -> Tuple[QueryResult, np.ndarray]:
    """Fused capture+execute path: one inner-block evaluation yields both the
    query result and the provenance mask."""
    ib = _inner_block(db, q, catalog)
    return _result_from_inner(q, ib), _provenance_from_inner(q, ib, db[q.table].num_rows)
