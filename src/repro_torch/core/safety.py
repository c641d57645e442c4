"""Attribute safety (Def. 5) — the static pre-filter for sketch candidates
(port of ``repro/core/safety.py``).

Following [32] we use a sufficient condition.  For the supported templates a
range partition on attribute ``a`` is safe when either:

  1. ``a`` is a group-by attribute of the (inner) block: every group lies
     entirely inside one fragment, so groups present in the sketch instance
     are *complete* and aggregate exactly as over D; or
  2. the HAVING chain is *upward monotone* (>, >= thresholds) and the
     aggregate is monotone under row removal (COUNT, or SUM over non-negative
     values): partially-present non-provenance groups can only shrink, so
     they cannot spuriously pass the HAVING filter.

Additionally (Sec. 9) candidates whose distinct-value count is below the
number of ranges are pre-filtered: such partitions degenerate (several ranges
map to one value) and [32]'s safety argument needs value-aligned bounds.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

from repro_torch.core.catalog import Catalog, default_catalog
from repro_torch.core.queries import Query
from repro_torch.core.table import Database


def _having_upward_monotone(q: Query) -> bool:
    ops_ok = {">", ">="}
    if q.having is not None and q.having.op not in ops_ok:
        return False
    if q.outer_having is not None and q.outer_having.op not in ops_ok:
        return False
    return True


def _agg_monotone(q: Query, db: Database, catalog: Catalog) -> bool:
    aggs = [q.agg] + ([q.outer_agg] if q.outer_agg else [])
    for agg in aggs:
        if agg.fn == "count":
            continue
        if agg.fn == "avg":
            return False  # partial AVG can move either way
        if agg.fn == "sum":
            if not db[q.table].has(agg.attr):
                return False
            if not catalog.column_nonnegative(db[q.table], agg.attr):
                return False
    return True


def safe_attributes(
    q: Query, db: Database, catalog: Optional[Catalog] = None
) -> Tuple[str, ...]:
    """SAFE(Q) restricted to the sketched (fact) relation's schema."""
    catalog = catalog or default_catalog()
    fact = db[q.table]
    gb_on_fact = tuple(a for a in q.groupby if fact.has(a))
    if _having_upward_monotone(q) and _agg_monotone(q, db, catalog):
        return tuple(sorted(fact.schema))
    return gb_on_fact


def prefilter_candidates(
    q: Query,
    db: Database,
    candidates: Tuple[str, ...],
    n_ranges: int,
    catalog: Optional[Catalog] = None,
) -> Tuple[str, ...]:
    """Drop candidates with fewer distinct values than ranges (Sec. 9).

    Group-by attributes are exempt: they are safe by the whole-group argument
    no matter how coarse the (deduplicated) partition ends up, and the paper's
    own experiments sketch low-cardinality GB attributes (e.g. ``district``).
    Distinct counts are catalog-cached, so the pre-filter scans each column
    once per table lifetime rather than once per query.
    """
    catalog = catalog or default_catalog()
    fact = db[q.table]
    out = []
    for a in candidates:
        if not fact.has(a):
            continue
        if a in q.groupby or catalog.distinct_count(fact, a) >= n_ranges:
            out.append(a)
    return tuple(out)


def stats_prefilter(
    q: Query,
    db: Database,
    candidates: Tuple[str, ...],
    ranges_for: Callable[[str], "object"],
    catalog: Optional[Catalog] = None,
) -> Tuple[str, ...]:
    """Summary-statistics dominance prune (PS3-style), before any sampling.

    For a fixed number of satisfied groups, a candidate's sketch covers the
    fragments those groups land in — so its size is bounded by (#covered
    fragments) x (fragment sizes).  A partition with *more* nonempty
    fragments whose largest and smallest nonempty fragments are both
    *smaller* (as fractions of the table) bounds every query's sketch no
    larger than a coarser partition does: the same group set touches at most
    as many rows.  Candidate ``a`` is pruned when some ``b`` dominates it on
    ``(n_nonempty >=, max_frac <=, min_frac <=)`` with at least one strict
    inequality — a product partial order, so maximal candidates always
    survive and the pool never empties.  Equi-depth partitions of two
    high-cardinality attributes tie on all three statistics and both survive
    (the AQR estimate pass ranks them); the prune bites on low-cardinality
    attributes whose deduplicated bounds collapse to few, fat fragments.

    All statistics come from catalog-cached fragment counts
    (``Catalog.frag_stats``): no sampling, no estimate launch.  Gated behind
    ``SelectionConfig.stats_prefilter`` — paper-faithful CB-OPT runs disable
    it and estimate every safe candidate.
    """
    if len(candidates) <= 1:
        return candidates
    catalog = catalog or default_catalog()
    fact = db[q.table]
    stats = {a: catalog.frag_stats(fact, ranges_for(a)) for a in candidates}

    def dominates(b: str, a: str) -> bool:
        nb, xb, mb = stats[b]
        na, xa, ma = stats[a]
        return (nb >= na and xb <= xa and mb <= ma
                and (nb > na or xb < xa or mb < ma))

    out = tuple(a for a in candidates
                if not any(b != a and dominates(b, a) for b in candidates))
    return out or candidates
