"""Sketch index: storage + reuse test (Fig. 3's first stage); port of ``repro/core/index.py``.

Reuse rule (the [32] compatibility test, specialized to our templates): a
sketch captured for Q1 answers Q2 when both share the FROM/GROUP BY/aggregate
structure and Q2's provenance is a subset of Q1's — which for upward-monotone
HAVING chains means Q2's thresholds dominate Q1's (tau_2 >= tau_1) and the
WHERE predicates match.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.queries import Query
from repro_torch.core.sketch import ProvenanceSketch


def _pred_key(q: Query) -> Tuple:
    return (
        q.table,
        q.groupby,
        (q.agg.fn, q.agg.attr),
        dataclasses.astuple(q.where) if q.where else None,
        dataclasses.astuple(q.join) if q.join else None,
        q.outer_groupby,
        (q.outer_agg.fn, q.outer_agg.attr) if q.outer_agg else None,
    )


def _thresholds(q: Query) -> Tuple[Optional[float], Optional[float]]:
    t1 = q.having.value if q.having else None
    t2 = q.outer_having.value if q.outer_having else None
    return t1, t2


def subsumes(q1: Query, q2: Query) -> bool:
    """True iff a sketch captured for q1 is guaranteed safe for q2."""
    if _pred_key(q1) != _pred_key(q2):
        return False
    ops_ok = {">", ">="}
    for h1, h2 in zip((q1.having, q1.outer_having), (q2.having, q2.outer_having)):
        if (h1 is None) != (h2 is None):
            return False
        if h1 is None:
            continue
        if h1.op not in ops_ok or h2.op not in ops_ok:
            return dataclasses.astuple(h1) == dataclasses.astuple(h2)
        if h2.value < h1.value:  # q2 asks for *more* provenance than q1 saw
            return False
        # Equal thresholds with mixed ops: `agg >= tau` admits the boundary
        # groups (agg == tau) that `agg > tau` excluded, so a `>`-captured
        # sketch lacks their provenance — q2 must strictly dominate.
        if h2.value == h1.value and h1.op == ">" and h2.op == ">=":
            return False
    return True


@dataclasses.dataclass
class IndexEntry:
    query: Query
    sketch: ProvenanceSketch
    uses: int = 0
    last_hit: int = 0  # index clock at insert/last lookup hit (prune recency)
    # Incremental-maintenance state for this sketch; always None until the
    # maintenance slice ports ``SketchMaintainer``.  Opaque to the index.
    maintainer: Optional[object] = None


class SketchIndex:
    """In-memory sketch store with subsumption-based retrieval.

    Eviction (``prune``/``remove``) and the serving layer's registration ids
    come with the sharded and replicated slices of the port.
    """

    def __init__(self):
        self._entries: Dict[Tuple, List[IndexEntry]] = {}
        self.hits = 0
        self.misses = 0
        self._clock = 0

    def lookup_entry(self, q: Query) -> Optional[IndexEntry]:
        """The smallest stored sketch whose query subsumes ``q``, as an entry
        (the engine needs the entry to repair/replace the sketch in place).

        ``size_rows`` ties break by (threshold tightness, recency) — NOT by
        insertion order.  Batched admission can insert a wave's sketches in a
        different order than a sequential replay (deferral reorders waves),
        so insertion-position ties would let batched and sequential probes
        serve the same query from *different* entries, diverging ``uses`` /
        ``last_hit`` bookkeeping and hence prune decisions.  Tighter
        thresholds mean less provenance beyond what ``q`` needs (and a
        tighter future-reuse test), higher ``last_hit`` means the entry is
        hot; both are insertion-order-independent, so equal-size probes pick
        identically however the entries got there."""
        best: Optional[IndexEntry] = None
        best_rank: Optional[Tuple] = None
        neg_inf = float("-inf")
        for pos, e in enumerate(self._entries.get(_pred_key(q), [])):
            if subsumes(e.query, q):
                t1, t2 = _thresholds(e.query)
                rank = (e.sketch.size_rows,
                        -(t1 if t1 is not None else neg_inf),
                        -(t2 if t2 is not None else neg_inf),
                        -e.last_hit, pos)
                if best_rank is None or rank < best_rank:
                    best, best_rank = e, rank
        if best is None:
            self.misses += 1
            return None
        best.uses += 1
        self._clock += 1
        best.last_hit = self._clock
        self.hits += 1
        return best

    def insert(self, q: Query, sketch: ProvenanceSketch,
               maintainer: Optional[object] = None) -> IndexEntry:
        self._clock += 1
        e = IndexEntry(q, sketch, last_hit=self._clock, maintainer=maintainer)
        self._entries.setdefault(_pred_key(q), []).append(e)
        return e

    def entries(self) -> List[IndexEntry]:
        return [e for v in self._entries.values() for e in v]

    def __len__(self) -> int:
        return sum(len(v) for v in self._entries.values())
