"""Synthetic query workloads (Sec. 11.1); port of ``repro/core/workload.py``.

Random instantiations of the Q-AGH / Q-AJGH / Q-AAJGH templates over the
four datasets, with HAVING thresholds drawn from the actual group-aggregate quantiles so workloads mix
selective and broad queries (like the paper's 1000-query batches).

Also home of the engine's :class:`WorkloadLog` — the bounded window of
recently *missed* queries that reuse-aware selection scores candidate
sketches against (subsumption reach ~ expected future index hits)."""
from __future__ import annotations

import collections
import dataclasses
from typing import List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.index import subsumes
from repro_torch.core.queries import Aggregate, Having, JoinSpec, Query, execute
from repro_torch.core.table import Database


class WorkloadLog:
    """Bounded log of recent sketch-index *misses*, stamped in arrival order.

    The reuse-aware cost model asks: had we captured a sketch for ``q``, how
    many queries in the recent window would it have served?  ``reach(q)``
    answers with the number of logged queries ``p`` that ``q`` subsumes — the
    same predicate the index uses to serve hits — so the worth-it rule can
    trade estimated coverage against expected future hits.

    Stamps make batched admission order-exact: ``run_batch`` admits whole
    waves and defers subsumed members to later waves, so entries can be
    *inserted* out of batch-position order.  Each entry carries the stamp of
    its batch position and ``reach(q, stamp)`` counts only entries at or
    before ``stamp``, which is what a sequential replay would have seen.
    Hits never enter the log: a served query needs no new sketch.
    """

    def __init__(self, window: int = 256):
        self.window = window
        self._log: collections.deque = collections.deque(maxlen=max(1, window))
        self._clock = 0
        self._batch_base: Optional[int] = None

    def __len__(self) -> int:
        return len(self._log)

    @property
    def clock(self) -> int:
        return self._clock

    def begin_batch(self, n: int) -> None:
        """Reserve stamp slots for an ``n``-query batch: position ``i`` gets
        stamp ``base + i + 1`` no matter which admission wave records it."""
        self._batch_base = self._clock
        self._clock += n

    def batch_stamp(self, pos: int) -> Optional[int]:
        """The reserved stamp of batch position ``pos`` (None outside a batch)."""
        if self._batch_base is None:
            return None
        return self._batch_base + pos + 1

    def record(self, q: Query, stamp: Optional[int] = None) -> int:
        """Log one miss; returns its stamp (auto-incremented when not given)."""
        if stamp is None:
            self._clock += 1
            stamp = self._clock
        self._log.append((stamp, q))
        return stamp

    def reach(self, q: Query, stamp: Optional[int] = None) -> int:
        """#logged queries at-or-before ``stamp`` that a sketch for ``q``
        would serve (``subsumes(q, p)``); the whole window when no stamp."""
        if stamp is None:
            stamp = self._clock
        return sum(1 for s, p in self._log if s <= stamp and subsumes(q, p))

    def entries(self) -> List[Tuple[int, Query]]:
        return list(self._log)

    def snapshot(self) -> dict:
        """Picklable state (queries are frozen value dataclasses): the
        coordinator checkpoints this so a restart keeps the reuse-aware
        cost model's miss window instead of reverting to reuse-blind
        declines."""
        return {"window": self.window, "clock": self._clock,
                "entries": list(self._log)}

    @classmethod
    def from_snapshot(cls, snap: Mapping) -> "WorkloadLog":
        log = cls(snap["window"])
        for stamp, q in snap["entries"]:
            log._log.append((stamp, q))
        log._clock = snap["clock"]
        return log


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    table: str
    gb_pool: Tuple[str, ...]  # attributes eligible for GROUP BY
    agg_pool: Tuple[str, ...]  # attributes eligible for aggregation
    join: Optional[JoinSpec] = None
    n_gb: Tuple[int, ...] = (1, 2, 3)
    agg_fns: Tuple[str, ...] = ("sum", "avg", "count")
    # HAVING threshold quantile range over the group aggregates
    q_range: Tuple[float, float] = (0.5, 0.95)


CRIMES_SPEC = WorkloadSpec(
    table="crimes",
    gb_pool=("district", "month", "year", "pid", "ward", "community"),
    agg_pool=("records",),
)

TPCH_SPEC = WorkloadSpec(
    table="lineitem",
    gb_pool=("l_suppkey", "l_shipdate", "l_partkey"),
    agg_pool=("l_extendedprice", "l_quantity"),
)

TPCH_JOIN_SPEC = WorkloadSpec(
    table="lineitem",
    gb_pool=("l_suppkey", "l_shipdate"),
    agg_pool=("l_extendedprice", "l_quantity"),
    join=JoinSpec("orders", "l_orderkey", "o_orderkey"),
)

PARKING_SPEC = WorkloadSpec(
    table="parking",
    gb_pool=("borough", "precinct", "agency", "year", "month", "hour"),
    agg_pool=("fine", "violation"),
)

STARS_SPEC = WorkloadSpec(
    table="stars",
    gb_pool=("field", "run"),
    agg_pool=("mag_g", "mag_r", "redshift"),
)


def generate_workload(
    spec: WorkloadSpec, db: Database, n_queries: int, seed: int = 0
) -> List[Query]:
    """Random template instantiations with data-calibrated thresholds."""
    rng = np.random.default_rng(seed)
    out: List[Query] = []
    attempts = 0
    while len(out) < n_queries and attempts < n_queries * 10:
        attempts += 1
        k = int(rng.choice(spec.n_gb))
        gb = tuple(sorted(rng.choice(spec.gb_pool, size=min(k, len(spec.gb_pool)), replace=False)))
        fn = str(rng.choice(spec.agg_fns))
        agg_attr = None if fn == "count" else str(rng.choice(spec.agg_pool))
        q0 = Query(
            table=spec.table,
            groupby=gb,
            agg=Aggregate(fn, agg_attr),
            join=spec.join,
        )
        # Calibrate the threshold on the actual group aggregates.
        res = execute(q0, db)
        if len(res.values) < 4:
            continue
        qlo, qhi = spec.q_range
        tau = float(np.quantile(res.values, rng.uniform(qlo, qhi)))
        out.append(dataclasses.replace(q0, having=Having(">", tau)))
    return out
