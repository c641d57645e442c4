"""PBDSEngine — the Fig. 3 workflow as one online component (port of
``repro/core/engine.py``, single-table ``run``).

For each incoming query:
  1. probe the sketch index; on a hit, run the query over the catalog-cached
     sketch instance (the rows of the sketch's fragments, pow2-padded);
  2. otherwise run the configured selection strategy (samples, AQR passes
     and whole selection results are cached), capture an accurate sketch on
     the chosen attribute through the fused capture+execute path, store it,
     warm its instance and return the shared result;
  3. when no candidate is worth it, fall back to NO-PS execution.

The engine runs on its tables' device.  Not in this slice: incremental
maintenance (index entries carry ``maintainer=None``; on a static table a
sketch never goes stale), mutations, ``run_batch`` and fragment-major
re-clustering.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.aqp.sampling import AQRCache, SampleCache
from repro_torch.aqp.size_estimation import EstimationConfig
from repro_torch.core.catalog import Catalog
from repro_torch.core.index import IndexEntry, SketchIndex
from repro_torch.core.queries import Query, QueryResult, execute, execute_and_provenance
from repro_torch.core.ranges import RangeSet, equi_depth_ranges
from repro_torch.core.sketch import ProvenanceSketch, apply_sketch, capture_sketch, execute_with_sketch
from repro_torch.core.strategies import (
    SelectionCache,
    SelectionConfig,
    SelectionResult,
    select_attribute,
)
from repro_torch.core.table import Database
from repro_torch.core.workload import WorkloadLog
from repro_torch.runtime.guards import hot_path
from repro_torch.runtime.stable_hash import stable_hash32

MAINTENANCE_SLICE = "table mutations come with the maintenance slice of the port"


@dataclasses.dataclass
class RunInfo:
    reused: bool
    created: bool
    attr: Optional[str]
    strategy: str
    selectivity: Optional[float]
    t_select: float = 0.0
    t_capture: float = 0.0
    t_execute: float = 0.0
    t_probe: float = 0.0

    @property
    def t_total(self) -> float:
        return self.t_probe + self.t_select + self.t_capture + self.t_execute


class PBDSEngine:
    def __init__(
        self,
        db: Database,
        strategy: str = "CB-OPT-GB",
        n_ranges: int = 100,
        theta: float = 0.05,
        cfg: EstimationConfig = EstimationConfig(),
        seed: int = 0,
        min_selectivity_gain: float = 0.9,
        selection: Optional[SelectionConfig] = None,
    ):
        self.db = db
        self.device: torch.device = db.device
        self.strategy = strategy
        self.n_ranges = n_ranges
        self.theta = theta
        self.cfg = cfg
        self.index = SketchIndex()
        self.samples = SampleCache()
        self.aqr = AQRCache()
        self.catalog = Catalog()
        self.selection = SelectionConfig() if selection is None else selection
        self.selection_cache = SelectionCache()
        self.workload = WorkloadLog(self.selection.reuse_window)
        self._base_key = prng.PRNGKey(seed)
        self._ranges_cache: Dict[Tuple[str, str], RangeSet] = {}
        # Sketches estimated to cover >= this fraction of the table are not
        # worth creating (problem definition (i) in Sec. 4.5).
        self.min_selectivity_gain = min_selectivity_gain

    def selection_state(self) -> dict:
        """Picklable snapshot of the reuse-aware selection state: the
        ``WorkloadLog`` miss window plus the ``SelectionCache`` counters."""
        return {
            "workload": self.workload.snapshot(),
            "selection_cache": {"hits": self.selection_cache.hits,
                                "misses": self.selection_cache.misses},
        }

    def restore_selection_state(self, state: Mapping) -> None:
        """Inverse of ``selection_state``."""
        self.workload = WorkloadLog.from_snapshot(state["workload"])
        sc = state.get("selection_cache")
        if sc is not None:
            self.selection_cache.hits = int(sc["hits"])
            self.selection_cache.misses = int(sc["misses"])

    def _select_key(self, q: Query) -> torch.Tensor:
        """Per-query selection randomness, derived from query *content*
        (the signature's process-stable hash folded into the seed key), so
        the draws do not depend on arrival order or the process."""
        return prng.fold_in(self._base_key, stable_hash32(q.signature()))

    def ranges_for(self, table: str, attr: str) -> RangeSet:
        ck = (table, attr)
        if ck not in self._ranges_cache:
            self._ranges_cache[ck] = equi_depth_ranges(self.db[table], attr, self.n_ranges)
        return self._ranges_cache[ck]

    # -- mutations (maintenance slice) ----------------------------------------
    def append_rows(self, table_name: str, rows: Mapping[str, np.ndarray]) -> None:
        raise NotImplementedError(MAINTENANCE_SLICE)

    def delete_rows(self, table_name: str, mask: np.ndarray) -> None:
        raise NotImplementedError(MAINTENANCE_SLICE)

    def _bound_history(self, table_name: str) -> None:
        raise NotImplementedError(MAINTENANCE_SLICE)

    def _maybe_compact(self, table_name: str) -> None:
        raise NotImplementedError(MAINTENANCE_SLICE)

    def _current_sketch(self, entry: IndexEntry) -> ProvenanceSketch:
        """The entry's sketch; tables never change in this slice, so a stale
        sketch means a mutation slipped past the engine."""
        if not entry.sketch.current_for(self.db[entry.query.table]):
            raise NotImplementedError(MAINTENANCE_SLICE)
        return entry.sketch

    @hot_path
    def _serve_hit(
        self, q: Query, entry: IndexEntry, t_probe: float
    ) -> Tuple[QueryResult, RunInfo]:
        """Serve one index hit over the sketch instance."""
        tp = time.perf_counter()
        sketch = self._current_sketch(entry)
        res = execute_with_sketch(q, self.db, sketch, catalog=self.catalog)
        return res, RunInfo(
            reused=True, created=False, attr=sketch.attr, strategy=self.strategy,
            selectivity=sketch.selectivity, t_probe=t_probe,
            t_execute=time.perf_counter() - tp,
        )

    def _worth_it(self, sel: SelectionResult, q: Query,
                  stamp: Optional[int]) -> bool:
        """The admission rule (problem definition (i), Sec. 4.5): create
        unless the estimate covers >= ``min_selectivity_gain`` of the table,
        after discounting ``reuse_weight`` per recent query the sketch would
        serve (reuse-aware mode)."""
        if sel.attr is None:
            return False
        est = sel.estimates.get(sel.attr) if sel.estimates else None
        if est is None:
            return True
        gain = est.est_selectivity
        if stamp is not None:
            gain -= self.selection.reuse_weight * self.workload.reach(q, stamp)
        return gain < self.min_selectivity_gain

    @hot_path
    def run(self, q: Query) -> Tuple[QueryResult, RunInfo]:
        t0 = time.perf_counter()
        entry = self.index.lookup_entry(q) if self.strategy != "NO-PS" else None
        tp = time.perf_counter()
        if entry is not None:
            return self._serve_hit(q, entry, tp - t0)

        if self.strategy == "NO-PS":
            res = execute(q, self.db, catalog=self.catalog)
            return res, RunInfo(False, False, None, "NO-PS", None,
                                t_execute=time.perf_counter() - tp, t_probe=tp - t0)

        stamp = self.workload.record(q) if self.selection.reuse_aware else None
        sel = select_attribute(
            self.strategy, self._select_key(q), q, self.db, self.n_ranges,
            sample_cache=self.samples, theta=self.theta, cfg=self.cfg,
            ranges_for=lambda a: self.ranges_for(q.table, a),
            catalog=self.catalog, aqr_cache=self.aqr,
            selection=self.selection, selection_cache=self.selection_cache,
        )
        t1 = time.perf_counter()

        if not self._worth_it(sel, q, stamp):
            res = execute(q, self.db, catalog=self.catalog)
            t2 = time.perf_counter()
            return res, RunInfo(False, False, None, self.strategy, None,
                                t_probe=tp - t0, t_select=t1 - tp, t_execute=t2 - t1)

        ranges = self.ranges_for(q.table, sel.attr)
        tc = time.perf_counter()
        # Fused path: one inner-block evaluation yields the result AND the
        # provenance the sketch is captured from.
        res, prov = execute_and_provenance(q, self.db, catalog=self.catalog)
        t2 = time.perf_counter()
        sketch = capture_sketch(q, self.db, ranges, prov=prov, catalog=self.catalog)
        self.index.insert(q, sketch)
        # Warm the reuse path while capture is being paid for: materialize the
        # sketch instance and run the query over it once, so its catalog
        # entries exist before the first index hit.
        execute(q, apply_sketch(sketch, self.db, catalog=self.catalog), catalog=self.catalog)
        t3 = time.perf_counter()
        return res, RunInfo(
            reused=False, created=True, attr=sel.attr, strategy=self.strategy,
            selectivity=sketch.selectivity, t_probe=tp - t0,
            t_select=t1 - tp, t_capture=(tc - t1) + (t3 - t2), t_execute=t2 - tc,
        )

    def run_batch(self, qs):
        raise NotImplementedError("run_batch comes with the batched-admission slice of the port")
