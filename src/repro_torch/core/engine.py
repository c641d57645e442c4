"""PBDSEngine — the Fig. 3 workflow as one online component (port of
``repro/core/engine.py``).

For each incoming query:
  1. probe the sketch index; on a hit, bring the sketch current if its table
     mutated (delta maintenance, or re-capture) and run the query over the
     catalog-cached sketch instance (the rows of the sketch's fragments,
     pow2-padded);
  2. otherwise run the configured selection strategy (samples, AQR passes
     and whole selection results are cached), capture an accurate sketch on
     the chosen attribute through the fused capture+execute path, build its
     maintainer, store both, warm its instance and return the shared result;
  3. when no candidate is worth it, fall back to NO-PS execution.

``run_batch`` serves a batch's index hits at once and admits its misses
through the batched pipeline (``repro_torch.core.admission``), with the
same results and index contents as sequential ``run``.  ``append_rows`` and
``delete_rows`` mutate a table; sketches repair lazily on their next hit.

With ``cluster_tables=True`` the first created sketch of a table also lays
the table out fragment-major on that sketch's partition
(``ColumnTable.cluster_by``), so instances on it are slice concatenations;
it is opt-in because the reorder changes the float32 order of additions for
queries grouping on other attributes.  ``compact_tail_frac`` folds an
oversized append tail back into fragment-major order.

The engine runs on its tables' device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.aqp.sampling import AQRCache, SampleCache
from repro_torch.aqp.size_estimation import EstimationConfig
from repro_torch.core.catalog import Catalog
from repro_torch.core.index import IndexEntry, SketchIndex
from repro_torch.core.maintenance import MaintenanceError, build_maintainer, repair_sketch
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
    # Hit-path split: ``t_probe`` is the index lookup, ``t_repair`` the
    # bring-current work on a mutated table.
    t_probe: float = 0.0
    t_repair: float = 0.0
    # Index hit on a mutated table: the sketch was brought current before use
    # (maintained, or re-captured when maintenance refused; the catalog's
    # ``sketch_maintained``/``sketch_recaptured`` stats tell them apart).
    repaired: bool = False
    # Fragment-sharded serving (``repro_torch.core.shard``): shards sent work
    # and shards skipped because the sketch has none of their fragments.
    # ``None`` for single-node execution.
    shards_contacted: Optional[int] = None
    shards_skipped: Optional[int] = None
    # Some shard's slices were served from the coordinator's table (the shard
    # missed the op deadline).
    degraded: bool = False

    @property
    def t_total(self) -> float:
        return self.t_probe + self.t_select + self.t_capture + self.t_repair + self.t_execute


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
        cluster_tables: bool = False,
        max_delta_chain: int = 64,
        compact_tail_frac: Optional[float] = None,
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
        self.cluster_tables = cluster_tables
        self._base_key = prng.PRNGKey(seed)
        self._ranges_cache: Dict[Tuple[str, str], RangeSet] = {}
        # Delta chains pin every prior version's columns; past this depth the
        # engine advances all maintainers and collapses the history.
        self.max_delta_chain = max_delta_chain
        # Sketches estimated to cover >= this fraction of the table are not
        # worth creating (problem definition (i) in Sec. 4.5).
        self.min_selectivity_gain = min_selectivity_gain
        # A clustered table whose unsorted append tail exceeds this fraction
        # of its rows is compacted (None: never).
        self.compact_tail_frac = compact_tail_frac

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

    def _maybe_cluster(self, table_name: str, ranges: RangeSet) -> None:
        """Fragment-major layout, once per table (at its first created
        sketch).  Equi-depth bounds do not depend on row order, so the
        ranges cache stays valid; cached samples hold row positions and go."""
        if not self.cluster_tables:
            return
        table = self.db[table_name]
        if table.layout is not None:
            return
        self.db = self.db.with_table(table.cluster_by(ranges))
        self.samples.invalidate(table_name)
        self.selection_cache.invalidate(table_name)
        self.catalog.invalidate_table(table)
        self.catalog.stats["cluster"] += 1

    # -- mutations -------------------------------------------------------------
    def append_rows(self, table_name: str, rows: Mapping[str, np.ndarray]) -> None:
        """Append a batch; sketches repair lazily on their next index hit."""
        self.db = self.db.with_table(self.db[table_name].append(rows))
        self.catalog.stats["table_append"] += 1
        self._bound_history(table_name)
        self._maybe_compact(table_name)

    def _maybe_compact(self, table_name: str) -> None:
        """Fold an oversized unsorted tail back into fragment-major order.
        Compaction drops the delta chain, so every maintainer is advanced to
        the current version first."""
        table = self.db[table_name]
        lay = table.layout
        if (self.compact_tail_frac is None or lay is None or
                lay.tail <= self.compact_tail_frac * max(table.num_rows, 1)):
            return
        self._advance_maintainers(table_name, table)
        self.db = self.db.with_table(table.compact())
        self.catalog.invalidate_chain(table)
        self.samples.invalidate(table_name)
        self.selection_cache.invalidate(table_name)
        self.catalog.stats["compact"] += 1

    def delete_rows(self, table_name: str, mask: np.ndarray) -> None:
        """Delete the masked rows; sketches repair lazily on their next hit."""
        self.db = self.db.with_table(self.db[table_name].delete(mask))
        self.catalog.stats["table_delete"] += 1
        self._bound_history(table_name)

    def _bound_history(self, table_name: str) -> None:
        """Cap the delta chain: past ``max_delta_chain`` advance every
        maintainer to the current version (delta-sized work), then drop the
        parent references and every cache entry of the chain, so prior
        versions' columns can be freed."""
        table = self.db[table_name]
        if table.delta_depth() <= self.max_delta_chain:
            return
        self._advance_maintainers(table_name, table)
        self.db = self.db.with_table(table.collapse())
        self.catalog.invalidate_chain(table)
        self.samples.invalidate(table_name)
        self.selection_cache.invalidate(table_name)
        self.catalog.stats["history_collapse"] += 1

    def _advance_maintainers(self, table_name: str, table) -> None:
        """Bring every maintainer of ``table_name`` to ``table``'s version
        (delta-sized work) before its delta chain is dropped."""
        for e in self.index.entries():
            if e.query.table != table_name or e.maintainer is None:
                continue
            try:
                e.maintainer.apply(table, self.db)
                e.sketch = e.maintainer.to_sketch(table, self.catalog)
            except MaintenanceError:
                e.maintainer = None  # next hit re-captures

    def _current_sketch(self, entry: IndexEntry) -> Tuple[ProvenanceSketch, bool]:
        """The entry's sketch, repaired first if its table mutated."""
        table = self.db[entry.query.table]
        if entry.sketch.current_for(table):
            return entry.sketch, False
        result, maintainer = repair_sketch(
            entry.query, self.db, entry.sketch, entry.maintainer, catalog=self.catalog)
        entry.sketch = result.sketch
        entry.maintainer = maintainer
        return result.sketch, True

    @hot_path
    def _serve_hit(
        self, q: Query, entry: IndexEntry, t_probe: float
    ) -> Tuple[QueryResult, RunInfo]:
        """Serve one index hit over the (repaired-if-stale) sketch instance:
        the shared hit path of ``run`` and ``run_batch``."""
        tp = time.perf_counter()
        sketch, repaired = self._current_sketch(entry)
        tr = time.perf_counter()
        res = execute_with_sketch(q, self.db, sketch, catalog=self.catalog)
        return res, RunInfo(
            reused=True, created=False, attr=sketch.attr, strategy=self.strategy,
            selectivity=sketch.selectivity, t_probe=t_probe, t_repair=tr - tp,
            t_execute=time.perf_counter() - tr, repaired=repaired,
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
        self._maybe_cluster(q.table, ranges)
        tc = time.perf_counter()
        # Fused path: one inner-block evaluation yields the result AND the
        # provenance the sketch is captured from.
        res, prov = execute_and_provenance(q, self.db, catalog=self.catalog)
        t2 = time.perf_counter()
        sketch = capture_sketch(q, self.db, ranges, prov=prov, catalog=self.catalog)
        # Maintenance state rides along from capture: its group encoding and
        # bucketization are catalog hits here, so the build is one counting
        # pass on the host.
        maintainer = build_maintainer(q, self.db, ranges, self.catalog)
        self.index.insert(q, sketch, maintainer=maintainer)
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

    @hot_path
    def run_batch(self, qs: Sequence[Query]) -> List[Tuple[QueryResult, RunInfo]]:
        """Batched admission: serve index hits at once, admit the misses
        through the shared-selection / fused-capture pipeline.

        Equivalent to ``[self.run(q) for q in qs]``: results, index contents,
        sketch bits and maintainer counters are equal.  Misses are grouped
        by inner-block signature, so each group pays one sample, one AQR
        pass, one inner-block scan and one maintainer build; capture emits
        all of a partition's bitvectors from one ``fragment_bitmap_batch``
        launch.  A query whose sketch an earlier member of the batch would
        create is deferred a wave and served as an index hit, as sequential
        execution would serve it.
        """
        from repro_torch.core.admission import admit_misses

        if self.selection.reuse_aware and self.strategy != "NO-PS":
            # Reserve workload-log stamps per batch position up front: wave
            # deferral records misses out of arrival order, and the stamps
            # keep ``reach`` equal to a sequential replay's.
            self.workload.begin_batch(len(qs))
        out: List[Optional[Tuple[QueryResult, RunInfo]]] = [None] * len(qs)
        pending: List[Tuple[int, Query]] = list(enumerate(qs))
        while pending:
            misses: List[Tuple[int, Query, float]] = []
            for i, q in pending:
                t0 = time.perf_counter()
                entry = self.index.lookup_entry(q) if self.strategy != "NO-PS" else None
                tp = time.perf_counter()
                if entry is None:
                    misses.append((i, q, tp - t0))
                    continue
                out[i] = self._serve_hit(q, entry, tp - t0)
            if not misses:
                break
            served, pending = admit_misses(self, misses)
            for i, item in served.items():
                out[i] = item
        return out  # type: ignore[return-value]
