"""Batched admission: the miss path of ``PBDSEngine.run_batch`` (port of
``repro/core/admission.py``).

``PBDSEngine.run`` admits one query at a time, so a burst of N cold queries
that differ only in their HAVING thresholds pays N samples, N AQR passes, N
full-table capture scans and N maintainer builds.  Batched admission shares
them across *signature groups*:

  wave planning   a query whose sketch an earlier batch member would create
                  is deferred a wave and served as an index hit, as
                  sequential execution would serve it;
  selection       misses grouped by inner-block signature share one sample
                  and one AQR pass, and every (query, candidate) incidence
                  row of the wave goes through one padded pass
                  (``estimate_size_multi``);
  execution       each signature group evaluates the shared inner block once;
                  every member's result and provenance mask derive from it;
  capture         admitted sketches grouped by (table, partition) capture
                  from stacked masks in one ``fragment_bitmap_batch`` launch,
                  and maintainers clone their threshold-independent counting
                  state from one build per (signature, partition).

Results, index contents, sketch bits and maintainer counters equal those of
sequential ``run`` (``tests/test_torch_admission.py`` holds both against the
reference): selection randomness is content-derived
(``PBDSEngine._select_key``), ranking ties break on ``(est_rows, attr)``,
and every shared product is what sequential execution would have pulled
from the caches.  The random strategies (and OPT) select per query through
``select_attribute``, whose pick is a function of the query's key.  With
``cluster_tables=True`` the first admission clusters the table mid-batch,
after the wave's selection shared the pre-cluster sample;
group-by candidates (CB-OPT-GB) pin incidence on group values, so the
choice is the one sequential ``run`` makes.
"""
from __future__ import annotations

import time
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import prng
from repro_torch.aqp.size_estimation import (
    EstimationSpec,
    estimate_size_multi,
    satisfied_groups,
)
from repro_torch.core.index import subsumes
from repro_torch.core.maintenance import SketchMaintainer
from repro_torch.core.queries import (
    Query,
    QueryResult,
    execute,
    inner_block,
    provenance_from_inner,
    result_from_group_state,
)
from repro_torch.core.ranges import RangeSet
from repro_torch.core.safety import stats_prefilter
from repro_torch.core.sketch import ProvenanceSketch, apply_sketch, capture_sketches_batch
from repro_torch.core.strategies import (
    RANDOM_STRATEGIES,
    SelectionResult,
    candidate_pool,
    select_attribute,
    selection_cache_key,
)
from repro_torch.runtime.guards import hot_path

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.engine import PBDSEngine, RunInfo

Miss = Tuple[int, Query, float]  # (batch position, query, probe seconds)


def exec_group_key(q: Query) -> Tuple:
    """Inner-block signature: queries with equal keys share FROM/WHERE/GROUP
    BY/aggregate products (sample, AQR estimates, inner-block evaluation,
    maintainer counting state); only their HAVING chains differ."""
    return q.inner_signature()


def plan_wave(misses: List[Miss]) -> Tuple[List[Miss], List[Miss]]:
    """Split one wave's misses into (admit now, defer to the next wave).

    A miss is deferred when an earlier miss in the same wave subsumes it: in
    sequential execution the earlier query's sketch would exist by then, so
    the later one is served as an index hit.  If the earlier query declines
    to create a sketch, the deferred one is admitted next wave with the same
    (content-derived) randomness, so the outcome still matches.
    """
    wave: List[Miss] = []
    deferred: List[Miss] = []
    for m in misses:
        if any(subsumes(w[1], m[1]) for w in wave):
            deferred.append(m)
        else:
            wave.append(m)
    return wave, deferred


@hot_path
def admit_misses(
    engine: "PBDSEngine", misses: List[Miss]
) -> Tuple[Dict[int, Tuple[QueryResult, "RunInfo"]], List[Tuple[int, Query]]]:
    """One admission wave: plan, admit, and return ``(served by batch
    position, deferred (position, query) pairs)``.  NO-PS skips planning:
    it never creates sketches."""
    wave, deferred = (
        plan_wave(misses) if engine.strategy != "NO-PS" else (misses, []))
    served = admit_wave(engine, wave)
    return served, [(i, q) for i, q, _ in deferred]


def _select_wave(
    engine: "PBDSEngine", wave: List[Miss]
) -> Dict[int, SelectionResult]:
    """Candidate selection for the whole wave.

    Cost-based strategies share per-signature-group samples and AQR passes
    and rank every (query, candidate) pair in one padded pass; OPT selects
    per query with its content-derived key (nothing to share).
    """
    db, strategy = engine.db, engine.strategy
    out: Dict[int, SelectionResult] = {}
    if strategy == "NO-PS":
        return {pos: SelectionResult("NO-PS", None, (), {}) for pos, _, _ in wave}
    if strategy in RANDOM_STRATEGIES or strategy == "OPT":
        for pos, q, _ in wave:
            out[pos] = select_attribute(
                strategy, engine._select_key(q), q, db, engine.n_ranges,
                sample_cache=engine.samples, theta=engine.theta, cfg=engine.cfg,
                ranges_for=lambda a, t=q.table: engine.ranges_for(t, a),
                catalog=engine.catalog, aqr_cache=engine.aqr,
                selection=engine.selection,
                selection_cache=engine.selection_cache,
            )
        return out

    sel_cfg = engine.selection
    specs: List[EstimationSpec] = []
    # Parallel to ``specs``: (selection-cache key or None, member positions).
    spec_assign: List[Tuple[Optional[Tuple], List[int]]] = []
    groups: Dict[Tuple, List[Tuple[int, Query]]] = {}
    for pos, q, _ in wave:
        groups.setdefault(exec_group_key(q), []).append((pos, q))
    for members in groups.values():
        # Members sharing a selection-cache key share one pool, prefilter,
        # estimate pass and memoized result, as a sequential replay does
        # (the first computes, the rest hit the cache).  With the cache off
        # every member is its own bucket.
        buckets: Dict[Tuple, List[Tuple[int, Query]]] = {}
        order: List[Tuple] = []
        for pos, q in members:
            bk = (selection_cache_key(strategy, q, db[q.table], engine.theta,
                                      engine.n_ranges)
                  if sel_cfg.cache else ("pos", pos))
            if bk not in buckets:
                buckets[bk] = []
                order.append(bk)
            buckets[bk].append((pos, q))
        pending: List[Tuple[Optional[Tuple], List[Tuple[int, Query]],
                            Tuple[str, ...]]] = []
        for bk in order:
            bmembers = buckets[bk]
            ck = bk if sel_cfg.cache else None
            if ck is not None:
                hit = engine.selection_cache.get(ck)
                if hit is not None:
                    for pos, _ in bmembers:
                        out[pos] = hit
                    continue
            q0 = bmembers[0][1]
            cands = candidate_pool(strategy, q0, db, engine.n_ranges,
                                   catalog=engine.catalog)
            if sel_cfg.stats_prefilter:
                cands = stats_prefilter(
                    q0, db, cands,
                    lambda a, t=q0.table: engine.ranges_for(t, a),
                    catalog=engine.catalog)
            if not cands:
                res = SelectionResult(strategy, None, cands, {})
            elif sel_cfg.skip_single_candidate and len(cands) == 1:
                res = SelectionResult(strategy, cands[0], cands, {},
                                      topk=cands)
            else:
                pending.append((ck, bmembers, cands))
                continue
            if ck is not None:
                engine.selection_cache.put(ck, res)
            for pos, _ in bmembers:
                out[pos] = res
        if not pending:
            continue
        # The sample/AQR key is the first member that reaches the sampling
        # code (cache hits, empty pools and single-candidate shortcuts never
        # do): the first *pending* bucket's lead query, what a sequential
        # replay would sample with.
        q0 = pending[0][1][0][1]
        k_s, k_e = prng.split(engine._select_key(q0))
        samples = engine.samples.get_or_create(
            k_s, db[q0.table], q0.groupby_on_fact(db), engine.theta)
        est, sampled = engine.aqr.get_or_compute(
            k_e, q0, db, samples, engine.theta, engine.cfg)
        for ck, bmembers, cands in pending:
            bq = bmembers[0][1]
            specs.append(EstimationSpec(
                q=bq, samples=samples,
                ranges_by_attr={a: engine.ranges_for(bq.table, a)
                                for a in cands},
                aqr=(est, satisfied_groups(bq, est, sampled)),
            ))
            spec_assign.append((ck, [pos for pos, _ in bmembers]))
    if specs:
        all_estimates = estimate_size_multi(db, specs, engine.cfg, engine.catalog)
        for spec, (ck, positions), estimates in zip(specs, spec_assign,
                                                    all_estimates):
            # Equal estimates resolve by attribute name, as in
            # ``strategies.select_attribute``.
            ranking = tuple(sorted(estimates,
                                   key=lambda a: (estimates[a].est_rows, a)))
            res = SelectionResult(
                strategy, ranking[0], tuple(spec.ranges_by_attr), estimates,
                topk=ranking[:1])
            if ck is not None:
                engine.selection_cache.put(ck, res)
            for pos in positions:
                out[pos] = res
    return out


def admit_wave(
    engine: "PBDSEngine", wave: List[Miss]
) -> Dict[int, Tuple[QueryResult, "RunInfo"]]:
    """Run one wave of misses through the shared pipeline; returns per-batch-
    position ``(result, info)`` as ``PBDSEngine.run`` would."""
    from repro_torch.core.engine import RunInfo

    catalog = engine.catalog
    db = engine.db
    out: Dict[int, Tuple[QueryResult, RunInfo]] = {}
    probe_s = {pos: tp for pos, _, tp in wave}

    t0 = time.perf_counter()
    sels = _select_wave(engine, wave)
    t_select_each = (time.perf_counter() - t0) / max(len(wave), 1)

    # The worth-it rule of ``run``, reuse-aware discount included.  Misses
    # are logged in wave order with their *reserved* batch-position stamps,
    # so ``reach`` sees the prefix a sequential replay would.  A miss
    # deferred to a later wave is recorded after this wave's decisions, as
    # in the reference.
    reuse = engine.selection.reuse_aware and engine.strategy != "NO-PS"
    admitted: Dict[int, RangeSet] = {}  # pos -> partition of the chosen attr
    for pos, q, _ in wave:
        stamp = (engine.workload.record(q, stamp=engine.workload.batch_stamp(pos))
                 if reuse else None)
        if engine._worth_it(sels[pos], q, stamp):
            admitted[pos] = engine.ranges_for(q.table, sels[pos].attr)

    # Re-layout comes before the shared scans, in the sequential order
    # (select, cluster, capture).
    for pos, q, _ in wave:
        if pos in admitted:
            engine._maybe_cluster(q.table, admitted[pos])
    db = engine.db  # clustering may have replaced tables

    # One inner-block evaluation per signature group feeds every member's
    # result and, for admitted members, the provenance its sketch captures.
    exec_groups: Dict[Tuple, List[Tuple[int, Query]]] = {}
    for pos, q, _ in wave:
        exec_groups.setdefault(exec_group_key(q), []).append((pos, q))
    results: Dict[int, QueryResult] = {}
    provs: Dict[int, np.ndarray] = {}
    t_exec: Dict[int, float] = {}
    for members in exec_groups.values():
        te0 = time.perf_counter()
        ib = inner_block(db, members[0][1], catalog)
        ib_share = (time.perf_counter() - te0) / len(members)
        n_fact = db[members[0][1].table].num_rows
        for pos, q in members:
            tq0 = time.perf_counter()
            results[pos] = result_from_group_state(
                q, ib.group_values, ib.agg_np, ib.present, ib.flat.device)
            if pos in admitted:
                provs[pos] = provenance_from_inner(q, ib, n_fact)
            t_exec[pos] = ib_share + (time.perf_counter() - tq0)

    # Fused capture: one bucketize + one batched bitmap launch per partition.
    adm_pos = [pos for pos, _, _ in wave if pos in admitted]
    t_capture: Dict[int, float] = {pos: 0.0 for pos in adm_pos}
    sketches: Dict[int, ProvenanceSketch] = {}
    if adm_pos:
        q_of = {pos: q for pos, q, _ in wave}
        tc0 = time.perf_counter()
        sk_list = capture_sketches_batch(
            [q_of[pos] for pos in adm_pos], db,
            [admitted[pos] for pos in adm_pos],
            [provs[pos] for pos in adm_pos], catalog=catalog)
        cap_share = (time.perf_counter() - tc0) / len(adm_pos)
        sketches = dict(zip(adm_pos, sk_list))

        # Maintainer counting state is HAVING-independent: build once per
        # (signature group, partition), clone for the rest of the group.
        bases: Dict[Tuple, SketchMaintainer] = {}
        for pos in adm_pos:
            q, ranges, sketch = q_of[pos], admitted[pos], sketches[pos]
            tm0 = time.perf_counter()
            bk = (exec_group_key(q), ranges.key())
            base = bases.get(bk)
            if base is None:
                maintainer = SketchMaintainer(q, db, ranges, catalog)
                bases[bk] = maintainer
            else:
                maintainer = base.clone_for(q, db, catalog)
            engine.index.insert(q, sketch, maintainer=maintainer)
            # Warm the reuse path while capture is being paid for, as ``run``.
            execute(q, apply_sketch(sketch, db, catalog=catalog), catalog=catalog)
            t_capture[pos] = cap_share + (time.perf_counter() - tm0)

    for pos, q, _ in wave:
        sel = sels[pos]
        if pos in sketches:
            sketch = sketches[pos]
            info = RunInfo(
                reused=False, created=True, attr=sel.attr,
                strategy=engine.strategy, selectivity=sketch.selectivity,
                t_probe=probe_s[pos], t_select=t_select_each,
                t_capture=t_capture[pos], t_execute=t_exec[pos],
            )
        else:
            info = RunInfo(
                reused=False, created=False, attr=None,
                strategy=engine.strategy, selectivity=None,
                t_probe=probe_s[pos], t_select=t_select_each,
                t_execute=t_exec[pos],
            )
        out[pos] = (results[pos], info)
    return out
