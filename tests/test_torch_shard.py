"""The port's fragment-sharded serving against the reference's, on the CPU.

Twins of ``tests/test_shard.py`` and ``tests/test_shard_batch.py`` on the
four templates (the join ones against the shards' replicas of ``orders``),
of the dimension mutation that evicts join sketches (also while the shards
lag and one is partitioned), and of the placement glue.  Each runs
the same seeded data through ``repro.core.ShardedEngine`` and
``repro_torch.core.ShardedEngine`` and holds, with no tolerance: results
(group values and values, bit for bit, which inside the integral envelope
also equals single-node execution), ``RunInfo`` and ``RouteInfo`` shards
contacted and skipped and their degraded-mode fields, and the engines' state (index sketch bits, each
shard's maintainer bits, registrations, watermark).  The twin of the
reference's recompile test counts distinct stacked shape classes instead of
XLA compiles; the multi-device ``shard_map`` mesh test has no one-card
counterpart.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core import datasets as rdata
from repro.core import shard as rshard
from repro_torch.convert import database_from_numpy
from repro_torch.core import shard as tshard
from repro_torch.runtime.guards import LAUNCH_COUNTS, SHAPE_CLASSES

torch.set_num_threads(1)  # small tensors; leave the cores to the other xdist workers

N_ROWS = 20_000
ARGS = dict(n_ranges=25, theta=0.1, seed=0, min_selectivity_gain=2.0)


def _port_db(rdb):
    return database_from_numpy(
        [(n, {a: np.asarray(rdb[n][a]) for a in rdb[n].schema}, rdb[n].primary_key)
         for n in rdb.names], device="cpu")


def _crimes(n, seed):
    rdb = R.Database({"crimes": rdata.make_crimes(n, seed=seed)})
    return rdb, _port_db(rdb)


def _threshold(mod, q, db, quantile):
    vals = mod.execute(dataclasses.replace(q, having=None, outer_having=None), db).values
    return float(np.quantile(vals, quantile))


def _having(mod, db, gb, quantiles, agg=("sum", "records"), where=None):
    base = mod.Query("crimes", gb, mod.Aggregate(*agg), where=where)
    return [dataclasses.replace(base, having=mod.Having(">", _threshold(mod, base, db, qt)))
            for qt in quantiles]


def _engines(rdb, tdb, table="crimes", attr="district", n_shards=4, **kw):
    """The reference's and the port's engine, with the same settings."""
    args = dict(ARGS, **kw)
    return (R.ShardedEngine(rdb, table, attr, n_shards=n_shards, **args),
            T.ShardedEngine(tdb, table, attr, n_shards=n_shards, **args))


def _snapshot(se):
    """Comparable engine state: index sketches, shard maintainer bits,
    registration count, watermark (``tests/test_shard_batch.py``'s)."""
    index = sorted((repr(e.query.signature()), e.sketch.bits.tobytes(), e.sketch.size_rows)
                   for e in se.engine.index.entries())
    shard_bits = [sorted(m.bits().tobytes() for m in shard.maintainers.values())
                  for shard in se.shards]
    return {"index": index, "shard_bits": shard_bits, "n_registered": len(se._registered),
            "watermark": se.min_watermark(), "version": se.version}


def _assert_same(got, want, ctx=""):
    """Port ``(result, info)`` equal to the reference's, bit for bit."""
    (g, gi), (w, wi) = got, want
    assert sorted(g.group_values) == sorted(w.group_values), ctx
    for a in w.group_values:
        np.testing.assert_array_equal(np.asarray(g.group_values[a]),
                                      np.asarray(w.group_values[a]), err_msg=ctx)
    np.testing.assert_array_equal(np.asarray(g.values), np.asarray(w.values), err_msg=ctx)
    assert (gi.reused, gi.created, gi.repaired, gi.attr, gi.shards_contacted,
            gi.shards_skipped, gi.degraded) == (
        wi.reused, wi.created, wi.repaired, wi.attr, wi.shards_contacted,
        wi.shards_skipped, wi.degraded), ctx


def _assert_routes(tse, rse, ctx=""):
    t, r = tse.last_route, rse.last_route
    assert (t is None) == (r is None), ctx
    if r is not None:
        assert (t.contacted, t.skipped, t.watermark, t.deltas_applied, t.fused, t.n_queries,
                t.degraded, t.failed_shards, t.n_retries, t.stale_checkpoints) == (
            r.contacted, r.skipped, r.watermark, r.deltas_applied, r.fused, r.n_queries,
            r.degraded, r.failed_shards, r.n_retries, r.stale_checkpoints), ctx


def _run_both(rse, tse, rq, tq, ctx=""):
    want, got = rse.run(rq), tse.run(tq)
    _assert_same(got, want, ctx)
    _assert_routes(tse, rse, ctx)
    return got


def _batch_both(rse, tse, rqs, tqs, ctx=""):
    want, got = rse.run_batch(rqs), tse.run_batch(tqs)
    assert len(want) == len(got)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_same(g, w, f"{ctx}[{i}]")
    _assert_routes(tse, rse, ctx)
    return got


# ---------------------------------------------------------------------------
# tests/test_shard.py twins
# ---------------------------------------------------------------------------


def test_plan_fragments_policies():
    sizes = np.array([10, 10, 10, 10, 40, 10, 10, 10])
    for policy in ("contig", "spread"):
        for n in (1, 2, 3, 5):
            np.testing.assert_array_equal(T.plan_fragments(sizes, n, policy=policy).owner,
                                          R.plan_fragments(sizes, n, policy=policy).owner)
    contig = T.plan_fragments(sizes, 3)
    assert (np.diff(contig.owner) >= 0).all() and set(contig.owner.tolist()) == {0, 1, 2}
    np.testing.assert_array_equal(contig.shards_for(np.array([0, 1])),
                                  np.unique(contig.owner[[0, 1]]))
    with pytest.raises(ValueError):
        T.plan_fragments(sizes, 2, policy="nope")


def _tpch_templates(mod, db):
    agh = mod.Query("lineitem", ("l_suppkey",), mod.Aggregate("sum", "l_quantity"))
    agh = dataclasses.replace(agh, having=mod.Having(">", _threshold(mod, agh, db, 0.8)))
    aagh = mod.Query("lineitem", ("l_partkey", "l_suppkey"), mod.Aggregate("sum", "l_quantity"),
                     having=mod.Having(">", 0.0),
                     outer_groupby=("l_suppkey",), outer_agg=mod.Aggregate("sum", None))
    aagh = dataclasses.replace(
        aagh, outer_having=mod.Having(">", _threshold(mod, aagh, db, 0.8)))
    join = mod.JoinSpec("orders", "l_orderkey", "o_orderkey")
    ajgh = mod.Query("lineitem", ("l_suppkey",), mod.Aggregate("sum", "l_quantity"), join=join)
    ajgh = dataclasses.replace(ajgh, having=mod.Having(">", _threshold(mod, ajgh, db, 0.8)))
    aajgh = mod.Query("lineitem", ("l_partkey", "l_suppkey"), mod.Aggregate("count", None),
                      join=join, having=mod.Having(">", 0.0),
                      outer_groupby=("l_suppkey",), outer_agg=mod.Aggregate("sum", None))
    aajgh = dataclasses.replace(
        aajgh, outer_having=mod.Having(">", _threshold(mod, aajgh, db, 0.8)))
    return {"Q-AGH": agh, "Q-AAGH": aagh, "Q-AJGH": ajgh, "Q-AAJGH": aajgh}


def _pair_tpch(n, seed):
    rdb = rdata.make_tpch(n, seed=seed)
    return rdb, _port_db(rdb)


@pytest.fixture(scope="module")
def tpch():
    return _pair_tpch(N_ROWS, 7)


@pytest.mark.parametrize("template", ["Q-AGH", "Q-AAGH", "Q-AJGH", "Q-AAJGH"])
@pytest.mark.parametrize("n_shards", [1, 3])
def test_routed_equals_single_node(tpch, n_shards, template):
    rdb, tdb = tpch
    rq, tq = _tpch_templates(R, rdb)[template], _tpch_templates(T, tdb)[template]
    rse, tse = _engines(rdb, tdb, "lineitem", "l_suppkey", n_shards, n_ranges=32)
    res, info = _run_both(rse, tse, rq, tq, "cold")
    want = T.execute(tq, tse.db).canonical()
    assert res.canonical() == want
    res, info = _run_both(rse, tse, rq, tq, "warm")
    assert info.reused and info.shards_contacted + info.shards_skipped == n_shards
    assert res.canonical() == want
    assert _snapshot(tse) == _snapshot(rse)


def test_dimension_mutation_evicts_and_recaptures():
    """``tests/test_shard.py::test_dimension_mutation_evicts_and_recaptures``:
    an append to ``orders`` is replicated to every shard and evicts the join
    sketch (index entry, registration, shard maintainers), so the next run
    captures afresh (``created``, not ``reused``) and stays exact."""
    rdb, tdb = _pair_tpch(N_ROWS, 13)

    def query(mod, db):
        q = mod.Query("lineitem", ("l_suppkey",), mod.Aggregate("sum", "l_quantity"),
                      join=mod.JoinSpec("orders", "l_orderkey", "o_orderkey"))
        return dataclasses.replace(q, having=mod.Having(">", _threshold(mod, q, db, 0.8)))

    rq, tq = query(R, rdb), query(T, tdb)
    rse, tse = _engines(rdb, tdb, "lineitem", "l_suppkey", 2, n_ranges=32)
    _run_both(rse, tse, rq, tq, "cold")
    _, info = _run_both(rse, tse, rq, tq, "warm")
    assert info.reused
    assert all(len(s.maintainers) == 1 for s in tse.shards)
    n = tse.db["orders"].num_rows
    rows = {
        "o_orderkey": np.arange(n + 1, n + 101, dtype=np.int64),
        "o_custkey": np.ones(100, dtype=np.int64),
        "o_totalprice": np.full(100, 1000.0, dtype=np.float32),
        "o_orderdate": np.full(100, 9000, dtype=np.int32),
        "o_shippriority": np.zeros(100, dtype=np.int32),
    }
    rse.append_rows("orders", rows)
    tse.append_rows("orders", rows)
    assert len(tse.engine.index) == 0 and not tse._registered
    assert all(s.dims["orders"] is tse.db["orders"] for s in tse.shards)
    assert all(not s.maintainers for s in tse.shards)
    res, info = _run_both(rse, tse, rq, tq, "after the dimension append")
    assert info.created and not info.reused
    assert res.canonical() == T.execute(tq, tse.db).canonical()
    res, info = _run_both(rse, tse, rq, tq, "warm again")
    assert info.reused and res.canonical() == T.execute(tq, tse.db).canonical()
    assert _snapshot(tse) == _snapshot(rse)


def test_selective_sketch_skips_shards():
    rdb, tdb = _crimes(N_ROWS, 3)
    rq, tq = _having(R, rdb, ("district",), [0.9])[0], _having(T, tdb, ("district",), [0.9])[0]
    rse, tse = _engines(rdb, tdb)
    _run_both(rse, tse, rq, tq)
    res, info = _run_both(rse, tse, rq, tq)
    assert info.reused and info.shards_skipped > 0
    assert res.canonical() == T.execute(tq, tse.db).canonical()
    assert tse.last_route.contacted == info.shards_contacted
    assert tse.last_route.t_critical_s > 0
    assert tse.engine.catalog.stats["stacked_build"] == 1


def test_non_matching_partition_routes_all_shards_exactly():
    rdb, tdb = _crimes(N_ROWS, 5)
    rq, tq = _having(R, rdb, ("year",), [0.8])[0], _having(T, tdb, ("year",), [0.8])[0]
    rse, tse = _engines(rdb, tdb, n_shards=3)
    _run_both(rse, tse, rq, tq)
    res, info = _run_both(rse, tse, rq, tq)
    assert info.reused and info.shards_contacted == 3 and info.shards_skipped == 0
    assert res.canonical() == T.execute(tq, tse.db).canonical()
    assert sum(s.catalog.stats["instance_mask"] for s in tse.shards) == 3



def test_shard_mask_branch_does_not_compact_on_the_host(monkeypatch):
    """A shard's instance on another partition than the serving one takes
    its rows from the kernel's compaction: no ``np.nonzero`` runs over the
    shard's rows, and the result is the reference's."""
    rdb, tdb = _crimes(N_ROWS, 5)
    rq, tq = _having(R, rdb, ("year",), [0.8])[0], _having(T, tdb, ("year",), [0.8])[0]
    rse, tse = _engines(rdb, tdb, n_shards=3)
    real, instance = np.nonzero, tshard.FragmentShard._instance
    inside = []

    def guarded(a):
        if inside and np.size(a) == inside[-1]:
            raise AssertionError("np.nonzero over a shard's n-row mask")
        return real(a)

    def guarded_instance(self, key, ranges, bits):
        inside.append(self.table.num_rows)
        try:
            return instance(self, key, ranges, bits)
        finally:
            inside.pop()

    monkeypatch.setattr(np, "nonzero", guarded)
    monkeypatch.setattr(tshard.FragmentShard, "_instance", guarded_instance)
    _run_both(rse, tse, rq, tq)
    res, info = _run_both(rse, tse, rq, tq)
    assert info.reused and sum(s.catalog.stats["instance_mask"] for s in tse.shards) == 3
    assert res.canonical() == T.execute(tq, tse.db).canonical()
    assert _snapshot(tse) == _snapshot(rse)


def _crimes_rows(rng):
    batch = rdata.make_crimes(int(rng.integers(200, 800)), seed=int(rng.integers(1 << 30)))
    return {a: np.array(batch[a]) for a in batch.schema}


def test_interleaved_mutations_watermark_and_exactness():
    rng = np.random.default_rng(11)
    rdb, tdb = _crimes(N_ROWS, 9)
    rqs = _having(R, rdb, ("district", "year"), (0.7, 0.9))
    tqs = _having(T, tdb, ("district", "year"), (0.7, 0.9))
    rse, tse = _engines(rdb, tdb)
    for rq, tq in zip(rqs, tqs):
        _run_both(rse, tse, rq, tq)
    n_routed = 0
    for step in range(30):
        op = rng.choice(["append", "delete", "query"], p=[0.35, 0.25, 0.4])
        if op == "append":
            rows = _crimes_rows(rng)
            rse.append_rows("crimes", rows)
            tse.append_rows("crimes", rows)
            assert tse.min_watermark() < tse.version == rse.version
        elif op == "delete":
            mask = rng.random(tse.db["crimes"].num_rows) < 0.02
            rse.delete_rows("crimes", mask)
            tse.delete_rows("crimes", mask)
            assert tse.min_watermark() < tse.version
        else:
            k = int(rng.integers(len(tqs)))
            res, info = _run_both(rse, tse, rqs[k], tqs[k], f"step {step}")
            assert info.reused
            n_routed += 1
            assert tse.min_watermark() == tse.version
            assert all(s.lag == 0 for s in tse.shards)
            assert res.canonical() == T.execute(tqs[k], tse.db).canonical(), step
            assert _snapshot(tse) == _snapshot(rse), step
        np.testing.assert_array_equal(tse._row_shard, rse._row_shard)
        np.testing.assert_array_equal(tse._row_local, rse._row_local)
    assert n_routed > 3


def test_tail_rows_on_bounds_route_like_the_reference():
    """Appended rows whose placement value sits exactly on a bound (float32
    compare) go to the reference's shard, and every shard's instance accepts
    its tail (a mis-routed row would raise)."""
    rdb, tdb = _crimes(N_ROWS, 13)
    rqs, tqs = _having(R, rdb, ("district",), [0.6]), _having(T, tdb, ("district",), [0.6])
    rse, tse = _engines(rdb, tdb)
    _run_both(rse, tse, rqs[0], tqs[0])
    rng = np.random.default_rng(2)
    rows = _crimes_rows(rng)
    bounds = tse.ranges.bounds
    rows["district"][:len(bounds)] = bounds.astype(rows["district"].dtype)
    rse.append_rows("crimes", rows)
    tse.append_rows("crimes", rows)
    np.testing.assert_array_equal(tse._row_shard, rse._row_shard)
    res, _ = _run_both(rse, tse, rqs[0], tqs[0], "after bound rows")
    assert res.canonical() == T.execute(tqs[0], tse.db).canonical()
    for ts, rs in zip(tse.shards, rse.shards):
        assert ts.table.layout.tail == rs.table.layout.tail
    for sid in range(4):
        local = tshard.local_table_for(sid, tse.plan, tse.ranges, tse.db["crimes"], version=1)
        rlocal = rshard.local_table_for(sid, rse.plan, rse.ranges, rse.db["crimes"], version=1)
        np.testing.assert_array_equal(local["district"].numpy(), np.asarray(rlocal["district"]))
        assert local.layout.tail == rlocal.layout.tail
        np.testing.assert_array_equal(local.layout.offsets, rlocal.layout.offsets)


def test_single_shard_degenerates_to_full_routing():
    rdb, tdb = _crimes(10_000, 17)
    kw = dict(agg=("count", None))
    rq, tq = _having(R, rdb, ("district",), [0.6], **kw)[0], _having(T, tdb, ("district",), [0.6], **kw)[0]
    rse, tse = _engines(rdb, tdb, n_shards=1, n_ranges=16)
    _run_both(rse, tse, rq, tq)
    res, info = _run_both(rse, tse, rq, tq)
    assert info.reused and info.shards_contacted == 1 and info.shards_skipped == 0
    assert res.canonical() == T.execute(tq, tse.db).canonical()


def test_inbox_cap_backpressure_and_resync():
    """Twin of ``tests/test_chaos.py``'s: deltas past the inbox cap are
    refused, and the next read drains the inbox and re-ships the logged
    suffix, to the reference's results."""
    rdb, tdb = _crimes(3_000, 6)
    rq, tq = _having(R, rdb, ("district",), [0.8])[0], _having(T, tdb, ("district",), [0.8])[0]
    rse, tse = _engines(rdb, tdb, n_shards=2, n_ranges=16, inbox_cap=2)
    _run_both(rse, tse, rq, tq)
    rng = np.random.default_rng(13)
    for _ in range(5):
        rows = _crimes_rows(rng)
        rse.append_rows("crimes", rows)
        tse.append_rows("crimes", rows)
    assert [s.backpressure_hits for s in tse.shards] == [s.backpressure_hits for s in rse.shards]
    assert all(s.backpressure_hits > 0 and s.lag <= 2 for s in tse.shards)
    with pytest.raises(T.BackpressureError):
        tse.shards[0].ship(99, "append", {})
    res, info = _run_both(rse, tse, rq, tq, "after backpressure")
    assert res.canonical() == T.execute(tq, tse.db).canonical()
    assert not info.degraded and tse.min_watermark() == tse.version
    assert all(len(log) == 0 for log in tse._log)
    assert _snapshot(tse) == _snapshot(rse)


def test_shard_past_the_deadline_is_served_coordinator_side():
    """With a deadline of 0 every shard op is late: once each op's timing
    baseline has formed, the shards are demoted and their slices served from
    the coordinator's table, as the reference serves them (results, routes
    and the ``degraded`` flags alike); an op in time promotes them back."""
    rdb, tdb = _crimes(N_ROWS, 7)
    rqs = _having(R, rdb, ("district", "year"), [0.8]) + _having(R, rdb, ("year",), [0.8])
    tqs = _having(T, tdb, ("district", "year"), [0.8]) + _having(T, tdb, ("year",), [0.8])
    rse, tse = _engines(rdb, tdb, n_shards=3, op_deadline_s=0.0)
    n_degraded = 0
    for step in range(12):
        for fused in (True, False):
            rse.fused = tse.fused = fused
            for rq, tq in zip(rqs, tqs):
                res, info = _run_both(rse, tse, rq, tq, f"step {step} fused={fused}")
                assert res.canonical() == T.execute(tq, tse.db).canonical()
                n_degraded += info.degraded
        assert tse.health == rse.health, step
    assert n_degraded > 0 and tse.health == ["suspect"] * 3
    rse.op_deadline_s = tse.op_deadline_s = 5.0
    res, info = _run_both(rse, tse, rqs[0], tqs[0], "in time again")
    assert not info.degraded and tse.health == ["healthy"] * 3
    assert _snapshot(tse) == _snapshot(rse)


def test_shard_past_the_deadline_serves_joins_coordinator_side(tpch):
    """A join query's degraded slices are joined through the coordinator's
    catalog, as the reference's ``_degraded_flat`` joins them: results,
    routes and ``degraded`` flags equal, on the fused and host-loop paths."""
    rdb, tdb = tpch
    rq, tq = _tpch_templates(R, rdb)["Q-AJGH"], _tpch_templates(T, tdb)["Q-AJGH"]
    rse, tse = _engines(rdb, tdb, "lineitem", "l_suppkey", 3, op_deadline_s=0.0, n_ranges=32)
    n_degraded = 0
    for step in range(4):
        for fused in (True, False):
            rse.fused = tse.fused = fused
            res, info = _run_both(rse, tse, rq, tq, f"step {step} fused={fused}")
            assert res.canonical() == T.execute(tq, tse.db).canonical()
            n_degraded += info.degraded
    assert n_degraded > 0 and tse.health == rse.health


def test_fused_launch_path_has_no_host_sync():
    """``tools.analyze`` links calls by bare name across ``src/``, so the
    port's ``_launch`` reaches ``_fused_body`` through a variable and the
    analyzer's SYNC01 does not follow the port's fused path; this walks that
    path itself, from ``ShardedEngine._launch`` to the kernel's launch, and
    finds no host-device sync on it (the merge point is the caller's copy
    of the results)."""
    import ast
    import inspect
    import textwrap

    from repro_torch.kernels import build, ops
    from repro_torch.kernels import segment_aggregate as ksa

    chain = [tshard.ShardedEngine._launch, tshard._fused_body, ops.segment_aggregate_batch,
             ksa.segment_aggregate_batch]
    helpers = [ksa._plan_on, ksa._device_plan, ksa.plan, ksa._buffers, ksa._launch,
               ksa._workspace, ksa.partial_sets, build.library, build.stream_handle,
               build.check_tensor, build.check]
    trees = {fn: ast.parse(textwrap.dedent(inspect.getsource(fn))) for fn in chain + helpers}

    def names(tree):
        return {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)} | {
            n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}

    for caller, callee in zip(chain, chain[1:]):
        refs = names(trees[caller])
        assert callee.__name__ in refs or any(
            caller.__globals__.get(n) is callee for n in refs), (caller, callee)
    assert "segagg_batch_launch" in names(trees[chain[-1]])
    reached = set().union(*(names(tree) for tree in trees.values()))
    assert all(h.__name__ in reached for h in helpers)
    sync_attrs = {"item", "cpu", "numpy", "tolist", "synchronize", "to_host", "asarray"}
    for fn, tree in trees.items():
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                f = node.func
                name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
                assert name not in sync_attrs, f"{fn.__qualname__}: {ast.unparse(node)}"


def test_sharded_engine_refuses_what_this_slice_lacks():
    """Coordinator-permuting keywords raise; subprocess shards and standby
    replication (ROADMAP A6) raise ``NotImplementedError`` naming their
    slice; a shard kill and a rebalance, once refused, now work: the killed
    shard loses its state, and the rebalanced engine serves exactly."""
    rdb, tdb = _crimes(2_000, 1)
    with pytest.raises(ValueError):
        T.ShardedEngine(tdb, "crimes", "district", n_shards=2, cluster_tables=True)
    with pytest.raises(ValueError):
        T.ShardedEngine(tdb, "crimes", "district", n_shards=2, compact_tail_frac=0.5)
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        T.ShardedEngine(tdb, "crimes", "district", n_shards=2, transport="subprocess")
    se = T.ShardedEngine(tdb, "crimes", "district", n_shards=2)
    for call in (lambda: se.attach_replica(None),
                 lambda: T.ShardedEngine.from_replica(None, epoch=1)):
        with pytest.raises(NotImplementedError, match="ROADMAP A6"):
            call()
    se.shards[0].inject("kill")
    assert se.shards[0].state_lost and se.shards[0].version == -1
    assert not se.shards[0].reachable and not se.shards[0].maintainers
    assert se.rebalance([0]) == [1]
    assert not (se.plan.owner == 0).any()
    assert se.shards[1].table.num_rows == tdb["crimes"].num_rows
    q = _having(T, tdb, ("district",), [0.7])[0]
    for _ in range(2):
        res, info = se.run(q)
        assert res.canonical() == T.execute(q, tdb).canonical() and not info.degraded


def test_dim_mutation_while_shards_lag_recaptures():
    """``tests/test_shard.py::test_dim_mutation_while_shards_lag_recaptures``:
    a dimension append lands while fact deltas are in flight and one shard
    is partitioned; the join sketch is evicted everywhere, the next read
    drains the lag, refreshes the partitioned shard's stale replica and
    re-captures; a shard whose local replica drifted drops its maintainer in
    ``catch_up``.  Results, routes, health and state equal the reference's."""
    rdb, tdb = _pair_tpch(N_ROWS, 21)
    rq, tq = (dataclasses.replace(q, having=mod.Having(">", _threshold(mod, q, db, 0.8)))
              for mod, db, q in (
                  (m, d, m.Query("lineitem", ("l_suppkey",), m.Aggregate("sum", "l_quantity"),
                                 join=m.JoinSpec("orders", "l_orderkey", "o_orderkey")))
                  for m, d in ((R, rdb), (T, tdb))))
    rse, tse = _engines(rdb, tdb, "lineitem", "l_suppkey", 3, n_ranges=32)
    _run_both(rse, tse, rq, tq, "cold")
    _, info = _run_both(rse, tse, rq, tq, "warm")
    assert info.reused and all(len(s.maintainers) == 1 for s in tse.shards)

    rng = np.random.default_rng(0)
    fact = tse.db["lineitem"]
    sel = rng.integers(0, fact.num_rows, 500)
    rows = {a: fact[a].numpy()[sel] for a in fact.schema}
    rse.append_rows("lineitem", rows)
    tse.append_rows("lineitem", rows)
    assert tse.min_watermark() < tse.version

    rse.shards[0].inject("partition")
    tse.shards[0].inject("partition")
    n = tse.db["orders"].num_rows
    dim_batch = {
        "o_orderkey": np.arange(n + 1, n + 51, dtype=np.int64),
        "o_custkey": np.ones(50, dtype=np.int64),
        "o_totalprice": np.full(50, 1000.0, dtype=np.float32),
        "o_orderdate": np.full(50, 9000, dtype=np.int32),
        "o_shippriority": np.zeros(50, dtype=np.int32),
    }
    rse.append_rows("orders", dim_batch)
    tse.append_rows("orders", dim_batch)
    assert all(not s.maintainers for s in tse.shards)
    assert tse.health == rse.health == ["suspect", "healthy", "healthy"]
    assert tse.shards[0].dims["orders"] is not tse.db["orders"]  # unreachable: stale

    rse.shards[0].heal()
    tse.shards[0].heal()
    res, info = _run_both(rse, tse, rq, tq, "after heal")
    assert info.created and not info.reused
    assert res.canonical() == T.execute(tq, tse.db).canonical()
    assert tse.min_watermark() == tse.version and tse.health == ["healthy"] * 3
    assert tse.shards[0].dim_token("orders") == (tse.db["orders"].uid, tse.db["orders"].version)
    res, info = _run_both(rse, tse, rq, tq, "warm after heal")
    assert info.reused and res.canonical() == T.execute(tq, tse.db).canonical()

    # A local replica drift the coordinator has not reconciled: catch_up
    # drops the join maintainer, bits_for asks for re-registration.
    rs, ts = rse.shards[1], tse.shards[1]
    key = next(iter(ts.maintainers))
    rs.dims["orders"] = rs.dims["orders"].append(dim_batch)
    ts.dims["orders"] = ts.dims["orders"].append(dim_batch)
    fact = tse.db["lineitem"]
    sel = rng.integers(0, fact.num_rows, 100)
    rows = {a: fact[a].numpy()[sel] for a in fact.schema}
    rse.append_rows("lineitem", rows)
    tse.append_rows("lineitem", rows)
    rs.catch_up(rse.version)
    ts.catch_up(tse.version)
    assert key not in ts.maintainers and ts.bits_for(key) is None
    res, _ = _run_both(rse, tse, rq, tq, "after the drift")
    assert res.canonical() == T.execute(tq, tse.db).canonical()
    assert _snapshot(tse) == _snapshot(rse)


def test_placement_glue_single_device():
    """``tests/test_shard.py::test_placement_glue_single_device``: no pins
    without several CUDA devices, ``place_table`` an identity for ``None``
    and a move that keeps (uid, version) otherwise, ``failover_device``
    the reference's choice on the same pin lists."""
    from repro.parallel import placement as rplace
    from repro_torch.parallel import placement as tplace

    devs = tplace.shard_devices(3)
    assert devs == [None, None, None]  # no card here: no pinning
    assert tplace.shard_devices(3, use_devices=False) == [None, None, None]
    _, tdb = _crimes(100, 0)
    t = tdb["crimes"]
    assert tplace.place_table(t, None) is t
    moved = tplace.place_table(t, torch.device("cpu"))
    assert moved is not t and (moved.uid, moved.version) == (t.uid, t.version)
    assert all(torch.equal(moved[a], t[a]) for a in t.schema)
    cases = [([None, None, None], 1, [1, 2]), (["d0", "d1", "d0"], 1, [1]),
             (["d0", "d1", "d0"], 2, [0, 2]), (["d0", "d0"], 1, [0, 1]),
             (["d0", "d1", "d2", "d1"], 3, [1, 3]), (["d0", "d1", "d2", "d0"], 0, [0, 3])]
    for pins, sid, dead in cases:
        assert tplace.failover_device(pins, sid, dead) == rplace.failover_device(pins, sid, dead)


# ---------------------------------------------------------------------------
# tests/test_shard_batch.py twins
# ---------------------------------------------------------------------------


def _tpch_batches(mod, db, quantiles=(0.55, 0.8, 0.9)):
    """``tests/test_shard_batch.py``'s per-template batches, the join ones
    (``:71``, ``:89``) included."""
    join = mod.JoinSpec("orders", "l_orderkey", "o_orderkey")
    agh = mod.Query("lineitem", ("l_suppkey",), mod.Aggregate("sum", "l_quantity"))
    ajgh = dataclasses.replace(agh, join=join)
    aagh = mod.Query("lineitem", ("l_partkey", "l_suppkey"), mod.Aggregate("sum", "l_quantity"),
                     having=mod.Having(">", 0.0),
                     outer_groupby=("l_suppkey",), outer_agg=mod.Aggregate("sum", None))
    aajgh = dataclasses.replace(aagh, agg=mod.Aggregate("count", None), join=join)

    def having(q):
        return [dataclasses.replace(q, having=mod.Having(">", _threshold(mod, q, db, qt)))
                for qt in quantiles]

    def outer_having(q):
        return [dataclasses.replace(q, outer_having=mod.Having(">", _threshold(mod, q, db, qt)))
                for qt in quantiles]

    return {"Q-AGH": having(agh), "Q-AJGH": having(ajgh),
            "Q-AAGH": outer_having(aagh), "Q-AAJGH": outer_having(aajgh)}


@pytest.mark.parametrize("template", ["Q-AGH", "Q-AAGH", "Q-AJGH", "Q-AAJGH"])
def test_run_batch_matches_sequential(tpch, template):
    rdb, tdb = tpch
    rqs, tqs = _tpch_batches(R, rdb)[template], _tpch_batches(T, tdb)[template]
    rse, tse = _engines(rdb, tdb, "lineitem", "l_suppkey", 2, n_ranges=32)
    _, t_seq = _engines(rdb, tdb, "lineitem", "l_suppkey", 2, n_ranges=32)
    got = _batch_both(rse, tse, rqs, tqs, template)
    seq = [t_seq.run(q) for q in tqs]
    for g, s in zip(got, seq):
        _assert_same(g, s, "batch vs sequential")
    assert _snapshot(tse) == _snapshot(rse) == _snapshot(t_seq)
    got = _batch_both(rse, tse, rqs, tqs, template + ":warm")
    assert all(info.reused for _, info in got)
    for (res, _), q in zip(got, tqs):
        assert res.canonical() == T.execute(q, tse.db).canonical()


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_run_batch_mixed_hits_and_misses(n_shards):
    rdb, tdb = _crimes(N_ROWS, 3)
    rqs = _having(R, rdb, ("district", "year"), (0.5, 0.7, 0.9))
    tqs = _having(T, tdb, ("district", "year"), (0.5, 0.7, 0.9))
    kw = dict(agg=("count", None))
    rq2, tq2 = _having(R, rdb, ("district",), [0.6], **kw)[0], _having(T, tdb, ("district",), [0.6], **kw)[0]
    rse, tse = _engines(rdb, tdb, n_shards=n_shards)
    _run_both(rse, tse, rqs[0], tqs[0])
    rbatch = [rqs[1], rqs[0], rq2, rqs[2], rqs[1]]
    tbatch = [tqs[1], tqs[0], tq2, tqs[2], tqs[1]]
    got = _batch_both(rse, tse, rbatch, tbatch, f"S={n_shards}")
    assert _snapshot(tse) == _snapshot(rse)
    for (res, _), q in zip(got, tbatch):
        assert res.canonical() == T.execute(q, tse.db).canonical()


def test_run_batch_interleaved_mutations_and_maintainer_state():
    rng = np.random.default_rng(19)
    rdb, tdb = _crimes(N_ROWS, 9)
    rqs = _having(R, rdb, ("district", "year"), (0.6, 0.8)) + _having(R, rdb, ("year",), [0.7])
    tqs = _having(T, tdb, ("district", "year"), (0.6, 0.8)) + _having(T, tdb, ("year",), [0.7])
    rse, tse = _engines(rdb, tdb)
    _batch_both(rse, tse, rqs, tqs, "cold")
    assert _snapshot(tse) == _snapshot(rse)
    assert [r.group_local for r in tse._registered.values()] == [
        r.group_local for r in rse._registered.values()]
    n_batches = 0
    for step in range(16):
        op = rng.choice(["append", "delete", "batch"], p=[0.3, 0.25, 0.45])
        if op == "append":
            batch = rdata.make_crimes(int(rng.integers(200, 600)), seed=int(rng.integers(1 << 30)))
            rows = {a: np.asarray(batch[a]) for a in batch.schema}
            rse.append_rows("crimes", rows)
            tse.append_rows("crimes", rows)
        elif op == "delete":
            mask = rng.random(tse.db["crimes"].num_rows) < 0.02
            rse.delete_rows("crimes", mask)
            tse.delete_rows("crimes", mask)
        else:
            picks = [int(rng.integers(len(tqs))) for _ in range(int(rng.integers(2, 5)))]
            got = _batch_both(rse, tse, [rqs[k] for k in picks], [tqs[k] for k in picks],
                              f"step {step}")
            for (res, info), k in zip(got, picks):
                assert info.reused
                assert res.canonical() == T.execute(tqs[k], tse.db).canonical(), step
            assert tse.min_watermark() == tse.version
            assert _snapshot(tse) == _snapshot(rse), step
            n_batches += 1
    assert n_batches >= 3


def test_fused_equals_host_loop_bitwise():
    rdb, tdb = _crimes(N_ROWS, 5)
    rqs = _having(R, rdb, ("district", "year"), [0.8])
    tqs = _having(T, tdb, ("district", "year"), [0.8])
    kw = dict(agg=("avg", "records"))
    rqs += _having(R, rdb, ("district", "year"), [0.8], **kw)
    tqs += _having(T, tdb, ("district", "year"), [0.8], **kw)
    rse, tse = _engines(rdb, tdb)
    for rq, tq in zip(rqs, tqs):
        _run_both(rse, tse, rq, tq, "cold")
        outs = {}
        for fused in (True, False):
            rse.fused = tse.fused = fused
            outs[fused] = _run_both(rse, tse, rq, tq, f"fused={fused}")
            assert tse.last_route.fused == fused
        (rf, inf_f), (rl, inf_l) = outs[True], outs[False]
        assert (inf_f.shards_contacted, inf_f.shards_skipped) == (
            inf_l.shards_contacted, inf_l.shards_skipped)
        np.testing.assert_array_equal(rf.values, rl.values)
        for a in rf.group_values:
            np.testing.assert_array_equal(rf.group_values[a], rl.group_values[a])
        assert rf.canonical() == T.execute(tq, tse.db).canonical()


def test_fused_equals_host_loop_bitwise_over_joins(tpch):
    """The join templates (and a WHERE on a dimension attribute) through the
    fused launch and the per-shard host loop: equal bits, equal to the
    reference and to single-node execution."""
    rdb, tdb = tpch
    rqs, tqs = _tpch_templates(R, rdb), _tpch_templates(T, tdb)
    pairs = [(rqs[t], tqs[t]) for t in ("Q-AJGH", "Q-AAJGH")]
    rw, tw = (dataclasses.replace(qs["Q-AJGH"], where=mod.Predicate("o_shippriority", ">=", 2))
              for mod, qs in ((R, rqs), (T, tqs)))
    pairs.append((rw, tw))
    rse, tse = _engines(rdb, tdb, "lineitem", "l_suppkey", 3, n_ranges=32)
    for rq, tq in pairs:
        _run_both(rse, tse, rq, tq, "cold")
        outs = {}
        for fused in (True, False):
            rse.fused = tse.fused = fused
            outs[fused] = _run_both(rse, tse, rq, tq, f"fused={fused}")
            assert outs[fused][1].reused and tse.last_route.fused == fused
        (rf, _), (rl, _) = outs[True], outs[False]
        np.testing.assert_array_equal(rf.values, rl.values)
        for a in rf.group_values:
            np.testing.assert_array_equal(rf.group_values[a], rl.group_values[a])
        assert rf.canonical() == T.execute(tq, tse.db).canonical()
    assert _snapshot(tse) == _snapshot(rse)


def test_hit_batch_costs_one_fused_launch():
    rdb, tdb = _crimes(N_ROWS, 11)
    rqs = _having(R, rdb, ("district", "year"), (0.6, 0.85))
    tqs = _having(T, tdb, ("district", "year"), (0.6, 0.85))
    kw = dict(agg=("count", None))
    rqs += _having(R, rdb, ("district",), [0.6], **kw)
    tqs += _having(T, tdb, ("district",), [0.6], **kw)
    rse, tse = _engines(rdb, tdb)
    rbatch, tbatch = rqs + rqs[:2], tqs + tqs[:2]
    _batch_both(rse, tse, rbatch, tbatch, "cold")
    _batch_both(rse, tse, rbatch, tbatch, "warm")
    before = LAUNCH_COUNTS["fused_partials"]
    got = _batch_both(rse, tse, rbatch, tbatch, "hot")
    assert LAUNCH_COUNTS["fused_partials"] - before == 1
    assert all(info.reused for _, info in got)
    assert tse.last_route.fused and tse.last_route.n_queries == len(tbatch)
    before = LAUNCH_COUNTS["fused_partials"]
    _run_both(rse, tse, rqs[0], tqs[0])
    assert LAUNCH_COUNTS["fused_partials"] - before == 1


def test_stacked_pow2_quantization_keeps_one_shape_class():
    """Twin of the reference's recompile test: shard-count and registered
    sketch set changes inside one pow2 class add no stacked shape class
    (the classes the reference would compile anew)."""
    rdb, tdb = _crimes(N_ROWS, 13)
    tq3, tq4 = (_having(T, tdb, ("district", "year"), [qt])[0] for qt in (0.1, 0.15))
    seen = SHAPE_CLASSES["fused_partials"]
    seen.clear()
    _, se3 = _engines(rdb, tdb, n_shards=3)
    se3.run(tq3)
    se3.run(tq3)
    classes = set(seen)
    assert len(classes) == 1
    _, se4 = _engines(rdb, tdb, n_shards=4)
    for q in (tq3, tq3, tq4, tq4):
        se4.run(q)
        assert se4.last_route is None or se4.last_route.fused
    assert seen == classes, "a new shape class inside one pow2 bucket"
    se4.run_batch([tq3, tq4])
    warm = set(seen)
    se4.run(tq3)
    se4.run(tq4)
    se4.run_batch([tq3, tq4, tq3])
    assert seen == warm, "steady-state serving added a shape class"


def test_prune_bounds_shard_registrations():
    rdb, tdb = _crimes(N_ROWS, 17)
    years = tdb["crimes"]["year"].numpy()
    lo = int(years.min())
    rqs, tqs = [], []
    for yr in (lo, lo + 1, lo + 2):
        rqs += _having(R, rdb, ("district", "year"), [0.8], where=R.Predicate("year", ">=", float(yr)))
        tqs += _having(T, tdb, ("district", "year"), [0.8], where=T.Predicate("year", ">=", float(yr)))
    rse, tse = _engines(rdb, tdb, n_shards=3, max_registered=2)
    for rq, tq in zip(rqs, tqs):
        _run_both(rse, tse, rq, tq)
        _run_both(rse, tse, rq, tq)
    assert len(tse.engine.index) == 2 and len(tse._registered) == 2
    for shard in tse.shards:
        assert len(shard.maintainers) <= 2 and len(shard._inst) <= 2
    assert len(tse.engine.catalog._stacked) <= 2
    _, info = _run_both(rse, tse, rqs[0], tqs[0], "re-capture")
    assert info.created and not info.reused
    res, info = _run_both(rse, tse, rqs[0], tqs[0])
    assert info.reused and res.canonical() == T.execute(tqs[0], tse.db).canonical()
    assert tse.prune(1) == rse.prune(1) >= 1
    assert len(tse._registered) == 1
    for shard in tse.shards:
        assert len(shard.maintainers) <= 1
    assert _snapshot(tse) == _snapshot(rse)


def test_index_lookup_contains_remove_match_reference():
    rdb, tdb = _crimes(5_000, 2)
    rqs = _having(R, rdb, ("district",), (0.5, 0.8))
    tqs = _having(T, tdb, ("district",), (0.5, 0.8))
    rse, tse = _engines(rdb, tdb, n_shards=2)
    for rq, tq in zip(rqs, tqs):
        _run_both(rse, tse, rq, tq)
    assert [e.reg_id for e in tse.index.entries()] == [e.reg_id for e in rse.index.entries()]
    np.testing.assert_array_equal(tse.index.lookup(tqs[1]).bits, rse.index.lookup(rqs[1]).bits)
    e = tse.index.entries()[0]
    assert tse.index.contains(e) and tse.index.remove(e)
    assert not tse.index.contains(e) and not tse.index.remove(e)
