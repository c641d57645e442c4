"""The port's ``PBDSEngine.run`` against the reference's, end to end: a
seeded CB-OPT-GB workload of Q-AGH and Q-AAGH queries replayed on both
engines must give equal canonical results, equal ``RunInfo``
created/reused/attr, equal sketch bits and equal index contents (both
engines sum float32 in row order on the CPU, so results are bit-equal)."""
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import datasets as rdata
from repro.core.workload import CRIMES_SPEC as R_SPEC, generate_workload as r_generate
import repro_torch.core as T
from repro_torch.convert import sketch_from_numpy
from repro_torch.core import datasets as tdata
from repro_torch.core.table import PAD_VALID
from repro_torch.core.workload import CRIMES_SPEC as T_SPEC, generate_workload as t_generate

torch.set_num_threads(1)  # small tensors; leave the cores to the other xdist workers

N_ROWS = 12_000


@pytest.fixture(scope="module")
def dbs():
    return (R.Database({"crimes": rdata.make_crimes(N_ROWS, seed=31)}),
            T.Database({"crimes": tdata.make_crimes(N_ROWS, seed=31, device="cpu")}))


def _nested(mod, db_res_values):
    """Two Q-AAGH queries with data-calibrated thresholds."""
    tau = float(np.quantile(db_res_values, 0.6))
    return [
        mod.Query("crimes", ("district", "year"), mod.Aggregate("sum", "records"),
                  having=mod.Having(">", tau), outer_groupby=("district",),
                  outer_agg=mod.Aggregate("count"), outer_having=mod.Having(">", 2)),
        mod.Query("crimes", ("district", "year"), mod.Aggregate("sum", "records"),
                  having=mod.Having(">", tau * 1.2), outer_groupby=("district",),
                  outer_agg=mod.Aggregate("count"), outer_having=mod.Having(">", 2)),
    ]


@pytest.fixture(scope="module")
def workloads(dbs):
    rdb, tdb = dbs
    rq = r_generate(R_SPEC, rdb, 10, seed=4)
    tq = t_generate(T_SPEC, tdb, 10, seed=4)
    base = R.execute(R.Query("crimes", ("district", "year"), R.Aggregate("sum", "records")),
                     rdb).values
    return rq + _nested(R, base), tq + _nested(T, base)


def test_generated_workloads_match(workloads):
    rq, tq = workloads
    assert [q.signature() for q in tq] == [q.signature() for q in rq]
    assert {q.template for q in tq} == {"Q-AGH", "Q-AAGH"}


def _index_contents(index):
    return sorted(
        (repr(e.query.signature()), e.sketch.attr, e.sketch.bits.tolist(), e.sketch.size_rows,
         e.sketch.total_rows, e.uses, e.last_hit)
        for e in index.entries())


def _selection_state(eng):
    state = eng.selection_state()
    wl = state["workload"]
    return (state["selection_cache"], wl["window"], wl["clock"],
            [(stamp, q.signature()) for stamp, q in wl["entries"]])


@pytest.mark.parametrize("strategy", ["CB-OPT-GB", "OPT", "NO-PS"])
def test_workload_replay_matches_reference(dbs, workloads, strategy):
    rdb, tdb = dbs
    rq, tq = workloads
    reng = R.PBDSEngine(rdb, strategy=strategy, seed=9)
    teng = T.PBDSEngine(tdb, strategy=strategy, seed=9)
    created = reused = 0
    for _ in range(2):
        for q1, q2 in zip(rq, tq):
            r_res, r_info = reng.run(q1)
            t_res, t_info = teng.run(q2)
            assert t_res.canonical() == r_res.canonical(), q1
            assert (t_info.created, t_info.reused, t_info.attr, t_info.selectivity) == (
                r_info.created, r_info.reused, r_info.attr, r_info.selectivity), q1
            created += t_info.created
            reused += t_info.reused
    assert _index_contents(teng.index) == _index_contents(reng.index)
    assert (teng.index.hits, teng.index.misses) == (reng.index.hits, reng.index.misses)
    assert _selection_state(teng) == _selection_state(reng)
    if strategy != "NO-PS":
        assert created >= 1 and reused >= 1
    # Every served result is the full-table result (Def. 4, extensionally).
    for q in tq:
        assert teng.run(q)[0].canonical() == T.execute(q, tdb).canonical()


def test_selection_state_round_trips(dbs, workloads):
    _, tdb = dbs
    _, tq = workloads
    eng = T.PBDSEngine(tdb, seed=9)
    for q in tq[:4]:
        eng.run(q)
    state = eng.selection_state()
    fresh = T.PBDSEngine(tdb, seed=9)
    fresh.restore_selection_state(state)
    assert fresh.selection_state() == state
    assert fresh.workload.reach(tq[0]) == eng.workload.reach(tq[0])


def test_reference_sketch_applies_in_the_port(dbs, workloads):
    """A sketch captured by the reference, carried over as numpy, selects the
    same instance rows and gives the same result in the port."""
    rdb, tdb = dbs
    rq, tq = workloads
    q1, q2 = rq[0], tq[0]
    ranges = R.equi_depth_ranges(rdb["crimes"], q1.groupby[0], 100)
    rsk = R.capture_sketch(q1, rdb, ranges, catalog=R.Catalog())
    tsk = sketch_from_numpy(tdb["crimes"], rsk.attr, rsk.ranges.bounds, rsk.bits,
                            rsk.size_rows, rsk.total_rows)
    rcat, tcat = R.Catalog(), T.Catalog()
    rinst = R.apply_sketch(rsk, rdb, catalog=rcat)["crimes"]
    tinst = T.apply_sketch(tsk, tdb, catalog=tcat)["crimes"]
    for a in rinst.schema:
        np.testing.assert_array_equal(tinst[a].numpy(), np.asarray(rinst[a]))
    assert (T.execute_with_sketch(q2, tdb, tsk, catalog=tcat).canonical()
            == R.execute_with_sketch(q1, rdb, rsk, catalog=rcat).canonical())
    assert T.is_safe_sketch(q2, tdb, tsk)
    with pytest.raises(ValueError):
        sketch_from_numpy(tdb["crimes"], rsk.attr, rsk.ranges.bounds, rsk.bits[:-1],
                          rsk.size_rows, rsk.total_rows)



@pytest.mark.parametrize("attr", ["district", "year", "beat"])
def test_unclustered_instance_matches_reference(dbs, attr):
    """The mask branch's instance (kept rows compacted on the device in the
    port): sketches captured by each package on the same data have equal
    bits, and their instances equal source rows, pow2 padding and columns."""
    from repro.core import sketch as rsketch
    from repro_torch.core import sketch as tsketch

    rdb, tdb = dbs
    # The top tenth of the attribute's groups: a selective sketch on it.
    tau = float(np.quantile(R.execute(R.Query("crimes", (attr,), R.Aggregate("sum", "records")),
                                      rdb).values, 0.9))
    rq, tq = (mod.Query("crimes", (attr,), mod.Aggregate("sum", "records"),
                        having=mod.Having(">", tau)) for mod in (R, T))
    rsk = R.capture_sketch(rq, rdb, R.equi_depth_ranges(rdb["crimes"], attr, 100),
                           catalog=R.Catalog())
    tsk = T.capture_sketch(tq, tdb, T.equi_depth_ranges(tdb["crimes"], attr, 100),
                           catalog=T.Catalog())
    np.testing.assert_array_equal(tsk.bits, rsk.bits)
    assert 0 < tsk.size_rows < N_ROWS
    tcat = T.Catalog()
    rinst, rrows = rsketch._build_instance(rsk, rdb["crimes"], R.Catalog())
    tinst, trows = tsketch._build_instance(tsk, tdb["crimes"], tcat)
    assert tcat.stats["instance_mask"] == 1
    np.testing.assert_array_equal(trows, rrows)
    assert trows.dtype == np.int64
    assert set(tinst.schema) == set(rinst.schema)
    for a in rinst.schema:
        np.testing.assert_array_equal(tinst[a].numpy(), np.asarray(rinst[a]))
    rapplied = R.apply_sketch(rsk, rdb, catalog=R.Catalog())["crimes"]
    tapplied = T.apply_sketch(tsk, tdb, catalog=T.Catalog())["crimes"]
    for a in rapplied.schema:
        np.testing.assert_array_equal(tapplied[a].numpy(), np.asarray(rapplied[a]))


def test_mask_branch_does_not_compact_on_the_host(dbs, workloads, monkeypatch):
    """``_build_instance``'s mask branch takes its rows from the kernel's
    compaction: no ``np.nonzero`` runs over an n-row mask on the host."""
    _, tdb = dbs
    _, tq = workloads
    table = tdb["crimes"]
    tsk = T.capture_sketch(tq[0], tdb, T.equi_depth_ranges(table, "year", 100),
                           catalog=T.Catalog())
    real = np.nonzero

    def guarded(a):
        if np.size(a) == table.num_rows:
            raise AssertionError("np.nonzero over an n-row mask")
        return real(a)

    monkeypatch.setattr(np, "nonzero", guarded)
    cat = T.Catalog()
    inst = T.apply_sketch(tsk, tdb, catalog=cat)["crimes"]
    assert cat.stats["instance_mask"] == 1
    monkeypatch.setattr(np, "nonzero", real)
    keep = T.sketch_keep_mask(tsk, table, catalog=cat)
    assert inst.num_rows == 1 << (int(keep.sum()) - 1).bit_length()
    assert int(inst[PAD_VALID].sum()) == int(keep.sum())


def test_random_strategies_and_shard_faults_run(dbs, workloads):
    """Paths once deferred to later slices now run: the random strategies in
    ``run`` and ``run_batch``, and a shard kill and a rebalance in the
    sharded engine.  Subprocess shards still refuse, naming their slice
    (ROADMAP A6)."""
    _, tdb = dbs
    _, tq = workloads
    rand = T.PBDSEngine(tdb, strategy="RAND-GB")
    res, info = rand.run(tq[0])
    assert res.canonical() == T.execute(tq[0], tdb).canonical()
    assert info.attr is None or info.attr in tq[0].groupby
    assert [r.canonical() for r, _ in rand.run_batch(tq[:2])] == [
        T.execute(q, tdb).canonical() for q in tq[:2]]
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        T.ShardedEngine(tdb, "crimes", "district", n_shards=2, transport="subprocess")
    se = T.ShardedEngine(tdb, "crimes", "district", n_shards=2)
    se.shards[0].inject("kill")
    assert se.shards[0].state_lost and not se.shards[0].reachable
    assert se.rebalance([0]) == [1] and not (se.plan.owner == 0).any()
    res, _ = se.run(tq[0])
    assert res.canonical() == T.execute(tq[0], tdb).canonical()


def test_engine_runs_on_its_tables_device(dbs):
    _, tdb = dbs
    assert T.PBDSEngine(tdb).device.type == "cpu"
