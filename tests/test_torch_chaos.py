"""The port's chaos-tolerant sharded serving against the reference's, on the
CPU.

Twins of ``tests/test_chaos.py``: the same seeded data, mutations and fault
injections go through ``repro.core.ShardedEngine`` and
``repro_torch.core.ShardedEngine`` in lockstep, and each read must give the
reference's result bit for bit (equal, inside the integral envelope, to
single-node execution of the current version), the reference's
``RunInfo`` and ``RouteInfo`` (``degraded``, ``failed_shards``,
``n_retries``), the reference's shard health and the same index misses
(recovery and rebalance never re-capture).  In the straggler test both
packages' shard and retry modules read a clock that advances only by their
sleeps, so an op's duration is its injected stall and the demotions are the
reference's whatever the machine's load.  The seeded differentials are in ``test_torch_chaos_differential.py``, and
the single-overflow backpressure twin in ``test_torch_shard.py``.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

import repro.core as R
import repro.runtime as RR
import repro_torch.core as T
import repro_torch.runtime as TR
from repro.core import datasets as rdata
from repro.core import shard as rshard
from repro.runtime import resilience as rres
from repro_torch.convert import database_from_numpy
from repro_torch.core import shard as tshard
from repro_torch.runtime import resilience as tres

torch.set_num_threads(1)  # small tensors; leave the cores to the other xdist workers


@pytest.fixture
def sleep_clock(monkeypatch):
    """Each package's shard and retry modules get a clock of their own that
    advances only when they sleep."""
    for mods in ((rshard, rres), (tshard, tres)):
        clock = {"t": 0.0}

        def sleep(s, clock=clock):
            clock["t"] += max(float(s), 0.0)

        fake = types.SimpleNamespace(perf_counter=lambda clock=clock: clock["t"], sleep=sleep)
        for mod in mods:
            monkeypatch.setattr(mod, "time", fake)


def _port_db(rdb):
    return database_from_numpy(
        [(n, {a: np.asarray(rdb[n][a]) for a in rdb[n].schema}, rdb[n].primary_key)
         for n in rdb.names], device="cpu")


def _crimes(n, seed):
    rdb = R.Database({"crimes": rdata.make_crimes(n, seed=seed)})
    return rdb, _port_db(rdb)


def _crimes_queries(mod, db):
    """``tests/test_chaos.py``'s three queries, thresholds from ``db``."""
    base = mod.Query("crimes", ("district", "year"), mod.Aggregate("sum", "records"))
    sums = np.asarray(mod.execute(base, db).values)
    qs = [dataclasses.replace(base, having=mod.Having(">", float(np.quantile(sums, qt))))
          for qt in (0.5, 0.8)]
    byear = mod.Query("crimes", ("year",), mod.Aggregate("sum", "records"))
    qs.append(dataclasses.replace(byear, having=mod.Having(
        ">", float(np.quantile(np.asarray(mod.execute(byear, db).values), 0.6)))))
    return qs


def _crimes_rows(rng, n):
    t = rdata.make_crimes(n, seed=int(rng.integers(1 << 30)))
    return {a: np.asarray(t[a]) for a in t.schema}


def _engines(rdb, tdb, n_shards=3, **kw):
    args = dict(n_ranges=16, theta=0.1, seed=0, min_selectivity_gain=2.0, **kw)
    return (R.ShardedEngine(rdb, "crimes", "district", n_shards=n_shards, **args),
            T.ShardedEngine(tdb, "crimes", "district", n_shards=n_shards, **args))


def _both(fn, rse, tse):
    """``fn`` on the reference's engine, then on the port's."""
    return fn(rse), fn(tse)


def _same_result(got, want, ctx):
    assert sorted(got.group_values) == sorted(want.group_values), ctx
    for a in want.group_values:
        np.testing.assert_array_equal(np.asarray(got.group_values[a]),
                                      np.asarray(want.group_values[a]), err_msg=ctx)
    np.testing.assert_array_equal(np.asarray(got.values), np.asarray(want.values), err_msg=ctx)


def _route(se):
    r = se.last_route
    return None if r is None else (r.contacted, r.skipped, r.watermark, r.deltas_applied,
                                   r.fused, r.degraded, r.failed_shards, r.n_retries,
                                   r.stale_checkpoints)


def _serve(rse, tse, rq, tq, ctx=""):
    """One read on both engines: the port's result equals the reference's
    bit for bit and single-node execution, and its ``RunInfo``,
    ``RouteInfo``, health and index misses equal the reference's."""
    (wres, winfo), (res, info) = rse.run(rq), tse.run(tq)
    _same_result(res, wres, ctx)
    assert res.canonical() == T.execute(tq, tse.db).canonical(), ctx
    assert (info.reused, info.created, info.repaired, info.degraded, info.shards_contacted,
            info.shards_skipped) == (winfo.reused, winfo.created, winfo.repaired,
                                     winfo.degraded, winfo.shards_contacted,
                                     winfo.shards_skipped), ctx
    assert _route(tse) == _route(rse), ctx
    assert tse.health == rse.health, ctx
    assert tse.index.misses == rse.index.misses, ctx
    return res, info


def test_kill_degraded_serve_recover():
    """Kill -> degraded serving -> mutation while down -> heal -> recovery by
    checkpoint adopt and delta replay, with no exception and no re-capture."""
    rdb, tdb = _crimes(4000, 2)
    rq, tq = _crimes_queries(R, rdb)[0], _crimes_queries(T, tdb)[0]
    rse, tse = _engines(rdb, tdb)
    _serve(rse, tse, rq, tq, "capture")

    _both(lambda se: se.shards[1].inject("kill"), rse, tse)
    res, info = _serve(rse, tse, rq, tq, "killed")
    assert info.reused and info.degraded and tse.last_route.degraded
    assert 1 in tse.last_route.failed_shards and tse.health[1] in ("suspect", "dead")

    rows = _crimes_rows(np.random.default_rng(7), 300)
    _both(lambda se: se.append_rows("crimes", rows), rse, tse)
    res, info = _serve(rse, tse, rq, tq, "append while down")
    assert info.degraded

    misses = tse.index.misses
    _both(lambda se: se.shards[1].heal(), rse, tse)
    res, info = _serve(rse, tse, rq, tq, "recovered")
    assert tse.health[1] == "healthy" and not info.degraded and not tse.last_route.degraded
    assert tse.shards[1].version == tse.version
    assert tse.index.misses == misses  # recovery never re-captures
    res, info = _serve(rse, tse, rq, tq, "after recovery")
    assert not info.degraded
    assert sorted(tse.shards[1].maintainers) == sorted(rse.shards[1].maintainers)
    for key, m in tse.shards[1].maintainers.items():
        np.testing.assert_array_equal(m.bits(), rse.shards[1].maintainers[key].bits())


def test_partition_keeps_state_and_flaky_retries():
    rdb, tdb = _crimes(4000, 3)
    rq, tq = _crimes_queries(R, rdb)[0], _crimes_queries(T, tdb)[0]
    rse, tse = _engines(rdb, tdb)
    _serve(rse, tse, rq, tq, "capture")
    _both(lambda se: se.shards[0].inject("partition"), rse, tse)
    state = tse.shards[0].table
    res, info = _serve(rse, tse, rq, tq, "partitioned")
    assert info.degraded and tse.shards[0].table is state  # state intact
    _both(lambda se: se.shards[0].heal(), rse, tse)
    res, info = _serve(rse, tse, rq, tq, "healed")
    assert tse.health[0] == "healthy" and not info.degraded
    # One dropped op, absorbed by the retry wrapper without degrading.
    _both(lambda se: se.shards[2].inject("flaky", 1), rse, tse)
    res, info = _serve(rse, tse, rq, tq, "flaky")
    assert tse.last_route.n_retries >= 1 and not info.degraded


def test_stall_past_deadline_routes_around_straggler(sleep_clock):
    """A stalled shard past the deadline is demoted once its ops' timing
    baselines have formed, served around, and promoted once healed."""
    rdb, tdb = _crimes(4000, 4)
    rq, tq = _crimes_queries(R, rdb)[0], _crimes_queries(T, tdb)[0]
    rse, tse = _engines(rdb, tdb, op_deadline_s=0.002)
    for i in range(10):  # form the per-op timing baselines
        _serve(rse, tse, rq, tq, f"warm {i}")
    _both(lambda se: se.shards[1].inject("stall", 0.05), rse, tse)
    _serve(rse, tse, rq, tq, "stalled catch_up")
    res, info = _serve(rse, tse, rq, tq, "routed around")
    assert tse.health[1] == "suspect"
    assert info.degraded and 1 in tse.last_route.failed_shards
    _both(lambda se: se.shards[1].heal(), rse, tse)
    res, info = _serve(rse, tse, rq, tq, "healed")
    assert tse.health[1] == "healthy" and not info.degraded


def test_rebalance_moves_dead_shards_fragments():
    rdb, tdb = _crimes(4000, 5)
    rqs, tqs = _crimes_queries(R, rdb), _crimes_queries(T, tdb)
    rse, tse = _engines(rdb, tdb)
    for rq, tq in zip(rqs, tqs):
        _serve(rse, tse, rq, tq, "capture")
    _both(lambda se: se.shards[2].inject("kill"), rse, tse)
    for i in range(2):  # two failed contacts: suspect, then dead
        _serve(rse, tse, rqs[0], tqs[0], f"contact {i}")
    assert tse.health[2] == "dead"

    misses = tse.index.misses
    rebuilt, want = tse.rebalance(), rse.rebalance()
    assert rebuilt == want and set(rebuilt) <= {0, 1} and rebuilt
    np.testing.assert_array_equal(tse.plan.owner, rse.plan.owner)
    assert not (tse.plan.owner == 2).any()
    np.testing.assert_array_equal(tse._row_shard, rse._row_shard)
    np.testing.assert_array_equal(tse._row_local, rse._row_local)
    for rq, tq in zip(rqs, tqs):
        res, info = _serve(rse, tse, rq, tq, "re-placed")
        assert not info.degraded  # a fully re-placed cluster serves clean
    assert tse.index.misses == misses  # rebalance never re-captures
    rows = _crimes_rows(np.random.default_rng(11), 200)
    _both(lambda se: se.append_rows("crimes", rows), rse, tse)
    mask = np.random.default_rng(12).random(tse.db["crimes"].num_rows) < 0.05
    _both(lambda se: se.delete_rows("crimes", mask), rse, tse)
    np.testing.assert_array_equal(tse._row_shard, rse._row_shard)
    for rq, tq in zip(rqs, tqs):
        _serve(rse, tse, rq, tq, "after mutations")
    _both(lambda se: se.shards[2].heal(), rse, tse)  # rejoins owning nothing
    _serve(rse, tse, rqs[0], tqs[0], "rejoined")
    assert tse.health[2] == "healthy"


def test_sustained_backpressure_log_bounded_and_drains_bit_identical():
    rdb, tdb = _crimes(3000, 16)
    rq, tq = _crimes_queries(R, rdb)[0], _crimes_queries(T, tdb)[0]
    cap, n_batches = 2, 20
    rse, tse = _engines(rdb, tdb, 2, inbox_cap=cap)
    _serve(rse, tse, rq, tq, "capture")
    rng = np.random.default_rng(21)
    for _ in range(n_batches):
        rows = _crimes_rows(rng, 40)
        _both(lambda se: se.append_rows("crimes", rows), rse, tse)
    assert all(s.lag <= cap for s in tse.shards)
    assert [s.backpressure_hits for s in tse.shards] == [s.backpressure_hits for s in rse.shards]
    assert all(s.backpressure_hits >= n_batches - cap for s in tse.shards)
    assert all(len(log) == n_batches for log in tse._log)  # the un-checkpointed suffix
    res, info = _serve(rse, tse, rq, tq, "drain")
    assert not info.degraded and tse.min_watermark() == tse.version
    assert all(len(log) == 0 for log in tse._log)
    for wave in range(3):
        for _ in range(5):
            rows = _crimes_rows(rng, 40)
            _both(lambda se: se.append_rows("crimes", rows), rse, tse)
        assert all(len(log) <= 5 for log in tse._log)
        _serve(rse, tse, rq, tq, f"wave {wave}")
        assert all(len(log) == 0 for log in tse._log)


def test_sharded_coordinator_selection_state_roundtrip():
    """The coordinator keeps one reuse-aware selection state (shards hold
    none); a replacement coordinator restores it."""
    rdb, tdb = _crimes(2000, 17)
    rq, tq = _crimes_queries(R, rdb)[0], _crimes_queries(T, tdb)[0]
    rse, tse = _engines(rdb, tdb, 2)
    _serve(rse, tse, rq, tq, "one miss")
    state, rstate = tse.selection_state(), rse.selection_state()
    assert state["workload"]["clock"] == rstate["workload"]["clock"] == tse.engine.workload.clock >= 1
    assert state["selection_cache"] == rstate["selection_cache"]
    _, tse2 = _engines(rdb, tdb, 2)
    tse2.restore_selection_state(state)
    assert tse2.engine.workload.clock == tse.engine.workload.clock
    assert ([(s, repr(p.signature())) for s, p in tse2.engine.workload.entries()]
            == [(s, repr(p.signature())) for s, p in tse.engine.workload.entries()])
    assert tse2.engine.selection_cache.misses == tse.engine.selection_cache.misses


@pytest.mark.parametrize("coord_rate", [0.0, 0.2])
def test_random_schedule_is_deterministic_heals_and_matches_reference(coord_rate):
    for seed, n_steps, n_shards in ((42, 30, 4), (0, 14, 1), (7, 50, 3), (53, 14, 4)):
        ev = TR.random_schedule(seed, n_steps, n_shards, coord_rate=coord_rate)
        assert ev == TR.random_schedule(seed, n_steps, n_shards, coord_rate=coord_rate)
        want = RR.random_schedule(seed, n_steps, n_shards, coord_rate=coord_rate)
        assert [dataclasses.astuple(e) for e in ev] == [dataclasses.astuple(e) for e in want]
        state = {}
        for e in ev:
            if e.kind == "heal":
                state.pop(e.shard, None)
            elif e.kind in ("kill", "stall", "partition"):
                state[e.shard] = e.kind
        assert state == {}  # every persistent fault is healed by the end
        assert all(e.shard == TR.COORD for e in ev if e.kind in TR.COORD_FAULT_KINDS)


def test_random_ops_match_reference():
    rdb, tdb = _crimes(2000, 1)
    rqs, tqs = _crimes_queries(R, rdb), _crimes_queries(T, tdb)
    for seed in (0, 1, 21):
        t_ops = TR.random_ops(seed, 20, tqs, _crimes_rows)
        r_ops = RR.random_ops(seed, 20, rqs, _crimes_rows)
        assert [k for k, _ in t_ops] == [k for k, _ in r_ops]
        for (kind, tp), (_, rp) in zip(t_ops, r_ops):
            if kind == "query":
                assert tqs.index(tp) == rqs.index(rp)
            elif kind == "batch":
                assert [tqs.index(q) for q in tp] == [rqs.index(q) for q in rp]
            elif kind == "append":
                assert sorted(tp) == sorted(rp)
                for a in tp:
                    np.testing.assert_array_equal(tp[a], rp[a])
            else:
                assert tp == rp


def test_harness_replays_events_at_steps():
    rdb, tdb = _crimes(2000, 9)
    rq, tq = _crimes_queries(R, rdb)[0], _crimes_queries(T, tdb)[0]
    rse, tse = _engines(rdb, tdb, 2)
    _serve(rse, tse, rq, tq, "capture")
    events = [(1, 0, "kill"), (2, 0, "heal")]
    trace = TR.ChaosHarness([TR.ChaosEvent(*e) for e in events]).run(
        tse, "crimes", [("query", tq)] * 4)
    want = RR.ChaosHarness([RR.ChaosEvent(*e) for e in events]).run(
        rse, "crimes", [("query", rq)] * 4)
    assert trace == want and len(trace) == 4 and len(set(map(str, trace))) == 1
    assert tse.health == rse.health == ["healthy", "healthy"]
    # The differential itself: a kill and heal change no result.
    ok, chaotic, clean = TR.differential(
        lambda: _engines(rdb, tdb, 2)[1], "crimes",
        [("query", tq)] * 3 + [("append", _crimes_rows(np.random.default_rng(3), 50)),
                               ("delete", (5, 0.02)), ("query", tq)],
        [TR.ChaosEvent(1, 1, "kill"), TR.ChaosEvent(4, 1, "heal")])
    assert ok and chaotic == clean


def test_checkpoints_survive_every_mutation():
    """A loopback checkpoint is a reference to the shard's table, so no table
    or catalog method may write a tensor in place: after appends, deletes,
    a chain collapse and re-reads, each checkpoint's columns hold the bits
    they held when it was taken, and recovery from one equals the
    reference's."""
    rdb, tdb = _crimes(4000, 8)
    rq = _crimes_queries(R, rdb)[1]
    tq = _crimes_queries(T, tdb)[1]
    rse, tse = _engines(rdb, tdb, 2)
    _serve(rse, tse, rq, tq, "capture")
    rng = np.random.default_rng(4)
    taken = []
    for step in range(3):  # 18 deltas, past MAX_DELTA_CHAIN: the shards collapse
        ckpt = tse._ckpt[0]
        taken.append((ckpt, {a: ckpt.table[a].clone() for a in ckpt.table.schema}))
        for _ in range(3):
            rows = _crimes_rows(rng, 300)
            _both(lambda se: se.append_rows("crimes", rows), rse, tse)
            mask = rng.random(tse.db["crimes"].num_rows) < 0.01
            _both(lambda se: se.delete_rows("crimes", mask), rse, tse)
        _serve(rse, tse, rq, tq, f"step {step}")
    assert tse.shards[0].table.delta_depth() == 0  # collapsed
    for ckpt, cols in taken:
        assert all(torch.equal(ckpt.table[a], v) for a, v in cols.items())
    rows = _crimes_rows(np.random.default_rng(5), 300)
    for se in (rse, tse):
        se.shards[0].inject("kill")
        se.append_rows("crimes", rows)
        se.shards[0].heal()
    misses = tse.index.misses
    res, info = _serve(rse, tse, rq, tq, "recovered")
    assert not info.degraded and tse.index.misses == misses


def test_epoch_fence_refuses_a_superseded_coordinator():
    """A coordinator's epoch is stamped on the shards by its first ops; a
    client of a lower epoch is then refused (``StaleEpochError``, never
    retried), an unreachable shard neither learns nor checks the epoch, and
    a rebuilt shard keeps it, in both packages alike."""
    rdb, tdb = _crimes(2000, 6)
    rq, tq = _crimes_queries(R, rdb)[0], _crimes_queries(T, tdb)[0]
    rse, tse = _engines(rdb, tdb, 2, epoch=3)
    _serve(rse, tse, rq, tq, "stamps the epoch")
    for se, mod in ((rse, R), (tse, T)):
        assert [c._shard.epoch for c in se.shards] == [3, 3]
        zombie = type(se.shards[0])(se.shards[0]._shard)  # a client of epoch 0
        with pytest.raises(mod.StaleEpochError):
            zombie.catch_up(se.version)
        with pytest.raises(mod.StaleEpochError):
            zombie.ship(se.version + 1, "append", {})
        assert se.shards[0].lag == 0
        se.shards[0].inject("partition")
        with pytest.raises(mod.ShardUnavailableError):
            zombie.catch_up(se.version)
        se.shards[0].heal()
        se.shards[1].inject("kill")
        assert se.rebalance([1]) == [0]
        assert se.shards[0]._shard.epoch == 3
    _serve(rse, tse, rq, tq, "after the rebalance")
