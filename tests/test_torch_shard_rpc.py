"""The port's process-boundary shards against the reference's, on the CPU.

Twins of ``tests/test_shard_rpc.py``: the same seeded data, mutations and
faults go in lockstep through ``repro.core.ShardedEngine`` and
``repro_torch.core.ShardedEngine``, both with ``transport="subprocess"``
(real shard server processes), and through the port's loopback engine.
After every op the port's subprocess results equal its loopback results and
the reference's subprocess results bit for bit, and its ``RunInfo``,
``RouteInfo``, shard health, index misses, maintained sketch bits and peer
restores equal the reference's.  Faults are real: a kill is a SIGKILL (its
pid is gone), a partition keeps the server and its state, flaky responses
go through the retries, shutdown leaves no process.

``test_frame_limit_carries_tables_across`` is the frame-limit fault of the
reference (ROADMAP C6): with the frame limit lowered to 4 KiB the
reference's subprocess build fails and its standby degrades, while the
port carries every table across in frames within the limit, builds,
attaches, takes over and serves what loopback serves.

Shard ops are timed against a deadline, so both packages' shard and retry
modules read a clock that advances only by their sleeps (the servers' own
stalls are real and bounded by the RPC deadline).
"""
import dataclasses
import os
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
from repro.core import shard_rpc as rshard_rpc
from repro.runtime import resilience as rres
from repro.runtime import transport as rtransport
from repro_torch.convert import database_from_numpy
from repro_torch.core import shard as tshard
from repro_torch.core import shard_rpc as tshard_rpc
from repro_torch.runtime import resilience as tres
from repro_torch.runtime import transport as ttransport

pytestmark = pytest.mark.slow  # spawns real shard server processes

torch.set_num_threads(1)  # small tensors; leave the cores to the other xdist workers


@pytest.fixture(scope="module", autouse=True)
def pools():
    """Both packages' server pools serve this file; no server outlives it."""
    yield
    rshard_rpc.POOL.shutdown_all()
    tshard_rpc.POOL.shutdown_all()


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


def _queries(mod, db):
    """``tests/test_shard_rpc.py``'s three queries, thresholds from ``db``."""
    base = mod.Query("crimes", ("district", "year"), mod.Aggregate("sum", "records"))
    sums = np.asarray(mod.execute(base, db).values)
    qs = [dataclasses.replace(base, having=mod.Having(">", float(np.quantile(sums, qt))))
          for qt in (0.5, 0.8)]
    byear = mod.Query("crimes", ("year",), mod.Aggregate("sum", "records"))
    qs.append(dataclasses.replace(byear, having=mod.Having(
        ">", float(np.quantile(np.asarray(mod.execute(byear, db).values), 0.6)))))
    return qs


def _rows(rng, n):
    t = rdata.make_crimes(n, seed=int(rng.integers(1 << 30)))
    return {a: np.asarray(t[a]) for a in t.schema}


@pytest.fixture(scope="module")
def crimes():
    rdb = R.Database({"crimes": rdata.make_crimes(3000, seed=2)})
    tdb = _port_db(rdb)
    return rdb, tdb, _queries(R, rdb), _queries(T, tdb)


def _engine(mod, db, n_shards=2, **kw):
    args = dict(n_ranges=16, theta=0.1, seed=0, min_selectivity_gain=2.0, transport="subprocess")
    args.update(kw)
    return mod.ShardedEngine(db, "crimes", "district", n_shards=n_shards, **args)


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False


def _same(got, want, ctx):
    assert sorted(got.group_values) == sorted(want.group_values), ctx
    for a in want.group_values:
        np.testing.assert_array_equal(np.asarray(got.group_values[a]),
                                      np.asarray(want.group_values[a]), err_msg=ctx)
    np.testing.assert_array_equal(np.asarray(got.values), np.asarray(want.values), err_msg=ctx)


def _state(se):
    """Route, health, misses, peer restores and the maintained bits of every
    group-local registration on every reachable shard."""
    r = se.last_route
    route = None if r is None else (r.contacted, r.skipped, r.watermark, r.deltas_applied,
                                    r.fused, r.degraded, r.failed_shards, r.n_retries,
                                    r.stale_checkpoints)
    bits = {}
    for key, reg in sorted(se._registered.items()):
        if not reg.group_local:
            continue
        for sid, c in enumerate(se.shards):
            if c.reachable and not c.state_lost and c.has_maintainer(key):
                bits[(key, sid)] = np.asarray(c.bits_for(key)).tobytes()
    return (route, tuple(se.health), se.index.misses, getattr(se, "peer_restores", 0),
            tuple(se.stale_checkpoints), bits)


def _info(info):
    return (info.reused, info.created, info.repaired, info.degraded, info.shards_contacted,
            info.shards_skipped)


def _run(rse, tse, rq, tq, ctx, lo=None):
    """One read on the reference's and the port's subprocess engines (and
    the port's loopback engine when given): equal results, equal to
    single-node execution, equal info and state."""
    (wres, winfo), (res, info) = rse.run(rq), tse.run(tq)
    _same(res, wres, ctx)
    assert res.canonical() == T.execute(tq, tse.db).canonical(), ctx
    assert _info(info) == _info(winfo), ctx
    assert _state(tse) == _state(rse), ctx
    if lo is not None:
        lres, linfo = lo.run(tq)
        _same(res, lres, ctx + " (loopback)")
        assert (info.reused, info.shards_contacted) == (linfo.reused, linfo.shards_contacted), ctx
    return res, info


def test_subprocess_serves_identical_to_loopback(crimes, sleep_clock):
    rdb, tdb, rqs, tqs = crimes
    rse, tse = _engine(R, rdb), _engine(T, tdb)
    lo = _engine(T, tdb, transport="loopback")
    try:
        assert [c.backend for c in tse.shards] == ["subprocess"] * 2
        assert all(c.launch_counts()["device"] == "cpu" for c in tse.shards)
        for rep in range(2):  # misses, then warm hits routed over RPC
            for i, (rq, tq) in enumerate(zip(rqs, tqs)):
                _, info = _run(rse, tse, rq, tq, f"pass {rep} q{i}", lo)
                assert not info.degraded and (info.reused or not rep)
        outs = rse.run_batch(rqs), tse.run_batch(tqs), lo.run_batch(tqs)
        for i, ((w, wi), (g, gi), (l, _)) in enumerate(zip(*outs)):
            _same(g, w, f"batch q{i}")
            _same(g, l, f"batch q{i} (loopback)")
            assert _info(gi) == _info(wi)
        assert _state(tse) == _state(rse)
        rows = _rows(np.random.default_rng(5), 200)
        for se in (rse, tse, lo):
            se.append_rows("crimes", rows)
        for i, (rq, tq) in enumerate(zip(rqs, tqs)):
            _run(rse, tse, rq, tq, f"after append q{i}", lo)
        # Both serving routes over the wire: the per-shard host loop too.
        rse.fused = tse.fused = False
        for i, (rq, tq) in enumerate(zip(rqs, tqs)):
            _run(rse, tse, rq, tq, f"host loop q{i}", lo)
    finally:
        for se in (rse, tse, lo):
            se.shutdown()


def test_kill_is_a_real_sigkill_and_recovery_respawns(crimes, sleep_clock):
    rdb, tdb, rqs, tqs = crimes
    rse, tse = _engine(R, rdb), _engine(T, tdb)
    try:
        _run(rse, tse, rqs[0], tqs[0], "capture")
        misses = tse.engine.index.misses
        pid0 = tse.shards[1].pid
        assert _pid_alive(pid0)
        for se in (rse, tse):
            se.shards[1].inject("kill")
        assert not _pid_alive(pid0) and tse.shards[1].pid is None  # a SIGKILL, not a flag
        _, info = _run(rse, tse, rqs[0], tqs[0], "degraded")
        assert info.degraded
        rows = _rows(np.random.default_rng(7), 150)
        for se in (rse, tse):
            se.append_rows("crimes", rows)  # lands in the coordinator's log
        for se in (rse, tse):
            se.shards[1].heal()
        _, info = _run(rse, tse, rqs[0], tqs[0], "healed")
        assert not info.degraded
        pid1 = tse.shards[1].pid
        assert pid1 is not None and pid1 != pid0  # a new server process
        assert tse.health[1] == "healthy" and tse.shards[1].version == tse.version
        # Recovery from the peer's mirror, replay and re-registration: no
        # re-capture.
        assert tse.peer_restores == rse.peer_restores == 1
        assert tse.engine.index.misses == misses
        _run(rse, tse, rqs[0], tqs[0], "again")
    finally:
        rse.shutdown()
        tse.shutdown()


def test_partition_drops_socket_but_keeps_server_state(crimes, sleep_clock):
    rdb, tdb, rqs, tqs = crimes
    rse, tse = _engine(R, rdb), _engine(T, tdb)
    try:
        _run(rse, tse, rqs[0], tqs[0], "capture")
        pid0 = tse.shards[0].pid
        for se in (rse, tse):
            se.shards[0].inject("partition")
        assert _pid_alive(pid0)  # the process survives a partition
        _, info = _run(rse, tse, rqs[0], tqs[0], "partitioned")
        assert info.degraded
        for se in (rse, tse):
            se.shards[0].heal()
        _, info = _run(rse, tse, rqs[0], tqs[0], "healed")
        assert not info.degraded
        assert tse.shards[0].pid == pid0 and tse.health[0] == "healthy"  # same server
        assert tse.peer_restores == 0
    finally:
        rse.shutdown()
        tse.shutdown()


def test_flaky_injects_real_rpc_errors_through_retries(crimes, sleep_clock):
    rdb, tdb, rqs, tqs = crimes
    rse, tse = _engine(R, rdb), _engine(T, tdb)
    try:
        _run(rse, tse, rqs[0], tqs[0], "capture")
        _run(rse, tse, rqs[0], tqs[0], "hit")
        for se in (rse, tse):
            se.shards[1].inject("flaky", 1)
        _, info = _run(rse, tse, rqs[0], tqs[0], "flaky")
        assert tse.last_route.n_retries >= 1 and not info.degraded  # a real RPC failed, retried
    finally:
        rse.shutdown()
        tse.shutdown()


@pytest.mark.parametrize("n_shards, seed", [(2, 1), (3, 2)])
def test_chaos_differential_subprocess_vs_fused_smoke(crimes, sleep_clock, n_shards, seed):
    """Seeded replays over subprocess shards under real kills, stalls and
    socket drops against fault-free in-process fused serving, in both
    packages: each package's chaotic trace equals its clean trace, the
    port's equals the reference's, and so do route, health and misses
    after every op."""
    rdb, tdb, rqs, tqs = crimes
    dbs = {R: rdb, T: tdb}
    traces, states = {}, {}
    # The clock decides the op deadline's demotions; the deadline's other
    # use is the RPC's own timeout (twice it), which must not fire on a
    # loaded machine in one package and not the other.
    deadline = 5.0
    for mod, rt, qs in ((R, RR, rqs), (T, TR, tqs)):
        ops = rt.random_ops(seed, 10, qs, _rows)
        events = rt.random_schedule(seed + 50, 10, n_shards)
        ok, chaotic, clean = rt.differential(
            lambda: _engine(mod, dbs[mod], n_shards, op_deadline_s=deadline), "crimes", ops,
            events, make_clean=lambda: _engine(mod, dbs[mod], n_shards, transport="loopback"))
        assert ok, f"{mod.__name__} n_shards={n_shards} seed={seed}: diverged"
        traces[mod] = chaotic
        se = _engine(mod, dbs[mod], n_shards, op_deadline_s=deadline)
        seen = []
        harness = rt.ChaosHarness(events)

        def on_step(step, se=se, seen=seen, harness=harness):
            if step:
                seen.append(_state(se)[:5])
            harness.apply_events(se, step)

        try:
            rt.run_ops(se, "crimes", ops, on_step=on_step)
            seen.append(_state(se)[:5])
        finally:
            se.shutdown()
        states[mod] = seen
    assert traces[T] == traces[R]
    for i, (got, want) in enumerate(zip(states[T], states[R])):
        assert got == want, f"after op {i}: {got} != {want}"


def test_shutdown_releases_processes(crimes):
    rdb, tdb, rqs, tqs = crimes
    seen = []
    for mod, shard_rpc, db, q in ((R, rshard_rpc, rdb, rqs[0]), (T, tshard_rpc, tdb, tqs[0])):
        se = _engine(mod, db)
        pids = [s.pid for s in se.shards]
        se.run(q)
        se.shutdown()
        se.shutdown()  # a second shutdown is a no-op
        # The servers went back to the warm pool, alive and reset.
        pooled = {sp.proc.pid for sp in shard_rpc.POOL._spares}
        assert set(pids) <= pooled and all(_pid_alive(p) for p in pids)
        se2 = _engine(mod, db)
        pid = se2.shards[0].pid
        se2.shards[0].inject("kill")
        se2.shutdown()
        assert not _pid_alive(pid)
        seen += pids + [s.pid for s in se2.shards if s.pid is not None]
        shard_rpc.POOL.shutdown_all()
        seen += [sp.proc.pid for sp in shard_rpc.POOL._all]
    assert seen and all(not _pid_alive(p) for p in seen)  # no process is left


FRAME_CAP = 4096


def test_frame_limit_carries_tables_across(crimes, monkeypatch):
    """ROADMAP C6 at a 4 KiB frame limit.  The reference ships the whole
    clustered table as one frame at a subprocess build (refused:
    ``ShardUnavailableError``) and at a standby's bootstrap (refused and
    swallowed: ``replica_degraded``).  The port, with the same limit in the
    coordinator, every shard server and the standby, carries each table in
    frames within the limit (a server or the coordinator would refuse any
    frame over it), builds, attaches, takes over and serves what loopback
    serves, and its replica never degrades."""
    rdb, tdb, rqs, tqs = crimes
    monkeypatch.setattr(rtransport.send_msg, "__defaults__", (None, FRAME_CAP))
    monkeypatch.setattr(rtransport.recv_msg, "__defaults__", (None, FRAME_CAP))
    with pytest.raises(R.ShardUnavailableError):
        _engine(R, rdb)
    rse = _engine(R, rdb, transport="loopback")
    replica = R.SubprocessReplica()
    try:
        rse.attach_replica(replica)
        assert rse.replica_degraded
    finally:
        replica.close_replica()

    monkeypatch.setattr(ttransport, "MAX_FRAME_BYTES", FRAME_CAP)
    monkeypatch.setenv("REPRO_RPC_MAX_FRAME_BYTES", str(FRAME_CAP))
    pool = tshard_rpc.ServerPool(spares=0)
    monkeypatch.setattr(tshard_rpc, "POOL", pool)
    sent = []
    real_send = ttransport.send_msg

    def send_msg(sock, obj, seq, deadline_s=None, **kw):
        sent.append(sum(len(p) for p in ttransport.encode_message(obj)))
        return real_send(sock, obj, seq, deadline_s=deadline_s, **kw)

    monkeypatch.setattr(ttransport, "send_msg", send_msg)
    fc = None
    try:
        pool.prewarm(2)
        tse = _engine(T, tdb)
        lo = _engine(T, tdb, transport="loopback")
        fc = T.FailoverCoordinator(tse, make_replica=T.SubprocessReplica)
        assert not tse.replica_degraded
        assert max(sent) > 25 * FRAME_CAP  # a table crossed, in frames
        for rep in range(2):
            for q in tqs:
                _same(fc.run(q)[0], lo.run(q)[0], f"pass {rep}")
        rows = _rows(np.random.default_rng(3), 300)
        fc.append_rows("crimes", rows)
        lo.append_rows("crimes", rows)
        misses = None
        for kind in ("coord_kill", "coord_partition"):
            fc.inject_coord(kind)
            assert not fc.engine.replica_degraded
            misses = fc.index.misses
            for q in tqs:
                res, info = fc.run(q)
                _same(res, lo.run(q)[0], kind)
                assert info.reused
            assert fc.index.misses == misses
        with pytest.raises(T.StaleEpochError):
            fc.zombie.shards[0].catch_up(fc.zombie.version)
        assert fc.takeovers == 2 and fc.engine.epoch == 2
    finally:
        if fc is not None:
            fc.shutdown()
        pool.close_pool()
