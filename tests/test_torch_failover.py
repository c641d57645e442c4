"""The port's coordinator failover against the reference's, on the CPU.

Twins of ``tests/test_failover.py`` (the coordinator-fault chaos tests
included; the one over subprocess shards and the TPC-H templates is in
``test_torch_failover_chaos.py``): the same seeded data, mutations, shard faults and coordinator
faults go in lockstep through ``repro.core`` and ``repro_torch.core``
(``FailoverCoordinator`` around a ``ShardedEngine``, loopback or subprocess
shards, an in-process or a subprocess standby).  After every op the port's
results equal the reference's bit for bit and single-node execution, and
its ``RunInfo``, ``RouteInfo``, shard health, index misses, epochs,
takeovers, peer restores and stale checkpoints equal the reference's.  A
takeover keeps every hit a hit (no re-capture), a partitioned coordinator is
fenced by ``StaleEpochError`` at the shard, a replication gap is caught, a
lost replica degrades replication and not serving, and the server pool
survives a respawn storm and the top-up racing shutdown without orphans.

Shard ops are timed against a deadline, so both packages' shard and retry
modules read a clock that advances only by their sleeps.
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
from repro_torch.convert import database_from_numpy
from repro_torch.core import shard as tshard
from repro_torch.core import shard_rpc as tshard_rpc
from repro_torch.runtime import resilience as tres

pytestmark = pytest.mark.slow  # spawns real shard server and standby processes

torch.set_num_threads(1)  # small tensors; leave the cores to the other xdist workers

PKGS = ((R, RR, rshard_rpc), (T, TR, tshard_rpc))


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


def _crimes_queries(mod, db):
    """``tests/test_failover.py``'s three queries, thresholds from ``db``."""
    base = mod.Query("crimes", ("district", "year"), mod.Aggregate("sum", "records"))
    sums = np.asarray(mod.execute(base, db).values)
    qs = [dataclasses.replace(base, having=mod.Having(">", float(np.quantile(sums, qt))))
          for qt in (0.4, 0.7)]
    qs.append(base)
    return qs


def _crimes_rows(rng, n):
    t = rdata.make_crimes(n, seed=int(rng.integers(1 << 30)))
    return {a: np.asarray(t[a]) for a in t.schema}


@pytest.fixture(scope="module")
def crimes():
    rdb = R.Database({"crimes": rdata.make_crimes(3000, seed=2)})
    tdb = _port_db(rdb)
    return {R: rdb, T: tdb}, {R: _crimes_queries(R, rdb), T: _crimes_queries(T, tdb)}


def _engine(mod, db, n_shards=3, **kw):
    args = dict(n_ranges=16, theta=0.1, seed=0, min_selectivity_gain=2.0)
    args.update(kw)
    return mod.ShardedEngine(db, "crimes", "district", n_shards=n_shards, **args)


def _sub(mod, db, n_shards=3, **kw):
    return _engine(mod, db, n_shards, transport="subprocess", op_deadline_s=5.0, **kw)


def _failover(mod, db, n_shards=3, replica="loopback", **kw):
    return mod.FailoverCoordinator(_engine(mod, db, n_shards, **kw),
                                   make_replica=mod.replica_factory(replica))


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
    r = se.last_route
    route = None if r is None else (r.contacted, r.skipped, r.watermark, r.deltas_applied,
                                    r.fused, r.degraded, r.failed_shards, r.n_retries,
                                    r.stale_checkpoints)
    return (route, tuple(se.health), se.index.misses, se.epoch, se.version,
            getattr(se, "takeovers", 0), se.peer_restores, tuple(se.stale_checkpoints))


def _run(engines, queries, i, ctx):
    """Query ``i`` on both packages' engines: equal results (to each other
    and to single-node execution), info and state."""
    (wres, winfo), (res, info) = (engines[m].run(queries[m][i]) for m in (R, T))
    _same(res, wres, ctx)
    assert res.canonical() == T.execute(queries[T][i], engines[T].db).canonical(), ctx
    assert (info.reused, info.created, info.degraded, info.shards_contacted) == (
        winfo.reused, winfo.created, winfo.degraded, winfo.shards_contacted), ctx
    assert _state(engines[T]) == _state(engines[R]), ctx
    return res, info


def _both(engines, fn):
    return {m: fn(m, engines[m]) for m in (R, T)}


def _shutdown(engines):
    for e in engines.values():
        e.shutdown()


# ---------------------------------------------------------------------------
# Loopback: takeover semantics
# ---------------------------------------------------------------------------


def test_takeover_keeps_index_hits_no_recapture(crimes, sleep_clock):
    dbs, qs = crimes
    fcs = {m: _failover(m, dbs[m]) for m in (R, T)}
    try:
        _run(fcs, qs, 0, "capture")
        epoch0 = fcs[T].engine.epoch
        _both(fcs, lambda m, fc: fc.inject_coord("coord_kill"))
        assert fcs[T].engine.epoch == epoch0 + 1 and fcs[T].zombie is None
        misses = fcs[T].index.misses
        _, info = _run(fcs, qs, 0, "after the takeover")
        # The replicated registration replayed into a hit: no capture.
        assert info.reused and not info.created and fcs[T].index.misses == misses
        assert fcs[T].engine.device.type == "cpu"  # the old coordinator's device
        rows = _crimes_rows(np.random.default_rng(7), 250)
        _both(fcs, lambda m, fc: fc.append_rows("crimes", rows))
        _run(fcs, qs, 0, "after an append")
    finally:
        _shutdown(fcs)


def test_partition_fences_zombie_coordinator(crimes, sleep_clock):
    dbs, qs = crimes
    fcs = {m: _failover(m, dbs[m]) for m in (R, T)}
    try:
        _run(fcs, qs, 0, "capture")
        _both(fcs, lambda m, fc: fc.inject_coord("coord_partition"))
        for m in (R, T):
            z = fcs[m].zombie
            assert z is not None and z.epoch + 1 == fcs[m].engine.epoch
            # Refused AT THE SHARD, as StaleEpochError (never retried or
            # absorbed as a ShardUnavailableError).
            with pytest.raises(m.StaleEpochError):
                z.shards[0].catch_up(z.version)
            with pytest.raises(m.StaleEpochError):
                z.shards[1].ship(z.version + 1, "append",
                                 {a: np.asarray(v)[:0] for a, v in
                                  _crimes_rows(np.random.default_rng(0), 4).items()})
        _run(fcs, qs, 0, "promoted")
        _both(fcs, lambda m, fc: fc.inject_coord("coord_kill"))
        _run(fcs, qs, 0, "chained takeover")
        assert fcs[T].takeovers == 2
    finally:
        _shutdown(fcs)


def _replay(rt, engine, table, ops, events=None):
    """``rt.run_ops`` (through ``rt.ChaosHarness`` when ``events`` are given),
    recording ``_state`` after every op: ``(trace, states)``."""
    harness = rt.ChaosHarness(events) if events is not None else None
    states = []

    def on_step(step):
        if step:
            states.append(_state(engine))
        if harness is not None:
            harness.apply_events(engine, step)

    try:
        trace = rt.run_ops(engine, table, ops, on_step=on_step)
    finally:
        engine.shutdown()
    states.append(_state(engine))
    return trace, states


def _differential(make, make_clean, table, ops, events, ctx):
    """Port chaotic vs port fault-free vs reference chaotic, state by state."""
    t_trace, t_states = _replay(TR, make(T), table, ops[T], events[T])
    clean, _ = _replay(TR, make_clean(T), table, ops[T])
    r_trace, r_states = _replay(RR, make(R), table, ops[R], events[R])
    first = next((i for i, (a, b) in enumerate(zip(t_trace, clean)) if a != b), None)
    assert t_trace == clean, f"{ctx}: the chaotic trace diverged at op {first}"
    first = next((i for i, (a, b) in enumerate(zip(t_trace, r_trace)) if a != b), None)
    assert t_trace == r_trace, f"{ctx}: the trace differs from the reference's at op {first}"
    for i, (got, want) in enumerate(zip(t_states, r_states)):
        assert got == want, f"{ctx}: after op {i} {got} != {want}"
    return t_states


@pytest.mark.parametrize("n_shards, seed", [(1, 11), (3, 12), (4, 13)])
def test_chaos_differential_with_coord_faults_loopback(crimes, sleep_clock, n_shards, seed):
    """Seeded replays mixing coordinator kills and partitions into the shard
    fault schedule: the port's trace equals its fault-free trace and the
    reference's, state by state; the port's own ``differential`` agrees."""
    dbs, qs = crimes
    ops = {m: rt.random_ops(seed, 24, qs[m], _crimes_rows) for m, rt, _ in PKGS}
    events = {m: rt.random_schedule(seed, 24, n_shards, coord_rate=0.15) for m, rt, _ in PKGS}
    assert events[T] == [TR.ChaosEvent(e.step, e.shard, e.kind, e.arg) for e in events[R]]
    assert any(e.shard == TR.COORD for e in events[T]), f"seed {seed}: no coordinator faults"
    states = _differential(lambda m: _failover(m, dbs[m], n_shards, op_deadline_s=0.02),
                           lambda m: _engine(m, dbs[m], n_shards), "crimes", ops, events,
                           f"n_shards={n_shards} seed={seed}")
    assert states[-1][5] == sum(e.shard == TR.COORD for e in events[T])  # every takeover ran
    if n_shards == 1:  # the port's own gate agrees
        ok, _, _ = TR.differential(lambda: _failover(T, dbs[T], n_shards, op_deadline_s=0.02),
                                   "crimes", ops[T], events[T],
                                   make_clean=lambda: _engine(T, dbs[T], n_shards))
        assert ok


def test_random_schedule_coord_events_seeded():
    a = TR.random_schedule(5, 40, 3, coord_rate=0.2)
    assert a == TR.random_schedule(5, 40, 3, coord_rate=0.2)
    assert a == [TR.ChaosEvent(e.step, e.shard, e.kind, e.arg)
                 for e in RR.random_schedule(5, 40, 3, coord_rate=0.2)]
    coord = [e for e in a if e.shard == TR.COORD]
    assert coord and all(e.kind in TR.COORD_FAULT_KINDS for e in coord)
    assert TR.COORD_FAULT_KINDS == T.standby.COORD_FAULT_KINDS == RR.chaos.COORD_FAULT_KINDS
    # coord_rate=0 keeps the schedules without coordinator faults unchanged.
    assert TR.random_schedule(5, 40, 3) == TR.random_schedule(5, 40, 3, coord_rate=0.0)


def test_replication_stream_detects_gaps():
    for m in (R, T):
        store = m.MetadataStore()
        with pytest.raises(m.ReplicationError, match="gap"):
            store.apply(m.ReplicationRecord(2, "ckpt", (0, 1)))
        store.apply(m.ReplicationRecord(1, "ckpt", (0, 1)))
        with pytest.raises(m.ReplicationError, match="unknown record kind"):
            store.apply(m.ReplicationRecord(2, "nonsense", None))
        assert store.last_seq == 2 and store.ckpt_versions == {0: 1}


def test_replica_loss_degrades_replication_not_serving(crimes, sleep_clock):
    dbs, qs = crimes

    def dying(m):
        class _DyingReplica:
            def publish(self, rec):
                raise m.ReplicationError("standby gone")

            def snapshot(self):  # pragma: no cover - never reached
                raise m.ReplicationError("standby gone")

            def close_replica(self):
                pass

        return _DyingReplica()

    ses = {m: _engine(m, dbs[m], 2) for m in (R, T)}
    try:
        _both(ses, lambda m, se: se.attach_replica(dying(m)))
        assert ses[T].replica_degraded and ses[R].replica_degraded  # the bootstrap failed
        rows = _crimes_rows(np.random.default_rng(3), 120)
        _both(ses, lambda m, se: se.append_rows("crimes", rows))
        _run(ses, qs, 0, "unreplicated")
    finally:
        _shutdown(ses)


# ---------------------------------------------------------------------------
# Subprocess: real processes, a real standby, peer checkpoints
# ---------------------------------------------------------------------------


def test_subprocess_takeover_with_standby_process(crimes, sleep_clock):
    """The standby is a real process: it outlives the coordinator object and
    hands the folded metadata store back over its socket."""
    dbs, qs = crimes
    fcs = {m: m.FailoverCoordinator(_sub(m, dbs[m]), make_replica=m.replica_factory("subprocess"))
           for m in (R, T)}
    try:
        standby = fcs[T].replica.proc.pid
        assert _pid_alive(standby)
        _run(fcs, qs, 0, "capture")
        _both(fcs, lambda m, fc: fc.inject_coord("coord_kill"))
        assert not _pid_alive(standby)  # the used standby was closed, a fresh one armed
        misses = fcs[T].index.misses
        _, info = _run(fcs, qs, 0, "after the takeover")
        assert info.reused and fcs[T].index.misses == misses
        rows = _crimes_rows(np.random.default_rng(9), 200)
        _both(fcs, lambda m, fc: fc.append_rows("crimes", rows))
        _both(fcs, lambda m, fc: fc.inject_coord("coord_partition"))
        for m in (R, T):
            with pytest.raises(m.StaleEpochError):
                fcs[m].zombie.shards[0].catch_up(fcs[m].zombie.version)
        _run(fcs, qs, 0, "after the partition")
        assert not fcs[T].engine.replica_degraded
    finally:
        _shutdown(fcs)


def test_peer_checkpoint_restores_killed_server(crimes, sleep_clock):
    """A SIGKILLed shard server recovers from its peer's mirror: shard-sized
    state off the peer, not a full-table reship."""
    dbs, qs = crimes
    ses = {m: _sub(m, dbs[m]) for m in (R, T)}
    try:
        _run(ses, qs, 0, "capture")
        rows = _crimes_rows(np.random.default_rng(4), 300)
        _both(ses, lambda m, se: se.append_rows("crimes", rows))
        _both(ses, lambda m, se: (se.shards[1].inject("kill"), se.shards[1].heal()))
        _run(ses, qs, 0, "recovered")
        assert ses[T].peer_restores == ses[R].peer_restores >= 1
    finally:
        _shutdown(ses)


def test_stale_checkpoints_counted_and_recovered(crimes, sleep_clock):
    """A checkpoint that cannot refresh its peer mirror is counted (engine
    and ``RouteInfo``), and once the peer heals, recovery replays back to
    exact parity."""
    dbs, qs = crimes
    ses = {m: _sub(m, dbs[m]) for m in (R, T)}
    try:
        _run(ses, qs, 0, "capture")
        _both(ses, lambda m, se: se.shards[1].inject("kill"))  # the peer of shard 0
        rng = np.random.default_rng(5)
        for i in range(3):
            rows = _crimes_rows(rng, 120)
            _both(ses, lambda m, se: se.append_rows("crimes", rows))
        _run(ses, qs, 0, "peer down")
        assert sum(ses[T].stale_checkpoints) > 0
        assert ses[T].last_route.stale_checkpoints == sum(ses[T].stale_checkpoints)
        _both(ses, lambda m, se: se.shards[1].heal())
        _run(ses, qs, 0, "peer healed")
    finally:
        _shutdown(ses)


# ---------------------------------------------------------------------------
# The server pool: a respawn storm, the top-up racing shutdown
# ---------------------------------------------------------------------------


def test_respawn_storm_degrades_to_cold_spawn(crimes, sleep_clock):
    """Kills faster than the background top-up can replenish the spares:
    heal falls through to a cold spawn, never deadlocks, never orphans."""
    dbs, qs = crimes
    ses = {m: _sub(m, dbs[m], 2) for m in (R, T)}
    killed = []
    try:
        _run(ses, qs, 0, "capture")
        for round_ in range(4):
            for m, _, shard_rpc in PKGS:
                for s in ses[m].shards:
                    killed.append(s.pid)
                    s.inject("kill")
                with shard_rpc.POOL._lock:  # drain every warm spare
                    spares = list(shard_rpc.POOL._spares)
                    shard_rpc.POOL._spares.clear()
                for sp in spares:
                    shard_rpc.POOL.discard(sp)
                for s in ses[m].shards:
                    s.heal()
            _run(ses, qs, 0, f"round {round_}")
    finally:
        _shutdown(ses)
    assert all(not _pid_alive(p) for p in killed)
    for _, _, shard_rpc in PKGS:
        with shard_rpc.POOL._lock:
            tracked = {sp.proc.pid for sp in shard_rpc.POOL._all}
        assert all(p in tracked or not _pid_alive(p) for p in killed)


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_pool_top_up_races_shutdown_without_orphans(crimes, pkg):
    """``shutdown_all`` racing the background fill: the closed window kills
    any spawn landing mid-shutdown instead of leaking it; ``close_pool`` is
    terminal until ``shutdown_all`` reopens the pool."""
    dbs, qs = crimes
    m, _, shard_rpc = PKGS[pkg == "port"]
    pool = shard_rpc.POOL
    for _ in range(3):
        with pool._lock:
            pool._spares.clear()
        pool._top_up_async()
        before = {sp.proc.pid for sp in list(pool._all)}
        pool.shutdown_all()
        for pid in before:
            assert not _pid_alive(pid)
    assert not pool._closed
    pool.close_pool()
    with pytest.raises(m.ShardUnavailableError):
        pool._spawn()
    pool.shutdown_all()
    assert not pool._closed
    se = _sub(m, dbs[m], 2)
    try:
        res, _ = se.run(qs[m][0])
        assert res.canonical() == m.execute(qs[m][0], se.db).canonical()
    finally:
        se.shutdown()
