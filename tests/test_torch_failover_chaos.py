"""The coordinator-fault chaos differential over subprocess shards, port
against reference, on the CPU.

Twin of ``tests/test_failover.py::test_chaos_differential_subprocess_coord_faults``:
seeded chaos with coordinator kills and partitions over real shard server
processes (1 to 8 shards, a subprocess standby on 4), the four workload
templates (Q-AGH, Q-AJGH, Q-AAGH, Q-AAJGH) on TPC-H.  The port's chaotic
trace must equal its fault-free single-process trace and the reference's
chaotic trace, and after every op its route, health, index misses, epoch,
takeovers, peer restores and stale checkpoints must equal the reference's.

Shard ops are timed against a deadline, so both packages' shard and retry
modules read a clock that advances only by their sleeps.
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
from repro.core import shard_rpc as rshard_rpc
from repro.runtime import resilience as rres
from repro_torch.convert import database_from_numpy
from repro_torch.core import shard as tshard
from repro_torch.core import shard_rpc as tshard_rpc
from repro_torch.runtime import resilience as tres

pytestmark = pytest.mark.slow  # spawns real shard server and standby processes

torch.set_num_threads(1)  # small tensors; leave the cores to the other xdist workers

PKGS = ((R, RR), (T, TR))


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


def _state(se):
    r = se.last_route
    route = None if r is None else (r.contacted, r.skipped, r.watermark, r.deltas_applied,
                                    r.fused, r.degraded, r.failed_shards, r.n_retries,
                                    r.stale_checkpoints)
    return (route, tuple(se.health), se.index.misses, se.epoch, se.version,
            getattr(se, "takeovers", 0), se.peer_restores, tuple(se.stale_checkpoints))


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


def test_chaos_differential_subprocess_coord_faults(sleep_clock):
    """Seeded chaos with coordinator faults over subprocess shards (1-8, a
    subprocess standby on 4), the four workload templates, state by state
    against the reference and against fault-free single-process serving."""
    rdb = rdata.make_tpch(2500, seed=8)
    dbs = {R: rdb, T: _port_db(rdb)}

    def templates(m, db):
        def thresh(q, qt):
            vals = m.execute(dataclasses.replace(q, having=None, outer_having=None), db).values
            return float(np.quantile(np.asarray(vals), qt))

        join = m.JoinSpec("orders", "l_orderkey", "o_orderkey")
        agh = m.Query("lineitem", ("l_suppkey",), m.Aggregate("sum", "l_quantity"))
        agh = dataclasses.replace(agh, having=m.Having(">", thresh(agh, 0.8)))
        ajgh = m.Query("lineitem", ("l_suppkey",), m.Aggregate("sum", "l_quantity"), join=join)
        ajgh = dataclasses.replace(ajgh, having=m.Having(">", thresh(ajgh, 0.8)))
        aagh = m.Query("lineitem", ("l_partkey", "l_suppkey"), m.Aggregate("sum", "l_quantity"),
                       having=m.Having(">", 0.0), outer_groupby=("l_suppkey",),
                       outer_agg=m.Aggregate("sum", None))
        aagh = dataclasses.replace(aagh, outer_having=m.Having(">", thresh(aagh, 0.8)))
        aajgh = m.Query("lineitem", ("l_partkey", "l_suppkey"), m.Aggregate("count", None),
                        join=join, having=m.Having(">", 0.0), outer_groupby=("l_suppkey",),
                        outer_agg=m.Aggregate("sum", None))
        aajgh = dataclasses.replace(aajgh, outer_having=m.Having(">", thresh(aajgh, 0.8)))
        return [agh, ajgh, aagh, aajgh]

    def rows(rng, n):
        t = rdata.make_tpch(4 * n, seed=int(rng.integers(1 << 30)))["lineitem"]
        return {a: np.asarray(t[a])[:n] for a in t.schema}

    def make_engine(m, n, replica):
        return m.FailoverCoordinator(
            m.ShardedEngine(dbs[m], "lineitem", "l_suppkey", n_shards=n, n_ranges=16, theta=0.1,
                            seed=0, min_selectivity_gain=1.0, transport="subprocess",
                            op_deadline_s=5.0),
            make_replica=m.replica_factory(replica))

    def make_clean(m, n):
        return m.ShardedEngine(dbs[m], "lineitem", "l_suppkey", n_shards=n, n_ranges=16,
                               theta=0.1, seed=0, min_selectivity_gain=1.0)

    for n_shards, seed, replica in ((1, 31, "loopback"), (4, 32, "subprocess"),
                                    (8, 33, "loopback")):
        qs = {m: templates(m, dbs[m]) for m in (R, T)}
        ops = {m: rt.random_ops(seed, 10, qs[m], rows, p_query=0.5, p_batch=0.2, p_append=0.2)
               for m, rt in PKGS}
        events = {m: rt.random_schedule(seed, 10, n_shards, coord_rate=0.25) for m, rt in PKGS}
        assert any(e.shard == TR.COORD for e in events[T]), f"seed {seed}: no coordinator faults"
        _differential(lambda m, n=n_shards, r=replica: make_engine(m, n, r),
                      lambda m, n=n_shards: make_clean(m, n), "lineitem", ops, events,
                      f"n_shards={n_shards} seed={seed}")
