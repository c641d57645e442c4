"""The chaos differential, port against reference, on the CPU.

Twins of ``tests/test_chaos.py::test_chaos_differential_crimes`` and
``::test_chaos_differential_tpch_templates``.  The same seeded op lists
(``random_ops``) and fault schedules (``random_schedule``, or the scripted
TPC-H one) replay on the port's engine with and without faults and on the
reference's engine with faults (once per case).  The port's chaotic trace
must equal its fault-free trace and the reference's chaotic trace, and
after every op its ``RouteInfo`` (``degraded``, ``failed_shards``,
``n_retries``), shard health and index misses must equal the reference's;
the misses also equal the fault-free run's (recovery never re-captures).

Shard ops are timed against a deadline, so both packages' shard and retry
modules read a clock that advances only by their sleeps: an op's duration
is its injected stall, and demotions are the same in both packages
whatever the machine's load.
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


def _state(se):
    r = se.last_route
    route = None if r is None else (r.contacted, r.skipped, r.watermark, r.deltas_applied,
                                    r.degraded, r.failed_shards, r.n_retries,
                                    r.stale_checkpoints)
    return route, tuple(se.health), se.index.misses


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


def _differential(make, table, r_ops, t_ops, r_events, t_events, ctx):
    """Port chaotic vs port fault-free vs reference chaotic."""
    t_trace, t_states = _replay(TR, make(T), table, t_ops, t_events)
    clean, clean_states = _replay(TR, make(T), table, t_ops)
    r_trace, r_states = _replay(RR, make(R), table, r_ops, r_events)
    first = next((i for i, (a, b) in enumerate(zip(t_trace, clean)) if a != b), None)
    assert t_trace == clean, f"{ctx}: the chaotic trace diverged at op {first}"
    first = next((i for i, (a, b) in enumerate(zip(t_trace, r_trace)) if a != b), None)
    assert t_trace == r_trace, f"{ctx}: the trace differs from the reference's at op {first}"
    for i, (got, want) in enumerate(zip(t_states, r_states)):
        assert got == want, f"{ctx}: after op {i} route, health, misses {got} != {want}"
    assert [m for _, _, m in t_states] == [m for _, _, m in clean_states], (
        f"{ctx}: faults changed the index misses (a re-capture)")
    return t_trace, t_states


def _crimes_queries(mod, db):
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


@pytest.fixture(scope="module")
def crimes():
    rdb = R.Database({"crimes": rdata.make_crimes(3000, seed=7)})
    tdb = _port_db(rdb)
    return rdb, tdb, _crimes_queries(R, rdb), _crimes_queries(T, tdb)


@pytest.mark.parametrize("n_shards, seed", [(1, 0), (2, 1), (3, 2), (4, 3)])
def test_chaos_differential_crimes(crimes, sleep_clock, n_shards, seed):
    """Seeded kill/stall/partition/flaky/heal replays on 1-4 shards."""
    rdb, tdb, rqs, tqs = crimes
    dbs = {R: rdb, T: tdb}
    ops = {mod: rt.random_ops(seed, 14, qs, _crimes_rows)
           for mod, rt, qs in ((R, RR, rqs), (T, TR, tqs))}
    events = {mod: rt.random_schedule(seed + 50, 14, n_shards) for mod, rt in ((R, RR), (T, TR))}

    def make(mod):
        return mod.ShardedEngine(dbs[mod], "crimes", "district", n_shards=n_shards, n_ranges=16,
                                 theta=0.1, seed=0, min_selectivity_gain=2.0, op_deadline_s=0.02)

    _, states = _differential(make, "crimes", ops[R], ops[T], events[R], events[T],
                              f"n_shards={n_shards} seed={seed}")
    assert states[-1][1] == ("healthy",) * n_shards  # the schedule heals everything


def test_chaos_differential_tpch_templates(sleep_clock):
    """The four templates under a scripted schedule on the join schema."""
    rdb = rdata.make_tpch(2500, seed=8)
    tdb = _port_db(rdb)
    dbs = {R: rdb, T: tdb}

    def templates(mod, db):
        def thresh(q, qt):
            vals = mod.execute(dataclasses.replace(q, having=None, outer_having=None), db).values
            return float(np.quantile(np.asarray(vals), qt))

        join = mod.JoinSpec("orders", "l_orderkey", "o_orderkey")
        agh = mod.Query("lineitem", ("l_suppkey",), mod.Aggregate("sum", "l_quantity"))
        agh = dataclasses.replace(agh, having=mod.Having(">", thresh(agh, 0.8)))
        ajgh = dataclasses.replace(agh, having=None, join=join)
        ajgh = dataclasses.replace(ajgh, having=mod.Having(">", thresh(ajgh, 0.8)))
        aagh = mod.Query("lineitem", ("l_partkey", "l_suppkey"), mod.Aggregate("sum", "l_quantity"),
                         having=mod.Having(">", 0.0), outer_groupby=("l_suppkey",),
                         outer_agg=mod.Aggregate("sum", None))
        aagh = dataclasses.replace(aagh, outer_having=mod.Having(">", thresh(aagh, 0.8)))
        aajgh = mod.Query("lineitem", ("l_partkey", "l_suppkey"), mod.Aggregate("count", None),
                          join=join, having=mod.Having(">", 0.0), outer_groupby=("l_suppkey",),
                          outer_agg=mod.Aggregate("sum", None))
        aajgh = dataclasses.replace(aajgh, outer_having=mod.Having(">", thresh(aajgh, 0.8)))
        return [agh, ajgh, aagh, aajgh]

    def rows(rng, n):
        t = rdata.make_tpch(4 * n, seed=int(rng.integers(1 << 30)))["lineitem"]
        return {a: np.asarray(t[a])[:n] for a in t.schema}

    ops = {mod: rt.random_ops(21, 12, templates(mod, dbs[mod]), rows, p_query=0.5, p_batch=0.2,
                              p_append=0.2)
           for mod, rt in ((R, RR), (T, TR))}
    script = [(1, 0, "kill"), (3, 2, "partition"), (5, 0, "heal"), (6, 1, "flaky", 2.0),
              (8, 2, "heal"), (9, 0, "stall", 0.05), (11, 0, "heal")]
    events = {mod: [rt.ChaosEvent(*e) for e in script] for mod, rt in ((R, RR), (T, TR))}

    def make(mod):
        return mod.ShardedEngine(dbs[mod], "lineitem", "l_suppkey", n_shards=3, n_ranges=16,
                                 theta=0.1, seed=0, min_selectivity_gain=1.0, op_deadline_s=0.02)

    _, states = _differential(make, "lineitem", ops[R], ops[T], events[R], events[T], "tpch")
    routes = [route for route, _, _ in states if route is not None]
    assert any(route[4] for route in routes)  # some route was served degraded
    assert states[-1][1] == ("healthy",) * 3
