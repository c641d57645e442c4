"""End-to-end engine twins of ``tests/test_system.py`` for the port: every
strategy of the paper, the random ones included, picks the reference's
attribute for every query and returns the reference's result bit for bit
(both sides sum float32 in row order on the CPU), which is also full-table
execution; cost-based selection beats random on average; ``run_batch``
and ``ShardedEngine`` under the random strategies match the reference.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import datasets as rdata
from repro.core.workload import CRIMES_SPEC as R_SPEC, generate_workload as r_generate
import repro_torch.core as T
from repro_torch.convert import database_from_numpy
from repro_torch.core.workload import CRIMES_SPEC as T_SPEC, generate_workload as t_generate

torch.set_num_threads(1)  # small tensors; leave the cores to the other xdist workers

STRATEGIES = ("NO-PS", "RAND-ALL", "RAND-GB", "RAND-PK", "RAND-AGG",
              "CB-OPT", "CB-OPT-REL", "CB-OPT-GB", "OPT")


@pytest.fixture(scope="module")
def dbs():
    rdb = R.Database({"crimes": rdata.make_crimes(15_000, seed=21)})
    tdb = database_from_numpy(
        [("crimes", {a: np.asarray(rdb["crimes"][a]) for a in rdb["crimes"].schema},
          rdb["crimes"].primary_key)], device="cpu")
    return rdb, tdb


@pytest.fixture(scope="module")
def workloads(dbs):
    rdb, tdb = dbs
    rq, tq = r_generate(R_SPEC, rdb, 6, seed=21), t_generate(T_SPEC, tdb, 6, seed=21)
    assert [q.signature() for q in tq] == [q.signature() for q in rq]
    return rq, tq


def _info(info):
    return (info.reused, info.created, info.attr, info.selectivity)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_engine_results_exact_for_every_strategy(dbs, workloads, strategy):
    rdb, tdb = dbs
    rq, tq = workloads
    reng = R.PBDSEngine(rdb, strategy=strategy, n_ranges=50, theta=0.1, seed=0)
    teng = T.PBDSEngine(tdb, strategy=strategy, n_ranges=50, theta=0.1, seed=0)
    for q1, q2 in zip(rq + rq, tq + tq):  # misses, then the replay
        r_res, r_info = reng.run(q1)
        t_res, t_info = teng.run(q2)
        assert _info(t_info) == _info(r_info), (strategy, q1)
        assert t_res.canonical() == r_res.canonical(), (strategy, q1)
        assert t_res.canonical() == T.execute(q2, tdb).canonical(), (strategy, q1)
    assert (teng.index.hits, teng.index.misses) == (reng.index.hits, reng.index.misses)


def test_engine_reuses_sketches(dbs, workloads):
    _, tdb = dbs
    _, tq = workloads
    eng = T.PBDSEngine(tdb, strategy="CB-OPT-GB", n_ranges=50, theta=0.1, seed=0)
    created = [eng.run(q)[1].created for q in tq]
    assert eng.index.hits == 0  # all distinct queries -> all misses
    assert any(created)
    for q, was_created in zip(tq, created):  # replay
        _, info = eng.run(q)
        assert info.reused == was_created or info.reused, q
    assert eng.index.hits >= sum(created)


def test_cost_based_beats_random_on_average(dbs):
    rdb, tdb = dbs
    rq = r_generate(R_SPEC, rdb, 8, seed=33)
    tq = t_generate(T_SPEC, tdb, 8, seed=33)
    sel = {}
    for strat in ("CB-OPT-GB", "RAND-PK"):
        reng = R.PBDSEngine(rdb, strategy=strat, n_ranges=50, theta=0.1, seed=1)
        teng = T.PBDSEngine(tdb, strategy=strat, n_ranges=50, theta=0.1, seed=1)
        sels = []
        for q1, q2 in zip(rq, tq):
            _, r_info = reng.run(q1)
            _, t_info = teng.run(q2)
            assert _info(t_info) == _info(r_info), (strat, q1)
            if t_info.selectivity is not None:
                sels.append(t_info.selectivity)
        sel[strat] = np.mean(sels) if sels else 1.0
    assert sel["CB-OPT-GB"] <= sel["RAND-PK"] + 0.05


def _index_contents(index):
    return sorted((repr(e.query.signature()), e.sketch.attr, e.sketch.bits.tolist(),
                   e.sketch.size_rows) for e in index.entries())


@pytest.mark.parametrize("strategy", ["RAND-GB", "RAND-PK"])
def test_run_batch_random_strategies_match_reference(dbs, strategy):
    """A burst of thresholds of two signature groups and its replay through
    ``run_batch``: the reference's picks, results and index, and what
    sequential ``run`` gives."""
    rdb, tdb = dbs

    def burst(mod, db):
        out = []
        for gb in (("district", "year"), ("community", "month")):
            base = mod.Query("crimes", gb, mod.Aggregate("sum", "records"))
            vals = mod.execute(base, db).values
            out += [dataclasses.replace(base, having=mod.Having(">", float(np.quantile(vals, qt))))
                    for qt in (0.95, 0.85, 0.7)]
        return out

    rq, tq = burst(R, rdb), burst(T, tdb)
    kw = dict(strategy=strategy, n_ranges=40, theta=0.1, seed=0, min_selectivity_gain=2.0)
    reng, t_bat, t_seq = R.PBDSEngine(rdb, **kw), T.PBDSEngine(tdb, **kw), T.PBDSEngine(tdb, **kw)
    for _ in range(2):
        r_out = reng.run_batch(rq)
        t_out = t_bat.run_batch(tq)
        s_out = [t_seq.run(q) for q in tq]
        for q, (r_res, r_info), (t_res, t_info), (s_res, s_info) in zip(rq, r_out, t_out, s_out):
            assert _info(t_info) == _info(r_info) == _info(s_info), (strategy, q)
            assert t_res.canonical() == r_res.canonical() == s_res.canonical(), (strategy, q)
    assert _index_contents(t_bat.index) == _index_contents(reng.index)
    assert _index_contents(t_seq.index) == _index_contents(reng.index)
    assert any(t_info.created for _, t_info in t_out) or any(
        t_info.reused for _, t_info in t_out)


def test_sharded_engine_random_strategy_matches_reference(dbs):
    """``ShardedEngine`` takes its strategy through its engine: RAND-GB
    picks, routes and answers as the reference's does."""
    rdb, tdb = dbs
    base = lambda mod: mod.Query("crimes", ("district", "year"), mod.Aggregate("sum", "records"))
    vals = R.execute(base(R), rdb).values
    taus = [float(np.quantile(vals, qt)) for qt in (0.95, 0.8, 0.6)]
    kw = dict(n_shards=4, strategy="RAND-GB", n_ranges=25, theta=0.1, seed=0,
              min_selectivity_gain=2.0)
    rse = R.ShardedEngine(rdb, "crimes", "district", **kw)
    tse = T.ShardedEngine(tdb, "crimes", "district", **kw)
    for _ in range(2):
        for tau in taus:
            rq = dataclasses.replace(base(R), having=R.Having(">", tau))
            tq = dataclasses.replace(base(T), having=T.Having(">", tau))
            r_res, r_info = rse.run(rq)
            t_res, t_info = tse.run(tq)
            assert _info(t_info) == _info(r_info), tau
            assert t_res.canonical() == r_res.canonical() == T.execute(tq, tdb).canonical()
    assert _index_contents(tse.engine.index) == _index_contents(rse.engine.index)
    assert tse.engine.index.hits >= 1
