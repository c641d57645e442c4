"""Selection in the port against the reference: the same stratified (or
uniform) sample, the same AQR estimates, the same chosen attribute, and
per candidate the same ``est_bits`` and ``est_rows``, for CB-OPT-GB, OPT
and the five random strategies on crimes, stars and tpch ``lineitem``; and
the twins of ``tests/test_selection.py`` (the config matrix, the stats
prefilter, the single-candidate shortcut, reuse-aware admission, the
workload log, the selection cache, the AQR key split and ``run_batch``
parity), each run on both packages with the reference test's assertions.

Exactness: the samples follow from bit-equal threefry draws; the estimates
sum float32 in row order on both sides, so ``estimate`` and everything the
ranking reads (``est_bits``, ``est_rows``, a sum of integral fragment sizes)
are equal.  The Def. 9 terms (``expected``/``lo``/``hi``) and ``sigma``
pass through float32 ``erf``/``log1p``/``exp``/``sqrt``, whose last bit may
differ between XLA and PyTorch: they are held to ``rtol=1e-5``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.core as R
from repro.aqp import sampling as rsamp
from repro.aqp import size_estimation as rse
from repro.core import datasets as rdata
from repro.core import strategies as rstrat
from repro.core.table import from_numpy as r_from_numpy
from repro.core.workload import CRIMES_SPEC as R_SPEC, generate_workload as r_generate
import repro_torch.core as T
from repro_torch import prng
from repro_torch.aqp import sampling as tsamp
from repro_torch.aqp import size_estimation as tse
from repro_torch.core import datasets as tdata
from repro_torch.core import strategies as tstrat
from repro_torch.core.workload import CRIMES_SPEC as T_SPEC, generate_workload as t_generate

torch.set_num_threads(1)  # small tensors; leave the cores to the other xdist workers

SEED = 17
TOL = dict(rtol=1e-5, atol=1e-6)


def _key(seed=SEED):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed)


@pytest.fixture(scope="module")
def dbs():
    crimes = dict(n=15_000, seed=21)
    stars = dict(n=15_000, seed=3)
    tpch = dict(n_lineitem=20_000, seed=1)
    return {
        "crimes": (R.Database({"crimes": rdata.make_crimes(**crimes)}),
                   T.Database({"crimes": tdata.make_crimes(**crimes, device="cpu")})),
        "stars": (R.Database({"stars": rdata.make_stars(**stars)}),
                  T.Database({"stars": tdata.make_stars(**stars, device="cpu")})),
        "lineitem": (rdata.make_tpch(**tpch), tdata.make_tpch(**tpch, device="cpu")),
    }


CASES = [
    ("crimes", ("district", "month"), ("count", None), None),
    ("crimes", ("community", "year"), ("sum", "records"), None),
    ("crimes", ("district", "pid", "year"), ("avg", "records"), None),
    ("crimes", ("month", "ward"), ("sum", "records"), ("year", ">", 2015)),
    ("stars", ("field", "run"), ("sum", "mag_g"), None),  # too many groups: uniform sample
    ("stars", ("field",), ("avg", "redshift"), None),
    ("stars", ("run",), ("sum", "mag_r"), ("dec", ">", 0.0)),
    ("lineitem", ("l_suppkey",), ("sum", "l_extendedprice"), None),
    ("lineitem", ("l_suppkey", "l_shipdate"), ("avg", "l_quantity"), None),
]


def _queries(dbs, table, gb, agg, where, quantile=0.7):
    rdb, _ = dbs[table]
    kw = dict(table=table, groupby=gb, agg=R.Aggregate(*agg))
    if where is not None:
        kw["where"] = R.Predicate(*where)
    tau = float(np.quantile(R.execute(R.Query(**kw), rdb).values, quantile))
    rq = R.Query(**kw, having=R.Having(">", tau))
    tkw = dict(table=table, groupby=gb, agg=T.Aggregate(*agg), having=T.Having(">", tau))
    if where is not None:
        tkw["where"] = T.Predicate(*where)
    return rq, T.Query(**tkw)


@pytest.mark.parametrize("table,gb,agg,where", CASES)
def test_samples_and_aqr_estimates_match(dbs, table, gb, agg, where):
    rdb, tdb = dbs[table]
    rq, tq = _queries(dbs, table, gb, agg, where)
    jk, tk = _key()
    rs = rsamp.SampleCache().get_or_create(jk, rdb[table], gb, 0.05)
    ts = tsamp.SampleCache().get_or_create(tk, tdb[table], gb, 0.05)
    assert ts.stratified == rs.stratified and ts.n_groups == rs.n_groups
    for f in ("indices", "sample_gid", "group_sizes", "sample_sizes"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(rs, f), err_msg=f)
    jke, tke = jax.random.split(jk)[1], prng.split(tk)[1]
    rest, rsat = rse.approximate_query_result(jke, rq, rdb, rs)
    test_, tsat = tse.approximate_query_result(tke, tq, tdb, ts)
    np.testing.assert_array_equal(test_.estimate, rest.estimate)
    np.testing.assert_array_equal(test_.n_samples, rest.n_samples)
    np.testing.assert_allclose(test_.sigma, rest.sigma, **TOL)
    np.testing.assert_allclose(test_.half_width, rest.half_width, **TOL)
    np.testing.assert_array_equal(tsat, rsat)
    assert 0 < tsat.sum() < tsat.size


def _check_estimates(t_est, r_est):
    assert set(t_est) == set(r_est)
    for a, r in r_est.items():
        t = t_est[a]
        np.testing.assert_array_equal(t.est_bits, r.est_bits, err_msg=a)
        assert t.est_rows == r.est_rows and t.est_selectivity == r.est_selectivity
        assert t.n_satisfied_groups == r.n_satisfied_groups
        np.testing.assert_allclose([t.expected_rows, t.lo_rows, t.hi_rows],
                                   [r.expected_rows, r.lo_rows, r.hi_rows], **TOL)


@pytest.mark.parametrize("strategy", ["CB-OPT-GB", "OPT", *T.RANDOM_STRATEGIES])
@pytest.mark.parametrize("table,gb,agg,where", CASES)
def test_select_attribute_matches(dbs, strategy, table, gb, agg, where):
    """Paper-faithful selection (every safe candidate estimated); the random
    strategies pick the same member of the same pool (``prng.randint``)."""
    rdb, tdb = dbs[table]
    rq, tq = _queries(dbs, table, gb, agg, where)
    jk, tk = _key()
    n_ranges = 50
    rsel = R.select_attribute(strategy, jk, rq, rdb, n_ranges, sample_cache=rsamp.SampleCache(),
                              catalog=R.Catalog(), topk=3)
    tsel = T.select_attribute(strategy, tk, tq, tdb, n_ranges, sample_cache=tsamp.SampleCache(),
                              catalog=T.Catalog(), topk=3)
    assert (tsel.attr, tsel.candidates, tsel.topk) == (rsel.attr, rsel.candidates, rsel.topk)
    _check_estimates(tsel.estimates, rsel.estimates)
    if strategy == "CB-OPT-GB":
        assert tsel.estimates  # the estimation pass really ran


@pytest.mark.parametrize("incidence", ["sample", "full"])
def test_single_candidate_estimate_matches(dbs, incidence):
    rdb, tdb = dbs["crimes"]
    rq, tq = _queries(dbs, "crimes", ("district", "month"), ("count", None), None)
    jk, tk = _key(5)
    rs = rsamp.stratified_reservoir_sample(jk, rdb["crimes"], rq.groupby, 0.05)
    ts = tsamp.stratified_reservoir_sample(tk, tdb["crimes"], tq.groupby, 0.05)
    for attr in ("district", "beat"):
        rr = R.equi_depth_ranges(rdb["crimes"], attr, 30)
        tr = T.equi_depth_ranges(tdb["crimes"], attr, 30)
        rcfg = rse.EstimationConfig(incidence=incidence)
        tcfg = tse.EstimationConfig(incidence=incidence)
        r = rse.estimate_size(jk, rq, rdb, rr, rs, rcfg, catalog=R.Catalog())
        t = tse.estimate_size(tk, tq, tdb, tr, ts, tcfg, catalog=T.Catalog())
        _check_estimates({attr: t}, {attr: r})


def test_engine_selection_defaults_match(dbs):
    """The engine's default SelectionConfig (prefilter, single-candidate
    shortcut, reuse-aware, memoized) picks alike on both sides."""
    rdb, tdb = dbs["crimes"]
    reng, teng = R.PBDSEngine(rdb, seed=3), T.PBDSEngine(tdb, seed=3)
    for gb, agg, where in [(("district", "month"), ("count", None), None),
                           (("community", "pid", "year"), ("sum", "records"), None)]:
        rq, tq = _queries(dbs, "crimes", gb, agg, where, quantile=0.9)
        kw = dict(sample_cache=None, theta=0.05, topk=2)
        rsel = R.select_attribute("CB-OPT-GB", reng._select_key(rq), rq, rdb, 100,
                                  catalog=reng.catalog, selection=reng.selection,
                                  selection_cache=reng.selection_cache,
                                  ranges_for=lambda a: reng.ranges_for("crimes", a), **kw)
        tsel = T.select_attribute("CB-OPT-GB", teng._select_key(tq), tq, tdb, 100,
                                  catalog=teng.catalog, selection=teng.selection,
                                  selection_cache=teng.selection_cache,
                                  ranges_for=lambda a: teng.ranges_for("crimes", a), **kw)
        assert (tsel.attr, tsel.candidates, tsel.topk) == (rsel.attr, rsel.candidates, rsel.topk)
        _check_estimates(tsel.estimates, rsel.estimates)
    assert (teng.selection_cache.hits, teng.selection_cache.misses) == (
        reng.selection_cache.hits, reng.selection_cache.misses)


# ---------------------------------------------------------------------------
# tests/test_selection.py twins
# ---------------------------------------------------------------------------

SIDES = ((R, rsamp, jax.random.PRNGKey), (T, tsamp, prng.PRNGKey))


def _broad_q(mod):
    # Every group passes HAVING -> estimated selectivity 1.0.
    return mod.Query("crimes", ("district",), mod.Aggregate("count", None),
                     having=mod.Having(">", 0.0))


def _two_cand_q(mod):
    return mod.Query("crimes", ("district", "month"), mod.Aggregate("count", None),
                     having=mod.Having(">", 50.0))


def _crimes(dbs):
    return dict(zip((R, T), dbs["crimes"]))


def _info(info):
    return (info.reused, info.created, info.attr, info.selectivity)


def test_config_defaults_and_paper_faithful():
    for strat in (rstrat, tstrat):
        cfg = strat.SelectionConfig()
        assert cfg.stats_prefilter and cfg.skip_single_candidate
        assert cfg.reuse_aware and cfg.cache
        pf = strat.SelectionConfig.paper_faithful()
        assert not (pf.stats_prefilter or pf.skip_single_candidate or pf.reuse_aware or pf.cache)
        assert strat.PAPER_FAITHFUL == pf
    assert (dataclasses.asdict(tstrat.SelectionConfig())
            == dataclasses.asdict(rstrat.SelectionConfig()))


def test_no_config_is_paper_faithful(dbs):
    """No config == explicit paper-faithful mode, on each side, and the two
    sides' passes equal each other."""
    dbm = _crimes(dbs)
    picks = []
    for mod, samp, key_of in SIDES:
        q = _two_cand_q(mod)
        kwargs = dict(sample_cache=samp.SampleCache(), theta=0.1, catalog=mod.Catalog())
        a = mod.select_attribute("CB-OPT-GB", key_of(7), q, dbm[mod], 10, **kwargs)
        b = mod.select_attribute("CB-OPT-GB", key_of(7), q, dbm[mod], 10,
                                 selection=(rstrat if mod is R else tstrat).PAPER_FAITHFUL,
                                 selection_cache=mod.SelectionCache(), **kwargs)
        assert a.attr == b.attr and a.candidates == b.candidates
        assert set(a.estimates) == set(b.estimates)
        for attr in a.estimates:
            assert a.estimates[attr].est_rows == b.estimates[attr].est_rows
            np.testing.assert_array_equal(a.estimates[attr].est_bits, b.estimates[attr].est_bits)
        picks.append(a)
    rsel, tsel = picks
    assert (tsel.attr, tsel.candidates) == (rsel.attr, rsel.candidates)
    _check_estimates(tsel.estimates, rsel.estimates)


def _skewed_db(mod):
    """'lo' has 2 distinct values, 'hi' is high-cardinality -> 'hi'
    dominates 'lo' on (n_nonempty, max_frac, min_frac)."""
    n = 4000
    rng = np.random.default_rng(3)
    cols = {"lo": (rng.random(n) < 0.5).astype(np.float32),
            "hi": rng.permutation(n).astype(np.float32),
            "v": rng.random(n).astype(np.float32)}
    t = r_from_numpy("t", cols) if mod is R else T.from_numpy("t", cols, device="cpu")
    return mod.Database({"t": t})


def _perm_db(mod):
    n = 4000
    rng = np.random.default_rng(4)
    cols = {"a1": rng.permutation(n).astype(np.float32),
            "a2": rng.permutation(n).astype(np.float32)}
    t = r_from_numpy("t", cols) if mod is R else T.from_numpy("t", cols, device="cpu")
    return mod.Database({"t": t})


@pytest.mark.parametrize("mod", [R, T], ids=["reference", "port"])
def test_stats_prefilter_prunes_dominated_and_never_empties(mod):
    db2 = _skewed_db(mod)
    q = mod.Query("t", ("hi", "lo"), mod.Aggregate("count", None), having=mod.Having(">", 0.0))
    rf = lambda a: mod.equi_depth_ranges(db2["t"], a, 16)
    assert mod.stats_prefilter(q, db2, ("hi", "lo"), rf, catalog=mod.Catalog()) == ("hi",)
    db3 = _perm_db(mod)
    q3 = mod.Query("t", ("a1", "a2"), mod.Aggregate("count", None), having=mod.Having(">", 0.0))
    rf3 = lambda a: mod.equi_depth_ranges(db3["t"], a, 16)
    assert mod.stats_prefilter(q3, db3, ("a1", "a2"), rf3, catalog=mod.Catalog()) == ("a1", "a2")
    # Single candidate short-circuits untouched; an empty pool stays empty.
    assert mod.stats_prefilter(q, db2, ("lo",), rf, catalog=mod.Catalog()) == ("lo",)
    assert mod.stats_prefilter(q, db2, (), rf, catalog=mod.Catalog()) == ()


def test_stats_prefilter_in_engine_skips_estimation_of_dominated():
    out = []
    for mod, strat in ((R, rstrat), (T, tstrat)):
        db2 = _skewed_db(mod)
        q = mod.Query("t", ("hi", "lo"), mod.Aggregate("count", None),
                      having=mod.Having(">", 2.0))
        eng = mod.PBDSEngine(db2, strategy="CB-OPT-GB", n_ranges=16, theta=0.2, seed=0,
                             selection=strat.SelectionConfig(skip_single_candidate=False))
        res, info = eng.run(q)
        assert res.canonical() == mod.execute(q, db2).canonical()
        pf = mod.PBDSEngine(db2, strategy="CB-OPT-GB", n_ranges=16, theta=0.2, seed=0,
                            selection=strat.SelectionConfig.paper_faithful())
        res_pf, info_pf = pf.run(q)
        assert res_pf.canonical() == res.canonical()
        out.append((res.canonical(), _info(info), _info(info_pf)))
    assert out[1] == out[0]


def test_single_candidate_shortcut_skips_sampling(dbs):
    dbm = _crimes(dbs)
    out = []
    for mod in (R, T):
        q = mod.Query("crimes", ("district",), mod.Aggregate("count", None),
                      having=mod.Having(">", 50.0))
        eng = mod.PBDSEngine(dbm[mod], strategy="CB-OPT-GB", n_ranges=10, theta=0.1, seed=0)
        res, info = eng.run(q)
        assert info.created and info.attr == "district"
        assert eng.samples.misses == 0 and eng.aqr.misses == 0
        assert res.canonical() == mod.execute(q, dbm[mod]).canonical()
        out.append((res.canonical(), _info(info)))
    assert out[1] == out[0]


def test_reuse_aware_creates_where_paper_declines(dbs):
    dbm = _crimes(dbs)
    out = []
    for mod, strat in ((R, rstrat), (T, tstrat)):
        q = _broad_q(mod)
        eng = mod.PBDSEngine(dbm[mod], strategy="CB-OPT-GB", n_ranges=10, theta=0.1,
                             min_selectivity_gain=0.9, seed=0,
                             selection=strat.SelectionConfig(skip_single_candidate=False))
        res, info = eng.run(q)
        assert info.created  # paper-faithful admission declines this (sel == 1.0)
        res2, info2 = eng.run(q)
        assert info2.reused
        assert res.canonical() == res2.canonical() == mod.execute(q, dbm[mod]).canonical()
        out.append((res.canonical(), _info(info), _info(info2)))
    assert out[1] == out[0]


def _flip_engine(mod, strat, db):
    return mod.PBDSEngine(db, strategy="CB-OPT-GB", n_ranges=10, theta=0.1,
                          min_selectivity_gain=0.5, seed=0,
                          selection=strat.SelectionConfig(skip_single_candidate=False))


def test_reuse_discount_flips_admission_after_enough_repeats(dbs):
    """Declined while reach is low, admitted at the 5th miss (1.0 - 0.12 *
    reach < 0.5), then index hits; one estimate pass in all."""
    dbm = _crimes(dbs)
    out = []
    for mod, strat in ((R, rstrat), (T, tstrat)):
        q = _broad_q(mod)
        eng = _flip_engine(mod, strat, dbm[mod])
        outcomes = [(info.created, info.reused) for info in (eng.run(q)[1] for _ in range(6))]
        assert outcomes[:4] == [(False, False)] * 4
        assert outcomes[4] == (True, False)
        assert outcomes[5] == (False, True)
        assert eng.aqr.misses == 1
        assert eng.selection_cache.hits >= 3
        out.append((outcomes, eng.selection_cache.hits, eng.selection_cache.misses))
    assert out[1] == out[0]


def test_workload_log_reach_window_and_stamps():
    for mod in (R, T):
        wl = mod.WorkloadLog(window=3)
        q1 = _broad_q(mod)
        q2 = dataclasses.replace(q1, having=mod.Having(">", 10.0))  # q1 subsumes q2
        assert (wl.record(q1), wl.record(q2)) == (1, 2)
        assert wl.reach(q1) == 2
        assert wl.reach(q2) == 1
        assert wl.reach(q1, stamp=1) == 1  # prefix-exact
        for _ in range(3):
            wl.record(q1)
        assert len(wl) == 3
        assert wl.reach(q2) == 0
        wl2 = mod.WorkloadLog()
        wl2.record(q1)
        wl2.begin_batch(4)
        assert [wl2.batch_stamp(i) for i in range(4)] == [2, 3, 4, 5]
        wl2.record(q2, stamp=wl2.batch_stamp(3))
        wl2.record(q1, stamp=wl2.batch_stamp(1))
        assert wl2.reach(q1, stamp=wl2.batch_stamp(1)) == 2
        assert wl2.reach(q1, stamp=wl2.batch_stamp(3)) == 3


def test_selection_state_survives_coordinator_restart(dbs):
    """``selection_state()`` round-trips through pickle into a fresh engine,
    which keeps accumulating reach: the 5th miss overall flips to created."""
    import pickle

    dbm = _crimes(dbs)
    out = []
    for mod, strat in ((R, rstrat), (T, tstrat)):
        q = _broad_q(mod)
        eng = _flip_engine(mod, strat, dbm[mod])
        for _ in range(4):
            assert not eng.run(q)[1].created
        blob = pickle.dumps(eng.selection_state())
        assert not _flip_engine(mod, strat, dbm[mod]).run(q)[1].created  # blank restart
        restarted = _flip_engine(mod, strat, dbm[mod])
        restarted.restore_selection_state(pickle.loads(blob))
        assert restarted.workload.clock == eng.workload.clock
        assert restarted.workload.reach(q) == eng.workload.reach(q)
        assert restarted.selection_cache.hits == eng.selection_cache.hits
        assert restarted.selection_cache.misses == eng.selection_cache.misses
        assert restarted.run(q)[1].created
        assert restarted.run(q)[1].reused
        out.append((restarted.workload.clock, restarted.selection_cache.hits,
                    restarted.selection_cache.misses))
    assert out[1] == out[0]


def _cache_engine(mod, strat, db):
    return mod.PBDSEngine(db, strategy="CB-OPT-GB", n_ranges=10, theta=0.1, seed=0,
                          min_selectivity_gain=2.0,  # always create
                          selection=strat.SelectionConfig(skip_single_candidate=False))


def test_selection_cache_repeat_template_pays_zero(dbs):
    dbm = _crimes(dbs)
    out = []
    for mod, strat in ((R, rstrat), (T, tstrat)):
        q1 = _two_cand_q(mod)
        eng = _cache_engine(mod, strat, dbm[mod])
        eng.run(q1)
        aqr_misses, sample_misses = eng.aqr.misses, eng.samples.misses
        _, info2 = eng.run(dataclasses.replace(q1, having=mod.Having(">", 120.0)))
        assert info2.reused
        _, info3 = eng.run(dataclasses.replace(q1, having=mod.Having(">", 10.0)))
        assert info3.created
        assert eng.selection_cache.hits >= 1
        assert eng.aqr.misses == aqr_misses and eng.samples.misses == sample_misses
        out.append((_info(info2), _info(info3), eng.selection_cache.hits))
    assert out[1] == out[0]


def test_selection_cache_invalidates_on_mutation(dbs):
    dbm = _crimes(dbs)
    out = []
    for mod, strat in ((R, rstrat), (T, tstrat)):
        q = _two_cand_q(mod)
        eng = _cache_engine(mod, strat, dbm[mod])
        eng.run(q)
        misses0 = eng.selection_cache.misses
        fact = eng.db["crimes"]
        eng.append_rows("crimes", {a: np.asarray(dbm[R]["crimes"][a])[:32] for a in fact.schema})
        res, info = eng.run(dataclasses.replace(q, having=mod.Having(">", 10.0)))
        assert eng.selection_cache.misses > misses0
        out.append((res.canonical(), _info(info), eng.selection_cache.misses))
    assert out[1] == out[0]


def test_selection_cache_unit():
    for strat in (rstrat, tstrat):
        cache = strat.SelectionCache(max_entries=2)
        r = strat.SelectionResult("CB-OPT-GB", "a", ("a",), {})
        k1, k2, k3 = (("s", 1, 1, 0.1, 10, (None, None), t) for t in ("t1", "t2", "t3"))
        assert cache.get(k1) is None and cache.misses == 1
        cache.put(k1, r)
        assert cache.get(k1) is r and cache.hits == 1
        cache.put(k2, r)
        cache.put(k3, r)  # FIFO evicts k1
        assert len(cache) == 2 and cache.get(k1) is None
        cache.invalidate("t2")  # the table name at key index 6
        assert len(cache) == 1 and cache.get(k2) is None


def test_selection_cache_key_separates_having_ops(dbs):
    dbm = _crimes(dbs)
    keys = []
    for mod in (R, T):
        q_gt = _two_cand_q(mod)
        q_eq = dataclasses.replace(q_gt, having=mod.Having("==", 50.0))
        t = dbm[mod]["crimes"]
        k_gt = mod.selection_cache_key("CB-OPT-GB", q_gt, t, 0.1, 10)
        assert k_gt != mod.selection_cache_key("CB-OPT-GB", q_eq, t, 0.1, 10)
        keys.append(k_gt[:1] + k_gt[3:])  # the table uid/version are per package
    assert keys[1] == keys[0]


def test_cached_and_uncached_aqr_paths_rank_identically(dbs):
    dbm = _crimes(dbs)
    picks = []
    for mod, samp, key_of in SIDES:
        q = _two_cand_q(mod)
        common = dict(theta=0.1, catalog=mod.Catalog())
        uncached = mod.select_attribute("CB-OPT-GB", key_of(11), q, dbm[mod], 10,
                                        sample_cache=samp.SampleCache(), aqr_cache=None, **common)
        cached = mod.select_attribute("CB-OPT-GB", key_of(11), q, dbm[mod], 10,
                                      sample_cache=samp.SampleCache(), aqr_cache=samp.AQRCache(),
                                      **common)
        assert uncached.attr == cached.attr and uncached.topk == cached.topk
        assert set(uncached.estimates) == set(cached.estimates)
        for a in uncached.estimates:
            assert uncached.estimates[a].est_rows == cached.estimates[a].est_rows
        picks.append(cached)
    assert (picks[1].attr, picks[1].topk) == (picks[0].attr, picks[0].topk)
    _check_estimates(picks[1].estimates, picks[0].estimates)


def _index_state(eng):
    return sorted((repr(e.query.signature()), e.sketch.bits.tolist()) for e in eng.index.entries())


@pytest.mark.parametrize("cfg", [None, "paper_faithful"])
def test_run_batch_parity_with_selection_configs(dbs, cfg):
    dbm = _crimes(dbs)
    out = []
    for mod, strat, gen, spec in ((R, rstrat, r_generate, R_SPEC),
                                  (T, tstrat, t_generate, T_SPEC)):
        sel = strat.SelectionConfig.paper_faithful() if cfg else None
        qs = gen(spec, dbm[mod], 8, seed=5)
        mk = lambda: mod.PBDSEngine(dbm[mod], strategy="CB-OPT-GB", n_ranges=10, theta=0.1,
                                    seed=0, selection=sel)
        e_seq, e_bat = mk(), mk()
        seq = [e_seq.run(q) for q in qs]
        bat = e_bat.run_batch(qs)
        for i, (s_, b_) in enumerate(zip(seq, bat)):
            assert s_[0].canonical() == b_[0].canonical(), i
            assert (s_[1].reused, s_[1].created, s_[1].attr) == (
                b_[1].reused, b_[1].created, b_[1].attr), i
        assert _index_state(e_seq) == _index_state(e_bat)
        if sel is None:
            sa = sorted((s_, repr(p.signature())) for s_, p in e_seq.workload.entries())
            sb = sorted((s_, repr(p.signature())) for s_, p in e_bat.workload.entries())
            assert [x[1] for x in sa] == [x[1] for x in sb]
        out.append(([(r.canonical(), _info(i)) for r, i in bat], _index_state(e_bat)))
    assert out[1] == out[0]
