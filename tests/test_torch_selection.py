"""Selection in the port against the reference: the same stratified (or
uniform) sample, the same AQR estimates, the same chosen attribute, and
per candidate the same ``est_bits`` and ``est_rows``, for CB-OPT-GB (and
OPT) on crimes, stars and tpch ``lineitem``.

Exactness: the samples follow from bit-equal threefry draws; the estimates
sum float32 in row order on both sides, so ``estimate`` and everything the
ranking reads (``est_bits``, ``est_rows``, a sum of integral fragment sizes)
are equal.  The Def. 9 terms (``expected``/``lo``/``hi``) and ``sigma``
pass through float32 ``erf``/``log1p``/``exp``/``sqrt``, whose last bit may
differ between XLA and PyTorch: they are held to ``rtol=1e-5``.
"""
import jax
import numpy as np
import pytest
import torch

import repro.core as R
from repro.aqp import sampling as rsamp
from repro.aqp import size_estimation as rse
from repro.core import datasets as rdata
import repro_torch.core as T
from repro_torch import prng
from repro_torch.aqp import sampling as tsamp
from repro_torch.aqp import size_estimation as tse
from repro_torch.core import datasets as tdata

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


@pytest.mark.parametrize("strategy", ["CB-OPT-GB", "OPT"])
@pytest.mark.parametrize("table,gb,agg,where", CASES)
def test_select_attribute_matches(dbs, strategy, table, gb, agg, where):
    """Paper-faithful selection (every safe candidate estimated)."""
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


def test_random_strategies_wait_for_randint(dbs):
    _, tdb = dbs["crimes"]
    _, tq = _queries(dbs, "crimes", ("district",), ("count", None), None)
    with pytest.raises(NotImplementedError):
        T.select_attribute("RAND-GB", prng.PRNGKey(0), tq, tdb, 10)
    assert torch.equal(prng.PRNGKey(0), prng.PRNGKey(0))
