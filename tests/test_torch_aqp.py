"""The port's sampling, estimators, bootstrap, size estimation and caches
against the reference's, on the CPU.

Twins of the non-join cases of ``tests/test_aqp.py`` (the wander-join and
join-size cases are twinned in ``test_torch_join.py``).  Each runs the same
seeded data and keys (``repro_torch.prng`` is bit-exact with
``jax.random``) through both packages and holds the reference test's
assertions on the port, plus: the same samples (row ids, group ids and
sizes), equal per-group estimates and ``est_rows``, equal cache counters.
``sigma``, pass probabilities and bootstrap spreads pass through float32
``erf``/``sqrt``, whose last bit may differ between XLA and PyTorch: they
are held to ``rtol=1e-5``.
"""
import jax
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.aqp import bootstrap as rboot
from repro.aqp import estimators as r_est
from repro.aqp import sampling as rsamp
from repro.aqp import size_estimation as rsize
from repro.core import datasets as rdata
from repro.core.table import encode_groups as r_encode
from repro_torch import prng
from repro_torch.aqp import bootstrap as tboot
from repro_torch.aqp import estimators as t_est
from repro_torch.aqp import sampling as tsamp
from repro_torch.aqp import size_estimation as tsize
from repro_torch.convert import database_from_numpy
from repro_torch.core.table import encode_groups as t_encode

torch.set_num_threads(1)  # small tensors; leave the cores to the other xdist workers

TOL = dict(rtol=1e-5, atol=1e-6)


def _keys(seed=0):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed)


def _port_db(rdb):
    return database_from_numpy(
        [(n, {a: np.asarray(rdb[n][a]) for a in rdb[n].schema}, rdb[n].primary_key)
         for n in rdb.names], device="cpu")


def _crimes(n, seed):
    rdb = R.Database({"crimes": rdata.make_crimes(n, seed=seed)})
    return rdb, _port_db(rdb)


@pytest.fixture(scope="module")
def dbs():
    return _crimes(30_000, 5)


def _same_sample(t, r):
    np.testing.assert_array_equal(t.indices, r.indices)
    np.testing.assert_array_equal(t.sample_gid, r.sample_gid)
    np.testing.assert_array_equal(t.group_sizes, r.group_sizes)
    np.testing.assert_array_equal(t.sample_sizes, r.sample_sizes)
    assert (t.n_groups, t.stratified) == (r.n_groups, r.stratified)
    for a in r.group_values:
        np.testing.assert_array_equal(np.asarray(t.group_values[a]), np.asarray(r.group_values[a]))


def test_stratified_sample_represents_every_group(dbs):
    rdb, tdb = dbs
    jk, tk = _keys()
    t = tdb["crimes"]
    s = tsamp.stratified_reservoir_sample(tk, t, ("district", "year"), theta=0.05)
    _same_sample(s, rsamp.stratified_reservoir_sample(jk, rdb["crimes"], ("district", "year"),
                                                      theta=0.05))
    assert s.stratified
    assert (s.sample_sizes >= 1).all() and (s.sample_sizes <= s.group_sizes).all()
    assert 0.03 < s.num_samples / t.num_rows < 0.15
    d = t["district"].numpy()[s.indices]
    assert (d == s.group_values["district"][s.sample_gid]).all()


def test_uniform_fallback_when_too_many_groups(dbs):
    rdb, tdb = dbs
    jk, tk = _keys()
    s = tsamp.stratified_reservoir_sample(tk, tdb["crimes"], ("beat", "year", "month"), theta=0.001)
    _same_sample(s, rsamp.stratified_reservoir_sample(jk, rdb["crimes"], ("beat", "year", "month"),
                                                      theta=0.001))
    assert not s.stratified


def test_sum_estimator_unbiased(dbs):
    """The mean of per-group SUM estimates over 30 sample draws lands near
    the true sums; every draw's estimates equal the reference's."""
    rdb, tdb = dbs
    t, rt = tdb["crimes"], rdb["crimes"]
    gid, n_groups, _ = t_encode(t, ("district",))
    rgid, rn, _ = r_encode(rt, ("district",))
    np.testing.assert_array_equal(gid, rgid)
    true = np.bincount(gid, weights=t["records"].numpy().astype(np.float64), minlength=n_groups)
    ests = []
    for i in range(30):
        jk, tk = _keys(i)
        s = tsamp.stratified_reservoir_sample(tk, t, ("district",), 0.05)
        rs = rsamp.stratified_reservoir_sample(jk, rt, ("district",), 0.05)
        est = t_est.group_estimates("sum", t.gather(s.indices)["records"],
                                    torch.ones(s.num_samples, dtype=torch.bool), s.sample_gid,
                                    s.n_groups, s.group_sizes)
        want = r_est.group_estimates("sum", rt.gather(rs.indices)["records"],
                                    np.ones(rs.num_samples, bool), rs.sample_gid, rs.n_groups,
                                    rs.group_sizes)
        np.testing.assert_array_equal(est.estimate, np.asarray(want.estimate))
        np.testing.assert_allclose(est.sigma, np.asarray(want.sigma), **TOL)
        ests.append(est.estimate)
    rel = np.abs(np.mean(ests, axis=0) - true) / np.maximum(true, 1)
    assert np.median(rel) < 0.15


def test_pass_probability_monotone():
    vals = np.array([10.0, 20.0, 30.0, 40.0], np.float32)
    gid, sizes = np.array([0, 0, 1, 1], np.int32), np.array([10, 10])
    est = t_est.group_estimates("sum", torch.from_numpy(vals), torch.ones(4, dtype=torch.bool),
                                gid, 2, sizes)
    want = r_est.group_estimates("sum", jax.numpy.asarray(vals), jax.numpy.asarray(np.ones(4, bool)),
                                gid, 2, sizes)
    np.testing.assert_array_equal(est.estimate, np.asarray(want.estimate))
    for tau in (50.0, 150.0, 500.0):
        np.testing.assert_allclose(t_est.pass_probability(est, ">", tau),
                                   r_est.pass_probability(want, ">", tau), **TOL)
    assert (t_est.pass_probability(est, ">", 50.0) >= t_est.pass_probability(est, ">", 500.0)).all()
    x = np.array([-3.0, -0.5, 0.0, 0.7, 2.5])
    np.testing.assert_allclose(t_est.norm_cdf(x), r_est.norm_cdf(x), **TOL)
    assert t_est.norm_cdf(np.array([0.0]))[0] == pytest.approx(0.5, abs=1e-6)


def test_bootstrap_shrinks_with_group_size():
    rng = np.random.default_rng(0)
    gid = np.repeat([0, 1], [400, 25]).astype(np.int32)
    vals = rng.normal(10, 3, 425).astype(np.float32)
    jk, tk = _keys()
    bs = tboot.bootstrap_group_means(tk, vals, gid, 2, n_resamples=50, device="cpu")
    want = rboot.bootstrap_group_means(jk, vals, gid, 2, n_resamples=50)
    np.testing.assert_allclose(bs.mean, np.asarray(want.mean), **TOL)
    np.testing.assert_allclose(bs.std, np.asarray(want.std), rtol=1e-4)
    assert bs.std[0] < bs.std[1]  # a bigger stratum gives a tighter statistic
    assert bs.mean == pytest.approx([vals[gid == 0].mean(), vals[gid == 1].mean()], abs=1.0)


def test_size_estimation_accuracy(dbs):
    rdb, tdb = dbs
    jk, tk = _keys()
    tq = T.Query("crimes", ("district", "year"), T.Aggregate("sum", "records"),
                 having=T.Having(">", 100.0))
    rq = R.Query("crimes", ("district", "year"), R.Aggregate("sum", "records"),
                 having=R.Having(">", 100.0))
    s = tsamp.stratified_reservoir_sample(tk, tdb["crimes"], tq.groupby, 0.05)
    rs = rsamp.stratified_reservoir_sample(jk, rdb["crimes"], rq.groupby, 0.05)
    for attr in ("district", "year"):
        ranges = T.equi_depth_ranges(tdb["crimes"], attr, 20)
        est = tsize.estimate_size(tk, tq, tdb, ranges, s)
        want = rsize.estimate_size(jk, rq, rdb, R.equi_depth_ranges(rdb["crimes"], attr, 20), rs)
        assert est.est_rows == want.est_rows, attr
        actual = T.capture_sketch(tq, tdb, ranges).size_rows
        assert abs(est.est_rows - actual) / max(actual, 1) < 0.2, (attr, est.est_rows, actual)
        assert est.lo_rows <= est.hi_rows
        assert 0 <= est.est_selectivity <= 1


def test_sample_cache_reuse(dbs):
    rdb, tdb = dbs
    cache, rcache = tsamp.SampleCache(), rsamp.SampleCache()
    (jk0, tk0), (jk9, tk9) = _keys(0), _keys(9)
    s1 = cache.get_or_create(tk0, tdb["crimes"], ("district",), 0.05)
    s2 = cache.get_or_create(tk9, tdb["crimes"], ("district",), 0.05)
    r1 = rcache.get_or_create(jk0, rdb["crimes"], ("district",), 0.05)
    rcache.get_or_create(jk9, rdb["crimes"], ("district",), 0.05)
    assert s1 is s2 and cache.hits == 1 and cache.misses == 1
    assert (cache.hits, cache.misses) == (rcache.hits, rcache.misses)
    _same_sample(s1, r1)


def _aqr_setup(mod, samp, size, db, keyfn):
    cache = samp.AQRCache(max_entries=2)
    qs = [mod.Query("crimes", (gb,), mod.Aggregate("count", None), having=mod.Having(">", 5.0))
          for gb in ("district", "month", "year")]
    return cache, samp.SampleCache(), size.EstimationConfig(), keyfn(0), qs


def test_aqr_cache_eviction_overflow_and_recompute():
    """The FIFO overflow branch: evicted passes recompute bit-identically and
    the counters follow the calls, in both packages alike."""
    rdb, tdb = _crimes(8_000, 3)
    sides = {}
    for name, mod, samp, size, db, keyfn in (
            ("t", T, tsamp, tsize, tdb, prng.PRNGKey), ("r", R, rsamp, rsize, rdb, jax.random.PRNGKey)):
        cache, scache, cfg, key, qs = _aqr_setup(mod, samp, size, db, keyfn)
        fact = db["crimes"]
        outs = []
        for q in qs:
            samples = scache.get_or_create(key, fact, q.groupby_on_fact(db), 0.2)
            outs.append(cache.get_or_compute(key, q, db, samples, 0.2, cfg))
        assert cache.misses == 3 and cache.hits == 0
        assert cache.evictions == 1 and len(cache._cache) == 2
        samples0 = scache.get_or_create(key, fact, qs[0].groupby_on_fact(db), 0.2)
        est2, sampled2 = cache.get_or_compute(key, qs[0], db, samples0, 0.2, cfg)
        est1, sampled1 = outs[0]
        np.testing.assert_array_equal(np.asarray(est1.estimate), np.asarray(est2.estimate))
        np.testing.assert_array_equal(np.asarray(est1.sigma), np.asarray(est2.sigma))
        np.testing.assert_array_equal(sampled1, sampled2)
        assert cache.misses == 4 and cache.evictions == 2
        before = dict(cache._cache)
        cache.get_or_compute(key, qs[0], db, samples0, 0.2, cfg)
        assert cache.hits == 1 and cache.evictions == 2 and list(cache._cache) == list(before)
        assert cache.hits + cache.misses == 5
        sides[name] = [(np.asarray(e.estimate), s) for e, s in outs]
    for (te, ts), (re, rs) in zip(sides["t"], sides["r"]):
        np.testing.assert_array_equal(te, re)
        np.testing.assert_array_equal(ts, rs)


def test_aqr_cache_version_churn_invalidation():
    """A mutated table never serves a stale pass, and ``invalidate`` drops
    every entry of the table."""
    rdb, tdb = _crimes(8_000, 3)
    for mod, samp, size, db, keyfn in ((T, tsamp, tsize, tdb, prng.PRNGKey),
                                       (R, rsamp, rsize, rdb, jax.random.PRNGKey)):
        cache = samp.AQRCache(max_entries=8)
        scache, cfg, key = samp.SampleCache(), size.EstimationConfig(), keyfn(0)
        q = mod.Query("crimes", ("district",), mod.Aggregate("count", None),
                      having=mod.Having(">", 5.0))
        fact = db["crimes"]
        samples = scache.get_or_create(key, fact, q.groupby_on_fact(db), 0.2)
        cache.get_or_compute(key, q, db, samples, 0.2, cfg)
        fact2 = fact.append({a: np.asarray(fact[a])[:16] for a in fact.schema})
        db2 = db.with_table(fact2)
        samples2 = scache.get_or_create(key, fact2, q.groupby_on_fact(db2), 0.2)
        cache.get_or_compute(key, q, db2, samples2, 0.2, cfg)
        assert cache.misses == 2 and cache.hits == 0  # no stale serve
        assert len(cache._cache) == 2
        cache.invalidate("crimes")
        assert len(cache._cache) == 0
        cache.get_or_compute(key, q, db2, samples2, 0.2, cfg)
        assert cache.misses == 3
