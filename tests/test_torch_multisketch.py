"""Composite (multi-attribute) sketches in the port against the reference:
twins of the 8 tests of ``tests/test_multisketch.py``, each run on both
packages over the same crimes table with the reference test's assertions
and tolerances, the port's bits, choices and sizes held against the
reference's; plus a composite bucketization refreshed across
``append_rows``/``delete_rows`` against a fresh one.
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
from repro.core import multisketch as RM
import repro_torch.core as T
from repro_torch import prng
from repro_torch.aqp import sampling as tsamp
from repro_torch.aqp import size_estimation as tse
from repro_torch.convert import database_from_numpy
from repro_torch.core import multisketch as TM
from repro_torch.device import to_host

torch.set_num_threads(1)  # small tensors; leave the cores to the other xdist workers

# (core module, multisketch module, sampling, size estimation, key constructor)
SIDES = {"reference": (R, RM, rsamp, rse, jax.random.PRNGKey),
         "port": (T, TM, tsamp, tse, prng.PRNGKey)}


@pytest.fixture(scope="module")
def dbs():
    rdb = R.Database({"crimes": rdata.make_crimes(15_000, seed=31)})
    tdb = database_from_numpy(
        [("crimes", {a: np.asarray(rdb["crimes"][a]) for a in rdb["crimes"].schema},
          rdb["crimes"].primary_key)], device="cpu")
    return {"reference": rdb, "port": tdb}


def _q(mod, db):
    base = mod.Query("crimes", ("district", "year"), mod.Aggregate("sum", "records"))
    tau = float(np.quantile(mod.execute(base, db).values, 0.9))
    return dataclasses.replace(base, having=mod.Having(">", tau))


def _host(x):
    return to_host(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def test_composite_sketch_safe(dbs):
    out = {}
    for side, (mod, ms, *_) in SIDES.items():
        db = dbs[side]
        q = _q(mod, db)
        cr = ms.composite_ranges(db["crimes"], ("district", "year"), 100)
        sk = ms.capture_composite(q, db, cr)
        assert ms.execute_with_composite(q, db, sk).canonical() == mod.execute(q, db).canonical()
        assert 0.0 < sk.selectivity <= 1.0
        out[side] = (sk.bits, sk.size_rows, sk.ranges.n_ranges)
    np.testing.assert_array_equal(out["port"][0], out["reference"][0])
    assert out["port"][1:] == out["reference"][1:]


def test_composite_never_larger_than_singles(dbs):
    """A GB-pair partition refines both of its parts: selectivity can only drop."""
    sels = {}
    for side, (mod, ms, *_) in SIDES.items():
        db = dbs[side]
        q = _q(mod, db)
        cr = ms.composite_ranges(db["crimes"], ("district", "year"), 100)
        comp = ms.capture_composite(q, db, cr)
        for part in cr.parts:
            single = mod.capture_sketch(q, db, part)
            assert comp.selectivity <= single.selectivity + 1e-9
            sels[(side, part.attr)] = single.selectivity
        sels[(side, "composite")] = comp.selectivity
    for attr in ("district", "year", "composite"):
        assert sels[("port", attr)] == sels[("reference", attr)]


def test_composite_bucketize_is_cross_product(dbs):
    buckets = {}
    for side, (_, ms, *_) in SIDES.items():
        t = dbs[side]["crimes"]
        cr = ms.composite_ranges(t, ("district", "year"), 64)
        b = _host(cr.bucketize(t))
        assert b.min() >= 0 and b.max() < cr.n_ranges
        b0 = _host(cr.parts[0].bucketize(t["district"]))
        b1 = _host(cr.parts[1].bucketize(t["year"]))
        np.testing.assert_array_equal(b, b0 * cr.parts[1].n_ranges + b1)
        buckets[side] = (b, cr.n_ranges, cr.attrs)
    np.testing.assert_array_equal(buckets["port"][0], buckets["reference"][0])
    assert buckets["port"][1:] == buckets["reference"][1:]


def test_composite_parity_with_single_attribute_path(dbs):
    """On a 2-attribute workload every query answered through the composite
    path matches the single-attribute sketch path and NO-PS execution."""
    got = {}
    for side, (mod, ms, *_) in SIDES.items():
        db = dbs[side]
        base = mod.Query("crimes", ("district", "year"), mod.Aggregate("sum", "records"))
        sums = mod.execute(base, db).values
        wl = [dataclasses.replace(base, having=mod.Having(">", float(np.quantile(sums, qt))))
              for qt in (0.5, 0.75, 0.9)]
        count = mod.Query("crimes", ("district", "year"), mod.Aggregate("count", None))
        wl.append(dataclasses.replace(count, having=mod.Having(
            ">", float(np.quantile(mod.execute(count, db).values, 0.8)))))
        cat = mod.Catalog()
        cr = ms.composite_ranges(db["crimes"], ("district", "year"), 100)
        got[side] = []
        for q in wl:
            want = mod.execute(q, db).canonical()
            comp = ms.capture_composite(q, db, cr, catalog=cat)
            assert ms.execute_with_composite(q, db, comp, catalog=cat).canonical() == want
            for attr in ("district", "year"):
                single = mod.capture_sketch(
                    q, db, mod.equi_depth_ranges(db["crimes"], attr, 100), catalog=cat)
                assert mod.execute_with_sketch(q, db, single, catalog=cat).canonical() == want
            got[side].append((want, comp.bits.tolist(), comp.size_rows))
    assert got["port"] == got["reference"]


def test_composite_path_goes_through_catalog(dbs):
    """Repeated composite capture and application over one partition reuse
    the catalog's bucketization, fragment sizes and sketch instance."""
    counters = {}
    for side, (mod, ms, *_) in SIDES.items():
        db = dbs[side]
        q = _q(mod, db)
        cat = mod.Catalog()
        cr = ms.composite_ranges(db["crimes"], ("district", "year"), 64)
        sk = ms.capture_composite(q, db, cr, catalog=cat)
        ms.execute_with_composite(q, db, sk, catalog=cat)
        stats1 = dict(cat.stats)
        assert stats1.get("bucketize", 0) >= 1
        sk2 = ms.capture_composite(q, db, cr, catalog=cat)
        ms.execute_with_composite(q, db, sk2, catalog=cat)
        ms.execute_with_composite(q, db, sk, catalog=cat)
        stats2 = dict(cat.stats)
        assert stats2.get("bucketize", 0) == stats1.get("bucketize", 0)
        assert stats2.get("fragment_sizes", 0) == stats1.get("fragment_sizes", 0)
        assert stats2.get("bucketize_hit", 0) > stats1.get("bucketize_hit", 0)
        assert stats2.get("instance_hit", 0) > stats1.get("instance_hit", 0)
        np.testing.assert_array_equal(sk.bits, sk2.bits)
        counters[side] = {k: stats2.get(k, 0) for k in
                          ("bucketize", "fragment_sizes", "instance_build", "instance_hit")}
    assert counters["port"] == counters["reference"]


def _gb_cands(ms, fact):
    return {
        ("district",): ms.composite_ranges(fact, ("district",), 64),
        ("year",): ms.composite_ranges(fact, ("year",), 64),
        ("district", "year"): ms.composite_ranges(fact, ("district", "year"), 64),
        # A non-GB attribute exercises the sample-row (slow) composite path.
        ("beat", "district"): ms.composite_ranges(fact, ("beat", "district"), 64),
    }


def test_composite_batched_estimation_matches_per_candidate_loop(dbs):
    """Composite candidates through ``estimate_size_batched`` agree with the
    single-candidate loop (the reference test's tolerances), and the port's
    estimates equal the reference's."""
    est = {}
    for side, (mod, ms, samp, se, key_of) in SIDES.items():
        db = dbs[side]
        q = _q(mod, db)
        key = key_of(3)
        fact = db["crimes"]
        samples = samp.stratified_reservoir_sample(key, fact, ("district", "year"), 0.1)
        aqr = se.approximate_query_result(key, q, db, samples)
        cands = _gb_cands(ms, fact)
        batched = se.estimate_size_batched(key, q, db, cands, samples, aqr=aqr)
        for attrs, cr in cands.items():
            ref = se.estimate_size(key, q, db, cr, samples, aqr=aqr)
            got = batched[attrs]
            assert got.attr == attrs
            np.testing.assert_array_equal(got.est_bits, ref.est_bits)
            assert got.est_rows == pytest.approx(ref.est_rows, rel=1e-5)
            assert got.expected_rows == pytest.approx(ref.expected_rows, rel=1e-4)
            assert got.lo_rows == pytest.approx(ref.lo_rows, rel=1e-4)
            assert got.hi_rows == pytest.approx(ref.hi_rows, rel=1e-4)
        est[side] = batched
    for attrs, r in est["reference"].items():
        t = est["port"][attrs]
        np.testing.assert_array_equal(t.est_bits, r.est_bits)
        assert t.est_rows == r.est_rows and t.n_satisfied_groups == r.n_satisfied_groups
        np.testing.assert_allclose([t.expected_rows, t.lo_rows, t.hi_rows],
                                   [r.expected_rows, r.lo_rows, r.hi_rows], rtol=1e-5)


def test_cb_opt_gb2_sizes_match_exact_membership(dbs):
    """The batched GB fast path: size == #rows whose composite fragment is
    hit by a satisfied group; the port's ``best``, its ranges and every size
    equal the reference's (rel 1e-6)."""
    picks = {}
    for side, (mod, ms, samp, se, key_of) in SIDES.items():
        db = dbs[side]
        q = _q(mod, db)
        fact = db["crimes"]
        gb = ("district", "year")
        split = jax.random.split if side == "reference" else prng.split
        k_s, k_e = split(key_of(0))
        samples = samp.stratified_reservoir_sample(k_s, fact, gb, 0.1)
        _, satisfied = se.approximate_query_result(k_e, q, db, samples)
        best, cr_best, sizes = ms.select_composite_gb(key_of(0), q, db, 100, theta=0.1)
        total = fact.num_rows
        for attrs in [("district",), ("year",), ("district", "year")]:
            cr = ms.composite_ranges(fact, attrs, 100)
            frag = None
            for r in cr.parts:
                vals = np.asarray(samples.group_values[r.attr])
                b = _host(r.bucketize(vals if side == "reference" else torch.from_numpy(vals)))
                frag = b if frag is None else frag * r.n_ranges + b
            sat_frags = np.unique(frag[np.nonzero(satisfied)[0]])
            exact = float(np.isin(_host(cr.bucketize(fact)), sat_frags).sum()) / total
            assert sizes[attrs] == pytest.approx(exact, rel=1e-6)
        picks[side] = (best, cr_best.key(), sizes)
    (rb, rkey, rsizes), (tb, tkey, tsizes) = picks["reference"], picks["port"]
    assert tb == rb and tkey == rkey and set(tsizes) == set(rsizes)
    for attrs in rsizes:
        assert tsizes[attrs] == pytest.approx(rsizes[attrs], rel=1e-6)


def test_cb_opt_gb2_selects_reasonably(dbs):
    picks = {}
    for side, (mod, ms, *_, key_of) in SIDES.items():
        db = dbs[side]
        q = _q(mod, db)
        best, cr, sizes = ms.select_composite_gb(key_of(0), q, db, 100, theta=0.1)
        sk = ms.capture_composite(q, db, cr)
        assert abs(sk.selectivity - sizes[best]) < 0.15
        singles = {k: v for k, v in sizes.items() if len(k) == 1}
        assert sizes[best] <= min(singles.values()) + 1e-9
        picks[side] = (best, sk.bits.tolist(), sk.size_rows)
    assert picks["port"] == picks["reference"]


def test_composite_bucketize_refreshes_across_mutations(dbs):
    """A composite bucketization cached on a table, refreshed through an
    append and then a delete (the catalog's delta path), equals a fresh
    bucketization of each version; so do its fragment sizes and the
    group-by fast path's fragment per group."""
    tdb = dbs["port"]
    eng = T.PBDSEngine(tdb, strategy="CB-OPT-GB", n_ranges=64, theta=0.1, seed=0)
    fact = eng.db["crimes"]
    cr = TM.composite_ranges(fact, ("district", "year"), 64)
    cat = eng.catalog
    cat.bucketize(fact, cr)
    rng = np.random.default_rng(5)
    rows = rng.integers(0, fact.num_rows, 700)
    eng.append_rows("crimes", {a: to_host(fact[a])[rows] for a in fact.schema})
    appended = eng.db["crimes"]
    eng.delete_rows("crimes", to_host(appended["month"]) == 3)
    for table in (appended, eng.db["crimes"]):
        before = cat.stats["bucketize"]
        got = to_host(cat.bucketize(table, cr))
        assert cat.stats["bucketize"] == before  # refreshed from the delta, not redone
        fresh = T.Catalog()
        np.testing.assert_array_equal(got, to_host(fresh.bucketize(table, cr)))
        np.testing.assert_array_equal(cat.fragment_sizes(table, cr),
                                      fresh.fragment_sizes(table, cr))
        enc = fresh.groups(table, ("district", "year"))
        frag = cat.frag_of_group(table, cr, ("district", "year"), enc.group_values)
        np.testing.assert_array_equal(frag, got[np.unique(enc.gid, return_index=True)[1]])
    assert cat.stats["bucketize_delta"] >= 2
