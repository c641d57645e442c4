"""The port's catalog against the reference's: twins of the non-join cases
of ``tests/test_catalog.py`` (the WHERE-mask cache's hit, miss and delta
refresh, the executor's use of it, the zero-host-encode second pass of a
crimes workload, the group-encoding identity and the fragment-of-group
vector cached per table version, with a composite partition added), each
run on both packages with the reference test's counters and held against
the reference's results.
"""
import jax
import numpy as np
import pytest
import torch

import repro.core as R
from repro.aqp import sampling as rsamp
from repro.aqp import size_estimation as rse
from repro.core import datasets as rdata
from repro.core import multisketch as RM
from repro.core.workload import CRIMES_SPEC as R_SPEC, generate_workload as r_generate
import repro_torch.core as T
from repro_torch import prng
from repro_torch.aqp import sampling as tsamp
from repro_torch.aqp import size_estimation as tse
from repro_torch.convert import database_from_numpy
from repro_torch.core import multisketch as TM
from repro_torch.core.workload import CRIMES_SPEC as T_SPEC, generate_workload as t_generate
from repro_torch.device import to_host

torch.set_num_threads(1)  # small tensors; leave the cores to the other xdist workers


def _crimes(n, seed):
    rt = rdata.make_crimes(n, seed=seed)
    tdb = database_from_numpy(
        [("crimes", {a: np.asarray(rt[a]) for a in rt.schema}, rt.primary_key)], device="cpu")
    return rt, tdb["crimes"]


def _host(x):
    return to_host(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _rows(t, take=slice(None)):
    """A table's columns as host arrays (a batch for ``append``)."""
    return {a: _host(t[a])[take] for a in t.schema}


def test_where_mask_cache_hit_miss_and_delta_refresh():
    """Repeated WHERE predicates evaluate once per table version; appends and
    deletes refresh the cached mask from the delta, never a full re-eval."""
    rt, tt = _crimes(8_000, 19)
    rbatch, _ = _crimes(1_000, 20)
    masks = {}
    for mod, t in ((R, rt), (T, tt)):
        cat = mod.Catalog()
        pred = mod.Predicate("year", ">", 2015.0)
        m1 = cat.where_mask(t, pred)
        assert cat.stats["where_mask"] == 1 and cat.stats["where_mask_hit"] == 0
        assert cat.where_mask(t, pred) is m1
        assert cat.stats["where_mask_hit"] == 1
        cat.where_mask(t, mod.Predicate("year", ">", 2018.0))
        assert cat.stats["where_mask"] == 2
        t2 = t.append(_rows(rbatch))
        m3 = cat.where_mask(t2, pred)
        assert cat.stats["where_mask_delta"] == 1 and cat.stats["where_mask"] == 2
        np.testing.assert_array_equal(_host(m3), _host(pred.mask(t2)))
        mask = np.zeros(t2.num_rows, dtype=bool)
        mask[::7] = True
        t3 = t2.delete(mask)
        m4 = cat.where_mask(t3, pred)
        assert cat.stats["where_mask_delta"] == 2 and cat.stats["where_mask"] == 2
        np.testing.assert_array_equal(_host(m4), _host(pred.mask(t3)))
        masks[mod] = (_host(m1), _host(m3), _host(m4))
    for a, b in zip(masks[T], masks[R]):
        np.testing.assert_array_equal(a, b)


def test_executor_uses_where_cache():
    """Replaying a WHERE query re-uses the cached mask (no re-evaluation)."""
    rt, tt = _crimes(8_000, 23)
    results = []
    for mod, t in ((R, rt), (T, tt)):
        db = mod.Database({"crimes": t})
        q = mod.Query("crimes", ("district",), mod.Aggregate("sum", "records"),
                      where=mod.Predicate("year", ">", 2015.0))
        cat = mod.Catalog()
        want = mod.execute(q, db, catalog=cat).canonical()
        assert cat.stats["where_mask"] == 1
        assert mod.execute(q, db, catalog=cat).canonical() == want
        assert cat.stats["where_mask"] == 1 and cat.stats["where_mask_hit"] == 1
        results.append(want)
    assert results[1] == results[0]


def test_second_workload_pass_does_zero_host_encode_work():
    """Replaying a crimes workload hits the catalog's caches only: no new
    group encodes, bucketizations, instance builds or distinct counts."""
    rt, tt = _crimes(20_000, 5)
    out = []
    for mod, t, gen, spec in ((R, rt, r_generate, R_SPEC), (T, tt, t_generate, T_SPEC)):
        db = mod.Database({"crimes": t})
        wl = gen(spec, db, 5, seed=5)
        eng = mod.PBDSEngine(db, strategy="CB-OPT-GB", n_ranges=50, theta=0.1, seed=0,
                             cluster_tables=False)
        first = [eng.run(q) for q in wl]
        s1 = dict(eng.catalog.stats)
        second = [eng.run(q) for q in wl]
        s2 = dict(eng.catalog.stats)
        assert any(i.reused for _, i in second)
        for counter in ("encode_groups", "join_materialize", "bucketize",
                        "instance_build", "distinct_count"):
            assert s2.get(counter, 0) == s1.get(counter, 0), counter
        assert s2.get("encode_groups_hit", 0) > s1.get("encode_groups_hit", 0)
        n_reused = sum(1 for _, i in second if i.reused)
        assert s2.get("instance_hit", 0) - s1.get("instance_hit", 0) >= n_reused
        out.append([(r.canonical(), i.reused, i.created, i.attr) for r, i in first + second])
    assert out[1] == out[0]


def test_catalog_group_encoding_identity():
    """Same (table, key) -> the identical cached encoding object; a
    different table object recomputes; the encodings equal the reference's."""
    rt, tt = _crimes(3_000, 1)
    encs = []
    for mod, t in ((R, rt), (T, tt)):
        cat = mod.Catalog()
        e1 = cat.groups(t, ("district", "year"))
        assert cat.groups(t, ("district", "year")) is e1
        assert cat.stats["encode_groups"] == 1 and cat.stats["encode_groups_hit"] == 1
        e3 = cat.groups(t.gather(np.arange(t.num_rows)), ("district", "year"))
        assert e3 is not e1 and cat.stats["encode_groups"] == 2
        encs.append(e1)
    np.testing.assert_array_equal(encs[1].gid, encs[0].gid)
    assert encs[1].n_groups == encs[0].n_groups


PARTITIONS = {
    "single": lambda mod, ms, t: {a: mod.equi_depth_ranges(t, a, 40)
                                  for a in ("district", "year")},
    "composite": lambda mod, ms, t: {
        ("district",): ms.composite_ranges(t, ("district",), 40),
        ("district", "year"): ms.composite_ranges(t, ("district", "year"), 40)},
}


@pytest.mark.parametrize("partition", sorted(PARTITIONS))
def test_frag_of_group_cached_per_table_version(partition):
    """The group-by fast path's fragment-of-group vector is bucketized once
    per (table version, group-by, partition) and then served from the
    catalog, for single-attribute and composite partitions alike; the
    estimates equal the reference's."""
    rt, tt = _crimes(20_000, 9)
    ests = []
    for mod, ms, samp, se, key_of in ((R, RM, rsamp, rse, jax.random.PRNGKey),
                                      (T, TM, tsamp, tse, prng.PRNGKey)):
        t = rt if mod is R else tt
        db = mod.Database({"crimes": t})
        q = mod.Query("crimes", ("district", "year"), mod.Aggregate("sum", "records"),
                      having=mod.Having(">", 400.0))
        key = key_of(0)
        samples = samp.stratified_reservoir_sample(key, t, q.groupby, 0.1)
        aqr = se.approximate_query_result(key, q, db, samples)
        ranges_by = PARTITIONS[partition](mod, ms, t)
        cat = mod.Catalog()
        first = se.estimate_size_batched(key, q, db, ranges_by, samples, aqr=aqr, catalog=cat)
        assert cat.stats["frag_of_group"] == 2  # one per partition
        assert cat.stats["frag_of_group_hit"] == 0
        se.estimate_size_batched(key, q, db, ranges_by, samples, aqr=aqr, catalog=cat)
        assert cat.stats["frag_of_group"] == 2 and cat.stats["frag_of_group_hit"] == 2
        # A new table version recomputes (the group dictionary may have grown).
        t2 = t.append(_rows(t, np.arange(100)))
        db2 = mod.Database({"crimes": t2})
        samples2 = samp.extend_sample_for_append(key, samples, (t2.delta.appended,),
                                                 (t.num_rows,))
        aqr2 = se.approximate_query_result(key, q, db2, samples2)
        second = se.estimate_size_batched(key, q, db2, ranges_by, samples2, aqr=aqr2, catalog=cat)
        assert cat.stats["frag_of_group"] == 4
        ests.append((first, second))
    for t_est, r_est in zip(ests[1], ests[0]):
        assert set(t_est) == set(r_est)
        for a in r_est:
            np.testing.assert_array_equal(t_est[a].est_bits, r_est[a].est_bits)
            assert t_est[a].est_rows == r_est[a].est_rows
