"""Hypothesis twins of ``tests/test_property.py``'s five properties, run
against the port and, on the same drawn data, against the reference: its
sketch bits (properties 1, 2 and 4), its estimate (3), its subsumption
verdict and result (4), and its maintained bits after every step (5):

  1. SAFETY: the sketch-instrumented query returns the full-data result.
  2. Accurate sketch bits equal the brute-force fragment incidence of the
     provenance.
  3. Size estimation is bounded by the table size; the Frechet interval is
     ordered.
  4. Index subsumption never returns an unsafe sketch.
  5. MAINTENANCE: across any append/delete sequence, maintained bits are a
     superset of the re-capture oracle's, equal for monotone-safe
     aggregates, and equal for every aggregate after ``repair()``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis", reason="property tests need hypothesis (pip install -r requirements-dev.txt)")

from hypothesis import HealthCheck, assume, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro.core as R  # noqa: E402
from repro.aqp.sampling import stratified_reservoir_sample as r_sample  # noqa: E402
from repro.aqp.size_estimation import estimate_size as r_estimate  # noqa: E402
from repro.core.table import from_numpy as r_from_numpy  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.aqp.sampling import stratified_reservoir_sample as t_sample  # noqa: E402
from repro_torch.aqp.size_estimation import estimate_size as t_estimate  # noqa: E402
from repro_torch.device import to_host  # noqa: E402

torch.set_num_threads(1)  # small tensors; leave the cores to the other xdist workers

SETTINGS = dict(
    max_examples=10,
    deadline=None,
    suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large],
)


def _port_table(cols):
    return T.from_numpy("t", cols, device="cpu")


@st.composite
def table_and_query(draw):
    n = draw(st.integers(min_value=30, max_value=400))
    seed = draw(st.integers(min_value=0, max_value=2**31 - 1))
    rng = np.random.default_rng(seed)
    ncat = draw(st.integers(min_value=2, max_value=12))
    cols = dict(
        a=rng.integers(0, ncat, n).astype(np.int32),
        b=rng.integers(0, ncat * 2, n).astype(np.int32),
        c=rng.integers(0, 50, n).astype(np.int32),
        v=rng.integers(0, 100, n).astype(np.int32),  # non-negative values
    )
    gb = draw(st.sampled_from([("a",), ("b",), ("a", "b")]))
    fn = draw(st.sampled_from(["sum", "count", "avg"]))
    tau = draw(st.floats(min_value=1.0, max_value=500.0))
    attr_pool = list(gb) if fn == "avg" else ["a", "b", "c"]
    attr = draw(st.sampled_from(attr_pool))
    n_ranges = draw(st.integers(min_value=2, max_value=20))
    return cols, (gb, fn, tau), attr, n_ranges


def _query(mod, spec):
    gb, fn, tau = spec
    return mod.Query("t", gb, mod.Aggregate(fn, None if fn == "count" else "v"),
                     having=mod.Having(">", tau))


def _both(cols, spec):
    """(reference db, query), (port db, query) over the same columns."""
    return ((R.Database({"t": r_from_numpy("t", cols)}), _query(R, spec)),
            (T.Database({"t": _port_table(cols)}), _query(T, spec)))


@given(table_and_query())
@settings(**SETTINGS)
def test_sketch_safety_invariant(tq):
    cols, spec, attr, n_ranges = tq
    (rdb, rq), (db, q) = _both(cols, spec)
    ranges = T.equi_depth_ranges(db["t"], attr, n_ranges)
    sk = T.capture_sketch(q, db, ranges, catalog=T.Catalog())
    assert T.execute_with_sketch(q, db, sk, catalog=T.Catalog()).canonical() == \
        T.execute(q, db).canonical()
    assert 0.0 <= sk.selectivity <= 1.0
    rsk = R.capture_sketch(rq, rdb, R.equi_depth_ranges(rdb["t"], attr, n_ranges),
                           catalog=R.Catalog())
    np.testing.assert_array_equal(sk.bits, rsk.bits)
    assert sk.size_rows == rsk.size_rows


@given(table_and_query())
@settings(**SETTINGS)
def test_sketch_bits_are_exact_incidence(tq):
    cols, spec, attr, n_ranges = tq
    (rdb, rq), (db, q) = _both(cols, spec)
    ranges = T.equi_depth_ranges(db["t"], attr, n_ranges)
    sk = T.capture_sketch(q, db, ranges, catalog=T.Catalog())
    prov = T.provenance_mask(q, db, catalog=T.Catalog())
    np.testing.assert_array_equal(prov, R.provenance_mask(rq, rdb, catalog=R.Catalog()))
    bucket = to_host(ranges.bucketize(db["t"][attr]))
    want = np.zeros(ranges.n_ranges, bool)
    for r in bucket[prov]:
        want[r] = True
    np.testing.assert_array_equal(sk.bits, want)


@given(table_and_query())
@settings(**SETTINGS)
def test_size_estimate_bounded(tq):
    cols, spec, attr, n_ranges = tq
    (rdb, rq), (db, q) = _both(cols, spec)
    ranges = T.equi_depth_ranges(db["t"], attr, n_ranges)
    s = t_sample(prng.PRNGKey(0), db["t"], q.groupby, 0.3)
    est = t_estimate(prng.PRNGKey(1), q, db, ranges, s, catalog=T.Catalog())
    n = db["t"].num_rows
    assert 0.0 <= est.est_rows <= n + 1e-6
    assert 0.0 <= est.est_selectivity <= 1.0
    assert est.lo_rows <= est.hi_rows + 1e-6
    assert est.expected_rows <= est.hi_rows + 1e-6
    rs = r_sample(jax.random.PRNGKey(0), rdb["t"], rq.groupby, 0.3)
    ref = r_estimate(jax.random.PRNGKey(1), rq, rdb, R.equi_depth_ranges(rdb["t"], attr, n_ranges),
                     rs, catalog=R.Catalog())
    np.testing.assert_array_equal(est.est_bits, ref.est_bits)
    assert est.est_rows == ref.est_rows


def _mut_table(rng, n, ncat):
    return dict(
        a=rng.integers(0, ncat, n).astype(np.int32),
        b=rng.integers(0, ncat * 3, n).astype(np.int32),
        v=rng.integers(0, 60, n).astype(np.int32),  # non-negative, f32-exact
    )


@st.composite
def maintenance_scenario(draw):
    """(initial table, query, sketch attr, ranges, ops); shrinks on the
    (ops-sequence, attr) pair."""
    seed = draw(st.integers(min_value=0, max_value=2**31 - 1))
    rng = np.random.default_rng(seed)
    n = draw(st.integers(min_value=40, max_value=250))
    ncat = draw(st.integers(min_value=2, max_value=10))
    fn = draw(st.sampled_from(["sum", "count", "avg"]))
    tau = draw(st.floats(min_value=1.0, max_value=400.0))
    spec = (("a",), fn, tau)
    # AVG is only safe on group-by attributes; sum/count are safe everywhere
    # here (non-negative v, upward-monotone HAVING).
    attr = draw(st.sampled_from(["a"] if fn == "avg" else ["a", "b"]))
    n_ranges = draw(st.integers(min_value=2, max_value=12))
    ops = draw(st.lists(
        st.one_of(
            st.tuples(st.just("append"), st.integers(1, 80)),
            st.tuples(st.just("delete"), st.integers(2, 9)),
        ),
        min_size=1, max_size=6))
    return _mut_table(rng, n, ncat), spec, attr, n_ranges, ops, seed, ncat


@given(maintenance_scenario())
@settings(**SETTINGS)
def test_maintained_bits_superset_and_exact_after_repair(scenario):
    cols, spec, attr, n_ranges, ops, seed, ncat = scenario
    rng = np.random.default_rng(seed + 1)
    (rdb, rq), (db, q) = _both(cols, spec)
    t, rt = db["t"], rdb["t"]
    ranges = T.equi_depth_ranges(t, attr, n_ranges)
    cat, rcat = T.Catalog(), R.Catalog()
    safe = T.monotone_safe(q, db, cat)
    assert safe == R.monotone_safe(rq, rdb, rcat)
    m = T.build_maintainer(q, db, ranges, cat)
    rm = R.build_maintainer(rq, rdb, R.equi_depth_ranges(rt, attr, n_ranges), rcat)

    for kind, arg in ops:
        if kind == "append":
            batch = _mut_table(rng, arg, ncat)
            t, rt = t.append(batch), rt.append(batch)
            cols = {k: np.concatenate([cols[k], batch[k]]) for k in cols}
        else:
            mask = to_host(t["b"]) % arg == 0
            if mask.all():
                continue
            t, rt = t.delete(mask), rt.delete(mask)
            keep = ~(cols["b"] % arg == 0)
            cols = {k: v[keep] for k, v in cols.items()}
        db, rdb = T.Database({"t": t}), R.Database({"t": rt})
        m.apply(t, db)
        rm.apply(rt, rdb)

        oracle = T.capture_sketch(q, T.Database({"t": _port_table(cols)}), ranges,
                                  catalog=T.Catalog())
        got = m.bits()
        np.testing.assert_array_equal(got, rm.bits())
        assert (got | oracle.bits == got).all(), "maintained bits lost coverage"
        if safe:
            np.testing.assert_array_equal(got, oracle.bits)
        m.repair()
        rm.repair()
        np.testing.assert_array_equal(m.bits(), oracle.bits)
        np.testing.assert_array_equal(m.bits(), rm.bits())


@given(table_and_query(), st.floats(min_value=0.0, max_value=300.0))
@settings(**SETTINGS)
def test_subsumption_soundness(tq, delta):
    """If subsumes(q1, q2), the q1 sketch answers q2 exactly."""
    cols, spec, attr, n_ranges = tq
    (rdb, rq1), (db, q1) = _both(cols, spec)
    q2 = dataclasses.replace(q1, having=T.Having(">", q1.having.value + delta))
    rq2 = dataclasses.replace(rq1, having=R.Having(">", rq1.having.value + delta))
    subsumed = T.subsumes(q1, q2)
    assert subsumed == R.subsumes(rq1, rq2)
    assume(subsumed)
    ranges = T.equi_depth_ranges(db["t"], attr, n_ranges)
    sk = T.capture_sketch(q1, db, ranges, catalog=T.Catalog())
    rsk = R.capture_sketch(rq1, rdb, R.equi_depth_ranges(rdb["t"], attr, n_ranges),
                           catalog=R.Catalog())
    np.testing.assert_array_equal(sk.bits, rsk.bits)
    got = T.execute_with_sketch(q2, db, sk, catalog=T.Catalog()).canonical()
    assert got == T.execute(q2, db).canonical()
    assert got == R.execute_with_sketch(rq2, rdb, rsk, catalog=R.Catalog()).canonical()
