"""Low-cardinality GROUP BY attributes in the port against the reference:
twins of ``tests/test_sketch_and_safety.py``'s low-cardinality block.
Group-by attributes are exempt from the distinct-count prefilter, so an
attribute with fewer distinct values than ``n_ranges`` reaches
``equi_depth_ranges``, whose deduplicated bounds collapse to a few fat,
value-aligned fragments; dedupe, capture, application, estimation and the
engine with maintenance must handle the degenerate partition, on both
packages alike.
"""
import numpy as np
import pytest
import torch

import jax

import repro.core as R
from repro.aqp import sampling as rsamp
from repro.aqp import size_estimation as rse
from repro.core.table import from_numpy as r_from_numpy
import repro_torch.core as T
from repro_torch import prng
from repro_torch.aqp import sampling as tsamp
from repro_torch.aqp import size_estimation as tse
from repro_torch.device import to_host

torch.set_num_threads(1)  # small tensors; leave the cores to the other xdist workers


def _lowcard_cols(n=6_000, n_distinct=3, seed=11):
    rng = np.random.default_rng(seed)
    return {"g": rng.integers(0, n_distinct, n).astype(np.float32),
            "v": rng.random(n).astype(np.float32)}


def _lowcard_db(mod):
    cols = _lowcard_cols()
    t = r_from_numpy("t", cols) if mod is R else T.from_numpy("t", cols, device="cpu")
    return mod.Database({"t": t})


def _lowcard_q(mod, tau=600.0):
    return mod.Query("t", ("g",), mod.Aggregate("count", None), having=mod.Having(">", tau))


def _host(x):
    return to_host(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def test_lowcard_gb_ranges_dedupe_and_value_align():
    out = []
    for mod in (R, T):
        db2 = _lowcard_db(mod)
        ranges = mod.equi_depth_ranges(db2["t"], "g", 10)
        assert ranges.n_ranges <= 3 + 1  # 3 distinct values -> at most 2 interior bounds
        assert np.all(np.diff(ranges.bounds) > 0)
        col = _host(db2["t"]["g"])
        frag = _host(ranges.bucketize(db2["t"]["g"]))
        for v in np.unique(col):
            assert len(np.unique(frag[col == v])) == 1
        out.append((ranges.bounds.tolist(), frag))
    assert out[1][0] == out[0][0]
    np.testing.assert_array_equal(out[1][1], out[0][1])


def test_lowcard_gb_capture_apply_execute():
    out = []
    for mod in (R, T):
        db2 = _lowcard_db(mod)
        q2 = _lowcard_q(mod, tau=2100.0)  # ~one of three groups passes
        ranges = mod.equi_depth_ranges(db2["t"], "g", 10)
        sk = mod.capture_sketch(q2, db2, ranges)
        assert mod.is_safe_sketch(q2, db2, sk)
        res = mod.execute_with_sketch(q2, db2, sk)
        assert res.canonical() == mod.execute(q2, db2).canonical()
        if 0 < int(np.asarray(sk.bits).sum()) < sk.ranges.n_ranges:
            assert sk.selectivity < 1.0
        out.append((sk.bits.tolist(), sk.size_rows, res.canonical()))
    assert out[1] == out[0]


def test_lowcard_gb_estimate_path():
    """The padded estimator takes a candidate whose deduped n_ranges is far
    below the requested count (ragged fragment axis)."""
    out = []
    for mod, samp, se, key_of in ((R, rsamp, rse, jax.random.PRNGKey),
                                  (T, tsamp, tse, prng.PRNGKey)):
        db2 = _lowcard_db(mod)
        q2 = _lowcard_q(mod, tau=2100.0)
        key = key_of(0)
        samples = samp.SampleCache().get_or_create(key, db2["t"], ("g",), 0.2)
        ranges = mod.equi_depth_ranges(db2["t"], "g", 10)
        est = se.estimate_size_batched(key, q2, db2, {"g": ranges}, samples,
                                       se.EstimationConfig())["g"]
        assert est.est_bits.shape[0] == ranges.n_ranges
        assert 0.0 <= est.est_selectivity <= 1.0
        out.append(est)
    r, t = out
    np.testing.assert_array_equal(t.est_bits, r.est_bits)
    assert (t.est_rows, t.est_selectivity, t.n_satisfied_groups) == (
        r.est_rows, r.est_selectivity, r.n_satisfied_groups)
    np.testing.assert_allclose([t.expected_rows, t.lo_rows, t.hi_rows],
                               [r.expected_rows, r.lo_rows, r.hi_rows], rtol=1e-5, atol=1e-6)


def test_lowcard_gb_engine_end_to_end_with_maintenance():
    """Engine admission, a repeat hit, then an append biased into one group
    and the repaired hit: results stay exact, and equal the reference's."""
    out = []
    for mod in (R, T):
        db2 = _lowcard_db(mod)
        q2 = _lowcard_q(mod, tau=1000.0)
        eng = mod.PBDSEngine(db2, strategy="CB-OPT-GB", n_ranges=10, theta=0.2, seed=0,
                             min_selectivity_gain=2.0)
        res, info = eng.run(q2)
        assert info.created
        assert res.canonical() == mod.execute(q2, db2).canonical()
        _, info2 = eng.run(q2)
        assert info2.reused
        eng.append_rows("t", {"g": np.full(500, 1.0, np.float32),
                              "v": np.linspace(0, 1, 500, dtype=np.float32)})
        res3, info3 = eng.run(q2)
        assert info3.reused and info3.repaired
        assert res3.canonical() == mod.execute(q2, eng.db).canonical()
        entry = eng.index.entries()[0]
        out.append((res.canonical(), res3.canonical(), info.attr, info.selectivity,
                    entry.sketch.bits.tolist(), entry.sketch.size_rows))
    assert out[1] == out[0]


@pytest.mark.parametrize("n_distinct", [1, 2, 5])
def test_lowcard_partition_matches_reference(n_distinct):
    """Fewer distinct values than ranges, down to one: the same deduped
    bounds, buckets and sketch as the reference."""
    cols = _lowcard_cols(n=3_000, n_distinct=n_distinct, seed=12)
    out = []
    for mod in (R, T):
        t = r_from_numpy("t", cols) if mod is R else T.from_numpy("t", cols, device="cpu")
        db2 = mod.Database({"t": t})
        q2 = _lowcard_q(mod, tau=float(3_000 // (n_distinct + 1)))
        ranges = mod.equi_depth_ranges(t, "g", 10)
        sk = mod.capture_sketch(q2, db2, ranges, catalog=mod.Catalog())
        res = mod.execute_with_sketch(q2, db2, sk, catalog=mod.Catalog())
        assert res.canonical() == mod.execute(q2, db2).canonical()
        out.append((ranges.bounds.tolist(), ranges.n_ranges, sk.bits.tolist(), sk.size_rows))
    assert out[1] == out[0]
