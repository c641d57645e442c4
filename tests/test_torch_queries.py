"""The port's executor against the reference: the paper's Fig. 1 example
with its exact values, and ``execute`` / ``execute_and_provenance`` on
Q-AGH and Q-AAGH queries over crimes and stars (canonical results and
provenance masks equal; both sum float32 in row order on the CPU)."""
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import datasets as rdata
import repro_torch.core as T
from repro_torch.core import datasets as tdata
from repro_torch.core.sketch import actual_size

torch.set_num_threads(1)  # small tensors; leave the cores to the other xdist workers


def _q(mod, table, groupby, agg, having=None, where=None, outer=None):
    kw = dict(table=table, groupby=groupby, agg=mod.Aggregate(*agg))
    if having is not None:
        kw["having"] = mod.Having(*having)
    if where is not None:
        kw["where"] = mod.Predicate(*where)
    if outer is not None:
        og, oagg, oh = outer
        kw.update(outer_groupby=og, outer_agg=mod.Aggregate(*oagg),
                  outer_having=mod.Having(*oh) if oh else None)
    return mod.Query(**kw)


FIG1 = dict(table="crimes", groupby=("pid", "month", "year"), agg=("sum", "records"),
            having=(">=", 100))


@pytest.fixture(scope="module")
def fig1():
    return tdata.paper_example_db(device="cpu"), _q(T, **FIG1)


def test_fig1_query_result(fig1):
    db, q = fig1
    assert T.execute(q, db).canonical() == (
        (1.0, 4.0, 2013.0, 174.0),
        (6.0, 8.0, 2015.0, 182.0),
        (7.0, 2.0, 2016.0, 157.0),
    )


def test_fig1_provenance_rows(fig1):
    db, q = fig1
    assert T.provenance_mask(q, db).tolist() == [False, True, True, True, True, True, False, False]


@pytest.mark.parametrize("attr,bounds,bits,selectivity", [
    ("pid", [3.5, 6.5], [True, True, True], 1.0),
    ("month", [4.5, 8.5], [True, True, False], 7 / 8),
    ("year", [2012.5, 2020.5], [False, True, False], 5 / 8),
])
def test_fig1_sketches(fig1, attr, bounds, bits, selectivity):
    db, q = fig1
    sk = T.capture_sketch(q, db, T.RangeSet(attr, np.array(bounds)))
    assert sk.bits.tolist() == bits
    assert sk.selectivity == pytest.approx(selectivity)
    assert T.is_safe_sketch(q, db, sk)


def test_fig1_year_sketch_range_condition(fig1):
    db, q = fig1
    (lo, hi), = T.capture_sketch(q, db, T.RangeSet("year", np.array([2012.5, 2020.5]))
                                 ).range_conditions()
    assert lo == pytest.approx(2012.5) and hi == pytest.approx(2020.5)


CRIMES_QUERIES = [
    dict(groupby=("district",), agg=("sum", "records"), having=(">", 15000.0)),
    dict(groupby=("district", "year"), agg=("avg", "records"), having=(">=", 12.5)),
    dict(groupby=("month", "pid"), agg=("count", None), having=(">", 112)),
    dict(groupby=("community", "year"), agg=("sum", "records"), where=("month", "<=", 6)),
    dict(groupby=("district", "year"), agg=("sum", "records"), having=(">", 90.0),
         outer=(("district",), ("count", None), (">", 3))),
    dict(groupby=("ward", "month"), agg=("count", None), having=(">=", 15),
         outer=(("ward",), ("sum", None), (">", 250.0))),
]
STARS_QUERIES = [
    dict(groupby=("field",), agg=("avg", "mag_g"), having=(">", 18.0)),
    dict(groupby=("run",), agg=("sum", "redshift"), having=(">", 1.5)),
    dict(groupby=("field", "run"), agg=("sum", "mag_r"), where=("redshift", ">", 0.1)),
    dict(groupby=("field", "run"), agg=("count", None), having=(">=", 1),
         outer=(("field",), ("avg", None), (">", 1.0))),
]


@pytest.fixture(scope="module")
def dbs():
    out = {}
    for name, make, kw in (("crimes", "make_crimes", dict(n=12_000, seed=4)),
                           ("stars", "make_stars", dict(n=12_000, seed=6))):
        out[name] = (R.Database({name: getattr(rdata, make)(**kw)}),
                     T.Database({name: getattr(tdata, make)(**kw, device="cpu")}))
    return out


@pytest.mark.parametrize("table,spec", [("crimes", s) for s in CRIMES_QUERIES]
                         + [("stars", s) for s in STARS_QUERIES])
def test_execute_and_provenance_match_reference(dbs, table, spec):
    rdb, tdb = dbs[table]
    rq, tq = _q(R, table, **spec), _q(T, table, **spec)
    assert rq.signature() == tq.signature() and rq.template == tq.template
    want_res, want_prov = R.execute_and_provenance(rq, rdb, catalog=R.Catalog())
    got_res, got_prov = T.execute_and_provenance(tq, tdb, catalog=T.Catalog())
    assert len(got_res.values) == len(want_res.values)
    assert got_res.canonical() == want_res.canonical()
    np.testing.assert_array_equal(got_prov, want_prov)
    assert T.execute(tq, tdb).canonical() == want_res.canonical()


@pytest.mark.parametrize("attr", ["district", "year", "community"])
def test_capture_and_sketch_instance_match_reference(dbs, attr):
    rdb, tdb = dbs["crimes"]
    spec = CRIMES_QUERIES[1]
    rq, tq = _q(R, "crimes", **spec), _q(T, "crimes", **spec)
    rr = R.equi_depth_ranges(rdb["crimes"], attr, 20)
    tr = T.equi_depth_ranges(tdb["crimes"], attr, 20)
    rsk = R.capture_sketch(rq, rdb, rr, catalog=R.Catalog())
    tsk = T.capture_sketch(tq, tdb, tr, catalog=T.Catalog())
    np.testing.assert_array_equal(tsk.bits, rsk.bits)
    assert (tsk.size_rows, tsk.total_rows) == (rsk.size_rows, rsk.total_rows)
    assert actual_size(tq, tdb, tr) == tsk.size_rows
    rcat, tcat = R.Catalog(), T.Catalog()
    rinst = R.apply_sketch(rsk, rdb, catalog=rcat)["crimes"]
    tinst = T.apply_sketch(tsk, tdb, catalog=tcat)["crimes"]
    assert tinst.num_rows == rinst.num_rows  # pow2-padded alike
    for a in rinst.schema:
        np.testing.assert_array_equal(tinst[a].numpy(), np.asarray(rinst[a]))
    assert (T.execute_with_sketch(tq, tdb, tsk, catalog=tcat).canonical()
            == R.execute_with_sketch(rq, rdb, rsk, catalog=rcat).canonical())
    assert tcat.stats["encode_groups_instance"] == 1


def test_join_templates_wait_for_their_slice(dbs):
    _, tdb = dbs["crimes"]
    q = T.Query("crimes", ("district",), T.Aggregate("count"),
                join=T.JoinSpec("other", "district", "district"))
    with pytest.raises(NotImplementedError):
        T.execute(q, tdb)
