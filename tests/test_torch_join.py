"""The port's join templates (Q-AJGH, Q-AAJGH) against the reference's, on
the CPU: ``Catalog.join`` and its delta chain, joined execution and
provenance, wander join, the join branch of size estimation, sketch
application over joins and the engine end to end.

Both packages run on the same seeded numpy data.  Where the aggregate is
integral (``l_quantity``, ``count``) every sum is exact in float32, and
results, provenance, sketch bits, chosen attributes, index contents and
walk picks are held equal with no tolerance.  Where a twin aggregates
``l_extendedprice`` (non-integral), values are held to the reference test's
own ``rel=1e-4`` (``tests/test_queries.py``).  Size estimation's Def. 9
terms (``expected``/``lo``/``hi``) pass through float32 ``erf``/``exp``,
whose last bit may differ between XLA and PyTorch: they are held to
``rtol=1e-5``, as ``tests/test_torch_selection.py`` holds them.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.core as R
from repro.aqp import sampling as rsamp
from repro.aqp import size_estimation as rse
from repro.aqp import wander_join as rwj
from repro.core import datasets as rdata
from repro.core.catalog import join_rows as r_join_rows
from repro.core.workload import TPCH_JOIN_SPEC as R_TPCH_JOIN_SPEC
from repro.core.workload import generate_workload as r_generate_workload
import repro_torch.core as T
from repro_torch import prng
from repro_torch.aqp import sampling as tsamp
from repro_torch.aqp import size_estimation as tse
from repro_torch.aqp import wander_join as twj
from repro_torch.convert import database_from_numpy
from repro_torch.core import queries as tqueries
from repro_torch.core.catalog import join_rows as t_join_rows
from repro_torch.core.workload import TPCH_JOIN_SPEC as T_TPCH_JOIN_SPEC
from repro_torch.core.workload import generate_workload as t_generate_workload

torch.set_num_threads(1)  # small tensors; leave the cores to the other xdist workers

REL = 1e-4  # tests/test_queries.py's tolerance for non-integral sums
TOL = dict(rtol=1e-5, atol=1e-6)  # Def. 9 terms, as tests/test_torch_selection.py
JOIN = ("orders", "l_orderkey", "o_orderkey")


def _port_db(rdb):
    return database_from_numpy(
        [(n, {a: np.asarray(rdb[n][a]) for a in rdb[n].schema}, rdb[n].primary_key)
         for n in rdb.names], device="cpu")


def _pair(n, seed, drop_orders=0):
    """The reference's and the port's tpch database; ``drop_orders`` removes
    every ``drop_orders``-th order, so some lineitems have no partner."""
    rdb = rdata.make_tpch(n, seed=seed)
    if drop_orders:
        o = {a: np.asarray(rdb["orders"][a]) for a in rdb["orders"].schema}
        keep = np.arange(o["o_orderkey"].shape[0]) % drop_orders != 0
        rdb = rdb.with_table(R.from_numpy("orders", {a: v[keep] for a, v in o.items()},
                                          rdb["orders"].primary_key))
    return rdb, _port_db(rdb)


def _query(mod, groupby, agg, having=None, outer=None, where=None, join=JOIN):
    kw = dict(table="lineitem", groupby=groupby, agg=mod.Aggregate(*agg),
              join=mod.JoinSpec(*join) if join else None)
    if having is not None:
        kw["having"] = mod.Having(*having)
    if where is not None:
        kw["where"] = mod.Predicate(*where)
    if outer is not None:
        og, oagg, oh = outer
        kw.update(outer_groupby=og, outer_agg=mod.Aggregate(*oagg),
                  outer_having=mod.Having(*oh) if oh else None)
    return mod.Query(**kw)


def _to_port(q):
    """The port's copy of a reference ``Query`` (same fields, same floats)."""
    def conv(x, cls):
        return None if x is None else cls(*dataclasses.astuple(x))

    return T.Query(q.table, q.groupby, conv(q.agg, T.Aggregate), conv(q.where, T.Predicate),
                   conv(q.having, T.Having), conv(q.join, T.JoinSpec), q.outer_groupby,
                   conv(q.outer_agg, T.Aggregate), conv(q.outer_having, T.Having))


def _threshold(mod, q, db, quantile):
    vals = mod.execute(dataclasses.replace(q, having=None, outer_having=None), db).values
    return float(np.quantile(vals, quantile))


def _result_map(res):
    attrs = sorted(res.group_values)
    return {tuple(float(res.group_values[a][i]) for a in attrs): float(res.values[i])
            for i in range(len(res.values))}


def _assert_results(got, want, integral, ctx=""):
    if integral:
        assert got.canonical() == want.canonical(), ctx
    else:
        g, w = _result_map(got), _result_map(want)
        assert g == pytest.approx(w, rel=REL), ctx


# ---------------------------------------------------------------------------
# Catalog.join and its delta chain
# ---------------------------------------------------------------------------


def _assert_join_equal(tj, tf, rj, rf, ctx=""):
    assert tj.schema == rj.schema, ctx
    assert tj.name == rj.name and tj.num_rows == rj.num_rows, ctx
    np.testing.assert_array_equal(tf, rf, err_msg=ctx)
    for a in rj.schema:
        np.testing.assert_array_equal(tj[a].numpy(), np.asarray(rj[a]), err_msg=f"{ctx} {a}")
        assert tj[a].numpy().dtype == np.asarray(rj[a]).dtype, f"{ctx} {a}"


@pytest.mark.parametrize("drop_orders", [0, 5])
def test_catalog_join_matches_reference(drop_orders):
    rdb, tdb = _pair(3_000, 4, drop_orders)
    rcat, tcat = R.Catalog(), T.Catalog()
    rj, rf = rcat.join(rdb["lineitem"], rdb["orders"], "l_orderkey", "o_orderkey")
    tj, tf = tcat.join(tdb["lineitem"], tdb["orders"], "l_orderkey", "o_orderkey")
    _assert_join_equal(tj, tf, rj, rf)
    assert (tj.num_rows < tdb["lineitem"].num_rows) == bool(drop_orders)
    # The same (fact, right, keys) is a cache hit: the identical objects.
    tj2, tf2 = tcat.join(tdb["lineitem"], tdb["orders"], "l_orderkey", "o_orderkey")
    assert tj2 is tj and tf2 is tf
    assert dict(tcat.stats) == {"join_materialize": 1, "join_hit": 1}
    rcat.join(rdb["lineitem"], rdb["orders"], "l_orderkey", "o_orderkey")
    assert dict(tcat.stats) == dict(rcat.stats)


def test_join_rows_names_colliding_right_columns():
    """A right column whose name the fact side has becomes ``<right>.<attr>``."""
    fact = {"k": np.array([3, 1, 2, 9], np.int32), "v": np.array([1, 2, 3, 4], np.int32)}
    dim = {"k": np.array([1, 2, 3], np.int32), "v": np.array([10, 20, 30], np.int32)}
    rcols, rf, rr = r_join_rows(fact, R.from_numpy("dim", dim), "k", "k")
    tcols, tf, tr = t_join_rows({a: torch.from_numpy(v) for a, v in fact.items()},
                              T.from_numpy("dim", dim, device="cpu"), "k", "k")
    assert sorted(tcols) == sorted(rcols) == ["dim.k", "dim.v", "k", "v"]
    np.testing.assert_array_equal(tf, rf)
    np.testing.assert_array_equal(tr, rr)
    for a in rcols:
        np.testing.assert_array_equal(tcols[a].numpy(), np.asarray(rcols[a]), err_msg=a)


def test_catalog_join_delta_chain_matches_reference():
    """An append joins only its batch and is built as an append of the
    parent's joined table; a delete drops the deleted fact rows' joined rows
    and remaps ``fact_idx``: columns and ``fact_idx`` equal the reference's
    and a fresh join's, and the joined table's group encodings
    delta-refresh."""
    rdb, tdb = _pair(3_000, 5, drop_orders=7)
    rng = np.random.default_rng(5)
    rcat, tcat = R.Catalog(), T.Catalog()
    rt, tt = rdb["lineitem"], tdb["lineitem"]
    rcat.join(rt, rdb["orders"], *JOIN[1:])
    tj0, _ = tcat.join(tt, tdb["orders"], *JOIN[1:])
    tcat.groups(tj0, ("l_suppkey",))
    src = {a: np.asarray(rt[a]) for a in rt.schema}
    for step in range(4):
        if step % 2 == 0:
            idx = rng.integers(0, rt.num_rows, 200)
            batch = {a: v[idx] for a, v in src.items()}
            batch["l_orderkey"] = rng.integers(1, 1_000, 200).astype(batch["l_orderkey"].dtype)
            rt, tt = rt.append(batch), tt.append(batch)
        else:
            mask = rng.random(tt.num_rows) < 0.1
            rt, tt = rt.delete(mask), tt.delete(mask)
        rj, rf = rcat.join(rt, rdb["orders"], *JOIN[1:])
        tj, tf = tcat.join(tt, tdb["orders"], *JOIN[1:])
        _assert_join_equal(tj, tf, rj, rf, f"step {step}")
        assert tj.delta is not None and tj.uid == tj0.uid
        fresh, fresh_idx = T.Catalog().join(
            T.from_numpy("lineitem", {a: tt[a].numpy() for a in tt.schema}, device="cpu"),
            tdb["orders"], *JOIN[1:])
        _assert_join_equal(tj, tf, fresh, fresh_idx, f"step {step} fresh")
        enc = tcat.groups(tj, ("l_suppkey",))
        np.testing.assert_array_equal(enc.gid, rcat.groups(rj, ("l_suppkey",)).gid)
    assert tcat.stats["join_delta"] == rcat.stats["join_delta"] == 4
    assert tcat.stats["join_materialize"] == 1
    assert tcat.stats["encode_groups"] == 1 and tcat.stats["encode_groups_delta"] == 4


def test_invalidate_table_drops_join_entries():
    _, tdb = _pair(1_000, 6)
    cat = T.Catalog()
    cat.join(tdb["lineitem"], tdb["orders"], *JOIN[1:])
    cat.invalidate_table(tdb["orders"])
    assert not cat._joins
    cat.join(tdb["lineitem"], tdb["orders"], *JOIN[1:])
    cat.invalidate_table(tdb["lineitem"])
    assert not cat._joins
    assert cat.stats["join_materialize"] == 2


# ---------------------------------------------------------------------------
# Joined execution and provenance (tests/test_queries.py::test_join_template)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tpch_small():
    return _pair(8_000, 12)


def test_join_template(tpch_small):
    rdb, tdb = tpch_small
    rq = _query(R, ("l_suppkey",), ("sum", "l_quantity"), having=(">", 100.0))
    tq = _query(T, ("l_suppkey",), ("sum", "l_quantity"), having=(">", 100.0))
    assert tq.template == rq.template == "Q-AJGH"
    res = T.execute(tq, tdb)
    assert res.canonical() == R.execute(rq, rdb).canonical()
    # The reference test's oracle: a manual join.
    li = {a: tdb["lineitem"][a].numpy() for a in tdb["lineitem"].schema}
    match = np.isin(li["l_orderkey"], tdb["orders"]["o_orderkey"].numpy())
    sums = {}
    for sk, qy, m in zip(li["l_suppkey"], li["l_quantity"], match):
        if m:
            sums[float(sk)] = sums.get(float(sk), 0.0) + float(qy)
    want = {k: v for k, v in sums.items() if v > 100.0}
    got = dict(zip(map(float, res.group_values["l_suppkey"]), map(float, res.values)))
    assert got == pytest.approx(want, rel=REL)


JOIN_CASES = [
    (("l_suppkey",), ("sum", "l_quantity"), (">", 100.0), None, None),
    (("l_suppkey",), ("count", None), (">", 4.0), None, ("o_shippriority", ">=", 2)),
    (("l_shipdate",), ("avg", "l_quantity"), (">", 27.0), None, ("l_discount", "<", 0.05)),
    (("l_suppkey", "o_shippriority"), ("sum", "l_quantity"), (">", 30.0), None, None),
    (("l_partkey", "l_suppkey"), ("count", None), (">", 0.0),
     (("l_suppkey",), ("sum", None), (">", 12.0)), None),
    (("l_suppkey",), ("sum", "l_extendedprice"), (">", 250_000.0), None, None),
]


@pytest.mark.parametrize("drop_orders", [0, 3])
@pytest.mark.parametrize("gb,agg,having,outer,where", JOIN_CASES)
def test_execute_and_provenance_match_reference(gb, agg, having, outer, where, drop_orders):
    """Joined results and provenance equal the reference's, dangling fact
    rows (no partner) included: they are never in the provenance."""
    rdb, tdb = _pair(6_000, 13, drop_orders)
    rq = _query(R, gb, agg, having, outer, where)
    tq = _query(T, gb, agg, having, outer, where)
    assert tq.signature() == rq.signature() and tq.template == rq.template
    want, want_prov = R.execute_and_provenance(rq, rdb, catalog=R.Catalog())
    got, got_prov = T.execute_and_provenance(tq, tdb, catalog=T.Catalog())
    integral = agg[1] != "l_extendedprice"
    _assert_results(got, want, integral)
    assert len(got.values) > 0
    if integral:
        np.testing.assert_array_equal(got_prov, want_prov)
        np.testing.assert_array_equal(T.provenance_mask(tq, tdb), want_prov)
    assert got_prov.shape == (tdb["lineitem"].num_rows,)
    if drop_orders:
        dangling = ~np.isin(tdb["lineitem"]["l_orderkey"].numpy(),
                            tdb["orders"]["o_orderkey"].numpy())
        assert dangling.any() and not got_prov[dangling].any()
    # Q(P(Q, D)) == Q(D): the lineage is a sufficient subset.
    sub = tdb.with_table(tdb["lineitem"].select(got_prov))
    assert T.execute(tq, sub).canonical() == got.canonical()


def test_join_templates_run_over_a_real_dimension(tpch_small):
    """The four templates' join half and their shared inner block: Q-AJGH
    and Q-AAJGH over orders equal the reference's."""
    rdb, tdb = tpch_small
    ajgh = (("l_suppkey",), ("sum", "l_quantity"), (">", 60.0), None, None)
    aajgh = (("l_partkey", "l_suppkey"), ("sum", "l_quantity"), (">", 0.0),
             (("l_suppkey",), ("count", None), (">", 1.0)), None)
    for spec, template in ((ajgh, "Q-AJGH"), (aajgh, "Q-AAJGH")):
        rq, tq = _query(R, *spec), _query(T, *spec)
        assert tq.template == template
        assert T.execute(tq, tdb).canonical() == R.execute(rq, rdb).canonical()
        ib = tqueries.inner_block(tdb, tq, T.Catalog())
        assert ib.fact_idx is not None and ib.flat.name == "lineitem_join_orders"


# ---------------------------------------------------------------------------
# Wander join (tests/test_aqp.py::test_wander_join_walk)
# ---------------------------------------------------------------------------


def test_wander_join_walk():
    rdb, tdb = _pair(5_000, 6)
    ridx = rwj.JoinIndex.build(rdb["orders"], "o_orderkey")
    tidx = twj.JoinIndex.build(tdb["orders"], "o_orderkey")
    np.testing.assert_array_equal(tidx.sorted_keys, ridx.sorted_keys)
    np.testing.assert_array_equal(tidx.order, ridx.order)
    fact_keys = tdb["lineitem"]["l_orderkey"].numpy()[:500]
    rrows, rfan = rwj.walk(jax.random.PRNGKey(0), ridx, fact_keys)
    trows, tfan = twj.walk(prng.PRNGKey(0), tidx, fact_keys, device="cpu")
    np.testing.assert_array_equal(trows, rrows)
    np.testing.assert_array_equal(tfan, rfan)
    ok = tdb["orders"]["o_orderkey"].numpy()
    assert (tfan >= 1).all()  # all orderkeys exist
    assert (ok[trows] == fact_keys).all()  # the picked partner matches the key


@pytest.mark.parametrize("seed", range(4))
def test_wander_join_fanout_and_dangling_rows_match_reference(seed):
    """A dimension with repeated keys (fan-out > 1) and missing ones: the
    picks, fan-outs and every value branch (COUNT(*), a fact attribute, a
    dimension attribute) and the WHERE branches equal the reference's."""
    rng = np.random.default_rng(seed)
    dim = {"d_key": rng.integers(0, 40, 120).astype(np.int32),
           "d_w": rng.integers(0, 9, 120).astype(np.int32),
           "d_f": rng.uniform(0, 5, 120).astype(np.float32)}
    fact = {"f_key": rng.integers(0, 50, 300).astype(np.int32),
            "f_v": rng.integers(0, 30, 300).astype(np.int32),
            "f_g": rng.integers(0, 5, 300).astype(np.int32)}
    rdim, tdim = R.from_numpy("dim", dim), T.from_numpy("dim", dim, device="cpu")
    rfact, tfact = R.from_numpy("f", fact), T.from_numpy("f", fact, device="cpu")
    ridx, tidx = rwj.JoinIndex.build(rdim, "d_key"), twj.JoinIndex.build(tdim, "d_key")
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    rrows, rfan = rwj.walk(jk, ridx, fact["f_key"])
    trows, tfan = twj.walk(tk, tidx, fact["f_key"], device="cpu")
    np.testing.assert_array_equal(trows, rrows)
    np.testing.assert_array_equal(tfan, rfan)
    assert (tfan > 1).any() and (tfan == 0).any() and (trows[tfan == 0] == -1).all()
    for agg_attr in (None, "f_v", "d_w", "d_f"):
        for where in (None, ("f_g", ">=", 2), ("d_w", "<", 5), ("d_f", ">", 2.5)):
            rv, ru = rwj.join_sample_values(
                jk, ridx, rdim, rfact, R.JoinSpec("dim", "f_key", "d_key"), agg_attr,
                R.Predicate(*where) if where else None)
            tv, tu = twj.join_sample_values(
                tk, tidx, tdim, tfact, T.JoinSpec("dim", "f_key", "d_key"), agg_attr,
                T.Predicate(*where) if where else None)
            np.testing.assert_array_equal(tv, rv, err_msg=f"{agg_attr} {where}")
            np.testing.assert_array_equal(tu, ru, err_msg=f"{agg_attr} {where}")


# ---------------------------------------------------------------------------
# Size estimation over a join (tests/test_aqp.py::test_join_size_estimation)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tpch_est():
    return _pair(20_000, 7)


@pytest.mark.parametrize("agg,where", [(("sum", "l_quantity"), None),
                                       (("count", None), ("o_shippriority", ">", 1)),
                                       (("avg", "l_quantity"), ("l_discount", "<", 0.06)),
                                       (("sum", "o_totalprice"), None)])
def test_join_size_estimation(tpch_est, agg, where):
    rdb, tdb = tpch_est
    if agg[1] == "o_totalprice":  # the picked partner's attribute: its 0.9 quantile
        having = (">", _threshold(R, _query(R, ("l_suppkey",), agg), rdb, 0.9))
    else:
        having = (">", 50.0) if agg[0] == "sum" else (">", 3.0) if agg[0] == "count" else (">", 26.0)
    rq = _query(R, ("l_suppkey",), agg, having, where=where)
    tq = _query(T, ("l_suppkey",), agg, having, where=where)
    jk, tk = jax.random.PRNGKey(0), prng.PRNGKey(0)
    rs = rsamp.stratified_reservoir_sample(jk, rdb["lineitem"], ("l_suppkey",), 0.1)
    ts = tsamp.stratified_reservoir_sample(tk, tdb["lineitem"], ("l_suppkey",), 0.1)
    np.testing.assert_array_equal(ts.indices, rs.indices)
    rest, rsat = rse.approximate_query_result(jk, rq, rdb, rs)
    test_, tsat = tse.approximate_query_result(tk, tq, tdb, ts)
    np.testing.assert_array_equal(test_.estimate, rest.estimate)
    np.testing.assert_allclose(test_.sigma, rest.sigma, **TOL)
    np.testing.assert_array_equal(tsat, rsat)
    rr = R.equi_depth_ranges(rdb["lineitem"], "l_suppkey", 20)
    tr = T.equi_depth_ranges(tdb["lineitem"], "l_suppkey", 20)
    r = rse.estimate_size(jk, rq, rdb, rr, rs)
    t = tse.estimate_size(tk, tq, tdb, tr, ts)
    assert t.est_rows == r.est_rows and t.n_satisfied_groups == r.n_satisfied_groups
    np.testing.assert_array_equal(t.est_bits, r.est_bits)
    np.testing.assert_allclose([t.expected_rows, t.lo_rows, t.hi_rows],
                               [r.expected_rows, r.lo_rows, r.hi_rows], **TOL)
    if agg == ("sum", "l_quantity"):  # the reference test's accuracy bound
        actual = T.capture_sketch(tq, tdb, tr).size_rows
        assert abs(t.est_rows - actual) / max(actual, 1) < 0.35


@pytest.mark.parametrize("strategy", ["CB-OPT-GB", "OPT"])
def test_select_attribute_over_a_join_matches(tpch_est, strategy):
    rdb, tdb = tpch_est
    spec = (("l_suppkey", "l_shipdate"), ("sum", "l_quantity"))
    rq0, tq0 = _query(R, *spec), _query(T, *spec)
    tau = _threshold(R, rq0, rdb, 0.9)
    rq = dataclasses.replace(rq0, having=R.Having(">", tau))
    tq = dataclasses.replace(tq0, having=T.Having(">", tau))
    rsel = R.select_attribute(strategy, jax.random.PRNGKey(3), rq, rdb, 50,
                              sample_cache=rsamp.SampleCache(), catalog=R.Catalog(), topk=2)
    tsel = T.select_attribute(strategy, prng.PRNGKey(3), tq, tdb, 50,
                              sample_cache=tsamp.SampleCache(), catalog=T.Catalog(), topk=2)
    assert (tsel.attr, tsel.candidates, tsel.topk) == (rsel.attr, rsel.candidates, rsel.topk)
    assert set(tsel.estimates) == set(rsel.estimates)
    for a, r in rsel.estimates.items():
        t = tsel.estimates[a]
        np.testing.assert_array_equal(t.est_bits, r.est_bits, err_msg=a)
        assert t.est_rows == r.est_rows


# ---------------------------------------------------------------------------
# Sketch application over joins (tests/test_catalog.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tpch_catalog():
    return _pair(20_000, 7)


def _catalog_templates(mod, db):
    """The join templates of ``tests/test_catalog.py::_templates``."""
    ajgh = mod.Query("lineitem", ("l_suppkey",), mod.Aggregate("sum", "l_extendedprice"),
                     join=mod.JoinSpec(*JOIN))
    ajgh = dataclasses.replace(ajgh, having=mod.Having(">", _threshold(mod, ajgh, db, 0.8)))
    aajgh = mod.Query("lineitem", ("l_suppkey", "l_partkey"), mod.Aggregate("sum", "l_quantity"),
                      join=mod.JoinSpec(*JOIN), having=mod.Having(">", 0.0),
                      outer_groupby=("l_suppkey",), outer_agg=mod.Aggregate("sum", None))
    aajgh = dataclasses.replace(
        aajgh, outer_having=mod.Having(">", _threshold(mod, aajgh, db, 0.8)))
    return {"Q-AJGH": ajgh, "Q-AAJGH": aajgh}


@pytest.mark.parametrize("template", ["Q-AJGH", "Q-AAJGH"])
def test_fragment_skipping_exact_all_templates(tpch_catalog, template):
    """Sketch-instrumented equals NO-PS over a join, on the keep-mask and the
    fragment-slice instance; bits equal the reference's (Q-AAJGH, integral)
    and the results equal it (Q-AJGH sums ``l_extendedprice``: rel 1e-4)."""
    rdb, tdb = tpch_catalog
    rq, tq = _catalog_templates(R, rdb)[template], _catalog_templates(T, tdb)[template]
    integral = template == "Q-AAJGH"
    ranges = T.equi_depth_ranges(tdb["lineitem"], "l_suppkey", 64)
    rranges = R.equi_depth_ranges(rdb["lineitem"], "l_suppkey", 64)
    clustered = tdb.with_table(tdb["lineitem"].cluster_by(ranges))
    want = T.execute(tq, tdb).canonical()
    assert len(want) > 0
    _assert_results(T.execute(tq, tdb), R.execute(rq, rdb), integral)

    cat_u = T.Catalog()
    sk_u = T.capture_sketch(tq, tdb, ranges, catalog=cat_u)
    assert T.execute_with_sketch(tq, tdb, sk_u, catalog=cat_u).canonical() == want
    assert cat_u.stats["instance_mask"] == 1 and cat_u.stats["instance_slices"] == 0

    cat_c = T.Catalog()
    sk_c = T.capture_sketch(tq, clustered, ranges, catalog=cat_c)
    got_c = T.execute_with_sketch(tq, clustered, sk_c, catalog=cat_c)
    if integral:
        assert got_c.canonical() == want
    else:  # another row order: float32 adds in another order
        assert _result_map(got_c) == pytest.approx(_result_map(T.execute(tq, tdb)), rel=REL)
    assert cat_c.stats["instance_slices"] == 1 and cat_c.stats["instance_mask"] == 0
    np.testing.assert_array_equal(sk_u.bits, sk_c.bits)
    assert sk_u.size_rows == sk_c.size_rows
    if integral:
        rsk = R.capture_sketch(rq, rdb, rranges, catalog=R.Catalog())
        np.testing.assert_array_equal(sk_u.bits, rsk.bits)
        assert sk_u.size_rows == rsk.size_rows


def test_second_workload_pass_does_zero_host_encode_work():
    """``tests/test_catalog.py::test_second_workload_pass_does_zero_host_encode_work``
    with ``TPCH_JOIN_SPEC``: a replay hits the caches only (no group encode,
    no join materialization, no bucketization, no instance build)."""
    rdb, tdb = _pair(20_000, 5)
    wl = [_to_port(q) for q in r_generate_workload(R_TPCH_JOIN_SPEC, rdb, 5, seed=5)]
    eng = T.PBDSEngine(tdb, strategy="CB-OPT-GB", n_ranges=50, theta=0.1, seed=0,
                       cluster_tables=False)
    for q in wl:
        eng.run(q)
    s1 = dict(eng.catalog.stats)
    infos = [eng.run(q)[1] for q in wl]
    s2 = dict(eng.catalog.stats)
    assert any(i.reused for i in infos)
    for counter in ("encode_groups", "join_materialize", "bucketize",
                    "instance_build", "distinct_count"):
        assert s2.get(counter, 0) == s1.get(counter, 0), counter
    assert s2.get("encode_groups_hit", 0) > s1.get("encode_groups_hit", 0)
    assert s2.get("join_hit", 0) > s1.get("join_hit", 0)
    n_reused = sum(1 for i in infos if i.reused)
    assert s2.get("instance_hit", 0) - s1.get("instance_hit", 0) >= n_reused


# ---------------------------------------------------------------------------
# The engine end to end (tests/test_system.py::test_join_workload_end_to_end)
# ---------------------------------------------------------------------------


def _index_state(eng):
    out = []
    for e in sorted(eng.index.entries(), key=lambda e: repr(e.query.signature())):
        m = e.maintainer
        out.append((repr(e.query.signature()), e.sketch.attr, e.sketch.bits.tobytes(),
                    e.sketch.size_rows, e.sketch.table_version,
                    None if m is None else (m.frag_prov.tobytes(), m.sums.tobytes(),
                                            m.counts.tobytes(), m.passing.tobytes())))
    return out


def test_generate_workload_runs_on_the_join_spec():
    rdb, tdb = _pair(12_000, 22)
    want = r_generate_workload(R_TPCH_JOIN_SPEC, rdb, 4, seed=22)
    got = t_generate_workload(T_TPCH_JOIN_SPEC, tdb, 4, seed=22)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert (g.table, g.groupby, g.agg.fn, g.agg.attr, g.template) == (
            w.table, w.groupby, w.agg.fn, w.agg.attr, w.template)
        assert dataclasses.astuple(g.join) == dataclasses.astuple(w.join)
        assert g.having.value == pytest.approx(w.having.value, rel=REL)


def test_join_workload_end_to_end():
    """The reference's workload through both engines: results, the chosen
    attributes and created sketches' bits, and the index contents."""
    rdb, tdb = _pair(12_000, 22)
    rqs = r_generate_workload(R_TPCH_JOIN_SPEC, rdb, 4, seed=22)
    tqs = [_to_port(q) for q in rqs]
    args = dict(strategy="CB-OPT-GB", n_ranges=50, theta=0.1, seed=0)
    reng, teng = R.PBDSEngine(rdb, **args), T.PBDSEngine(tdb, **args)
    for rq, tq in list(zip(rqs, tqs)) * 2:
        want, rinfo = reng.run(rq)
        got, tinfo = teng.run(tq)
        integral = tq.agg.attr != "l_extendedprice"
        _assert_results(got, want, integral, tq.signature())
        _assert_results(got, T.execute(tq, tdb), integral, tq.signature())
        assert got.canonical() == T.execute(tq, tdb, catalog=teng.catalog).canonical()
        assert (tinfo.reused, tinfo.created, tinfo.attr) == (
            rinfo.reused, rinfo.created, rinfo.attr)
    assert teng.index.hits == reng.index.hits and teng.index.misses == reng.index.misses
    assert _index_state(teng) == _index_state(reng)


INTEGRAL_JOINS = [
    (("l_suppkey",), ("sum", "l_quantity"), 0.9, None),
    (("l_shipdate",), ("count", None), 0.85, None),
    (("l_partkey", "l_suppkey"), ("count", None), None, (("l_suppkey",), ("sum", None), 0.8)),
]


@pytest.mark.parametrize("gb,agg,q_inner,outer", INTEGRAL_JOINS)
def test_engine_join_queries_equal_reference_bitwise(gb, agg, q_inner, outer):
    """Integral Q-AJGH/Q-AAJGH through both engines, miss then hit, with
    dangling lineitems: results, attributes, sketch bits, index contents and
    the catalog's counters equal."""
    rdb, tdb = _pair(10_000, 31, drop_orders=4)
    rq0, tq0 = _query(R, gb, agg), _query(T, gb, agg)
    if outer is None:
        tau = _threshold(R, rq0, rdb, q_inner)
        rq = dataclasses.replace(rq0, having=R.Having(">", tau))
        tq = dataclasses.replace(tq0, having=T.Having(">", tau))
    else:
        og, oagg, qt = outer
        rq = dataclasses.replace(rq0, having=R.Having(">", 0.0), outer_groupby=og,
                                 outer_agg=R.Aggregate(*oagg))
        tq = dataclasses.replace(tq0, having=T.Having(">", 0.0), outer_groupby=og,
                                 outer_agg=T.Aggregate(*oagg))
        tau = _threshold(R, rq, rdb, qt)
        rq = dataclasses.replace(rq, outer_having=R.Having(">", tau))
        tq = dataclasses.replace(tq, outer_having=T.Having(">", tau))
    args = dict(strategy="CB-OPT-GB", n_ranges=30, theta=0.1, seed=0, min_selectivity_gain=2.0)
    reng, teng = R.PBDSEngine(rdb, **args), T.PBDSEngine(tdb, **args)
    for step in ("miss", "hit"):
        want, rinfo = reng.run(rq)
        got, tinfo = teng.run(tq)
        assert got.canonical() == want.canonical() == T.execute(tq, tdb).canonical(), step
        assert (tinfo.reused, tinfo.created, tinfo.attr, tinfo.selectivity) == (
            rinfo.reused, rinfo.created, rinfo.attr, rinfo.selectivity), step
    assert tinfo.reused
    assert _index_state(teng) == _index_state(reng)
    assert dict(teng.catalog.stats) == dict(reng.catalog.stats)


@pytest.mark.cuda
@pytest.mark.parametrize("template", ["Q-AJGH", "Q-AAJGH"])
def test_join_templates_on_the_card_equal_the_cpu(template):
    """A Q-AJGH and a Q-AAJGH through the engine on the card (the kernels
    launched) and on the CPU (their plain versions): results, chosen
    attributes and sketch bits equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.core import datasets as tdata
    from repro_torch.runtime.guards import LAUNCH_COUNTS

    outs = {}
    for device in ("cpu", "cuda"):
        db = tdata.make_tpch(40_000, seed=3, device=device)
        q = _query(T, ("l_suppkey",), ("sum", "l_quantity"))
        if template == "Q-AAJGH":
            q = dataclasses.replace(
                _query(T, ("l_partkey", "l_suppkey"), ("count", None)),
                having=T.Having(">", 0.0), outer_groupby=("l_suppkey",),
                outer_agg=T.Aggregate("sum", None))
            q = dataclasses.replace(q, outer_having=T.Having(">", _threshold(T, q, db, 0.9)))
        else:
            q = dataclasses.replace(q, having=T.Having(">", _threshold(T, q, db, 0.9)))
        eng = T.PBDSEngine(db, strategy="CB-OPT-GB", n_ranges=50, theta=0.1, seed=0,
                           min_selectivity_gain=2.0)
        before = LAUNCH_COUNTS["segment_aggregate"]
        runs = [eng.run(q) for _ in range(2)]
        if device == "cuda":
            assert LAUNCH_COUNTS["segment_aggregate"] > before
        outs[device] = ([r.canonical() for r, _ in runs], [i.attr for _, i in runs],
                        [e.sketch.bits.tobytes() for e in eng.index.entries()])
    assert outs["cuda"] == outs["cpu"]
    assert outs["cpu"][2]  # a sketch was created
