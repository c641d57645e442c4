"""The port's fragment-major layout against the reference's, on the CPU.

``ColumnTable.cluster_by``, ``take_fragments`` and ``compact`` must give the
reference's row permutation, columns and offsets (a stable sort by fragment,
so rows of one fragment keep their order), the layout's tail must follow
appends and deletes as the reference's does, and the clustered halves of
``tests/test_maintenance.py``'s differential replays and of
``tests/test_admission.py::test_run_batch_clustered_engine`` must give equal
results, sketch bits, maintainer counters and catalog stats on both
packages.  The data is integral, so "equal" means equal bits.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core import datasets as rdata
from repro.core.engine import PBDSEngine as RPBDSEngine
from repro_torch.convert import database_from_numpy
from repro_torch.core.engine import PBDSEngine as TPBDSEngine

torch.set_num_threads(1)  # small tensors; leave the cores to the other xdist workers

N_DIM = 200


def _mk_batch(rng, n):
    return dict(
        s_key=rng.integers(1, N_DIM + 1, n).astype(np.int32),
        s_grp=rng.integers(0, 12, n).astype(np.int32),
        s_sub=rng.integers(0, 6, n).astype(np.int32),
        s_attr=rng.integers(0, 240, n).astype(np.int32),
        s_val=rng.integers(0, 40, n).astype(np.int32),
    )


def _mk_dim(seed=0):
    rng = np.random.default_rng(seed)
    return dict(d_key=np.arange(1, N_DIM + 1, dtype=np.int32),
                d_w=rng.integers(0, 10, N_DIM).astype(np.int32))


def _db(mod, fact_np, dim_np):
    if mod is T:
        return T.Database({"sales": T.from_numpy("sales", fact_np, device="cpu"),
                           "dim": T.from_numpy("dim", dim_np, device="cpu")})
    return R.Database({"sales": R.from_numpy("sales", fact_np),
                       "dim": R.from_numpy("dim", dim_np)})


def _threshold(mod, q, db, quantile):
    vals = mod.execute(dataclasses.replace(q, having=None, outer_having=None), db).values
    return float(np.quantile(vals, quantile)) if len(vals) else 0.0


def _templates(mod, db):
    """``tests/test_maintenance.py``'s templates without a join."""
    agh = mod.Query("sales", ("s_grp",), mod.Aggregate("sum", "s_val"))
    agh = dataclasses.replace(agh, having=mod.Having(">", _threshold(mod, agh, db, 0.6)))
    agh_w = mod.Query("sales", ("s_grp",), mod.Aggregate("count", None),
                      where=mod.Predicate("s_sub", ">=", 3.0))
    agh_w = dataclasses.replace(agh_w, having=mod.Having(">", _threshold(mod, agh_w, db, 0.6)))
    aagh = mod.Query("sales", ("s_grp", "s_sub"), mod.Aggregate("sum", "s_val"),
                     having=mod.Having(">", 0.0),
                     outer_groupby=("s_grp",), outer_agg=mod.Aggregate("sum", None))
    aagh = dataclasses.replace(
        aagh, outer_having=mod.Having(">", _threshold(mod, aagh, db, 0.6)))
    return [agh, agh_w, aagh]


def _delete_predicate(rng):
    kind = rng.integers(0, 3)
    if kind == 0:
        lo = int(rng.integers(0, 200))
        return lambda cols: (cols["s_attr"] >= lo) & (cols["s_attr"] < lo + 30)
    if kind == 1:
        g = int(rng.integers(0, 12))
        return lambda cols: cols["s_grp"] == g
    v = int(rng.integers(1, 7))
    return lambda cols: (cols["s_key"] % 13 == v)


def _assert_tables_equal(tt, rt, ctx=""):
    assert sorted(tt.columns) == sorted(rt.columns), ctx
    for a in rt.columns:
        np.testing.assert_array_equal(tt[a].numpy(), np.asarray(rt[a]), err_msg=f"{ctx} {a}")
    assert (tt.layout is None) == (rt.layout is None), ctx
    if rt.layout is not None:
        np.testing.assert_array_equal(tt.layout.offsets, rt.layout.offsets, err_msg=ctx)
        assert (tt.layout.tail, tt.layout.attr, tt.layout.ranges_key) == (
            rt.layout.tail, rt.layout.attr, rt.layout.ranges_key), ctx
    assert (tt.version, tt.num_rows) == (rt.version, rt.num_rows), ctx


def _assert_maintainers_equal(tm, rm, ctx):
    for field in ("frag_prov", "sums", "counts", "passing", "counted"):
        np.testing.assert_array_equal(getattr(tm, field), getattr(rm, field),
                                      err_msg=f"{ctx} {field}")
    assert (tm.conservative, tm.exact, tm.n_groups, tm.version) == (
        rm.conservative, rm.exact, rm.n_groups, rm.version), ctx
    assert tm.incidence == rm.incidence, ctx


# ---------------------------------------------------------------------------
# 1. Layout mechanics.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("make,attr,n_ranges", [
    ("crimes", "district", 25), ("crimes", "year", 7), ("crimes", "records", 40),
    ("tpch", "l_suppkey", 32), ("tpch", "l_shipdate", 16),
])
def test_cluster_by_take_fragments_compact_match_reference(make, attr, n_ranges):
    rt = (rdata.make_crimes(5_000, seed=3) if make == "crimes"
          else rdata.make_tpch(5_000, seed=3)["lineitem"])
    tt = T.from_numpy(rt.name, {a: np.asarray(rt[a]) for a in rt.schema},
                      rt.primary_key, device="cpu")
    rr = R.equi_depth_ranges(rt, attr, n_ranges)
    tr = T.equi_depth_ranges(tt, attr, n_ranges)
    rc, tc = rt.cluster_by(rr), tt.cluster_by(tr)
    _assert_tables_equal(tc, rc, "cluster_by")
    assert (tc.uid, tc.version, tc.delta) == (tt.uid, tt.version, None)
    assert tc.layout.matches(tr) and not tc.layout.matches(T.equi_depth_ranges(tt, attr, 3))
    np.testing.assert_array_equal(tc.layout.bounds(), tr.bounds)

    rng = np.random.default_rng(n_ranges)
    frags = np.sort(rng.choice(tr.n_ranges, max(1, tr.n_ranges // 3), replace=False))
    r_inst, r_rows = rc.take_fragments(frags, return_rows=True)
    t_inst, t_rows = tc.take_fragments(frags, return_rows=True)
    np.testing.assert_array_equal(t_rows, r_rows)
    _assert_tables_equal(t_inst, r_inst, "take_fragments")

    # Appended rows land in the tail; the tail filter and compact agree too,
    # including rows whose value sits exactly on a bound.
    batch = {a: np.asarray(rt[a])[rng.integers(0, rt.num_rows, 300)] for a in rt.schema}
    batch[attr][:len(tr.bounds)] = np.asarray(tr.bounds).astype(batch[attr].dtype)
    ra, ta = rc.append(batch), tc.append(batch)
    _assert_tables_equal(ta, ra, "append")
    assert ta.layout.tail == 300
    r_inst, r_rows = ra.take_fragments(frags, return_rows=True)
    t_inst, t_rows = ta.take_fragments(frags, return_rows=True)
    np.testing.assert_array_equal(t_rows, r_rows)
    _assert_tables_equal(t_inst, r_inst, "take_fragments with a tail")
    _assert_tables_equal(ta.compact(), ra.compact(), "compact")
    assert ta.compact().layout.tail == 0 and ta.compact().uid == ta.uid


def test_layout_tail_under_append_and_delete_matches_reference():
    rng = np.random.default_rng(8)
    fact = _mk_batch(rng, 600)
    rt, tt = R.from_numpy("sales", fact), T.from_numpy("sales", fact, device="cpu")
    rr, tr = R.equi_depth_ranges(rt, "s_attr", 11), T.equi_depth_ranges(tt, "s_attr", 11)
    rt, tt = rt.cluster_by(rr), tt.cluster_by(tr)
    for step in range(8):
        if step % 3 == 2:
            mask = rng.random(tt.num_rows) < 0.15
            rt, tt = rt.delete(mask), tt.delete(mask)
        else:
            batch = _mk_batch(rng, int(rng.integers(10, 80)))
            rt, tt = rt.append(batch), tt.append(batch)
        _assert_tables_equal(tt, rt, f"step {step}")
        tail_bucket = T.Catalog().bucketize(tt, tr).numpy()[tt.num_rows - tt.layout.tail:]
        frags = np.arange(0, tr.n_ranges, 2)
        np.testing.assert_array_equal(tt.take_fragments(frags, tail_bucket=tail_bucket)["s_key"],
                                      np.asarray(rt.take_fragments(frags)["s_key"]))
    assert tt.collapse().layout is tt.layout
    with pytest.raises(ValueError):
        tt.take_fragments([0], tail_bucket=np.zeros(tt.layout.tail + 1, dtype=np.int32))


def test_append_delete_versioning_and_layout():
    """The layout half of ``tests/test_maintenance.py:318`` on the port."""
    rng = np.random.default_rng(3)
    t0 = T.from_numpy("sales", _mk_batch(rng, 500), device="cpu")
    ranges = T.equi_depth_ranges(t0, "s_attr", 8)
    t1 = t0.cluster_by(ranges)
    assert t1.uid == t0.uid and t1.version == 0 and t1.delta is None
    t2 = t1.append(_mk_batch(rng, 60))
    assert t2.version == 1 and t2.uid == t1.uid
    assert t2.delta.kind == "append" and t2.delta.parent is t1
    assert t2.layout is not None and t2.layout.tail == 60 and t2.num_rows == 560
    np.testing.assert_array_equal(t2["s_val"].numpy()[:500], t1["s_val"].numpy())
    mask = np.zeros(560, dtype=bool)
    mask[rng.choice(560, 80, replace=False)] = True
    t3 = t2.delete(mask)
    assert t3.version == 2 and t3.num_rows == 480
    lay = t3.layout
    bucket = ranges.bucketize(t3["s_attr"]).numpy()
    for f in range(lay.n_fragments):
        assert (bucket[lay.offsets[f]:lay.offsets[f + 1]] == f).all(), f
    assert lay.offsets[-1] + lay.tail == t3.num_rows
    assert t3.gather(np.arange(10)).uid != t3.uid and t3.gather(np.arange(10)).layout is None
    assert t3.with_column("x", t3["s_val"]).layout is lay


def test_sketch_instance_slices_a_clustered_table():
    """``apply_sketch`` on a table clustered on the sketch's partition slices
    fragments (``instance_slices``), the tail filtered through the catalog's
    bucket ids, and gives the reference's instance."""
    rng = np.random.default_rng(4)
    fact = _mk_batch(rng, 800)
    rdb, tdb = _db(R, fact, _mk_dim()), _db(T, fact, _mk_dim())
    rr = R.equi_depth_ranges(rdb["sales"], "s_grp", 12)
    tr = T.equi_depth_ranges(tdb["sales"], "s_grp", 12)
    batch = _mk_batch(rng, 70)
    rdb = rdb.with_table(rdb["sales"].cluster_by(rr).append(batch))
    tdb = tdb.with_table(tdb["sales"].cluster_by(tr).append(batch))
    rq, tq = _templates(R, rdb)[0], _templates(T, tdb)[0]
    rcat, tcat = R.Catalog(), T.Catalog()
    rsk = R.capture_sketch(rq, rdb, rr, catalog=rcat)
    tsk = T.capture_sketch(tq, tdb, tr, catalog=tcat)
    np.testing.assert_array_equal(tsk.bits, rsk.bits)
    r_inst = R.apply_sketch(rsk, rdb, catalog=rcat)["sales"]
    t_inst = T.apply_sketch(tsk, tdb, catalog=tcat)["sales"]
    _assert_tables_equal(t_inst, r_inst, "instance")
    assert tcat.stats["instance_slices"] == rcat.stats["instance_slices"] == 1
    assert tcat.stats.get("instance_mask", 0) == 0
    assert (T.execute_with_sketch(tq, tdb, tsk, catalog=tcat).canonical()
            == R.execute_with_sketch(rq, rdb, rsk, catalog=rcat).canonical()
            == T.execute(tq, tdb).canonical())


# ---------------------------------------------------------------------------
# 2. Maintainer-level differential replay, clustered (tests/test_maintenance.py:180).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(20))
def test_differential_replay_maintainer_clustered(seed):
    rng = np.random.default_rng(seed)
    fact_np = _mk_batch(rng, 500)
    dim_np = _mk_dim()
    rdb, tdb = _db(R, fact_np, dim_np), _db(T, fact_np, dim_np)
    rqs, tqs = _templates(R, rdb), _templates(T, tdb)
    k = int(rng.integers(0, len(tqs)))
    rq, tq = rqs[k], tqs[k]
    attrs = ["s_grp"] + (["s_attr"] if T.monotone_safe(tq, tdb) else [])
    attr = attrs[int(rng.integers(0, len(attrs)))]
    n_ranges = int(rng.integers(6, 16))
    rranges = R.equi_depth_ranges(rdb["sales"], attr, n_ranges)
    tranges = T.equi_depth_ranges(tdb["sales"], attr, n_ranges)
    rt, tt = rdb["sales"].cluster_by(rranges), tdb["sales"].cluster_by(tranges)
    _assert_tables_equal(tt, rt, f"seed={seed} cluster_by")
    rdb, tdb = rdb.with_table(rt), tdb.with_table(tt)
    rcat, tcat = R.Catalog(), T.Catalog()
    rm = R.build_maintainer(rq, rdb, rranges, rcat)
    tm = T.build_maintainer(tq, tdb, tranges, tcat)
    _assert_maintainers_equal(tm, rm, f"seed={seed} build")
    for step in range(int(rng.integers(4, 8))):
        op = rng.choice(["append", "delete", "query"], p=[0.4, 0.3, 0.3])
        if op == "append":
            batch = _mk_batch(rng, int(rng.integers(20, 100)))
            rt, tt = rt.append(batch), tt.append(batch)
            fact_np = {k: np.concatenate([fact_np[k], batch[k]]) for k in fact_np}
        elif op == "delete":
            pred = _delete_predicate(rng)
            mask = pred({k: tt[k].numpy() for k in ("s_attr", "s_grp", "s_key")})
            if mask.all():
                continue
            o_mask = pred(fact_np)
            rt, tt = rt.delete(mask), tt.delete(mask)
            fact_np = {k: v[~o_mask] for k, v in fact_np.items()}
        rdb, tdb = rdb.with_table(rt), tdb.with_table(tt)
        rm.apply(rt, rdb)
        tm.apply(tt, tdb)
        ctx = f"seed={seed} tmpl={tq.template} attr={attr} step={step} op={op}"
        _assert_tables_equal(tt, rt, ctx)
        _assert_maintainers_equal(tm, rm, ctx)
        oracle = T.capture_sketch(tq, _db(T, fact_np, dim_np), tranges, catalog=T.Catalog())
        np.testing.assert_array_equal(tm.bits(), oracle.bits, err_msg=ctx)
        if op == "query":
            tsk, rsk = tm.to_sketch(tt, tcat), rm.to_sketch(rt, rcat)
            assert tsk.size_rows == oracle.size_rows == rsk.size_rows, ctx
            got = T.execute_with_sketch(tq, tdb, tsk, catalog=tcat).canonical()
            assert got == R.execute_with_sketch(rq, rdb, rsk, catalog=rcat).canonical(), ctx
            assert got == T.execute(tq, _db(T, fact_np, dim_np)).canonical(), ctx
    assert tcat.stats.get("instance_slices", 0) == rcat.stats.get("instance_slices", 0)


# ---------------------------------------------------------------------------
# 3. Engine-level differential replay, cluster_tables=True (tests/test_maintenance.py:237).
# ---------------------------------------------------------------------------


def _engine_replay(seed, **engine_kwargs):
    rng = np.random.default_rng(1000 + seed)
    fact_np = _mk_batch(rng, 900)
    dim_np = _mk_dim()
    rdb, tdb = _db(R, fact_np, dim_np), _db(T, fact_np, dim_np)
    rqs, tqs = _templates(R, rdb), _templates(T, tdb)
    args = dict(strategy="CB-OPT-GB", n_ranges=10, theta=0.3, seed=seed,
                min_selectivity_gain=2.0, cluster_tables=True, **engine_kwargs)
    reng, teng = RPBDSEngine(rdb, **args), TPBDSEngine(tdb, **args)
    for _ in range(12):
        op = rng.choice(["append", "delete", "query"], p=[0.25, 0.2, 0.55])
        if op == "append":
            batch = _mk_batch(rng, int(rng.integers(30, 150)))
            reng.append_rows("sales", batch)
            teng.append_rows("sales", batch)
            fact_np = {k: np.concatenate([fact_np[k], batch[k]]) for k in fact_np}
        elif op == "delete":
            pred = _delete_predicate(rng)
            mask = pred({k: teng.db["sales"][k].numpy() for k in ("s_attr", "s_grp", "s_key")})
            if mask.all():
                continue
            reng.delete_rows("sales", mask)
            teng.delete_rows("sales", mask)
            fact_np = {k: v[~pred(fact_np)] for k, v in fact_np.items()}
        else:
            k = int(rng.integers(0, len(tqs)))
            r_res, r_info = reng.run(rqs[k])
            t_res, t_info = teng.run(tqs[k])
            ctx = f"seed={seed} tmpl={tqs[k].template}"
            assert t_res.canonical() == r_res.canonical(), ctx
            odb = _db(T, fact_np, dim_np)
            assert t_res.canonical() == T.execute(tqs[k], odb).canonical(), ctx
            assert (t_info.reused, t_info.created, t_info.repaired, t_info.attr) == (
                r_info.reused, r_info.created, r_info.repaired, r_info.attr), ctx
            for e in teng.index.entries():
                if e.sketch.current_for(teng.db["sales"]):
                    osk = T.capture_sketch(e.query, odb, e.sketch.ranges, catalog=T.Catalog())
                    np.testing.assert_array_equal(e.sketch.bits, osk.bits, err_msg=ctx)
        _assert_tables_equal(teng.db["sales"], reng.db["sales"], f"seed={seed} op={op}")
    rents = sorted(reng.index.entries(), key=lambda e: repr(e.query.signature()))
    tents = sorted(teng.index.entries(), key=lambda e: repr(e.query.signature()))
    assert len(rents) == len(tents)
    for re_, te in zip(rents, tents):
        np.testing.assert_array_equal(te.sketch.bits, re_.sketch.bits)
        _assert_maintainers_equal(te.maintainer, re_.maintainer, f"seed={seed}")
    assert dict(teng.catalog.stats) == dict(reng.catalog.stats)
    return teng


@pytest.mark.parametrize("seed", range(4))
def test_differential_replay_engine_clustered(seed):
    eng = _engine_replay(seed)
    assert eng.catalog.stats["cluster"] == 1
    assert eng.db["sales"].layout is not None


@pytest.mark.parametrize("seed", range(2))
def test_compact_tail_frac_matches_reference(seed):
    """``compact_tail_frac``: an oversized tail folds back into fragment
    order on both packages at the same mutations (maintainers advanced
    first), with equal layouts, results and stats."""
    eng = _engine_replay(seed, compact_tail_frac=0.05)
    assert eng.catalog.stats["compact"] >= 1


# ---------------------------------------------------------------------------
# 4. run_batch with cluster_tables=True (tests/test_admission.py:222).
# ---------------------------------------------------------------------------


def test_run_batch_clustered_engine():
    rdb = rdata.make_tpch(20_000, seed=7)
    tdb = database_from_numpy(
        [(n, {a: np.asarray(rdb[n][a]) for a in rdb[n].schema}, rdb[n].primary_key)
         for n in rdb.names], device="cpu")

    def batch(mod, db):
        q = mod.Query("lineitem", ("l_suppkey",), mod.Aggregate("sum", "l_quantity"))
        return [dataclasses.replace(q, having=mod.Having(">", _threshold(mod, q, db, qt)))
                for qt in (0.95, 0.9, 0.8)]

    args = dict(strategy="CB-OPT-GB", n_ranges=40, theta=0.1, seed=0,
                min_selectivity_gain=0.98, cluster_tables=True)
    reng, t_seq, t_bat = RPBDSEngine(rdb, **args), TPBDSEngine(tdb, **args), TPBDSEngine(tdb, **args)
    rqs, tqs = batch(R, rdb), batch(T, tdb)
    want = reng.run_batch(rqs)
    seq = [t_seq.run(q) for q in tqs]
    got = t_bat.run_batch(tqs)
    for (w, wi), (s, si), (g, gi) in zip(want, seq, got):
        assert g.canonical() == w.canonical() == s.canonical()
        assert (gi.reused, gi.created, gi.attr) == (wi.reused, wi.created, wi.attr) == (
            si.reused, si.created, si.attr)
    for eng in (t_seq, t_bat):
        ents = sorted(eng.index.entries(), key=lambda e: repr(e.query.signature()))
        rents = sorted(reng.index.entries(), key=lambda e: repr(e.query.signature()))
        assert len(ents) == len(rents)
        for te, re_ in zip(ents, rents):
            np.testing.assert_array_equal(te.sketch.bits, re_.sketch.bits)
            assert te.sketch.size_rows == re_.sketch.size_rows
    assert t_bat.db["lineitem"].layout is not None
    _assert_tables_equal(t_bat.db["lineitem"], reng.db["lineitem"], "clustered lineitem")
    assert t_bat.catalog.stats["cluster"] == reng.catalog.stats["cluster"] == 1
