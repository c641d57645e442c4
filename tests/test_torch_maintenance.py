"""The port's incremental maintenance against the reference's: the seeded
differential replays of ``tests/test_maintenance.py`` on the unclustered
layout, over the templates without a join (Q-AGH, Q-AGH with WHERE,
Q-AAGH) and, in their own replays, the join templates (Q-AJGH, Q-AAJGH;
also over a dimension with missing keys, so some fact rows dangle), run on
both packages over the same numpy data.  A mutated dimension table makes a
join maintainer refuse, and the engine re-captures, as the reference does.

Held equal, with no tolerance: maintained sketch bits (also against a
from-scratch capture on the mutated data), the maintainers' float64 sums,
int64 counts, ``frag_prov`` and surviving sets, query results, and the
catalog's stat counters, which show that the delta path did no full-table
re-bucketization or re-encode.  The data is integral and small, so every
group aggregate is exact in float32 and equal bits are well defined.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core.engine import PBDSEngine as RPBDSEngine
from repro_torch.aqp.sampling import SampleSet, extend_sample_for_append
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


def _mk_dim(seed=0, holes=False):
    """The dimension: one row per key 1..N_DIM, or with ``holes`` every
    third key missing (the fact rows carrying it dangle)."""
    rng = np.random.default_rng(seed)
    dim = dict(
        d_key=np.arange(1, N_DIM + 1, dtype=np.int32),
        d_w=rng.integers(0, 10, N_DIM).astype(np.int32),
    )
    if holes:
        keep = dim["d_key"] % 3 != 0
        dim = {k: v[keep] for k, v in dim.items()}
    return dim


def _db(mod, fact_np, dim_np):
    if mod is T:
        return T.Database({"sales": T.from_numpy("sales", fact_np, device="cpu"),
                           "dim": T.from_numpy("dim", dim_np, device="cpu")})
    return R.Database({"sales": R.from_numpy("sales", fact_np),
                       "dim": R.from_numpy("dim", dim_np)})


def _threshold(mod, q, db, quantile):
    vals = mod.execute(dataclasses.replace(q, having=None, outer_having=None), db).values
    if len(vals) == 0:
        return 0.0
    return float(np.quantile(vals, quantile))


def _templates(mod, db):
    """The reference suite's templates without a join (``_templates`` at
    ``tests/test_maintenance.py:80-107`` minus Q-AJGH and Q-AAJGH), with
    thresholds calibrated by ``mod``'s own executor."""
    agh = mod.Query("sales", ("s_grp",), mod.Aggregate("sum", "s_val"))
    agh = dataclasses.replace(agh, having=mod.Having(">", _threshold(mod, agh, db, 0.6)))
    agh_w = mod.Query("sales", ("s_grp",), mod.Aggregate("count", None),
                      where=mod.Predicate("s_sub", ">=", 3.0))
    agh_w = dataclasses.replace(
        agh_w, having=mod.Having(">", _threshold(mod, agh_w, db, 0.6)))
    aagh = mod.Query("sales", ("s_grp", "s_sub"), mod.Aggregate("sum", "s_val"),
                     having=mod.Having(">", 0.0),
                     outer_groupby=("s_grp",), outer_agg=mod.Aggregate("sum", None))
    aagh = dataclasses.replace(
        aagh, outer_having=mod.Having(">", _threshold(mod, aagh, db, 0.6)))
    return [agh, agh_w, aagh]


def _join_templates(mod, db):
    """The reference suite's join templates (``tests/test_maintenance.py:89-104``),
    with thresholds calibrated by ``mod``'s own executor."""
    ajgh = mod.Query("sales", ("s_grp",), mod.Aggregate("sum", "s_val"),
                     join=mod.JoinSpec("dim", "s_key", "d_key"))
    ajgh = dataclasses.replace(ajgh, having=mod.Having(">", _threshold(mod, ajgh, db, 0.6)))
    aajgh = mod.Query("sales", ("s_grp", "s_sub"), mod.Aggregate("sum", "s_val"),
                      join=mod.JoinSpec("dim", "s_key", "d_key"),
                      having=mod.Having(">", 0.0),
                      outer_groupby=("s_grp",), outer_agg=mod.Aggregate("sum", None))
    aajgh = dataclasses.replace(
        aajgh, outer_having=mod.Having(">", _threshold(mod, aajgh, db, 0.6)))
    return [ajgh, aajgh]


def _delete_predicate(rng):
    """A value-based deletion predicate removing a small-ish row fraction."""
    kind = rng.integers(0, 3)
    if kind == 0:
        lo = int(rng.integers(0, 200))
        return lambda cols: (cols["s_attr"] >= lo) & (cols["s_attr"] < lo + 30)
    if kind == 1:
        g = int(rng.integers(0, 12))
        return lambda cols: cols["s_grp"] == g
    v = int(rng.integers(1, 7))
    return lambda cols: (cols["s_key"] % 13 == v)


def _assert_maintainers_equal(tm, rm, ctx):
    for field in ("frag_prov", "sums", "counts", "passing", "counted"):
        np.testing.assert_array_equal(getattr(tm, field), getattr(rm, field),
                                      err_msg=f"{ctx} {field}")
    assert (tm.conservative, tm.exact, tm.n_groups, tm.version) == (
        rm.conservative, rm.exact, rm.n_groups, rm.version), ctx
    assert tm.incidence == rm.incidence, ctx
    for a, v in rm.group_values.items():
        np.testing.assert_array_equal(tm.group_values[a], np.asarray(v), err_msg=ctx)


# ---------------------------------------------------------------------------
# 1. Maintainer-level differential replay (tests/test_maintenance.py:182).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(30))
def test_differential_replay_maintainer(seed):
    rng = np.random.default_rng(seed)
    fact_np = _mk_batch(rng, 500)
    dim_np = _mk_dim()
    rdb, tdb = _db(R, fact_np, dim_np), _db(T, fact_np, dim_np)
    rqs, tqs = _templates(R, rdb), _templates(T, tdb)
    assert [q.signature() for q in tqs] == [q.signature() for q in rqs]
    k = int(rng.integers(0, len(tqs)))
    rq, tq = rqs[k], tqs[k]
    safe = T.monotone_safe(tq, tdb)
    assert safe == R.monotone_safe(rq, rdb)
    attrs = ["s_grp"] + (["s_attr"] if safe else [])
    attr = attrs[int(rng.integers(0, len(attrs)))]
    n_ranges = int(rng.integers(6, 16))
    rranges = R.equi_depth_ranges(rdb["sales"], attr, n_ranges)
    tranges = T.equi_depth_ranges(tdb["sales"], attr, n_ranges)
    np.testing.assert_array_equal(tranges.bounds, rranges.bounds)

    rcat, tcat = R.Catalog(), T.Catalog()
    rt, tt = rdb["sales"], tdb["sales"]
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
            if mask.all():  # never delete the whole table
                continue
            rt, tt = rt.delete(mask), tt.delete(mask)
            fact_np = {k: v[~pred(fact_np)] for k, v in fact_np.items()}
        rdb, tdb = rdb.with_table(rt), tdb.with_table(tt)
        rm.apply(rt, rdb)
        tm.apply(tt, tdb)
        ctx = f"seed={seed} tmpl={tq.template} attr={attr} step={step} op={op}"
        _assert_maintainers_equal(tm, rm, ctx)
        oracle = T.capture_sketch(tq, _db(T, fact_np, dim_np), tranges, catalog=T.Catalog())
        np.testing.assert_array_equal(tm.bits(), oracle.bits, err_msg=ctx)
        if op == "query":
            tsk = tm.to_sketch(tt, tcat)
            rsk = rm.to_sketch(rt, rcat)
            assert tsk.size_rows == oracle.size_rows == rsk.size_rows, ctx
            got = T.execute_with_sketch(tq, tdb, tsk, catalog=tcat).canonical()
            assert got == R.execute_with_sketch(rq, rdb, rsk, catalog=rcat).canonical(), ctx
            assert got == T.execute(tq, _db(T, fact_np, dim_np)).canonical(), ctx


# ---------------------------------------------------------------------------
# 2. Engine-level differential replay (tests/test_maintenance.py:237).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_differential_replay_engine(seed):
    rng = np.random.default_rng(1000 + seed)
    fact_np = _mk_batch(rng, 900)
    dim_np = _mk_dim()
    rdb, tdb = _db(R, fact_np, dim_np), _db(T, fact_np, dim_np)
    rqs, tqs = _templates(R, rdb), _templates(T, tdb)
    args = dict(strategy="CB-OPT-GB", n_ranges=10, theta=0.3, seed=seed,
                min_selectivity_gain=2.0)
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
            assert t_res.canonical() == T.execute(tqs[k], _db(T, fact_np, dim_np)).canonical()
            assert (t_info.reused, t_info.created, t_info.repaired, t_info.attr) == (
                r_info.reused, r_info.created, r_info.repaired, r_info.attr), ctx
            odb = _db(T, fact_np, dim_np)
            for e in teng.index.entries():
                if e.sketch.current_for(teng.db["sales"]):
                    osk = T.capture_sketch(e.query, odb, e.sketch.ranges, catalog=T.Catalog())
                    np.testing.assert_array_equal(e.sketch.bits, osk.bits, err_msg=ctx)
    rents = sorted(reng.index.entries(), key=lambda e: repr(e.query.signature()))
    tents = sorted(teng.index.entries(), key=lambda e: repr(e.query.signature()))
    assert len(rents) == len(tents)
    for re_, te in zip(rents, tents):
        np.testing.assert_array_equal(te.sketch.bits, re_.sketch.bits)
        assert (te.sketch.table_version, te.uses) == (re_.sketch.table_version, re_.uses)
        _assert_maintainers_equal(te.maintainer, re_.maintainer, f"seed={seed}")
    assert dict(teng.catalog.stats) == dict(reng.catalog.stats)


def test_differential_replay_engine_exercises_maintenance():
    """Across the engine replays the repair path runs, mostly through
    maintenance rather than re-capture."""
    stats = []
    for seed in range(4):
        rng = np.random.default_rng(1000 + seed)
        fact_np = _mk_batch(rng, 900)
        tdb = _db(T, fact_np, _mk_dim())
        tqs = _templates(T, tdb)
        eng = TPBDSEngine(tdb, strategy="CB-OPT-GB", n_ranges=10, theta=0.3, seed=seed,
                          min_selectivity_gain=2.0)
        for _ in range(12):
            op = rng.choice(["append", "delete", "query"], p=[0.25, 0.2, 0.55])
            if op == "append":
                eng.append_rows("sales", _mk_batch(rng, int(rng.integers(30, 150))))
            elif op == "delete":
                pred = _delete_predicate(rng)
                mask = pred({k: eng.db["sales"][k].numpy() for k in ("s_attr", "s_grp", "s_key")})
                if not mask.all():
                    eng.delete_rows("sales", mask)
            else:
                eng.run(tqs[int(rng.integers(0, len(tqs)))])
        stats.append(eng.catalog.stats)
    maintained = sum(s.get("sketch_maintained", 0) for s in stats)
    recaptured = sum(s.get("sketch_recaptured", 0) for s in stats)
    assert maintained > 0 and maintained >= recaptured


# ---------------------------------------------------------------------------
# 3. The delta path does no full-table host work (tests/test_maintenance.py:255, :285).
# ---------------------------------------------------------------------------


def test_maintained_append_does_zero_full_table_rebucketization():
    rng = np.random.default_rng(7)
    fact_np = _mk_batch(rng, 2_000)
    batches = [_mk_batch(rng, 100) for _ in range(3)]
    engines = []
    for mod, cls in ((R, RPBDSEngine), (T, TPBDSEngine)):
        db = _db(mod, fact_np, _mk_dim())
        q = _templates(mod, db)[0]
        eng = cls(db, strategy="CB-OPT-GB", n_ranges=10, theta=0.3, seed=0,
                  min_selectivity_gain=2.0)
        _, info = eng.run(q)
        assert info.created
        before = dict(eng.catalog.stats)
        for batch in batches:
            eng.append_rows("sales", batch)
            _, info = eng.run(q)
            assert info.reused and info.repaired
        engines.append((eng, before, dict(eng.catalog.stats)))
    (_, r_before, r_after), (_, before, after) = engines
    for counter in ("bucketize", "fragment_sizes"):
        assert after.get(counter, 0) == before.get(counter, 0), counter
    assert after.get("encode_groups", 0) - before.get("encode_groups", 0) <= 3
    assert after.get("bucketize_delta", 0) > before.get("bucketize_delta", 0)
    assert after.get("fragment_sizes_delta", 0) > before.get("fragment_sizes_delta", 0)
    assert after.get("sketch_maintained", 0) - before.get("sketch_maintained", 0) == 3
    assert after.get("sketch_recaptured", 0) == before.get("sketch_recaptured", 0)
    assert (before, after) == (r_before, r_after)


def test_selection_on_appended_table_extends_sample_without_rebucketize():
    rng = np.random.default_rng(11)
    fact_np = _mk_batch(rng, 2_000)
    batch = _mk_batch(rng, 120)
    out = []
    for mod, cls in ((R, RPBDSEngine), (T, TPBDSEngine)):
        db = _db(mod, fact_np, _mk_dim())
        qs = _templates(mod, db)
        eng = cls(db, strategy="CB-OPT-GB", n_ranges=10, theta=0.3, seed=0,
                  min_selectivity_gain=2.0,
                  selection=mod.SelectionConfig(skip_single_candidate=False))
        eng.run(qs[0])
        eng.append_rows("sales", batch)
        before_b = eng.catalog.stats.get("bucketize", 0)
        before_ext = eng.samples.extended
        q2 = dataclasses.replace(qs[0], having=mod.Having(">", qs[0].having.value * 0.5))
        res, info = eng.run(q2)
        assert eng.samples.extended == before_ext + 1
        assert eng.catalog.stats.get("bucketize", 0) == before_b
        (sample, _), = eng.samples._cache.values()
        out.append((res, info, sample))
    (r_res, r_info, r_s), (t_res, t_info, t_s) = out
    full = {k: np.concatenate([fact_np[k], batch[k]]) for k in fact_np}
    assert t_res.canonical() == T.execute(q2, _db(T, full, _mk_dim())).canonical()
    assert t_res.canonical() == r_res.canonical()
    assert (t_info.created, t_info.attr, t_info.selectivity) == (
        r_info.created, r_info.attr, r_info.selectivity)
    for field in ("indices", "sample_gid", "group_sizes", "sample_sizes"):
        np.testing.assert_array_equal(getattr(t_s, field), getattr(r_s, field), err_msg=field)


def test_extend_sample_for_append_matches_reference():
    """Bernoulli inclusion draws with the port's threefry: the extended
    sample's rows, group ids and new group keys equal the reference's."""
    import jax

    from repro.aqp.sampling import extend_sample_for_append as r_extend
    from repro.aqp.sampling import stratified_reservoir_sample as r_sample
    from repro_torch import prng

    rng = np.random.default_rng(17)
    fact_np = _mk_batch(rng, 1_500)
    batches = [_mk_batch(rng, 90), _mk_batch(rng, 40)]
    batches[1]["s_grp"][:5] = 40 + np.arange(5, dtype=np.int32)  # unseen groups
    rt = R.from_numpy("sales", fact_np)
    rs = r_sample(jax.random.PRNGKey(3), rt, ("s_grp", "s_sub"), 0.1)
    ts = SampleSet(**{f.name: getattr(rs, f.name) for f in dataclasses.fields(SampleSet)})
    r_out = r_extend(jax.random.PRNGKey(5), rs, tuple(R.from_numpy("sales", b) for b in batches),
                     (1_500, 1_590))
    t_out = extend_sample_for_append(
        prng.PRNGKey(5), ts, tuple(T.from_numpy("sales", b, device="cpu") for b in batches),
        (1_500, 1_590))
    for field in ("indices", "sample_gid", "group_sizes", "sample_sizes"):
        np.testing.assert_array_equal(getattr(t_out, field), getattr(r_out, field), err_msg=field)
    assert t_out.n_groups == r_out.n_groups == rs.n_groups + 5
    for a in ("s_grp", "s_sub"):
        np.testing.assert_array_equal(t_out.group_values[a], r_out.group_values[a])


# ---------------------------------------------------------------------------
# 4. Table-level delta mechanics (tests/test_maintenance.py:318, :349).
# ---------------------------------------------------------------------------


def test_append_delete_versioning():
    """The versioning half of ``test_append_delete_versioning_and_layout``
    (the layout half waits for ``cluster_by``)."""
    rng = np.random.default_rng(3)
    t1 = T.from_numpy("sales", _mk_batch(rng, 500), device="cpu")
    assert t1.version == 0 and t1.delta is None
    batch = _mk_batch(rng, 60)
    t2 = t1.append(batch)
    assert t2.version == 1 and t2.uid == t1.uid
    assert t2.delta.kind == "append" and t2.delta.parent is t1 and t2.delta.n_delta == 60
    assert t2.num_rows == 560
    np.testing.assert_array_equal(t2["s_val"].numpy()[:500], t1["s_val"].numpy())
    np.testing.assert_array_equal(t2["s_val"].numpy()[500:], batch["s_val"])

    mask = np.zeros(560, dtype=bool)
    mask[rng.choice(560, 80, replace=False)] = True
    t3 = t2.delete(mask)
    assert t3.version == 2 and t3.num_rows == 480 and t3.uid == t1.uid
    assert t3.delta.kind == "delete" and t3.delta.n_delta == 80
    np.testing.assert_array_equal(t3["s_attr"].numpy(), t2["s_attr"].numpy()[~mask])
    assert t3.delta_depth() == 2
    t4 = t3.collapse()
    assert (t4.uid, t4.version, t4.delta, t4.delta_depth()) == (t3.uid, 2, None, 0)
    # A gathered copy is a fresh lineage.
    assert t3.gather(np.arange(10)).uid != t3.uid


def test_append_rejects_lossy_cast_and_bad_batches():
    rng = np.random.default_rng(4)
    t = T.from_numpy("sales", _mk_batch(rng, 50), device="cpu")
    batch = _mk_batch(rng, 5)
    lossy = dict(batch, s_val=batch["s_val"] + 0.5)
    with pytest.raises(ValueError, match="lossy"):
        t.append(lossy)
    with pytest.raises(ValueError, match="schema"):
        t.append({k: v for k, v in batch.items() if k != "s_val"})
    with pytest.raises(ValueError, match="ragged"):
        t.append(dict(batch, s_val=batch["s_val"][:3]))
    with pytest.raises(ValueError):
        t.delete(np.zeros(49, dtype=bool))
    # int64 values that fit int32 are not lossy.
    t2 = t.append({k: v.astype(np.int64) for k, v in batch.items()})
    assert t2["s_val"].dtype == torch.int32


def test_catalog_delta_refresh_matches_full_recompute():
    rng = np.random.default_rng(5)
    fact = _mk_batch(rng, 800)
    batch = _mk_batch(rng, 100)
    batch["s_grp"][:3] = [50, 51, 50]  # unseen keys, numbered after the existing groups
    encs = []
    for mod in (R, T):
        t0 = (T.from_numpy("sales", fact, device="cpu") if mod is T
              else R.from_numpy("sales", fact))
        ranges = mod.equi_depth_ranges(t0, "s_attr", 9)
        cat = mod.Catalog()
        cat.bucketize(t0, ranges)
        cat.groups(t0, ("s_grp", "s_sub"))
        cat.fragment_sizes(t0, ranges)
        t1 = t0.append(batch)
        mask = np.asarray(t1["s_key"]) % 5 == 0
        t2 = t1.delete(mask)
        before = cat.stats.get("bucketize", 0), cat.stats.get("encode_groups", 0)
        bucket = np.asarray(cat.bucketize(t2, ranges))
        sizes = cat.fragment_sizes(t2, ranges)
        enc = cat.groups(t2, ("s_grp", "s_sub"))
        after = cat.stats.get("bucketize", 0), cat.stats.get("encode_groups", 0)
        assert before == after  # all delta refreshes
        assert cat.stats.get("bucketize_delta", 0) >= 2
        np.testing.assert_array_equal(bucket, np.asarray(ranges.bucketize(t2["s_attr"])))
        np.testing.assert_array_equal(sizes, np.bincount(bucket, minlength=ranges.n_ranges))
        for a in ("s_grp", "s_sub"):
            np.testing.assert_array_equal(
                enc.group_values[a][enc.gid], np.asarray(t2[a]), err_msg=a)
        encs.append((enc, bucket, sizes, dict(cat.stats)))
    (r_enc, r_bucket, r_sizes, r_stats), (t_enc, t_bucket, t_sizes, t_stats) = encs
    np.testing.assert_array_equal(t_enc.gid, r_enc.gid)
    assert t_enc.n_groups == r_enc.n_groups
    for a in ("s_grp", "s_sub"):
        np.testing.assert_array_equal(t_enc.group_values[a], r_enc.group_values[a])
    np.testing.assert_array_equal(t_bucket, r_bucket)
    np.testing.assert_array_equal(t_sizes, r_sizes)
    assert t_stats == r_stats


def test_where_mask_and_column_stats_refresh_from_deltas():
    rng = np.random.default_rng(6)
    t0 = T.from_numpy("sales", _mk_batch(rng, 300), device="cpu")
    pred = T.Predicate("s_sub", ">=", 3.0)
    cat = T.Catalog()
    cat.where_mask(t0, pred)
    cat.distinct_count(t0, "s_attr")
    cat.column_nonnegative(t0, "s_val")
    t1 = t0.append(_mk_batch(rng, 40))
    t2 = t1.delete(t1["s_grp"].numpy() == 3)
    for t in (t1, t2):
        np.testing.assert_array_equal(cat.where_mask(t, pred).numpy(), t["s_sub"].numpy() >= 3)
        assert cat.column_nonnegative(t, "s_val")
    assert cat.distinct_count(t1, "s_attr") == len(np.unique(t1["s_attr"].numpy()))
    assert cat.stats["where_mask"] == 1 and cat.stats["where_mask_delta"] == 2
    assert cat.stats["distinct_count_delta"] == 1 and cat.stats["column_stats_delta"] == 2
    cat.invalidate_chain(t2)
    assert cat.where_mask(t2, pred) is not None and cat.stats["where_mask"] == 2


# ---------------------------------------------------------------------------
# 5. History bound, float32 envelope, state round trip, re-capture fallback.
# ---------------------------------------------------------------------------


def test_engine_bounds_delta_history():
    """Past ``max_delta_chain`` the engine advances maintainers and collapses
    the chain; results and bits stay exact and equal the reference's."""
    rng = np.random.default_rng(23)
    fact_np = _mk_batch(rng, 800)
    batches = [_mk_batch(rng, 40) for _ in range(10)]
    out = []
    for mod, cls in ((R, RPBDSEngine), (T, TPBDSEngine)):
        db = _db(mod, fact_np, _mk_dim())
        q = _templates(mod, db)[0]
        eng = cls(db, strategy="CB-OPT-GB", n_ranges=10, theta=0.3, seed=0,
                  min_selectivity_gain=2.0, max_delta_chain=3)
        eng.run(q)
        for batch in batches:
            eng.append_rows("sales", batch)
        assert eng.db["sales"].delta_depth() <= 3
        assert eng.catalog.stats.get("history_collapse", 0) >= 2
        res, _ = eng.run(q)
        out.append((q, res, eng.index.entries()[0], dict(eng.catalog.stats)))
    (_, r_res, r_entry, r_stats), (q, t_res, t_entry, t_stats) = out
    full = {k: np.concatenate([fact_np[k]] + [b[k] for b in batches]) for k in fact_np}
    odb = _db(T, full, _mk_dim())
    assert t_res.canonical() == T.execute(q, odb).canonical() == r_res.canonical()
    osk = T.capture_sketch(t_entry.query, odb, t_entry.sketch.ranges, catalog=T.Catalog())
    np.testing.assert_array_equal(t_entry.sketch.bits, osk.bits)
    np.testing.assert_array_equal(t_entry.sketch.bits, r_entry.sketch.bits)
    assert t_stats == r_stats


def test_clears_held_back_outside_f32_exact_envelope():
    """Group sums beyond 2**24: a flip to "failing" keeps its bits (superset,
    never subset), in the port as in the reference."""
    rng = np.random.default_rng(29)
    n = 400
    cols = dict(
        g=np.repeat(np.arange(4, dtype=np.int32), n // 4),
        a=rng.integers(0, 100, n).astype(np.int32),
        v=np.full(n, 1_000_000, dtype=np.int64),  # sums ~1e8 >> 2**24
    )
    mask = (cols["g"] == 0) & (np.arange(n) % 2 == 0)
    ms = []
    for mod in (R, T):
        kw = {"device": "cpu"} if mod is T else {}
        t = mod.from_numpy("t", cols, **kw)
        db = mod.Database({"t": t})
        q = mod.Query("t", ("g",), mod.Aggregate("sum", "v"),
                      having=mod.Having(">", 99_000_000.0 * n / 400))
        ranges = mod.equi_depth_ranges(t, "a", 6)
        m = mod.build_maintainer(q, db, ranges, mod.Catalog())
        assert m.exact and m._values_integral and not m._clears_trustworthy()
        t2 = t.delete(mask)
        m.apply(t2, mod.Database({"t": t2}))
        assert m.conservative
        ms.append(m)
    rm, tm = ms
    _assert_maintainers_equal(tm, rm, "envelope")
    tdb = T.Database({"t": T.from_numpy("t", {k: v[~mask] for k, v in cols.items()},
                                        device="cpu")})
    oracle = T.capture_sketch(tm.q, tdb, tm.ranges, catalog=T.Catalog())
    got = tm.bits()
    assert ((got | oracle.bits) == got).all()
    tm.repair()
    assert not tm.conservative
    np.testing.assert_array_equal(tm.bits(), oracle.bits)


def test_state_dict_round_trip_matches_reference():
    rng = np.random.default_rng(31)
    fact_np = _mk_batch(rng, 600)
    batch = _mk_batch(rng, 50)
    states = []
    for mod in (R, T):
        db = _db(mod, fact_np, _mk_dim())
        q = _templates(mod, db)[2]
        ranges = mod.equi_depth_ranges(db["sales"], "s_grp", 8)
        m = mod.build_maintainer(q, db, ranges, mod.Catalog())
        state = m.state_dict()
        t2 = db["sales"].append(batch)
        db2 = db.with_table(t2)
        back = mod.SketchMaintainer.from_state(q, db, ranges, state)
        back.apply(t2, db2)
        m.apply(t2, db2)
        _assert_maintainers_equal(back, m, str(mod.__name__))
        states.append(state)
    r_state, t_state = states
    for k in ("version", "exact", "conservative", "values_integral", "n_groups"):
        assert t_state[k] == r_state[k], k
    for k in ("sums", "counts", "passing", "counted", "frag_prov"):
        np.testing.assert_array_equal(t_state[k], r_state[k], err_msg=k)
    for a, b in zip(t_state["incidence"], r_state["incidence"]):
        np.testing.assert_array_equal(a, b)
    other = T.from_numpy("sales", fact_np, device="cpu")  # another lineage
    tdb = _db(T, fact_np, _mk_dim()).with_table(other)
    with pytest.raises(T.MaintenanceError):
        T.SketchMaintainer.from_state(_templates(T, tdb)[2], tdb,
                                      T.equi_depth_ranges(other, "s_grp", 8), t_state)


def test_repair_recaptures_without_a_maintainer():
    """A stale entry with no maintainer is re-captured, and gets one back."""
    rng = np.random.default_rng(13)
    fact_np = _mk_batch(rng, 900)
    db = _db(T, fact_np, _mk_dim())
    q = _templates(T, db)[0]
    eng = TPBDSEngine(db, strategy="CB-OPT-GB", n_ranges=10, theta=0.3, seed=0,
                      min_selectivity_gain=2.0)
    _, info = eng.run(q)
    assert info.created
    entry = eng.index.entries()[0]
    entry.maintainer = None
    batch = _mk_batch(rng, 50)
    eng.append_rows("sales", batch)
    res, info = eng.run(q)
    assert info.reused and info.repaired
    assert eng.catalog.stats["sketch_recaptured"] == 1
    assert entry.maintainer is not None
    full = {k: np.concatenate([fact_np[k], batch[k]]) for k in fact_np}
    assert res.canonical() == T.execute(q, _db(T, full, _mk_dim())).canonical()


def test_join_queries_are_not_maintained():
    """Across a mutated *dimension* table a join maintainer refuses
    (``MaintenanceError``, where the reference raises it) and the engine
    re-captures: ``tests/test_maintenance.py::
    test_repair_falls_back_to_recapture_on_dimension_mutation`` on both
    packages, with equal results, counters and re-captured bits."""
    out = []
    for mod, cls in ((R, RPBDSEngine), (T, TPBDSEngine)):
        rng = np.random.default_rng(13)
        fact_np = _mk_batch(rng, 900)
        db = _db(mod, fact_np, _mk_dim())
        ajgh = _join_templates(mod, db)[0]
        eng = cls(db, strategy="CB-OPT-GB", n_ranges=10, theta=0.3, seed=0,
                  min_selectivity_gain=2.0)
        _, info = eng.run(ajgh)
        assert info.created
        entry = eng.index.entries()[0]
        maintainer = entry.maintainer
        eng.db = eng.db.with_table(eng.db["dim"].append(dict(
            d_key=np.array([N_DIM + 1], np.int32), d_w=np.array([3], np.int32))))
        batch = _mk_batch(rng, 50)
        eng.append_rows("sales", batch)
        with pytest.raises(mod.MaintenanceError, match="join dimension table mutated"):
            maintainer.apply(eng.db["sales"], eng.db)
        res, info = eng.run(ajgh)
        assert info.reused and info.repaired
        assert eng.catalog.stats.get("sketch_recaptured", 0) == 1
        assert eng.catalog.stats.get("sketch_maintained", 0) == 0
        assert entry.maintainer is not None and entry.maintainer is not maintainer
        full = {k: np.concatenate([fact_np[k], batch[k]]) for k in fact_np}
        dim = {k: np.concatenate([v, [N_DIM + 1 if k == "d_key" else 3]]).astype(np.int32)
               for k, v in _mk_dim().items()}
        assert res.canonical() == mod.execute(ajgh, _db(mod, full, dim)).canonical()
        out.append((res, entry, dict(eng.catalog.stats)))
    (r_res, r_entry, r_stats), (t_res, t_entry, t_stats) = out
    assert t_res.canonical() == r_res.canonical()
    np.testing.assert_array_equal(t_entry.sketch.bits, r_entry.sketch.bits)
    _assert_maintainers_equal(t_entry.maintainer, r_entry.maintainer, "re-built")
    assert t_stats == r_stats


@pytest.mark.parametrize("holes", [False, True], ids=["full_dim", "dim_with_holes"])
@pytest.mark.parametrize("seed", range(12))
def test_differential_replay_maintainer_join(seed, holes):
    """``tests/test_maintenance.py:182``'s maintainer replay over the join
    templates: after every delta the port's maintainer equals the
    reference's and its bits a from-scratch capture."""
    rng = np.random.default_rng(500 + seed)
    fact_np = _mk_batch(rng, 500)
    dim_np = _mk_dim(holes=holes)
    rdb, tdb = _db(R, fact_np, dim_np), _db(T, fact_np, dim_np)
    rqs, tqs = _join_templates(R, rdb), _join_templates(T, tdb)
    assert [q.signature() for q in tqs] == [q.signature() for q in rqs]
    k = seed % 2
    rq, tq = rqs[k], tqs[k]
    attrs = ["s_grp"] + (["s_attr"] if T.monotone_safe(tq, tdb) else [])
    attr = attrs[int(rng.integers(0, len(attrs)))]
    n_ranges = int(rng.integers(6, 16))
    rranges = R.equi_depth_ranges(rdb["sales"], attr, n_ranges)
    tranges = T.equi_depth_ranges(tdb["sales"], attr, n_ranges)
    rcat, tcat = R.Catalog(), T.Catalog()
    rt, tt = rdb["sales"], tdb["sales"]
    rm = R.build_maintainer(rq, rdb, rranges, rcat)
    tm = T.build_maintainer(tq, tdb, tranges, tcat)
    assert tm.right is tdb["dim"]
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
            rt, tt = rt.delete(mask), tt.delete(mask)
            fact_np = {k: v[~pred(fact_np)] for k, v in fact_np.items()}
        rdb, tdb = rdb.with_table(rt), tdb.with_table(tt)
        rm.apply(rt, rdb)
        tm.apply(tt, tdb)
        ctx = f"seed={seed} tmpl={tq.template} attr={attr} step={step} op={op}"
        _assert_maintainers_equal(tm, rm, ctx)
        oracle = T.capture_sketch(tq, _db(T, fact_np, dim_np), tranges, catalog=T.Catalog())
        np.testing.assert_array_equal(tm.bits(), oracle.bits, err_msg=ctx)
        if op == "query":
            tsk, rsk = tm.to_sketch(tt, tcat), rm.to_sketch(rt, rcat)
            assert tsk.size_rows == oracle.size_rows == rsk.size_rows, ctx
            got = T.execute_with_sketch(tq, tdb, tsk, catalog=tcat).canonical()
            assert got == R.execute_with_sketch(rq, rdb, rsk, catalog=rcat).canonical(), ctx
            assert got == T.execute(tq, _db(T, fact_np, dim_np)).canonical(), ctx


@pytest.mark.parametrize("seed", range(3))
def test_differential_replay_engine_join(seed):
    """``tests/test_maintenance.py:237``'s engine replay over all five
    templates (the join ones included) and a dimension with missing keys:
    results, infos, index contents, maintainers and catalog counters equal
    the reference's, and results equal full execution."""
    rng = np.random.default_rng(2000 + seed)
    fact_np = _mk_batch(rng, 900)
    dim_np = _mk_dim(holes=seed % 2 == 1)
    rdb, tdb = _db(R, fact_np, dim_np), _db(T, fact_np, dim_np)
    rqs = _templates(R, rdb) + _join_templates(R, rdb)
    tqs = _templates(T, tdb) + _join_templates(T, tdb)
    args = dict(strategy="CB-OPT-GB", n_ranges=10, theta=0.3, seed=seed,
                min_selectivity_gain=2.0)
    reng, teng = RPBDSEngine(rdb, **args), TPBDSEngine(tdb, **args)
    for _ in range(14):
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
            assert t_res.canonical() == T.execute(tqs[k], _db(T, fact_np, dim_np)).canonical()
            assert (t_info.reused, t_info.created, t_info.repaired, t_info.attr) == (
                r_info.reused, r_info.created, r_info.repaired, r_info.attr), ctx
    rents = sorted(reng.index.entries(), key=lambda e: repr(e.query.signature()))
    tents = sorted(teng.index.entries(), key=lambda e: repr(e.query.signature()))
    assert len(rents) == len(tents)
    for re_, te in zip(rents, tents):
        np.testing.assert_array_equal(te.sketch.bits, re_.sketch.bits)
        _assert_maintainers_equal(te.maintainer, re_.maintainer, f"seed={seed}")
    assert dict(teng.catalog.stats) == dict(reng.catalog.stats)
    assert teng.catalog.stats.get("join_delta", 0) > 0


def test_join_state_dict_round_trip_matches_reference():
    """A join maintainer's state carries the dimension's uid and version; a
    restore against a moved dimension refuses, as the reference's does."""
    rng = np.random.default_rng(41)
    fact_np = _mk_batch(rng, 600)
    batch = _mk_batch(rng, 50)
    states = []
    for mod in (R, T):
        db = _db(mod, fact_np, _mk_dim(holes=True))
        q = _join_templates(mod, db)[1]
        ranges = mod.equi_depth_ranges(db["sales"], "s_grp", 8)
        m = mod.build_maintainer(q, db, ranges, mod.Catalog())
        state = m.state_dict()
        assert (state["right_uid"], state["right_version"]) == (db["dim"].uid, 0)
        t2 = db["sales"].append(batch)
        db2 = db.with_table(t2)
        back = mod.SketchMaintainer.from_state(q, db, ranges, state)
        back.apply(t2, db2)
        m.apply(t2, db2)
        _assert_maintainers_equal(back, m, str(mod.__name__))
        moved = db.with_table(db["dim"].append(dict(
            d_key=np.array([N_DIM + 3], np.int32), d_w=np.array([1], np.int32))))
        with pytest.raises(mod.MaintenanceError):
            mod.SketchMaintainer.from_state(q, moved, ranges, state)
        states.append(state)
    r_state, t_state = states
    for k in ("version", "exact", "conservative", "values_integral", "n_groups"):
        assert t_state[k] == r_state[k], k
    for k in ("sums", "counts", "passing", "counted", "frag_prov"):
        np.testing.assert_array_equal(t_state[k], r_state[k], err_msg=k)


def test_dimension_append_on_a_hit_matches_reference():
    """A dimension append that gives dangling fact rows a partner leaves the
    single-node hit path's sketch in place (it is versioned against the fact
    table only): the port serves what the reference serves.  Both then
    differ from full execution: the reference fault recorded in ROADMAP C5,
    kept identical here, not fixed in the port alone."""
    outs = []
    for mod, cls in ((R, RPBDSEngine), (T, TPBDSEngine)):
        rng = np.random.default_rng(13)
        fact_np = _mk_batch(rng, 900)
        db = _db(mod, fact_np, _mk_dim(holes=True))
        ajgh = _join_templates(mod, db)[0]
        eng = cls(db, strategy="CB-OPT-GB", n_ranges=10, theta=0.3, seed=0,
                  min_selectivity_gain=2.0)
        _, info = eng.run(ajgh)
        assert info.created
        missing = _mk_dim()
        missing = {k: v[missing["d_key"] % 3 == 0] for k, v in missing.items()}
        eng.append_rows("dim", missing)
        res, info = eng.run(ajgh)
        assert info.reused and not info.repaired
        full = mod.execute(ajgh, eng.db)
        outs.append((res, full, eng.index.entries()[0].sketch.bits))
    (r_res, r_full, r_bits), (t_res, t_full, t_bits) = outs
    assert t_res.canonical() == r_res.canonical()
    assert t_full.canonical() == r_full.canonical()
    np.testing.assert_array_equal(t_bits, r_bits)
    assert t_res.canonical() != t_full.canonical()  # ROADMAP C5


def test_clone_for_and_maintainer_for_equal_a_fresh_build():
    """A clone shares the counting state of its pool-mate and equals a fresh
    build for its own threshold, before and after a delta, as the
    reference's does."""
    rng = np.random.default_rng(37)
    fact_np = _mk_batch(rng, 700)
    batch = _mk_batch(rng, 60)
    batch["s_grp"][:4] = 30  # a new group
    built = []
    for mod in (R, T):
        db = _db(mod, fact_np, _mk_dim())
        base = _templates(mod, db)[0]
        q2 = dataclasses.replace(base, having=mod.Having(">", base.having.value * 0.8))
        ranges = mod.equi_depth_ranges(db["sales"], "s_attr", 9)
        cat = mod.Catalog()
        first = mod.build_maintainer(base, db, ranges, cat)
        if mod is T:
            from repro_torch.core.maintenance import maintainer_for
        else:
            from repro.core.maintenance import maintainer_for
        clone = maintainer_for(q2, db, ranges, cat, [first])
        fresh = mod.build_maintainer(q2, db, ranges, cat)
        _assert_maintainers_equal(clone, fresh, f"{mod.__name__} clone")
        t2 = db["sales"].append(batch)
        db2 = db.with_table(t2)
        for m in (first, clone, fresh):
            m.apply(t2, db2)
        _assert_maintainers_equal(clone, fresh, f"{mod.__name__} clone after delta")
        # Copy on write: the delta's rows were copied before they changed.
        assert first.incidence == clone.incidence
        assert any(a is not b for a, b in zip(first.incidence, clone.incidence))
        built.append((first, clone))
    (r_first, r_clone), (t_first, t_clone) = built
    _assert_maintainers_equal(t_first, r_first, "first")
    _assert_maintainers_equal(t_clone, r_clone, "clone")
