"""The port's batched admission against the reference's, on the CPU.

``PBDSEngine.run_batch`` must give, on the same seeded tpch and crimes data,
what the reference's ``run_batch`` gives and what the port's own sequential
``run`` gives: equal canonical results, equal ``RunInfo``
(reused/created/repaired/attr), and equal index contents (queries, sketch
bits, sizes, attributes, and the maintainers' ``frag_prov``, sums, counts,
surviving sets and conservatism), as ``_assert_index_parity`` in
``tests/test_admission.py`` holds them.  The data is integral, both sides
add float32 in row order on the CPU, so "equal" means equal bits
everywhere.  Also here: the batched bitmap's plain version against the
reference's Pallas kernel (interpret mode) and jnp oracle, batched capture
against per-query capture, the shared-work counters, the join templates'
batches, and a ``cuda`` test of the CUDA kernel that skips without a card.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import datasets as rdata
from repro.core.engine import PBDSEngine as RPBDSEngine
from repro.core.sketch import capture_sketches_batch as r_capture_batch
from repro.core.workload import WorkloadLog as RWorkloadLog
from repro.kernels import ops as jops
from repro.kernels import ref as jref
import repro_torch.core as T
from repro_torch.convert import database_from_numpy
from repro_torch.core.engine import PBDSEngine as TPBDSEngine
from repro_torch.core.workload import WorkloadLog as TWorkloadLog
from repro_torch.kernels import ops, ref
from repro_torch.runtime.guards import LAUNCH_COUNTS

torch.set_num_threads(1)  # small tensors; leave the cores to the other xdist workers

N_ROWS = 20_000
RNG = np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _port_db(rdb):
    return database_from_numpy(
        [(n, {a: np.asarray(rdb[n][a]) for a in rdb[n].schema}, rdb[n].primary_key)
         for n in rdb.names], device="cpu")


@pytest.fixture(scope="module")
def tpch():
    rdb = rdata.make_tpch(N_ROWS, seed=7)
    return rdb, _port_db(rdb)


@pytest.fixture(scope="module")
def crimes():
    rdb = R.Database({"crimes": rdata.make_crimes(N_ROWS, seed=11)})
    return rdb, _port_db(rdb)


# Per dataset: (table, Q-AGH group-by and aggregate, Q-AAGH inner and outer group-by).
SHAPES = {
    "tpch": ("lineitem", ("l_suppkey",), ("sum", "l_quantity"),
             ("l_suppkey", "l_partkey"), ("l_suppkey",)),
    "crimes": ("crimes", ("district", "year"), ("sum", "records"),
               ("district", "year"), ("district",)),
}


def _threshold(mod, q, db, quantile):
    vals = mod.execute(dataclasses.replace(q, having=None, outer_having=None), db).values
    return float(np.quantile(vals, quantile))


def _batch(mod, db, dataset, template, quantiles):
    """Queries differing only in HAVING threshold, descending, so that no
    earlier query subsumes a later one (every query is a miss).  The join
    templates (tpch only) join lineitem with orders, as
    ``tests/test_admission.py:72,92`` do."""
    table, gb, (fn, attr), inner_gb, outer_gb = SHAPES[dataset]
    join = mod.JoinSpec("orders", "l_orderkey", "o_orderkey") if "J" in template else None
    if template in ("Q-AGH", "Q-AJGH"):
        q = mod.Query(table, gb, mod.Aggregate(fn, attr), join=join)
        return [dataclasses.replace(q, having=mod.Having(">", _threshold(mod, q, db, qt)))
                for qt in quantiles]
    inner = mod.Query(table, inner_gb, mod.Aggregate(fn, attr), join=join)
    return [dataclasses.replace(
        inner, having=mod.Having(">", _threshold(mod, inner, db, qt)),
        outer_groupby=outer_gb, outer_agg=mod.Aggregate("sum", None),
        outer_having=mod.Having(">", 0.0)) for qt in quantiles]


ENGINE_ARGS = dict(strategy="CB-OPT-GB", n_ranges=40, theta=0.1, seed=0,
                   min_selectivity_gain=0.98)


def _engines(rdb, tdb, **kw):
    args = dict(ENGINE_ARGS, **kw)
    return RPBDSEngine(rdb, **args), TPBDSEngine(tdb, **args), TPBDSEngine(tdb, **args)


def _info(info):
    return (info.reused, info.created, info.repaired, info.attr, info.selectivity)


def _assert_run_parity(want, got, ctx=""):
    assert len(want) == len(got)
    for i, ((w_res, w_info), (g_res, g_info)) in enumerate(zip(want, got)):
        assert g_res.canonical() == w_res.canonical(), f"{ctx} result {i}"
        assert _info(g_info) == _info(w_info), f"{ctx} info {i}"


def _assert_index_parity(e_want, e_got, ctx=""):
    ew = sorted(e_want.index.entries(), key=lambda e: repr(e.query.signature()))
    eg = sorted(e_got.index.entries(), key=lambda e: repr(e.query.signature()))
    assert len(ew) == len(eg), f"{ctx}: {len(ew)} vs {len(eg)} entries"
    for a, b in zip(ew, eg):
        assert a.query.signature() == b.query.signature(), ctx
        np.testing.assert_array_equal(a.sketch.bits, b.sketch.bits, err_msg=ctx)
        assert (a.sketch.size_rows, a.sketch.attr, a.sketch.table_version) == (
            b.sketch.size_rows, b.sketch.attr, b.sketch.table_version), ctx
        ma, mb = a.maintainer, b.maintainer
        assert (ma is None) == (mb is None), ctx
        if ma is not None:
            for field in ("frag_prov", "sums", "counts", "passing"):
                np.testing.assert_array_equal(getattr(ma, field), getattr(mb, field),
                                              err_msg=f"{ctx} {field}")
            assert ma.conservative == mb.conservative, ctx


def _replay(rq, tq, r_eng, t_bat, t_seq, ctx):
    """The same batch through the reference's run_batch, the port's
    run_batch and the port's sequential run; all three must agree."""
    want = r_eng.run_batch(rq)
    got = t_bat.run_batch(tq)
    seq = [t_seq.run(q) for q in tq]
    _assert_run_parity(want, got, f"{ctx} batch")
    _assert_run_parity(seq, got, f"{ctx} sequential")
    return got


# ---------------------------------------------------------------------------
# The kernel's plain version and batched capture
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,n_ranges,b", [(5_000, 37, 5), (4_097, 100, 8), (33, 129, 33),
                                          (1_000, 1, 3)])
def test_fragment_bitmap_batch_plain_matches_reference(n, n_ranges, b):
    """Exact against the reference's jnp oracle and its Pallas kernel in
    interpret mode, at ranges that are not a multiple of 128 and batches
    that are not a power of two; row by row equal to the single bitmap."""
    bucket = RNG.integers(0, n_ranges, n).astype(np.int32)
    provs = RNG.random((b, n)) < 0.05
    want = np.asarray(jref.fragment_bitmap_batch_ref(jnp.asarray(provs), jnp.asarray(bucket),
                                                     n_ranges))
    pallas = np.asarray(jops.fragment_bitmap_batch(jnp.asarray(provs), jnp.asarray(bucket),
                                                   n_ranges, backend="interpret"))
    got = ops.fragment_bitmap_batch(torch.from_numpy(provs), torch.from_numpy(bucket),
                                    n_ranges).numpy()
    assert got.shape == (b, n_ranges) and got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    for i in range(b):
        single = ops.fragment_bitmap(torch.from_numpy(provs[i]), torch.from_numpy(bucket),
                                     n_ranges).numpy()
        np.testing.assert_array_equal(got[i], single)


def test_fragment_bitmap_batch_plain_drops_out_of_range_buckets():
    bucket = torch.tensor([0, -1, 2, 7, 1], dtype=torch.int32)
    provs = torch.ones((2, 5), dtype=torch.bool)
    provs[1, 0] = False
    got = ref.fragment_bitmap_batch_ref(provs, bucket, 3)
    assert got.tolist() == [[True, True, True], [False, True, True]]
    assert ref.fragment_bitmap_batch_ref(torch.zeros((0, 5), dtype=torch.bool),
                                         bucket, 3).shape == (0, 3)


def test_fragment_bitmap_batch_cpu_wrapper_launches_nothing():
    before = dict(LAUNCH_COUNTS)
    ops.fragment_bitmap_batch(torch.ones((2, 3), dtype=torch.bool),
                              torch.tensor([0, 1, 1], dtype=torch.int32), 2)
    assert dict(LAUNCH_COUNTS) == before


@pytest.mark.parametrize("dataset", ["tpch", "crimes"])
def test_capture_sketches_batch_matches_single_and_reference(dataset, tpch, crimes):
    rdb, tdb = {"tpch": tpch, "crimes": crimes}[dataset]
    table, gb = SHAPES[dataset][0], SHAPES[dataset][1]
    tq = _batch(T, tdb, dataset, "Q-AGH", (0.95, 0.9, 0.8))
    rq = _batch(R, rdb, dataset, "Q-AGH", (0.95, 0.9, 0.8))
    # Two partitions, so the queries form two (table, partition) groups.
    tr = [T.equi_depth_ranges(tdb[table], a, 40) for a in (gb[0], gb[0], gb[-1])]
    rr = [R.equi_depth_ranges(rdb[table], a, 40) for a in (gb[0], gb[0], gb[-1])]
    provs = [T.provenance_mask(q, tdb) for q in tq]
    for p, q in zip(provs, rq):
        np.testing.assert_array_equal(p, R.provenance_mask(q, rdb))
    batched = T.capture_sketches_batch(tq, tdb, tr, provs, catalog=T.Catalog())
    r_batched = r_capture_batch(rq, rdb, rr, provs, catalog=R.Catalog())
    for q, prov, ranges, sk_b, sk_r in zip(tq, provs, tr, batched, r_batched):
        sk_s = T.capture_sketch(q, tdb, ranges, prov=prov)
        np.testing.assert_array_equal(sk_b.bits, sk_s.bits)
        np.testing.assert_array_equal(sk_b.bits, sk_r.bits)
        assert (sk_b.size_rows, sk_b.total_rows, sk_b.attr) == (
            sk_s.size_rows, sk_s.total_rows, sk_s.attr) == (
            sk_r.size_rows, sk_r.total_rows, sk_r.attr)


# ---------------------------------------------------------------------------
# run_batch against the reference and against sequential run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("template", ["Q-AGH", "Q-AAGH"])
@pytest.mark.parametrize("dataset", ["tpch", "crimes"])
def test_run_batch_matches_reference(dataset, template, tpch, crimes):
    """All-miss batches with duplicates (deferral waves)."""
    rdb, tdb = {"tpch": tpch, "crimes": crimes}[dataset]
    quantiles = (0.95, 0.9, 0.85, 0.8)
    rq = _batch(R, rdb, dataset, template, quantiles)
    tq = _batch(T, tdb, dataset, template, quantiles)
    assert [q.signature() for q in tq] == [q.signature() for q in rq]
    rq, tq = rq + [rq[0], rq[-1]], tq + [tq[0], tq[-1]]
    r_eng, t_bat, t_seq = _engines(rdb, tdb)
    out = _replay(rq, tq, r_eng, t_bat, t_seq, f"{dataset} {template}")
    _assert_index_parity(r_eng, t_bat, f"{dataset} {template}")
    _assert_index_parity(t_seq, t_bat, f"{dataset} {template} sequential")
    assert sum(i.created for _, i in out) >= 1
    assert sum(i.reused for _, i in out) >= 1
    assert (t_bat.index.hits, t_bat.index.misses) == (r_eng.index.hits, r_eng.index.misses)
    snap_r, snap_t = r_eng.workload.snapshot(), t_bat.workload.snapshot()
    assert snap_t["clock"] == snap_r["clock"]
    assert ([(s, q.signature()) for s, q in snap_t["entries"]]
            == [(s, q.signature()) for s, q in snap_r["entries"]])


@pytest.mark.parametrize("template", ["Q-AJGH", "Q-AAJGH"])
def test_run_batch_join_templates_match_reference(template, tpch):
    """The join templates' all-miss batches with duplicates: the reference's
    ``run_batch``, the port's and the port's sequential ``run`` agree, and
    the signature group's members share one inner-block pass (one join
    materialization, one group encode of the joined table)."""
    rdb, tdb = tpch
    quantiles = (0.95, 0.9, 0.85, 0.8)
    rq = _batch(R, rdb, "tpch", template, quantiles)
    tq = _batch(T, tdb, "tpch", template, quantiles)
    assert [q.signature() for q in tq] == [q.signature() for q in rq]
    assert {q.template for q in tq} == {template}
    rq, tq = rq + [rq[0], rq[-1]], tq + [tq[0], tq[-1]]
    r_eng, t_bat, t_seq = _engines(rdb, tdb)
    out = _replay(rq, tq, r_eng, t_bat, t_seq, f"tpch {template}")
    _assert_index_parity(r_eng, t_bat, f"tpch {template}")
    _assert_index_parity(t_seq, t_bat, f"tpch {template} sequential")
    assert sum(i.created for _, i in out) >= 2
    assert sum(i.reused for _, i in out) >= 1
    assert (t_bat.index.hits, t_bat.index.misses) == (r_eng.index.hits, r_eng.index.misses)
    assert dict(t_bat.catalog.stats) == dict(r_eng.catalog.stats)
    # One join layout and encode of the base table (and one per warmed
    # instance) either way; the batch reads them once per signature group.
    for counter in ("join_materialize", "encode_groups"):
        assert t_bat.catalog.stats[counter] == t_seq.catalog.stats[counter], counter
    assert t_bat.catalog.stats["join_hit"] < t_seq.catalog.stats["join_hit"]
    for e in t_bat.index.entries():
        assert e.maintainer is not None and e.maintainer.right is tdb["orders"]


def test_run_batch_mixed_hits_and_misses(tpch):
    rdb, tdb = tpch
    quantiles = (0.95, 0.85)
    r_agh, t_agh = (_batch(m, db, "tpch", "Q-AGH", quantiles) for m, db in ((R, rdb), (T, tdb)))
    r_aagh, t_aagh = (_batch(m, db, "tpch", "Q-AAGH", quantiles)
                      for m, db in ((R, rdb), (T, tdb)))
    r_eng, t_bat, t_seq = _engines(rdb, tdb)
    r_eng.run(r_agh[0])
    t_bat.run(t_agh[0])
    t_seq.run(t_agh[0])

    def mixed(agh, aagh):
        return [agh[0], agh[1], aagh[0], agh[0], aagh[1]]

    out = _replay(mixed(r_agh, r_aagh), mixed(t_agh, t_aagh), r_eng, t_bat, t_seq, "mixed")
    _assert_index_parity(r_eng, t_bat, "mixed")
    _assert_index_parity(t_seq, t_bat, "mixed sequential")
    assert any(i.reused for _, i in out) and any(i.created for _, i in out)


def test_run_batch_two_signature_groups_one_wave(tpch):
    """Different templates and aggregates in one wave share per-group
    products without cross-talk."""
    rdb, tdb = tpch

    def queries(mod, db):
        other = mod.Query("lineitem", ("l_suppkey",), mod.Aggregate("sum", "l_extendedprice"))
        other = dataclasses.replace(
            other, having=mod.Having(">", _threshold(mod, other, db, 0.9)))
        return (_batch(mod, db, "tpch", "Q-AGH", (0.9, 0.8))
                + _batch(mod, db, "tpch", "Q-AAGH", (0.9, 0.8)) + [other])

    r_eng, t_bat, t_seq = _engines(rdb, tdb)
    _replay(queries(R, rdb), queries(T, tdb), r_eng, t_bat, t_seq, "multi-group")
    _assert_index_parity(r_eng, t_bat, "multi-group")
    _assert_index_parity(t_seq, t_bat, "multi-group sequential")
    assert len({e.query.inner_signature() for e in t_bat.index.entries()}) >= 2


@pytest.mark.parametrize("strategy", ["NO-PS", "OPT", "CB-OPT-REL"])
def test_run_batch_other_strategies(tpch, strategy):
    rdb, tdb = tpch
    rq = _batch(R, rdb, "tpch", "Q-AGH", (0.95, 0.85))
    tq = _batch(T, tdb, "tpch", "Q-AGH", (0.95, 0.85))
    r_eng, t_bat, t_seq = _engines(rdb, tdb, strategy=strategy)
    _replay(rq + [rq[0]], tq + [tq[0]], r_eng, t_bat, t_seq, strategy)
    _assert_index_parity(r_eng, t_bat, strategy)
    _assert_index_parity(t_seq, t_bat, f"{strategy} sequential")


def test_run_batch_random_strategy_is_deferred(tpch):
    """A random strategy defers its pick to ``select_attribute`` per query
    (the query's content-derived key): the wave, its replay and the index
    equal the reference's and sequential ``run``'s."""
    rdb, tdb = tpch
    rq = _batch(R, rdb, "tpch", "Q-AGH", (0.95, 0.85))
    tq = _batch(T, tdb, "tpch", "Q-AGH", (0.95, 0.85))
    r_eng, t_bat, t_seq = _engines(rdb, tdb, strategy="RAND-GB")
    got = _replay(rq + [rq[0]], tq + [tq[0]], r_eng, t_bat, t_seq, "RAND-GB")
    assert any(info.created for _, info in got) and got[-1][1].reused
    _assert_index_parity(r_eng, t_bat, "RAND-GB")
    _assert_index_parity(t_seq, t_bat, "RAND-GB sequential")


def test_shared_miss_path_work(tpch):
    """A B-query miss batch pays one sample, one AQR pass, one group
    encoding and one inner-block scan per signature group, in the port as
    in the reference."""
    rdb, tdb = tpch
    quantiles = (0.97, 0.95, 0.92, 0.9)
    counters = []
    for mod, cls, db in ((R, RPBDSEngine, rdb), (T, TPBDSEngine, tdb)):
        eng = cls(db, **ENGINE_ARGS,
                  selection=mod.SelectionConfig(skip_single_candidate=False))
        out = eng.run_batch(_batch(mod, db, "tpch", "Q-AGH", quantiles))
        n_created = sum(1 for _, i in out if i.created)
        assert n_created >= 2
        assert eng.samples.misses == 1 and eng.aqr.misses == 1
        s = eng.catalog.stats
        assert s["encode_groups"] <= 1 + n_created
        assert s["instance_build"] == n_created
        counters.append((n_created, dict(s), eng.samples.misses, eng.aqr.misses))
    assert counters[0] == counters[1]


def test_batch_capture_is_one_launch_per_partition(tpch, monkeypatch):
    """The wave's admitted sketches of one partition come from one batched
    capture call, and sequential ``run`` never makes one."""
    from repro_torch.core import admission, sketch

    _, tdb = tpch
    calls = []
    real = sketch.capture_sketches_batch

    def counting(qs, *args, **kw):
        calls.append(len(qs))
        return real(qs, *args, **kw)

    monkeypatch.setattr(admission, "capture_sketches_batch", counting)
    tq = _batch(T, tdb, "tpch", "Q-AGH", (0.97, 0.95, 0.92, 0.9))
    out = TPBDSEngine(tdb, **ENGINE_ARGS).run_batch(tq)
    assert calls == [sum(i.created for _, i in out)] and calls[0] >= 2


def test_run_batch_interleaved_mutations(crimes):
    """batch -> append -> batch (repairs) -> delete -> batch, held against
    the reference and against sequential run at every step."""
    rdb, tdb = crimes

    def queries(mod, db):
        base = mod.Query("crimes", ("district", "year"), mod.Aggregate("sum", "records"))
        taus = np.quantile(mod.execute(base, db).values, np.linspace(0.95, 0.7, 6))
        return [dataclasses.replace(base, having=mod.Having(">", float(t))) for t in taus]

    rq, tq = queries(R, rdb), queries(T, tdb)
    r_eng, t_bat, t_seq = _engines(rdb, tdb)
    _replay(rq, tq, r_eng, t_bat, t_seq, "cold")

    fresh = rdata.make_crimes(2_500, seed=99)
    rows = {a: np.asarray(fresh[a]) for a in fresh.schema}
    for e in (r_eng, t_bat, t_seq):
        e.append_rows("crimes", rows)
    out = _replay(rq, tq, r_eng, t_bat, t_seq, "post-append")
    assert all(i.reused and i.repaired for _, i in out)

    mask = np.asarray(r_eng.db["crimes"]["year"]) < 2012
    for e in (r_eng, t_bat, t_seq):
        e.delete_rows("crimes", mask)
    _replay(rq, tq, r_eng, t_bat, t_seq, "post-delete")
    _assert_index_parity(r_eng, t_bat, "post-mutations")
    _assert_index_parity(t_seq, t_bat, "post-mutations sequential")
    assert dict(t_bat.catalog.stats) == dict(r_eng.catalog.stats)
    assert t_bat.catalog.stats["sketch_maintained"] > 0
    assert t_bat.catalog.stats["encode_groups_delta"] > 0


def test_workload_batch_stamps_match_reference():
    """Reserved stamps: a batch position keeps its stamp whichever wave
    records it, and ``reach`` counts only what a sequential replay saw."""
    tq = [T.Query("t", ("a",), T.Aggregate("count"), having=T.Having(">", float(v)))
          for v in (5, 3, 1)]
    rq = [R.Query("t", ("a",), R.Aggregate("count"), having=R.Having(">", float(v)))
          for v in (5, 3, 1)]
    logs = []
    for qs, log in ((rq, RWorkloadLog(8)), (tq, TWorkloadLog(8))):
        assert log.batch_stamp(0) is None
        log.record(qs[0])
        log.begin_batch(3)
        for pos in (2, 0):  # out of order, as a deferred wave records them
            log.record(qs[pos], stamp=log.batch_stamp(pos))
        logs.append((log.clock, [s for s, _ in log.entries()],
                     [log.reach(q, log.batch_stamp(1)) for q in qs]))
    assert logs[0] == logs[1]
    assert logs[1][:2] == (4, [1, 4, 2])


# ---------------------------------------------------------------------------
# The CUDA kernel (on the card only)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4_097, 1 << 20])
@pytest.mark.parametrize("b,n_ranges", [(1, 100), (8, 37), (33, 100), (64, 32768)])
def test_fragment_bitmap_batch_kernel_matches_plain(cuda, n, b, n_ranges):
    """Exact against the plain version: every mask chunk of 32, rows that
    are not a multiple of 4, and the widest shared-memory table."""
    gen = torch.Generator(device=cuda).manual_seed(n + b)
    bucket = torch.randint(-1, n_ranges + 1, (n,), generator=gen, device=cuda,
                           dtype=torch.int32)
    provs = torch.rand((b, n), generator=gen, device=cuda) < 0.05
    before = LAUNCH_COUNTS["fragment_bitmap_batch"]
    got = ops.fragment_bitmap_batch(provs, bucket, n_ranges)
    want = ref.fragment_bitmap_batch_ref(provs, bucket, n_ranges)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert LAUNCH_COUNTS["fragment_bitmap_batch"] == before + 1
    # Row by row against the single kernel, which also skips out-of-range rows.
    for i in (0, b - 1):
        assert torch.equal(got[i], ops.fragment_bitmap(provs[i], bucket, n_ranges))


@pytest.mark.cuda
def test_fragment_bitmap_batch_kernel_takes_unaligned_views(cuda):
    """A view that starts off a 16-byte boundary is copied, not misread."""
    bucket = torch.randint(0, 50, (1_001,), device=cuda, dtype=torch.int32)[1:]
    provs = (torch.rand((3, 1_001), device=cuda) < 0.2)[:, 1:]
    got = ops.fragment_bitmap_batch(provs, bucket, 50)
    assert torch.equal(got, ref.fragment_bitmap_batch_ref(provs, bucket, 50))
