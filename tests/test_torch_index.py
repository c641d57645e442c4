"""The port's sketch index and subsumption rule against the reference's, on
the CPU: twins of ``tests/test_index.py`` (the mixed ``>``/``>=`` rule at
equal thresholds, lookup tie-breaks, prune recency) and of
``tests/test_subsumption.py``'s randomized containment suite, its nested and
join halves included.

Every case runs the same seeded queries through ``repro.core.subsumes`` /
``SketchIndex.lookup_entry`` and the port's, and holds the answers equal;
the containment suite also holds, for every subsuming pair, that the
fragments of q2's provenance lie inside q1's captured sketch (captured by
the port, whose bits equal the reference's on this integral data).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import datasets as rdata
from repro.core.sketch import ProvenanceSketch as RSketch
import repro_torch.core as T
from repro_torch.convert import database_from_numpy

torch.set_num_threads(1)  # small tensors; leave the cores to the other xdist workers

OPS = (">", ">=", "<", "<=", "=")


def _q(mod, gb=("a",), tau=10.0, op=">", where=None, join=None, outer=None):
    q = mod.Query("t", gb, mod.Aggregate("sum", "v"), having=mod.Having(op, tau),
                  where=mod.Predicate(*where) if where else None,
                  join=mod.JoinSpec(*join) if join else None)
    if outer is not None:
        op2, tau2 = outer
        q = dataclasses.replace(q, outer_groupby=("a",), outer_agg=mod.Aggregate("sum", None),
                                outer_having=mod.Having(op2, tau2))
    return q


def _sk(mod, size_rows=10):
    cls = RSketch if mod is R else T.ProvenanceSketch
    return cls("t", mod.RangeSet("a", np.array([1.0, 2.0])), bits=np.array([True, False, True]),
               size_rows=size_rows, total_rows=100)


def _subsumes_both(a, b):
    r, t = R.subsumes(_q(R, **a), _q(R, **b)), T.subsumes(_q(T, **a), _q(T, **b))
    assert r == t, (a, b)
    return t


# ---------------------------------------------------------------------------
# tests/test_index.py twins
# ---------------------------------------------------------------------------


def test_subsumes_threshold_domination():
    assert _subsumes_both(dict(tau=10.0), dict(tau=10.0))
    assert _subsumes_both(dict(tau=10.0), dict(tau=25.0))
    assert not _subsumes_both(dict(tau=10.0), dict(tau=5.0))
    assert _subsumes_both(dict(tau=10.0, op=">="), dict(tau=10.0))


def test_subsumes_mixed_ops_at_equal_threshold():
    """A ``>``-captured sketch must not serve ``>=`` at the same threshold
    (groups at agg == tau are in q2's provenance, not in the sketch), on the
    inner and the outer HAVING alike."""
    assert not _subsumes_both(dict(tau=10.0, op=">"), dict(tau=10.0, op=">="))
    assert _subsumes_both(dict(tau=10.0, op=">="), dict(tau=10.0, op=">"))
    assert _subsumes_both(dict(tau=10.0, op=">="), dict(tau=10.0, op=">="))
    assert _subsumes_both(dict(tau=10.0, op=">"), dict(tau=10.0, op=">"))
    assert _subsumes_both(dict(tau=10.0, op=">"), dict(tau=10.0 + 1e-6, op=">="))
    assert not _subsumes_both(dict(tau=0.0, outer=(">", 7.0)), dict(tau=0.0, outer=(">=", 7.0)))
    assert _subsumes_both(dict(tau=0.0, outer=(">=", 7.0)), dict(tau=0.0, outer=(">", 7.0)))


def test_equal_threshold_mixed_op_lookup_misses_index():
    for mod in (R, T):
        idx = mod.SketchIndex()
        idx.insert(_q(mod, tau=10.0, op=">"), _sk(mod))
        assert idx.lookup(_q(mod, tau=10.0, op=">=")) is None
        assert idx.misses == 1
        assert idx.lookup(_q(mod, tau=10.0, op=">")) is not None


def test_subsumes_requires_matching_structure():
    """Group-by, WHERE and join must match; non-monotone ops subsume only on
    equality."""
    join = ("d", "a", "k")
    assert not _subsumes_both(dict(), dict(gb=("b",)))
    assert not _subsumes_both(dict(), dict(where=("b", ">", 0.0)))
    assert not _subsumes_both(dict(where=("b", ">", 0.0)), dict(where=("b", ">", 1.0)))
    assert _subsumes_both(dict(op="<", tau=3.0), dict(op="<", tau=3.0))
    assert not _subsumes_both(dict(op="<", tau=3.0), dict(op="<", tau=4.0))
    assert not _subsumes_both(dict(), dict(join=join))
    assert not _subsumes_both(dict(join=join), dict())
    assert not _subsumes_both(dict(join=join), dict(join=("d", "a", "k2")))
    assert _subsumes_both(dict(join=join, tau=10.0), dict(join=join, tau=20.0))
    assert not _subsumes_both(dict(join=join, tau=20.0), dict(join=join, tau=10.0))


def test_lookup_prefers_smallest_subsuming_sketch():
    for mod in (R, T):
        idx = mod.SketchIndex()
        idx.insert(_q(mod, tau=10.0), _sk(mod, size_rows=50))
        idx.insert(_q(mod, tau=12.0), _sk(mod, size_rows=20))
        e = idx.lookup_entry(_q(mod, tau=30.0))
        assert e is not None and e.sketch.size_rows == 20
        assert (idx.hits, idx.misses) == (1, 0)


def test_prune_keeps_most_recently_hit_entries():
    kept = []
    for mod in (R, T):
        idx = mod.SketchIndex()
        queries = [_q(mod, gb=gb, tau=5.0) for gb in (("a",), ("b",), ("c",), ("d",))]
        for q in queries:
            idx.insert(q, _sk(mod))
        assert idx.lookup(queries[2]) is not None
        assert idx.lookup(queries[0]) is not None
        assert idx.prune(2) == 2 and len(idx) == 2
        kept.append({e.query.groupby for e in idx.entries()})
        assert idx.lookup(queries[1]) is None and idx.lookup(queries[3]) is None
        assert idx.prune(5) == 0
    assert kept[0] == kept[1] == {("a",), ("c",)}


def test_lookup_tie_break_is_insertion_order_independent():
    """Equal-size sketches serve from the same entry whatever the insertion
    order: the tighter threshold wins, in both packages."""
    for mod in (R, T):
        qa, qb, probe = _q(mod, tau=10.0), _q(mod, tau=12.0), _q(mod, tau=30.0)
        idx1, idx2 = mod.SketchIndex(), mod.SketchIndex()
        idx1.insert(qa, _sk(mod, size_rows=20))
        idx1.insert(qb, _sk(mod, size_rows=20))
        idx2.insert(qb, _sk(mod, size_rows=20))
        idx2.insert(qa, _sk(mod, size_rows=20))
        e1, e2 = idx1.lookup_entry(probe), idx2.lookup_entry(probe)
        assert e1.query.having.value == e2.query.having.value == 12.0
        assert e1.uses == e2.uses == 1


def test_lookup_tie_break_prefers_tighter_outer_threshold():
    for mod in (R, T):
        probe = _q(mod, tau=30.0, outer=(">", 9.0))
        for order in ((5.0, 8.0), (8.0, 5.0)):
            idx = mod.SketchIndex()
            for t2 in order:
                idx.insert(_q(mod, tau=10.0, outer=(">", t2)), _sk(mod, size_rows=20))
            assert idx.lookup_entry(probe).query.outer_having.value == 8.0, (mod, order)


@pytest.mark.parametrize("seed", range(4))
def test_randomized_subsumes_equals_reference(seed):
    """Random query pairs over every op, WHERE and join variant, nested or
    not: the port's ``subsumes`` answers as the reference's."""
    rng = np.random.default_rng(seed)
    joins = [None, ("d", "a", "k"), ("d", "a", "k2")]
    wheres = [None, ("b", ">", 0.0), ("b", ">", 1.0)]

    def draw():
        kw = dict(tau=float(rng.choice([1.0, 2.0, 2.5, 3.0])), op=str(rng.choice(OPS)),
                  join=joins[int(rng.integers(0, 3))], where=wheres[int(rng.integers(0, 3))])
        if rng.random() < 0.4:
            kw["outer"] = (str(rng.choice([">", ">="])), float(rng.choice([1.0, 2.0, 3.0])))
        return kw

    n_true = 0
    for _ in range(400):
        q1 = draw()
        # q2: q1 with each field redrawn at random (structure often shared).
        other = draw()
        q2 = {k: (other.get(k) if rng.random() < 0.3 else q1.get(k))
              for k in set(q1) | set(other)}
        q2 = {k: v for k, v in q2.items() if v is not None}
        n_true += _subsumes_both(q1, q2)
    assert n_true > 20


# ---------------------------------------------------------------------------
# tests/test_subsumption.py twins: subsumes => provenance containment
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def crimes():
    rdb = R.Database({"crimes": rdata.make_crimes(8_000, seed=41)})
    return rdb, _port_db(rdb)


@pytest.fixture(scope="module")
def tpch():
    rdb = rdata.make_tpch(8_000, seed=43)
    return rdb, _port_db(rdb)


def _port_db(rdb):
    return database_from_numpy(
        [(n, {a: np.asarray(rdb[n][a]) for a in rdb[n].schema}, rdb[n].primary_key)
         for n in rdb.names], device="cpu")


def _prov_frag_bits(q, db, ranges):
    """The oracle: which fragments hold >= 1 provenance row of ``q``."""
    prov = T.provenance_mask(q, db)
    bucket = ranges.bucketize(db[q.table][ranges.attr]).numpy()
    bits = np.zeros(ranges.n_ranges, dtype=bool)
    bits[bucket[prov]] = True
    return bits


class _Pairs:
    """Checks ``subsumes(q1, q2) => frag(P(q2)) within bits(q1)`` on the
    port, with the reference's ``subsumes`` answering alike and, for the
    first pairs of each suite, the reference's captured bits equal."""

    def __init__(self, rdb, tdb, table, attr, n_ranges=20, n_bit_checks=6):
        self.rdb, self.tdb = rdb, tdb
        self.rr = R.equi_depth_ranges(rdb[table], attr, n_ranges)
        self.tr = T.equi_depth_ranges(tdb[table], attr, n_ranges)
        self.bit_checks = n_bit_checks
        self.captures = {}

    def check(self, rq1, rq2, tq1, tq2):
        sub = T.subsumes(tq1, tq2)
        assert sub == R.subsumes(rq1, rq2)
        if not sub:
            return False
        key = tq1.signature()
        if key not in self.captures:
            self.captures[key] = T.capture_sketch(tq1, self.tdb, self.tr, catalog=T.Catalog())
            if self.bit_checks:
                self.bit_checks -= 1
                rsk = R.capture_sketch(rq1, self.rdb, self.rr, catalog=R.Catalog())
                np.testing.assert_array_equal(self.captures[key].bits, rsk.bits)
        missing = _prov_frag_bits(tq2, self.tdb, self.tr) & ~self.captures[key].bits
        assert not missing.any(), (
            f"unsafe reuse: {tq1.having}/{tq1.outer_having} claimed to subsume "
            f"{tq2.having}/{tq2.outer_having}; fragments {np.nonzero(missing)[0]} "
            f"hold q2 provenance outside the sketch")
        return True


def _tau(rng, vals):
    """A threshold at an actual aggregate value (boundary equality is the
    adversarial case) or one off it."""
    v = float(rng.choice(vals))
    return v + (float(rng.choice([-1.0, 1.0])) if rng.random() < 0.4 else 0.0)


def test_randomized_agh_pairs_containment(crimes):
    rdb, tdb = crimes
    rng = np.random.default_rng(7)
    rbase = R.Query("crimes", ("district", "year"), R.Aggregate("sum", "records"))
    tbase = T.Query("crimes", ("district", "year"), T.Aggregate("sum", "records"))
    agg_vals = np.unique(T.execute(tbase, tdb).values)
    pairs = _Pairs(rdb, tdb, "crimes", "district")
    n_subsumed = 0
    for _ in range(120):
        taus = [_tau(rng, agg_vals) for _ in range(2)]
        pool = list(OPS) if rng.random() < 0.3 else [">", ">="]
        ops = [str(o) for o in rng.choice(pool, size=2)]
        rq = [dataclasses.replace(rbase, having=R.Having(o, t)) for o, t in zip(ops, taus)]
        tq = [dataclasses.replace(tbase, having=T.Having(o, t)) for o, t in zip(ops, taus)]
        n_subsumed += pairs.check(*rq, *tq)
    assert n_subsumed > 15


def test_randomized_nested_pairs_mixed_inner_outer(crimes):
    rdb, tdb = crimes
    rng = np.random.default_rng(19)

    def base(mod):
        return mod.Query("crimes", ("district", "year"), mod.Aggregate("sum", "records"),
                         outer_groupby=("district",), outer_agg=mod.Aggregate("sum", None))

    tb = base(T)
    inner_vals = np.unique(T.execute(dataclasses.replace(
        tb, outer_groupby=None, outer_agg=None), tdb).values)
    outer_vals = np.unique(T.execute(tb, tdb).values)
    pairs = _Pairs(rdb, tdb, "crimes", "district")
    n_subsumed = 0
    for _ in range(60):
        ops = [str(o) for o in rng.choice([">", ">="], size=4)]
        taus = [_tau(rng, inner_vals), _tau(rng, inner_vals),
                _tau(rng, outer_vals), _tau(rng, outer_vals)]
        qs = {mod: [dataclasses.replace(base(mod), having=mod.Having(ops[i], taus[i]),
                                        outer_having=mod.Having(ops[2 + i], taus[2 + i]))
                    for i in range(2)] for mod in (R, T)}
        n_subsumed += pairs.check(*qs[R], *qs[T])
    assert n_subsumed > 5


@pytest.mark.parametrize("template", ["Q-AJGH", "Q-AAJGH"])
def test_randomized_join_pairs_containment(tpch, template):
    """The join half: thresholds at the joined group aggregates, sketches on
    lineitem's ``l_suppkey``, provenance scattered back to lineitem rows."""
    rdb, tdb = tpch
    rng = np.random.default_rng(23 if template == "Q-AJGH" else 29)

    def base(mod):
        join = mod.JoinSpec("orders", "l_orderkey", "o_orderkey")
        if template == "Q-AJGH":
            return mod.Query("lineitem", ("l_suppkey",), mod.Aggregate("sum", "l_quantity"),
                             join=join)
        return mod.Query("lineitem", ("l_suppkey", "o_shippriority"),
                         mod.Aggregate("sum", "l_quantity"), join=join,
                         outer_groupby=("l_suppkey",), outer_agg=mod.Aggregate("sum", None))

    tb = base(T)
    inner_vals = np.unique(T.execute(dataclasses.replace(
        tb, outer_groupby=None, outer_agg=None), tdb).values)
    outer_vals = np.unique(T.execute(tb, tdb).values)
    pairs = _Pairs(rdb, tdb, "lineitem", "l_suppkey")
    n_subsumed = 0
    for _ in range(60):
        ops = [str(o) for o in rng.choice([">", ">="], size=4)]
        taus = [_tau(rng, inner_vals), _tau(rng, inner_vals),
                _tau(rng, outer_vals), _tau(rng, outer_vals)]
        qs = {}
        for mod in (R, T):
            q = [dataclasses.replace(base(mod), having=mod.Having(ops[i], taus[i]))
                 for i in range(2)]
            if template == "Q-AAJGH":
                q = [dataclasses.replace(x, outer_having=mod.Having(ops[2 + i], taus[2 + i]))
                     for i, x in enumerate(q)]
            qs[mod] = q
        n_subsumed += pairs.check(*qs[R], *qs[T])
    assert n_subsumed > 5


def test_subsumption_implies_safe_result_end_to_end_over_a_join(tpch):
    """Serving q2 from q1's sketch instance (joined afresh) returns q2's
    exact result whenever ``subsumes`` says yes, as the reference's does."""
    rdb, tdb = tpch
    join = ("orders", "l_orderkey", "o_orderkey")
    rbase = R.Query("lineitem", ("l_suppkey",), R.Aggregate("count", None),
                    join=R.JoinSpec(*join))
    tbase = T.Query("lineitem", ("l_suppkey",), T.Aggregate("count", None),
                    join=T.JoinSpec(*join))
    agg_vals = T.execute(tbase, tdb).values
    tau = float(np.quantile(agg_vals, 0.8))
    tr = T.equi_depth_ranges(tdb["lineitem"], "l_suppkey", 20)
    rr = R.equi_depth_ranges(rdb["lineitem"], "l_suppkey", 20)
    tq1 = dataclasses.replace(tbase, having=T.Having(">", tau))
    rq1 = dataclasses.replace(rbase, having=R.Having(">", tau))
    tsk = T.capture_sketch(tq1, tdb, tr)
    rsk = R.capture_sketch(rq1, rdb, rr)
    np.testing.assert_array_equal(tsk.bits, rsk.bits)
    rng = np.random.default_rng(3)
    n_served = 0
    for _ in range(20):
        op = str(rng.choice([">", ">="]))
        tau2 = float(rng.choice([tau, tau + 1.0, tau * 1.2, float(rng.choice(agg_vals))]))
        tq2 = dataclasses.replace(tbase, having=T.Having(op, tau2))
        rq2 = dataclasses.replace(rbase, having=R.Having(op, tau2))
        assert T.subsumes(tq1, tq2) == R.subsumes(rq1, rq2)
        if not T.subsumes(tq1, tq2):
            continue
        got = T.execute(tq2, T.apply_sketch(tsk, tdb)).canonical()
        assert got == T.execute(tq2, tdb).canonical() == R.execute(
            rq2, R.apply_sketch(rsk, rdb)).canonical(), (op, tau2)
        n_served += 1
    assert n_served > 3
