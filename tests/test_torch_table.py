"""Tables, ranges and datasets of the port against the reference: the same
casts, the same float32 bucketization, the same group encodings and
equi-depth bounds, and dataset generators yielding identical arrays."""
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import datasets as rdata
import repro_torch.core as T
from repro_torch.convert import database_from_numpy
from repro_torch.core import datasets as tdata

torch.set_num_threads(1)  # small tensors; leave the cores to the other xdist workers

ROOT = Path(__file__).resolve().parents[1]


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("dtype", [np.int64, np.float64, np.int32, np.float32, np.bool_,
                                   np.int16, np.uint8])
def test_from_numpy_casts_like_jnp_asarray(dtype):
    data = np.arange(6).astype(dtype)
    want = np.asarray(R.from_numpy("t", {"a": data})["a"])
    got = T.from_numpy("t", {"a": data}, device="cpu")["a"].numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_f32_bucketize_at_the_boundary():
    """Twin of tests/test_catalog.py's f32 tail-bucketing test: 10.0 equals
    the bound 10.0000001 once both are float32, so side='right' puts it in
    fragment 1 (a float64 search would say 0)."""
    values = np.array([1.0, 5.0, 9.0, 10.0, 12.0])
    bounds = np.array([10.0000001])
    want = np.asarray(R.RangeSet("a", bounds).bucketize(jnp.asarray(values)))
    got = T.RangeSet("a", bounds).bucketize(torch.from_numpy(values)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[3] == 1 and got.dtype == np.int32
    from repro_torch.core.table import _bucketize_np
    np.testing.assert_array_equal(_bucketize_np(bounds, values), got)


@pytest.mark.parametrize("make,attr,n_ranges", [
    ("make_crimes", "district", 100), ("make_crimes", "records", 100),
    ("make_crimes", "beat", 37), ("make_stars", "mag_g", 100), ("make_stars", "run", 10),
])
def test_equi_depth_ranges_and_bucketize(make, attr, n_ranges):
    rt = getattr(rdata, make)(5_000)
    tt = getattr(tdata, make)(5_000, device="cpu")
    rr = R.equi_depth_ranges(rt, attr, n_ranges)
    tr = T.equi_depth_ranges(tt, attr, n_ranges)
    np.testing.assert_array_equal(tr.bounds, rr.bounds)
    assert tr.key() == rr.key()
    np.testing.assert_array_equal(_np(tr.bucketize(tt[attr])), _np(rr.bucketize(rt[attr])))
    np.testing.assert_array_equal(_np(T.fragment_sizes(tt, tr)), _np(R.fragment_sizes(rt, rr)))
    rw, tw = R.equi_width_ranges(rt, attr, n_ranges), T.equi_width_ranges(tt, attr, n_ranges)
    np.testing.assert_array_equal(tw.bounds, rw.bounds)


@pytest.mark.parametrize("attrs", [(), ("district",), ("month", "year"),
                                   ("community", "pid", "ward")])
def test_encode_groups(attrs):
    rt, tt = rdata.make_crimes(4_000, seed=2), tdata.make_crimes(4_000, seed=2, device="cpu")
    rg, rn, rv = R.encode_groups(rt, attrs)
    tg, tn, tv = T.encode_groups(tt, attrs)
    assert tn == rn
    np.testing.assert_array_equal(tg, rg)
    assert tg.dtype == np.int32 and set(tv) == set(rv)
    for a in rv:
        np.testing.assert_array_equal(tv[a], rv[a])


@pytest.mark.parametrize("case", [
    "int32 two columns", "int32 negative", "int64 wide", "int16 three columns",
    "uint8", "float32", "int64 beyond one key", "one row", "no rows"])
def test_unique_rows_equals_numpy_unique_axis0(case):
    """The packed-key path orders and numbers rows as ``np.unique(axis=0)``
    does (dtype kept); rows it cannot pack take ``np.unique(axis=0)``."""
    from repro_torch.core.table import unique_rows

    rng = np.random.default_rng(len(case))
    n = 5_000
    stacked = {
        "int32 two columns": lambda: np.stack([rng.integers(8036, 10592, n),
                                               rng.integers(1, 1000, n)], 1).astype(np.int32),
        "int32 negative": lambda: rng.integers(-50, 50, (n, 2)).astype(np.int32),
        "int64 wide": lambda: np.stack([rng.integers(-2**40, 2**40, n),
                                        rng.integers(0, 3, n)], 1).astype(np.int64),
        "int16 three columns": lambda: rng.integers(-3, 4, (n, 3)).astype(np.int16),
        "uint8": lambda: rng.integers(0, 256, (n, 2)).astype(np.uint8),
        "float32": lambda: rng.integers(0, 9, (n, 2)).astype(np.float32) / 4,
        "int64 beyond one key": lambda: np.stack([rng.integers(-2**62, 2**62, n),
                                                  rng.integers(0, 2**20, n)], 1),
        "one row": lambda: np.array([[3, -1]], dtype=np.int32),
        "no rows": lambda: np.empty((0, 2), dtype=np.int32),
    }[case]()
    want_u, want_inv = np.unique(stacked, axis=0, return_inverse=True)
    got_u, got_inv = unique_rows(stacked)
    assert got_u.dtype == want_u.dtype and got_inv.ndim == 1
    np.testing.assert_array_equal(got_u, want_u)
    np.testing.assert_array_equal(got_inv, want_inv.reshape(-1))


def _tables(db_or_table):
    if isinstance(db_or_table, (R.Database, T.Database)):
        return db_or_table.tables
    return {db_or_table.name: db_or_table}


@pytest.mark.parametrize("make,kwargs", [
    ("make_crimes", dict(n=3_000, seed=5)), ("make_tpch", dict(n_lineitem=4_000, seed=1)),
    ("make_parking", dict(n=3_000, seed=2)), ("make_stars", dict(n=3_000, seed=3)),
    ("paper_example_db", {}),
])
def test_datasets_yield_identical_arrays(make, kwargs):
    ref = _tables(getattr(rdata, make)(**kwargs))
    got = _tables(getattr(tdata, make)(**kwargs, device="cpu"))
    assert set(got) == set(ref)
    for name, rt in ref.items():
        tt = got[name]
        assert tt.schema == rt.schema and tt.primary_key == rt.primary_key
        for a in rt.schema:
            want, have = np.asarray(rt[a]), tt[a].numpy()
            assert have.dtype == want.dtype, (name, a)
            np.testing.assert_array_equal(have, want)


def test_database_from_numpy_round_trips_reference_tables():
    rdb = rdata.make_tpch(2_000)
    tdb = database_from_numpy(
        [(t.name, t.to_numpy(), t.primary_key) for t in rdb.tables.values()], device="cpu")
    assert tdb.names == rdb.names and tdb.device == torch.device("cpu")
    for name in rdb.names:
        for a in rdb[name].schema:
            np.testing.assert_array_equal(tdb[name][a].numpy(), np.asarray(rdb[name][a]))


def test_table_ops_keep_lineage_rules():
    t = tdata.make_crimes(100, device="cpu")
    g = t.gather(np.array([3, 1, 4]))
    assert g.num_rows == 3 and g.uid != t.uid
    np.testing.assert_array_equal(g["district"].numpy(), t["district"].numpy()[[3, 1, 4]])
    w = t.with_column("x", t["pid"])
    assert w.has("x") and w.uid != t.uid and w.schema == tuple(sorted(t.schema + ("x",)))


def test_entry_points_raise_without_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    data = {"a": np.arange(4)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.from_numpy("t", data)
    with pytest.raises(RuntimeError):
        tdata.make_crimes(100)
    with pytest.raises(RuntimeError):
        database_from_numpy([("t", data, ())])
    assert T.from_numpy("t", data, device="cpu").device == torch.device("cpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    scanned = {p.relative_to(ROOT / "src" / "repro_torch").parts[0] for p in files[:-1]}
    # Every subpackage of the port is scanned, the LM stack's included.
    assert {"core", "aqp", "kernels", "runtime", "models", "data", "launch",
            "configs"} <= scanned, scanned
    for sub in ("models", "data", "launch", "configs"):
        assert (ROOT / "src" / "repro_torch" / sub / "__init__.py") in files, sub
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path.relative_to(ROOT)} imports {mod}"
