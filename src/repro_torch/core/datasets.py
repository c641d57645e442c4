"""Synthetic schema-matched generators for the paper's four workloads (a numpy
copy of ``repro/core/datasets.py``: the same seeds give the same arrays).

The real dumps (Chicago Crime ~6.7M x 9, TPC-H SF, NYC Parking ~31M x 16,
SDSS Stars ~5.2M x 7) are not available offline; these generators match the
schemas, attribute counts, and the *correlation structure* the paper leans on
(geographic attributes in CRIME/PARKING correlate; TPC-H attrs are largely
independent — Sec. 11.2.2 attributes the accuracy gap to exactly this).
Row counts are parameters so tests stay fast while benchmarks can scale up.
Every generator puts its tables on ``device`` (CUDA unless ``"cpu"``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.table import ColumnTable, Database, from_numpy
from repro_torch.device import DeviceLike


def make_crimes(n: int = 100_000, seed: int = 0, device: DeviceLike = None) -> ColumnTable:
    """9 numeric attrs; district/zipcode/beat/ward/community are correlated,
    and crime *volume* correlates with district and year — the alignment that
    makes some partition attributes much better sketch choices than others
    (the whole point of the paper's cost model)."""
    rng = np.random.default_rng(seed)
    district = rng.integers(1, 26, n)
    # Geographic correlation: zipcode/beat/ward/community derive from district
    zipcode = 60600 + district * 4 + rng.integers(0, 4, n)
    beat = district * 100 + rng.integers(0, 30, n)
    ward = (district * 2 + rng.integers(0, 3, n)) % 50 + 1
    community = (district * 3 + rng.integers(0, 5, n)) % 77 + 1
    year = rng.integers(2010, 2025, n)
    month = rng.integers(1, 13, n)
    pid = rng.integers(1, 10, n)
    # Skewed count column (the HAVING target), correlated with geography and
    # time: a few "hot" districts, declining trend over years, summer peak.
    district_heat = np.where(district <= 5, 4.0, np.where(district <= 10, 1.5, 0.6))
    year_heat = 1.0 + 1.8 * (2024 - year) / 14.0  # older years hotter
    month_heat = 1.0 + 0.4 * np.sin((month - 1) / 12.0 * 2 * np.pi)
    records = np.maximum(1, rng.zipf(1.8, n))
    records = np.minimum(records, 500)
    records = np.maximum(1, (records * district_heat * year_heat * month_heat)).astype(np.int64)
    return from_numpy(
        "crimes",
        dict(
            pid=pid.astype(np.int32),
            month=month.astype(np.int32),
            year=year.astype(np.int32),
            records=records.astype(np.int32),
            district=district.astype(np.int32),
            zipcode=zipcode.astype(np.int32),
            beat=beat.astype(np.int32),
            ward=ward.astype(np.int32),
            community=community.astype(np.int32),
        ),
        primary_key=("beat", "year", "month"),
        device=device,
    )


def make_tpch(n_lineitem: int = 120_000, seed: int = 1, device: DeviceLike = None) -> Database:
    """lineitem / orders / part with TPC-H-like distributions (independent)."""
    rng = np.random.default_rng(seed)
    n_orders = max(1, n_lineitem // 4)
    n_part = max(1, n_lineitem // 6)

    orderkey = rng.integers(1, n_orders + 1, n_lineitem)
    partkey = rng.integers(1, n_part + 1, n_lineitem)
    suppkey = rng.integers(1, max(2, n_part // 10), n_lineitem)
    quantity = rng.integers(1, 51, n_lineitem)
    extendedprice = (quantity * rng.uniform(900, 105000 / 50, n_lineitem)).astype(np.float32)
    discount = rng.integers(0, 11, n_lineitem).astype(np.float32) / 100.0
    tax = rng.integers(0, 9, n_lineitem).astype(np.float32) / 100.0
    shipdate = rng.integers(8036, 10592, n_lineitem)  # days, 1992..1998
    commitdate = shipdate + rng.integers(-30, 61, n_lineitem)
    receiptdate = shipdate + rng.integers(1, 31, n_lineitem)
    lineitem = from_numpy(
        "lineitem",
        dict(
            l_orderkey=orderkey.astype(np.int64),
            l_partkey=partkey.astype(np.int64),
            l_suppkey=suppkey.astype(np.int64),
            l_quantity=quantity.astype(np.float32),
            l_extendedprice=extendedprice,
            l_discount=discount,
            l_tax=tax,
            l_shipdate=shipdate.astype(np.int32),
            l_commitdate=commitdate.astype(np.int32),
            l_receiptdate=receiptdate.astype(np.int32),
        ),
        primary_key=("l_orderkey",),
        device=device,
    )
    orders = from_numpy(
        "orders",
        dict(
            o_orderkey=np.arange(1, n_orders + 1, dtype=np.int64),
            o_custkey=rng.integers(1, max(2, n_orders // 10), n_orders).astype(np.int64),
            o_totalprice=rng.uniform(850, 560000, n_orders).astype(np.float32),
            o_orderdate=rng.integers(8036, 10592, n_orders).astype(np.int32),
            o_shippriority=rng.integers(0, 5, n_orders).astype(np.int32),
        ),
        primary_key=("o_orderkey",),
        device=device,
    )
    part = from_numpy(
        "part",
        dict(
            p_partkey=np.arange(1, n_part + 1, dtype=np.int64),
            p_size=rng.integers(1, 51, n_part).astype(np.int32),
            p_retailprice=rng.uniform(900, 2000, n_part).astype(np.float32),
            p_brand=rng.integers(1, 26, n_part).astype(np.int32),
        ),
        primary_key=("p_partkey",),
        device=device,
    )
    return Database({"lineitem": lineitem, "orders": orders, "part": part})


def make_parking(n: int = 100_000, seed: int = 2, device: DeviceLike = None) -> ColumnTable:
    """16 numeric attrs, NYC-parking-like with correlated geography."""
    rng = np.random.default_rng(seed)
    borough = rng.integers(1, 6, n)
    precinct = borough * 20 + rng.integers(0, 20, n)
    street = precinct * 50 + rng.integers(0, 50, n)
    county = borough
    issuer = rng.integers(1, 1000, n)
    agency = issuer % 12 + 1
    year = rng.integers(2014, 2024, n)
    month = rng.integers(1, 13, n)
    hour = rng.integers(0, 24, n)
    vehicle_year = rng.integers(1990, 2024, n)
    violation = np.maximum(1, rng.zipf(1.6, n)) % 99 + 1
    fine = (violation * 5 + rng.integers(10, 200, n)).astype(np.float32)
    plate_type = rng.integers(1, 90, n)
    body_type = rng.integers(1, 40, n)
    color = rng.integers(1, 20, n)
    reg_state = rng.integers(1, 68, n)
    cols = dict(
        borough=borough, precinct=precinct, street=street, county=county,
        issuer=issuer, agency=agency, year=year, month=month, hour=hour,
        vehicle_year=vehicle_year, violation=violation, fine=fine,
        plate_type=plate_type, body_type=body_type, color=color,
        reg_state=reg_state,
    )
    cols = {k: (v.astype(np.float32) if v.dtype.kind == "f" else v.astype(np.int32)) for k, v in cols.items()}
    return from_numpy("parking", cols, primary_key=("street", "issuer"), device=device)


def make_stars(n: int = 100_000, seed: int = 3, device: DeviceLike = None) -> ColumnTable:
    """7 numeric attrs, SDSS-like (ra/dec sky coords + magnitudes/redshift)."""
    rng = np.random.default_rng(seed)
    ra = rng.uniform(0, 360, n).astype(np.float32)
    dec = rng.uniform(-90, 90, n).astype(np.float32)
    field = (ra / 10).astype(np.int32) * 18 + ((dec + 90) / 10).astype(np.int32)
    mag_g = rng.normal(18, 2, n).astype(np.float32)
    mag_r = (mag_g - rng.normal(0.5, 0.3, n)).astype(np.float32)  # correlated
    redshift = np.abs(rng.normal(0.1, 0.08, n)).astype(np.float32)
    run = rng.integers(100, 900, n).astype(np.int32)
    return from_numpy(
        "stars",
        dict(ra=ra, dec=dec, field=field, mag_g=mag_g, mag_r=mag_r,
             redshift=redshift, run=run),
        primary_key=("run", "field"),
        device=device,
    )


def paper_example_db(device: DeviceLike = None) -> Database:
    """The Fig. 1 running-example instance, verbatim (8 rows)."""
    crimes = from_numpy(
        "crimes",
        dict(
            pid=np.array([3, 4, 4, 8, 8, 2, 7, 7], np.int32),
            month=np.array([1, 1, 1, 6, 6, 7, 2, 9], np.int32),
            year=np.array([2010, 2013, 2013, 2015, 2015, 2016, 2022, 2023], np.int32),
            records=np.array([88, 73, 101, 86, 96, 157, 83, 58], np.int32),
        ),
        device=device,
    )
    return Database({"crimes": crimes})
