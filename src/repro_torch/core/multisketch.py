"""Multi-attribute (composite) provenance sketches; port of
``repro/core/multisketch.py``.

A sketch may be built on a partition over several attributes (Sec. 4.2,
fn. 3 of the paper): the fragment id is the row-major cross product of the
per-attribute range buckets, the sketch a bitset over n_a x n_b x ...
fragments.  The CB-OPT-GB2 strategy estimates the group-by singles and
2-subsets of one query and picks the smallest.

The composite bucketization, fragment sizes and instances go through the
catalog like single-attribute ones (``CompositeRanges.key`` lives in the
catalog's key space).  Capture is the ``fragment_bitmap`` kernel on the
composite bucket; the instance is the ``sketch_filter_rows`` kernel's kept
rows (ascending, so the reference's ``table.select(keep)`` order) gathered
on the table's device.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.aqp.sampling import stratified_reservoir_sample
from repro_torch.aqp.size_estimation import approximate_query_result, estimate_size_batched
from repro_torch.core.catalog import Catalog, default_catalog
from repro_torch.core.queries import Query, QueryResult, execute, provenance_mask
from repro_torch.core.ranges import RangeSet, cross_product_id, equi_depth_ranges
from repro_torch.core.sketch import mask_instance
from repro_torch.core.table import ColumnTable, Database
from repro_torch.device import to_host


@dataclasses.dataclass(frozen=True)
class CompositeRanges:
    """Cross-product range partition over >= 1 attributes."""

    parts: Tuple[RangeSet, ...]

    @property
    def attrs(self) -> Tuple[str, ...]:
        return tuple(r.attr for r in self.parts)

    @property
    def n_ranges(self) -> int:
        n = 1
        for r in self.parts:
            n *= r.n_ranges
        return n

    def bucketize(self, table: ColumnTable) -> torch.Tensor:
        """Row-major composite fragment id (int32, on the table's device)."""
        return cross_product_id(self.parts, lambda r: r.bucketize(table[r.attr]))

    def key(self) -> Tuple:
        """Hashable identity, catalog-compatible with ``RangeSet.key``."""
        return ("composite",) + tuple(r.key() for r in self.parts)


@dataclasses.dataclass(frozen=True)
class CompositeSketch:
    table: str
    ranges: CompositeRanges
    bits: np.ndarray
    size_rows: int
    total_rows: int

    @property
    def selectivity(self) -> float:
        return self.size_rows / max(self.total_rows, 1)


def composite_ranges(
    table: ColumnTable, attrs: Sequence[str], n_ranges_total: int
) -> CompositeRanges:
    """Split the range budget evenly (geometric mean) across attributes."""
    k = len(attrs)
    per = max(2, int(round(n_ranges_total ** (1.0 / k))))
    return CompositeRanges(tuple(equi_depth_ranges(table, a, per) for a in attrs))


def capture_composite(
    q: Query, db: Database, ranges: CompositeRanges,
    prov: Optional[np.ndarray] = None,
    catalog: Optional[Catalog] = None,
) -> CompositeSketch:
    """Capture over a composite partition: the ``fragment_bitmap`` kernel on
    the catalog's cached composite bucket (what the reference's
    ``segment_max(prov, bucket) > 0`` computes)."""
    from repro_torch.kernels import ops as kops

    catalog = catalog or default_catalog()
    table = db[q.table]
    if prov is None:
        prov = provenance_mask(q, db, catalog=catalog)
    bucket = catalog.bucketize(table, ranges)
    prov_dev = torch.from_numpy(np.ascontiguousarray(prov)).to(table.device)
    bits = to_host(kops.fragment_bitmap(prov_dev, bucket, ranges.n_ranges)).astype(bool)
    sizes = catalog.fragment_sizes(table, ranges)
    return CompositeSketch(
        table=q.table, ranges=ranges, bits=bits,
        size_rows=int(sizes[bits].sum()), total_rows=table.num_rows,
    )


def apply_composite(
    sketch: CompositeSketch, db: Database, catalog: Optional[Catalog] = None
) -> Database:
    """D_P for a composite sketch, cached per sketch in the catalog: the
    keep-mask branch of a single-attribute instance, unpadded (a composite
    partition is never a table's fragment-major layout).  The instance
    records its base rows, so its group encodings derive from the base
    table's."""
    catalog = catalog or default_catalog()
    table = db[sketch.table]
    instance = catalog.get_instance(sketch, table)
    if instance is None:
        instance, rows = mask_instance(sketch, table, catalog)
        catalog.put_instance(sketch, table, instance, rows=rows)
    return db.with_table(instance)


def execute_with_composite(
    q: Query, db: Database, sk: CompositeSketch, catalog: Optional[Catalog] = None
) -> QueryResult:
    return execute(q, apply_composite(sk, db, catalog=catalog), catalog=catalog)


def select_composite_gb(
    key: torch.Tensor,
    q: Query,
    db: Database,
    n_ranges: int,
    theta: float = 0.05,
    max_pair_candidates: int = 3,
    catalog: Optional[Catalog] = None,
) -> Tuple[Tuple[str, ...], CompositeRanges, Dict[Tuple[str, ...], float]]:
    """CB-OPT-GB2: cost-based choice over group-by singles and pairs.

    One shared AQR pass, then every candidate (singles and the first
    ``max_pair_candidates`` sorted pairs) through one
    ``estimate_size_batched`` pass.  For group-by candidates the group key
    pins the (composite) fragment, so each size is exact given the
    satisfied-group set.  Returns ``(best attrs, its ranges, selectivity
    estimate per candidate)``.
    """
    catalog = catalog or default_catalog()
    fact = db[q.table]
    gb = [a for a in q.groupby if fact.has(a)]
    # One key per random pass: sampling and the AQR must not share one.
    k_s, k_e = prng.split(key)
    samples = stratified_reservoir_sample(k_s, fact, tuple(gb), theta)
    aqr = approximate_query_result(k_e, q, db, samples)

    cands: List[Tuple[str, ...]] = [(a,) for a in gb]
    cands += [tuple(sorted(p)) for p in itertools.combinations(gb, 2)][:max_pair_candidates]
    ranges_by = {attrs: composite_ranges(fact, attrs, n_ranges) for attrs in cands}

    total = max(fact.num_rows, 1)
    ests = estimate_size_batched(prng.fold_in(k_e, 1), q, db, ranges_by,
                                 samples, aqr=aqr, catalog=catalog)
    sizes: Dict[Tuple[str, ...], float] = {
        attrs: ests[attrs].est_rows / total for attrs in cands}
    # Equal estimates fall back to the lexically smallest candidate.
    best = min(sizes, key=lambda attrs: (sizes[attrs], attrs))
    return best, composite_ranges(fact, best, n_ranges), sizes
