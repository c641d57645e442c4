"""Provenance sketches (Sec. 4): capture, instances, application,
selectivity (port of ``repro/core/sketch.py``).

A sketch for query Q on range partition ``F_{R,a}`` is the bitvector over
ranges whose fragments contain >= 1 provenance row.  Capture is a segmented
OR of the provenance mask by fragment id (the ``fragment_bitmap`` kernel);
the instance of a sketch is the rows whose fragment bit is set, pow2-padded
and cached per sketch in the catalog: on a table clustered on the sketch's
own partition the concatenated fragment slices (``take_fragments``), else
the ``sketch_filter`` kernel's kept rows (mask and compaction in one
launch, on the device).  Batched admission
captures B sketches of one partition from one scan
(``capture_sketches_batch``, the ``fragment_bitmap_batch`` kernel).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.catalog import Catalog, default_catalog
from repro_torch.core.queries import Query, QueryResult, execute, provenance_mask
from repro_torch.core.ranges import RangeSet
from repro_torch.core.table import PAD_VALID, ColumnTable, Database
from repro_torch.device import to_host


@dataclasses.dataclass(frozen=True)
class ProvenanceSketch:
    """An accurate sketch: table + attribute + ranges + membership bits.

    ``table_uid`` / ``table_version`` record which version of the relation
    the bits describe.
    """

    table: str
    ranges: RangeSet
    bits: np.ndarray  # bool, shape (n_ranges,)
    size_rows: int  # |R_P| — rows covered by the sketch instance
    total_rows: int  # |R|
    table_uid: int = 0
    table_version: int = 0

    def current_for(self, table: ColumnTable) -> bool:
        return self.table_uid == table.uid and self.table_version == table.version

    @property
    def attr(self) -> str:
        return self.ranges.attr

    @property
    def selectivity(self) -> float:
        return self.size_rows / max(self.total_rows, 1)

    @property
    def n_fragments(self) -> int:
        return int(self.bits.sum())

    def range_conditions(self) -> Tuple[Tuple[float, float], ...]:
        """The disjunction of [lo, hi) conditions a DBMS would be handed."""
        bounds = np.concatenate([[-np.inf], self.ranges.bounds, [np.inf]])
        return tuple((float(bounds[i]), float(bounds[i + 1]))
                     for i in np.nonzero(self.bits)[0])


def capture_sketch(
    q: Query,
    db: Database,
    ranges: RangeSet,
    prov: Optional[np.ndarray] = None,
    catalog: Optional[Catalog] = None,
) -> ProvenanceSketch:
    """Build the accurate sketch R(Q, D, F) for ``q`` on partition ``ranges``."""
    from repro_torch.kernels import ops as kops

    catalog = catalog or default_catalog()
    table = db[q.table]
    if prov is None:
        prov = provenance_mask(q, db, catalog=catalog)
    bucket = catalog.bucketize(table, ranges)
    prov_dev = torch.from_numpy(np.ascontiguousarray(prov)).to(table.device)
    # The sketch bits come to the host once, at capture (a reference merge point).
    bits = to_host(kops.fragment_bitmap(prov_dev, bucket, ranges.n_ranges))
    sizes = catalog.fragment_sizes(table, ranges)
    return ProvenanceSketch(
        table=q.table,
        ranges=ranges,
        bits=bits.astype(bool),
        size_rows=int(sizes[bits].sum()),
        total_rows=table.num_rows,
        table_uid=table.uid,
        table_version=table.version,
    )


def capture_sketches_batch(
    qs: Sequence[Query],
    db: Database,
    ranges_list: Sequence[RangeSet],
    provs: Sequence[np.ndarray],
    catalog: Optional[Catalog] = None,
) -> List[ProvenanceSketch]:
    """Multi-sketch fused capture: B provenance masks, one scan per partition.

    Queries are grouped by (table, partition); each group pays one cached
    bucketization, one host-to-device copy of its stacked masks and one
    ``fragment_bitmap_batch`` launch.  The mask batch is pow2-padded (empty
    masks), as in the reference.  Bits are equal to per-query capture.
    """
    from repro_torch.kernels import ops as kops

    catalog = catalog or default_catalog()
    out: List[Optional[ProvenanceSketch]] = [None] * len(qs)
    groups: Dict[Tuple, List[int]] = {}
    for i, (q, ranges) in enumerate(zip(qs, ranges_list)):
        groups.setdefault((q.table, ranges.key()), []).append(i)
    for (table_name, _), idxs in groups.items():
        table = db[table_name]
        ranges = ranges_list[idxs[0]]
        bucket = catalog.bucketize(table, ranges)
        stacked = np.stack([np.asarray(provs[i], dtype=bool) for i in idxs])
        b = stacked.shape[0]
        b_pad = 1 << (b - 1).bit_length()
        if b_pad != b:
            stacked = np.concatenate(
                [stacked, np.zeros((b_pad - b, stacked.shape[1]), dtype=bool)])
        provs_dev = torch.from_numpy(stacked).to(table.device)
        # The whole wave's bits come to the host at once (a reference merge point).
        bits_b = to_host(kops.fragment_bitmap_batch(provs_dev, bucket, ranges.n_ranges))
        sizes = catalog.fragment_sizes(table, ranges)
        for j, i in enumerate(idxs):
            bits = bits_b[j].astype(bool)
            out[i] = ProvenanceSketch(
                table=table_name,
                ranges=ranges_list[i],
                bits=bits,
                size_rows=int(sizes[bits].sum()),
                total_rows=table.num_rows,
                table_uid=table.uid,
                table_version=table.version,
            )
    return out  # type: ignore[return-value]


def sketch_keep_mask(
    sketch: ProvenanceSketch, table: ColumnTable, catalog: Optional[Catalog] = None
) -> torch.Tensor:
    """Row keep-mask: True iff the row's fragment belongs to the sketch."""
    from repro_torch.kernels import ops as kops

    catalog = catalog or default_catalog()
    bucket = catalog.bucketize(table, sketch.ranges)
    return kops.sketch_filter(bucket, torch.from_numpy(sketch.bits).to(table.device))


def _pad_instance_pow2(
    instance: ColumnTable, rows: np.ndarray, catalog: Catalog
) -> Tuple[ColumnTable, np.ndarray]:
    """Pow2-pad an instance's row count with masked (weight-0) tail rows.

    The tail rows duplicate row 0 and carry ``PAD_VALID=False``; the executor
    zero-weights them, so results are bit-identical.  ``rows`` (the
    base-table row per instance row) is padded alongside.
    """
    n = instance.num_rows
    if n == 0:
        return instance, rows
    n_pad = 1 << (n - 1).bit_length()
    valid = np.zeros(n_pad, dtype=bool)
    valid[:n] = True
    if n_pad != n:
        idx = np.zeros(n_pad, dtype=np.int64)
        idx[:n] = np.arange(n)
        instance = instance.gather(torch.from_numpy(idx))
        rows = rows[idx]
        catalog.stats["instance_padded"] += 1
    return (instance.with_column(PAD_VALID, torch.from_numpy(valid).to(instance.device)),
            rows)


def mask_instance(sketch, table: ColumnTable, catalog: Catalog) -> Tuple[ColumnTable, np.ndarray]:
    """The rows of ``table`` whose fragment the sketch keeps (ascending, so
    ``table.select(keep)``'s order) and their base-table row ids, unpadded:
    the ``sketch_filter_rows`` kernel's kept rows gathered on the table's
    device.  ``sketch`` is single-attribute or composite."""
    from repro_torch.kernels import ops as kops

    bucket = catalog.bucketize(table, sketch.ranges)
    _, rows = kops.sketch_filter_rows(bucket, torch.from_numpy(sketch.bits).to(table.device))
    return table.gather(rows), to_host(rows)


def _build_instance(
    sketch: ProvenanceSketch, table: ColumnTable, catalog: Catalog
) -> Tuple[ColumnTable, np.ndarray]:
    """Materialize the sketch instance R_P of one table (+ its source rows),
    pow2-padded: fragment slices on a table clustered on the sketch's
    partition, the kept rows of the keep-mask kernel otherwise (compacted on
    the device; the host gets a copy of the k rows, not the n-row mask)."""
    lay = table.layout
    if lay is not None and lay.matches(sketch.ranges):
        catalog.stats["instance_slices"] += 1
        # Tail rows are filtered through the catalog's (delta-refreshed)
        # bucket ids, so the tail filter stays delta-sized.
        tail_bucket = None
        if lay.tail:
            n = table.num_rows
            tail_bucket = to_host(catalog.bucketize(table, sketch.ranges)[n - lay.tail:])
        inst, rows = table.take_fragments(np.nonzero(sketch.bits)[0],
                                          tail_bucket=tail_bucket, return_rows=True)
        return _pad_instance_pow2(inst, rows, catalog)
    catalog.stats["instance_mask"] += 1
    return _pad_instance_pow2(*mask_instance(sketch, table, catalog), catalog)


def apply_sketch(
    sketch: ProvenanceSketch, db: Database, catalog: Optional[Catalog] = None
) -> Database:
    """D_P: replace the sketched relation with its (catalog-cached) instance."""
    catalog = catalog or default_catalog()
    table = db[sketch.table]
    instance = catalog.get_instance(sketch, table)
    if instance is None:
        instance, rows = _build_instance(sketch, table, catalog)
        catalog.put_instance(sketch, table, instance, rows=rows)
    return db.with_table(instance)


def execute_with_sketch(
    q: Query,
    db: Database,
    sketch: Optional[ProvenanceSketch],
    catalog: Optional[Catalog] = None,
) -> QueryResult:
    """Run ``q`` over ``D_P`` (or D when no sketch) — the instrumented query."""
    if sketch is None:
        return execute(q, db, catalog=catalog)
    return execute(q, apply_sketch(sketch, db, catalog=catalog), catalog=catalog)


def is_safe_sketch(q: Query, db: Database, sketch: ProvenanceSketch) -> bool:
    """Def. 4 checked extensionally: Q(D_P) == Q(D)."""
    return execute(q, db).canonical() == execute_with_sketch(q, db, sketch).canonical()


def actual_size(q: Query, db: Database, ranges: RangeSet) -> int:
    """size(Q, D, R, a, R) — ground truth for RSE measurements."""
    return capture_sketch(q, db, ranges).size_rows
