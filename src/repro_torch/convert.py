"""Carry state across from the JAX reference: databases and sketches.

The reference's "weights" are its data and its captured sketches.  Both
travel as numpy arrays (``ColumnTable.to_numpy()``, ``sketch.bits``), so a
database built or a sketch captured by ``repro`` can be rebuilt here, and
both packages then compute the same thing.
"""
from __future__ import annotations

from typing import Iterable, Mapping, Tuple

import numpy as np

from repro_torch.core.ranges import RangeSet
from repro_torch.core.sketch import ProvenanceSketch
from repro_torch.core.table import ColumnTable, Database, from_numpy
from repro_torch.device import DeviceLike

TableSpec = Tuple[str, Mapping[str, np.ndarray], Iterable[str]]


def database_from_numpy(tables: Iterable[TableSpec], device: DeviceLike = None) -> Database:
    """A ``Database`` from ``(name, columns, primary_key)`` triples, e.g.
    ``(t.name, t.to_numpy(), t.primary_key)`` for each reference table."""
    built = {}
    for name, columns, primary_key in tables:
        built[name] = from_numpy(name, columns, primary_key, device=device)
    return Database(built)


def sketch_from_numpy(
    table: ColumnTable,
    attr: str,
    bounds: np.ndarray,
    bits: np.ndarray,
    size_rows: int,
    total_rows: int,
) -> ProvenanceSketch:
    """A ``ProvenanceSketch`` over ``table`` (current for its version) from a
    reference sketch's partition bounds, bits and sizes."""
    bits = np.asarray(bits, dtype=bool)
    ranges = RangeSet(attr, np.asarray(bounds, dtype=np.float64))
    if bits.shape != (ranges.n_ranges,):
        raise ValueError(f"{bits.shape[0]} bits for {ranges.n_ranges} ranges")
    if total_rows != table.num_rows:
        raise ValueError(f"sketch of {total_rows} rows for a table of {table.num_rows}")
    return ProvenanceSketch(
        table=table.name, ranges=ranges, bits=bits, size_rows=int(size_rows),
        total_rows=int(total_rows), table_uid=table.uid, table_version=table.version,
    )
