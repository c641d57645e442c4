"""Columnar tables on a torch device (port of ``repro/core/table.py``).

A ``ColumnTable`` is an immutable struct of 1-D column tensors, all on one
device.  This slice carries what the single-table ``PBDSEngine.run`` path
needs: the uid/version lineage, ``gather``/``with_column``, ``from_numpy`` (which casts like ``jnp.asarray`` with x64 off),
``encode_groups`` and the float32 host bucketizer.  Appends, deletes,
compaction and the fragment-major layout come with the maintenance slice.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device, to_host

# Monotone lineage ids, as in the reference: each freshly created relation
# gets a new uid; caches tell "same relation, newer contents" apart from "a
# different relation" by (uid, version).
_TABLE_UIDS = itertools.count(1)

# Reserved column marking pow2-padded tables (sketch instances): True for
# real rows, False for the shape-pinning tail.
PAD_VALID = "__valid__"

# What ``jnp.asarray`` makes of a numpy dtype with x64 disabled.
_JAX_CAST = {np.dtype(np.int64): np.int32, np.dtype(np.float64): np.float32}


def _bucketize_np(bounds: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Host-side fragment ids with ``RangeSet.bucketize``'s float32
    comparison: a float64 search could put boundary-adjacent values in a
    different fragment than every device bucketization."""
    return np.searchsorted(bounds.astype(np.float32),
                           np.asarray(values).astype(np.float32), side="right")


def as_column(values: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy column on ``device``, cast as ``jnp.asarray`` casts it:
    int64 -> int32, float64 -> float32, other dtypes kept."""
    arr = np.asarray(values)
    arr = arr.astype(_JAX_CAST.get(arr.dtype, arr.dtype), copy=False)
    # A read-only source (e.g. a view of a JAX array) is copied: torch
    # tensors are writable.
    return torch.from_numpy(np.require(arr, requirements=["C", "W"])).to(device)


@dataclasses.dataclass(frozen=True, eq=False)
class ColumnTable:
    """An immutable bag-semantics relation stored column-major.

    ``uid`` is the lineage identity (fresh for every derived table in this
    slice, since nothing here mutates a relation); ``version`` is its
    per-lineage version token.  Compared and hashed by identity.
    """

    name: str
    columns: Dict[str, torch.Tensor]
    primary_key: Tuple[str, ...] = ()
    version: int = 0
    uid: int = 0

    def __post_init__(self):
        if self.uid == 0:
            object.__setattr__(self, "uid", next(_TABLE_UIDS))

    @property
    def num_rows(self) -> int:
        if not self.columns:
            return 0
        return int(next(iter(self.columns.values())).shape[0])

    @property
    def schema(self) -> Tuple[str, ...]:
        return tuple(sorted(self.columns))

    @property
    def device(self) -> torch.device:
        for v in self.columns.values():
            return v.device
        return torch.device("cpu")

    def __getitem__(self, attr: str) -> torch.Tensor:
        return self.columns[attr]

    def has(self, attr: str) -> bool:
        return attr in self.columns

    def with_column(self, attr: str, values: torch.Tensor) -> "ColumnTable":
        cols = dict(self.columns)
        cols[attr] = values
        return ColumnTable(self.name, cols, self.primary_key)

    def gather(self, idx) -> "ColumnTable":
        idx = torch.as_tensor(idx, dtype=torch.int64).to(self.device)
        return ColumnTable(
            self.name,
            {k: v.index_select(0, idx) for k, v in self.columns.items()},
            self.primary_key,
        )

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"ColumnTable({self.name!r}, rows={self.num_rows}, "
                f"cols={list(self.schema)}, device={self.device})")


def from_numpy(
    name: str,
    data: Mapping[str, np.ndarray],
    primary_key: Iterable[str] = (),
    device: DeviceLike = None,
) -> ColumnTable:
    """A table of numpy columns on ``device`` (CUDA unless ``"cpu"``)."""
    dev = resolve_device(device)
    cols = {k: as_column(v, dev) for k, v in data.items()}
    lengths = {k: int(v.shape[0]) for k, v in cols.items()}
    if len(set(lengths.values())) > 1:
        raise ValueError(f"ragged columns: {lengths}")
    return ColumnTable(name, cols, tuple(primary_key))


@dataclasses.dataclass(frozen=True)
class Database:
    """A named collection of tables (the ``D`` of the paper)."""

    tables: Dict[str, ColumnTable]

    def __getitem__(self, name: str) -> ColumnTable:
        return self.tables[name]

    def with_table(self, table: ColumnTable) -> "Database":
        t = dict(self.tables)
        t[table.name] = table
        return Database(t)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(sorted(self.tables))

    @property
    def device(self) -> torch.device:
        """The device of the tables (all on one)."""
        devices = {t.device for t in self.tables.values()}
        if len(devices) != 1:
            raise ValueError(f"tables lie on {sorted(map(str, devices))}, expected one device")
        return devices.pop()


def encode_groups(
    table: ColumnTable, attrs: Sequence[str]
) -> Tuple[np.ndarray, int, Dict[str, np.ndarray]]:
    """Dictionary-encode the group-by key on the host (``np.unique``), as
    the reference does: ``(gid, n_groups, group_values)`` with groups
    numbered in lexicographic key order."""
    if not attrs:
        return np.zeros(table.num_rows, dtype=np.int32), 1, {}
    stacked = np.stack([to_host(table[a]) for a in attrs], axis=1)
    uniq, gid = np.unique(stacked, axis=0, return_inverse=True)
    group_values = {a: uniq[:, i] for i, a in enumerate(attrs)}
    return gid.reshape(-1).astype(np.int32), int(uniq.shape[0]), group_values
