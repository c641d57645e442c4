"""Columnar tables on a torch device (port of ``repro/core/table.py``).

A ``ColumnTable`` is an immutable struct of 1-D column tensors, all on one
device, with a uid/version lineage: ``append`` and ``delete`` produce the
next version of the same relation and link it to its parent through a
``TableDelta``, from which catalog caches and sketch maintainers refresh
with delta-sized work.  Also here: ``gather``/``with_column``,
``from_numpy`` (which casts like ``jnp.asarray`` with x64 off),
``encode_groups`` and the float32 host bucketizer.  The fragment-major
layout (``cluster_by``, ``take_fragments``, ``compact``) comes with the
clustering slice.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple

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


def _numpy_dtype(col: torch.Tensor) -> np.dtype:
    return to_host(col[:0]).dtype


@dataclasses.dataclass(frozen=True, eq=False)
class TableDelta:
    """One append/delete step linking a table version to its parent.

    Catalog caches refresh from the parent entry plus the delta, and
    ``repro_torch.core.maintenance`` folds the delta rows into its counters.
    ``parent`` is a strong reference so id()-keyed parent cache entries stay
    valid while the delta is reachable.
    """

    kind: str  # 'append' | 'delete'
    parent: "ColumnTable"
    appended: Optional["ColumnTable"] = None  # kind='append': the new rows
    deleted_idx: Optional[np.ndarray] = None  # kind='delete': parent rows removed
    kept_idx: Optional[np.ndarray] = None  # kind='delete': parent rows kept

    @property
    def n_delta(self) -> int:
        if self.kind == "append":
            return self.appended.num_rows
        return int(self.deleted_idx.shape[0])


@dataclasses.dataclass(frozen=True, eq=False)
class ColumnTable:
    """An immutable bag-semantics relation stored column-major.

    ``uid`` is the lineage identity, kept by ``append``/``delete`` and fresh
    for any other derived table; ``version`` is the per-lineage version
    token they bump; ``delta`` is the step that produced this version (None
    for a root table).  Compared and hashed by identity.
    """

    name: str
    columns: Dict[str, torch.Tensor]
    primary_key: Tuple[str, ...] = ()
    version: int = 0
    uid: int = 0
    delta: Optional[TableDelta] = None

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

    # -- mutations (delta-aware) ----------------------------------------------
    def delta_depth(self) -> int:
        """Length of the delta chain behind this version."""
        depth, t = 0, self
        while t.delta is not None:
            depth += 1
            t = t.delta.parent
        return depth

    def collapse(self) -> "ColumnTable":
        """Drop the delta history: same contents, version and lineage, no
        parent references (so prior versions' columns can be freed)."""
        if self.delta is None:
            return self
        return ColumnTable(self.name, self.columns, self.primary_key,
                           version=self.version, uid=self.uid)

    def append(self, rows: Mapping[str, np.ndarray]) -> "ColumnTable":
        """Append a batch of rows (numpy columns), producing the next version.

        The batch is cast to the columns' dtypes on the table's device; a
        lossy cast raises, since a silently truncated value would flow
        through every maintained aggregate undetectably.
        """
        if set(rows) != set(self.columns):
            raise ValueError(
                f"append schema mismatch: {sorted(rows)} vs {sorted(self.columns)}")
        batch = {}
        for k, v in rows.items():
            src = np.asarray(v)
            dst = src.astype(_numpy_dtype(self.columns[k]))
            if not np.array_equal(dst.astype(np.float64), src.astype(np.float64),
                                  equal_nan=True):
                raise ValueError(
                    f"append column {k!r}: lossy cast {src.dtype} -> "
                    f"{self.columns[k].dtype}")
            batch[k] = dst
        lengths = {int(v.shape[0]) for v in batch.values()}
        if len(lengths) != 1:
            raise ValueError(
                f"ragged append batch: { {k: int(v.shape[0]) for k, v in batch.items()} }")
        dev = self.device
        appended = ColumnTable(
            self.name,
            {k: torch.from_numpy(np.require(v, requirements=["C", "W"])).to(dev)
             for k, v in batch.items()},
            self.primary_key)
        cols = {k: torch.cat([v, appended.columns[k]]) for k, v in self.columns.items()}
        return ColumnTable(
            self.name, cols, self.primary_key, version=self.version + 1, uid=self.uid,
            delta=TableDelta(kind="append", parent=self, appended=appended),
        )

    def delete(self, mask: np.ndarray) -> "ColumnTable":
        """Delete the rows where ``mask`` (numpy bool[num_rows]) is True,
        producing the next version; the kept rows keep their order."""
        mask = np.asarray(mask, dtype=bool)
        if mask.shape != (self.num_rows,):
            raise ValueError(f"delete mask of shape {mask.shape} for {self.num_rows} rows")
        deleted_idx = np.nonzero(mask)[0]
        kept_idx = np.nonzero(~mask)[0]
        keep = torch.from_numpy(kept_idx).to(self.device)
        cols = {k: v.index_select(0, keep) for k, v in self.columns.items()}
        return ColumnTable(
            self.name, cols, self.primary_key, version=self.version + 1, uid=self.uid,
            delta=TableDelta(kind="delete", parent=self,
                             deleted_idx=deleted_idx, kept_idx=kept_idx),
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
