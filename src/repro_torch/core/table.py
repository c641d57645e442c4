"""Columnar tables on a torch device (port of ``repro/core/table.py``).

A ``ColumnTable`` is an immutable struct of 1-D column tensors, all on one
device, with a uid/version lineage: ``append`` and ``delete`` produce the
next version of the same relation and link it to its parent through a
``TableDelta``, from which catalog caches and sketch maintainers refresh
with delta-sized work.  Also here: ``gather``/``with_column``,
``from_numpy`` (which casts like ``jnp.asarray`` with x64 off),
``encode_groups`` and the float32 host bucketizer.

``cluster_by`` lays a table out fragment-major under a range partition
(``FragmentLayout``): fragment ``f`` is the row slice ``[offsets[f],
offsets[f+1])``, so a sketch on that partition is applied by concatenating
slices (``take_fragments``).  Appends land in the layout's unsorted tail;
``compact`` folds the tail back into fragment-major order.
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
class FragmentLayout:
    """Fragment-major physical layout of a clustered table.

    Fragment ``f`` of the range partition is the contiguous row slice
    ``[offsets[f], offsets[f+1])``; the last ``tail`` rows are appended rows
    not yet sorted into their fragments.  Compared by identity.
    """

    attr: str
    ranges_key: Tuple
    offsets: np.ndarray  # (n_fragments + 1,) row offsets, offsets[0] == 0
    tail: int = 0

    @property
    def n_fragments(self) -> int:
        return int(self.offsets.shape[0]) - 1

    def matches(self, ranges) -> bool:
        return self.attr == ranges.attr and self.ranges_key == ranges.key()

    def bounds(self) -> np.ndarray:
        """The partition's interior split points, read back from the key
        (``RangeSet.key()`` holds the float64 bounds' bytes), so tail rows
        can be bucketized without the ``RangeSet``."""
        bounds = np.frombuffer(self.ranges_key[2], dtype=np.float64)
        if bounds.shape[0] != self.ranges_key[1] - 1:
            raise ValueError("layout ranges_key does not hold float64 bounds")
        return bounds


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

    ``uid`` is the lineage identity, kept by ``append``/``delete``/
    ``cluster_by`` and fresh for any other derived table; ``version`` is the
    per-lineage version token ``append``/``delete`` bump; ``layout`` is the
    fragment-major layout ``cluster_by`` sets (row-reordering operations drop
    it, appends grow its tail); ``delta`` is the step that produced this
    version (None for a root table).  Compared and hashed by identity.
    """

    name: str
    columns: Dict[str, torch.Tensor]
    primary_key: Tuple[str, ...] = ()
    layout: Optional[FragmentLayout] = None
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
        # Row order is unchanged, so the layout survives.
        return ColumnTable(self.name, cols, self.primary_key, self.layout)

    def select(self, mask) -> "ColumnTable":
        """Keep the rows where ``mask`` is True (compacted on the host)."""
        mask = to_host(mask) if isinstance(mask, torch.Tensor) else np.asarray(mask)
        return self.gather(np.nonzero(mask)[0])

    def gather(self, idx) -> "ColumnTable":
        idx = torch.as_tensor(idx, dtype=torch.int64).to(self.device)
        return ColumnTable(
            self.name,
            {k: v.index_select(0, idx) for k, v in self.columns.items()},
            self.primary_key,
        )

    # -- fragment-major layout ---------------------------------------------------
    def cluster_by(self, ranges) -> "ColumnTable":
        """Fragment-major layout for a range partition: rows stably reordered
        by fragment id (the reference's ``np.argsort(kind="stable")``, so
        rows of one fragment keep their order).  Lineage and version
        survive; the delta chain does not (row positions moved)."""
        bucket = to_host(ranges.bucketize(self[ranges.attr]))
        order = np.argsort(bucket, kind="stable")
        counts = np.bincount(bucket, minlength=ranges.n_ranges)
        offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        clustered = self.gather(order)
        layout = FragmentLayout(attr=ranges.attr, ranges_key=ranges.key(), offsets=offsets)
        return ColumnTable(self.name, clustered.columns, self.primary_key, layout,
                           version=self.version, uid=self.uid)

    def take_fragments(
        self, frag_ids: np.ndarray, tail_bucket: Optional[np.ndarray] = None,
        return_rows: bool = False,
    ):
        """The given fragments' slices, concatenated (clustered tables only).

        Tail rows are kept one by one when their fragment is among
        ``frag_ids``; ``tail_bucket`` (their fragment ids, e.g. from the
        catalog's delta-refreshed bucketization) is recomputed from the
        layout's bounds when not given.  With ``return_rows`` the source row
        of each output row comes back too.
        """
        if self.layout is None:
            raise ValueError(f"{self.name}: take_fragments needs a clustered table")
        lay = self.layout
        frag_ids = np.asarray(frag_ids)
        off = lay.offsets
        parts = [np.arange(off[f], off[f + 1]) for f in frag_ids]
        if lay.tail:
            n = self.num_rows
            if tail_bucket is None:
                tail_bucket = _bucketize_np(lay.bounds(), to_host(self[lay.attr][n - lay.tail:]))
            tail_bucket = np.asarray(tail_bucket)
            if tail_bucket.shape[0] != lay.tail:
                raise ValueError(
                    f"tail_bucket has {tail_bucket.shape[0]} entries for a "
                    f"{lay.tail}-row tail")
            keep = np.zeros(lay.n_fragments, dtype=bool)
            keep[frag_ids] = True
            parts.append(np.arange(n - lay.tail, n)[keep[tail_bucket]])
        idx = np.concatenate(parts) if parts else np.empty(0, dtype=np.int64)
        out = self.gather(idx)
        return (out, idx) if return_rows else out

    def compact(self) -> "ColumnTable":
        """Fold the unsorted tail into fragment-major order: each fragment's
        tail rows follow its prefix rows, in tail order.  Same contents,
        lineage and version; the delta chain is dropped, so row-position
        caches must be invalidated by the caller."""
        lay = self.layout
        if lay is None or lay.tail == 0:
            return self.collapse()
        n = self.num_rows
        tail_rows = np.arange(n - lay.tail, n)
        tail_bucket = _bucketize_np(lay.bounds(), to_host(self[lay.attr][n - lay.tail:]))
        order_t = np.argsort(tail_bucket, kind="stable")
        tail_counts = np.bincount(tail_bucket, minlength=lay.n_fragments)
        new_offsets = np.concatenate(
            [[0], np.cumsum(np.diff(lay.offsets) + tail_counts)]).astype(np.int64)
        t_off = np.concatenate([[0], np.cumsum(tail_counts)])
        parts = []
        for f in range(lay.n_fragments):
            parts.append(np.arange(lay.offsets[f], lay.offsets[f + 1]))
            parts.append(tail_rows[order_t[t_off[f]:t_off[f + 1]]])
        compacted = self.gather(np.concatenate(parts))
        layout = FragmentLayout(attr=lay.attr, ranges_key=lay.ranges_key, offsets=new_offsets)
        return ColumnTable(self.name, compacted.columns, self.primary_key, layout,
                           version=self.version, uid=self.uid)

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
        return ColumnTable(self.name, self.columns, self.primary_key, self.layout,
                           version=self.version, uid=self.uid)

    def append(self, rows: Mapping[str, np.ndarray]) -> "ColumnTable":
        """Append a batch of rows (numpy columns), producing the next version.

        The batch is cast to the columns' dtypes on the table's device; a
        lossy cast raises, since a silently truncated value would flow
        through every maintained aggregate undetectably.  A layout survives:
        the batch lands in its unsorted tail.
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
        layout = (dataclasses.replace(self.layout, tail=self.layout.tail + lengths.pop())
                  if self.layout is not None else None)
        return ColumnTable(
            self.name, cols, self.primary_key, layout,
            version=self.version + 1, uid=self.uid,
            delta=TableDelta(kind="append", parent=self, appended=appended),
        )

    def delete(self, mask: np.ndarray) -> "ColumnTable":
        """Delete the rows where ``mask`` (numpy bool[num_rows]) is True,
        producing the next version; the kept rows keep their order, so a
        layout survives with its offsets and tail shrunk."""
        mask = np.asarray(mask, dtype=bool)
        if mask.shape != (self.num_rows,):
            raise ValueError(f"delete mask of shape {mask.shape} for {self.num_rows} rows")
        deleted_idx = np.nonzero(mask)[0]
        kept_idx = np.nonzero(~mask)[0]
        keep = torch.from_numpy(kept_idx).to(self.device)
        cols = {k: v.index_select(0, keep) for k, v in self.columns.items()}
        layout = None
        if self.layout is not None:
            lay = self.layout
            prefix_len = self.num_rows - lay.tail
            del_prefix = deleted_idx[deleted_idx < prefix_len]
            frag_of_deleted = np.searchsorted(lay.offsets, del_prefix, side="right") - 1
            counts = np.diff(lay.offsets) - np.bincount(
                frag_of_deleted, minlength=lay.n_fragments)
            offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
            tail = lay.tail - int((deleted_idx >= prefix_len).sum())
            layout = FragmentLayout(attr=lay.attr, ranges_key=lay.ranges_key,
                                    offsets=offsets, tail=tail)
        return ColumnTable(
            self.name, cols, self.primary_key, layout,
            version=self.version + 1, uid=self.uid,
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


def unique_rows(stacked: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``np.unique(stacked, axis=0, return_inverse=True)``: the distinct rows
    of a 2-D array in lexicographic order, and each row's index among them
    (1-D).  Integer rows whose value ranges pack into one int64 key are
    found by a 1-D ``np.unique`` of that mixed-radix key, which orders them
    alike and takes a tenth of the time; other rows take
    ``np.unique(axis=0)``."""
    n, k = stacked.shape
    if n and k and stacked.dtype.kind in "iu":
        lows = [int(stacked[:, j].min()) for j in range(k)]
        sizes = [int(stacked[:, j].max()) - lows[j] + 1 for j in range(k)]
        total = 1
        for size in sizes:
            total *= size
        if total < 2 ** 62:
            key = np.zeros(n, dtype=np.int64)
            for j in range(k):
                key = key * sizes[j] + (stacked[:, j].astype(np.int64) - lows[j])
            ukey, inv = np.unique(key, return_inverse=True)
            uniq = np.empty((ukey.shape[0], k), dtype=stacked.dtype)
            for j in reversed(range(k)):
                uniq[:, j] = ukey % sizes[j] + lows[j]
                ukey = ukey // sizes[j]
            return uniq, inv.reshape(-1)
    uniq, inv = np.unique(stacked, axis=0, return_inverse=True)
    return uniq, inv.reshape(-1)


def encode_groups(
    table: ColumnTable, attrs: Sequence[str]
) -> Tuple[np.ndarray, int, Dict[str, np.ndarray]]:
    """Dictionary-encode the group-by key on the host, as the reference
    does: ``(gid, n_groups, group_values)`` with groups numbered in
    lexicographic key order (``unique_rows``)."""
    if not attrs:
        return np.zeros(table.num_rows, dtype=np.int32), 1, {}
    stacked = np.stack([to_host(table[a]) for a in attrs], axis=1)
    uniq, gid = unique_rows(stacked)
    group_values = {a: uniq[:, i] for i, a in enumerate(attrs)}
    return gid.astype(np.int32), int(uniq.shape[0]), group_values
