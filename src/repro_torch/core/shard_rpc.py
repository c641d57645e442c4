"""The shard client surface (port of the in-process half of
``repro/core/shard_rpc.py``).

``ShardedEngine`` talks to every shard through a client.  This module ports
the loopback client, which wraps an in-process ``FragmentShard``: it
carries its coordinator's epoch and fences every state-touching op with it,
and it checkpoints, restores and rebuilds the shard for recovery.  Shards
as separate processes behind a socket (``SubprocessShardClient``,
``ShardServer``, the warm pool) and a standby's takeover of the clients
come with the process-boundary slice (ROADMAP A6).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.queries import Query, inner_block_arrays
from repro_torch.core.ranges import RangeSet
from repro_torch.core.shard import FragmentShard, ShardPlan
from repro_torch.core.table import ColumnTable


@dataclasses.dataclass(frozen=True)
class ShardCheckpoint:
    """One shard's recovery point: its own immutable local table at a
    watermark (tables are never written in place, so the reference is the
    snapshot)."""

    table: ColumnTable
    version: int


class LoopbackShardClient:
    """In-process client: wraps a ``FragmentShard`` directly.

    Everything not defined here goes to the wrapped shard (``inject``,
    ``heal``, ``reachable``, and the state callers read: ``maintainers``,
    ``table``, ``lag``, ``version``).
    """

    def __init__(self, shard: FragmentShard):
        self._shard = shard
        # This client's coordinator epoch, stamped on every fenced op; the
        # owning ``ShardedEngine`` sets it.
        self.epoch = 0

    def __getattr__(self, name):
        if name == "_shard":  # during partial init
            raise AttributeError(name)
        return getattr(self._shard, name)

    def _fence(self, op: str) -> None:
        """Stamp and check this client's epoch on the shard before a fenced
        op.  Skipped while the shard is unreachable: the op itself raises at
        the shard's guard, and an unreachable coordinator must not bump the
        shard's epoch through the fault."""
        if self._shard.fault in ("dead", "partition"):
            return
        self._shard.fence(self.epoch, op)

    # -- fenced ops ----------------------------------------------------------------
    def ship(self, version: int, kind: str, payload) -> None:
        self._fence("ship")
        self._shard.ship(version, kind, payload)

    def catch_up(self, watermark: int) -> int:
        self._fence("catch_up")
        return self._shard.catch_up(watermark)

    def register(self, key: int, q: Query, ranges: RangeSet) -> None:
        self._fence("register")
        self._shard.register(key, q, ranges)

    def update_dim(self, table: ColumnTable) -> None:
        self._fence("update_dim")
        self._shard.update_dim(table)

    def bits_for(self, key: int) -> Optional[np.ndarray]:
        self._fence("bits_for")
        return self._shard.bits_for(key)

    def partial(self, q: Query, key: int, ranges: RangeSet, bits: np.ndarray):
        self._fence("partial")
        return self._shard.partial(q, key, ranges, bits)

    def block_arrays(self, key: int, ranges: RangeSet, bits: np.ndarray, q: Query):
        """One shard's inner-block arrays (encoding, WHERE mask, values) over
        its sketch instance (joined when the query joins), for the stacked
        layout."""
        self._fence("block_arrays")
        shard = self._shard
        return inner_block_arrays(q, shard.joined_instance(q, key, ranges, bits), shard.catalog)

    # -- client-side state ---------------------------------------------------------
    def has_maintainer(self, key: int) -> bool:
        return key in self._shard.maintainers

    def dim_token(self, name: str) -> Optional[Tuple[int, int]]:
        t = self._shard.dims.get(name)
        return None if t is None else (t.uid, t.version)

    def state_token(self) -> Optional[Tuple[int, int]]:
        t = self._shard.table
        return None if t is None else (t.uid, t.version)

    @property
    def state_lost(self) -> bool:
        return self._shard.table is None

    # -- recovery ------------------------------------------------------------------
    def make_checkpoint(self, coord_table: ColumnTable, coord_version: int) -> ShardCheckpoint:
        """The shard's current table as its recovery point (the coordinator's
        table and version are what a remote shard would checkpoint from)."""
        t = self._shard.table
        return ShardCheckpoint(table=t, version=t.version)

    def restore_checkpoint(self, ckpt: ShardCheckpoint, dims: Mapping[str, ColumnTable],
                           plan: ShardPlan, ranges: RangeSet) -> None:
        self._fence("restore_checkpoint")
        self._shard.adopt(ckpt.table, dims)

    def rebuild(self, plan: ShardPlan, ranges: RangeSet, clustered: ColumnTable,
                dims: Mapping[str, ColumnTable], device, inbox_cap: Optional[int],
                version: int) -> None:
        """Replace the shard by one cut anew from the coordinator's table
        under ``plan``; its epoch, the shard's identity, survives."""
        self._fence("rebuild")
        epoch = self._shard.epoch
        self._shard = FragmentShard(self._shard.shard_id, plan, ranges, clustered, dims, device,
                                    inbox_cap=inbox_cap, version=version)
        self._shard.epoch = epoch

    def close_client(self) -> None:
        pass
