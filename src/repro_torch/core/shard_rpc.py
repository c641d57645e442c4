"""The shard client surface (port of the in-process half of
``repro/core/shard_rpc.py``).

``ShardedEngine`` talks to every shard through a client.  This slice ports
the loopback client, which wraps an in-process ``FragmentShard``, and
``ShardCheckpoint``, a shard's recovery point.  Shards as separate
processes behind a socket (``SubprocessShardClient``, ``ShardServer``, the
warm pool) come with the process-boundary slice; the coordinator epoch and
its fence, restoring a checkpoint, rebuilding a shard and a standby's
takeover of the clients with the fault half of the sharded path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.queries import Query, inner_block_arrays
from repro_torch.core.ranges import RangeSet
from repro_torch.core.shard import FragmentShard
from repro_torch.core.table import ColumnTable


@dataclasses.dataclass(frozen=True)
class ShardCheckpoint:
    """One shard's recovery point: its own immutable local table at a
    watermark."""

    table: ColumnTable
    version: int


class LoopbackShardClient:
    """In-process client: wraps a ``FragmentShard`` directly.

    Everything not defined here goes to the wrapped shard (``ship``,
    ``catch_up``, ``register``, ``bits_for``, ``partial``, and the state
    callers read: ``maintainers``, ``table``, ``lag``).
    """

    def __init__(self, shard: FragmentShard):
        self._shard = shard

    def __getattr__(self, name):
        if name == "_shard":  # during partial init
            raise AttributeError(name)
        return getattr(self._shard, name)

    def block_arrays(self, key: int, ranges: RangeSet, bits: np.ndarray, q: Query):
        """One shard's inner-block arrays (encoding, WHERE mask, values) over
        its sketch instance (joined when the query joins), for the stacked
        layout."""
        shard = self._shard
        return inner_block_arrays(q, shard.joined_instance(q, key, ranges, bits), shard.catalog)

    # -- client-side state ---------------------------------------------------------
    def has_maintainer(self, key: int) -> bool:
        return key in self._shard.maintainers

    def dim_token(self, name: str) -> Optional[Tuple[int, int]]:
        t = self._shard.dims.get(name)
        return None if t is None else (t.uid, t.version)

    def state_token(self) -> Tuple[int, int]:
        t = self._shard.table
        return (t.uid, t.version)

    def make_checkpoint(self) -> ShardCheckpoint:
        t = self._shard.table
        return ShardCheckpoint(table=t, version=t.version)

    def close_client(self) -> None:
        pass
