"""Coordinator failover: a warm standby that takes over an active cluster
(port of ``repro/core/standby.py``).

:class:`FailoverCoordinator` owns the role of "the coordinator", so that the
process playing it can die.  It wraps an active ``ShardedEngine``, keeps a
metadata replica attached (``core/replication.py``) and, when the chaos
harness injects a coordinator fault, promotes a standby:

1. **Snapshot** the replica's folded ``MetadataStore`` (a subprocess
   standby survived the coordinator and hands its store back).
2. **Promote** through ``ShardedEngine.from_replica`` with a bumped epoch:
   the clustered table replays from the replicated mutation log onto the
   old coordinator's device, placement and delta logs are adopted, the
   index is rebuilt by local counting under the replicated ``reg_id``s,
   and the live shard clients are re-wrapped (``clone_for_takeover``): no
   shard state moves, nothing is captured again, no table is reshipped.
3. **Fence** the old coordinator out: the promoted engine's first catch-up
   stamps the new epoch on every reachable shard, after which any op of the
   old coordinator raises ``StaleEpochError``.
4. **Re-arm**: a fresh replica attaches to the promoted coordinator, so
   takeovers chain.

Fault kinds (``runtime.chaos.COORD_FAULT_KINDS``): ``coord_kill`` drops the
coordinator object (its clients are not closed: the shard servers keep
running and the promoted engine adopts their sockets); ``coord_partition``
keeps the old engine as a live zombie that still believes it coordinates,
with the epoch fence the only thing keeping its writes out.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.core.replication import InProcessReplica, SubprocessReplica
from repro_torch.core.shard import ShardedEngine

#: Coordinator-level fault kinds this wrapper understands (the same tuple
#: as ``runtime.chaos.COORD_FAULT_KINDS``, not imported: the harness imports
#: nothing from here, and this module does not depend on it).
COORD_FAULT_KINDS = ("coord_kill", "coord_partition")


def replica_factory(kind: str) -> Callable[[], object]:
    """``"loopback"``: an in-process replica; ``"subprocess"``: a warm
    standby process that survives the coordinator object's death."""
    if kind == "loopback":
        return InProcessReplica
    if kind == "subprocess":
        return SubprocessReplica
    raise ValueError(f"unknown replica kind {kind!r}")


class FailoverCoordinator:
    """The failover-capable coordinator role around one ``ShardedEngine``.

    Delegates the whole serving surface (``run``, ``run_batch``, mutations,
    introspection) to the active engine, so it goes wherever a
    ``ShardedEngine`` goes (``runtime.chaos.run_ops`` and the differential
    included); ``inject_coord`` is the chaos surface.
    """

    def __init__(self, engine: ShardedEngine,
                 make_replica: Optional[Callable[[], object]] = None):
        self._engine = engine
        self._make_replica = make_replica or InProcessReplica
        self.replica = self._make_replica()
        engine.attach_replica(self.replica)
        self.takeovers = 0
        #: The fenced-out old engine after a ``coord_partition`` (None after
        #: a ``coord_kill``: a killed coordinator leaves no object behind).
        self.zombie: Optional[ShardedEngine] = None

    # -- delegation ------------------------------------------------------------
    @property
    def engine(self) -> ShardedEngine:
        """The active coordinator engine."""
        return self._engine

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._engine, name)

    # -- chaos surface ---------------------------------------------------------
    def inject_coord(self, kind: str) -> ShardedEngine:
        """Fail the active coordinator and promote a standby (see the module
        docstring); returns the promoted engine."""
        if kind not in COORD_FAULT_KINDS:
            raise ValueError(f"unknown coordinator fault kind {kind!r}")
        old = self._engine
        store = self.replica.snapshot()
        promoted = ShardedEngine.from_replica(store, epoch=old.epoch + 1, attach=old.shards)
        self.replica.close_replica()
        # The zombie is never shut down: its clients share live shard
        # servers with the promoted engine (close_client would hand shared
        # servers back to the pool under it).  A killed coordinator just
        # loses every reference; a partitioned one stays, so the epoch fence
        # can be seen refusing it.
        self.zombie = old if kind == "coord_partition" else None
        self._engine = promoted
        self.takeovers += 1
        # Stamp the new epoch on every reachable shard now (from here the
        # old coordinator is fenced out, not merely superseded) and recover
        # any shard that needs it.
        promoted._catch_up_all()
        # Re-arm with a fresh standby so the next takeover works too.
        self.replica = self._make_replica()
        promoted.attach_replica(self.replica)
        return promoted

    # -- lifecycle -------------------------------------------------------------
    def shutdown(self) -> None:
        """Shut down the active engine and the standby; the zombie (if any)
        is dropped without shutdown: its shard servers belong to the active
        engine now."""
        self.zombie = None
        try:
            self.replica.close_replica()
        except Exception:
            pass
        self._engine.shutdown()
