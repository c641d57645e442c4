"""Fragment-sharded serving: fragments placed on shards, sketches routed
(port of ``repro/core/shard.py``, the in-process loopback shards).

A clustered ``ColumnTable``'s fragments are placed on S shards (in-process
``FragmentShard`` objects on the engine's device), and a reused sketch is
routed as a fragment-id set to only the shards that own set bits.

Serving is fused by default: the contacted shards' sketch instances are
stacked shard-major (``StackedInstances``: rows pow2-padded to a common
count, group ids rewritten into a coordinator-owned global dictionary), and
one launch of the ``segment_aggregate_batch`` kernel computes every shard's
per-group sums and counts and merges them over the shard axis.
``run_batch`` adds a leading query axis, so a whole hit batch, across
different registered sketches, costs one launch.  The per-shard host loop
(each shard's ``partial()``, merged by group key on the coordinator)
stays behind ``fused=False``.  Either way the query finishes with the
group-level code single-node execution uses
(``queries.result_from_group_state``), so results equal single-node results
bit for bit while the aggregates are exact (integral values inside the
float32 2^24 envelope).

Mutations are coordinator operations that route each batch by fragment
ownership and ship per-shard deltas into shard inboxes; shards apply them
and advance their maintainers when next read, and every read first drains
each shard up to the coordinator's mutation count (the watermark).  When
the placement attribute is in the (outer) GROUP BY, every group lives on
one shard, so per-shard maintainers keep the sketch's bits shard-locally
and the logical bits are their OR; otherwise the coordinator's maintainer
keeps them.  Dimension tables are replicated to every shard: a join query's
local instance is joined with the shard's replica, and a mutated dimension
is replicated anew and evicts the sketches whose join reads it.

Every shard op goes through ``_shard_call``: bounded retries against
``ShardUnavailableError``, a deadline with a per-(shard, op) straggler
baseline, and the health machine healthy -> suspect -> dead -> recovering
-> healthy.  A shard that is down, unreachable or past the deadline has its
slices served coordinator-side (bit-identical inside the envelope, in the
one fused launch too); a lost shard recovers by adopting its checkpoint,
replaying the coordinator's delta log and re-registering its maintainers by
local counting, never by re-capture; ``rebalance`` re-places a dead shard's
fragments onto the survivors.  Faults are injected in-process
(``FragmentShard.inject``, driven by ``runtime/chaos.py``).  Subprocess
shards, peer-mirrored checkpoints and metadata replication to a standby
coordinator belong to the process-boundary slice (ROADMAP A6) and raise
``NotImplementedError`` here.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import time
from typing import Deque, Dict, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core.catalog import Catalog
from repro_torch.core.engine import PBDSEngine, RunInfo
from repro_torch.core.index import IndexEntry
from repro_torch.core.maintenance import MaintenanceError, SketchMaintainer, maintainer_for
from repro_torch.core.queries import (
    Query,
    QueryResult,
    inner_block_arrays,
    inner_group_partials,
    result_from_group_state,
)
from repro_torch.core.ranges import RangeSet, equi_depth_ranges
from repro_torch.core.table import ColumnTable, Database, FragmentLayout, unique_rows
from repro_torch.device import to_host
from repro_torch.parallel.placement import failover_device, place_table, shard_devices
from repro_torch.runtime.elastic import plan_replacement
from repro_torch.runtime.guards import LAUNCH_COUNTS, SHAPE_CLASSES, hot_path
from repro_torch.runtime.resilience import RetryPolicy, StragglerMonitor, with_retries

REPLICATION_SLICE = (
    "subprocess shards and metadata replication to a standby coordinator come "
    "with the process-boundary slice (ROADMAP A6)")


class ShardUnavailableError(RuntimeError):
    """A shard could not be reached: dead, partitioned or mid-failure.  The
    one error ``_shard_call`` retries, so transient drops retry while logic
    errors (the mis-routed-tail guard) surface at once."""


class BackpressureError(RuntimeError):
    """A shard's inbox is at its depth cap; the coordinator's per-shard delta
    log carries the entry until the next read resyncs the shard."""


class StaleEpochError(RuntimeError):
    """A shard refused an op fenced behind the newest coordinator epoch it
    has seen.  Not a ``ShardUnavailableError``: a fenced-out coordinator's
    op is invalid, not transient, and is never retried."""


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Fragment -> shard ownership map for one range partition."""

    n_shards: int
    owner: np.ndarray  # (n_fragments,) shard id per fragment

    def fragments_of(self, shard_id: int) -> np.ndarray:
        return np.nonzero(self.owner == shard_id)[0]

    def shards_for(self, frag_ids: np.ndarray) -> np.ndarray:
        """The distinct shards owning any of ``frag_ids``: the route set."""
        return np.unique(self.owner[np.asarray(frag_ids)])


def plan_fragments(sizes: np.ndarray, n_shards: int, policy: str = "contig") -> ShardPlan:
    """Place fragments on shards.

    ``contig`` (default) cuts the fragment sequence into row-balanced
    contiguous runs, so a selective sketch's (value-clustered) bits skip
    whole shards; ``spread`` deals fragments round-robin.
    """
    sizes = np.asarray(sizes, dtype=np.float64)
    n_frags = sizes.shape[0]
    owner = np.zeros(n_frags, dtype=np.int64)
    if policy == "spread":
        owner = np.arange(n_frags, dtype=np.int64) % n_shards
    elif policy == "contig":
        per = sizes.sum() / max(n_shards, 1)
        s, load = 0, 0.0
        for f in range(n_frags):
            if s < n_shards - 1 and load >= per:
                s, load = s + 1, 0.0
            owner[f] = s
            load += sizes[f]
    else:
        raise ValueError(f"unknown placement policy {policy!r}")
    return ShardPlan(n_shards=n_shards, owner=owner)


def local_table_for(
    shard_id: int, plan: ShardPlan, ranges: RangeSet, clustered: ColumnTable,
    version: int = 0,
) -> ColumnTable:
    """Gather ``shard_id``'s owned rows out of the coordinator's clustered
    table into a shard-local clustered layout (local fragment j is the j-th
    owned global fragment); tail rows are routed by ownership, bucketized
    in float32 as ``append_rows`` routes them."""
    if clustered.layout is None:
        raise ValueError("shards are built from a clustered table")
    owned = plan.fragments_of(shard_id)
    lay = clustered.layout
    off = lay.offsets
    parts = [np.arange(off[f], off[f + 1]) for f in owned]
    n_tail_local = 0
    if lay.tail:
        n = clustered.num_rows
        tail_frag = to_host(ranges.bucketize(clustered[ranges.attr][n - lay.tail:]))
        own_tail = (n - lay.tail) + np.nonzero(plan.owner[tail_frag] == shard_id)[0]
        n_tail_local = int(own_tail.shape[0])
        parts.append(own_tail)
    idx = np.concatenate(parts) if parts else np.empty(0, dtype=np.int64)
    local = clustered.gather(idx)
    local_sizes = np.array([off[f + 1] - off[f] for f in owned], dtype=np.int64)
    layout = FragmentLayout(
        attr=ranges.attr,
        # Never equal to a RangeSet.key(): local fragment ids are another
        # coordinate system than the global partition's.
        ranges_key=("shard", shard_id, ranges.key()),
        offsets=np.concatenate([[0], np.cumsum(local_sizes)]).astype(np.int64),
        tail=n_tail_local,
    )
    return ColumnTable(local.name, local.columns, clustered.primary_key, layout,
                       version=version)


class FragmentShard:
    """One shard: its owned fragments' rows, its catalog and its sketch
    maintainers.  Deltas arrive through ``ship`` into an inbox and are
    applied by ``catch_up`` when the coordinator next reads.  Every op
    passes ``_guard``, where injected faults take effect."""

    MAX_DELTA_CHAIN = 16

    def __init__(
        self,
        shard_id: int,
        plan: ShardPlan,
        ranges: RangeSet,
        clustered: ColumnTable,
        dims: Mapping[str, ColumnTable],
        device: Optional[torch.device] = None,
        inbox_cap: Optional[int] = None,
        version: int = 0,
    ):
        self.shard_id = shard_id
        self.ranges = ranges
        self.owned = plan.fragments_of(shard_id)
        # global fragment id -> local fragment position (-1 = not owned).
        self._local_of_global = np.full(ranges.n_ranges, -1, dtype=np.int64)
        self._local_of_global[self.owned] = np.arange(self.owned.shape[0])
        # On the shard's pin, else the coordinator's device.
        self.device = device
        self.table: Optional[ColumnTable] = place_table(
            local_table_for(shard_id, plan, ranges, clustered, version=version), device)
        self.dims: Dict[str, ColumnTable] = {k: place_table(v, device) for k, v in dims.items()}
        self.catalog = Catalog()
        self.maintainers: Dict[int, SketchMaintainer] = {}
        self._inst: Dict[int, Tuple[Tuple, ColumnTable]] = {}
        self._inbox: Deque[Tuple[int, str, object]] = collections.deque()
        # Past this many queued deltas ``ship`` raises ``BackpressureError``
        # (``None``: no cap), so a shard that never drains cannot eat the
        # coordinator's memory; the coordinator's log carries the entry.
        self.inbox_cap = inbox_cap
        self.backpressure_hits = 0
        # Injected fault: None, "dead", "stall", "partition" or "flaky".
        self.fault: Optional[str] = None
        self.stall_s = 0.0
        self._flaky_fails = 0
        # Highest coordinator epoch this shard has accepted an op from: the
        # shard's identity, not its table state, so it survives a kill and a
        # rebuild and a fenced-out coordinator stays fenced out.
        self.epoch = 0

    # -- epoch fence and faults ------------------------------------------------
    def fence(self, epoch: int, op: str = "") -> None:
        """Refuse ops behind the newest coordinator epoch seen (a monotone
        max): once a newer coordinator has reached the shard, the old one's
        ops raise ``StaleEpochError``."""
        if epoch < self.epoch:
            raise StaleEpochError(
                f"shard {self.shard_id}: coordinator epoch {epoch} is fenced "
                f"behind {self.epoch} ({op or 'op'})")
        self.epoch = epoch

    def _guard(self, op: str) -> None:
        """Every shard op passes here: the failure choke point."""
        if self.fault in ("dead", "partition"):
            raise ShardUnavailableError(f"shard {self.shard_id} is {self.fault} ({op})")
        if self.fault == "flaky":
            self._flaky_fails -= 1
            if self._flaky_fails <= 0:
                self.fault = None
            raise ShardUnavailableError(f"shard {self.shard_id} dropped {op} (flaky)")
        if self.fault == "stall" and self.stall_s > 0:
            time.sleep(self.stall_s)
        if self.table is None:
            raise ShardUnavailableError(f"shard {self.shard_id} lost its state ({op})")

    def inject(self, kind: str, arg=None) -> None:
        """Inject one fault.  ``kill`` loses all in-memory state (table,
        maintainers, instances, inbox, catalog), as a process death would;
        ``stall`` makes every op sleep ``arg`` seconds (default 0.02);
        ``partition`` makes the shard unreachable with its state intact;
        ``flaky`` fails the next ``arg`` ops (default 1), then heals."""
        if kind == "kill":
            self.fault = "dead"
            self.table = None
            self.maintainers.clear()
            self._inst.clear()
            self._inbox.clear()
            self.catalog = Catalog()
        elif kind == "stall":
            self.fault = "stall"
            self.stall_s = float(arg) if arg is not None else 0.02
        elif kind == "partition":
            self.fault = "partition"
        elif kind == "flaky":
            self.fault = "flaky"
            self._flaky_fails = int(arg) if arg is not None else 1
        else:
            raise ValueError(f"unknown fault kind {kind!r}")

    def heal(self) -> None:
        """Clear any injected fault.  A killed shard becomes reachable but
        empty: the coordinator finds the lost state on its next read and
        recovers it (checkpoint adopt, delta replay, re-registration)."""
        self.fault = None
        self.stall_s = 0.0
        self._flaky_fails = 0

    @property
    def reachable(self) -> bool:
        """Can the coordinator reach this shard at all?"""
        return self.fault not in ("dead", "partition")

    def adopt(self, table: ColumnTable, dims: Mapping[str, ColumnTable]) -> None:
        """Install recovered state (a checkpoint's table and the current
        dimension tables) after a kill; maintainers and instances are gone
        until re-registration."""
        self.table = place_table(table, self.device)
        self.dims = {k: place_table(v, self.device) for k, v in dims.items()}
        self.catalog = Catalog()
        self.maintainers = {}
        self._inst = {}
        self._inbox.clear()

    # -- replication -----------------------------------------------------------
    @property
    def version(self) -> int:
        """Local watermark: fact-table deltas applied (-1 while the state
        is lost)."""
        return self.table.version if self.table is not None else -1

    @property
    def lag(self) -> int:
        return len(self._inbox)

    def ship(self, version: int, kind: str, payload) -> None:
        """Enqueue one versioned delta (``append`` rows or ``delete`` local
        mask).  Idempotent: ``catch_up`` drops entries at or below the local
        version, so the coordinator may re-ship a log suffix.  Past
        ``inbox_cap`` entries it raises ``BackpressureError``."""
        self._guard("ship")
        if self.inbox_cap is not None and len(self._inbox) >= self.inbox_cap:
            self.backpressure_hits += 1
            raise BackpressureError(f"shard {self.shard_id} inbox at cap ({self.inbox_cap})")
        self._inbox.append((version, kind, payload))

    def update_dim(self, table: ColumnTable) -> None:
        """Replace a replicated dimension table."""
        self._guard("update_dim")
        old = self.dims.get(table.name)
        if old is not None:
            self.catalog.invalidate_table(old)
        self.dims[table.name] = place_table(table, self.device)
        for key in [k for k, m in self.maintainers.items()
                    if m.q.join is not None and m.q.join.right == table.name]:
            del self.maintainers[key]

    def _db(self) -> Database:
        tables = dict(self.dims)
        tables[self.table.name] = self.table
        return Database(tables)

    def catch_up(self, watermark: int) -> int:
        """Apply pending deltas up to ``watermark`` and advance the
        maintainers (delta-sized work); returns the number applied.  A
        version gap stops the drain until the coordinator re-ships the
        missing suffix from its log."""
        self._guard("catch_up")
        applied = 0
        while self.table.version < watermark and self._inbox:
            version, kind, payload = self._inbox[0]
            if version <= self.table.version:
                self._inbox.popleft()  # duplicate re-ship
                continue
            if version > self.table.version + 1:
                break  # gap: wait for the coordinator's log resync
            self._inbox.popleft()
            if kind == "append":
                self.table = self.table.append(payload)
            elif kind == "delete":
                self.table = self.table.delete(payload)
            else:  # pragma: no cover - defensive
                raise ValueError(f"unknown delta kind {kind!r}")
            applied += 1
        if applied:
            db = self._db()
            for key, m in list(self.maintainers.items()):
                try:
                    m.apply(self.table, db)
                except MaintenanceError:
                    del self.maintainers[key]
            self._inst.clear()
        if self.table.delta_depth() > self.MAX_DELTA_CHAIN:
            self.catalog.invalidate_chain(self.table)
            self.table = self.table.collapse()
        return applied

    # -- sketch registration ---------------------------------------------------
    def register(self, key: int, q: Query, ranges: RangeSet) -> None:
        """Build this shard's maintainer for one logical index entry (cloned
        from a maintainer of the same inner-block signature when one
        exists)."""
        self._guard("register")
        self.maintainers[key] = maintainer_for(
            q, self._db(), ranges, self.catalog, list(self.maintainers.values()))

    def unregister(self, key: int) -> None:
        self.maintainers.pop(key, None)
        self._inst.pop(key, None)

    def bits_for(self, key: int) -> Optional[np.ndarray]:
        """This shard's maintained bits (global fragment ids), or ``None``
        when the maintainer was dropped and needs re-registration."""
        self._guard("bits_for")
        m = self.maintainers.get(key)
        return m.bits() if m is not None else None

    # -- query serving ---------------------------------------------------------
    def _instance(self, key: int, ranges: RangeSet, bits: np.ndarray) -> ColumnTable:
        """The local sketch instance: owned and sketched fragments, sliced
        when the sketch is on the serving partition (tail rows filtered by
        their global fragment), the keep-mask kernel's kept rows otherwise.  The
        instance's source rows are recorded in the catalog, so its group
        encodings and WHERE masks are gathers of the local table's."""
        self._guard("instance")
        token = (id(self.table), bits.tobytes())
        cached = self._inst.get(key)
        if cached is not None and cached[0] == token:
            self.catalog.stats["instance_hit"] += 1
            return cached[1]
        lay = self.table.layout
        if ranges.key() == self.ranges.key():
            local_ids = np.nonzero(bits[self.owned])[0]
            tail_bucket = None
            if lay.tail:
                n = self.table.num_rows
                gfrag = to_host(self.catalog.bucketize(self.table, self.ranges)[n - lay.tail:])
                tail_bucket = self._local_of_global[gfrag]
                if tail_bucket.size and tail_bucket.min() < 0:
                    # Routing and bucketization disagree: corruption.
                    raise RuntimeError(
                        f"shard {self.shard_id}: mis-routed tail rows "
                        f"(fragments {np.unique(gfrag[tail_bucket < 0])})")
            inst, rows = self.table.take_fragments(local_ids, tail_bucket=tail_bucket,
                                                   return_rows=True)
            self.catalog.stats["instance_slices"] += 1
        else:
            from repro_torch.kernels import ops as kops

            bucket = self.catalog.bucketize(self.table, ranges)
            _, rows_dev = kops.sketch_filter_rows(bucket, torch.from_numpy(bits).to(bucket.device))
            inst = self.table.gather(rows_dev)
            rows = to_host(rows_dev)
            self.catalog.stats["instance_mask"] += 1
        self.catalog.note_subset(inst, self.table, rows)
        self._inst[key] = (token, inst)
        return inst

    def joined_instance(self, q: Query, key: int, ranges: RangeSet,
                        bits: np.ndarray) -> ColumnTable:
        """The local sketch instance, joined with the shard's replica of the
        query's dimension table when the query joins."""
        return _joined(q, self._instance(key, ranges, bits), self.dims, self.catalog)

    def partial(
        self, q: Query, key: int, ranges: RangeSet, bits: np.ndarray
    ) -> Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray]:
        """Per-group partial aggregates over the local sketch instance:
        ``(group key values, sums, WHERE-passing counts)``; the coordinator
        re-keys on the values, so local numbering is never coordinated."""
        enc, _, sums, counts = inner_group_partials(
            q, self.joined_instance(q, key, ranges, bits), self.catalog)
        return enc.group_values, to_host(sums), to_host(counts)


def _joined(q: Query, inst: ColumnTable, dims: Mapping[str, ColumnTable],
            catalog: Catalog) -> ColumnTable:
    """``inst`` joined with ``dims[q.join.right]`` through ``catalog`` when
    ``q`` joins, else ``inst``."""
    if q.join is None:
        return inst
    flat, _ = catalog.join(inst, dims[q.join.right], q.join.left_key, q.join.right_key)
    return flat


# ---------------------------------------------------------------------------
# Stacked shard-major execution (the fused path)
# ---------------------------------------------------------------------------


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


@dataclasses.dataclass(frozen=True)
class StackedInstances:
    """Shard-major stacked inner-block tensors for one registered entry.

    Each contacted shard's instance rows are padded to a common pow2 row
    count and stacked on a shard axis (also pow2-padded): values, group ids
    in the coordinator's global dictionary, and weights (WHERE; padded rows
    weigh 0).  A leading query axis of 1 lets a hit batch concatenate.
    """

    vals: torch.Tensor  # (1, S_pad, R_pad) f32
    gid: torch.Tensor  # (1, S_pad, R_pad) i32, global group ids
    weights: torch.Tensor  # (1, S_pad, R_pad) f32
    n_groups: int
    g_pad: int
    group_values: Dict[str, np.ndarray]  # global dictionary (np.unique order)
    contacted_ids: Tuple[int, ...]  # shards owning >= 1 sketch fragment
    token: Tuple = ()  # freshness: shard table versions + sketch bits

    @property
    def contacted(self) -> int:
        return len(self.contacted_ids)

    @property
    def r_pad(self) -> int:
        return int(self.vals.shape[2])

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.vals, self.gid, self.weights))


def _fused_body(vals: torch.Tensor, gid: torch.Tensor, w: torch.Tensor, g_pad: int):
    """(K, S, R) stacked tensors -> (K, g_pad) merged per-group sums and
    counts.  Each query's shard slices flatten into one row axis (group ids
    are already global, so the shard-axis reduction is the segment sum), and
    one ``segment_aggregate_batch`` launch covers the query axis.  Integral
    float32 sums are exact in any order, so the result equals the host-loop
    merge and single-node execution bit for bit."""
    from repro_torch.kernels import ops as kops

    k, s, r = vals.shape
    return kops.segment_aggregate_batch(
        vals.reshape(k, s * r), gid.reshape(k, s * r), g_pad, w.reshape(k, s * r))


# ---------------------------------------------------------------------------
# Coordinator
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Registered:
    """Routed-serving state of one logical index entry (keyed by its
    ``reg_id``): the bits come from the shards' maintainers when every group
    is shard-local, from the coordinator's otherwise."""

    entry: IndexEntry
    ranges: RangeSet
    group_local: bool


@dataclasses.dataclass
class RouteInfo:
    """Bookkeeping of one routed execution or hit batch."""

    contacted: int
    skipped: int
    watermark: int
    deltas_applied: int
    per_shard_s: Dict[int, float]
    t_merge_s: float
    # The one stacked launch on the fused path; the summed per-shard
    # ``partial()`` calls on the host loop.
    t_launch_s: float = 0.0
    fused: bool = False
    n_queries: int = 1
    # Degraded-mode bookkeeping: ``failed_shards`` lists the shards whose
    # slices were served from the coordinator's table this route (down,
    # unreachable or past the op deadline), ``n_retries`` the transient shard
    # op failures that retries absorbed, ``stale_checkpoints`` the
    # cumulative peer-mirrored checkpoints that could not advance (peer
    # mirrors come with subprocess shards, ROADMAP A6, so 0 here).
    degraded: bool = False
    failed_shards: Tuple[int, ...] = ()
    n_retries: int = 0
    stale_checkpoints: int = 0

    @property
    def t_critical_s(self) -> float:
        """Shard-parallel latency: the slowest contacted shard plus the
        merge on the host loop; launch plus merge on the fused path."""
        if self.fused:
            return self.t_launch_s + self.t_merge_s
        return (max(self.per_shard_s.values()) if self.per_shard_s else 0.0) + self.t_merge_s


class ShardedEngine:
    """Coordinator: a ``PBDSEngine`` for selection and capture, plus S
    fragment shards for serving.

    The coordinator keeps the authoritative clustered table (captures,
    selection and NO-PS run single-node over it); index hits are served
    routed, only the shards owning set bits contacted.  Mutations ship
    per-shard deltas and return at once; shards drain on their next read.
    """

    def __init__(
        self,
        db: Database,
        table: str,
        attr: str,
        n_shards: int,
        n_ranges: int = 64,
        strategy: str = "CB-OPT-GB",
        policy: str = "contig",
        use_devices: bool = True,
        fused: bool = True,
        max_registered: Optional[int] = None,
        health: bool = True,
        op_deadline_s: float = 5.0,
        inbox_cap: Optional[int] = 4096,
        retry_policy: Optional[RetryPolicy] = None,
        transport: str = "loopback",
        epoch: int = 0,
        **engine_kwargs,
    ):
        for k in ("cluster_tables", "compact_tail_frac"):
            if k in engine_kwargs:
                # Re-permuting the coordinator table would desync the
                # global-row -> shard-row map that delete routing needs.
                raise ValueError(f"{k} is coordinator-managed in ShardedEngine")
        if transport == "subprocess":
            raise NotImplementedError(REPLICATION_SLICE)
        if transport != "loopback":
            raise ValueError(f"unknown transport {transport!r}")
        from repro_torch.core import shard_rpc  # deferred: shard_rpc imports us

        self.table_name = table
        self.attr = attr
        self.n_shards = n_shards
        self.ranges = equi_depth_ranges(db[table], attr, n_ranges)
        clustered = db[table].cluster_by(self.ranges)
        self.engine = PBDSEngine(db.with_table(clustered), strategy=strategy,
                                 n_ranges=n_ranges, **engine_kwargs)
        self.device = self.engine.device
        # The serving partition is the engine's partition for ``attr``, so a
        # sketch selected on it routes as fragment slices on every shard.
        self.engine._ranges_cache[(table, attr)] = self.ranges
        self.plan = plan_fragments(np.diff(clustered.layout.offsets), n_shards, policy=policy)
        dims = self._dims()
        # Shards are pinned round-robin only when the engine itself is on a
        # CUDA device and several exist.
        self._devices = shard_devices(n_shards, use_devices and self.device.type == "cuda")
        self._inbox_cap = inbox_cap
        self.shards = [
            shard_rpc.LoopbackShardClient(
                FragmentShard(s, self.plan, self.ranges, clustered, dims, self._devices[s],
                              inbox_cap=inbox_cap))
            for s in range(n_shards)
        ]
        # Coordinator epoch, stamped on every fenced shard op: a shard
        # refuses any lower epoch, so a superseded coordinator cannot land
        # mutations after a takeover.
        self.epoch = int(epoch)
        for c in self.shards:
            c.epoch = self.epoch
        # Global row -> (shard, local row), kept across mutations so that
        # coordinator delete masks translate to shard-local masks.
        n = clustered.num_rows
        frag_of_row = np.searchsorted(clustered.layout.offsets, np.arange(n), side="right") - 1
        self._row_shard = self.plan.owner[frag_of_row]
        self._row_local = np.empty(n, dtype=np.int64)
        self._shard_rows = np.zeros(n_shards, dtype=np.int64)
        for s in range(n_shards):
            sel = self._row_shard == s
            self._shard_rows[s] = int(sel.sum())
            self._row_local[sel] = np.arange(self._shard_rows[s])
        # Coordinator mutation count == the read watermark.
        self.version = 0
        self._registered: Dict[int, _Registered] = {}
        self._reg_counter = 1
        self.last_route: Optional[RouteInfo] = None
        self.fused = fused
        # Registrations beyond this are pruned by recency after each pass.
        self.max_registered = max_registered
        # Shard health: healthy -> suspect -> dead -> recovering -> healthy
        # (``_shard_call``, ``_recover_shard``).  ``health=False`` bypasses
        # the per-op wrapper (a fault-free baseline; never run it against
        # injected faults).
        self.health_tracking = health
        self.op_deadline_s = op_deadline_s
        self._retry_policy = retry_policy or RetryPolicy(
            max_attempts=3, backoff_s=1e-3, backoff_mult=2.0,
            retryable=(ShardUnavailableError,), deadline_s=op_deadline_s)
        self.health: List[str] = ["healthy"] * n_shards
        self._monitors: Dict[Tuple[int, str], StragglerMonitor] = {}
        self._route_retries = 0
        self.stale_checkpoints = [0] * n_shards
        # Recovery state held by the coordinator: per shard a checkpoint (a
        # reference to its immutable local table at its last drained read)
        # and the log of every delta shipped past it.  A lost shard recovers
        # by checkpoint adopt + log replay + maintainer re-registration.
        self._ckpt = [c.make_checkpoint(clustered, 0) for c in self.shards]
        self._log: List[List[Tuple[int, str, object]]] = [[] for _ in range(n_shards)]

    def _emit(self, kind: str, payload) -> None:
        """Stream one metadata record to an attached standby: a no-op until
        replication lands (ROADMAP A6)."""

    def attach_replica(self, replica) -> None:
        raise NotImplementedError(REPLICATION_SLICE)

    @classmethod
    def from_replica(cls, store, *, epoch: int, attach=None) -> "ShardedEngine":
        raise NotImplementedError(REPLICATION_SLICE)

    # -- convenience -----------------------------------------------------------
    @property
    def db(self) -> Database:
        return self.engine.db

    @property
    def index(self):
        return self.engine.index

    def min_watermark(self) -> int:
        """The slowest shard's applied-delta count."""
        return min((s.version for s in self.shards), default=self.version)

    def stacked_bytes(self) -> int:
        """Device bytes held by the stacked cache (per-entry stacks and
        assembled hit batches)."""
        total = 0
        for _, value in self.engine.catalog._stacked.values():
            if isinstance(value, StackedInstances):
                total += value.nbytes
            else:
                total += sum(t.numel() * t.element_size() for t in value[:3])
        return total

    # -- mutations -------------------------------------------------------------
    def append_rows(self, table_name: str, rows: Mapping[str, np.ndarray]) -> None:
        """Route the batch by fragment ownership and ship per-shard deltas
        (every shard gets one, possibly empty, so versions stay aligned)."""
        if table_name != self.table_name:
            self.engine.append_rows(table_name, rows)
            self._emit("mutation", ("append", table_name))
            self._replicate_dim(table_name)
            return
        rows_np = {k: np.asarray(v) for k, v in rows.items()}
        # ``RangeSet.bucketize`` itself (float32), so coordinator routing and
        # shard-side bucketization agree on boundary values.
        bucket = to_host(self.ranges.bucketize(
            torch.from_numpy(np.array(rows_np[self.attr]))))
        shard_of = self.plan.owner[bucket]
        counts = np.bincount(shard_of, minlength=self.n_shards)
        new_local = np.empty(shard_of.shape[0], dtype=np.int64)
        version = self.version + 1
        for s in range(self.n_shards):
            sel = shard_of == s
            self._ship(s, version, "append", {k: v[sel] for k, v in rows_np.items()})
            new_local[sel] = self._shard_rows[s] + np.arange(counts[s])
        self._shard_rows += counts
        self._row_shard = np.concatenate([self._row_shard, shard_of])
        self._row_local = np.concatenate([self._row_local, new_local])
        self.engine.append_rows(table_name, rows)
        self.version += 1
        self._emit("mutation", ("append", table_name, version))

    def delete_rows(self, table_name: str, mask: np.ndarray) -> None:
        """Translate the coordinator-row mask into per-shard local masks."""
        if table_name != self.table_name:
            self.engine.delete_rows(table_name, mask)
            self._emit("mutation", ("delete", table_name))
            self._replicate_dim(table_name)
            return
        mask = np.asarray(mask, dtype=bool)
        version = self.version + 1
        for s in range(self.n_shards):
            local_mask = np.zeros(self._shard_rows[s], dtype=bool)
            local_mask[self._row_local[mask & (self._row_shard == s)]] = True
            self._ship(s, version, "delete", local_mask)
        keep = ~mask
        self._row_shard = self._row_shard[keep]
        self._row_local = self._row_local[keep]
        self._shard_rows = np.bincount(self._row_shard, minlength=self.n_shards)
        for s in range(self.n_shards):
            sel = self._row_shard == s
            self._row_local[sel] = np.arange(self._shard_rows[s])
        self.engine.delete_rows(table_name, mask)
        self.version += 1
        self._emit("mutation", ("delete", table_name, version))

    def _ship(self, sid: int, version: int, kind: str, payload) -> None:
        """Best-effort delivery of one delta: the coordinator's per-shard log
        is the authoritative copy, so a refused ship leaves the shard lagging
        until the next read resyncs it from the log."""
        self._log[sid].append((version, kind, payload))
        if self.health_tracking and self.health[sid] == "dead":
            return  # known dead: recovery replays the log
        try:
            self.shards[sid].ship(version, kind, payload)
        except BackpressureError:
            pass  # inbox full; the log carries it
        except ShardUnavailableError:
            self._demote(sid)

    def _replicate_dim(self, table_name: str) -> None:
        """Replicate a mutated dimension table and evict the sketches whose
        join reads it: sketches are versioned against the fact table only,
        so serving one across a dimension mutation could return a stale
        join.  The next query re-captures.  An unreachable shard is skipped:
        ``_sync_shard`` refreshes a drifted replica before it serves again."""
        for sid, shard in enumerate(self.shards):
            if self.health_tracking and self.health[sid] == "dead":
                continue
            try:
                shard.update_dim(self.engine.db[table_name])
            except ShardUnavailableError:
                self._demote(sid)
        for e in list(self.engine.index.entries()):
            if e.query.join is not None and e.query.join.right == table_name:
                self.engine.index.remove(e)
                if e.reg_id:
                    self._unregister(e.reg_id)
                    self._emit("evict", e.reg_id)

    # -- queries ---------------------------------------------------------------
    @hot_path
    def run(self, q: Query) -> Tuple[QueryResult, RunInfo]:
        t0 = time.perf_counter()
        entry = self.engine.index.lookup_entry(q) if self.engine.strategy != "NO-PS" else None
        if entry is not None:
            routed = self._run_routed(q, entry, t0)
            if routed is not None:
                return routed
        # Miss (or an unroutable hit): single-node on the coordinator, then
        # register any fresh capture with every shard.
        res, info = self.engine.run(q)
        self._register_new()
        return res, info

    def _group_local(self, q: Query) -> bool:
        """Can the sketch's bits be maintained shard-locally?  Only when
        every (inner and outer) group lies on one shard: the placement
        attribute is in the (outer) GROUP BY."""
        if self.attr not in q.groupby:
            return False
        if q.outer_groupby is not None and self.attr not in q.outer_groupby:
            return False
        return True

    def _register_new(self) -> None:
        """Register every not-yet-registered index entry: one watermark
        catch-up across the shards, then every new entry's per-shard
        maintainers (a whole admitted wave at once)."""
        if self.engine.strategy == "NO-PS":
            return
        new = [e for e in self.engine.index.entries() if e.reg_id == 0]
        if not new:
            return
        for e in new:
            e.reg_id = self._reg_counter
            self._reg_counter += 1
        fact_new = [e for e in new if e.query.table == self.table_name]
        down: Set[int] = set()
        if any(self._group_local(e.query) for e in fact_new):
            _, down = self._catch_up_all()
        for e in fact_new:
            group_local = self._group_local(e.query)
            if group_local:
                for sid, shard in enumerate(self.shards):
                    if sid in down or (self.health_tracking and self.health[sid] != "healthy"):
                        continue  # registered at recovery (_reregister_shard)
                    try:
                        self._shard_call(sid, "register", functools.partial(
                            shard.register, e.reg_id, e.query, e.sketch.ranges))
                    except ShardUnavailableError:
                        pass
            self._registered[e.reg_id] = _Registered(e, e.sketch.ranges, group_local)
        if self.max_registered is not None:
            self.prune(self.max_registered)

    def _unregister(self, key: int) -> None:
        for shard in self.shards:
            shard.unregister(key)
        self._registered.pop(key, None)
        self.engine.catalog.drop_stacked(("stacked", key))

    def prune(self, max_entries: int) -> int:
        """Evict the least recently hit sketches from the index, and their
        shard maintainers, instances and stacked tensors; returns the count."""
        evicted = self.engine.index.prune(max_entries)
        if evicted:
            alive = {e.reg_id for e in self.engine.index.entries()}
            for key in [k for k in self._registered if k not in alive]:
                self._unregister(key)
                self._emit("evict", key)
        return evicted

    def shutdown(self) -> None:
        """Release shard resources (loopback clients hold none)."""
        for c in self.shards:
            c.close_client()

    def selection_state(self) -> dict:
        """The coordinator's reuse-aware selection state (shards never see it)."""
        return self.engine.selection_state()

    def restore_selection_state(self, state: Mapping) -> None:
        self.engine.restore_selection_state(state)

    # -- health, recovery, rebalance ---------------------------------------------
    def _demote(self, sid: int) -> None:
        """One hard failure of shard ``sid``: healthy -> suspect, suspect
        -> dead."""
        if self.health_tracking:
            self.health[sid] = "dead" if self.health[sid] == "suspect" else "suspect"

    def _shard_call(self, sid: int, op: str, fn):
        """One guarded shard op: bounded retries with backoff and a deadline
        (``with_retries`` against ``ShardUnavailableError``), a per-(shard,
        op) straggler baseline, and the health transitions.  A failure that
        outlasts the retries demotes the shard (healthy -> suspect -> dead);
        an op past ``op_deadline_s`` demotes it to suspect once the op's
        baseline has formed (so the first calls, which build kernels and
        caches, never demote); an op in time promotes suspect or recovering
        back to healthy."""
        if not self.health_tracking:
            return fn()
        if self.health[sid] == "dead":
            raise ShardUnavailableError(f"shard {sid} marked dead")
        retries = 0

        def count(_attempt: int, _e: Exception) -> None:
            nonlocal retries
            retries += 1

        t0 = time.perf_counter()
        try:
            out = with_retries(fn, self._retry_policy, on_retry=count)
        except ShardUnavailableError:
            self._route_retries += retries
            self._demote(sid)
            raise
        dt = time.perf_counter() - t0
        self._route_retries += retries
        mon = self._monitors.get((sid, op))
        if mon is None:
            mon = self._monitors[(sid, op)] = StragglerMonitor()
        mon.observe(dt)
        if dt > self.op_deadline_s and mon.median() is not None:
            self.health[sid] = "suspect"
        elif self.health[sid] in ("suspect", "recovering"):
            self.health[sid] = "healthy"
        return out

    def _checkpoint(self, sid: int) -> None:
        """Advance one shard's recovery point (it is at the watermark) and
        prune its log; a version compare when already there."""
        cur = self._ckpt[sid]
        if cur is not None and cur.version == self.version:
            return
        ckpt = self.shards[sid].make_checkpoint(self.db[self.table_name], self.version)
        self._ckpt[sid] = ckpt
        v = ckpt.version
        if self._log[sid] and self._log[sid][0][0] <= v:
            self._log[sid] = [e for e in self._log[sid] if e[0] > v]
        self._emit("ckpt", (sid, v))

    def _dims(self) -> Dict[str, ColumnTable]:
        return {k: v for k, v in self.engine.db.tables.items() if k != self.table_name}

    def _sync_shard(self, sid: int) -> int:
        """Bring one shard to the watermark: refresh drifted dimension
        replicas, drain the inbox, re-ship any log suffix the shard missed
        (ships lost to a partition or refused by backpressure), and rebuild
        it outright when the log cannot reach the watermark."""
        shard = self.shards[sid]
        for name, t in self.engine.db.tables.items():
            if name != self.table_name and shard.dim_token(name) != (t.uid, t.version):
                shard.update_dim(t)
        applied = shard.catch_up(self.version)
        while shard.version < self.version:
            missing = [e for e in self._log[sid] if e[0] > shard.version]
            if not missing:
                return applied + self._rebuild_shard(sid)
            before = shard.version
            for entry in missing:
                try:
                    shard.ship(*entry)
                except BackpressureError:
                    break  # drain below, then ship the rest
            applied += shard.catch_up(self.version)
            if shard.version == before:
                return applied + self._rebuild_shard(sid)
        return applied

    def _recover_shard(self, sid: int) -> int:
        """Recover a reachable-again shard: adopt its last checkpoint when
        its state was lost, replay the delta log to the watermark,
        re-register its maintainers by counting its local rows.  Never a
        re-capture: the sketch bits come back through the counting that
        produced them."""
        shard = self.shards[sid]
        self.health[sid] = "recovering"
        if shard.state_lost:
            if self._ckpt[sid] is None:
                # No coherent checkpoint (the placement changed while it was
                # gone): rebuild from the coordinator's table.
                self._rebuild_shard(sid)
                self.health[sid] = "healthy"
                return 0
            shard.restore_checkpoint(self._ckpt[sid], self._dims(), self.plan, self.ranges)
        applied = self._sync_shard(sid)
        self._reregister_shard(sid)
        self._checkpoint(sid)
        self.health[sid] = "healthy"
        return applied

    def _reregister_shard(self, sid: int) -> None:
        """Register every routed group-local entry the shard lacks (its
        maintainers were lost or rebuilt, or it sat out a registration wave
        while suspect)."""
        shard = self.shards[sid]
        for key, reg in self._registered.items():
            if not reg.group_local or not self.engine.index.contains(reg.entry):
                continue
            if not shard.has_maintainer(key):
                shard.register(key, reg.entry.query, reg.ranges)

    def _rebuild_shard(self, sid: int) -> int:
        """Rebuild one shard outright from the coordinator's table under the
        current plan (a gather of its local rows): ``rebalance``'s path, and
        recovery's when the log cannot reach the watermark.  Still no
        re-capture: maintainers re-register by local counting."""
        dead = [s for s, h in enumerate(self.health) if h == "dead"]
        self._devices[sid] = failover_device(self._devices, sid, dead)
        self.shards[sid].rebuild(self.plan, self.ranges, self.db[self.table_name], self._dims(),
                                 self._devices[sid], self._inbox_cap, self.version)
        self._log[sid] = []
        self._reregister_shard(sid)
        self._checkpoint(sid)
        return 0

    def _rebuild_row_maps(self) -> None:
        """Recompute the global row -> (shard, local row) maps from the
        coordinator's table and the current plan (after a re-placement).
        Tail rows are bucketized by ``RangeSet.bucketize`` (float32), as
        ``append_rows`` routed them."""
        ctable = self.db[self.table_name]
        lay = ctable.layout
        n = ctable.num_rows
        frag_prefix = np.searchsorted(lay.offsets, np.arange(n - lay.tail), side="right") - 1
        if lay.tail:
            tail_frag = to_host(self.ranges.bucketize(ctable[self.attr][n - lay.tail:]))
            row_frag = np.concatenate([frag_prefix, tail_frag])
        else:
            row_frag = frag_prefix
        self._row_shard = self.plan.owner[row_frag]
        self._row_local = np.empty(n, dtype=np.int64)
        self._shard_rows = np.zeros(self.n_shards, dtype=np.int64)
        for s in range(self.n_shards):
            sel = self._row_shard == s
            self._shard_rows[s] = int(sel.sum())
            self._row_local[sel] = np.arange(self._shard_rows[s])

    def rebalance(self, dead: Optional[Sequence[int]] = None) -> List[int]:
        """Re-place the fragments of ``dead`` shards (default: every shard
        marked dead) onto the survivors by ``plan_replacement``, and rebuild
        the survivors whose fragment set changed; returns their ids."""
        if dead is None:
            dead = [s for s in range(self.n_shards) if self.health[s] == "dead"]
        dead_set = {int(d) for d in dead}
        if not dead_set:
            return []
        sizes = np.diff(self.db[self.table_name].layout.offsets)
        new_owner = plan_replacement(sizes, self.plan.owner, self.n_shards, sorted(dead_set))
        changed = [s for s in range(self.n_shards)
                   if not np.array_equal(np.nonzero(new_owner == s)[0], self.plan.fragments_of(s))]
        self.plan = ShardPlan(n_shards=self.n_shards, owner=new_owner)
        self._rebuild_row_maps()
        rebuilt, voided = [], []
        for sid in changed:
            if sid in dead_set:
                # The lost shard owns nothing now; its checkpoint and log
                # speak the old placement, so a rejoin rebuilds, never replays.
                self._ckpt[sid] = None
                self._log[sid] = []
                voided.append(sid)
                continue
            self._rebuild_shard(sid)
            self.health[sid] = "healthy"
            rebuilt.append(sid)
        self._emit("plan", (new_owner, voided))
        # The plan changed identity: every stacked cache key is dead.
        self.engine.catalog.drop_stacked(("stacked",))
        self.engine.catalog.drop_stacked(("stacked_batch",))
        return rebuilt

    def _catch_up_all(self) -> Tuple[int, Set[int]]:
        """The watermark gate: every reachable shard drains its inbox up to
        the coordinator's mutation count before serving; returns the deltas
        applied and the shards that could not be brought current
        (``down``: their slices serve from the coordinator's table this
        route).  A dead or killed shard that is reachable again recovers on
        the spot."""
        applied = 0
        down: Set[int] = set()
        for sid, shard in enumerate(self.shards):
            if (self.health_tracking and self.health[sid] == "dead") or (
                    shard.state_lost and shard.reachable):
                if shard.reachable:
                    try:
                        applied += self._recover_shard(sid)
                    except (ShardUnavailableError, BackpressureError):
                        self.health[sid] = "dead"
                        down.add(sid)
                else:
                    down.add(sid)
                continue
            try:
                applied += self._shard_call(
                    sid, "catch_up", functools.partial(self._sync_shard, sid))
            except (ShardUnavailableError, BackpressureError):
                down.add(sid)
                continue
            self._checkpoint(sid)
            if self.health_tracking and self.health[sid] == "healthy":
                # A shard that sat out a registration wave (suspect then)
                # picks up its maintainers on its first healthy read.
                try:
                    self._reregister_shard(sid)
                except (ShardUnavailableError, BackpressureError):
                    down.add(sid)
        return applied, down

    def _degraded_set(self, down: Set[int]) -> Set[int]:
        """The shards served coordinator-side this route: ``down`` plus the
        suspect and dead ones, less those owning no fragment (re-placed away
        by a rebalance: nothing to stand in for)."""
        degraded = set(down)
        if self.health_tracking:
            degraded |= {s for s in range(self.n_shards) if self.health[s] in ("suspect", "dead")}
        return {s for s in degraded if self.plan.fragments_of(s).size > 0}

    def _resolve_bits(self, key: int, reg: _Registered, degraded: Set[int]) -> Optional[np.ndarray]:
        """The logical sketch bits of one registered entry, or ``None`` when a
        shard maintainer was lost (the caller falls back to the miss path).
        Group-local entries OR their shards' maintained bits; the others, or
        any with a degraded shard, take the coordinator's maintained sketch,
        which for a group-local entry is the same bits.  A shard that fails
        here joins ``degraded``."""
        if reg.group_local:
            bits_parts: Optional[List[np.ndarray]] = []
            for sid, shard in enumerate(self.shards):
                if self.plan.fragments_of(sid).size == 0:
                    continue  # owns nothing (re-placed away)
                if sid in degraded:
                    bits_parts = None
                    break
                try:
                    b = self._shard_call(sid, "bits_for", functools.partial(shard.bits_for, key))
                except ShardUnavailableError:
                    degraded.add(sid)
                    bits_parts = None
                    break
                if b is None:  # maintainer dropped
                    self._unregister(key)
                    return None
                bits_parts.append(b)
            if bits_parts is not None:
                return np.logical_or.reduce(bits_parts)
        sketch, _ = self.engine._current_sketch(reg.entry)
        return sketch.bits

    # -- coordinator-side slices -------------------------------------------------
    def _degraded_flat(self, sid: int, reg: _Registered, bits: np.ndarray) -> ColumnTable:
        """Shard ``sid``'s instance rows cut from the coordinator's table,
        while the shard is served coordinator-side (same rows; another row
        order, invisible inside the exactness envelope)."""
        ctable = self.db[self.table_name]
        ranges = reg.ranges
        owned = self.plan.fragments_of(sid)
        if ranges.key() == self.ranges.key():
            frag_ids = owned[np.asarray(bits)[owned]]
            lay = ctable.layout
            tail_bucket = None
            if lay.tail:
                n = ctable.num_rows
                tail_bucket = to_host(
                    self.engine.catalog.bucketize(ctable, self.ranges)[n - lay.tail:])
            return ctable.take_fragments(frag_ids, tail_bucket=tail_bucket)
        bucket = to_host(self.engine.catalog.bucketize(ctable, ranges))
        return ctable.select(np.asarray(bits)[bucket] & (self._row_shard == sid))

    def _degraded_partial(self, sid: int, q: Query, reg: _Registered, bits: np.ndarray):
        """Coordinator-side stand-in for ``FragmentShard.partial``."""
        flat = _joined(q, self._degraded_flat(sid, reg, bits), self.db.tables,
                       self.engine.catalog)
        enc, _, sums, counts = inner_group_partials(q, flat, self.engine.catalog)
        return enc.group_values, to_host(sums), to_host(counts)

    def _stacked_token(self, degraded: Set[int], bits: np.ndarray) -> Tuple:
        """Freshness token of the stacked tensors: each live shard's table
        (uid, version), the coordinator table's for degraded ones, and the
        sketch bits.  A kill, heal, rebuild or rebalance changes it (a lost
        shard outside the degraded set owns no fragment, and any sentinel
        does for it)."""
        ctable = self.db[self.table_name]
        per = tuple(("coord", ctable.uid, ctable.version) if sid in degraded
                    else (s.state_token() or ("lost",)) for sid, s in enumerate(self.shards))
        return (per, bits.tobytes())

    def _degraded_arrays(self, sid: int, q: Query, reg: _Registered, bits: np.ndarray):
        """Coordinator-side stand-in for a shard's ``block_arrays``."""
        catalog = self.engine.catalog
        return inner_block_arrays(
            q, _joined(q, self._degraded_flat(sid, reg, bits), self.db.tables, catalog), catalog)

    def _contacted(self, reg: _Registered, bits: np.ndarray) -> List[int]:
        """The shards a route contacts: those owning fragments, less those
        owning no sketch fragment when the sketch is on the serving partition
        (their instance is empty by construction)."""
        routable = reg.ranges.key() == self.ranges.key()
        out = []
        for sid in range(self.n_shards):
            owned = self.plan.fragments_of(sid)
            if owned.size == 0 or (routable and not bits[owned].any()):
                continue  # fragment-skip the whole shard
            out.append(sid)
        return out

    def _stacked_for(
        self, key: int, reg: _Registered, bits: np.ndarray, degraded: Set[int],
    ) -> StackedInstances:
        """Build (or fetch) the stacked shard-major tensors of one entry.

        Cached under the registration and plan, guarded by the freshness
        token, so any delta a shard applies or any maintained bit that flips
        rebuilds the stack and the steady state costs one dictionary probe.
        The shard axis covers the contacted shards only; a degraded shard's
        slice is cut from the coordinator's table (the launch does not care
        where a slice came from), and a shard that fails mid-build joins
        ``degraded``.
        """
        catalog = self.engine.catalog
        ckey = ("stacked", key, self.db[self.table_name].uid, id(self.plan))
        token = self._stacked_token(degraded, bits)
        hit = catalog.get_stacked(ckey, token)
        if hit is not None:
            return hit
        q = reg.entry.query
        attrs = tuple(q.groupby)
        per_shard: List[Tuple] = []
        contacted_ids = self._contacted(reg, bits)
        for sid in contacted_ids:
            if sid not in degraded:
                try:
                    per_shard.append(self._shard_call(sid, "instance", functools.partial(
                        self.shards[sid].block_arrays, key, reg.ranges, bits, q)))
                    continue
                except ShardUnavailableError:
                    degraded.add(sid)
            per_shard.append(self._degraded_arrays(sid, q, reg, bits))

        # The coordinator's global group dictionary: np.unique over the
        # contacted shards' group keys, the construction the host-loop merge
        # re-keys with, so the fused, host-loop and single-node paths number
        # (and order) groups alike.
        global_of_local: List[Optional[np.ndarray]] = [None] * len(per_shard)
        if not attrs:
            n_groups, group_values = 1, {}
        else:
            mats, owners = [], []
            for i, a in enumerate(per_shard):
                if a[0].n_groups > 0:
                    mats.append(np.stack([np.asarray(a[0].group_values[at]) for at in attrs],
                                         axis=1))
                    owners.append(i)
            if mats:
                uniq, inv = unique_rows(np.concatenate(mats))
                n_groups = int(uniq.shape[0])
                group_values = {a: uniq[:, i] for i, a in enumerate(attrs)}
                off = 0
                for i, m in zip(owners, mats):
                    global_of_local[i] = inv[off:off + m.shape[0]]
                    off += m.shape[0]
            else:
                n_groups, group_values = 0, {}

        r_max = max((int(a[1].shape[0]) for a in per_shard), default=0)
        r_pad = _next_pow2(max(r_max, 1))
        s_pad = _next_pow2(max(len(per_shard), 1))
        g_pad = _next_pow2(max(n_groups, 1))
        dev = self.device
        vals = torch.zeros((1, s_pad, r_pad), dtype=torch.float32, device=dev)
        gid = torch.zeros((1, s_pad, r_pad), dtype=torch.int32, device=dev)
        weights = torch.zeros((1, s_pad, r_pad), dtype=torch.float32, device=dev)
        for i, (enc, where_mask, v) in enumerate(per_shard):
            n = int(where_mask.shape[0])
            if n == 0:
                continue
            gmap = global_of_local[i]
            g = enc.gid_dev.to(dev, torch.int32)  # a pinned shard's slice moves here
            if gmap is not None:
                g = torch.from_numpy(gmap.astype(np.int32)).to(dev)[g.long()]
            gid[0, i, :n] = g
            vals[0, i, :n] = v.to(dev, torch.float32)
            weights[0, i, :n] = where_mask.to(dev, torch.float32)

        # Keyed on how the stack was built: a shard may have failed mid-build.
        token = self._stacked_token(degraded, bits)
        st = StackedInstances(
            vals=vals, gid=gid, weights=weights, n_groups=n_groups, g_pad=g_pad,
            group_values=group_values, contacted_ids=tuple(contacted_ids), token=token,
        )
        catalog.put_stacked(ckey, token, st)
        return st

    @hot_path
    def _launch(self, vals: torch.Tensor, gid: torch.Tensor, weights: torch.Tensor,
                g_pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The one fused launch (no host sync inside: the caller's copy of
        the (K, g_pad) results to the host is the merge point).

        It calls the launch function through a variable, as the reference's
        ``_launch`` does: ``tools.analyze`` links calls by bare name across
        ``src/``, and a direct call would link this hot path to the
        reference's same-named jnp oracle, which no hot path runs."""
        SHAPE_CLASSES["fused_partials"].add((*vals.shape, g_pad))
        LAUNCH_COUNTS["fused_partials"] += 1
        fn = _fused_body
        return fn(vals, gid, weights, g_pad)

    def _result_from_merged(
        self, q: Query, st: StackedInstances, sums: np.ndarray, counts: np.ndarray,
    ) -> QueryResult:
        """Finish one query from the fused launch's merged group state (the
        host loop's tail, minus the re-key: the stack speaks the global
        dictionary already)."""
        if not q.groupby:
            s, c = float(sums[0]), float(counts[0])
            agg = _finalize(q.agg.fn, np.array([s], dtype=np.float64),
                            np.array([c], dtype=np.float64))
            return result_from_group_state(q, {}, agg, np.array([c > 0]), self.device)
        if st.n_groups == 0:
            return _empty_result(q)
        sums64 = sums[:st.n_groups].astype(np.float64)
        counts64 = counts[:st.n_groups].astype(np.float64)
        agg = _finalize(q.agg.fn, sums64, counts64)
        return result_from_group_state(q, st.group_values, agg, counts64 > 0, self.device)

    def _degraded_report(self, degraded: Set[int]) -> dict:
        """``RouteInfo``'s degraded-mode fields for this route."""
        return dict(degraded=bool(degraded), failed_shards=tuple(sorted(degraded)),
                    n_retries=self._route_retries,
                    stale_checkpoints=sum(self.stale_checkpoints))

    def _partials(self, q: Query, key: int, reg: _Registered, bits: np.ndarray,
                  degraded: Set[int]) -> Tuple[List, Dict[int, float]]:
        """Host loop: each contacted shard's ``partial()`` and its seconds."""
        per_shard_s: Dict[int, float] = {}
        partials = []
        for sid in self._contacted(reg, bits):
            ts = time.perf_counter()
            if sid not in degraded:
                try:
                    partials.append(self._shard_call(sid, "partial", functools.partial(
                        self.shards[sid].partial, q, key, reg.ranges, bits)))
                except ShardUnavailableError:
                    degraded.add(sid)
            if sid in degraded:
                partials.append(self._degraded_partial(sid, q, reg, bits))
            per_shard_s[sid] = time.perf_counter() - ts
        return partials, per_shard_s

    def _run_routed(
        self, q: Query, entry: IndexEntry, t0: float
    ) -> Optional[Tuple[QueryResult, RunInfo]]:
        key = entry.reg_id
        reg = self._registered.get(key)
        if reg is None:
            return None
        self._route_retries = 0
        applied, down = self._catch_up_all()
        degraded = self._degraded_set(down)
        bits = self._resolve_bits(key, reg, degraded)
        if bits is None:
            return None

        if self.fused:
            st = self._stacked_for(key, reg, bits, degraded)
            tl = time.perf_counter()
            sums, counts = self._launch(st.vals, st.gid, st.weights, st.g_pad)
            sums_np, counts_np = to_host(sums[0]), to_host(counts[0])  # the merge point
            tm = time.perf_counter()
            res = self._result_from_merged(q, st, sums_np, counts_np)
            t1 = time.perf_counter()
            contacted = st.contacted
            per_shard_s: Dict[int, float] = {}
            t_launch, t_merge = tm - tl, t1 - tm
        else:
            partials, per_shard_s = self._partials(q, key, reg, bits, degraded)
            tm = time.perf_counter()
            res = _merge_partials(q, partials, self.device)
            t1 = time.perf_counter()
            contacted = len(per_shard_s)
            t_launch, t_merge = sum(per_shard_s.values()), t1 - tm
        self.last_route = RouteInfo(
            contacted=contacted, skipped=self.n_shards - contacted,
            watermark=self.version, deltas_applied=applied, per_shard_s=per_shard_s,
            t_merge_s=t_merge, t_launch_s=t_launch, fused=self.fused,
            **self._degraded_report(degraded),
        )
        info = RunInfo(
            reused=True, created=False, attr=reg.ranges.attr,
            strategy=self.engine.strategy, selectivity=entry.sketch.selectivity,
            t_execute=t1 - t0, repaired=applied > 0,
            shards_contacted=contacted, shards_skipped=self.n_shards - contacted,
            degraded=bool(degraded),
        )
        return res, info

    # -- batched serving -------------------------------------------------------
    @hot_path
    def run_batch(self, qs: Sequence[Query]) -> List[Tuple[QueryResult, RunInfo]]:
        """Batched sharded serving: every index hit of a wave in one fused
        launch, the misses through the batched admission pipeline, and every
        capture registered with the shards in one pass.  Results, index
        contents, sketch bits and shard maintainer state equal those of
        ``[self.run(q) for q in qs]``."""
        from repro_torch.core.admission import admit_misses

        if self.engine.selection.reuse_aware and self.engine.strategy != "NO-PS":
            self.engine.workload.begin_batch(len(qs))
        out: List[Optional[Tuple[QueryResult, RunInfo]]] = [None] * len(qs)
        pending: List[Tuple[int, Query]] = list(enumerate(qs))
        while pending:
            misses: List[Tuple[int, Query, float]] = []
            hits: Dict[int, List[Tuple[int, Query, IndexEntry, float]]] = {}
            for i, q in pending:
                t0 = time.perf_counter()
                entry = (self.engine.index.lookup_entry(q)
                         if self.engine.strategy != "NO-PS" else None)
                tp = time.perf_counter()
                if entry is None:
                    misses.append((i, q, tp - t0))
                elif entry.reg_id in self._registered:
                    hits.setdefault(entry.reg_id, []).append((i, q, entry, tp - t0))
                else:
                    # A hit without a routed registration: single-node serve
                    # and re-register, as ``run`` falls back.
                    out[i] = self.engine.run(q)
                    self._register_new()
            if hits:
                self._serve_hits_batch(list(hits.items()), out)
            if not misses:
                break
            served, pending = admit_misses(self.engine, misses)
            for i, item in served.items():
                out[i] = item
            self._register_new()
        return out  # type: ignore[return-value]

    def _serve_hits_batch(
        self,
        groups: List[Tuple[int, List[Tuple[int, Query, IndexEntry, float]]]],
        out: List[Optional[Tuple[QueryResult, RunInfo]]],
    ) -> None:
        """Serve one wave's index hits routed: all entries, one launch."""
        self._route_retries = 0
        applied, down = self._catch_up_all()
        degraded = self._degraded_set(down)
        serving: List[Tuple[int, List, StackedInstances]] = []
        loop_stats: List[Tuple[Tuple[int, ...], Dict[int, float], float, int]] = []
        for key, members in groups:
            reg = self._registered.get(key)
            bits = self._resolve_bits(key, reg, degraded) if reg is not None else None
            if bits is None:
                # Maintainer lost: single-node serve, re-register after.
                for i, q, _, _ in members:
                    out[i] = self.engine.run(q)
                self._register_new()
                continue
            if not self.fused:
                loop_stats.append(self._serve_key_host_loop(
                    key, reg, bits, members, applied, degraded, out))
                continue
            serving.append((key, members, self._stacked_for(key, reg, bits, degraded)))
        if loop_stats:
            contacted = set().union(*(set(c) for c, _, _, _ in loop_stats))
            per_shard_s: Dict[int, float] = {}
            for _, ps, _, _ in loop_stats:
                for sid, dt in ps.items():
                    per_shard_s[sid] = per_shard_s.get(sid, 0.0) + dt
            self.last_route = RouteInfo(
                contacted=len(contacted), skipped=self.n_shards - len(contacted),
                watermark=self.version, deltas_applied=applied, per_shard_s=per_shard_s,
                t_merge_s=sum(m for _, _, m, _ in loop_stats),
                t_launch_s=sum(per_shard_s.values()), fused=False,
                n_queries=sum(n for _, _, _, n in loop_stats),
                **self._degraded_report(degraded),
            )
        if not serving:
            return

        tl = time.perf_counter()
        if len(serving) == 1:
            st0 = serving[0][2]
            sums, counts = self._launch(st0.vals, st0.gid, st0.weights, st0.g_pad)
        else:
            sums, counts = self._launch(*self._assemble_batch(serving))
        sums_np, counts_np = to_host(sums), to_host(counts)  # the merge point
        tm = time.perf_counter()

        union_contacted: Set[int] = set()
        n_served = 0
        for row, (key, members, st) in enumerate(serving):
            union_contacted.update(st.contacted_ids)
            for i, q, entry, tp in members:
                tq = time.perf_counter()
                res = self._result_from_merged(q, st, sums_np[row], counts_np[row])
                out[i] = (res, RunInfo(
                    reused=True, created=False, attr=self._registered[key].ranges.attr,
                    strategy=self.engine.strategy, selectivity=entry.sketch.selectivity,
                    t_probe=tp, t_execute=time.perf_counter() - tq, repaired=applied > 0,
                    shards_contacted=st.contacted, shards_skipped=self.n_shards - st.contacted,
                    degraded=bool(degraded),
                ))
                n_served += 1
        t1 = time.perf_counter()
        self.last_route = RouteInfo(
            contacted=len(union_contacted), skipped=self.n_shards - len(union_contacted),
            watermark=self.version, deltas_applied=applied, per_shard_s={},
            t_merge_s=t1 - tm, t_launch_s=tm - tl, fused=True, n_queries=n_served,
            **self._degraded_report(degraded),
        )

    def _assemble_batch(self, serving: List[Tuple[int, List, StackedInstances]]):
        """Concatenate several entries' stacks on the query axis, each padded
        to the batch's common (pow2) shard, row and group classes, with
        weight-0 filler rows up to a pow2 query count.  Cached under the
        ordered entry set, guarded by every member's token."""
        catalog = self.engine.catalog
        bkey = ("stacked_batch",) + tuple(key for key, _, _ in serving)
        token = tuple(st.token for _, _, st in serving)
        hit = catalog.get_stacked(bkey, token)
        if hit is not None:
            return hit
        s_pad = max(int(st.vals.shape[1]) for _, _, st in serving)
        r_pad = max(st.r_pad for _, _, st in serving)
        g_pad = max(st.g_pad for _, _, st in serving)
        k_pad = _next_pow2(len(serving))

        def stack(field: str, dtype: torch.dtype) -> torch.Tensor:
            out = torch.zeros((k_pad, s_pad, r_pad), dtype=dtype, device=self.device)
            for row, (_, _, st) in enumerate(serving):
                t = getattr(st, field)[0]
                out[row, :t.shape[0], :t.shape[1]] = t
            return out

        assembled = (stack("vals", torch.float32), stack("gid", torch.int32),
                     stack("weights", torch.float32), g_pad)
        catalog.put_stacked(bkey, token, assembled)
        return assembled

    def _serve_key_host_loop(
        self, key: int, reg: _Registered, bits: np.ndarray,
        members: List[Tuple[int, Query, IndexEntry, float]],
        applied: int, degraded: Set[int],
        out: List[Optional[Tuple[QueryResult, RunInfo]]],
    ) -> Tuple[Tuple[int, ...], Dict[int, float], float, int]:
        """Host-loop batch path: per-shard partials once per entry (they do
        not depend on HAVING), one merge, each member's own tail.  Returns
        (contacted shards, per-shard seconds, merge seconds, queries)."""
        q0 = reg.entry.query
        partials, per_shard_s = self._partials(q0, key, reg, bits, degraded)
        tm = time.perf_counter()
        state = merge_partials_state(tuple(q0.groupby), partials)
        for i, q, entry, tp in members:
            tq = time.perf_counter()
            res = _result_from_state(q, state, self.device)
            out[i] = (res, RunInfo(
                reused=True, created=False, attr=reg.ranges.attr,
                strategy=self.engine.strategy, selectivity=entry.sketch.selectivity,
                t_probe=tp, t_execute=time.perf_counter() - tq, repaired=applied > 0,
                shards_contacted=len(per_shard_s),
                shards_skipped=self.n_shards - len(per_shard_s), degraded=bool(degraded),
            ))
        return tuple(per_shard_s), dict(per_shard_s), time.perf_counter() - tm, len(members)


def merge_partials_state(
    attrs: Tuple[str, ...],
    partials: List[Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray]],
) -> Optional[Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray]]:
    """Re-key per-shard partials by group value into merged state
    ``(group_values, sums, counts)`` (float64), or ``None`` when no shard
    contributed a group.  Independent of HAVING, so one merge serves every
    query behind an entry."""
    if not attrs:
        s = float(sum(p[1].sum() for p in partials))
        c = float(sum(p[2].sum() for p in partials))
        return {}, np.array([s], dtype=np.float64), np.array([c], dtype=np.float64)
    keys, sums, counts = [], [], []
    for gv, s, c in partials:
        if s.shape[0] == 0:
            continue
        keys.append(np.stack([np.asarray(gv[a]) for a in attrs], axis=1))
        sums.append(s.astype(np.float64))
        counts.append(c.astype(np.float64))
    if not keys:
        return None
    uniq, inv = unique_rows(np.concatenate(keys))
    sums_m = np.zeros(uniq.shape[0], dtype=np.float64)
    counts_m = np.zeros(uniq.shape[0], dtype=np.float64)
    np.add.at(sums_m, inv, np.concatenate(sums))
    np.add.at(counts_m, inv, np.concatenate(counts))
    return {a: uniq[:, i] for i, a in enumerate(attrs)}, sums_m, counts_m


def _empty_result(q: Query) -> QueryResult:
    return QueryResult(
        group_values={a: np.empty(0) for a in (q.outer_groupby or q.groupby)},
        values=np.empty(0))


def _result_from_state(
    q: Query,
    state: Optional[Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray]],
    device: torch.device,
) -> QueryResult:
    """Finish one query from merged group state: inside the integral
    envelope the float32 cast in ``_finalize`` reproduces the single-node
    kernel's per-group values bit for bit."""
    if state is None:
        return _empty_result(q)
    group_values, sums_m, counts_m = state
    agg = _finalize(q.agg.fn, sums_m, counts_m)
    return result_from_group_state(q, group_values, agg, counts_m > 0, device)


def _merge_partials(
    q: Query,
    partials: List[Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray]],
    device: torch.device,
) -> QueryResult:
    """Merge per-shard partials into one query's final result."""
    return _result_from_state(q, merge_partials_state(tuple(q.groupby), partials), device)


def _finalize(fn: str, sums: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """float32 finalization, as the executor's kernel arithmetic."""
    sums32 = sums.astype(np.float32)
    counts32 = counts.astype(np.float32)
    if fn == "count":
        return counts32
    if fn == "sum":
        return sums32
    if fn == "avg":
        return sums32 / np.maximum(counts32, np.float32(1.0))
    raise ValueError(f"unknown aggregate {fn!r}")
