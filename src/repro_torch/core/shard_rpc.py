"""Shard clients, the shard server and its process pool (port of
``repro/core/shard_rpc.py``).

``ShardedEngine`` talks to every shard through a client, and two backends
share one op surface and one failure vocabulary (an RPC timeout or a dead
connection is a ``ShardUnavailableError``, a full inbox a
``BackpressureError``), so the health machine, ``rebalance`` and degraded
routing run unchanged over either:

* :class:`LoopbackShardClient` wraps an in-process ``FragmentShard``.
* :class:`SubprocessShardClient` talks to a ``FragmentShard`` in a separate
  OS process over a unix socket (``repro_torch.runtime.transport``).  Faults
  are real mechanisms: ``kill`` is a SIGKILL of the server, ``partition`` a
  client-side socket drop, ``stall`` a server-side sleep per op, ``flaky``
  server-injected error responses.

:class:`ShardServer` is the server loop (``serve``/``main``).  It is told
its device as a string (``"cuda:0"``, ``"cpu"``), resolves it with
``repro_torch.device.resolve_device`` (which raises without a GPU, so a
server never picks the CPU on its own) and moves everything it keeps onto
it: tables arrive as CPU tensors.  Its kernels load from the build
directory; the first build on a machine takes a lock, so servers that
start together compile once.

Checkpoints cross the boundary differently per backend
(:class:`ShardCheckpoint`): loopback keeps a reference to the shard's
immutable local table; the subprocess backend references the coordinator's
table at the watermark and rebuilds the shard server-side from it, then
replays the delta log and re-registers maintainers, never re-captures.
Subprocess shards also mirror each other's local tables (``peer_put``,
``peer_ship``), so a killed server recovers from its peer's mirror.

The warm read path stays at about one RPC a shard a read: ``catch_up``
responses piggyback the shard's state token, maintainer keys, dimension
tokens and maintained sketch bits, which the client caches until its own
next state-changing op.
"""
from __future__ import annotations

import atexit
import dataclasses
import itertools
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Mapping, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core.maintenance import MaintenanceError
from repro_torch.core.queries import Query, inner_block_arrays
from repro_torch.core.ranges import RangeSet
from repro_torch.core.shard import (
    BackpressureError,
    FragmentShard,
    ShardPlan,
    ShardUnavailableError,
    StaleEpochError,
)
from repro_torch.core.table import ColumnTable
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.parallel.placement import place_table
from repro_torch.runtime import transport
from repro_torch.runtime.guards import LAUNCH_COUNTS, hot_path

# ---------------------------------------------------------------------------
# Shared client-side value types
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardCheckpoint:
    """One shard's recovery point.

    ``kind == "local"``: ``table`` is the shard's own immutable local table
    (loopback; adopting it is free).  ``kind == "coord"``: ``table`` is the
    coordinator's clustered table at the checkpoint watermark, from which
    recovery rebuilds the shard server-side (the subprocess backend: the
    coordinator cannot cheaply read a remote shard's table, but it can cut
    it again).
    """

    kind: str  # "local" | "coord"
    table: ColumnTable
    version: int


@dataclasses.dataclass(frozen=True)
class _EncView:
    """Client-side stand-in for ``catalog.GroupEncoding`` built from a
    server's ``block_arrays`` response (the fields the stacked layout
    reads)."""

    n_groups: int
    group_values: Dict[str, np.ndarray]
    gid_dev: torch.Tensor


#: Server exception type name -> local class, so RPC errors re-raise as the
#: types the serving layer's retry and health logic dispatch on.
_ERROR_TYPES = {
    "ShardUnavailableError": ShardUnavailableError,
    "BackpressureError": BackpressureError,
    "MaintenanceError": MaintenanceError,
    "StaleEpochError": StaleEpochError,
    "ValueError": ValueError,
    "KeyError": KeyError,
    "RuntimeError": RuntimeError,
}


def _raise_remote(resp: dict) -> None:
    etype, msg = resp.get("etype", "RuntimeError"), resp.get("msg", "")
    cls = _ERROR_TYPES.get(etype)
    if cls is None:
        raise transport.RemoteError(etype, msg)
    raise cls(msg)


# ---------------------------------------------------------------------------
# Loopback client (in-process)
# ---------------------------------------------------------------------------


class LoopbackShardClient:
    """In-process client: wraps a ``FragmentShard`` directly.

    Everything not defined here goes to the wrapped shard (``inject``,
    ``heal``, ``reachable``, and the state callers read: ``maintainers``,
    ``table``, ``lag``, ``version``).
    """

    backend = "loopback"

    def __init__(self, shard: FragmentShard):
        self._shard = shard
        # This client's coordinator epoch, stamped on every fenced op; the
        # owning ``ShardedEngine`` sets it.  A takeover wraps the same shard
        # in a new client with the bumped epoch, after which this client's
        # ops are fenced out.
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

    def clone_for_takeover(self) -> "LoopbackShardClient":
        """A fresh client over the same live shard for a takeover
        coordinator: the shard's state (table, maintainers, epoch) stays
        put; only the client is new."""
        return LoopbackShardClient(self._shard)

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
        table and version are what a remote shard checkpoints from)."""
        t = self._shard.table
        return ShardCheckpoint(kind="local", table=t, version=t.version)

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


# ---------------------------------------------------------------------------
# Server process pool
# ---------------------------------------------------------------------------

_SPAWN_TIMEOUT_S = 60.0
_sock_counter = itertools.count(1)
_sock_dir: Optional[str] = None


def _socket_dir() -> str:
    global _sock_dir
    if _sock_dir is None:
        _sock_dir = tempfile.mkdtemp(prefix="repro-torch-shards-")
    return _sock_dir


def _spawn_env() -> Dict[str, str]:
    """The child's environment: this one, with the port's source directory
    first on ``PYTHONPATH`` so ``repro_torch`` imports from this tree."""
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


class _ServerProc:
    """One shard server subprocess and its RPC connection."""

    def __init__(self, proc: subprocess.Popen, path: str):
        self.proc = proc
        self.path = path
        self.conn: Optional[socket.socket] = None
        self._seq = itertools.count(1)

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None

    def connect(self, deadline_s: float = _SPAWN_TIMEOUT_S) -> None:
        """(Re)connect to the server's socket, waiting out the child's
        interpreter and ``torch`` start-up on first contact."""
        self.drop_conn()
        t_end = time.perf_counter() + deadline_s
        last: Optional[Exception] = None
        while time.perf_counter() < t_end:
            if not self.alive:
                raise ShardUnavailableError(
                    f"shard server {self.proc.pid} exited (rc={self.proc.poll()})")
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.settimeout(1.0)
            try:
                s.connect(self.path)
                self.conn = s
                return
            except (FileNotFoundError, ConnectionRefusedError, socket.timeout, OSError) as e:
                last = e
                s.close()
                time.sleep(0.02)
        raise ShardUnavailableError(f"could not connect to shard server at {self.path}: {last}")

    def drop_conn(self) -> None:
        if self.conn is not None:
            try:
                self.conn.close()
            except OSError:
                pass
            self.conn = None

    def request(self, payload: dict, deadline_s: float) -> dict:
        """One request/response exchange.  Transport failures surface as
        ``ShardUnavailableError``, the serving layer's retryable class,
        after dropping the (now desynced) connection."""
        if self.conn is None:
            self.connect(deadline_s=max(deadline_s, 10.0))
        seq = next(self._seq)
        try:
            transport.send_msg(self.conn, payload, seq, deadline_s=deadline_s)
            rseq, resp = transport.recv_msg(self.conn, deadline_s=deadline_s)
        except transport.RpcTimeout as e:
            self.drop_conn()
            raise ShardUnavailableError(f"rpc {payload.get('op')} timed out: {e}") from e
        except (transport.RpcClosed, transport.FrameError, OSError) as e:
            self.drop_conn()
            raise ShardUnavailableError(f"rpc {payload.get('op')} connection lost: {e}") from e
        if rseq != seq:
            self.drop_conn()
            raise ShardUnavailableError(f"rpc desync (sent seq {seq}, got {rseq})")
        return resp

    def kill(self) -> None:
        try:
            self.proc.kill()
        except OSError:
            pass
        self.drop_conn()
        try:
            self.proc.wait(timeout=5.0)
        except Exception:
            pass


class ServerPool:
    """Reusable shard-server subprocesses.

    Spawning a server pays the child's interpreter and ``torch`` import
    (seconds, and on a GPU a CUDA context at its first build), so the pool
    keeps stateless warm servers (a ``reset`` op drops the shard between
    tenants but keeps the process, its context and its loaded kernels) and
    tops up a small spare set (``REPRO_SHARD_SPARES``, default 2) in the
    background, so a respawn after a kill usually pops a warm process.

    Orphan safety is layered: every spawned pid is tracked and SIGKILLed
    ``atexit``, and each child watches its stdin pipe and exits the moment
    the parent dies (EOF).
    """

    def __init__(self, spares: Optional[int] = None):
        self._lock = threading.Lock()
        self._spares: List[_ServerProc] = []
        self._all: Set[_ServerProc] = set()
        self._target = (int(os.environ.get("REPRO_SHARD_SPARES", "2"))
                        if spares is None else spares)
        self._filling = False
        self._closed = False

    def _spawn(self) -> _ServerProc:
        # Checked twice: before paying the Popen, and again before tracking
        # the child, so a close_pool() racing this spawn (atexit against
        # the background top-up thread) never leaves an untracked orphan.
        with self._lock:
            if self._closed:
                raise ShardUnavailableError("server pool is closed")
        path = os.path.join(_socket_dir(), f"s{next(_sock_counter)}.sock")
        # ``-c`` and not ``-m``: run as ``__main__`` the module would be
        # imported twice in the child.
        proc = subprocess.Popen(
            [sys.executable, "-c",
             "import sys; from repro_torch.core.shard_rpc import main; main(sys.argv[1:])", path],
            stdin=subprocess.PIPE, stdout=subprocess.DEVNULL, start_new_session=True,
            env=_spawn_env())
        sp = _ServerProc(proc, path)
        with self._lock:
            if not self._closed:
                self._all.add(sp)
                return sp
        sp.kill()
        raise ShardUnavailableError("server pool closed mid-spawn")

    def acquire(self) -> _ServerProc:
        with self._lock:
            sp = self._spares.pop() if self._spares else None
        while sp is not None and not sp.alive:
            with self._lock:
                self._all.discard(sp)
                sp = self._spares.pop() if self._spares else None
        if sp is None:
            sp = self._spawn()
        self._top_up_async()
        return sp

    def release(self, sp: _ServerProc) -> None:
        """Return a server to the spare set (after a state reset), or reap
        it if it is no longer serviceable."""
        if not sp.alive:
            self.discard(sp)
            return
        try:
            resp = sp.request({"op": "reset", "args": (), "ctl": True}, deadline_s=10.0)
            if not resp.get("ok"):
                raise ShardUnavailableError("reset refused")
        except ShardUnavailableError:
            self.discard(sp)
            return
        with self._lock:
            self._spares.append(sp)

    def discard(self, sp: _ServerProc) -> None:
        sp.kill()
        with self._lock:
            self._all.discard(sp)
            if sp in self._spares:
                self._spares.remove(sp)

    def prewarm(self, n: int) -> None:
        """Grow the spare set to ``n`` now (the children start in parallel)."""
        need = []
        with self._lock:
            cur = len(self._spares)
        for _ in range(max(0, n - cur)):
            need.append(self._spawn())
        with self._lock:
            self._spares.extend(need)

    def _top_up_async(self) -> None:
        with self._lock:
            if self._filling or len(self._spares) >= self._target:
                return
            self._filling = True

        def fill():
            try:
                while True:
                    with self._lock:
                        if self._closed or len(self._spares) >= self._target:
                            return
                    try:
                        sp = self._spawn()
                    except ShardUnavailableError:
                        return  # pool closed mid-fill
                    with self._lock:
                        if self._closed:
                            break
                        self._spares.append(sp)
                sp.kill()
            finally:
                with self._lock:
                    self._filling = False

        threading.Thread(target=fill, daemon=True).start()

    def _drain(self) -> List[_ServerProc]:
        with self._lock:
            self._closed = True
            procs = list(self._all)
            self._all.clear()
            self._spares.clear()
        return procs

    def shutdown_all(self) -> None:
        """Kill every pooled server, then reopen for the next tenant.  The
        closed window makes this race-free against the background top-up:
        a spawn landing mid-shutdown is killed, not leaked."""
        for sp in self._drain():
            sp.kill()
        with self._lock:
            self._closed = False

    # ``close_pool`` (not ``close``): the hot-path analyzer links calls by
    # name, and would alias socket ``close()`` calls in the RPC hot path
    # onto this teardown (which reaches ``Popen.wait``).
    def close_pool(self) -> None:
        """Terminal shutdown (atexit): kill everything and stay closed, so
        no late spawn of the top-up thread outlives the coordinator."""
        for sp in self._drain():
            sp.kill()


#: Process-wide pool; ``atexit`` makes sure no shard server outlives the
#: coordinator's process.
POOL = ServerPool()
atexit.register(POOL.close_pool)


# ---------------------------------------------------------------------------
# Subprocess client
# ---------------------------------------------------------------------------


class SubprocessShardClient:
    """Coordinator-side handle of a shard living in its own OS process.

    Failure semantics are real: ``kill`` SIGKILLs the server (``heal``
    takes an empty one from the pool, whose state stays lost until the
    coordinator recovers it), ``partition`` drops the socket client-side
    with the server's state intact, ``stall`` makes the server sleep per op
    (past the RPC deadline it is a timeout), ``flaky`` makes the server fail
    the next N ops with marshalled errors that go through the retries.

    ``device`` names the server's device (``"cuda:0"``, ``"cpu"``; ``None``
    is CUDA): the coordinator's tensors cross as CPU tensors, and the server
    moves what it keeps there.
    """

    backend = "subprocess"

    def __init__(
        self,
        shard_id: int,
        plan: ShardPlan,
        ranges: RangeSet,
        clustered: ColumnTable,
        dims: Mapping[str, ColumnTable],
        inbox_cap: Optional[int] = None,
        version: int = 0,
        op_deadline_s: float = 5.0,
        pool: Optional[ServerPool] = None,
        device: DeviceLike = None,
    ):
        self.shard_id = shard_id
        self._pool = pool or POOL
        self._inbox_cap = inbox_cap
        self.device = "cuda" if device is None else str(device)
        # RPC deadline: past the engine's op deadline, so a mild stall
        # completes slowly (straggler semantics, as loopback) while a hard
        # stall still times out into ShardUnavailableError.
        self._deadline_s = max(op_deadline_s * 2.0, op_deadline_s + 1.0)
        # A build ships a table and, on a fresh server, pays its CUDA
        # context and kernel loads.
        self._build_deadline_s = max(120.0, self._deadline_s)
        self._proc: Optional[_ServerProc] = self._pool.acquire()
        self._fault: Optional[str] = None  # None|"dead"|"partition"|"stall"
        self._state_lost = True
        self._version = -1
        self._lag = 0
        self._bp = 0
        self._token: Optional[Tuple[int, int]] = None
        self._mkeys: Set[int] = set()
        self._bits: Optional[Dict[int, np.ndarray]] = None
        self._dims: Dict[str, Tuple[int, int]] = {}
        self._pending_unregister: Set[int] = set()
        # Coordinator epoch stamped on every non-control request; the server
        # fences ops behind the newest epoch it has seen (the owning
        # ``ShardedEngine`` sets it; 0 only during this first build).
        self.epoch = 0
        self._build(plan, ranges, clustered, dims, version)

    # -- plumbing --------------------------------------------------------------
    def _absorb_meta(self, meta: Optional[dict]) -> None:
        if not meta:
            return
        self._version = meta["version"]
        self._lag = meta["lag"]
        self._bp = meta["bp"]
        self._token = meta["token"]
        self._mkeys = set(meta["mkeys"])
        self._dims = dict(meta["dims"])
        if "bits" in meta:
            self._bits = meta["bits"]

    def _request(self, op: str, args: tuple, ctl: bool = False,
                 deadline_s: Optional[float] = None):
        if not ctl and self._fault == "partition":
            raise ShardUnavailableError(f"shard {self.shard_id} is partition ({op})")
        if self._proc is None:
            raise ShardUnavailableError(f"shard {self.shard_id} is dead ({op})")
        resp = self._proc.request(
            {"op": op, "args": args, "ctl": ctl, "epoch": self.epoch},
            deadline_s=self._deadline_s if deadline_s is None else deadline_s)
        self._absorb_meta(resp.get("meta"))
        if not resp.get("ok"):
            _raise_remote(resp)
        return resp.get("value")

    def _build(self, plan: ShardPlan, ranges: RangeSet, clustered: ColumnTable,
               dims: Mapping[str, ColumnTable], version: int) -> None:
        # Collapsed before shipping: the wire carries one table's columns,
        # not its whole delta chain.
        self._request(
            "build",
            (self.shard_id, plan.owner, plan.n_shards, ranges, clustered.collapse(),
             {k: v.collapse() for k, v in dims.items()}, self._inbox_cap, version,
             self.device),
            deadline_s=self._build_deadline_s)
        self._state_lost = False
        self._bits = self._bits if self._bits is not None else {}

    def _flush_unregisters(self) -> None:
        if not self._pending_unregister:
            return
        keys = tuple(self._pending_unregister)
        try:
            self._request("unregister_many", (keys,), ctl=True)
            self._pending_unregister.clear()
        except ShardUnavailableError:
            pass  # still unreachable; retried on a later op

    # -- fault injection (chaos surface) ---------------------------------------
    def inject(self, kind: str, arg=None) -> None:
        """Real-mechanism fault injection (see the class docstring)."""
        if kind == "kill":
            if self._proc is not None:
                self._pool.discard(self._proc)
                self._proc = None
            self._fault = "dead"
            self._state_lost = True
            self._version = -1
            self._lag = 0
            self._token = None
            self._mkeys = set()
            self._bits = None
            self._dims = {}
            self._pending_unregister.clear()
        elif kind == "stall":
            s = float(arg) if arg is not None else 0.02
            self._request("set_stall", (s,), ctl=True)
            self._fault = "stall"
        elif kind == "partition":
            self._fault = "partition"
            if self._proc is not None:
                self._proc.drop_conn()
        elif kind == "flaky":
            self._request("set_flaky", (int(arg) if arg is not None else 1,), ctl=True)
        else:
            raise ValueError(f"unknown fault kind {kind!r}")

    def heal(self) -> None:
        """Clear the fault.  After a kill this takes a fresh, empty server
        from the pool: reachable again, its state lost until the
        coordinator recovers it."""
        if self._proc is None or not self._proc.alive:
            if self._proc is not None:
                self._pool.discard(self._proc)
            self._proc = self._pool.acquire()
            self._state_lost = True
            self._version = -1
            self._token = None
            self._mkeys = set()
            self._bits = None
            self._dims = {}
        elif self._fault == "stall" or self._fault is None:
            try:
                self._request("clear_faults", (), ctl=True)
            except ShardUnavailableError:
                pass
        self._fault = None

    @property
    def reachable(self) -> bool:
        return self._fault not in ("dead", "partition")

    # -- replication -----------------------------------------------------------
    @property
    def version(self) -> int:
        return -1 if self._state_lost else self._version

    @property
    def lag(self) -> int:
        return self._lag

    @property
    def backpressure_hits(self) -> int:
        return self._bp

    @property
    def inbox_cap(self) -> Optional[int]:
        return self._inbox_cap

    def ship(self, version: int, kind: str, payload) -> None:
        self._request("ship", (version, kind, payload))

    def catch_up(self, watermark: int) -> int:
        self._flush_unregisters()
        return self._request("catch_up", (watermark,))

    def update_dim(self, table: ColumnTable) -> None:
        self._request("update_dim", (table.collapse(),))

    def dim_token(self, name: str) -> Optional[Tuple[int, int]]:
        return self._dims.get(name)

    # -- sketch registration ---------------------------------------------------
    def register(self, key: int, q: Query, ranges: RangeSet) -> None:
        self._flush_unregisters()
        self._request("register", (key, q, ranges))

    def unregister(self, key: int) -> None:
        # Best effort, like the loopback's (whose unregister has no fault
        # guard): an unreachable shard's stale maintainer is queued and
        # flushed before the next register/catch_up, so a recycled entry id
        # never aliases onto it.
        self._mkeys.discard(key)
        if self._bits is not None:
            self._bits.pop(key, None)
        try:
            self._request("unregister_many", ((key,),), ctl=True)
        except ShardUnavailableError:
            self._pending_unregister.add(key)

    def has_maintainer(self, key: int) -> bool:
        return key in self._mkeys

    def bits_for(self, key: int) -> Optional[np.ndarray]:
        if self._fault in ("dead", "partition"):
            raise ShardUnavailableError(f"shard {self.shard_id} is {self._fault} (bits_for)")
        if self._state_lost:
            raise ShardUnavailableError(f"shard {self.shard_id} lost its state (bits_for)")
        if self._bits is not None:
            # Piggybacked on the last catch_up/register response; every
            # bit-changing op goes through this client, so the cache is
            # exact and the warm read path pays no extra round trip here.
            return self._bits.get(key)
        return self._request("bits_for", (key,))

    # -- query serving ---------------------------------------------------------
    @hot_path
    def partial(self, q: Query, key: int, ranges: RangeSet,
                bits: np.ndarray) -> Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray]:
        return self._request("partial", (q, key, ranges, np.asarray(bits)))

    @hot_path
    def block_arrays(self, key: int, ranges: RangeSet, bits: np.ndarray, q: Query):
        """The server's inner-block arrays as CPU tensors (the server's copy
        to the host is the route's sync point; the caller stacks them on
        its device)."""
        n_groups, group_values, gid, where, vals = self._request(
            "block_arrays", (key, ranges, np.asarray(bits), q))
        return _EncView(n_groups=n_groups, group_values=group_values, gid_dev=gid), where, vals

    # -- state identity / recovery ---------------------------------------------
    def state_token(self) -> Optional[Tuple[int, int]]:
        return None if self._state_lost else self._token

    @property
    def state_lost(self) -> bool:
        return self._state_lost

    def make_checkpoint(self, coord_table: ColumnTable, coord_version: int) -> ShardCheckpoint:
        # No RPC: the coordinator's clustered table is immutable, so a
        # reference to it at the checkpoint watermark is a consistent
        # snapshot the shard can be rebuilt from.
        return ShardCheckpoint(kind="coord", table=coord_table.collapse(), version=coord_version)

    def restore_checkpoint(self, ckpt: ShardCheckpoint, dims: Mapping[str, ColumnTable],
                           plan: ShardPlan, ranges: RangeSet) -> None:
        self._build(plan, ranges, ckpt.table, dims, ckpt.version)

    def rebuild(self, plan: ShardPlan, ranges: RangeSet, clustered: ColumnTable,
                dims: Mapping[str, ColumnTable], device, inbox_cap: Optional[int],
                version: int) -> None:
        self._inbox_cap = inbox_cap
        if device is not None:
            self.device = str(device)
        self._build(plan, ranges, clustered, dims, version)

    # -- peer-mirrored checkpoints ---------------------------------------------
    def peer_put(self, sid: int, local: ColumnTable, plan_token: int) -> None:
        """Seed this server with a mirror of peer shard ``sid``'s local
        table (a full ship, only at seed or re-seed; deltas keep it
        current)."""
        self._request("ckpt_put", (sid, local.collapse(), plan_token),
                      deadline_s=self._build_deadline_s)

    def peer_ship(self, sid: int, version: int, kind: str, payload) -> bool:
        """Apply one delta to the mirror of shard ``sid``; False when the
        mirror is missing or the delta would leave a version gap (the
        server drops the mirror: a gapped mirror is useless)."""
        return bool(self._request("ckpt_ship", (sid, version, kind, payload)))

    def peer_fetch(self, sid: int, plan_token: int) -> Optional[Tuple[ColumnTable, int]]:
        """Fetch the mirror of shard ``sid``; None when absent or seeded
        under another placement plan."""
        return self._request("ckpt_get", (sid, plan_token), deadline_s=self._build_deadline_s)

    def build_local(self, plan: ShardPlan, ranges: RangeSet, local: ColumnTable,
                    dims: Mapping[str, ColumnTable], inbox_cap: Optional[int]) -> None:
        """Rebuild this shard from an already-local table (recovery from a
        peer's mirror): no cut of the coordinator's table, no reship of it."""
        self._inbox_cap = inbox_cap
        self._request(
            "build_local",
            (self.shard_id, plan.owner, plan.n_shards, ranges, local.collapse(),
             {k: v.collapse() for k, v in dims.items()}, inbox_cap, self.device),
            deadline_s=self._build_deadline_s)
        self._state_lost = False
        self._bits = self._bits if self._bits is not None else {}
        self._fault = None

    def clone_for_takeover(self) -> "SubprocessShardClient":
        """A fresh client over the same live server socket for a takeover
        coordinator.  No shard state moves: the new client learns the
        server's state in one control round trip (whose meta carries the
        version, maintainer keys and dimension tokens); the bit cache
        refills on the first catch_up."""
        c = object.__new__(SubprocessShardClient)
        c.shard_id = self.shard_id
        c._pool = self._pool
        c._inbox_cap = self._inbox_cap
        c.device = self.device
        c._deadline_s = self._deadline_s
        c._build_deadline_s = self._build_deadline_s
        c._proc = self._proc
        c._fault = self._fault if self._fault in ("dead",) else None
        c._state_lost = True
        c._version = -1
        c._lag = 0
        c._bp = 0
        c._token = None
        c._mkeys = set()
        c._bits = None
        c._dims = {}
        c._pending_unregister = set()
        c.epoch = 0  # the owning engine stamps the real epoch after attach
        if c._proc is not None:
            try:
                token = c._request("state_token", (), ctl=True)
                c._state_lost = token is None
            except ShardUnavailableError:
                c._state_lost = True
        return c

    def launch_counts(self) -> dict:
        """The server's pid, its device and its ``LAUNCH_COUNTS`` (a
        diagnostic of the port: it shows kernels ran in the server)."""
        return self._request("launch_counts", (), ctl=True)

    def close_client(self) -> None:
        """Release the server back to the warm pool (or reap it)."""
        proc, self._proc = self._proc, None
        if proc is not None:
            if self._fault in ("dead",) or not proc.alive:
                self._pool.discard(proc)
            else:
                self._pool.release(proc)
        self._fault = "dead"
        self._state_lost = True

    @property
    def pid(self) -> Optional[int]:
        """The server's process id (None after a kill)."""
        return self._proc.proc.pid if self._proc is not None else None


# ---------------------------------------------------------------------------
# Server side
# ---------------------------------------------------------------------------

#: Kernels a shard server launches (instances, partials); loaded at build.
SERVER_KERNELS = ("sketch_filter", "segment_aggregate")


class ShardServer:
    """One shard's server loop state: the ``FragmentShard`` plus the
    server-side halves of fault injection (stall = sleep per data op,
    flaky = fail the next N data ops)."""

    #: ops exempt from stall/flaky (fault control, lifecycle, diagnostics,
    #: and unregister, whose loopback counterpart has no fault guard).
    CTL_OPS = ("ping", "set_stall", "set_flaky", "clear_faults", "reset", "shutdown",
               "unregister_many", "state_token", "launch_counts")

    def __init__(self):
        self.shard: Optional[FragmentShard] = None
        self.device: Optional[torch.device] = None
        self.stall_s = 0.0
        self.flaky_fails = 0
        self.closed = False
        # Highest coordinator epoch seen on a non-control op: process
        # identity, not shard state, so it survives shard rebuilds; zeroed
        # only by ``reset`` (a new tenant's epoch space).
        self.epoch = 0
        # Peer-mirrored checkpoints: sid -> (mirror table, plan token), kept
        # current by ``ckpt_ship``; recovery pulls shard-local state from
        # here instead of reshipping the coordinator's table.
        self.peer_ckpts: Dict[int, Tuple[ColumnTable, int]] = {}

    # -- dispatch --------------------------------------------------------------
    def handle(self, msg: dict) -> dict:
        op = msg.get("op", "")
        args = msg.get("args", ())
        try:
            if op not in self.CTL_OPS:
                if self.stall_s > 0:
                    time.sleep(self.stall_s)
                if self.flaky_fails > 0:
                    self.flaky_fails -= 1
                    raise ShardUnavailableError(f"shard dropped {op} (flaky)")
                # Epoch fence AFTER the fault simulation (a stalled zombie op
                # must still be rejected, not served): a monotone max, so a
                # newer coordinator's first op fences every older one out.
                epoch = int(msg.get("epoch", 0))
                if epoch < self.epoch:
                    raise StaleEpochError(
                        f"coordinator epoch {epoch} is fenced behind {self.epoch} ({op})")
                self.epoch = epoch
            value = self._dispatch(op, args)
            return {"ok": True, "value": value, "meta": self._meta(op)}
        except Exception as e:  # marshalled; the client re-raises by type
            return {"ok": False, "etype": type(e).__name__, "msg": str(e),
                    "meta": self._meta(op)}

    def _meta(self, op: str) -> dict:
        s = self.shard
        if s is None or s.table is None:
            return {"version": -1, "lag": 0, "bp": 0, "token": None, "mkeys": (), "dims": {},
                    "bits": {}}
        meta = {
            "version": s.version,
            "lag": s.lag,
            "bp": s.backpressure_hits,
            "token": (s.table.uid, s.table.version),
            "mkeys": tuple(s.maintainers.keys()),
            "dims": {k: (v.uid, v.version) for k, v in s.dims.items()},
        }
        if op in ("build", "catch_up", "register", "update_dim"):
            # The only ops after which maintained bits can differ from the
            # client's cache: piggyback the fresh bits, so the warm read path
            # never pays a separate bits_for round trip.
            meta["bits"] = {key: np.asarray(m.bits()) for key, m in s.maintainers.items()}
        return meta

    def _require_shard(self) -> FragmentShard:
        if self.shard is None:
            raise ShardUnavailableError("server has no shard state (build first)")
        return self.shard

    def _set_device(self, name: str) -> torch.device:
        self.device = _pick_device(name)
        return self.device

    def _dispatch(self, op: str, args: tuple):
        if op == "ping":
            return "pong"
        if op == "set_stall":
            self.stall_s = float(args[0])
            return None
        if op == "set_flaky":
            self.flaky_fails = int(args[0])
            return None
        if op == "clear_faults":
            self.stall_s = 0.0
            self.flaky_fails = 0
            return None
        if op == "reset":
            self.shard = None
            self.stall_s = 0.0
            self.flaky_fails = 0
            self.epoch = 0
            self.peer_ckpts = {}
            return None
        if op == "shutdown":
            self.closed = True
            return None
        if op == "launch_counts":
            return {"pid": os.getpid(), "device": None if self.device is None else str(self.device),
                    "launch_counts": dict(LAUNCH_COUNTS)}
        if op == "build":
            (shard_id, owner, n_shards, ranges, clustered, dims, inbox_cap, version,
             device) = args
            plan = ShardPlan(n_shards=n_shards, owner=np.asarray(owner))
            self.shard = FragmentShard(shard_id, plan, ranges, clustered, dims,
                                       self._set_device(device), inbox_cap=inbox_cap,
                                       version=version)
            _load_kernels(self.device)
            return None
        if op == "unregister_many":
            if self.shard is not None:
                for key in args[0]:
                    self.shard.unregister(key)
            return None
        if op == "state_token":
            s = self.shard
            return None if s is None or s.table is None else (s.table.uid, s.table.version)
        if op == "ckpt_put":
            sid, table, token = args
            self.peer_ckpts[int(sid)] = (place_table(table, self.device), token)
            return None
        if op == "ckpt_ship":
            sid, version, kind, payload = args
            ent = self.peer_ckpts.get(int(sid))
            if ent is None:
                return False
            table, token = ent
            if version <= table.version:
                return True  # duplicate re-ship: idempotent skip
            if version > table.version + 1:
                # Version gap (an earlier delta never landed): a gapped
                # mirror can never be made current again; drop it so the
                # coordinator re-seeds instead of recovering stale state.
                self.peer_ckpts.pop(int(sid), None)
                return False
            table = table.append(payload) if kind == "append" else table.delete(payload)
            # Collapsed: a mirror holds no chain of earlier versions' columns.
            self.peer_ckpts[int(sid)] = (table.collapse(), token)
            return True
        if op == "ckpt_get":
            sid, token = args
            ent = self.peer_ckpts.get(int(sid))
            if ent is None or ent[1] != token:
                # Absent, or seeded under another placement plan: a mirror
                # gathered under the old owner map is never adopted after a
                # rebalance.
                return None
            return ent[0].collapse(), ent[0].version
        if op == "build_local":
            shard_id, owner, n_shards, ranges, local, dims, inbox_cap, device = args
            plan = ShardPlan(n_shards=n_shards, owner=np.asarray(owner))
            self.shard = FragmentShard.from_local(
                shard_id, plan, ranges, local, dims, device=self._set_device(device),
                inbox_cap=inbox_cap)
            _load_kernels(self.device)
            return None
        shard = self._require_shard()
        if op == "ship":
            version, kind, payload = args
            shard.ship(version, kind, payload)
            return None
        if op == "catch_up":
            return shard.catch_up(int(args[0]))
        if op == "register":
            key, q, ranges = args
            shard.register(key, q, ranges)
            return None
        if op == "bits_for":
            return shard.bits_for(args[0])
        if op == "partial":
            q, key, ranges, bits = args
            return shard.partial(q, key, ranges, bits)
        if op == "block_arrays":
            key, ranges, bits, q = args
            enc, where, vals = inner_block_arrays(q, shard.joined_instance(q, key, ranges, bits),
                                                  shard.catalog)
            return int(enc.n_groups), dict(enc.group_values), enc.gid_dev, where, vals
        if op == "update_dim":
            shard.update_dim(args[0])
            return None
        raise ValueError(f"unknown rpc op {op!r}")


def _pick_device(name: str) -> torch.device:
    """The server's device for its shard's columns.  Devices do not cross
    processes, so the coordinator sends a name and the server resolves it
    (``resolve_device`` raises when a GPU is named and none exists: never a
    quiet fall back to the CPU).  A bare ``"cuda"`` takes the current
    device's index, so the server reports the card it runs on."""
    dev = resolve_device(name)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _load_kernels(device: torch.device) -> None:
    """Load the server's kernels at build time (inside the build's
    deadline, not the first data op's)."""
    if device.type != "cuda":
        return
    from repro_torch.kernels import build

    for name in SERVER_KERNELS:
        build.library(name)


def _stdin_watchdog() -> None:
    """Exit the moment the parent dies: the coordinator holds our stdin
    pipe, so EOF means the parent is gone."""
    try:
        while True:
            if not sys.stdin.buffer.read(4096):
                break
    except Exception:
        pass
    os._exit(2)


def serve(path: str) -> None:
    """The server process: bind, accept one connection at a time, serve
    request/response until shutdown.  A broken connection (a client timed
    out mid-stall and reconnected, a coordinator dropped a partition) just
    re-enters accept: shard state survives across connections."""
    threading.Thread(target=_stdin_watchdog, daemon=True).start()
    transport.limits_from_env()

    # Disjoint uid space: tables made in this process (local shard tables,
    # instances) must never collide with the coordinator's uids arriving
    # over the wire, or per-uid catalog caches would alias.
    from repro_torch.core import table as table_mod

    table_mod._TABLE_UIDS = itertools.count(((os.getpid() & 0xFFFFF) << 40) | 1)

    srv = ShardServer()
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.bind(path)
    sock.listen(4)
    while not srv.closed:
        conn, _ = sock.accept()
        try:
            while not srv.closed:
                seq, msg = transport.recv_msg(conn, deadline_s=None)
                resp = srv.handle(msg)
                transport.send_msg(conn, resp, seq)
        except (transport.RpcClosed, transport.FrameError, OSError):
            pass  # connection over; accept the next one
        finally:
            try:
                conn.close()
            except OSError:
                pass
    os._exit(0)


def main(argv: Optional[List[str]] = None) -> None:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print("usage: python -c 'from repro_torch.core.shard_rpc import main; main()' "
              "<socket-path>", file=sys.stderr)
        raise SystemExit(2)
    serve(args[0])
