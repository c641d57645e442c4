"""Coordinator metadata replication: the stream a warm standby adopts (port
of ``repro/core/replication.py``).

The coordinator (``repro_torch.core.shard.ShardedEngine``) alone holds what
a ``selection_state()`` snapshot does not: the clustered table's lineage,
the per-shard delta logs and checkpoint watermarks, the sketch index's
registrations and the fragment placement.  Without a replica one
coordinator death loses all of it, and every sketch would be captured
again.

Every metadata mutation of the coordinator streams as a sequenced
:class:`ReplicationRecord` to a replica, which folds the stream into a
:class:`MetadataStore`: what a standby needs to call
``ShardedEngine.from_replica`` and serve on.

* ``bootstrap``: the full base state (clustered table, dims, ranges,
  placement, construction arguments, delta logs, the coordinator's
  device), at ``attach_replica`` and again when a promoted coordinator
  re-arms its own standby.
* ``mutation``: one ``append_rows``/``delete_rows`` with the coordinator-
  order payload (so replay gives the row order later delete masks index)
  and the per-shard ship payloads (so the standby's delta logs can re-ship
  what a shard never drained).
* ``register`` / ``evict``: index registrations keyed by the stable
  ``reg_id`` the shards key their maintainers by.  Sketch bits are never
  replicated: the standby counts them again (maintain, never re-capture).
* ``ckpt``: a shard checkpoint advanced to a version; prunes the replica's
  copy of that shard's delta log.
* ``selection``: a ``selection_state()`` snapshot.  Its staleness can only
  shift future selection decisions, never results.
* ``plan``: a rebalance's placement (new owner array, voided shards).

:class:`InProcessReplica` folds the records in the coordinator's process;
:class:`SubprocessReplica` ships them over ``runtime/transport`` frames to a
standby process that outlives the coordinator and hands the store back at
takeover.  The standby holds tables as the CPU tensors they arrive as: it
never initializes CUDA and holds nothing on the card.

A sequence gap raises :class:`ReplicationError` at the replica: a standby
refuses to take over from a stream it knows is missing records.
"""
from __future__ import annotations

import atexit
import dataclasses
import itertools
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.runtime import transport

RECORD_KINDS = ("bootstrap", "mutation", "register", "evict", "ckpt", "selection", "plan")


class ReplicationError(RuntimeError):
    """The replication stream is unusable (a gap, an unknown record, a dead
    standby): the coordinator degrades to unreplicated, never crashes."""


@dataclasses.dataclass(frozen=True)
class ReplicationRecord:
    """One sequenced metadata mutation."""

    seq: int
    kind: str
    payload: object


class MetadataStore:
    """A replica's folded view of the coordinator's metadata stream: the
    bootstrap base, the coordinator-order mutation log to replay on it, the
    per-shard delta-log suffixes, the ordered registrations, the latest
    selection snapshot and the current placement."""

    def __init__(self):
        self.boot: Optional[dict] = None
        # Coordinator-order mutations since the bootstrap: (kind, table,
        # payload, version), version None for dimension-table mutations
        # (they do not advance the serving watermark).
        self.muts: List[Tuple[str, str, object, Optional[int]]] = []
        self._logs: Dict[int, List[Tuple[int, str, object]]] = {}
        self.ckpt_versions: Dict[int, Optional[int]] = {}
        # reg_id -> registration payload, in insertion order: the index
        # must be refilled in the same order, or lookup ties could resolve
        # otherwise on the standby.
        self.regs: Dict[int, dict] = {}
        self.selection: Optional[dict] = None
        self.owner: Optional[np.ndarray] = None
        self.version = 0
        self.reg_counter = 1
        self.last_seq = 0

    def apply(self, rec: ReplicationRecord) -> None:
        if rec.seq != self.last_seq + 1:
            raise ReplicationError(f"replication gap: record seq {rec.seq} after {self.last_seq}")
        self.last_seq = rec.seq
        kind = rec.kind
        if kind == "bootstrap":
            p = dict(rec.payload)
            self.boot = p
            self.owner = np.asarray(p["owner"])
            self.version = int(p["version"])
            self.muts = []
            self._logs = {s: list(entries) for s, entries in enumerate(p.get("log") or [])}
            self.ckpt_versions = dict(enumerate(p.get("ckpt_versions") or []))
            self.regs = {}
            self.reg_counter = int(p.get("reg_counter", 1))
            self.selection = p.get("selection")
        elif kind == "mutation":
            mkind, tname, payload, version, ships = rec.payload
            self.muts.append((mkind, tname, payload, version))
            if version is not None:
                self.version = int(version)
                for sid, sp in enumerate(ships or ()):
                    self._logs.setdefault(sid, []).append((int(version), mkind, sp))
        elif kind == "register":
            for p in rec.payload:
                rid = int(p["reg_id"])
                self.regs[rid] = dict(p)
                self.reg_counter = max(self.reg_counter, rid + 1)
        elif kind == "evict":
            self.regs.pop(int(rec.payload), None)
        elif kind == "ckpt":
            sid, v = rec.payload
            self.ckpt_versions[int(sid)] = v
            log = self._logs.get(int(sid))
            if log and v is not None:
                self._logs[int(sid)] = [e for e in log if e[0] > v]
        elif kind == "selection":
            self.selection = rec.payload
        elif kind == "plan":
            owner, voided = rec.payload
            self.owner = np.asarray(owner)
            for sid in voided:
                self._logs[int(sid)] = []
                self.ckpt_versions[int(sid)] = None
        else:
            raise ReplicationError(f"unknown record kind {kind!r}")

    def ship_logs(self, n_shards: int) -> List[List[Tuple[int, str, object]]]:
        return [list(self._logs.get(s, ())) for s in range(n_shards)]


class InProcessReplica:
    """Warm-standby metadata held in the coordinator's process: the same
    record stream and takeover surface as :class:`SubprocessReplica`, with
    no serialization."""

    backend = "loopback"

    def __init__(self):
        self._store = MetadataStore()
        self.records = 0

    def publish(self, rec: ReplicationRecord) -> None:
        self._store.apply(rec)
        self.records += 1

    def snapshot(self) -> MetadataStore:
        return self._store

    # ``close_replica`` (not ``close``): the hot-path analyzer links calls
    # by name and would alias socket ``close()`` calls in the RPC hot path
    # onto this teardown (which reaches ``Popen.wait``).
    def close_replica(self) -> None:
        pass


# ---------------------------------------------------------------------------
# Subprocess replica: a standby process that outlives the coordinator object
# ---------------------------------------------------------------------------

_SPAWN_TIMEOUT_S = 60.0
_sock_counter = itertools.count(1)
_live_replicas: "set[SubprocessReplica]" = set()


def _kill_live_replicas() -> None:
    for r in list(_live_replicas):
        r.close_replica()


atexit.register(_kill_live_replicas)


class SubprocessReplica:
    """Streams replication records to a warm standby process over the
    framed transport the shard RPC uses (crc-checked, deadline-bounded; a
    bootstrap larger than a frame crosses as several).

    The child applies each record to its own :class:`MetadataStore`;
    ``snapshot()`` pulls the folded store back (the takeover path).  The
    child exits when its stdin pipe closes (the parent died), and every
    spawned replica is killed ``atexit``, so standbys never orphan.
    """

    backend = "subprocess"

    def __init__(self, deadline_s: float = 30.0):
        self._deadline_s = deadline_s
        self._seq = itertools.count(1)
        self.records = 0
        from repro_torch.core.shard_rpc import _socket_dir, _spawn_env

        self.path = os.path.join(_socket_dir(), f"r{next(_sock_counter)}.sock")
        # NOT ``-m repro_torch.core.replication``: run as __main__ the
        # standby's MetadataStore would pickle as ``__main__.MetadataStore``
        # and fail to unpickle at takeover.
        self.proc: Optional[subprocess.Popen] = subprocess.Popen(
            [sys.executable, "-c",
             "import sys; from repro_torch.core.replication import main; main(sys.argv[1:])",
             self.path],
            stdin=subprocess.PIPE, stdout=subprocess.DEVNULL, start_new_session=True,
            env=_spawn_env())
        self.conn: Optional[socket.socket] = None
        _live_replicas.add(self)

    def _connect(self) -> None:
        t_end = time.perf_counter() + _SPAWN_TIMEOUT_S
        last: Optional[Exception] = None
        while time.perf_counter() < t_end:
            if self.proc is None or self.proc.poll() is not None:
                raise ReplicationError("standby process exited")
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
        raise ReplicationError(f"could not connect to standby: {last}")

    def _call(self, msg: dict):
        if self.proc is None:
            raise ReplicationError("replica closed")
        if self.conn is None:
            self._connect()
        seq = next(self._seq)
        try:
            transport.send_msg(self.conn, msg, seq, deadline_s=self._deadline_s)
            rseq, resp = transport.recv_msg(self.conn, deadline_s=self._deadline_s)
        except transport.TransportError as e:
            raise ReplicationError(f"standby rpc failed: {e}") from e
        if rseq != seq or not resp.get("ok"):
            raise ReplicationError(
                f"standby refused {msg.get('op')}: {resp.get('msg', 'desync')}")
        return resp.get("value")

    def publish(self, rec: ReplicationRecord) -> None:
        self._call({"op": "publish", "rec": rec})
        self.records += 1

    def snapshot(self) -> MetadataStore:
        return self._call({"op": "snapshot"})

    def close_replica(self) -> None:
        proc, self.proc = self.proc, None
        _live_replicas.discard(self)
        if self.conn is not None:
            try:
                self.conn.close()
            except OSError:
                pass
            self.conn = None
        if proc is not None:
            try:
                proc.kill()
                proc.wait(timeout=5.0)
            except Exception:
                pass


# ---------------------------------------------------------------------------
# The standby process
# ---------------------------------------------------------------------------


def serve(path: str) -> None:
    """The standby loop: fold published records, hand the store back on
    ``snapshot``.  It tolerates reconnects like the shard server: the folded
    store survives a dropped coordinator connection (that is the point)."""
    def _watchdog():
        try:
            while True:
                if not sys.stdin.buffer.read(4096):
                    break
        except Exception:
            pass
        os._exit(2)

    threading.Thread(target=_watchdog, daemon=True).start()
    transport.limits_from_env()
    store = MetadataStore()
    closed = False
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.bind(path)
    sock.listen(2)
    while not closed:
        conn, _ = sock.accept()
        try:
            while not closed:
                seq, msg = transport.recv_msg(conn, deadline_s=None)
                op = msg.get("op")
                try:
                    if op == "publish":
                        store.apply(msg["rec"])
                        resp = {"ok": True, "value": None}
                    elif op == "snapshot":
                        resp = {"ok": True, "value": store}
                    elif op == "ping":
                        resp = {"ok": True, "value": "pong"}
                    elif op == "shutdown":
                        closed = True
                        resp = {"ok": True, "value": None}
                    else:
                        resp = {"ok": False, "msg": f"unknown op {op!r}"}
                except Exception as e:
                    resp = {"ok": False, "msg": f"{type(e).__name__}: {e}"}
                transport.send_msg(conn, resp, seq)
        except (transport.RpcClosed, transport.FrameError, OSError):
            pass  # the coordinator died or reconnected; keep the store
        finally:
            try:
                conn.close()
            except OSError:
                pass
    os._exit(0)


def main(argv: Optional[List[str]] = None) -> None:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print("usage: python -c 'from repro_torch.core.replication import main; main()' "
              "<socket-path>", file=sys.stderr)
        raise SystemExit(2)
    serve(args[0])
