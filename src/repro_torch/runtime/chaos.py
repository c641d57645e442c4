"""Deterministic fault injection for chaos-testing the sharded engine (port
of ``repro/runtime/chaos.py``, numpy only).

The harness replays a workload (queries, batches, appends, deletes) against a
``ShardedEngine`` while injecting faults into its shards at scripted or
seeded-random points: ``kill`` (all local state lost), ``stall`` (every op
sleeps: a straggler), ``partition`` (unreachable, state intact), ``flaky``
(the next N ops fail, then self-heal) and ``heal``.

Everything is seeded and replayable: ``random_schedule`` and ``random_ops``
derive all randomness from ``numpy.random.default_rng(seed)`` (so the same
seeds give the reference's schedules and op lists), and delete masks are
carried as ``(seed, fraction)`` pairs resolved against the engine's current
row count.  Two engines replaying the same op list see identical mutations,
which makes the chaos *differential* possible: a chaotic replay must give
results equal to the fault-free replay of the same ops (degraded-mode
substitution is bit-identical inside the exactness envelope, so equality is
exact, not approximate).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

#: Fault kinds ``random_schedule`` draws from (``heal`` is scheduled
#: separately so faults actually get cleared and recovery paths run).
FAULT_KINDS = ("kill", "stall", "partition", "flaky")

#: Coordinator-level fault kinds (``coord_rate``): ``coord_kill`` drops the
#: active coordinator dead (standby takeover adopts replicated metadata),
#: ``coord_partition`` fences it off while it still *thinks* it is the
#: coordinator — the epoch fence is what keeps its zombie ops out.
COORD_FAULT_KINDS = ("coord_kill", "coord_partition")

#: ``ChaosEvent.shard`` sentinel for coordinator-level events.
COORD = -1


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scripted fault transition, applied just before op ``step``."""

    step: int
    shard: int
    kind: str  # one of FAULT_KINDS, or "heal"
    arg: Optional[float] = None  # stall seconds / flaky op count


def random_schedule(
    seed: int,
    n_steps: int,
    n_shards: int,
    rate: float = 0.35,
    stall_s: float = 0.005,
    heal_bias: float = 0.5,
    coord_rate: float = 0.0,
) -> List[ChaosEvent]:
    """A seeded-random fault schedule over ``n_steps`` workload ops.

    At each step, with probability ``rate``, either heal one currently
    faulted shard (probability ``heal_bias`` when any is faulted — keeps
    kill/rejoin cycles flowing so recovery actually executes) or inject a
    fresh fault on a healthy shard.  The tail of the schedule heals every
    outstanding fault so a replay can end with a fully recovered cluster.

    With ``coord_rate > 0`` the schedule additionally drops coordinator
    faults (``COORD_FAULT_KINDS`` on the ``COORD`` sentinel shard) — each
    one forces a standby takeover mid-replay.  Coordinator faults compose
    freely with shard faults: a takeover must work while shards are dead,
    stalled, or partitioned.
    """
    rng = np.random.default_rng(seed)
    faulted: Dict[int, str] = {}
    events: List[ChaosEvent] = []
    for step in range(n_steps):
        if coord_rate > 0 and rng.random() < coord_rate:
            kind = COORD_FAULT_KINDS[int(rng.integers(len(COORD_FAULT_KINDS)))]
            events.append(ChaosEvent(step, COORD, kind))
        if rng.random() >= rate:
            continue
        if faulted and (rng.random() < heal_bias or len(faulted) == n_shards):
            shard = sorted(faulted)[int(rng.integers(len(faulted)))]
            del faulted[shard]
            events.append(ChaosEvent(step, shard, "heal"))
            continue
        free = [s for s in range(n_shards) if s not in faulted]
        if not free:
            continue
        shard = free[int(rng.integers(len(free)))]
        kind = FAULT_KINDS[int(rng.integers(len(FAULT_KINDS)))]
        if kind == "stall":
            events.append(ChaosEvent(step, shard, "stall", stall_s))
            faulted[shard] = kind
        elif kind == "flaky":
            # Self-heals after failing the next 1-3 ops; not tracked as
            # persistently faulted.
            events.append(ChaosEvent(step, shard, "flaky",
                                     float(rng.integers(1, 4))))
        else:
            events.append(ChaosEvent(step, shard, kind))
            faulted[shard] = kind
    for shard in sorted(faulted):
        events.append(ChaosEvent(n_steps - 1, shard, "heal"))
    return events


def random_ops(
    seed: int,
    n_steps: int,
    queries: Sequence,
    make_rows: Callable[[np.random.Generator, int], Dict[str, np.ndarray]],
    p_query: float = 0.45,
    p_batch: float = 0.2,
    p_append: float = 0.2,
    delete_frac: float = 0.02,
) -> List[Tuple[str, object]]:
    """A seeded workload: single queries, query batches, appends, deletes.

    Ops are engine-independent values — append batches are materialized row
    dicts, deletes are ``(seed, fraction)`` resolved at replay time — so the
    same list replays identically against any number of engines.
    """
    rng = np.random.default_rng(seed)
    ops: List[Tuple[str, object]] = []
    for _ in range(n_steps):
        r = rng.random()
        if r < p_query:
            ops.append(("query", queries[int(rng.integers(len(queries)))]))
        elif r < p_query + p_batch:
            ops.append(("batch", [
                queries[int(rng.integers(len(queries)))]
                for _ in range(int(rng.integers(2, 5)))]))
        elif r < p_query + p_batch + p_append:
            rows = make_rows(rng, int(rng.integers(40, 160)))
            ops.append(("append", {k: np.asarray(v) for k, v in rows.items()}))
        else:
            ops.append(("delete", (int(rng.integers(1 << 31)), delete_frac)))
    return ops


def run_ops(
    engine,
    table: str,
    ops: Sequence[Tuple[str, object]],
    on_step: Optional[Callable[[int], None]] = None,
) -> List:
    """Replay one op list; returns the canonical result trace.

    Query results enter the trace in canonical form (sorted group tuples),
    mutations as ``(kind, #rows)`` markers — the trace is the object the
    differential gate compares with ``==``.  No exception handling here on
    purpose: the engine is REQUIRED to keep answering through faults, so
    anything surfacing to this loop is a finding.
    """
    trace: List = []
    for step, (kind, payload) in enumerate(ops):
        if on_step is not None:
            on_step(step)
        if kind == "query":
            res, _ = engine.run(payload)
            trace.append(res.canonical())
        elif kind == "batch":
            outs = engine.run_batch(list(payload))
            trace.append(tuple(r.canonical() for r, _ in outs))
        elif kind == "append":
            engine.append_rows(table, payload)
            n = next(iter(payload.values())).shape[0]
            trace.append(("append", int(n)))
        elif kind == "delete":
            dseed, frac = payload
            mask = (np.random.default_rng(dseed).random(
                engine.db[table].num_rows) < frac)
            engine.delete_rows(table, mask)
            trace.append(("delete", int(mask.sum())))
        else:  # pragma: no cover - defensive
            raise ValueError(f"unknown op kind {kind!r}")
    return trace


class ChaosHarness:
    """Applies a fault schedule while replaying a workload.

    The harness pokes faults through the engine's shard clients
    (``inject``/``heal`` on a loopback client flips the shard's in-process
    fault flags; on a subprocess client it delivers the real mechanism:
    ``kill`` SIGKILLs the shard server, ``stall`` makes it sleep per op,
    ``partition`` drops the socket, ``flaky`` injects error responses) and
    otherwise drives the engine through its public serving API only.
    """

    def __init__(self, events: Sequence[ChaosEvent]):
        self.events = list(events)
        self._by_step: Dict[int, List[ChaosEvent]] = {}
        for e in self.events:
            self._by_step.setdefault(e.step, []).append(e)

    def apply_events(self, engine, step: int) -> None:
        for e in self._by_step.get(step, []):
            if e.shard == COORD or e.kind in COORD_FAULT_KINDS:
                # Coordinator-level fault: the engine must be failover-
                # capable (``core.standby.FailoverCoordinator``).
                engine.inject_coord(e.kind)
                continue
            shard = engine.shards[e.shard]
            if e.kind == "heal":
                shard.heal()
            else:
                shard.inject(e.kind, e.arg)

    def run(self, engine, table: str, ops: Sequence[Tuple[str, object]]) -> List:
        return run_ops(engine, table, ops,
                       on_step=lambda s: self.apply_events(engine, s))


def differential(
    make_engine: Callable[[], object],
    table: str,
    ops: Sequence[Tuple[str, object]],
    events: Sequence[ChaosEvent],
    make_clean: Optional[Callable[[], object]] = None,
) -> Tuple[bool, List, List]:
    """The chaos differential gate for one replay sequence.

    Runs the op list fault-free on one fresh engine and under the fault
    schedule on another; returns ``(identical, chaotic_trace, clean_trace)``.
    Identity is exact (``==`` on canonical traces): degraded-mode serving
    substitutes coordinator-side slices that are bit-identical to the lost
    shard's, so chaos may change *routing* but never *results*.

    ``make_clean`` lets the fault-free reference come from a different
    engine configuration than the chaotic run (subprocess shards under real
    kills, stalls and socket drops against fault-free in-process serving).
    Engines exposing ``shutdown()`` are shut down before returning, so
    replays over subprocess shards never leak servers.
    """

    def _run(factory, trace_fn):
        eng = factory()
        try:
            return trace_fn(eng)
        finally:
            close = getattr(eng, "shutdown", None)
            if close is not None:
                close()

    clean = _run(make_clean or make_engine,
                 lambda e: run_ops(e, table, ops))
    chaotic = _run(make_engine,
                   lambda e: ChaosHarness(events).run(e, table, ops))
    return chaotic == clean, chaotic, clean
