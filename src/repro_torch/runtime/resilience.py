"""Failure handling (port of ``repro/runtime/resilience.py``, numpy only):
bounded retries with backoff for transient errors, and a straggler monitor
that flags slow operations against a trailing median.  The sharded engine
wraps every shard op in ``with_retries`` against ``ShardUnavailableError``
and times it with a monitor."""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, Optional, Tuple, TypeVar

import numpy as np

T = TypeVar("T")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    max_attempts: int = 3
    backoff_s: float = 0.1
    backoff_mult: float = 2.0
    retryable: Tuple[type, ...] = (RuntimeError, OSError)
    # Wall-clock budget of the whole retry loop: once spent, the next
    # retryable failure re-raises even with attempts left, and every sleep
    # is capped to what is left of it.  ``None``: no deadline.
    deadline_s: Optional[float] = None
    # Decorrelated jitter: each sleep is drawn uniformly from
    # ``[backoff_s, prev_sleep * backoff_mult * (1 + jitter))``, so clients
    # retrying against one recovering shard spread out.  ``jitter=0`` gives
    # the plain geometric sequence; ``seed`` makes the draws replayable.
    jitter: float = 0.5
    seed: Optional[int] = None


def with_retries(fn: Callable[[], T], policy: RetryPolicy = RetryPolicy(),
                 on_retry: Optional[Callable[[int, Exception], None]] = None) -> T:
    """``fn()``, retried on ``policy.retryable`` errors with backoff; the
    last failure re-raises.  The jitter draws through
    ``np.random.default_rng(policy.seed)``, as the reference's do, so a
    seeded policy sleeps the reference's sleeps float for float."""
    delay = policy.backoff_s
    rng = None
    if policy.jitter > 0:
        rng = np.random.default_rng(policy.seed)
    t0 = time.perf_counter()
    for attempt in range(1, policy.max_attempts + 1):
        try:
            return fn()
        except policy.retryable as e:  # noqa: PERF203
            if attempt == policy.max_attempts:
                raise
            remaining = None
            if policy.deadline_s is not None:
                remaining = policy.deadline_s - (time.perf_counter() - t0)
                if remaining <= 0:
                    raise
            if on_retry:
                on_retry(attempt, e)
            sleep = delay
            if rng is not None:
                hi = delay * (1.0 + policy.jitter)
                sleep = float(rng.uniform(policy.backoff_s, hi)) \
                    if hi > policy.backoff_s else delay
            if remaining is not None:
                sleep = min(sleep, remaining)
            time.sleep(max(sleep, 0.0))
            delay = sleep * policy.backoff_mult
    raise AssertionError("unreachable")


class StragglerMonitor:
    """Flags steps slower than ``threshold`` x trailing median.

    At scale the same logic runs per-host on step barrier times; a flagged
    host is reported to the elastic controller.  Deterministic and
    unit-testable: feed it durations, read back flags.
    """

    def __init__(self, window: int = 32, threshold: float = 2.0):
        self.window = window
        self.threshold = threshold
        self._times: Deque[float] = deque(maxlen=window)
        self.flagged = 0

    def observe(self, duration_s: float) -> bool:
        med = self.median()
        self._times.append(duration_s)
        if med is None:
            return False
        slow = duration_s > self.threshold * med
        self.flagged += int(slow)
        return slow

    def median(self) -> Optional[float]:
        if len(self._times) < max(4, self.window // 4):
            return None
        s = sorted(self._times)
        return s[len(s) // 2]
