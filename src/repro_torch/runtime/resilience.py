"""Straggler tracking (from ``repro/runtime/resilience.py``, numpy free):
a monitor that flags slow operations against a trailing median.  The
sharded engine times every shard operation with one, on the fault-free path
too.  The reference's retry loop (``RetryPolicy``, ``with_retries``) comes
with the fault half of the sharded path, which has errors to retry."""
from __future__ import annotations

from collections import deque
from typing import Deque, Optional


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
