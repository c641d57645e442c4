"""Hot-path marker and kernel launch counters (port of the part of
``repro/runtime/guards.py`` the single-table engine path uses).

``LAUNCH_COUNTS``
    Bumped by each CUDA kernel wrapper exactly where it launches its kernel
    (keys are the kernel names, e.g. ``"segment_aggregate"``), so a run can
    show that the main path went through the hand-written kernels.

``@hot_path`` tags serving-critical entry points, as in the reference; it
returns the function unchanged.
"""
from __future__ import annotations

import collections
from typing import Callable, TypeVar

F = TypeVar("F", bound=Callable)

LAUNCH_COUNTS: collections.Counter = collections.Counter()


def hot_path(fn: F) -> F:
    """Mark ``fn`` as a serving-critical hot path (no host-device sync
    outside the reference's merge points, pow2-padded shapes)."""
    return fn
