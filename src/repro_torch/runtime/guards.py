"""Hot-path marker and launch telemetry (port of the part of
``repro/runtime/guards.py`` the engine and sharded serving use).

``LAUNCH_COUNTS``
    Bumped by each CUDA kernel wrapper exactly where it launches its kernel
    (keys are the kernel names, e.g. ``"segment_aggregate"``), so a run can
    show that the main path went through the hand-written kernels; and by
    the sharded engine once per fused launch (``"fused_partials"``), so a
    hit batch can be shown to cost one launch.
``SHAPE_CLASSES``
    The distinct input shapes each fused launch has seen (key
    ``"fused_partials"``: ``(K, S_pad, R_pad, g_pad)``).  The reference
    counts XLA traces of its fused body, one per shape class; here the set's
    size is that count, and a test holds it still while the shard count or
    the registered sketches change inside one pow2 class.

``@hot_path`` tags serving-critical entry points, as in the reference; it
returns the function unchanged.
"""
from __future__ import annotations

import collections
from typing import Callable, DefaultDict, Set, Tuple, TypeVar

F = TypeVar("F", bound=Callable)

LAUNCH_COUNTS: collections.Counter = collections.Counter()
SHAPE_CLASSES: DefaultDict[str, Set[Tuple[int, ...]]] = collections.defaultdict(set)


def hot_path(fn: F) -> F:
    """Mark ``fn`` as a serving-critical hot path (no host-device sync
    outside the reference's merge points, pow2-padded shapes)."""
    return fn
