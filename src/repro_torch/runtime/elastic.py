"""Elastic re-planning after node or shard loss (port of
``repro/runtime/elastic.py``, numpy only).

A failed host removes a slice of devices; ``plan_remesh`` picks a new
(pod, data, model) factorization that keeps the tensor-parallel extent and
the global batch.  ``plan_replacement`` is its fragment-level analogue: the
sharded engine's ``rebalance`` hands a dead shard's fragments to the
survivors.  Both are pure and deterministic.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    n_micro: int  # new grad-accum factor preserving global batch
    dropped_devices: int


def feasible_mesh_shape(
    n_devices: int, model_parallel: int, prefer_pods: int = 1
) -> Optional[Tuple[int, ...]]:
    """Largest (pod, data, model) grid with data*model*pod <= n_devices."""
    if n_devices < model_parallel:
        return None
    usable = n_devices - (n_devices % model_parallel)
    dp_total = usable // model_parallel
    if dp_total == 0:
        return None
    pods = prefer_pods
    while pods > 1 and dp_total % pods != 0:
        pods -= 1
    data = dp_total // pods
    if pods > 1:
        return (pods, data, model_parallel)
    return (data, model_parallel)


def plan_remesh(
    n_devices: int,
    model_parallel: int,
    global_batch: int,
    old_n_micro: int,
    old_data_extent: int,
    prefer_pods: int = 1,
) -> Optional[ElasticPlan]:
    shape = feasible_mesh_shape(n_devices, model_parallel, prefer_pods)
    if shape is None:
        return None
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    data_extent = shape[-2] * (shape[0] if len(shape) == 3 else 1)
    # Preserve the global batch: per-device batch fixed => n_micro scales
    # inversely with the DP extent.
    n_micro = max(1, old_n_micro * old_data_extent // max(data_extent, 1))
    while n_micro < global_batch and global_batch % n_micro != 0:
        n_micro += 1
    while (global_batch // n_micro) % data_extent != 0 and n_micro < global_batch:
        n_micro += 1
        while global_batch % n_micro != 0 and n_micro < global_batch:
            n_micro += 1
    used = 1
    for s in shape:
        used *= s
    return ElasticPlan(
        mesh_shape=shape,
        axis_names=names,
        n_micro=n_micro,
        dropped_devices=n_devices - used,
    )


def plan_replacement(
    sizes: np.ndarray,
    owner: np.ndarray,
    n_shards: int,
    dead: Sequence[int],
) -> np.ndarray:
    """Re-place the fragments owned by ``dead`` shards onto survivors.

    The fragment-level analogue of ``plan_remesh``: when a shard is lost for
    good, its fragments (sized in rows) are handed to the least-loaded
    surviving shards, largest orphan first — a greedy longest-processing-time
    assignment that keeps the post-failure load spread within one fragment of
    balanced.  Surviving shards keep every fragment they already own (their
    local tables stay valid; only receivers rebuild), and the function is
    pure and deterministic so the coordinator and any observer agree on the
    new placement without coordination.

    Returns the new ``owner`` array; raises ``ValueError`` when every shard
    is dead.
    """
    sizes = np.asarray(sizes, dtype=np.float64)
    owner = np.asarray(owner, dtype=np.int64).copy()
    dead_set = {int(d) for d in dead}
    survivors = [s for s in range(n_shards) if s not in dead_set]
    if not survivors:
        raise ValueError("no surviving shards to re-place fragments on")
    load = {s: float(sizes[owner == s].sum()) for s in survivors}
    orphans = np.nonzero(np.isin(owner, list(dead_set)))[0]
    for f in sorted(orphans.tolist(), key=lambda f: -sizes[f]):
        s = min(survivors, key=lambda s: (load[s], s))
        owner[f] = s
        load[s] += float(sizes[f])
    return owner
