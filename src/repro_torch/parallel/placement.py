"""Device placement for fragment shards (port of the shard half of
``repro/parallel/placement.py``).

Each ``FragmentShard`` is an in-process object with its own table, catalog
and maintainers.  With more than one CUDA device, each shard's columns are
pinned to a device round-robin, so its partial aggregation runs on its own
card; on one card every pin is ``None`` and placement is a no-op.  The
reference's serving mesh and stacked placement (``serving_mesh``,
``place_stacked``) wait for the port's mesh (ROADMAP A7.6): the fused
launch here runs on the coordinator's device.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.core.table import ColumnTable


def shard_devices(n_shards: int, use_devices: bool = True) -> List[Optional[torch.device]]:
    """One device per shard, round-robin over the CUDA devices; ``None``
    entries (no pinning) when placement is disabled or at most one device
    exists."""
    n_dev = torch.cuda.device_count()
    if not use_devices or n_dev <= 1:
        return [None] * n_shards
    return [torch.device("cuda", i % n_dev) for i in range(n_shards)]


def failover_device(devices: List, sid: int, dead: List[int]):
    """Placement for shard ``sid``'s rebuild after a failure.

    Keeps the shard's own pin in the common case.  When the same device
    also backs *another* dead shard, the fault likely sits with the device,
    so the rebuild lands on the least-loaded device backing no dead shard
    (its own pin when every device is implicated).  ``None`` pins stay
    ``None``.
    """
    own = devices[sid]
    if own is None:
        return None
    dead_devs = {str(devices[d]) for d in dead
                 if d != sid and devices[d] is not None}
    if str(own) not in dead_devs:
        return own
    alive = [d for d in devices if d is not None and str(d) not in dead_devs]
    if not alive:
        return own
    load: dict = {}
    for d in alive:
        load[str(d)] = load.get(str(d), 0) + 1
    return min(alive, key=lambda d: (load[str(d)], str(d)))


def place_table(table: ColumnTable, device: Optional[torch.device]) -> ColumnTable:
    """``table`` with every column on ``device``, its (uid, version) kept
    (itself when ``device`` is ``None``)."""
    if device is None:
        return table
    cols = {k: v.to(device) for k, v in table.columns.items()}
    return ColumnTable(table.name, cols, table.primary_key, table.layout,
                       version=table.version, uid=table.uid)
