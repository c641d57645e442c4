"""Segmented sum/count: the wrappers of ``csrc/segment_aggregate.cu`` and
``csrc/segment_aggregate_batch.cu``.

They replace ``repro/kernels/segment_aggregate.py::segment_aggregate_pallas``
and ``segment_aggregate_batch_pallas``; the sources say how the kernels are
built and what bounds them.  A CPU tensor goes to the plain version
(``ref.segment_aggregate_ref``, ``ref.segment_aggregate_batch_ref``); a
CUDA tensor goes to the kernel, or the call raises.

:func:`plan` fixes the launch, and with it the order of the float
additions: per-warp copies of the partials in 256-thread blocks up to
``PRIVATE_GROUPS`` groups; above, clusters of blocks that each own a slice
of the groups, one cluster per chunk of rows and window of at most
``WINDOW_GROUPS`` groups.  It mirrors the source's constants
(``tests/test_torch_kernels.py`` reads them from the source).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import segment_aggregate_batch_ref, segment_aggregate_ref
from repro_torch.runtime.guards import LAUNCH_COUNTS

NAME = "segment_aggregate"
BATCH_NAME = "segment_aggregate_batch"
# Few groups (segagg_private): 256-thread blocks, every warp with its own
# copy of the partials (8 copies of 2 * n_groups floats, at most 64 KB),
# loading 2 runs of 32 rows at a time.
PRIV_THREADS = 256
PRIV_ROWS = PRIV_THREADS * 2
PRIVATE_GROUPS = 1024
# Many groups (segagg_sliced): tiles of TILE_ROWS rows stream into a ring of
# STAGES stages (each array of a stage has TILE_ROWS + 4 words: the 16-byte
# segments holding the tile); a block owns at most SLICE_MAX groups and a
# cluster has at most CLUSTER_MAX blocks, so a cluster covers a window of at
# most WINDOW_GROUPS groups (wider group-bys take several windows, the
# grid's z axis); FILTERS filter warps compact the rows they keep in place
# in the stage and count them (COUNT_BYTES), and each of ADDERS adder warps
# keeps 2 * slice floats and a byte tag per group.
TILE_ROWS = 1024
STAGES = 3
SLICE_MAX = 4096
CLUSTER_MAX = 8
WINDOW_GROUPS = CLUSTER_MAX * SLICE_MAX
RING_BYTES = STAGES * 3 * (TILE_ROWS + 4) * 4
BARRIER_BYTES = 128
FILTERS = 8
ADDERS = 2
COUNT_BYTES = STAGES * FILTERS * 4
SMEM_MAX = 232_448  # dynamic shared bytes a block may use on an H100
SHARED_PER_SM = 228 * 1024
THREADS_PER_SM = 2048
# A row's partials (8 * n_groups bytes a chunk) stay at most 1/PARTIALS_SHARE
# of its 12 * n input bytes wherever n allows.
PARTIALS_SHARE = 4


class Plan(NamedTuple):
    """How a launch sums each batch row (the same for every row and every
    batch size): ``parts`` partial sets the merge adds in order, each from
    a block (``cluster == 0``, segagg_private) or from ``windows`` clusters
    of ``cluster`` blocks over ``part_rows`` rows, block c of window z
    owning the groups [(z * cluster + c) * slice, ... + slice) with ADDERS
    adder warps (beside FILTERS filter warps and a producer) and a ring of
    ``stages`` stages, in ``smem`` dynamic shared bytes a block."""
    parts: int
    part_rows: int
    cluster: int
    slice: int
    windows: int
    stages: int
    smem: int


def sliced_smem(slice_: int) -> int:
    """Dynamic shared bytes of segagg_sliced (the source's ``sliced_smem``)."""
    return RING_BYTES + BARRIER_BYTES + COUNT_BYTES + ADDERS * (8 * slice_ + -(-slice_ // 16) * 16)


def slice_shape(n_groups: int) -> Tuple[int, int, int, int]:
    """(cluster, slice, windows, smem) of segagg_sliced for ``n_groups``:
    the fewest blocks whose slices of at most SLICE_MAX groups cover them,
    up to CLUSTER_MAX (the source's ``slice_of``); above WINDOW_GROUPS
    groups, as many windows of that cluster as cover them."""
    cluster = min(CLUSTER_MAX, -(-n_groups // SLICE_MAX))
    slice_ = min(SLICE_MAX, -(-n_groups // cluster))
    return cluster, slice_, -(-n_groups // (cluster * slice_)), sliced_smem(slice_)


def plan(n: int, n_groups: int, n_sms: int, max_clusters: Optional[int] = None) -> Plan:
    """The launch for ``n`` rows and ``n_groups`` on a card of ``n_sms``
    SMs, on which ``max_clusters`` clusters of the sliced shape can be
    resident at once (``segagg_max_clusters``; estimated from the shared
    memory when None).

    Sliced: enough chunks that a row's windows give every resident cluster
    one, no more than the tiles, and few enough that a row's partials stay
    within 1/PARTIALS_SHARE of its input bytes.  The plan depends on (n,
    n_groups, the card) only, never on a batch size, so each batch row adds
    in an unbatched launch's order and equal inputs give equal bits.
    """
    if n_groups <= PRIVATE_GROUPS:
        smem = (PRIV_THREADS // 32) * 8 * n_groups
        per_sm = max(1, min(THREADS_PER_SM // PRIV_THREADS, SHARED_PER_SM // (smem + 1024)))
        blocks = max(1, min(n_sms * per_sm, -(-n // PRIV_ROWS)))
        return Plan(blocks, 0, 0, n_groups, 1, 0, smem)
    cluster, slice_, windows, smem = slice_shape(n_groups)
    if max_clusters is None:
        per_sm = min(THREADS_PER_SM // ((FILTERS + ADDERS + 1) * 32),
                     SHARED_PER_SM // (smem + 1024))
        max_clusters = max(1, n_sms * per_sm // cluster)
    tiles = -(-n // TILE_ROWS)
    cap = max(1, 12 * n // PARTIALS_SHARE // (8 * n_groups))
    chunks = max(1, min(max_clusters // windows, cap, tiles))
    per_chunk = max(1, -(-tiles // chunks))
    return Plan(max(1, -(-tiles // per_chunk)), per_chunk * TILE_ROWS, cluster, slice_, windows,
                STAGES, smem)


@functools.lru_cache(maxsize=4096)
def _device_plan(index: int, name: str, n: int, n_groups: int) -> Plan:
    """:func:`plan` on device ``index`` with the clusters it can hold (the
    library ``name`` is asked once per shape); raises if a cluster cannot
    be resident.  Cached: a launch's host time is mostly this and the
    allocations."""
    n_sms = torch.cuda.get_device_properties(index).multi_processor_count
    if n_groups <= PRIVATE_GROUPS:
        return plan(n, n_groups, n_sms)
    cluster, _, _, smem = slice_shape(n_groups)
    count = build.library(name).segagg_max_clusters(index, n_groups, cluster, smem)
    if count <= 0:
        raise RuntimeError(f"{NAME}: no cluster of {cluster} blocks with {smem} bytes of "
                           f"shared memory can be resident (CUDA error {-count})")
    return plan(n, n_groups, n_sms, count)


def _plan_on(dev: torch.device, name: str, n: int, n_groups: int) -> Tuple[int, Plan]:
    """(device index, the plan) of a launch of library ``name`` on ``dev``."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return index, _device_plan(index, name, n, n_groups)


def _buffers(dev: torch.device, shape: Tuple[int, ...], p: Plan):
    """(sums, counts, scratch) of a launch whose results have ``shape``
    ((n_groups,) or (b, n_groups)); three allocations cost less host time
    than views of one."""
    rows = shape[0] if len(shape) == 2 else 1
    sums = torch.empty(shape, dtype=torch.float32, device=dev)
    counts = torch.empty(shape, dtype=torch.float32, device=dev)
    return sums, counts, torch.empty(rows * p.parts * 2 * shape[-1], dtype=torch.float32,
                                     device=dev)


def segment_aggregate(
    values: torch.Tensor, gid: torch.Tensor, n_groups: int, weights: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums f32[n_groups], counts f32[n_groups]) of f32 ``values`` times f32
    ``weights`` per int32 ``gid``; rows with gid outside [0, n_groups) add
    nothing."""
    if values.device.type == "cpu":
        return segment_aggregate_ref(values, gid, n_groups, weights)
    dev = values.device
    n = int(values.shape[0])
    build.check_tensor(values, "values", torch.float32, dev, (n,))
    build.check_tensor(gid, "gid", torch.int32, dev, (n,))
    build.check_tensor(weights, "weights", torch.float32, dev, (n,))
    if n_groups < 1:
        raise ValueError(f"n_groups must be >= 1, got {n_groups}")
    lib = build.library(NAME)
    index, p = _plan_on(dev, NAME, n, n_groups)
    sums, counts, scratch = _buffers(dev, (n_groups,), p)
    err = lib.segagg_launch(
        index, build.stream_handle(dev), values.data_ptr(), gid.data_ptr(),
        weights.data_ptr(), n, n_groups, sums.data_ptr(), counts.data_ptr(),
        scratch.data_ptr(), p.parts, p.part_rows, p.cluster, p.smem)
    build.check(err, NAME)
    LAUNCH_COUNTS[NAME] += 1
    return sums, counts


def segment_aggregate_batch(
    values: torch.Tensor, gid: torch.Tensor, n_groups: int, weights: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B segment problems at once: (sums, counts) as f32[B, n_groups] from
    (B, n) f32 ``values``, int32 ``gid`` and f32 ``weights``; rows with gid
    outside [0, n_groups) add nothing."""
    if values.device.type == "cpu":
        return segment_aggregate_batch_ref(values, gid, n_groups, weights)
    dev = values.device
    b, n = (int(d) for d in values.shape)
    build.check_tensor(values, "values", torch.float32, dev, (b, n))
    build.check_tensor(gid, "gid", torch.int32, dev, (b, n))
    build.check_tensor(weights, "weights", torch.float32, dev, (b, n))
    if n_groups < 1:
        raise ValueError(f"n_groups must be >= 1, got {n_groups}")
    lib = build.library(BATCH_NAME)
    index, p = _plan_on(dev, BATCH_NAME, n, n_groups)
    sums, counts, scratch = _buffers(dev, (b, n_groups), p)
    if b == 0:
        return sums, counts
    err = lib.segagg_batch_launch(
        index, build.stream_handle(dev), values.data_ptr(), gid.data_ptr(),
        weights.data_ptr(), n, b, n_groups, sums.data_ptr(), counts.data_ptr(),
        scratch.data_ptr(), p.parts, p.part_rows, p.cluster, p.smem)
    build.check(err, BATCH_NAME)
    LAUNCH_COUNTS[BATCH_NAME] += 1
    return sums, counts
