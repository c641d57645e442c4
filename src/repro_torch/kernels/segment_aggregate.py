"""Segmented sum/count: the wrappers of ``csrc/segment_aggregate.cu`` and
``csrc/segment_aggregate_batch.cu``.

They replace ``repro/kernels/segment_aggregate.py::segment_aggregate_pallas``
and ``segment_aggregate_batch_pallas``; the sources say how the kernels are
built and what bounds them.  A CPU tensor goes to the plain version
(``ref.segment_aggregate_ref``, ``ref.segment_aggregate_batch_ref``); a
CUDA tensor goes to the kernel, or the call raises.

:func:`plan` fixes the launch, and with it the order of the float
additions: up to ``PRIVATE_GROUPS`` groups, one launch of clusters of
``PRIV_CLUSTER`` 256-thread blocks with per-warp copies of the sums, as
many clusters as the card holds at once (fewer when the rows are few), the
last cluster of a row adding the clusters' partial sets; above, clusters of
blocks that each own a slice of the groups, one cluster per chunk of rows
and window of at most ``WINDOW_GROUPS`` groups, then a merge launch.  It
mirrors the source's constants (``tests/test_torch_kernels.py`` reads them
from the source).  The partial sets and the private kernel's tickets live
in a workspace per device and stream (:class:`_Workspace`), grown to the
largest call seen, so a call allocates only its sums and counts.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import segment_aggregate_batch_ref, segment_aggregate_ref
from repro_torch.runtime.guards import LAUNCH_COUNTS

NAME = "segment_aggregate"
BATCH_NAME = "segment_aggregate_batch"
# Few groups (segagg_private): clusters of PRIV_CLUSTER blocks of 256
# threads, every warp with copies_of(n_groups) copies of the sums (2 *
# n_groups floats each, together at most COPY_GROUPS groups' worth or one
# copy, so at most 64 KB a block, and a byte tag a slot unless a lane has a
# copy of its own), taking steps of STEP_ROWS rows, 4 a lane, at least
# MIN_STEPS a warp where the rows allow; the registers allow
# PRIV_MIN_BLOCKS blocks an SM.
PRIV_THREADS = 256
PRIV_WARPS = PRIV_THREADS // 32
STEP_ROWS = 128
PRIV_CLUSTER = 8
PRIV_MIN_BLOCKS = 4
COPY_GROUPS = 512
MIN_STEPS = 8
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
    batch size).  ``cluster == 0`` (segagg_private): ``parts`` blocks a row
    in clusters of PRIV_CLUSTER, each cluster one partial set, the last
    cluster adding the ``parts // PRIV_CLUSTER`` sets in a fixed tree.  Else
    ``parts`` partial sets the merge adds in order, each from ``windows``
    clusters of ``cluster`` blocks over ``part_rows`` rows, block c of window
    z owning the groups [(z * cluster + c) * slice, ... + slice) with ADDERS
    adder warps (beside FILTERS filter warps and a producer) and a ring of
    ``stages`` stages.  ``smem``: dynamic shared bytes a block."""
    parts: int
    part_rows: int
    cluster: int
    slice: int
    windows: int
    stages: int
    smem: int


def copies_of(n_groups: int) -> int:
    """Copies of the sums a warp of segagg_private keeps (the source's
    ``copies_of``): one a lane up to 16 groups, else the most (a power of
    two) that hold at most COPY_GROUPS groups together."""
    c = 1
    while c < 32 and 2 * c * n_groups <= COPY_GROUPS:
        c *= 2
    return c


def private_smem(n_groups: int) -> int:
    """Dynamic shared bytes of segagg_private (the source's ``private_smem``)."""
    gc = n_groups * copies_of(n_groups)
    tags = -(-gc // 16) * 16 if copies_of(n_groups) < 32 else 0
    return PRIV_WARPS * (8 * gc + tags)


def merge_threads(n_groups: int) -> int:
    """Threads that add each of segagg_private's 2 * n_groups outputs in the
    last cluster (a power of two, at most a warp, all within the cluster's
    threads; the source's ``tpo``)."""
    tpo = 1
    while tpo < 32 and tpo * 2 * 2 * n_groups <= PRIV_CLUSTER * PRIV_THREADS:
        tpo *= 2
    return tpo


def partial_sets(p: Plan) -> int:
    """Partial sets of 2 * n_groups floats a batch row writes."""
    return p.parts // PRIV_CLUSTER if p.cluster == 0 else p.parts


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
    SMs, on which ``max_clusters`` clusters of the launch's shape can be
    resident at once (``segagg_max_clusters``; estimated from the threads,
    the shared memory and PRIV_MIN_BLOCKS when None).

    Private: as many clusters as are resident at once, no more than give
    every warp MIN_STEPS steps of rows (a cluster's merge is the same work
    whatever its rows).  Sliced: enough chunks that a row's windows give
    every resident cluster one, no more than the tiles, and few enough that
    a row's partials stay within 1/PARTIALS_SHARE of its input bytes.  The plan depends on (n,
    n_groups, the card) only, never on a batch size, so each batch row adds
    in an unbatched launch's order and equal inputs give equal bits.
    """
    if n_groups <= PRIVATE_GROUPS:
        smem = private_smem(n_groups)
        if max_clusters is None:
            per_sm = min(PRIV_MIN_BLOCKS, THREADS_PER_SM // PRIV_THREADS,
                         SHARED_PER_SM // (smem + 1024))
            max_clusters = max(1, n_sms * per_sm // PRIV_CLUSTER)
        want = -(-max(n, 1) // (STEP_ROWS * PRIV_WARPS * PRIV_CLUSTER * MIN_STEPS))
        return Plan(max(1, min(max_clusters, want)) * PRIV_CLUSTER, 0, 0, n_groups, 1, 0, smem)
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
        cluster, smem = 0, private_smem(n_groups)
    else:
        cluster, _, _, smem = slice_shape(n_groups)
    count = build.library(name).segagg_max_clusters(index, n_groups, cluster, smem)
    if count <= 0:
        raise RuntimeError(f"{NAME}: no cluster of {cluster or PRIV_CLUSTER} blocks with {smem} "
                           f"bytes of shared memory can be resident (CUDA error {-count})")
    return plan(n, n_groups, n_sms, count)


def _plan_on(dev: torch.device, name: str, n: int, n_groups: int) -> Tuple[int, Plan]:
    """(device index, the plan) of a launch of library ``name`` on ``dev``."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return index, _device_plan(index, name, n, n_groups)


class _Workspace:
    """A stream's partial sets (float32) and the private kernel's tickets,
    one a batch row (int32, zero: each launch leaves its own zero).  The
    launches of one stream run in order, so each finds them free."""

    def __init__(self, dev: torch.device, floats: int, rows: int):
        self.scratch = torch.empty(floats, dtype=torch.float32, device=dev)
        self.tickets = torch.zeros(rows, dtype=torch.int32, device=dev)


_WORKSPACES: Dict[Tuple[int, int], _Workspace] = {}


def _workspace(dev: torch.device, stream: int, floats: int, rows: int) -> _Workspace:
    """The stream's workspace, grown (to twice what was there, at least) when
    a call needs more; a grown one replaces the old, whose last launch is
    ordered before any reuse of its memory on this stream."""
    ws = _WORKSPACES.get((dev.index, stream))
    if ws is None or ws.scratch.numel() < floats or ws.tickets.numel() < rows:
        have = (ws.scratch.numel(), ws.tickets.numel()) if ws else (0, 0)
        ws = _WORKSPACES[(dev.index, stream)] = _Workspace(
            dev, max(floats, 2 * have[0]), max(rows, 2 * have[1], 64))
    return ws


def _buffers(dev: torch.device, shape: Tuple[int, ...]):
    """(sums, counts) of a launch whose results have ``shape`` ((n_groups,)
    or (b, n_groups)): one allocation split in two.  Two allocations cost
    the same host time within the spread (8.5-12.7 against 9.2-14.7 µs in
    four runs of ``segagg_probe.py --few`` on an H100 80GB HBM3 at 700 W)."""
    return torch.empty((2, *shape), dtype=torch.float32, device=dev).unbind(0)


def _launch(fn, dev: torch.device, index: int, p: Plan, rows: int, n_groups: int, sums,
            counts, *args) -> int:
    """The C call ``fn(index, stream, *args, sums, counts, scratch, tickets,
    plan...)`` with the stream's workspace."""
    stream = build.stream_handle(dev)
    ws = _workspace(dev, stream, rows * partial_sets(p) * 2 * n_groups, rows)
    return fn(index, stream, *args, sums.data_ptr(), counts.data_ptr(), ws.scratch.data_ptr(),
              ws.tickets.data_ptr(), p.parts, p.part_rows, p.cluster, p.smem)


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
    sums, counts = _buffers(dev, (n_groups,))
    err = _launch(lib.segagg_launch, dev, index, p, 1, n_groups, sums, counts, values.data_ptr(),
                  gid.data_ptr(), weights.data_ptr(), n, n_groups)
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
    sums, counts = _buffers(dev, (b, n_groups))
    if b == 0:
        return sums, counts
    err = _launch(lib.segagg_batch_launch, dev, index, p, b, n_groups, sums, counts,
                  values.data_ptr(), gid.data_ptr(), weights.data_ptr(), n, b, n_groups)
    build.check(err, BATCH_NAME)
    LAUNCH_COUNTS[BATCH_NAME] += 1
    return sums, counts
