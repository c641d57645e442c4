"""Segmented sum/count: the wrapper of ``csrc/segment_aggregate.cu``.

Replaces ``repro/kernels/segment_aggregate.py::segment_aggregate_pallas``;
the source says how the kernel is built and what bounds it.  A CPU tensor
goes to the plain version (``ref.segment_aggregate_ref``); a CUDA tensor
goes to the kernel, or the call raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import segment_aggregate_ref
from repro_torch.runtime.guards import LAUNCH_COUNTS

NAME = "segment_aggregate"
# Where the per-block partials accumulate (the source's launch modes): one
# copy per warp in shared memory (few groups), one copy per block in shared
# memory, or the block's slice of global scratch.
PRIVATE, SHARED, GLOBAL = 0, 1, 2
# Few groups: 256-thread blocks, every warp with its own copy of the
# partials while the 8 copies take at most PRIVATE_LIMIT, loading 2 runs of
# 32 rows at a time.
PRIV_THREADS = 256
PRIV_ROWS = PRIV_THREADS * 2
PRIVATE_LIMIT = 64 * 1024
# Many groups: 512 threads (16 warps, each owning the groups g % 16 ==
# warp), each loading 4 rows of a 2,048-row tile.  Shared memory before the
# partials: the tile's rows sorted into the owners' lists (3 words a row),
# the rows of each owner in each run of 32 rows, and 32 words of scan totals.
THREADS = 512
WARPS = THREADS // 32
TILE_ROWS = THREADS * 4
STAGE_BYTES = 4 * (3 * TILE_ROWS + WARPS * (TILE_ROWS // 32) + 32)
# One copy of the partials (2 * n_groups floats) stays in shared memory up
# to this size; a block may use 227 KB on an H100, and 128 KB holds the
# 16,384-group pad of the widest group-bys.
SHARED_LIMIT = 160 * 1024
SHARED_PER_SM = 228 * 1024
THREADS_PER_SM = 2048
# Above SHARED_LIMIT the partials live in global scratch, at most this big.
GLOBAL_SCRATCH = 256 << 20


def grid(n: int, n_groups: int, n_sms: int) -> Tuple[int, int]:
    """(blocks, mode) for ``n`` rows and ``n_groups``.

    Enough blocks to fill every SM as far as shared memory allows (and no
    more than the rows need): the merge pass reads every block's partials,
    so a wide group-by runs fewer blocks.  The grid fixes the order of the
    float additions, so equal inputs on one card give equal bits.
    """
    part = 8 * n_groups
    if (PRIV_THREADS // 32) * part <= PRIVATE_LIMIT:
        mode, threads, rows, smem = PRIVATE, PRIV_THREADS, PRIV_ROWS, (PRIV_THREADS // 32) * part
    else:
        mode = SHARED if part <= SHARED_LIMIT else GLOBAL
        threads, rows = THREADS, TILE_ROWS
        smem = STAGE_BYTES + (part if mode == SHARED else 0)
    per_sm = max(1, min(THREADS_PER_SM // threads, SHARED_PER_SM // (smem + 1024)))
    blocks = max(1, min(n_sms * per_sm, -(-n // rows)))
    if mode == GLOBAL:
        blocks = max(1, min(blocks, GLOBAL_SCRATCH // part))
    return blocks, mode


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
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    n_sms = torch.cuda.get_device_properties(index).multi_processor_count
    blocks, mode = grid(n, n_groups, n_sms)
    sums = torch.empty(n_groups, dtype=torch.float32, device=dev)
    counts = torch.empty(n_groups, dtype=torch.float32, device=dev)
    scratch = torch.empty(blocks * 2 * n_groups, dtype=torch.float32, device=dev)
    err = lib.segagg_launch(
        index, build.stream_handle(dev), values.data_ptr(), gid.data_ptr(),
        weights.data_ptr(), n, n_groups, sums.data_ptr(), counts.data_ptr(),
        scratch.data_ptr(), blocks, mode)
    build.check(err, NAME)
    LAUNCH_COUNTS[NAME] += 1
    return sums, counts
