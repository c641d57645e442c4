"""Sketch keep-mask and kept rows: the wrappers of ``csrc/sketch_filter.cu``.

Replaces ``repro/kernels/sketch_filter.py::sketch_filter_pallas`` and the
``np.nonzero`` its caller runs over the mask; the source says how the
kernels are built and what bounds them.  A CPU tensor goes to the plain
versions (``ref.sketch_filter_ref``, ``ref.sketch_filter_rows_ref``); a CUDA
tensor goes to a kernel, or the call raises.

The kernels load buckets 16 bytes at a time: a view whose data does not
start on a 16-byte boundary is first copied (counted in
``LAUNCH_COUNTS["sketch_filter.aligned_copy"]``); a whole tensor always
starts on one.  The compaction keeps a workspace per device and stream
(:class:`_Workspace`); :func:`sketch_filter_rows` reads the kept count
back with one 8-byte copy, the call's one wait for the card.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import sketch_filter_ref, sketch_filter_rows_ref
from repro_torch.runtime.guards import LAUNCH_COUNTS

NAME = "sketch_filter"
ROWS_COUNTER = "sketch_filter.rows"  # launches that also compact the kept rows
COPY_COUNTER = "sketch_filter.aligned_copy"  # buckets copied to a 16-byte boundary
# The flags (one bit per range) live in a block's shared memory (16 KB).
MAX_RANGES = 1 << 17
# The source's constants: rows a tile, and the workspace's head words (two
# tickets, the count, a spare) before its two arrays of status words.
TILE_ROWS = 4096
HEAD_WORDS = 4


class _Workspace:
    """A stream's tickets, count and status words (int64, zeroed when made).

    Call k uses the pair of parity k % 2 and clears the other pair, which
    call k - 1 used for ``prev_tiles`` tiles; the launches of one stream
    run in order, so each call finds its pair clear."""

    def __init__(self, dev: torch.device, cap: int):
        self.cap = cap
        self.words = torch.zeros(HEAD_WORDS + 2 * cap, dtype=torch.int64, device=dev)
        self.count = self.words[2]
        self.parity = 0
        self.prev_tiles = 0


_WORKSPACES: Dict[Tuple[int, int], _Workspace] = {}


def _workspace(dev: torch.device, stream: int, tiles: int) -> _Workspace:
    ws = _WORKSPACES.get((dev.index, stream))
    if ws is None or ws.cap < tiles:
        # A larger one starts clear; the old one's last launch is ordered
        # before any reuse of its memory on this stream.
        cap = max(tiles, 2 * ws.cap if ws else 256)
        ws = _WORKSPACES[(dev.index, stream)] = _Workspace(dev, cap)
    return ws


def _checked(bucket: torch.Tensor, bits: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
    """(bucket, n, n_ranges) after the argument checks; bucket copied to a
    16-byte boundary when it does not start on one."""
    dev = bucket.device
    n = int(bucket.shape[0])
    n_ranges = int(bits.shape[0])
    build.check_tensor(bucket, "bucket", torch.int32, dev, (n,))
    build.check_tensor(bits, "bits", torch.bool, dev, (n_ranges,))
    if not 1 <= n_ranges <= MAX_RANGES:
        raise ValueError(f"n_ranges must lie in [1, {MAX_RANGES}], got {n_ranges}")
    if bucket.data_ptr() % 16:
        bucket = bucket.clone()
        LAUNCH_COUNTS[COPY_COUNTER] += 1
    return bucket, n, n_ranges


def sketch_filter(bucket: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """keep (bool[n]) from bucket (int32[n]) and bits (bool[n_ranges])."""
    if bucket.device.type == "cpu":
        return sketch_filter_ref(bucket, bits)
    bucket, n, n_ranges = _checked(bucket, bits)
    dev = bucket.device
    keep = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return keep
    err = build.library(NAME).filter_launch(dev.index, build.stream_handle(dev),
                                            bucket.data_ptr(), bits.data_ptr(), n, n_ranges,
                                            keep.data_ptr())
    build.check(err, NAME)
    LAUNCH_COUNTS[NAME] += 1
    return keep


def sketch_filter_rows(bucket: torch.Tensor, bits: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keep bool[n], rows int64[k]): the keep-mask and the indices of its
    kept rows in ascending order (``np.nonzero(keep)[0]``), in one launch."""
    if bucket.device.type == "cpu":
        return sketch_filter_rows_ref(bucket, bits)
    bucket, n, n_ranges = _checked(bucket, bits)
    dev = bucket.device
    keep = torch.empty(n, dtype=torch.bool, device=dev)
    rows = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return keep, rows
    stream = build.stream_handle(dev)
    tiles = -(-n // TILE_ROWS)
    ws = _workspace(dev, stream, tiles)
    err = build.library(NAME).filter_rows_launch(
        dev.index, stream, bucket.data_ptr(), bits.data_ptr(), n, n_ranges, keep.data_ptr(),
        rows.data_ptr(), ws.words.data_ptr(), ws.cap, ws.parity, ws.prev_tiles)
    build.check(err, NAME)
    ws.parity, ws.prev_tiles = 1 - ws.parity, tiles
    LAUNCH_COUNTS[NAME] += 1
    LAUNCH_COUNTS[ROWS_COUNTER] += 1
    return keep, rows[:int(ws.count)]
