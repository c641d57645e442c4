"""Fragment-membership bitmaps: the wrappers of ``csrc/fragment_bitmap.cu``
and ``csrc/fragment_bitmap_batch.cu``.

They replace ``repro/kernels/fragment_bitmap.py::fragment_bitmap_pallas``
and ``fragment_bitmap_batch_pallas``; the sources say how the kernels are
built and what bounds them.  A CPU tensor goes to the plain version
(``ref.fragment_bitmap_ref``, ``ref.fragment_bitmap_batch_ref``); a CUDA
tensor goes to the kernel, or the call raises.

``fragment_bitmap`` is one launch a call: the kernel writes the bool
output itself, through a word array and a count that it leaves zeroed for
the next call (one workspace per device and stream, zeroed when made).
It loads 16 flags and 4 buckets at a time: a view whose data does not
start on a 16-byte boundary is first copied (counted in
``LAUNCH_COUNTS["fragment_bitmap.aligned_copy"]``).

``fragment_bitmap_batch`` is one launch a call too: a word table of
(chunks of 32 masks) x n_ranges words and a count, which the kernel leaves
zeroed, per device and stream, grown to the largest call seen.  With n a
multiple of 4 and the masks 4-byte aligned it loads a run of 4 rows' flags
as one word and their buckets as 16 bytes, so buckets off a 16-byte
boundary are first copied (``LAUNCH_COUNTS["fragment_bitmap_batch.aligned_copy"]``);
else it loads row by row (no copy).
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import fragment_bitmap_batch_ref, fragment_bitmap_ref
from repro_torch.runtime.guards import LAUNCH_COUNTS

NAME = "fragment_bitmap"
BATCH_NAME = "fragment_bitmap_batch"
COPY_COUNTER = "fragment_bitmap.aligned_copy"  # prov or bucket copied to a 16-byte boundary
BATCH_COPY_COUNTER = "fragment_bitmap_batch.aligned_copy"  # bucket copied to a 16-byte boundary
# The batched kernel's source: masks a block's words hold (a bit each),
# blocks a cluster, rows a tile.
MASKS_PER_CHUNK = 32
BATCH_CLUSTER = 8
BATCH_TILE_ROWS = 4096
# fragment_bitmap keeps one bit per range in shared memory (4 KB); the batched
# kernel keeps one 32-bit word per range.
MAX_RANGES = 32768
# The workspace: MAX_RANGES / 32 bit words and the count of finished clusters.
WORKSPACE_WORDS = MAX_RANGES // 32 + 1

_WORKSPACES: Dict[Tuple[int, int], torch.Tensor] = {}


class _BatchWorkspace:
    """A stream's word table and count (int32, the count last, zero when
    made and after every launch), with both pointers kept."""

    def __init__(self, dev: torch.device, words: int):
        self.table = torch.zeros(words + 1, dtype=torch.int32, device=dev)
        self.words = words
        self.ptr = self.table.data_ptr()
        self.done = self.ptr + 4 * words


_BATCH_WORKSPACES: Dict[Tuple[int, int], _BatchWorkspace] = {}


def _batch_workspace(dev: torch.device, stream: int, words: int) -> _BatchWorkspace:
    """At least ``words`` zero words and the zero count; a larger one (twice
    the words at least) replaces a smaller, whose last launch is ordered
    before any reuse of its memory on this stream."""
    ws = _BATCH_WORKSPACES.get((dev.index, stream))
    if ws is None or ws.words < words:
        ws = _BATCH_WORKSPACES[(dev.index, stream)] = _BatchWorkspace(
            dev, max(words, 2 * ws.words if ws else 0))
    return ws


@functools.lru_cache(maxsize=256)
def _batch_clusters(index: int, masks: int, n_ranges: int) -> int:
    """Clusters of the batched kernel resident at once with ``n_ranges``
    words of shared memory a block; raises if none can be."""
    count = build.library(BATCH_NAME).bitmap_batch_clusters(index, masks, n_ranges)
    if count <= 0:
        raise RuntimeError(f"{BATCH_NAME}: no cluster with {n_ranges} words of shared memory "
                           f"can be resident (CUDA error {-count})")
    return count


def batch_blocks(n: int, chunks: int, clusters: int) -> int:
    """The grid's x extent: whole clusters, the resident ones shared among
    the chunks, no more than the tiles of rows need."""
    want = -(-max(n, 1) // (BATCH_TILE_ROWS * BATCH_CLUSTER))
    return max(1, min(want, clusters // chunks)) * BATCH_CLUSTER


def fragment_bitmap(prov: torch.Tensor, bucket: torch.Tensor, n_ranges: int) -> torch.Tensor:
    """bits (bool[n_ranges]) from prov (bool[n]) and bucket (int32[n])."""
    if bucket.device.type == "cpu":
        return fragment_bitmap_ref(prov, bucket, n_ranges)
    dev = bucket.device
    n = int(bucket.shape[0])
    build.check_tensor(bucket, "bucket", torch.int32, dev, (n,))
    build.check_tensor(prov, "prov", torch.bool, dev, (n,))
    if not 1 <= n_ranges <= MAX_RANGES:
        raise ValueError(f"n_ranges must lie in [1, {MAX_RANGES}], got {n_ranges}")
    if bucket.data_ptr() % 16 or prov.data_ptr() % 16:
        bucket, prov = bucket.clone(), prov.clone()
        LAUNCH_COUNTS[COPY_COUNTER] += 1
    stream = build.stream_handle(dev)
    ws = _WORKSPACES.get((dev.index, stream))
    if ws is None:
        ws = _WORKSPACES[(dev.index, stream)] = torch.zeros(WORKSPACE_WORDS, dtype=torch.int32,
                                                            device=dev)
    bits = torch.empty(n_ranges, dtype=torch.bool, device=dev)
    err = build.library(NAME).bitmap_launch(dev.index, stream, bucket.data_ptr(),
                                            prov.data_ptr(), n, n_ranges, ws.data_ptr(),
                                            bits.data_ptr())
    build.check(err, NAME)
    LAUNCH_COUNTS[NAME] += 1
    return bits


def fragment_bitmap_batch(provs: torch.Tensor, bucket: torch.Tensor,
                          n_ranges: int) -> torch.Tensor:
    """bits (bool[B, n_ranges]) from provs (bool[B, n]) and one bucket
    (int32[n]): B sketches captured in one scan of the rows."""
    if bucket.device.type == "cpu":
        return fragment_bitmap_batch_ref(provs, bucket, n_ranges)
    dev = bucket.device
    n = int(bucket.shape[0])
    b = int(provs.shape[0])
    build.check_tensor(bucket, "bucket", torch.int32, dev, (n,))
    build.check_tensor(provs, "provs", torch.bool, dev, (b, n))
    if not 1 <= n_ranges <= MAX_RANGES:
        raise ValueError(f"n_ranges must lie in [1, {MAX_RANGES}], got {n_ranges}")
    bits = torch.empty((b, n_ranges), dtype=torch.bool, device=dev)
    if b == 0:
        return bits
    aligned = n % 4 == 0 and provs.data_ptr() % 4 == 0
    if aligned and bucket.data_ptr() % 16:
        bucket = bucket.clone()
        LAUNCH_COUNTS[BATCH_COPY_COUNTER] += 1
    lib = build.library(BATCH_NAME)
    chunks = -(-b // MASKS_PER_CHUNK)
    stream = build.stream_handle(dev)
    ws = _batch_workspace(dev, stream, chunks * n_ranges)
    blocks = batch_blocks(n, chunks, _batch_clusters(dev.index, min(b, MASKS_PER_CHUNK),
                                                     n_ranges))
    err = lib.bitmap_batch_launch(dev.index, stream, bucket.data_ptr(), provs.data_ptr(), n, b,
                                  n_ranges, ws.ptr, ws.done, bits.data_ptr(), blocks, int(aligned))
    build.check(err, BATCH_NAME)
    LAUNCH_COUNTS[BATCH_NAME] += 1
    return bits
