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
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import fragment_bitmap_batch_ref, fragment_bitmap_ref
from repro_torch.runtime.guards import LAUNCH_COUNTS

NAME = "fragment_bitmap"
BATCH_NAME = "fragment_bitmap_batch"
COPY_COUNTER = "fragment_bitmap.aligned_copy"  # prov or bucket copied to a 16-byte boundary
# fragment_bitmap keeps one bit per range in shared memory (4 KB); the batched
# kernel keeps one 32-bit word per range.
MAX_RANGES = 32768
# The workspace: MAX_RANGES / 32 bit words and the count of finished clusters.
WORKSPACE_WORDS = MAX_RANGES // 32 + 1

_WORKSPACES: Dict[Tuple[int, int], torch.Tensor] = {}


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
    # The kernel loads four buckets as one 16-byte word and four flags of a
    # mask as one 4-byte word.
    if bucket.data_ptr() % 16:
        bucket = bucket.clone()
    if provs.data_ptr() % 4:
        provs = provs.clone()
    lib = build.library(BATCH_NAME)
    chunk = lib.bitmap_batch_masks_per_chunk()
    index, blocks = build.launch_config(-(-n // 4), lib.bitmap_batch_threads(), dev)
    words = torch.zeros((-(-b // chunk), n_ranges), dtype=torch.int32, device=dev)
    err = lib.bitmap_batch_launch(index, build.stream_handle(dev), bucket.data_ptr(),
                                  provs.data_ptr(), n, b, n_ranges, words.data_ptr(),
                                  bits.data_ptr(), blocks)
    build.check(err, BATCH_NAME)
    LAUNCH_COUNTS[BATCH_NAME] += 1
    return bits
