"""Fragment-membership bitmap: the wrapper of ``csrc/fragment_bitmap.cu``.

Replaces ``repro/kernels/fragment_bitmap.py::fragment_bitmap_pallas``; the
source says how the kernel is built and what bounds it.  A CPU tensor goes
to the plain version (``ref.fragment_bitmap_ref``); a CUDA tensor goes to
the kernel, or the call raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import fragment_bitmap_ref
from repro_torch.runtime.guards import LAUNCH_COUNTS

NAME = "fragment_bitmap"
# The per-block bitmap (one int32 word per range) lives in shared memory.
MAX_RANGES = 32768


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
    lib = build.library(NAME)
    index, blocks = build.launch_config(n, lib.bitmap_threads(), dev)
    bits = torch.zeros(n_ranges, dtype=torch.int32, device=dev)
    err = lib.bitmap_launch(index, build.stream_handle(dev), bucket.data_ptr(),
                            prov.data_ptr(), n, n_ranges, bits.data_ptr(), blocks)
    build.check(err, NAME)
    LAUNCH_COUNTS[NAME] += 1
    return bits > 0
