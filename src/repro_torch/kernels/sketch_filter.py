"""Sketch keep-mask: the wrapper of ``csrc/sketch_filter.cu``.

Replaces ``repro/kernels/sketch_filter.py::sketch_filter_pallas``; the
source says how the kernel is built and what bounds it.  A CPU tensor goes
to the plain version (``ref.sketch_filter_ref``); a CUDA tensor goes to the
kernel, or the call raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import sketch_filter_ref
from repro_torch.runtime.guards import LAUNCH_COUNTS

NAME = "sketch_filter"
# The per-block copy of the bits (one byte per range) lives in shared memory.
MAX_RANGES = 1 << 17


def sketch_filter(bucket: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """keep (bool[n]) from bucket (int32[n]) and bits (bool[n_ranges])."""
    if bucket.device.type == "cpu":
        return sketch_filter_ref(bucket, bits)
    dev = bucket.device
    n = int(bucket.shape[0])
    n_ranges = int(bits.shape[0])
    build.check_tensor(bucket, "bucket", torch.int32, dev, (n,))
    build.check_tensor(bits, "bits", torch.bool, dev, (n_ranges,))
    if not 1 <= n_ranges <= MAX_RANGES:
        raise ValueError(f"n_ranges must lie in [1, {MAX_RANGES}], got {n_ranges}")
    lib = build.library(NAME)
    index, blocks = build.launch_config(n, lib.filter_threads(), dev)
    keep = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return keep
    err = lib.filter_launch(index, build.stream_handle(dev), bucket.data_ptr(),
                            bits.data_ptr(), n, n_ranges, keep.data_ptr(), blocks)
    build.check(err, NAME)
    LAUNCH_COUNTS[NAME] += 1
    return keep
