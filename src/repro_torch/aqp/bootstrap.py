"""Bootstrap over stratified samples (Sec. 7.2); port of
``repro/aqp/bootstrap.py``.

For every stratum s_g, B resamples with replacement of the same size; the
spread of the B per-group means is a distribution-free accuracy measure
that complements the CLT intervals.  A resample is a per-row "within my
segment" random offset, so the reference's ``vmap`` over ``split(key, B)``
becomes an explicit (B, m) batch here: one draw of (B, m) uniforms, one
gather, and one segment sum over B * n_groups flattened segments (row order
within each resample, so each row of the batch adds exactly like its own
``segment_sum``).  Fig. 4 of the paper sweeps B; 50 is the knee.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import prng
from repro_torch.device import DeviceLike, resolve_device, to_host


@dataclasses.dataclass(frozen=True)
class BootstrapStats:
    mean: np.ndarray  # bootstrap mean of the per-group mean statistic
    std: np.ndarray  # bootstrap std of that statistic
    n_resamples: int


def _segment_layout(gid: np.ndarray, n_groups: int):
    order = np.argsort(gid, kind="stable")
    sizes = np.bincount(gid, minlength=n_groups)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    return order, sizes, starts


def _resample_means(vals_sorted: torch.Tensor, starts_row: torch.Tensor,
                    sizes_row: torch.Tensor, gid_sorted: torch.Tensor,
                    n_groups: int, key: torch.Tensor, n_resamples: int) -> torch.Tensor:
    """(B, n_groups) matrix of per-resample per-group means."""
    m = vals_sorted.shape[0]
    dev = vals_sorted.device
    u = prng.uniform(prng.split(key, n_resamples), (m,), device=dev)  # (B, m)
    offs = torch.floor(u * sizes_row).to(torch.int32)
    idx = starts_row + torch.minimum(offs, sizes_row.to(torch.int32) - 1)
    resampled = vals_sorted[idx.long()]  # (B, m)
    seg = (torch.arange(n_resamples, device=dev)[:, None] * n_groups
           + gid_sorted[None, :]).reshape(-1)
    total = n_resamples * n_groups
    s = torch.zeros(total, dtype=torch.float32, device=dev).index_add_(
        0, seg, resampled.reshape(-1))
    c = torch.zeros(total, dtype=torch.float32, device=dev).index_add_(
        0, seg, torch.ones_like(resampled).reshape(-1))
    return (s / torch.clamp_min(c, 1.0)).reshape(n_resamples, n_groups)


def bootstrap_group_means(
    key: torch.Tensor,
    values: np.ndarray,  # statistic input per sampled row (e.g. u*v)
    gid: np.ndarray,  # group id per sampled row
    n_groups: int,
    n_resamples: int = 50,
    device: DeviceLike = None,
) -> BootstrapStats:
    values = np.asarray(values, dtype=np.float32)
    gid = np.asarray(gid)
    dev = resolve_device(device)
    order, sizes, starts = _segment_layout(gid, n_groups)
    vals_sorted = torch.from_numpy(values[order]).to(dev)
    gid_sorted = torch.from_numpy(gid[order].astype(np.int64)).to(dev)
    sizes_row = torch.from_numpy(sizes[gid[order]].astype(np.float32)).to(dev)
    starts_row = torch.from_numpy(starts[gid[order]].astype(np.int32)).to(dev)
    # pow2 segment count, as in the reference (padded segments get no rows).
    n_pad = 1 << max(0, (n_groups - 1)).bit_length()
    means = _resample_means(vals_sorted, starts_row, sizes_row, gid_sorted,
                            n_pad, key, n_resamples)
    # The spreads return to the host cost model (a reference merge point).
    means = to_host(means)[:, :n_groups]
    return BootstrapStats(
        mean=means.mean(axis=0),
        std=means.std(axis=0, ddof=1) if n_resamples > 1 else np.zeros(n_groups),
        n_resamples=n_resamples,
    )
