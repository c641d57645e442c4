"""Haas'97 estimators + CLT confidence intervals (Sec. 8.2, Eqs. 1–7); port
of ``repro/aqp/estimators.py``.

Per-group unbiased estimators for SUM/COUNT/AVG with the paper's scaling
rules (Def. 7): for a group g with #g rows in R and #s_g sampled rows,

  SUM:   #g * T_n(u·v)          COUNT: #g * T_n(u)         AVG: T_n(uv)/T_n(u)

Computed for all groups at once with segment sums on the sample's device
(``index_add_``, the counterpart of the reference's ``segment_sum``: in row
order on the CPU; on the card its atomics add in no fixed order, which is
exact on the integral values the engine's workloads aggregate).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.device import to_host

Z_95 = 1.959964  # (alpha+1)/2 quantile for alpha = 0.95


@dataclasses.dataclass(frozen=True)
class GroupEstimates:
    """Per-group estimate + CI, plus the ingredients for Def. 9."""

    fn: str
    estimate: np.ndarray  # shape (n_groups,)
    sigma: np.ndarray  # std of the *estimate* (already scaled), (n_groups,)
    half_width: np.ndarray  # CI half width eps_n, (n_groups,)
    n_samples: np.ndarray  # #s_g, (n_groups,)


def _seg(vals: torch.Tensor, gid: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=vals.dtype, device=vals.device).index_add_(0, gid, vals)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


def group_estimates(
    fn: str,
    values: Optional[torch.Tensor],  # v(t) per sampled row (None for COUNT)
    pred: torch.Tensor,  # u(t) per sampled row (bool)
    gid: np.ndarray,  # dense group id per sampled row
    n_groups: int,
    group_sizes: np.ndarray,  # #g over the full table
    z: float = Z_95,
) -> GroupEstimates:
    # The group axis is padded to pow2 as in the reference; padding segments
    # receive no rows, so the first n_groups outputs are unchanged.
    real_groups = n_groups
    n_groups = _next_pow2(max(1, n_groups))
    dev = pred.device
    gs = np.asarray(group_sizes, dtype=np.float32)
    if n_groups != real_groups:
        gs = np.pad(gs, (0, n_groups - real_groups))
    gid = torch.from_numpy(np.asarray(gid, dtype=np.int64)).to(dev)
    u = pred.to(torch.float32)
    ns = _seg(torch.ones_like(u), gid, n_groups)  # #s_g
    ns_safe = torch.clamp_min(ns, 1.0)
    sizes = torch.from_numpy(gs).to(dev)

    uv = u if fn == "count" else u * values.to(torch.float32)

    mean_uv = _seg(uv, gid, n_groups) / ns_safe  # T_n(uv)
    # T_{n,2}(uv): sample variance of uv within the group.
    var_uv = _seg((uv - mean_uv[gid]) ** 2, gid, n_groups) / torch.clamp_min(ns - 1.0, 1.0)

    if fn in ("sum", "count"):
        est = sizes * mean_uv
        sigma = sizes * torch.sqrt(var_uv / ns_safe)
    elif fn == "avg":
        mean_u = _seg(u, gid, n_groups) / ns_safe
        var_u = _seg((u - mean_u[gid]) ** 2, gid, n_groups) / torch.clamp_min(ns - 1.0, 1.0)
        cov = _seg((uv - mean_uv[gid]) * (u - mean_u[gid]), gid, n_groups) / torch.clamp_min(
            ns - 1.0, 1.0)  # T_{n,1,1}(uv, u)
        mean_u_safe = torch.clamp_min(mean_u, 1e-12)
        r = mean_uv / mean_u_safe  # R_{n,2}
        est = r
        var_ratio = (var_uv - 2.0 * r * cov + r * r * var_u) / (mean_u_safe ** 2)
        sigma = torch.sqrt(torch.clamp_min(var_ratio, 0.0) / ns_safe)
    else:
        raise ValueError(f"unknown aggregate {fn!r}")

    eps = z * sigma
    # The host cost model consumes these (a reference merge point).
    return GroupEstimates(
        fn=fn,
        estimate=to_host(est)[:real_groups],
        sigma=to_host(sigma)[:real_groups],
        half_width=to_host(eps)[:real_groups],
        n_samples=to_host(ns).astype(np.int64)[:real_groups],
    )


def norm_cdf(x: np.ndarray) -> np.ndarray:
    """Standard normal CDF via float32 erf, as the reference computes it."""
    x = torch.as_tensor(np.asarray(x), dtype=torch.float32)
    return to_host(0.5 * (1.0 + torch.erf(x / np.float32(np.sqrt(2.0))))).astype(np.float64)


def pass_probability(
    est: GroupEstimates, op: str, threshold: float, floor: float = 1e-6
) -> np.ndarray:
    """P(group passes HAVING) under the CLT normal approximation (Sec. 8.2):
    Phi((est - tau)/sigma) for '>' style predicates; groups with sigma == 0
    degenerate to the indicator."""
    sigma = np.maximum(est.sigma, 1e-30)
    zscores = (est.estimate - threshold) / sigma
    p_gt = norm_cdf(zscores)
    exact = est.sigma <= 1e-30
    if op in (">", ">="):
        p = np.where(exact, (est.estimate > threshold) if op == ">" else (est.estimate >= threshold), p_gt)
    elif op in ("<", "<="):
        p = np.where(exact, (est.estimate < threshold) if op == "<" else (est.estimate <= threshold), 1.0 - p_gt)
    elif op == "=":
        p = np.where(np.abs(est.estimate - threshold) <= est.half_width, 1.0, floor)
    else:
        raise ValueError(op)
    return np.clip(p.astype(np.float64), floor, 1.0 - 1e-12)
