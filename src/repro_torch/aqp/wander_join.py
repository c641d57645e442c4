"""Wander join (Li et al., SIGMOD'16) for the join templates' estimates
(Sec. 8, Alg. 1); port of ``repro/aqp/wander_join.py``.

The join "index" is the dimension's sorted key column; one walk step for a
batch of sampled fact rows is a ``searchsorted`` pair giving each row its
partner range [lo, hi), then a uniform pick inside the range.  A sampled
row's unbiased contribution to a join-SUM is ``v * (hi - lo)`` (the value
of the picked partner times its fan-out), the wander-join estimator with
the walk order fact -> dimension.  The search runs on the host, as in the
reference; the uniforms are ``prng.uniform``, bit for bit ``jax.random``'s,
so the picks equal the reference's for the same key.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.device import DeviceLike, to_host

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.queries import JoinSpec, Predicate
    from repro_torch.core.table import ColumnTable


@dataclasses.dataclass(frozen=True)
class JoinIndex:
    """Sorted-key 'index' over the dimension table."""

    right: str
    right_key: str
    sorted_keys: np.ndarray
    order: np.ndarray  # position -> original right row id

    @classmethod
    def build(cls, right: "ColumnTable", right_key: str) -> "JoinIndex":
        rk = to_host(right[right_key])
        order = np.argsort(rk, kind="stable")
        return cls(right.name, right_key, rk[order], order)


def walk(
    key: torch.Tensor,
    index: JoinIndex,
    fact_keys: np.ndarray,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """One wander-join step for every sampled fact row: ``(right_row_id,
    fanout)``; a row with no partner gets fanout 0 and right_row_id -1.  The
    uniforms are drawn on ``device`` (CUDA unless ``"cpu"``)."""
    lo = np.searchsorted(index.sorted_keys, fact_keys, side="left")
    hi = np.searchsorted(index.sorted_keys, fact_keys, side="right")
    fanout = hi - lo
    m = fact_keys.shape[0]
    u = to_host(prng.uniform(key, (m,), device=device))
    pick = lo + np.minimum((u * np.maximum(fanout, 1)).astype(np.int64), np.maximum(fanout - 1, 0))
    right_rows = np.where(fanout > 0, index.order[np.minimum(pick, len(index.order) - 1)], -1)
    return right_rows, fanout


def join_sample_values(
    key: torch.Tensor,
    index: JoinIndex,
    right: "ColumnTable",
    fact_sample: "ColumnTable",  # the sampled fact rows (gathered)
    join: "JoinSpec",
    agg_attr: Optional[str],
    where: Optional["Predicate"],
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-sampled-row (value, predicate) pairs for the join estimators.

    value v(t) is the wander-join contribution (0 when dangling): the
    fan-out for COUNT(*), a fact attribute times the fan-out, or the picked
    partner's attribute times the fan-out.  pred u(t) folds the WHERE
    predicate evaluated on the joined row.
    """
    from repro_torch.core.queries import _OPS

    fact_keys = to_host(fact_sample[join.left_key])
    right_rows, fanout = walk(key, index, fact_keys, device=fact_sample.device)
    has_partner = fanout > 0

    if agg_attr is None:  # COUNT(*) over the join: contribution = fan-out
        v = fanout.astype(np.float64)
    elif fact_sample.has(agg_attr):
        v = to_host(fact_sample[agg_attr]).astype(np.float64) * fanout
    else:  # aggregate over a dimension attribute: value of the picked partner
        rv = to_host(right[agg_attr])
        v = np.where(has_partner, rv[np.maximum(right_rows, 0)], 0.0) * fanout

    u = has_partner.copy()
    if where is not None:
        if fact_sample.has(where.attr):
            u &= to_host(where.mask(fact_sample))
        else:
            rcol = to_host(right[where.attr])
            joined_vals = np.where(has_partner, rcol[np.maximum(right_rows, 0)], 0.0)
            u &= np.asarray(_OPS[where.op](joined_vals, where.value)) & has_partner
    return v, u
