"""Sketch-size estimation — Algorithms 1 & 2 and Def. 9 of the paper; port of
``repro/aqp/size_estimation.py`` for single-table queries (the wander-join
branch comes with the join slice).

Pipeline (Fig. 3):
  stratified sample (cached)  ->  AQR: per-group aggregate estimates
  ->  HAVING on estimates -> G'
  ->  fragment incidence of G' under the candidate's range partition
  ->  size  = sum of #R_r over satisfied ranges        (Alg. 2)
      E[size], Frechet lo/hi via pass probabilities    (Def. 9)

``estimate_size_batched`` evaluates all candidate attributes of one query in
a single batched incidence pass (:func:`_incidence_pass`).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.aqp.bootstrap import bootstrap_group_means
from repro_torch.aqp.estimators import GroupEstimates, group_estimates, pass_probability
from repro_torch.aqp.sampling import SampleSet
from repro_torch.device import to_host
from repro_torch.runtime.guards import hot_path

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.catalog import Catalog


def _catalog(catalog: "Optional[Catalog]") -> "Catalog":
    from repro_torch.core.catalog import default_catalog

    return catalog if catalog is not None else default_catalog()


@dataclasses.dataclass(frozen=True)
class SizeEstimate:
    attr: str
    est_rows: float  # point estimate of |R_P| (Alg. 2)
    est_selectivity: float
    expected_rows: float  # E[size] under Def. 9 (independent groups)
    lo_rows: float  # Frechet lower bound
    hi_rows: float  # Frechet upper bound
    est_bits: np.ndarray  # which ranges the estimate marks satisfied
    n_satisfied_groups: int


@dataclasses.dataclass(frozen=True)
class EstimationConfig:
    n_resamples: int = 50
    z: float = 1.959964  # 95% CI
    incidence: str = "sample"  # 'sample' | 'full' (Def. 8's f(G', D))
    use_bootstrap: bool = True


def aqr_estimates(
    key: torch.Tensor,
    q: "Query",
    db: "Database",
    samples: SampleSet,
    cfg: EstimationConfig = EstimationConfig(),
) -> GroupEstimates:
    """Algorithm 1's estimation half: per-group aggregate estimates.

    Depends only on the query's FROM/WHERE/GROUP BY/aggregate, not on the
    HAVING chain.
    """
    from repro_torch.core.queries import JOIN_SLICE

    if q.join is not None:
        raise NotImplementedError(JOIN_SLICE)
    fact = db[q.table]
    sample_rows = fact.gather(torch.from_numpy(samples.indices))
    kb, _kw = prng.split(key)  # the reference's second key feeds wander join
    fn = q.agg.fn
    values = None if fn == "count" else sample_rows[q.agg.attr]
    pred = (
        q.where.mask(sample_rows)
        if q.where is not None
        else torch.ones(samples.num_samples, dtype=torch.bool, device=fact.device)
    )

    est = group_estimates(fn, values, pred, samples.sample_gid, samples.n_groups,
                          samples.group_sizes, z=cfg.z)

    if cfg.use_bootstrap and samples.stratified:
        # Bootstrap the per-group mean statistic; fold its spread into sigma
        # (max of CLT and bootstrap spreads -> conservative CI, Sec. 7.2).
        uv = to_host(pred).astype(np.float32)
        if values is not None:
            uv = uv * to_host(values).astype(np.float32)
        bs = bootstrap_group_means(kb, uv, samples.sample_gid, samples.n_groups,
                                   cfg.n_resamples, device=fact.device)
        if fn in ("sum", "count"):
            scale = samples.group_sizes.astype(np.float64)
            boot_est = scale * bs.mean
            boot_sigma = scale * bs.std
        else:
            boot_est, boot_sigma = est.estimate, est.sigma  # AVG: keep CLT form
        est = GroupEstimates(
            fn=est.fn,
            estimate=np.where(samples.sample_sizes > 1, boot_est, est.estimate),
            sigma=np.maximum(est.sigma, boot_sigma),
            half_width=cfg.z * np.maximum(est.sigma, boot_sigma),
            n_samples=est.n_samples,
        )
    return est


def satisfied_groups(q: "Query", est: GroupEstimates, sampled: np.ndarray) -> np.ndarray:
    """HAVING over the estimates -> the satisfied-group mask G' (restricted
    to groups ever sampled)."""
    if q.having is not None:
        from repro_torch.core.queries import _OPS

        satisfied = np.asarray(_OPS[q.having.op](est.estimate, q.having.value))
    else:
        satisfied = np.ones(est.estimate.shape[0], dtype=bool)
    return satisfied & sampled


@hot_path
def approximate_query_result(
    key: torch.Tensor,
    q: "Query",
    db: "Database",
    samples: SampleSet,
    cfg: EstimationConfig = EstimationConfig(),
) -> Tuple[GroupEstimates, np.ndarray]:
    """Algorithm 1 (AQR): per-group estimates + satisfied-group mask G'."""
    est = aqr_estimates(key, q, db, samples, cfg)
    return est, satisfied_groups(q, est, samples.sample_sizes > 0)


def _sample_incidence(
    q: "Query",
    db: "Database",
    samples: SampleSet,
    ranges: "RangeSet",
    satisfied: np.ndarray,
    catalog: "Optional[Catalog]" = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(frag_id, gid) incidence pairs from the *sample* rows of G'.

    When the partition attribute is a group-by attribute the group key pins
    the fragment exactly (the CB-OPT-GB fast path).
    """
    catalog = _catalog(catalog)
    fact = db[q.table]
    if ranges.attr in samples.groupby:
        frag_of_group = catalog.frag_of_group(
            fact, ranges, samples.groupby, samples.group_values)
        gids = np.nonzero(satisfied)[0]
        return frag_of_group[gids], gids
    row_sat = satisfied[samples.sample_gid]
    rows = samples.indices[row_sat]
    gids = samples.sample_gid[row_sat]
    bucket = catalog.cached_bucket(fact, ranges)
    take = torch.from_numpy(rows).to(fact.device)
    if bucket is not None:
        frag = to_host(bucket.index_select(0, take))
    else:
        frag = to_host(ranges.bucketize(fact[ranges.attr].index_select(0, take)))
    pairs = np.unique(np.stack([frag, gids], axis=1), axis=0)
    return pairs[:, 0], pairs[:, 1]


def _full_incidence(
    q: "Query",
    db: "Database",
    samples: SampleSet,
    ranges: "RangeSet",
    satisfied: np.ndarray,
    catalog: "Optional[Catalog]" = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Def. 8's f(G', D): scan the full table for rows of satisfied groups."""
    catalog = _catalog(catalog)
    fact = db[q.table]
    gid = catalog.groups(fact, tuple(samples.groupby)).gid
    row_sat = satisfied[gid]
    frag = to_host(catalog.bucketize(fact, ranges))[row_sat]
    pairs = np.unique(np.stack([frag, gid[row_sat]], axis=1), axis=0)
    return pairs[:, 0], pairs[:, 1]


def _pass_probabilities(q: "Query", est: GroupEstimates) -> np.ndarray:
    """p_g = P(group g satisfies the HAVING) under the CLT/bootstrap CI."""
    p_g = pass_probability(
        est, q.having.op if q.having else ">", q.having.value if q.having else -np.inf
    )
    if q.having is None:
        p_g = np.ones_like(p_g)
    return p_g


def _candidate_incidence(
    q: "Query",
    db: "Database",
    samples: SampleSet,
    ranges: "RangeSet",
    satisfied: np.ndarray,
    cfg: EstimationConfig,
    catalog: "Catalog",
) -> Tuple[np.ndarray, np.ndarray]:
    if cfg.incidence == "full":
        return _full_incidence(q, db, samples, ranges, satisfied, catalog)
    return _sample_incidence(q, db, samples, ranges, satisfied, catalog)


def _incidence_pass(frag: torch.Tensor, valid: torch.Tensor, p_pair: torch.Tensor,
                    sizes: torch.Tensor):
    """Alg. 2 + Def. 9 for a batch of candidates from deduped (frag, group)
    pairs: frag (C, P) int64, valid (C, P) bool padding mask, p_pair (C, P)
    f32 pass probabilities, sizes (C, R) f32 fragment sizes.

    The reference vmaps a scatter over the candidates; here the C
    candidates' pairs scatter into one flattened (C * R) axis.  Inputs and
    outputs are host data, so this runs on the CPU, where ``index_add_``
    adds in pair order: the sums are deterministic.  ``est_rows`` sums
    integral fragment sizes and is exact; the Def. 9 terms sum non-integral
    ``log1p`` values.
    """
    c, n_r = sizes.shape
    flat = (frag + torch.arange(c)[:, None] * n_r).reshape(-1)
    vf = valid.to(torch.float32)

    def scatter(vals: torch.Tensor, reduce: str) -> torch.Tensor:
        out = torch.zeros(c * n_r, dtype=torch.float32)
        if reduce == "add":
            out.index_add_(0, flat, vals.reshape(-1))
        else:
            out.scatter_reduce_(0, flat, vals.reshape(-1), reduce="amax")
        return out.reshape(c, n_r)

    hits = scatter(vf, "amax")
    bits = hits > 0
    est_rows = (sizes * hits).sum(dim=1)
    log1m = torch.log1p(-torch.clamp_max(p_pair, 1 - 1e-12)) * vf
    p_frag = torch.where(bits, 1.0 - torch.exp(scatter(log1m, "add")), torch.zeros(()))
    max_p = scatter(p_pair * vf, "amax")
    sum_p = scatter(p_pair * vf, "add")
    expected = (sizes * p_frag).sum(dim=1)
    lo = (sizes * max_p).sum(dim=1)
    hi = (sizes * torch.clamp_max(sum_p, 1.0)).sum(dim=1)
    return bits, est_rows, expected, lo, hi


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


@dataclasses.dataclass(frozen=True)
class EstimationSpec:
    """One query's candidate-estimation request inside a multi-query batch."""

    q: "Query"
    samples: SampleSet
    ranges_by_attr: Mapping[str, "RangeSet"]
    aqr: Tuple[GroupEstimates, np.ndarray]  # (estimates, satisfied mask)


@hot_path
def estimate_size_multi(
    db: "Database",
    specs: Sequence[EstimationSpec],
    cfg: EstimationConfig = EstimationConfig(),
    catalog: "Optional[Catalog]" = None,
) -> List[Dict[str, SizeEstimate]]:
    """Algorithm 2 + Def. 9 for a batch of queries in one incidence pass.

    Every (query, candidate) pair becomes one row of a padded incidence
    matrix (pairs and fragments padded to pow2, as in the reference); the
    per-candidate loop only assembles host-side (frag, group) pairs.
    """
    catalog = _catalog(catalog)
    rows = []  # (spec_idx, attr, ranges, frag, gids, p_g)
    for si, spec in enumerate(specs):
        if not spec.ranges_by_attr:
            continue
        est, satisfied = spec.aqr
        p_g = _pass_probabilities(spec.q, est)
        for a, ranges in spec.ranges_by_attr.items():
            frag, gids = _candidate_incidence(
                spec.q, db, spec.samples, ranges, satisfied, cfg, catalog)
            rows.append((si, a, ranges, frag, gids, p_g))
    out: List[Dict[str, SizeEstimate]] = [{} for _ in specs]
    if not rows:
        return out

    n_rows_p = _next_pow2(len(rows))
    max_pairs = _next_pow2(max(1, max(len(r[3]) for r in rows)))
    max_r = _next_pow2(max(r[2].n_ranges for r in rows))

    frag_mat = np.zeros((n_rows_p, max_pairs), dtype=np.int64)
    valid_mat = np.zeros((n_rows_p, max_pairs), dtype=bool)
    p_mat = np.zeros((n_rows_p, max_pairs), dtype=np.float32)
    sizes_mat = np.zeros((n_rows_p, max_r), dtype=np.float32)
    for i, (si, a, ranges, frag, gids, p_g) in enumerate(rows):
        k = len(frag)
        frag_mat[i, :k] = frag
        valid_mat[i, :k] = True
        p_mat[i, :k] = p_g[gids]
        sizes_mat[i, : ranges.n_ranges] = catalog.fragment_sizes(
            db[specs[si].q.table], ranges)

    bits_b, est_b, exp_b, lo_b, hi_b = (to_host(t) for t in _incidence_pass(
        torch.from_numpy(frag_mat), torch.from_numpy(valid_mat),
        torch.from_numpy(p_mat), torch.from_numpy(sizes_mat)))

    for i, (si, a, ranges, frag, gids, p_g) in enumerate(rows):
        spec = specs[si]
        total = max(db[spec.q.table].num_rows, 1)
        out[si][a] = SizeEstimate(
            attr=a,
            est_rows=float(est_b[i]),
            est_selectivity=float(est_b[i]) / total,
            expected_rows=float(exp_b[i]),
            lo_rows=float(lo_b[i]),
            hi_rows=float(hi_b[i]),
            est_bits=bits_b[i, : ranges.n_ranges],
            n_satisfied_groups=int(spec.aqr[1].sum()),
        )
    return out


def estimate_size_batched(
    key: torch.Tensor,
    q: "Query",
    db: "Database",
    ranges_by_attr: Mapping[str, "RangeSet"],
    samples: SampleSet,
    cfg: EstimationConfig = EstimationConfig(),
    aqr: Optional[Tuple[GroupEstimates, np.ndarray]] = None,
    catalog: "Optional[Catalog]" = None,
) -> Dict[str, SizeEstimate]:
    """Algorithm 2 + Def. 9 for all candidates of one query in one pass."""
    catalog = _catalog(catalog)
    if not ranges_by_attr:
        return {}
    if aqr is None:
        aqr = approximate_query_result(key, q, db, samples, cfg)
    spec = EstimationSpec(q=q, samples=samples, ranges_by_attr=ranges_by_attr, aqr=aqr)
    return estimate_size_multi(db, [spec], cfg, catalog)[0]


def estimate_size(
    key: torch.Tensor,
    q: "Query",
    db: "Database",
    ranges: "RangeSet",
    samples: SampleSet,
    cfg: EstimationConfig = EstimationConfig(),
    aqr: Optional[Tuple[GroupEstimates, np.ndarray]] = None,
    catalog: "Optional[Catalog]" = None,
) -> SizeEstimate:
    """Algorithm 2 + Def. 9 for one candidate in float64 host math (the
    single-candidate reference; strategies use the batched variant)."""
    catalog = _catalog(catalog)
    est, satisfied = aqr if aqr is not None else approximate_query_result(key, q, db, samples, cfg)
    frag, gids = _candidate_incidence(q, db, samples, ranges, satisfied, cfg, catalog)
    n_r = ranges.n_ranges
    sizes = catalog.fragment_sizes(db[q.table], ranges).astype(np.float64)
    bits = np.zeros(n_r, dtype=bool)
    bits[frag] = True
    est_rows = float(sizes[bits].sum())
    # Def. 9: P(r in P) = 1 - prod_{g in frag} (1 - p_g)   (independent case)
    # with Frechet bounds max_g p_g <= P <= min(1, sum_g p_g).
    p_g = _pass_probabilities(q, est)
    log1m = np.log1p(-np.minimum(p_g[gids], 1 - 1e-12))
    sum_log = np.zeros(n_r)
    np.add.at(sum_log, frag, log1m)
    p_frag = np.where(bits, 1.0 - np.exp(sum_log), 0.0)
    max_p = np.zeros(n_r)
    np.maximum.at(max_p, frag, p_g[gids])
    sum_p = np.zeros(n_r)
    np.add.at(sum_p, frag, p_g[gids])
    total = max(db[q.table].num_rows, 1)
    return SizeEstimate(
        attr=ranges.attr,
        est_rows=est_rows,
        est_selectivity=est_rows / total,
        expected_rows=float((sizes * p_frag).sum()),
        lo_rows=float((sizes * max_p).sum()),
        hi_rows=float((sizes * np.minimum(sum_p, 1.0)).sum()),
        est_bits=bits,
        n_satisfied_groups=int(satisfied.sum()),
    )
