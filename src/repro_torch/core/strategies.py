"""Candidate-attribute selection strategies (Sec. 9 / Sec. 11.1.3); port of
``repro/core/strategies.py``.

Random baselines: RAND-ALL, RAND-REL-ALL, RAND-GB, RAND-PK, RAND-AGG (one
                  ``prng.randint`` pick from the candidate pool).
Cost-based:       CB-OPT (all safe attrs), CB-OPT-REL (query-relevant),
                  CB-OPT-GB (group-by attrs only — the paper's winner).
Oracles:          OPT (exact capture of every candidate), NO-PS (in the engine).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import prng
from repro_torch.aqp.sampling import AQRCache, SampleCache
from repro_torch.aqp.size_estimation import (
    EstimationConfig,
    SizeEstimate,
    approximate_query_result,
    estimate_size_batched,
    satisfied_groups,
)
from repro_torch.core.catalog import Catalog, default_catalog
from repro_torch.core.queries import Query
from repro_torch.core.ranges import RangeSet, equi_depth_ranges
from repro_torch.core.safety import prefilter_candidates, safe_attributes, stats_prefilter
from repro_torch.core.sketch import actual_size
from repro_torch.core.table import Database

RANDOM_STRATEGIES = ("RAND-ALL", "RAND-REL-ALL", "RAND-GB", "RAND-PK", "RAND-AGG")
COST_STRATEGIES = ("CB-OPT", "CB-OPT-REL", "CB-OPT-GB")
ALL_STRATEGIES = RANDOM_STRATEGIES + COST_STRATEGIES + ("OPT",)


@dataclasses.dataclass(frozen=True)
class SelectionConfig:
    """Knobs for the selection critical path (all engine-default ON).

    ``stats_prefilter``: dominance-prune candidates from catalog summary
    statistics before any sampling.  ``skip_single_candidate``: a pool of
    one candidate is admitted estimate-free.  ``reuse_aware`` /
    ``reuse_window`` / ``reuse_weight``: each recent-window query a candidate
    sketch would serve discounts its estimated coverage by ``reuse_weight``.
    ``cache``: memoize whole selection passes per (strategy, table version,
    theta, n_ranges, HAVING ops, inner-block signature).
    """

    stats_prefilter: bool = True
    skip_single_candidate: bool = True
    reuse_aware: bool = True
    reuse_window: int = 256
    reuse_weight: float = 0.12
    cache: bool = True

    @classmethod
    def paper_faithful(cls) -> "SelectionConfig":
        """Sec. 8-9 selection exactly as the paper ran it."""
        return cls(stats_prefilter=False, skip_single_candidate=False,
                   reuse_aware=False, cache=False)


PAPER_FAITHFUL = SelectionConfig.paper_faithful()


@dataclasses.dataclass
class SelectionResult:
    strategy: str
    attr: Optional[str]  # chosen attribute (None => no viable candidate)
    candidates: Tuple[str, ...]
    estimates: Dict[str, SizeEstimate]  # filled for cost-based strategies
    topk: Tuple[str, ...] = ()  # ranking, best first (cost-based only)


def selection_cache_key(
    strategy: str, q: Query, table: "object", theta: float, n_ranges: int
) -> Tuple:
    """Identity of one memoized selection pass (everything it consumes
    besides threshold values)."""
    ops = (q.having.op if q.having else None,
           q.outer_having.op if q.outer_having else None)
    return ((strategy, table.uid, table.version, theta, n_ranges, ops)
            + q.inner_signature())


class SelectionCache:
    """Memoized selection passes: repeat templates pay ~zero.  Bounded FIFO."""

    def __init__(self, max_entries: int = 512):
        self._cache: Dict[Tuple, SelectionResult] = {}
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0

    def get(self, key: Tuple) -> Optional[SelectionResult]:
        hit = self._cache.get(key)
        if hit is not None:
            self.hits += 1
            return hit
        self.misses += 1
        return None

    def put(self, key: Tuple, result: SelectionResult) -> None:
        if len(self._cache) >= self.max_entries:
            self._cache.pop(next(iter(self._cache)))
        self._cache[key] = result

    def invalidate(self, table_name: str) -> None:
        # Key layout: (strategy, uid, version, theta, n_ranges, ops) +
        # inner_signature, whose first element is the table name.
        for ck in [ck for ck in self._cache if ck[6] == table_name]:
            del self._cache[ck]

    def __len__(self) -> int:
        return len(self._cache)


def candidate_pool(
    strategy: str, q: Query, db: Database, n_ranges: int,
    catalog: Optional[Catalog] = None,
) -> Tuple[str, ...]:
    """The strategy-specific candidate set, safety-checked and pre-filtered."""
    catalog = catalog or default_catalog()
    fact = db[q.table]
    safe = set(safe_attributes(q, db, catalog=catalog))
    if strategy in ("RAND-ALL", "CB-OPT", "OPT"):
        pool = tuple(sorted(safe))
    elif strategy in ("RAND-REL-ALL", "CB-OPT-REL"):
        pool = tuple(a for a in q.relevant_attrs if a in safe and fact.has(a))
    elif strategy in ("RAND-GB", "CB-OPT-GB"):
        pool = tuple(a for a in q.groupby if a in safe and fact.has(a))
    elif strategy == "RAND-PK":
        pool = tuple(a for a in fact.primary_key if a in safe)
    elif strategy == "RAND-AGG":
        pool = tuple([q.agg.attr] if q.agg.attr and q.agg.attr in safe else [])
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    return prefilter_candidates(q, db, pool, n_ranges, catalog=catalog)


def select_attribute(
    strategy: str,
    key: torch.Tensor,
    q: Query,
    db: Database,
    n_ranges: int,
    sample_cache: Optional[SampleCache] = None,
    theta: float = 0.05,
    cfg: EstimationConfig = EstimationConfig(),
    ranges_for: Optional[Callable[[str], RangeSet]] = None,
    topk: int = 1,
    catalog: Optional[Catalog] = None,
    aqr_cache: Optional[AQRCache] = None,
    selection: Optional[SelectionConfig] = None,
    selection_cache: Optional[SelectionCache] = None,
) -> SelectionResult:
    """Pick the partition attribute for ``q`` under ``strategy``.

    ``selection=None`` is the paper-faithful pass; the engine threads its
    :class:`SelectionConfig` plus a shared :class:`SelectionCache`, which
    only the cost-based strategies consult.
    """
    catalog = catalog or default_catalog()
    sel_cfg = selection if selection is not None else PAPER_FAITHFUL
    cost_based = strategy in COST_STRATEGIES
    ck = None
    if cost_based and sel_cfg.cache and selection_cache is not None:
        ck = selection_cache_key(strategy, q, db[q.table], theta, n_ranges)
        hit = selection_cache.get(ck)
        if hit is not None:
            return hit

    def done(result: SelectionResult) -> SelectionResult:
        if ck is not None:
            selection_cache.put(ck, result)
        return result

    cands = candidate_pool(strategy, q, db, n_ranges, catalog=catalog)
    ranges_for = ranges_for or (lambda a: equi_depth_ranges(db[q.table], a, n_ranges))
    if cost_based and sel_cfg.stats_prefilter:
        cands = stats_prefilter(q, db, cands, ranges_for, catalog=catalog)
    if not cands:
        return done(SelectionResult(strategy, None, cands, {}))

    if strategy in RANDOM_STRATEGIES:
        # One scalar draw on the host, bit-equal with jax.random.randint.
        i = int(prng.randint(key, (), 0, len(cands), device="cpu"))
        return SelectionResult(strategy, cands[i], cands, {})

    if strategy == "OPT":
        sizes = {a: actual_size(q, db, ranges_for(a)) for a in cands}
        best = min(sizes, key=lambda a: (sizes[a], a))
        ranking = tuple(sorted(sizes, key=lambda a: (sizes[a], a)))
        return SelectionResult(strategy, best, cands, {}, topk=ranking[:topk])

    if cost_based and sel_cfg.skip_single_candidate and len(cands) == 1:
        # Nothing to rank: admit the lone survivor estimate-free.
        return done(SelectionResult(strategy, cands[0], cands, {}, topk=cands))

    # Cost-based: one shared AQR pass, then all candidates' fragment
    # incidence in a single batched pass (Sec. 8).
    sample_cache = sample_cache or SampleCache()
    k_s, k_e = prng.split(key)
    samples = sample_cache.get_or_create(k_s, db[q.table], q.groupby_on_fact(db), theta)
    if aqr_cache is not None:
        est, sampled = aqr_cache.get_or_compute(k_e, q, db, samples, theta, cfg)
        aqr = (est, satisfied_groups(q, est, sampled))
    else:
        aqr = approximate_query_result(k_e, q, db, samples, cfg)
    estimates: Dict[str, SizeEstimate] = estimate_size_batched(
        prng.fold_in(k_e, 1), q, db, {a: ranges_for(a) for a in cands},
        samples, cfg, aqr=aqr, catalog=catalog,
    )
    # Equal estimates resolve by attribute name, never by dict order.
    ranking = tuple(sorted(estimates, key=lambda a: (estimates[a].est_rows, a)))
    return done(SelectionResult(strategy, ranking[0], cands, estimates,
                                topk=ranking[:topk]))

