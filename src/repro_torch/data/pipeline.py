"""PBDS-sketched data pipeline (the port of ``repro/data/pipeline.py``): the
paper's technique as the data-curation / request-admission stage.

A corpus (or request pool) carries a *metadata table*, one row per document:
domain, shard, quality, length, timestamp.  A **curation query**, a Q-AGH
over that table such as ``GROUP BY (domain, shard) HAVING avg(quality) >
tau``, defines which documents are relevant.  The port's ``PBDSEngine``
(CB-OPT-GB by default, ``cluster_tables=True``) picks the partition
attribute by sample-based size estimation and captures a provenance sketch;
the loader then **skips whole fragments**: documents in skipped fragments
are never touched or tokenized.

Operational properties, as in the reference: deterministic (every draw from
one seed), sharded (each DP rank draws a disjoint strided stream),
resumable (``state()``/``restore()`` round-trip the cursor).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Tuple

import numpy as np

from repro_torch.core.engine import PBDSEngine
from repro_torch.core.queries import Aggregate, Having, Query, provenance_mask
from repro_torch.core.sketch import apply_sketch
from repro_torch.core.table import PAD_VALID, ColumnTable, Database, from_numpy
from repro_torch.device import DeviceLike, resolve_device, to_host


def make_corpus_metadata(
    n_docs: int = 50_000, n_domains: int = 32, n_shards: int = 256, seed: int = 0,
    device: DeviceLike = None,
) -> ColumnTable:
    """Synthetic corpus metadata with domain-correlated quality (so curation
    queries actually separate data), on ``device`` (CUDA unless ``"cpu"``).
    The same numpy draws as the reference, so the same seed gives the same
    table."""
    rng = np.random.default_rng(seed)
    domain = rng.integers(0, n_domains, n_docs)
    shard = (domain * (n_shards // n_domains) + rng.integers(0, n_shards // n_domains, n_docs))
    base_q = rng.uniform(0.2, 0.9, n_domains)
    quality = np.clip(base_q[domain] + rng.normal(0, 0.15, n_docs), 0, 1)
    length = rng.integers(128, 4096, n_docs)
    timestamp = rng.integers(1_600_000_000, 1_750_000_000, n_docs)
    doc_id = np.arange(n_docs)
    return from_numpy(
        "corpus",
        dict(
            doc_id=doc_id.astype(np.int64),
            domain=domain.astype(np.int32),
            shard=shard.astype(np.int32),
            quality=quality.astype(np.float32),
            length=length.astype(np.int32),
            timestamp=timestamp.astype(np.int64),
        ),
        primary_key=("doc_id",),
        device=device,
    )


@dataclasses.dataclass(frozen=True)
class CurationSpec:
    groupby: Tuple[str, ...] = ("domain", "shard")
    agg: str = "avg"
    agg_attr: str = "quality"
    having_op: str = ">"
    having_value: float = 0.55
    strategy: str = "CB-OPT-GB"
    n_ranges: int = 64
    theta: float = 0.1

    def query(self) -> Query:
        return Query(
            table="corpus",
            groupby=self.groupby,
            agg=Aggregate(self.agg, self.agg_attr),
            having=Having(self.having_op, self.having_value),
        )


class SketchedDataPipeline:
    """Fragment-skipping batch iterator over a sketched corpus.

    The engine runs on ``device`` (CUDA unless ``"cpu"``); a metadata table
    on another device is copied there first.
    """

    def __init__(
        self,
        metadata: ColumnTable,
        spec: CurationSpec,
        batch_size: int,
        seq_len: int,
        vocab_size: int,
        dp_rank: int = 0,
        dp_size: int = 1,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        dev = resolve_device(device)
        if metadata.device != dev:
            metadata = from_numpy(metadata.name, {a: to_host(metadata[a]) for a in metadata.schema},
                                  metadata.primary_key, device=dev)
        self.metadata = metadata
        self.spec = spec
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.dp_rank = dp_rank
        self.dp_size = dp_size
        self.seed = seed

        self.engine = PBDSEngine(
            Database({"corpus": metadata}),
            strategy=spec.strategy,
            n_ranges=spec.n_ranges,
            theta=spec.theta,
            seed=seed,
            # Fragment-major corpus layout: curation queries group by corpus
            # attributes, so groups stay fragment-contained and selection is
            # unaffected by the reorder; loading skips whole fragments.
            cluster_tables=True,
        )
        q = spec.query()
        _, self.run_info = self.engine.run(q)
        self.sketch = self.engine.index.lookup(q)
        if self.sketch is not None:
            # Fragment-skipping load: the catalog-cached sketch instance is
            # the surviving fragments' docs (a slice of the clustered corpus).
            inst = apply_sketch(self.sketch, self.engine.db, catalog=self.engine.catalog)["corpus"]
            doc_ids = to_host(inst["doc_id"])
            if inst.has(PAD_VALID):
                # Instances are pow2-padded with masked duplicate rows; only
                # the valid rows are docs.
                doc_ids = doc_ids[to_host(inst[PAD_VALID])]
            self.selected_docs = np.sort(doc_ids)
        else:  # no viable sketch: the exact predicate
            keep = provenance_mask(q, self.engine.db, catalog=self.engine.catalog)
            self.selected_docs = np.sort(to_host(self.engine.db["corpus"]["doc_id"])[keep])
        self.skipped_fraction = 1.0 - len(self.selected_docs) / max(metadata.num_rows, 1)
        # Deterministic shuffle; strided rank sharding.
        rng = np.random.default_rng(seed + 17)
        self._order = rng.permutation(self.selected_docs)
        self._cursor = 0
        self._epoch = 0

    # -- iterator state (checkpointable) -----------------------------------
    def state(self) -> Dict[str, Any]:
        return {"cursor": int(self._cursor), "epoch": int(self._epoch), "seed": self.seed}

    def restore(self, state: Dict[str, Any]) -> None:
        self._cursor = int(state["cursor"])
        self._epoch = int(state["epoch"])

    # -- batches ------------------------------------------------------------
    def _doc_tokens(self, doc_ids: np.ndarray) -> np.ndarray:
        """Deterministic per-doc token synthesis (stand-in tokenizer): a noisy
        per-document arithmetic progression, the reference's draws."""
        out = np.empty((len(doc_ids), self.seq_len), np.int32)
        v = self.vocab_size
        for i, d in enumerate(doc_ids):
            rng = np.random.default_rng(int(d) * 1_000_003 + 7)
            start = rng.integers(0, v)
            step = 1 + int(d) % 7
            seq = (start + step * np.arange(self.seq_len)) % v
            noise = rng.random(self.seq_len) < 0.1
            seq = np.where(noise, rng.integers(0, v, self.seq_len), seq)
            out[i] = seq.astype(np.int32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        n = len(self._order)
        per_rank = self.batch_size // self.dp_size
        need = per_rank * self.dp_size
        if self._cursor + need > n:
            self._epoch += 1
            rng = np.random.default_rng(self.seed + 17 + self._epoch)
            self._order = rng.permutation(self.selected_docs)
            self._cursor = 0
        take = self._order[self._cursor : self._cursor + need]
        self._cursor += need
        mine = take[self.dp_rank :: self.dp_size]  # strided => elastic-friendly
        return {"tokens": self._doc_tokens(mine)}
