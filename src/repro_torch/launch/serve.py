"""Serving entry point: batched prefill + greedy decode over sketch-filtered
requests (the port of ``repro/launch/serve.py``).

A request pool carries metadata (the corpus schema); a PBDS sketch filters
which requests a serving policy ("serve only domains whose mean quality
passes tau") touches, then the model prefills the batch and decodes.  On
the card every prefill attention layer runs the flash-attention kernel,
every mamba layer the selective-scan kernel and every sLSTM layer the
sLSTM-scan kernel.  Dense, MoE and recurrent configs serve (``--arch
qwen2-moe-a2.7b --no-smoke`` holds 30.3 GB of bf16 weights on one card,
``--arch xlstm-350m --no-smoke`` 0.91 GB).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b --smoke \\
      --requests 16 --prompt-len 64 --gen 16 [--device cpu]

The reference declares ``--smoke`` as ``store_true`` with ``default=True``,
so it can never serve a full config; here ``--no-smoke`` serves one.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.core.engine import RunInfo
from repro_torch.data import CurationSpec, SketchedDataPipeline, make_corpus_metadata
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamTree


@dataclasses.dataclass
class ServeResult:
    prompt: torch.Tensor  # (B, prompt_len) int32, the admitted requests' tokens
    prefill_logits: torch.Tensor  # (B, vocab_p) float32, last prompt position
    decode_logits: torch.Tensor  # (B, vocab_p), teacher-forced decode at prompt_len - 1
    last_logits: torch.Tensor  # (B, vocab_p), the last decode step's
    generated: torch.Tensor  # (B, gen) int32, greedy
    run_info: RunInfo  # the admission query's engine run
    skipped_fraction: float  # share of the request pool the sketch skipped
    selected_docs: np.ndarray  # the admitted request ids
    t_prefill_s: float
    t_decode_s: float  # every decode step, prompt (teacher-forced) and generation
    n_decode_steps: int

    @property
    def per_token_s(self) -> float:
        return self.t_decode_s / max(self.n_decode_steps, 1)

    @property
    def tokens_per_s(self) -> float:
        return self.prompt.shape[0] / self.per_token_s


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def admit_requests(cfg: ModelConfig, *, requests: int = 16, prompt_len: int = 64,
                   seed: int = 0, n_docs: int = 5_000, device: DeviceLike = None):
    """The sketch-filtered admission: ``(tokens, pipe)``, the first batch of
    ``requests`` admitted prompts of ``prompt_len`` tokens, (B, prompt_len)
    on ``device`` (CUDA unless ``"cpu"``), and the pipeline that admitted
    them."""
    dev = resolve_device(device)
    meta = make_corpus_metadata(n_docs=n_docs, seed=seed, device=dev)
    pipe = SketchedDataPipeline(meta, CurationSpec(), requests, prompt_len, cfg.vocab_size,
                                seed=seed, device=dev)
    return torch.from_numpy(next(iter(pipe))["tokens"]).to(dev), pipe


@torch.inference_mode()
def serve(cfg: ModelConfig, *, requests: int = 16, prompt_len: int = 64, gen: int = 16,
          seed: int = 0, n_docs: int = 5_000, device: DeviceLike = None,
          params: Optional[ParamTree] = None) -> ServeResult:
    """Admit ``requests`` requests through the curation sketch, prefill them
    and decode ``gen`` tokens greedily, on ``device`` (CUDA unless
    ``"cpu"``).  ``params`` defaults to random weights from ``seed``."""
    dev = resolve_device(device)
    if params is None:
        params = lm.concrete_params(cfg, seed=seed, device=dev)
    tokens, pipe = admit_requests(cfg, requests=requests, prompt_len=prompt_len, seed=seed,
                                  n_docs=n_docs, device=dev)
    b = tokens.shape[0]

    # --- prefill + greedy decode ---------------------------------------------
    _sync(dev)
    t0 = time.perf_counter()
    prefill_logits = lm.prefill(params, cfg, {"tokens": tokens})
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    total = prompt_len + gen
    cache = lm.init_cache(cfg, b, total, device=dev)
    # Feed the prompt through the decode path to fill the cache
    # (teacher-forced), then generate greedily.
    tok = tokens[:, 0]
    generated, decode_logits = [], None
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(total - 1):
        logits, cache = lm.decode_step(params, cfg, cache, tok, i)
        if i + 1 < prompt_len:
            tok = tokens[:, i + 1]
        else:
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            generated.append(tok)
        if i == prompt_len - 1:
            decode_logits = logits
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return ServeResult(
        prompt=tokens, prefill_logits=prefill_logits, decode_logits=decode_logits,
        last_logits=logits,
        generated=(torch.stack(generated, dim=1) if generated
                   else torch.empty((b, 0), dtype=torch.int32, device=dev)),
        run_info=pipe.run_info, skipped_fraction=pipe.skipped_fraction,
        selected_docs=pipe.selected_docs, t_prefill_s=t_prefill, t_decode_s=t_decode,
        n_decode_steps=total - 1)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="stablelm-1.6b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = get_config(args.arch, smoke=args.smoke)
    res = serve(cfg, requests=args.requests, prompt_len=args.prompt_len, gen=args.gen,
                seed=args.seed, device=args.device)
    b = res.prompt.shape[0]
    print(f"[serve] admission sketch on {res.run_info.attr}: "
          f"skipping {res.skipped_fraction:.1%} of request pool")
    print(f"[serve] B={b} prefill({args.prompt_len} tok)={res.t_prefill_s*1e3:.0f}ms "
          f"decode={res.per_token_s*1e3:.1f}ms/tok throughput={res.tokens_per_s:.0f} tok/s")
    print(f"[serve] finite logits: {bool(torch.isfinite(res.last_logits).all())}")


if __name__ == "__main__":
    main()
