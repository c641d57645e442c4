"""End-to-end training driver with the PBDS-sketched data pipeline (the port
of ``repro/launch/train.py``).

Curation query -> cost-based sketch selection -> fragment-skipping loader ->
train_step with grad accumulation -> checkpoint/resume -> straggler
monitoring, on one device: CUDA unless ``--device cpu``.  The reference's
host mesh (``launch/mesh.py``) is an identity on one card and is not ported
yet (ROADMAP A7.6).  On the card every attention layer's forward and
backward run the flash-attention kernels, and curation runs the engine's.

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b --smoke \\
      --steps 50 --batch 8 --seq 128 [--ckpt DIR] [--resume] [--device cpu]

The reference declares ``--smoke`` as ``store_true`` with ``default=True``,
so it can never train a full config; here ``--no-smoke`` trains one.

The MoE configs (``--arch qwen2-moe-a2.7b``, ``qwen3-moe-30b-a3b``) train
at ``--smoke``, on the CPU too.  At full width neither fits one card: the
bf16 weights and gradients, the f32 master and the two f32 moments come to
16 bytes a parameter (the f32 gradient accumulator adds 4 more), 242 GB
for qwen2-moe's 15.15 B parameters (its padded experts included) and 481 GB
for qwen3-moe's 30.1 B, against the card's 80 GB; they wait for the
multi-card path (ROADMAP A7.6).

The recurrent configs (``--arch xlstm-350m``, ``jamba-1.5-large-398b``)
train on the card through the selective-scan and sLSTM-scan kernels,
forward and backward (``--arch xlstm-350m --no-smoke`` at full width and
depth; jamba-1.5-large's full state does not fit one card), and at
``--smoke`` on the CPU, where autograd differentiates the scans' plain
versions.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, get_config
from repro_torch.data import CurationSpec, SketchedDataPipeline, make_corpus_metadata
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import OptConfig
from repro_torch.runtime import StragglerMonitor
from repro_torch.train.step import (TrainSpec, init_train_state, make_train_step,
                                    microbatch_reshape)

# Under the checkout's git-ignored build/ (the reference writes /tmp/repro_ckpt).
DEFAULT_CKPT = str(Path(__file__).resolve().parents[3] / "build" / "repro_torch_ckpt")


def make_batch_for(cfg: ModelConfig, raw, seq: int, device: DeviceLike = None
                   ) -> Dict[str, torch.Tensor]:
    """Adapt a raw token batch to the arch's input signature on ``device``.
    The ported configs take tokens only (vision and encoder-decoder configs
    wait for their slice, ROADMAP A7)."""
    return {"tokens": torch.from_numpy(np.ascontiguousarray(raw["tokens"][:, :seq])).to(
        resolve_device(device))}


def train(cfg: ModelConfig, *, steps: int = 50, batch: int = 8, seq: int = 128,
          n_micro: int = 2, ckpt_dir: str = DEFAULT_CKPT, ckpt_every: int = 20,
          resume: bool = False, quality_threshold: float = 0.55, seed: int = 0,
          device: DeviceLike = None) -> List[float]:
    """The reference's training loop; prints its lines and returns the
    losses of the steps it ran."""
    dev = resolve_device(device)
    print(f"[train] arch={cfg.name} params={cfg.param_count():,}")

    # --- PBDS data curation (the paper's technique, online) ----------------
    meta = make_corpus_metadata(n_docs=20_000, seed=seed, device=dev)
    cur = CurationSpec(having_value=quality_threshold)
    pipe = SketchedDataPipeline(meta, cur, batch, seq, cfg.vocab_size, seed=seed, device=dev)
    ri = pipe.run_info
    print(
        f"[train] curation: strategy={ri.strategy} attr={ri.attr} "
        f"sketch_sel={ri.selectivity if ri.selectivity is not None else 1.0:.3f} "
        f"skipped={pipe.skipped_fraction:.1%} of corpus "
        f"(select={ri.t_select*1e3:.0f}ms capture={ri.t_capture*1e3:.0f}ms)"
    )

    # --- model / optimizer ---------------------------------------------------
    spec = TrainSpec(microbatch=n_micro, opt=OptConfig(total_steps=max(steps, 2)))
    state = init_train_state(cfg, spec, seed=seed, device=dev)
    step_fn = make_train_step(cfg, spec)
    ckpt = CheckpointManager(ckpt_dir, keep=3)

    start = 0
    if resume:
        try:
            state, extra = ckpt.restore(state)
            start = int(extra.get("step", 0))
            pipe.restore(extra.get("pipeline", pipe.state()))
            print(f"[train] resumed from step {start}")
        except FileNotFoundError:
            print("[train] no checkpoint found; fresh start")

    mon = StragglerMonitor()
    it = iter(pipe)
    losses = []
    for step in range(start, steps):
        t0 = time.perf_counter()
        raw = next(it)
        mb = microbatch_reshape(make_batch_for(cfg, raw, seq, dev), n_micro)
        state, metrics = step_fn(state, mb)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        slow = mon.observe(dt)
        losses.append(loss)
        if step % 10 == 0 or step == steps - 1:
            print(f"[train] step={step} loss={loss:.4f} gnorm={float(metrics['grad_norm']):.3f} "
                  f"dt={dt*1e3:.0f}ms{' STRAGGLER' if slow else ''}")
        if (step + 1) % ckpt_every == 0 or step == steps - 1:
            ckpt.save(step + 1, state, extra={"step": step + 1, "pipeline": pipe.state()})
    ckpt.wait()
    if losses:
        print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"(improved={losses[-1] < losses[0]}) ckpts={ckpt.all_steps()}")
    return losses


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="stablelm-1.6b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--n-micro", type=int, default=2)
    ap.add_argument("--ckpt", default=DEFAULT_CKPT)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--quality-threshold", type=float, default=0.55)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = get_config(args.arch, smoke=args.smoke)
    train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, n_micro=args.n_micro,
          ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every, resume=args.resume,
          quality_threshold=args.quality_threshold, seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
