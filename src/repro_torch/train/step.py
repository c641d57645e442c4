"""Train, prefill and decode steps (the port of ``repro/train/step.py``).

``train_step`` accumulates gradients over the microbatch axis in a Python
loop (the reference's ``lax.scan``): each microbatch's gradients come out of
autograd in the parameters' dtype, are cast to ``acc_dtype`` and added;
the sum is divided by the number of microbatches and handed to
``adamw_update``.  Those are the reference's rounding points.  On the card
every attention layer's forward and backward run the flash-attention
kernels (``models/layers.py::gqa_chunked``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.device import DeviceLike
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.models.params import tree_leaves, tree_unflatten
from repro_torch.optim.adamw import OptConfig, adamw_update, init_opt_state


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    """Per-(arch, shape) fitting knobs."""

    microbatch: int = 8  # microbatches a step, as launch/train.py passes it (--n-micro)
    opt: OptConfig = OptConfig()
    acc_dtype: str = "float32"  # grad-accumulator dtype


def init_train_state(cfg: ModelConfig, spec: TrainSpec, *, seed: int = 0,
                     device: DeviceLike = None) -> Dict[str, Any]:
    """{"params": random weights from ``seed``, "opt": fresh AdamW state} on
    ``device`` (CUDA unless ``"cpu"``)."""
    params = lm.concrete_params(cfg, seed=seed, device=device)
    return {"params": params, "opt": init_opt_state(params, spec.opt)}


def make_train_step(cfg: ModelConfig, spec: TrainSpec):
    """(state, batch) -> (state, metrics).

    ``batch`` leaves have shape (n_micro, micro_batch, ...): the leading
    axis is the accumulation loop.  The state is not modified: the step
    returns a new one.  Metrics: ``loss``, ``grad_norm`` and ``lr``, float32
    0-d tensors on the state's device.
    """
    acc_dt = torch_dtype(spec.acc_dtype)

    def train_step(state, batch):
        params = state["params"]
        flat = tree_leaves(params)
        n_micro = next(iter(batch.values())).shape[0]
        gacc = [torch.zeros(p.shape, dtype=acc_dt, device=p.device) for p in flat]
        lsum = torch.zeros((), dtype=torch.float32, device=flat[0].device)
        for i in range(n_micro):
            mb = {k: x[i] for k, x in batch.items()}
            live = [p.detach().requires_grad_(True) for p in flat]
            with torch.enable_grad():
                loss = lm.loss_fn(tree_unflatten(params, live, dicts=True), cfg, mb)
                grads = torch.autograd.grad(loss, live)
            for a, g in zip(gacc, grads):
                a.add_(g.to(acc_dt))
            lsum = lsum + loss.detach()
            del live, grads, loss
        for a in gacc:
            a.div_(n_micro)
        new_params, new_opt, metrics = adamw_update(tree_unflatten(params, gacc), state["opt"],
                                                    params, spec.opt)
        metrics["loss"] = lsum / n_micro
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        return lm.prefill(params, cfg, batch)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, cache, token, pos):
        return lm.decode_step(params, cfg, cache, token, pos)

    return decode_step


def microbatch_reshape(batch: Dict[str, torch.Tensor], n_micro: int) -> Dict[str, torch.Tensor]:
    """(B, ...) -> (n_micro, B/n_micro, ...) for the accumulation loop."""

    def leaf(x):
        b = x.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} is not a multiple of {n_micro} microbatches")
        return x.reshape(n_micro, b // n_micro, *x.shape[1:])

    return {k: leaf(x) for k, x in batch.items()}
