"""AdamW with a cosine schedule and global-norm clipping (the port of
``repro/optim/adamw.py``).

The state mirrors the parameter tree: first and second moments in
``opt_dtype``, an optional float32 master copy, and ``step`` as an int32
0-d tensor on the parameters' device, so the whole train state is one tree
of tensors that ``checkpoint.CheckpointManager`` saves.  The update math
runs in float32 in the reference's order of operations; new parameters are
the float32 result cast to the parameters' dtype.  The update is functional
(new tensors, as the reference returns new arrays).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.models.layers import torch_dtype
from repro_torch.models.params import tree_leaves, tree_unflatten


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    opt_dtype: str = "float32"  # m/v dtype
    use_master: bool = True  # keep fp32 master copy of bf16 params


def schedule(oc: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an int32 tensor): linear warmup, then
    a cosine from ``lr`` down to 0.1 ``lr`` at ``total_steps``; float32."""
    warm = torch.clamp(step / max(oc.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - oc.warmup_steps) / max(oc.total_steps - oc.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return oc.lr * warm * (0.1 + 0.9 * cos)


def init_opt_state(params: Any, oc: OptConfig) -> Dict[str, Any]:
    """Zero moments in ``opt_dtype``, ``step`` 0 and (``use_master``) a
    float32 copy of the parameters, each on its parameter's device."""
    dt = torch_dtype(oc.opt_dtype)
    flat = tree_leaves(params)
    zeros = lambda: tree_unflatten(params, [torch.zeros(p.shape, dtype=dt, device=p.device)
                                            for p in flat])
    state = {"m": zeros(), "v": zeros(),
             "step": torch.zeros((), dtype=torch.int32, device=flat[0].device)}
    if oc.use_master:
        state["master"] = tree_unflatten(params, [p.detach().to(torch.float32) for p in flat])
    return state


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves (in tree order) of each leaf's float32
    sum of squares."""
    sq = sum(torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(tree))
    return torch.sqrt(sq)


def adamw_update(grads: Any, opt_state: Dict[str, Any], params: Any, oc: OptConfig
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (new_params, new_opt_state, metrics) with
    metrics ``grad_norm`` and ``lr`` (float32 0-d tensors)."""
    step = opt_state["step"] + 1
    lr = schedule(oc, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(oc.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)

    b1, b2 = oc.b1, oc.b2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)
    dt = torch_dtype(oc.opt_dtype)
    source = opt_state.get("master", params)

    def upd(g, m, v, p):
        g = g.to(torch.float32) * scale
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g
        v32 = b2 * v.to(torch.float32) + (1 - b2) * g * g
        mh = m32 / bc1
        vh = v32 / bc2
        p32 = p.to(torch.float32)
        new_p = p32 - lr * (mh / (torch.sqrt(vh) + oc.eps) + oc.weight_decay * p32)
        return new_p, m32.to(dt), v32.to(dt)

    flat_pd = tree_leaves(params)
    new_p32, new_m, new_v = [], [], []
    with torch.no_grad():
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(opt_state["m"]),
                              tree_leaves(opt_state["v"]), tree_leaves(source)):
            a, b, c = upd(g, m, v, p)
            new_p32.append(a)
            new_m.append(b)
            new_v.append(c)

    param_dtype = flat_pd[0].dtype
    new_params = tree_unflatten(params, [p.to(param_dtype) for p in new_p32])
    new_state = {"m": tree_unflatten(opt_state["m"], new_m),
                 "v": tree_unflatten(opt_state["v"], new_v), "step": step}
    if "master" in opt_state:
        new_state["master"] = tree_unflatten(opt_state["master"], new_p32)
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
