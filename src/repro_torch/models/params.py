"""Parameter specs: one tree describing shapes, logical axes and init (the
port of ``repro/models/params.py``).

A model builds a nested dict of ``P`` leaves.  From it come the concrete
parameters: a :class:`ParamTree` module whose nesting mirrors the spec, so
``params["periods"]["b0"]["mixer"]["wq"]`` names the same leaf as in the
reference and ``state_dict()`` keys read ``periods.b0.mixer.wq``.  The
logical axes are kept for the sharding rules a later slice ports; on one
card nothing reads them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device

Axes = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class P:
    """A parameter leaf spec."""

    shape: Tuple[int, ...]
    axes: Axes  # logical axis names per dim (None = replicated dim)
    init: str = "normal"  # 'normal' | 'zeros' | 'ones' | 'embed'
    scale: float = 0.02

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map_p(fn: Callable[[P], Any], tree: Any) -> Any:
    """Apply ``fn`` to every ``P`` leaf of a nested dict."""
    if isinstance(tree, P):
        return fn(tree)
    return {k: tree_map_p(fn, v) for k, v in tree.items()}


def leaves(tree: Any, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs of a nested mapping in sorted key order, the order
    ``jax.tree_util`` flattens a dict in."""
    if not isinstance(tree, (Mapping, ParamTree)):
        yield prefix, tree
        return
    for k in sorted(tree.keys()):
        yield from leaves(tree[k], prefix + (k,))


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a nested mapping (dicts, ``ParamTree``s) in
    :func:`leaves`' order, jax's flatten order for the same dicts."""
    return [x for _, x in leaves(tree)]


def tree_unflatten(like: Any, flat: Sequence[Any], dicts: bool = False) -> Any:
    """``like``'s structure with ``flat`` (in :func:`tree_leaves` order) as
    its leaves: a ``ParamTree`` where ``like`` has one, else dicts.  With
    ``dicts`` only dicts, whose leaves are ``flat``'s tensors themselves (a
    ``ParamTree`` makes each leaf a new ``nn.Parameter``)."""
    it = iter(flat)

    def build(node):
        if not isinstance(node, (Mapping, ParamTree)):
            return next(it)
        out = {k: build(node[k]) for k in sorted(node.keys())}
        return ParamTree(out) if isinstance(node, ParamTree) and not dicts else out

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure has")
    return out


def stack(tree: Any, n: int, axis_name: str = "layers") -> Any:
    """Add a leading stacked-layers dim to every leaf (one entry per period)."""
    return tree_map_p(
        lambda p: P((n,) + p.shape, (axis_name,) + p.axes, p.init, p.scale), tree
    )


def n_params(tree: Any) -> int:
    return sum(math.prod(p.shape) for _, p in leaves(tree))


class ParamTree(nn.Module):
    """Nested parameters: a child ``ParamTree`` per dict level, an
    ``nn.Parameter`` per leaf, without ``requires_grad`` (the train step
    differentiates detached copies of the leaves, ``train/step.py``).  Indexes like
    the reference's dict tree (``tree[key]``, ``key in tree``)."""

    def __init__(self, tree: Mapping[str, Any]):
        super().__init__()
        self._keys = tuple(sorted(tree))
        for k in self._keys:
            v = tree[k]
            if isinstance(v, torch.Tensor):
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))
            elif isinstance(v, ParamTree):
                self.add_module(k, v)
            else:
                self.add_module(k, ParamTree(v))

    def __getitem__(self, key: str):
        if key not in self._keys:
            raise KeyError(key)
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._keys

    def keys(self) -> Tuple[str, ...]:
        return self._keys

    def items(self):
        return ((k, self[k]) for k in self._keys)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "ParamTree":
        """A new tree of ``fn(leaf)`` for every leaf (e.g. a cast)."""
        return ParamTree(_map_tensors(self, fn))


def _map_tensors(tree, fn) -> Dict[str, Any]:
    return {k: fn(v) if isinstance(v, torch.Tensor) else _map_tensors(v, fn)
            for k, v in tree.items()}


def init_params(spec: Any, dtype: torch.dtype, *, seed: int = 0,
                device: DeviceLike = None) -> ParamTree:
    """Concrete initialization with the reference's scales: ``1/sqrt(fan_in)``
    (``fan_in`` the second-to-last dim, as the reference takes it), 0.02 for
    ``init='embed'``, zeros and ones.  Leaves are drawn in flattening order
    from one ``torch.Generator`` seeded with ``seed`` on ``device``; the
    numbers differ from ``jax.random``'s (tests carry the reference's
    weights across with ``convert.lm_params_from_numpy``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out: Dict[str, Any] = {}
    for path, p in leaves(spec):
        if p.init == "zeros":
            x = torch.zeros(p.shape, dtype=dtype, device=dev)
        elif p.init == "ones":
            x = torch.ones(p.shape, dtype=dtype, device=dev)
        else:
            fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
            scale = p.scale if p.init == "embed" else 1.0 / math.sqrt(max(fan_in, 1))
            # Scaled in place: one float32 temporary a leaf (17.7 GB for
            # qwen2-moe's largest), not two.
            x = torch.randn(p.shape, generator=gen, dtype=torch.float32,
                            device=dev).mul_(scale).to(dtype)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    return ParamTree(out)
