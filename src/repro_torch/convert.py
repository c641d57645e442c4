"""Carry state across from the JAX reference: databases, sketches, LM
weights and training state.

The engine's "weights" are its data and its captured sketches; the LM's
are its parameter tree.  All travel as numpy arrays
(``ColumnTable.to_numpy()``, ``sketch.bits``, the reference's parameter
leaves as ``np.asarray``), so a database built, a sketch captured or a
model initialised by ``repro`` can be rebuilt here, and both packages then
compute the same thing.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, Iterable, Mapping, Tuple

import numpy as np
import torch

from repro_torch.core.ranges import RangeSet
from repro_torch.core.sketch import ProvenanceSketch
from repro_torch.core.table import ColumnTable, Database, from_numpy
from repro_torch.device import DeviceLike, resolve_device, to_host
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.models.lm import build_param_spec
from repro_torch.models.params import ParamTree, leaves

if TYPE_CHECKING:
    from repro_torch.train.step import TrainSpec

TableSpec = Tuple[str, Mapping[str, np.ndarray], Iterable[str]]


def database_from_numpy(tables: Iterable[TableSpec], device: DeviceLike = None) -> Database:
    """A ``Database`` from ``(name, columns, primary_key)`` triples, e.g.
    ``(t.name, t.to_numpy(), t.primary_key)`` for each reference table."""
    built = {}
    for name, columns, primary_key in tables:
        built[name] = from_numpy(name, columns, primary_key, device=device)
    return Database(built)


def sketch_from_numpy(
    table: ColumnTable,
    attr: str,
    bounds: np.ndarray,
    bits: np.ndarray,
    size_rows: int,
    total_rows: int,
) -> ProvenanceSketch:
    """A ``ProvenanceSketch`` over ``table`` (current for its version) from a
    reference sketch's partition bounds, bits and sizes."""
    bits = np.asarray(bits, dtype=bool)
    ranges = RangeSet(attr, np.asarray(bounds, dtype=np.float64))
    if bits.shape != (ranges.n_ranges,):
        raise ValueError(f"{bits.shape[0]} bits for {ranges.n_ranges} ranges")
    if total_rows != table.num_rows:
        raise ValueError(f"sketch of {total_rows} rows for a table of {table.num_rows}")
    return ProvenanceSketch(
        table=table.name, ranges=ranges, bits=bits, size_rows=int(size_rows),
        total_rows=int(total_rows), table_uid=table.uid, table_version=table.version,
    )


def _leaf_to_tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    arr = np.array(arr)  # a writable contiguous copy (jax hands out read-only views)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' numpy bfloat16: carry the bits
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _tree_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig, dtype: torch.dtype,
                     dev: torch.device, what: str) -> ParamTree:
    """A tree shaped as ``cfg``'s parameters, of ``dtype``, from numpy leaves."""
    want = dict(leaves(build_param_spec(cfg)))
    have = dict(leaves(tree))
    if set(want) != set(have):
        raise ValueError(f"{what} does not match {cfg.name}: missing "
                         f"{sorted(set(want) - set(have))}, extra {sorted(set(have) - set(want))}")
    out: Dict[str, Any] = {}
    for path, spec in want.items():
        x = _leaf_to_tensor(np.asarray(have[path]), dev)
        if tuple(x.shape) != spec.shape or x.dtype != dtype:
            raise ValueError(f"{what} {'/'.join(path)}: {tuple(x.shape)} {x.dtype}, expected "
                             f"{spec.shape} {dtype}")
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    return ParamTree(out)


def lm_params_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig,
                         device: DeviceLike = None) -> ParamTree:
    """The port's parameters from the reference's parameter tree (nested
    dicts with stacked ``periods`` and ``rem``; leaves as numpy, e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``), bit for bit, on
    ``device`` (CUDA unless ``"cpu"``).  Raises when a leaf is missing,
    extra, or of another shape or dtype than ``cfg`` gives it."""
    return _tree_from_numpy(tree, cfg, torch_dtype(cfg.dtype), resolve_device(device),
                            "parameter tree")


def train_state_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig, spec: "TrainSpec",
                           device: DeviceLike = None) -> Dict[str, Any]:
    """The port's train state (``train.step.init_train_state``'s structure)
    from the reference's (``{"params", "opt": {"m", "v", "master", "step"}}``
    with numpy leaves), bit for bit, on ``device``: the parameters through
    :func:`lm_params_from_numpy`, the moments in ``spec.opt.opt_dtype``, the
    master copy in float32 and ``step`` an int32 0-d tensor."""
    dev = resolve_device(device)
    opt = tree["opt"]
    keys = {"m", "v", "step"} | ({"master"} if spec.opt.use_master else set())
    if set(opt) != keys:
        raise ValueError(f"optimizer state has {sorted(opt)}, expected {sorted(keys)}")
    step = np.asarray(opt["step"])
    if step.shape != () or step.dtype != np.int32:
        raise ValueError(f"opt/step: {step.shape} {step.dtype}, expected () int32")
    moment = torch_dtype(spec.opt.opt_dtype)
    state = {"m": _tree_from_numpy(opt["m"], cfg, moment, dev, "opt/m"),
             "v": _tree_from_numpy(opt["v"], cfg, moment, dev, "opt/v"),
             "step": torch.from_numpy(step.copy()).to(dev)}
    if spec.opt.use_master:
        state["master"] = _tree_from_numpy(opt["master"], cfg, torch.float32, dev, "opt/master")
    return {"params": lm_params_from_numpy(tree["params"], cfg, dev), "opt": state}


def train_state_to_numpy(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`train_state_from_numpy`: the reference's train
    state as nested dicts of numpy arrays (bf16 as ml_dtypes' ``bfloat16``)."""
    opt = state["opt"]
    out = {k: lm_params_to_numpy(v) for k, v in opt.items() if k != "step"}
    out["step"] = to_host(opt["step"])
    return {"params": lm_params_to_numpy(state["params"]), "opt": out}


def lm_params_to_numpy(params: ParamTree) -> Dict[str, Any]:
    """The inverse of :func:`lm_params_from_numpy`: nested dicts of numpy
    arrays (bfloat16 leaves as ml_dtypes' ``bfloat16``, the reference's
    numpy type for them)."""
    out: Dict[str, Any] = {}
    for path, x in leaves(params):
        if x.dtype == torch.bfloat16:
            import ml_dtypes

            arr = to_host(x.view(torch.int16)).view(ml_dtypes.bfloat16)
        else:
            arr = to_host(x)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    return out
