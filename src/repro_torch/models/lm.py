"""Model assembly for decoder-only LMs, dense and MoE (the port of
``repro/models/lm.py``): the parameter tree, the training loss, prefill and
cached decode.

The parameter tree keeps the reference's layout: one period of the layer
pattern (``cfg.pattern``) stacked over ``n_periods`` (leaves carry a leading
period axis), then the unrolled remainder blocks.  The reference scans the
stacked periods with ``lax.scan``; here a Python loop walks them, indexing
each leaf at its period.

Entry points:
  loss_fn(params, cfg, batch)                -- training loss (xent + MoE aux)
  prefill(params, cfg, batch)                -- full-seq forward -> last logits
  decode_step(params, cfg, cache, token, pos) -- one token against the cache

Training differentiates ``loss_fn`` with autograd; ``remat="full"``
recomputes each period in the backward (``torch.utils.checkpoint``, the
reference's ``jax.checkpoint`` around its scan body).  The port has the
mixers ``attn``/``swa``, ``mamba``, ``mlstm`` and ``slstm`` (``ssm.py``) and
the FFNs ``mlp``, ``moe`` and ``none``; the vision front end and
encoder-decoder configs raise ``NotImplementedError`` (ROADMAP A7).  On the
card the mamba and sLSTM scans' gradients run their backward kernels; under
``remat="full"`` the first forward of a period writes none of their
residuals, the recomputation does.  The reference's ``parallel/context.py``
sharding constraints are identities on one card and are not called.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import residuals
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import Block, ModelConfig
from repro_torch.models.params import P, ParamTree, init_params, stack

WAITS = "waits for its slice of the LM port (ROADMAP A7)"


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} {WAITS}")


MIXERS = ("attn", "swa", "mamba", "mlstm", "slstm")
FFNS = ("mlp", "moe", "none")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port does not have yet: every block's mixer must
    be one of ``MIXERS`` and its FFN one of ``FFNS``, with no front end and
    no encoder."""
    if cfg.is_encdec:
        raise _unsupported(f"{cfg.name}: the encoder-decoder backbone")
    if cfg.frontend:
        raise _unsupported(f"{cfg.name}: the {cfg.frontend} front end")
    for mixer, ffn in cfg.all_blocks:
        if mixer not in MIXERS:
            raise ValueError(f"{cfg.name}: no mixer {mixer!r}")
        if ffn not in FFNS:
            raise ValueError(f"{cfg.name}: no FFN {ffn!r}")


# ---------------------------------------------------------------------------
# Parameter tree construction
# ---------------------------------------------------------------------------


def _mixer_params(cfg: ModelConfig, mixer: str) -> Dict[str, Any]:
    if mixer == "mamba":
        return S.mamba_params(cfg)
    if mixer == "mlstm":
        return S.mlstm_params(cfg)
    if mixer == "slstm":
        return S.slstm_params(cfg)
    return L.attn_params(cfg)


def _block_params(cfg: ModelConfig, block: Block) -> Dict[str, Any]:
    """The block's mixer and, unless its FFN is ``none``, its FFN."""
    mixer, ffn = block
    p: Dict[str, Any] = {"mixer": _mixer_params(cfg, mixer)}
    if ffn != "none":
        p["ffn"] = L.moe_params(cfg) if ffn == "moe" else L.mlp_params(cfg)
    return p


def build_param_spec(cfg: ModelConfig) -> Dict[str, Any]:
    check_supported(cfg)
    d, vp = cfg.d_model, cfg.vocab_p
    spec: Dict[str, Any] = {
        "embed": P((vp, d), ("vocab", "embed"), init="embed"),
        "final_norm": L.norm_params(d),
        "lm_head": P((d, vp), ("embed", "vocab")),
    }
    period = {f"b{j}": _block_params(cfg, blk) for j, blk in enumerate(cfg.pattern)}
    spec["periods"] = stack(period, cfg.n_periods)
    if cfg.remainder:
        spec["rem"] = {f"r{j}": _block_params(cfg, blk) for j, blk in enumerate(cfg.remainder)}
    return spec


def concrete_params(cfg: ModelConfig, *, seed: int = 0, device: DeviceLike = None) -> ParamTree:
    """Random weights at the reference's scales in ``cfg.dtype`` on
    ``device`` (CUDA unless ``"cpu"``), from a ``torch.Generator`` seeded
    with ``seed``."""
    return init_params(build_param_spec(cfg), L.torch_dtype(cfg.dtype), seed=seed,
                       device=device)


# ---------------------------------------------------------------------------
# Block application (full sequence)
# ---------------------------------------------------------------------------


def _apply_block_train(cfg: ModelConfig, block: Block, p, h: torch.Tensor):
    """(h, aux): the block's output and its MoE aux loss (0 for ``mlp``, as
    the reference sets it)."""
    mixer, ffn = block
    if mixer == "attn":
        h = L.attention_train(p["mixer"], cfg, h, causal=True)
    elif mixer == "swa":
        h = L.attention_train(p["mixer"], cfg, h, window=cfg.sliding_window)
    elif mixer == "mamba":
        h = S.mamba_train(p["mixer"], cfg, h)
    elif mixer == "mlstm":
        h = S.mlstm_train(p["mixer"], cfg, h)
    else:  # slstm
        h = S.slstm_train(p["mixer"], cfg, h)
    if ffn == "moe":
        return L.moe(p["ffn"], cfg, h)
    if ffn == "mlp":
        return L.mlp(p["ffn"], cfg, h), 0.0
    return h, 0.0


def _period(cfg: ModelConfig, pp, h: torch.Tensor, aux: torch.Tensor):
    """One period of the layer pattern (the reference's scan body): (h, the
    running aux sum), the aux carried as the reference's scan carries it."""
    for j, blk in enumerate(cfg.pattern):
        h, a = _apply_block_train(cfg, blk, pp[f"b{j}"], h)
        aux = aux + a
    return h, aux


def _remat_contexts():
    """The first forward of a recomputed period writes no scan residuals
    (``kernels/residuals.py``): the recomputation's are the ones used."""
    return residuals.skipped(), contextlib.nullcontext()


def _remat(fn: Callable, cfg: ModelConfig) -> Callable:
    """``fn`` recomputed in the backward under ``remat="full"`` (its
    activations are not kept); as it is under ``"none"``."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        raise _unsupported(f"{cfg.name}: remat='dots' (a policy that keeps the matmul "
                           f"outputs)")
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, context_fn=_remat_contexts)


def _period_slices(tree, n: int):
    """The ``n`` periods' parameters out of the stacked tree, as views
    (``torch.unbind``: under autograd their gradients are stacked once)."""
    if isinstance(tree, torch.Tensor):
        return torch.unbind(tree, 0)
    parts = {k: _period_slices(v, n) for k, v in tree.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _period_slice(tree, i: int):
    """Period ``i``'s parameters (or cache) out of the stacked tree: every
    leaf indexed at ``i`` on its leading axis (views, no copies)."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    if isinstance(tree, tuple):  # the sLSTM cache (h, c, n, m)
        return tuple(_period_slice(v, i) for v in tree)
    return {k: _period_slice(v, i) for k, v in tree.items()}


def _run_stack(cfg: ModelConfig, params, h: torch.Tensor, period: Callable = _period):
    """Run the periods in order (each through ``period``), then the
    remainder blocks: (h, the float32 sum of the blocks' MoE aux losses,
    from 0 in block order)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for pp in _period_slices(params["periods"], cfg.n_periods):
        h, aux = period(cfg, pp, h, aux)
    for j, blk in enumerate(cfg.remainder):
        h, a = _apply_block_train(cfg, blk, params["rem"][f"r{j}"], h)
        aux = aux + a
    return h, aux


def _embed(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    # F.embedding's backward on the card sums each token's rows in a fixed
    # order (sorted indices), so a training step's gradients repeat bit for bit.
    emb = F.embedding(tokens.long(), params["embed"])
    # The reference's weak-typed scale is cast to the residual stream's dtype
    # before it multiplies (sqrt(2048) is 45.25 in bf16); torch would multiply
    # by the unrounded float, so round it first.
    return emb * torch.tensor(float(np.sqrt(cfg.d_model)), dtype=emb.dtype).item()


def chunked_xent(cfg: ModelConfig, h: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Cross-entropy with the vocab projection applied in sequence chunks of
    ``cfg.loss_chunk``, so the (B, S, V) logits never exist; V can be 262k.
    Logits in float32, padded vocab entries at -1e30, ``lse - gold`` masked
    by ``mask``, the sum over chunks in order, divided by the mask's count."""
    b, s, d = h.shape
    chunk = min(cfg.loss_chunk, s)
    pad = -s % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    pad_v = None
    if cfg.vocab_p > cfg.vocab_size:
        pad_v = torch.arange(cfg.vocab_p, device=h.device) >= cfg.vocab_size
    loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    n = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(0, s + pad, chunk):
        hh, ll, mm = h[:, c:c + chunk], labels[:, c:c + chunk], mask[:, c:c + chunk]
        logits = torch.einsum("bsd,dv->bsv", hh, head).to(torch.float32)
        if pad_v is not None:
            logits = torch.where(pad_v, torch.full_like(logits, -1e30), logits)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, ll.long()[..., None])[..., 0]
        loss_sum = loss_sum + ((lse - gold) * mm).sum()
        n = n + mm.sum()
    return loss_sum / torch.clamp(n, min=1.0)


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The reference's training loss of ``batch["tokens"]`` (B, S), float32
    0-d: next-token cross-entropy plus 0.01 times the sum of the MoE blocks'
    load-balance aux losses (0 for a dense model, whose loss is the xent
    itself).  ``params`` is the parameter tree (a ``ParamTree`` or nested
    dicts of tensors, e.g. leaves that require grad)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    h = _embed(cfg, params, tokens)
    h, aux = _run_stack(cfg, params, h, period=_remat(_period, cfg))
    h = L.rmsnorm(params["final_norm"], h)
    labels = F.pad(tokens[:, 1:], (0, 1))
    mask = F.pad(torch.ones(tokens[:, 1:].shape, dtype=torch.float32, device=tokens.device),
                 (0, 1))
    return chunked_xent(cfg, h, params["lm_head"], labels, mask) + 0.01 * aux


# -- caches -----------------------------------------------------------------


def _block_cache(cfg: ModelConfig, block: Block, batch: int, length: int, dtype, device):
    """The reference's block cache: ``kv`` for attention, ``ssm`` (mamba's
    state and conv tail, the tail in ``dtype``), ``ml`` (mLSTM's c, n, m) or
    ``sl`` (sLSTM's (h, c, n, m) tuple); recurrent states in float32."""
    mixer, _ = block
    if mixer == "mamba":
        return {"ssm": S.init_mamba_cache(cfg, batch, dtype, device)}
    if mixer == "mlstm":
        return {"ml": S.init_mlstm_cache(cfg, batch, device)}
    if mixer == "slstm":
        return {"sl": S.init_slstm_cache(cfg, batch, device)}
    window = cfg.sliding_window if mixer == "swa" else 0
    return {"kv": L.init_attn_cache(cfg, batch, length, window, dtype, device)}


def init_cache(cfg: ModelConfig, batch: int, length: int, device: DeviceLike = None):
    """Decode cache tree; period leaves stacked over n_periods."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = L.torch_dtype(cfg.kv_dtype or cfg.dtype)
    period = {f"b{j}": _block_cache(cfg, blk, batch, length, dtype, dev)
              for j, blk in enumerate(cfg.pattern)}
    cache: Dict[str, Any] = {"periods": _stack_leaves(period, cfg.n_periods)}
    if cfg.remainder:
        cache["rem"] = {f"r{j}": _block_cache(cfg, blk, batch, length, dtype, dev)
                        for j, blk in enumerate(cfg.remainder)}
    return cache


def _stack_leaves(tree, n: int):
    if isinstance(tree, torch.Tensor):
        return tree[None].repeat((n,) + (1,) * tree.dim())
    if isinstance(tree, tuple):
        return tuple(_stack_leaves(v, n) for v in tree)
    return {k: _stack_leaves(v, n) for k, v in tree.items()}


def _store(cache, new) -> None:
    """Copy a recurrent mixer's new state into its cache tensors (views of
    the stacked cache), leaf by leaf, cast to each leaf's dtype."""
    if isinstance(cache, torch.Tensor):
        cache.copy_(new)
    elif isinstance(cache, tuple):
        for c, x in zip(cache, new):
            _store(c, x)
    else:
        for k, c in cache.items():
            _store(c, new[k])


# -- decode -------------------------------------------------------------------


def _apply_block_decode(cfg: ModelConfig, block: Block, p, c, h: torch.Tensor, pos: int):
    """One block of one decode step; the block's cache ``c`` is updated in
    place (attention writes its slot, a recurrent mixer's new state is
    copied over its old one)."""
    mixer, ffn = block
    if mixer in ("attn", "swa"):
        window = cfg.sliding_window if mixer == "swa" else 0
        h, _ = L.attention_decode(p["mixer"], cfg, h, c["kv"], pos, window=window)
    else:
        step, key = {"mamba": (S.mamba_decode, "ssm"), "mlstm": (S.mlstm_decode, "ml"),
                     "slstm": (S.slstm_decode, "sl")}[mixer]
        h, state = step(p["mixer"], cfg, h, c[key])
        _store(c[key], state)
    if ffn == "moe":  # one position a row: groups of 1, an expert's capacity 1
        return L.moe(p["ffn"], cfg, h)[0]
    if ffn == "mlp":
        return L.mlp(p["ffn"], cfg, h)
    return h


def decode_step(params, cfg: ModelConfig, cache, token: torch.Tensor, pos: int):
    """token (B,) int, pos an int -> (logits (B, vocab_p) float32, cache).

    The cache is updated in place (each period's slice is a view of the
    stacked tensors) and returned.
    """
    h = _embed(cfg, params, token[:, None])
    for i in range(cfg.n_periods):
        pp = _period_slice(params["periods"], i)
        pc = _period_slice(cache["periods"], i)
        for j, blk in enumerate(cfg.pattern):
            h = _apply_block_decode(cfg, blk, pp[f"b{j}"], pc[f"b{j}"], h, pos)
    for j, blk in enumerate(cfg.remainder):
        h = _apply_block_decode(cfg, blk, params["rem"][f"r{j}"], cache["rem"][f"r{j}"], h, pos)
    h = L.rmsnorm(params["final_norm"], h)
    logits = torch.einsum("bsd,dv->bsv", h, params["lm_head"]).to(torch.float32)[:, 0]
    if cfg.vocab_p > cfg.vocab_size:
        pad_v = torch.arange(cfg.vocab_p, device=logits.device) >= cfg.vocab_size
        logits = torch.where(pad_v, torch.full_like(logits, -1e30), logits)
    return logits, cache


# -- prefill ------------------------------------------------------------------


def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Full-sequence forward returning last-position logits (B, vocab_p),
    float32.  On the card every attention layer runs the flash-attention
    kernel, every mamba layer the selective-scan kernel and every sLSTM
    layer the sLSTM-scan kernel."""
    check_supported(cfg)
    h = _embed(cfg, params, batch["tokens"])
    h, _ = _run_stack(cfg, params, h)
    h = L.rmsnorm(params["final_norm"], h)
    return torch.einsum("bd,dv->bv", h[:, -1], params["lm_head"]).to(torch.float32)
