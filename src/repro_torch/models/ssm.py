"""State-space and recurrent mixers (the port of ``repro/models/ssm.py``):
Mamba (the selective SSM) and xLSTM's mLSTM and sLSTM blocks.  Each has a
full-sequence form for prefill and training and a recurrent form that
decodes one position against an O(1) state.

The names, layouts and rounding points are the reference's.  The two
sequential scans run hand-written kernels on the card, forward and
backward: :func:`mamba_train`'s selective scan with the softplus of dt
before it and the skip term and gate after it
(``kernels/selective_scan.py``, ``csrc/selective_scan.cu`` and
``csrc/selective_scan_bwd.cu``) and :func:`slstm_train`'s recurrence
(``kernels/slstm_scan.py``, ``csrc/slstm_scan.cu`` and
``csrc/slstm_scan_bwd.cu``, the reference's custom VJP); on a CPU tensor
each runs its plain version (``kernels/ref.py``), which autograd
differentiates.  The gates' products, the convolution and the
projections around them are torch ops, as they are einsums around the
scans in the reference.  The mLSTM's chunkwise form is matrix products over
S / chunk chunks and stays torch ops; so does every decode step.

``jax.nn``'s activations are ``kernels/ref.py``'s ``sigmoid``, ``silu``,
``softplus`` and ``log_sigmoid``, each rounded where XLA rounds it (not the
MLP's ``layers.silu`` in float32).  Every recurrent state is float32, ``m``
starting at -1e30; the mamba convolution's tail is stored in the cache's
dtype.  The reference's ``constrain_state`` calls are identities on one
card and are not ported.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import log_sigmoid, sigmoid, silu, slstm_cell, softplus
from repro_torch.kernels.selective_scan import selective_scan_gated
from repro_torch.kernels.slstm_scan import slstm_scan
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import norm_params, rmsnorm
from repro_torch.models.params import P

F32 = torch.float32


# ---------------------------------------------------------------------------
# Mamba (selective SSM, Mamba-1 style)
# ---------------------------------------------------------------------------


def mamba_params(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    r = cfg.ssm_dt_rank
    return {
        "ln": norm_params(d),
        "in_proj": P((d, 2 * di), ("embed", "ssm_inner")),
        "conv": P((cfg.ssm_conv, di), (None, "ssm_inner")),
        "wb": P((di, n), ("ssm_inner", None)),
        "wc": P((di, n), ("ssm_inner", None)),
        "wdt_lo": P((di, r), ("ssm_inner", None)),
        "wdt_hi": P((r, di), (None, "ssm_inner")),
        "dt_bias": P((di,), ("ssm_inner",), init="zeros"),
        "a_log": P((di, n), ("ssm_inner", None), init="ones"),
        "dd": P((di,), ("ssm_inner",), init="ones"),
        "out_proj": P((di, d), ("ssm_inner", "embed")),
    }


def _mamba_gates_raw(p, x1: torch.Tensor):
    """B, C, the raw dt (the einsum's, before ``dt_bias`` and the softplus)
    and a from the post-conv activations ``x1`` (..., di), float32."""
    xf = x1.to(F32)
    bmat = torch.einsum("...i,in->...n", xf, p["wb"].to(F32))
    cmat = torch.einsum("...i,in->...n", xf, p["wc"].to(F32))
    dt = torch.einsum("...i,ir->...r", xf, p["wdt_lo"].to(F32))
    dt = torch.einsum("...r,ri->...i", dt, p["wdt_hi"].to(F32))
    a = -torch.exp(p["a_log"].to(F32))  # (di, n)
    return bmat, cmat, dt, a


def _mamba_gates(p, x1: torch.Tensor):
    """B, C, dt from the post-conv activations ``x1`` (..., di), float32."""
    bmat, cmat, dt, a = _mamba_gates_raw(p, x1)
    return bmat, cmat, softplus(dt + p["dt_bias"].to(F32)), a


def mamba_gated_inputs(p, cfg: ModelConfig, x: torch.Tensor):
    """What :func:`mamba_train` hands :func:`selective_scan_gated`, from x
    (B, S, d): ``(x1, z, dt_raw, dt_bias, a, bmat, cmat, dd)``.  The causal
    depthwise convolution is a sum of shifted products in the model's dtype,
    then ``silu`` in that dtype (``x1``); ``z`` is a view of the in_proj
    output; the gates over the whole sequence in float32, ``dt`` before its
    bias and softplus, which the gated scan applies."""
    s = x.shape[1]
    di = cfg.ssm_expand * x.shape[2]
    h = rmsnorm(p["ln"], x)
    dt_ = x.dtype
    xz = torch.einsum("bsd,de->bse", h, p["in_proj"].to(dt_))
    x1, z = torch.split(xz, di, dim=-1)  # (B, S, di)
    k = cfg.ssm_conv
    xpad = F.pad(x1, (0, 0, k - 1, 0))
    w = p["conv"].to(dt_)
    conv = xpad[:, :s] * w[0]
    for i in range(1, k):
        conv = conv + xpad[:, i:i + s] * w[i]
    x1 = silu(conv)
    bmat, cmat, dt_raw, a = _mamba_gates_raw(p, x1)
    return x1, z, dt_raw, p["dt_bias"].to(F32), a, bmat, cmat, p["dd"].to(F32)


def mamba_scan_inputs(p, cfg: ModelConfig, x: torch.Tensor):
    """What the scan-only ``selective_scan`` takes for :func:`mamba_train`'s
    scan, from x (B, S, d): ``(x1, z, dt, a, bmat, cmat)``, ``dt`` after
    its bias and softplus (:func:`mamba_gated_inputs` otherwise)."""
    x1, z, dt_raw, dt_bias, a, bmat, cmat, _ = mamba_gated_inputs(p, cfg, x)
    return x1, z, softplus(dt_raw + dt_bias), a, bmat, cmat


def mamba_train(p, cfg: ModelConfig, x: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """Mamba over a full sequence, x (B, S, d): :func:`mamba_gated_inputs`,
    then :func:`selective_scan_gated` (the softplus of dt, the reference's
    chunked scans, the skip term ``dd x1`` and the ``silu(z)`` gate: one
    kernel on the card, the plain ops with the scan's ``chunk`` on the CPU)
    and the output projection.  Its gradient on the card runs the scan's
    backward kernel from the states the forward saved."""
    y = selective_scan_gated(*mamba_gated_inputs(p, cfg, x), x.dtype, chunk=chunk)
    return x + torch.einsum("bsi,id->bsd", y, p["out_proj"].to(x.dtype))


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    di = cfg.ssm_expand * cfg.d_model
    return {
        "h": torch.zeros((batch, di, cfg.ssm_state), dtype=F32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=dtype, device=device),
    }


def mamba_decode(p, cfg: ModelConfig, x: torch.Tensor, cache: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One step. x (B, 1, d); cache: the state ``h`` and the conv tail.
    Returns the output and the new cache (new tensors; the caller stores
    them).  The convolution is a float32 einsum here, as in the reference
    (``mamba_train``'s is in the model's dtype)."""
    dt_ = x.dtype
    di = cfg.ssm_expand * cfg.d_model
    h = rmsnorm(p["ln"], x)
    xz = torch.einsum("bsd,de->bse", h, p["in_proj"].to(dt_))
    x1, z = torch.split(xz, di, dim=-1)  # (B, 1, di)
    hist = torch.cat([cache["conv"], x1], dim=1)  # (B, k, di)
    conv = torch.einsum("bki,ki->bi", hist.to(F32), p["conv"].to(F32))
    x1s = silu(conv)  # (B, di)
    bmat, cmat, dtv, a = _mamba_gates(p, x1s)
    hstate = cache["h"] * torch.exp(dtv[..., None] * a) + (dtv * x1s)[..., None] * bmat[..., None, :]
    y = torch.einsum("bin,bn->bi", hstate, cmat) + p["dd"].to(F32) * x1s
    y = (y * silu(z[:, 0].to(F32))).to(dt_)
    out = x + torch.einsum("bi,id->bd", y, p["out_proj"].to(dt_))[:, None]
    return out, {"h": hstate, "conv": hist[:, 1:].to(cache["conv"].dtype)}


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory) and sLSTM (scalar memory, block-diagonal
# recurrence)
# ---------------------------------------------------------------------------


def mlstm_params(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    f = int(cfg.xlstm_proj_factor * d)
    return {
        "ln": norm_params(d),
        "up": P((d, 2 * f), ("embed", "xl_inner")),
        "wq": P((f, f), ("xl_inner", None)),
        "wk": P((f, f), ("xl_inner", None)),
        "wv": P((f, f), ("xl_inner", None)),
        "wif": P((f, 2), ("xl_inner", None)),  # input and forget gate pre-activations
        "wog": P((f, f), ("xl_inner", None)),
        "down": P((f, d), ("xl_inner", "embed")),
    }


def mlstm_train(p, cfg: ModelConfig, x: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """The chunk-recurrent mLSTM (xLSTM's parallel form, tiled), x (B, S, d).

    A loop over chunks carries the (C, n, m) matrix-memory state; within a
    chunk the quadratic form runs on a (chunk x chunk) tile and the earlier
    chunks enter through the carried state.  Padded positions have an input
    gate of -1e30 and a forget gate of 0 in log space, so they add nothing.
    """
    b, s, d = x.shape
    hh = cfg.n_heads
    f = int(cfg.xlstm_proj_factor * d)
    dh = f // hh
    dt_ = x.dtype
    hin = rmsnorm(p["ln"], x)
    u = torch.einsum("bsd,de->bse", hin, p["up"].to(dt_))
    xm, z = torch.split(u, f, dim=-1)  # (B, S, f)

    def heads(w):
        return torch.einsum("bsf,fg->bsg", xm, w.to(dt_)).reshape(b, s, hh, dh)

    q, k, v = heads(p["wq"]), heads(p["wk"]), heads(p["wv"])
    gates = torch.einsum("bsf,fg->bsg", xm.to(F32), p["wif"].to(F32))  # (B, S, 2)
    logi = gates[..., 0]
    logf = log_sigmoid(gates[..., 1])  # (B, S)
    scale = 1.0 / np.sqrt(dh)

    c = min(chunk, s)
    pad = -s % c
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        logi = F.pad(logi, (0, pad), value=-1e30)
        logf = F.pad(logf, (0, pad))
    nc = (s + pad) // c
    qc = q.to(F32).reshape(b, nc, c, hh, dh)
    kc = k.to(F32).reshape(b, nc, c, hh, dh)
    vc = v.to(F32).reshape(b, nc, c, hh, dh)
    lic = logi.reshape(b, nc, c)
    lfc = logf.reshape(b, nc, c)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))

    C = torch.zeros((b, hh, dh, dh), dtype=F32, device=x.device)
    n = torch.zeros((b, hh, dh), dtype=F32, device=x.device)
    m0 = torch.full((b, hh), -1e30, dtype=F32, device=x.device)
    houts = []
    for j in range(nc):
        qq, kk, vv, li, lf = qc[:, j], kc[:, j], vc[:, j], lic[:, j], lfc[:, j]
        lf_cum = torch.cumsum(lf, dim=1)  # (B, c): the chunk's running sum of log f
        # Intra-chunk log decay lf_cum[t] - lf_cum[s] + li[s], s <= t.
        logd = lf_cum[:, :, None] - lf_cum[:, None, :] + li[:, None, :]
        logd = torch.where(tri[None], logd, torch.full_like(logd, -1e30))
        m_intra = logd.amax(dim=-1)  # (B, c)
        # A stabilizer per step and head: the gates are shared across heads.
        m_t = torch.maximum(m_intra[..., None], m0[:, None, :] + lf_cum[..., None])  # (B, c, H)
        dmat = torch.exp(logd[:, :, None, :] - m_t[..., None])  # (B, c, H, c)
        qs = qq * scale
        sqk = torch.einsum("bthd,bshd->bths", qs, kk)  # (B, c, H, c)
        w = sqk * dmat
        inter_scale = torch.exp(m0[:, None, :] + lf_cum[..., None] - m_t)  # (B, c, H)
        h_inter = torch.einsum("bthd,bhde->bthe", qs, C) * inter_scale[..., None]
        n_inter = torch.einsum("bthd,bhd->bth", qs, n) * inter_scale
        num = torch.einsum("bths,bshd->bthd", w, vv) + h_inter
        den = torch.maximum(torch.abs(w.sum(-1) + n_inter), torch.exp(-m_t))
        houts.append(num / den[..., None])  # (B, c, H, dh)
        # The state at the end of the chunk.
        lf_tot = lf_cum[:, -1]  # (B,)
        decay_s = lf_tot[:, None] - lf_cum + li  # (B, c): log weight of each s
        m_new = torch.maximum(m0 + lf_tot[:, None], decay_s.amax(dim=1)[:, None])  # (B, H)
        w_s = torch.exp(decay_s[:, :, None] - m_new[:, None, :])  # (B, c, H)
        carry = torch.exp(m0 + lf_tot[:, None] - m_new)
        C = C * carry[..., None, None] + torch.einsum("bsh,bshd,bshe->bhde", w_s, kk, vv)
        n = n * carry[..., None] + torch.einsum("bsh,bshd->bhd", w_s, kk)
        m0 = m_new
    hout = torch.stack(houts, dim=1).reshape(b, s + pad, f)[:, :s]
    og = sigmoid(torch.einsum("bsf,fg->bsg", xm.to(F32), p["wog"].to(F32)))
    y = (hout * og * silu(z.to(F32))).to(dt_)
    return x + torch.einsum("bsf,fd->bsd", y, p["down"].to(dt_))


def init_mlstm_cache(cfg: ModelConfig, batch: int, device: torch.device
                     ) -> Dict[str, torch.Tensor]:
    hh = cfg.n_heads
    f = int(cfg.xlstm_proj_factor * cfg.d_model)
    dh = f // hh
    return {
        "c": torch.zeros((batch, hh, dh, dh), dtype=F32, device=device),
        "n": torch.zeros((batch, hh, dh), dtype=F32, device=device),
        "m": torch.full((batch, hh), -1e30, dtype=F32, device=device),
    }


def mlstm_decode(p, cfg: ModelConfig, x: torch.Tensor, cache: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One step. x (B, 1, d); cache (c, n, m).  Returns the output and the
    new state (new tensors)."""
    b, _, d = x.shape
    hh = cfg.n_heads
    f = int(cfg.xlstm_proj_factor * d)
    dh = f // hh
    dt_ = x.dtype
    hin = rmsnorm(p["ln"], x)
    u = torch.einsum("bsd,de->bse", hin, p["up"].to(dt_))[:, 0]
    xm, z = torch.split(u, f, dim=-1)  # (B, f)

    def heads(w):
        return torch.einsum("bf,fg->bg", xm, w.to(dt_)).reshape(b, hh, dh).to(F32)

    q, k, v = heads(p["wq"]), heads(p["wk"]), heads(p["wv"])
    gates = torch.einsum("bf,fg->bg", xm.to(F32), p["wif"].to(F32))
    logi, logf = gates[..., 0:1], log_sigmoid(gates[..., 1:2])  # (B, 1)
    # The scalar gates broadcast across heads.
    logi_h = logi.expand(b, hh)
    logf_h = logf.expand(b, hh)
    m_new = torch.maximum(logf_h + cache["m"], logi_h)
    i_p = torch.exp(logi_h - m_new)[..., None]  # (B, H, 1)
    f_p = torch.exp(logf_h + cache["m"] - m_new)[..., None]
    scale = 1.0 / np.sqrt(dh)
    ks = k * scale
    c = cache["c"] * f_p[..., None] + i_p[..., None] * torch.einsum("bhd,bhe->bhde", v, ks)
    n = cache["n"] * f_p + i_p * ks
    num = torch.einsum("bhde,bhe->bhd", c, q)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", n, q)), torch.exp(-m_new))[..., None]
    hout = (num / den).reshape(b, f)
    og = sigmoid(torch.einsum("bf,fg->bg", xm.to(F32), p["wog"].to(F32)))
    y = (hout * og * silu(z.to(F32))).to(dt_)
    out = x + torch.einsum("bf,fd->bd", y, p["down"].to(dt_))[:, None]
    return out, {"c": c, "n": n, "m": m_new}


def slstm_params(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    hh = cfg.n_heads
    uh = d // hh
    return {
        "ln": norm_params(d),
        "wx": P((d, 4 * d), ("embed", "units")),
        "wr": P((hh, uh, 4 * uh), (None, None, "units")),
        "bias": P((4 * d,), ("units",), init="zeros"),
        "out": P((d, d), ("units", "embed")),
    }


def _slstm_step(p, cfg: ModelConfig, xproj_t: torch.Tensor, state):
    """xproj_t (B, 4d); state (h, c, n, m) each (B, H, uh) float32."""
    hh = cfg.n_heads
    uh = cfg.d_model // hh
    h, c, n, m = state
    h, (c, n, m) = slstm_cell(xproj_t, h, (c, n, m), p["wr"].to(F32),
                              p["bias"].reshape(hh, 4 * uh).to(F32))
    return h, c, n, m


def slstm_scan_input(p, x: torch.Tensor) -> torch.Tensor:
    """What :func:`slstm_train` hands the scan: the input projection
    ``xproj`` (B, S, 4d) of x (B, S, d), in x's dtype."""
    return torch.einsum("bsd,dg->bsg", rmsnorm(p["ln"], x), p["wx"].to(x.dtype))


def slstm_train(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The sLSTM over a full sequence, x (B, S, d): the input projection,
    :func:`slstm_scan` (the kernel on the card, the per-step plain loop on
    the CPU), the hidden states rounded to the dtype and projected out.
    Its gradient on the card runs the reverse-scan kernel (the reference's
    ``_slstm_scan_bwd``) from the forward's residuals."""
    b, s, d = x.shape
    dt_ = x.dtype
    xproj = slstm_scan_input(p, x)  # (B, S, 4d)
    hs = slstm_scan(xproj, p["wr"], p["bias"])  # (B, S, H, uh) float32
    hs = hs.reshape(b, s, d).to(dt_)
    return x + torch.einsum("bsd,dg->bsg", hs, p["out"].to(dt_))


def init_slstm_cache(cfg: ModelConfig, batch: int, device: torch.device
                     ) -> Tuple[torch.Tensor, ...]:
    hh = cfg.n_heads
    uh = cfg.d_model // hh
    z = torch.zeros((batch, hh, uh), dtype=F32, device=device)
    return (z, z.clone(), z.clone(), torch.full((batch, hh, uh), -1e30, dtype=F32,
                                                device=device))


def slstm_decode(p, cfg: ModelConfig, x: torch.Tensor, cache) -> Tuple[torch.Tensor, Any]:
    """One step. x (B, 1, d); cache (h, c, n, m).  Returns the output and
    the new state (new tensors)."""
    dt_ = x.dtype
    hin = rmsnorm(p["ln"], x)
    xproj = torch.einsum("bsd,dg->bsg", hin, p["wx"].to(dt_))[:, 0]
    h, c, n, m = _slstm_step(p, cfg, xproj, cache)
    b = x.shape[0]
    y = h.reshape(b, cfg.d_model).to(dt_)
    out = x + torch.einsum("bd,dg->bg", y, p["out"].to(dt_))[:, None]
    return out, (h, c, n, m)
