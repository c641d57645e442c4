"""Plain PyTorch versions of the ported kernels (the correctness contract).

Counterparts of ``repro/kernels/ref.py``'s jnp oracles.  The CPU path of
every kernel wrapper runs these; ``chip_smoke.py`` holds each CUDA kernel
against them on the card.  Nothing on the engine's path calls them for a
CUDA tensor.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def fragment_bitmap_ref(prov: torch.Tensor, bucket: torch.Tensor, n_ranges: int) -> torch.Tensor:
    """bits[r] = OR over rows in fragment r of the provenance mask.  Rows
    whose bucket lies outside ``[0, n_ranges)`` set nothing, as
    ``segment_max`` drops them."""
    idx = bucket.long()
    flags = prov.to(torch.int32)
    ok = (idx >= 0) & (idx < n_ranges)
    if not bool(ok.all()):
        idx, flags = idx[ok], flags[ok]
    hits = torch.zeros(n_ranges, dtype=torch.int32, device=bucket.device)
    hits.scatter_reduce_(0, idx, flags, reduce="amax")
    return hits > 0


def fragment_bitmap_batch_ref(provs: torch.Tensor, bucket: torch.Tensor,
                              n_ranges: int) -> torch.Tensor:
    """bits[b, r] = OR over rows in fragment r of provenance mask b (one
    ``scatter_reduce_`` over a (B, n_ranges) output).  Rows whose bucket lies
    outside ``[0, n_ranges)`` set nothing, as ``segment_max`` drops them."""
    b = int(provs.shape[0])
    idx = bucket.long()
    flags = provs.to(torch.int32)
    ok = (idx >= 0) & (idx < n_ranges)
    if not bool(ok.all()):
        idx, flags = idx[ok], flags[:, ok]
    hits = torch.zeros((b, n_ranges), dtype=torch.int32, device=bucket.device)
    hits.scatter_reduce_(1, idx.expand(b, -1), flags, reduce="amax")
    return hits > 0


def sketch_filter_ref(bucket: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """keep[i] = bits[bucket[i]] — the sketch's disjunction of ranges.  Rows
    whose bucket lies outside ``[0, n_ranges)`` are not kept, as no range of
    the reference's one-hot compare matches them."""
    idx = bucket.long()
    n_ranges = int(bits.shape[0])
    ok = (idx >= 0) & (idx < n_ranges)
    return bits.to(torch.bool)[idx.clamp(0, n_ranges - 1)] & ok


def sketch_filter_rows_ref(bucket: torch.Tensor, bits: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keep, rows): the keep-mask and its kept rows in ascending order
    (int64, ``np.nonzero(keep)[0]``)."""
    keep = sketch_filter_ref(bucket, bits)
    return keep, torch.nonzero(keep).flatten()


def segment_aggregate_ref(
    values: torch.Tensor, gid: torch.Tensor, n_groups: int,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums, counts) per group with optional row weights (WHERE mask).

    Accumulates in float32 in row order (``index_add_`` on the CPU adds its
    rows one after another, as XLA-CPU's ``segment_sum`` does), so the CPU
    results equal the reference's bit for bit.  Rows whose gid lies outside
    ``[0, n_groups)`` are dropped, like ``segment_sum``'s out-of-range ids.
    """
    v = values.to(torch.float32)
    w = torch.ones_like(v) if weights is None else weights.to(torch.float32)
    g = gid.long()
    ok = (g >= 0) & (g < n_groups)
    if not bool(ok.all()):
        g, v, w = g[ok], v[ok], w[ok]
    sums = torch.zeros(n_groups, dtype=torch.float32, device=v.device).index_add_(0, g, v * w)
    counts = torch.zeros(n_groups, dtype=torch.float32, device=v.device).index_add_(0, g, w)
    return sums, counts


def segment_aggregate_batch_ref(
    values: torch.Tensor, gid: torch.Tensor, n_groups: int,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums, counts) as (B, n_groups): row ``b`` is
    ``segment_aggregate_ref`` of row ``b``.  One ``index_add_`` over the
    flattened rows with ids ``gid + b * n_groups`` adds each row's values in
    row order, as the unbatched version does; out-of-range gids are dropped
    per row."""
    b = int(values.shape[0])
    v = values.to(torch.float32)
    w = torch.ones_like(v) if weights is None else weights.to(torch.float32)
    g = gid.long()
    ok = (g >= 0) & (g < n_groups)
    flat = (g + n_groups * torch.arange(b, device=g.device)[:, None])[ok]
    out = torch.zeros(2, b * n_groups, dtype=torch.float32, device=v.device)
    out[0].index_add_(0, flat, (v * w)[ok])
    out[1].index_add_(0, flat, w[ok])
    return out[0].view(b, n_groups), out[1].view(b, n_groups)


NEG_INF = -1e30  # the masked logit of the reference (``kernels/flash_attention.py``)


def _attention_probs(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int):
    """(masked f32 logits, f32 q, f32 k with kv heads expanded to q's, scale)
    of the plain attention: float32 math on float32 casts of the inputs."""
    qf, kf = q.to(torch.float32), k.to(torch.float32)
    group = qf.shape[1] // kf.shape[1]
    if group > 1:
        kf = kf.repeat_interleave(group, dim=1)
    scale = 1.0 / torch.sqrt(torch.tensor(float(qf.shape[-1]), dtype=torch.float32))
    scale = scale.to(qf.device)
    logits = torch.einsum("bhsd,bhtd->bhst", qf, kf) * scale
    s, t = qf.shape[2], kf.shape[2]
    qpos = torch.arange(s, device=q.device)[:, None] + (t - s)
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window and window > 0:
        mask &= kpos > qpos - window
    logits = torch.where(mask[None, None], logits, torch.full_like(logits, NEG_INF))
    return logits, qf, kf, scale


def _expand_kv(x: torch.Tensor, group: int) -> torch.Tensor:
    xf = x.to(torch.float32)
    return xf.repeat_interleave(group, dim=1) if group > 1 else xf


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True, window: int = 0
) -> torch.Tensor:
    """O = softmax(QK^T / sqrt(d)) V with optional causal/sliding-window mask.

    Shapes: q (B, H, S, D), k/v (B, Hkv, T, D) with ``H % Hkv == 0`` (query
    head ``h`` reads kv head ``h // (H // Hkv)``; the reference's oracle
    takes ``Hkv == H`` only).  q rows are end-aligned with k (position
    ``s + T - S``).  Float32 math on float32 casts of the inputs (a bf16 q
    is cast before it is scaled, as the reference's promotion does); the
    output has q's dtype.
    """
    logits, _, _, _ = _attention_probs(q, k, causal, window)
    vf = _expand_kv(v, q.shape[1] // k.shape[1])
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p, vf).to(q.dtype)


def flash_attention_lse_ref(
    q: torch.Tensor, k: torch.Tensor, causal: bool = True, window: int = 0
) -> torch.Tensor:
    """The log-sum-exp of each query row's masked, scaled logits, (B, H, S)
    float32: what the forward kernel stores for the backward."""
    logits, _, _, _ = _attention_probs(q, k, causal, window)
    return torch.logsumexp(logits, dim=-1)


def flash_attention_bwd_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, do: torch.Tensor,
    causal: bool = True, window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dQ, dK, dV) of ``flash_attention_ref`` given its output ``o`` and the
    output's gradient ``do``, by the flash-attention backward's formula in
    float32: P = softmax(scale Q K^T) recomputed, D = rowsum(dO o O),
    dV = P^T dO, dS = P o (dO V^T - D), dQ = scale dS K, dK = scale dS^T Q.
    Shapes as ``flash_attention_ref``; dK and dV of a kv head sum over the
    query heads that read it.  Each gradient has its input's dtype."""
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    group = h // hkv
    logits, qf, kf, scale = _attention_probs(q, k, causal, window)
    vf = _expand_kv(v, group)
    of, dof = o.to(torch.float32), do.to(torch.float32)
    p = torch.softmax(logits, dim=-1)
    dv = torch.einsum("bhst,bhsd->bhtd", p, dof)
    dp = torch.einsum("bhsd,bhtd->bhst", dof, vf)
    ds = p * (dp - (dof * of).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhst,bhtd->bhsd", ds, kf) * scale
    dk = torch.einsum("bhst,bhsd->bhtd", ds, qf) * scale
    if group > 1:
        dk = dk.reshape(b, hkv, group, t, d).sum(dim=2)
        dv = dv.reshape(b, hkv, group, t, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# The recurrent mixers' scans (``models/ssm.py``)
# ---------------------------------------------------------------------------
#
# The reference's ``jax.nn`` activations, each rounded where XLA rounds it:
# in bfloat16 every step of the expansion rounds to the dtype (``logistic``
# is ``1 / (1 + exp(-x))``, ``softplus`` is ``logaddexp(x, 0)``); in float32
# no torch formula repeats XLA-CPU's ``exp``/``log1p`` bit for bit, and
# ``torch.sigmoid`` is the nearest form of ``logistic``.


class _Sigmoid(torch.autograd.Function):
    """``lax.logistic`` with its JVP rule as the gradient: ``g * (y * (1 -
    y))``, each step rounded to the dtype (autograd through ``1 / (1 +
    exp(-x))`` rounds other steps in bfloat16)."""

    @staticmethod
    def forward(ctx, x):
        y = torch.sigmoid(x) if x.dtype == torch.float32 else 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (y * (1 - y))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``."""
    return _Sigmoid.apply(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * sigmoid(x)`` (in bfloat16 the MLP's
    ``layers.silu`` forward; in float32 through ``torch.sigmoid``)."""
    return x * sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``jnp.logaddexp(x, 0)`` =
    ``max(x, 0) + log1p(exp(-|x|))`` (not ``F.softplus``'s form)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)


def selective_scan_plain(x1: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                         bmat: torch.Tensor, cmat: torch.Tensor,
                         chunk: int = 1024) -> torch.Tensor:
    """The plain version of ``selective_scan``: the body of the reference's
    ``mamba_train`` scans (``repro/models/ssm.py:87-108``), transcribed.

    ``x1`` (B, S, di) in the model's dtype, read as float32; ``dt`` (B, S,
    di) float32 after the softplus; ``a`` (di, n) float32 (``-exp(a_log)``);
    ``bmat``, ``cmat`` (B, S, n) float32.  Returns ``ys`` (B, S, di) float32.
    Chunk by chunk, the (B, c, di, n) ``decay = exp(dt a)`` and ``drive =
    (dt x) b``, then one step a position: ``h = h decay + drive``, ``y =
    einsum(h, c)``.  The state carries across chunks, so the chunk bounds
    memory only: the reference pads the last chunk with zero steps after the
    real ones, which change no output, and the last chunk here is ragged."""
    b, s, di = x1.shape
    c = max(1, min(chunk, s))
    h = torch.zeros((b, di, a.shape[1]), dtype=torch.float32, device=x1.device)
    ys = []
    for c0 in range(0, s, c):
        dtc = dt[:, c0:c0 + c]
        decay = torch.exp(dtc[..., None] * a)  # (B, c, di, n)
        drive = (dtc * x1[:, c0:c0 + c].to(torch.float32))[..., None] * bmat[:, c0:c0 + c, None, :]
        for t in range(dtc.shape[1]):
            h = h * decay[:, t] + drive[:, t]
            ys.append(torch.einsum("bin,bn->bi", h, cmat[:, c0 + t]))
    if not ys:
        return torch.zeros((b, 0, di), dtype=torch.float32, device=x1.device)
    return torch.stack(ys, dim=1)


def selective_scan_gated_plain(x1: torch.Tensor, z: torch.Tensor, dt_raw: torch.Tensor,
                               dt_bias: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                               cmat: torch.Tensor, dd: torch.Tensor, out_dtype: torch.dtype,
                               chunk: int = 1024, scan=selective_scan_plain) -> torch.Tensor:
    """The plain version of ``selective_scan_gated``: ``mamba_train``'s ops
    around the scan, as the reference rounds them (``repro/models/ssm.py:
    53, 110-111``): ``dt = softplus(dt_raw + dt_bias)``, ``ys = scan(x1, dt,
    a, bmat, cmat)``, then ``(ys + dd x1)`` and ``* silu(z)`` in float32,
    cast to ``out_dtype``.  ``scan`` is the plain scan; on the card the
    scan-only kernel in its place gives the composition the gated kernel
    is held to."""
    dt = softplus(dt_raw + dt_bias)
    y = scan(x1, dt, a, bmat, cmat, chunk=chunk)
    y = y + dd * x1.to(torch.float32)
    return (y * silu(z.to(torch.float32))).to(out_dtype)


def slstm_cell(xt: torch.Tensor, hprev: torch.Tensor, state, wr: torch.Tensor,
               bias: torch.Tensor):
    """One sLSTM step (``_slstm_cell`` and ``_slstm_step``): ``xt`` (B, 4d)
    in its dtype, ``hprev`` (B, H, uh) float32, ``state`` (c, n, m) float32,
    ``wr`` (H, uh, 4 uh) and ``bias`` (H, 4 uh) already float32.  Returns
    ``(h, (c, n, m))``: the recurrent product, then ``(x + rec) + bias``,
    the z, i, f, o gates, the log-sigmoid forget gate, the stabilizer m and
    ``h = sigmoid(o) c / max(n, 1e-6)``."""
    return slstm_update(slstm_pre(xt, hprev, wr, bias), state)


def slstm_pre(xt: torch.Tensor, hprev: torch.Tensor, wr: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """A step's gate pre-activations (B, H, 4 uh) float32: ``(x + hprev
    wr) + bias``."""
    b = xt.shape[0]
    hh, uh = wr.shape[0], wr.shape[1]
    rec = torch.einsum("bhu,hug->bhg", hprev, wr)
    return xt.reshape(b, hh, 4 * uh).to(torch.float32) + rec + bias


def slstm_update(pre: torch.Tensor, state):
    """The cell from its pre-activations ``pre`` (B, H, 4 uh) and the state
    (c, n, m): ``(h, (c, n, m))``."""
    uh = pre.shape[-1] // 4
    c, n, m = state
    zt, it, ft, ot = torch.split(pre, uh, dim=-1)
    logf = log_sigmoid(ft)
    m_new = torch.maximum(logf + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(logf + m - m_new)
    c_new = f_p * c + i_p * torch.tanh(zt)
    n_new = f_p * n + i_p
    h_new = sigmoid(ot) * c_new / torch.clamp_min(n_new, 1e-6)
    return h_new, (c_new, n_new, m_new)


def slstm_cell_bwd(pre: torch.Tensor, prev, new, dh: torch.Tensor, dstate):
    """The cell's backward (``_slstm_cell``'s pullback in
    ``_slstm_scan_bwd``), float32, in the kernel's formulas and order.

    ``pre`` (B, H, 4 uh), ``prev`` the state (c, n, m) before the step,
    ``new`` the one after it, ``dh`` the gradient of its ``h`` and
    ``dstate`` of its new state.  Returns ``(dpre, (dc, dn, dm))``, the
    latter the gradient of ``prev``.  It carries the stabilizer's gradient,
    which cancels in exact arithmetic.  ``maximum``'s tie splits the
    gradient half and half (``jnp.maximum``'s and ``torch.maximum``'s
    rule); ``clamp_min(n, 1e-6)`` passes it where ``n >= 1e-6`` (torch's
    rule; ``jnp.maximum(n, 1e-6)`` would halve it at ``n == 1e-6``)."""
    c0, n0, m0 = prev
    c1, n1, _ = new
    dc, dn, dm = dstate
    zt, it, ft, ot = torch.chunk(pre, 4, dim=-1)
    logf = log_sigmoid(ft)
    lm = logf + m0
    m1 = torch.maximum(lm, it)
    i_p = torch.exp(it - m1)
    f_p = torch.exp(lm - m1)
    tz = torch.tanh(zt)
    sig = 1 / (1 + torch.exp(-ot))
    nn = torch.clamp_min(n1, 1e-6)
    h = sig * c1 / nn
    dq = dh / nn
    dc1 = dc + dq * sig
    dn1 = dn + torch.where(n1 >= 1e-6, -(dq * h), torch.zeros_like(dq))
    do = (dq * c1) * (sig * (1 - sig))
    df_p = dc1 * c0 + dn1 * n0
    di_p = dc1 * tz + dn1
    dz = (dc1 * i_p) * (1 - tz * tz)
    gi = di_p * i_p
    gf = df_p * f_p
    dm1 = (dm - gi) - gf
    zero = torch.zeros_like(dm1)
    half = torch.where(lm == it, dm1 * 0.5, zero)
    dlm = gf + torch.where(lm > it, dm1, half)
    di = gi + torch.where(it > lm, dm1, half)
    df = dlm * (1 / (1 + torch.exp(ft)))  # log_sigmoid' = sigmoid(-f)
    return torch.cat([dz, di, df, do], dim=-1), (dc1 * f_p, dn1 * f_p, dlm)


def slstm_scan_plain(xproj: torch.Tensor, wr: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The plain version of ``slstm_scan``: the forward of the reference's
    ``_slstm_scan_p`` (``_slstm_scan_fwd_impl``, ``repro/models/ssm.py:356``),
    one :func:`slstm_cell` a position from zero states and ``m = -1e30``.
    ``xproj`` (B, S, 4d) in its dtype, ``wr`` (H, uh, 4 uh) and ``bias``
    (4d) in their stored dtype, widened to float32.  Returns ``hs`` (B, S,
    H, uh) float32."""
    b, s, _ = xproj.shape
    hh, uh = wr.shape[0], wr.shape[1]
    w = wr.to(torch.float32)
    bi = bias.reshape(hh, 4 * uh).to(torch.float32)
    z = torch.zeros((b, hh, uh), dtype=torch.float32, device=xproj.device)
    h, state = z, (z, z, torch.full_like(z, -1e30))
    hs = []
    for t in range(s):
        h, state = slstm_cell(xproj[:, t], h, state, w, bi)
        hs.append(h)
    if not hs:
        return torch.zeros((b, 0, hh, uh), dtype=torch.float32, device=xproj.device)
    return torch.stack(hs, dim=1)


def slstm_scan_fwd_plain(xproj: torch.Tensor, wr: torch.Tensor, bias: torch.Tensor):
    """:func:`slstm_scan_plain` with what its backward needs: ``(hs, pre,
    (c, n, m))``, ``pre`` (B, S, 4d) the gate pre-activations and the
    states after each position (B, S, H, uh), all float32 (the residuals
    ``slstm_scan``'s forward kernel writes when a gradient is needed)."""
    b, s, _ = xproj.shape
    hh, uh = wr.shape[0], wr.shape[1]
    w = wr.to(torch.float32)
    bi = bias.reshape(hh, 4 * uh).to(torch.float32)
    z = torch.zeros((b, hh, uh), dtype=torch.float32, device=xproj.device)
    h, state = z, (z, z, torch.full_like(z, -1e30))
    hs, pres, cs, ns, ms = [], [], [], [], []
    for t in range(s):
        pre = slstm_pre(xproj[:, t], h, w, bi)
        h, state = slstm_update(pre, state)
        for out, v in zip((hs, pres, cs, ns, ms), (h, pre) + state):
            out.append(v)
    if not hs:
        e = torch.zeros((b, 0, hh, uh), dtype=torch.float32, device=xproj.device)
        return e, torch.zeros((b, 0, 4 * hh * uh), dtype=torch.float32, device=xproj.device), (
            e, e, e)
    c, n, m = (torch.stack(v, dim=1) for v in (cs, ns, ms))
    return torch.stack(hs, dim=1), torch.stack(pres, dim=1).reshape(b, s, -1), (c, n, m)


def slstm_weight_grads(hs: torch.Tensor, dpre: torch.Tensor):
    """``dwr`` (H, uh, 4 uh) and ``dbias`` (4d) float32 from ``hs`` (B, S,
    H, uh) and ``dpre`` (B, S, H, 4 uh) float32: one matrix product a head
    of ``hs_prev^T`` (H, uh, B S), the hidden states one position back
    (zero at the first), by ``dpre`` (H, B S, 4 uh), and ``dpre`` summed
    over (B, S): the reference's einsums inside its VJP, summed once."""
    b, s, hh, uh = hs.shape
    hs_prev = torch.cat([torch.zeros_like(hs[:, :1]), hs[:, :-1]], dim=1)
    dwr = torch.matmul(hs_prev.permute(2, 3, 0, 1).reshape(hh, uh, b * s),
                       dpre.permute(2, 0, 1, 3).reshape(hh, b * s, 4 * uh))
    return dwr, dpre.sum(dim=(0, 1)).reshape(-1)


def slstm_scan_bwd_plain(xproj: torch.Tensor, wr: torch.Tensor, bias: torch.Tensor,
                         pre: torch.Tensor, states, hs: torch.Tensor, dhs: torch.Tensor):
    """The plain version of ``slstm_scan``'s backward, the counterpart of the
    reference's ``_slstm_scan_bwd`` (``repro/models/ssm.py:375``): from the
    last position back, :func:`slstm_cell_bwd` carrying ``dh`` (the
    recurrent product's ``dpre wr^T`` plus the position's ``dhs``) and the
    state's gradient, then :func:`slstm_weight_grads`.

    ``pre``, ``states`` and ``hs`` as :func:`slstm_scan_fwd_plain` returns
    them, ``dhs`` (B, S, H, uh) float32.  Returns ``(dxproj, dwr, dbias)``
    in their inputs' dtypes."""
    b, s, _ = xproj.shape
    hh, uh = wr.shape[0], wr.shape[1]
    w = wr.to(torch.float32)
    c, n, m = states
    pre4 = pre.reshape(b, s, hh, 4 * uh)
    dpre = torch.empty_like(pre4)
    z = torch.zeros((b, hh, uh), dtype=torch.float32, device=xproj.device)
    dh_next, dst = z, (z, z, z)
    for t in reversed(range(s)):
        prev = (c[:, t - 1], n[:, t - 1], m[:, t - 1]) if t else (z, z, torch.full_like(z, -1e30))
        dp, dst = slstm_cell_bwd(pre4[:, t], prev, (c[:, t], n[:, t], m[:, t]),
                                 dh_next + dhs[:, t].to(torch.float32), dst)
        dpre[:, t] = dp
        dh_next = torch.einsum("bhg,hug->bhu", dp, w)
    dwr, dbias = slstm_weight_grads(hs, dpre)
    return (dpre.reshape(b, s, 4 * hh * uh).to(xproj.dtype), dwr.to(wr.dtype),
            dbias.to(bias.dtype))


SCAN_SPAN = 4  # positions between the saved states of the selective scan (a ring stage)


def selective_scan_states(x1: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                          bmat: torch.Tensor) -> torch.Tensor:
    """The state entering every span of SCAN_SPAN positions, (B, ceil(S /
    SCAN_SPAN), n, di) float32, the first zero: what ``selective_scan``'s
    forward kernel saves for its backward, bit for bit (the same float32
    products, ``exp`` and sums as :func:`selective_scan_plain`)."""
    b, s, di = x1.shape
    h = torch.zeros((b, di, a.shape[1]), dtype=torch.float32, device=x1.device)
    out = []
    for t in range(s):
        if t % SCAN_SPAN == 0:
            out.append(h.transpose(1, 2))
        h = h * torch.exp(dt[:, t, :, None] * a) + (
            dt[:, t] * x1[:, t].to(torch.float32))[..., None] * bmat[:, t, None, :]
    if not out:
        return torch.zeros((b, 0, a.shape[1], di), dtype=torch.float32, device=x1.device)
    return torch.stack(out, dim=1)


def _scan_bwd(xf, dt, a, bmat, cmat, dy, hsave):
    """The selective scan's reverse walk, span by span: a span's states
    recomputed from the one saved at its start, then from its last position
    back ``dh = dh decay_next + dy c``, ``dc = sum_i dy h``, ``db = sum_i
    dh dt x``, ``d(dt x) = sum_k dh b``, ``g = dh h_prev decay`` into ``da
    += g dt`` (a row each, summed over rows at the end) and ``ddt = sum_k g
    a + d(dt x) x``, ``dx = d(dt x) dt``.  Returns ``(dx, ddt, da, db, dc)``
    float32."""
    b, s, di = xf.shape
    dh = torch.zeros((b, di, a.shape[1]), dtype=torch.float32, device=xf.device)
    da = torch.zeros_like(dh)
    dx, ddt = torch.empty_like(xf), torch.empty_like(xf)
    db, dc = torch.empty_like(bmat), torch.empty_like(cmat)
    span = SCAN_SPAN
    for k0 in reversed(range(0, s, span)):
        states = [hsave[:, k0 // span].transpose(1, 2)]
        for t in range(k0, min(k0 + span, s)):
            states.append(states[-1] * torch.exp(dt[:, t, :, None] * a)
                          + (dt[:, t] * xf[:, t])[..., None] * bmat[:, t, None, :])
        for t in reversed(range(k0, min(k0 + span, s))):
            h_t, h_p = states[t - k0 + 1], states[t - k0]
            dh = dh + dy[:, t, :, None] * cmat[:, t, None, :]
            dtx = dt[:, t] * xf[:, t]
            dc[:, t] = torch.einsum("bi,bin->bn", dy[:, t], h_t)
            db[:, t] = torch.einsum("bin,bi->bn", dh, dtx)
            dsum = (dh * bmat[:, t, None, :]).sum(-1)
            decay = torch.exp(dt[:, t, :, None] * a)
            g = dh * h_p * decay
            da = da + g * dt[:, t, :, None]
            ddt[:, t] = (g * a).sum(-1) + dsum * xf[:, t]
            dx[:, t] = dsum * dt[:, t]
            dh = dh * decay
    return dx, ddt, da.sum(0), db, dc


def selective_scan_bwd_plain(x1: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                             bmat: torch.Tensor, cmat: torch.Tensor, dys: torch.Tensor,
                             hsave: Optional[torch.Tensor] = None):
    """The plain version of ``selective_scan``'s backward: the same formulas
    as its kernel, in torch ops, a span at a time (``hsave`` the saved
    states, recomputed by :func:`selective_scan_states` when None).
    ``dys`` (B, S, di) float32.  Returns ``(dx1, ddt, da, dbmat, dcmat)``,
    ``dx1`` in x1's dtype, the rest float32."""
    if hsave is None:
        hsave = selective_scan_states(x1, dt, a, bmat)
    dx, ddt, da, db, dc = _scan_bwd(x1.to(torch.float32), dt, a, bmat, cmat,
                                    dys.to(torch.float32), hsave)
    return dx.to(x1.dtype), ddt, da, db, dc


def selective_scan_gated_bwd_plain(x1: torch.Tensor, z: torch.Tensor, dt_raw: torch.Tensor,
                                   dt_bias: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                                   cmat: torch.Tensor, dd: torch.Tensor, dout: torch.Tensor,
                                   hsave: Optional[torch.Tensor] = None, chunk: int = 1024):
    """The plain version of ``selective_scan_gated``'s backward, the gradient
    of :func:`selective_scan_gated_plain` in the kernel's formulas: with
    ``s = sigmoid(z)``, ``y2 = ys + dd x1`` (``ys`` recomputed), ``dy =
    dout z s`` goes into the scan's reverse walk, ``dz = (dout y2) (s (1 +
    z (1 - s)))``, ``ddd = sum dy x1``, ``dx1 = dy dd + d(dt x) dt`` and
    ``ddt_raw = ddt sigmoid(dt_raw + dt_bias)``.  ``dout`` (B, S, di) in the
    output's dtype; ``chunk`` bounds the recomputed ys's memory (as
    :func:`selective_scan_plain`'s).  Returns ``(dx1, dz, ddt_raw, ddt_bias, da, dbmat,
    dcmat, ddd)``: ``dx1`` and ``dz`` in their inputs' dtypes, the rest
    float32."""
    xf, zf, go = x1.to(torch.float32), z.to(torch.float32), dout.to(torch.float32)
    tt = dt_raw + dt_bias
    dt = softplus(tt)
    if hsave is None:
        hsave = selective_scan_states(x1, dt, a, bmat)
    ys = selective_scan_plain(x1, dt, a, bmat, cmat, chunk=chunk)
    sz = 1 / (1 + torch.exp(-zf))
    dy = go * (zf * sz)
    dz = (go * (ys + dd * xf)) * (sz * (1 + zf * (1 - sz)))
    dx, ddt, da, db, dc = _scan_bwd(xf, dt, a, bmat, cmat, dy, hsave)
    ddt_raw = ddt * (1 / (1 + torch.exp(-tt)))
    return ((dy * dd + dx).to(x1.dtype), dz.to(z.dtype), ddt_raw, ddt_raw.sum(dim=(0, 1)), da,
            db, dc, (dy * xf).sum(dim=(0, 1)))
