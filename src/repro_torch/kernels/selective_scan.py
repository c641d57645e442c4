"""The selective scan (Mamba-1): the wrappers of ``csrc/selective_scan.cu``.

It replaces no Pallas kernel: the reference's ``mamba_train``
(``repro/models/ssm.py:58``) runs the scan as two nested ``lax.scan``s,
and a per-step loop of torch ops would launch a few kernels a position and
materialize (B, chunk, di, n) float32 ``decay`` and ``drive`` tensors, 17.2
GB each at jamba-1.5-large's width with 16 rows of 1,024 positions.

Two entries launch the one kernel (a template with the gate on or off),
one launch a call, both counted under ``LAUNCH_COUNTS["selective_scan"]``:

- :func:`selective_scan` takes the post-softplus ``dt`` and returns the
  float32 ``ys``;
- :func:`selective_scan_gated` is ``mamba_train`` from the einsum's raw
  ``dt`` to the gated output in the model's dtype: the softplus of ``dt +
  dt_bias``, the scan, the skip term ``dd x1``, the ``silu(z)`` gate and the
  cast, rounded as the torch ops around the scan-only entry round them, so
  the float32 ``dt`` and ``ys`` never go through device memory.

On the card the number of states is a template parameter (1 to 16), a
producer warp feeds a ring of stages in shared memory by bulk copies on
mbarriers, and each compute thread keeps its channel's states and row of
``a`` in registers; the source says what bounds it.

A CPU tensor goes to the plain versions (``ref.selective_scan_plain``,
``ref.selective_scan_gated_plain``), which autograd differentiates; a CUDA
tensor goes to the kernel, or the call raises.  Under autograd on the card
the kernel runs inside an autograd function: its forward also saves the
state entering every 4 positions ((B, S / 4, n, di) float32), and its
backward is :func:`selective_scan_bwd` or :func:`selective_scan_gated_bwd`,
``csrc/selective_scan_bwd.cu``: the reverse walk a stage at a time from the
saved states, a channel's states split over four lanes and its epilogue
and softplus differentiated once a position, then a second launch adding
the tiles' and rows' partial sums in order (one call, two launches, counted
once under ``LAUNCH_COUNTS["selective_scan_bwd"]``).  ``LAUNCH_COUNTS
["selective_scan.residuals"]`` counts the forwards that saved states (not
those under ``residuals.skipped``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, residuals
from repro_torch.kernels.ref import softplus as ref_softplus
from repro_torch.kernels.ref import (SCAN_SPAN, selective_scan_bwd_plain,
                                     selective_scan_gated_bwd_plain, selective_scan_gated_plain,
                                     selective_scan_plain, selective_scan_states)
from repro_torch.runtime.guards import LAUNCH_COUNTS

NAME = "selective_scan"
BWD_NAME = "selective_scan_bwd"
RESIDUALS_COUNTER = "selective_scan.residuals"  # forwards that saved the backward's states
MAX_STATE = 16  # states a channel keeps in registers (the source's kMaxState)
MAX_BATCH = 65535
TILE = 64  # channels a unit of the backward (its source's kTile)
VALUES = 32  # a position's dc and db partial sums a tile (its source's kValues)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(x1, dt, a, bmat, cmat, **gated) -> None:
    """Refuse, on every device, what the kernel does not take; ``gated``
    holds ``z``, ``dt_bias``, ``dd`` and ``out_dtype`` for the gated entry."""
    if x1.dim() != 3:
        raise ValueError(f"x1 must be (B, S, di), got {tuple(x1.shape)}")
    b, s, di = x1.shape
    if a.dim() != 2 or a.shape[0] != di:
        raise ValueError(f"a has shape {tuple(a.shape)}, expected ({di}, n)")
    n = a.shape[1]
    if x1.dtype not in _DTYPE_CODES:
        raise TypeError(f"x1 has dtype {x1.dtype}: the kernel reads float32 or bfloat16")
    want = {"dt": (dt, (b, s, di)), "bmat": (bmat, (b, s, n)), "cmat": (cmat, (b, s, n))}
    if gated:
        want.update(dt_bias=(gated["dt_bias"], (di,)), dd=(gated["dd"], (di,)))
        z, out_dtype = gated["z"], gated["out_dtype"]
        if tuple(z.shape) != (b, s, di):
            raise ValueError(f"z has shape {tuple(z.shape)}, expected {(b, s, di)}")
        if z.dtype != x1.dtype or out_dtype != x1.dtype:
            raise TypeError(f"z ({z.dtype}) and the output ({out_dtype}) must have x1's dtype "
                            f"({x1.dtype})")
        if z.device != x1.device:
            raise ValueError(f"z lies on {z.device}, x1 on {x1.device}")
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    for name, t in [("a", a)] + [(name, t) for name, (t, _) in want.items()]:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}, expected torch.float32")
        if t.device != x1.device:
            raise ValueError(f"{name} lies on {t.device}, x1 on {x1.device}")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"{n} states a channel: the kernel keeps 1 to {MAX_STATE}")
    if b > MAX_BATCH:
        raise ValueError(f"{b} batch rows: the kernel takes at most {MAX_BATCH}")


def _z_rows(z: torch.Tensor):
    """z and the elements between its position rows: a view whose last axis
    is contiguous and whose rows are evenly spaced (``xz``'s second half)
    is read in place; anything else is made contiguous."""
    b, s, di = z.shape
    if z.stride(2) == 1 and z.stride(1) >= di and z.stride(0) == s * z.stride(1):
        return z, z.stride(1)
    return z.contiguous(), di


def states_shape(x1: torch.Tensor, a: torch.Tensor):
    """The saved states' shape: (B, ceil(S / SCAN_SPAN), n, di)."""
    b, s, di = x1.shape
    return (b, -(-s // SCAN_SPAN), a.shape[1], di)


def _check_bwd(x1, a, grad, grad_dtype, hsave) -> None:
    """Refuse what the backward kernel does not take (after :func:`_check`):
    the output's gradient (B, S, di) in ``grad_dtype`` and the saved states."""
    for name, t, shape, dtype in (("the output's gradient", grad, tuple(x1.shape), grad_dtype),
                                  ("hsave", hsave, states_shape(x1, a), torch.float32)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if t.device != x1.device:
            raise ValueError(f"{name} lies on {t.device}, x1 on {x1.device}")
    residuals.require_written("hsave", hsave)


def _launch(x1, dt, a, bmat, cmat, z=None, dt_bias=None, dd=None, keep: bool = False):
    """The output, and with ``keep`` also the saved states: ``(out, hsave)``."""
    b, s, di = x1.shape
    dev = x1.device
    gated = z is not None
    x1, dt, a, bmat, cmat = (t.contiguous() for t in (x1, dt, a, bmat, cmat))
    out = torch.empty((b, s, di), dtype=x1.dtype if gated else torch.float32, device=dev)
    hsave = torch.empty(states_shape(x1, a), dtype=torch.float32, device=dev) if keep else None
    if out.numel() == 0:
        return (out, hsave) if keep else out
    if gated:
        z, z_step = _z_rows(z)
        dt_bias, dd = dt_bias.contiguous(), dd.contiguous()
        ptrs = (z.data_ptr(), z_step, dt.data_ptr(), dt_bias.data_ptr(), a.data_ptr(),
                bmat.data_ptr(), cmat.data_ptr(), dd.data_ptr())
    else:
        ptrs = (None, di, dt.data_ptr(), None, a.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
                None)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    err = build.library(NAME).selective_scan_launch(
        index, build.stream_handle(dev), _DTYPE_CODES[x1.dtype], int(gated), x1.data_ptr(),
        *ptrs, out.data_ptr(), hsave.data_ptr() if keep else None, b, s, di, a.shape[1])
    build.check(err, NAME)
    LAUNCH_COUNTS[NAME] += 1
    if keep:
        LAUNCH_COUNTS[RESIDUALS_COUNTER] += 1
        return out, hsave
    return out


def _launch_bwd(x1, dt, a, bmat, cmat, grad, hsave, z=None, dt_bias=None, dd=None):
    """The backward kernel's call (two launches): ``(dx1, ddt, da, dbmat,
    dcmat)``, gated ``(dx1, dz, ddt_raw, ddt_bias, da, dbmat, dcmat, ddd)``."""
    b, s, di = x1.shape
    n = a.shape[1]
    dev = x1.device
    gated = z is not None
    f32 = dict(dtype=torch.float32, device=dev)
    x1, dt, a, bmat, cmat, grad, hsave = (t.contiguous() for t in
                                          (x1, dt, a, bmat, cmat, grad, hsave))
    dx = torch.empty((b, s, di), dtype=x1.dtype, device=dev)
    dz = torch.empty((b, s, di), dtype=x1.dtype, device=dev) if gated else None
    ddt = torch.empty((b, s, di), **f32)
    dcm, dbm = torch.empty((b, s, n), **f32), torch.empty((b, s, n), **f32)
    da = torch.empty((di, n), **f32)
    ddd, dbias = (torch.empty((di,), **f32), torch.empty((di,), **f32)) if gated else (None,
                                                                                    None)
    outs = (dx, dz, ddt, dbias, da, dbm, dcm, ddd) if gated else (dx, ddt, da, dbm, dcm)
    if dx.numel() == 0:
        for t in outs:
            if t is not None and t.dtype == torch.float32:
                t.zero_()
        return outs
    part = torch.empty((b, s, -(-di // TILE), VALUES), **f32)
    part_a = torch.empty((b, di, n), **f32)
    part_dd = torch.empty((b, di), **f32) if gated else None
    part_bias = torch.empty((b, di), **f32) if gated else None
    if gated:
        z, z_step = _z_rows(z)
        dt_bias, dd = dt_bias.contiguous(), dd.contiguous()
    else:
        z_step = di
    ptr = lambda t: None if t is None else t.data_ptr()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    err = build.library(BWD_NAME).selective_scan_bwd_launch(
        index, build.stream_handle(dev), _DTYPE_CODES[x1.dtype], int(gated), x1.data_ptr(),
        ptr(z), z_step, dt.data_ptr(), ptr(dt_bias), a.data_ptr(), bmat.data_ptr(),
        cmat.data_ptr(), ptr(dd), grad.data_ptr(), hsave.data_ptr(), dx.data_ptr(), ptr(dz),
        ddt.data_ptr(), dcm.data_ptr(), dbm.data_ptr(), da.data_ptr(), ptr(ddd), ptr(dbias),
        part.data_ptr(), part_a.data_ptr(), ptr(part_dd), ptr(part_bias), b, s, di, n)
    build.check(err, BWD_NAME)
    LAUNCH_COUNTS[BWD_NAME] += 1
    return outs


def _saved_states(x1, a, keep_out):
    """The forward's ``(out, hsave)``, a placeholder for ``hsave`` when the
    forward kept none."""
    if isinstance(keep_out, tuple):
        return keep_out
    return keep_out, residuals.placeholder(states_shape(x1, a), x1.device)


class _SelectiveScan(torch.autograd.Function):
    """The kernel under autograd on the card; its backward is
    :func:`selective_scan_bwd`."""

    @staticmethod
    def forward(ctx, x1, dt, a, bmat, cmat):
        ys, hsave = _saved_states(x1, a, _launch(x1, dt, a, bmat, cmat,
                                                 keep=residuals.wanted()))
        ctx.save_for_backward(x1, dt, a, bmat, cmat, hsave)
        return ys

    @staticmethod
    def backward(ctx, dys):
        x1, dt, a, bmat, cmat, hsave = ctx.saved_tensors
        return selective_scan_bwd(x1, dt, a, bmat, cmat, dys, hsave)


class _SelectiveScanGated(torch.autograd.Function):
    """The gated kernel under autograd on the card; its backward is
    :func:`selective_scan_gated_bwd`."""

    @staticmethod
    def forward(ctx, x1, z, dt_raw, dt_bias, a, bmat, cmat, dd):
        out, hsave = _saved_states(x1, a, _launch(x1, dt_raw, a, bmat, cmat, z=z,
                                                  dt_bias=dt_bias, dd=dd,
                                                  keep=residuals.wanted()))
        ctx.save_for_backward(x1, z, dt_raw, dt_bias, a, bmat, cmat, dd, hsave)
        return out

    @staticmethod
    def backward(ctx, dout):
        *args, hsave = ctx.saved_tensors
        return selective_scan_gated_bwd(*args, dout, hsave)


def selective_scan(x1: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                   cmat: torch.Tensor, *, chunk: int = 1024) -> torch.Tensor:
    """``ys`` (B, S, di) float32 of the Mamba-1 recurrence from a zero state:
    ``h = h exp(dt a) + (dt x1) b`` and ``y = sum_n h c`` at every position.

    ``x1`` (B, S, di) float32 or bfloat16 (read as float32), ``dt`` (B, S,
    di), ``a`` (di, n) with 1 <= n <= 16, ``bmat`` and ``cmat`` (B, S, n)
    float32.  ``chunk`` is the plain version's (the CPU's) memory bound, the
    reference's ``mamba_train`` chunk; the kernel walks all S positions at
    once.
    """
    _check(x1, dt, a, bmat, cmat)
    if x1.device.type == "cpu":
        return selective_scan_plain(x1, dt, a, bmat, cmat, chunk=chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x1, dt, a, bmat, cmat)):
        return _SelectiveScan.apply(x1, dt, a, bmat, cmat)
    return _launch(x1, dt, a, bmat, cmat)


def selective_scan_gated(x1: torch.Tensor, z: torch.Tensor, dt_raw: torch.Tensor,
                         dt_bias: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                         cmat: torch.Tensor, dd: torch.Tensor, out_dtype: torch.dtype = None,
                         *, chunk: int = 1024) -> torch.Tensor:
    """``mamba_train``'s scan with its neighbours: ``dt = softplus(dt_raw +
    dt_bias)`` (``ref.softplus``'s form), the scan of :func:`selective_scan`,
    then ``((ys + dd x1) * silu(z))`` in float32, cast to ``out_dtype``.

    ``x1`` and ``z`` (B, S, di) in the model's dtype (float32 or bfloat16;
    ``z`` may be a view with evenly spaced position rows), ``dt_raw`` (B, S,
    di), ``dt_bias`` and ``dd`` (di,), ``a`` (di, n), ``bmat`` and ``cmat``
    (B, S, n) float32; ``out_dtype`` (x1's dtype, the default) is the
    output's.  ``chunk`` bounds the plain version's memory on the CPU.
    """
    out_dtype = x1.dtype if out_dtype is None else out_dtype
    _check(x1, dt_raw, a, bmat, cmat, z=z, dt_bias=dt_bias, dd=dd, out_dtype=out_dtype)
    args = (x1, z, dt_raw, dt_bias, a, bmat, cmat, dd)
    if x1.device.type == "cpu":
        return selective_scan_gated_plain(*args, out_dtype, chunk=chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _SelectiveScanGated.apply(*args)
    return _launch(x1, dt_raw, a, bmat, cmat, z=z, dt_bias=dt_bias, dd=dd)


def selective_scan_states_of(x1: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                             bmat: torch.Tensor, cmat: torch.Tensor, z: torch.Tensor = None,
                             dt_bias: torch.Tensor = None, dd: torch.Tensor = None):
    """``(out, hsave)``: :func:`selective_scan` (or, given ``z``, ``dt_bias``
    and ``dd``, :func:`selective_scan_gated` with ``dt`` raw) with the states
    its backward reads, the state entering every SCAN_SPAN positions
    (``ref.selective_scan_states`` on the CPU, the forward kernel saving them
    on the card)."""
    gated = z is not None
    if gated:
        _check(x1, dt, a, bmat, cmat, z=z, dt_bias=dt_bias, dd=dd, out_dtype=x1.dtype)
    else:
        _check(x1, dt, a, bmat, cmat)
    if x1.device.type == "cpu":
        if gated:
            out = selective_scan_gated_plain(x1, z, dt, dt_bias, a, bmat, cmat, dd, x1.dtype)
            return out, selective_scan_states(x1, ref_softplus(dt + dt_bias), a, bmat)
        return selective_scan_plain(x1, dt, a, bmat, cmat), selective_scan_states(x1, dt, a, bmat)
    return _launch(x1, dt, a, bmat, cmat, z=z, dt_bias=dt_bias, dd=dd, keep=True)


def selective_scan_bwd(x1: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                       cmat: torch.Tensor, dys: torch.Tensor, hsave: torch.Tensor):
    """``(dx1, ddt, da, dbmat, dcmat)``: the gradient of
    :func:`selective_scan` for ``dys`` (B, S, di) float32, from the saved
    states ``hsave`` (:func:`selective_scan_states_of`); ``dx1`` in x1's
    dtype, the rest float32.  A CPU tensor goes to
    ``ref.selective_scan_bwd_plain``, a CUDA tensor to the kernel."""
    _check(x1, dt, a, bmat, cmat)
    _check_bwd(x1, a, dys, torch.float32, hsave)
    if x1.device.type == "cpu":
        return selective_scan_bwd_plain(x1, dt, a, bmat, cmat, dys, hsave)
    return _launch_bwd(x1, dt, a, bmat, cmat, dys, hsave)


def selective_scan_gated_bwd(x1: torch.Tensor, z: torch.Tensor, dt_raw: torch.Tensor,
                             dt_bias: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                             cmat: torch.Tensor, dd: torch.Tensor, dout: torch.Tensor,
                             hsave: torch.Tensor):
    """``(dx1, dz, ddt_raw, ddt_bias, da, dbmat, dcmat, ddd)``: the gradient
    of :func:`selective_scan_gated` for ``dout`` (B, S, di) in the output's
    dtype (x1's), from the saved states; ``dx1`` and ``dz`` in x1's dtype,
    the rest float32.  A CPU tensor goes to
    ``ref.selective_scan_gated_bwd_plain``, a CUDA tensor to the kernel."""
    _check(x1, dt_raw, a, bmat, cmat, z=z, dt_bias=dt_bias, dd=dd, out_dtype=x1.dtype)
    _check_bwd(x1, a, dout, x1.dtype, hsave)
    if x1.device.type == "cpu":
        return selective_scan_gated_bwd_plain(x1, z, dt_raw, dt_bias, a, bmat, cmat, dd, dout,
                                              hsave)
    return _launch_bwd(x1, dt_raw, a, bmat, cmat, dout, hsave, z=z, dt_bias=dt_bias, dd=dd)
