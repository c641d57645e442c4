"""The sLSTM scan: the wrapper of ``csrc/slstm_scan.cu``.

It replaces no Pallas kernel: the reference's ``_slstm_scan_p``
(``repro/models/ssm.py:412``, forward ``_slstm_scan_fwd_impl`` ``:356``)
steps one position at a time in a ``lax.scan``.  As torch ops that is about
fifteen launches a position: a 2,048-token prefill of xlstm-350m's twelve
sLSTM layers would take some 370,000.  The kernel walks every position in
one launch.

The recurrence is block-diagonal by head, so the kernel gives each head and
group of batch rows a thread-block cluster (:func:`plan`): each CTA of the
cluster holds its units' four gate columns of ``wr`` in shared memory for
the whole call, takes their recurrent product in float32 on the CUDA cores
(``slices`` partial sums of ``slice`` u each, added in order: the order
depends on ``uh`` alone), updates their cells, and sends their new ``h`` to
every CTA of the cluster through distributed shared memory, one wait a
position.  A group's rows run as one or two halves that take turns at the
product.  The source says what bounds it; ``kernels/scan_probe.py``
measures it.

A CPU tensor goes to the plain version (``ref.slstm_scan_plain``), which
autograd differentiates; a CUDA tensor goes to the kernel, or the call
raises (a shape no plan takes raises ValueError).  Under autograd on the
card the kernel runs inside an autograd function: its forward also writes
the gate pre-activations and the states c, n and m of every position
(float32; the reference's residuals ``hs_prev`` and ``states_prev``, with
the recurrent product kept), and its backward is :func:`slstm_scan_bwd`:
the reverse scan in ``csrc/slstm_scan_bwd.cu`` (one launch a call, counted
under ``LAUNCH_COUNTS["slstm_scan_bwd"]``, on the forward's cluster with a
plan of its own: product threads reduce-scatter the CTA's share of dh,
cell threads run the cell's backward) for ``dpre``, then ``dwr`` and
``dbias`` as one float32 matrix product a head and one sum
(``ref.slstm_weight_grads``).  ``LAUNCH_COUNTS["slstm_scan.residuals"]``
counts the forwards that wrote residuals (not those under
``residuals.skipped``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels import build, residuals
from repro_torch.kernels.ref import (slstm_scan_bwd_plain, slstm_scan_fwd_plain,
                                     slstm_scan_plain, slstm_weight_grads)
from repro_torch.runtime.guards import LAUNCH_COUNTS

NAME = "slstm_scan"
BWD_NAME = "slstm_scan_bwd"
RESIDUALS_COUNTER = "slstm_scan.residuals"  # forwards that wrote the backward's residuals
# Mirrored by the source's constexprs (kMaxUnits, kMaxCluster, kMaxShare,
# kMaxRows, kMaxHalves, kMaxSmem, kOnePerSm) and its Layout.
MAX_UNITS = 256  # units a head
MAX_CLUSTER = 8  # CTAs a head: the portable cluster size
MAX_SHARE = 32  # units a CTA: 4 x 32 gate columns, 128 threads a half
MAX_ROWS = 4  # batch rows a half (8 fmaf chains a row a thread)
MAX_HALVES = 2  # halves of a group's rows, in turn at the product
MAX_SMEM = 232_448  # dynamic shared memory a block can have on an H100
ONE_PER_SM = 118_784  # two CTAs of this many bytes do not fit one SM's 228 KB
# Clusters of 1, 2, 4 and 8 CTAs resident at once on an H100 SXM (132 SMs in
# GPCs of unequal size; cudaOccupancyMaxActiveClusters on the card, one CTA
# an SM), used where the card is not asked.
RESIDENT = {1: 132, 2: 66, 4: 30, 8: 15}
# The planner's clocks a position (used only to rank plans): (fixed, for
# the cell, the exchange and the waits; per half and round of 4 inputs of
# the product, a row; the same, a round), the forward's fitted to the
# card's times of every plan at 1 to 16 rows of 4 x 256 (``scan_probe
# --plans``), the backward's to its own (``scan_probe --bwd --plans``).
CLOCKS = (1700, 62, 40)
BWD_CLOCKS = (1550, 88, 12)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@dataclass(frozen=True)
class Plan:
    """One launch: clusters of ``cluster`` CTAs, one a (head, group of batch
    rows), ``groups`` groups (the grid's y), ``halves`` halves of at most
    ``rows`` rows a CTA, ``threads`` threads and ``smem`` bytes of dynamic
    shared memory a CTA.  Each output's recurrent product is ``slices``
    fmaf chains over ``slice`` consecutive u each, added in order."""

    cluster: int
    groups: int
    halves: int
    rows: int
    threads: int
    smem: int
    slice: int
    slices: int

    def units(self, uh: int) -> Tuple[Tuple[int, int], ...]:
        """Each CTA's units of a head, ``(first, count)`` by rank (the
        source's ``lo`` and ``n``)."""
        c = self.cluster
        return tuple((k * uh // c, (k + 1) * uh // c - k * uh // c) for k in range(c))

    def row_ranges(self, b: int) -> Tuple[Tuple[int, int], ...]:
        """Each (group, half)'s batch rows, ``(first, count)`` (the source's
        ``b0`` and ``rows``)."""
        out = []
        for y in range(self.groups):
            g0, g1 = y * b // self.groups, (y + 1) * b // self.groups
            for p in range(self.halves):
                first = g0 + (g1 - g0) * p // self.halves
                out.append((first, g0 + (g1 - g0) * (p + 1) // self.halves - first))
        return tuple(out)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def rows_of(b: int, groups: int, halves: int) -> int:
    """The rows of the most-filled half (the source's ``rows_of``)."""
    return _ceil(_ceil(b, groups), halves)


def slices_of(uh: int, cluster: int, backward: bool = False) -> Tuple[int, int]:
    """``(slice, slices)``: the inputs a partial sum covers and their count
    (the source's ``Layout``; ``csrc/slstm_scan_bwd.cu``'s ``BwdLayout``
    with ``backward``): a half's threads are groups of 8 of the CTA's padded
    outputs times slices of the inputs, a multiple of 4 each.  The forward's
    inputs are uh units and its outputs the share's 4 gates; the backward's
    inputs are the share's 4 gate columns and its outputs the head's uh
    units."""
    share = _ceil(uh, cluster)
    inputs, outputs = (4 * share, uh) if backward else (uh, 4 * share)
    ngroups = _ceil(outputs, 8)
    k = min(_ceil(4 * share, 32) * 32 // ngroups, _ceil(inputs, 4))
    slice_ = _ceil(_ceil(inputs, k), 4) * 4
    return slice_, _ceil(inputs, slice_)


def half_threads(uh: int, cluster: int, backward: bool = False) -> int:
    """A half's threads: round_up(4 share, 32), the product's; with
    ``backward`` also cell threads, half as many rounded to warps (the
    source's ``bwd_product_threads`` and ``bwd_cell_threads``)."""
    product = _ceil(4 * _ceil(uh, cluster), 32) * 32
    return product + _ceil(product // 2, 32) * 32 if backward else product


def smem_bytes(uh: int, cluster: int, rows: int, halves: int, w_bytes: int,
               backward: bool = False) -> int:
    """A CTA's dynamic shared memory (the source's ``Layout`` and
    ``smem_for``, or with ``backward`` ``BwdLayout`` and ``bwd_smem_for``);
    at least ONE_PER_SM.  Forward, per half: two mbarriers, h
    double-buffered ([2][rows][uh rounded to 8] float32), the partial sums
    ([rows][slices][4 share rounded to 8]) and the share's new h; then the
    CTA's wr columns [uh][4 share rounded to 8] in the stored dtype.
    Backward, per half: two mbarriers, the CTA's new dpre ([rows][slices x
    slice]), the partial sums ([rows][slices][uh rounded to 8]) and the
    cluster's partial dh double-buffered ([2][rows][cluster][share rounded
    to 4]); then wr's rows for the CTA's gate columns, transposed
    ([slices x slice][uh rounded to 8])."""
    share = _ceil(uh, cluster)
    slice_, slices = slices_of(uh, cluster, backward)
    if backward:
        kk, uh8 = slices * slice_, _ceil(uh, 8) * 8
        per_half = (rows * kk * 4 + rows * slices * uh8 * 4
                    + 2 * rows * cluster * _ceil(share, 4) * 16)
        weights = kk * uh8 * w_bytes
    else:
        cpad = _ceil(4 * share, 8) * 8
        per_half = (2 * rows * _ceil(uh, 8) * 8 * 4 + rows * slices * cpad * 4
                    + _ceil(rows * share * 4, 16) * 16)
        weights = uh * cpad * w_bytes
    need = 16 * MAX_HALVES + halves * per_half + _ceil(weights, 16) * 16
    return max(need, ONE_PER_SM)


def plan(b: int, hh: int, uh: int, w_bytes: int,
         max_clusters: Optional[Callable[[int, int, int, int], int]] = None,
         backward: bool = False) -> Plan:
    """The launch for ``b`` batch rows of ``hh`` heads of ``uh`` units with
    ``wr`` of ``w_bytes`` (4 float32, 2 bfloat16) a weight; with
    ``backward``, of ``csrc/slstm_scan_bwd.cu`` (the same cluster; its own
    threads, shared memory, slices and clocks, so its own groups and
    halves).

    The cluster is the fewest CTAs (1, 2, 4 or 8) that leave each at most
    MAX_SHARE units: a half of 4 product warps at uh = 256.  The groups and
    halves are those whose launch takes the fewest estimated clocks: waves
    of resident clusters (``max_clusters(cluster, groups, halves, smem)``,
    else RESIDENT) times a position's.  Raises ValueError for a shape no
    plan takes."""
    if not 1 <= uh <= MAX_UNITS:
        raise ValueError(f"{uh} units a head: the kernel takes 1 to {MAX_UNITS}")
    if b < 1 or hh < 1:
        raise ValueError(f"{b} batch rows of {hh} heads: the kernel needs at least one of each")
    if w_bytes not in (2, 4):
        raise ValueError(f"wr of {w_bytes} bytes a weight: the kernel reads float32 or bfloat16")
    cluster = next(c for c in (1, 2, 4, MAX_CLUSTER) if _ceil(uh, c) <= MAX_SHARE)
    role_threads = half_threads(uh, cluster, backward)
    slice_, slices = slices_of(uh, cluster, backward)
    fixed, chunk_row, chunk = BWD_CLOCKS if backward else CLOCKS
    best, best_cost = None, math.inf
    for halves in range(1, MAX_HALVES + 1):
        for groups in sorted({_ceil(b, r) for r in range(1, MAX_ROWS * halves + 1)}):
            rows = rows_of(b, groups, halves)
            if groups > 65535 or b // groups < halves or rows > MAX_ROWS:
                continue
            smem = smem_bytes(uh, cluster, rows, halves, w_bytes, backward)
            if smem > MAX_SMEM:
                continue
            resident = max_clusters(cluster, groups, halves, smem) if max_clusters else None
            resident = resident if resident and resident > 0 else RESIDENT[cluster]
            position = fixed + halves * _ceil(slice_, 4) * (chunk_row * rows + chunk)
            cost = _ceil(hh * groups, resident) * position
            if cost < best_cost:
                best_cost = cost
                best = Plan(cluster, groups, halves, rows, halves * role_threads, smem, slice_,
                            slices)
    if best is None:
        raise ValueError(f"{b} batch rows: the grid's y axis holds 65,535 groups of at most "
                         f"{MAX_ROWS * MAX_HALVES} rows")
    return best


_PLANS: Dict[tuple, Plan] = {}


def card_plan(index: int, x_code: int, w_code: int, b: int, hh: int, uh: int,
              backward: bool = False) -> Plan:
    """:func:`plan` with the card's resident clusters
    (``slstm_scan_max_clusters``, or ``slstm_scan_bwd_max_clusters``),
    cached by shape."""
    key = (index, x_code, w_code, b, hh, uh, backward)
    got = _PLANS.get(key)
    if got is None:
        if backward:
            lib = build.library(BWD_NAME)

            def resident(cluster: int, groups: int, halves: int, smem: int) -> int:
                return lib.slstm_scan_bwd_max_clusters(index, w_code, b, hh, uh, cluster, groups,
                                                       halves, smem)
        else:
            lib = build.library(NAME)

            def resident(cluster: int, groups: int, halves: int, smem: int) -> int:
                return lib.slstm_scan_max_clusters(index, x_code, w_code, b, hh, uh, cluster,
                                                   groups, halves, smem)

        got = _PLANS[key] = plan(b, hh, uh, 2 if w_code else 4, resident, backward)
    return got


def _check(xproj, wr, bias) -> None:
    if xproj.dim() != 3 or wr.dim() != 3:
        raise ValueError(f"xproj must be (B, S, 4d) and wr (H, uh, 4 uh), got "
                         f"{tuple(xproj.shape)} and {tuple(wr.shape)}")
    hh, uh, g4 = wr.shape
    if g4 != 4 * uh or xproj.shape[-1] != 4 * hh * uh or tuple(bias.shape) != (4 * hh * uh,):
        raise ValueError(f"xproj {tuple(xproj.shape)}, wr {tuple(wr.shape)} and bias "
                         f"{tuple(bias.shape)} do not make 4d = 4 H uh")
    for name, t in (("xproj", xproj), ("wr", wr), ("bias", bias)):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name} has dtype {t.dtype}: the kernel reads float32 or bfloat16")
        if t.device != xproj.device:
            raise ValueError(f"{name} lies on {t.device}, xproj on {xproj.device}")
    if bias.dtype != wr.dtype:
        raise TypeError(f"bias has dtype {bias.dtype}, wr {wr.dtype}")


def _check_bwd(xproj, wr, pre, states, hs, dhs) -> None:
    """Refuse what the backward kernel does not take (after :func:`_check`)."""
    b, s, g4 = xproj.shape
    hh, uh, _ = wr.shape
    want = {"pre": (pre, (b, s, g4))}
    want.update({name: (t, (b, s, hh, uh)) for name, t in
                 zip(("c", "n", "m", "hs", "dhs"), (*states, hs, dhs))})
    if len(states) != 3:
        raise ValueError(f"states must be (c, n, m), got {len(states)} tensors")
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}, expected torch.float32")
        if t.device != xproj.device:
            raise ValueError(f"{name} lies on {t.device}, xproj on {xproj.device}")
    for name in ("pre", "c", "n", "m"):
        residuals.require_written(name, want[name][0])


def _index(dev) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _launch(xproj, wr, bias, keep: bool = False):
    """``hs``, and with ``keep`` the residuals ``(hs, pre, (c, n, m))``."""
    b, s, _ = xproj.shape
    hh, uh, _ = wr.shape
    dev = xproj.device
    xproj, wr, bias = xproj.contiguous(), wr.contiguous(), bias.contiguous()
    hs = torch.empty((b, s, hh, uh), dtype=torch.float32, device=dev)
    res = None
    if keep:
        res = (torch.empty((b, s, 4 * hh * uh), dtype=torch.float32, device=dev),
               tuple(torch.empty_like(hs) for _ in range(3)))
    if hs.numel() == 0:
        return (hs, *res) if keep else hs
    index = _index(dev)
    x_code, w_code = _DTYPE_CODES[xproj.dtype], _DTYPE_CODES[wr.dtype]
    p = card_plan(index, x_code, w_code, b, hh, uh)
    ptrs = (res[0].data_ptr(), *(t.data_ptr() for t in res[1])) if keep else (None,) * 4
    err = build.library(NAME).slstm_scan_launch(
        index, build.stream_handle(dev), x_code, w_code, xproj.data_ptr(), wr.data_ptr(),
        bias.data_ptr(), hs.data_ptr(), b, s, hh, uh, p.cluster, p.groups, p.halves, p.smem,
        *ptrs)
    build.check(err, NAME)
    LAUNCH_COUNTS[NAME] += 1
    if keep:
        LAUNCH_COUNTS[RESIDUALS_COUNTER] += 1
        return (hs, *res)
    return hs


def _launch_bwd(wr, pre, states, dhs) -> torch.Tensor:
    """``dpre`` (B, S, 4d) float32 from the backward kernel."""
    b, s, g4 = pre.shape
    hh, uh, _ = wr.shape
    dev = pre.device
    wr, pre, dhs = wr.contiguous(), pre.contiguous(), dhs.contiguous()
    c, n, m = (t.contiguous() for t in states)
    dpre = torch.empty((b, s, g4), dtype=torch.float32, device=dev)
    if dpre.numel() == 0:
        return dpre
    index = _index(dev)
    w_code = _DTYPE_CODES[wr.dtype]
    p = card_plan(index, 0, w_code, b, hh, uh, backward=True)
    err = build.library(BWD_NAME).slstm_scan_bwd_launch(
        index, build.stream_handle(dev), w_code, wr.data_ptr(), pre.data_ptr(), c.data_ptr(),
        n.data_ptr(), m.data_ptr(), dhs.data_ptr(), dpre.data_ptr(), b, s, hh, uh, p.cluster,
        p.groups, p.halves, p.smem)
    build.check(err, BWD_NAME)
    LAUNCH_COUNTS[BWD_NAME] += 1
    return dpre


class _SlstmScan(torch.autograd.Function):
    """The kernel under autograd on the card: the forward keeps its
    residuals (placeholders under ``residuals.skipped``), the backward is
    :func:`slstm_scan_bwd`."""

    @staticmethod
    def forward(ctx, xproj, wr, bias):
        if residuals.wanted():
            hs, pre, states = _launch(xproj, wr, bias, keep=True)
        else:
            hs = _launch(xproj, wr, bias)
            pre = residuals.placeholder((*xproj.shape[:2], xproj.shape[2]), xproj.device)
            states = tuple(residuals.placeholder(hs.shape, hs.device) for _ in range(3))
        ctx.save_for_backward(xproj, wr, bias, pre, *states, hs)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        xproj, wr, bias, pre, c, n, m, hs = ctx.saved_tensors
        return slstm_scan_bwd(xproj, wr, bias, pre, (c, n, m), hs, dhs)


def slstm_scan(xproj: torch.Tensor, wr: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``hs`` (B, S, H, uh) float32: the sLSTM's hidden state at every
    position from zero states (``m = -1e30``).

    ``xproj`` (B, S, 4d), the input projection, float32 or bfloat16;
    ``wr`` (H, uh, 4 uh), the block-diagonal recurrent weights, and
    ``bias`` (4d), in their stored dtype, widened to float32 exactly.
    """
    _check(xproj, wr, bias)
    if xproj.device.type == "cpu":
        return slstm_scan_plain(xproj, wr, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xproj, wr, bias)):
        return _SlstmScan.apply(xproj, wr, bias)
    return _launch(xproj, wr, bias)


def slstm_scan_residuals(xproj: torch.Tensor, wr: torch.Tensor, bias: torch.Tensor):
    """``(hs, pre, (c, n, m))``: :func:`slstm_scan` with the residuals its
    backward reads (``ref.slstm_scan_fwd_plain`` on the CPU, the forward
    kernel writing them on the card)."""
    _check(xproj, wr, bias)
    if xproj.device.type == "cpu":
        return slstm_scan_fwd_plain(xproj, wr, bias)
    return _launch(xproj, wr, bias, keep=True)


def slstm_scan_bwd(xproj: torch.Tensor, wr: torch.Tensor, bias: torch.Tensor,
                   pre: torch.Tensor, states, hs: torch.Tensor, dhs: torch.Tensor):
    """``(dxproj, dwr, dbias)`` in their inputs' dtypes: the gradient of
    :func:`slstm_scan` for ``dhs`` (B, S, H, uh) float32, from the forward's
    ``pre``, ``states`` (c, n, m) and ``hs`` (:func:`slstm_scan_residuals`).
    A CPU tensor goes to ``ref.slstm_scan_bwd_plain``; a CUDA tensor to the
    backward kernel for ``dpre``, then ``ref.slstm_weight_grads``: ``dwr``
    one float32 matrix product a head, ``dbias`` one sum."""
    _check(xproj, wr, bias)
    _check_bwd(xproj, wr, pre, tuple(states), hs, dhs)
    if xproj.device.type == "cpu":
        return slstm_scan_bwd_plain(xproj, wr, bias, pre, states, hs, dhs)
    b, s, _ = xproj.shape
    hh, uh, _ = wr.shape
    dpre = _launch_bwd(wr, pre, tuple(states), dhs)
    dwr, dbias = slstm_weight_grads(hs, dpre.view(b, s, hh, 4 * uh))
    return dpre.to(xproj.dtype), dwr.to(wr.dtype), dbias.to(bias.dtype)
