"""The selective scan (Mamba-1): the wrapper of ``csrc/selective_scan.cu``.

It replaces no Pallas kernel: the reference's ``mamba_train``
(``repro/models/ssm.py:58``) runs the scan as two nested ``lax.scan``s,
and a per-step loop of torch ops would launch a few kernels a position and
materialize (B, chunk, di, n) float32 ``decay`` and ``drive`` tensors, 17.2
GB each at jamba-1.5-large's width with 16 rows of 1,024 positions.  The
kernel keeps the state in registers and walks every position in one
launch; the source says what bounds it.

A CPU tensor goes to the plain version (``ref.selective_scan_plain``),
which autograd differentiates; a CUDA tensor goes to the kernel, or the
call raises.  Under autograd on the card the kernel runs inside an
autograd function whose backward raises: the scan's backward kernel waits
for ROADMAP A7.4b.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import selective_scan_plain
from repro_torch.runtime.guards import LAUNCH_COUNTS

NAME = "selective_scan"
MAX_STATE = 16  # states a channel keeps in registers (the source's kMaxState)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
BACKWARD_WAITS = ("the selective scan's backward on the card waits for its kernel "
                  "(ROADMAP A7.4b); train on the CPU, where autograd differentiates the "
                  "plain version")


def _check(x1, dt, a, bmat, cmat) -> None:
    if x1.dim() != 3:
        raise ValueError(f"x1 must be (B, S, di), got {tuple(x1.shape)}")
    b, s, di = x1.shape
    n = a.shape[-1]
    want = {"dt": (dt, (b, s, di)), "a": (a, (di, n)), "bmat": (bmat, (b, s, n)),
            "cmat": (cmat, (b, s, n))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}, expected torch.float32")
        if t.device != x1.device:
            raise ValueError(f"{name} lies on {t.device}, x1 on {x1.device}")
    if x1.dtype not in _DTYPE_CODES:
        raise TypeError(f"x1 has dtype {x1.dtype}: the kernel reads float32 or bfloat16")


def _launch(x1, dt, a, bmat, cmat) -> torch.Tensor:
    b, s, di = x1.shape
    n = a.shape[-1]
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"{n} states a channel: the kernel keeps 1 to {MAX_STATE}")
    if b > 65535:
        raise ValueError(f"{b} batch rows: the grid's y axis holds 65,535")
    dev = x1.device
    x1, dt, a, bmat, cmat = (t.contiguous() for t in (x1, dt, a, bmat, cmat))
    ys = torch.empty((b, s, di), dtype=torch.float32, device=dev)
    if ys.numel() == 0:
        return ys
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    err = build.library(NAME).selective_scan_launch(
        index, build.stream_handle(dev), _DTYPE_CODES[x1.dtype], x1.data_ptr(), dt.data_ptr(),
        a.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), ys.data_ptr(), b, s, di, n)
    build.check(err, NAME)
    LAUNCH_COUNTS[NAME] += 1
    return ys


class _SelectiveScan(torch.autograd.Function):
    """The kernel under autograd on the card; its backward raises."""

    @staticmethod
    def forward(ctx, x1, dt, a, bmat, cmat):
        return _launch(x1, dt, a, bmat, cmat)

    @staticmethod
    def backward(ctx, dys):
        raise NotImplementedError(BACKWARD_WAITS)


def selective_scan(x1: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                   cmat: torch.Tensor, *, chunk: int = 1024) -> torch.Tensor:
    """``ys`` (B, S, di) float32 of the Mamba-1 recurrence from a zero state:
    ``h = h exp(dt a) + (dt x1) b`` and ``y = sum_n h c`` at every position.

    ``x1`` (B, S, di) float32 or bfloat16 (read as float32), ``dt`` (B, S,
    di), ``a`` (di, n), ``bmat`` and ``cmat`` (B, S, n) float32.  ``chunk``
    is the plain version's (the CPU's) memory bound, the reference's
    ``mamba_train`` chunk; the kernel walks all S positions at once.
    """
    _check(x1, dt, a, bmat, cmat)
    if x1.device.type == "cpu":
        return selective_scan_plain(x1, dt, a, bmat, cmat, chunk=chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x1, dt, a, bmat, cmat)):
        return _SelectiveScan.apply(x1, dt, a, bmat, cmat)
    return _launch(x1, dt, a, bmat, cmat)
