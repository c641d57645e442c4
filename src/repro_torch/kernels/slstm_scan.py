"""The sLSTM scan: the wrapper of ``csrc/slstm_scan.cu``.

It replaces no Pallas kernel: the reference's ``_slstm_scan_p``
(``repro/models/ssm.py:412``, forward ``_slstm_scan_fwd_impl`` ``:356``)
steps one position at a time in a ``lax.scan``.  As torch ops that is about
fifteen launches a position: a 2,048-token prefill of xlstm-350m's twelve
sLSTM layers would take some 370,000.  The kernel walks every position in
one launch; the source says what bounds it.

A CPU tensor goes to the plain version (``ref.slstm_scan_plain``), which
autograd differentiates; a CUDA tensor goes to the kernel, or the call
raises.  Under autograd on the card the kernel runs inside an autograd
function whose backward raises: the counterpart of ``_slstm_scan_bwd``
waits for ROADMAP A7.4b.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import slstm_scan_plain
from repro_torch.runtime.guards import LAUNCH_COUNTS

NAME = "slstm_scan"
MAX_UNITS = 256  # units a head: a block has a thread per pre-activation, 4 uh <= 1,024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
BACKWARD_WAITS = ("the sLSTM scan's backward on the card waits for its kernel "
                  "(ROADMAP A7.4b); train on the CPU, where autograd differentiates the "
                  "plain version")


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


def _launch(xproj, wr, bias) -> torch.Tensor:
    b, s, _ = xproj.shape
    hh, uh, _ = wr.shape
    if uh > MAX_UNITS:
        raise ValueError(f"{uh} units a head: the kernel takes at most {MAX_UNITS}")
    if b > 65535:
        raise ValueError(f"{b} batch rows: the grid's y axis holds 65,535")
    dev = xproj.device
    xproj, wr, bias = xproj.contiguous(), wr.contiguous(), bias.contiguous()
    hs = torch.empty((b, s, hh, uh), dtype=torch.float32, device=dev)
    if hs.numel() == 0:
        return hs
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    err = build.library(NAME).slstm_scan_launch(
        index, build.stream_handle(dev), _DTYPE_CODES[xproj.dtype], _DTYPE_CODES[wr.dtype],
        xproj.data_ptr(), wr.data_ptr(), bias.data_ptr(), hs.data_ptr(), b, s, hh, uh)
    build.check(err, NAME)
    LAUNCH_COUNTS[NAME] += 1
    return hs


class _SlstmScan(torch.autograd.Function):
    """The kernel under autograd on the card; its backward raises."""

    @staticmethod
    def forward(ctx, xproj, wr, bias):
        return _launch(xproj, wr, bias)

    @staticmethod
    def backward(ctx, dhs):
        raise NotImplementedError(BACKWARD_WAITS)


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
