"""Whether the scan kernels' forwards write what their backwards read.

Under autograd on the card, ``selective_scan``'s and ``slstm_scan``'s
forwards save residuals for their backward kernels (the selective scan's
state every 4 positions; the sLSTM's gate pre-activations and states).  A
forward that ``torch.utils.checkpoint`` will run again before the backward
(``models/lm.py``'s ``remat="full"``) need not write them: its saved
tensors are dropped and the rerun's are used.  ``lm._remat`` runs the
first forward under :func:`skipped`; the autograd functions then save
placeholders of the residuals' shapes, which the checkpoint's metadata
check compares, and launch without them.  The backward wrappers refuse a
placeholder (:func:`require_written`), so a backward never reads one.
"""
from __future__ import annotations

import contextlib
import threading

_STATE = threading.local()


def wanted() -> bool:
    """False inside :func:`skipped`."""
    return not getattr(_STATE, "skip", False)


@contextlib.contextmanager
def skipped():
    """Forwards under this write no residuals."""
    prev = getattr(_STATE, "skip", False)
    _STATE.skip = True
    try:
        yield
    finally:
        _STATE.skip = prev


def placeholder(shape, device) -> "torch.Tensor":
    """A float32 tensor of ``shape`` that owns no memory (an expanded
    scalar): what a skipped forward saves in a residual's place."""
    import torch

    return torch.zeros((), dtype=torch.float32, device=device).expand(shape)


def require_written(name: str, t) -> None:
    """Refuse a placeholder: a residual whose every stride is 0 (a
    broadcast scalar) is what a forward under :func:`skipped` saved in
    place of the one it did not write."""
    if t.dim() > 0 and all(st == 0 for st in t.stride()):
        raise ValueError(f"{name} is a placeholder: the forward that saved it ran under "
                         f"residuals.skipped and wrote no residuals")
