"""Where the port's entry points run."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.

    With no CUDA device and no explicit ``"cpu"`` this raises instead of
    quietly running on the host, so a measurement can never be a CPU run
    under a device's name.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the host")
    return dev


def to_host(x: torch.Tensor):
    """A numpy copy (or view, for a CPU tensor) of ``x``."""
    return x.detach().cpu().numpy()

