"""Threefry-2x32, bit-exact with ``jax.random`` under JAX's default config
(``jax_threefry_partitionable=True``, x64 off).

The engine's sampling, bootstrap and selection draw from ``jax.random`` in
the reference; with any other generator the samples, and so the chosen
attributes, would differ.  Only what the single-table engine path draws is
here: ``PRNGKey``, ``fold_in``, ``split`` and float32 ``uniform``.

A key is an int64 CPU tensor of shape (2,) holding two uint32 words, JAX's
raw key data.  torch has no full uint32 arithmetic, so every word is carried
in int64 and masked with ``& 0xFFFFFFFF`` after each add.  In the
partitionable scheme the ``i``-th draw of ``split``/``uniform`` hashes the
64-bit counter ``i`` as the word pair ``(i >> 32, i & 0xFFFFFFFF)``, and
``fold_in(key, d)`` hashes ``(0, d)``; ``uniform`` keeps ``b0 ^ b1`` of the
hashed pair and maps its top 23 bits onto [0, 1) through the float32
mantissa (``bits >> 9 | 0x3F800000``, minus 1.0).

Key arithmetic stays on the host; ``uniform`` runs on the requested device.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from repro_torch.device import DeviceLike, resolve_device

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Word = Union[int, torch.Tensor]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0: Word, k1: Word, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds on uint32 words held in int64.

    ``k0``/``k1`` are python ints or tensors broadcastable against the
    counter words ``x0``/``x1``.
    """
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _words(key: torch.Tensor) -> Tuple[int, int]:
    if key.shape != (2,):
        raise ValueError(f"expected one key of shape (2,), got {tuple(key.shape)}")
    return int(key[0]), int(key[1])


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with x64 off: the words ``(0, seed)``
    (a negative seed wraps to its 32-bit two's complement)."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 32):
        raise OverflowError(f"seed {seed} does not fit in 32 bits")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: hash the counter pair ``(0, data)``."""
    k0, k1 = _words(key)
    b0, b1 = threefry2x32(k0, k1, torch.zeros(1, dtype=torch.int64),
                          torch.tensor([int(data) & _MASK], dtype=torch.int64))
    return torch.cat([b0, b1])


def _counters(n: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & _MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (num, 2) keys, key ``i`` hashing counter ``i``."""
    k0, k1 = _words(key)
    b0, b1 = threefry2x32(k0, k1, *_counters(num, torch.device("cpu")))
    return torch.stack([b0, b1], dim=1)


def uniform(key: torch.Tensor, shape: Union[int, Sequence[int]],
            device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` on ``device`` (CUDA
    unless ``"cpu"``).

    ``key`` is one key (2,) or a stack of keys (B, 2); a stack draws
    ``(B, *shape)``, row ``b`` equal to ``uniform(key[b], shape)`` (what
    ``jax.vmap`` over split keys gives).
    """
    shape = (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    device = resolve_device(device)
    hi, lo = _counters(n, device)
    if key.dim() == 1:
        k0, k1 = _words(key)
        out_shape = shape
    else:
        if key.shape[-1] != 2:
            raise ValueError(f"expected keys of shape (B, 2), got {tuple(key.shape)}")
        k = key.to(device)
        k0, k1 = k[:, 0:1], k[:, 1:2]
        out_shape = (key.shape[0],) + shape
    b0, b1 = threefry2x32(k0, k1, hi, lo)
    bits = (b0 ^ b1) >> 9 | 0x3F800000  # < 2**31: fits int32 as is
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return floats.reshape(out_shape)
