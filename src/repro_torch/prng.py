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
mantissa (``bits >> 9 | 0x3F800000``, minus 1.0).  ``randint`` splits the
key in two, draws 32 bits from each the same way, and folds the pair into
the span by JAX's double-width modulus.

Key arithmetic stays on the host; ``uniform`` and ``randint`` run on the
requested device.
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


def _bits32(key: torch.Tensor, shape: Tuple[int, ...], device: torch.device
            ) -> torch.Tensor:
    """32 random bits per element (``b0 ^ b1`` of the hashed counters)."""
    n = 1
    for s in shape:
        n *= s
    k0, k1 = _words(key)
    b0, b1 = threefry2x32(k0, k1, *_counters(n, device))
    return (b0 ^ b1).reshape(shape)


def _shape(shape: Union[int, Sequence[int]]) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)


def uniform(key: torch.Tensor, shape: Union[int, Sequence[int]],
            device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` on ``device`` (CUDA
    unless ``"cpu"``).

    ``key`` is one key (2,) or a stack of keys (B, 2); a stack draws
    ``(B, *shape)``, row ``b`` equal to ``uniform(key[b], shape)`` (what
    ``jax.vmap`` over split keys gives).
    """
    shape = _shape(shape)
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


_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def randint(key: torch.Tensor, shape: Union[int, Sequence[int]], minval: int, maxval: int,
            device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32) on
    ``device`` (CUDA unless ``"cpu"``).

    Bounds are clamped to int32; ``maxval <= minval`` returns ``minval``.
    The span's modulus of the 64 random bits of two draws is taken as
    ``((hi % span) * m + lo % span) % span`` with ``m = (2**16 % span)**2
    % span``, every step in uint32 arithmetic (wrapping: for a span above
    2**16, ``m`` is 0), exactly as JAX computes it.
    """
    shape = _shape(shape)
    device = resolve_device(device)
    maxval_out_of_range = int(maxval) > _I32_MAX
    lo_v = min(max(int(minval), _I32_MIN), _I32_MAX)
    hi_v = min(max(int(maxval), _I32_MIN), _I32_MAX)
    k1, k2 = split(key)
    higher, lower = _bits32(k1, shape, device), _bits32(k2, shape, device)
    span = (hi_v - lo_v) & _MASK
    if hi_v <= lo_v:
        span = 1
    elif maxval_out_of_range:
        span = (span + 1) & _MASK
    if span == 0:  # the full 2**32 range: XLA's remainder by 0 keeps the dividend
        offset = lower
    else:
        multiplier = (1 << 16) % span
        multiplier = ((multiplier * multiplier) & _MASK) % span  # wraps, as uint32 does
        offset = (((higher % span) * multiplier) & _MASK) + lower % span
        offset = (offset & _MASK) % span
    out = (lo_v + offset) & _MASK
    out = torch.where(out >= (1 << 31), out - (1 << 32), out)
    return out.to(torch.int32)
