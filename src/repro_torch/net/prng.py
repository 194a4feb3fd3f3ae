"""Threefry-2x32 random numbers, bit for bit those of ``jax.random``.

The JAX package draws link loss, duplication, jitter and reordering from
``jax.random`` (``PRNGKey``, ``split``, ``uniform``, ``randint``) with
JAX's defaults: the threefry2x32 generator and
``jax_threefry_partitionable`` on, under which the counter of element
``i`` of a draw is the 64-bit ``i`` split into its high and low words and
32-bit draws are ``bits1 ^ bits2``.  This module computes the same
functions from integer tensor ops only, on the device of the key, so a
lossy fabric run can match the JAX package's frame for frame.

A key is an ``int64`` tensor of shape ``(..., 2)`` holding two u32 words
(``torch.uint32`` has no shift, add or compare on the CPU); leading
dimensions are a batch of keys, and each draw gets the batch as its
leading dimensions, as ``jax.vmap`` over the key would give.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from repro_torch import resolve_device

U32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & U32


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash, 20 rounds, of the counter pairs
    ``(x1, x2)`` under the key ``(k1, k2)``; u32 words in broadcastable
    ``int64`` tensors."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & U32
    x2 = (x2 + ks[1]) & U32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & U32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & U32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & U32
    return x1, x2


def PRNGKey(seed: int, device="cuda") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off: the seed is
    taken as 32 bits, so the words are ``(0, seed & 0xFFFFFFFF)``."""
    return torch.tensor([0, int(seed) & U32], dtype=torch.int64,
                        device=resolve_device(device))


def _counts(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (high, low) words of the 64-bit counters 0..n-1."""
    iota = torch.arange(n, dtype=torch.int64, device=device)
    return iota >> 32, iota & U32


def _hash(key: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both threefry words of counters 0..n-1, shaped (*batch, n)."""
    hi, lo = _counts(n, key.device)
    return threefry2x32(key[..., 0:1], key[..., 1:2], hi, lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (*batch, num, 2)."""
    b1, b2 = _hash(key, num)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element of ``shape``: (*batch, *shape), u32 in
    ``int64``."""
    shape = tuple(shape)
    b1, b2 = _hash(key, math.prod(shape))
    return (b1 ^ b2).reshape(*key.shape[:-1], *shape)


def uniform(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1), from the top
    23 bits as a mantissa under the exponent of 1.0, minus 1.0."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` with the default
    int32 dtype: two further keys draw higher and lower bits, reduced mod
    the span with the ``2**32 mod span`` multiplier, in u32 arithmetic."""
    for v in (minval, maxval):
        if not _I32_MIN <= v <= _I32_MAX:
            raise ValueError(f"randint: bound {v} outside the int32 range")
    keys = split(key, 2)
    higher = random_bits(keys[..., 0, :], shape)
    lower = random_bits(keys[..., 1, :], shape)
    span = (maxval - minval) & U32 if maxval > minval else 1
    multiplier = (1 << 16) % span
    multiplier = ((multiplier * multiplier) & U32) % span
    offset = (((higher % span) * multiplier) & U32) + lower % span
    offset = (offset & U32) % span
    return (offset + minval).to(torch.int32)
