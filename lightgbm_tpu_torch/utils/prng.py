"""``jax.random``'s threefry2x32 streams on torch tensors, bit for bit.

The JAX package draws its bagging masks, GOSS samples and stochastic
int8 roundings from ``jax.random`` (default implementation
``threefry2x32``, with ``jax_threefry_partitionable`` on, the default
of jax 0.5 and later).  The port draws the same bits:

* a key is a (2,) int64 tensor on the host holding two uint32 words
  (keys are tiny; a draw runs on the device it is asked for, so no
  key is ever read back from the card);
* ``PRNGKey(seed)`` is ``[seed >> 32, seed & 0xFFFFFFFF]``;
* ``split(key, n)`` hashes the 64-bit counters 0..n-1 (high word,
  low word) and stacks the two output words into n keys;
* ``fold_in(key, data)`` hashes the counter pair ``(0, data)``;
* ``uniform(key, shape)`` hashes the flat index of each element as a
  64-bit counter, xors the two output words, and keeps the top 23
  bits as the mantissa of a float in [1, 2), minus 1.

Arithmetic is on int64 tensors masked to 32 bits (torch's uint32 lacks
most operations on CUDA), so the CPU and the card give the same bits.
Plain torch ops: the JAX package runs these as plain XLA, not in a
Pallas kernel.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the counter words
    ``(x0, x1)`` under ``key``: two int64 tensors of uint32 values, of
    the counters' shape (jax's ``threefry2x32_p``)."""
    k0, k1 = (int(v) & _MASK for v in key.tolist())
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a non-negative seed."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK],
                        dtype=torch.int64)


def _counters(n: int, device) -> tuple:
    """The 64-bit flat indices 0..n-1 as (high, low) uint32 words."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & _MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (num, 2) keys."""
    hi, lo = _counters(num, "cpu")
    b0, b1 = threefry2x32(key, hi, lo)
    return torch.stack([b0, b1], dim=1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data``."""
    x = torch.tensor([0, int(data) & _MASK], dtype=torch.int64)
    b0, b1 = threefry2x32(key, x[:1], x[1:])
    return torch.cat([b0, b1])


def random_bits(key: torch.Tensor, shape: Sequence[int],
                device: Union[str, torch.device, None] = None
                ) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32-bit) as int64 values, drawn
    on ``device`` (the host by default)."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    hi, lo = _counters(n, device or "cpu")
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(shape)


def uniform(key: torch.Tensor, shape: Sequence[int],
            device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: f32 in [0, 1), drawn on
    ``device`` (the host by default)."""
    bits = (random_bits(key, shape, device) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


__all__ = ["PRNGKey", "split", "fold_in", "random_bits", "uniform",
           "threefry2x32"]
