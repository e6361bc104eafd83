"""Counter-based random numbers: the threefry2x32 keys and draws of
``jax.random`` that the whole-sweep rook uses, on torch tensors.

The engine's rook fills each bond's start set from random priorities
(``tci_tpu/models/device_sweep.py``: ``jax.random.PRNGKey(seed)`` from a
uint32 seed, ``fold_in(key, b)`` for bond b, ``jax.random.uniform(key,
(n,))`` in float64). This module computes the same three functions as jax
0.9.0 does with its default implementation (``threefry2x32``) and
``jax_threefry_partitionable`` on, so that the port draws the same pivot
start sets as ``tci_tpu``.

Every value is an int64 tensor holding a 32-bit word (masked to 32 bits
after each addition and shift), so the functions are plain tensor
arithmetic: they run on any device, read nothing back, and can be recorded
into a CUDA graph. A key is a (2,) int64 tensor [hi, lo].
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """Threefry-2x32 with 20 rounds (jax's ``threefry2x32_p``): the key
    words k0, k1 and the counter words x0, x1 (broadcast), each an int64
    tensor of 32-bit values. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def prng_key(seed: torch.Tensor) -> torch.Tensor:
    """``jax.random.PRNGKey(jnp.uint32(seed))``: [0, seed] for a seed below
    2^32 (an int64 tensor of any device)."""
    seed = torch.as_tensor(seed, dtype=torch.int64)
    return torch.stack([torch.zeros_like(seed), seed & _MASK])


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a 32-bit unsigned `data`:
    threefry of the counter [0, data] under `key`."""
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], zero, zero + (int(data) & _MASK))
    return torch.stack([y0, y1])


def uniform_f64(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), dtype=float64)`` on [0, 1): 64 random
    bits for counter i are (y0 << 32) | y1 of threefry([0, i]); the top 52
    become the mantissa of a float in [1, 2), from which 1 is taken."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(i), i)
    # the 52 mantissa bits: bits 63..12 of (y0 << 32 | y1), kept in int64
    # without overflow as (y0 << 20) | (y1 >> 12)
    mant = (y0 << 20) | (y1 >> 12)
    one = 0x3FF0000000000000
    return (mant | one).view(torch.float64) - 1.0
