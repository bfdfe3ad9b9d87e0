"""Counter-based threefry2x32 random numbers, bit-identical to ``jax.random``.

The reference's load generator draws with ``jax.random`` under its
defaults: the ``threefry2x32`` implementation with
``jax_threefry_partitionable`` on.  This module computes the same bits in
torch, on whatever device the key lives:

* a key is an int64 tensor ``[..., 2]`` holding two uint32 words;
  ``PRNGKey(seed)`` is ``[0, seed mod 2**32]`` for a seed in the int32
  range, as jax builds it from an int32 seed;
* ``fold_in(key, d)`` hashes the counter pair ``(0, d mod 2**32)`` under
  the key, and ``split(key, n)[i]`` hashes ``(0, i)`` (the partitionable
  split's iota counters), so ``split(key, n)[i] == fold_in(key, i)``;
* 32 random bits at flat position ``i`` of a draw are ``y1 ^ y2`` of the
  hash of ``(i >> 32, i mod 2**32)``;
* ``uniform`` puts the top 23 bits in the mantissa of a float in [1, 2)
  and subtracts 1; ``randint`` takes two such draws from ``split(key)``
  and combines them modulo the span with jax's multiplier.

uint32 arithmetic runs in int64 lanes masked to 32 bits, so every shift
is logical and no add overflows.  Every function broadcasts over the
key's leading dimensions, and none copies from the host once the key is
on its device (no host sync in a loop of draws).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.types import I32, resolve_device

MASK = 0xFFFFFFFF
I64 = torch.int64
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & MASK) | (x >> (32 - d))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block (20 rounds) of key words ``k1, k2`` over
    counter words ``x1, x2``: int64 tensors of uint32 values that
    broadcast together.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = x1 ^ _rotl(x2, r)
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def PRNGKey(seed, device="cuda") -> torch.Tensor:
    """The key of an int32 ``seed`` (a Python int or a tensor, which
    keeps its device): ``[0, seed mod 2**32]``."""
    if isinstance(seed, torch.Tensor):
        s = seed.to(I64)
    else:
        if not -(1 << 31) <= int(seed) < (1 << 31):
            raise ValueError(f"seed {seed} is outside the int32 range")
        s = torch.tensor(int(seed), dtype=I64, device=resolve_device(device))
    return torch.stack([torch.zeros_like(s), s & MASK], dim=-1)


def _hash(key: torch.Tensor, hi, lo) -> torch.Tensor:
    """The key ``[..., 2]`` hashed over counters ``(hi, lo)`` (which
    broadcast against the key's leading dimensions): ``[..., 2]``."""
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], hi, lo)
    return torch.stack([y1, y2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: a new key from ``key`` and 32-bit
    ``data`` (an int or a tensor broadcasting against the key's leading
    dimensions, taken modulo 2**32)."""
    if isinstance(data, torch.Tensor):
        d = data.to(I64) & MASK
    else:
        d = torch.full((), int(data) & MASK, dtype=I64, device=key.device)
    return _hash(key, torch.zeros_like(d), d)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``[..., num, 2]`` keys."""
    lo = torch.arange(num, dtype=I64, device=key.device)
    return _hash(key[..., None, :], torch.zeros_like(lo), lo)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits (int64 values in [0, 2**32)) of shape
    ``key.shape[:-1] + shape``."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    i = torch.arange(math.prod(shape), dtype=I64, device=key.device)
    lead = key.shape[:-1]
    k = key.reshape(lead + (1,) * len(shape) + (2,))
    y1, y2 = threefry2x32(k[..., 0], k[..., 1], (i >> 32).reshape(shape),
                          (i & MASK).reshape(shape))
    return y1 ^ y2


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1) from 32 random bits, as jax's ``uniform``: the
    top 23 bits fill the mantissa of a float in [1, 2), then 1 is
    subtracted (exact)."""
    one = 0x3F800000
    return ((bits >> 9) | one).to(I32).view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.uniform`` in float32 over [0, 1) (the default range;
    other ranges are not ported: XLA may fuse their scaling into an FMA)."""
    return bits_to_uniform(random_bits(key, shape))


def normal(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.normal`` in float32: the same uniform on
    ``(nextafter(-1, 0), 1)`` mapped through ``sqrt(2) erfinv``.  The two
    ``erfinv`` differ (XLA's float32 one strays in the tails), so the
    results agree to 1e-6 below |x| = 2.5 and to some 5e-6 of the value
    beyond, not bit for bit."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = bits_to_uniform(random_bits(key, shape)) * (1.0 - lo) + lo
    return math.sqrt(2.0) * torch.erfinv(u.clamp_min(lo))


def bits_to_randint(higher: torch.Tensor, lower: torch.Tensor, minval: int,
                    maxval: int) -> torch.Tensor:
    """int32 in [minval, maxval) from two 32-bit draws, as jax's
    ``randint``: ``(higher mod span) * (2**32 mod span) + lower mod
    span``, all in uint32, modulo the span."""
    for b in (minval, maxval):
        if not -(1 << 31) <= b < (1 << 31):
            raise ValueError(f"randint bound {b} is outside the int32 range")
    span = (maxval - minval) & MASK if maxval > minval else 1
    mult = (1 << 16) % span
    mult = ((mult * mult) & MASK) % span
    off = ((((higher % span) * mult) & MASK) + lower % span) & MASK
    out = (minval + off % span) & MASK
    return torch.where(out >= (1 << 31), out - (1 << 32), out).to(I32)


def randint(key: torch.Tensor, shape, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint`` to int32."""
    k = split(key)
    return bits_to_randint(random_bits(k[..., 0, :], shape),
                           random_bits(k[..., 1, :], shape), minval, maxval)
