"""threefry2x32 counter-based PRNG, bit for bit with ``jax.random``.

Reproduces JAX's default generator under ``jax_threefry_partitionable=True``
(the default from jax 0.5 on): keys are pairs of uint32 words, ``split``
and ``random_bits`` hash the 64-bit iota of the output shape as (hi, lo)
counter words, and ``fold_in`` hashes the pair (0, data). torch has no
uint32 arithmetic, so every word lives in an int64 tensor masked to 32
bits; sums and products are reduced mod 2^32 after each operation.

A key is an int64 tensor of shape (..., 2). Every function here accepts
leading key-batch dims, which is how the trainer derives one key per
client (``fold_in`` of a key by a vector of satellite ids) without a loop.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher (20 rounds) over broadcast words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words (seed >> 32, seed & M32)."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _M32, seed & _M32], dtype=torch.int64,
                        device=resolve_device(device))


def key_u32(seed_u32) -> torch.Tensor:
    """``jax.random.key(seed_u32)`` for a uint32 seed or a tensor of them:
    the words (0, seed), the same as ``PRNGKey(seed)``. A tensor seed of
    shape (...) gives keys (..., 2) on the seed's device."""
    s = torch.as_tensor(seed_u32, dtype=torch.int64) & _M32
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def _iota(key: torch.Tensor, shape: tuple) -> tuple:
    """(hi, lo) words of the row-major 64-bit iota over ``shape``, shaped
    to broadcast after the key's batch dims."""
    n = 1
    for s in shape:
        n *= s
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    hi = lo >> 32
    return hi.reshape(shape), (lo & _M32).reshape(shape)


def _hash_shape(key: torch.Tensor, shape: tuple):
    lead = key.shape[:-1]
    pad = (1,) * len(shape)
    k1 = key[..., 0].reshape(lead + pad)
    k2 = key[..., 1].reshape(lead + pad)
    hi, lo = _iota(key, shape)
    return threefry2x32(k1, k2, hi, lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: key (..., 2) -> keys (..., num, 2)."""
    b1, b2 = _hash_shape(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: key (..., 2), data int or int tensor
    broadcasting against the key's batch dims -> key."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    lead = torch.broadcast_shapes(key.shape[:-1], d.shape)
    k = key.expand(lead + (2,))
    y1, y2 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def bits(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``jax.random.bits`` (uint32 words): key (..., 2) -> (..., *shape)."""
    b1, b2 = _hash_shape(key, tuple(shape))
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: tuple, minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under
    the exponent of 1.0, minus 1, scaled into [minval, maxval)."""
    b = bits(key, shape)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    # XLA contracts f·span + lo into one fused multiply-add; the float64
    # product of two float32s is exact, so rounding the float64 sum once
    # to float32 reproduces it
    fma = (f.double() * (hi - lo).double() + lo.double()).to(torch.float32)
    return torch.maximum(lo, fma)


def bernoulli(key: torch.Tensor, p: float, shape: tuple) -> torch.Tensor:
    """``jax.random.bernoulli`` (float32 ``p``): ``uniform < p``, as bool."""
    return uniform(key, shape) < torch.tensor(p, dtype=torch.float32,
                                              device=key.device)


def _mulmod32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b mod 2^32 for words < 2^32 without overflowing int64."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & _M32


def randint(key: torch.Tensor, shape: tuple, minval, maxval) -> torch.Tensor:
    """``jax.random.randint`` with int32 output semantics.

    ``minval``/``maxval`` are ints or int tensors broadcasting against
    (..., *shape) — a per-row ``maxval`` is how each client samples from
    its own unpadded length. Draws two 32-bit words per value and reduces
    them mod the span exactly as JAX does (same bias, same values).
    """
    dev = key.device
    lo = torch.as_tensor(minval, dtype=torch.int64, device=dev)
    hi = torch.as_tensor(maxval, dtype=torch.int64, device=dev)
    k = split(key, 2)
    higher = bits(k[..., 0, :], shape)
    lower = bits(k[..., 1, :], shape)
    span = torch.where(hi <= lo, torch.ones_like(hi), (hi - lo) & _M32)
    mult = (65536 % span)
    mult = _mulmod32(mult, mult) % span
    off = (_mulmod32(higher % span, mult) + lower % span) & _M32
    return lo + off % span
