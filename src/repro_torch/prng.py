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

Element i of a draw is a function of the key and its counter i alone, so
the draws take a flat counter offset ``start``: ``bits(key, (n,),
start=z)`` is elements [z, z + n) of the draw over any shape of more
elements, which is how ``nn.init`` fills a large leaf slab by slab.
"""
from __future__ import annotations

import math

import numpy as np
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


def _iota(key: torch.Tensor, shape: tuple, start: int = 0) -> tuple:
    """(hi, lo) words of the row-major 64-bit iota over ``shape`` from the
    counter ``start``, shaped to broadcast after the key's batch dims."""
    n = 1
    for s in shape:
        n *= s
    lo = torch.arange(start, start + n, dtype=torch.int64, device=key.device)
    hi = lo >> 32
    return hi.reshape(shape), (lo & _M32).reshape(shape)


def _hash_shape(key: torch.Tensor, shape: tuple, start: int = 0):
    lead = key.shape[:-1]
    pad = (1,) * len(shape)
    k1 = key[..., 0].reshape(lead + pad)
    k2 = key[..., 1].reshape(lead + pad)
    hi, lo = _iota(key, shape, start)
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


def bits(key: torch.Tensor, shape: tuple, *, start: int = 0) -> torch.Tensor:
    """``jax.random.bits`` (uint32 words): key (..., 2) -> (..., *shape),
    the words at counters ``start`` on."""
    b1, b2 = _hash_shape(key, tuple(shape), start)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: tuple, minval=0.0,
            maxval=1.0, *, start: int = 0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under
    the exponent of 1.0, minus 1, scaled into [minval, maxval)."""
    b = bits(key, shape, start=start)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    # XLA contracts f·span + lo into one fused multiply-add; the float64
    # product of two float32s is exact, so rounding the float64 sum once
    # to float32 reproduces it
    fma = (f.double() * (hi - lo).double() + lo.double()).to(torch.float32)
    return torch.maximum(lo, fma)


def gumbel(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``jax.random.gumbel`` in float32, its default ("low") mode:
    −log(−log(u)), u from ``uniform`` on [tiny, 1)."""
    u = uniform(key, shape, float(torch.finfo(torch.float32).tiny), 1.0)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis: the
    argmax of the logits plus ``gumbel`` noise, as int64. For float32
    logits the noise is JAX's; for bfloat16 logits JAX draws it in
    bfloat16, the port in float32."""
    return torch.argmax(logits.to(torch.float32)
                        + gumbel(key, tuple(logits.shape)), dim=-1)


# ---------------------------------------------------------------------------
# normal: XLA's float32 erf_inv over XLA's CPU log1p and log
# ---------------------------------------------------------------------------

def _fma32(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """a·b + c in float32 with one rounding, as XLA's fused multiply-add:
    the float64 product of two float32s is exact."""
    return (a.double() * b.double() + c).to(torch.float32)


def _poly32(x: torch.Tensor, coeffs: tuple) -> torch.Tensor:
    """Horner's rule in fused multiply-adds, highest degree first, the
    coefficients rounded to float32 as XLA's constants are."""
    p = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        p = _fma32(p, x, float(np.float32(c)))
    return p


# Cephes' logf, XLA's CPU float32 log: x = m − 1 for the mantissa m in
# [√½, √2), then x − x²/2 + x³·P(x) + e·ln 2 (ln 2 split in two), the
# polynomial and the final sums in fused multiply-adds
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_F32_NOT_EXPONENT = -2139095041             # 0x807FFFFF as int32


def _log32(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``log`` for positive finite x, op for op (equal
    to XLA's on 2.2·10^6 inputs over [10^-4, 100])."""
    b = torch.clamp(x, min=2.0 ** -126).view(torch.int32)
    m = ((b & _F32_NOT_EXPONENT) | 0x3F000000).view(torch.float32)
    e = ((b >> 23) - 127).to(torch.float32) + 1.0
    low = m < 0.70710677
    x = (m - 1.0) + torch.where(low, m, 0.0)
    e = e - low.to(torch.float32)
    x2 = x * x
    x3 = x2 * x
    p = [float(np.float32(c)) for c in _LOG_P]
    y = _fma32(_fma32(torch.full_like(x, p[0]), x, p[1]), x, p[2])
    y1 = _fma32(_fma32(torch.full_like(x, p[3]), x, p[4]), x, p[5])
    y2 = _fma32(_fma32(torch.full_like(x, p[6]), x, p[7]), x, p[8])
    y = _fma32(_fma32(y, x3, y1.double()), x3, y2.double())
    y = _fma32(y, x3, (e * -2.12194440e-4).double())
    r = _fma32(x2, torch.full_like(x, -0.5), x.double()) + y
    return _fma32(e, torch.full_like(x, 0.693359375), r.double())


# Cephes' log1p below √2 − 1, XLA's: x − x²/2 + x³·P(x)/Q(x)
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969e0, 2.9911919328553073277375e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``log1p``: Cephes' rational form (its
    multiply-adds fused) below |x| = √2 − 1, bit for bit; ``log(1 + x)``
    above it."""
    x2 = x * x
    r = _poly32(x, _LOG1P_P) / _poly32(x, _LOG1P_Q)
    small = x + _fma32(x2, torch.full_like(x, -0.5), (x * x2 * r).double())
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       _log32(x + 1.0))


# Giles' single-precision erf_inv, XLA's: a polynomial in w − 2.5 for
# w = −log1p(−x²) < 5 and in √w − 3 above, highest degree first
_ERFINV_LO = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_HI = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (``torch.erfinv`` is another function,
    up to 63 ulp away): Giles' polynomial with fused multiply-adds, on
    ``log1p``. Equal to XLA's CPU ``jax.lax.erf_inv`` on 2·10^6 inputs
    over (−1, 1); the tests hold it within 2 ulp."""
    w = -log1p(-x * x)
    lt = w < 5.0
    # XLA's float32 sqrt is correctly rounded and torch's CPU one is not
    # always: the float64 root rounded once to float32 is
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    # python-float coefficients select as float32 constants
    p = torch.where(lt, _ERFINV_LO[0], _ERFINV_HI[0])
    for lo, hi in zip(_ERFINV_LO[1:], _ERFINV_HI[1:]):
        p = _fma32(p, w, torch.where(lt, lo, hi).double())
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


#: nextafter(−1, 0) in float32, the low end of ``normal``'s uniform, and
#: sqrt(2) rounded to float32, as JAX multiplies by it
_NEXT_ABOVE_M1 = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2_F32 = float(np.float32(math.sqrt(2)))


def normal(key: torch.Tensor, shape: tuple, *,
           start: int = 0) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``uniform`` on [nextafter(−1, 0),
    1) through ``sqrt(2) · erfinv``. The uniform bits are JAX's, and the
    values JAX's CPU values (see ``erfinv``)."""
    return erfinv(uniform(key, shape, _NEXT_ABOVE_M1, 1.0,
                          start=start)) * _SQRT2_F32


#: erf(±2/√2) in float32, the bounds of ``truncated_normal``'s uniform at
#: ±2σ (XLA's float32 erf gives the correctly rounded value there)
_ERF_2_OVER_SQRT2 = float(np.float32(0.9544997215270996))


def truncated_normal(key: torch.Tensor, lower: float, upper: float,
                     shape: tuple, *, start: int = 0) -> torch.Tensor:
    """``jax.random.truncated_normal`` in float32 at the ±2σ bounds the
    models use, as ``jax._src.random._truncated_normal`` computes it:
    ``uniform`` on [erf(lower/√2), erf(upper/√2)), then ``√2 · erfinv``,
    clipped to ``nextafter`` of each bound toward 0. The uniform bits are
    JAX's, and the values JAX's CPU values (see ``erfinv``)."""
    if (float(lower), float(upper)) != (-2.0, 2.0):
        raise ValueError(f"truncated_normal takes the ±2 bounds of the "
                         f"models' initializers, got ({lower}, {upper})")
    u = uniform(key, shape, -_ERF_2_OVER_SQRT2, _ERF_2_OVER_SQRT2,
                start=start)
    out = erfinv(u) * _SQRT2_F32
    lo = float(np.nextafter(np.float32(lower), np.float32(np.inf)))
    hi = float(np.nextafter(np.float32(upper), np.float32(-np.inf)))
    return torch.clamp(out, lo, hi)


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
