"""Parameter initializers (port of ``repro.nn.init``).

Every initializer takes (key, shape, dtype) and returns a tensor on the
key's device. A key is a threefry key of :mod:`repro_torch.prng`, and the
draws are ``jax.random``'s: ``uniform_init`` draws ``prng.uniform`` (bit
for bit), ``normal_init`` ``prng.normal`` and ``scaled_init``
``prng.truncated_normal`` (both equal to JAX's CPU draws). So a model
initialised from a key is the JAX package's model from the same key.
"""
from __future__ import annotations

import math

import torch

from repro_torch import prng

_F32 = torch.float32
#: std of a standard normal truncated at ±2σ, as the JAX package divides by
_TRUNC_STD = 0.87962566


def normal_init(key, shape, dtype=_F32, stddev: float = 0.02):
    return (prng.normal(key, tuple(shape)) * stddev).to(dtype)


def scaled_init(key, shape, dtype=_F32, scale: float = 1.0):
    """Truncated normal (±2σ, renormalised) with 1/sqrt(fan_in) scaling.

    fan_in is the second-to-last axis for matrices (d_in, d_out); for
    stacked-layer params (L, d_in, d_out) the leading axes are ignored.
    """
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    stddev = scale / math.sqrt(max(fan_in, 1))
    x = prng.truncated_normal(key, -2.0, 2.0, tuple(shape))
    return (x * stddev / _TRUNC_STD).to(dtype)


def uniform_init(key, shape, lo: float, hi: float):
    """float32 uniform on [lo, hi): ``jax.random.uniform``, bit for bit."""
    return prng.uniform(key, tuple(shape), lo, hi)


def zeros_init(key, shape, dtype=_F32):
    return torch.zeros(tuple(shape), dtype=dtype, device=key.device)


def ones_init(key, shape, dtype=_F32):
    return torch.ones(tuple(shape), dtype=dtype, device=key.device)
