"""Parameter initializers (port of ``repro.nn.init``).

Every initializer takes (key, shape, dtype) and returns a tensor on the
key's device. A key is a threefry key of :mod:`repro_torch.prng`; the draws
come from a ``torch.Generator`` seeded from its two words, so a model's
init is a function of its key, as in the JAX package. The draws differ
from ``jax.random``'s. ``prng.normal`` comes within 2 ulp of
``jax.random.normal``, but ``truncated_normal`` has no torch twin, so
tests carry JAX's weights across with :mod:`repro_torch.convert` instead.
"""
from __future__ import annotations

import math

import torch

_F32 = torch.float32
#: std of a standard normal truncated at ±2σ, as the JAX package divides by
_TRUNC_STD = 0.87962566


def generator(key: torch.Tensor) -> torch.Generator:
    """A generator on the key's device, seeded from the key's two words."""
    words = [int(w) & 0xFFFFFFFF for w in key.reshape(-1).tolist()]
    g = torch.Generator(device=key.device)
    g.manual_seed((words[0] << 32) | words[1])
    return g


def normal_init(key, shape, dtype=_F32, stddev: float = 0.02):
    x = torch.randn(tuple(shape), generator=generator(key), dtype=_F32,
                    device=key.device)
    return (x * stddev).to(dtype)


def scaled_init(key, shape, dtype=_F32, scale: float = 1.0):
    """Truncated normal (±2σ, renormalised) with 1/sqrt(fan_in) scaling.

    fan_in is the second-to-last axis for matrices (d_in, d_out); for
    stacked-layer params (L, d_in, d_out) the leading axes are ignored.
    """
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    stddev = scale / math.sqrt(max(fan_in, 1))
    x = torch.empty(tuple(shape), dtype=_F32, device=key.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0,
                                generator=generator(key))
    return (x * (stddev / _TRUNC_STD)).to(dtype)


def uniform_init(key, shape, lo: float, hi: float):
    """float32 uniform on [lo, hi)."""
    x = torch.rand(tuple(shape), generator=generator(key), dtype=_F32,
                   device=key.device)
    return lo + (hi - lo) * x


def zeros_init(key, shape, dtype=_F32):
    return torch.zeros(tuple(shape), dtype=dtype, device=key.device)


def ones_init(key, shape, dtype=_F32):
    return torch.ones(tuple(shape), dtype=dtype, device=key.device)
