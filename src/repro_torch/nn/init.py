"""Parameter initializers (port of ``repro.nn.init``).

Every initializer takes (key, shape, dtype) and returns a tensor on the
key's device. A key is a threefry key of :mod:`repro_torch.prng`, and the
draws are ``jax.random``'s: ``uniform_init`` draws ``prng.uniform`` (bit
for bit), ``normal_init`` ``prng.normal`` and ``scaled_init``
``prng.truncated_normal`` (both equal to JAX's CPU draws). So a model
initialised from a key is the JAX package's model from the same key.

``normal_init`` and ``scaled_init`` fill a leaf of the target dtype
``SLAB`` elements at a time (each element's draw depends on its counter
alone, so the slabs are the one-shot draw bit for bit): the threefry
draws run in int64 and float64 temporaries of tens of bytes an element,
which a whole leaf of billions of elements (the MoE archs' stacked
experts) would not fit. On the ``meta`` device they return the empty
leaf.
"""
from __future__ import annotations

import math

import torch

from repro_torch import prng

_F32 = torch.float32
#: std of a standard normal truncated at ±2σ, as the JAX package divides by
_TRUNC_STD = 0.87962566
#: elements drawn at a time: ~2^26 bounds the draws' temporaries to a few GB
SLAB = 1 << 26


def _fill(key, shape, dtype, draw):
    """The leaf (key batch dims + ``shape``) in ``dtype``, its flat
    elements [z, z + n) set to ``draw(z, n)`` slab by slab."""
    out = torch.empty(key.shape[:-1] + tuple(shape), dtype=dtype,
                      device=key.device)
    if key.device.type == "meta":
        return out
    flat = out.view(key.shape[:-1] + (-1,))
    n = flat.shape[-1]
    for z in range(0, n, SLAB):
        flat[..., z:z + SLAB] = draw(z, min(SLAB, n - z))
    return out


def normal_init(key, shape, dtype=_F32, stddev: float = 0.02):
    return _fill(key, shape, dtype, lambda z, n: (
        prng.normal(key, (n,), start=z) * stddev).to(dtype))


def scaled_init(key, shape, dtype=_F32, scale: float = 1.0):
    """Truncated normal (±2σ, renormalised) with 1/sqrt(fan_in) scaling.

    fan_in is the second-to-last axis for matrices (d_in, d_out); for
    stacked-layer params (L, d_in, d_out) the leading axes are ignored.
    """
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    stddev = scale / math.sqrt(max(fan_in, 1))
    return _fill(key, shape, dtype, lambda z, n: (
        prng.truncated_normal(key, -2.0, 2.0, (n,), start=z) * stddev
        / _TRUNC_STD).to(dtype))


def uniform_init(key, shape, lo: float, hi: float):
    """float32 uniform on [lo, hi): ``jax.random.uniform``, bit for bit."""
    return prng.uniform(key, tuple(shape), lo, hi)


def zeros_init(key, shape, dtype=_F32):
    return torch.zeros(tuple(shape), dtype=dtype, device=key.device)


def ones_init(key, shape, dtype=_F32):
    return torch.ones(tuple(shape), dtype=dtype, device=key.device)
