"""The port's initializers against ``repro.nn.init`` for the same key.

``normal_init``, ``scaled_init`` (the truncated normal) and
``uniform_init`` (``jax.random.uniform``, as the SSM's ``a0``/``dt0``
draw it) within 2 ulp of JAX's at several shapes and keys, with the
truncated normal's two float32 erf bounds equal to JAX's; and a
hymba-1.5b smoke model initialised from ``PRNGKey(0)`` in each package,
with no weights carried across, giving the same logits (rel ≤ 1e-5).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import decoder as jD
from repro.models import get_config as jax_get_config
from repro.models import smoke_variant as jax_smoke_variant
from repro.nn import init as jinit
from repro_torch import prng
from repro_torch.models import decoder as tD
from repro_torch.models import get_config, smoke_variant
from repro_torch.nn import init as tinit
from repro_torch.nn.pytree import tree_leaves

ULP = 2
KEYS_SHAPES = [(0, (1000, 300)), (7, (3, 64, 96)), (2 ** 31 - 1, (513,)),
               (42, (5, 7, 9))]


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a − b| in float32 units in the last place (sign-magnitude order)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64).ravel()
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64).ravel()
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def test_truncated_normal_bounds_are_jax_erf():
    s2 = np.float32(math.sqrt(2))
    for x in (-2.0, 2.0):
        want = np.float32(jax.scipy.special.erf(jnp.float32(x) / s2))
        assert np.float32(math.copysign(prng._ERF_2_OVER_SQRT2, x)) == want
    with pytest.raises(ValueError, match="±2"):
        prng.truncated_normal(prng.PRNGKey(0, "cpu"), -3.0, 3.0, (4,))


@pytest.mark.parametrize("seed,shape", KEYS_SHAPES)
def test_initializers_within_2_ulp(seed, shape):
    kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed, "cpu")
    cases = [
        (jinit.normal_init(kj, shape), tinit.normal_init(kt, shape)),
        (jinit.normal_init(kj, shape, stddev=0.5),
         tinit.normal_init(kt, shape, stddev=0.5)),
        (jinit.scaled_init(kj, shape), tinit.scaled_init(kt, shape)),
        (jinit.scaled_init(kj, shape, scale=3.0),
         tinit.scaled_init(kt, shape, scale=3.0)),
        (jax.random.truncated_normal(kj, -2.0, 2.0, shape, jnp.float32),
         prng.truncated_normal(kt, -2.0, 2.0, shape)),
        (jax.random.uniform(kj, shape, jnp.float32, 1.0, 16.0),
         tinit.uniform_init(kt, shape, 1.0, 16.0)),
        (jax.random.uniform(kj, shape, jnp.float32, 1e-3, 0.1),
         tinit.uniform_init(kt, shape, 1e-3, 0.1)),
    ]
    for want, got in cases:
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        assert _ulps(got.numpy(), np.asarray(want)).max() <= ULP
    # the truncated normal stays inside its open bounds
    x = prng.truncated_normal(kt, -2.0, 2.0, shape)
    assert bool(((x > -2.0) & (x < 2.0)).all())


def test_bf16_init_matches_jax():
    kj, kt = jax.random.PRNGKey(3), prng.PRNGKey(3, "cpu")
    want = np.asarray(jinit.scaled_init(kj, (64, 48), jnp.bfloat16)
                      .astype(jnp.float32))
    got = tinit.scaled_init(kt, (64, 48), torch.bfloat16).float().numpy()
    # one bf16 step at most where the float32 values straddle a rounding
    assert np.abs(got - want).max() <= 2.0 ** -8 * np.abs(want).max()


def test_hymba_from_a_key_matches_jax_without_convert():
    cfg_j = jax_smoke_variant(jax_get_config("hymba-1.5b"))
    cfg_t = smoke_variant(get_config("hymba-1.5b"))
    params_j = jD.init(cfg_j, jax.random.PRNGKey(0))
    params_t = tD.init(cfg_t, prng.PRNGKey(0, "cpu"))
    for a, b in zip(tree_leaves(params_t),
                    jax.tree_util.tree_leaves(params_j)):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        # draws within 2 ulp; dt_bias = dt0 + log(-expm1(-dt0)) adds the
        # two libraries' log and expm1
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-7)
    tokens = np.random.default_rng(5).integers(0, cfg_j.vocab_size, (2, 40),
                                               dtype=np.int32)
    want, _ = jD.forward(cfg_j, params_j, {"tokens": jnp.asarray(tokens)})
    got, _ = tD.forward(cfg_t, params_t, {"tokens": torch.tensor(tokens)})
    real = slice(0, cfg_j.vocab_size)
    want = np.asarray(want)[..., real]
    assert (np.abs(got[..., real].detach().numpy() - want).max()
            / np.abs(want).max()) <= 1e-5
