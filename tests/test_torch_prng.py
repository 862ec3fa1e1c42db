"""Port PRNG (repro_torch.prng) vs jax.random: bit-exact threefry2x32.

The port reproduces the ``jax_threefry_partitionable=True`` generator;
under the other setting the bit checks are skipped.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro_torch import prng


@pytest.fixture(autouse=True)
def _partitionable():
    if not jax.config.jax_threefry_partitionable:
        pytest.skip("the port reproduces jax_threefry_partitionable=True")


def _key(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed, device="cpu")


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
def test_prngkey_split_fold_in(seed):
    jk, tk = _key(seed)
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    for num in (2, 3, 10):
        np.testing.assert_array_equal(np.asarray(jax.random.split(jk, num)),
                                      prng.split(tk, num).numpy())
    for data in (0, 1, 0x5A7, 2 ** 32 - 1):
        np.testing.assert_array_equal(np.asarray(jax.random.fold_in(jk, data)),
                                      prng.fold_in(tk, data).numpy())
    # batched fold-in (one key per satellite id) == vmapped jax fold_in
    ids = jnp.arange(13)
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda s: jax.random.fold_in(jk, s))(ids)),
        prng.fold_in(tk, torch.arange(13)).numpy())


@pytest.mark.parametrize("shape", [(1,), (5,), (3, 7), (2, 3, 4)])
def test_bits(shape):
    jk, tk = _key(11)
    np.testing.assert_array_equal(np.asarray(jax.random.bits(jk, shape)),
                                  prng.bits(tk, shape).numpy())


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (0.0, np.pi), (-2.5, 3.0)])
def test_uniform(lo, hi):
    jk, tk = _key(3)
    want = np.asarray(jax.random.uniform(jk, (4, 9), jnp.float32, lo, hi))
    got = prng.uniform(tk, (4, 9), lo, hi).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(want, got)


def test_randint_per_row_maxval():
    """One key and one bound per client — the batch sampler's draw."""
    jk, tk = _key(5)
    n = np.array([1, 5, 100, 643, 70000, 2 ** 31 - 1], np.int32)
    keys_j = jax.random.split(jk, len(n))
    want = np.asarray(jax.vmap(
        lambda k, m: jax.random.randint(k, (17,), 0, m))(keys_j, jnp.asarray(n)))
    got = prng.randint(prng.split(tk, len(n)), (17,), 0,
                       torch.as_tensor(n.astype(np.int64))[:, None]).numpy()
    np.testing.assert_array_equal(want, got)
    # scalar bounds and a nonzero minval
    np.testing.assert_array_equal(
        np.asarray(jax.random.randint(jk, (3, 4), -7, 9)),
        prng.randint(tk, (3, 4), -7, 9).numpy())
