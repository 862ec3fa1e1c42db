"""The port's teleport primitive and the statevector pieces under it vs the
JAX package (ROADMAP item 9).

Over a grid of (θ, φ, seed), as ``tests/test_quantum.py`` does: the
measurement outcomes m0 and m1 bit-equal, the received state, fidelity
and decoded θ′, φ′ ≤ 1e-6; ``teleport_params`` (one key split per pair,
the JAX ``vmap``) the same. The gates, CNOT and ``measure_qubit`` (whose
draw is ``prng.uniform``) are held to the JAX functions directly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.quantum import statevector as jsv
from repro.quantum import teleport as jtp
from repro_torch import prng
from repro_torch.core.round import _jnp_mod
from repro_torch.quantum import statevector as tsv
from repro_torch.quantum import teleport as ttp

THETAS = (0.05, 0.7, 1.6, 3.0)
PHIS = (-3.1, -0.5, 1.2, 3.1)


def _state(rng, shape):
    s = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    return (s / np.linalg.norm(s, axis=-1, keepdims=True)).astype(np.complex64)


@pytest.mark.parametrize("seed", [0, 1, 5, 17, 123456])
def test_teleport_state_matches_jax(seed):
    for theta in THETAS:
        for phi in PHIS:
            rj, fj, m0j, m1j = jtp.teleport_state(jax.random.PRNGKey(seed),
                                                  theta, phi)
            rt, ft, m0t, m1t = ttp.teleport_state(prng.PRNGKey(seed, "cpu"),
                                                  theta, phi)
            assert (int(m0t), int(m1t)) == (int(m0j), int(m1j)), (theta, phi)
            np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-6)
            assert abs(float(ft) - float(fj)) <= 1e-6
            tj, pj = jtp.decode_state(rj)
            tt, pt = ttp.decode_state(rt)
            assert abs(float(tt) - float(tj)) <= 1e-6, (theta, phi)
            assert abs(float(pt) - float(pj)) <= 1e-6, (theta, phi)


def test_teleport_params_matches_jax():
    key = jax.random.PRNGKey(3)
    t = jax.random.uniform(key, (64,), minval=0.1, maxval=3.0)
    p = jax.random.uniform(jax.random.fold_in(key, 1), (64,), minval=-3.0,
                           maxval=3.0)
    tj, pj, fj = jtp.teleport_params(key, t, p)
    tt, pt, ft = ttp.teleport_params(prng.PRNGKey(3, "cpu"),
                                     torch.tensor(np.asarray(t)),
                                     torch.tensor(np.asarray(p)))
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-6)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6)
    assert abs(float(ft) - float(fj)) <= 1e-6 and float(ft) > 1 - 1e-5


def test_gates_and_cnot_match_jax():
    rng = np.random.default_rng(0)
    st = _state(rng, (4, 8))
    t, p, l = rng.uniform(-3, 3, (3, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        tsv.u3_gate(torch.tensor(t), torch.tensor(p), torch.tensor(l)).numpy(),
        np.asarray(jsv.u3_gate(t, p, l)))
    for name in ("H", "X", "Z"):
        np.testing.assert_array_equal(getattr(tsv, name).numpy(),
                                      np.asarray(getattr(jsv, name)))
    ts = torch.tensor(st)
    for q in range(3):
        np.testing.assert_allclose(tsv.apply_h(ts, q).numpy(),
                                   np.asarray(jsv.apply_h(st, q)), atol=1e-7)
        np.testing.assert_allclose(
            tsv.apply_u3(ts, float(t[q]), float(p[q]), 0.0, q).numpy(),
            np.asarray(jsv.apply_u3(st, t[q], p[q], 0.0, q)), atol=1e-7)
        for c in range(3):
            if c != q:
                np.testing.assert_array_equal(
                    tsv.apply_cnot(ts, c, q).numpy(),
                    np.asarray(jsv.apply_cnot(st, c, q)))


@pytest.mark.parametrize("qubit", [0, 2])
def test_measure_qubit_matches_jax(qubit):
    """One key over a batch (the JAX function unbatched) and one key per
    state (the JAX function under vmap): equal outcomes, states ≤ 1e-6."""
    rng = np.random.default_rng(qubit)
    st = _state(rng, (16, 8))
    key = jax.random.PRNGKey(11)
    oj, cj = jsv.measure_qubit(key, jnp.asarray(st), qubit)
    ot, ct = tsv.measure_qubit(prng.PRNGKey(11, "cpu"), torch.tensor(st),
                               qubit)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-6)
    keys = jax.random.split(key, 16)
    oj, cj = jax.vmap(lambda k, s: jsv.measure_qubit(k, s, qubit))(
        keys, jnp.asarray(st))
    ot, ct = tsv.measure_qubit(prng.split(prng.PRNGKey(11, "cpu"), 16),
                               torch.tensor(st), qubit)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-6)
    assert 0 < int(ot.sum()) < 16


def test_trainer_angle_mod_matches_jnp_remainder():
    """The trainer's angle wrap is ``jnp.remainder`` bit for bit (the
    teleported angles of a payload depend on it)."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=4096) * 10).astype(np.float32)
    x[:4] = [0.0, -0.0, np.pi, -2 * np.pi]
    for m in (np.pi, 2 * np.pi):
        want = np.asarray(jnp.asarray(x) % m)
        got = _jnp_mod(torch.tensor(x), m).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
