"""Port statevector simulator and the fused gate-layer op vs the JAX package.

The plain layer (``ref.py``) is held against the JAX oracle
``apply_layer_planes_ref`` and the Pallas kernel run in interpret mode
(as the JAX package's own tests run it), ≤ 1e-6; gradients through the
port's ``autograd.Function`` against ``jax.vjp`` of
``repro.kernels.apply_gate_layer``, ≤ 1e-5. The CUDA kernel itself is
checked on the card by ``test_torch_kernels_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels import apply_gate_layer as jax_apply_gate_layer
from repro.kernels.statevec_gate.kernel import apply_layer_planes
from repro.kernels.statevec_gate.ops import _pack_gates
from repro.kernels.statevec_gate.ref import apply_layer_planes_ref
from repro.quantum import statevector as jsv
from repro_torch.kernels.statevec_gate import ops, ref
from repro_torch.quantum import statevector as tsv


def _state(rng, shape):
    s = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    return (s / np.linalg.norm(s, axis=-1, keepdims=True)).astype(np.complex64)


def _u3(rng, nq, lead=()):
    """Random unitaries (lead..., nq, 2, 2) complex64, from numpy angles."""
    th, ph, la = rng.uniform(-3, 3, (3,) + lead + (nq,))
    c, s = np.cos(th / 2), np.sin(th / 2)
    g = np.stack([np.stack([c, -np.exp(1j * la) * s], -1),
                  np.stack([np.exp(1j * ph) * s,
                            np.exp(1j * (ph + la)) * c], -1)], -2)
    return g.astype(np.complex64)


def test_gates_and_readout_helpers():
    rng = np.random.default_rng(0)
    ang = rng.uniform(-4, 4, (3, 5)).astype(np.float32)
    for jf, tf in ((jsv.ry_gate, tsv.ry_gate), (jsv.rz_gate, tsv.rz_gate)):
        np.testing.assert_allclose(np.asarray(jf(ang)),
                                   tf(torch.tensor(ang)).numpy(), atol=1e-6)
    for nq in (2, 3, 8):
        np.testing.assert_array_equal(np.asarray(jsv.ring_cz_signs(nq)),
                                      tsv.ring_cz_signs(nq, "cpu").numpy())
        np.testing.assert_array_equal(np.asarray(jsv.zexp_signs(nq, 2)),
                                      tsv.zexp_signs(nq, 2, "cpu").numpy())
    np.testing.assert_array_equal(np.asarray(jsv.init_state(3, (2,))),
                                  tsv.init_state(3, (2,), "cpu").numpy())
    st = _state(rng, (4, 64))
    t = torch.tensor(st)
    np.testing.assert_allclose(np.asarray(jsv.probs(st)),
                               tsv.probs(t).numpy(), atol=1e-7)
    np.testing.assert_allclose(np.asarray(jsv.expect_z_all(st, 5)),
                               tsv.expect_z_all(t, 5).numpy(), atol=1e-6)
    for q in (0, 3, 5):
        np.testing.assert_allclose(np.asarray(jsv.expect_z(st, q)),
                                   tsv.expect_z(t, q).numpy(), atol=1e-6)
        np.testing.assert_allclose(
            np.asarray(jsv.apply_cz(st, q, (q + 1) % 6)),
            tsv.apply_cz(t, q, (q + 1) % 6).numpy(), atol=0)


@pytest.mark.parametrize("nq,group", [(1, 2), (4, 2), (5, 3), (8, 2)])
def test_apply_1q_and_fused_layer(nq, group):
    rng = np.random.default_rng(nq)
    st = _state(rng, (3, 2 ** nq))
    gates = _u3(rng, nq)
    for q in range(nq):
        np.testing.assert_allclose(
            np.asarray(jsv.apply_1q(st, gates[q], q)),
            tsv.apply_1q(torch.tensor(st), torch.tensor(gates[q]), q).numpy(),
            atol=1e-6)
    for gj, gt in zip(jsv.group_1q_gates(gates, group),
                      tsv.group_1q_gates(torch.tensor(gates), group)):
        np.testing.assert_allclose(np.asarray(gj), gt.numpy(), atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(jsv.apply_1q_layer(st, gates, group)),
        tsv.apply_1q_layer(torch.tensor(st), torch.tensor(gates),
                           group).numpy(), atol=1e-6)


@pytest.mark.parametrize("G,S,nq", [(1, 3, 1), (2, 4, 3), (3, 2, 8)])
def test_plain_layer_matches_jax_ref_and_pallas(G, S, nq):
    """The port's plain layer == the JAX oracle and the Pallas kernel
    (interpret mode) per gate set, ≤ 1e-6."""
    rng = np.random.default_rng(10 * nq + G)
    st = _state(rng, (G, S, 2 ** nq))
    g8 = np.asarray(jax.vmap(_pack_gates)(_u3(rng, nq, (G,))))
    got_r, got_i = ref.apply_layer_planes_ref(
        torch.tensor(st.real.copy()), torch.tensor(st.imag.copy()),
        torch.tensor(g8))
    for g in range(G):
        for oracle in (apply_layer_planes_ref, apply_layer_planes):
            wr, wi = oracle(jnp.asarray(st[g].real), jnp.asarray(st[g].imag),
                            jnp.asarray(g8[g]))
            np.testing.assert_allclose(got_r[g].numpy(), np.asarray(wr),
                                       atol=1e-6)
            np.testing.assert_allclose(got_i[g].numpy(), np.asarray(wi),
                                       atol=1e-6)


def test_pack_gates_matches_jax():
    rng = np.random.default_rng(1)
    gates = _u3(rng, 5)
    np.testing.assert_array_equal(np.asarray(_pack_gates(gates)),
                                  ops.pack_gates(torch.tensor(gates)).numpy())


def test_layer_gradients_match_jax_vjp():
    """Gradients through the autograd.Function (CPU: the plain forward,
    the replayed backward) == jax.grad through repro's custom VJP, wrt the
    state planes and the gate angles, ≤ 1e-5."""
    nq, S = 3, 2
    rng = np.random.default_rng(2)
    st = _state(rng, (S, 2 ** nq))
    ang = rng.uniform(-3, 3, (2, nq)).astype(np.float32)
    wr, wi = rng.normal(size=(2, S, 2 ** nq)).astype(np.float32)

    def loss_j(sr, si, a):
        gates = jsv.rz_gate(a[1]) @ jsv.ry_gate(a[0])
        out = jax_apply_gate_layer(sr + 1j * si, gates)
        return jnp.sum(wr * out.real + wi * out.imag)

    gj = jax.grad(loss_j, argnums=(0, 1, 2))(
        jnp.asarray(st.real), jnp.asarray(st.imag), jnp.asarray(ang))

    sr = torch.tensor(st.real.copy())[None].requires_grad_(True)
    si = torch.tensor(st.imag.copy())[None].requires_grad_(True)
    a = torch.tensor(ang, requires_grad=True)
    gates = tsv.rz_gate(a[1]) @ tsv.ry_gate(a[0])
    out_r, out_i = ops.apply_gate_layer(sr, si, ops.pack_gates(gates)[None])
    (torch.tensor(wr) * out_r[0] + torch.tensor(wi) * out_i[0]).sum().backward()
    for want, got in zip(gj, (sr.grad[0], si.grad[0], a.grad)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_wrapper_rejects_bad_inputs():
    re = torch.zeros(2, 3, 8)
    with pytest.raises(ValueError):
        ops.apply_gate_layer(re, re, torch.zeros(2, 2, 8))      # nq mismatch
    with pytest.raises(ValueError):
        ops.apply_gate_layer(re, re.double(), torch.zeros(2, 3, 8))
    # past the resident kernel's 13 qubits the layer takes the tiled plan
    # (TPU kernel #2): on the CPU, the plain version
    rng = np.random.default_rng(3)
    big = torch.tensor(rng.normal(size=(2, 1, 1, 2 ** 14)).astype(np.float32))
    g8 = ops.pack_gates(torch.tensor(_u3(rng, 14, (1,))))
    got = ops.apply_gate_layer(big[0], big[1], g8)
    assert ops.LAYER_DEBUG["path"] == "tiled"
    for a, b in zip(got, ref.apply_layer_planes_ref(big[0], big[1], g8)):
        assert torch.equal(a, b)


def test_cpu_tensors_never_launch():
    before = ops.LAUNCHES
    re = torch.zeros(1, 1, 4)
    ops.apply_gate_layer(re, re, torch.zeros(1, 2, 8))
    assert ops.LAUNCHES == before
