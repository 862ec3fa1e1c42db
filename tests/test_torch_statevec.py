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


def _noisy_gates(rng, nq, lead=()):
    """Random non-unitary gates: U3 plus complex noise of scale 0.2."""
    g = _u3(rng, nq, lead)
    noise = rng.normal(size=g.shape) + 1j * rng.normal(size=g.shape)
    return (g + 0.2 * noise).astype(np.complex64)


# (G, S, nq, low_qubits, group_qubits): the resident plan's single pass,
# the backward's low pass plus column passes past 8 qubits, and the tiled
# split at forced small tiles
VJP_CASES = [(2, 3, 1, 13, 7), (2, 3, 5, 13, 7), (3, 2, 10, 13, 7),
             (3, 2, 6, 3, 2), (2, 2, 9, 4, 3)]


@pytest.mark.parametrize("G,S,nq,low,gq", VJP_CASES)
def test_layer_vjp_ref_matches_autograd(G, S, nq, low, gq):
    """The plain backward (the kernel's algorithm, pass by pass) == autograd
    through the plain forward, ≤ 1e-5, for non-unitary gates; the gate-only
    and state-only cases return only what is asked for."""
    rng = np.random.default_rng(100 + nq)
    st = _state(rng, (G, S, 2 ** nq))
    g8 = ops.pack_gates(torch.tensor(_noisy_gates(rng, nq, (G,))))
    re, im = torch.tensor(st.real.copy()), torch.tensor(st.imag.copy())
    w = torch.tensor(rng.normal(size=(2, G, S, 2 ** nq)).astype(np.float32))
    args = [x.clone().requires_grad_(True) for x in (re, im, g8)]
    out = ref.apply_layer_planes_ref(*args)
    (w[0] * out[0] + w[1] * out[1]).sum().backward()
    passes = ops.bwd_passes(nq, low, gq)
    (c_re, c_im), gg = ref.layer_vjp_ref(re, im, g8, w[0], w[1], passes)
    for a, b in zip(args, (c_re, c_im, gg)):
        np.testing.assert_allclose(b.numpy(), a.grad.numpy(), atol=1e-5)
    (n_re, n_im), g_only = ref.layer_vjp_ref(re, im, g8, w[0], w[1], passes,
                                             need_state=False)
    assert n_re is None and n_im is None and torch.equal(g_only, gg)
    (s_re, s_im), none = ref.layer_vjp_ref(re, im, g8, w[0], w[1], passes,
                                           need_gate=False)
    assert none is None
    assert torch.equal(s_re, c_re) and torch.equal(s_im, c_im)


@pytest.mark.parametrize("nq,G,tiling", [
    (4, 2, {}), (6, 1, dict(low_qubits=3, group_qubits=2, group_tile=4))])
def test_layer_vjp_matches_jax_vjp(nq, G, tiling):
    """The port's backward (CPU: ``ref.layer_vjp_ref`` through the
    autograd.Function) == ``jax.vjp`` of repro's ``apply_gate_layer`` (the
    Pallas forward in interpret mode), per gate set, wrt the state planes
    and the gates' real and imaginary parts, ≤ 1e-5, for non-unitary
    gates; resident plan (two gate sets) and the tiled split at forced
    small tiles (one: each JAX call runs the Pallas forward in interpret
    mode)."""
    S = 3
    rng = np.random.default_rng(200 + nq)
    st = _state(rng, (G, S, 2 ** nq))
    gates = _noisy_gates(rng, nq, (G,))
    w = rng.normal(size=(2, G, S, 2 ** nq)).astype(np.float32)
    args = [torch.tensor(x).requires_grad_(True) for x in (
        st.real.copy(), st.imag.copy(),
        ops.pack_gates(torch.tensor(gates)).numpy())]
    out = ops.apply_gate_layer(*args, **tiling)
    (torch.tensor(w[0]) * out[0] + torch.tensor(w[1]) * out[1]).sum(
    ).backward()

    def f(sr, si, gr, gi):
        o = jax_apply_gate_layer(sr + 1j * si, gr + 1j * gi, **tiling)
        return o.real, o.imag

    for g in range(G):
        _, vjp = jax.vjp(f, jnp.asarray(st[g].real), jnp.asarray(st[g].imag),
                         jnp.asarray(gates[g].real),
                         jnp.asarray(gates[g].imag))
        d_sr, d_si, d_gr, d_gi = vjp((jnp.asarray(w[0, g]),
                                      jnp.asarray(w[1, g])))
        want_g8 = np.stack([np.asarray(d_gr), np.asarray(d_gi)],
                           -1).reshape(nq, 8)
        for got, want in ((args[0].grad[g], d_sr), (args[1].grad[g], d_si),
                          (args[2].grad[g], want_g8)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5)
