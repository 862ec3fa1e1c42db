"""The port's single-gate op (TPU kernel #3's wrapper) vs the JAX package.

``ops.apply_gate`` on the CPU runs the plain version; it is held against
the JAX ``apply_gate`` (the Pallas kernel in interpret mode, as the JAX
package's own tests run it) over nq 2-11 and every qubit, ≤ 2e-6, and its
VJP against ``jax.vjp`` of the same, ≤ 1e-5. The backward's math,
``adjoint_gate8`` and ``gate_grad``, is held against the JAX ``ref.py``,
≤ 1e-6. The CUDA kernel itself is checked on the card by
``test_torch_kernels_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels.statevec_gate import ref as jref
from repro.kernels.statevec_gate.ops import apply_gate as jax_apply_gate
from repro.models import get_config as jax_get_config
from repro.quantum import statevector as jsv
from repro.quantum import vqc as jvqc
from repro_torch.kernels.statevec_gate import ops, ref
from repro_torch.models import get_config
from repro_torch.quantum import statevector as tsv
from repro_torch.quantum import vqc as tvqc

CASES = [(nq, q) for nq in range(2, 12) for q in range(nq)]


def _state(rng, shape):
    s = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    return (s / np.linalg.norm(s, axis=-1, keepdims=True)).astype(np.complex64)


def _angles(rng, lead=()):
    return rng.uniform(-3, 3, (3,) + lead).astype(np.float32)


@pytest.mark.parametrize("nq,q", CASES, ids=[f"nq{n}-q{q}" for n, q in CASES])
def test_apply_gate_matches_jax(nq, q):
    rng = np.random.default_rng(31 * nq + q)
    st = _state(rng, (2 ** nq,))
    t, p, l = _angles(rng)
    want = np.asarray(jax_apply_gate(jnp.asarray(st), jsv.u3_gate(t, p, l),
                                     q))
    g8 = ops.pack_gates(tsv.u3_gate(torch.tensor(t), torch.tensor(p),
                                    torch.tensor(l)))
    re, im = ops.apply_gate(torch.tensor(st.real.copy())[None, None],
                            torch.tensor(st.imag.copy())[None, None],
                            g8[None], q)
    np.testing.assert_allclose(re[0, 0].numpy(), want.real, atol=2e-6)
    np.testing.assert_allclose(im[0, 0].numpy(), want.imag, atol=2e-6)
    hook = ops.apply_1q(torch.tensor(st), tsv.u3_gate(t, p, l), q)
    np.testing.assert_allclose(hook.numpy(), want, atol=2e-6)


@pytest.mark.parametrize("nq", range(2, 12))
def test_apply_gate_vjp_matches_jax(nq):
    """Gradients wrt the state planes and the gate's three angles through
    the port's autograd.Function == jax.grad through the JAX custom VJP
    (the kernel on the adjoint gate + gate_grad), ≤ 1e-5."""
    q = nq // 2 if nq % 2 else nq - 1
    rng = np.random.default_rng(nq)
    st = _state(rng, (2 ** nq,))
    ang = _angles(rng)
    wr, wi = rng.normal(size=(2, 2 ** nq)).astype(np.float32)

    def loss_j(sr, si, a):
        out = jax_apply_gate(sr + 1j * si, jsv.u3_gate(a[0], a[1], a[2]), q)
        return jnp.sum(wr * out.real + wi * out.imag)

    gj = jax.grad(loss_j, argnums=(0, 1, 2))(
        jnp.asarray(st.real), jnp.asarray(st.imag), jnp.asarray(ang))
    sr = torch.tensor(st.real.copy()).requires_grad_(True)
    si = torch.tensor(st.imag.copy()).requires_grad_(True)
    a = torch.tensor(ang, requires_grad=True)
    g8 = ops.pack_gates(tsv.u3_gate(a[0], a[1], a[2]))
    out_r, out_i = ops.apply_gate(sr[None, None], si[None, None], g8[None], q)
    (torch.tensor(wr) * out_r[0, 0] + torch.tensor(wi) * out_i[0, 0]
     ).sum().backward()
    for want, got in zip(gj, (sr.grad, si.grad, a.grad)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_adjoint_gate8_and_gate_grad_match_jax():
    """The backward's math per gate set: adjoint ≤ 1e-6 (exact here), and
    group g's gate cotangent == the JAX gate_grad over group g's rows,
    ≤ 1e-6, for unit-norm states and cotangents (each entry sums S · 2^nq
    products in another order than XLA's, so the bound is relative to
    their scale)."""
    rng = np.random.default_rng(3)
    G, S, nq = 3, 4, 5
    g8 = rng.normal(size=(G, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        ref.adjoint_gate8(torch.tensor(g8)).numpy(),
        np.stack([np.asarray(jref.adjoint_gate8(jnp.asarray(g))) for g in g8]))
    st, cot = _state(rng, (G, S, 2 ** nq)), _state(rng, (G, S, 2 ** nq))
    planes = np.stack([st.real, st.imag, cot.real, cot.imag])
    for q in range(nq):
        got = ref.gate_grad(*map(torch.tensor, planes), q).numpy()
        for g in range(G):
            want = jref.gate_grad(*map(jnp.asarray, planes[:, g]), q)
            np.testing.assert_allclose(got[g], np.asarray(want), atol=1e-6)


def test_gate_sets_follow_the_group_axis():
    """Row (g, s) takes gate set g: every row == the JAX apply_gate of its
    group's gate, ≤ 2e-6."""
    rng = np.random.default_rng(4)
    G, S, nq, q = 3, 2, 6, 4
    st = _state(rng, (G, S, 2 ** nq))
    t, p, l = _angles(rng, (G,))
    gates = tsv.u3_gate(torch.tensor(t), torch.tensor(p), torch.tensor(l))
    re, im = ops.apply_gate(torch.tensor(st.real.copy()),
                            torch.tensor(st.imag.copy()),
                            ops.pack_gates(gates), q)
    for g in range(G):
        for s in range(S):
            want = np.asarray(jax_apply_gate(
                jnp.asarray(st[g, s]), jsv.u3_gate(t[g], p[g], l[g]), q))
            np.testing.assert_allclose(re[g, s].numpy(), want.real, atol=2e-6)
            np.testing.assert_allclose(im[g, s].numpy(), want.imag, atol=2e-6)


def test_vqc_per_gate_hook_matches_jax():
    """``vqc_logits(apply_1q=ops.apply_1q)`` == the JAX per-gate path
    through its kernel hook, ≤ 2e-6, and == the port's fused path."""
    small = dict(vqc_qubits=4, vqc_layers=2, n_features=4)
    cfg_j = jax_get_config("vqc-satqfl").replace(**small)
    cfg = get_config("vqc-satqfl").replace(**small)
    rng = np.random.default_rng(5)
    params = {"theta": rng.uniform(0, 3, (2, 4)), "phi": rng.uniform(0, 3, (2, 4)),
              "w_out": rng.uniform(1, 3, (7,)), "b_out": rng.normal(size=7)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    feats = rng.uniform(0, 3, (3, 4)).astype(np.float32)
    want = jvqc.vqc_logits(cfg_j, {k: jnp.asarray(v) for k, v in params.items()},
                           jnp.asarray(feats), apply_1q=jax_apply_gate)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    got = tvqc.vqc_logits(cfg, tp, torch.tensor(feats), apply_1q=ops.apply_1q)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
    fused = tvqc.vqc_logits(cfg, tp, torch.tensor(feats))
    np.testing.assert_allclose(got.numpy(), fused.numpy(), atol=2e-6)


def test_gate_wrapper_rejects_bad_inputs():
    re = torch.zeros(2, 3, 8)
    with pytest.raises(ValueError):
        ops.apply_gate(re, re, torch.zeros(3, 8), 0)            # G mismatch
    with pytest.raises(ValueError):
        ops.apply_gate(re, re, torch.zeros(2, 8), 3)            # no qubit 3
    with pytest.raises(ValueError):
        ops.apply_gate(re, re.double(), torch.zeros(2, 8), 0)


def test_cpu_tensors_never_launch_the_gate_kernel():
    before = ops.GATE_LAUNCHES
    re = torch.zeros(1, 1, 4, requires_grad=True)
    out, _ = ops.apply_gate(re, torch.zeros(1, 1, 4), torch.ones(1, 8), 1)
    out.sum().backward()
    assert ops.GATE_LAUNCHES == before
