"""The port's CUDA kernels against their plain versions, on the card.

Imports torch and the port only (no jax), so it runs on a GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Every test carries the ``cuda`` marker and skips where no GPU is present:
a CUDA kernel has no CPU mode.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.statevec_gate import ops, ref


def _layer_inputs(G, S, nq, seed):
    """Normalized random states and random unitary gate sets, on the card."""
    rng = np.random.default_rng(seed)
    shape = (G, S, 2 ** nq)
    st = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    st /= np.linalg.norm(st, axis=-1, keepdims=True)
    th, ph, la = rng.uniform(-3, 3, (3, G, nq))
    c, s = np.cos(th / 2), np.sin(th / 2)
    gates = np.stack([np.stack([c, -np.exp(1j * la) * s], -1),
                      np.stack([np.exp(1j * ph) * s,
                                np.exp(1j * (ph + la)) * c], -1)], -2)
    t = lambda x: torch.tensor(x.astype(np.float32), device="cuda")
    return (t(st.real), t(st.imag),
            ops.pack_gates(torch.tensor(gates.astype(np.complex64),
                                        device="cuda")))


@pytest.mark.cuda
@pytest.mark.parametrize("G,S,nq", [(64, 32, 8), (2048, 1, 8), (3, 2, 1),
                                    (4, 3, 5), (2, 3, 13), (40, 3, 8),
                                    (9, 7, 10)])
def test_layer_kernel_matches_plain(G, S, nq):
    """The kernel == the plain version, ≤ 1e-5, and counts one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    re, im, g8 = _layer_inputs(G, S, nq, seed=nq)
    before = ops.LAUNCHES
    got = ops.apply_gate_layer(re, im, g8)
    assert ops.LAUNCHES == before + 1
    want = ref.apply_layer_planes_ref(re, im, g8)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_layer_kernel_gradients_match_plain():
    """Backward through the kernel op == autograd through the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    re, im, g8 = _layer_inputs(4, 3, 6, seed=1)
    w = torch.randn(2, 4, 3, 64, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    grads = []
    for fn in (ops.apply_gate_layer, ref.apply_layer_planes_ref):
        args = [x.clone().requires_grad_(True) for x in (re, im, g8)]
        out_r, out_i = fn(*args)
        (w[0] * out_r + w[1] * out_i).sum().backward()
        grads.append([a.grad for a in args])
    for a, b in zip(*grads):
        assert (a - b).abs().max().item() <= 1e-5
