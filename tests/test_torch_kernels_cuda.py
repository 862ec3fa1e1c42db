"""The port's CUDA kernels against their plain versions, on the card.

Imports torch and the port only (no jax), so it runs on a GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Every test carries the ``cuda`` marker and skips where no GPU is present:
a CUDA kernel has no CPU mode.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.otp_xor import ops as otp_ops
from repro_torch.kernels.otp_xor import ref as otp_ref
from repro_torch.kernels.statevec_gate import ops, ref


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")


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


def _words(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2 ** 32, shape, dtype=np.uint32).view(np.int32)
    return torch.tensor(a, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tag_input", [False, True])
@pytest.mark.parametrize("E,n", [(64, 62), (1, 1), (3, 4096), (3, 4097),
                                 (5, 16389), (2, 65543)])
def test_otp_rows_kernel_matches_plain(E, n, tag_input):
    """Ciphertext and tags bit-equal to the plain version; one launch."""
    _need_cuda()
    msg, pad = _words((E, n), n), _words((E, n), n + 1)
    rk, sk = _words((E,), 2), _words((E,), 3)
    before = otp_ops.LAUNCHES["otp_xor_mac_edges"]
    ct, tags = otp_ops.otp_xor_mac_rows(msg, pad, rk, sk, tag_input)
    assert otp_ops.LAUNCHES["otp_xor_mac_edges"] == before + 1
    ct_r, tags_r = otp_ref.otp_xor_mac_rows_ref(msg, pad, rk, sk, tag_input)
    torch.cuda.synchronize()
    assert torch.equal(ct, ct_r) and torch.equal(tags, tags_r)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [62, 16384 * 4 + 7])
def test_otp_stream_kernel_matches_plain(n):
    _need_cuda()
    msg, pad = _words((n,), 7), _words((n,), 8)
    before = otp_ops.LAUNCHES["otp_xor_mac"]
    for tag_input in (False, True):
        ct, tag = otp_ops.otp_xor_mac_stream(msg, pad, 0xDEADBEEF, 12345,
                                             tag_input)
        keys = torch.tensor([[0xDEADBEEF], [12345]], dtype=torch.int64,
                            device="cuda")
        ct_r, tag_r = otp_ref.otp_xor_mac_rows_ref(msg[None], pad[None],
                                                   keys[0], keys[1],
                                                   tag_input)
        torch.cuda.synchronize()
        assert torch.equal(ct, ct_r[0]) and int(tag) == int(tag_r[0])
    assert otp_ops.LAUNCHES["otp_xor_mac"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["int64", "strided", "keys"])
def test_otp_kernel_rejects_bad_cuda_inputs(bad):
    """A CUDA input of the wrong dtype or layout raises; it never drops to
    the plain version."""
    _need_cuda()
    msg, pad = _words((4, 8), 1), _words((4, 8), 2)
    keys = _words((4,), 3)
    if bad == "int64":
        msg = msg.to(torch.int64)
    elif bad == "strided":
        msg = _words((8, 4), 1).t()
    else:
        keys = keys.to(torch.int64)
    before = dict(otp_ops.LAUNCHES)
    with pytest.raises(ValueError):
        otp_ops.otp_xor_mac_rows(msg, pad, keys, keys)
    assert otp_ops.LAUNCHES == before


@pytest.mark.cuda
def test_trainer_raises_when_the_kernel_cannot_launch(monkeypatch):
    """No fallback: a secure stage on the card whose kernel does not launch
    fails the round instead of running the plain version."""
    _need_cuda()
    from repro_torch.constellation import build_trace
    from repro_torch.core import SatQFLConfig, SatQFLTrainer
    from repro_torch.data import dirichlet_partition, make_statlog
    from repro_torch.data import server_split
    from repro_torch.models import get_config, get_model

    def refuse(*args, **kwargs):
        raise RuntimeError("otp_xor_mac launch failed: refused")

    monkeypatch.setattr(otp_ops, "_launch", refuse)
    monkeypatch.setattr(otp_ops, "otp_xor_mac_rows_ref",
                        lambda *a, **k: pytest.fail("plain version ran"))
    cfg = get_config("vqc-satqfl").replace(vqc_qubits=4, vqc_layers=1,
                                           n_features=4)
    X, y = make_statlog(n_features=4, device="cuda")
    Xc, yc, server = server_split(X, y)
    sats = dirichlet_partition(Xc, yc, 6)
    trace = build_trace(n_sats=6, n_planes=2, duration_s=1800, step_s=60,
                        device="cuda")
    tr = SatQFLTrainer(cfg, get_model(cfg),
                       SatQFLConfig(mode="qfl", security="qkd", n_rounds=1,
                                    local_steps=1, batch_size=4),
                       trace, sats, server, device="cuda")
    with pytest.raises(RuntimeError, match="refused"):
        tr.run_round(0)
