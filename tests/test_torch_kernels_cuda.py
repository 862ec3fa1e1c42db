"""The port's CUDA kernels against their plain versions, on the card.

Imports torch and the port only (no jax), so it runs on a GPU machine
(``tests/conftest.py`` imports jax, hence ``--noconftest``):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py

Every test carries the ``cuda`` marker and skips where no GPU is present:
a CUDA kernel has no CPU mode.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.otp_xor import ops as otp_ops
from repro_torch.kernels.otp_xor import ref as otp_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.statevec_gate import ops, ref
from repro_torch.kernels.swa_attention import ops as swa_ops
from repro_torch.models.blocks import ssd_ref
from repro_torch.nn.pytree import tree_leaves
from torch_bf16_limit import bf16_steps


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


def _sv_counts():
    return ops.LAUNCHES, ops.TILED_LAUNCHES, ops.GATE_LAUNCHES


def _gate8(G, seed):
    """Random unitary gates packed (G, 8), on the card."""
    rng = np.random.default_rng(seed)
    th, ph, la = rng.uniform(-3, 3, (3, G))
    c, s = np.cos(th / 2), np.sin(th / 2)
    g = np.stack([np.stack([c, -np.exp(1j * la) * s], -1),
                  np.stack([np.exp(1j * ph) * s,
                            np.exp(1j * (ph + la)) * c], -1)], -2)
    return ops.pack_gates(torch.tensor(g.astype(np.complex64),
                                       device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("G,S,nq,q", [
    (64, 32, 8, 0), (64, 32, 8, 3), (64, 32, 8, 7),     # the shift insertions
    (4, 3, 5, 4), (3, 1, 1, 0),
    (2, 2, 14, 13), (1, 3, 15, 14), (1, 1, 16, 15),     # stride spans tiles
    (2, 1, 16, 2), (1, 4, 20, 17)])
def test_gate_kernel_matches_plain(G, S, nq, q):
    """Kernel #3 == the plain version, ≤ 2e-6, with the stride inside a
    warp's segment (q < 5) and past 2^13 (q ≥ 13); one launch of it and
    none of the layer kernels."""
    _need_cuda()
    re, im, _ = _layer_inputs(G, S, nq, seed=nq + q)
    g8 = _gate8(G, seed=q)
    before = _sv_counts()
    got = ops.apply_gate(re, im, g8, q)
    assert _sv_counts() == (before[0], before[1], before[2] + 1)
    want = ref.apply_gate_planes_ref(re, im, g8, q)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 13])
def test_gate_kernel_gradients_match_plain(q):
    """Kernel #3's backward (the adjoint gate through the kernel plus the
    plain gate cotangent) == autograd through the plain version, ≤ 1e-5."""
    _need_cuda()
    G, S, nq = 3, 2, 14
    re, im, _ = _layer_inputs(G, S, nq, seed=5)
    g8 = _gate8(G, seed=6)
    w = torch.randn(2, G, S, 2 ** nq, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    grads = []
    for fn in (ops.apply_gate, ref.apply_gate_planes_ref):
        args = [x.clone().requires_grad_(True) for x in (re, im, g8)]
        before = ops.GATE_LAUNCHES
        out_r, out_i = fn(*args, q)
        (w[0] * out_r + w[1] * out_i).sum().backward()
        grads.append([a.grad for a in args])
        if fn is ops.apply_gate:
            assert ops.GATE_LAUNCHES == before + 2     # forward, adjoint
    for a, b in zip(*grads):
        assert (a - b).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("G,S,nq,low,gq,gt,passes", [
    (1, 1, 6, 3, 2, 4, 3), (2, 3, 8, 4, 3, 8, 3), (3, 2, 9, 5, 4, 16, 2),
    (64, 32, 14, 13, 7, 512, 2), (3, 2, 16, 13, 7, 512, 2),
    (1, 4, 20, 13, 7, 512, 2), (2, 1, 20, 13, 3, 512, 4)])
def test_tiled_layer_kernel_matches_plain(G, S, nq, low, gq, gt, passes):
    """Kernel #2 == the plain layer, ≤ 2e-6: the JAX tests' forced small
    tiles (several passes at small nq) and the wide registers (nq 14, 16,
    20); one launch per pass and none of the other kernels."""
    _need_cuda()
    re, im, g8 = _layer_inputs(G, S, nq, seed=nq)
    before = _sv_counts()
    got = ops.apply_gate_layer(re, im, g8, low_qubits=low, group_qubits=gq,
                               group_tile=gt)
    assert ops.LAYER_DEBUG["path"] == "tiled"
    assert _sv_counts() == (before[0], before[1] + passes, before[2])
    want = ref.apply_layer_planes_ref(re, im, g8)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 2e-6


@pytest.mark.cuda
def test_per_gate_plan_runs_the_gate_kernel(caplog):
    """A non-power-of-two group tile takes the loud per-gate plan: kernel
    #3 once per qubit on the card, a warning and LAYER_DEBUG."""
    _need_cuda()
    import logging
    re, im, g8 = _layer_inputs(2, 2, 14, seed=3)
    before = _sv_counts()
    with caplog.at_level(logging.WARNING, logger=ops.__name__):
        got = ops.apply_gate_layer(re, im, g8, group_tile=3)
    assert ops.LAYER_DEBUG["path"] == "per-gate"
    assert any("per-gate" in r.message for r in caplog.records)
    assert _sv_counts() == (before[0], before[1], before[2] + 14)
    want = ref.apply_layer_planes_ref(re, im, g8)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 2e-6


@pytest.mark.cuda
def test_resident_layer_counts_only_its_kernel():
    _need_cuda()
    re, im, g8 = _layer_inputs(4, 3, 8, seed=2)
    before = _sv_counts()
    ops.apply_gate_layer(re, im, g8)
    assert ops.LAYER_DEBUG["path"] == "resident"
    assert _sv_counts() == (before[0] + 1, before[1], before[2])


@pytest.mark.cuda
def test_tiled_layer_gradients_run_the_backward_kernel():
    """Backward through the tiled plan (nq 14) runs the layer backward
    kernel — 6 launches: two recomputed pass inputs, three passes, the
    reduce — and no forward kernel, == autograd through the plain version,
    ≤ 1e-5."""
    _need_cuda()
    re, im, g8 = _layer_inputs(2, 2, 14, seed=4)
    w = torch.randn(2, 2, 2, 2 ** 14, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(1))
    grads = []
    for fn in (ops.apply_gate_layer, ref.apply_layer_planes_ref):
        args = [x.clone().requires_grad_(True) for x in (re, im, g8)]
        out_r, out_i = fn(*args)
        before = (_sv_counts(), ops.LAYER_BWD_LAUNCHES)
        (w[0] * out_r + w[1] * out_i).sum().backward()
        if fn is ops.apply_gate_layer:
            assert (_sv_counts(), ops.LAYER_BWD_LAUNCHES) == (
                before[0], before[1] + 6)
        grads.append([a.grad for a in args])
    for a, b in zip(*grads):
        assert (a - b).abs().max().item() <= 1e-5


def _noisy_layer_inputs(G, S, nq, seed):
    """As ``_layer_inputs``, the gates made non-unitary by complex noise
    of scale 0.2: the backward never inverts a gate."""
    re, im, g8 = _layer_inputs(G, S, nq, seed)
    g = torch.Generator("cuda").manual_seed(seed)
    return re, im, g8 + 0.2 * torch.randn(g8.shape, device="cuda",
                                          generator=g)


def _bwd_launches(nq, low=13, gq=7, need_gate=True):
    passes = ops.bwd_passes(nq, low, gq)
    return len(passes) + (len(passes) if need_gate else 0)


# (G, S, nq, low_qubits, group_qubits): the trainer's ansatz (64, 32, 2^8)
# and 14-qubit (64, 32, 2^14) shapes, every body of the low pass (nq 1-8),
# the column passes past 8 qubits, 20 qubits, and forced small tiles
BWD_SHAPES = [(64, 32, 8, 13, 7), (3, 2, 1, 13, 7), (3, 2, 2, 13, 7),
              (3, 2, 3, 13, 7), (4, 3, 5, 13, 7), (4, 3, 6, 13, 7),
              (4, 3, 7, 13, 7), (2, 3, 9, 13, 7), (2, 3, 10, 13, 7),
              (2, 2, 13, 13, 7), (64, 32, 14, 13, 7), (1, 2, 20, 13, 7),
              (1, 1, 6, 3, 2), (2, 3, 8, 4, 3)]
# the 14-qubit trainer shape takes the trainer's unitary gates: 14 noisy
# ones grow the cotangents to tens, where float32 rounding alone comes
# within a few ulps of 1e-5; every other shape is noisy
UNITARY_BWD_SHAPES = {(64, 32, 14)}


@pytest.mark.cuda
@pytest.mark.parametrize("need", ["both", "gate_only", "state_only"])
@pytest.mark.parametrize("G,S,nq,low,gq", BWD_SHAPES)
def test_layer_backward_kernel_matches_autograd(G, S, nq, low, gq, need):
    """The layer backward kernel == autograd through the plain version,
    ≤ 1e-5, for non-unitary gates (unitary at the 14-qubit trainer
    shape, see ``UNITARY_BWD_SHAPES``), with the state cotangent, the gate
    cotangent or both wanted (the ansatz's first layer wants only the
    gates'); its launches are counted, none of the forward kernels'."""
    _need_cuda()
    make = (_layer_inputs if (G, S, nq) in UNITARY_BWD_SHAPES
            else _noisy_layer_inputs)
    re, im, g8 = make(G, S, nq, seed=nq)
    w = torch.randn(2, G, S, 2 ** nq, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(nq))
    flags = {"both": (True, True, True), "gate_only": (False, False, True),
             "state_only": (True, True, False)}[need]
    tiling = dict(low_qubits=low, group_qubits=gq,
                  group_tile=512 if low >= 8 else 8)
    grads = []
    for fn, kw in ((ops.apply_gate_layer, tiling),
                   (ref.apply_layer_planes_ref, {})):
        args = [x.clone().requires_grad_(f) for x, f in zip((re, im, g8),
                                                             flags)]
        out_r, out_i = fn(*args, **kw)
        before = (_sv_counts(), ops.LAYER_BWD_LAUNCHES)
        (w[0] * out_r + w[1] * out_i).sum().backward()
        if fn is ops.apply_gate_layer:
            assert (_sv_counts(), ops.LAYER_BWD_LAUNCHES) == (
                before[0], before[1] + _bwd_launches(nq, low, gq, flags[2]))
        grads.append([a.grad for a in args])
    torch.cuda.synchronize()
    for a, b, f in zip(*grads, flags):
        assert (a is None) == (not f)
        if f:
            assert (a - b).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("G,S,nq", [(64, 32, 8), (64, 32, 14)])
def test_layer_backward_kernel_is_bit_identical(G, S, nq):
    """Two backward calls on the same inputs give the same bits: the gate
    cotangent is reduced in a fixed order, with no float atomics."""
    _need_cuda()
    re, im, g8 = _layer_inputs(G, S, nq, seed=7)
    w = torch.randn(2, G, S, 2 ** nq, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(7))
    grads = []
    for _ in range(2):
        args = [x.clone().requires_grad_(True) for x in (re, im, g8)]
        out_r, out_i = ops.apply_gate_layer(*args)
        (w[0] * out_r + w[1] * out_i).sum().backward()
        grads.append([a.grad for a in args])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("nq", range(1, 21))
def test_layer_bodies_match_plain_at_every_register(nq):
    """#1's bodies (one warp per state to 2^10, register-blocked to 2^13)
    and #2's (the register-blocked pass 0 past 2^13) == the plain layer,
    ≤ 1e-5, at every register from 1 to 20 qubits."""
    _need_cuda()
    G, S = (3, 5) if nq <= 14 else (1, 2)
    re, im, g8 = _layer_inputs(G, S, nq, seed=30 + nq)
    got = ops.apply_gate_layer(re, im, g8)
    assert ops.LAYER_DEBUG["path"] == ("resident" if nq <= 13 else "tiled")
    want = ref.apply_layer_planes_ref(re, im, g8)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("low", [11, 12])
def test_register_blocked_pass0_at_every_tile(low):
    """Pass 0 at 2^11 and 2^12 tiles (64 and 128 threads a tile) ==
    the plain layer, ≤ 2e-6."""
    _need_cuda()
    re, im, g8 = _layer_inputs(2, 3, 14, seed=low)
    got = ops.apply_gate_layer(re, im, g8, low_qubits=low)
    assert ops.LAYER_DEBUG["path"] == "tiled"
    want = ref.apply_layer_planes_ref(re, im, g8)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 2e-6


@pytest.mark.cuda
def test_parameter_shift_on_the_card_matches_the_cpu():
    """The shift rule's launches per step (4·nq·L of #3, 1 + L + L² of #1)
    and its loss and grads == the same rule on the CPU (plain versions),
    ≤ 1e-5: each branch value sums B · 2^nq products in another order on
    the card, where nvcc also contracts the butterflies into FMAs."""
    _need_cuda()
    from repro_torch.models import get_config
    from repro_torch.quantum.vqc import parameter_shift_grad
    cfg = get_config("vqc-satqfl")
    nq, L = cfg.vqc_qubits, cfg.vqc_layers
    rng = np.random.default_rng(0)
    K, B = 4, 32
    params = {"theta": rng.uniform(0, 3, (K, L, nq)),
              "phi": rng.uniform(0, 3, (K, L, nq)),
              "w_out": rng.uniform(1, 3, (K, 7)), "b_out": rng.normal(size=(K, 7))}
    params = {k: torch.tensor(v.astype(np.float32)) for k, v in params.items()}
    batch = {"features": torch.tensor(rng.uniform(0, 3, (K, B, 8)).astype(
        np.float32)), "labels": torch.tensor(rng.integers(0, 7, (K, B)))}
    on = lambda t: {k: v.cuda() for k, v in t.items()}
    before = _sv_counts()
    loss, g = parameter_shift_grad(cfg, on(params), on(batch), with_loss=True)
    assert _sv_counts() == (before[0] + 1 + L + L * L, before[1],
                            before[2] + 4 * nq * L)
    loss_c, g_c = parameter_shift_grad(cfg, params, batch, with_loss=True)
    assert (loss.cpu() - loss_c).abs().max().item() <= 1e-5
    for k in g:
        assert (g[k].cpu() - g_c[k]).abs().max().item() <= 1e-5, k


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
    for plain in ("otp_xor_mac_rows_ref", "otp_xor_mac_rows_seeded_ref"):
        monkeypatch.setattr(otp_ops, plain,
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


# the seeded body's trees: name -> (rows, leaves as (dtype, row shape) in
# flatten order): the trainer's VQC tree, a mixed-width tree, a multi-block
# tree, the (64, 2^20) f32 and bf16 leaves, an empty leaf and odd 16-bit
# leaves across block edges, 300 leaves spread over several blocks, and
# the federated-LLM twin's 4 rows of the smoke qwen3-0.6b tree (its init)
SEEDED_TREES = {
    "vqc_stage": (64, [("float32", (7,)), ("float32", (3, 8)),
                       ("float32", (3, 8)), ("float32", (7,))]),
    "mixed": (5, [("float32", (3, 5)), ("bfloat16", (7,)),
                  ("float16", (2, 3)), ("int32", (4,))]),
    "multiblock": (5, [("float32", (3,)), ("float32", (16389,)),
                       ("bfloat16", (5,)), ("int32", (7,))]),
    "bandwidth": (64, [("float32", (1 << 20,))]),
    "bandwidth_bf16": (64, [("bfloat16", (1 << 21,))]),
    "edges": (3, [("bfloat16", (8191,)), ("float32", (0,)),
                  ("int16", (8193,)), ("float32", (4095,)),
                  ("float16", (1,))]),
    "many_leaves": (2, [("bfloat16" if i % 3 else "float32", (17 + i,))
                        for i in range(300)]),
    "llm_twin": (4, "qwen3_smoke"),
}


def _seeded_tree(name):
    E, spec = SEEDED_TREES[name]
    if spec == "qwen3_smoke":
        from repro_torch import prng
        from repro_torch.models import get_config, get_model, smoke_variant
        from repro_torch.nn.pytree import tree_map
        cfg = smoke_variant(get_config("qwen3-0.6b"))
        tree = get_model(cfg).init(cfg, prng.PRNGKey(0, device="cuda"))
        return E, tree_map(lambda v: v.expand((E,) + v.shape), tree)
    return E, {f"l{i:03d}": torch.zeros((E,) + shape,
                                        dtype=getattr(torch, dt),
                                        device="cuda")
               for i, (dt, shape) in enumerate(spec)}


@pytest.mark.cuda
@pytest.mark.parametrize("tag_input", [False, True])
@pytest.mark.parametrize("name", list(SEEDED_TREES))
def test_otp_seeded_rows_kernel_matches_plain(name, tag_input):
    """Pads generated in the kernel: ciphertext and tags bit-equal to the
    plain version (pads expanded from the same layout), with seeds 0 and
    2^32 - 1 among the rows; one launch under the seeded key."""
    _need_cuda()
    from repro_torch.security.otp import pad_layout
    E, tree = _seeded_tree(name)
    layout = pad_layout(tree, lead=1)
    n = int(layout[-1, 1]) + (int(layout[-1, 2]) if int(layout[-1, 3]) == 32
                              else (int(layout[-1, 2]) + 1) // 2)
    msg = _words((E, n), len(name))
    seeds = _words((E,), 4)
    seeds[0], seeds[-1] = 0, -1                    # seeds 0 and 2^32 - 1
    rk, sk = _words((E,), 5), _words((E,), 6)
    before = dict(otp_ops.LAUNCHES)
    ct, tags = otp_ops.otp_xor_mac_rows_seeded(msg, seeds, layout, rk, sk,
                                               tag_input)
    assert otp_ops.LAUNCHES == {**before, "otp_xor_mac_edges_seeded":
                                before["otp_xor_mac_edges_seeded"] + 1}
    ct_r, tags_r = otp_ref.otp_xor_mac_rows_seeded_ref(msg, seeds, layout,
                                                       rk, sk, tag_input)
    torch.cuda.synchronize()
    assert torch.equal(ct, ct_r) and torch.equal(tags, tags_r)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 2 ** 32 - 1, 0x5EED])
@pytest.mark.parametrize("name", ["vqc_stage", "stream"])
def test_otp_seeded_stream_kernel_matches_plain(name, seed):
    """The stream entry at one edge's 62 words and at 65,543 words."""
    _need_cuda()
    from repro_torch.security.otp import pad_layout
    if name == "stream":
        tree = {"a": torch.zeros(1 << 16, device="cuda"),
                "b": torch.zeros(13, dtype=torch.bfloat16, device="cuda")}
    else:
        tree = {k: v[0] for k, v in _seeded_tree(name)[1].items()}
    layout = pad_layout(tree)
    n = 65543 if name == "stream" else 62
    msg = _words((n,), 9)
    before = otp_ops.LAUNCHES["otp_xor_mac_seeded"]
    for tag_input in (False, True):
        ct, tag = otp_ops.otp_xor_mac_stream_seeded(msg, seed, layout,
                                                    0xDEADBEEF, 12345,
                                                    tag_input)
        row = torch.tensor([[seed], [0xDEADBEEF], [12345]], device="cuda")
        ct_r, tag_r = otp_ref.otp_xor_mac_rows_seeded_ref(
            msg[None], row[0], layout, row[1], row[2], tag_input)
        torch.cuda.synchronize()
        assert torch.equal(ct, ct_r[0]) and int(tag) == int(tag_r[0])
    assert otp_ops.LAUNCHES["otp_xor_mac_seeded"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["seeds_int64", "seeds_cpu", "layout_cpu",
                                 "layout_words", "layout_leaves"])
def test_otp_seeded_kernel_rejects_bad_cuda_inputs(bad):
    """Seeds or a layout the kernel does not take raise before any launch;
    a CUDA call never drops to the plain version."""
    _need_cuda()
    from repro_torch.security.otp import pad_layout
    E, tree = _seeded_tree("mixed")
    layout = pad_layout(tree, lead=1)
    msg, seeds, keys = _words((E, 26), 1), _words((E,), 2), _words((E,), 3)
    if bad == "seeds_int64":
        seeds = seeds.to(torch.int64)
    elif bad == "seeds_cpu":
        seeds = seeds.cpu()
    elif bad == "layout_cpu":
        layout = layout.cpu()
    elif bad == "layout_words":
        msg = _words((E, 27), 1)
    else:
        layout = pad_layout({f"x{i:03d}": torch.zeros(E, 1, device="cuda")
                             for i in range(otp_ops.MAX_LEAVES + 1)}, lead=1)
        msg = _words((E, otp_ops.MAX_LEAVES + 1), 1)
    before = dict(otp_ops.LAUNCHES)
    with pytest.raises(ValueError):
        otp_ops.otp_xor_mac_rows_seeded(msg, seeds, layout, keys, keys)
    assert otp_ops.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("edge_batched", [True, False])
def test_secure_trainer_launches_only_the_seeded_entries(edge_batched):
    """A qfl qkd round on the card: 2 launches of the seeded rows entry
    edge-batched, 2 of the seeded stream entry per delivered edge on the
    per-edge oracle, none of the given-pad entries."""
    _need_cuda()
    from repro_torch.constellation import build_trace
    from repro_torch.core import SatQFLConfig, SatQFLTrainer
    from repro_torch.data import dirichlet_partition, make_statlog
    from repro_torch.data import server_split
    from repro_torch.models import get_config, get_model
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
                       trace, sats, server, edge_batched=edge_batched,
                       device="cuda")
    for k in otp_ops.LAUNCHES:
        otp_ops.LAUNCHES[k] = 0
    tr.run_round(0)
    want = ({"otp_xor_mac_edges_seeded": 2} if edge_batched
            else {"otp_xor_mac_seeded": 2 * tr.log.n_transfers})
    assert otp_ops.LAUNCHES == {"otp_xor_mac_edges": 0, "otp_xor_mac": 0,
                                "otp_xor_mac_edges_seeded": 0,
                                "otp_xor_mac_seeded": 0, **want}
    assert tr.log.n_transfers > 0


def _async_world(n_rounds=5):
    """The 12-satellite trace (5 rounds: deferred deliveries merge at
    rounds 1, 3 and 4), the 4-qubit model and data built on the CPU (the
    trainer moves them to its device)."""
    from repro_torch.constellation import build_trace
    from repro_torch.data import dirichlet_partition, make_statlog
    from repro_torch.data import server_split
    from repro_torch.models import get_config, get_model
    cfg = get_config("vqc-satqfl").replace(vqc_qubits=4, vqc_layers=1,
                                           n_features=4)
    X, y = make_statlog(n_features=4, device="cpu")
    Xc, yc, server = server_split(X, y)
    trace = build_trace(n_sats=12, n_planes=4, duration_s=1800, step_s=60,
                        device="cpu")
    return cfg, get_model(cfg), trace, dirichlet_partition(Xc, yc, 12), server


def _ring_entries(tr, r, g):
    """The entries main ``g``'s merge took from the ring at round r, as the
    per-main-list oracle holds them, in (sat, born) order."""
    st = tr.plan.stale
    out = []
    for s, slot in np.argwhere(st.merge_born[r, g] >= 0):
        p = ({"y": tr._ring_y[s, slot].clone()}
             if tr.fl.agg_security == "secagg" else
             {k: v[s, slot].clone() for k, v in tr._ring.items()})
        out.append((p, int(s), int(st.merge_born[r, g, s, slot])))
    return sorted(out, key=lambda e: (e[1], e[2]))


@pytest.mark.cuda
def test_async_secagg_round_card_matches_cpu():
    """async under qkd + secagg on the card and on the CPU: delivered
    counts and accounting exactly equal, metrics within 1e-4, and the secagg
    merge of the card's ring bit-equal on both devices at every round."""
    _need_cuda()
    from repro_torch.core import SatQFLConfig, SatQFLTrainer
    cfg, api, trace, sats, server = _async_world()
    fl = SatQFLConfig(mode="async", security="qkd", agg_security="secagg",
                      n_rounds=5, local_steps=2, batch_size=8)
    tc = SatQFLTrainer(cfg, api, fl, trace, sats, server, device="cuda")
    tp = SatQFLTrainer(cfg, api, fl, trace, sats, server, device="cpu")
    merged = 0
    for r in range(fl.n_rounds):
        mc, mp = tc.run_round(r), tp.run_round(r)
        assert (mc.participants, mc.comm_s, mc.security_s) == \
            (mp.participants, mp.comm_s, mp.security_s)
        assert abs(mc.server_val_loss - mp.server_val_loss) <= 1e-4
        if not tc.plan.stale.merge_any[r].any():
            continue
        ring = tc._ring_merge(r)
        tp._ring_y = tc._ring_y.cpu()
        tp.global_params = {k: v.cpu() for k, v in tc.global_params.items()}
        host = tp._ring_merge(r)
        for k in ring:
            assert torch.equal(ring[k].cpu().view(torch.int32),
                               host[k].view(torch.int32)), (r, k)
        merged += 1
    assert merged and tc.log.round_details == tp.log.round_details


@pytest.mark.cuda
@pytest.mark.parametrize("agg", ["none", "secagg"])
def test_async_ring_merge_is_the_oracle_merge_on_card(agg):
    """On the card, at every (round, main): the ring's merge == the
    per-main-list oracle's merge of the same entries, bit for bit."""
    _need_cuda()
    from repro_torch.core import SatQFLConfig, SatQFLTrainer
    cfg, api, trace, sats, server = _async_world()
    tr = SatQFLTrainer(cfg, api,
                       SatQFLConfig(mode="async", security="qkd",
                                    agg_security=agg, n_rounds=5,
                                    local_steps=2, batch_size=8),
                       trace, sats, server, device="cuda")
    tr.async_debug = True
    checked = 0
    for r in range(tr.fl.n_rounds):
        tr.run_round(r)
        ring = {m: t for rr, m, t in tr.async_merge_log if rr == r}
        for g, m in enumerate(tr.plan.live_groups(r)):
            fresh = _ring_entries(tr, r, g)
            if not fresh:
                continue
            got = (tr._secagg_merge_oracle(m, fresh) if agg == "secagg"
                   else tr._list_merge(g, fresh))
            for k in got:
                assert torch.equal(got[k].cpu().view(torch.int32),
                                   ring[m][k].view(torch.int32)), (r, m, k)
            checked += 1
    assert checked == int(tr.plan.stale.merge_any.sum()) > 0


def _swa_inputs(B, S, H, KV, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    t = lambda shape, scale: torch.tensor(
        (scale * rng.standard_normal(shape)).astype(np.float32),
        device="cuda").to(dtype)
    return (t((B, S, H, hd), 0.5), t((B, S, KV, hd), 0.5),
            t((B, S, KV, hd), 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,KV,hd,W", [
    (2, 64, 4, 2, 64, 16),        # the smoke model's attention
    (1, 96, 4, 2, 32, 0),
    (1, 1000, 3, 1, 64, 100),     # S no power of two, 3 heads
    (1, 50, 2, 2, 128, 64),       # W > S
    (2, 1, 2, 1, 64, 0),          # S = 1
    (1, 77, 4, 2, 64, 32),        # S no multiple of 16: ragged last tiles
    (1, 256, 16, 8, 128, 0),      # qwen3's hd 128, full causal
    (4, 2048, 25, 5, 64, 1024),   # hymba-1.5b's prefill
])
def test_swa_kernel_matches_plain(B, S, H, KV, hd, W, dtype):
    """The kernel == the plain version (f32 ≤ 2e-5; bf16 within one bf16
    step of each element), with one launch counted."""
    _need_cuda()
    q, k, v = _swa_inputs(B, S, H, KV, hd, dtype, seed=S + W)
    before = swa_ops.LAUNCHES
    got = swa_ops.swa_attention(q, k, v, W)
    assert swa_ops.LAUNCHES == before + 1
    want = swa_ops.swa_attention_plain(q, k, v, W)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 2e-5
    else:
        assert bf16_steps(got, want) <= 1.0


@pytest.mark.cuda
def test_swa_kernel_takes_unaligned_views():
    """A contiguous bf16 view that does not start on 16 bytes (the kernel
    stages rows in 16-byte copies) gives the same output, in one launch."""
    _need_cuda()
    q, k, v = _swa_inputs(1, 64, 4, 2, 64, torch.bfloat16, seed=9)
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device="cuda")
    qv = buf[1:].view(q.shape)
    qv.copy_(q)
    assert qv.data_ptr() % 16 != 0
    before = swa_ops.LAUNCHES
    got = swa_ops.swa_attention(qv, k, v, 16)
    assert swa_ops.LAUNCHES == before + 1
    assert torch.equal(got, swa_ops.swa_attention(q, k, v, 16))


@pytest.mark.cuda
def test_swa_kernel_gradients_replay_the_plain_version():
    _need_cuda()
    q, k, v = _swa_inputs(1, 80, 4, 2, 64, torch.float32, seed=2)
    w = torch.randn(q.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    grads = []
    for fn in (swa_ops.swa_attention, swa_ops.swa_attention_plain):
        args = [x.clone().requires_grad_(True) for x in (q, k, v)]
        (fn(*args, 16) * w).sum().backward()
        grads.append([a.grad for a in args])
    for a, b in zip(*grads):
        assert (a - b).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["hd48", "float16", "kv3"])
def test_swa_kernel_rejects_what_it_cannot_take(bad):
    """A CUDA input the kernel cannot take raises and never drops to the
    plain version."""
    _need_cuda()
    hd = 48 if bad == "hd48" else 64
    q, k, v = _swa_inputs(1, 16, 4, 3 if bad == "kv3" else 2, hd,
                          torch.float16 if bad == "float16"
                          else torch.float32, seed=1)
    before = swa_ops.LAUNCHES
    with pytest.raises(ValueError):
        swa_ops.swa_attention(q, k, v, 4)
    assert swa_ops.LAUNCHES == before


def _ssd_inputs(B, S, H, G, P, N, dtype, seed):
    rng = np.random.default_rng(seed)
    f = lambda a: torch.tensor(a.astype(np.float32), device="cuda")
    x = f(0.5 * rng.standard_normal((B, S, H, P))).to(dtype)
    dt = f(np.log1p(np.exp(rng.standard_normal((B, S, H)))))
    A = f(-np.exp(0.3 * rng.standard_normal(H)))
    Bv = f(0.3 * rng.standard_normal((B, S, G, N))).to(dtype)
    Cv = f(0.3 * rng.standard_normal((B, S, G, N))).to(dtype)
    return x, dt, A, Bv, Cv


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,G,P,N", [
    (2, 64, 16, 1, 32, 16),       # the smoke model's SSM
    (2, 256, 4, 2, 16, 16),       # G = 2
    (1, 1000, 8, 1, 64, 16),      # chunk falls back to 125
    (1, 512, 24, 1, 64, 128),     # mamba2-130m's heads and state
    (1, 100, 3, 1, 6, 12),        # chunk, P and N no multiple of 8
    (4, 2048, 50, 1, 64, 16),     # hymba-1.5b's prefill
])
def test_ssd_kernel_matches_plain(B, S, H, G, P, N):
    """y and the final state == the plain version (f32 ≤ 3e-5), one launch
    counted."""
    _need_cuda()
    args = _ssd_inputs(B, S, H, G, P, N, torch.float32, seed=S + H)
    before = ssd_ops.LAUNCHES
    y, st = ssd_ops.ssd_scan(*args, chunk=128)
    assert ssd_ops.LAUNCHES == before + 1
    y_r, st_r = ssd_ref(*args, chunk=128)
    torch.cuda.synchronize()
    assert (y - y_r).abs().max().item() <= 3e-5
    assert (st - st_r).abs().max().item() <= 3e-5


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,G,P,N", [
    (2, 64, 16, 1, 32, 16),       # the smoke model's SSM
    (2, 256, 4, 2, 16, 16),       # G = 2, P = 16
    (1, 1000, 8, 1, 64, 16),      # chunk 125: padded tiles
    (1, 512, 24, 1, 64, 128),     # N = 128: eight k-steps of C.B^T
    (1, 100, 3, 1, 6, 12),        # unaligned rows: staged element-wise
    (4, 2048, 50, 1, 64, 16),     # hymba-1.5b's prefill
    (8, 4096, 50, 1, 64, 16),     # 12,800 blocks: the look-back over waves
])
def test_ssd_kernel_matches_plain_in_bf16(B, S, H, G, P, N):
    """bf16 y within one bf16 step of each element: kernel and plain
    version round the same float32 sums; the float32 state ≤ 3e-5. The
    largest grid passes its carries across many waves of blocks, so an
    ordering fault in the look-back shows as a hang or a wrong state."""
    _need_cuda()
    args = _ssd_inputs(B, S, H, G, P, N, torch.bfloat16, seed=S + H)
    y, st = ssd_ops.ssd_scan(*args, chunk=128)
    y_r, st_r = ssd_ref(*args, chunk=128)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    assert bf16_steps(y, y_r) <= 1.0
    assert (st - st_r).abs().max().item() <= 3e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ssd_kernel_starts_from_a_given_state(dtype):
    """A given initial state is loaded by the kernel (one launch), never
    sent to the plain version."""
    _need_cuda()
    args = _ssd_inputs(2, 256, 4, 2, 16, 16, dtype, seed=5)
    init = 0.1 * torch.randn(2, 4, 16, 16, device="cuda",
                             generator=torch.Generator("cuda").manual_seed(6))
    before = ssd_ops.LAUNCHES
    y, st = ssd_ops.ssd_scan(*args, chunk=128, init_state=init)
    assert ssd_ops.LAUNCHES == before + 1
    y_r, st_r = ssd_ref(*args, chunk=128, init_state=init)
    y0, _ = ssd_ref(*args, chunk=128)
    torch.cuda.synchronize()
    assert (y.float() - y0.float()).abs().max().item() > 1e-3
    if dtype == torch.float32:
        assert (y - y_r).abs().max().item() <= 3e-5
    else:
        assert bf16_steps(y, y_r) <= 1.0
    assert (st - st_r).abs().max().item() <= 3e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,G,P,N", [
    (4, 2048, 24, 1, 64, 128),    # mamba2-130m's prefill
    (8, 4096, 50, 1, 64, 16),     # 12,800 blocks
    (2, 16384, 8, 1, 64, 16),     # 128 chunks: four look-back windows
])
def test_ssd_kernel_repeats_its_bits(B, S, H, G, P, N, dtype):
    """The look-back sums each chunk's incoming carry in a fixed order:
    five calls give the same y and state bit for bit, within the
    kernel's tolerance of the plain version."""
    _need_cuda()
    args = _ssd_inputs(B, S, H, G, P, N, dtype, seed=S + H)
    outs = [ssd_ops.ssd_scan(*args, chunk=128) for _ in range(5)]
    y_r, st_r = ssd_ref(*args, chunk=128)
    torch.cuda.synchronize()
    for y, st in outs[1:]:
        assert torch.equal(y, outs[0][0]) and torch.equal(st, outs[0][1])
    y, st = outs[0]
    if dtype == torch.float32:
        assert (y - y_r).abs().max().item() <= 3e-5
    else:
        assert bf16_steps(y, y_r) <= 1.0
    assert (st - st_r).abs().max().item() <= 3e-5


@pytest.mark.cuda
def test_ssd_kernel_gradients_replay_the_plain_version():
    _need_cuda()
    args = _ssd_inputs(1, 64, 4, 1, 16, 16, torch.float32, seed=3)
    grads = []
    for fn in (ssd_ops.ssd_scan, ssd_ref):
        targs = [a.clone().requires_grad_(True) for a in args]
        y, st = fn(*targs, chunk=32)
        (y.square().sum() + st.sum()).backward()
        grads.append([a.grad for a in targs])
    for a, b in zip(*grads):
        assert (a - b).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["chunk256", "odd_p", "mixed_dtype"])
def test_ssd_kernel_rejects_what_it_cannot_take(bad):
    _need_cuda()
    P = 15 if bad == "odd_p" else 16
    x, dt, A, Bv, Cv = _ssd_inputs(1, 512, 2, 1, P, 16, torch.float32,
                                   seed=4)
    if bad == "mixed_dtype":
        Bv = Bv.to(torch.bfloat16)
    before = ssd_ops.LAUNCHES
    with pytest.raises(ValueError):
        ssd_ops.ssd_scan(x, dt, A, Bv, Cv,
                         chunk=256 if bad == "chunk256" else 128)
    assert ssd_ops.LAUNCHES == before


# ---------------------------------------------------------------------------
# the fault plane and round checkpoints on the card
# ---------------------------------------------------------------------------

FAULTS = dict(link_flap_rate=0.3, crash_rate=0.2, straggler_rate=0.3,
              corrupt_rate=0.3, fault_seed=11)


def _fault_trainer(device, n_rounds=2, **kw):
    from repro_torch.core import SatQFLConfig, SatQFLTrainer
    cfg, api, trace, sats, server = _async_world()
    fl = SatQFLConfig(**{"mode": "sim", "security": "qkd",
                         "n_rounds": n_rounds, "local_steps": 2,
                         "batch_size": 8, **FAULTS, **kw})
    return SatQFLTrainer(cfg, api, fl, trace, sats, server, device=device)


def _spy_macs(tr) -> list:
    """Record (tamper word, seed, MAC ok) of every row the trainer's secure
    stages and per-edge exchanges send through the seeded kernel."""
    seen = []
    stage, edge = tr._secure_stage, tr._secure_edge

    def spy_stage(stacked, seeds, mac_r, mac_s, tamper):
        out, ok = stage(stacked, seeds, mac_r, mac_s, tamper)
        seen.extend(zip(tamper.tolist(), seeds.tolist(),
                        ok.cpu().tolist()))
        return out, ok

    def spy_edge(params, seed, mac_r, mac_s, tamper=0):
        out, ok = edge(params, seed, mac_r, mac_s, tamper)
        seen.append((tamper, seed, ok))
        return out, ok

    tr._secure_stage, tr._secure_edge = spy_stage, spy_edge
    return seen


@pytest.mark.cuda
def test_sim_qkd_faults_round_card_matches_cpu():
    """sim under qkd with every fault rate set, on the card and on the
    CPU: fault reports, delivered counts and accounting exactly equal,
    metrics and params within 1e-4."""
    _need_cuda()
    tc, tp = _fault_trainer("cuda"), _fault_trainer("cpu")
    tc.run()
    tp.run()
    assert tc.fault_reports == tp.fault_reports
    assert sum(f.corruptions + f.link_flaps + f.crashes
               for f in tc.fault_reports) > 0
    assert tc.log.round_details == tp.log.round_details
    for mc, mp in zip(tc.history, tp.history):
        assert (mc.participants, mc.comm_s, mc.security_s) == \
            (mp.participants, mp.comm_s, mp.security_s)
        assert abs(mc.server_val_loss - mp.server_val_loss) <= 1e-4
    for k, v in tc.global_params.items():
        assert (v.cpu() - tp.global_params[k]).abs().max() <= 1e-4, k


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["rows", "stream"])
def test_tampered_payload_fails_the_seeded_mac_on_card(entry):
    """Both seeded entries on the card: a row (or stream) whose first
    received word is flipped fails the receiver's MAC, every clean one
    passes, and the flip is undone after decryption."""
    _need_cuda()
    tr = _fault_trainer("cuda")
    rng = np.random.default_rng(4)
    u32 = lambda n: rng.integers(1, 2 ** 32, n, dtype=np.uint64).astype(
        np.uint32)
    if entry == "rows":
        K = 8
        stacked = {k: v.expand((K,) + v.shape).clone() + torch.randn(
            (K,) + v.shape, device="cuda") for k, v in
            tr.global_params.items()}
        tamper = np.zeros((K,), np.uint32)
        tamper[[1, 4, 7]] = u32(3) | 1
        out, ok = tr._secure_stage(stacked, u32(K), u32(K), u32(K), tamper)
        assert ok.cpu().tolist() == [not t for t in tamper]
    else:
        stacked = tr.global_params
        outs = [tr._secure_edge(stacked, int(s), int(r), int(m), t)
                for s, r, m, t in zip(u32(2), u32(2), u32(2),
                                      (0, int(u32(1)[0] | 1)))]
        assert [ok for _, ok in outs] == [True, False]
        out = outs[1][0]
    for k in stacked:
        assert torch.equal(out[k], stacked[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("edge_batched", [True, False])
def test_tampered_rows_fail_the_mac_in_a_faulted_round(edge_batched):
    """A faulted sim qkd run on the card: every tampered row the seeded
    kernel sees fails the MAC, every other row with a pad seed passes."""
    _need_cuda()
    tr = _fault_trainer("cuda")
    if not edge_batched:
        tr.edge_batched = False
    seen = _spy_macs(tr)
    tr.run()
    tampered = [ok for t, _, ok in seen if t]
    clean = [ok for t, s, ok in seen if not t and s]
    assert tampered and not any(tampered)
    assert clean and all(clean)
    assert len(tampered) == sum(f.corruptions for f in tr.fault_reports)


@pytest.mark.cuda
def test_kill_resume_bit_identical_on_card(tmp_path):
    """async under qkd + secagg with faults and retries on the card: 4
    rounds straight, and 2 rounds, a checkpoint, a fresh trainer restored
    from it and 2 more, end with the same bits, history, fault reports
    and accounting."""
    _need_cuda()
    kw = dict(mode="async", agg_security="secagg", max_retries=2,
              n_rounds=4)
    a = _fault_trainer("cuda", **kw)
    a.run()
    b = _fault_trainer("cuda", **kw)
    for r in range(2):
        b.run_round(r)
    b.save_round_checkpoint(str(tmp_path))
    c = _fault_trainer("cuda", **kw)
    assert c.restore_round_checkpoint(str(tmp_path)) == 2
    for r in range(2, 4):
        c.run_round(r)
    for k in a.global_params:
        assert torch.equal(a.global_params[k].view(torch.int32),
                           c.global_params[k].view(torch.int32)), k
    assert [m.participants for m in a.history] == \
        [m.participants for m in c.history]
    assert a.fault_reports == c.fault_reports
    assert a.log.round_details == c.log.round_details


# ---------------------------------------------------------------------------
# the in-graph round (core.dist) on the card
# ---------------------------------------------------------------------------

def _dist_world(device, nq=4, layers=1, n=6, steps=2, batch=8, seed=1):
    """A small stacked world on ``device``: config, api, inputs made by
    numpy from a seed (seeds u32 in int64 words)."""
    from repro_torch.models import get_config, get_model
    cfg = get_config("vqc-satqfl").replace(vqc_qubits=nq, vqc_layers=layers,
                                           n_features=nq)
    rng = np.random.default_rng(seed)
    batches = {
        "features": torch.tensor(rng.uniform(0, np.pi, (n, steps, batch, nq)
                                             ).astype(np.float32),
                                 device=device),
        "labels": torch.tensor(rng.integers(0, 7, (n, steps, batch)),
                               device=device)}
    mask = torch.tensor((rng.uniform(size=n) > 0.4).astype(np.float32),
                        device=device)
    seeds = torch.tensor(rng.integers(0, 2 ** 32, n), device=device)
    return cfg, get_model(cfg), batches, mask, seeds


def _dist_rounds(device, mode, security, rounds=2, opt="momentum",
                 grad_method="autodiff", hops=2, **kw):
    """``rounds`` rounds of ``make_fl_round`` on ``_dist_world``: (final
    state, the metrics of each round)."""
    from repro_torch import prng
    from repro_torch.core import SatQFLConfig
    from repro_torch.core.dist import fl_init_state, make_fl_round
    from repro_torch.nn import optim
    cfg, api, batches, mask, seeds = _dist_world(device, **kw)
    n = mask.shape[0]
    fl = SatQFLConfig(mode=mode, local_steps=batches["labels"].shape[1],
                      batch_size=8, grad_method=grad_method)
    opt = getattr(optim, opt)(0.1)
    state = fl_init_state(cfg, api, opt, n, prng.PRNGKey(0, device))
    rf = make_fl_round(cfg, api, fl, opt, n, security=security,
                       seq_hops=hops)
    metrics = []
    for _ in range(rounds):
        state, m = rf(state, batches, mask, seeds)
        metrics.append(m)
    return state, metrics


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sim", "async"])
def test_dist_otp_round_card_matches_cpu(mode):
    """Two otp rounds of the in-graph engine on the card and on the CPU:
    params, optimizer slots, stale buffers and losses within 1e-5; two
    seeded OTP launches a round on the card."""
    _need_cuda()
    before = otp_ops.LAUNCHES["otp_xor_mac_edges_seeded"]
    sc, mc = _dist_rounds("cuda", mode, "otp")
    assert otp_ops.LAUNCHES["otp_xor_mac_edges_seeded"] == before + 4
    sp, mp = _dist_rounds("cpu", mode, "otp")
    np.testing.assert_allclose([float(m["loss"]) for m in mc],
                               [float(m["loss"]) for m in mp], rtol=0,
                               atol=1e-5)
    for a, b in ((sc.params, sp.params), (sc.opt_slots, sp.opt_slots),
                 (sc.stale, sp.stale)):
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            assert (x.cpu() - y).abs().max() <= 1e-5
    assert torch.equal(sc.stale_age.cpu(), sp.stale_age)


@pytest.mark.cuda
def test_dist_otp_gather_verifies_and_catches_a_flipped_word():
    """otp_gather on the card: ``mac_ok`` true and the aggregate bit-equal
    to otp's; outside the round, the sender's launch equals the plain
    version bit for bit, and a ciphertext with one flipped word fails its
    row's MAC and no other row's, both under the plain verify and under
    the round's own check (the aggregator's launch against the sender's
    tags)."""
    _need_cuda()
    from repro_torch.core import dist
    from repro_torch.kernels.otp_xor.ref import (as_storage,
                                                 otp_xor_mac_rows_seeded_ref)
    from repro_torch.security.mac import mac_verify_rows
    from repro_torch.security.otp import (pad_layout, tree_to_u32_rows,
                                          u32_to_tree_rows)
    sg, mg = _dist_rounds("cuda", "sim", "otp_gather", rounds=1)
    so, _ = _dist_rounds("cuda", "sim", "otp", rounds=1)
    assert bool(mg[0]["mac_ok"])
    for x, y in zip(tree_leaves(sg.params), tree_leaves(so.params)):
        assert torch.equal(x, y)
    seeds = dist._round_seeds(_dist_world("cuda")[-1], 1, dist._OTP_MIX)
    r, s = dist._mac_keys(seeds)
    ct, tags = dist._gather_send(sg.params, seeds)
    want_ct, want_tags = otp_xor_mac_rows_seeded_ref(
        as_storage(tree_to_u32_rows(sg.params)), as_storage(seeds),
        pad_layout(sg.params, lead=1), as_storage(r), as_storage(s))
    assert torch.equal(as_storage(tree_to_u32_rows(ct)), want_ct)
    assert torch.equal(tags, want_tags)
    rows = tree_to_u32_rows(ct)
    assert mac_verify_rows(rows, tags, r, s).all()
    rows[3, 7] ^= 1 << 20
    assert mac_verify_rows(rows, tags, r, s).tolist() == [
        i != 3 for i in range(6)]
    _, rx = dist._gather_receive(u32_to_tree_rows(rows, ct), seeds)
    assert (rx == tags).tolist() == [i != 3 for i in range(6)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,security,grad_method", [
    ("sim", "none", "autodiff"), ("sim", "otp", "autodiff"),
    ("sim", "otp_gather", "autodiff"), ("sim", "secagg", "autodiff"),
    ("seq", "otp", "autodiff"), ("async", "otp", "autodiff"),
    ("sim", "none", "param_shift")])
def test_dist_round_launch_counts(mode, security, grad_method):
    """A round's launches at 8 qubits and 3 layers, E = 2 local steps, H =
    seq_hops for seq and 1 otherwise: E·(1 + L)·H of #1 and E·2L·H of the
    layer backward under autodiff; E·(1 + L + L²) of #1 and E·4·nq·L of
    #3 under the shift rule; the seeded OTP rows entry 2·H (otp), 2
    (otp_gather) or 0; nothing else."""
    _need_cuda()
    nq, L, E = 8, 3, 2
    H = 2 if mode == "seq" else 1
    _dist_rounds("cuda", mode, security, rounds=1, nq=nq, layers=L,
                 grad_method=grad_method)        # warm: builds the kernels
    before = _all_launches()
    _dist_rounds("cuda", mode, security, rounds=1, nq=nq, layers=L,
                 grad_method=grad_method)
    got = {k: v - before[k] for k, v in _all_launches().items()}
    want = {k: 0 for k in got}
    if grad_method == "param_shift":
        want["layer"] = E * (1 + L + L * L)
        want["gate_1q"] = E * 4 * nq * L
    else:
        want["layer"] = E * (1 + L) * H
        want["layer_bwd"] = E * 2 * L * H * len(ops.bwd_passes(nq))
    want["otp_xor_mac_edges_seeded"] = {"otp": 2 * H,
                                        "otp_gather": 2}.get(security, 0)
    assert got == want


def _all_launches() -> dict:
    return {"layer": ops.LAUNCHES, "tiled": ops.TILED_LAUNCHES,
            "gate_1q": ops.GATE_LAUNCHES, "layer_bwd": ops.LAYER_BWD_LAUNCHES,
            **otp_ops.LAUNCHES}


# --------------------------------------------------------------------------
# the LM training path (dense and ssm decoders)
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 512, 32, 4, 64),          # tinyllama-1.1b: GQA 32/4
    (1, 512, 16, 16, 128),        # olmo-1b: MHA 16/16, hd 128
    (1, 512, 48, 1, 128),         # granite-34b: MQA
    (2, 64, 4, 1, 64),            # granite's smoke variant
])
def test_swa_kernel_matches_plain_at_training_shapes(B, S, H, KV, hd, dtype):
    """Full causal attention at the dense archs' head layouts: the kernel
    == the plain version (f32 ≤ 2e-5; bf16 within one bf16 step), and its
    gradients (the plain version's replay) equal the plain version's."""
    _need_cuda()
    q, k, v = _swa_inputs(B, S, H, KV, hd, dtype, seed=H + KV)
    before = swa_ops.LAUNCHES
    got = swa_ops.swa_attention(q, k, v, 0)
    assert swa_ops.LAUNCHES == before + 1
    want = swa_ops.swa_attention_plain(q, k, v, 0)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 2e-5
    else:
        assert bf16_steps(got, want) <= 1.0
    w = torch.randn(q.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(1)).to(dtype)
    grads = []
    for fn in (swa_ops.swa_attention, swa_ops.swa_attention_plain):
        args = [x.clone().requires_grad_(True) for x in (q, k, v)]
        (fn(*args, 0).float() * w.float()).sum().backward()
        grads.append([a.grad for a in args])
    for a, b in zip(*grads):
        assert ((a.float() - b.float()).abs().max().item()
                <= 1e-5 * max(1.0, b.float().abs().max().item()))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmo-1b", "qwen3-0.6b",
                                  "granite-34b", "mamba2-130m",
                                  "deepseek-moe-16b", "qwen3-moe-235b-a22b"])
def test_lm_train_step_card_matches_cpu(arch):
    """One train step of the smoke variant in float32 under sgd at lr 1
    (the update is the gradient; adamw's first update is a sign), on the
    card (the kernels) and on the CPU (their plain versions) from the
    same key and batch: loss and every parameter ≤ 1e-4. The step launches
    the arch's sequence-mixer kernel 2·L times (forward and the per-layer
    recompute) and the other one never."""
    _need_cuda()
    from repro_torch import prng
    from repro_torch.data.tokens import lm_batches, synthetic_corpus
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import get_config, get_model, smoke_variant
    from repro_torch.nn.optim import sgd

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_variant(get_config(arch))
    api = get_model(cfg)
    corpus = synthetic_corpus(20_000, cfg.vocab_size, device="cpu")
    batch = next(lm_batches(corpus, 2, 64, 1, seed=3))
    out = {}
    for dev in ("cpu", "cuda"):
        params = api.init(cfg, prng.PRNGKey(0, dev))
        opt = sgd(1.0)
        step = make_train_step(cfg, api, opt)
        swa_ops.LAUNCHES = ssd_ops.LAUNCHES = 0
        out[dev] = step(params, opt.init(params),
                        {k: v.to(dev) for k, v in batch.items()}, 0)
        launches = (swa_ops.LAUNCHES, ssd_ops.LAUNCHES)
    want = ((0, 2 * cfg.n_layers) if cfg.family == "ssm"
            else (2 * cfg.n_layers, 0))
    assert launches == want
    (p_c, _, l_c), (p_g, _, l_g) = out["cpu"], out["cuda"]
    assert abs(float(l_g) - float(l_c)) <= 1e-4 * abs(float(l_c))
    for a, b in zip(tree_leaves(p_g), tree_leaves(p_c)):
        assert (a.cpu() - b).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-moe-235b-a22b"])
def test_moe_prefill_card_matches_cpu(arch, monkeypatch):
    """The smoke MoE model's prefill of 2 x 256 tokens in float32 (TF32
    off) on the card (#6) and on the CPU (its plain version) from the same
    key: every MoE layer routes every token to the same experts, and the
    next-token logits agree within 1e-4 rel. On the card the prefill
    launches #6 once a layer and #7 never; decode launches neither."""
    _need_cuda()
    from repro_torch import prng
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import blocks, get_config, get_model
    from repro_torch.models import smoke_variant

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_variant(get_config(arch))
    api = get_model(cfg)
    routed = {"cpu": [], "cuda": []}
    route = blocks._moe_route

    def spy(xt, router, cfg_):
        out = route(xt, router, cfg_)
        routed[xt.device.type].append(out[1].cpu())
        return out
    monkeypatch.setattr(blocks, "_moe_route", spy)
    tokens = prng.randint(prng.PRNGKey(3, "cpu"), (2, 256), 0,
                          cfg.vocab_size)
    logits = {}
    with torch.inference_mode():
        for dev in ("cpu", "cuda"):
            params = api.init(cfg, prng.PRNGKey(0, dev))
            swa_ops.LAUNCHES = ssd_ops.LAUNCHES = 0
            logits[dev] = make_prefill_step(cfg, api)(
                params, {"tokens": tokens.to(dev)})[:, :cfg.vocab_size]
            launches = (swa_ops.LAUNCHES, ssd_ops.LAUNCHES)
        assert launches == (cfg.n_layers, 0)
        n_moe = cfg.n_layers - cfg.first_dense_layers
        assert len(routed["cpu"]) == len(routed["cuda"]) == n_moe
        for a, b in zip(routed["cpu"], routed["cuda"]):
            assert torch.equal(a, b)
        want = logits["cpu"]
        rel = ((logits["cuda"].cpu() - want).abs().max()
               / want.abs().max()).item()
        assert rel <= 1e-4
        swa_ops.LAUNCHES = ssd_ops.LAUNCHES = 0
        toks = generate(cfg, api, params, tokens[:, :8].cuda(), 4,
                        cache_len=12)
        assert (swa_ops.LAUNCHES, ssd_ops.LAUNCHES) == (0, 0)
        assert toks.shape == (2, 12)


# --------------------------------------------------------------------------
# the encoder-decoder, the VLM and the int8 KV cache
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,KV,hd", [
    (16, 448, 6, 6, 64),          # whisper-tiny's decoder prefill
    (4, 2048, 64, 8, 128),        # llama-3.2-vision-90b's self layers
])
def test_swa_kernel_matches_plain_at_encdec_vlm_shapes(B, S, H, KV, hd,
                                                       dtype):
    """Full causal attention at the shapes the encoder-decoder and the
    VLM give #6: the kernel == the plain version (f32 ≤ 2e-5; bf16 within
    one bf16 step of each element), one launch counted."""
    _need_cuda()
    q, k, v = _swa_inputs(B, S, H, KV, hd, dtype, seed=S + H)
    before = swa_ops.LAUNCHES
    got = swa_ops.swa_attention(q, k, v, 0)
    assert swa_ops.LAUNCHES == before + 1
    want = swa_ops.swa_attention_plain(q, k, v, 0)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 2e-5
    else:
        assert bf16_steps(got, want) <= 1.0


def _open_gates(params, value: float):
    """The VLM's parameters with its tanh gates at ``value`` (0 at init
    switches every cross block off); other models' as they are."""
    if "groups" not in params:
        return params
    cross = dict(params["groups"]["cross"])
    for g in ("gate_attn", "gate_ffn"):
        cross[g] = torch.full_like(cross[g], value)
    return dict(params, groups=dict(params["groups"], cross=cross))


def _nonzero_biases(params, rng):
    """whisper's attention and MLP biases and LayerNorm shifts (``bq``,
    ``bv``, ``bo``, ``bi``, ``b``) at N(0, 0.1) and LayerNorm scales
    (``s``) at 1 + N(0, 0.1), from numpy on the params' device (a fresh
    model has them 0 and 1, which hides a bias that is dropped or
    misplaced); other models' as they are."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = _nonzero_biases(v, rng)
        elif k in ("bq", "bv", "bo", "bi", "b", "s"):
            d = 0.1 * rng.standard_normal(tuple(v.shape))
            out[k] = torch.tensor(d + (1.0 if k == "s" else 0.0),
                                  dtype=v.dtype, device=v.device)
        else:
            out[k] = v
    return out


def _causal_layers(cfg) -> int:
    if cfg.family == "encdec":
        return cfg.n_layers
    return cfg.n_layers // cfg.cross_every * (cfg.cross_every - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-tiny", "llama-3.2-vision-90b"])
def test_encdec_vlm_train_step_card_matches_cpu(arch):
    """One sgd step at lr 1 of the smoke model (VLM gates at 0.5,
    whisper's biases and LayerNorm leaves nonzero) in float32 with the
    launcher's extras, on the card and on the CPU from
    the same key and batch: loss and every parameter ≤ 1e-4; the step
    launches #6 twice per causal self-attention layer and #7 never."""
    _need_cuda()
    from repro_torch import prng
    from repro_torch.data.tokens import lm_batches, synthetic_corpus
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import lm_extras
    from repro_torch.models import get_config, get_model, smoke_variant
    from repro_torch.nn.optim import sgd

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_variant(get_config(arch))
    api = get_model(cfg)
    corpus = synthetic_corpus(20_000, cfg.vocab_size, device="cpu")
    batch = dict(next(lm_batches(corpus, 2, 64, 1, seed=3)),
                 **lm_extras(cfg, 2, "cpu"))
    out = {}
    for dev in ("cpu", "cuda"):
        params = _nonzero_biases(_open_gates(
            api.init(cfg, prng.PRNGKey(0, dev)), 0.5),
            np.random.default_rng(1))
        opt = sgd(1.0)
        swa_ops.LAUNCHES = ssd_ops.LAUNCHES = 0
        out[dev] = make_train_step(cfg, api, opt)(
            params, opt.init(params),
            {k: v.to(dev) for k, v in batch.items()}, 0)
        launches = (swa_ops.LAUNCHES, ssd_ops.LAUNCHES)
    assert launches == (2 * _causal_layers(cfg), 0)
    (p_c, _, l_c), (p_g, _, l_g) = out["cpu"], out["cuda"]
    assert abs(float(l_g) - float(l_c)) <= 1e-4 * abs(float(l_c))
    for a, b in zip(tree_leaves(p_g), tree_leaves(p_c)):
        assert (a.cpu() - b).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-tiny", "llama-3.2-vision-90b"])
def test_encdec_vlm_prefill_card_matches_cpu(arch):
    """The smoke model's prefill of 2 x 256 tokens (VLM gates at 0.5,
    whisper's biases and LayerNorm leaves nonzero) in float32, TF32 off,
    on the card (#6) and the CPU (its plain version) from the same key
    and embeddings: next-token logits ≤ 1e-4 rel; the
    prefill launches #6 once per causal layer, ``generate`` through
    ``prefill_cross`` none."""
    _need_cuda()
    from repro_torch import prng
    from repro_torch.launch.serve import generate, launcher_extras
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import get_config, get_model, smoke_variant

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_variant(get_config(arch))
    api = get_model(cfg)
    key = prng.PRNGKey(3, "cpu")
    batch = dict(tokens=prng.randint(key, (2, 256), 0, cfg.vocab_size),
                 **launcher_extras(cfg, key, 2))
    logits = {}
    with torch.inference_mode():
        for dev in ("cpu", "cuda"):
            params = _nonzero_biases(_open_gates(
                api.init(cfg, prng.PRNGKey(0, dev)), 0.5),
                np.random.default_rng(1))
            swa_ops.LAUNCHES = ssd_ops.LAUNCHES = 0
            logits[dev] = make_prefill_step(cfg, api)(
                params, {k: v.to(dev) for k, v in batch.items()}
            )[:, :cfg.vocab_size]
            launches = (swa_ops.LAUNCHES, ssd_ops.LAUNCHES)
        assert launches == (_causal_layers(cfg), 0)
        want = logits["cpu"]
        rel = ((logits["cuda"].cpu() - want).abs().max()
               / want.abs().max()).item()
        assert rel <= 1e-4
        swa_ops.LAUNCHES = ssd_ops.LAUNCHES = 0
        extras = {k: v.cuda() for k, v in batch.items() if k != "tokens"}
        toks = generate(cfg, api, params, batch["tokens"][:, :8].cuda(), 4,
                        cache_len=12, extras=extras)
        assert (swa_ops.LAUNCHES, ssd_ops.LAUNCHES) == (0, 0)
        assert toks.shape == (2, 12)


@pytest.mark.cuda
def test_int8_attn_decode_card_matches_cpu():
    """``attn_decode`` on the int8 cache, 12 steps into 8 ring slots
    under W=8, on the card and the CPU: inputs and weights on a dyadic
    grid (q, k, v exact in any summation order), so every int8 value,
    float16 scale and position written is equal, the outputs ≤ 1e-5."""
    _need_cuda()
    from repro_torch.models import blocks, get_config, smoke_variant

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_variant(get_config("tinyllama-1.1b")).replace(
        kv_cache_dtype="int8")
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    rng = np.random.default_rng(0)
    dy = lambda shape, denom: torch.tensor(
        (rng.integers(-4, 5, shape) / denom).astype(np.float32))
    p = {"wq": dy((d, H * hd), 64), "wk": dy((d, KV * hd), 64),
         "wv": dy((d, KV * hd), 64), "wo": dy((H * hd, d), 64)}
    xs = [dy((2, 1, d), 8) for _ in range(12)]
    out = {}
    for dev in ("cpu", "cuda"):
        pd = {k: v.to(dev) for k, v in p.items()}
        cache = blocks.attn_cache_init(cfg, None, 2, 8, torch.float32, dev)
        ys = []
        for t, x in enumerate(xs):
            y, cache = blocks.attn_decode(
                pd, cfg, x.to(dev), torch.full((2,), t, dtype=torch.int32,
                                               device=dev),
                cache, window=8, use_rope=False)
            ys.append(y.cpu())
        out[dev] = (torch.stack(ys), {k: v.cpu() for k, v in cache.items()})
    assert (out["cuda"][0] - out["cpu"][0]).abs().max().item() <= 1e-5
    for k, v in out["cpu"][1].items():
        assert torch.equal(out["cuda"][1][k], v), k
