"""The port's gate-layer plans (TPU kernels #1, #2 and #3's per-gate plan)
vs the JAX package.

``layer_plan`` must equal the JAX package's for every register size from
2^1 to 2^22, under the default tiles and the tests' overrides. On the CPU
every plan runs the plain version: the tiled plan is held against the
JAX tiled kernel (Pallas interpret mode) at the JAX tests' forced small
tiles and at nq=14, ≤ 2e-6, its VJP ≤ 1e-5, and the per-gate plan must log
its warning and record itself in ``LAYER_DEBUG``. The launch geometry of
the card's group passes (``ops.group_passes``) is checked here; the CUDA
kernels themselves on the card by ``test_torch_kernels_cuda.py``.
"""
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels.statevec_gate import ops as jops
from repro.models import get_config as jax_get_config
from repro.quantum import statevector as jsv
from repro.quantum import vqc as jvqc
from repro_torch.kernels.statevec_gate import ops, ref
from repro_torch.models import get_config
from repro_torch.quantum import statevector as tsv
from repro_torch.quantum import vqc as tvqc

# (low_qubits, group_tile): the defaults, the JAX tests' small tiles and a
# non-power-of-two tile (the per-gate plan)
OVERRIDES = [(13, 512), (3, 4), (4, 8), (5, 16), (13, 3), (3, 0)]
# (nq, low_qubits, group_qubits, group_tile) of tests/test_batched_round.py
SMALL_TILES = [(6, 3, 2, 4), (8, 4, 3, 8), (9, 5, 4, 16), (7, 3, 2, 4)]


def _state(rng, shape):
    s = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    return (s / np.linalg.norm(s, axis=-1, keepdims=True)).astype(np.complex64)


def _gates(rng, nq):
    """(nq, 2, 2) random U3 gates from numpy angles, in both packages."""
    t, p, l = rng.uniform(-3, 3, (3, nq)).astype(np.float32)
    return (jsv.u3_gate(t, p, l),
            tsv.u3_gate(torch.tensor(t), torch.tensor(p), torch.tensor(l)))


def _port_layer(st, gates_t, **tiling):
    """The port's layer on one client's states (S, dim): G = 1."""
    re, im = ops.apply_gate_layer(torch.tensor(st.real.copy())[None],
                                  torch.tensor(st.imag.copy())[None],
                                  ops.pack_gates(gates_t)[None], **tiling)
    return torch.complex(re[0], im[0]).numpy()


@pytest.mark.parametrize("low,tile", OVERRIDES)
def test_layer_plan_matches_jax(low, tile):
    for nq in range(1, 23):
        assert ops.layer_plan(1 << nq, low, tile) == jops.layer_plan(
            1 << nq, True, low, tile), nq


@pytest.mark.parametrize("nq,low,gq,gt", SMALL_TILES)
def test_tiled_layer_matches_jax_at_small_tiles(nq, low, gq, gt):
    """Forced small tiles put several qubit groups in a small register,
    as the JAX tests do; batched states (S = 3) ride along."""
    rng = np.random.default_rng(nq)
    st = _state(rng, (3, 2 ** nq))
    gj, gt_ = _gates(rng, nq)
    tiling = dict(low_qubits=low, group_qubits=gq, group_tile=gt)
    want = jops.apply_gate_layer(jnp.asarray(st), gj, **tiling)
    assert jops.LAYER_DEBUG["path"] == "tiled"
    got = _port_layer(st, gt_, **tiling)
    assert ops.LAYER_DEBUG == {"path": "tiled", "dim": 2 ** nq,
                               "batch": (1, 3)}
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-6)


def test_tiled_layer_matches_jax_at_14_qubits():
    """The first register past the resident kernel: pass 0 over qubits
    0-12, one group pass of 1 qubit, with the default tiles."""
    rng = np.random.default_rng(14)
    st = _state(rng, (2, 2 ** 14))
    gj, gt_ = _gates(rng, 14)
    want = jops.apply_gate_layer(jnp.asarray(st), gj)
    assert jops.LAYER_DEBUG["path"] == "tiled"
    got = _port_layer(st, gt_)
    assert ops.LAYER_DEBUG["path"] == "tiled"
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-6)


def test_tiled_layer_vjp_matches_jax():
    """d/dθ of a layer-dependent loss through the tiled plan (port: the
    replayed plain version; JAX: its custom VJP), ≤ 1e-5."""
    nq = 7
    rng = np.random.default_rng(7)
    st = _state(rng, (2 ** nq,))
    tiling = dict(low_qubits=3, group_qubits=2, group_tile=4)

    def loss_j(theta):
        gates = jnp.stack([jsv.ry_gate(theta * (q + 1)) for q in range(nq)])
        out = jops.apply_gate_layer(jnp.asarray(st), gates, **tiling)
        return jnp.sum(jnp.abs(out[: 2 ** (nq - 1)]) ** 2)

    theta = torch.tensor(0.41, requires_grad=True)
    gates = torch.stack([tsv.ry_gate(theta * (q + 1)) for q in range(nq)])
    re, im = ops.apply_gate_layer(
        torch.tensor(st.real.copy())[None, None],
        torch.tensor(st.imag.copy())[None, None],
        ops.pack_gates(gates)[None], **tiling)
    (re[0, 0, : 2 ** (nq - 1)] ** 2 + im[0, 0, : 2 ** (nq - 1)] ** 2
     ).sum().backward()
    assert abs(float(jax.grad(loss_j)(0.41)) - theta.grad.item()) < 1e-5


def test_per_gate_plan_is_flagged(caplog):
    """A non-power-of-two group tile takes the per-gate plan loudly: the
    warning on the port's logger and LAYER_DEBUG, as the JAX op does; the
    result == JAX's per-gate plan."""
    nq = 6
    rng = np.random.default_rng(6)
    st = _state(rng, (2, 2 ** nq))
    gj, gt_ = _gates(rng, nq)
    tiling = dict(low_qubits=3, group_tile=3)
    want = jops.apply_gate_layer(jnp.asarray(st), gj, **tiling)
    assert jops.LAYER_DEBUG["path"] == "per-gate"
    with caplog.at_level(logging.WARNING, logger=ops.__name__):
        got = _port_layer(st, gt_, **tiling)
    assert ops.LAYER_DEBUG["path"] == "per-gate"
    assert any("per-gate" in r.message and r.name == ops.__name__
               for r in caplog.records)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-6)


@pytest.mark.parametrize("nq,low,gq,tile,want", [
    (14, 13, 7, 512, [(13, 1, 512)]),
    (20, 13, 7, 512, [(13, 7, 64)]),
    (22, 13, 7, 512, [(13, 7, 64), (20, 2, 512)]),
    (6, 3, 2, 4, [(3, 2, 4), (5, 1, 4)]),
    (8, 4, 3, 8, [(4, 3, 8), (7, 1, 8)]),
    (9, 5, 4, 16, [(5, 4, 16)]),
    (13, 13, 7, 512, [])])
def test_group_passes_cover_the_register(nq, low, gq, tile, want):
    """The card's passes after pass 0: they cover qubits [low, nq) in
    order, each tile of at most 2^13 amplitudes (64 KB for both planes in
    shared memory), ``group_tile`` an upper bound on its lanes."""
    passes = ops.group_passes(nq, low, gq, tile)
    assert passes == want
    q = min(nq, low)
    for q0, gs, tc in passes:
        assert q0 == q and 1 <= gs <= gq and tc <= min(tile, 1 << q0)
        assert (1 << gs) * tc <= ops.GROUP_AMPS and tc & (tc - 1) == 0
        q += gs
    assert q == nq or (not passes and nq <= low)


def test_vqc_wide_register_matches_jax():
    """The VQC past 13 qubits (logits and autodiff grads of one batch at
    nq=14), the JAX fused path (kron-grouped einsums) against the port's
    tiled plan (butterflies), ≤ 1e-5 each: every ⟨Z⟩ sums 2^14 products of
    two different float32 layer algorithms (2.9e-6 apart here, where the
    same pair agrees to 2e-6 at 8 qubits)."""
    small = dict(vqc_qubits=14, vqc_layers=1, n_features=4)
    cfg_j = jax_get_config("vqc-satqfl").replace(**small)
    cfg = get_config("vqc-satqfl").replace(**small)
    rng = np.random.default_rng(8)
    params = {"theta": rng.uniform(0, 3, (1, 14)), "phi": rng.uniform(0, 3, (1, 14)),
              "w_out": rng.uniform(1, 3, (7,)), "b_out": rng.normal(size=7)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    batch = {"features": rng.uniform(0, 3, (2, 4)).astype(np.float32),
             "labels": rng.integers(0, 7, (2,))}
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    np.testing.assert_allclose(
        tvqc.vqc_logits(cfg, tp, tb["features"]).detach().numpy(),
        np.asarray(jvqc.vqc_logits(cfg_j, pj, bj["features"])), atol=1e-5)
    assert ops.LAYER_DEBUG["path"] == "tiled"
    gj = jax.grad(lambda p: jvqc.vqc_loss(cfg_j, p, bj))(pj)
    tvqc.vqc_loss(cfg, tp, tb).backward()
    for k in params:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(gj[k]),
                                   atol=1e-5, err_msg=k)


def test_cpu_tensors_never_launch_a_layer_kernel():
    before = (ops.LAUNCHES, ops.TILED_LAUNCHES, ops.GATE_LAUNCHES)
    for dim, tile in ((4, 512), (2 ** 14, 512), (2 ** 14, 3)):
        re = torch.zeros(1, 1, dim)
        ops.apply_gate_layer(re, re, torch.zeros(1, dim.bit_length() - 1, 8),
                             group_tile=tile)
    assert (ops.LAUNCHES, ops.TILED_LAUNCHES, ops.GATE_LAUNCHES) == before


@pytest.mark.parametrize("nq,low,gq,want", [
    (1, 13, 7, [(0, 1)]), (8, 13, 7, [(0, 8)]),
    (10, 13, 7, [(0, 8), (8, 2)]),
    (14, 13, 7, [(0, 8), (8, 3), (11, 3)]),
    (20, 13, 7, [(0, 8), (8, 3), (11, 3), (14, 3), (17, 3)]),
    (6, 3, 2, [(0, 3), (3, 2), (5, 1)]),
    (9, 5, 4, [(0, 5), (5, 3), (8, 1)])])
def test_bwd_passes_cover_the_register(nq, low, gq, want):
    """The backward's passes: a low pass of at most 8 qubits (one warp per
    2^m chunk on the card) and column passes of at most 3 (a column's 2^m
    amplitudes, each gate's input kept in registers), in order, covering
    every qubit once; the forward's tiling overrides shape them."""
    passes = ops.bwd_passes(nq, low, gq)
    assert passes == want
    assert passes[0][1] <= ops.BWD_LOW_QUBITS
    assert all(1 <= m <= ops.BWD_COL_QUBITS for _, m in passes[1:])
    assert [q0 for q0, _ in passes] == [sum(m for _, m in passes[:i])
                                        for i in range(len(passes))]
    assert sum(m for _, m in passes) == nq


def test_tiled_layer_vjp_matches_autograd_through_plain():
    """The backward at 14 qubits (the low pass and two column passes) on
    the CPU == autograd through the plain forward, ≤ 1e-5, for
    non-unitary gates."""
    nq, G, S = 14, 1, 2
    rng = np.random.default_rng(41)
    st = _state(rng, (G, S, 2 ** nq))
    t, p, l = rng.uniform(-3, 3, (3, nq)).astype(np.float32)
    g = tsv.u3_gate(torch.tensor(t), torch.tensor(p), torch.tensor(l))
    nr, ni = torch.tensor(rng.normal(size=(2, nq, 2, 2)).astype(np.float32))
    g = g + 0.2 * torch.complex(nr, ni)
    g8 = ops.pack_gates(g)[None]
    w = torch.tensor(rng.normal(size=(2, G, S, 2 ** nq)).astype(np.float32))
    grads = []
    for fn in (ops.apply_gate_layer, ref.apply_layer_planes_ref):
        args = [x.clone().requires_grad_(True) for x in (
            torch.tensor(st.real.copy()), torch.tensor(st.imag.copy()), g8)]
        out = fn(*args)
        (w[0] * out[0] + w[1] * out[1]).sum().backward()
        grads.append([a.grad for a in args])
    assert ops.LAYER_DEBUG["path"] == "tiled"
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
