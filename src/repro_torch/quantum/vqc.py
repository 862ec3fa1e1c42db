"""Variational quantum classifier — the paper's QFL workload (port of
``repro.quantum.vqc``).

Circuit: RY(x_i) angle encoding, L ansatz layers of RZ(φ)·RY(θ) per
qubit followed by a CZ ring, and ⟨Z_i⟩ readout on the first n_classes
qubits scaled and biased by a small classical head.

The fused path (the default, and the trainers' hot path) keeps the
batched state as float32 (re, im) planes and applies the encoding layer
and every ansatz layer through the fused gate-layer op
``kernels.statevec_gate.ops.apply_gate_layer`` — the hand-written CUDA
kernel on the GPU. The CZ ring is one ±1 diagonal and the readout one
sign-matrix product, in plain torch. ``fused=False`` runs the per-gate
complex simulator, kept as the numerics oracle.

Params may carry a leading client axis: theta/phi (K, L, nq) and
w_out/b_out (K, C) with features (K, B, F) give logits (K, B, C) and one
loss per client — the batched trainers' form. Without the client axis
the shapes and results are those of the JAX package. The parameter-shift
rule is not ported yet (ROADMAP queue 1, item 9): ``shift_grad`` is None.
"""
from __future__ import annotations

import math

import torch

from repro_torch import prng
from repro_torch.kernels.statevec_gate.ops import apply_gate_layer, pack_gates
from repro_torch.models.config import ArchConfig
from repro_torch.quantum import statevector as sv


def vqc_init(cfg: ArchConfig, key: torch.Tensor) -> dict:
    """Initial params on the key's device, the same draws as the JAX
    package's ``vqc_init`` under the same key."""
    nq, L = cfg.vqc_qubits, cfg.vqc_layers
    k1, k2, _ = prng.split(key, 3)
    dev = key.device
    return {
        "theta": prng.uniform(k1, (L, nq), 0.0, math.pi),
        "phi": prng.uniform(k2, (L, nq), 0.0, math.pi),
        "w_out": torch.ones((cfg.n_classes,), device=dev) * 3.0,
        "b_out": torch.zeros((cfg.n_classes,), device=dev),
    }


def layer_gates(params) -> torch.Tensor:
    """(..., L, nq, 2, 2) fused per-qubit ansatz gates RZ(φ)·RY(θ)."""
    ry = sv.ry_gate(params["theta"])
    rz = sv.rz_gate(params["phi"])
    return torch.einsum("...ab,...bc->...ac", rz, ry)


def encoding_gates(cfg: ArchConfig, features: torch.Tensor) -> torch.Tensor:
    """(..., nq, 2, 2) per-sample RY(x_q) encoding gates (RY(0)=I padding)."""
    nq = cfg.vqc_qubits
    k = min(cfg.n_features, nq)
    pad = torch.zeros(features.shape[:-1] + (nq - k,), dtype=torch.float32,
                      device=features.device)
    return sv.ry_gate(torch.cat([features[..., :k].to(torch.float32), pad],
                                dim=-1))


# ---------------------------------------------------------------------------
# fused batched evaluation (default path)
# ---------------------------------------------------------------------------

def _circuit_planes_fused(cfg: ArchConfig, params, features):
    """State planes (K, B, 2^nq) after encoding + ansatz, client axis on."""
    nq, L = cfg.vqc_qubits, cfg.vqc_layers
    K, B = features.shape[:2]
    dim = 1 << nq
    dev = features.device
    re = torch.zeros((K * B, 1, dim), dtype=torch.float32, device=dev)
    re[..., 0] = 1.0
    im = torch.zeros_like(re)
    # per-sample encoding gates: one gate set per state (G = K·B, S = 1)
    enc = pack_gates(encoding_gates(cfg, features)).reshape(K * B, nq, 8)
    re, im = apply_gate_layer(re, im, enc)
    re, im = re.reshape(K, B, dim), im.reshape(K, B, dim)
    # per-client ansatz gates: G = K clients, S = B samples each
    gates = pack_gates(layer_gates(params))                  # (K, L, nq, 8)
    ring = sv.ring_cz_signs(nq, dev)
    for l in range(L):
        re, im = apply_gate_layer(re, im, gates[:, l])
        re, im = re * ring, im * ring
    return re, im


def _logits_fused(cfg: ArchConfig, params, features):
    re, im = _circuit_planes_fused(cfg, params, features)
    nq = cfg.vqc_qubits
    exps = (re * re + im * im) @ sv.zexp_signs(nq, cfg.n_classes,
                                               features.device).T
    return params["w_out"][:, None] * exps + params["b_out"][:, None]


# ---------------------------------------------------------------------------
# per-gate reference path (numerics oracle)
# ---------------------------------------------------------------------------

def _circuit_state(cfg: ArchConfig, params, features):
    """Complex state (K, B, 2^nq), one ``apply_1q`` per gate."""
    nq, L = cfg.vqc_qubits, cfg.vqc_layers
    state = sv.init_state(nq, tuple(features.shape[:2]), features.device)
    for q in range(min(cfg.n_features, nq)):
        state = sv.apply_1q(state, sv.ry_gate(features[..., q]), q)
    for l in range(L):
        for q in range(nq):
            state = sv.apply_1q(
                state, sv.ry_gate(params["theta"][:, l, q])[:, None], q)
            state = sv.apply_1q(
                state, sv.rz_gate(params["phi"][:, l, q])[:, None], q)
        for q in range(nq):
            state = sv.apply_cz(state, q, (q + 1) % nq)
    return state


def _logits_per_gate(cfg: ArchConfig, params, features):
    state = _circuit_state(cfg, params, features)
    exps = torch.stack([sv.expect_z(state, q) for q in range(cfg.n_classes)],
                       dim=-1)
    return params["w_out"][:, None] * exps + params["b_out"][:, None]


def vqc_logits(cfg: ArchConfig, params, features, fused: bool = True):
    """features (B, F) -> logits (B, C); with the client axis on params,
    features (K, B, F) -> logits (K, B, C)."""
    single = params["theta"].dim() == 2
    if single:
        params = {k: v[None] for k, v in params.items()}
        features = features[None]
    fn = _logits_fused if fused else _logits_per_gate
    logits = fn(cfg, params, features)
    return logits[0] if single else logits


def vqc_loss(cfg: ArchConfig, params, batch, ctx=None, fused: bool = True):
    """Mean cross-entropy: a scalar, or (K,) per client with the client axis."""
    logits = vqc_logits(cfg, params, batch["features"], fused=fused)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, batch["labels"][..., None])[..., 0]
    return torch.mean(lse - ll, dim=-1)


def vqc_accuracy(cfg: ArchConfig, params, batch):
    logits = vqc_logits(cfg, params, batch["features"])
    hit = (torch.argmax(logits, -1) == batch["labels"]).to(torch.float32)
    return torch.mean(hit, dim=-1)


# ---------------------------------------------------------------------------
# ModelApi adapter
# ---------------------------------------------------------------------------

def _no_serve(*a, **k):
    raise NotImplementedError("VQC is a classifier — no autoregressive serve")


def vqc_api():
    from repro_torch.models.registry import ModelApi

    def fwd(cfg, params, batch, ctx=None):
        logits = vqc_logits(cfg, params, batch["features"])
        return logits, torch.zeros((), device=logits.device)

    return ModelApi(vqc_init, fwd, vqc_loss, _no_serve, _no_serve,
                    shift_grad=None)
