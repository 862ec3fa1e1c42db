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
the shapes and results are those of the JAX package. Every contraction
over a client's data is computed client by client (a batched matmul
over the client axis, or a product summed over the last axis), never
with the client axis folded into GEMM rows: on the CPU a client's result
is then the same bits whether its call stacks 1 client or 64, so the
trainer's two executors train identically (the async ring's check
against its per-main-list oracle is bit for bit).

Gradients: exact autodiff through the fused path, or the paper-faithful
±π/2 parameter-shift rule (``parameter_shift_grad``, what Qiskit's QNN
computes), evaluated by branch stacking: every shifted circuit is the base
circuit with one fixed ±π/2 rotation inserted at its site (one launch of
the single-gate kernel on the planes), and each layer's branch stack runs
through the suffix layers as one batched gate layer per layer.
``parameter_shift_grad_serial`` evaluates one circuit pair per parameter
on the per-gate path, the rule's oracle.
"""
from __future__ import annotations

import math

import torch

from repro_torch import prng
from repro_torch.kernels.statevec_gate.ops import (
    apply_gate, apply_gate_layer, pack_gates,
)
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

def _encoded_planes(cfg: ArchConfig, features):
    """State planes (K, B, 2^nq) after the RY(x) encoding layer."""
    nq = cfg.vqc_qubits
    K, B = features.shape[:2]
    dim = 1 << nq
    re = torch.zeros((K * B, 1, dim), dtype=torch.float32,
                     device=features.device)
    re[..., 0] = 1.0
    im = torch.zeros_like(re)
    # per-sample encoding gates: one gate set per state (G = K·B, S = 1)
    enc = pack_gates(encoding_gates(cfg, features)).reshape(K * B, nq, 8)
    re, im = apply_gate_layer(re, im, enc)
    return re.reshape(K, B, dim), im.reshape(K, B, dim)


def _ansatz_layer(planes, gates8, ring):
    """One ansatz layer on planes (K, S, 2^nq): per-client gates (G = K
    clients, S rows each), then the CZ ring."""
    re, im = apply_gate_layer(*planes, gates8)
    return re * ring, im * ring


def _circuit_planes_fused(cfg: ArchConfig, params, features):
    """State planes (K, B, 2^nq) after encoding + ansatz, client axis on."""
    gates = pack_gates(layer_gates(params))                  # (K, L, nq, 8)
    ring = sv.ring_cz_signs(cfg.vqc_qubits, features.device)
    planes = _encoded_planes(cfg, features)
    for l in range(cfg.vqc_layers):
        planes = _ansatz_layer(planes, gates[:, l], ring)
    return planes


def _readout(cfg: ArchConfig, planes):
    """⟨Z_0..Z_{C-1}⟩ of planes (..., 2^nq) -> (..., C)."""
    re, im = planes
    pr = re * re + im * im
    zt = sv.zexp_signs(cfg.vqc_qubits, cfg.n_classes, re.device).T
    return torch.matmul(pr, zt.expand(pr.shape[:-2] + zt.shape))


def _logits_fused(cfg: ArchConfig, params, features):
    exps = _readout(cfg, _circuit_planes_fused(cfg, params, features))
    return params["w_out"][:, None] * exps + params["b_out"][:, None]


# ---------------------------------------------------------------------------
# per-gate reference path (numerics oracle; also the kernel-injection hook)
# ---------------------------------------------------------------------------

def _circuit_state(cfg: ArchConfig, params, features, apply_1q=None):
    """Complex state (K, B, 2^nq), one ``apply_1q`` per gate (the
    simulator's, or an override such as the single-gate kernel's
    ``ops.apply_1q``)."""
    ap = apply_1q or sv.apply_1q
    nq, L = cfg.vqc_qubits, cfg.vqc_layers
    state = sv.init_state(nq, tuple(features.shape[:2]), features.device)
    for q in range(min(cfg.n_features, nq)):
        state = ap(state, sv.ry_gate(features[..., q]), q)
    for l in range(L):
        for q in range(nq):
            state = ap(state, sv.ry_gate(params["theta"][:, l, q])[:, None],
                       q)
            state = ap(state, sv.rz_gate(params["phi"][:, l, q])[:, None], q)
        for q in range(nq):
            state = sv.apply_cz(state, q, (q + 1) % nq)
    return state


def _logits_per_gate(cfg: ArchConfig, params, features, apply_1q=None):
    state = _circuit_state(cfg, params, features, apply_1q)
    exps = torch.stack([sv.expect_z(state, q) for q in range(cfg.n_classes)],
                       dim=-1)
    return params["w_out"][:, None] * exps + params["b_out"][:, None]


def _with_client_axis(fn, params, *tensors):
    """Runs ``fn(params, *tensors)`` with a client axis added where the
    params have none, and strips it from the result's leaves."""
    single = params["theta"].dim() == 2
    if not single:
        return fn(params, *tensors)
    out = fn({k: v[None] for k, v in params.items()}, *[
        {k: v[None] for k, v in t.items()} if isinstance(t, dict) else t[None]
        for t in tensors])
    strip = lambda x: {k: v[0] for k, v in x.items()} if isinstance(
        x, dict) else x[0]
    return tuple(map(strip, out)) if isinstance(out, tuple) else strip(out)


def vqc_logits(cfg: ArchConfig, params, features, apply_1q=None,
               fused: bool = True):
    """features (B, F) -> logits (B, C); with the client axis on params,
    features (K, B, F) -> logits (K, B, C).

    The default is the fused path; ``fused=False`` (or an ``apply_1q``
    override, e.g. the single-gate kernel's ``ops.apply_1q``) takes the
    per-gate path.
    """
    if fused and apply_1q is None:
        fn = lambda p, f: _logits_fused(cfg, p, f)
    else:
        fn = lambda p, f: _logits_per_gate(cfg, p, f, apply_1q)
    return _with_client_axis(fn, params, features)


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
# parameter-shift gradients (paper-faithful: Qiskit QNN's gradient rule)
# ---------------------------------------------------------------------------

def _shift_chain(cfg: ArchConfig, params, batch, fused: bool = True):
    """dL/dlogits for the classical chain rule (the shift rule
    differentiates the circuit's expectations, which the logits are linear
    in; the cross-entropy is chained in classically, as Qiskit's QNN
    does). Client axis on: dL (K, B, C)."""
    feats, labels = batch["features"], batch["labels"]
    logits0 = vqc_logits(cfg, params, feats, fused=fused)
    p = torch.softmax(logits0, dim=-1)
    onehot = torch.nn.functional.one_hot(labels, cfg.n_classes)
    return feats, (p - onehot) / feats.shape[-2]


def _head_grads(cfg: ArchConfig, params, batch):
    """Autograd of the loss (summed over clients) wrt w_out and b_out."""
    w = params["w_out"].detach().requires_grad_(True)
    b = params["b_out"].detach().requires_grad_(True)
    with torch.enable_grad():
        loss = vqc_loss(cfg, {**params, "w_out": w, "b_out": b}, batch)
        return torch.autograd.grad(loss.sum(), (w, b))


def _pm_gates(gate_fn, K: int, device) -> list:
    """The fixed ±π/2 rotation, packed once per sign for K clients."""
    half = torch.tensor(math.pi / 2, device=device)
    return [pack_gates(gate_fn(a)).expand(K, 8).contiguous()
            for a in (half, -half)]


def _shift_grads(cfg: ArchConfig, params, batch, chunk: int):
    """The branch-stacked shift rule with the client axis on: (loss (K,),
    grads)."""
    nq, L, C = cfg.vqc_qubits, cfg.vqc_layers, cfg.n_classes
    feats, labels = batch["features"], batch["labels"]
    K, B = feats.shape[:2]
    dim = 1 << nq
    dev = feats.device
    gates = pack_gates(layer_gates(params))                  # (K, L, nq, 8)
    ring = sv.ring_cz_signs(nq, dev)
    w = params["w_out"][:, None]

    # ONE base sweep gives the per-layer branch inputs AND the readout:
    # logits, dL/dlogits and the head grads all derive from its state
    planes = _encoded_planes(cfg, feats)
    layer_in = []
    for l in range(L):
        layer_in.append(planes)
        planes = _ansatz_layer(planes, gates[:, l], ring)
    exps = _readout(cfg, planes)                               # (K, B, C)
    logits0 = w * exps + params["b_out"][:, None]
    p = torch.softmax(logits0, dim=-1)
    dL = (p - torch.nn.functional.one_hot(labels, C)) / B
    # chained diagonal observable: Σ_shift dL·logits needs only
    # Σ_{b,i} |ψ|²[b,i] · M[b,i] per branch (b_out cancels in the ± diff)
    Z = sv.zexp_signs(nq, C, dev)
    M = torch.bmm(dL * w, Z.expand((K,) + Z.shape))

    ry_pm = _pm_gates(sv.ry_gate, K, dev)
    rz_pm = _pm_gates(sv.rz_gate, K, dev)

    def branches(src, pm):
        """(K, 2·nq, B, dim) planes: the ±π/2 gate on each qubit of src,
        client-major (sign, then qubit)."""
        outs = [apply_gate(*src, pm[s], q) for s in (0, 1) for q in range(nq)]
        return tuple(torch.stack([o[i] for o in outs], dim=1) for i in (0, 1))

    def branch_vals(stack, l0):
        """Branch stack -> suffix layers l0.. -> readout (K, 2, nq)."""
        step = chunk if chunk and chunk > 0 else 2 * nq
        vals = []
        for c0 in range(0, 2 * nq, step):
            st = tuple(x[:, c0:c0 + step].reshape(K, -1, dim) for x in stack)
            for l in range(l0, L):
                st = _ansatz_layer(st, gates[:, l], ring)
            pr = (st[0] * st[0] + st[1] * st[1]).reshape(K, -1, B, dim)
            vals.append((pr.reshape(K, pr.shape[1], -1)
                         * M.reshape(K, 1, -1)).sum(dim=-1))
        return torch.cat(vals, dim=1).reshape(K, 2, nq)

    g_theta, g_phi = [], []
    for l in range(L):
        # θ_l,q: RY(±π/2) on qubit q BEFORE layer l (RY(θ±s) = RY(θ)RY(±s))
        vt = branch_vals(branches(layer_in[l], ry_pm), l)
        g_theta.append(0.5 * (vt[:, 0] - vt[:, 1]))
        # φ_l,q: RZ(±π/2) AFTER layer l (RZ commutes through the diagonal
        # CZ ring), i.e. before layer l+1
        nxt = layer_in[l + 1] if l + 1 < L else planes
        vp = branch_vals(branches(nxt, rz_pm), l + 1)
        g_phi.append(0.5 * (vp[:, 0] - vp[:, 1]))

    # head grads are closed-form: logits = w ⊙ exps + b
    grads = {"theta": torch.stack(g_theta, dim=1),
             "phi": torch.stack(g_phi, dim=1),
             "w_out": torch.sum(dL * exps, dim=1),
             "b_out": torch.sum(dL, dim=1)}
    lse = torch.logsumexp(logits0, dim=-1)
    ll = logits0.gather(-1, labels[..., None])[..., 0]
    return torch.mean(lse - ll, dim=-1), grads


def parameter_shift_grad(cfg: ArchConfig, params, batch, chunk: int = 0,
                         group: int = 4, with_loss: bool = False):
    """∂loss/∂(θ, φ) via the ±π/2 rule, vectorized over all shifts.

    Pauli rotations compose, R(θ±π/2) = R(θ)·R(±π/2), so a shifted circuit
    is the BASE circuit with one fixed ±π/2 rotation inserted at the shift
    site (RZ shifts also commute through the diagonal CZ ring). The rule

      1. runs the fused base circuit once, keeping each layer's input,
      2. per layer, inserts the ±π/2 gate on each qubit (one launch of the
         single-gate kernel each, 2·nq per stack) and pushes the stack,
         client-major (K, 2·nq·B, 2^nq), through the remaining suffix
         layers as one gate layer per layer with G = K gate sets,
      3. reads every branch out against the chained observable
         M[b, :] = Σ_c dL[b,c]·w_c·zsign_c.

    ``chunk > 0`` pushes each stack through its suffix in chunks of that
    many branches (the JAX package's ``lax.map(batch_size=chunk)``): more
    launches, the same result. ``group`` is the JAX package's kron width;
    it is kept in the signature and does not change the port's result.
    Params and batch may carry the client axis. Returns grads matching
    ``params``, or ``(loss, grads)`` with ``with_loss=True`` (the loss
    falls out of the base sweep).
    """
    with torch.no_grad():
        loss, grads = _with_client_axis(
            lambda p, b: _shift_grads(cfg, p, b, chunk), params, batch)
    return (loss, grads) if with_loss else grads


def parameter_shift_grad_serial(cfg: ArchConfig, params, batch):
    """One circuit pair per parameter on the per-gate path: the shift
    rule's numerics oracle and the baseline the stacked rule replaces."""
    def serial(params, batch):
        feats, dL = _shift_chain(cfg, params, batch, fused=False)
        shift = math.pi / 2

        def logits_at(theta, phi):
            return vqc_logits(cfg, {**params, "theta": theta, "phi": phi},
                              feats, fused=False)

        def shift_grad(base, is_theta):
            K = base.shape[0]
            out = []
            for i in range(base[0].numel()):
                e = torch.zeros_like(base).reshape(K, -1)
                e[:, i] = shift
                e = e.reshape(base.shape)
                if is_theta:
                    dlogits = 0.5 * (logits_at(base + e, params["phi"])
                                     - logits_at(base - e, params["phi"]))
                else:
                    dlogits = 0.5 * (logits_at(params["theta"], base + e)
                                     - logits_at(params["theta"], base - e))
                out.append(torch.sum(dL * dlogits, dim=(1, 2)))
            return torch.stack(out, dim=1).reshape(base.shape)

        with torch.no_grad():
            g_theta = shift_grad(params["theta"], True)
            g_phi = shift_grad(params["phi"], False)
        g_w, g_b = _head_grads(cfg, params, batch)
        return {"theta": g_theta, "phi": g_phi, "w_out": g_w, "b_out": g_b}

    return _with_client_axis(serial, params, batch)


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
                    shift_grad=parameter_shift_grad, client_axis_loss=True)
