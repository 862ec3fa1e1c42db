"""Statevector simulator in PyTorch (port of ``repro.quantum.statevector``).

States are complex64 tensors of shape (..., 2**n) with little-endian qubit
order (qubit 0 is the least-significant index bit), as in the JAX
package. These functions are the plain simulator: the per-gate oracle of
the VQC, the reference its fused kernel path is held against, and the
teleport primitive's 3-qubit register (gates, CNOT, measurement). The
trainer's hot path keeps states as float32 (re, im) planes instead and
applies whole gate layers through ``repro_torch.kernels.statevec_gate``.
"""
from __future__ import annotations

import math
import string
from functools import lru_cache

import numpy as np
import torch

from repro_torch import prng
from repro_torch.device import resolve_device

CDTYPE = torch.complex64


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------

# fixed gates on the CPU; the apply_* functions move them to the state
H = (1.0 / math.sqrt(2.0)) * torch.tensor([[1, 1], [1, -1]], dtype=CDTYPE)
X = torch.tensor([[0, 1], [1, 0]], dtype=CDTYPE)
Y = torch.tensor([[0, -1j], [1j, 0]], dtype=CDTYPE)
Z = torch.tensor([[1, 0], [0, -1]], dtype=CDTYPE)


def ry_gate(theta: torch.Tensor) -> torch.Tensor:
    t = torch.as_tensor(theta).to(torch.float32) / 2
    c, s = torch.cos(t), torch.sin(t)
    return torch.stack([torch.stack([c, -s], -1),
                        torch.stack([s, c], -1)], -2).to(CDTYPE)


def rz_gate(phi: torch.Tensor) -> torch.Tensor:
    p = torch.as_tensor(phi).to(torch.float32) / 2
    e_m = torch.exp(-1j * p.to(CDTYPE))
    e_p = torch.exp(1j * p.to(CDTYPE))
    zero = torch.zeros_like(e_m)
    return torch.stack([torch.stack([e_m, zero], -1),
                        torch.stack([zero, e_p], -1)], -2)


def u3_gate(theta, phi, lam) -> torch.Tensor:
    """Standard U(θ, φ, λ) — the paper's parameter-encoding unitary (Alg.
    2/4); the angles broadcast, on the device of ``theta``."""
    t = torch.as_tensor(theta).to(torch.float32) / 2
    c = torch.cos(t).to(CDTYPE)
    s = torch.sin(t).to(CDTYPE)
    phi = torch.as_tensor(phi, device=t.device).to(torch.float32).to(CDTYPE)
    lam = torch.as_tensor(lam, device=t.device).to(torch.float32).to(CDTYPE)
    c, s, phi, lam = torch.broadcast_tensors(c, s, phi, lam)
    return torch.stack([
        torch.stack([c, -torch.exp(1j * lam) * s], -1),
        torch.stack([torch.exp(1j * phi) * s, torch.exp(1j * (phi + lam)) * c],
                    -1),
    ], -2)


# ---------------------------------------------------------------------------
# state construction / application
# ---------------------------------------------------------------------------

def init_state(n_qubits: int, batch: tuple = (), device=None) -> torch.Tensor:
    """|0...0> statevector, optionally batched."""
    state = torch.zeros(tuple(batch) + (2 ** n_qubits,), dtype=CDTYPE,
                        device=resolve_device(device))
    state[..., 0] = 1.0
    return state


def apply_1q(state: torch.Tensor, gate: torch.Tensor,
             qubit: int) -> torch.Tensor:
    """Apply a 2x2 gate to ``qubit``. state (..., 2^n); gate (..., 2, 2)
    broadcasting against the state's batch dims."""
    dim = state.shape[-1]
    lead = state.shape[:-1]
    lo = 2 ** qubit
    st = state.reshape(lead + (dim // (2 * lo), 2, lo))
    if gate.dim() == 2:
        out = torch.einsum("ab,...hbl->...hal", gate, st)
    else:
        out = torch.einsum("...ab,...hbl->...hal", gate, st)
    return out.reshape(lead + (dim,))


def apply_h(state: torch.Tensor, qubit: int) -> torch.Tensor:
    return apply_1q(state, H.to(state.device), qubit)


def apply_ry(state: torch.Tensor, theta, qubit: int) -> torch.Tensor:
    return apply_1q(state, ry_gate(theta).to(state.device), qubit)


def apply_rz(state: torch.Tensor, phi, qubit: int) -> torch.Tensor:
    return apply_1q(state, rz_gate(phi).to(state.device), qubit)


def apply_u3(state: torch.Tensor, theta, phi, lam,
             qubit: int) -> torch.Tensor:
    return apply_1q(state, u3_gate(theta, phi, lam).to(state.device), qubit)


def _bit(idx, q):
    return (idx >> q) & 1


def apply_cz(state: torch.Tensor, q1: int, q2: int) -> torch.Tensor:
    """Controlled-Z: phase-flip where both bits are 1 (diagonal)."""
    idx = torch.arange(state.shape[-1], device=state.device)
    sign = torch.where((_bit(idx, q1) & _bit(idx, q2)) == 1, -1.0, 1.0)
    return state * sign.to(CDTYPE)


def apply_cnot(state: torch.Tensor, control: int,
               target: int) -> torch.Tensor:
    """CNOT via the partner index: swap amplitudes where control=1."""
    idx = torch.arange(state.shape[-1], device=state.device)
    swapped = state[..., idx ^ (1 << target)]
    return torch.where(_bit(idx, control) == 1, swapped, state)


def apply_controlled_1q(state: torch.Tensor, gate: torch.Tensor,
                        control: int, target: int) -> torch.Tensor:
    """General controlled single-qubit gate (conditioned corrections):
    where the control bit is 1, out[i] = g[t, t]·s[i] + g[t, 1−t]·s[i ^
    2^target] with t the target bit of i."""
    idx = torch.arange(state.shape[-1], device=state.device)
    gate = gate.to(state.device)
    tbit = _bit(idx, target)
    g_tt = torch.where(tbit == 0, gate[0, 0], gate[1, 1])
    g_to = torch.where(tbit == 0, gate[0, 1], gate[1, 0])
    mixed = g_tt * state + g_to * state[..., idx ^ (1 << target)]
    return torch.where(_bit(idx, control) == 1, mixed, state)


# ---------------------------------------------------------------------------
# fused layer application (one contraction per qubit group)
# ---------------------------------------------------------------------------

def group_1q_gates(gates: torch.Tensor, group: int = 2) -> list:
    """Kron consecutive 1q gates into (2^g, 2^g) group gates.

    gates (..., nq, 2, 2), gate q acting on qubit q. Returns a list, low
    group first, of (..., 2^s, 2^s) tensors with the kron ordered
    high-qubit-first (matching the little-endian (2,)*nq reshape).
    """
    nq = gates.shape[-3]
    out = []
    q = 0
    while q < nq:
        s = min(group, nq - q)
        acc = gates[..., q, :, :]
        for t in range(1, s):
            hi = gates[..., q + t, :, :]
            d = acc.shape[-1]
            acc = torch.einsum("...hk,...ab->...hakb", hi, acc).reshape(
                acc.shape[:-2] + (2 * d, 2 * d))
        out.append(acc)
        q += s
    return out


def apply_1q_layer(state: torch.Tensor, gates: torch.Tensor,
                   group: int = 2) -> torch.Tensor:
    """Apply gate q to qubit q for all qubits in one fused contraction.

    gates (..., nq, 2, 2) broadcasts against the state's batch dims.
    Consecutive qubits are kron-fused into 2^group-dim gates, then one
    multi-operand einsum contracts every group gate with its state axis.
    """
    dim = state.shape[-1]
    nq = dim.bit_length() - 1
    if gates.shape[-3] != nq:
        raise ValueError(f"gates {tuple(gates.shape)} for {nq} qubits")
    grouped = group_1q_gates(gates.to(state.dtype), group)
    sizes = [g.shape[-1] for g in grouped]            # low group first
    lead = state.shape[:-1]
    st = state.reshape(lead + tuple(reversed(sizes)))
    n_groups = len(sizes)
    in_sub = string.ascii_lowercase[:n_groups]        # state axes, high->low
    out_sub = string.ascii_uppercase[:n_groups]
    terms = ["..." + out_sub[n_groups - 1 - j] + in_sub[n_groups - 1 - j]
             for j in range(n_groups)]
    eq = ",".join(terms) + ",..." + in_sub + "->..." + out_sub
    return torch.einsum(eq, *grouped, st).reshape(lead + (dim,))


@lru_cache(maxsize=None)
def _ring_cz_signs(nq: int, device: torch.device) -> torch.Tensor:
    idx = np.arange(1 << nq)
    count = np.zeros(idx.shape, np.int64)
    for q in range(nq):
        count += ((idx >> q) & 1) & ((idx >> ((q + 1) % nq)) & 1)
    signs = np.where(count % 2 == 1, -1.0, 1.0).astype(np.float32)
    return torch.as_tensor(signs, device=device)


def ring_cz_signs(nq: int, device=None) -> torch.Tensor:
    """±1 diagonal of the CZ entangler ring ∏_q CZ(q, q+1 mod nq): the
    CZs are diagonal and commute, so the ring is one static sign vector.
    Built once per (nq, device); callers must not write into it."""
    return _ring_cz_signs(nq, resolve_device(device))


@lru_cache(maxsize=None)
def _zexp_signs(nq: int, n_obs: int, device: torch.device) -> torch.Tensor:
    idx = np.arange(1 << nq)
    rows = [np.where((idx >> q) & 1 == 0, 1.0, -1.0) for q in range(n_obs)]
    return torch.as_tensor(np.stack(rows).astype(np.float32), device=device)


def zexp_signs(nq: int, n_obs: int, device=None) -> torch.Tensor:
    """(n_obs, 2^nq) ±1 matrix: row q is the ⟨Z_q⟩ sign vector, so the
    stacked readout is one matmul over the probabilities. Built once per
    (nq, n_obs, device); callers must not write into it."""
    return _zexp_signs(nq, n_obs, resolve_device(device))


def expect_z_all(state: torch.Tensor, n_obs: int) -> torch.Tensor:
    """Stacked ⟨Z_0..Z_{n_obs-1}⟩: state (..., 2^n) -> (..., n_obs)."""
    nq = state.shape[-1].bit_length() - 1
    return probs(state) @ zexp_signs(nq, n_obs, state.device).T


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------

def probs(state: torch.Tensor) -> torch.Tensor:
    return (state.real ** 2 + state.imag ** 2).to(torch.float32)


def expect_z(state: torch.Tensor, qubit: int) -> torch.Tensor:
    """⟨Z_qubit⟩ ∈ [-1, 1]."""
    idx = torch.arange(state.shape[-1], device=state.device)
    sign = torch.where(_bit(idx, qubit) == 0, 1.0, -1.0)
    return torch.sum(probs(state) * sign, dim=-1)


def sample_measure(key: torch.Tensor, state: torch.Tensor,
                   shots: int) -> torch.Tensor:
    """``shots`` computational-basis outcomes, (..., shots) int32, drawn as
    ``jax.random.categorical(key, logp, shape=(..., shots))`` draws them:
    the argmax over the basis of log(max(p, 1e-30)) plus Gumbel noise,
    ``prng.gumbel`` over (..., shots, 2^n). The log-probabilities
    broadcast right-aligned against that noise, as in JAX, so a batch of
    states must broadcast against (shots,)."""
    logp = torch.log(torch.clamp(probs(state), min=1e-30))
    shape = tuple(logp.shape[:-1]) + (shots, logp.shape[-1])
    return torch.argmax(prng.gumbel(key, shape) + logp,
                        dim=-1).to(torch.int32)


def measure_qubit(key: torch.Tensor, state: torch.Tensor, qubit: int):
    """Projective measurement of one qubit: (outcome int32, collapsed and
    renormalised state). One key (2,) measures the whole batch; keys
    (..., 2) matching the state's leading dims measure each state with its
    own key, as the JAX package's function does under ``vmap``. The draw
    is ``prng.uniform``, bit-exact with ``jax.random.uniform``."""
    p = probs(state)
    mask1 = _bit(torch.arange(state.shape[-1], device=state.device),
                 qubit) == 1
    p1 = torch.sum(torch.where(mask1, p, 0.0), dim=-1)
    u = prng.uniform(key, tuple(p1.shape[key.dim() - 1:]))
    outcome = (u < p1).to(torch.int32)
    keep = torch.where(outcome[..., None] == 1, mask1, ~mask1)
    collapsed = torch.where(keep, state, torch.zeros((), dtype=state.dtype,
                                                     device=state.device))
    norm = torch.sqrt(torch.sum(probs(collapsed), dim=-1, keepdim=True))
    return outcome, div_real(collapsed, torch.clamp(norm, min=1e-30))


def div_real(z: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Complex ``z`` over real ``r``, part by part: what XLA's complex
    division computes for a divisor with zero imaginary part (torch's
    complex division rounds differently)."""
    return torch.complex(z.real / r, z.imag / r)
