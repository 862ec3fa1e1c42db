"""Quantum teleportation (paper Algorithm 4) as a feasibility primitive
(port of ``repro.quantum.teleport``).

3-qubit register, little-endian: Q=0 (secret), A=1 (sender e-bit),
B=2 (receiver e-bit).

  1. entangle A,B: H(A); CNOT(A->B)            (shared Bell pair |Φ+>)
  2. encode secret: U(θ, φ, 0) on Q
  3. Bell-basis measurement: CNOT(Q->A); H(Q); measure Q -> m0, A -> m1
  4. corrections on B: X if m1, Z if m0
  5. B now holds U(θ,φ,0)|0> — decoded back to (θ, φ) from amplitudes

Every function takes leading batch dims: ``teleport_state`` with keys
(n, 2) and angles (n,) is the JAX package's ``vmap`` of it over n pairs,
with the same measurement draws. ``teleport_params`` is the paper's
Algorithm 2 "transfer θ, φ via teleportation"; each qubit carries two
reals.
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.quantum import statevector as sv


def fidelity(psi: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """|<psi|phi>|^2 for statevectors (..., dim)."""
    ov = torch.sum(torch.conj(psi) * phi, dim=-1)
    return (torch.abs(ov) ** 2).to(torch.float32)


def teleport_state(key: torch.Tensor, theta, phi):
    """Teleport U(θ,φ,0)|0> from Q to B with sampled measurements.

    key (..., 2), theta/phi (...). Returns (received 1-qubit states
    (..., 2) complex, fidelity vs ideal, m0, m1).
    """
    theta = torch.as_tensor(theta, device=key.device).to(torch.float32)
    phi = torch.as_tensor(phi, device=key.device).to(torch.float32)
    st = sv.init_state(3, tuple(key.shape[:-1]), key.device)
    st = sv.apply_h(st, 1)
    st = sv.apply_cnot(st, 1, 2)
    st = sv.apply_u3(st, theta, phi, 0.0, 0)
    st = sv.apply_cnot(st, 0, 1)
    st = sv.apply_h(st, 0)
    keys = prng.split(key)
    m0, st = sv.measure_qubit(keys[..., 0, :], st, 0)
    m1, st = sv.measure_qubit(keys[..., 1, :], st, 1)
    # corrections on B conditioned on the classical bits
    stx = sv.apply_1q(st, sv.X.to(st.device), 2)
    st = torch.where((m1 == 1)[..., None], stx, st)
    stz = sv.apply_1q(st, sv.Z.to(st.device), 2)
    st = torch.where((m0 == 1)[..., None], stz, st)
    # B's reduced state: after measurement Q, A are classical (m0, m1)
    idx_b0 = (m0 + 2 * m1).to(torch.int64)[..., None]   # B bit = 0
    received = torch.cat([st.gather(-1, idx_b0), st.gather(-1, idx_b0 + 4)],
                         dim=-1)
    norm = torch.sqrt(torch.sum(torch.abs(received) ** 2, dim=-1,
                                keepdim=True))
    received = sv.div_real(received, norm)
    return received, fidelity(u3_col(theta, phi), received), m0, m1


def u3_col(theta, phi) -> torch.Tensor:
    """U(θ,φ,0)|0> = [cos(θ/2), e^{iφ} sin(θ/2)], stacked last."""
    t = torch.as_tensor(theta).to(torch.float32) / 2
    p = torch.as_tensor(phi, device=t.device).to(torch.float32)
    return torch.stack([torch.cos(t).to(sv.CDTYPE),
                        torch.exp(1j * p.to(sv.CDTYPE))
                        * torch.sin(t).to(sv.CDTYPE)], dim=-1)


def decode_state(received: torch.Tensor):
    """Recover (θ, φ) from received single-qubit states (..., 2), the
    inverse of ``u3_col``, in float32. A global-phase fix first rotates
    amplitude 0 to real-positive."""
    a0, a1 = received[..., 0], received[..., 1]
    r0 = torch.abs(a0)
    gp = torch.where(r0 > 1e-7, sv.div_real(a0, torch.clamp(r0, min=1e-30)),
                     torch.ones((), dtype=a0.dtype, device=a0.device))
    a1 = a1 * torch.conj(gp)
    theta = 2.0 * torch.arccos(torch.clamp(r0, 0.0, 1.0))
    return theta.to(torch.float32), torch.angle(a1).to(torch.float32)


def teleport_params(key: torch.Tensor, thetas: torch.Tensor,
                    phis: torch.Tensor):
    """Teleport a vector of (θ, φ) parameter pairs (Algorithm 2 steps 5-8).

    thetas/phis (n,) float32 in [0, π] / [-π, π]. Returns (θ', φ', mean
    fidelity). Exact up to measurement randomness: the corrections make
    the protocol deterministic, so the fidelity is 1 and θ'=θ, φ'=φ up to
    float error.
    """
    keys = prng.split(key, thetas.shape[0])
    received, fid, _, _ = teleport_state(keys, thetas, phis)
    td, pd = decode_state(received)
    return td, pd, torch.mean(fid)
