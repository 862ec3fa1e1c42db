"""BB84 quantum key distribution, paper Algorithm 3 (port of
``repro.quantum.qkd``).

Each BB84 qubit is an independent one-qubit circuit, so a whole batch of
qubits — and, with a leading key axis, a whole batch of edges — is one
program over tensors:

  1. the sender draws random bits and random bases (Z / X);
  2. prepares |b> in the chosen basis (H|b> for X);
  3. an optional eavesdropper intercept-resends in a random basis;
  4. the receiver measures in its own random bases;
  5. sifting keeps the positions where the bases agree (~half);
  6. the QBER over the sifted bits (~25% under attack) decides an abort.

Every random draw is the port's threefry (``repro_torch.prng``), so each
field is bit-equal to the JAX package's. Measurement keeps its float32 op
order: complex abs, square, divide. The sifted key seeds the threefry pad
expansion through ``derive_pad_seed``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import prng

_M32 = 0xFFFFFFFF


class BB84Result(NamedTuple):
    sifted_key: torch.Tensor     # (..., n) int32 0/1 — padded; use key_len
    key_len: torch.Tensor        # (...) int32: number of valid sifted bits
    sift_mask: torch.Tensor      # (..., n) bool where bases matched
    sender_bits: torch.Tensor    # (..., n) int32
    receiver_bits: torch.Tensor  # (..., n) int32
    qber: torch.Tensor           # (...) float32 error rate on sifted bits


def _inv_sqrt2(device) -> torch.Tensor:
    return 1.0 / torch.sqrt(torch.tensor(2.0, dtype=torch.float32,
                                         device=device))


def _prepare(bits: torch.Tensor, bases: torch.Tensor):
    """|bit> in the Z basis, H|bit> in the X basis: amplitudes (a0, a1),
    complex64."""
    inv = _inv_sqrt2(bits.device)
    one = torch.ones((), dtype=torch.float32, device=bits.device)
    zero = torch.zeros((), dtype=torch.float32, device=bits.device)
    z0 = torch.where(bits == 0, one, zero)
    z1 = torch.where(bits == 0, zero, one)
    x0 = torch.where(bits == 0, inv, inv)
    x1 = torch.where(bits == 0, inv, -inv)
    a0 = torch.where(bases == 1, x0, z0)
    a1 = torch.where(bases == 1, x1, z1)
    return a0.to(torch.complex64), a1.to(torch.complex64)


def _measure_1q(key: torch.Tensor, a0, a1, basis: torch.Tensor):
    """Measure one-qubit states in Z (0) or X (1): X is H, then Z."""
    inv = _inv_sqrt2(a0.device)
    h0, h1 = (a0 + a1) * inv, (a0 - a1) * inv
    b0 = torch.where(basis == 1, h0, a0)
    b1 = torch.where(basis == 1, h1, a1)
    p1 = torch.abs(b1) ** 2 / (torch.abs(b0) ** 2 + torch.abs(b1) ** 2)
    u = prng.uniform(key, (p1.shape[-1],))
    return (u < p1).to(torch.int32)


def _bb84_impl(key: torch.Tensor, n_bits: int, eavesdrop) -> BB84Result:
    """BB84 over keys (..., 2); ``eavesdrop`` is a Python bool or a bool
    tensor over the key batch.

    With a tensor, the eavesdropper's branch is always computed and
    selected per edge with a ``where``: the keys are split up front, so a
    clean edge consumes the same key material as a ``False`` call and the
    batch is bit-identical to per-edge calls. A Python bool skips the
    branch it does not need.
    """
    ks = prng.split(key, 6)
    shape = (n_bits,)
    bits = prng.bernoulli(ks[..., 0, :], 0.5, shape).to(torch.int32)
    bases_a = prng.bernoulli(ks[..., 1, :], 0.5, shape).to(torch.int32)
    bases_b = prng.bernoulli(ks[..., 2, :], 0.5, shape).to(torch.int32)

    a0, a1 = _prepare(bits, bases_a)
    if isinstance(eavesdrop, bool):
        if eavesdrop:
            bases_e = prng.bernoulli(ks[..., 3, :], 0.5,
                                     shape).to(torch.int32)
            eve_bits = _measure_1q(ks[..., 4, :], a0, a1, bases_e)
            a0, a1 = _prepare(eve_bits, bases_e)      # intercept-resend
    else:
        bases_e = prng.bernoulli(ks[..., 3, :], 0.5, shape).to(torch.int32)
        eve_bits = _measure_1q(ks[..., 4, :], a0, a1, bases_e)
        e0, e1 = _prepare(eve_bits, bases_e)          # intercept-resend
        eav = torch.as_tensor(eavesdrop, dtype=torch.bool,
                              device=key.device)[..., None]
        a0, a1 = torch.where(eav, e0, a0), torch.where(eav, e1, a1)

    recv_bits = _measure_1q(ks[..., 5, :], a0, a1, bases_b)

    sift = bases_a == bases_b
    n_sift = sift.sum(dim=-1, dtype=torch.int32)
    # compact the sifted bits to the front (fixed shape; key_len counts)
    order = torch.argsort((~sift).to(torch.int8), dim=-1, stable=True)
    pos = torch.arange(n_bits, device=key.device)
    sifted = torch.where(pos < n_sift[..., None],
                         torch.gather(recv_bits, -1, order),
                         torch.zeros_like(recv_bits))
    errors = (sift & (recv_bits != bits)).sum(dim=-1, dtype=torch.int32)
    qber = (errors.to(torch.float32)
            / torch.clamp(n_sift, min=1).to(torch.float32))
    return BB84Result(sifted_key=sifted, key_len=n_sift, sift_mask=sift,
                      sender_bits=bits, receiver_bits=recv_bits, qber=qber)


def bb84_keygen(key: torch.Tensor, n_bits: int,
                eavesdrop: bool = False) -> BB84Result:
    """Run BB84 over n_bits channel uses (single edge, key (2,))."""
    return _bb84_impl(key, n_bits, bool(eavesdrop))


def bb84_keygen_edges(keys: torch.Tensor, n_bits: int,
                      eavesdrop) -> BB84Result:
    """Edge-batched BB84: keys (E, 2), eavesdrop (E,) bool; every field
    gains a leading edge axis, each row bit-identical to
    ``bb84_keygen(keys[e], n_bits, bool(eavesdrop[e]))``."""
    return _bb84_impl(keys, n_bits,
                      torch.as_tensor(eavesdrop, dtype=torch.bool,
                                      device=keys.device))


def qber_estimate(res: BB84Result) -> torch.Tensor:
    return res.qber


def qber_abort_mask(res: BB84Result, threshold: float) -> torch.Tensor:
    """(E,) bool: True where the edge's QBER crossed the abort threshold."""
    return res.qber > threshold


def derive_pad_seed(sifted_key: torch.Tensor, key_len) -> torch.Tensor:
    """Fold the valid sifted bits into a 32-bit seed: the wrapping u32 sum
    of bit_i · ((i · 2654435761 mod 2^32) mod 2^31), as int64."""
    n = sifted_key.shape[-1]
    idx = torch.arange(n, dtype=torch.int64, device=sifted_key.device)
    valid = idx < torch.as_tensor(key_len, device=sifted_key.device)[..., None]
    weights = ((idx * 2654435761) & _M32) % (1 << 31)
    terms = torch.where(valid, sifted_key.to(torch.int64) * weights, 0)
    return terms.sum(dim=-1) & _M32


def derive_pad_seeds(sifted_keys: torch.Tensor,
                     key_lens: torch.Tensor) -> torch.Tensor:
    """Edge-batched ``derive_pad_seed``: (E, n) keys + (E,) lens -> (E,)."""
    return derive_pad_seed(sifted_keys, key_lens)
