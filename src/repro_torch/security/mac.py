"""Polynomial MAC over GF(p), p = 2^31 − 1 (port of ``repro.security.mac``).

Carter–Wegman structure: each u32 word is two 16-bit symbols (low half
first), each symbol is offset by one, and

    tag = Σ_i (m_i + 1) · r^(N−i) + (N mod p) · s   (mod p),  i = 0 .. N−1

over the N = 2·words symbols, with r = (r_key mod p) | 1 and
s = s_key mod p from 32-bit key material. The arithmetic is exact modular
math, so the order of summation cannot change a bit: the plain version
here forms every term as one int64 product of two residues (< 2^62) and
reduces the int64 sum once, where the JAX package splits into 16-bit
halves to stay in uint32. Words are u32 values held in int64 tensors.

The fused XOR + MAC CUDA kernel (``repro_torch.kernels.otp_xor``) computes
the same tag; its plain version is built on this module.
"""
from __future__ import annotations

import torch

P31 = 0x7FFFFFFF            # 2^31 − 1
_M32 = 0xFFFFFFFF


def _as_words(x, like: torch.Tensor | None = None) -> torch.Tensor:
    dev = like.device if like is not None else None
    return torch.as_tensor(x, dtype=torch.int64, device=dev) & _M32


def _mod31(x: torch.Tensor) -> torch.Tensor:
    """Reduce words < 2^32 mod 2^31 − 1 using 2^31 ≡ 1."""
    y = (x >> 31) + (x & P31)
    return torch.where(y >= P31, y - P31, y)


def addmod(a, b):
    """(a + b) mod p for residues a, b < p."""
    return _mod31(a + b)


def mulmod(a, b):
    """(a · b) mod p for a, b < 2^31: one exact int64 product."""
    return (a * b) % P31


def _powers(r: torch.Tensor, n: int) -> torch.Tensor:
    """[r^1, ..., r^n] mod p along a new last axis, for residues r (...)."""
    pw = r[..., None]
    while pw.shape[-1] < n:
        step = pw[..., -1:]                      # r^len
        pw = torch.cat([pw, mulmod(pw, step)], dim=-1)
    return pw[..., :n]


def _symbols(msg: torch.Tensor) -> torch.Tensor:
    """(..., n) words -> (..., 2n) symbols + 1, low half of each word first."""
    return torch.stack([msg & 0xFFFF, msg >> 16], dim=-1).flatten(-2) + 1


def poly_mac_rows(msgs_u32: torch.Tensor, r_keys, s_keys) -> torch.Tensor:
    """Tag E equal-length streams: msgs (E, n) words, keys (E,) -> tags (E,).

    Row e is exactly ``poly_mac_u32(msgs[e], r_keys[e], s_keys[e])``.
    """
    msgs = _as_words(msgs_u32)
    r = _mod31(_as_words(r_keys, msgs)) | 1
    s = _mod31(_as_words(s_keys, msgs))
    m = _symbols(msgs)
    n = m.shape[-1]
    pw = _powers(r, n).flip(-1)                   # r^n ... r^1
    # every term < 2^31, so an int64 sum of up to 2^32 terms is exact
    tag = mulmod(m, pw).sum(dim=-1) % P31
    return addmod(tag, mulmod(torch.full_like(s, n % P31), s))


def poly_mac_u32(msg_u32: torch.Tensor, r_key, s_key) -> torch.Tensor:
    """Tag a flat (n,) word stream; returns a 0-d int64 tag."""
    msg = _as_words(msg_u32)
    return poly_mac_rows(msg[None], _as_words(r_key, msg).reshape(1),
                         _as_words(s_key, msg).reshape(1))[0]


def mac_verify(msg_u32, tag, r_key, s_key) -> torch.Tensor:
    """Recompute and compare: a 0-d bool tensor."""
    return poly_mac_u32(msg_u32, r_key, s_key) == _as_words(tag)


def mac_verify_rows(msgs_u32, tags, r_keys, s_keys) -> torch.Tensor:
    """Vectorized verify: (E,) bool — one recompute for the whole stage."""
    msgs = _as_words(msgs_u32)
    return poly_mac_rows(msgs, r_keys, s_keys) == _as_words(tags, msgs)
