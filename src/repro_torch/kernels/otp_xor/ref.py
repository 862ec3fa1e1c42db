"""Plain PyTorch versions of the fused OTP-XOR + MAC kernel.

``otp_xor_mac_rows_ref`` is the function the CUDA kernel's given-pad body
computes, on the same int32 bit storage of u32 words, and
``otp_xor_mac_rows_seeded_ref`` the one its seeded body computes (the pads
expanded from seeds and a pad layout by the port's threefry): the oracles
the kernel is held against on the card and the CPU paths of the wrappers.
The block refs reproduce the TPU kernel's intermediate contract
(``repro.kernels.otp_xor.ref``): per-(edge, block) partial tags over
128-lane blocks with a power table, on int64 u32 words.
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.security.mac import P31, poly_mac_rows, poly_mac_u32
from repro_torch.security.otp import layout_rows

_M32 = 0xFFFFFFFF


def as_words(x: torch.Tensor) -> torch.Tensor:
    """int32 bit storage (or int64 words) -> int64 u32 words."""
    return x.to(torch.int64) & _M32


def as_storage(words: torch.Tensor) -> torch.Tensor:
    """int64 u32 words -> their int32 bit storage."""
    words = words & _M32
    return (words - ((words >> 31) << 32)).to(torch.int32)


def otp_xor_mac_ref(msg_u32, pad_u32, r_key, s_key):
    """The whole op on one aligned (padded) stream, as the JAX package's
    ``otp_xor_mac_ref``: XOR, then the security layer's MAC over the
    ciphertext. u32 words (int64 or int32 storage) -> (ct, tag) as int64
    u32 words."""
    ct = as_words(msg_u32) ^ as_words(pad_u32)
    return ct, poly_mac_u32(ct, r_key, s_key)


def otp_xor_mac_rows_ref(msg, pad, r_keys, s_keys, tag_input: bool = False):
    """msg/pad (E, n) int32 storage, keys (E,) -> (ct (E, n), tags (E,)),
    both int32 storage; tags cover ``msg`` if ``tag_input`` else ``ct``."""
    m = as_words(msg)
    ct = m ^ as_words(pad)
    tags = poly_mac_rows(m if tag_input else ct, as_words(r_keys),
                         as_words(s_keys))
    return as_storage(ct), tags.to(torch.int32)


def layout_pads(seeds, layout) -> torch.Tensor:
    """(E,) seeds (int32 storage or int64 words) and a pad layout ->
    (E, n) pad words (int64): leaf i of each row draws ``prng.bits`` under
    ``fold_in(key(seed), i)``, 16-bit leaves keep the low halves and pack
    two to a word, low first, with pad 0 after an odd length."""
    base = prng.key_u32(as_words(seeds))
    out, off = [], 0
    for i, first, count, width in layout_rows(layout):
        if first != off:
            raise ValueError(f"layout leaf {i} starts at word {first}, "
                             f"not {off}")
        b = prng.bits(prng.fold_in(base, i), (count,))
        if width == 16:
            b = torch.nn.functional.pad(b & 0xFFFF, (0, count % 2))
            b = b[:, 0::2] | (b[:, 1::2] << 16)
        out.append(b)
        off += b.shape[-1]
    return torch.cat(out, dim=-1)


def otp_xor_mac_rows_seeded_ref(msg, seeds, layout, r_keys, s_keys,
                                tag_input: bool = False):
    """The seeded body: msg (E, n) int32 storage, seeds (E,), a pad layout
    of n words, keys (E,) -> (ct (E, n), tags (E,)), int32 storage."""
    return otp_xor_mac_rows_ref(msg, as_storage(layout_pads(seeds, layout)),
                                r_keys, s_keys, tag_input)


def _block_tags(terms: torch.Tensor, lead: int) -> torch.Tensor:
    """Modular sum of each block: terms (*lead, R, C) -> (*lead,)."""
    return terms.flatten(lead).sum(dim=-1) % P31


def _terms(ct, pw_lo, pw_hi):
    lo = (ct & 0xFFFF) + 1
    hi = (ct >> 16) + 1
    return ((lo * pw_lo) % P31 + (hi * pw_hi) % P31) % P31


def otp_xor_mac_edge_blocks_ref(msg, pad, powers):
    """msg/pad (E, nb, R, C) words, powers (E, 2, R, C) ->
    (ct, partial tags (E, nb)), int64 words."""
    ct = as_words(msg) ^ as_words(pad)
    pw = as_words(powers)
    terms = _terms(ct, pw[:, None, 0], pw[:, None, 1])
    return ct, _block_tags(terms, 2)


def otp_xor_mac_blocks_ref(msg, pad, powers):
    """msg/pad (nb, R, C) words, powers (2, R, C) ->
    (ct, partial tags (nb,)), int64 words."""
    ct = as_words(msg) ^ as_words(pad)
    pw = as_words(powers)
    terms = _terms(ct, pw[0][None], pw[1][None])
    return ct, _block_tags(terms, 1)
