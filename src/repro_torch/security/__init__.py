"""Security stack of the port (paper Algorithm 2): QKD-keyed OTP + MAC.

  * ``otp``  — XOR one-time-pad encryption of parameter trees, pads
    expanded from QKD-derived seeds by the threefry PRF, and the u32 wire
    view of a tree
  * ``mac``  — polynomial MAC over the wire words, GF(2^31 − 1)
  * ``fernet_lite`` — Fernet-structured token AEAD for control messages
  * ``keys`` — per-edge, per-round key schedule driven by simulated BB84

On the trainer's path the OTP-XOR and the MAC of each exchange run fused in
one CUDA kernel (``repro_torch.kernels.otp_xor``). The secagg entries
(``tree_to_q32`` … ``secagg_mask_stream``) carry the mod-2^32 fixed-point
streams of dropout-tolerant secure aggregation.
"""
from repro_torch.security.errors import SecurityError
from repro_torch.security.fernet_lite import (
    TOKEN_OVERHEAD, InvalidToken, fernet_decrypt, fernet_decrypt_rows,
    fernet_encrypt, fernet_encrypt_rows,
)
from repro_torch.security.keys import (
    MASK_DOMAIN, QBER_ABORT, EdgeKey, KeyManager, canonical_edge,
    mac_key_mix, pairwise_mask_seed, round_seed_mix,
)
from repro_torch.security.mac import (
    P31, mac_verify, mac_verify_rows, poly_mac_rows, poly_mac_u32,
)
from repro_torch.security.otp import (
    decrypt_tree, decrypt_tree_rows, encrypt_flat_u32, encrypt_tree,
    encrypt_tree_rows,
    SECAGG_CLIP, SECAGG_FRAC_BITS, SECAGG_W_MAX, layout_rows, pad_layout,
    pad_u32, pad_u32_rows, q32_to_tree, secagg_mask_stream, sum_signed_pads,
    tree_pad_u32, tree_pad_u32_rows, tree_to_q32, tree_to_u32,
    tree_to_u32_rows, u32_to_tree, u32_to_tree_rows,
)

__all__ = [
    "encrypt_tree", "decrypt_tree", "encrypt_flat_u32", "pad_u32", "tree_to_u32", "u32_to_tree",
    "encrypt_tree_rows", "decrypt_tree_rows", "pad_u32_rows",
    "tree_to_u32_rows", "u32_to_tree_rows", "tree_pad_u32",
    "tree_pad_u32_rows", "pad_layout", "layout_rows",
    "tree_to_q32", "q32_to_tree", "sum_signed_pads", "secagg_mask_stream",
    "SECAGG_FRAC_BITS", "SECAGG_CLIP", "SECAGG_W_MAX",
    "poly_mac_u32", "mac_verify", "poly_mac_rows", "mac_verify_rows", "P31",
    "KeyManager", "EdgeKey", "canonical_edge", "mac_key_mix",
    "round_seed_mix", "pairwise_mask_seed", "MASK_DOMAIN", "QBER_ABORT",
    "SecurityError", "fernet_encrypt", "fernet_decrypt",
    "fernet_encrypt_rows", "fernet_decrypt_rows", "TOKEN_OVERHEAD",
    "InvalidToken",
]
