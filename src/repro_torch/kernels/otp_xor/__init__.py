"""Fused OTP-XOR + GF(2^31 - 1) MAC: CUDA kernel, plain versions, wrappers."""
from repro_torch.kernels.otp_xor.ops import (
    otp_xor_mac, otp_xor_mac_edges, otp_xor_mac_rows,
    otp_xor_mac_rows_seeded, otp_xor_mac_stream, otp_xor_mac_stream_seeded,
)
from repro_torch.kernels.otp_xor.ref import (
    as_storage, as_words, layout_pads, otp_xor_mac_blocks_ref,
    otp_xor_mac_edge_blocks_ref, otp_xor_mac_ref, otp_xor_mac_rows_ref,
    otp_xor_mac_rows_seeded_ref,
)

__all__ = ["otp_xor_mac", "otp_xor_mac_edges", "otp_xor_mac_rows",
           "otp_xor_mac_stream", "otp_xor_mac_rows_seeded",
           "otp_xor_mac_stream_seeded", "as_storage", "as_words",
           "layout_pads", "otp_xor_mac_blocks_ref",
           "otp_xor_mac_edge_blocks_ref", "otp_xor_mac_ref",
           "otp_xor_mac_rows_ref",
           "otp_xor_mac_rows_seeded_ref"]
