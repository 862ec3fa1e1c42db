"""Quantum substrate of the port: statevector simulator, the VQC, BB84 QKD
and teleportation."""
from repro_torch.quantum.qkd import bb84_keygen, derive_pad_seed, qber_estimate
from repro_torch.quantum.statevector import (
    H, X, Y, Z, apply_1q, apply_1q_layer, apply_cnot, apply_controlled_1q,
    apply_cz, apply_h, apply_ry, apply_rz, apply_u3, expect_z, expect_z_all,
    group_1q_gates, init_state, probs, ring_cz_signs, ry_gate, rz_gate,
    sample_measure, u3_gate, zexp_signs,
)
from repro_torch.quantum.teleport import (
    fidelity, teleport_params, teleport_state,
)
from repro_torch.quantum.vqc import (
    encoding_gates, layer_gates, parameter_shift_grad,
    parameter_shift_grad_serial, vqc_accuracy, vqc_api, vqc_init,
    vqc_logits, vqc_loss,
)

__all__ = ["init_state", "apply_1q", "apply_1q_layer", "apply_cz",
           "apply_cnot", "apply_controlled_1q", "apply_h", "apply_ry",
           "apply_rz", "apply_u3", "expect_z", "expect_z_all", "probs",
           "ring_cz_signs", "sample_measure", "zexp_signs", "group_1q_gates",
           "H", "X", "Y", "Z", "ry_gate", "rz_gate", "u3_gate",
           "vqc_init", "vqc_logits", "vqc_loss", "vqc_api", "vqc_accuracy",
           "layer_gates", "encoding_gates", "parameter_shift_grad",
           "parameter_shift_grad_serial", "bb84_keygen", "derive_pad_seed",
           "qber_estimate", "teleport_state", "teleport_params", "fidelity"]
