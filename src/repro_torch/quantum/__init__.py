"""Quantum substrate of the port: statevector simulator and the VQC."""
from repro_torch.quantum.statevector import (
    apply_1q, apply_1q_layer, apply_cz, expect_z, expect_z_all,
    group_1q_gates, init_state, probs, ring_cz_signs, ry_gate, rz_gate,
    zexp_signs,
)
from repro_torch.quantum.teleport import teleport_params
from repro_torch.quantum.vqc import (
    encoding_gates, layer_gates, parameter_shift_grad,
    parameter_shift_grad_serial, vqc_accuracy, vqc_api, vqc_init,
    vqc_logits, vqc_loss,
)

__all__ = ["apply_1q", "apply_1q_layer", "apply_cz", "expect_z",
           "expect_z_all", "group_1q_gates", "init_state", "probs",
           "ring_cz_signs", "ry_gate", "rz_gate", "zexp_signs",
           "teleport_params", "encoding_gates", "layer_gates",
           "parameter_shift_grad", "parameter_shift_grad_serial",
           "vqc_accuracy", "vqc_api", "vqc_init", "vqc_logits", "vqc_loss"]
