"""Statevector gate kernels: CUDA kernels, plain versions, wrappers."""
from repro_torch.kernels.statevec_gate.ops import (
    apply_1q, apply_gate, apply_gate_layer, layer_plan, pack_gates,
)
from repro_torch.kernels.statevec_gate.ref import (
    adjoint_gate8, apply_gate_planes_ref, apply_layer_planes_ref, gate_grad,
)

__all__ = ["apply_1q", "apply_gate", "apply_gate_layer", "layer_plan",
           "pack_gates", "adjoint_gate8", "apply_gate_planes_ref",
           "apply_layer_planes_ref", "gate_grad"]
