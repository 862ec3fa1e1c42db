"""Fused single-qubit gate layer: CUDA kernel, plain version, wrapper."""
from repro_torch.kernels.statevec_gate.ops import apply_gate_layer, pack_gates
from repro_torch.kernels.statevec_gate.ref import (
    apply_gate_planes_ref, apply_layer_planes_ref,
)

__all__ = ["apply_gate_layer", "pack_gates", "apply_gate_planes_ref",
           "apply_layer_planes_ref"]
