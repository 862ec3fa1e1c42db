"""Hand-written Hopper kernels of the port, one package per TPU kernel.

  statevec_gate — the resident and tiled single-qubit gate layers and
                  the single gate over batched statevectors (the VQC's
                  inner loop and its parameter-shift branches), in CUDA C++
  otp_xor       — the fused OTP-XOR + GF(2^31 - 1) MAC over every edge
                  stream of a secure-exchange stage, in CUDA C++
  swa_attention — sliding-window / causal flash attention of the LLM
                  decoder's prefill and training forward, in CUDA C++
  ssd_scan      — the Mamba-2 SSD chunked scan of the same paths, in
                  CUDA C++

Each package holds ``csrc/`` (the CUDA source), ``build.py`` (its ctypes
binding; ``kernels/build.py`` compiles with nvcc at first use),
``ref.py`` (the plain PyTorch version) and ``ops.py`` (the wrapper: kernel
on CUDA tensors, plain version on CPU tensors, launch count).

This package exports the JAX package's six names in its call forms. The
two gate ops take a complex state and (..., 2, 2) gates here and are
thin wrappers over the plane entries of ``statevec_gate.ops``, which take
(G, S, 2^nq) float32 planes and packed (G, ..., 8) gates. The JAX
wrappers' ``interpret``/``use_kernel`` switches have no counterpart: the
device of the tensors picks the kernel or its plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.otp_xor.ops import otp_xor_mac, otp_xor_mac_edges
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.statevec_gate import ops as _sv
from repro_torch.kernels.swa_attention.ops import swa_attention


def _planes(state: torch.Tensor) -> tuple:
    dim = state.shape[-1]
    return (state.real.to(torch.float32).reshape(1, -1, dim).contiguous(),
            state.imag.to(torch.float32).reshape(1, -1, dim).contiguous())


def apply_gate(state: torch.Tensor, gate: torch.Tensor,
               qubit: int) -> torch.Tensor:
    """One 2x2 gate on ``qubit`` of complex states (..., 2^nq), gate (2, 2)
    complex: ``statevector.apply_1q`` through the single-gate kernel (#3).
    Returns complex64 states of the input's shape."""
    re, im = _sv.apply_gate(*_planes(state), _sv.pack_gates(gate)[None],
                            qubit)
    return torch.complex(re, im).reshape(state.shape)


def apply_gate_layer(state: torch.Tensor, gates: torch.Tensor,
                     low_qubits: int = _sv.LOW_QUBITS,
                     group_qubits: int = _sv.GROUP_QUBITS,
                     group_tile: int = _sv.GROUP_TILE) -> torch.Tensor:
    """Gate q on qubit q for every qubit of complex states (..., 2^nq),
    gates (nq, 2, 2) complex (one layer of ``vqc.layer_gates``): the
    resident (#1) or tiled (#2) layer. Returns complex64 states of the
    input's shape; the tiling overrides exist for tests."""
    re, im = _sv.apply_gate_layer(*_planes(state),
                                  _sv.pack_gates(gates)[None], low_qubits,
                                  group_qubits, group_tile)
    return torch.complex(re, im).reshape(state.shape)


__all__ = ["otp_xor_mac", "otp_xor_mac_edges", "apply_gate",
           "apply_gate_layer", "swa_attention", "ssd_scan"]
