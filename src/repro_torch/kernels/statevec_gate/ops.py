"""The fused gate layer as a differentiable op (port of ``ops.py:138-209``).

``apply_gate_layer(state_re, state_im, gates8)`` applies gate q to qubit
q for all nq qubits of one layer. On a CUDA tensor it launches the
hand-written kernel (``csrc/statevec_gate.cu``) and counts the launch in
``LAUNCHES``; on a CPU tensor it runs the plain version in ``ref.py``.
A CUDA tensor never falls back to the plain version: the kernel runs or
the call raises.

The backward replays the plain version under autograd, as the JAX
package's ``_layer_bwd`` replays ``apply_layer_planes_ref`` (the JAX
package has no backward kernel for the layer either).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.statevec_gate.ref import apply_layer_planes_ref

#: the largest register the resident kernel holds: 2^13 amplitudes, the
#: JAX kernel's MAX_FUSED_DIM (kernel.py:51)
MAX_QUBITS = 13

#: launches of the CUDA kernel in this process (the wrapper adds one per
#: launch; callers reset it to 0 to count the launches of one run)
LAUNCHES = 0


def pack_gates(gates: torch.Tensor) -> torch.Tensor:
    """(..., nq, 2, 2) complex64 -> (..., nq, 8) float32 packed reals."""
    g = torch.view_as_real(gates.to(torch.complex64).contiguous())
    return g.reshape(gates.shape[:-2] + (8,))


def _launch(state_re, state_im, gates8):
    global LAUNCHES
    from repro_torch.kernels.statevec_gate.build import library

    G, S, dim = state_re.shape
    nq = gates8.shape[1]
    out_re = torch.empty_like(state_re)
    out_im = torch.empty_like(state_im)
    err = library().statevec_gate_layer(
        state_re.data_ptr(), state_im.data_ptr(), gates8.data_ptr(),
        out_re.data_ptr(), out_im.data_ptr(), G, S, nq,
        torch.cuda.current_stream(state_re.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"statevec_gate_layer launch failed: CUDA error "
                           f"{err} at G={G}, S={S}, nq={nq}")
    LAUNCHES += 1
    return out_re, out_im


def _check(state_re, state_im, gates8):
    if state_re.dim() != 3 or state_re.shape != state_im.shape:
        raise ValueError(f"state planes must both be (G, S, 2^nq), got "
                         f"{tuple(state_re.shape)}, {tuple(state_im.shape)}")
    G, _, dim = state_re.shape
    nq = dim.bit_length() - 1
    if dim != 1 << nq or gates8.shape != (G, nq, 8):
        raise ValueError(f"gates8 must be (G={G}, nq={nq}, 8) for states "
                         f"of dim {dim}, got {tuple(gates8.shape)}")
    if nq > MAX_QUBITS:
        raise NotImplementedError(
            f"{nq} qubits exceed the resident layer kernel ({MAX_QUBITS}); "
            f"the tiled layer (TPU kernel #2, apply_layer_planes_tiled) is "
            f"not ported yet")
    for t in (state_re, state_im, gates8):
        if t.dtype != torch.float32 or t.device != state_re.device:
            raise ValueError("state planes and gates must be float32 on "
                             "one device")


class _GateLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, state_re, state_im, gates8):
        ctx.save_for_backward(state_re, state_im, gates8)
        if state_re.is_cuda:
            return _launch(state_re.contiguous(), state_im.contiguous(),
                           gates8.contiguous())
        return apply_layer_planes_ref(state_re, state_im, gates8)

    @staticmethod
    def backward(ctx, g_re, g_im):
        inputs = [x.detach().requires_grad_(need) for x, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [x for x in inputs if x.requires_grad]
        with torch.enable_grad():
            out = apply_layer_planes_ref(*inputs)
            grads = iter(torch.autograd.grad(out, wanted, (g_re, g_im)))
        return tuple(next(grads) if x.requires_grad else None
                     for x in inputs)


def apply_gate_layer(state_re: torch.Tensor, state_im: torch.Tensor,
                     gates8: torch.Tensor):
    """One fused gate layer: planes (G, S, 2^nq) f32, gates8 (G, nq, 8).

    Row (g, s) of the state takes gate set g. Returns the new planes.
    """
    _check(state_re, state_im, gates8)
    return _GateLayer.apply(state_re, state_im, gates8)
