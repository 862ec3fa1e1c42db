"""Plain PyTorch version of the fused gate layer (planes formulation).

The oracle the CUDA kernel is held against on the card, the CPU path of
the wrapper, and the function whose autograd the layer's backward
replays (as ``repro.kernels.statevec_gate.ops._layer_bwd`` replays
``apply_layer_planes_ref``). Gates are packed as 8 float32 reals,
[g00r, g00i, g01r, g01i, g10r, g10i, g11r, g11i].
"""
from __future__ import annotations

import torch


def apply_gate_planes_ref(state_re, state_im, gate8, qubit: int):
    """One 2x2 gate on ``qubit``: state planes (..., dim); gate8 (..., 8)
    whose leading dims broadcast against the state's leading dims."""
    dim = state_re.shape[-1]
    lead = state_re.shape[:-1]
    lo = 1 << qubit
    xr = state_re.reshape(lead + (dim // (2 * lo), 2, lo))
    xi = state_im.reshape(lead + (dim // (2 * lo), 2, lo))
    a0r, a1r = xr[..., 0, :], xr[..., 1, :]
    a0i, a1i = xi[..., 0, :], xi[..., 1, :]
    pad = (1,) * (a0r.dim() - gate8.dim() + 1)
    g00r, g00i, g01r, g01i, g10r, g10i, g11r, g11i = [
        gate8[..., i].reshape(gate8.shape[:-1] + pad) for i in range(8)]
    y0r = g00r * a0r - g00i * a0i + g01r * a1r - g01i * a1i
    y0i = g00r * a0i + g00i * a0r + g01r * a1i + g01i * a1r
    y1r = g10r * a0r - g10i * a0i + g11r * a1r - g11i * a1i
    y1i = g10r * a0i + g10i * a0r + g11r * a1i + g11i * a1r
    outr = torch.stack([y0r, y1r], dim=-2).reshape(lead + (dim,))
    outi = torch.stack([y0i, y1i], dim=-2).reshape(lead + (dim,))
    return outr, outi


def apply_layer_planes_ref(state_re, state_im, gates8):
    """Gate q on qubit q, sequentially, for all nq qubits.

    state planes (G, S, dim) with row (g, s) taking gate set g; gates8
    (G, nq, 8). The JAX signature (nq, 8) is G = 1.
    """
    for q in range(gates8.shape[-2]):
        state_re, state_im = apply_gate_planes_ref(
            state_re, state_im, gates8[..., q, :], q)
    return state_re, state_im
