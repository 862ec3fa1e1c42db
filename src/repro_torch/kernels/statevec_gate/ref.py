"""Plain PyTorch versions of the statevector gate kernels (planes
formulation).

The oracles the CUDA kernels are held against on the card, the CPU path
of the wrappers, and the function whose autograd the layer's backward
replays (as ``repro.kernels.statevec_gate.ops._layer_bwd`` replays
``apply_layer_planes_ref``). ``adjoint_gate8`` and ``gate_grad`` are the
math of the single gate's backward (``ops._bwd``). Gates are packed as 8
float32 reals, [g00r, g00i, g01r, g01i, g10r, g10i, g11r, g11i]. Every
function is valid at any register size.
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


def adjoint_gate8(gate8):
    """Conjugate transpose in the 8-real packing: gate8 (..., 8)."""
    g00r, g00i, g01r, g01i, g10r, g10i, g11r, g11i = gate8.unbind(-1)
    return torch.stack([g00r, -g00i, g10r, -g10i, g01r, -g01i, g11r, -g11i],
                       dim=-1)


def gate_grad(state_re, state_im, cot_re, cot_im, qubit: int):
    """Cotangent of the 8 gate reals (the real-linear transpose of
    ``apply_gate_planes_ref``): planes (G, ..., dim) whose row g took gate
    g -> (G, 8), summed over every other axis and over the pairs."""
    G = state_re.shape[0]
    lo = 1 << qubit
    ar, ai, yr, yi = (x.reshape(G, -1, 2, lo)
                      for x in (state_re, state_im, cot_re, cot_im))

    def pair(i, j):
        # g_ij couples y_i with a_j:
        # gr_ij = sum(yr_i*ar_j + yi_i*ai_j); gi_ij = sum(-yr_i*ai_j + yi_i*ar_j)
        gr = (yr[:, :, i] * ar[:, :, j] + yi[:, :, i] * ai[:, :, j]).sum((1, 2))
        gi = (-yr[:, :, i] * ai[:, :, j] + yi[:, :, i] * ar[:, :, j]).sum((1, 2))
        return gr, gi

    return torch.stack([x for i in (0, 1) for j in (0, 1) for x in pair(i, j)],
                       dim=-1)
