"""Plain PyTorch versions of the statevector gate kernels (planes
formulation).

The oracles the CUDA kernels are held against on the card and the CPU
path of the wrappers. ``adjoint_gate8`` and ``gate_grad`` are the math of
the single gate's backward (``ops._bwd``); ``layer_vjp_ref`` is the gate
layer's backward, pass by pass as the CUDA backward runs it. Gates are
packed as 8 float32 reals, [g00r, g00i, g01r, g01i, g10r, g10i, g11r,
g11i]. Every function is valid at any register size.
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


def layer_vjp_ref(state_re, state_im, gates8, cot_re, cot_im, passes=None,
                  need_state: bool = True, need_gate: bool = True):
    """The gate layer's backward, the algorithm of the CUDA backward.

    state planes (G, S, dim) and gates8 (G, nq, 8) are the layer's inputs,
    cot planes the cotangent at its output. ``passes`` splits the qubits
    into consecutive ranges (q0, m) (default: one pass). Each pass's input
    is the state with the earlier passes applied; the passes run last to
    first, and inside a pass gate q, last to first, pairs its own input
    (``gate_grad``) with the cotangent at its output, which then takes the
    adjoint gate. No gate is inverted. Returns ((cot_re, cot_im) at the
    layer's input or (None, None), gate cotangent (G, nq, 8) or None).
    """
    nq = gates8.shape[-2]
    passes = passes or [(0, nq)]
    inputs = [(state_re, state_im)]
    if need_gate:
        for q0, m in passes[:-1]:
            re, im = inputs[-1]
            for q in range(q0, q0 + m):
                re, im = apply_gate_planes_ref(re, im, gates8[..., q, :], q)
            inputs.append((re, im))
    grads = [None] * nq
    v_re, v_im = cot_re, cot_im
    for i in reversed(range(len(passes))):
        q0, m = passes[i]
        if need_gate:
            us = [inputs[i]]
            for q in range(q0, q0 + m - 1):
                us.append(apply_gate_planes_ref(*us[-1], gates8[..., q, :], q))
        for q in reversed(range(q0, q0 + m)):
            if need_gate:
                grads[q] = gate_grad(*us[q - q0], v_re, v_im, q)
            v_re, v_im = apply_gate_planes_ref(
                v_re, v_im, adjoint_gate8(gates8[..., q, :]), q)
    g8 = torch.stack(grads, dim=-2) if need_gate else None
    return ((v_re, v_im) if need_state else (None, None)), g8
