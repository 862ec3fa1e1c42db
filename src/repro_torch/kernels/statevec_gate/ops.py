"""The statevector gate kernels as differentiable ops (port of
``repro.kernels.statevec_gate.ops``).

``apply_gate(state_re, state_im, gate8, qubit)`` applies one 2x2 gate to
one qubit (TPU kernel #3). Its backward applies the adjoint gate with the
same kernel and computes the gate's cotangent in plain torch, as the JAX
package's ``_bwd`` does. ``apply_1q(state, gate, qubit)`` is the same op on
complex states, with the signature of ``statevector.apply_1q``: the
VQC's per-gate hook.

``apply_gate_layer(state_re, state_im, gates8)`` applies gate q to qubit q
for all nq qubits of one layer and picks a plan by state size, as the JAX
package's ``apply_gate_layer`` does:

  resident — a state of at most 2^13 amplitudes stays in shared memory
             for all nq stages (TPU kernel #1);
  tiled    — a larger state takes one pass over memory per qubit group
             (TPU kernel #2): pass 0 fuses qubits [0, low_qubits) per tile,
             each later pass up to ``group_qubits`` qubits;
  per-gate — a non-power-of-two ``group_tile`` cannot cover the lanes, so
             the layer runs kernel #3 once per qubit; it is logged as a
             warning and recorded in ``LAYER_DEBUG``.

``layer_plan`` exposes the choice, ``LAYER_DEBUG`` records the last call's.
The layer's backward replays the plain version under autograd at every
plan, as the JAX package's ``_layer_bwd`` replays
``apply_layer_planes_ref``.

On a CUDA tensor each op launches its hand-written kernel
(``csrc/statevec_gate.cu``) and counts the launch: ``LAUNCHES`` (#1),
``TILED_LAUNCHES`` (#2, one per pass) and ``GATE_LAUNCHES`` (#3). On a CPU
tensor it runs the plain version in ``ref.py``. A CUDA tensor never falls
back to the plain version: the kernel runs or the call raises.
"""
from __future__ import annotations

import logging

import torch

from repro_torch.kernels.statevec_gate.ref import (
    adjoint_gate8, apply_gate_planes_ref, apply_layer_planes_ref, gate_grad,
)

logger = logging.getLogger(__name__)

#: the largest register the resident kernel holds: 2^13 amplitudes, the
#: JAX kernel's MAX_FUSED_DIM (kernel.py:51)
MAX_QUBITS = 13
MAX_FUSED_DIM = 1 << MAX_QUBITS
#: the tiled plan's defaults (JAX kernel.py:55-57): pass 0 fuses qubits
#: [0, LOW_QUBITS); each later pass fuses up to GROUP_QUBITS qubits over
#: tiles of at most GROUP_TILE lanes
LOW_QUBITS = 13
GROUP_QUBITS = 7
GROUP_TILE = 512
#: amplitudes of one group-pass tile on the card (64 KB for both planes):
#: a tile has at most 2^13 / 2^gs lanes (``csrc`` kGroupAmps)
GROUP_AMPS = 8192

#: launches of each CUDA kernel in this process (each wrapper adds one per
#: launch; callers reset them to 0 to count the launches of one run)
LAUNCHES = 0            # kernel #1, the resident layer
TILED_LAUNCHES = 0      # kernel #2, one per pass of a tiled layer
GATE_LAUNCHES = 0       # kernel #3, one gate on one qubit

#: the plan of the most recent ``apply_gate_layer`` call:
#: {"path": "resident" | "tiled" | "per-gate", "dim": int, "batch": (G, S)}
LAYER_DEBUG: dict = {}


def pack_gates(gates: torch.Tensor) -> torch.Tensor:
    """(..., 2, 2) complex64 -> (..., 8) float32 packed reals."""
    g = torch.view_as_real(gates.to(torch.complex64).contiguous())
    return g.reshape(gates.shape[:-2] + (8,))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


# ---------------------------------------------------------------------------
# launches (CUDA tensors only)
# ---------------------------------------------------------------------------

def _launch_layer(state_re, state_im, gates8, n_groups: int,
                  states_per_group: int, nq: int, gate_stride: int):
    """Kernel #1's body: gate q on qubit q for q < nq over the planes viewed
    as (n_groups, states_per_group, 2^nq)."""
    from repro_torch.kernels.statevec_gate.build import library
    out_re = torch.empty_like(state_re)
    out_im = torch.empty_like(state_im)
    _raise_on(library().statevec_gate_layer(
        state_re.data_ptr(), state_im.data_ptr(), gates8.data_ptr(),
        out_re.data_ptr(), out_im.data_ptr(), n_groups, states_per_group,
        nq, gate_stride, _stream(state_re)),
        f"statevec_gate_layer (G={n_groups}, S={states_per_group}, nq={nq})")
    return out_re, out_im


def _resident(state_re, state_im, gates8):
    global LAUNCHES
    G, S, dim = state_re.shape
    nq = dim.bit_length() - 1
    out = _launch_layer(state_re, state_im, gates8, G, S, nq, nq * 8)
    LAUNCHES += 1
    return out


def group_passes(nq: int, low_qubits: int = LOW_QUBITS,
                 group_qubits: int = GROUP_QUBITS,
                 group_tile: int = GROUP_TILE) -> list:
    """The tiled plan's passes after pass 0, as (q0, gs, tc): qubits
    [q0, q0 + gs) over tiles of tc lanes. On the card a tile holds at most
    GROUP_AMPS amplitudes, so ``group_tile`` is an upper bound on tc."""
    passes = []
    q0 = min(nq, low_qubits)
    while q0 < nq:
        gs = min(nq - q0, group_qubits)
        passes.append((q0, gs, min(1 << q0, group_tile, GROUP_AMPS >> gs)))
        q0 += gs
    return passes


def _tiled(state_re, state_im, gates8, low_qubits, group_qubits, group_tile):
    """Kernel #2: pass 0 is kernel #1's body over 2^low-amplitude tiles,
    then one group pass per later qubit group."""
    global TILED_LAUNCHES
    from repro_torch.kernels.statevec_gate.build import library
    G, S, dim = state_re.shape
    nq = dim.bit_length() - 1
    g0 = min(nq, low_qubits)
    passes = group_passes(nq, low_qubits, group_qubits, group_tile)
    if not 1 <= g0 <= MAX_QUBITS or any(tc < 1 for _, _, tc in passes):
        raise ValueError(f"the tiled layer takes 1 <= low_qubits <= "
                         f"{MAX_QUBITS} and group tiles of at most "
                         f"{GROUP_AMPS} amplitudes, got low_qubits="
                         f"{low_qubits}, group_qubits={group_qubits}")
    re, im = _launch_layer(state_re, state_im, gates8, G, S * (dim >> g0),
                           g0, nq * 8)
    TILED_LAUNCHES += 1
    for q0, gs, tc in passes:
        out_re, out_im = torch.empty_like(re), torch.empty_like(im)
        n_hi = G * S * (dim >> (q0 + gs))
        _raise_on(library().statevec_gate_group(
            re.data_ptr(), im.data_ptr(), gates8.data_ptr(),
            out_re.data_ptr(), out_im.data_ptr(), n_hi, n_hi // G, nq * 8,
            q0, gs, tc.bit_length() - 1, _stream(re)),
            f"statevec_gate_group (G={G}, S={S}, nq={nq}, q0={q0}, gs={gs}, "
            f"tc={tc})")
        TILED_LAUNCHES += 1
        re, im = out_re, out_im
    return re, im


def _gate(state_re, state_im, gate8, qubit: int):
    """Kernel #3 on CUDA planes (G, S, 2^nq) with gate8 (G, 8)."""
    global GATE_LAUNCHES
    from repro_torch.kernels.statevec_gate.build import library
    G, S, dim = state_re.shape
    nq = dim.bit_length() - 1
    out_re = torch.empty_like(state_re)
    out_im = torch.empty_like(state_im)
    _raise_on(library().statevec_gate_1q(
        state_re.data_ptr(), state_im.data_ptr(), gate8.data_ptr(),
        out_re.data_ptr(), out_im.data_ptr(), G, S, nq, qubit,
        _stream(state_re)),
        f"statevec_gate_1q (G={G}, S={S}, nq={nq}, q={qubit})")
    GATE_LAUNCHES += 1
    return out_re, out_im


def _check(state_re, state_im, gates, gate_dims: tuple, what: str):
    if state_re.dim() != 3 or state_re.shape != state_im.shape:
        raise ValueError(f"state planes must both be (G, S, 2^nq), got "
                         f"{tuple(state_re.shape)}, {tuple(state_im.shape)}")
    G, _, dim = state_re.shape
    nq = dim.bit_length() - 1
    want = (G,) + tuple(nq if d == "nq" else d for d in gate_dims)
    if dim != 1 << nq or gates.shape != want:
        raise ValueError(f"{what} must be {want} for states of dim {dim}, "
                         f"got {tuple(gates.shape)}")
    for t in (state_re, state_im, gates):
        if t.dtype != torch.float32 or t.device != state_re.device:
            raise ValueError("state planes and gates must be float32 on "
                             "one device")


def _contig(*ts):
    return [t.contiguous() for t in ts]


# ---------------------------------------------------------------------------
# one gate on one qubit (kernel #3)
# ---------------------------------------------------------------------------

def _gate_planes(state_re, state_im, gate8, qubit: int):
    if state_re.is_cuda:
        return _gate(*_contig(state_re, state_im, gate8), qubit)
    return apply_gate_planes_ref(state_re, state_im, gate8, qubit)


class _Gate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, state_re, state_im, gate8, qubit):
        ctx.save_for_backward(state_re, state_im, gate8)
        ctx.qubit = qubit
        return _gate_planes(state_re, state_im, gate8, qubit)

    @staticmethod
    def backward(ctx, g_re, g_im):
        state_re, state_im, gate8 = ctx.saved_tensors
        need_re, need_im, need_gate, _ = ctx.needs_input_grad
        a_re = a_im = g8 = None
        if need_re or need_im:
            # the butterfly is real-linear: its transpose is the adjoint gate
            a_re, a_im = _gate_planes(g_re, g_im, adjoint_gate8(gate8),
                                      ctx.qubit)
        if need_gate:
            g8 = gate_grad(state_re, state_im, g_re, g_im, ctx.qubit)
        return a_re, a_im, g8, None


def apply_gate(state_re: torch.Tensor, state_im: torch.Tensor,
               gate8: torch.Tensor, qubit: int):
    """One 2x2 gate on ``qubit``: planes (G, S, 2^nq) f32, gate8 (G, 8).

    Row (g, s) of the state takes gate g. Returns the new planes.
    """
    _check(state_re, state_im, gate8, (8,), "gate8")
    if not 0 <= qubit < state_re.shape[-1].bit_length() - 1:
        raise ValueError(f"qubit {qubit} outside the register")
    return _Gate.apply(state_re, state_im, gate8, qubit)


def apply_1q(state: torch.Tensor, gate: torch.Tensor,
             qubit: int) -> torch.Tensor:
    """``statevector.apply_1q`` through ``apply_gate``: complex state
    (..., 2^n), gate (..., 2, 2) broadcasting against the state's batch
    dims. Each state row takes its own gate (G = rows, S = 1)."""
    lead, dim = state.shape[:-1], state.shape[-1]
    g8 = pack_gates(gate).expand(lead + (8,)).reshape(-1, 8)
    re, im = apply_gate(state.real.reshape(-1, 1, dim),
                        state.imag.reshape(-1, 1, dim), g8, qubit)
    return torch.complex(re, im).reshape(state.shape)


# ---------------------------------------------------------------------------
# the gate layer (kernels #1 and #2; kernel #3 on the per-gate plan)
# ---------------------------------------------------------------------------

def layer_plan(dim: int, low_qubits: int = LOW_QUBITS,
               group_tile: int = GROUP_TILE) -> str:
    """Which plan ``apply_gate_layer`` takes for a 2^nq state (the JAX
    package's ``layer_plan`` with its kernel on)."""
    if dim <= MAX_FUSED_DIM and dim.bit_length() - 1 <= low_qubits:
        return "resident"
    # every per-pass extent is a power of two, so the tiles cover the
    # state exactly iff the tile override is one too
    if group_tile > 0 and (group_tile & (group_tile - 1)) == 0:
        return "tiled"
    return "per-gate"


class _GateLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, state_re, state_im, gates8, plan, tiling):
        ctx.save_for_backward(state_re, state_im, gates8)
        if not state_re.is_cuda:
            return apply_layer_planes_ref(state_re, state_im, gates8)
        state_re, state_im, gates8 = _contig(state_re, state_im, gates8)
        if plan == "resident":
            return _resident(state_re, state_im, gates8)
        if plan == "tiled":
            return _tiled(state_re, state_im, gates8, *tiling)
        for q in range(gates8.shape[1]):
            state_re, state_im = _gate(state_re, state_im,
                                       gates8[:, q].contiguous(), q)
        return state_re, state_im

    @staticmethod
    def backward(ctx, g_re, g_im):
        inputs = [x.detach().requires_grad_(need) for x, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [x for x in inputs if x.requires_grad]
        with torch.enable_grad():
            out = apply_layer_planes_ref(*inputs)
            grads = iter(torch.autograd.grad(out, wanted, (g_re, g_im)))
        return tuple(next(grads) if x.requires_grad else None
                     for x in inputs) + (None, None)


def apply_gate_layer(state_re: torch.Tensor, state_im: torch.Tensor,
                     gates8: torch.Tensor, low_qubits: int = LOW_QUBITS,
                     group_qubits: int = GROUP_QUBITS,
                     group_tile: int = GROUP_TILE):
    """One gate layer: planes (G, S, 2^nq) f32, gates8 (G, nq, 8).

    Row (g, s) of the state takes gate set g. Returns the new planes. The
    tiling overrides exist for tests; the defaults are the production plan.
    """
    _check(state_re, state_im, gates8, ("nq", 8), "gates8")
    G, S, dim = state_re.shape
    plan = layer_plan(dim, low_qubits, group_tile)
    LAYER_DEBUG.update(path=plan, dim=dim, batch=(G, S))
    if plan == "per-gate":
        logger.warning(
            "apply_gate_layer: tiled fused path unavailable for dim=%d "
            "(low_qubits=%d, group_tile=%d) — degrading to %d per-gate "
            "kernel sweeps", dim, low_qubits, group_tile, gates8.shape[1])
    return _GateLayer.apply(state_re, state_im, gates8, plan,
                            (low_qubits, group_qubits, group_tile))
