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

  resident — a state of at most 2^13 amplitudes stays on chip for all
             nq stages (TPU kernel #1): in one warp's registers up to
             2^10, register-blocked in one block above;
  tiled    — a larger state takes one pass over memory per qubit group
             (TPU kernel #2): pass 0 fuses qubits [0, low_qubits) per tile
             (register-blocked), each later pass up to ``group_qubits``
             qubits;
  per-gate — a non-power-of-two ``group_tile`` cannot cover the lanes, so
             the layer runs kernel #3 once per qubit; it is logged as a
             warning and recorded in ``LAYER_DEBUG``.

``layer_plan`` exposes the choice, ``LAYER_DEBUG`` records the last call's.
The layer's backward is a kernel of its own at every plan (where the JAX
package's ``_layer_bwd`` replays ``apply_layer_planes_ref`` under
``jax.vjp``): ``bwd_passes`` splits the register into a low pass and
column passes, the pass inputs are recomputed with the forward bodies, and
the passes run in reverse, each pairing gate cotangents in registers; one
reduce launch sums the per-block partials in a fixed order. Its plain
version, and the CPU path, is ``ref.layer_vjp_ref`` on the same passes.

On a CUDA tensor each op launches its hand-written kernel
(``csrc/statevec_gate.cu``) and counts the launch: ``LAUNCHES`` (#1),
``TILED_LAUNCHES`` (#2, one per pass), ``GATE_LAUNCHES`` (#3) and
``LAYER_BWD_LAUNCHES`` (every launch of the layer's backward: its passes,
the recomputed pass inputs and the reduce). On a CPU tensor it runs the
plain version in ``ref.py``. A CUDA tensor never falls back to the plain
version: the kernel runs or the call raises.
"""
from __future__ import annotations

import ctypes
import logging

import torch

from repro_torch.kernels.statevec_gate.ref import (
    adjoint_gate8, apply_gate_planes_ref, apply_layer_planes_ref, gate_grad,
    layer_vjp_ref,
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
#: the backward's passes (``csrc`` kBwdLowQubits, kBwdColQubits): a low
#: pass of at most 8 qubits, one warp per 2^m chunk, then column passes of
#: at most 3 qubits, each thread holding a column's 2^gs amplitudes
BWD_LOW_QUBITS = 8
BWD_COL_QUBITS = 3
#: threads of a backward block (``csrc`` kThreads)
_BWD_THREADS = 256

#: launches of each CUDA kernel in this process (each wrapper adds one per
#: launch; callers reset them to 0 to count the launches of one run)
LAUNCHES = 0            # kernel #1, the resident layer
TILED_LAUNCHES = 0      # kernel #2, one per pass of a tiled layer
GATE_LAUNCHES = 0       # kernel #3, one gate on one qubit
LAYER_BWD_LAUNCHES = 0  # the layer backward: every launch it makes

#: the plan of the most recent ``apply_gate_layer`` call:
#: {"path": "resident" | "tiled" | "per-gate", "dim": int, "batch": (G, S)}
LAYER_DEBUG: dict = {}


def pack_gates(gates: torch.Tensor) -> torch.Tensor:
    """(..., 2, 2) complex64 -> (..., 8) float32 packed reals."""
    g = torch.view_as_real(gates.to(torch.complex64).contiguous())
    return g.reshape(gates.shape[:-2] + (8,))


_LIB = None


def _lib():
    """The kernel library, built and bound on first use."""
    global _LIB
    if _LIB is None:
        from repro_torch.kernels.statevec_gate.build import library
        _LIB = library()
    return _LIB


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_failed(err: int, what: str):
    raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _ready(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (the warp body's float4 accesses)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


# ---------------------------------------------------------------------------
# launches (CUDA tensors only)
# ---------------------------------------------------------------------------

def _launch_layer(state_re, state_im, gates8, n_groups: int,
                  states_per_group: int, nq: int, gate_stride: int):
    """Kernel #1's bodies, which are also pass 0 of #2: gate q on qubit q for
    q < nq over the planes viewed as (n_groups, states_per_group, 2^nq)."""
    out_re = torch.empty_like(state_re)
    out_im = torch.empty_like(state_im)
    err = _lib().statevec_gate_layer(
        state_re.data_ptr(), state_im.data_ptr(), gates8.data_ptr(),
        out_re.data_ptr(), out_im.data_ptr(), n_groups, states_per_group,
        nq, gate_stride, _stream(state_re))
    if err:
        _launch_failed(err, f"statevec_gate_layer (G={n_groups}, "
                            f"S={states_per_group}, nq={nq})")
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


def _group_pass(re, im, gates8, q0: int, gs: int, tc: int):
    """One group pass of kernel #2: qubits [q0, q0 + gs) over (2^gs, tc)
    tiles of the (hi, 2^gs, 2^q0) view."""
    G, S, dim = re.shape
    nq = dim.bit_length() - 1
    out_re, out_im = torch.empty_like(re), torch.empty_like(im)
    n_hi = G * S * (dim >> (q0 + gs))
    err = _lib().statevec_gate_group(
        re.data_ptr(), im.data_ptr(), gates8.data_ptr(),
        out_re.data_ptr(), out_im.data_ptr(), n_hi, n_hi // G, nq * 8,
        q0, gs, tc.bit_length() - 1, _stream(re))
    if err:
        _launch_failed(err, f"statevec_gate_group (G={G}, S={S}, nq={nq}, "
                            f"q0={q0}, gs={gs}, tc={tc})")
    return out_re, out_im


def _tiled(state_re, state_im, gates8, low_qubits, group_qubits, group_tile):
    """Kernel #2: pass 0 over 2^low-amplitude tiles (kernel #1's bodies),
    then one group pass per later qubit group."""
    global TILED_LAUNCHES
    G, S, dim = state_re.shape
    nq = dim.bit_length() - 1
    g0 = min(nq, low_qubits)
    passes = group_passes(nq, low_qubits, group_qubits, group_tile)
    if not 1 <= g0 <= MAX_QUBITS or any(tc < 1 for _, _, tc in passes):
        raise ValueError(f"the tiled layer takes 1 <= low_qubits <= "
                         f"{MAX_QUBITS} and group tiles of at most "
                         f"{GROUP_AMPS} amplitudes, got low_qubits="
                         f"{low_qubits}, group_qubits={group_qubits}")
    re, im = _launch_layer(state_re, state_im, gates8, G, S * (dim >> g0), g0,
                           nq * 8)
    TILED_LAUNCHES += 1
    for q0, gs, tc in passes:
        re, im = _group_pass(re, im, gates8, q0, gs, tc)
        TILED_LAUNCHES += 1
    return re, im


def _gate(state_re, state_im, gate8, qubit: int):
    """Kernel #3 on CUDA planes (G, S, 2^nq) with gate8 (G, 8)."""
    global GATE_LAUNCHES
    G, S, dim = state_re.shape
    nq = dim.bit_length() - 1
    out_re = torch.empty_like(state_re)
    out_im = torch.empty_like(state_im)
    err = _lib().statevec_gate_1q(
        state_re.data_ptr(), state_im.data_ptr(), gate8.data_ptr(),
        out_re.data_ptr(), out_im.data_ptr(), G, S, nq, qubit,
        _stream(state_re))
    if err:
        _launch_failed(err, f"statevec_gate_1q (G={G}, S={S}, nq={nq}, "
                            f"q={qubit})")
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


def bwd_passes(nq: int, low_qubits: int = LOW_QUBITS,
               group_qubits: int = GROUP_QUBITS) -> list:
    """The layer backward's passes as (q0, m): a low pass of qubits
    [0, min(nq, low_qubits, BWD_LOW_QUBITS)), then column passes of at most
    min(group_qubits, BWD_COL_QUBITS) qubits. The forward's tiling
    overrides shape the backward too, so the tests reach several passes at
    small registers."""
    m0 = min(nq, max(low_qubits, 1), BWD_LOW_QUBITS)
    step = min(max(group_qubits, 1), BWD_COL_QUBITS)
    passes = [(0, m0)]
    while passes[-1][0] + passes[-1][1] < nq:
        q0 = passes[-1][0] + passes[-1][1]
        passes.append((q0, min(nq - q0, step)))
    return passes


def _bwd_blocks_per_group(units: int, m: int, column: bool) -> int:
    """Blocks of one group in a backward pass: a block holds 256 units of
    a column pass, 256 >> lane bits of the low pass (``csrc``
    warp_lane_bits)."""
    per_block = _BWD_THREADS >> (0 if column else min(m - 1, 5))
    return -(-units // per_block)


def _layer_backward(state_re, state_im, gates8, cot_re, cot_im, passes,
                    need_state: bool, need_gate: bool):
    """The layer backward on the card (``ref.layer_vjp_ref``'s algorithm):
    recompute the input of every pass but the last, run the passes in
    reverse, then reduce the gate partials."""
    global LAYER_BWD_LAUNCHES
    lib = _lib()
    G, S, dim = state_re.shape
    nq = dim.bit_length() - 1
    stream = _stream(state_re)
    inputs = [(state_re, state_im)]
    if need_gate:
        for q0, m in passes[:-1]:
            re, im = inputs[-1]
            if q0 == 0:
                re, im = _launch_layer(re, im, gates8, G, S << (nq - m), m,
                                       nq * 8)
            else:
                re, im = _group_pass(re, im, gates8, q0, m, min(
                    1 << q0, GROUP_TILE, GROUP_AMPS >> m))
            LAYER_BWD_LAUNCHES += 1
            inputs.append((re, im))
    # every pass has S * 2^(nq - m) units a group (rows of the low pass,
    # columns of a column pass)
    blocks = [_bwd_blocks_per_group(S << (nq - m), m, q0 > 0)
              for q0, m in passes]
    offsets = [0]
    for (_, m), b in zip(passes, blocks):
        offsets.append(offsets[-1] + G * b * m * 8)
    partial = (torch.empty(offsets[-1], dtype=torch.float32,
                           device=state_re.device) if need_gate else None)
    v_re, v_im = cot_re, cot_im
    for i in reversed(range(len(passes))):
        q0, m = passes[i]
        u_re, u_im = inputs[i] if need_gate else (v_re, v_im)
        write = need_state or i > 0
        out_re = torch.empty_like(v_re) if write else None
        out_im = torch.empty_like(v_im) if write else None
        err = lib.statevec_gate_layer_bwd(
            u_re.data_ptr(), u_im.data_ptr(), gates8.data_ptr(),
            v_re.data_ptr(), v_im.data_ptr(),
            out_re.data_ptr() if write else None,
            out_im.data_ptr() if write else None,
            partial.data_ptr() + 4 * offsets[i] if need_gate else None,
            G, S << (nq - m), blocks[i], q0, m, nq * 8, int(q0 > 0),
            int(write), int(need_gate), stream)
        if err:
            _launch_failed(err, f"statevec_gate_layer_bwd (G={G}, S={S}, "
                                f"nq={nq}, q0={q0}, m={m})")
        LAYER_BWD_LAUNCHES += 1
        v_re, v_im = out_re, out_im
    g8 = None
    if need_gate:
        g8 = torch.empty_like(gates8)
        desc = [x for (q0, m), b, off in zip(passes, blocks, offsets)
                for x in (off, b, q0, m)]
        err = lib.statevec_gate_grad_reduce(
            partial.data_ptr(), g8.data_ptr(), G, nq, len(passes),
            (ctypes.c_longlong * len(desc))(*desc), stream)
        if err:
            _launch_failed(err, f"statevec_gate_grad_reduce (G={G}, "
                                f"nq={nq})")
        LAYER_BWD_LAUNCHES += 1
    return (v_re, v_im), g8


class _GateLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, state_re, state_im, gates8, plan, tiling):
        ctx.save_for_backward(state_re, state_im, gates8)
        ctx.tiling = tiling
        if not state_re.is_cuda:
            return apply_layer_planes_ref(state_re, state_im, gates8)
        state_re, state_im, gates8 = (_ready(state_re), _ready(state_im),
                                      gates8.contiguous())
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
        state_re, state_im, gates8 = ctx.saved_tensors
        need_re, need_im, need_gate = ctx.needs_input_grad[:3]
        low_qubits, group_qubits, _ = ctx.tiling
        passes = bwd_passes(gates8.shape[1], low_qubits, group_qubits)
        args = (need_re or need_im, need_gate)
        if state_re.is_cuda:
            (c_re, c_im), g8 = _layer_backward(
                _ready(state_re), _ready(state_im), gates8.contiguous(),
                _ready(g_re), _ready(g_im), passes, *args)
        else:
            (c_re, c_im), g8 = layer_vjp_ref(state_re, state_im, gates8,
                                             g_re, g_im, passes, *args)
        return (c_re if need_re else None, c_im if need_im else None,
                g8, None, None)


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
