"""RoundPlan: the trace → schedule compiler (port of ``repro.core.plan``).

A ``ConstellationTrace`` + ``SatQFLConfig`` compiles ONCE into dense
per-round numpy arrays — roles S_p(t), the secondary→primary assignment,
the participation mask P_i(t), hops and latency, window waits, group
sizes, FedAvg weights, and the EdgeSchedule's per-stage CSR of every
exchange a round performs. The trainer reads groups, weights and stages
from the plan instead of re-deriving them inside the round loop.

This slice compiles plans for modes ``qfl`` and ``sim`` under
``security="none"`` with every fault rate at 0, i.e. the JAX package's
``compile_round_plan(..., with_seeds=False)`` without a key registry:
``seeds`` is all zeros, the EdgeSchedule carries no key material, and
there is no staleness or fault schedule. Other configurations raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.constellation.topology import (
    ConstellationTrace, isl_routes_batched, pairwise_distances, round_steps,
)
from repro_torch.core.flconfig import SatQFLConfig

GROUND = -1    # edge endpoint id for the ground station ("gs")


def canonical_edge(edge: tuple) -> tuple:
    """Edges are undirected; endpoints may be ints (sats) or strings.
    (A copy of ``repro.security.keys.canonical_edge``.)"""
    return tuple(sorted(edge, key=str))


@dataclass(frozen=True)
class EdgeSchedule:
    """Every exchange of every round, stacked over an edge axis.

    Dense ``(R, E_max)`` arrays laid out stage-major within each round (a
    stage = one batched dispatch: the ISL uplinks of a ``sim`` round, or
    the feeder uplinks); ``ptr`` bounds each (round, stage) CSR-style and
    the tail past ``ptr[r, -1]`` is padding (``mask`` False).
    """
    n_stages: np.ndarray      # (R,) int — dispatch stages per round
    ptr: np.ndarray           # (R, S_max + 1) int — CSR offsets per stage
    src: np.ndarray           # (R, E_max) int — sender satellite
    dst: np.ndarray           # (R, E_max) int — receiver; GROUND = station
    link: np.ndarray          # (R, E_max) uint8 — 0 ISL, 1 feeder
    conc: np.ndarray          # (R, E_max) int — ISL-aperture concurrency
    mask: np.ndarray          # (R, E_max) bool — valid edge
    first: np.ndarray         # (R, E_max) bool — first planned use of the edge
    born: np.ndarray          # (R, E_max) int — round the payload was trained

    def stage_bounds(self, r: int, stage: int) -> tuple[int, int]:
        return int(self.ptr[r, stage]), int(self.ptr[r, stage + 1])

    def edge_tuple(self, r: int, j: int) -> tuple:
        a = int(self.src[r, j])
        b = "gs" if int(self.dst[r, j]) == GROUND else int(self.dst[r, j])
        return canonical_edge((a, b))


@dataclass(frozen=True)
class RoundPlan:
    """Dense per-round schedule. Shapes: R = n_rounds, N = n_sats."""
    n_rounds: int
    n_sats: int
    step_s: float                 # trace sampling interval
    t_idx: np.ndarray             # (R,) int — trace step of each round
    primary_mask: np.ndarray      # (R, N) bool — S_p(t): sees a ground station
    assignment: np.ndarray        # (R, N) int — secondary → its primary;
                                  #   primaries map to themselves; -1 = unreachable
    part_mask: np.ndarray         # (R, N) float32 — P_i(t) within (H_max, L_max)
    hops: np.ndarray              # (R, N) float — ISL hops to a primary (inf = none)
    latency_s: np.ndarray         # (R, N) float — accumulated ISL latency
    window_wait_s: np.ndarray     # (R, N) float — seconds until the sat↔main ISL
                                  #   window opens (0 = open now, inf = never)
    group_size: np.ndarray        # (R, N) int — secondaries uploading to this
                                  #   sat's main (the ISL concurrency divisor)
    seeds: np.ndarray             # (R, N) uint32 — pad seeds (0: no security)
    weights: np.ndarray           # (N,) float32 — FedAvg aggregation weights w_i
    edges: EdgeSchedule | None = None

    def groups(self, r: int) -> dict[int, list[int]]:
        """{main: [secondaries]} at round r (the paper's {SecSat} grouping)."""
        return _groups_of(self.assignment[r], self.primary_mask[r])

    def unreachable(self, r: int) -> list[int]:
        return [int(s) for s in np.where(self.assignment[r] < 0)[0]]

    def participants(self, r: int) -> int:
        return int(self.part_mask[r].sum())


def _nearest_primary_assignment(pos, isl, prim):
    """Nearest ISL-visible primary per secondary: pos (R, N, 3), isl
    (R, N, N), prim (R, N) -> (R, N) int (primaries → self, -1 none)."""
    R, N = prim.shape
    cand = isl & prim[:, None, :]
    nearest = np.where(cand, pairwise_distances(pos), np.inf).argmin(axis=2)
    reachable = cand.any(axis=2)
    idx = np.broadcast_to(np.arange(N), (R, N))
    return np.where(prim, idx,
                    np.where(reachable, nearest, -1)).astype(np.int64)


def _window_waits(trace: ConstellationTrace, t_idx, assignment, prim):
    """Seconds from each round's step until the (sat, main) ISL opens."""
    R, N = assignment.shape
    step = (float(trace.times_s[1] - trace.times_s[0])
            if trace.n_steps > 1 else 0.0)
    waits = np.zeros((R, N))
    sat_idx = np.arange(N)
    for r in range(R):
        t = int(t_idx[r])
        main = np.clip(assignment[r], 0, None)
        series = trace.ss_access[sat_idx, main, t:]
        w = np.where(series.any(axis=1), series.argmax(axis=1) * step, np.inf)
        waits[r] = np.where(prim[r], 0.0,
                            np.where(assignment[r] >= 0, w, np.inf))
    return waits


def _groups_of(assignment_r: np.ndarray, prim_r: np.ndarray):
    out: dict[int, list[int]] = {int(p): [] for p in np.where(prim_r)[0]}
    for s in np.where(~prim_r & (assignment_r >= 0))[0]:
        out[int(assignment_r[s])].append(int(s))
    return out


def _round_stages(fl: SatQFLConfig, assignment_r, prim_r, n_sats: int):
    """Edge list (src, dst, link, conc) of each dispatch stage of one
    round, in the order the trainer walks it: qfl = one feeder stage;
    sim = ISL uplinks, then the mains' feeder uplinks."""
    if fl.mode == "qfl":
        return [[(s, GROUND, 1, 1) for s in range(n_sats)]]
    groups = _groups_of(assignment_r, prim_r)
    return [[(s, m, 0, max(len(groups[m]), 1))
             for m in groups for s in groups[m]],
            [(m, GROUND, 1, 1) for m in groups]]


def _edge_schedule(fl: SatQFLConfig, assignment, prim) -> EdgeSchedule:
    """Compile the per-round exchange plane (see EdgeSchedule)."""
    R, N = assignment.shape
    per_round = [_round_stages(fl, assignment[r], prim[r], N)
                 for r in range(R)]
    S_max = max(len(st) for st in per_round)
    E_max = max(max(sum(len(s) for s in st) for st in per_round), 1)
    ptr = np.zeros((R, S_max + 1), np.int64)
    src = np.zeros((R, E_max), np.int64)
    dst = np.full((R, E_max), GROUND, np.int64)
    link = np.zeros((R, E_max), np.uint8)
    conc = np.ones((R, E_max), np.int64)
    mask = np.zeros((R, E_max), bool)
    first = np.zeros((R, E_max), bool)
    born = np.zeros((R, E_max), np.int64)
    seen: set = set()
    for r, stages in enumerate(per_round):
        j = 0
        for si, stage in enumerate(stages):
            for (a, b, lk, c) in stage:
                e = canonical_edge((a, "gs" if b == GROUND else b))
                src[r, j], dst[r, j] = a, b
                link[r, j], conc[r, j], mask[r, j] = lk, c, True
                born[r, j] = r
                if e not in seen:
                    seen.add(e)
                    first[r, j] = True
                j += 1
            ptr[r, si + 1] = j
        ptr[r, len(stages):] = j
    return EdgeSchedule(n_stages=np.asarray([len(st) for st in per_round]),
                        ptr=ptr, src=src, dst=dst, link=link, conc=conc,
                        mask=mask, first=first, born=born)


def check_supported(fl: SatQFLConfig):
    """Raise ``NotImplementedError`` for what this slice does not run."""
    if fl.mode not in ("qfl", "sim"):
        raise NotImplementedError(
            f"mode={fl.mode!r} is not ported yet (ROADMAP queue 1, item 7: "
            f"seq + async v2 + secagg)")
    if fl.security != "none":
        raise NotImplementedError(
            f"security={fl.security!r} is not ported yet (ROADMAP queue 1, "
            f"item 6: the security plane)")
    if fl.agg_security != "none":
        raise NotImplementedError(
            "agg_security='secagg' is not ported yet (ROADMAP queue 1, "
            "item 7: seq + async v2 + secagg)")
    if (fl.link_flap_rate > 0 or fl.crash_rate > 0 or fl.straggler_rate > 0
            or fl.corrupt_rate > 0):
        raise NotImplementedError(
            "fault injection is not ported yet (ROADMAP queue 1, item 8: "
            "fault plane + checkpoints)")


def compile_round_plan(trace: ConstellationTrace, fl: SatQFLConfig, *,
                       sample_counts=None,
                       round_stride: int | None = None) -> RoundPlan:
    """Compile trace + config into a :class:`RoundPlan`.

    sample_counts — per-satellite dataset sizes for FedAvg weighting
    (used when ``fl.weight_by_samples``).
    """
    check_supported(fl)
    t_idx = round_steps(trace, fl.n_rounds, round_stride)
    R, N = fl.n_rounds, trace.n_sats

    prim = trace.sg_access[:, :, t_idx].any(axis=1).T            # (R, N)
    pos = trace.sat_pos[:, t_idx].transpose(1, 0, 2)             # (R, N, 3)
    isl = trace.ss_access[:, :, t_idx].transpose(2, 0, 1)        # (R, N, N)
    assignment = _nearest_primary_assignment(pos, isl, prim)
    part, hops, lat = isl_routes_batched(trace, t_idx, fl.h_max, fl.l_max_s)

    # group sizes: secondaries per main, broadcast to every group member
    sec_of = np.where(prim, -1, assignment)
    counts = np.zeros((R, N), np.int64)
    for r in range(R):
        counts[r] = np.bincount(sec_of[r][sec_of[r] >= 0], minlength=N)
    group_size = np.where(assignment >= 0, np.take_along_axis(
        counts, np.clip(assignment, 0, None), axis=1), 0)

    if fl.weight_by_samples and sample_counts is not None:
        weights = np.asarray(sample_counts, np.float32)
        if weights.shape != (N,):
            raise ValueError("one sample count per satellite")
    else:
        weights = np.ones((N,), np.float32)

    return RoundPlan(
        n_rounds=R, n_sats=N,
        step_s=(float(trace.times_s[1] - trace.times_s[0])
                if trace.n_steps > 1 else 0.0),
        t_idx=np.asarray(t_idx), primary_mask=prim, assignment=assignment,
        part_mask=part.astype(np.float32), hops=hops, latency_s=lat,
        window_wait_s=_window_waits(trace, t_idx, assignment, prim),
        group_size=group_size, seeds=np.zeros((R, N), np.uint32),
        weights=weights, edges=_edge_schedule(fl, assignment, prim))
