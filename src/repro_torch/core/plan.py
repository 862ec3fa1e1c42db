"""RoundPlan: the trace → schedule compiler (port of ``repro.core.plan``).

A ``ConstellationTrace`` + ``SatQFLConfig`` compiles ONCE into dense
per-round numpy arrays — roles S_p(t), the secondary→primary assignment,
the participation mask P_i(t), hops and latency, window waits, group
sizes, FedAvg weights, and the EdgeSchedule's per-stage CSR of every
exchange a round performs. The trainer reads groups, weights and stages
from the plan instead of re-deriving them inside the round loop.

The port compiles plans for modes ``qfl`` and ``sim`` under
``security`` none, qkd or qkd_fernet, with every fault rate at 0. Given a
key registry (the trainer's :class:`~repro_torch.security.keys.KeyManager`)
the EdgeSchedule carries per-(round, edge) key material, every edge
established in one batched BB84; ``with_seeds=True`` also fills the
per-(round, satellite) ``seeds``. There is no staleness or fault schedule
yet. Other configurations raise ``NotImplementedError`` naming the ROADMAP
item that brings them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch import prng
from repro_torch.constellation.topology import (
    ConstellationTrace, isl_routes_batched, pairwise_distances, round_steps,
)
from repro_torch.core.flconfig import SatQFLConfig
from repro_torch.security.keys import (KeyManager, canonical_edge,
                                       mac_key_mix, round_seed_mix)

GROUND = -1    # edge endpoint id for the ground station ("gs")


@dataclass(frozen=True)
class EdgeSchedule:
    """Every exchange of every round, stacked over an edge axis.

    Dense ``(R, E_max)`` arrays laid out stage-major within each round (a
    stage = one batched dispatch: the ISL uplinks of a ``sim`` round, or
    the feeder uplinks); ``ptr`` bounds each (round, stage) CSR-style and
    the tail past ``ptr[r, -1]`` is padding (``mask`` False).

    Key material (seed/mac_r/mac_s/abort) is filled only when a key
    registry was given at compile time (``with_keys``): pad seeds come
    from ``round_seed_mix`` of the edge seed and the BORN round, ``first``
    marks each edge's first planned use (where QKD time is paid), and
    ``abort`` marks edges whose QBER crossed the abort threshold.
    """
    n_stages: np.ndarray      # (R,) int — dispatch stages per round
    ptr: np.ndarray           # (R, S_max + 1) int — CSR offsets per stage
    src: np.ndarray           # (R, E_max) int — sender satellite
    dst: np.ndarray           # (R, E_max) int — receiver; GROUND = station
    link: np.ndarray          # (R, E_max) uint8 — 0 ISL, 1 feeder
    conc: np.ndarray          # (R, E_max) int — ISL-aperture concurrency
    mask: np.ndarray          # (R, E_max) bool — valid edge
    first: np.ndarray         # (R, E_max) bool — first planned use of the edge
    abort: np.ndarray         # (R, E_max) bool — QBER abort at establishment
    born: np.ndarray          # (R, E_max) int — round the payload was trained
    seed: np.ndarray          # (R, E_max) uint32 — per-(born, edge) pad seed
    mac_r: np.ndarray         # (R, E_max) uint32 — MAC evaluation point
    mac_s: np.ndarray         # (R, E_max) uint32 — MAC blind
    with_keys: bool           # key-material columns populated?

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
    seeds: np.ndarray             # (R, N) uint32 — uplink pad seeds
                                  #   (``with_seeds``; else 0)
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


def _seed_schedule(assignment, prim, fl: SatQFLConfig, keymgr: KeyManager):
    """(R, N) uint32 round seeds of every satellite's uplink edge: qfl
    and mains over the feeder (sat, "gs"), secondaries over the ISL to
    their main; unreachable satellites keep seed 0. Every edge is
    established in one batched BB84."""
    R, N = assignment.shape
    cells = {}
    for r in range(R):
        for s in range(N):
            if fl.mode == "qfl" or prim[r, s]:
                edge = ("gs", s)
            elif assignment[r, s] >= 0:
                edge = (s, int(assignment[r, s]))
            else:
                continue
            cells[(r, s)] = canonical_edge(edge)
    eks = keymgr.establish_edges(list(dict.fromkeys(cells.values())))
    base = {ek.edge: ek.seed for ek in eks}
    seeds = np.zeros((R, N), np.uint32)
    for (r, s), edge in cells.items():
        seeds[r, s] = round_seed_mix(base[edge], r)
    return seeds


def _edge_schedule(fl: SatQFLConfig, assignment, prim,
                   keymgr: KeyManager | None) -> EdgeSchedule:
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
    abort = np.zeros((R, E_max), bool)
    born = np.zeros((R, E_max), np.int64)
    seed = np.zeros((R, E_max), np.uint32)
    mac_r = np.zeros((R, E_max), np.uint32)
    mac_s = np.zeros((R, E_max), np.uint32)
    cells: dict = {}
    seen: dict = {}             # edges in order of first planned use
    for r, stages in enumerate(per_round):
        j = 0
        for si, stage in enumerate(stages):
            for (a, b, lk, c) in stage:
                e = canonical_edge((a, "gs" if b == GROUND else b))
                src[r, j], dst[r, j] = a, b
                link[r, j], conc[r, j], mask[r, j] = lk, c, True
                born[r, j] = r
                cells[r, j] = e
                if e not in seen:
                    seen[e] = None
                    first[r, j] = True
                j += 1
            ptr[r, si + 1] = j
        ptr[r, len(stages):] = j

    if keymgr is not None and seen:
        # ONE batched BB84 for every edge the whole plan will ever use
        info = {ek.edge: ek for ek in keymgr.establish_edges(list(seen))}
        for (r, j), e in cells.items():
            ek = info[e]
            abort[r, j] = ek.compromised
            # pad seeds fold in the BORN round: one pad per (edge, born)
            seed[r, j] = round_seed_mix(ek.seed, born[r, j])
            mac_r[r, j], mac_s[r, j] = mac_key_mix(seed[r, j])
    return EdgeSchedule(n_stages=np.asarray([len(st) for st in per_round]),
                        ptr=ptr, src=src, dst=dst, link=link, conc=conc,
                        mask=mask, first=first, abort=abort, born=born,
                        seed=seed, mac_r=mac_r, mac_s=mac_s,
                        with_keys=keymgr is not None)


def check_supported(fl: SatQFLConfig):
    """Raise ``NotImplementedError`` for what this slice does not run."""
    if fl.mode not in ("qfl", "sim"):
        raise NotImplementedError(
            f"mode={fl.mode!r} is not ported yet (ROADMAP queue 1, item 7: "
            f"seq + async v2 + secagg)")
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
                       sample_counts=None, keymgr: KeyManager | None = None,
                       round_stride: int | None = None,
                       with_seeds: bool = False, device=None) -> RoundPlan:
    """Compile trace + config into a :class:`RoundPlan`.

    sample_counts — per-satellite dataset sizes for FedAvg weighting
    (used when ``fl.weight_by_samples``); keymgr — a QKD key registry (the
    trainer's), whose edge keys fill the EdgeSchedule's key material;
    with_seeds — also fill the per-satellite ``seeds``, with a registry
    made from ``fl.seed`` on ``device`` where none is given. Unlike the
    JAX package, ``with_seeds`` defaults to False: a plan without a
    registry runs no BB84 (the trainer passes its own).
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

    if with_seeds:
        if keymgr is None:
            keymgr = KeyManager(prng.PRNGKey(fl.seed + 7, device),
                                n_qkd_bits=fl.qkd_bits)
        seeds = _seed_schedule(assignment, prim, fl, keymgr)
    else:
        seeds = np.zeros((R, N), np.uint32)

    return RoundPlan(
        n_rounds=R, n_sats=N,
        step_s=(float(trace.times_s[1] - trace.times_s[0])
                if trace.n_steps > 1 else 0.0),
        t_idx=np.asarray(t_idx), primary_mask=prim, assignment=assignment,
        part_mask=part.astype(np.float32), hops=hops, latency_s=lat,
        window_wait_s=_window_waits(trace, t_idx, assignment, prim),
        group_size=group_size, seeds=seeds, weights=weights,
        edges=_edge_schedule(fl, assignment, prim, keymgr))
