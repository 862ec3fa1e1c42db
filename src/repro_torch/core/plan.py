"""RoundPlan: the trace → schedule compiler (port of ``repro.core.plan``).

A ``ConstellationTrace`` + ``SatQFLConfig`` compiles ONCE into dense
per-round numpy arrays — roles S_p(t), the secondary→primary assignment,
the participation mask P_i(t), hops and latency, window waits, group
sizes, FedAvg weights, the EdgeSchedule's per-stage CSR of every exchange
a round performs and, for mode ``async``, the StalenessSchedule of the
bounded-staleness buffer. The trainer reads groups, weights, stages and
the buffer's merge masks from the plan instead of re-deriving them inside
the round loop.

The port compiles plans for all four modes (qfl, sim, seq, async), every
security mode, ``agg_security`` none or secagg, and the seeded fault plane
(:class:`FaultSchedule`: link flaps, satellite crashes, stragglers, payload
tampering and async retransmission with backoff). Given a key registry
(the trainer's :class:`~repro_torch.security.keys.KeyManager`) the
EdgeSchedule carries per-(round, edge) key material, every edge
established in one batched BB84; ``with_seeds=True`` also fills the
per-(round, satellite) ``seeds``. With every fault rate at 0 the plan
carries no fault plane (``faults is None``) and every schedule is the
fault-free one.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import prng
from repro_torch.constellation.topology import (
    ConstellationTrace, isl_routes_batched, pairwise_distances, round_steps,
)
from repro_torch.core.flconfig import SatQFLConfig
from repro_torch.device import resolve_device
from repro_torch.security.keys import (KeyManager, canonical_edge,
                                       mac_key_mix, pairwise_mask_seed,
                                       round_seed_mix)
from repro_torch.security.otp import SECAGG_CLIP, SECAGG_W_MAX

GROUND = -1    # edge endpoint id for the ground station ("gs")

# fault-site hash domains: distinct constants keep the four fault kinds
# statistically independent even at the same (round, edge/sat) site
_FAULT_KIND = {"flap": 0x464C4150, "crash": 0x43525348,
               "strag": 0x53545247, "tamper": 0x54414D50}


def _edge_ids(edge, n_sats: int) -> tuple[int, int]:
    """Order-free integer endpoints of an edge; the ground station maps
    to ``n_sats`` so ('gs', s) and (s, 'gs') hash identically."""
    ids = [n_sats if e in ("gs", GROUND) else int(e) for e in edge]
    return min(ids), max(ids)


def fault_site_u32(fault_seed: int, kind: str, round_idx: int, a: int,
                   b: int = 0, attempt: int = 0) -> np.uint32:
    """Deterministic per-site fault hash: a chain of the numpy mixer the
    pad-seed schedule uses (``round_seed_mix``), so the per-client oracle
    and the batched executor derive identical sites from (seed, kind,
    round, endpoints, attempt) with no shared state."""
    h = round_seed_mix(np.uint32((fault_seed ^ _FAULT_KIND[kind])
                                 & 0xFFFFFFFF), round_idx)
    h = round_seed_mix(h, a + 1)
    h = round_seed_mix(h, b + 1)
    return np.uint32(round_seed_mix(h, attempt + 0x51ED))


def _fault_hit(u32, rate: float) -> bool:
    """uint32 hash < rate·2³²: exact at rate 0 and 1."""
    return int(u32) < int(rate * 4294967296.0)


@dataclass(frozen=True)
class FaultSchedule:
    """Seeded fault-injection schedule compiled into the RoundPlan.

    Every fault site is a pure function of ``(fault_seed, kind, round,
    endpoints[, attempt])`` through :func:`fault_site_u32`, thresholded by
    the config's rates: the dense arrays tabulate that function and the
    pointwise accessors (``flap_of`` / ``tamper_of``) recompute it, so the
    per-edge oracle (which never sees edge-slot indices) and the batched
    executor (which reads the arrays) cannot drift apart. With every rate
    at 0 ``compile_round_plan`` attaches no schedule (``plan.faults is
    None``).

    * ``crash[r, s]``: satellite ``s``'s payload computer is down for
      round ``r``; it neither trains nor sends. A crashed MAIN still
      relays, merges and feeds (the comms bus survives) but skips its own
      ``main_trains`` step.
    * ``straggler[r, s]``: its upload wall (or async transmit wait) gains
      ``straggler_extra_s`` seconds; never set where ``crash`` is.
    * ``link_flap[r, j]``: EdgeSchedule slot ``(r, j)`` drops before the
      payload moves (establishment, if due, is still paid), like a QBER
      abort. Async ISL arrivals are never flapped here: their flap/retry
      history was resolved by the retransmit ledger, and the arrival
      schedule holds only the surviving attempts.
    * ``tamper[r, j]``: nonzero word XORed into the first wire word of
      slot ``(r, j)``; the receiver's MAC rejects the payload after
      transfer and crypto time were paid.
    * ``flap_events / retry_events / lost_events / recovered_events``: the
      async retransmit ledger, charged to the round each attempt targeted.
    """
    seed: int
    n_sats: int
    link_flap_rate: float
    crash_rate: float
    straggler_rate: float
    corrupt_rate: float
    straggler_extra_s: float
    max_retries: int
    retry_backoff_steps: int
    crash: np.ndarray             # (R, N) bool
    straggler: np.ndarray         # (R, N) bool
    link_flap: np.ndarray         # (R, E_max) bool — EdgeSchedule-aligned
    tamper: np.ndarray            # (R, E_max) uint32 — 0 = clean
    attempt: np.ndarray           # (R, E_max) int32 — delivery attempt of
                                  #   async arrival slots (0 elsewhere)
    flap_events: np.ndarray       # (R,) int32
    retry_events: np.ndarray      # (R,) int32
    lost_events: np.ndarray       # (R,) int32
    recovered_events: np.ndarray  # (R,) int32
    recovered: np.ndarray         # (R, N) bool — update born (r, s)
                                  #   delivered only via retransmit

    def flap_of(self, born: int, edge, attempt: int = 0) -> bool:
        """Pointwise link-flap test: the hash the arrays tabulate."""
        if self.link_flap_rate <= 0:
            return False
        a, b = _edge_ids(edge, self.n_sats)
        return _fault_hit(fault_site_u32(self.seed, "flap", born, a, b,
                                         attempt), self.link_flap_rate)

    def tamper_of(self, born: int, edge) -> int:
        """Pointwise tamper word (0 = clean): the hash the array holds."""
        if self.corrupt_rate <= 0:
            return 0
        a, b = _edge_ids(edge, self.n_sats)
        u = fault_site_u32(self.seed, "tamper", born, a, b)
        if not _fault_hit(u, self.corrupt_rate):
            return 0
        return int(np.uint32(u) | np.uint32(1))     # never zero

    def straggler_extra(self, r: int, s: int) -> float:
        return self.straggler_extra_s if self.straggler[r, s] else 0.0


@dataclass(frozen=True)
class EdgeSchedule:
    """Every exchange of every round, stacked over an edge axis.

    Dense ``(R, E_max)`` arrays laid out stage-major within each round (a
    stage = one batched dispatch: the ISL uplinks of a ``sim`` round, the
    compiled arrivals of an ``async`` round, one hop of every ``seq``
    chain, or the feeder uplinks); ``ptr`` bounds each (round, stage)
    CSR-style and the tail past ``ptr[r, -1]`` is padding (``mask`` False).

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
                              #   (= r except async deferred deliveries)
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
class StalenessSchedule:
    """Compiled async bounded-staleness buffer (the ring frame).

    A secondary trains every round it is grouped, but its update moves only
    when the (sat, main) ISL window opens: an update *born* at round ``b``
    is delivered at the first mains-bearing round whose trace time has
    passed the window's opening, enters its main's buffer, and merges at
    the first round that main is primary again if its staleness ``r − b``
    is within Δ_max; otherwise it is discarded. That lifecycle is a pure
    function of the trace, so it compiles into dense arrays, and the
    batched executor's whole async merge is one scatter into the ring and
    one masked weighted reduction.

    Ring frame: ``(N + 1, D)`` per round and main slot, D = Δ_max + 1,
    indexed by (satellite, born mod D); row N is the scratch row for masked
    writes. An overwritten slot's previous occupant is ≥ D rounds old,
    already beyond Δ_max.

    The secagg columns (``fl.agg_security='secagg'``) carry the pairwise
    masking schedule: per-sender signed mask seeds (cohort = the born
    round's group) and per-merge signed correction streams cancelling
    every cohort partner absent from that merge (QBER-aborted,
    window-dropped or still in flight).
    """
    D: int                        # ring depth Δ_max + 1
    n_mains_max: int              # G — merge rows per round
    tx_wait_s: np.ndarray         # (R, N) float — seconds a round-r sender
                                  #   waits for its transmit window (inf =
                                  #   never reopens; engines clamp to the
                                  #   comm model's mean window wait)
    delay_rounds: np.ndarray      # (R, N) int — rounds until the window
                                  #   opens for a round-r sender; -1 never
    deliver_round: np.ndarray     # (R, N) int — delivery round of a round-r
                                  #   update; -1 = dropped (windowless /
                                  #   stale on arrival / beyond the horizon)
    send_slot: np.ndarray         # (R, N) int — ring slot (born mod D)
                                  #   written by a round-r sender; -1 none
    main_ids: np.ndarray          # (R, G) int — mains in engine iteration
                                  #   order; -1 pad
    merge_w: np.ndarray           # (R, G, N+1, D) float32 — normalized
                                  #   FedAvg weight of each ring cell in this
                                  #   round's merge (0 = not merged)
    merge_born: np.ndarray        # (R, G, N+1, D) int — born round of each
                                  #   merged cell; -1 invalid
    merge_any: np.ndarray         # (R, G) bool — any entry merged
    merge_count: np.ndarray       # (R, G) int32 — delivered count per main
    # --- secagg (dropout-tolerant secure aggregation) -------------------
    with_secagg: bool
    wq: np.ndarray                # (N,) int32 — integer FedAvg weights
    pair_seed: np.ndarray         # (R, N, P) uint32 — sender mask seeds
    pair_sign: np.ndarray         # (R, N, P) int32 — +1 / −1 / 0 pad
    sum_wq: np.ndarray            # (R, G) int32 — Σ wq over merged entries
    corr_seed: np.ndarray         # (R, G, C) uint32 — merge corrections
    corr_sign: np.ndarray         # (R, G, C) int32


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
    stale: StalenessSchedule | None = None  # async bounded-staleness buffer
    faults: FaultSchedule | None = None     # seeded fault-injection plane
                                  #   (None whenever every fault rate is 0)

    def groups(self, r: int) -> dict[int, list[int]]:
        """{main: [secondaries]} at round r (the paper's {SecSat} grouping)."""
        return _groups_of(self.assignment[r], self.primary_mask[r])

    def live_groups(self, r: int) -> dict[int, list[int]]:
        """The groups both engines iterate and every stage was compiled
        from: ``groups(r)`` minus crash-faulted secondaries. Mains stay even
        when crashed (the comms bus survives); the engines skip only their
        own ``main_trains`` step."""
        f = self.faults
        return _live_groups_of(self.groups(r),
                               f.crash[r] if f is not None else None)

    def live_sats(self, r: int) -> list[int]:
        """All non-crashed satellites at round r (the qfl sender set)."""
        f = self.faults
        return [s for s in range(self.n_sats)
                if f is None or not f.crash[r, s]]

    def fault_mask(self, r: int, device=None) -> torch.Tensor:
        """(N,) float32 health vector on ``device``: 1 = healthy, 0 =
        crash-faulted this round; all ones without a fault plane, so
        callers can pass it unconditionally."""
        dev = resolve_device(device)
        if self.faults is None:
            return torch.ones((self.n_sats,), dtype=torch.float32, device=dev)
        return torch.from_numpy(
            1.0 - self.faults.crash[r].astype(np.float32)).to(dev)

    def unreachable(self, r: int) -> list[int]:
        return [int(s) for s in np.where(self.assignment[r] < 0)[0]]

    def participants(self, r: int) -> int:
        return int(self.part_mask[r].sum())

    def dist_inputs(self, r: int, device=None):
        """(part_mask float32, seeds, weights float32) of round r for
        ``core.dist.make_fl_round``, on ``device``; the seeds are u32
        values in int64 words, the port's u32 convention."""
        dev = resolve_device(device)
        return (torch.from_numpy(self.part_mask[r].astype(np.float32)).to(dev),
                torch.from_numpy(self.seeds[r].astype(np.int64)).to(dev),
                torch.from_numpy(self.weights.astype(np.float32)).to(dev))


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


def _live_groups_of(groups: dict, crash_r=None) -> dict:
    """The groups minus crash-faulted secondaries (``crash_r`` (N,) bool,
    or None without a fault plane)."""
    if crash_r is None or not crash_r.any():
        return groups
    return {m: [s for s in secs if not crash_r[s]]
            for m, secs in groups.items()}


def _round_stages(fl: SatQFLConfig, assignment_r, prim_r, n_sats: int,
                  arrivals_r=None, crash_r=None):
    """Edge list (src, dst, link, conc, born) of each dispatch stage of
    one round, in the order the trainer walks it, ``born`` -1 for this
    round: qfl = one feeder stage; sim = ISL uplinks, then feeder; async =
    the staleness schedule's compiled ARRIVALS (updates whose window has
    opened by this round, possibly born rounds earlier), then feeder; seq
    = one stage per chain hop, then feeder. Crash-faulted satellites send
    nothing, so their edges never enter a stage (a crashed main keeps its
    feeder: the comms bus survives)."""
    def now(edges):
        return [(a, b, lk, c, -1) for (a, b, lk, c) in edges]

    if fl.mode == "qfl":
        return [now([(s, GROUND, 1, 1) for s in range(n_sats)
                     if crash_r is None or not crash_r[s]])]
    groups = _live_groups_of(_groups_of(assignment_r, prim_r), crash_r)
    mains = list(groups)
    stages = []
    if fl.mode == "sim":
        stages.append(now([(s, m, 0, max(len(groups[m]), 1))
                           for m in mains for s in groups[m]]))
    elif fl.mode == "async":
        stages.append([(s, m, 0, 1, b)
                       for (s, m, b, _k) in (arrivals_r or [])])
    elif fl.mode == "seq":
        chains = [groups[m] for m in mains]
        for hop in range(max((len(c) for c in chains), default=0)):
            stages.append(now([(c[hop], mains[g], 0, 1)
                               for g, c in enumerate(chains) if len(c) > hop]))
    else:
        raise ValueError(fl.mode)
    stages.append(now([(m, GROUND, 1, 1) for m in mains]))
    return stages


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
                   keymgr: KeyManager | None, arrivals=None,
                   crash=None) -> EdgeSchedule:
    """Compile the per-round exchange plane (see EdgeSchedule)."""
    R, N = assignment.shape
    per_round = [_round_stages(fl, assignment[r], prim[r], N,
                               arrivals[r] if arrivals is not None else None,
                               crash[r] if crash is not None else None)
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
            for (a, b, lk, c, bn) in stage:
                e = canonical_edge((a, "gs" if b == GROUND else b))
                src[r, j], dst[r, j] = a, b
                link[r, j], conc[r, j], mask[r, j] = lk, c, True
                born[r, j] = r if bn < 0 else bn
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
            # pad seeds fold in the BORN round: one pad per (edge, born),
            # never reused even when several deferred deliveries cross the
            # same edge in one round
            seed[r, j] = round_seed_mix(ek.seed, born[r, j])
            mac_r[r, j], mac_s[r, j] = mac_key_mix(seed[r, j])
    return EdgeSchedule(n_stages=np.asarray([len(st) for st in per_round]),
                        ptr=ptr, src=src, dst=dst, link=link, conc=conc,
                        mask=mask, first=first, abort=abort, born=born,
                        seed=seed, mac_r=mac_r, mac_s=mac_s,
                        with_keys=keymgr is not None)


def _async_send_schedule(fl: SatQFLConfig, assignment, prim,
                         trace: ConstellationTrace, t_idx, crash=None):
    """Phase A of the staleness compiler: the send/arrival plan.

    A secondary trains DURING its round's access window, so its update can
    move only at the next trace step its (sat, main) ISL is open: that
    instant is ``tx_wait_s`` after the round's step, and the update is
    delivered at the first mains-bearing round at or past it. It is dropped
    when the window never reopens inside the trace, the delivery would land
    beyond the horizon, or it would already exceed Δ_max on arrival, so
    async updates always merge with staleness ≥ 1.

    With ``fl.link_flap_rate > 0`` each transmission attempt may FLAP
    (drop before the payload moves). A flapped delivery re-enters the
    schedule with bounded exponential backoff: retransmission ``k``
    searches for the next open ISL step at or past ``fail_step +
    retry_backoff_steps · 2^min(k−1, 6)``, up to ``max_retries`` attempts,
    still bounded by Δ_max and the horizon, after which the update is
    LOST. The whole retry history is resolved here, so the arrival
    schedule holds only surviving attempts (with their attempt index, for
    the recovery ledger) and both executors replay identical outcomes.

    Returns (delay_rounds, deliver_round, tx_wait_s, arrivals, groups per
    round, fault_info); ``arrivals[r]`` lists (sat, dest main, born,
    attempt) in delivery order — born ascending, then the born round's
    group order — the order the per-main-list oracle's outbox drains.
    ``fault_info`` is the retransmit ledger (per-round flap / retry / lost
    / recovered counts and per-(born, sat) flags), None without a flap
    rate.
    """
    R, N = assignment.shape
    t_idx = np.asarray(t_idx, np.int64)
    step = (float(trace.times_s[1] - trace.times_s[0])
            if trace.n_steps > 1 else 0.0)
    groups_r = [_live_groups_of(_groups_of(assignment[r], prim[r]),
                                crash[r] if crash is not None else None)
                for r in range(R)]
    has_mains = [len(g) > 0 for g in groups_r]
    delay = np.full((R, N), -1, np.int64)
    deliver = np.full((R, N), -1, np.int64)
    tx_wait = np.full((R, N), np.inf)
    flap_on = fl.link_flap_rate > 0
    fs_seed = fl.fault_seed & 0xFFFFFFFF
    flap_events, retry_events, lost_events, recovered_events = (
        np.zeros((R,), np.int32) for _ in range(4))
    attempt_of = np.zeros((R, N), np.int32)
    recovered = np.zeros((R, N), bool)
    for b in range(R):
        t = int(t_idx[b])
        for m, secs in groups_r[b].items():
            for s in secs:
                attempt = 0
                k_from = t + 1       # first step a transmission may use
                fail_rd = -1         # round of the last failed attempt
                while True:
                    hits = np.where(trace.ss_access[s, m, k_from:])[0]
                    if len(hits) == 0:
                        # the window never reopens inside the trace: a
                        # plain drop on attempt 0, a fault-caused loss later
                        if attempt > 0:
                            lost_events[fail_rd] += 1
                        break
                    k_tx = k_from + int(hits[0])
                    if attempt == 0:
                        tx_wait[b, s] = (k_tx - t) * step
                    ks = np.where(t_idx[b:] >= k_tx)[0]
                    if len(ks) == 0:
                        if attempt > 0:
                            lost_events[fail_rd] += 1
                        break           # opens past the round horizon
                    if attempt == 0:
                        delay[b, s] = int(ks[0])
                    rd = next((k for k in range(b + int(ks[0]), R)
                               if has_mains[k]), None)
                    if rd is None or rd - b > fl.max_staleness:
                        if attempt > 0:
                            lost_events[fail_rd] += 1
                        break           # too stale to bother transmitting
                    if flap_on and _fault_hit(
                            fault_site_u32(fs_seed, "flap", b,
                                           min(s, m), max(s, m), attempt),
                            fl.link_flap_rate):
                        # the transmission at k_tx drops; the event is
                        # charged to the round that would have received it
                        flap_events[rd] += 1
                        fail_rd = rd
                        if attempt >= fl.max_retries:
                            lost_events[rd] += 1
                            break       # retry budget exhausted: lost
                        retry_events[rd] += 1
                        k_from = k_tx + fl.retry_backoff_steps * (
                            2 ** min(attempt, 6))
                        attempt += 1
                        continue
                    deliver[b, s] = rd
                    attempt_of[b, s] = attempt
                    if attempt > 0:
                        recovered[b, s] = True
                        recovered_events[rd] += 1
                    break
    arrivals = [[] for _ in range(R)]
    for b in range(R):
        for m, secs in groups_r[b].items():
            for s in secs:
                if deliver[b, s] >= 0:
                    arrivals[int(deliver[b, s])].append(
                        (int(s), int(m), b, int(attempt_of[b, s])))
    fault_info = None
    if flap_on:
        fault_info = {"flap_events": flap_events,
                      "retry_events": retry_events,
                      "lost_events": lost_events,
                      "recovered_events": recovered_events,
                      "attempt_of": attempt_of, "recovered": recovered}
    return delay, deliver, tx_wait, arrivals, groups_r, fault_info


def _staleness_schedule(fl: SatQFLConfig, delay, deliver, tx_wait, arrivals,
                        groups_r, weights, es: EdgeSchedule,
                        keymgr: KeyManager | None,
                        faults: FaultSchedule | None = None
                        ) -> StalenessSchedule:
    """Phase B: simulate the buffer's lifecycle into dense merge arrays.

    Runs the pending-queue mechanics the per-main-list oracle runs live —
    arrivals append (minus QBER-aborted edges when the exchange is
    secured, and minus tamper-faulted deliveries, whose MAC the receiver
    rejects), each current main merges its fresh entries and discards the
    stale ones — and records the outcome as ring-frame masks. For secagg it
    also deals the pairwise mask shares of every born round's cohort and
    compiles each merge's signed corrections for absent partners.
    """
    R, N = delay.shape
    D = fl.max_staleness + 1
    G = max(max((len(g) for g in groups_r), default=1), 1)
    secagg = fl.agg_security == "secagg" and keymgr is not None

    # the engines abort on compromised edges under every security but none
    aborted = {}
    if es.with_keys and fl.security != "none" and keymgr is not None:
        for r in range(R):
            for (s, m, _b, _k) in arrivals[r]:
                e = canonical_edge((s, m))
                if e not in aborted:
                    aborted[e] = keymgr.get(e).compromised

    # tamper-faulted deliveries fail the receiver's MAC and never enter the
    # buffer; keyed by the BORN round, so two in-flight updates on one edge
    # fault independently (the pad fold-in's convention)
    tampered: set = set()
    if faults is not None and faults.corrupt_rate > 0:
        for r in range(R):
            for (s, m, b, _k) in arrivals[r]:
                if faults.tamper_of(b, (s, m)):
                    tampered.add((s, m, b))

    main_ids = np.full((R, G), -1, np.int64)
    send_slot = np.full((R, N), -1, np.int64)
    merge_w = np.zeros((R, G, N + 1, D), np.float32)
    merge_born = np.full((R, G, N + 1, D), -1, np.int64)
    merge_any = np.zeros((R, G), bool)
    merge_count = np.zeros((R, G), np.int32)

    wq = np.maximum(1, np.round(
        np.asarray(weights, np.float64) * SECAGG_W_MAX
        / max(float(np.max(weights)), 1e-9))).astype(np.int32)
    P = max(max((len(secs) for g in groups_r for secs in g.values()),
                default=1) - 1, 1)
    pair_seed = np.zeros((R, N, P), np.uint32)
    pair_sign = np.zeros((R, N, P), np.int32)
    sum_wq = np.zeros((R, G), np.int32)

    pair_base = {}
    if secagg:
        pairs = sorted({canonical_edge((s, s2))
                        for g in groups_r for secs in g.values()
                        for s in secs for s2 in secs if s != s2},
                       key=str)
        pair_base = keymgr.share_edges(pairs)
        for b in range(R):
            for secs in groups_r[b].values():
                for s in secs:
                    for k, s2 in enumerate(x for x in secs if x != s):
                        pair_seed[b, s, k] = pairwise_mask_seed(
                            pair_base[canonical_edge((s, s2))], b)
                        pair_sign[b, s, k] = 1 if s < s2 else -1

    # the buffer simulation (mirrors the oracle's live lists)
    pending: dict[int, list] = {}
    batches: dict[tuple, list] = {}   # (r, g) -> merged [(s, born)]
    for b in range(R):
        for secs in groups_r[b].values():
            for s in secs:
                if deliver[b, s] >= 0:
                    send_slot[b, s] = b % D
    for r in range(R):
        mains = list(groups_r[r])
        main_ids[r, :len(mains)] = mains
        for (s, m, b, _k) in arrivals[r]:
            if aborted.get(canonical_edge((s, m)), False):
                continue                    # QBER abort: update dropped
            if (s, m, b) in tampered:
                continue                    # MAC-rejected on arrival
            pending.setdefault(m, []).append((s, b))
        for g, m in enumerate(mains):
            fresh = sorted([(s, b) for (s, b) in pending.get(m, [])
                            if r - b <= fl.max_staleness])
            pending[m] = []                 # merged or stale-discarded
            batches[(r, g)] = fresh
            if not fresh:
                continue
            ws = [float(weights[s]) for s, _ in fresh]
            wsum = sum(ws)
            for (s, b), w in zip(fresh, ws):
                merge_w[r, g, s, b % D] = np.float32(w / wsum)
                merge_born[r, g, s, b % D] = b
            merge_any[r, g] = True
            merge_count[r, g] = len(fresh)
            sum_wq[r, g] = int(sum(int(wq[s]) for s, _ in fresh))
            if secagg and sum_wq[r, g] * SECAGG_CLIP >= 2 ** 31:
                # |Σ w·q| must stay below 2^31 or the aggregate wraps into
                # garbage — identically on both executors, so no parity
                # check could catch it
                raise ValueError(
                    f"secagg merge batch at round {r} (Σw={sum_wq[r, g]}) "
                    f"overflows the int32 fixed-point budget; reduce the "
                    f"constellation/buffer size or Δ_max")

    # secagg merge corrections: absent cohort partners
    corr: dict[tuple, list] = {}
    C = 1
    if secagg:
        for (r, g), fresh in batches.items():
            inset = set(fresh)
            m = int(main_ids[r, g])
            lst = []
            for (s, b) in fresh:
                for s2 in groups_r[b][m]:
                    if s2 == s or (s2, b) in inset:
                        continue            # partner merges here: cancels
                    lst.append((pairwise_mask_seed(
                        pair_base[canonical_edge((s, s2))], b),
                        -(1 if s < s2 else -1)))
            if lst:
                corr[(r, g)] = lst
                C = max(C, len(lst))
    corr_seed = np.zeros((R, G, C), np.uint32)
    corr_sign = np.zeros((R, G, C), np.int32)
    for (r, g), lst in corr.items():
        for k, (sd, sg) in enumerate(lst):
            corr_seed[r, g, k] = sd
            corr_sign[r, g, k] = sg

    return StalenessSchedule(
        D=D, n_mains_max=G, tx_wait_s=tx_wait, delay_rounds=delay,
        deliver_round=deliver, send_slot=send_slot, main_ids=main_ids,
        merge_w=merge_w, merge_born=merge_born, merge_any=merge_any,
        merge_count=merge_count, with_secagg=secagg, wq=wq,
        pair_seed=pair_seed, pair_sign=pair_sign, sum_wq=sum_wq,
        corr_seed=corr_seed, corr_sign=corr_sign)


def _fault_masks(fl: SatQFLConfig, R: int, N: int):
    """(crash, straggler) (R, N) bool masks from the fault-site hash. A
    crashed satellite is not transmitting at all, so it is never also a
    straggler that round."""
    crash = np.zeros((R, N), bool)
    strag = np.zeros((R, N), bool)
    if fl.crash_rate <= 0 and fl.straggler_rate <= 0:
        return crash, strag
    fs_seed = fl.fault_seed & 0xFFFFFFFF
    for r in range(R):
        for s in range(N):
            if fl.crash_rate > 0:
                crash[r, s] = _fault_hit(
                    fault_site_u32(fs_seed, "crash", r, s), fl.crash_rate)
            if fl.straggler_rate > 0:
                strag[r, s] = _fault_hit(
                    fault_site_u32(fs_seed, "strag", r, s),
                    fl.straggler_rate)
    strag &= ~crash
    return crash, strag


def _compile_faults(fl: SatQFLConfig, es: EdgeSchedule, crash, strag,
                    fault_info, n_sats: int) -> FaultSchedule | None:
    """Tabulate the fault-site hash over the compiled EdgeSchedule.

    None when every fault rate is 0: the plan then carries no fault plane
    and both executors run their fault-free paths. Async ISL arrival slots
    are never flap-masked here (the retransmit ledger of
    ``_async_send_schedule`` resolved their history); they carry the
    surviving delivery's attempt index instead. The pad seed stays a
    function of (edge, born): a flapped attempt drops the link BEFORE any
    ciphertext moves, so the surviving attempt is that pad's first and
    only exposure on the wire.
    """
    if (fl.link_flap_rate <= 0 and fl.crash_rate <= 0
            and fl.straggler_rate <= 0 and fl.corrupt_rate <= 0):
        return None
    R, E_max = es.src.shape
    fs_seed = fl.fault_seed & 0xFFFFFFFF
    link_flap = np.zeros((R, E_max), bool)
    tamper = np.zeros((R, E_max), np.uint32)
    attempt = np.zeros((R, E_max), np.int32)
    for r in range(R):
        for j in range(int(es.ptr[r, -1])):
            b = int(es.born[r, j])
            d = int(es.dst[r, j])
            a, bb = _edge_ids((int(es.src[r, j]),
                               "gs" if d == GROUND else d), n_sats)
            is_arrival = fl.mode == "async" and int(es.link[r, j]) == 0
            if is_arrival and fault_info is not None:
                attempt[r, j] = int(
                    fault_info["attempt_of"][b, int(es.src[r, j])])
            if fl.link_flap_rate > 0 and not is_arrival:
                link_flap[r, j] = _fault_hit(
                    fault_site_u32(fs_seed, "flap", b, a, bb),
                    fl.link_flap_rate)
            if fl.corrupt_rate > 0:
                u = fault_site_u32(fs_seed, "tamper", b, a, bb)
                if _fault_hit(u, fl.corrupt_rate):
                    tamper[r, j] = np.uint32(u) | np.uint32(1)
    zR = np.zeros((R,), np.int32)
    fi = fault_info or {}
    return FaultSchedule(
        seed=fs_seed, n_sats=n_sats,
        link_flap_rate=fl.link_flap_rate, crash_rate=fl.crash_rate,
        straggler_rate=fl.straggler_rate, corrupt_rate=fl.corrupt_rate,
        straggler_extra_s=fl.straggler_extra_s, max_retries=fl.max_retries,
        retry_backoff_steps=fl.retry_backoff_steps,
        crash=crash, straggler=strag, link_flap=link_flap, tamper=tamper,
        attempt=attempt,
        flap_events=fi.get("flap_events", zR),
        retry_events=fi.get("retry_events", zR),
        lost_events=fi.get("lost_events", zR),
        recovered_events=fi.get("recovered_events", zR),
        recovered=fi.get("recovered", np.zeros((R, n_sats), bool)))


def compile_round_plan(trace: ConstellationTrace, fl: SatQFLConfig, *,
                       sample_counts=None, keymgr: KeyManager | None = None,
                       round_stride: int | None = None,
                       with_seeds: bool = True, device=None) -> RoundPlan:
    """Compile trace + config into a :class:`RoundPlan`.

    sample_counts — per-satellite dataset sizes for FedAvg weighting
    (used when ``fl.weight_by_samples``); keymgr — a QKD key registry (the
    trainer's), whose edge keys fill the EdgeSchedule's key material;
    with_seeds — also fill the per-satellite ``seeds``. Where no registry
    is given, one is made from ``fl.seed`` on ``device`` for
    ``with_seeds`` and for secagg (whose pairwise mask shares need one even
    under ``security="none"``). ``with_seeds=False`` without a registry
    runs no BB84 (plans for security="none"; the trainer passes its own
    registry and ``with_seeds=False``).
    """
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

    if keymgr is None and (with_seeds or fl.agg_security == "secagg"):
        keymgr = KeyManager(prng.PRNGKey(fl.seed + 7, device),
                            n_qkd_bits=fl.qkd_bits)
    if with_seeds:
        seeds = _seed_schedule(assignment, prim, fl, keymgr)
    else:
        seeds = np.zeros((R, N), np.uint32)

    # the fault plane's crash/straggler masks come before any schedule, so
    # crashed satellites never enter a dispatch stage
    crash, strag = _fault_masks(fl, R, N)
    crash_arg = crash if crash.any() else None

    # async: the send/arrival plan first — the edge schedule's async
    # uplink stage IS the arrival schedule
    arrivals = stale = fault_info = None
    if fl.mode == "async":
        (delay, deliver, tx_wait, arrivals, groups_r,
         fault_info) = _async_send_schedule(fl, assignment, prim, trace,
                                            t_idx, crash_arg)
    edges = _edge_schedule(fl, assignment, prim, keymgr, arrivals, crash_arg)
    faults = _compile_faults(fl, edges, crash, strag, fault_info, N)
    if fl.mode == "async":
        stale = _staleness_schedule(fl, delay, deliver, tx_wait, arrivals,
                                    groups_r, weights, edges, keymgr, faults)

    return RoundPlan(
        n_rounds=R, n_sats=N,
        step_s=(float(trace.times_s[1] - trace.times_s[0])
                if trace.n_steps > 1 else 0.0),
        t_idx=np.asarray(t_idx), primary_mask=prim, assignment=assignment,
        part_mask=part.astype(np.float32), hops=hops, latency_s=lat,
        window_wait_s=_window_waits(trace, t_idx, assignment, prim),
        group_size=group_size, seeds=seeds, weights=weights,
        edges=edges, stale=stale, faults=faults)
