"""sat-QFL topology (port of ``repro.constellation.topology``): primary /
secondary roles, participation within (H_max, L_max), and the trace the
FL scheduler consumes.

  S_p(t) = ground-visible satellites (primaries / "main satellites")
  S_s(t) = the rest, reachable only over ISLs
  P_i(t) = 1 iff a path to a ground station exists within (H_max, L_max)

plus the scheduling artifacts the FL core consumes: per-round
participation masks, the secondary→primary assignment, and access windows
(t_start, t_end).

Orbits and access are computed in torch float32 on the requested device;
the trace itself is numpy, like the JAX package's, so the plan compiler
runs the same host code on either package's trace.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.constellation.orbits import (
    GROUND_STATIONS, ground_station_eci, propagate, walker_constellation,
)
from repro_torch.constellation.visibility import (
    sat_ground_access, sat_sat_access,
)
from repro_torch.device import resolve_device

SPEED_OF_LIGHT_KM_S = 299792.458


@dataclass
class ConstellationTrace:
    """Propagated scenario: everything the FL scheduler needs, as numpy."""
    times_s: np.ndarray                 # (T,)
    sat_pos: np.ndarray                 # (n_sat, T, 3)
    sg_access: np.ndarray               # (n_sat, n_gs, T) bool
    ss_access: np.ndarray               # (n_sat, n_sat, T) bool
    gs_names: list
    n_sats: int

    @property
    def n_steps(self) -> int:
        return len(self.times_s)


def build_trace(n_sats: int = 50, n_planes: int = 10,
                duration_s: float = 6 * 3600.0, step_s: float = 30.0,
                min_elev_deg: float = 10.0, seed: int = 0,
                gs_names: list | None = None,
                device=None) -> ConstellationTrace:
    """The paper's scenario: 50 (or 100) Starlink-like satellites, 10
    ground stations, 6 h window, 30 s sampling."""
    dev = resolve_device(device)
    names = gs_names or list(GROUND_STATIONS.keys())
    lat_lon = [GROUND_STATIONS[n] for n in names]
    times = torch.arange(0.0, duration_s + step_s, step_s,
                         dtype=torch.float32, device=dev)
    elements = walker_constellation(n_sats, n_planes, jitter_seed=seed,
                                    device=dev)
    sat_pos = propagate(elements, times)
    gs_pos = ground_station_eci(lat_lon, times)
    sg = sat_ground_access(sat_pos, gs_pos, min_elev_deg)
    ss = sat_sat_access(sat_pos)
    return ConstellationTrace(
        times_s=times.cpu().numpy(), sat_pos=sat_pos.cpu().numpy(),
        sg_access=sg.cpu().numpy(), ss_access=ss.cpu().numpy(),
        gs_names=names, n_sats=n_sats)


def partition_roles(trace: ConstellationTrace, t_idx: int):
    """S_p(t), S_s(t): primaries see any ground station at step t."""
    vis = trace.sg_access[:, :, t_idx].any(axis=1)
    return np.where(vis)[0], np.where(~vis)[0]


def assign_secondaries(trace: ConstellationTrace, t_idx: int):
    """Each secondary's nearest ISL-visible primary (the paper's {SecSat}
    per MainSat grouping): ({primary: [secondaries]}, [unreachable])."""
    primaries, secondaries = partition_roles(trace, t_idx)
    pos = trace.sat_pos[:, t_idx]
    isl = trace.ss_access[:, :, t_idx]
    assign = {int(p): [] for p in primaries}
    unreachable = []
    for s in secondaries:
        cand = [p for p in primaries if isl[s, p]]
        if not cand:
            unreachable.append(int(s))
            continue
        dists = [np.linalg.norm(pos[s] - pos[p]) for p in cand]
        assign[int(cand[int(np.argmin(dists))])].append(int(s))
    return assign, unreachable


def isl_routes(trace: ConstellationTrace, t_idx: int, h_max: int = 4,
               l_max_s: float = 0.25):
    """P_i(t) via BFS over the ISL graph with hop + latency constraints.

    Returns (participation (n_sat,) bool, hops (n_sat,), latency_s (n_sat,)).
    Primaries have 0 hops; latency accumulates ISL propagation delays.

    The scalar reference, the JAX package's BFS in its visiting order: a
    satellite keeps the first feasible path it is reached by. The hot path
    is ``isl_routes_batched``, whose relaxation keeps the least latency
    over min-hop paths (and so can reach, where L_max binds on a tie, a
    satellite this visiting order missed).
    """
    n = trace.n_sats
    pos = trace.sat_pos[:, t_idx]
    isl = trace.ss_access[:, :, t_idx]
    primaries, _ = partition_roles(trace, t_idx)

    hops = np.full(n, np.inf)
    lat = np.full(n, np.inf)
    hops[primaries] = 0
    lat[primaries] = 0.0
    frontier = list(primaries)
    while frontier:
        nxt = []
        for u in frontier:
            for v in np.where(isl[u])[0]:
                d = np.linalg.norm(pos[u] - pos[v]) / SPEED_OF_LIGHT_KM_S
                if (hops[u] + 1 < hops[v] and hops[u] + 1 <= h_max
                        and lat[u] + d <= l_max_s):
                    hops[v] = hops[u] + 1
                    lat[v] = lat[u] + d
                    nxt.append(v)
        frontier = nxt
    return np.isfinite(hops), hops, lat


def pairwise_distances(pos: np.ndarray) -> np.ndarray:
    """Batched ‖p_i − p_j‖ (..., n, n) via the Gram expansion, in f64
    (the expansion cancels catastrophically in f32 at LEO radii)."""
    pos = np.asarray(pos, np.float64)
    n2 = np.einsum('...ik,...ik->...i', pos, pos)
    g = pos @ np.swapaxes(pos, -1, -2)
    d2 = n2[..., :, None] + n2[..., None, :] - 2.0 * g
    return np.sqrt(np.maximum(d2, 0.0))


def isl_routes_batched(trace: ConstellationTrace, t_idxs,
                       h_max: int = 4, l_max_s: float = 0.25):
    """P_i(t) over a batch of trace steps: a hop-synchronous frontier
    relaxation (at hop h every unreached satellite takes the minimum
    latency over the satellites settled at hop h-1, within L_max).

    Returns (participation (R, n) bool, hops (R, n), latency_s (R, n)),
    inf marking unreachable satellites.
    """
    t_idxs = np.asarray(t_idxs, dtype=np.int64)
    pos = trace.sat_pos[:, t_idxs].transpose(1, 0, 2)
    isl = trace.ss_access[:, :, t_idxs].transpose(2, 0, 1)
    prim = trace.sg_access[:, :, t_idxs].any(axis=1).T
    w = np.where(isl, pairwise_distances(pos) / SPEED_OF_LIGHT_KM_S, np.inf)
    lat = np.where(prim, 0.0, np.inf)
    hops = np.where(prim, 0.0, np.inf)
    for h in range(1, h_max + 1):
        settled = hops == (h - 1)
        if not settled.any():
            break
        best = (np.where(settled, lat, np.inf)[:, :, None] + w).min(axis=1)
        ok = (best <= l_max_s) & ~np.isfinite(hops)
        lat = np.where(ok, best, lat)
        hops = np.where(ok, float(h), hops)
    return np.isfinite(hops), hops, lat


def access_windows(trace: ConstellationTrace, sat: int,
                   other: int | None = None, ground: int | None = None):
    """(t_start, t_end) intervals in seconds of sat↔sat, sat↔ground or (by
    default) sat↔any-ground access — the accessTimes input of Algorithm
    1."""
    if other is not None:
        series = trace.ss_access[sat, other]
    elif ground is not None:
        series = trace.sg_access[sat, ground]
    else:
        series = trace.sg_access[sat].any(axis=0)
    t = trace.times_s
    edges = np.diff(series.astype(np.int8), prepend=0, append=0)
    starts = np.where(edges == 1)[0]
    ends = np.where(edges == -1)[0] - 1
    return [(float(t[a]), float(t[min(b, len(t) - 1)]))
            for a, b in zip(starts, ends)]


def participation_series(trace: ConstellationTrace, n_rounds: int,
                         h_max: int = 4, l_max_s: float = 0.25,
                         round_stride: int | None = None) -> np.ndarray:
    """(n_rounds, n) bool: P_i at the trace step of each FL round (rounds
    spread across the trace, stride T / n_rounds by default)."""
    t_idxs = round_steps(trace, n_rounds, round_stride)
    return isl_routes_batched(trace, t_idxs, h_max, l_max_s)[0]


def round_steps(trace: ConstellationTrace, n_rounds: int,
                round_stride: int | None = None) -> np.ndarray:
    """(n_rounds,) trace-step index of each FL round (stride = T/n_rounds)."""
    stride = round_stride or max(trace.n_steps // max(n_rounds, 1), 1)
    return np.minimum(np.arange(n_rounds) * stride, trace.n_steps - 1)
