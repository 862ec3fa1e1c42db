"""Keplerian orbit propagation + ground-station kinematics (port of
``repro.constellation.orbits``).

Circular two-body orbits in float32, as the JAX package computes them:
positions in ECI km; ground stations rotate with Earth.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device

EARTH_RADIUS_KM = 6378.137
MU_EARTH = 398600.4418           # km^3 / s^2
EARTH_ROT_RATE = 7.2921159e-5    # rad / s

# the paper's 10 ground stations
GROUND_STATIONS = {
    "Tokyo": (35.6762, 139.6503),
    "LosAngeles": (34.0522, -118.2437),
    "Madrid": (40.4168, -3.7038),
    "Toronto": (43.6532, -79.3832),
    "Santiago": (-33.4489, -70.6693),
    "Frankfurt": (50.1109, 8.6821),
    "Sydney": (-33.8688, 151.2093),
    "Bangalore": (12.9716, 77.5946),
    "Nairobi": (-1.2921, 36.8219),
    "Anchorage": (61.2181, -149.9003),
}


def _deg2rad(x: torch.Tensor) -> torch.Tensor:
    """float32 degrees -> radians as jnp.deg2rad rounds it: x · f32(π/180)."""
    return x * torch.tensor(np.pi / 180, dtype=torch.float32, device=x.device)


class OrbitalElements(NamedTuple):
    """Circular-orbit elements, one float32 entry per satellite."""
    sma_km: torch.Tensor
    inc_rad: torch.Tensor
    raan_rad: torch.Tensor
    anom0_rad: torch.Tensor


def walker_constellation(n_sats: int, n_planes: int, inc_deg: float = 53.0,
                         alt_km: float = 550.0, phasing: int = 1,
                         jitter_seed: int | None = 0,
                         jitter_deg: float = 1.5,
                         device=None) -> OrbitalElements:
    """Walker-delta pattern with Starlink shell-1 parameters and a seeded
    phase jitter (the same numpy draws as the JAX package)."""
    device = resolve_device(device)
    per_plane = int(math.ceil(n_sats / n_planes))
    plane_idx = np.arange(n_sats) // per_plane
    slot_idx = np.arange(n_sats) % per_plane
    raan = 2 * np.pi * plane_idx / n_planes
    anom = (2 * np.pi * slot_idx / per_plane
            + 2 * np.pi * phasing * plane_idx / n_sats)
    if jitter_seed is not None:
        rng = np.random.default_rng(jitter_seed)
        anom = anom + np.deg2rad(rng.normal(0, jitter_deg, n_sats))
        raan = raan + np.deg2rad(rng.normal(0, jitter_deg / 3, n_sats))
    sma = np.full(n_sats, EARTH_RADIUS_KM + alt_km)
    inc = np.full(n_sats, np.deg2rad(inc_deg))
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return OrbitalElements(f32(sma), f32(inc), f32(raan), f32(anom))


def propagate(elements: OrbitalElements, times_s: torch.Tensor) -> torch.Tensor:
    """ECI positions (n_sats, n_times, 3) km at the given times (seconds)."""
    a = elements.sma_km[:, None]
    n_mot = torch.sqrt(MU_EARTH / (a * a * a))
    u = elements.anom0_rad[:, None] + n_mot * times_s[None, :]
    cu, su = torch.cos(u), torch.sin(u)
    ci = torch.cos(elements.inc_rad)[:, None]
    si = torch.sin(elements.inc_rad)[:, None]
    cO = torch.cos(elements.raan_rad)[:, None]
    sO = torch.sin(elements.raan_rad)[:, None]
    x = a * (cO * cu - sO * su * ci)
    y = a * (sO * cu + cO * su * ci)
    z = a * (su * si)
    return torch.stack([x, y, z], dim=-1)


def ground_station_eci(lat_lon_deg, times_s: torch.Tensor,
                       gmst0_rad: float = 0.0) -> torch.Tensor:
    """ECI positions (n_gs, n_times, 3) of ground stations."""
    ll = torch.as_tensor(np.asarray(lat_lon_deg, np.float32),
                         device=times_s.device)
    lat = _deg2rad(ll[:, 0])[:, None]
    lon = _deg2rad(ll[:, 1])[:, None]
    theta = gmst0_rad + lon + EARTH_ROT_RATE * times_s[None, :]
    clat = torch.cos(lat)
    x = EARTH_RADIUS_KM * clat * torch.cos(theta)
    y = EARTH_RADIUS_KM * clat * torch.sin(theta)
    z = EARTH_RADIUS_KM * torch.sin(lat) * torch.ones_like(theta)
    return torch.stack([x, y, z], dim=-1)
