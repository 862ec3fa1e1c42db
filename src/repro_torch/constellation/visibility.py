"""Line-of-sight access (port of ``repro.constellation.visibility``):
the edges of the paper's H(t) graph, over the propagated positions."""
from __future__ import annotations

import torch

from repro_torch.constellation.orbits import EARTH_RADIUS_KM, _deg2rad


def elevation_angle(sat_pos: torch.Tensor, gs_pos: torch.Tensor) -> torch.Tensor:
    """sat_pos (n_sat, T, 3); gs_pos (n_gs, T, 3) -> (n_sat, n_gs, T) rad."""
    rel = sat_pos[:, None] - gs_pos[None]
    up = gs_pos / torch.linalg.norm(gs_pos, dim=-1, keepdim=True)
    cos_zen = torch.sum(rel * up[None], dim=-1) / torch.clamp(
        torch.linalg.norm(rel, dim=-1), min=1e-6)
    return torch.arcsin(torch.clamp(cos_zen, -1.0, 1.0))


def sat_ground_access(sat_pos, gs_pos, min_elev_deg: float = 10.0):
    """Boolean access (n_sat, n_gs, T)."""
    deg = torch.tensor(min_elev_deg, dtype=torch.float32, device=sat_pos.device)
    return elevation_angle(sat_pos, gs_pos) >= _deg2rad(deg)


def sat_sat_access(sat_pos: torch.Tensor, max_range_km: float = 5016.0,
                   grazing_alt_km: float = 80.0) -> torch.Tensor:
    """ISL feasibility (n_sat, n_sat, T): within range, and the segment
    between the satellites clears the grazing altitude."""
    d = sat_pos[:, None] - sat_pos[None]
    dist = torch.linalg.norm(d, dim=-1)
    in_range = (dist > 1e-3) & (dist <= max_range_km)
    a = sat_pos[:, None]
    ab = -d
    denom = torch.clamp(torch.sum(ab * ab, dim=-1), min=1e-9)
    t = torch.clamp(-torch.sum(a * ab, dim=-1) / denom, 0.0, 1.0)
    closest = a + t[..., None] * ab
    clear = torch.linalg.norm(closest, dim=-1) >= (EARTH_RADIUS_KM
                                                   + grazing_alt_km)
    eye = torch.eye(sat_pos.shape[0], dtype=torch.bool,
                    device=sat_pos.device)[:, :, None]
    return in_range & clear & ~eye
