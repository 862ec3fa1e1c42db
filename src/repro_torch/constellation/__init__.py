"""Constellation substrate of the port: orbits, LoS access, topology."""
from repro_torch.constellation.orbits import (
    EARTH_RADIUS_KM, GROUND_STATIONS, ground_station_eci, propagate,
    walker_constellation,
)
from repro_torch.constellation.topology import (
    ConstellationTrace, build_trace, isl_routes_batched, pairwise_distances,
    round_steps,
)
from repro_torch.constellation.visibility import (
    elevation_angle, sat_ground_access, sat_sat_access,
)

__all__ = ["EARTH_RADIUS_KM", "GROUND_STATIONS", "ground_station_eci",
           "propagate", "walker_constellation", "ConstellationTrace",
           "build_trace", "isl_routes_batched", "pairwise_distances",
           "round_steps", "elevation_angle",
           "sat_ground_access", "sat_sat_access"]
