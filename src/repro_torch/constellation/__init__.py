"""Constellation substrate of the port: orbits, LoS access, topology."""
from repro_torch.constellation.orbits import (
    EARTH_RADIUS_KM, GROUND_STATIONS, ground_station_eci, propagate,
    walker_constellation,
)
from repro_torch.constellation.topology import (
    ConstellationTrace, access_windows, assign_secondaries, build_trace,
    isl_routes, isl_routes_batched, pairwise_distances, participation_series,
    partition_roles, round_steps,
)
from repro_torch.constellation.visibility import (
    elevation_angle, sat_ground_access, sat_sat_access,
)

__all__ = ["EARTH_RADIUS_KM", "GROUND_STATIONS", "ground_station_eci",
           "propagate", "walker_constellation", "ConstellationTrace",
           "build_trace", "partition_roles", "access_windows",
           "participation_series", "assign_secondaries", "isl_routes",
           "isl_routes_batched", "pairwise_distances", "round_steps", "elevation_angle",
           "sat_ground_access", "sat_sat_access"]
