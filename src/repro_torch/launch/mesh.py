"""Device meshes (port of ``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
process group.

Production target, the JAX package's meshes kept shape for shape so the
specs and the analytic terms compare:
  single-pod:  (16, 16)    axes ("data", "model")        = 256 ranks
  multi-pod:   (2, 16, 16) axes ("pod", "data", "model") = 512 ranks
one rank per GPU, over the default process group (a ``torchrun`` of 256 or
512 ranks, or the dry-run's fake group). On H100 nodes of 8 GPUs a 16-wide
"model" axis spans two nodes.

sat-QFL mapping: a satellite = one "data" slice ("model" parallelism = the
satellite's compute board); intra-pod reductions are ISL traffic, the
"pod" axis is the primary→ground feeder tier.
"""
from __future__ import annotations

import atexit
import os
import shutil
import tempfile

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def init_host_group(device=None) -> str:
    """A world-1 process group on this host if none is running: NCCL for a
    CUDA device, gloo for the CPU, rendezvous through a file in a new
    temporary directory (no network). Returns the device type."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        tmp = tempfile.mkdtemp(prefix="repro_torch_pg_")
        atexit.register(shutil.rmtree, tmp, True)
        path = os.path.join(tmp, "store")
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method="file://" + path, rank=0, world_size=1)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    return dev.type


def make_host_mesh(model: int = 1, device=None):
    """(world // model, model) mesh over the default process group, one
    rank per local card (``init_host_group`` starts a world-1 group where
    none runs): smoke runs and examples."""
    from torch.distributed.device_mesh import init_device_mesh
    dtype = init_host_group(device)
    n = dist.get_world_size()
    return init_device_mesh(dtype, (max(n // model, 1), model),
                            mesh_dim_names=("data", "model"))


def data_axes_for(mesh) -> tuple:
    return tuple(a for a in mesh.mesh_dim_names if a != "model")
