"""Distribution context threaded through model code (port of
``repro.sharding.context``).

``DistCtx`` carries the mesh and the axis-name conventions. Models take
``ctx=None`` on one device; under a mesh the parameters and inputs are
DTensors placed by ``sharding.specs`` and DTensor's sharding propagation
partitions the step, as GSPMD does for the JAX package. The blocks that
*behave* differently under a mesh are the MoE (expert parallelism in a
``local_map`` region, the counterpart of ``shard_map``), the kernels
(called on each rank's local shard) and the layout hooks
(``models.decoder._gather_point`` and ``_seq_constraint``, ``attn_apply``'s
``seq_attn``).

``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh`` or anything
with the same two members, ``mesh_dim_names`` and ``size(dim)``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class DistCtx:
    mesh: object                       # DeviceMesh, or None
    data_axes: tuple = ("data",)       # batch-sharded axes, e.g. ("pod","data")
    model_axis: str = "model"
    strategy: str = "tp"               # "tp": tensor-parallel over "model"
                                       #   (+ seq-sharded residuals)
                                       # "dp": no TP — batch over EVERY mesh
                                       #   axis, params fully FSDP-sharded
    fsdp: bool = False                 # shard params over data axes too
    expert_parallel: bool = True       # MoE: shard experts over model axis
    seq_shard: bool = True             # sequence sharding of the residual
                                       # stream over "model"
    gather_once: bool = False          # one replicated gather of the normed
                                       # input per block
    quant_gather: bool = False         # int8-quantise the re-gather of
                                       # block inputs
    seq_attn: bool = False             # queries stay seq-sharded through
                                       # attention; gather K/V only

    def axis_size(self, name: str) -> int:
        return self.mesh.size(self.mesh.mesh_dim_names.index(name))

    @property
    def all_axes(self) -> tuple:
        return tuple(self.data_axes) + (self.model_axis,)

    @property
    def model_size(self) -> int:
        if self.mesh is None:
            return 1
        return self.axis_size(self.model_axis)

    @property
    def data_size(self) -> int:
        if self.mesh is None:
            return 1
        n = 1
        for a in self.data_axes:
            n *= self.axis_size(a)
        return n

    @property
    def data_spec_axes(self):
        """Axes usable as one entry of a spec."""
        return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]

    def replace(self, **kw) -> "DistCtx":
        return dataclasses.replace(self, **kw)


def has_mesh(ctx) -> bool:
    return ctx is not None and getattr(ctx, "mesh", None) is not None


def is_dtensor(x) -> bool:
    """True for a DTensor (without importing ``torch.distributed.tensor``
    where nothing could have made one)."""
    cls = type(x)
    return cls.__name__ == "DTensor" and cls.__module__.startswith(
        "torch.distributed.tensor")


@contextlib.contextmanager
def _implicit_replication():
    """``implicit_replication`` that restores the setting it found, so
    scopes nest (the library's turns it off on every exit)."""
    from torch.distributed.tensor import DTensor
    disp = DTensor._op_dispatcher
    prev = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = prev


def mesh_scope(ctx):
    """Under a mesh ctx, plain tensors made inside a step (positions, masks,
    zero accumulators) count as replicated when they meet a DTensor;
    otherwise nothing."""
    if not has_mesh(ctx) or not hasattr(ctx.mesh, "device_type"):
        return contextlib.nullcontext()
    return _implicit_replication()
