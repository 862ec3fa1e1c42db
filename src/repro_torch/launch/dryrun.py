"""Multi-pod dry-run (port of ``repro.launch.dryrun``): trace every
(architecture × input shape) step on the production mesh without
allocating a parameter or touching a GPU.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --out DIR

The process joins a fake process group (``torch.testing._internal``'s
``FakeStore``, backend ``"fake"``: collectives return at once) of the
mesh's 256 or 512 ranks as rank 0, places the bundle's parameters,
optimizer state, batch and cache as DTensors by their specs over *meta*
local shards (shapes and dtypes, no storage), and runs the step once:
DTensor's sharding propagation partitions it as GSPMD partitions the JAX
package's, the kernels and the MoE run on local shards, and the plain
versions run on the meta shards. (Meta shards rather than
``FakeTensorMode``: DTensor's redistribution planner reads index tensors
it builds with ``torch.arange``, which fake mode makes data-less.)

Per combo it prints and records:
  * the analytic per-rank memory estimate, the fits gate against
    ``HBM_PER_CHIP`` (one H100 80GB HBM3, as ``torch.cuda`` reports it);
  * the collectives the trace issued on rank 0, bytes per kind;
  * the FLOPs and bytes of the local ops rank 0 ran;
  * the roofline terms (``launch.analysis``).

A failure here (a sharding with no rule, a shape mismatch, a collective
that does not fit) is a bug in the system, not in the run: the exit code
is 1.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_flatten
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.shapes import INPUT_SHAPES, shape_for, supports_shape
from repro_torch.launch.analysis import (analytic_memory_per_chip, analyze,
                                         collective_kind, format_roofline_row)
from repro_torch.launch.mesh import data_axes_for, make_production_mesh
from repro_torch.launch.steps import abstract_params, build_bundle
from repro_torch.models.registry import ARCH_IDS, get_config, get_model
from repro_torch.nn.pytree import tree_leaves
from repro_torch.sharding.context import DistCtx
from repro_torch.sharding.specs import distribute_tree

#: ``torch.cuda.get_device_properties(0).total_memory`` of an NVIDIA H100
#: 80GB HBM3 (chip_smoke.py phase 17 reads it on the card)
HBM_PER_CHIP = 85_017_493_504


def combos(archs=None, shapes=None):
    archs = archs or [a for a in ARCH_IDS if a != "vqc-satqfl"]
    shapes = shapes or list(INPUT_SHAPES)
    for a in archs:
        cfg = get_config(a)
        for s in shapes:
            if not supports_shape(cfg, shape_for(s)):
                continue
            yield a, s


def fake_world(n: int):
    """Join a fake process group of ``n`` ranks as rank 0 (replacing one
    of another size)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor) and not isinstance(t, DTensor))


class StepRecorder(TorchDispatchMode):
    """Records, while active, the collectives a step issues on this rank
    (``events``: ``(kind, result bytes)``) and the FLOPs and bytes of the
    local ops it runs: a DTensor op is handed back to DTensor, whose local
    ops and redistributions then come through here."""

    def __init__(self):
        super().__init__()
        self.events, self.flops, self.bytes = [], 0, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = tree_flatten(out)[0]
        if func.namespace.startswith("_c10d_functional"):
            kind = collective_kind(func.__name__)
            if kind is not None:
                self.events.append((kind, _nbytes(outs)))
            return out
        if func._overloadpacket in flop_registry:
            self.flops += int(flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out))
        if not func.is_view:
            self.bytes += _nbytes(tree_flatten((args, kwargs))[0]) + \
                _nbytes(outs)
        return out


def _traced_peak(step_fn, args, rec: StepRecorder):
    """Run ``step_fn(*args)`` once under ``rec`` and
    ``torch.distributed._tools.mem_tracker``: the per-rank peak of the
    live local shards (the arguments' included), in bytes, or None where
    the tracker gives none."""
    from torch.distributed._tools.mem_tracker import MemTracker
    mt = MemTracker()
    mt.track_external(*[t.to_local() for t in tree_leaves(args)])
    with torch.no_grad(), rec, mt:
        step_fn(*args)
    snap = mt.get_tracker_snapshot("peak")
    return max((d.get("Total", 0) for d in snap.values()), default=None)


def _auto_fsdp(arch: str) -> bool:
    """Models whose TP-sharded weights alone crowd a card shard their
    parameters over the data axes too: the 34B+ archs."""
    cfg = get_config(arch)
    nbytes = sum(l.numel() * l.element_size()
                 for l in tree_leaves(abstract_params(cfg, get_model(cfg))))
    return nbytes > 40e9


def run_one(arch: str, shape_name: str, multi_pod: bool, fsdp=None,
            optimizer: str = "sgd", strategy: str = "tp",
            seq_attn: bool = False, verbose: bool = True) -> dict:
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    mesh_name = "multi" if multi_pod else "single"
    n_chips = mesh.size()
    if fsdp is None:
        fsdp = _auto_fsdp(arch)
    ctx = DistCtx(mesh=mesh, data_axes=data_axes_for(mesh), fsdp=fsdp,
                  strategy=strategy, seq_shard=(strategy == "tp"),
                  seq_attn=seq_attn)
    t0 = time.time()
    bundle = build_bundle(arch, shape_name, ctx, optimizer=optimizer)
    args = tuple(distribute_tree(a, s, mesh)
                 for a, s in zip(bundle.arg_shapes, bundle.in_specs))
    rec = StepRecorder()
    peak = _traced_peak(bundle.step_fn, args, rec)
    trace_s = time.time() - t0

    shape = shape_for(shape_name)
    roof = analyze(arch, shape_name, mesh_name, n_chips,
                   {"collectives": rec.events, "traced_flops": rec.flops,
                    "traced_bytes": rec.bytes, "peak_bytes": peak},
                   bundle.cfg, bundle.api, shape)
    amem = analytic_memory_per_chip(bundle.cfg, bundle.api, shape, n_chips,
                                    ctx.model_size, ctx.data_size, fsdp)
    fits = amem["total"] <= HBM_PER_CHIP
    fits_measured = None if peak is None else peak <= HBM_PER_CHIP
    rec_d = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "mode": bundle.mode, "n_chips": n_chips, "fsdp": fsdp,
        "optimizer": optimizer, "strategy": strategy, "seq_attn": seq_attn,
        "trace_s": round(trace_s, 1),
        "fits_hbm": bool(fits),
        "fits_hbm_measured": fits_measured,
        "analytic_mem_per_chip": {k: round(v / 2**30, 3)
                                  for k, v in amem.items()},
        **roof.to_dict(),
    }
    if verbose:
        print(f"[dryrun] {arch} × {shape_name} × {mesh_name} "
              f"({bundle.mode}, {n_chips} ranks)")
        print(f"  {format_roofline_row(roof)}")
        print(f"  collectives: {roof.coll_breakdown}")
        print(f"  traced/rank: {rec.flops:.4g} FLOPs, "
              f"{rec.bytes:.4g} bytes")
        print(f"  analytic/chip: "
              f"{ {k: round(v / 2**30, 2) for k, v in amem.items()} } GiB")
        print(f"  fits {HBM_PER_CHIP / 2**30:.2f} GiB/chip: {fits} "
              f"(analytic; traced peak {fits_measured})   trace "
              f"{trace_s:.1f}s")
    return rec_d


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--fsdp", action="store_true", default=None,
                    help="force FSDP (default: auto for 34B+ archs)")
    ap.add_argument("--optimizer", default="sgd")
    ap.add_argument("--strategy", default="tp", choices=["tp", "dp"])
    ap.add_argument("--seq-attn", action="store_true",
                    help="seq-sharded queries through attention")
    ap.add_argument("--out", default=None, help="JSON output path or dir")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        pairs = list(combos())
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        pairs = [(args.arch, args.shape)]

    t0 = time.time()
    records, failures = [], []
    for arch, shape in pairs:
        for mp in meshes:
            try:
                records.append(run_one(arch, shape, mp, fsdp=args.fsdp,
                                       optimizer=args.optimizer,
                                       strategy=args.strategy,
                                       seq_attn=args.seq_attn))
            except Exception as e:  # noqa: BLE001 — report and continue
                traceback.print_exc()
                failures.append({"arch": arch, "shape": shape,
                                 "mesh": "multi" if mp else "single",
                                 "error": repr(e)})

    if args.out:
        out = args.out
        if not out.endswith(".json"):
            os.makedirs(out, exist_ok=True)
            tag = (pairs[0][0] + "_" + pairs[0][1] if len(pairs) == 1
                   else "all")
            out = os.path.join(out, f"dryrun_{tag}_{args.mesh}"
                                    f"{'_fsdp' if args.fsdp else ''}.json")
        with open(out, "w") as f:
            json.dump({"records": records, "failures": failures}, f,
                      indent=1)
        print(f"[dryrun] wrote {out}")

    print(f"[dryrun] {len(records)} ok, {len(failures)} failed "
          f"in {time.time() - t0:.1f}s")
    if dist.is_initialized():
        dist.destroy_process_group()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
