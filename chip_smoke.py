#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card. It builds
the hand-written CUDA kernel from the sources in the checkout and then:

1. prints the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, and the kernel's build time;
2. holds the fused gate-layer kernel against its plain PyTorch version on
   the card at nq ∈ {1, 2, 5, 8, 10, 13} and at the trainer's shapes
   (ansatz G=64 clients × S=32 samples, encoding G=2048 × S=1, nq=8):
   max abs error ≤ 1e-5 on both planes, norms preserved to 1e-5; and times
   the kernel, the plain version and one batched complex matmul with the
   kron'ed layer unitary (the library yardstick, used nowhere in the port)
   with CUDA events over back-to-back calls, and the kernel alone on the
   device with ``torch.profiler``;
3. runs the trainer at full width — the paper's 50-satellite / 10-plane
   trace over 6 h at 30 s, the 8-qubit 3-layer VQC, synthetic Statlog over
   50 Dirichlet shards — for 3 rounds each of modes qfl and sim, with the
   launch counter set to 0 just before each mode and read just after; every
   round's val loss must be finite and below 10 (≈ ln 7 for a sane run);
4. runs the sim trainer for 2 rounds on the CPU (plain path) and on the
   card, and holds the metrics within 1e-4 and the accounting exactly equal;
5. profiles one warm sim round with ``torch.profiler`` and prints the
   device-busy share and the kernels that take the most device time.

It prints one ``{"kernels": [...]}`` line, the card line, and as its last
line ``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout, it exits non-zero and prints no result. Any failed phase exits
non-zero.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
TOL = 1e-5
# the last two put group boundaries inside blocks, across many blocks
CHECK_SHAPES = [(4, 3, 1), (4, 3, 2), (4, 3, 5), (4, 3, 8), (3, 2, 10),
                (2, 2, 13), (64, 32, 8), (2048, 1, 8), (40, 3, 8),
                (9, 7, 10)]
MAIN_SHAPES = {"ansatz": (64, 32, 8), "encoding": (2048, 1, 8)}


class PhaseError(RuntimeError):
    pass


def _card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else (
        f"nvidia-smi failed: {out.stderr.strip()}")


def _cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of one call, from CUDA events over ``iters`` calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _dev_us(event) -> float:
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def _kernel_device_ms(torch, fn, kernel_name: str, iters: int):
    """Device time of one launch of the named kernel, from torch.profiler
    over ``iters`` calls; None where the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == DeviceType.CUDA
              and kernel_name in e.key]
    count = sum(e.count for e in events)
    total_us = sum(_dev_us(e) for e in events)
    return total_us / count / 1e3 if count and total_us > 0 else None


def _random_layer(torch, G, S, nq, seed):
    """Normalized random states and random unitary gate sets on the card."""
    g = torch.Generator().manual_seed(seed)
    st = torch.randn(G, S, 1 << nq, dtype=torch.complex64, generator=g)
    st = st / torch.linalg.norm(st, dim=-1, keepdim=True)
    th, ph, la = torch.rand(3, G, nq, generator=g) * 6.0 - 3.0
    c = torch.cos(th / 2).to(torch.complex64)
    s = torch.sin(th / 2).to(torch.complex64)
    e = lambda a: torch.exp(1j * a.to(torch.complex64))
    gates = torch.stack([torch.stack([c, -e(la) * s], -1),
                         torch.stack([e(ph) * s, e(ph + la) * c], -1)], -2)
    return (st.real.contiguous().cuda(), st.imag.contiguous().cuda(),
            gates.cuda())


def _kron_layer(torch, gates):
    """(G, nq, 2, 2) -> (G, 2^nq, 2^nq): gate q on qubit q, little-endian."""
    u = gates[:, 0]
    for q in range(1, gates.shape[1]):
        hi = gates[:, q]
        d = u.shape[-1]
        u = torch.einsum("ghk,gab->ghakb", hi, u).reshape(-1, 2 * d, 2 * d)
    return u


def phase_kernel(torch, ops, ref):
    """Kernel vs plain on the card; times at the trainer's shapes."""
    max_err = 0.0
    for i, (G, S, nq) in enumerate(CHECK_SHAPES):
        re, im, gates = _random_layer(torch, G, S, nq, seed=i)
        g8 = ops.pack_gates(gates)
        got = ops.apply_gate_layer(re, im, g8)
        want = ref.apply_layer_planes_ref(re, im, g8)
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        norm = (got[0] ** 2 + got[1] ** 2).sum(-1)
        norm_err = (norm - 1.0).abs().max().item()
        print(f"kernel check G={G} S={S} nq={nq}: max_abs_err={err:.3e} "
              f"norm_err={norm_err:.3e}")
        if not (err <= TOL and norm_err <= TOL):
            raise PhaseError(f"kernel disagrees at G={G} S={S} nq={nq}: "
                             f"err {err}, norm err {norm_err}")
        max_err = max(max_err, err)

    timings = {}
    for name, (G, S, nq) in MAIN_SHAPES.items():
        re, im, gates = _random_layer(torch, G, S, nq, seed=100)
        g8 = ops.pack_gates(gates)
        state = torch.complex(re, im)
        u_t = _kron_layer(torch, gates).transpose(-1, -2).contiguous()
        lib = torch.matmul(state, u_t)
        got = ops.apply_gate_layer(re, im, g8)
        lib_err = max((lib.real - got[0]).abs().max().item(),
                      (lib.imag - got[1]).abs().max().item())
        rows, dim = G * S, 1 << nq
        n_bytes = 2 * 4 * dim * rows * 2 + 4 * G * nq * 8
        n_flops = 28 * (dim // 2) * nq * rows
        layer = lambda: ops.apply_gate_layer(re, im, g8)
        t = {
            "kernel_ms": _cuda_ms(torch, layer, 200),
            "device_ms": _kernel_device_ms(torch, layer,
                                           "fused_layer_kernel", 50),
            "plain_ms": _cuda_ms(torch, lambda: ref.apply_layer_planes_ref(
                re, im, g8), 50),
            "library_ms": _cuda_ms(torch, lambda: torch.matmul(state, u_t),
                                   50),
            "bytes_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
            "flops_ms": n_flops / FP32_FLOPS * 1e3,
            "library_max_abs_err": lib_err,
        }
        t["bound_ms"] = max(t["bytes_ms"], t["flops_ms"])
        t["bound_by"] = ("bytes" if t["bytes_ms"] >= t["flops_ms"]
                         else "operations")
        timings[name] = t
        print(f"kernel timing {name} G={G} S={S} nq={nq}: " + json.dumps(t))
    return max_err, timings


def _data(torch, n_sats):
    from repro_torch.data import dirichlet_partition, make_statlog, server_split
    X, y = make_statlog(n_features=8, device="cuda")
    Xc, yc, server = server_split(X, y)
    return dirichlet_partition(Xc, yc, n_sats), server


def phase_trainer(torch, ops, trace, sats, server):
    """qfl and sim, 3 rounds each, at full width; counts each mode's launches.

    The launch count is set to 0 just before each mode's rounds and read
    just after, so each mode shows on its own that it ran the kernel.
    """
    from repro_torch.core import SatQFLConfig, SatQFLTrainer
    from repro_torch.models import get_config, get_model
    cfg = get_config("vqc-satqfl")
    api = get_model(cfg)
    report, launches = {}, {}
    for mode in ("qfl", "sim"):
        fl = SatQFLConfig(mode=mode, n_rounds=3, local_steps=10,
                          batch_size=32)
        tr = SatQFLTrainer(cfg, api, fl, trace, sats, server, device="cuda")
        rounds = []
        ops.LAUNCHES = 0
        for r in range(fl.n_rounds):
            l0 = ops.LAUNCHES
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = tr.run_round(r)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            rounds.append({"round": r, "seconds": dt,
                           "launches": ops.LAUNCHES - l0,
                           "val_loss": m.server_val_loss,
                           "val_acc": m.server_val_acc,
                           "participants": m.participants,
                           "comm_s": m.comm_s})
            print(f"trainer {mode} " + json.dumps(rounds[-1]))
            if not (math.isfinite(m.server_val_loss)
                    and m.server_val_loss < 10.0):
                raise PhaseError(f"{mode} round {r}: val loss "
                                 f"{m.server_val_loss}")
        launches[mode] = ops.LAUNCHES
        if launches[mode] == 0:
            raise PhaseError(f"the {mode} trainer never launched the kernel")
        report[mode] = rounds
    return launches, report


def phase_cross_device(torch, trace, sats, server):
    """sim, 2 rounds, on the CPU (plain path) and on the card."""
    from repro_torch.core import SatQFLConfig, SatQFLTrainer
    from repro_torch.models import get_config, get_model
    cfg = get_config("vqc-satqfl")
    fl = SatQFLConfig(mode="sim", n_rounds=2, local_steps=10, batch_size=32)
    runs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        tr = SatQFLTrainer(cfg, get_model(cfg), fl, trace, sats, server,
                           device=dev)
        tr.run()
        runs[dev] = tr
        print(f"cross-device {dev}: {time.perf_counter() - t0:.1f} s")
    a, b = runs["cuda"], runs["cpu"]
    worst = 0.0
    for ma, mb in zip(a.history, b.history):
        for f in ("server_val_loss", "server_val_acc", "server_test_acc",
                  "dev_train_acc", "dev_val_loss"):
            worst = max(worst, abs(getattr(ma, f) - getattr(mb, f)))
        if (ma.comm_s, ma.participants) != (mb.comm_s, mb.participants):
            raise PhaseError(f"accounting differs at round {ma.round}")
    for f in ("bytes_moved", "n_transfers", "round_details"):
        if getattr(a.log, f) != getattr(b.log, f):
            raise PhaseError(f"CommLog.{f} differs between cuda and cpu")
    print(f"cross-device max metric gap: {worst:.3e}")
    if worst > 1e-4:
        raise PhaseError(f"cuda and cpu metrics differ by {worst}")
    return worst


def phase_profile(torch, trace, sats, server):
    """Where a round's time goes: torch.profiler over one warm sim round.

    Measurement only (the profiler's own overhead inflates the round); a
    profiler that records no device time prints "not measured".
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import SatQFLConfig, SatQFLTrainer
    from repro_torch.models import get_config, get_model
    cfg = get_config("vqc-satqfl")
    fl = SatQFLConfig(mode="sim", n_rounds=2, local_steps=10, batch_size=32)
    tr = SatQFLTrainer(cfg, get_model(cfg), fl, trace, sats, server,
                       device="cuda")
    tr.run_round(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.run_round(1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side kernels only: the aten ops that launch them report the
    # same device time again
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == DeviceType.CUDA
              and _dev_us(e) > 0]
    busy_s = sum(_dev_us(e) for e in events) / 1e6
    if busy_s == 0:
        print("profile: not measured (the profiler recorded no device time)")
        return
    top = sorted(events, key=_dev_us, reverse=True)[:10]
    print("profile: " + json.dumps({
        "round_s_under_profiler": wall, "device_busy_s": busy_s,
        "device_busy_share": busy_s / wall,
        "device_ops": sum(e.count for e in events),
        "top": [{"name": e.key[:80], "device_ms": _dev_us(e) / 1e3,
                 "count": e.count} for e in top]}))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    try:
        from repro_torch.constellation import build_trace
        from repro_torch.kernels.statevec_gate import build, ops, ref
    except ImportError as err:
        print(f"chip_smoke: run from the root of a checkout ({err})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = _card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")

    max_err, timings = phase_kernel(torch, ops, ref)
    t0 = time.perf_counter()
    trace = build_trace(n_sats=50, n_planes=10, device="cuda")
    sats, server = _data(torch, 50)
    print(f"trace + data: {time.perf_counter() - t0:.1f} s")
    launches, report = phase_trainer(torch, ops, trace, sats, server)
    print(f"trainer launches by mode: {json.dumps(launches)}")
    print("trainer report: " + json.dumps(report))
    phase_cross_device(torch, trace, sats, server)
    phase_profile(torch, trace, sats, server)

    t = timings["ansatz"]
    entry = {
        "name": "statevec_gate_layer", "route": "cuda",
        "source": "src/repro_torch/kernels/statevec_gate/csrc/statevec_gate.cu",
        "replaces": "src/repro/kernels/statevec_gate/kernel.py:170",
        "launches": sum(launches.values()), "launches_by_path": launches,
        "max_abs_err": max_err,
        "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"], "device_ms": t["device_ms"],
    }
    # the same numbers again in microseconds, under the key names that
    # PERF.md's tables use; derived here so the two can never disagree
    entry["max_err"] = max_err
    for us_key, ms_key in (("kernel_us", "ms"), ("plain_us", "plain_ms"),
                           ("library_us", "library_ms"),
                           ("bound_us", "bound_ms")):
        entry[us_key] = entry[ms_key] * 1e3
    print(json.dumps({"kernels": [entry]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr)
        sys.exit(1)
