#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card. It builds
the hand-written CUDA kernels from the sources in the checkout (one nvcc
per source, all at once) and then:

1. prints the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, and the kernels' build time;
2. holds the fused gate-layer kernel against its plain PyTorch version on
   the card at nq ∈ {1, 2, 5, 8, 10, 13} and at the trainer's shapes
   (ansatz G=64 clients × S=32 samples, encoding G=2048 × S=1, nq=8):
   max abs error ≤ 1e-5 on both planes, norms preserved to 1e-5; and times
   the kernel, the plain version and one batched complex matmul with the
   kron'ed layer unitary (the library yardstick, used nowhere in the port)
   with CUDA events over back-to-back calls, and the kernel alone on the
   device with ``torch.profiler``;
3. holds the fused OTP-XOR + MAC kernel against its plain version, bit
   for bit, in both tag modes, through the rows entry (the trainer's stage
   (64, 62), a multi-block (5, 16389), the bandwidth shape (64, 2^20)),
   the stream entry (62 and 16384·4+7 words) and the padded-convention
   wrappers; times the kernel and the plain version at those shapes;
4. runs the trainer at full width — the paper's 50-satellite / 10-plane
   trace over 6 h at 30 s, the 8-qubit 3-layer VQC, synthetic Statlog over
   50 Dirichlet shards — on every path of the port: qfl and sim without
   security (2 rounds each), qfl and sim under ``security="qkd"`` (3 rounds
   each), sim under ``qkd_fernet`` (2 rounds) and sim qkd on the per-edge
   oracle (``edge_batched=False``, 3 rounds, bit-exact against the
   edge-batched run). Every launch count is set to 0 just before each path
   and read just after; each path must launch each of its kernels, and
   every round's val loss must be finite and below 10 (≈ ln 7);
5. runs the sim trainer for 2 rounds on the CPU (plain path) and on the
   card, without security and under qkd, and holds the metrics within
   1e-4 and the accounting exactly equal; and one drop-mode round with
   forced eavesdroppers on both, whose aborted edges must agree;
6. profiles one warm secure sim round with ``torch.profiler`` and prints
   the device-busy share and the kernels that take the most device time.

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
# H100 SXM 32-bit integer rate: 64 INT32 lanes per SM (half the float32
# lanes, Hopper architecture white paper) x 132 SMs x 1.98 GHz boost
INT32_OPS = 64 * 132 * 1.98e9
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


OTP_ROW_SHAPES = {"stage": (64, 62), "multiblock": (5, 16389),
                  "bandwidth": (64, 1 << 20)}
OTP_STREAM_SHAPES = {"edge": 62, "stream": 16384 * 4 + 7}
OTP_SOURCE = "src/repro_torch/kernels/otp_xor/csrc/otp_xor.cu"


def _words(torch, shape, seed):
    """Random u32 words in int32 bit storage, made on the card."""
    g = torch.Generator("cuda").manual_seed(seed)
    return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                         device="cuda", generator=g)


def _otp_gap(torch, got, want) -> int:
    """Largest |difference| of ciphertext words and tags (0 = bit-exact)."""
    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               for a, b in zip(got, want))


def _otp_bound(rows: int, n: int) -> dict:
    """Least time for XOR + MAC of rows × n words: msg and pad read, ct
    written (12 B a word) plus keys and tags; one XOR and two modular
    multiply-adds (5 integer ops) a word."""
    n_bytes = 12 * rows * n + 12 * rows
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 5 * rows * n / INT32_OPS * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bytes_ms": bytes_ms,
            "ops_ms": ops_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def phase_otp_kernel(torch, ops, ref):
    """The fused OTP-XOR + MAC kernel vs plain, bit for bit; timings."""
    worst = {"otp_xor_mac_edges": 0, "otp_xor_mac": 0}
    timings = {"otp_xor_mac_edges": {}, "otp_xor_mac": {}}
    for i, (name, (E, n)) in enumerate(OTP_ROW_SHAPES.items()):
        msg, pad = _words(torch, (E, n), 10 * i), _words(torch, (E, n),
                                                         10 * i + 1)
        rk, sk = _words(torch, (E,), 10 * i + 2), _words(torch, (E,),
                                                         10 * i + 3)
        for tag_input in (False, True):
            got = ops.otp_xor_mac_rows(msg, pad, rk, sk, tag_input)
            want = ref.otp_xor_mac_rows_ref(msg, pad, rk, sk, tag_input)
            torch.cuda.synchronize()
            gap = _otp_gap(torch, got, want)
            print(f"otp rows check {name} E={E} n={n} "
                  f"tag_input={tag_input}: max_abs_err={gap}")
            worst["otp_xor_mac_edges"] = max(worst["otp_xor_mac_edges"], gap)
        big = E * n > 1 << 24
        call = lambda: ops.otp_xor_mac_rows(msg, pad, rk, sk)
        t = {"shape": [E, n], "ms": _cuda_ms(torch, call, 20 if big else 200),
             "device_ms": _kernel_device_ms(torch, call,
                                            "otp_xor_mac_kernel", 20),
             "plain_ms": _cuda_ms(torch, lambda: ref.otp_xor_mac_rows_ref(
                 msg, pad, rk, sk), 3 if big else 20),
             **_otp_bound(E, n)}
        timings["otp_xor_mac_edges"][name] = t
        print(f"otp rows timing {name}: " + json.dumps(t))
        del msg, pad
    for i, (name, n) in enumerate(OTP_STREAM_SHAPES.items()):
        msg, pad = _words(torch, (n,), 100 + i), _words(torch, (n,), 200 + i)
        keys = _words(torch, (2,), 300 + i).tolist()
        for tag_input in (False, True):
            got = ops.otp_xor_mac_stream(msg, pad, keys[0], keys[1],
                                         tag_input)
            kt = torch.tensor(keys, dtype=torch.int32, device="cuda")
            ct, tag = ref.otp_xor_mac_rows_ref(msg[None], pad[None], kt[:1],
                                               kt[1:], tag_input)
            torch.cuda.synchronize()
            gap = _otp_gap(torch, got, (ct[0], tag[0]))
            print(f"otp stream check {name} n={n} tag_input={tag_input}: "
                  f"max_abs_err={gap}")
            worst["otp_xor_mac"] = max(worst["otp_xor_mac"], gap)
        call = lambda: ops.otp_xor_mac_stream(msg, pad, keys[0], keys[1])
        t = {"shape": [n], "ms": _cuda_ms(torch, call, 200),
             "device_ms": _kernel_device_ms(torch, call,
                                            "otp_xor_mac_kernel", 20),
             "plain_ms": _cuda_ms(torch, lambda: ref.otp_xor_mac_rows_ref(
                 msg[None], pad[None], kt[:1], kt[1:]), 20),
             **_otp_bound(1, n)}
        timings["otp_xor_mac"][name] = t
        print(f"otp stream timing {name}: " + json.dumps(t))
    # the JAX wrappers' convention: zero-padded to whole 16384-word blocks,
    # tag over the padded stream
    E, n = 5, 16389
    msg, pad = _words(torch, (E, n), 400), _words(torch, (E, n), 401)
    rk, sk = _words(torch, (E,), 402), _words(torch, (E,), 403)
    padded = 2 * 16384
    F = torch.nn.functional
    ct, tags = ref.otp_xor_mac_rows_ref(F.pad(msg, (0, padded - n)),
                                        F.pad(pad, (0, padded - n)), rk, sk)
    gap_e = _otp_gap(torch, ops.otp_xor_mac_edges(msg, pad, rk, sk),
                     (ct[:, :n], tags))
    gap_s = _otp_gap(torch, ops.otp_xor_mac(msg[3], pad[3], int(rk[3]),
                                            int(sk[3])), (ct[3, :n], tags[3]))
    print(f"otp padded wrappers: edges max_abs_err={gap_e}, "
          f"stream max_abs_err={gap_s}")
    worst["otp_xor_mac_edges"] = max(worst["otp_xor_mac_edges"], gap_e)
    worst["otp_xor_mac"] = max(worst["otp_xor_mac"], gap_s)
    if any(worst.values()):
        raise PhaseError(f"otp_xor kernel disagrees with plain: {worst}")
    return worst, timings


# name -> (mode, security, rounds, edge_batched)
TRAINER_PATHS = {
    "qfl": ("qfl", "none", 2, True),
    "sim": ("sim", "none", 2, True),
    "qfl_qkd": ("qfl", "qkd", 3, True),
    "sim_qkd": ("sim", "qkd", 3, True),
    "sim_qkd_fernet": ("sim", "qkd_fernet", 2, True),
    "sim_qkd_oracle": ("sim", "qkd", 3, False),
}


def _counts(sv_ops, otp_ops) -> dict:
    return {"statevec_gate_layer": sv_ops.LAUNCHES, **otp_ops.LAUNCHES}


def _reset(sv_ops, otp_ops):
    sv_ops.LAUNCHES = 0
    for k in otp_ops.LAUNCHES:
        otp_ops.LAUNCHES[k] = 0


def phase_trainer(torch, sv_ops, otp_ops, trace, sats, server):
    """Every trainer path of the port at full width; counts each path's
    launches of each kernel, set to 0 just before the path and read just
    after. Holds the edge-batched secure plane against its per-edge
    oracle, bit for bit."""
    from repro_torch.core import SatQFLConfig, SatQFLTrainer
    from repro_torch.models import get_config, get_model
    cfg = get_config("vqc-satqfl")
    api = get_model(cfg)
    report, launches, finals = {}, {}, {}
    for path, spec in TRAINER_PATHS.items():
        mode, security, n_rounds, edge_batched = spec
        fl = SatQFLConfig(mode=mode, security=security, n_rounds=n_rounds,
                          local_steps=10, batch_size=32)
        t0 = time.perf_counter()
        tr = SatQFLTrainer(cfg, api, fl, trace, sats, server,
                           edge_batched=edge_batched, device="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        rounds = []
        _reset(sv_ops, otp_ops)
        for r in range(n_rounds):
            before = _counts(sv_ops, otp_ops)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = tr.run_round(r)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            rounds.append({
                "round": r, "seconds": dt,
                "launches": {k: v - before[k] for k, v in
                             _counts(sv_ops, otp_ops).items()},
                "val_loss": m.server_val_loss, "val_acc": m.server_val_acc,
                "participants": m.participants, "comm_s": m.comm_s,
                "security_s": m.security_s})
            print(f"trainer {path} " + json.dumps(rounds[-1]))
            if not (math.isfinite(m.server_val_loss)
                    and m.server_val_loss < 10.0):
                raise PhaseError(f"{path} round {r}: val loss "
                                 f"{m.server_val_loss}")
        launches[path] = _counts(sv_ops, otp_ops)
        needed = ["statevec_gate_layer"] + (
            [] if security == "none" else
            ["otp_xor_mac_edges" if edge_batched else "otp_xor_mac"])
        for k in needed:
            if launches[path][k] == 0:
                raise PhaseError(f"the {path} trainer never launched {k}")
        report[path] = {"setup_s": setup_s, "rounds": rounds}
        finals[path] = tr
    a, b = finals["sim_qkd"], finals["sim_qkd_oracle"]
    for k in a.global_params:
        if not torch.equal(a.global_params[k].view(torch.int32),
                           b.global_params[k].view(torch.int32)):
            raise PhaseError(f"edge-batched and per-edge params differ: {k}")
    for ma, mb in zip(a.history, b.history):
        if ((ma.comm_s, ma.security_s, ma.participants)
                != (mb.comm_s, mb.security_s, mb.participants)):
            raise PhaseError(f"edge-batched and per-edge accounting differ "
                             f"at round {ma.round}")
    print("trainer: edge-batched == per-edge oracle, bit-exact params and "
          "equal accounting over 3 sim qkd rounds")
    return launches, report


def phase_cross_device(torch, trace, sats, server):
    """The same runs on the CPU (plain path) and on the card: sim without
    security (1 round) and under qkd (2 rounds) within 1e-4 and with
    equal accounting; one drop-mode round with forced eavesdroppers on
    every edge of satellites 0-4, whose aborted edges must agree."""
    from repro_torch.core import SatQFLConfig, SatQFLTrainer
    from repro_torch.models import get_config, get_model
    from repro_torch.security import canonical_edge
    cfg = get_config("vqc-satqfl")
    eav = frozenset(canonical_edge((a, b)) for a in range(5)
                    for b in list(range(50)) + ["gs"] if a != b)
    cases = {"sim": (dict(security="none", n_rounds=1), frozenset()),
             "sim_qkd": (dict(security="qkd", n_rounds=2), frozenset()),
             "sim_qkd_drop": (dict(security="qkd", n_rounds=1,
                                   on_qber_abort="drop"), eav)}
    worst = {}
    for name, (kw, eavs) in cases.items():
        fl = SatQFLConfig(mode="sim", local_steps=10, batch_size=32, **kw)
        runs = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            tr = SatQFLTrainer(cfg, get_model(cfg), fl, trace, sats, server,
                               eavesdrop_edges=eavs, device=dev)
            tr.run()
            runs[dev] = tr
            print(f"cross-device {name} {dev}: "
                  f"{time.perf_counter() - t0:.1f} s")
        a, b = runs["cuda"], runs["cpu"]
        gap = 0.0
        for ma, mb in zip(a.history, b.history):
            for f in ("server_val_loss", "server_val_acc", "server_test_acc",
                      "dev_train_acc", "dev_val_loss"):
                gap = max(gap, abs(getattr(ma, f) - getattr(mb, f)))
            if ((ma.comm_s, ma.security_s, ma.participants)
                    != (mb.comm_s, mb.security_s, mb.participants)):
                raise PhaseError(f"{name}: accounting differs at round "
                                 f"{ma.round}")
        for f in ("bytes_moved", "n_transfers", "round_details"):
            if getattr(a.log, f) != getattr(b.log, f):
                raise PhaseError(f"{name}: CommLog.{f} differs between "
                                 f"cuda and cpu")
        if a.aborted_edges != b.aborted_edges:
            raise PhaseError(f"{name}: aborted edges differ between cuda "
                             f"and cpu")
        if eavs and not a.aborted_edges:
            raise PhaseError(f"{name}: no edge aborted under eavesdropping")
        print(f"cross-device {name}: max metric gap {gap:.3e}, "
              f"{len(a.aborted_edges)} aborted edges on both")
        if gap > 1e-4:
            raise PhaseError(f"{name}: cuda and cpu metrics differ by {gap}")
        worst[name] = gap
    return worst


def phase_profile(torch, trace, sats, server):
    """Where a round's time goes: torch.profiler over one warm secure sim
    round (``security="qkd"``, the edge-batched plane).

    Measurement only (the profiler's own overhead inflates the round); a
    profiler that records no device time prints "not measured".
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import SatQFLConfig, SatQFLTrainer
    from repro_torch.models import get_config, get_model
    cfg = get_config("vqc-satqfl")
    fl = SatQFLConfig(mode="sim", security="qkd", n_rounds=2, local_steps=10,
                      batch_size=32)
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
        from repro_torch.kernels import build as kbuild
        from repro_torch.kernels.otp_xor import build as otp_build
        from repro_torch.kernels.otp_xor import ops as otp_ops
        from repro_torch.kernels.otp_xor import ref as otp_ref
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
    kbuild.build(build.SOURCE, otp_build.SOURCE)     # one nvcc each, at once
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")

    max_err, timings = phase_kernel(torch, ops, ref)
    otp_err, otp_timings = phase_otp_kernel(torch, otp_ops, otp_ref)
    t0 = time.perf_counter()
    trace = build_trace(n_sats=50, n_planes=10, device="cuda")
    sats, server = _data(torch, 50)
    print(f"trace + data: {time.perf_counter() - t0:.1f} s")
    launches, report = phase_trainer(torch, ops, otp_ops, trace, sats,
                                     server)
    print(f"trainer launches by path: {json.dumps(launches)}")
    print("trainer report: " + json.dumps(report))
    phase_cross_device(torch, trace, sats, server)
    phase_profile(torch, trace, sats, server)

    t = timings["ansatz"]
    entries = [{
        "name": "statevec_gate_layer", "route": "cuda",
        "source": "src/repro_torch/kernels/statevec_gate/csrc/statevec_gate.cu",
        "replaces": "src/repro/kernels/statevec_gate/kernel.py:170",
        "max_abs_err": max_err,
        "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"], "device_ms": t["device_ms"],
    }]
    # the otp kernel at the shape its entry meets on the trainer's path:
    # a secure stage's (64, 62) rows; one edge's 62-word stream
    for name, replaces, main_shape in (
            ("otp_xor_mac_edges", "kernel.py:98", "stage"),
            ("otp_xor_mac", "kernel.py:131", "edge")):
        t = otp_timings[name][main_shape]
        entries.append({
            "name": name, "route": "cuda", "source": OTP_SOURCE,
            "replaces": "src/repro/kernels/otp_xor/" + replaces,
            "max_abs_err": otp_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "device_ms": t["device_ms"], "shapes": otp_timings[name]})
    for entry in entries:
        by_path = {p: c[entry["name"]] for p, c in launches.items()}
        entry["launches"] = sum(by_path.values())
        entry["launches_by_path"] = by_path
        # the same numbers again in microseconds, under the key names that
        # PERF.md's tables use; derived here so the two never disagree
        entry["max_err"] = entry["max_abs_err"]
        for us_key, ms_key in (("kernel_us", "ms"), ("plain_us", "plain_ms"),
                               ("library_us", "library_ms"),
                               ("bound_us", "bound_ms")):
            v = entry[ms_key]
            entry[us_key] = None if v is None else v * 1e3
    print(json.dumps({"kernels": entries}))
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
