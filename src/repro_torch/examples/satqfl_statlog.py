"""End-to-end driver: the paper's core experiment (Table IV) — all four
frameworks (QFL / QFL-Async / QFL-Seq / QFL-Sim) training the VQC on the
(synthetic) Statlog workload over a 50-satellite Starlink-like trace, a
few hundred aggregate local steps (the port's twin of
``examples/satqfl_statlog.py``).

    PYTHONPATH=src python -m repro_torch.examples.satqfl_statlog \\
        [--rounds 6] [--sats 50] [--out table4.json] [--device cpu]

It runs on the GPU unless ``--device cpu`` is given, and writes its table
as JSON only where ``--out`` says.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.constellation import build_trace
from repro_torch.core import SatQFLConfig, SatQFLTrainer
from repro_torch.data import (dirichlet_partition, make_eurosat,
                              make_statlog, server_split)
from repro_torch.device import resolve_device
from repro_torch.examples._out import Printer
from repro_torch.models import get_config, get_model

MODES = {"QFL": "qfl", "QFL-Async": "async", "QFL-Seq": "seq",
         "QFL-Sim": "sim"}


def run(dataset: str = "statlog", n_sats: int = 20, n_rounds: int = 8,
        local_steps: int = 8, qubits: int = 6, security: str = "none",
        seed: int = 0, modes=None, device=None) -> dict:
    """Table IV: each framework's server and device accuracy and loss and
    its cumulative communication time (the JAX package's
    ``benchmarks.bench_frameworks.run``)."""
    dev = resolve_device(device)
    cfg = get_config("vqc-satqfl").replace(
        vqc_qubits=qubits, vqc_layers=2, n_features=qubits,
        n_classes=7 if dataset == "statlog" else 10)
    api = get_model(cfg)
    if dataset == "statlog":
        X, y = make_statlog(n_features=qubits, seed=seed, device=dev)
    else:
        X, y = make_eurosat(n_features=qubits, seed=seed, n_samples=6000,
                            device=dev)
    Xc, yc, server = server_split(X, y, seed=seed)
    trace = build_trace(n_sats=n_sats, n_planes=5, duration_s=6 * 3600,
                        step_s=30, seed=seed, device=dev)
    sats = dirichlet_partition(Xc, yc, n_sats, seed=seed)

    table = {}
    for label, mode in (modes or MODES).items():
        fl = SatQFLConfig(mode=mode, n_rounds=n_rounds,
                          local_steps=local_steps, batch_size=32,
                          security=security, seed=seed)
        tr = SatQFLTrainer(cfg, api, fl, trace, sats, server, device=dev)
        hist = tr.run()
        mean = lambda f: float(np.nanmean([f(m) for m in hist]))
        table[label] = {
            "server_val_acc_avg": mean(lambda m: m.server_val_acc),
            "server_val_acc_final": hist[-1].server_val_acc,
            "server_test_acc_avg": mean(lambda m: m.server_test_acc),
            "server_test_acc_final": hist[-1].server_test_acc,
            "server_val_loss_avg": mean(lambda m: m.server_val_loss),
            "server_val_loss_final": hist[-1].server_val_loss,
            "dev_train_acc_avg": mean(lambda m: m.dev_train_acc),
            "dev_val_loss_avg": mean(lambda m: m.dev_val_loss),
            "comm_time_total_s": float(sum(m.comm_s for m in hist)),
            "security_time_total_s": float(sum(m.security_s
                                               for m in hist)),
            "participants_per_round": float(np.mean(
                [m.participants for m in hist])),
            "curve_val_acc": [m.server_val_acc for m in hist],
            "curve_val_loss": [m.server_val_loss for m in hist],
        }
    return {"dataset": dataset, "n_sats": n_sats, "n_rounds": n_rounds,
            "frameworks": table}


def main(argv=None) -> dict:
    """Run the example; returns {"lines": what it printed, "table": the
    ``run`` payload}."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--sats", type=int, default=50)
    ap.add_argument("--local-steps", type=int, default=8)
    ap.add_argument("--qubits", type=int, default=6)
    ap.add_argument("--dataset", default="statlog",
                    choices=["statlog", "eurosat"])
    ap.add_argument("--out", default=None, help="JSON output path")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    say = Printer()

    out = run(dataset=args.dataset, n_sats=args.sats, n_rounds=args.rounds,
              local_steps=args.local_steps, qubits=args.qubits,
              device=args.device)

    say(f"\n== sat-QFL frameworks on {args.dataset} "
        f"({args.sats} sats, {args.rounds} rounds) ==")
    say(f"{'framework':10s} {'valAcc':>7s} {'testAcc':>8s} "
        f"{'valLoss':>8s} {'comm(s)':>9s}")
    for label, fw in out["frameworks"].items():
        say(f"{label:10s} {fw['server_val_acc_final']:7.3f} "
            f"{fw['server_test_acc_final']:8.3f} "
            f"{fw['server_val_loss_final']:8.3f} "
            f"{fw['comm_time_total_s']:9.1f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        say(f"\nfull payload -> {args.out}")
    return {"lines": say.lines, "table": out}


if __name__ == "__main__":
    main()
