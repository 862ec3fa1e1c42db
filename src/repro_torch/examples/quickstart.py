"""Quickstart: one secure hierarchical sat-QFL round, end to end (the
port's twin of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Walks the public API surface:
  1. derive a constellation trace (orbits -> LoS -> roles)
  2. build the paper's VQC workload on synthetic Statlog
  3. run hierarchical rounds in each schedule, QKD-secured
  4. print the round metrics a deployment would monitor

It runs on the GPU unless ``--device cpu`` is given; the VQC's gate layers
and the QKD exchanges' OTP + MAC run as the port's CUDA kernels there.
"""
from __future__ import annotations

import argparse

from repro_torch.constellation import build_trace, partition_roles
from repro_torch.core import SatQFLConfig, SatQFLTrainer
from repro_torch.data import dirichlet_partition, make_statlog, server_split
from repro_torch.device import resolve_device
from repro_torch.examples._out import Printer
from repro_torch.models import get_config, get_model


def main(argv=None) -> dict:
    """Run the example; returns {"lines": what it printed, "metrics":
    {mode: the last round's RoundMetrics}}."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sats", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--local-steps", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    say = Printer()

    n_sats = args.sats
    say("== sat-QFL quickstart ==")
    trace = build_trace(n_sats=n_sats, n_planes=4, duration_s=3600,
                        step_s=60, device=dev)
    p, s = partition_roles(trace, 0)
    say(f"constellation: {n_sats} satellites -> {len(p)} primary / "
        f"{len(s)} secondary at t0")

    cfg = get_config("vqc-satqfl").replace(vqc_qubits=4, vqc_layers=2,
                                           n_features=4)
    api = get_model(cfg)
    X, y = make_statlog(n_features=4, device=dev)
    Xc, yc, server = server_split(X, y)
    sats = dirichlet_partition(Xc, yc, n_sats)
    say(f"data: statlog-synthetic {tuple(X.shape)} -> {n_sats} non-IID "
        f"shards")

    metrics = {}
    for mode in ("sim", "seq", "async"):
        fl = SatQFLConfig(mode=mode, n_rounds=args.rounds,
                          local_steps=args.local_steps, batch_size=16,
                          security="qkd")
        tr = SatQFLTrainer(cfg, api, fl, trace, sats, server, device=dev)
        hist = tr.run()
        m = metrics[mode] = hist[-1]
        say(f"mode={mode:5s} | val_acc={m.server_val_acc:.3f} "
            f"val_loss={m.server_val_loss:.3f} "
            f"comm={sum(h.comm_s for h in hist):.2f}s "
            f"(security {sum(h.security_s for h in hist):.2f}s) "
            f"participants={m.participants}")
    say("done.")
    return {"lines": say.lines, "metrics": metrics}


if __name__ == "__main__":
    main()
