"""Async v2 + dropout scenarios: the compiled bounded-staleness buffer
with dropout-tolerant secure aggregation (the port's twin of
``examples/async_dropout.py``).

Runs the asynchronous schedule over a Starlink-like trace three ways —

  * plain async v2 (compiled ring buffer, staleness-aware merges),
  * secagg: pairwise-masked quantized updates (nothing readable per-sat),
  * secagg under attack: one satellite's edges are eavesdropped, QBER
    aborts drop it mid-round, and its lingering pairwise masks are
    cancelled exactly from the surviving rows —

and prints the staleness histogram the plan compiled plus per-round
delivery/wait accounting.

    PYTHONPATH=src python -m repro_torch.examples.async_dropout \\
        [--sats 16] [--device cpu]

It runs on the GPU unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.constellation import build_trace
from repro_torch.core import SatQFLConfig, SatQFLTrainer
from repro_torch.data import dirichlet_partition, make_statlog, server_split
from repro_torch.device import resolve_device
from repro_torch.examples._out import Printer
from repro_torch.models import get_config, get_model


def main(argv=None) -> dict:
    """Run the example; returns {"lines": what it printed, "metrics":
    {scenario: the last round's RoundMetrics}}."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sats", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    say = Printer()

    cfg = get_config("vqc-satqfl").replace(vqc_qubits=4, vqc_layers=1,
                                           n_features=4)
    api = get_model(cfg)
    X, y = make_statlog(n_features=4, device=dev)
    Xc, yc, server = server_split(X, y)
    trace = build_trace(n_sats=args.sats, n_planes=max(args.sats // 4, 1),
                        duration_s=3600, step_s=60, device=dev)
    sats = dirichlet_partition(Xc, yc, args.sats)

    scenarios = {
        "async-v2": dict(),
        "secagg": dict(agg_security="secagg"),
        "secagg+eavesdrop": dict(agg_security="secagg", security="qkd",
                                 on_qber_abort="drop"),
    }
    eav = frozenset((1, m) for m in range(args.sats) if m != 1)

    metrics = {}
    for label, kw in scenarios.items():
        fl = SatQFLConfig(mode="async", n_rounds=args.rounds,
                          local_steps=args.local_steps, batch_size=16,
                          eval_every=args.rounds - 1, **kw)
        tr = SatQFLTrainer(cfg, api, fl, trace, sats, server,
                           eavesdrop_edges=(eav if "eavesdrop" in label
                                            else frozenset()),
                           device=dev)
        hist = tr.run()
        st = tr.plan.stale
        borns = st.merge_born[st.merge_born >= 0]
        rounds_of = np.nonzero(st.merge_born >= 0)[0]
        staleness = np.bincount((rounds_of - borns).astype(int),
                                minlength=fl.max_staleness + 1)
        m = metrics[label] = hist[-1]
        say(f"\n== {label} ==")
        say(f"  sends compiled      : {int((st.send_slot >= 0).sum())}")
        say(f"  merged deliveries   : {int((st.merge_born >= 0).sum())}"
            f"  (staleness 1..Δ: {staleness[1:].tolist()})")
        trained = sum(len(secs) for r in range(fl.n_rounds)
                      for secs in tr.plan.groups(r).values())
        say(f"  window-dropped      : "
            f"{trained - int((st.send_slot >= 0).sum())} of {trained} "
            f"trained updates never transmitted")
        say(f"  QBER-aborted edges  : {sorted(tr.aborted_edges)}")
        say(f"  total wait / comm s : {tr.log.wait_s:.1f} / "
            f"{tr.log.total_s:.1f}")
        say(f"  final val acc       : {m.server_val_acc:.3f}")
    return {"lines": say.lines, "metrics": metrics}


if __name__ == "__main__":
    main()
