"""Round times of the trainer's secure paths of any checkout, so that two
commits compare in one GPU call.

    python3 tools/time_secure_round.py [--src DIR] [--rounds N]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (this
checkout's by default). The scenario is chip_smoke's (the paper's 50
satellites in 10 planes, the 8-qubit 3-layer VQC, 10 local steps of batch
32). For each of sim without security, sim under qkd edge-batched and sim
under qkd on the per-edge oracle it runs one warm-up round, then ``N``
rounds timed on the host clock (each ending in a synchronise), then one
more round under ``torch.profiler`` for its device-op count and busy
share; it prints one JSON line a path after the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (puts this checkout's src on the path)

PATHS = {"sim": dict(security="none"), "sim_qkd": dict(security="qkd"),
         "sim_qkd_oracle": dict(security="qkd", edge_batched=False)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=chip_smoke.ROOT / "src")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    import torch
    import repro_torch
    from repro_torch.constellation import build_trace
    from repro_torch.core import SatQFLConfig, SatQFLTrainer
    from repro_torch.models import get_config, get_model

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke._card_line())
    print(f"trainer from {Path(repro_torch.__file__).resolve().parent}")
    trace = build_trace(n_sats=50, n_planes=10, device="cuda")
    sats, server = chip_smoke._data(torch, 50)
    cfg = get_config("vqc-satqfl")
    for name, spec in PATHS.items():
        kw = dict(spec)
        edge_batched = kw.pop("edge_batched", True)
        fl = SatQFLConfig(mode="sim", n_rounds=args.rounds + 2,
                          local_steps=10, batch_size=32, **kw)
        tr = SatQFLTrainer(cfg, get_model(cfg), fl, trace, sats, server,
                           edge_batched=edge_batched, device="cuda")
        tr.run_round(0)
        seconds = []
        for r in range(1, args.rounds + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.run_round(r)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        prof = chip_smoke._device_profile(
            torch, lambda: tr.run_round(args.rounds + 1)) or {}
        print(json.dumps({"path": name, "round_s": seconds,
                          "device_ops": prof.get("device_ops"),
                          "device_busy_share": prof.get(
                              "device_busy_share")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
