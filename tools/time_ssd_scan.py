"""Device time of kernel #7 (``ssd_scan``) of any checkout at chip_smoke's
SSD shapes, so that two commits compare in one GPU call.

    python3 tools/time_ssd_scan.py [--src DIR] [SHAPE ...]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (this
checkout's by default). Each SHAPE is a key of ``chip_smoke.SSD_SHAPES``
(default: the bf16 ones). Inputs, seeds and timing are chip_smoke's. Prints
the card's name and power limit, then one JSON line per shape: device ms,
event ms (host path included) and the device memory one call allocates
beyond its inputs (outputs and scratch).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (puts this checkout's src on the path)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=chip_smoke.ROOT / "src")
    ap.add_argument("shapes", nargs="*", default=[
        n for n, s in chip_smoke.SSD_SHAPES.items() if s[-1] == "bfloat16"])
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    import torch
    from repro_torch.kernels.ssd_scan import ops

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke._card_line())
    print(f"ssd_scan from {Path(ops.__file__).resolve()}")
    for i, name in enumerate(args.shapes):
        B, S, H, G, P, N, dtype = chip_smoke.SSD_SHAPES[name]
        inputs = chip_smoke._ssd_inputs(torch, B, S, H, G, P, N, dtype,
                                        seed=100 + i)
        call = lambda: ops.ssd_scan(*inputs, chunk=128)
        call()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        call()
        torch.cuda.synchronize()
        print(json.dumps({
            "shape": name, "dims": [B, S, H, G, P, N, dtype],
            "device_ms": chip_smoke._device_ms(torch, call, 10),
            "ms": chip_smoke._cuda_ms(torch, call, 20),
            "call_bytes": torch.cuda.max_memory_allocated() - base}))
        del inputs
    return 0


if __name__ == "__main__":
    sys.exit(main())
