"""Times of the gate-layer op (kernels #1 and #2 and the layer's backward)
of any checkout at the trainer's shapes, so that two commits compare in
one GPU call.

    python3 tools/time_gate_layer.py [--src DIR]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (this
checkout's by default). Inputs and timing are chip_smoke's: for each of
chip_smoke's ``MAIN_SHAPES``, the largest resident register (64, 32,
2^13) and the 14-qubit ansatz layer (64, 32, 2^14) it prints one JSON
line with the forward's device ms and event ms (host path included), and
the same for one forward + backward of the layer through autograd with
the state and the gates requiring grad (the trainer's ansatz layers 2
and 3), after the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (puts this checkout's src on the path)

# chip_smoke's #1 shapes, the largest resident register and the 14-qubit
# ansatz layer (#2)
SHAPES = {**chip_smoke.MAIN_SHAPES, "nq13_resident": (64, 32, 13),
          "nq14_ansatz": (64, 32, 14)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=chip_smoke.ROOT / "src")
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    import torch
    from repro_torch.kernels.statevec_gate import ops

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke._card_line())
    print(f"gate layer from {Path(ops.__file__).resolve()}")
    for name, (G, S, nq) in SHAPES.items():
        re, im, gates = chip_smoke._random_layer(torch, G, S, nq, seed=100)
        g8 = ops.pack_gates(gates)
        w = torch.randn(2, G, S, 1 << nq, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(1))
        big = nq > 12
        fwd = lambda: ops.apply_gate_layer(re, im, g8)

        def step():
            xs = [x.detach().requires_grad_(True) for x in (re, im, g8)]
            out = ops.apply_gate_layer(*xs)
            torch.autograd.backward(out, (w[0], w[1]))

        print(json.dumps({
            "shape": name, "dims": [G, S, 1 << nq],
            "fwd_device_ms": chip_smoke._device_ms(torch, fwd, 10 if big
                                                   else 50),
            "fwd_ms": chip_smoke._cuda_ms(torch, fwd, 20 if big else 200),
            "step_device_ms": chip_smoke._device_ms(torch, step, 3 if big
                                                    else 20),
            "step_ms": chip_smoke._cuda_ms(torch, step, 5 if big else 50)}))
        del re, im, gates, g8, w
    return 0


if __name__ == "__main__":
    sys.exit(main())
