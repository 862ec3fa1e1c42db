"""Training driver (port of ``repro.launch.train``, its ``--fl`` path).

sat-QFL federated training (``--fl``): the in-graph stacked-satellite
round (``repro_torch.core.dist``), every satellite a row of one stacked
axis on one card:

    PYTHONPATH=src python -m repro_torch.launch.train --fl --mode sim \\
        --security otp --rounds 5

``--engine host`` runs the host-orchestrated trainer instead (the full
comm model and Algorithm 2 security) with the constellation-batched
executor; ``--engine host-perclient`` selects its per-client numerics
oracle:

    PYTHONPATH=src python -m repro_torch.launch.train --fl --engine host \\
        --mode sim --rounds 5 --sats 32

It runs on the GPU unless ``--device cpu`` is given. The LM pretraining
path (no ``--fl``) needs the decoder zoo's loss and is not ported yet,
and so are its flags (``--arch``, ``--smoke``, ``--steps``, ``--seq`` and
``--optimizer``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.device import resolve_device

_LM_NOT_PORTED = ("LM pretraining (no --fl) needs the LLM client zoo's "
                  "loss and training step, which are not ported yet "
                  "(ROADMAP queue 1, item 11); run with --fl")


def run_lm(args):
    raise NotImplementedError(_LM_NOT_PORTED)


def run_fl_host(args, cfg, api, fl, trace, sats, server, device=None):
    """Host-orchestrated engine (comm model + Algorithm 2 security): the
    constellation-batched executor, or the per-client oracle under
    ``--engine host-perclient``. Resumes from ``--ckpt-dir`` and
    checkpoints there after every round."""
    from repro_torch.checkpoint.io import latest_step
    from repro_torch.core import SatQFLTrainer

    batched = args.engine == "host"
    tr = SatQFLTrainer(cfg, api, fl, trace, sats, server, batched=batched,
                       device=device)
    print(f"[fl] host engine ({'batched' if batched else 'per-client'}) "
          f"mode={fl.mode} security={fl.security} sats={tr.n_sats}")
    start = 0
    ckpt_dir = getattr(args, "ckpt_dir", None)
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        start = tr.restore_round_checkpoint(ckpt_dir)
        print(f"[fl] resumed from {ckpt_dir} at round {start}")
    for r in range(start, fl.n_rounds):
        t0 = time.perf_counter()
        m = tr.run_round(r)
        print(f"  round {r}: val_loss={m.server_val_loss:.4f} "
              f"val_acc={m.server_val_acc:.3f} comm={m.comm_s:.2f}s "
              f"participants={m.participants} "
              f"({(time.perf_counter() - t0) * 1e3:.0f} ms wall)")
        if ckpt_dir:
            tr.save_round_checkpoint(ckpt_dir)
    return tr


def run_fl(args):
    """The ``--fl`` path: the JAX launcher's config, trace, data and batch
    draws, on ``--device``. Returns the final :class:`FLState` (dist) or
    the trainer (host engines)."""
    from repro_torch import prng
    from repro_torch.constellation import build_trace
    from repro_torch.core import SatQFLConfig, compile_round_plan, evaluate
    from repro_torch.core.dist import fl_init_state, make_fl_round
    from repro_torch.data import (dirichlet_partition, make_statlog,
                                  server_split)
    from repro_torch.models import get_config, get_model
    from repro_torch.nn.optim import sgd

    dev = resolve_device(getattr(args, "device", None))
    cfg = get_config("vqc-satqfl").replace(
        vqc_qubits=args.qubits, vqc_layers=2, n_features=args.qubits)
    api = get_model(cfg)
    n_sats = args.sats
    if args.engine == "dist":
        # the in-graph engine takes its security mode in make_fl_round;
        # the config only needs an Algorithm-2 name whose != "none" gate
        # matches (plan key and seed compilation)
        security = "none" if args.security == "none" else "qkd"
    else:
        # the host engine speaks Algorithm-2 names: the in-graph 'otp' is
        # its QKD-keyed OTP(+MAC); 'secagg' is an in-graph construction
        host_map = {"none": "none", "otp": "qkd"}
        if args.security not in host_map:
            raise SystemExit(
                f"--security {args.security} is dist-engine only; the host "
                f"engine supports none|otp (otp runs as QKD-keyed OTP+MAC)")
        security = host_map[args.security]
    fl = SatQFLConfig(mode=args.mode, n_rounds=args.rounds,
                      local_steps=args.local_steps, batch_size=args.batch,
                      lr=args.lr, seed=args.seed, security=security)
    X, y = make_statlog(n_features=args.qubits, device=dev)
    Xc, yc, server = server_split(X, y)
    sats = dirichlet_partition(Xc, yc, n_sats)
    trace = build_trace(n_sats=n_sats, n_planes=max(n_sats // 2, 1),
                        duration_s=3600, step_s=60, seed=args.seed,
                        device=dev)
    if args.engine != "dist":
        return run_fl_host(args, cfg, api, fl, trace, sats, server, dev)

    opt = sgd(fl.lr)
    state = fl_init_state(cfg, api, opt, n_sats,
                          prng.PRNGKey(args.seed, dev))
    seq_hops = 4
    round_fn = make_fl_round(cfg, api, fl, opt, n_sats,
                             security=args.security, seq_hops=seq_hops)
    per = min(len(s["features"]) for s in sats)
    E, Bn = fl.local_steps, fl.batch_size
    steps = E * seq_hops if fl.mode == "seq" else E
    # participation masks, pad seeds and FedAvg weights all come from the
    # compiled constellation schedule
    plan = compile_round_plan(
        trace, fl, sample_counts=[len(s["labels"]) for s in sats],
        with_seeds=(args.security != "none"), device=dev)

    rng = np.random.default_rng(args.seed)
    print(f"[fl] mode={fl.mode} security={args.security} sats={n_sats} "
          f"(plan: {plan.participants(0)}/{n_sats} participate at r0)")
    for r in range(args.rounds):
        idx = torch.from_numpy(rng.integers(0, per, (n_sats, steps, Bn))
                               ).to(dev)
        batches = {k: torch.stack([s[k][i] for s, i in zip(sats, idx)])
                   for k in ("features", "labels")}
        mask, seeds, weights = plan.dist_inputs(r, dev)
        state, metrics = round_fn(state, batches, mask, seeds, weights)
        # server metrics on the aggregated model (satellite 0's copy)
        g_params = {k: v[0] for k, v in state.params.items()}
        vl, va = evaluate(api, cfg, g_params, server["val"])
        print(f"  round {r}: local_loss={float(metrics['loss']):.4f} "
              f"val_loss={vl:.4f} val_acc={va:.3f}")
    return state


def main(argv=None):
    """Parse ``argv`` and run; returns the final state of the ``--fl``
    path (an :class:`FLState`, or the trainer of a host engine)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (resume if present)")
    # FL mode
    ap.add_argument("--fl", action="store_true")
    ap.add_argument("--mode", default="sim",
                    choices=["sim", "seq", "async", "qfl"])
    ap.add_argument("--engine", default="dist",
                    choices=["dist", "host", "host-perclient"],
                    help="dist = in-graph stacked round; host = paper-scale "
                         "trainer (constellation-batched); host-perclient "
                         "= its per-client numerics oracle")
    ap.add_argument("--security", default="none",
                    choices=["none", "otp", "secagg"])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--sats", type=int, default=8)
    ap.add_argument("--local-steps", type=int, default=5)
    ap.add_argument("--qubits", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    if args.fl:
        return run_fl(args)
    return run_lm(args)


if __name__ == "__main__":
    main()
