"""Training launcher (port of ``repro.launch.train``).

Two entry modes, both on the GPU unless ``--device cpu`` is given:

  * LM pretraining on the synthetic corpus, for every arch but the VQC
    (dense, moe, ssm, hybrid, and the encdec and vlm archs, whose batches
    carry the JAX launcher's stubbed audio or image embeddings);
    ``--smoke`` takes the reduced config:

      PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
          --smoke --steps 50 --batch 8 --seq 128

  * sat-QFL federated training (``--fl``): the in-graph stacked-satellite
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

    The LM path's own flags (``--arch``, ``--smoke``, ``--steps``,
    ``--seq``, ``--optimizer``) are refused with ``--fl``, which does not
    read them.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.device import resolve_device

#: the LM path's own flags and their defaults (the JAX launcher's)
_LM_FLAGS = {"arch": "tinyllama-1.1b", "smoke": False, "steps": 30,
             "seq": 128, "optimizer": "adamw"}


def lm_extras(cfg, batch: int, device) -> dict:
    """The JAX launcher's embeddings, joined to every batch:
    ``steps.stub_embeds`` under ``PRNGKey(1)`` (audio) or ``PRNGKey(2)``
    (image)."""
    from repro_torch import prng
    from repro_torch.launch.steps import stub_embeds
    return stub_embeds(cfg, batch, prng.PRNGKey(1, device),
                       prng.PRNGKey(2, device))


def run_lm(args):
    """LM pretraining: ``--steps`` steps of ``make_train_step`` on
    ``lm_batches`` of the synthetic corpus (with ``lm_extras``) under
    ``--optimizer`` with the JAX launcher's cosine schedule (warmup 10), on
    ``--device``. Resumes from ``--ckpt-dir`` and saves there a third of
    the way through. Returns the loss of every step it ran."""
    from repro_torch import prng
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data.tokens import lm_batches, synthetic_corpus
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import get_config, get_model, smoke_variant
    from repro_torch.nn.optim import cosine_schedule, get_optimizer
    from repro_torch.nn.pytree import tree_leaves

    dev = resolve_device(getattr(args, "device", None))
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    api = get_model(cfg)
    params = api.init(cfg, prng.PRNGKey(args.seed, dev))
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"[train] {cfg.name} ({'smoke' if args.smoke else 'full'}): "
          f"{n_params/1e6:.1f}M params on {dev}")

    opt = get_optimizer(args.optimizer,
                        cosine_schedule(args.lr, args.steps, warmup=10))
    opt_state = opt.init(params)
    corpus = synthetic_corpus(max(args.batch * args.seq * 50, 100_000),
                              cfg.vocab_size, seed=args.seed, device=dev)
    step = make_train_step(cfg, api, opt)

    mgr = None
    start = 0
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=2)
        if mgr.latest is not None:
            (params, opt_state), start, _ = mgr.restore((params, opt_state))
            print(f"[train] resumed from step {start}")

    ex = lm_extras(cfg, args.batch, dev)
    t0 = time.time()
    losses = []
    for i, batch in enumerate(lm_batches(corpus, args.batch, args.seq,
                                         args.steps, seed=args.seed)):
        if i < start:
            continue
        batch.update(ex)
        params, opt_state, loss = step(params, opt_state, batch, i)
        losses.append(float(loss))
        if i % max(args.steps // 10, 1) == 0:
            print(f"  step {i:4d}  loss {losses[-1]:.4f}  "
                  f"({(time.time()-t0):.1f}s)")
        if mgr and (i + 1) % max(args.steps // 3, 1) == 0:
            mgr.save(i + 1, (params, opt_state), {"loss": losses[-1]})
    if losses:
        print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"({'improved' if losses[-1] < losses[0] else 'NO IMPROVEMENT'})")
    return losses


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
    """Parse ``argv`` and run; returns the LM path's losses, or the final
    state of the ``--fl`` path (an :class:`FLState`, or the trainer of a
    host engine)."""
    ap = argparse.ArgumentParser(description=__doc__)
    # the LM path's flags default to None here, so that --fl can refuse
    # them when they are given; run_lm takes _LM_FLAGS' defaults
    ap.add_argument("--arch", default=None)
    ap.add_argument("--smoke", action="store_true", default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default=None)
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
    given = [f"--{k}" for k in _LM_FLAGS if getattr(args, k) is not None]
    if args.fl:
        if given:
            ap.error(f"{', '.join(given)}: LM-path flags, which --fl does "
                     f"not read")
        return run_fl(args)
    for k, default in _LM_FLAGS.items():
        if getattr(args, k) is None:
            setattr(args, k, default)
    return run_lm(args)


if __name__ == "__main__":
    main()
