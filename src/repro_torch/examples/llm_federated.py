"""sat-QFL with an LLM as the satellites' local model (the port's twin of
``examples/llm_federated.py``): the in-graph stacked-satellite round
training a reduced qwen3-0.6b on synthetic tokens, each round's
participation, pad seeds and FedAvg weights from a constellation trace
compiled into a ``RoundPlan``.

    PYTHONPATH=src python -m repro_torch.examples.llm_federated \\
        [--rounds 3] [--sats 4] [--security {none,otp,otp_gather,secagg}] \\
        [--device cpu]

It runs on the GPU unless ``--device cpu`` is given. ``otp_gather`` (the
central-server topology, whose aggregator checks every sender's MAC tag)
is beside the JAX example's three modes; its rounds print ``mac_ok``.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import prng
from repro_torch.constellation import build_trace
from repro_torch.core import SatQFLConfig, compile_round_plan, evaluate
from repro_torch.core.dist import fl_init_state, make_fl_round
from repro_torch.data import lm_batches, synthetic_corpus
from repro_torch.device import resolve_device
from repro_torch.models import get_config, get_model, smoke_variant
from repro_torch.nn.optim import sgd
from repro_torch.nn.pytree import tree_leaves, tree_map

#: local steps, batch and sequence length of every satellite's update
E, BATCH, SEQ = 3, 4, 64


def main(argv=None) -> dict:
    """Run the example; returns {"rounds": [per-round metrics as floats],
    "state": the final FLState}."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--sats", type=int, default=4)
    ap.add_argument("--security", default="secagg",
                    choices=["none", "otp", "otp_gather", "secagg"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = smoke_variant(get_config("qwen3-0.6b"))
    api = get_model(cfg)
    n_sats = args.sats
    fl = SatQFLConfig(mode="sim", n_rounds=args.rounds, local_steps=E,
                      batch_size=BATCH, lr=5e-2)
    opt = sgd(fl.lr)
    state = fl_init_state(cfg, api, opt, n_sats, prng.PRNGKey(0, dev))
    n_params = sum(x.numel() for x in tree_leaves(state.params))
    print(f"== federated {cfg.name} (smoke): {n_sats} satellites x "
          f"{n_params // n_sats / 1e6:.1f}M params, "
          f"security={args.security}, on {dev}")

    round_fn = make_fl_round(cfg, api, fl, opt, n_sats,
                             security=args.security)
    corpus = synthetic_corpus(200_000, cfg.vocab_size, device=dev)
    trace = build_trace(n_sats=n_sats, n_planes=max(n_sats // 2, 1),
                        duration_s=3600, step_s=60, device=dev)
    plan = compile_round_plan(trace, fl, device=dev)

    eval_batch = next(lm_batches(corpus, 8, SEQ, 1, seed=99))
    rounds = []
    for r in range(args.rounds):
        per_sat = [list(lm_batches(corpus, BATCH, SEQ, E, seed=100 * r + i))
                   for i in range(n_sats)]
        batches = {k: torch.stack([torch.stack([b[k] for b in bs])
                                   for bs in per_sat])
                   for k in ("tokens", "labels")}
        mask, seeds, weights = plan.dist_inputs(r, dev)
        state, metrics = round_fn(state, batches, mask, seeds, weights)
        g_params = tree_map(lambda x: x[0], state.params)
        vl, va = evaluate(api, cfg, g_params, eval_batch)
        m = {"local_loss": float(metrics["loss"]), "global_eval_loss": vl,
             "token_acc": va}
        if "mac_ok" in metrics:
            m["mac_ok"] = bool(metrics["mac_ok"])
        rounds.append(m)
        print(f"round {r}: " + " ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in m.items()))
    print("done.")
    return {"rounds": rounds, "state": state}


if __name__ == "__main__":
    main()
