"""The local-training program shared by both executors (port of
``repro.core.localtrain``).

One satellite's local update is E optimizer steps on E pre-sampled
batches. The JAX package vmaps that program over clients; here the client
axis is written out: params (K, ...), optimizer slots (K, ...), data
(K, n_max, ...), one key and one true length per client. The batched
executor runs a whole stage of clients as K rows; the per-client oracle
runs the same program with K = 1.

Batches are drawn through ``sample_batch_bounded`` with the per-client
keys of the JAX package, so both packages (and both executors) train on
the same indices.
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.core.gradients import make_grad_fn


def sample_batch_bounded(data: dict, key: torch.Tensor, batch_size: int,
                         n) -> dict:
    """Uniform batch from the first ``n`` rows of (possibly padded) data.

    data leaves (K, n_max, ...), key (K, 2), n (K,) -> leaves
    (K, batch_size, ...): row k draws from its own first n[k] rows.
    """
    n = torch.as_tensor(n, device=key.device).reshape(-1, 1)
    idx = prng.randint(key, (batch_size,), 0, n)
    rows = torch.arange(idx.shape[0], device=key.device)[:, None]
    return {k: v[rows, idx] for k, v in data.items()}


def sample_local_batches(data: dict, key: torch.Tensor, batch_size: int, n,
                         local_steps: int) -> list:
    """Pre-sample all E step batches: a list of E batches, leaves
    (K, batch_size, ...), from the JAX package's split of each key."""
    keys = prng.split(key, local_steps)                     # (K, E, 2)
    return [sample_batch_bounded(data, keys[:, e], batch_size, n)
            for e in range(local_steps)]


def make_local_train(api, model_cfg, fl, optimizer):
    """(params, opt_state, batches, step0) -> (params, opt_state, losses).

    batches: list of E batches with leaves (K, B, ...). Returns the new
    params and slots and each client's mean loss over the E steps (K,).
    """
    grad_fn = make_grad_fn(api, model_cfg, fl)

    def local_train(params, opt_state, batches, step0: int):
        losses = []
        for e, batch in enumerate(batches):
            loss, g = grad_fn(params, batch)
            params, opt_state = optimizer.update(g, opt_state, params,
                                                 step0 + e)
            losses.append(loss)
        return params, opt_state, torch.stack(losses).mean(dim=0)

    return local_train


def make_batched_local_train(api, model_cfg, fl, optimizer):
    """(params (K,...), opt_states (K,...), data (K, n_max, ...), n (K,),
    keys (K, 2), step0) -> (params (K,...), opt_states (K,...), losses (K,))
    — sampling and training for a whole client stage at once."""
    local_train = make_local_train(api, model_cfg, fl, optimizer)

    def batched(params, opt_states, data, n, keys, step0: int):
        batches = sample_local_batches(data, keys, fl.batch_size, n,
                                       fl.local_steps)
        return local_train(params, opt_states, batches, step0)

    return batched
