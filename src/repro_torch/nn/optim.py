"""Optimizers and learning-rate schedules (port of ``repro.nn.optim``).

The same optax-like interface as the JAX package::

    opt = sgd(lr=schedule)
    state = opt.init(params)
    params, state = opt.update(grads, state, params, step)

Updates are elementwise, so a leading client axis on params, grads and
slots (the batched trainer's stacked clients) passes straight through;
``step`` is one scalar shared by every client of a dispatch. Updates are
functional: they return new tensors and never write into their inputs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.nn.pytree import tree_leaves, tree_map, tree_unflatten


class OptState(NamedTuple):
    """Generic optimizer state: a tree of per-param slots (possibly empty)."""
    slots: Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], OptState]
    update: Callable[[Any, OptState, Any, Any], tuple[Any, OptState]]
    name: str = "opt"


def _f32(step, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(step, device=like.device).to(torch.float32)


# ---------------------------------------------------------------------------
# Schedules (callables (step, like) -> lr as a float32 scalar on like's device)
# ---------------------------------------------------------------------------

def constant_schedule(lr: float):
    return lambda step, like: torch.tensor(lr, dtype=torch.float32,
                                           device=like.device)


def inv_sqrt_schedule(base_lr: float, warmup: int = 0):
    """η_t = base / sqrt(max(t, 1)) with optional linear warmup (Prop. 1)."""
    def sched(step, like):
        s = _f32(step, like)
        lr = base_lr * torch.rsqrt(torch.clamp(s, min=1.0))
        if warmup > 0:
            lr = torch.where(s < warmup, base_lr * (s + 1) / warmup, lr)
        return lr
    return sched


def cosine_schedule(base_lr: float, total_steps: int, warmup: int = 0,
                    min_frac: float = 0.1):
    def sched(step, like):
        s = _f32(step, like)
        warm = base_lr * torch.clamp((s + 1) / max(warmup, 1), max=1.0)
        prog = torch.clamp((s - warmup) / max(total_steps - warmup, 1),
                           0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup, warm, cos) if warmup > 0 else cos
    return sched


def _as_schedule(lr):
    return lr if callable(lr) else constant_schedule(float(lr))


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------

def sgd(lr=1e-2) -> Optimizer:
    """Paper-faithful plain SGD. Zero optimizer memory."""
    sched = _as_schedule(lr)

    def init(params):
        del params
        return OptState(slots=())

    def update(grads, state, params, step):
        eta = sched(step, tree_leaves(params)[0])

        def upd(p, g):
            if p.dtype == torch.float32:
                return p - eta * g.to(torch.float32)
            return p - (eta.to(g.dtype) * g).to(p.dtype)

        return tree_map(upd, params, grads), state

    return Optimizer(init=init, update=update, name="sgd")


def momentum(lr=1e-2, beta: float = 0.9) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        return OptState(slots=tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params))

    def update(grads, state, params, step):
        eta = sched(step, tree_leaves(params)[0])
        vel = tree_map(lambda v, g: beta * v + g.to(torch.float32),
                       state.slots, grads)
        new = tree_map(lambda p, v: (p.to(torch.float32) - eta * v).to(p.dtype),
                       params, vel)
        return new, OptState(slots=vel)

    return Optimizer(init=init, update=update, name="momentum")


def adamw(lr=3e-4, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1,
          moment_dtype=torch.float32) -> Optimizer:
    """AdamW with configurable moment dtype."""
    sched = _as_schedule(lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype,
                                      device=p.device)
        return OptState(slots={"m": tree_map(zeros, params),
                               "v": tree_map(zeros, params)})

    def update(grads, state, params, step):
        like = tree_leaves(params)[0]
        eta = sched(step, like)
        t = _f32(step, like) + 1.0
        c1 = 1.0 - torch.pow(torch.tensor(b1, device=like.device), t)
        c2 = 1.0 - torch.pow(torch.tensor(b2, device=like.device), t)

        def upd(p, g, m, v):
            gf = g.to(torch.float32)
            mf = b1 * m.to(torch.float32) + (1 - b1) * gf
            vf = b2 * v.to(torch.float32) + (1 - b2) * gf * gf
            step_ = (mf / c1) / (torch.sqrt(vf / c2) + eps) \
                + weight_decay * p.to(torch.float32)
            return ((p.to(torch.float32) - eta * step_).to(p.dtype),
                    mf.to(moment_dtype), vf.to(moment_dtype))

        out = [upd(*leaves) for leaves in zip(
            tree_leaves(params), tree_leaves(grads),
            tree_leaves(state.slots["m"]), tree_leaves(state.slots["v"]))]
        pick = lambda i: tree_unflatten(params, [o[i] for o in out])
        return pick(0), OptState(slots={"m": pick(1), "v": pick(2)})

    return Optimizer(init=init, update=update, name="adamw")


def get_optimizer(name: str, lr) -> Optimizer:
    if name == "sgd":
        return sgd(lr)
    if name == "momentum":
        return momentum(lr)
    if name == "adamw":
        return adamw(lr)
    raise ValueError(f"unknown optimizer {name!r}")
