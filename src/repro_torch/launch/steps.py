"""Step functions (port of the prefill and decode step makers of
``repro.launch.steps``).

The JAX package wraps these in a ``StepBundle`` with sharding specs for
its dry-run; the port runs on one card and returns the plain functions.
``ctx`` is accepted and ignored.
"""
from __future__ import annotations

from repro_torch.models.config import ArchConfig
from repro_torch.models.registry import ModelApi


def make_prefill_step(cfg: ArchConfig, api: ModelApi, ctx=None):
    """(params, {"tokens": (B, S)}) -> next-token logits (B, Vp): the last
    position of ``api.forward``, with the LM head applied to that position
    only (XLA pushes the JAX package's slice through the matmul; eager
    torch would compute every position's logits)."""
    def prefill_step(params, batch):
        return api.prefill(cfg, params, batch, ctx)
    return prefill_step


def make_decode_step(cfg: ArchConfig, api: ModelApi, ctx=None):
    """(params, cache, {"token": (B,), "pos": (B,)}) -> (logits, cache)."""
    def decode_step(params, cache, batch):
        return api.decode_step(cfg, params, cache, batch, ctx)
    return decode_step
