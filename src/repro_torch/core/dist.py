"""The in-graph sat-QFL round (port of ``repro.core.dist``).

**Stacked-satellite formulation.** The satellite index is the leading axis
of every parameter, optimizer-slot and data tensor, and one FL round is one
call of ``round_fn`` over that axis. The paper's schedules become array
operations on it:

  simultaneous — local steps, then a weighted mean over the satellite axis
  asynchronous — the same mean, masked by the visibility-window
                 participation vector; non-participants' updates wait in
                 a staleness buffer and fold in within Δ_max rounds
  sequential   — a ring: train, pass the parameters to the next satellite
                 (``torch.roll`` over the axis); N chains run pipelined

Security (Algorithm 2) runs over the whole stacked tree at once:

  otp        — OTP-XOR each satellite's update with its pad, move the
               ciphertext, decrypt at the receiver: two launches of the
               fused OTP kernel's seeded rows entry (``kernels.otp_xor``),
               encrypt then decrypt, so XOR∘XOR never cancels away
  otp_gather — the central-server topology (sim/qfl): the aggregator
               receives every ciphertext with its sender's MAC tag,
               verifies all of them and decrypts centrally
               (``metrics["mac_ok"]``); again two launches, the sender's
               tags coming out of the launch that makes the ciphertext
  secagg     — pairwise-additive masks Σ m_i = 0 (a ring PRF of normal
               draws), so the masked updates average to the true mean
               while each update is blinded

Local training is the port's ``core.localtrain`` program over all n_sat
rows as one stage, so a round makes one training call (seq: one a hop).
Under a mesh ``ctx`` otp_gather pins the ciphertext the aggregator
receives to replicated (the JAX package's ``P(None, …)`` constraint: an
all-gather of the satellite axis when its rows are DTensors sharded over
the mesh); on plain tensors, and with ``ctx=None``, that is nothing.
``fl_input_specs`` gives the round's inputs as meta tensors. Seeds and MAC keys
are u32 values held in int64 tensors masked to 32 bits, the port's
convention; they reach the kernel as int32 bit storage. On CPU tensors the
kernel's wrapper runs its plain version, bit for bit the same.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import prng
from repro_torch.core.flconfig import SatQFLConfig
from repro_torch.core.localtrain import make_local_train
from repro_torch.kernels.otp_xor import ops as otp_ops
from repro_torch.kernels.otp_xor.ref import as_storage
from repro_torch.nn.optim import Optimizer
from repro_torch.nn.pytree import tree_leaves, tree_map, tree_unflatten
from repro_torch.security.mac import poly_mac_rows
from repro_torch.sharding.context import has_mesh
from repro_torch.sharding.specs import P, constrain
from repro_torch.security.otp import (pad_layout, tree_to_u32_rows,
                                      u32_to_tree_rows)

_M32 = 0xFFFFFFFF
#: round-mixing constants of the otp and secagg pad seeds
_OTP_MIX, _SECAGG_MIX = 0x9E3779B9, 0x85EBCA6B


class FLState(NamedTuple):
    params: Any                  # stacked (n_sat, ...) tree
    opt_slots: Any               # stacked optimizer slots
    stale: Any                   # async: buffered undelivered updates
    stale_age: torch.Tensor      # (n_sat,) int32 rounds buffered (-1 none)
    round_idx: torch.Tensor      # 0-d int32


def _u32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int64) & _M32


def _round_seeds(seeds, r, mix: int) -> torch.Tensor:
    """seeds ^ (r · mix) in uint32 arithmetic."""
    return _u32(seeds) ^ ((_u32(r) * mix) & _M32)


def _mac_keys(seeds) -> tuple:
    """The (r, s) MAC key pair of each row's seed: the integer mix of
    ``security.keys.mac_key_mix`` in uint32 arithmetic."""
    s = _u32(seeds)
    return s ^ 0xA5A5A5A5, (s * 747796405 + 2891336453) & _M32


# ---------------------------------------------------------------------------
# security primitives over stacked trees
# ---------------------------------------------------------------------------

def _otp_rows(tree, seeds, r_keys, s_keys, tag_input: bool = False):
    """One launch of the fused OTP kernel's seeded rows entry over the
    stacked tree's rows (the plain version on a CPU tree): (XORed tree,
    tags (n,) int32 storage), the tags over the input rows when
    ``tag_input`` (a receiver) and over the output rows otherwise."""
    msg = as_storage(tree_to_u32_rows(tree))
    out, tags = otp_ops.otp_xor_mac_rows_seeded(
        msg, as_storage(_u32(seeds)), pad_layout(tree, lead=1),
        as_storage(_u32(r_keys)), as_storage(_u32(s_keys)), tag_input)
    return u32_to_tree_rows(out, tree), tags


def _gather_send(tree, round_seeds):
    """otp_gather's sender side: one launch makes every row's ciphertext
    and its MAC tag under the row's round seed: (ciphertext tree, tags)."""
    rk, sk = _mac_keys(round_seeds)
    return _otp_rows(tree, round_seeds, rk, sk)


def _replicated(tree, ctx):
    """Every leaf of ``tree`` constrained to replicated under ``ctx``'s
    mesh (a DTensor leaf is gathered; a plain one is left as it is)."""
    if not has_mesh(ctx):
        return tree
    return tree_map(lambda t: constrain(t, P(*([None] * t.dim())), ctx),
                    tree)


def _gather_receive(ct, round_seeds):
    """otp_gather's aggregator side: one launch decrypts what arrived and
    tags the ciphertext as received: (plaintext tree, tags). A row
    verifies when its tag equals its sender's."""
    rk, sk = _mac_keys(round_seeds)
    return _otp_rows(ct, round_seeds, rk, sk, tag_input=True)


def otp_stacked(tree, seeds_u32):
    """OTP over a stacked tree, seeds (n_sat,) u32: row i XORed with the
    pads of seeds[i], bit for bit ``security.otp.encrypt_tree_rows``. One
    launch of the seeded rows entry; its tags are discarded. Involution."""
    zeros = torch.zeros_like(_u32(seeds_u32))
    return _otp_rows(tree, seeds_u32, zeros, zeros)[0]


def mac_tags_stacked(tree, round_seeds_u32):
    """Per-satellite MAC tags over a stacked ciphertext tree: (tags (n,),
    r (n,), s (n,)), int64 u32 words, with the (r, s) key pair mixed from
    each round seed. The receiver recomputes its own from what moved."""
    r, s = _mac_keys(round_seeds_u32)
    return poly_mac_rows(tree_to_u32_rows(tree), r, s), r, s


def secagg_mask(tree, seeds_u32, sign_split: int):
    """Pairwise-additive masking: θ_i + PRF(i) − PRF(i+1 mod N).

    The masks telescope to zero over the satellite axis, so the uniform
    mean of the masked updates is the true mean while each update is
    blinded. Leaf j of row i draws ``prng.normal`` under ``fold_in(key(
    seed_i), j + sign_split)``, as the JAX package draws
    ``jax.random.normal``; non-float32 leaves are masked in float32 and
    cast back.
    """
    seeds = _u32(seeds_u32)
    base = prng.key_u32(seeds)
    base_n = prng.key_u32(torch.roll(seeds, -1))
    leaves = tree_leaves(tree)
    out = []
    for i, leaf in enumerate(leaves):
        row = tuple(leaf.shape[1:])
        m = (prng.normal(prng.fold_in(base, i + sign_split), row)
             - prng.normal(prng.fold_in(base_n, i + sign_split), row))
        out.append(leaf + m if leaf.dtype == torch.float32
                   else (leaf.to(torch.float32) + m).to(leaf.dtype))
    return tree_unflatten(tree, out)


def make_secure_exchange(security: str):
    """f(tree, seeds, round) -> the tree as the aggregator receives it."""
    if security in ("none", "otp_gather"):     # otp_gather: in round_fn
        return lambda tree, seeds, r: tree

    if security == "otp":
        def exchange(tree, seeds, r):
            s = _round_seeds(seeds, r, _OTP_MIX)
            # the ciphertext is what moves: the sender's launch makes it,
            # the receiver's launch decrypts it
            return otp_stacked(otp_stacked(tree, s), s)
        return exchange

    if security == "secagg":
        def exchange(tree, seeds, r):
            return secagg_mask(tree, _round_seeds(seeds, r, _SECAGG_MIX),
                               sign_split=1000)
        return exchange

    raise ValueError(security)


# ---------------------------------------------------------------------------
# the round
# ---------------------------------------------------------------------------

def _bshape(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast (N,) weights against an (N, ...) leaf, as float32."""
    return w.reshape((-1,) + (1,) * (like.dim() - 1)).to(torch.float32)


def _wmean_sats(tree, w: torch.Tensor):
    """Weighted mean over the satellite axis, broadcast back to every row;
    w (N,) with a positive sum."""
    wn = (w / torch.clamp(torch.sum(w), min=1e-9)).to(torch.float32)

    def red(x):
        m = torch.tensordot(wn, x.to(torch.float32), dims=([0], [0]))
        return m[None].expand(x.shape).to(x.dtype).contiguous()

    return tree_map(red, tree)


def _steps(batches, idx: list) -> list:
    """Leaves (n_sat, steps, B, ...) -> the list of per-step batches with
    leaves (n_sat, B, ...) that ``make_local_train`` takes, at ``idx``."""
    return [tree_map(lambda x: x[:, i], batches) for i in idx]


def make_fl_round(model_cfg, api, fl: SatQFLConfig, optimizer: Optimizer,
                  n_sats: int, security: str = "none", seq_hops: int = 4,
                  ctx=None):
    """Build the round function.

    round_fn(state, batches, part_mask, seeds, weights=None,
             fault_mask=None) -> (state, metrics)

      batches:    tree, leaves (n_sat, steps, batch, ...): steps is
                  local_steps (sim/async/qfl) or seq_hops·local_steps (seq:
                  each hop of the chain takes its own slice)
      part_mask:  (n_sat,) float — visibility-window participation (async)
      seeds:      (n_sat,) u32 — per-edge QKD-derived pad seeds
      weights:    (n_sat,) float — FedAvg sample-count weights (None =
                  uniform)
      fault_mask: (n_sat,) float, 1 = healthy / 0 = crashed (None = all
                  healthy; ``plan.fault_mask(r)``): a crashed satellite
                  trains nothing (params and optimizer slots frozen),
                  sim/qfl drop its FedAvg weight, seq passes the chain
                  through its hop untrained, async removes it from both
                  delivery and rebuffering (its stale entry just ages)

    The three per-round inputs come from a compiled
    :class:`~repro_torch.core.plan.RoundPlan` (``plan.dist_inputs(r)``).
    ``metrics`` holds the mean local loss (a 0-d tensor) and, under
    otp_gather, ``mac_ok`` (a 0-d bool tensor).
    """
    if security == "otp_gather" and fl.mode not in ("sim", "qfl"):
        raise ValueError("otp_gather models the central-server topology — "
                         "sim/qfl schedules only")
    if security == "secagg" and fl.mode != "sim":
        # the ring-PRF masks telescope only over the FULL satellite set
        raise ValueError("secagg requires full participation — only the "
                         "'sim' schedule; use 'otp' for seq/async")
    exchange = make_secure_exchange(security)
    # the same local-training program the host trainer runs, over all
    # n_sat rows as one stage
    local_train = make_local_train(api, model_cfg, fl, optimizer)
    E = fl.local_steps

    def round_fn(state: FLState, batches, part_mask, seeds, weights=None,
                 fault_mask=None):
        if fault_mask is not None and security == "secagg":
            # a dropped row would leave its neighbours' masks uncancelled
            raise ValueError("secagg cannot drop crashed rows — "
                             "run faults with security 'none'/'otp'")
        r = state.round_idx
        dev = state.stale_age.device
        step0 = r * E
        # secagg's ring masks telescope to zero only under UNIFORM weights
        if weights is None or security == "secagg":
            w_agg = torch.ones((n_sats,), device=dev)
        else:
            w_agg = weights
        mac_ok = None

        def freeze_faulted(new, old):
            """Crashed rows keep their pre-round value."""
            if fault_mask is None:
                return new
            return tree_map(lambda n, o: torch.where(
                _bshape(fault_mask, n) > 0, n, o), new, old)

        def masked_mean_loss(loss):
            if fault_mask is None:
                return torch.mean(loss)
            return torch.sum(loss * fault_mask) / torch.clamp(
                torch.sum(fault_mask), min=1.0)

        steps = tree_leaves(batches)[0].shape[1]
        if fl.mode == "seq":
            p, o = state.params, state.opt_slots
            losses = torch.zeros((), device=dev)
            for hop in range(seq_hops):
                # hop h trains on steps [h·E, (h+1)·E), wrapping if the
                # caller under-provisioned the steps axis
                hop_batches = _steps(batches, [(e + hop * E) % steps
                                               for e in range(E)])
                p2, o2, loss = local_train(p, o, hop_batches, step0 + hop)
                # a crashed satellite's hop is a pass-through
                p, o = freeze_faulted(p2, p), freeze_faulted(o2, o)
                p = exchange(p, _u32(seeds) ^ (hop + 1), r)
                p = tree_map(lambda x: torch.roll(x, 1, 0), p)
                losses = losses + masked_mean_loss(loss)
            # each slot now holds a chain that visited seq_hops satellites,
            # so sample weights do not map to slots: uniform
            new_params = _wmean_sats(p, torch.ones((n_sats,), device=dev))
            mean_loss = losses / seq_hops
            new_stale, new_age = state.stale, state.stale_age
        else:
            p, o, loss = local_train(state.params, state.opt_slots,
                                     _steps(batches, range(steps)), step0)
            p = freeze_faulted(p, state.params)
            o = freeze_faulted(o, state.opt_slots)
            mean_loss = masked_mean_loss(loss)
            if fl.mode in ("sim", "qfl"):
                w = w_agg if fault_mask is None else w_agg * fault_mask
                if security == "otp_gather":
                    # the aggregator receives every satellite's ciphertext
                    # and its sender's tag, verifies, then decrypts
                    s = _round_seeds(seeds, r, _OTP_MIX)
                    ct, tags = _gather_send(p, s)
                    ct = _replicated(ct, ctx)
                    moved, tags_rx = _gather_receive(ct, s)
                    mac_ok = torch.all(tags == tags_rx)
                else:
                    moved = exchange(p, seeds, r)
                new_params = _wmean_sats(moved, w)
                if fault_mask is not None:
                    # every satellite crashed: keep the model (a
                    # zero-weight mean would zero every parameter)
                    any_w = torch.sum(w) > 0
                    new_params = tree_map(
                        lambda m, old: torch.where(any_w, m, old),
                        new_params, state.params)
                new_stale, new_age = state.stale, state.stale_age
            else:                       # async (the config admits no other)
                # deliver participants now, buffer the rest; a crashed
                # satellite neither delivers nor rebuffers
                live = (part_mask if fault_mask is None
                        else part_mask * fault_mask)
                moved = exchange(p, seeds, r)
                sel_now = live
                stale_ok = ((state.stale_age >= 0)
                            & (state.stale_age <= fl.max_staleness))
                # a crashed-but-visible satellite delivers nothing fresh,
                # yet its buffered update is aggregator-side and folds in
                sel_stale = stale_ok.to(torch.float32) * (1.0 - sel_now)
                combined = tree_map(
                    lambda now, st: (now.to(torch.float32)
                                     * _bshape(sel_now, now)
                                     + st.to(torch.float32)
                                     * _bshape(sel_stale, st)).to(now.dtype),
                    moved, state.stale)
                w_tot = (sel_now + sel_stale) * w_agg
                # nobody delivered and no usable buffer: keep the model
                any_w = torch.sum(w_tot) > 0
                new_params = tree_map(
                    lambda m, old: torch.where(any_w, m, old),
                    _wmean_sats(combined, w_tot), state.params)
                new_stale = tree_map(
                    lambda fresh, st: torch.where(
                        _bshape(live, fresh) > 0, fresh.to(torch.float32),
                        st.to(torch.float32)).to(fresh.dtype),
                    moved, state.stale)
                new_age = torch.where(live > 0, 0, state.stale_age + 1).to(
                    torch.int32)

        metrics = {"loss": mean_loss}
        if mac_ok is not None:
            metrics["mac_ok"] = mac_ok
        return FLState(new_params, o, new_stale, new_age, r + 1), metrics

    return round_fn


def fl_init_state(model_cfg, api, optimizer: Optimizer, n_sats: int,
                  key: torch.Tensor) -> FLState:
    """Every satellite starts from the same global model: the init of
    ``split(key, n_sats)[0]`` in every row (the JAX package inits each row
    and broadcasts row 0), on the key's device."""
    keys = prng.split(key, n_sats)
    params = tree_map(lambda x: x[None].repeat((n_sats,) + (1,) * x.dim()),
                      api.init(model_cfg, keys[0]))
    return FLState(params=params,
                   opt_slots=optimizer.init(params),
                   stale=tree_map(torch.zeros_like, params),
                   stale_age=torch.full((n_sats,), -1, dtype=torch.int32,
                                        device=key.device),
                   round_idx=torch.zeros((), dtype=torch.int32,
                                         device=key.device))


def fl_input_specs(model_cfg, api, fl: SatQFLConfig, n_sats: int,
                   feature_shape: tuple, n_classes: int, seq_hops: int = 1):
    """Meta-tensor stand-ins of the round's inputs (classifier
    workloads); the u32 seeds are int64, the port's convention."""
    steps = fl.local_steps * (seq_hops if fl.mode == "seq" else 1)
    bs = (n_sats, steps, fl.batch_size)
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype,
                                            device=torch.device("meta"))
    return {
        "batches": {
            "features": meta(bs + tuple(feature_shape), torch.float32),
            "labels": meta(bs, torch.int32),
        },
        "part_mask": meta((n_sats,), torch.float32),
        "seeds": meta((n_sats,), torch.int64),
        "weights": meta((n_sats,), torch.float32),
    }
