"""Host-orchestrated sat-QFL rounds — paper Algorithm 1 (port of
``repro.core.round``: modes qfl, sim, seq and async; security none, qkd,
qkd_fernet and teleport; ``agg_security`` none or secagg; gradients by
autodiff or parameter shift).

Roles, groups, weights, the exchange stages and the async buffer's
lifecycle come from the compiled :class:`~repro_torch.core.plan.RoundPlan`;
every transfer is accounted by the communication-time model; local
training is the VQC on each satellite's private data. Per mode a group
merges as: sim, parallel uploads averaged; seq, a serial chain (each hop
trains on the previous hop's model and a QBER-aborted hop reverts the
chain); async, the bounded-staleness buffer below. Mains then train,
uplink over the feeder, and the ground station averages.

**Constellation-batched executor (default).** Every participating client
of a stage is one row of a stacked client axis, padded to one fixed frame
of pow2(n_sats) rows: local training for the whole stage is one pass of
``core.localtrain`` over that axis (the VQC's gate layers run as the CUDA
kernel over all rows at once), and aggregation is one weighted reduction
over the rows. Pad rows train throwaway copies; their optimizer slots
scatter into a scratch row (index n_sats) that nothing reads. seq trains
hop h of every chain as one stage.

``batched=False`` keeps the per-client loop as the numerics oracle. Both
executors draw each (round, satellite) key from the same fold-in schedule
as the JAX package and sample through the same bounded sampler, so they
see identical batches; accounting is exactly equal between them.

**Async: the compiled bounded-staleness buffer.** An update trained at
round ``b`` transmits when its (sat, main) ISL window opens, arrives at a
later round, and waits in its main's buffer until that main is primary
again: merged if its staleness is within Δ_max, discarded otherwise. The
batched executor keeps a device ring keyed (satellite, born mod Δ_max+1)
and runs each round as one scatter into the ring, one secure stage over
the plan's arrivals and one masked merge; the oracle keeps live per-main
lists. Both merge through ONE reduction (``_frame_merge``) over the same
(N+1)·(Δ_max+1) frame with the same (mains frame, cells) weight shape, so
their merged parameters are bit-equal by construction.

**Dropout-tolerant secure aggregation** (``agg_security='secagg'``, async
only): senders quantize their updates to a mod-2^32 fixed-point stream
and add signed pairwise pad streams keyed off BB84 shares; partners merged
in the same batch cancel, and an absent partner's pads are cancelled
exactly from the plan's correction tables (ring) or the key registry
(oracle). Integer arithmetic, so both executors agree bit for bit.

**Secure exchange (Algorithm 2).** Under ``security`` qkd / qkd_fernet
every edge key is established in ONE batched BB84 when the plan compiles
(the trainer's ``KeyManager`` rides along), and the plan's EdgeSchedule
carries per-(round, edge) pad seeds (folding in the round the payload was
born, so a deferred async delivery never reuses a pad), MAC keys,
first-contact and abort masks. ``edge_batched=True`` (the default) runs
each round stage as one secure dispatch over the stacked rows: the
sender's XOR + MAC and the receiver's MAC + XOR are one launch each of the
fused CUDA kernel (``kernels.otp_xor``), which generates the threefry pads
itself from the stage's seeds and the tree's cached pad layout.
``edge_batched=False`` keeps the per-edge oracle (``_exchange``), two
launches of the kernel's seeded stream entry per delivered edge. Both
give bit-identical payloads and exactly equal accounting; QBER aborts
surface per edge (``SecurityError.edges``, ``fl.on_qber_abort`` raise or
drop) and a MAC mismatch raises.

**Fault plane.** A config with a non-zero fault rate compiles a seeded
:class:`~repro_torch.core.plan.FaultSchedule` into the plan: crashed
satellites neither train nor send (a crashed main still relays, merges
and feeds, riding the mains' training stage as a masked row), stragglers
pay ``straggler_extra_s`` on their upload wall, a flapped link drops
before any data moves, and a tampered payload flips its first wire word
before the receiver's MAC, which rejects it in the seeded OTP kernel.
Async retransmissions with backoff were resolved by the plan. Both
executors drop at the same sites and report the same per-round
:class:`FaultReport`; ``fl.on_fault='raise'`` surfaces a round's first
fault as its ``FaultError`` subclass instead.

**Checkpoints.** ``save_round_checkpoint`` / ``restore_round_checkpoint``
(and ``run(ckpt_dir=...)``, which resumes from the latest) write the
whole resume state after a round in the JAX package's file format
(``repro_torch.checkpoint``); a resumed run ends bit-identical to the
uninterrupted one, and the port resumes a run that the JAX trainer
started (``convert.trainer_state_from_checkpoint``).

**A custom sampler.** ``sample_batch(data, key, batch_size)`` other than
``default_sample_batch`` draws each local step's batch from one client's
unpadded data with the JAX trainer's keys. It has no padding contract, so
it runs on the per-client oracle whatever ``batched`` says.
"""
from __future__ import annotations

import math
from dataclasses import asdict, dataclass

import numpy as np
import torch

from repro_torch import convert, prng
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.constellation.topology import ConstellationTrace
from repro_torch.core.comm import CommLog, CommModel
from repro_torch.core.flconfig import SatQFLConfig
from repro_torch.core.localtrain import (
    make_batched_local_train, make_local_train, sample_batch_bounded,
    sample_local_batches,
)
from repro_torch.core.plan import RoundPlan, compile_round_plan
from repro_torch.device import resolve_device
from repro_torch.kernels.otp_xor import ops as otp_ops
from repro_torch.kernels.otp_xor.ref import as_storage
from repro_torch.nn.optim import (
    constant_schedule, get_optimizer, inv_sqrt_schedule,
)
from repro_torch.nn.pytree import (tree_bytes, tree_leaves, tree_map,
                                   tree_weighted_sum)
from repro_torch.quantum.teleport import teleport_params
from repro_torch.security.errors import (CorruptionError, LinkFlapError,
                                         RetryExhaustedError, SatCrashError,
                                         SecurityError)
from repro_torch.security.fernet_lite import (
    TOKEN_OVERHEAD, InvalidToken, fernet_decrypt, fernet_decrypt_rows,
    fernet_encrypt, fernet_encrypt_rows,
)
from repro_torch.security.keys import KeyManager, canonical_edge
from repro_torch.security.otp import (pad_layout, q32_to_tree,
                                      secagg_mask_rows, secagg_mask_stream,
                                      sum_signed_pads, tree_to_u32,
                                      tree_to_u32_rows, u32_to_tree,
                                      u32_to_tree_rows)


def _mac_rows_verify(sent_tags: torch.Tensor,
                     received_tags: torch.Tensor) -> torch.Tensor:
    """Receiver-side MAC check of a stage (or of one edge): the sender's
    tags against the tags the receiver recomputed over what it received.
    Module-level so tests can force a mismatch."""
    return sent_tags == received_tags


def evaluate(api, model_cfg, params, batch) -> tuple[float, float]:
    """(loss, accuracy) of one model on one batch."""
    logits, _ = api.forward(model_cfg, params, batch)
    labels = batch["labels"]
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    ll = lf.gather(-1, labels[..., None].long())[..., 0]
    loss = torch.mean(lse - ll)
    acc = torch.mean((torch.argmax(lf, -1) == labels).to(torch.float32))
    return float(loss), float(acc)


def _jnp_mod(x: torch.Tensor, m: float) -> torch.Tensor:
    """``jnp.remainder`` (the sign of the divisor) from the exact fmod, as
    XLA computes it; torch's ``%`` rounds differently."""
    r = torch.fmod(x, m)                      # m > 0
    return torch.where(r < 0, r + m, r)


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length() if n > 1 else 1


def _frame_merge(frame, w: torch.Tensor):
    """The async merge: (mp, nd) weights over a frame whose leaves are
    (nd, ...) -> leaves (mp, ...), row g = Σ_k w[g, k]·frame[k] in float32,
    as one elementwise product and one sum over k. The ring and the
    per-main-list oracle both call it with the same shapes (a zero-weight
    cell adds an exact zero), so their merges are bit-equal."""
    mp, nd = w.shape

    def one(x):
        xf = x.reshape(nd, -1).to(torch.float32)
        out = (w[:, :, None] * xf[None]).sum(dim=1)
        return out.reshape((mp,) + tuple(x.shape[1:])).to(x.dtype)

    return tree_map(one, frame)


@dataclass
class FaultReport:
    """Per-round ledger of the injected-fault plane, tabulated from the
    compiled schedule (so both executors report identical counts; the
    parity checks hold their drops, merges and accounting to it)."""
    round: int
    crashes: int = 0        # satellites whose payload computer was down
    stragglers: int = 0     # satellites paying straggler_extra_s
    link_flaps: int = 0     # transmissions dropped before data moved
    corruptions: int = 0    # payloads MAC-rejected at the receiver
    retries: int = 0        # async retransmissions launched
    lost: int = 0           # async updates lost after max_retries
    recovered: int = 0      # async deliveries that needed ≥ 1 retry


@dataclass
class RoundMetrics:
    round: int
    server_val_loss: float = float("nan")
    server_val_acc: float = float("nan")
    server_test_acc: float = float("nan")
    dev_train_acc: float = float("nan")
    dev_test_acc: float = float("nan")
    dev_val_loss: float = float("nan")
    comm_s: float = 0.0
    security_s: float = 0.0
    participants: int = 0
    teleport_fidelity: float = float("nan")


def default_sample_batch(data: dict, key: torch.Tensor,
                         batch_size: int) -> dict:
    """The trainers' sampler: a uniform batch from every row of one
    client's data (leaves (n, ...), key (2,)), through the bounded sampler
    both executors share."""
    n = next(iter(data.values())).shape[0]
    one = sample_batch_bounded({k: v[None] for k, v in data.items()},
                               key[None], batch_size, n)
    return {k: v[0] for k, v in one.items()}


class SatQFLTrainer:
    """Hierarchical QFL over a constellation trace (paper Algorithm 1)."""

    def __init__(self, model_cfg, api, fl: SatQFLConfig,
                 trace: ConstellationTrace, sat_data: list,
                 server_data: dict, comm: CommModel | None = None,
                 sample_batch=default_sample_batch,
                 eavesdrop_edges: frozenset = frozenset(),
                 batched: bool = True, edge_batched: bool = True,
                 device=None):
        self.device = dev = resolve_device(device)
        self.model_cfg = model_cfg
        self.api = api
        self.fl = fl
        self.comm = comm or CommModel()
        self.sample_batch = sample_batch
        self._custom_sampler = sample_batch is not default_sample_batch
        # the batched executor samples through the bounded default sampler;
        # a custom sampler has no padding contract -> the per-client oracle
        self.batched = batched and not self._custom_sampler
        self.n_sats = trace.n_sats
        if len(sat_data) != self.n_sats:
            raise ValueError(f"{len(sat_data)} client datasets for "
                             f"{self.n_sats} satellites")
        # every batched dispatch is padded to ONE fixed frame of rows
        self._frame = _next_pow2(self.n_sats)

        # the JAX package's key schedule: the trainer's key (teleport
        # draws) and init from split(PRNGKey(seed)), local training from
        # fold_in(PRNGKey(seed), 0x5A7) per (round, sat)
        self.key, init_key = prng.split(prng.PRNGKey(fl.seed, dev))
        self._train_key = prng.fold_in(prng.PRNGKey(fl.seed, dev), 0x5A7)
        self.global_params = api.init(model_cfg, init_key)
        self._row_nbytes = tree_bytes(self.global_params)

        sched = (inv_sqrt_schedule(fl.lr, warmup=0)
                 if fl.lr_schedule == "inv_sqrt" else constant_schedule(fl.lr))
        self.opt = get_optimizer(fl.optimizer, sched)
        # per-client oracle: one slot tree per satellite; batched executor:
        # slots stacked (row i = satellite i, row n_sats = scratch)
        self.opt_states = [self.opt.init(self.global_params)
                           for _ in range(self.n_sats)]
        self._opt_stacked = tree_map(
            lambda x: x.expand((self.n_sats + 1,) + x.shape).clone(),
            self.opt.init(self.global_params))

        # every client padded to one shared length; the true length rides
        # along so the bounded sampler draws exactly the unpadded indices
        counts = [len(next(iter(d.values()))) for d in sat_data]
        max_n = max(counts)
        self._n_samples = torch.tensor(counts, dtype=torch.int64, device=dev)

        def pad(x, c):
            x = x.to(dev)
            return torch.cat([x, x.new_zeros((max_n - c,) + x.shape[1:])])

        self._data_stacked = {
            k: torch.stack([pad(d[k], c) for d, c in zip(sat_data, counts)])
            for k in sat_data[0]}
        # a custom sampler draws from each client's own unpadded data
        self._sat_data = ([tree_map(lambda x: x.to(dev), d) for d in sat_data]
                          if self._custom_sampler else None)
        self.server_data = tree_map(lambda x: x.to(dev), server_data)
        self.log = CommLog()
        self.history: list[RoundMetrics] = []
        self.fault_reports: list[FaultReport] = []

        self.keymgr = KeyManager(prng.PRNGKey(fl.seed + 7, dev),
                                 n_qkd_bits=fl.qkd_bits,
                                 eavesdrop_edges=eavesdrop_edges)
        self._qkd_established: set = set()
        self.aborted_edges: set = set()         # QBER aborts, per edge
        # async oracle state: live per-main buffer lists and the deferred
        # in-flight sends, keyed by their compiled delivery round
        self.pending: dict[int, list] = {}  # main -> [(payload, sat, born)]
        self._outbox: dict[int, list] = {}      # deliver_round -> sends
        # test hook: with async_debug on, every (round, main) buffer merge
        # is recorded as a host tree (the ring-vs-oracle check reads it)
        self.async_debug = False
        self.async_merge_log: list = []
        self._last_fidelity = None      # mean fidelity, last teleport edge
        # the edge-batched secure plane covers the OTP(+MAC) modes; the
        # per-edge loop stays as the numerics/accounting oracle
        self.edge_batched = (edge_batched
                             and fl.security in ("qkd", "qkd_fernet"))

        self._local_train = make_local_train(api, model_cfg, fl, self.opt)
        self._batched_train = make_batched_local_train(api, model_cfg, fl,
                                                       self.opt)
        # the whole schedule, with every edge key established in one
        # batched BB84 when the exchange is secured (teleport too: its
        # exchanges abort on compromised edges like the OTP modes') or the
        # aggregation is (secagg's pairwise mask shares)
        self.plan: RoundPlan = compile_round_plan(
            trace, fl, sample_counts=counts,
            keymgr=(self.keymgr if (fl.security != "none"
                                    or fl.agg_security == "secagg")
                    else None),
            with_seeds=False)
        if fl.mode == "async":
            self._init_async()

    def _init_async(self):
        """Async state of the batched executor: the device ring, keyed
        (satellite, born mod D) with row n_sats the scratch row for masked
        writes, so group reshuffles never remap payloads; under secagg the
        ring of masked mod-2^32 streams (int32 storage) instead."""
        fl, st = self.fl, self.plan.stale
        N, D = self.n_sats, st.D
        es = self.plan.edges
        arr_max = max((int(es.ptr[r, 1] - es.ptr[r, 0])
                       for r in range(self.plan.n_rounds)), default=1)
        self._async_exframe = _next_pow2(max(arr_max, 1))
        if fl.agg_security != "secagg":
            self._ring = tree_map(lambda x: x.new_zeros((N + 1, D)
                                                        + tuple(x.shape)),
                                  self.global_params)
            return
        leaves = tree_leaves(self.global_params)
        # user-config validation must raise (asserts vanish under -O)
        if not all(x.dtype == torch.float32 for x in leaves):
            raise ValueError(
                "agg_security='secagg' quantizes float32 parameters only; "
                "this model has non-f32 leaves")
        self._q_words = sum(x.numel() for x in leaves)
        if 4 * self._q_words != self._row_nbytes:
            raise ValueError("secagg wire stream size disagrees with the "
                             "model's byte accounting")
        self._ring_y = torch.zeros((N + 1, D, self._q_words),
                                   dtype=torch.int32, device=self.device)

    # ------------------------------------------------------------------
    # local training
    # ------------------------------------------------------------------
    def _sat_key(self, r: int, sat: int):
        return prng.fold_in(prng.fold_in(self._train_key, r), sat)

    def _train_sat(self, sat: int, params, r: int):
        """Per-client oracle: the shared program on one client row."""
        fl = self.fl
        one = lambda x: x[None]
        if self._custom_sampler:
            # the caller's sampler on the unpadded data, one key per step
            # from the JAX trainer's split of the (round, sat) key
            keys = prng.split(self._sat_key(r, sat), fl.local_steps)
            batches = [tree_map(one, self.sample_batch(self._sat_data[sat],
                                                       keys[e],
                                                       fl.batch_size))
                       for e in range(fl.local_steps)]
        else:
            data = {k: v[sat:sat + 1] for k, v in self._data_stacked.items()}
            batches = sample_local_batches(data, self._sat_key(r, sat)[None],
                                           fl.batch_size,
                                           self._n_samples[sat:sat + 1],
                                           fl.local_steps)
        p, o, loss = self._local_train(
            tree_map(one, params), tree_map(one, self.opt_states[sat]),
            batches, r * fl.local_steps)
        self.opt_states[sat] = tree_map(lambda x: x[0], o)
        return tree_map(lambda x: x[0], p), loss[0]

    def _broadcast_global(self, k: int):
        return tree_map(lambda x: x.expand((k,) + x.shape),
                        self.global_params)

    def _train_group_batched(self, sat_ids: list[int], params_stacked,
                             r: int, update_opt=None,
                             pad_to: int | None = None):
        """Train ``sat_ids`` as one stage over the stacked client axis.

        params_stacked: leaves (K or Kp, ...) — row j holds sat_ids[j]'s
        input model. Returns (params (Kp, ...), losses (Kp,)), padded to
        ``pad_to`` rows (default: the frame); pad rows repeat row 0. Rows
        where ``update_opt`` is False (seq's idle chains) and pad rows
        leave every real optimizer slot untouched.
        """
        k = len(sat_ids)
        kp = pad_to or self._frame
        dev = self.device
        upd = ([True] * k if update_opt is None
               else [bool(u) for u in update_opt])
        ids = torch.tensor(list(sat_ids) + [sat_ids[0]] * (kp - k),
                           device=dev)
        scatter = torch.tensor([s if u else self.n_sats
                                for s, u in zip(sat_ids, upd)]
                               + [self.n_sats] * (kp - k), device=dev)
        params = tree_map(
            lambda x: torch.cat([x, x[:1].expand((kp - x.shape[0],)
                                                 + x.shape[1:])])
            if x.shape[0] < kp else x, params_stacked)
        keys = prng.fold_in(prng.fold_in(self._train_key, r), ids)
        slots = tree_map(lambda x: x[ids], self._opt_stacked)
        data = {kk: v[ids] for kk, v in self._data_stacked.items()}
        p, o, losses = self._batched_train(params, slots, data,
                                           self._n_samples[ids], keys,
                                           r * self.fl.local_steps)
        # masked and pad rows scatter into the scratch row; the real ids
        # of a stage are distinct
        self._opt_stacked = tree_map(
            lambda full, new: full.index_copy(0, scatter, new),
            self._opt_stacked, o)
        return p, losses

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def _dev_eval(self, params, data, n):
        """Masked per-client (loss, acc) of the global model over each
        client's first ≤64 (padded) samples; the padded tail carries zero
        weight, so each row equals the unpadded per-client metric."""
        m_cap = min(64, data["labels"].shape[1])
        feats = data["features"][:, :m_cap]
        labels = data["labels"][:, :m_cap]
        stacked = tree_map(lambda x: x.expand((feats.shape[0],) + x.shape),
                           params)
        logits, _ = self.api.forward(self.model_cfg, stacked,
                                     {"features": feats})
        lf = logits.to(torch.float32)
        lse = torch.logsumexp(lf, dim=-1)
        ll = lf.gather(-1, labels[..., None])[..., 0]
        valid = (torch.arange(m_cap, device=self.device)[None]
                 < torch.clamp(n, max=m_cap)[:, None]).to(torch.float32)
        cnt = torch.clamp(valid.sum(dim=1), min=1.0)
        loss = ((lse - ll) * valid).sum(dim=1) / cnt
        hit = (torch.argmax(lf, -1) == labels).to(torch.float32)
        return loss, (hit * valid).sum(dim=1) / cnt

    # ------------------------------------------------------------------
    # fault plane (the seeded FaultSchedule riding on the compiled plan)
    # ------------------------------------------------------------------
    def _crashed(self, r: int, s: int) -> bool:
        f = self.plan.faults
        return f is not None and bool(f.crash[r, s])

    def _strag_extra(self, r: int, s: int) -> float:
        """Straggler wall-clock penalty of sender ``s`` at round ``r``,
        added wherever that sender's transfer wall (or async transmit wait)
        is recorded, delivered or not, on both executors."""
        f = self.plan.faults
        return f.straggler_extra(r, s) if f is not None else 0.0

    def _fault_report_for(self, r: int) -> FaultReport:
        """The round's fault ledger, tabulated from the compiled schedule."""
        f, es = self.plan.faults, self.plan.edges
        n_e = int(es.ptr[r, -1])
        # a tampered slot is only DETECTED where data moved: QBER-aborted
        # and flapped slots never reach the receiver's MAC
        detected = (f.tamper[r, :n_e] != 0) & ~f.link_flap[r, :n_e] \
            & ~es.abort[r, :n_e]
        return FaultReport(
            round=r, crashes=int(f.crash[r].sum()),
            stragglers=int(f.straggler[r].sum()),
            link_flaps=int(f.link_flap[r, :n_e].sum())
            + int(f.flap_events[r]),
            corruptions=int(detected.sum()),
            retries=int(f.retry_events[r]), lost=int(f.lost_events[r]),
            recovered=int(f.recovered_events[r]))

    def _raise_round_faults(self, r: int):
        """``on_fault='raise'``: surface the round's first fault as its
        typed error BEFORE the engines degrade; precedence crash >
        retry exhaustion > link flap > corruption (worst loss first)."""
        f, es = self.plan.faults, self.plan.edges
        if f.crash[r].any():
            sites = [(r, int(s)) for s in np.where(f.crash[r])[0]]
            raise SatCrashError(
                f"satellite crash(es) at round {r}: {sites}", sites=sites)
        if int(f.lost_events[r]) > 0:
            raise RetryExhaustedError(
                f"{int(f.lost_events[r])} async update(s) lost at round "
                f"{r} after {self.fl.max_retries} retransmission(s)",
                sites=[(r, "async")])
        n_e = int(es.ptr[r, -1])
        flaps = [es.edge_tuple(r, j) for j in range(n_e) if f.link_flap[r, j]]
        if flaps or int(f.flap_events[r]) > 0:
            raise LinkFlapError(
                f"link flap(s) at round {r}: {flaps or 'async transmit'}",
                sites=[(r, e) for e in flaps] or [(r, "async")])
        tampers = [(r, es.edge_tuple(r, j)) for j in range(n_e)
                   if (f.tamper[r, j] and not f.link_flap[r, j]
                       and not es.abort[r, j])]
        if tampers:
            raise CorruptionError(
                f"payload corruption at round {r}: MAC rejected "
                f"{[e for _, e in tampers]}", sites=tampers)

    # ------------------------------------------------------------------
    # secure exchange (Algorithm 2) — returns params as seen by receiver
    # ------------------------------------------------------------------
    def _transfer_s(self, nbytes: int, link: str, concurrent: int) -> float:
        return (self.comm.isl_transfer(nbytes, concurrent) if link == "isl"
                else self.comm.feeder_transfer(nbytes, concurrent))

    def _exchange(self, params, edge: tuple, round_idx: int, link: str,
                  concurrent: int = 1):
        """Per-edge Algorithm 2 — the numerics/accounting oracle of the
        edge-batched plane. Returns (params_as_received, wall_s); params
        is None when the edge QBER-aborted under on_qber_abort='drop', or
        when an injected fault (link flap, payload tamper) dropped it."""
        fl = self.fl
        fs = self.plan.faults
        # async ISL arrivals are never flapped here: the plan's retransmit
        # ledger resolved their flap/retry history
        flapped = (fs is not None
                   and not (fl.mode == "async" and link == "isl")
                   and fs.flap_of(round_idx, edge))
        nbytes = tree_bytes(params)
        if fl.security == "none":
            if flapped:
                return None, 0.0    # the link dropped before data moved
            t = self._transfer_s(nbytes, link, concurrent)
            self.log.count_transfer(nbytes)   # wall time recorded per round
            return params, t

        t = 0.0
        ek = self.keymgr.get(edge)
        if ek.edge not in self._qkd_established:
            self._qkd_established.add(ek.edge)
            tq = self.comm.qkd_time(fl.qkd_bits)
            self.log.add_security(tq)
            t += tq
        if ek.compromised:
            # eavesdropping detected at key establishment: the edge aborts
            # BEFORE any data moves (nothing counted for this transfer)
            self.aborted_edges.add(ek.edge)
            if fl.on_qber_abort == "raise":
                raise SecurityError(f"QBER abort on edge {ek.edge}",
                                    edges=[ek.edge])
            return None, t                    # drop: sat leaves C(t)
        if flapped:
            # establishment (when due) was paid; the payload never moved
            return None, t

        t += self._transfer_s(nbytes, link, concurrent)
        self.log.count_transfer(nbytes)   # wall time recorded per round
        if fl.security == "teleport":
            return params, t + self._teleport(params)
        seed = int(ek.round_seed(round_idx))
        tv = fs.tamper_of(round_idx, edge) if fs is not None else 0
        received, ok = self._secure_edge(params, seed,
                                         *ek.mac_keys(round_idx), tv)
        # the compiled schedule, not a ~2^-31 tag collision, decides that a
        # tampered payload is dropped
        if not ok and not tv:
            raise SecurityError(f"MAC mismatch on edge {ek.edge}",
                                edges=[ek.edge])
        tc = 2 * self.comm.crypto_time(nbytes)
        if fl.security == "qkd_fernet":
            # control-plane metadata rides in a Fernet token keyed off the
            # QKD seed (the paper's QKD+Fernet mode)
            fkey = seed.to_bytes(4, "big") * 8
            meta = f"edge={ek.edge} round={round_idx} n={nbytes}".encode()
            tok = fernet_encrypt(fkey, meta)
            if fernet_decrypt(fkey, tok) != meta:
                raise SecurityError(f"Fernet token corrupt on edge {ek.edge}",
                                    edges=[ek.edge])
            tc += 2 * self.comm.crypto_time(len(tok))
        self.log.add_security(tc)
        if tv:
            # corruption detected AFTER transfer and crypto were paid: the
            # receiver discards the payload
            return None, t + tc
        return received, t + tc

    def _teleport(self, params) -> float:
        """Teleport a sample of (θ, φ) angle pairs of the payload (the
        feasibility primitive): records the mean fidelity and returns the
        classical channel's time."""
        # an int32 leaf is a secagg wire stream: uint32 words in int32
        # storage, read as the unsigned values they carry
        flat = torch.cat([(x.to(torch.int64) & 0xFFFFFFFF
                           if x.dtype == torch.int32 else x)
                          .reshape(-1).to(torch.float32)
                          for x in tree_leaves(params)])
        n = min(self.fl.teleport_pairs, flat.shape[0] // 2)
        thetas = torch.clamp(_jnp_mod(torch.abs(flat[:n]), math.pi), 0.0,
                             math.pi)
        phis = _jnp_mod(flat[n:2 * n] + math.pi, 2 * math.pi) - math.pi
        self.key, k = prng.split(self.key)
        _, _, fid = teleport_params(k, thetas, phis)
        self._last_fidelity = float(fid)
        tt = self.comm.teleport_time(n)
        self.log.add_security(tt)
        return tt

    def _secure_edge(self, params, seed: int, mac_r: int, mac_s: int,
                     tamper: int = 0):
        """One edge's payload through OTP + MAC, as two launches of the
        fused kernel's seeded stream entry: the sender encrypts and tags
        its ciphertext, the receiver regenerates the pad from its own copy
        of the seed, tags what it received and decrypts it. ``tamper`` (0 =
        clean; the fault plane sets it) flips the first received word
        before the receiver's launch and is undone after decryption, as in
        ``_secure_stage``. Returns (tree, MAC ok: True without
        verification)."""
        msg = as_storage(tree_to_u32(params))
        layout = pad_layout(params)
        ct, tag = otp_ops.otp_xor_mac_stream_seeded(msg, seed, layout, mac_r,
                                                    mac_s)
        if tamper:
            flip = int(np.array([tamper], np.uint32).view(np.int32)[0])
            ct = ct.clone()
            ct[0] ^= flip
        plain, tag_rx = otp_ops.otp_xor_mac_stream_seeded(
            ct, seed, layout, mac_r, mac_s, tag_input=True)
        if tamper:
            plain[0] ^= flip
        ok = (not self.fl.verify_mac
              or bool(_mac_rows_verify(tag, tag_rx)))
        return u32_to_tree(plain, params), ok

    def _secure_stage(self, stacked, seeds, mac_r, mac_s, tamper):
        """ONE edge-batched Algorithm-2 dispatch over the frame's rows: the
        sender's XOR + MAC and the receiver's MAC + XOR, one launch each of
        the fused kernel's seeded rows entry, which generates every row's
        pad from its seed. Rows without an edge carry seed 0 and pass
        through bit-identically (XOR is an involution).

        seeds/mac_r/mac_s/tamper: (K,) uint32 numpy, copied to the device
        together as one (3, K) array. ``tamper`` is the wire-corruption
        word per row (0 = clean; the fault plane sets it): it flips the
        first RECEIVED word before the receiver's MAC, so a tampered row
        fails verification, and is undone after decryption so a dropped
        row keeps the sender's payload, as the JAX stage decrypts the
        clean ciphertext. Returns (tree, ok (K,) bool or None without MAC
        verification)."""
        dev = self.device
        seeds_t, mac_r_t, mac_s_t = torch.from_numpy(
            np.stack([seeds, mac_r, mac_s]).astype(np.uint32).view(np.int32)
        ).to(dev)
        layout = pad_layout(stacked, lead=1)
        msg = as_storage(tree_to_u32_rows(stacked))
        ct, tags = otp_ops.otp_xor_mac_rows_seeded(msg, seeds_t, layout,
                                                   mac_r_t, mac_s_t)
        flip = None
        if tamper.any():
            flip = torch.from_numpy(
                tamper.astype(np.uint32).view(np.int32)).to(dev)
            ct = ct.clone()
            ct[:, 0] ^= flip
        plain, tags_rx = otp_ops.otp_xor_mac_rows_seeded(
            ct, seeds_t, layout, mac_r_t, mac_s_t, tag_input=True)
        if flip is not None:
            plain[:, 0] ^= flip
        ok = _mac_rows_verify(tags, tags_rx) if self.fl.verify_mac else None
        return u32_to_tree_rows(plain, stacked), ok

    def _exchange_rows_batched(self, stacked, rows, edges, r: int,
                               stage: int, link: str, conc, borns=None):
        """Edge-batched Algorithm 2 for one round stage.

        Key material, first-contact and abort masks come from the compiled
        EdgeSchedule; the device work for ALL edges is one secure stage,
        and the stage's Fernet control tokens are one batched call. The
        scalar accounting walks edges in the exact per-edge-oracle order,
        so comm/security totals are equal to the float.
        """
        fl = self.fl
        es = self.plan.edges
        fs = self.plan.faults
        lo, hi = es.stage_bounds(r, stage)
        if hi - lo != len(edges):
            raise RuntimeError(f"plan and engine disagree on stage "
                               f"{(r, stage)}: {hi - lo} vs {len(edges)}")
        nbytes = self._row_nbytes
        tq = self.comm.qkd_time(fl.qkd_bits)
        walls, delivered, tampv, fern = [], [], [], []
        for j, edge in enumerate(edges):
            e = es.edge_tuple(r, lo + j)
            c = int(es.conc[r, lo + j])
            plan_link = "feeder" if es.link[r, lo + j] else "isl"
            bn = int(es.born[r, lo + j])
            if (e != canonical_edge(edge) or c != conc[j]
                    or plan_link != link
                    or bn != (borns[j] if borns is not None else r)):
                raise RuntimeError(f"plan and engine disagree on edge {e} "
                                   f"of stage {(r, stage)}")
            t = 0.0
            if es.first[r, lo + j]:
                self._qkd_established.add(e)
                self.log.add_security(tq)
                t += tq
            if es.abort[r, lo + j]:
                self.aborted_edges.add(e)
                if fl.on_qber_abort == "raise":
                    raise SecurityError(f"QBER abort on edge {e}", edges=[e])
                walls.append(t)
                delivered.append(False)
                tampv.append(0)
                continue
            if fs is not None and fs.link_flap[r, lo + j]:
                # injected flap: establishment (when due) was paid, the
                # payload never moved; the row drops like a QBER abort
                walls.append(t)
                delivered.append(False)
                tampv.append(0)
                continue
            t += self._transfer_s(nbytes, link, c)
            self.log.count_transfer(nbytes)
            tc = 2 * self.comm.crypto_time(nbytes)
            if fl.security == "qkd_fernet":
                # the token's length is structural, so the accounting stays
                # in the loop; the hashlib work is one batched call below
                meta = f"edge={e} round={bn} n={nbytes}".encode()
                fern.append((e, int(es.seed[r, lo + j]), meta))
                tc += 2 * self.comm.crypto_time(TOKEN_OVERHEAD + len(meta))
            self.log.add_security(tc)
            walls.append(t + tc)
            # injected tamper: transfer and crypto were paid, then the
            # receiver's MAC rejects the payload and the row is dropped
            tv = int(fs.tamper[r, lo + j]) if fs is not None else 0
            tampv.append(tv)
            delivered.append(tv == 0)

        if fern:
            fkeys = [seed.to_bytes(4, "big") * 8 for _, seed, _ in fern]
            toks = fernet_encrypt_rows(fkeys, [m for _, _, m in fern])
            try:
                back = fernet_decrypt_rows(fkeys, toks)
            except InvalidToken as err:
                raise SecurityError(
                    f"Fernet token corrupt in stage {(r, stage)}: {err}",
                    edges=[e for e, _, _ in fern]) from err
            bad = [e for (e, _, m), got in zip(fern, back) if got != m]
            if bad:
                raise SecurityError(f"Fernet token corrupt on edges {bad}",
                                    edges=bad)

        # device plane: one stage over the frame, row-aligned (rows without
        # a delivered or tampered edge get seed 0 and pass through)
        K = tree_leaves(stacked)[0].shape[0]
        seeds, mr, ms, tam = (np.zeros((K,), np.uint32) for _ in range(4))
        live_rows = []
        for j, row in enumerate(rows):
            if delivered[j] or tampv[j]:
                # a tampered row rides the stage with its real keys and the
                # injected wire word, so the receiver's MAC rejects it in
                # the kernel; it stays out of live_rows (the schedule, not a
                # ~2^-31 tag collision, decides that it drops)
                seeds[row] = es.seed[r, lo + j]
                mr[row] = es.mac_r[r, lo + j]
                ms[row] = es.mac_s[r, lo + j]
                tam[row] = tampv[j]
            if delivered[j]:
                live_rows.append((row, edges[j]))
        out, ok = self._secure_stage(stacked, seeds, mr, ms, tam)
        if ok is not None and live_rows:
            ok = ok.cpu().numpy()
            bad = [canonical_edge(e) for row, e in live_rows if not ok[row]]
            if bad:
                raise SecurityError(f"MAC mismatch on edges {bad}",
                                    edges=bad)
        return out, walls, delivered

    def _exchange_rows(self, stacked, rows: list[int], edges: list[tuple],
                       r: int, stage: int, link: str, concurrents=None,
                       borns=None):
        """Algorithm-2 exchange over rows of a stacked (K, ...) tree.

        ``rows[j]`` is the stacked row carrying ``edges[j]``'s payload and
        ``borns[j]`` (default: this round) the round it was trained: async
        deferred deliveries key their pad seeds off it. Returns (stacked,
        walls, delivered): delivered[j] is False for a QBER-dropped edge,
        whose row passes through untouched and which the caller masks out
        of aggregation. security='none' never touches the tensors
        (accounting only); the OTP(+MAC) modes run one edge-batched stage
        (``edge_batched=True``) or the per-edge oracle on row slices —
        identical bits, identical accounting.
        """
        k = len(edges)
        conc = concurrents or [1] * k
        if self.fl.security == "none":
            fs = self.plan.faults
            flap = [False] * k
            if fs is not None and fs.link_flap_rate > 0:
                lo, _ = self.plan.edges.stage_bounds(r, stage)
                flap = [bool(fs.link_flap[r, lo + j]) for j in range(k)]
            walls = []
            for c, dropped in zip(conc, flap):
                # a flapped link drops before any data moved: nothing counted
                walls.append(0.0 if dropped
                             else self._transfer_s(self._row_nbytes, link, c))
                if not dropped:
                    self.log.count_transfer(self._row_nbytes)
            return stacked, walls, [not d for d in flap]
        if self.edge_batched:
            return self._exchange_rows_batched(stacked, rows, edges, r,
                                               stage, link, conc, borns)
        out_rows, walls, delivered = [], [], []
        for j, (edge, c) in enumerate(zip(edges, conc)):
            p_j = tree_map(lambda x: x[rows[j]], stacked)
            p_j, t = self._exchange(p_j, edge,
                                    borns[j] if borns is not None else r,
                                    link, c)
            delivered.append(p_j is not None)
            out_rows.append(p_j)
            walls.append(t)
        live = [j for j in range(k) if delivered[j]]
        if live:
            # one gather-scatter, not one full-tree copy per row
            idx = torch.tensor([rows[j] for j in live], device=self.device)
            exchanged = tree_map(lambda *xs: torch.stack(xs),
                                 *[out_rows[j] for j in live])
            stacked = tree_map(lambda full, new: full.index_copy(0, idx, new),
                               stacked, exchanged)
        return stacked, walls, delivered

    # ------------------------------------------------------------------
    # aggregation
    # ------------------------------------------------------------------
    def _weight_of(self, s: int) -> float:
        return float(self.plan.weights[s])

    def _aggregate(self, models: list, ws: list):
        """FedAvg: normalized weighted sum; ws parallel to models."""
        wsum = sum(ws)
        return tree_weighted_sum(models, [w / wsum for w in ws])

    def _wmean_rows(self, stacked, w):
        """Weighted mean over the stacked client axis (fp32 accumulate)."""
        wn = torch.as_tensor(np.asarray(w, np.float32), device=self.device)
        wn = wn / torch.clamp(wn.sum(), min=1e-9)
        return tree_map(
            lambda x: torch.tensordot(wn, x.to(torch.float32),
                                      dims=([0], [0])).to(x.dtype), stacked)

    # ------------------------------------------------------------------
    # per-mode group merges (per-client oracle): each merges one
    # {main: secs} group and returns
    # (merged_params, group_wall_s, group_wait_s, delivered_count)
    # ------------------------------------------------------------------
    def _merge_seq(self, r: int, main: int, secs: list):
        # the chain is SERIAL: wall = sum of hop transfers
        theta = self.global_params
        chain_wall = 0.0
        delivered = 0
        for s in secs:
            prev = theta
            theta, _ = self._train_sat(s, theta, r)
            theta, t = self._exchange(theta, (s, main), r, "isl")
            chain_wall += t + self._strag_extra(r, s)
            if theta is None:
                theta = prev    # hop aborted or faulted: chain reverts
            else:
                delivered += 1
        return theta, chain_wall, 0.0, delivered

    def _merge_sim(self, r: int, main: int, secs: list):
        # parallel uploads CONTEND for the main's ISL aperture
        # (bandwidth / n_concurrent): wall = max over secs
        collected, ws, up_walls = [], [], [0.0]
        for s in secs:
            p, _ = self._train_sat(s, self.global_params, r)
            p, t = self._exchange(p, (s, main), r, "isl",
                                  concurrent=max(len(secs), 1))
            up_walls.append(t + self._strag_extra(r, s))
            if p is None:
                continue            # QBER abort / injected fault: dropped
            collected.append(p)
            ws.append(self._weight_of(s))
        merged = (self._aggregate(collected, ws) if collected
                  else self.global_params)
        return merged, max(up_walls), 0.0, len(collected)

    def _secagg_merge_oracle(self, m: int, fresh: list):
        """Unmask and dequantize one main's secagg merge batch.

        ``fresh``: [(payload, sat, born)] in (sat, born) order. Masks of
        partners inside the batch cancel; every absent cohort partner's
        signed pads are recovered from the key registry and cancelled
        exactly (mod 2^32)."""
        st = self.plan.stale
        agg = torch.stack([p["y"] for p, _, _ in fresh]).to(
            torch.int64).sum(dim=0)
        inset = {(s, b) for _, s, b in fresh}
        pairs, borns, signs = [], [], []
        for _, s, b in fresh:
            # the cohort is the born round's live group: the compiled
            # pairwise-mask schedule was dealt over it
            for s2 in self.plan.live_groups(b)[m]:
                if s2 == s or (s2, b) in inset:
                    continue            # partner merges here: masks cancel
                pairs.append(canonical_edge((s, s2)))
                borns.append(b)
                signs.append(-(1 if s < s2 else -1))
        agg = agg + self.keymgr.recover_masks(pairs, borns, signs,
                                              self._q_words).to(torch.int64)
        sumw = sum(int(st.wq[s]) for _, s, _ in fresh)
        return q32_to_tree(as_storage(agg), self.global_params, float(sumw))

    def _list_merge(self, g: int, fresh: list):
        """Main ``g``'s merge of its buffer list ``fresh`` [(payload, sat,
        born)] in (sat, born) order: the ring's frame holding only these
        entries, the ring's weight shape with only row g set, and the
        ring's own reduction (``_frame_merge``), so the result equals the
        ring's merge of the same entries bit for bit."""
        D = self.plan.stale.D
        mp, nd = self._frame, (self.n_sats + 1) * D
        ws = [float(self.plan.weights[s]) for _, s, _ in fresh]
        wsum = sum(ws)
        w = np.zeros((mp, nd), np.float32)
        pos = []
        for (_, s, b), wt in zip(fresh, ws):
            pos.append(s * D + b % D)
            w[g, pos[-1]] = np.float32(wt / wsum)
        idx = torch.tensor(pos, device=self.device)
        frame = tree_map(
            lambda *xs: xs[0].new_zeros((nd,) + tuple(xs[0].shape))
            .index_copy(0, idx, torch.stack(xs)),
            *[p for p, _, _ in fresh])
        merged = _frame_merge(frame, torch.from_numpy(w).to(self.device))
        return tree_map(lambda x: x[g], merged)

    def _async_oracle_prepare(self, r: int):
        """Async, per-main-list oracle: one round's buffer mechanics.

        Phase 1 trains every grouped secondary and schedules its send at
        the compiled delivery round (``plan.stale.deliver_round``); phase 2
        drains this round's arrivals — per-edge Algorithm 2, pad seeds
        keyed by the BORN round — into the live per-main lists; phase 3
        lets each current main merge its fresh entries (staleness filter,
        then ``_frame_merge`` over the ring's frame, so the merged
        parameters equal the ring's bit for bit) and discard the rest.
        Window waits are recorded per trained secondary as min(wait,
        comm.window_wait_s): a windowless satellite clamps to the cap.
        """
        fl, st, cap = self.fl, self.plan.stale, self.comm.window_wait_s
        groups = self.plan.live_groups(r)
        mains = list(groups)
        state = {"merged": {}, "walls": {}, "waits": {}, "delivered": {}}
        secagg = fl.agg_security == "secagg"
        for m, secs in groups.items():
            gw = 0.0
            for s in secs:
                p, _ = self._train_sat(s, self.global_params, r)
                gw = max(gw, min(float(st.tx_wait_s[r, s]), cap)
                         + self._strag_extra(r, s))
                rd = int(st.deliver_round[r, s])
                if rd < 0:
                    continue    # windowless / stale on arrival / horizon
                if secagg:
                    p = {"y": secagg_mask_stream(p, int(st.wq[s]),
                                                 st.pair_seed[r, s],
                                                 st.pair_sign[r, s])}
                self._outbox.setdefault(rd, []).append((s, m, r, p))
            state["waits"][m] = gw
        for (s, m, b, payload) in self._outbox.pop(r, []):
            p2, t = self._exchange(payload, (s, m), b, "isl")
            # an arrival whose destination lost primary status still costs
            # its transfer: fold it into the round wall via the first group
            key = m if m in groups else mains[0]
            state["walls"][key] = max(state["walls"].get(key, 0.0), t)
            if p2 is None:
                continue                    # QBER abort: update dropped
            self.pending.setdefault(m, []).append((p2, s, b))
        for g, m in enumerate(mains):
            q = self.pending.get(m, [])
            fresh = sorted([e for e in q if r - e[2] <= fl.max_staleness],
                           key=lambda e: (e[1], e[2]))
            self.pending[m] = []            # merged or stale-discarded
            state["delivered"][m] = len(fresh)
            if not fresh:
                state["merged"][m] = self.global_params
            elif secagg:
                state["merged"][m] = self._secagg_merge_oracle(m, fresh)
            else:
                state["merged"][m] = self._list_merge(g, fresh)
        self._async_state = state

    def _merge_async(self, r: int, main: int, secs: list):
        stt = self._async_state
        if self.async_debug:
            self.async_merge_log.append(
                (r, main, tree_map(lambda x: x.detach().cpu().clone(),
                                   stt["merged"][main])))
        return (stt["merged"][main], stt["walls"].get(main, 0.0),
                stt["waits"][main], stt["delivered"][main])

    _GROUP_SCHEDULERS = {"seq": _merge_seq, "sim": _merge_sim,
                         "async": _merge_async}

    # ------------------------------------------------------------------
    # per-mode group merges (batched executor): each returns
    # (merged_stacked (mp, ...), group_walls, group_waits, delivered)
    # ------------------------------------------------------------------
    def _merge_sim_batched(self, r: int, mains: list, groups: dict, mp: int):
        secs_all = [s for m in mains for s in groups[m]]
        group_walls = [0.0] * len(mains)
        if not secs_all:
            return self._broadcast_global(mp), group_walls, [0.0], 0
        sp = self._frame
        p, _ = self._train_group_batched(secs_all,
                                         self._broadcast_global(sp), r)
        conc = [max(len(groups[m]), 1) for m in mains for _ in groups[m]]
        edges = [(s, m) for m in mains for s in groups[m]]
        p, walls, delivered = self._exchange_rows(
            p, list(range(len(secs_all))), edges, r, 0, "isl", conc)
        # masked weighted group reduction over the stacked client axis;
        # QBER-dropped rows carry no weight
        a = np.zeros((mp, sp), np.float32)
        j = 0
        for g, m in enumerate(mains):
            for s in groups[m]:
                if delivered[j]:
                    a[g, j] = self._weight_of(s)
                group_walls[g] = max(group_walls[g],
                                     walls[j] + self._strag_extra(r, s))
                j += 1
        row_sum = a.sum(axis=1, keepdims=True)
        an = torch.as_tensor(a / np.where(row_sum > 0, row_sum, 1.0),
                             device=self.device)
        keep = torch.as_tensor(row_sum[:, 0] == 0, device=self.device)

        def _merge(x, g):
            m = torch.tensordot(an, x.to(torch.float32), dims=([1], [0]))
            k = keep.reshape((-1,) + (1,) * (x.dim() - 1))
            return torch.where(k, g.to(torch.float32), m).to(x.dtype)

        merged = tree_map(_merge, p, self._broadcast_global(mp))
        return merged, group_walls, [0.0], int(sum(delivered))

    def _merge_seq_batched(self, r: int, mains: list, groups: dict, mp: int):
        # chains are serial WITHIN a group but parallel ACROSS groups: hop
        # h trains the h-th secondary of every chain as one stage
        chains = [groups[m] for m in mains]
        n_chains = len(mains)
        theta = self._broadcast_global(mp)
        chain_walls = [0.0] * n_chains
        delivered = 0
        for hop in range(max((len(c) for c in chains), default=0)):
            active = [len(c) > hop for c in chains]
            ids = [c[hop] if len(c) > hop else mains[g]
                   for g, c in enumerate(chains)]
            theta_prev = theta
            p_new, _ = self._train_group_batched(ids, theta, r,
                                                 update_opt=active, pad_to=mp)
            mask = torch.as_tensor(active + [False] * (mp - n_chains),
                                   device=self.device)
            theta = tree_map(
                lambda new, old: torch.where(
                    mask.reshape((-1,) + (1,) * (new.dim() - 1)), new, old),
                p_new, theta)
            act_rows = [g for g in range(n_chains) if active[g]]
            if self.fl.security == "none":
                fs = self.plan.faults
                dropped = []
                for g in act_rows:
                    s = chains[g][hop]
                    chain_walls[g] += self._strag_extra(r, s)
                    if fs is not None and fs.flap_of(r, (s, mains[g])):
                        dropped.append(g)   # the link flapped: nothing moved
                        continue
                    chain_walls[g] += self.comm.isl_transfer(self._row_nbytes)
                    self.log.count_transfer(self._row_nbytes)
                    delivered += 1
            else:
                edges = [(chains[g][hop], mains[g]) for g in act_rows]
                theta, walls, ok = self._exchange_rows(theta, act_rows,
                                                       edges, r, hop, "isl")
                for t, g in zip(walls, act_rows):
                    chain_walls[g] += t + self._strag_extra(r,
                                                            chains[g][hop])
                dropped = [g for g, d in zip(act_rows, ok) if not d]
                delivered += int(sum(ok))
            if dropped:
                # an aborted or faulted hop never reached the next hop:
                # those chains revert to their pre-hop state
                idx = torch.tensor(dropped, device=self.device)
                theta = tree_map(
                    lambda full, old: full.index_copy(0, idx, old[idx]),
                    theta, theta_prev)
        return theta, chain_walls, [0.0], delivered

    # ------------------------------------------------------------------
    # async ring (batched executor)
    # ------------------------------------------------------------------
    def _async_merge(self, mw: torch.Tensor, anyv: torch.Tensor):
        """The whole async merge over the ring: mw (mp, N+1, D) holds the
        plan's normalized weights (0 = cell not in this round's merge);
        mains without an entry (anyv False) keep the global model."""
        mp = mw.shape[0]
        frame = tree_map(lambda x: x.reshape((-1,) + tuple(x.shape[2:])),
                         self._ring)
        merged = _frame_merge(frame, mw.reshape(mp, -1))

        def keep(m, g):
            k = anyv.reshape((-1,) + (1,) * (m.dim() - 1))
            return torch.where(k, m, g[None].to(m.dtype))

        return tree_map(keep, merged, self.global_params)

    def _async_merge_y(self, sel, corr_seed, corr_sign, sumw, anyv):
        """The secagg merge: every main's masked mod-2^32 sum over the ring
        plus the plan's signed correction streams (absent partners' pads
        cancelled; one pad call for all mains), then dequantized."""
        mp = sel.shape[0]
        yf = self._ring_y.reshape(-1, self._q_words).to(torch.int64)
        agg = (sel.reshape(mp, -1, 1) * yf[None]).sum(dim=1)
        corr = sum_signed_pads(corr_seed, corr_sign, self._q_words)
        merged = q32_to_tree(as_storage(agg + corr.to(torch.int64)),
                             self.global_params, sumw)

        def keep(m, g):
            k = anyv.reshape((-1,) + (1,) * (m.dim() - 1))
            return torch.where(k, m, g[None]).to(g.dtype)

        return tree_map(keep, merged, self.global_params)

    def _merge_async_batched(self, r: int, mains: list, groups: dict,
                             mp: int):
        """Async round: train (one stage), scatter into the ring, exchange
        the plan's compiled arrivals (one secure stage) and merge every
        main's buffer (one reduction) — no per-main lists."""
        fl, st = self.fl, self.plan.stale
        cap = self.comm.window_wait_s
        secagg = fl.agg_security == "secagg"
        N, D = self.n_sats, st.D
        dev = self.device
        if [int(x) for x in st.main_ids[r] if x >= 0] != mains:
            raise RuntimeError(f"plan and engine disagree on the mains of "
                               f"round {r}")
        group_walls = [0.0] * len(mains)
        group_waits = [0.0] * len(mains)
        secs_all = [s for m in mains for s in groups[m]]
        if secs_all:
            p, _ = self._train_group_batched(
                secs_all, self._broadcast_global(self._frame), r)
            for g, m in enumerate(mains):
                for s in groups[m]:
                    group_waits[g] = max(
                        group_waits[g],
                        min(float(st.tx_wait_s[r, s]), cap)
                        + self._strag_extra(r, s))
            sats = np.full((self._frame,), N, np.int64)
            slots = np.zeros((self._frame,), np.int64)
            for j, s in enumerate(secs_all):
                if st.send_slot[r, s] >= 0:
                    sats[j], slots[j] = s, st.send_slot[r, s]
            cell = (torch.from_numpy(sats).to(dev),
                    torch.from_numpy(slots).to(dev))
            if secagg:
                wq = np.ones((self._frame,), np.int64)
                seeds = np.zeros((self._frame,) + st.pair_seed.shape[2:],
                                 np.int64)
                signs = np.zeros((self._frame,) + st.pair_sign.shape[2:],
                                 np.int64)
                for j, s in enumerate(secs_all):
                    wq[j] = st.wq[s]
                    seeds[j] = st.pair_seed[r, s]
                    signs[j] = st.pair_sign[r, s]
                # every row's quantize + mask in one pass, pads of all
                # (row, partner) seeds in one threefry call
                self._ring_y.index_put_(cell, secagg_mask_rows(
                    p, torch.from_numpy(wq).to(dev),
                    torch.from_numpy(seeds).to(dev),
                    torch.from_numpy(signs).to(dev)))
            else:
                tree_map(lambda full, x: full.index_put_(cell, x),
                         self._ring, p)
        # arrivals: updates whose window has opened by this round (the
        # plan's stage-0 edge list IS the delivery schedule)
        es = self.plan.edges
        lo, hi = es.stage_bounds(r, 0)
        arr = [(int(es.src[r, j]), int(es.dst[r, j]), int(es.born[r, j]))
               for j in range(lo, hi)]
        if arr:
            gathered = None
            if fl.security != "none":
                gi = np.full((self._async_exframe,), N, np.int64)
                gd = np.zeros((self._async_exframe,), np.int64)
                for k, (s, _m, b) in enumerate(arr):
                    gi[k], gd[k] = s, b % D
                gi = torch.from_numpy(gi).to(dev)
                gd = torch.from_numpy(gd).to(dev)
                gathered = ({"y": self._ring_y[gi, gd]} if secagg else
                            tree_map(lambda x: x[gi, gd], self._ring))
            _, walls, _ = self._exchange_rows(
                gathered, list(range(len(arr))), [(s, m) for s, m, _ in arr],
                r, 0, "isl", borns=[b for _, _, b in arr])
            widx = {m: g for g, m in enumerate(mains)}
            for t, (s, m, b) in zip(walls, arr):
                g = widx.get(m, 0)
                group_walls[g] = max(group_walls[g], t)
        merged = self._ring_merge(r)
        if self.async_debug:
            for g, m in enumerate(mains):
                self.async_merge_log.append(
                    (r, m, tree_map(lambda x: x[g].detach().cpu().clone(),
                                    merged)))
        return (merged, group_walls, group_waits,
                int(st.merge_count[r].sum()))

    def _ring_merge(self, r: int):
        """Round r's merge of every main's buffer straight from the ring
        (rows (frame, ...), row g = the g-th main): each main's queue
        append, staleness filter and weights are already baked into the
        plan's masks."""
        fl, st = self.fl, self.plan.stale
        N, D, G, mp = self.n_sats, st.D, st.n_mains_max, self._frame
        dev = self.device
        anyv = np.zeros((mp,), bool)
        anyv[:G] = st.merge_any[r]
        anyv = torch.from_numpy(anyv).to(dev)
        if fl.agg_security != "secagg":
            mw = np.zeros((mp, N + 1, D), np.float32)
            mw[:G] = st.merge_w[r]
            return self._async_merge(torch.from_numpy(mw).to(dev), anyv)
        sel = np.zeros((mp, N + 1, D), np.int64)
        sel[:G] = st.merge_w[r] > 0
        cs = np.zeros((mp,) + st.corr_seed.shape[2:], np.int64)
        cg = np.zeros((mp,) + st.corr_sign.shape[2:], np.int64)
        cs[:G] = st.corr_seed[r]
        cg[:G] = st.corr_sign[r]
        sw = np.zeros((mp,), np.float32)
        sw[:G] = st.sum_wq[r]
        return self._async_merge_y(
            torch.from_numpy(sel).to(dev), torch.from_numpy(cs).to(dev),
            torch.from_numpy(cg).to(dev), torch.from_numpy(sw).to(dev), anyv)

    _BATCHED_SCHEDULERS = {"seq": _merge_seq_batched,
                           "sim": _merge_sim_batched,
                           "async": _merge_async_batched}

    # ------------------------------------------------------------------
    # round schedulers
    # ------------------------------------------------------------------
    def _round_qfl(self, r: int) -> int:
        """Flat FedAvg baseline: every satellite talks to the server over
        its own feeder beam — transfers are PARALLEL (wall = max). Crashed
        satellites sit out."""
        ids = self.plan.live_sats(r)
        if self.batched:
            if not ids:
                self.log.add_wall(0.0)
                return 0
            p, _ = self._train_group_batched(
                ids, self._broadcast_global(self._frame), r)
            p, walls, delivered = self._exchange_rows(
                p, list(range(len(ids))), [("gs", s) for s in ids], r, 0,
                "feeder")
            walls = [t + self._strag_extra(r, s) for t, s in zip(walls, ids)]
            self.log.add_wall(2 * max([0.0] + walls))
            w = np.zeros((self._frame,), np.float32)
            for j, s in enumerate(ids):
                if delivered[j]:
                    w[j] = self.plan.weights[s]
            if any(delivered):
                self.global_params = self._wmean_rows(p, w)
            return int(sum(delivered))
        updates, ws, walls = [], [], [0.0]
        for s in ids:
            p, _ = self._train_sat(s, self.global_params, r)
            p, t = self._exchange(p, ("gs", s), r, "feeder")
            walls.append(t + self._strag_extra(r, s))
            if p is None:
                continue            # QBER abort / injected fault: dropped
            updates.append(p)
            ws.append(self._weight_of(s))
        self.log.add_wall(2 * max(walls))   # up + broadcast down
        if updates:
            self.global_params = self._aggregate(updates, ws)
        return len(updates)

    def _round_hierarchical(self, r: int) -> int:
        """Algorithm 1 proper (per-client oracle): the mode's group merge,
        main-satellite training, feeder uplink, global FedAvg through the
        same frame-padded weighted reduction as the batched executor."""
        fl = self.fl
        merge_group = self._GROUP_SCHEDULERS[fl.mode]
        if fl.mode == "async":
            # cross-group phases (training, deferred arrivals, buffer
            # appends) run once per round; each group then reads its merge
            self._async_oracle_prepare(r)
        mp = self._frame
        main_ws = np.zeros((mp,), np.float32)
        main_models = [None] * mp
        group_walls, feeder_walls, group_waits = [0.0], [0.0], [0.0]
        participants = 0
        for g, (main, secs) in enumerate(self.plan.live_groups(r).items()):
            merged, wall, wait, delivered = merge_group(self, r, main, secs)
            group_walls.append(wall)
            group_waits.append(wait)
            participants += delivered
            if fl.main_trains and not self._crashed(r, main):
                # a crashed MAIN still relays, merges and feeds (the comms
                # bus survives) but its payload computer skips training
                merged, _ = self._train_sat(main, merged, r)
                participants += 1
            merged, t = self._exchange(merged, (main, "gs"), r, "feeder")
            feeder_walls.append(t + self._strag_extra(r, main))
            if merged is None:
                continue        # feeder QBER abort / fault: group lost
            main_models[g] = merged
            main_ws[g] = (self._weight_of(main)
                          + sum(self._weight_of(s) for s in secs))
        if main_ws.any():
            zeros = tree_map(torch.zeros_like, self.global_params)
            stacked = tree_map(
                lambda *xs: torch.stack(xs),
                *[m if m is not None else zeros for m in main_models])
            self.global_params = self._wmean_rows(stacked, main_ws)
        # groups run in parallel: the round blocks on the slowest group,
        # then the slowest feeder uplink, plus the broadcast back down;
        # window waits overlap the same way (recorded once, the slowest)
        self.log.add_wait(max(group_waits))
        self.log.add_wall(max(group_walls) + 2 * max(feeder_walls))
        return participants

    def _round_hierarchical_batched(self, r: int) -> int:
        """The same Algorithm-1 round with local training dispatched once
        per stage over the stacked client axis: secondaries (the mode's
        merge), then mains, then one weighted reduction for the global
        model."""
        groups = self.plan.live_groups(r)
        mains = list(groups)
        if not mains:
            self.log.add_wait(0.0)
            self.log.add_wall(0.0)
            return 0
        mp = self._frame
        merged, group_walls, group_waits, participants = \
            self._BATCHED_SCHEDULERS[self.fl.mode](self, r, mains, groups, mp)
        if self.fl.main_trains:
            live_m = [not self._crashed(r, m) for m in mains]
            p_new, _ = self._train_group_batched(mains, merged, r,
                                                 update_opt=live_m, pad_to=mp)
            if all(live_m):
                merged = p_new
            else:
                # crashed mains ride the stage as masked rows, so the frame
                # and every other row's bits stay as they are: their
                # optimizer slots are untouched and their merged params
                # pass through untrained (the payload computer is down)
                keep = torch.as_tensor(live_m + [False] * (mp - len(mains)),
                                       device=self.device)
                merged = tree_map(
                    lambda new, old: torch.where(
                        keep.reshape((-1,) + (1,) * (new.dim() - 1)),
                        new, old), p_new, merged)
            participants += int(sum(live_m))
        feeder_stage = int(self.plan.edges.n_stages[r]) - 1
        merged, feeder_walls, fdel = self._exchange_rows(
            merged, list(range(len(mains))), [(m, "gs") for m in mains], r,
            feeder_stage, "feeder")
        feeder_walls = [t + self._strag_extra(r, m)
                        for t, m in zip(feeder_walls, mains)]
        # pad rows carry zero weight, so the padded reduction is exact;
        # feeder-aborted mains contribute nothing (their group is lost)
        main_ws = np.zeros((mp,), np.float32)
        main_ws[:len(mains)] = [
            (self._weight_of(m) + sum(self._weight_of(s) for s in groups[m]))
            if fdel[g] else 0.0
            for g, m in enumerate(mains)]
        if any(fdel):
            self.global_params = self._wmean_rows(merged, main_ws)
        self.log.add_wait(max([0.0] + group_waits))
        self.log.add_wall(max([0.0] + group_walls)
                          + 2 * max([0.0] + feeder_walls))
        return participants

    # ------------------------------------------------------------------
    # round-granularity checkpoints
    # ------------------------------------------------------------------
    # A checkpoint is (tree, metadata). The tree holds everything numeric
    # whose bits the resume must reproduce: the global params, the
    # teleport key, the optimizer slots and, for async, the staleness ring
    # (batched) or the in-flight buffer payloads (oracle), whose
    # variable-length structure the metadata's index lists describe so the
    # load template can be rebuilt. Everything host-side (CommLog, history,
    # fault reports, abort and establishment sets) rides in the metadata.
    # The KeyManager is not saved: every plan edge is established at
    # compile time from fl.seed, so rebuilding it is exact.

    def _async_payload_like(self):
        if self.fl.agg_security == "secagg":
            return {"y": torch.zeros((self._q_words,), dtype=torch.int32,
                                     device=self.device)}
        return self.global_params

    def _stack_opt_states(self):
        return tree_map(lambda *xs: torch.stack(xs), *self.opt_states)

    def _ckpt_ring(self):
        """The float ring as a checkpoint holds it. Under secagg the JAX
        trainer keeps an unused zero ring beside ``ring_y``; it is written
        (and read back, then dropped) so both trainers' files hold the
        same leaves."""
        if self.fl.agg_security != "secagg":
            return self._ring
        D = self.plan.stale.D
        return tree_map(lambda x: x.new_zeros((self.n_sats + 1, D)
                                              + tuple(x.shape)),
                        self.global_params)

    def _ckpt_state(self):
        fl = self.fl
        dev = {"params": self.global_params, "key": self.key,
               "opt": (self._opt_stacked if self.batched
                       else self._stack_opt_states())}
        pending_idx, outbox_idx = [], []
        if fl.mode == "async":
            if self.batched:
                dev["ring"] = self._ckpt_ring()
                if fl.agg_security == "secagg":
                    dev["ring_y"] = self._ring_y
            else:
                pend, outp = [], []
                # flattened in dict-insertion and list order; the index
                # lists let restore rebuild the same iteration order (the
                # buffer merge and the establishment accounting follow it)
                for mn, lst in self.pending.items():
                    for (p, s, b) in lst:
                        pending_idx.append([int(mn), int(s), int(b)])
                        pend.append(p)
                for rd, lst in self._outbox.items():
                    for (s, mn, b, p) in lst:
                        outbox_idx.append([int(rd), int(s), int(mn), int(b)])
                        outp.append(p)
                dev["pending"] = pend
                dev["outbox"] = outp
        lg = self.log
        meta = {
            "round": len(self.history),
            "config": asdict(fl),
            "batched": self.batched,
            "edge_batched": self.edge_batched,
            "n_sats": self.n_sats,
            "log": {
                "transfer_s": lg.transfer_s, "wait_s": lg.wait_s,
                "security_s": lg.security_s, "bytes_moved": lg.bytes_moved,
                "n_transfers": lg.n_transfers,
                "per_round": list(lg.per_round),
                "round_details": lg.round_details,
            },
            "history": [asdict(h) for h in self.history],
            "fault_reports": [asdict(f) for f in self.fault_reports],
            "aborted_edges": [list(e) for e in self.aborted_edges],
            "qkd_established": [list(e) for e in self._qkd_established],
            "pending_idx": pending_idx,
            "outbox_idx": outbox_idx,
            "last_fidelity": self._last_fidelity,
        }
        return dev, meta

    def _ckpt_template(self, meta):
        fl = self.fl
        like = {"params": self.global_params, "key": self.key,
                "opt": (self._opt_stacked if self.batched
                        else self._stack_opt_states())}
        if fl.mode == "async":
            if self.batched:
                like["ring"] = self._ckpt_ring()
                if fl.agg_security == "secagg":
                    like["ring_y"] = self._ring_y
            else:
                pl = self._async_payload_like()
                like["pending"] = [pl] * len(meta["pending_idx"])
                like["outbox"] = [pl] * len(meta["outbox_idx"])
        return like

    def save_round_checkpoint(self, directory: str, keep: int = 3) -> str:
        """Write the full resume state after ``len(self.history)`` rounds,
        in the JAX trainer's file format; returns the file's path."""
        dev, meta = self._ckpt_state()
        return ckpt_io.CheckpointManager(directory, keep=keep).save(
            meta["round"], convert.trainer_state_to_checkpoint(dev), meta)

    def restore_round_checkpoint(self, directory: str,
                                 step: int | None = None) -> int:
        """Restore the trainer's state from a round checkpoint written by
        this trainer or by the JAX package's; returns the number of
        completed rounds. Running on from round r ends with the params,
        history, fault reports and accounting of the uninterrupted run,
        bit for bit on one device."""
        step, meta = ckpt_io.read_metadata(directory, step)
        if meta.get("config") != asdict(self.fl):
            raise ValueError(
                "checkpoint was written under a different SatQFLConfig; "
                "resume with the identical configuration")
        if (meta.get("batched") != self.batched
                or meta.get("edge_batched") != self.edge_batched
                or meta.get("n_sats") != self.n_sats):
            raise ValueError(
                "checkpoint execution-path fingerprint (batched/"
                "edge_batched/n_sats) does not match this trainer")
        leaves, step, meta = ckpt_io.read_leaves(directory, step)
        dev = convert.trainer_state_from_checkpoint(
            leaves, self._ckpt_template(meta))
        fl = self.fl
        self.global_params = dev["params"]
        self.key = dev["key"]
        if self.batched:
            self._opt_stacked = dev["opt"]
        else:
            self.opt_states = [tree_map(lambda x, i=i: x[i], dev["opt"])
                               for i in range(self.n_sats)]
        if fl.mode == "async":
            if self.batched:
                if fl.agg_security == "secagg":
                    self._ring_y = dev["ring_y"]
                else:
                    self._ring = dev["ring"]
            else:
                self.pending, self._outbox = {}, {}
                for (mn, s, b), p in zip(meta["pending_idx"], dev["pending"]):
                    self.pending.setdefault(int(mn), []).append(
                        (p, int(s), int(b)))
                for (rd, s, mn, b), p in zip(meta["outbox_idx"],
                                             dev["outbox"]):
                    self._outbox.setdefault(int(rd), []).append(
                        (int(s), int(mn), int(b), p))
        lg = meta["log"]
        self.log = CommLog(
            transfer_s=lg["transfer_s"], wait_s=lg["wait_s"],
            security_s=lg["security_s"], bytes_moved=lg["bytes_moved"],
            n_transfers=lg["n_transfers"], per_round=list(lg["per_round"]),
            # msgpack turns tuples into lists: the cum tuple comes back
            round_details=[{**d, "cum": tuple(d["cum"])}
                           for d in lg["round_details"]])
        self.history = [RoundMetrics(**h) for h in meta["history"]]
        self.fault_reports = [FaultReport(**f) for f in meta["fault_reports"]]
        self.aborted_edges = {tuple(e) for e in meta["aborted_edges"]}
        self._qkd_established = {tuple(e) for e in meta["qkd_established"]}
        self._last_fidelity = meta.get("last_fidelity")
        return step

    # ------------------------------------------------------------------
    # one round of Algorithm 1
    # ------------------------------------------------------------------
    def run_round(self, r: int) -> RoundMetrics:
        fl = self.fl
        if r >= self.plan.n_rounds:
            raise IndexError(
                f"round {r} beyond the compiled plan ({self.plan.n_rounds} "
                f"rounds); construct the trainer with fl.n_rounds >= {r + 1}")
        if fl.on_fault == "raise" and self.plan.faults is not None:
            # the round's injected faults surface as typed errors BEFORE
            # the engines degrade (as on_qber_abort='raise')
            self._raise_round_faults(r)
        m = RoundMetrics(round=r)
        round_t0 = self.log.total_s
        sec_t0 = self.log.security_s
        if fl.mode == "qfl":
            m.participants = self._round_qfl(r)
        elif fl.mode in self._GROUP_SCHEDULERS:
            m.participants = (self._round_hierarchical_batched(r)
                              if self.batched
                              else self._round_hierarchical(r))
        else:
            raise ValueError(fl.mode)
        m.comm_s = self.log.total_s - round_t0
        m.security_s = self.log.security_s - sec_t0
        fr = None
        if self.plan.faults is not None:
            fr = self._fault_report_for(r)
            self.fault_reports.append(fr)
        # round details carry a "faults" key only where a plane exists
        self.log.close_round(faults=asdict(fr) if fr is not None else None)
        if self._last_fidelity is not None:
            m.teleport_fidelity = self._last_fidelity

        if r % fl.eval_every == 0:
            m.server_val_loss, m.server_val_acc = evaluate(
                self.api, self.model_cfg, self.global_params,
                self.server_data["val"])
            _, m.server_test_acc = evaluate(
                self.api, self.model_cfg, self.global_params,
                self.server_data["test"])
            # sampled device metrics over the first S client datasets
            S = min(self.n_sats, 8)
            dev_vl, dev_tr = self._dev_eval(
                self.global_params,
                {k: v[:S] for k, v in self._data_stacked.items()},
                self._n_samples[:S])
            m.dev_train_acc = float(dev_tr.mean())
            m.dev_val_loss = float(dev_vl.mean())
            m.dev_test_acc = m.server_test_acc
        self.history.append(m)
        return m

    def run(self, ckpt_dir: str | None = None, ckpt_every: int = 1,
            ckpt_keep: int = 3) -> list[RoundMetrics]:
        """Run the rounds of the plan; with ``ckpt_dir``, checkpoint every
        ``ckpt_every`` rounds and after the last (keeping ``ckpt_keep``),
        and first resume from the latest checkpoint the directory holds
        (kill-and-restart safe)."""
        start = len(self.history)
        if ckpt_dir is not None and ckpt_io.latest_step(ckpt_dir) is not None:
            start = self.restore_round_checkpoint(ckpt_dir)
        for r in range(start, self.fl.n_rounds):
            self.run_round(r)
            if ckpt_dir is not None and (
                    (r + 1) % ckpt_every == 0 or r + 1 == self.fl.n_rounds):
                self.save_round_checkpoint(ckpt_dir, keep=ckpt_keep)
        return self.history
