"""Host-orchestrated sat-QFL rounds — paper Algorithm 1 (port of
``repro.core.round``, modes ``qfl`` and ``sim`` under ``security="none"``).

Roles, groups, weights and the exchange stages come from the compiled
:class:`~repro_torch.core.plan.RoundPlan`; every transfer is accounted by
the communication-time model; local training is the VQC on each
satellite's private data.

**Constellation-batched executor (default).** Every participating client
of a stage is one row of a stacked client axis, padded to one fixed frame
of pow2(n_sats) rows: local training for the whole stage is one pass of
``core.localtrain`` over that axis (the VQC's gate layers run as the CUDA
kernel over all rows at once), and aggregation is one weighted reduction
over the rows. Pad rows train throwaway copies; their optimizer slots
scatter into a scratch row (index n_sats) that nothing reads.

``batched=False`` keeps the per-client loop as the numerics oracle. Both
executors draw each (round, satellite) key from the same fold-in schedule
as the JAX package and sample through the same bounded sampler, so they
see identical batches; accounting is exactly equal between them.

Not ported yet, and refused with ``NotImplementedError`` rather than run
weaker: modes seq/async and secagg (ROADMAP queue 1, item 7), transport
security (item 6), fault injection and checkpoints (item 8), and the
parameter-shift gradient (item 9).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import prng
from repro_torch.constellation.topology import ConstellationTrace
from repro_torch.core.comm import CommLog, CommModel
from repro_torch.core.flconfig import SatQFLConfig
from repro_torch.core.localtrain import (
    make_batched_local_train, make_local_train, sample_local_batches,
)
from repro_torch.core.plan import RoundPlan, check_supported, compile_round_plan
from repro_torch.device import resolve_device
from repro_torch.nn.optim import (
    constant_schedule, get_optimizer, inv_sqrt_schedule,
)
from repro_torch.nn.pytree import tree_bytes, tree_map, tree_weighted_sum


def evaluate(api, model_cfg, params, batch) -> tuple[float, float]:
    """(loss, accuracy) of one model on one batch."""
    logits, _ = api.forward(model_cfg, params, batch)
    labels = batch["labels"]
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    ll = lf.gather(-1, labels[..., None])[..., 0]
    loss = torch.mean(lse - ll)
    acc = torch.mean((torch.argmax(lf, -1) == labels).to(torch.float32))
    return float(loss), float(acc)


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length() if n > 1 else 1


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


class SatQFLTrainer:
    """Hierarchical QFL over a constellation trace (paper Algorithm 1)."""

    def __init__(self, model_cfg, api, fl: SatQFLConfig,
                 trace: ConstellationTrace, sat_data: list,
                 server_data: dict, comm: CommModel | None = None,
                 batched: bool = True, device=None):
        self.device = dev = resolve_device(device)
        check_supported(fl)
        self.model_cfg = model_cfg
        self.api = api
        self.fl = fl
        self.comm = comm or CommModel()
        self.batched = batched
        self.n_sats = trace.n_sats
        if len(sat_data) != self.n_sats:
            raise ValueError(f"{len(sat_data)} client datasets for "
                             f"{self.n_sats} satellites")
        # every batched dispatch is padded to ONE fixed frame of rows
        self._frame = _next_pow2(self.n_sats)

        # the JAX package's key schedule: init from split(PRNGKey(seed)),
        # local training from fold_in(PRNGKey(seed), 0x5A7) per (round, sat)
        init_key = prng.split(prng.PRNGKey(fl.seed, dev))[1]
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
        self.server_data = tree_map(lambda x: x.to(dev), server_data)
        self.log = CommLog()
        self.history: list[RoundMetrics] = []

        self._local_train = make_local_train(api, model_cfg, fl, self.opt)
        self._batched_train = make_batched_local_train(api, model_cfg, fl,
                                                       self.opt)
        self.plan: RoundPlan = compile_round_plan(trace, fl,
                                                  sample_counts=counts)

    # ------------------------------------------------------------------
    # local training
    # ------------------------------------------------------------------
    def _sat_key(self, r: int, sat: int):
        return prng.fold_in(prng.fold_in(self._train_key, r), sat)

    def _train_sat(self, sat: int, params, r: int):
        """Per-client oracle: the shared program on one client row."""
        fl = self.fl
        one = lambda x: x[None]
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
                             r: int):
        """Train ``sat_ids`` as one stage over the stacked client axis.

        params_stacked: leaves (K or Kp, ...) — row j holds sat_ids[j]'s
        input model. Returns (params (Kp, ...), losses (Kp,)), padded to
        the frame's Kp rows; pad rows repeat row 0 and leave every real
        optimizer slot untouched.
        """
        k = len(sat_ids)
        kp = self._frame
        dev = self.device
        ids = torch.tensor(list(sat_ids) + [sat_ids[0]] * (kp - k),
                           device=dev)
        scatter = torch.tensor(list(sat_ids) + [self.n_sats] * (kp - k),
                               device=dev)
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
        # pad rows scatter into the scratch row; real ids are distinct
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
    # exchange accounting (security="none": the tensors never move)
    # ------------------------------------------------------------------
    def _exchange(self, params, edge: tuple, r: int, link: str,
                  concurrent: int = 1):
        """Per-edge exchange of the oracle: (params_as_received, wall_s)."""
        nbytes = tree_bytes(params)
        t = (self.comm.isl_transfer(nbytes, concurrent) if link == "isl"
             else self.comm.feeder_transfer(nbytes, concurrent))
        self.log.count_transfer(nbytes)   # wall time recorded per round
        return params, t

    def _exchange_rows(self, k: int, link: str, concurrents=None) -> list:
        """Accounting of one stage of ``k`` row exchanges; returns the
        per-edge walls in the oracle's order."""
        walls = []
        for c in concurrents or [1] * k:
            walls.append(self.comm.isl_transfer(self._row_nbytes, c)
                         if link == "isl"
                         else self.comm.feeder_transfer(self._row_nbytes, c))
            self.log.count_transfer(self._row_nbytes)
        return walls

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
    # sim group merge: per-client oracle and batched executor
    # ------------------------------------------------------------------
    def _merge_sim(self, r: int, main: int, secs: list):
        # parallel uploads CONTEND for the main's ISL aperture
        # (bandwidth / n_concurrent): wall = max over secs
        collected, ws, up_walls = [], [], [0.0]
        for s in secs:
            p, _ = self._train_sat(s, self.global_params, r)
            p, t = self._exchange(p, (s, main), r, "isl",
                                  concurrent=max(len(secs), 1))
            up_walls.append(t)
            collected.append(p)
            ws.append(self._weight_of(s))
        merged = (self._aggregate(collected, ws) if collected
                  else self.global_params)
        return merged, max(up_walls), 0.0, len(collected)

    def _merge_sim_batched(self, r: int, mains: list, groups: dict, mp: int):
        secs_all = [s for m in mains for s in groups[m]]
        group_walls = [0.0] * len(mains)
        if not secs_all:
            return self._broadcast_global(mp), group_walls, [0.0], 0
        sp = self._frame
        p, _ = self._train_group_batched(secs_all,
                                         self._broadcast_global(sp), r)
        walls = self._exchange_rows(
            len(secs_all), "isl",
            [max(len(groups[m]), 1) for m in mains for _ in groups[m]])
        # masked weighted group reduction over the stacked client axis
        a = np.zeros((mp, sp), np.float32)
        j = 0
        for g, m in enumerate(mains):
            for s in groups[m]:
                a[g, j] = self._weight_of(s)
                group_walls[g] = max(group_walls[g], walls[j])
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
        return merged, group_walls, [0.0], len(secs_all)

    # ------------------------------------------------------------------
    # round schedulers
    # ------------------------------------------------------------------
    def _round_qfl(self, r: int) -> int:
        """Flat FedAvg baseline: every satellite talks to the server over
        its own feeder beam — transfers are PARALLEL (wall = max)."""
        ids = list(range(self.n_sats))
        if self.batched:
            p, _ = self._train_group_batched(
                ids, self._broadcast_global(self._frame), r)
            walls = self._exchange_rows(len(ids), "feeder")
            self.log.add_wall(2 * max([0.0] + walls))
            w = np.zeros((self._frame,), np.float32)
            w[:self.n_sats] = self.plan.weights
            self.global_params = self._wmean_rows(p, w)
            return len(ids)
        updates, ws, walls = [], [], [0.0]
        for s in ids:
            p, _ = self._train_sat(s, self.global_params, r)
            p, t = self._exchange(p, ("gs", s), r, "feeder")
            walls.append(t)
            updates.append(p)
            ws.append(self._weight_of(s))
        self.log.add_wall(2 * max(walls))   # up + broadcast down
        self.global_params = self._aggregate(updates, ws)
        return len(updates)

    def _round_hierarchical(self, r: int) -> int:
        """Algorithm 1 proper (per-client oracle): per-group sim merge,
        main-satellite training, feeder uplink, global FedAvg through the
        same frame-padded weighted reduction as the batched executor."""
        mp = self._frame
        main_ws = np.zeros((mp,), np.float32)
        main_models = [None] * mp
        group_walls, feeder_walls, group_waits = [0.0], [0.0], [0.0]
        participants = 0
        for g, (main, secs) in enumerate(self.plan.groups(r).items()):
            merged, wall, wait, delivered = self._merge_sim(r, main, secs)
            group_walls.append(wall)
            group_waits.append(wait)
            participants += delivered
            if self.fl.main_trains:
                merged, _ = self._train_sat(main, merged, r)
                participants += 1
            merged, t = self._exchange(merged, (main, "gs"), r, "feeder")
            feeder_walls.append(t)
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
        # then the slowest feeder uplink, plus the broadcast back down
        self.log.add_wait(max(group_waits))
        self.log.add_wall(max(group_walls) + 2 * max(feeder_walls))
        return participants

    def _round_hierarchical_batched(self, r: int) -> int:
        """The same Algorithm-1 round with local training dispatched once
        per stage over the stacked client axis: secondaries, then mains,
        then one weighted reduction for the global model."""
        groups = self.plan.groups(r)
        mains = list(groups)
        if not mains:
            self.log.add_wait(0.0)
            self.log.add_wall(0.0)
            return 0
        mp = self._frame
        merged, group_walls, group_waits, participants = \
            self._merge_sim_batched(r, mains, groups, mp)
        if self.fl.main_trains:
            merged, _ = self._train_group_batched(mains, merged, r)
            participants += len(mains)
        feeder_walls = self._exchange_rows(len(mains), "feeder")
        # pad rows carry zero weight, so the padded reduction is exact
        main_ws = np.zeros((mp,), np.float32)
        main_ws[:len(mains)] = [
            self._weight_of(m) + sum(self._weight_of(s) for s in groups[m])
            for m in mains]
        self.global_params = self._wmean_rows(merged, main_ws)
        self.log.add_wait(max([0.0] + group_waits))
        self.log.add_wall(max([0.0] + group_walls)
                          + 2 * max([0.0] + feeder_walls))
        return participants

    # ------------------------------------------------------------------
    # one round of Algorithm 1
    # ------------------------------------------------------------------
    def run_round(self, r: int) -> RoundMetrics:
        fl = self.fl
        if r >= self.plan.n_rounds:
            raise IndexError(
                f"round {r} beyond the compiled plan ({self.plan.n_rounds} "
                f"rounds); construct the trainer with fl.n_rounds >= {r + 1}")
        m = RoundMetrics(round=r)
        round_t0 = self.log.total_s
        sec_t0 = self.log.security_s
        if fl.mode == "qfl":
            m.participants = self._round_qfl(r)
        elif self.batched:
            m.participants = self._round_hierarchical_batched(r)
        else:
            m.participants = self._round_hierarchical(r)
        m.comm_s = self.log.total_s - round_t0
        m.security_s = self.log.security_s - sec_t0
        self.log.close_round()

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

    def run(self, ckpt_dir: str | None = None) -> list[RoundMetrics]:
        """Run all rounds of the plan."""
        if ckpt_dir is not None:
            raise NotImplementedError(
                "round checkpoints are not ported yet (ROADMAP queue 1, "
                "item 8: fault plane + checkpoints)")
        for r in range(len(self.history), self.fl.n_rounds):
            self.run_round(r)
        return self.history
