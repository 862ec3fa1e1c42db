"""Per-edge, per-round key schedule driven by simulated BB84 (port of
``repro.security.keys``).

Every communicating pair (edge) of the sat-QFL hierarchy — secondary↔main
ISLs and main↔ground feeder links — establishes a key by BB84 once per
key epoch; per-round pads and MAC keys fold the round index into the
edge seed, so a pad is never reused. An edge whose QBER exceeds the abort
threshold (an eavesdropper, paper §III-B) is marked compromised.

``establish_edges`` runs ONE batched BB84 over every edge not yet
established, bit-identical to per-edge ``establish`` calls (the oracle).
The per-round mixes are numpy helpers shared by ``EdgeKey`` and the plan
compiler, so the scalar and stacked schedules cannot drift.

Each edge's BB84 key is ``fold_in(master, hash(edge) & 0x7FFFFFFF)``, as in
the JAX package. An edge with a ``"gs"`` endpoint hashes a ``str``, which
Python salts per process: keys agree with the JAX package's only within
one process (or under one ``PYTHONHASHSEED``).

For secagg, ``share_edges`` deals the pairwise mask shares of a cohort
(rooted in the pairs' BB84 keys) and ``recover_masks`` rebuilds the signed
pad streams of absent partners, exactly (mod 2^32).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import prng
from repro_torch.quantum.qkd import (bb84_keygen, bb84_keygen_edges,
                                     derive_pad_seed, derive_pad_seeds)
from repro_torch.security.otp import sum_signed_pads

QBER_ABORT = 0.11   # standard BB84 abort threshold

# domain-separation constant for secagg pairwise mask streams: a pair of
# satellites may also share a data edge (the same BB84 key), and its OTP
# pads must never collide with the additive mask pads
MASK_DOMAIN = np.uint32(0x6D61736B)   # "mask"


def round_seed_mix(seeds, round_idx):
    """Per-(round, edge) pad seed: integer mix of edge seed + round index,
    over any numpy shapes (uint64 intermediates keep the low 32 bits)."""
    s = np.asarray(seeds, np.uint64)
    r = np.asarray(round_idx, np.uint64)
    return ((s * np.uint64(2654435761))
            ^ (r * np.uint64(0x9E3779B9))).astype(np.uint32)


def mac_key_mix(round_seeds):
    """(r, s) MAC key pair from per-round seeds; vectorized like the mix."""
    base = np.asarray(round_seeds, np.uint64)
    r = (base ^ np.uint64(0xA5A5A5A5)).astype(np.uint32)
    s = ((base * np.uint64(747796405))
         + np.uint64(2891336453)).astype(np.uint32)
    return r, s


def pairwise_mask_seed(edge_seed, born):
    """Per-(pair, born-round) secagg mask seed, domain-separated from the
    pair's OTP pads by xoring :data:`MASK_DOMAIN` into the base seed."""
    return round_seed_mix(
        np.asarray(edge_seed, np.uint64).astype(np.uint32) ^ MASK_DOMAIN,
        born)


def canonical_edge(edge: tuple) -> tuple:
    """Edges are undirected; endpoints may be ints (sats) or strings."""
    return tuple(sorted(edge, key=str))


@dataclass
class EdgeKey:
    edge: tuple
    seed: int                 # 32-bit QKD-derived seed
    qber: float
    compromised: bool

    def round_seed(self, round_idx: int) -> np.uint32:
        return np.uint32(round_seed_mix(self.seed, round_idx))

    def mac_keys(self, round_idx: int) -> tuple:
        r, s = mac_key_mix(self.round_seed(round_idx))
        return int(r), int(s)


class KeyManager:
    """Host-side registry of QKD-established edge keys; BB84 runs on the
    master key's device."""

    def __init__(self, master_key: torch.Tensor, n_qkd_bits: int = 512,
                 eavesdrop_edges: frozenset = frozenset()):
        self.master_key = master_key
        self.n_qkd_bits = n_qkd_bits
        self.eavesdrop_edges = eavesdrop_edges
        self._edges: dict[tuple, EdgeKey] = {}

    def _edge_key(self, edge: tuple) -> torch.Tensor:
        return prng.fold_in(self.master_key, hash(edge) & 0x7FFFFFFF)

    def establish(self, edge: tuple) -> EdgeKey:
        """Run BB84 for one edge; idempotent per epoch. The per-edge oracle
        of ``establish_edges`` — same fold-in, same circuit."""
        edge = canonical_edge(edge)
        if edge in self._edges:
            return self._edges[edge]
        res = bb84_keygen(self._edge_key(edge), self.n_qkd_bits,
                          eavesdrop=edge in self.eavesdrop_edges)
        qber = float(res.qber)
        ek = EdgeKey(edge=edge,
                     seed=int(derive_pad_seed(res.sifted_key, res.key_len)),
                     qber=qber, compromised=qber > QBER_ABORT)
        self._edges[edge] = ek
        return ek

    def establish_edges(self, edges) -> list[EdgeKey]:
        """Establish many edges in ONE batched BB84; already-established
        edges come from the registry. Bit-identical to ``establish``."""
        canon = [canonical_edge(e) for e in edges]
        new = [e for e in dict.fromkeys(canon) if e not in self._edges]
        if new:
            hashes = torch.tensor([hash(e) & 0x7FFFFFFF for e in new],
                                  dtype=torch.int64,
                                  device=self.master_key.device)
            keys = prng.fold_in(self.master_key, hashes)
            eav = [e in self.eavesdrop_edges for e in new]
            res = bb84_keygen_edges(keys, self.n_qkd_bits, eav)
            seeds = derive_pad_seeds(res.sifted_key, res.key_len).tolist()
            qbers = res.qber.tolist()
            for e, seed, q in zip(new, seeds, qbers):
                self._edges[e] = EdgeKey(edge=e, seed=int(seed), qber=q,
                                         compromised=q > QBER_ABORT)
        return [self._edges[e] for e in canon]

    def get(self, edge: tuple) -> EdgeKey:
        return self.establish(edge)

    # ------------------------------------------------------------------
    # secagg pairwise mask shares (dropout-tolerant aggregation)
    # ------------------------------------------------------------------
    def share_edges(self, pairs) -> dict:
        """Deal pairwise secagg mask shares for a cohort's satellite pairs:
        {canonical pair: base edge seed}, every pair's share rooted in its
        BB84 key, all established in one batched BB84. Per-(pair, born)
        mask seeds come from :func:`pairwise_mask_seed`."""
        return {ek.edge: int(ek.seed)
                for ek in self.establish_edges(list(pairs))}

    def recover_masks(self, pairs, borns, signs,
                      n_words: int) -> torch.Tensor:
        """Σ sign · mask-pad over absent cohort partners: the streams their
        surviving partners folded into their contributions, re-derived from
        the registry. Returns (n_words,) int32 storage (mod 2^32, exact) on
        the master key's device."""
        dev = self.master_key.device
        if not pairs:
            return torch.zeros((n_words,), dtype=torch.int32, device=dev)
        eks = self.establish_edges(list(pairs))
        seeds = np.asarray([pairwise_mask_seed(ek.seed, b)
                            for ek, b in zip(eks, borns)], np.uint32)
        return sum_signed_pads(seeds, np.asarray(signs, np.int32), n_words,
                               device=dev)

    def compromised_nodes(self) -> set:
        out = set()
        for ek in self._edges.values():
            if ek.compromised:
                out.update(ek.edge)
        return out

    def rekey(self, edge: tuple) -> EdgeKey:
        self._edges.pop(canonical_edge(edge), None)
        return self.establish(edge)
