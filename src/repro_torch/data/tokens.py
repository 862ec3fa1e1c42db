"""Synthetic token corpus for the LLM workloads (port of ``repro.data.tokens``).

A Zipf-sampled, locally correlated stream (order-1 mixing): enough
structure that cross-entropy falls during smoke training, with any vocab
size. Both functions draw from numpy's seeded generator exactly as the
JAX package does, so the corpus and every batch are bit-equal to its own;
the tensors land on ``device`` (the GPU unless the caller asks for the
CPU).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def synthetic_corpus(n_tokens: int, vocab_size: int, seed: int = 0,
                     zipf_a: float = 1.3, mix: float = 0.7,
                     device=None) -> torch.Tensor:
    """(n_tokens,) int32 token ids in [0, vocab_size)."""
    rng = np.random.default_rng(seed)
    base = rng.zipf(zipf_a, n_tokens).astype(np.int64)
    base = (base - 1) % vocab_size
    # order-1 correlation: with prob `mix`, repeat a deterministic successor
    succ = rng.permutation(vocab_size)
    out = base.copy()
    keep = rng.random(n_tokens) < mix
    out[1:][keep[1:]] = succ[out[:-1][keep[1:]]]
    return torch.from_numpy(out.astype(np.int32)).to(resolve_device(device))


def lm_batches(corpus: torch.Tensor, batch: int, seq_len: int,
               n_batches: int, seed: int = 0):
    """Yield {"tokens", "labels"} (batch, seq_len) next-token batches
    sampled from the corpus, on the corpus's device."""
    rng = np.random.default_rng(seed)
    n = corpus.shape[0] - seq_len - 1
    for _ in range(n_batches):
        starts = rng.integers(0, n, batch)
        idx = starts[:, None] + np.arange(seq_len + 1)[None]
        window = corpus[torch.from_numpy(idx).to(corpus.device)]
        yield {"tokens": window[:, :-1], "labels": window[:, 1:]}
