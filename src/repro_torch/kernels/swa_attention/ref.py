"""Plain PyTorch sliding-window attention (port of ``repro.kernels.swa_attention.ref``).

Materialised scores, float32 softmax: the oracle of the CUDA kernel and
the wrapper's path for CPU tensors.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def swa_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      window: int = 0) -> torch.Tensor:
    """q/k/v (BH, S, hd) -> o (BH, S, hd), key j visible to query i iff
    i - window < j <= i (window 0: every j <= i). fp32 softmax."""
    BH, S, hd = q.shape
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(hd)
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[None, :] > pos[:, None] - window
    s = s.masked_fill(~mask[None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
