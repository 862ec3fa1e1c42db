"""Common functional layers of the LLM blocks, the LM loss and a parameter
count (port of ``repro.nn.common``).

Numerics policy, as in the JAX package: normalization statistics are
computed in float32 whatever the activation dtype (bf16 on the card), and
outputs are cast back to the input dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.pytree import tree_leaves

_F32 = torch.float32


def rms_norm(x: torch.Tensor, scale: torch.Tensor | None = None,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm (llama family). ``scale=None`` gives the non-parametric form."""
    xf = x.to(_F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.to(_F32)
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor | None = None,
               bias: torch.Tensor | None = None,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm. OLMo's non-parametric LN is ``scale=None, bias=None``."""
    xf = x.to(_F32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.to(_F32)
    if bias is not None:
        y = y + bias.to(_F32)
    return y.to(x.dtype)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin of shape positions.shape + (head_dim // 2,), float32,
    computed on the fly for the given integer positions."""
    half = head_dim // 2
    # log(theta) rounded to float32, as jnp.log takes it; computed on the
    # host so no device tensor is made from a Python scalar (a blocking copy)
    log_theta = torch.log(torch.tensor(theta, dtype=_F32)).item()
    freq = torch.exp(-log_theta * (torch.arange(half, dtype=_F32,
                                                device=positions.device)
                                   / half))
    ang = positions.to(_F32)[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding, split-halves convention (llama / HF).

    x (..., n_heads, head_dim); cos/sin broadcastable to (..., head_dim//2)
    — e.g. (B, S, hd//2) against x (B, S, H, hd): the head axis is inserted.
    """
    half = x.shape[-1] // 2
    c = cos[..., None, :].to(_F32)
    s = sin[..., None, :].to(_F32)
    x1f, x2f = x[..., :half].to(_F32), x[..., half:].to(_F32)
    out = torch.cat([x1f * c - x2f * s, x2f * c + x1f * s], dim=-1)
    return out.to(x.dtype)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP (llama family): down(silu(x @ gate) * (x @ up)), with the
    activation in the native dtype as the JAX package keeps it."""
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor | None,
             w_out: torch.Tensor, b_out: torch.Tensor | None) -> torch.Tensor:
    """GELU MLP (whisper / classic transformer), with ``jax.nn.gelu``'s
    default tanh approximation."""
    h = x @ w_in
    if b_in is not None:
        h = h + b_in
    y = F.gelu(h, approximate="tanh") @ w_out
    if b_out is not None:
        y = y + b_out
    return y


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy in float32; labels are int ids, ``mask``
    0/1 weights. The label's logit is a masked sum over the vocab (iota ==
    label), as the JAX package takes it."""
    lf = logits.to(_F32)
    m = torch.amax(lf, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
    onehot = torch.arange(lf.shape[-1], device=lf.device) == labels[..., None]
    ll = torch.sum(torch.where(onehot, lf, 0.0), dim=-1)
    nll = lse - ll
    if mask is not None:
        w = mask.to(_F32)
        return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)
    return torch.mean(nll)


def count_params(params) -> int:
    return sum(x.numel() for x in tree_leaves(params))
