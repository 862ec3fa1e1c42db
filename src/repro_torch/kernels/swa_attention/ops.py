"""Sliding-window attention in model layout (port of ``repro.kernels.swa_attention.ops``).

``swa_attention(q, k, v, window)`` takes q (B, S, H, hd) and k/v
(B, S, KV, hd) with H a multiple of KV (GQA) and returns o (B, S, H, hd):
causal softmax attention over the band i - window < j <= i (window 0:
full causal), softmax in float32, output in q's dtype.

On a CUDA tensor it launches the hand-written kernel
(``csrc/swa_attention.cu``: tensor cores for bf16, CUDA cores for
float32), which reads kv head ``h // (H // KV)`` in place of repeating k
and v, and counts the launch in ``LAUNCHES``; on a CPU tensor it runs the
plain version (``swa_attention_plain``: repeat, fold heads into batch,
``ref.swa_attention_ref``). A CUDA tensor never falls back to the plain
version: the kernel runs or the call raises.

The backward replays the plain version under autograd, as the JAX
package's ``_swa_bwd`` replays ``swa_attention_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.swa_attention.ref import swa_attention_ref

#: head dims the kernel is built for
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the CUDA kernel in this process (the wrapper adds one per
#: launch; callers reset it to 0 to count the launches of one run), and
#: the same launches by window
LAUNCHES = 0
LAUNCHES_BY_WINDOW: dict[int, int] = {}


def _fold(x: torch.Tensor) -> torch.Tensor:
    B, S, H, hd = x.shape
    return x.permute(0, 2, 1, 3).reshape(B * H, S, hd)


def _unfold(o: torch.Tensor, B: int, H: int) -> torch.Tensor:
    BH, S, hd = o.shape
    return o.reshape(B, H, S, hd).permute(0, 2, 1, 3)


def repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, H, hd): kv head j serves heads
    j * rep .. j * rep + rep - 1 (``jnp.broadcast_to`` order)."""
    B, S, KV, hd = k.shape
    rep = n_heads // KV
    if rep == 1:
        return k
    return k[:, :, :, None, :].expand(B, S, KV, rep, hd).reshape(
        B, S, KV * rep, hd)


def swa_attention_plain(q, k, v, window: int = 0) -> torch.Tensor:
    """The plain PyTorch version in model layout."""
    B, S, H, hd = q.shape
    o = swa_attention_ref(_fold(q), _fold(repeat_kv(k, H)),
                          _fold(repeat_kv(v, H)), window)
    return _unfold(o, B, H)


def _launch(q, k, v, window: int) -> torch.Tensor:
    global LAUNCHES
    from repro_torch.kernels.swa_attention.build import library

    B, S, H, hd = q.shape
    KV = k.shape[2]
    # the bf16 kernel stages rows in 16-byte copies: a contiguous view at an
    # odd offset is copied to a fresh (aligned) allocation first
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    o = torch.empty_like(q)
    err = library().swa_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, H, KV,
        hd, window, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"swa_attention launch failed: CUDA error {err} at B={B}, S={S}, "
            f"H={H}, KV={KV}, hd={hd}, window={window}, {q.dtype}")
    LAUNCHES += 1
    LAUNCHES_BY_WINDOW[window] = LAUNCHES_BY_WINDOW.get(window, 0) + 1
    return o


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, S, H, hd) and k, v one "
                         f"(B, S, KV, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if k.shape[:2] != (B, S) or k.shape[3] != hd or KV < 1 or H % KV:
        raise ValueError(f"k/v {tuple(k.shape)} do not serve q "
                         f"{tuple(q.shape)} (H must be a multiple of KV)")
    for t in (k, v):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k and v must share one dtype and device")
    if q.is_cuda:
        if q.dtype not in _DTYPES or hd not in HEAD_DIMS:
            raise ValueError(
                f"the swa_attention kernel takes float32 or bfloat16 with "
                f"head dim in {HEAD_DIMS}, got {q.dtype} at "
                f"{tuple(q.shape)}")
    elif q.device.type not in ("cpu", "meta"):
        # meta: the dry-run's shape-only trace of the plain version
        raise ValueError(f"no swa_attention for device {q.device}")


class _SWAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, window):
        ctx.window = window
        ctx.save_for_backward(q, k, v)
        if q.is_cuda:
            return _launch(q.contiguous(), k.contiguous(), v.contiguous(),
                           window)
        return swa_attention_plain(q, k, v, window)

    @staticmethod
    def backward(ctx, g):
        inputs = [x.detach().requires_grad_(need) for x, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [x for x in inputs if x.requires_grad]
        with torch.enable_grad():
            out = swa_attention_plain(*inputs, ctx.window)
            grads = iter(torch.autograd.grad(out, wanted, g))
        return tuple(next(grads) if x.requires_grad else None
                     for x in inputs) + (None,)


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: int = 0) -> torch.Tensor:
    """q (B, S, H, hd); k/v (B, S, KV, hd) -> o (B, S, H, hd)."""
    _check(q, k, v)
    return _SWAttention.apply(q, k, v, max(int(window), 0))
