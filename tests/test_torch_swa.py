"""Port sliding-window attention vs the JAX package, on the CPU.

The port's wrapper runs its plain version on CPU tensors; it is held
against the JAX oracle ``swa_attention_ref`` (f32 ≤ 2e-5, bf16 ≤ 3e-2,
the bounds of ``tests/test_kernels.py``, and in bf16 also within one bf16
step of each element: both round float32 results), against the JAX Pallas kernel in
interpret mode at one tiny shape, and its replay backward against
``jax.grad`` of the oracle (≤ 1e-5). The CUDA kernel itself is held
against the plain version on the card (``test_torch_kernels_cuda.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels.swa_attention.ops import _fold, _repeat_kv, _unfold
from repro.kernels.swa_attention.ops import swa_attention as jax_swa
from repro.kernels.swa_attention.ref import swa_attention_ref as jax_ref
from repro_torch.kernels.swa_attention import ops
from torch_bf16_limit import bf16_steps

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _inputs(B, S, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    q = (0.5 * rng.standard_normal((B, S, H, hd))).astype(np.float32)
    k = (0.5 * rng.standard_normal((B, S, KV, hd))).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    return q, k, v


def _jax_oracle(q, k, v, window):
    H = q.shape[2]
    o = jax_ref(_fold(q), _fold(_repeat_kv(k, H)), _fold(_repeat_kv(v, H)),
                window=window)
    return _unfold(o, q.shape[0], H)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 16, 100])
@pytest.mark.parametrize("S", [64, 96])
def test_plain_matches_jax_oracle(S, window, dtype):
    q, k, v = _inputs(2, S, 4, 2, 32, seed=S + window)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = _jax_oracle(*(jnp.asarray(a).astype(jd) for a in (q, k, v)),
                       window)
    got = ops.swa_attention(*(torch.tensor(a).to(td) for a in (q, k, v)),
                            window)
    assert got.dtype == td and got.shape == q.shape
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= TOL[dtype]
    if dtype == "bfloat16":
        # one bf16 step of each element of want, plus 2^-16
        step = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                       - 7) + 2.0 ** -16
        assert (np.abs(got.float().numpy() - want) / step).max() <= 1.0


def test_plain_matches_jax_kernel_in_interpret_mode():
    q, k, v = _inputs(1, 64, 2, 1, 32, seed=3)
    want = jax_swa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=16,
                   interpret=True)
    got = ops.swa_attention(torch.tensor(q), torch.tensor(k),
                            torch.tensor(v), 16)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 2e-5


def test_window_limits_context():
    """A key beyond every later window leaves those rows unchanged."""
    q, k, v = (torch.tensor(a) for a in _inputs(1, 96, 2, 2, 32, seed=5))
    W = 16
    o1 = ops.swa_attention(q, k, v, W)
    k2, v2 = k.clone(), v.clone()
    k2[:, 0] += 100.0
    v2[:, 0] -= 50.0
    o2 = ops.swa_attention(q, k2, v2, W)
    assert (o1[:, W:] - o2[:, W:]).abs().max().item() < 1e-6
    assert (o1[:, :W] - o2[:, :W]).abs().max().item() > 1e-3


def test_replay_backward_matches_jax_grad():
    q, k, v = _inputs(1, 64, 4, 2, 32, seed=7)
    w = np.random.default_rng(8).standard_normal(q.shape).astype(np.float32)
    W = 16

    def jloss(q_, k_, v_):
        return jnp.sum(_jax_oracle(q_, k_, v_, W) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                                 for a in (q, k, v)))
    args = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    (ops.swa_attention(*args, W) * torch.tensor(w)).sum().backward()
    for a, b in zip(args, want):
        assert np.abs(a.grad.numpy() - np.asarray(b)).max() <= 1e-5


def test_rejects_mismatched_inputs():
    q, k, v = (torch.tensor(a) for a in _inputs(1, 8, 3, 2, 32, seed=1))
    with pytest.raises(ValueError, match="multiple of KV"):
        ops.swa_attention(q, k, v)
    q, k, v = (torch.tensor(a) for a in _inputs(1, 8, 4, 2, 32, seed=1))
    with pytest.raises(ValueError, match="one dtype"):
        ops.swa_attention(q, k.double(), v)


def test_two_term_bf16_split_of_p_keeps_the_bf16_limit():
    """The bf16 kernel's P.V recipe in plain torch: float32 scores of exact
    bf16 q, k; float32 softmax numerators p split into p_hi = bf16(p) and
    p_lo = bf16(p - p_hi), each multiplied by the exact bf16 v with float32
    sums (what the tensor cores do), divided by the row sum at the end.
    That stays within one bf16 step of the plain version; one bf16 term
    (SDPA's recipe) does not, so the limit tells the two apart."""
    B, S, H, KV, hd, W = 1, 256, 4, 2, 64, 64
    q, k, v = (torch.tensor(a).bfloat16()
               for a in _inputs(B, S, H, KV, hd, seed=21))
    want = ops.swa_attention_plain(q, k, v, W)
    qf = ops._fold(q).float()
    kf, vf = (ops._fold(ops.repeat_kv(t, H)).float() for t in (k, v))
    s = torch.einsum("bqd,bkd->bqk", qf, kf) / hd ** 0.5
    pos = torch.arange(S)
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - W)
    s = s.masked_fill(~band, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    p_hi = p.bfloat16().float()
    p_lo = (p - p_hi).bfloat16().float()
    two = (p_hi @ vf + p_lo @ vf) / l
    one = (p_hi @ vf) / l
    unfold = lambda o: ops._unfold(o, B, H).bfloat16()
    assert bf16_steps(unfold(two), want) <= 1.0
    assert bf16_steps(unfold(one), want) > 1.0
