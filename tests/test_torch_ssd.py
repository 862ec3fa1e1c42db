"""Port SSD chunked scan vs the JAX package, on the CPU.

The port's ``ssd_scan`` (its plain version on CPU tensors) and its
``blocks.ssd_ref`` are held against the JAX ``ssd_ref`` and, at one tiny
shape, the JAX Pallas ``ssd_scan`` in interpret mode: y and the final
state ≤ 3e-5 (the bound of ``tests/test_kernels.py``). Cases cover the
chunk-divisor fallback, more than one B/C group and a given initial
state. The CUDA kernel is held against the plain version on the card
(``test_torch_kernels_cuda.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.models.blocks import ssd_ref as jax_ssd_ref
from repro_torch.kernels.ssd_scan import chunk_len, ssd_scan, ssd_scan_ref
from repro_torch.models.blocks import ssd_ref
from torch_bf16_limit import bf16_steps

TOL = 3e-5


def _inputs(B, S, H, G, P, N, seed):
    """The distributions of the JAX package's own kernel tests."""
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((B, S, H, P))).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(0.3 * rng.standard_normal(H))).astype(np.float32)
    Bv = (0.3 * rng.standard_normal((B, S, G, N))).astype(np.float32)
    Cv = (0.3 * rng.standard_normal((B, S, G, N))).astype(np.float32)
    return x, dt, A, Bv, Cv


def _close(got, want):
    return np.abs(got.detach().numpy() - np.asarray(want)).max() <= TOL


@pytest.mark.parametrize("S,G,H,chunk", [
    (64, 1, 4, 32),       # whole chunks
    (96, 1, 2, 64),       # 64 does not divide 96: falls back to 48
    (50, 2, 4, 16),       # G > 1, chunk falls back to 10
    (40, 1, 2, 128),      # chunk longer than the sequence
])
def test_scan_and_ref_match_jax(S, G, H, chunk):
    args = _inputs(2, S, H, G, 16, 16, seed=S + G)
    want_y, want_st = jax_ssd_ref(*(jnp.asarray(a) for a in args),
                                  chunk=chunk)
    targs = [torch.tensor(a) for a in args]
    for fn in (ssd_scan, ssd_ref):
        y, st = fn(*targs, chunk=chunk)
        assert y.shape == args[0].shape and st.dtype == torch.float32
        assert _close(y, want_y) and _close(st, want_st)


def test_init_state_goes_through_the_reference():
    """On the CPU the wrapper's plain version takes the given state (on the
    card the kernel loads it)."""
    args = _inputs(1, 48, 4, 2, 8, 16, seed=11)
    init = (0.1 * np.random.default_rng(12).standard_normal(
        (1, 4, 8, 16))).astype(np.float32)
    want_y, want_st = jax_ssd_ref(*(jnp.asarray(a) for a in args), chunk=16,
                                  init_state=jnp.asarray(init))
    y, st = ssd_scan(*(torch.tensor(a) for a in args), chunk=16,
                     init_state=torch.tensor(init))
    assert _close(y, want_y) and _close(st, want_st)


def test_plain_matches_jax_kernel_in_interpret_mode():
    args = _inputs(1, 32, 2, 1, 8, 16, seed=13)
    want_y, want_st = jax_ssd_scan(*(jnp.asarray(a) for a in args), chunk=16,
                                   interpret=True)
    y, st = ssd_scan(*(torch.tensor(a) for a in args), chunk=16)
    assert _close(y, want_y) and _close(st, want_st)


def test_head_major_reference_matches_model_layout():
    x, dt, A, Bv, Cv = (torch.tensor(a) for a in _inputs(2, 32, 4, 2, 8, 16,
                                                         seed=17))
    y, st = ssd_scan_ref(x.movedim(2, 1), dt.movedim(2, 1), A,
                         Bv.movedim(2, 1), Cv.movedim(2, 1), chunk=16)
    y2, st2 = ssd_ref(x, dt, A, Bv, Cv, chunk=16)
    assert torch.equal(y.movedim(1, 2), y2) and torch.equal(st, st2)


def test_replay_backward_matches_jax_grad():
    args = _inputs(1, 32, 2, 1, 8, 16, seed=19)
    w = np.random.default_rng(20).standard_normal(args[0].shape).astype(
        np.float32)

    def jloss(*a):
        y, st = jax_ssd_ref(*a, chunk=16)
        return jnp.sum(y * w) + jnp.sum(st)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in args))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    y, st = ssd_scan(*targs, chunk=16)
    ((y * torch.tensor(w)).sum() + st.sum()).backward()
    for a, b in zip(targs, want):
        assert np.abs(a.grad.numpy() - np.asarray(b)).max() <= 1e-4


@pytest.mark.parametrize("S", [1, 7, 64, 96, 125, 1000, 2048])
def test_chunk_rule_matches_jax(S):
    c = min(128, S)
    while S % c:
        c -= 1
    assert chunk_len(S, 128) == c


def _ssd_terms(xh, dt, A, Bv, Cv, chunk, terms):
    """y of the chunked scan as the bf16 kernel computes it: the float32
    decayed scores M and the float32 carry enter their products with the
    exact bf16 x and C as bf16 terms (``terms`` of them), each product
    summed in float32."""
    b, s, h, p = xh.shape
    n = Bv.shape[3]
    nc = s // chunk
    f = lambda t, *shape: t.float().reshape(b, nc, chunk, *shape)
    xf, dtf = f(xh, h, p), f(dt, h)
    Bh, Ch = f(Bv, 1, n).expand(-1, -1, -1, h, -1), f(Cv, 1, n).expand(
        -1, -1, -1, h, -1)

    def split(t):
        out = []
        for _ in range(terms):
            hi = t.bfloat16().float()
            out.append(hi)
            t = t - hi
        return out

    cs = torch.cumsum((dtf * A).double(), dim=2)            # (b,nc,c,h)
    seg = (cs[:, :, :, None, :] - cs[:, :, None, :, :]).float()  # l, s
    tril = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    L = torch.exp(seg.masked_fill(~tril[None, None, :, :, None],
                                  float("-inf")))
    M = torch.einsum("bzlhn,bzshn->bzlsh", Ch, Bh) * L * dtf[:, :, None]
    y = sum(torch.einsum("bzlsh,bzshp->bzlhp", m, xf) for m in split(M))
    w = torch.exp((cs[:, :, -1:] - cs).float()) * dtf
    states = torch.einsum("bzlh,bzlhp,bzlhn->bzhpn", w, xf, Bh)
    decay = torch.exp(cs[:, :, -1].float())
    carry, prev = torch.zeros(b, h, p, n), []
    for z in range(nc):
        prev.append(carry)
        carry = carry * decay[:, z, :, None, None] + states[:, z]
    y_off = sum(torch.einsum("bzlhn,bzhpn->bzlhp", Ch, c)
                for c in split(torch.stack(prev, 1)))
    y = y + torch.exp(cs.float())[..., None] * y_off
    return y.reshape(b, s, h, p).bfloat16()


def test_two_term_bf16_split_of_m_keeps_the_bf16_limit():
    """The bf16 SSD kernel's recipe in plain torch: M and the carry as two
    bf16 terms against exact bf16 x and C stay within one bf16 step of the
    plain version's y; one bf16 term does not, so the limit tells the two
    apart."""
    x, dt, A, Bv, Cv = (torch.tensor(a) for a in _inputs(2, 256, 4, 1, 16,
                                                         16, seed=23))
    x, Bv, Cv = x.bfloat16(), Bv.bfloat16(), Cv.bfloat16()
    want, _ = ssd_ref(x, dt, A, Bv, Cv, chunk=64)
    two = _ssd_terms(x, dt, A, Bv, Cv, 64, terms=2)
    one = _ssd_terms(x, dt, A, Bv, Cv, 64, terms=1)
    assert bf16_steps(two, want) <= 1.0
    assert bf16_steps(one, want) > 1.0
