"""The fused OTP-XOR + MAC wrappers and plain versions vs the JAX package's.

On the CPU the port's entries run their plain version (``ref.py``); the
JAX wrappers run the Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs them. Ciphertexts and tags are bit-equal.
The JAX wrappers use 8-row (1024-word) blocks here, as
``tests/test_batched_security.py`` does: the block size is part of their
padded-stream tag, and interpret mode at 128-row blocks compiles for
minutes. The JAX edge-batched wrapper compiles for minutes beyond one
edge, so it is called at E=1 only; each port row is held against the JAX
single-stream wrapper, which the JAX package's own tests hold equal to
the edge-batched one row by row.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.otp_xor import ref as jref
from repro.kernels.otp_xor.ops import otp_xor_mac as jax_otp_xor_mac
from repro.kernels.otp_xor.ops import otp_xor_mac_edges as jax_edges
from repro.security.mac import poly_mac_u32
from repro_torch.kernels.otp_xor import ops, ref

BLOCK_ROWS = 8
E_MAX = 5
# one compile per length (eager dispatch and a vmapped jit are far slower)
_jax_mac = jax.jit(poly_mac_u32)
_jax_block_refs = (jax.jit(jref.otp_xor_mac_edge_blocks_ref),
                   jax.jit(jref.otp_xor_mac_blocks_ref))


def _storage(a):
    return ref.as_storage(torch.tensor(np.asarray(a).astype(np.int64)))


@pytest.fixture(scope="module")
def streams():
    """Per n: E_MAX random rows, keys, and the JAX wrapper's (ct, tag) of
    each row — one interpret-mode compile per n."""
    out = {}
    for n in (1, 62, 16384, 16389):
        rng = np.random.default_rng(n)
        msg = rng.integers(0, 2 ** 32, (E_MAX, n), dtype=np.uint32)
        pad = rng.integers(0, 2 ** 32, (E_MAX, n), dtype=np.uint32)
        rk = rng.integers(0, 2 ** 32, E_MAX, dtype=np.uint32)
        sk = rng.integers(0, 2 ** 32, E_MAX, dtype=np.uint32)
        want = [jax_otp_xor_mac(jnp.asarray(msg[e]), jnp.asarray(pad[e]),
                                jnp.uint32(rk[e]), jnp.uint32(sk[e]),
                                block_rows=BLOCK_ROWS) for e in range(E_MAX)]
        out[n] = (msg, pad, rk, sk,
                  np.stack([np.asarray(c) for c, _ in want]),
                  [int(t) for _, t in want])
    return out


@pytest.mark.parametrize("E", [1, 5])
@pytest.mark.parametrize("n", [1, 62, 16384, 16389])
def test_padded_wrappers_match_jax(streams, E, n):
    msg, pad, rk, sk, ct_j, tag_j = streams[n]
    ct, tags = ops.otp_xor_mac_edges(_storage(msg[:E]), _storage(pad[:E]),
                                     _storage(rk[:E]), _storage(sk[:E]),
                                     block_rows=BLOCK_ROWS)
    assert ref.as_words(ct).tolist() == ct_j[:E].tolist()
    assert ref.as_words(tags).tolist() == tag_j[:E]
    ct1, tag1 = ops.otp_xor_mac(_storage(msg[E - 1]), _storage(pad[E - 1]),
                                int(rk[E - 1]), int(sk[E - 1]),
                                block_rows=BLOCK_ROWS)
    assert ref.as_words(ct1).tolist() == ct_j[E - 1].tolist()
    assert int(tag1) == tag_j[E - 1]


def test_edges_wrapper_matches_jax_edges_wrapper(streams):
    msg, pad, rk, sk, ct_j, tag_j = streams[62]
    ct_e, tags_e = jax_edges(jnp.asarray(msg[:1]), jnp.asarray(pad[:1]),
                             jnp.asarray(rk[:1]), jnp.asarray(sk[:1]),
                             block_rows=BLOCK_ROWS)
    ct, tags = ops.otp_xor_mac_edges(_storage(msg[:1]), _storage(pad[:1]),
                                     _storage(rk[:1]), _storage(sk[:1]),
                                     block_rows=BLOCK_ROWS)
    assert ref.as_words(ct).tolist() == np.asarray(ct_e).tolist()
    assert ref.as_words(tags).tolist() == np.asarray(tags_e).tolist()
    assert np.asarray(tags_e).tolist() == tag_j[:1]


@pytest.mark.parametrize("tag_input", [False, True])
@pytest.mark.parametrize("n", [1, 62, 16389])
def test_entries_tag_the_unpadded_stream(streams, n, tag_input):
    """The trainer's convention: the rows and stream entries tag the
    stream at its true length — the JAX trainer's ``poly_mac_rows``, whose
    rows are ``poly_mac_u32``."""
    msg, pad, rk, sk, _, _ = streams[n]
    ct, tags = ops.otp_xor_mac_rows(_storage(msg), _storage(pad),
                                    _storage(rk), _storage(sk),
                                    tag_input=tag_input)
    assert ref.as_words(ct).tolist() == (msg ^ pad).tolist()
    tagged = msg if tag_input else msg ^ pad
    want = [int(_jax_mac(jnp.asarray(tagged[e]), jnp.uint32(rk[e]),
                         jnp.uint32(sk[e]))) for e in range(E_MAX)]
    assert ref.as_words(tags).tolist() == want
    ct1, tag1 = ops.otp_xor_mac_stream(_storage(msg[2]), _storage(pad[2]),
                                       int(rk[2]), int(sk[2]),
                                       tag_input=tag_input)
    assert torch.equal(ct1, ct[2]) and int(tag1) == int(tags[2])


def test_block_refs_match_jax():
    rng = np.random.default_rng(9)
    E, nb, R, C = 2, 3, 8, 128
    msg = rng.integers(0, 2 ** 32, (E, nb, R, C), dtype=np.uint32)
    pad = rng.integers(0, 2 ** 32, (E, nb, R, C), dtype=np.uint32)
    pw = rng.integers(0, 2 ** 31 - 1, (E, 2, R, C), dtype=np.uint32)
    t = lambda a: torch.tensor(a.astype(np.int64))
    edges_ref, blocks_ref = _jax_block_refs
    for got, want in (
            (ref.otp_xor_mac_edge_blocks_ref(t(msg), t(pad), t(pw)),
             edges_ref(jnp.asarray(msg), jnp.asarray(pad), jnp.asarray(pw))),
            (ref.otp_xor_mac_blocks_ref(t(msg[1]), t(pad[1]), t(pw[1])),
             blocks_ref(jnp.asarray(msg[1]), jnp.asarray(pad[1]),
                        jnp.asarray(pw[1])))):
        for a, b in zip(got, want):
            assert a.tolist() == np.asarray(b).tolist()


@pytest.mark.parametrize("bad", ["int64", "strided", "shape", "keys"])
def test_wrapper_rejects_bad_inputs(bad):
    """Wrong dtype, layout or shape raises before any dispatch."""
    msg = torch.zeros((4, 8), dtype=torch.int32)
    pad = torch.zeros((4, 8), dtype=torch.int32)
    keys = torch.zeros((4,), dtype=torch.int32)
    if bad == "int64":
        msg = msg.to(torch.int64)
    elif bad == "strided":
        msg = torch.zeros((8, 4), dtype=torch.int32).t()
    elif bad == "shape":
        pad = pad[:, :7]
    else:
        keys = keys.to(torch.int64)
    with pytest.raises(ValueError):
        ops.otp_xor_mac_rows(msg, pad, keys, torch.zeros_like(keys))
