"""The port's BB84 and key registry vs the JAX package's, in one process.

Every BB84 field bit-equal for single and edge-batched calls with a mixed
eavesdrop mask; pad seeds bit-equal; ``KeyManager.establish_edges`` equal
to the JAX registry's on edges with a ``"gs"`` endpoint. Those hash a
``str``, which Python salts per process, so the comparison only holds
within one process — which is how these tests run it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.quantum import qkd as jqkd
from repro.security.keys import KeyManager as JaxKeyManager
from repro_torch import prng
from repro_torch.quantum import qkd as tqkd
from repro_torch.security.keys import QBER_ABORT, KeyManager

EAV = [False, True, False, True, True, False]


def _keys(n):
    k = jax.random.split(jax.random.PRNGKey(11), n)
    return k, torch.tensor(np.asarray(k).astype(np.int64))


def _assert_result_equal(t, j):
    for f in jqkd.BB84Result._fields:
        a, b = getattr(t, f), np.asarray(getattr(j, f))
        assert a.numpy().tolist() == b.tolist(), f


@pytest.fixture(scope="module")
def batch():
    jk, tk = _keys(len(EAV))
    jr = jqkd.bb84_keygen_edges(jk, 512, jnp.asarray(EAV))
    tr = tqkd.bb84_keygen_edges(tk, 512, EAV)
    return jk, tk, jr, tr


def test_bb84_edges_bit_equal(batch):
    _, _, jr, tr = batch
    _assert_result_equal(tr, jr)
    assert tr.qber.dtype == torch.float32
    assert tqkd.qber_abort_mask(tr, QBER_ABORT).tolist() == EAV


@pytest.mark.parametrize("e", [0, 1])
def test_bb84_single_edge_bit_equal(batch, e):
    jk, tk, _, tr = batch
    one = tqkd.bb84_keygen(tk[e], 512, eavesdrop=EAV[e])
    _assert_result_equal(one, jqkd.bb84_keygen(jk[e], 512,
                                               eavesdrop=EAV[e]))
    # the batch computes the eavesdropper's branch for every edge and
    # selects it: row e equals the single call
    for f in tqkd.BB84Result._fields:
        assert torch.equal(getattr(one, f), getattr(tr, f)[e]), f


def test_pad_seeds_bit_equal(batch):
    _, _, jr, tr = batch
    want = np.asarray(jqkd.derive_pad_seeds(jr.sifted_key, jr.key_len))
    got = tqkd.derive_pad_seeds(tr.sifted_key, tr.key_len)
    assert got.tolist() == want.tolist()
    assert int(tqkd.derive_pad_seed(tr.sifted_key[2], tr.key_len[2])) == \
        int(want[2])


def test_establish_edges_matches_jax():
    eav = frozenset({(1, 2), (0, "gs"), (3, "gs")})
    edges = [(0, 3), (2, 1), ("gs", 0), (5, "gs"), (2, 7), (0, 3),
             ("gs", 3), (9, "gs")]
    km = KeyManager(prng.PRNGKey(7, "cpu"), eavesdrop_edges=eav)
    got = km.establish_edges(edges)
    want = JaxKeyManager(jax.random.PRNGKey(7),
                         eavesdrop_edges=eav).establish_edges(edges)
    for a, b in zip(got, want):
        assert (a.edge, a.seed, a.qber, a.compromised) == \
            (b.edge, b.seed, b.qber, b.compromised)
    assert [ek.compromised for ek in got] == \
        [False, True, True, False, False, False, True, False]
    # the per-edge oracle gives the same keys as the batch
    loop = KeyManager(prng.PRNGKey(7, "cpu"), eavesdrop_edges=eav)
    for e, ek in zip(edges, got):
        assert loop.establish(e) == ek
    assert km.compromised_nodes() == {0, 1, 2, 3, "gs"}
    assert km.rekey((3, 0)) == got[0]
