"""The port's security primitives vs the JAX package's, in one process.

MAC arithmetic exact against Python ints; poly-MAC tags, u32 wire views,
pads, OTP ciphertexts, key mixes and Fernet tokens bit- or byte-equal to
``repro.security``. Inputs are made with numpy and handed to both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.security import fernet_lite as jfernet
from repro.security import keys as jkeys
from repro.security import mac as jmac
from repro.security import otp as jotp
from repro_torch import prng
from repro_torch.security import fernet_lite as tfernet
from repro_torch.security import keys as tkeys
from repro_torch.security import mac as tmac
from repro_torch.security import otp as totp

P = 2 ** 31 - 1
# jit, one compile per length: eager poly_mac_u32 dispatches its
# associative scan op by op (10-20 s a length), and a jit of the vmapped
# poly_mac_rows compiles for minutes
_jax_mac = jax.jit(jmac.poly_mac_u32)


def _t(a):
    """numpy uint32 words -> the port's int64 words."""
    return torch.tensor(np.asarray(a).astype(np.int64))


def _tree(rng, lead=()):
    """f32, odd-length bf16 and i32 leaves, the same bits in both packages."""
    f = rng.normal(size=lead + (3, 5)).astype(np.float32)
    h = rng.normal(size=lead + (7,)).astype(np.float32)
    i = rng.integers(-2 ** 31, 2 ** 31, lead + (4,)).astype(np.int32)
    jt = {"w": jnp.asarray(f), "h": jnp.asarray(h).astype(jnp.bfloat16),
          "i": jnp.asarray(i)}
    tt = {"w": torch.tensor(f),
          "h": torch.tensor(np.asarray(jt["h"].astype(jnp.float32))).to(
              torch.bfloat16),
          "i": torch.tensor(i)}
    return jt, tt


def test_mulmod_addmod_exact():
    rng = np.random.default_rng(0)
    vals = np.concatenate([[0, 1, 2, P - 2, P - 1, 2 ** 16, 2 ** 16 - 1],
                           rng.integers(0, P, 200)]).astype(np.int64)
    a, b = np.meshgrid(vals, vals)
    a, b = a.ravel(), b.ravel()
    mul = tmac.mulmod(_t(a), _t(b)).numpy()
    add = tmac.addmod(_t(a), _t(b)).numpy()
    want_mul = [(int(x) * int(y)) % P for x, y in zip(a, b)]
    want_add = [(int(x) + int(y)) % P for x, y in zip(a, b)]
    assert mul.tolist() == want_mul and add.tolist() == want_add
    ju = jnp.asarray(a.astype(np.uint32)), jnp.asarray(b.astype(np.uint32))
    assert np.asarray(jmac.mulmod(*ju)).tolist() == want_mul
    assert np.asarray(jmac.addmod(*ju)).tolist() == want_add


@pytest.mark.parametrize("n", [1, 62, 257, 16387])
def test_poly_mac_matches_jax(n):
    rng = np.random.default_rng(n)
    msgs = rng.integers(0, 2 ** 32, (3, n), dtype=np.uint32)
    rk = rng.integers(0, 2 ** 32, 3, dtype=np.uint32)
    sk = rng.integers(0, 2 ** 32, 3, dtype=np.uint32)
    want = [int(_jax_mac(jnp.asarray(msgs[e]), jnp.uint32(rk[e]),
                         jnp.uint32(sk[e]))) for e in range(3)]
    rows = tmac.poly_mac_rows(_t(msgs), _t(rk), _t(sk))
    assert rows.tolist() == want
    assert int(tmac.poly_mac_u32(_t(msgs[1]), int(rk[1]), int(sk[1]))) \
        == want[1]
    assert tmac.mac_verify_rows(_t(msgs), rows, _t(rk), _t(sk)).all()


def test_mac_detects_every_single_bitflip():
    rng = np.random.default_rng(1)
    msg = _t(rng.integers(0, 2 ** 32, 62, dtype=np.uint32))
    tag = tmac.poly_mac_u32(msg, 0x12345678, 0x9ABCDEF0)
    assert bool(tmac.mac_verify(msg, tag, 0x12345678, 0x9ABCDEF0))
    for word in (0, 31, 61):
        for bit in range(32):
            bad = msg.clone()
            bad[word] ^= np.uint32(1 << bit).item()
            assert not bool(tmac.mac_verify(bad, tag, 0x12345678,
                                            0x9ABCDEF0)), (word, bit)


def test_wire_view_round_trips_and_matches_jax():
    rng = np.random.default_rng(2)
    jt, tt = _tree(rng)
    words = totp.tree_to_u32(tt)
    assert words.tolist() == np.asarray(jotp.tree_to_u32(jt)).tolist()
    assert words.shape == (15 + 4 + 4,)       # 7 bf16 pack into 4 words
    back = totp.u32_to_tree(words, tt)
    for k in tt:
        assert back[k].dtype == tt[k].dtype
        assert torch.equal(back[k].view(torch.uint8), tt[k].view(torch.uint8))
    jr, tr = _tree(rng, lead=(3,))
    rows = totp.tree_to_u32_rows(tr)
    assert rows.tolist() == np.asarray(jotp.tree_to_u32_rows(jr)).tolist()
    back = totp.u32_to_tree_rows(rows, tr)
    assert torch.equal(totp.tree_to_u32_rows(back), rows)
    for e in range(3):
        one = {k: v[e] for k, v in tr.items()}
        assert torch.equal(totp.tree_to_u32(one), rows[e])


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, 2 ** 32 - 1])
def test_pads_and_encryption_match_jax(seed):
    rng = np.random.default_rng(seed % 1000)
    assert totp.pad_u32(seed, 37, device="cpu").tolist() == np.asarray(
        jotp.pad_u32(jnp.uint32(seed), 37)).tolist()
    jt, tt = _tree(rng)
    ct = totp.encrypt_tree(tt, seed)
    want = np.asarray(jotp.tree_to_u32(jotp.encrypt_tree(
        jt, jnp.uint32(seed)))).tolist()
    assert totp.tree_to_u32(ct).tolist() == want
    # the pads in the wire layout are what the fused kernel XORs in
    assert (totp.tree_to_u32(tt) ^ totp.tree_pad_u32(tt, seed)).tolist() \
        == want
    back = totp.decrypt_tree(ct, seed)
    assert torch.equal(totp.tree_to_u32(back), totp.tree_to_u32(tt))


def test_row_pads_and_encryption_match_jax():
    rng = np.random.default_rng(3)
    seeds = np.asarray([0, 11, 2 ** 31 + 1, 2 ** 32 - 1, 99], np.uint32)
    assert totp.pad_u32_rows(_t(seeds), 9).tolist() == np.asarray(
        jotp.pad_u32_rows(jnp.asarray(seeds), 9)).tolist()
    jr, tr = _tree(rng, lead=(5,))
    want = np.asarray(jotp.tree_to_u32_rows(jotp.encrypt_tree_rows(
        jr, jnp.asarray(seeds))))
    ct = totp.encrypt_tree_rows(tr, _t(seeds))
    assert totp.tree_to_u32_rows(ct).tolist() == want.tolist()
    pads = totp.tree_pad_u32_rows(tr, _t(seeds))
    assert (totp.tree_to_u32_rows(tr) ^ pads).tolist() == want.tolist()
    for e in range(5):
        one = {k: v[e] for k, v in tr.items()}
        assert totp.tree_to_u32(totp.encrypt_tree(one, int(seeds[e]))
                                ).tolist() == want[e].tolist()


@pytest.mark.parametrize("seed", [0, 5, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1])
def test_typed_key_matches_jax(seed):
    want = np.asarray(jax.random.key_data(jax.random.key(np.uint32(seed))))
    assert prng.key_u32(seed).tolist() == want.tolist()
    if seed < 2 ** 31:
        assert prng.PRNGKey(seed, "cpu").tolist() == want.tolist()


def test_bernoulli_matches_jax():
    keys = jax.random.split(jax.random.PRNGKey(4), 3)
    for p in (0.5, 0.1):
        want = np.asarray(jax.vmap(
            lambda k: jax.random.bernoulli(k, p, (300,)))(keys))
        got = prng.bernoulli(_t(np.asarray(keys)), p, (300,))
        assert got.dtype == torch.bool and got.numpy().tolist() == \
            want.tolist()


def test_key_mixes_match_jax():
    seeds = np.asarray([0, 1, 2 ** 31, 2 ** 32 - 1, 123456789], np.uint32)
    rounds = np.arange(5)
    for fn in ("round_seed_mix", "pairwise_mask_seed"):
        a = getattr(tkeys, fn)(seeds[:, None], rounds[None])
        b = getattr(jkeys, fn)(seeds[:, None], rounds[None])
        assert a.dtype == b.dtype and np.array_equal(a, b), fn
    for x, y in zip(tkeys.mac_key_mix(seeds), jkeys.mac_key_mix(seeds)):
        assert np.array_equal(x, y)
    ek = tkeys.EdgeKey(edge=(0, "gs"), seed=77, qber=0.0, compromised=False)
    jek = jkeys.EdgeKey(edge=(0, "gs"), seed=77, qber=0.0, compromised=False)
    assert ek.round_seed(3) == jek.round_seed(3)
    assert ek.mac_keys(3) == tuple(int(v) for v in jek.mac_keys(3))
    assert tkeys.canonical_edge(("gs", 4)) == jkeys.canonical_edge(("gs", 4))


def test_fernet_tokens_byte_equal_and_cross_decrypt():
    key = (123456).to_bytes(4, "big") * 8
    iv = bytes(range(16))
    for pt in (b"", b"edge=(0, 'gs') round=3 n=248", bytes(100)):
        tok = tfernet.fernet_encrypt(key, pt, now=1000.0, iv=iv)
        assert tok == jfernet.fernet_encrypt(key, pt, now=1000.0, iv=iv)
        assert len(tok) == tfernet.TOKEN_OVERHEAD + len(pt)
        assert jfernet.fernet_decrypt(key, tok, now=1001.0) == pt
        assert tfernet.fernet_decrypt(key, tok, now=1001.0) == pt
    keys, pts = [key, key[::-1]], [b"a", b"bc"]
    rows = tfernet.fernet_encrypt_rows(keys, pts, now=5.0, ivs=[iv, iv])
    assert rows == jfernet.fernet_encrypt_rows(keys, pts, now=5.0,
                                               ivs=[iv, iv])
    assert jfernet.fernet_decrypt_rows(keys, rows, now=5.0) == pts
    bad = bytearray(rows[0])
    bad[30] ^= 1
    with pytest.raises(tfernet.InvalidToken):
        tfernet.fernet_decrypt(key, bytes(bad), now=5.0)
