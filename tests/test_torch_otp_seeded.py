"""The fused OTP-XOR + MAC kernel's seeded entries vs the JAX package.

The seeded entries generate each row's pad from its 32-bit seed and the
tree's pad layout (``security.otp.pad_layout``). On the CPU they run their
plain version, which expands the pads from that same layout tensor through
the port's threefry, so the layout the kernel reads is tested here.
Ciphertexts are held bit for bit against ``repro.security.otp``'s
``encrypt_tree(_rows)`` and tags against ``repro.security.mac``. The JAX
MAC is jitted per length: eager ``poly_mac_rows`` takes 10-20 s a call,
and its jit compiles for ~110 s at the VQC's 62 words (1.5 s at the mixed
tree's 26), so the VQC rows are held against ``poly_mac_u32`` row by row
(``poly_mac_rows`` is its vmap).
"""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.security import mac as jmac
from repro.security import otp as jotp
from repro_torch.kernels.otp_xor import ops, ref
from repro_torch.security import otp as totp

ROOT = Path(__file__).resolve().parents[1]
SEEDS = np.asarray([0, 11, 2 ** 31 + 1, 2 ** 32 - 1], np.uint32)
_jax_mac_u32 = jax.jit(jmac.poly_mac_u32)
_jax_mac_rows = jax.jit(jmac.poly_mac_rows)


def _vqc_leaves(rng, lead):
    """The trainer's VQC tree (8 qubits, 3 layers, 7 classes): 62 words."""
    return {"b_out": rng.normal(size=lead + (7,)).astype(np.float32),
            "phi": rng.normal(size=lead + (3, 8)).astype(np.float32),
            "theta": rng.normal(size=lead + (3, 8)).astype(np.float32),
            "w_out": rng.normal(size=lead + (7,)).astype(np.float32)}


def _mixed_leaves(rng, lead):
    """f32 (3, 5), bf16 of odd length 7, f16 (2, 3), i32 (4,): 26 words."""
    return {"a": rng.normal(size=lead + (3, 5)).astype(np.float32),
            "b": jnp.asarray(rng.normal(size=lead + (7,)), jnp.bfloat16),
            "c": rng.normal(size=lead + (2, 3)).astype(np.float16),
            "d": rng.integers(-2 ** 31, 2 ** 31, lead + (4,)).astype(
                np.int32)}


TREES = {"vqc": _vqc_leaves, "mixed": _mixed_leaves}


def _both(name, seed, lead=()):
    """The same bits as a JAX tree and a port tree (numpy in between)."""
    jt = {k: jnp.asarray(v) for k, v in TREES[name](
        np.random.default_rng(seed), lead).items()}
    tt = {}
    for k, v in jt.items():
        if v.dtype == jnp.bfloat16:
            tt[k] = torch.tensor(np.asarray(v).view(np.int16)).view(
                torch.bfloat16)
        else:
            tt[k] = torch.tensor(np.asarray(v))
    return jt, tt


def _storage(a):
    return ref.as_storage(torch.tensor(np.asarray(a).astype(np.int64)))


def _words(t):
    return ref.as_words(t).tolist()


@pytest.mark.parametrize("lead", [0, 1])
@pytest.mark.parametrize("name", list(TREES))
def test_pad_layout_matches_wire_offsets(name, lead):
    """One row per leaf in flatten order: its index, the offset of its
    words in ``tree_to_u32(_rows)``, its elements per row and its width."""
    jt, tt = _both(name, 1, (3,) * lead)
    layout = totp.pad_layout(tt, lead=lead)
    assert layout.dtype == torch.int64 and layout.shape == (4, 4)
    wire = (totp.tree_to_u32_rows if lead else totp.tree_to_u32)
    off, want = 0, []
    for i, k in enumerate(sorted(tt)):
        leaf = tt[k]
        want.append((i, off, leaf[0].numel() if lead else leaf.numel(),
                     16 if leaf.element_size() == 2 else 32))
        off += wire({k: leaf}).shape[-1]
    assert totp.layout_rows(layout) == tuple(want)
    assert tuple(map(tuple, layout.tolist())) == tuple(want)
    jwire = (jotp.tree_to_u32_rows if lead else jotp.tree_to_u32)(jt)
    assert off == wire(tt).shape[-1] == np.asarray(jwire).shape[-1]


def test_pad_layout_is_cached_per_structure():
    """Built once per structure and device: other values, the same tensor;
    another dtype or shape, another layout."""
    _, a = _both("mixed", 1)
    _, b = _both("mixed", 2)
    la = totp.pad_layout(a)
    assert totp.pad_layout(b) is la
    b["a"] = b["a"].to(torch.int32)
    assert totp.pad_layout(b) is not la
    assert totp.pad_layout({"x": torch.zeros(5, 3)}, lead=1) is \
        totp.pad_layout({"y": torch.ones(3)})
    with pytest.raises(ValueError):
        totp.pad_layout({})


@pytest.mark.parametrize("name", list(TREES))
def test_layout_pads_are_the_tree_pads(name):
    """The plain version's pads, expanded from the layout alone, are the
    port's ``tree_pad_u32_rows`` bit for bit."""
    _, tt = _both(name, 3, (4,))
    seeds = torch.tensor(SEEDS.astype(np.int64))
    assert torch.equal(ref.layout_pads(ref.as_storage(seeds),
                                       totp.pad_layout(tt, lead=1)),
                       totp.tree_pad_u32_rows(tt, seeds))


@pytest.mark.parametrize("tag_input", [False, True])
@pytest.mark.parametrize("name", list(TREES))
def test_seeded_rows_match_jax(name, tag_input):
    """Rows with seeds {0, 11, 2^31+1, 2^32-1}: ciphertexts == JAX's
    ``tree_to_u32_rows(encrypt_tree_rows(tree, seeds))``, tags == its
    poly MAC over them (sender) or over the message (receiver)."""
    jt, tt = _both(name, 4, (4,))
    rng = np.random.default_rng(5)
    rk = rng.integers(0, 2 ** 32, 4, dtype=np.uint32)
    sk = rng.integers(0, 2 ** 32, 4, dtype=np.uint32)
    msg = np.asarray(jotp.tree_to_u32_rows(jt))
    ct_j = np.asarray(jotp.tree_to_u32_rows(
        jotp.encrypt_tree_rows(jt, jnp.asarray(SEEDS))))
    tagged = msg if tag_input else ct_j
    if name == "mixed":
        tags_j = np.asarray(_jax_mac_rows(jnp.asarray(tagged),
                                          jnp.asarray(rk), jnp.asarray(sk)))
    else:
        tags_j = [int(_jax_mac_u32(jnp.asarray(tagged[e]), jnp.uint32(rk[e]),
                                   jnp.uint32(sk[e]))) for e in range(4)]
    ct, tags = ops.otp_xor_mac_rows_seeded(
        _storage(totp.tree_to_u32_rows(tt)), _storage(SEEDS),
        totp.pad_layout(tt, lead=1), _storage(rk), _storage(sk), tag_input)
    assert _words(ct) == ct_j.tolist()
    assert _words(tags) == np.asarray(tags_j).tolist()


@pytest.mark.parametrize("seed", [0, 2 ** 32 - 1])
@pytest.mark.parametrize("name", list(TREES))
def test_seeded_stream_matches_jax(name, seed):
    """One tree: ciphertext == JAX's ``tree_to_u32(encrypt_tree(...))``,
    tag == ``poly_mac_u32`` over it, and the receiver's tag over what it
    received; decrypting the ciphertext gives the message back."""
    jt, tt = _both(name, 6)
    msg = _storage(totp.tree_to_u32(tt))
    layout = totp.pad_layout(tt)
    ct_j = jotp.tree_to_u32(jotp.encrypt_tree(jt, jnp.uint32(seed)))
    rk, sk = 0x9E3779B9, 0x7F4A7C15
    tag_j = int(_jax_mac_u32(ct_j, jnp.uint32(rk), jnp.uint32(sk)))
    ct, tag = ops.otp_xor_mac_stream_seeded(msg, seed, layout, rk, sk)
    assert _words(ct) == np.asarray(ct_j).tolist() and int(
        ref.as_words(tag)) == tag_j
    plain, tag_rx = ops.otp_xor_mac_stream_seeded(ct, seed, layout, rk, sk,
                                                  tag_input=True)
    assert torch.equal(plain, msg) and int(tag_rx) == int(tag)


def _bad_case(bad):
    """Inputs of a 2-row mixed tree with one thing wrong."""
    _, tt = _both("mixed", 7, (2,))
    msg = _storage(totp.tree_to_u32_rows(tt))
    seeds = _storage(SEEDS[:2])
    keys = _storage(SEEDS[2:])
    layout = totp.pad_layout(tt, lead=1)
    if bad == "seeds_int64":
        seeds = seeds.to(torch.int64)
    elif bad == "seeds_shape":
        seeds = _storage(SEEDS[:3])
    elif bad == "seeds_strided":
        seeds = _storage(SEEDS)[::2]
    elif bad == "layout_int32":
        layout = layout.to(torch.int32)
    elif bad == "layout_cols":
        layout = layout[:, :3].contiguous()
    elif bad == "layout_strided":
        layout = layout.t().contiguous().t()
    elif bad == "layout_words":       # a layout of another tree
        layout = totp.pad_layout({k: v for k, v in tt.items() if k != "d"},
                                 lead=1)
    elif bad == "layout_width":
        layout = layout.clone()
        layout[0, 3] = 8
    elif bad == "layout_gap":
        layout = layout.clone()
        layout[1, 1] += 1
    elif bad == "layout_leaves":
        layout = totp.pad_layout({f"x{i:03d}": torch.zeros(2, 1)
                                  for i in range(ops.MAX_LEAVES + 1)},
                                 lead=1)
        msg = torch.zeros((2, ops.MAX_LEAVES + 1), dtype=torch.int32)
    return msg, seeds, layout, keys


@pytest.mark.parametrize("bad", ["seeds_int64", "seeds_shape",
                                 "seeds_strided", "layout_int32",
                                 "layout_cols", "layout_strided",
                                 "layout_words", "layout_width",
                                 "layout_gap", "layout_leaves"])
def test_seeded_entries_refuse_bad_inputs(bad):
    """Seeds or a layout the kernel does not take raise ValueError, on the
    CPU too, before anything runs; a layout with more leaves than the
    kernel's key table holds raises rather than falling back."""
    msg, seeds, layout, keys = _bad_case(bad)
    with pytest.raises(ValueError):
        ops.otp_xor_mac_rows_seeded(msg, seeds, layout, keys, keys)
    if not bad.startswith("seeds"):
        with pytest.raises(ValueError):
            ops.otp_xor_mac_stream_seeded(msg[0].contiguous(), 5, layout, 1,
                                          2)


def _names(path: Path) -> set:
    """Every name a module reads, imports or looks up as an attribute."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Name):
            out.add(node.id)
        elif isinstance(node, ast.Attribute):
            out.add(node.attr)
        elif isinstance(node, ast.alias):
            out.add(node.name)
            out.add(node.asname)
    return out


def test_trainer_builds_no_pads_in_plain_torch():
    """The trainer's secure stage and per-edge exchange reach only the
    seeded entries: ``core/round.py`` names no plain-torch pad function nor a
    given-pad entry."""
    names = _names(ROOT / "src" / "repro_torch" / "core" / "round.py")
    assert not names & {"tree_pad_u32", "tree_pad_u32_rows",
                        "otp_xor_mac_rows", "otp_xor_mac_stream"}
    assert {"otp_xor_mac_rows_seeded", "otp_xor_mac_stream_seeded",
            "pad_layout"} <= names


def test_in_graph_round_builds_no_pads_in_plain_torch():
    """The in-graph round's otp, otp_gather and ``otp_stacked`` reach only
    the seeded rows entry, whose CPU path is its plain version:
    ``core/dist.py`` names no plain-torch pad or encryption function nor a
    given-pad entry."""
    names = _names(ROOT / "src" / "repro_torch" / "core" / "dist.py")
    assert not names & {"tree_pad_u32", "tree_pad_u32_rows", "pad_u32",
                        "pad_u32_rows", "encrypt_tree", "encrypt_tree_rows",
                        "decrypt_tree_rows", "otp_xor_mac_rows",
                        "otp_xor_mac_stream", "otp_xor_mac_stream_seeded"}
    assert {"otp_xor_mac_rows_seeded", "pad_layout"} <= names
