"""OTP (x ⊕ K) over parameter trees — paper Algorithm 2 step 4 (port of
``repro.security.otp``, its OTP and wire-format half).

Every leaf is bit-viewed as unsigned words (32-bit leaves as u32, bf16,
f16 and i16 leaves as u16) and XORed with a pad stream expanded by the
threefry PRF from a QKD-derived 32-bit seed. Decryption is the same XOR.
The pad key of leaf i is ``fold_in(key(seed), i)`` with leaves in
``jax.tree_util`` order (dict keys sorted), so the stream never repeats
across leaves; the round is folded into the seed by the key schedule, so
pads never repeat across rounds.

torch has no uint32 arithmetic: words are held in int64 tensors masked to
32 bits (u16 words to 16). The wire view (``tree_to_u32``) packs u16
leaves two to a word, low half first, with a zero half-word after an odd
length. ``tree_pad_u32(_rows)`` gives the pads in that same wire layout,
so ``tree_to_u32(encrypt_tree(t, s)) == tree_to_u32(t) ^ tree_pad_u32(t, s)``
— the form the fused XOR + MAC kernel's given-pad entries consume.
``pad_layout`` describes the same pads leaf by leaf (index, first wire
word, elements, width): from it and a seed the kernel's seeded entries
generate the pads themselves, which is what the trainer runs.

The secagg half (``tree_to_q32`` … ``secagg_mask_stream``) carries the
mod-2^32 fixed-point streams of dropout-tolerant secure aggregation as
int32 bit storage (the OTP kernel's convention): arithmetic runs on int64
words reduced mod 2^32, and a stream is bit-viewed as uint32 only at the
wire.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import prng
from repro_torch.device import resolve_device
from repro_torch.nn.pytree import tree_leaves, tree_map

_M32 = 0xFFFFFFFF

#: leaf dtype -> (same-width signed integer view, word width in bits)
_BITCAST = {
    torch.float32: (torch.int32, 32),
    torch.int32: (torch.int32, 32),
    torch.bfloat16: (torch.int16, 16),
    torch.float16: (torch.int16, 16),
    torch.int16: (torch.int16, 16),
}


def _width(dtype) -> int:
    if dtype not in _BITCAST:
        raise TypeError(f"no OTP bit view for leaf dtype {dtype}")
    return _BITCAST[dtype][1]


def _to_words(leaf: torch.Tensor) -> torch.Tensor:
    """Leaf -> its unsigned words (int64, masked to the leaf's width)."""
    view, width = _BITCAST[leaf.dtype]
    return leaf.contiguous().view(view).to(torch.int64) & ((1 << width) - 1)


def _from_words(words: torch.Tensor, dtype) -> torch.Tensor:
    """Unsigned words (int64) -> a leaf of ``dtype`` with those bits."""
    view, width = _BITCAST[dtype]
    signed = words - ((words >> (width - 1)) << width)   # two's complement
    return signed.to(view).view(dtype)


def _unflatten(tree, leaves: list):
    """Rebuild ``tree``'s structure from leaves in flatten order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*[build(x) for x in t])
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(tree)


# ---------------------------------------------------------------------------
# pads and encryption
# ---------------------------------------------------------------------------

def _seed_keys(seeds, device) -> torch.Tensor:
    return prng.key_u32(torch.as_tensor(seeds, dtype=torch.int64,
                                        device=device))


def pad_u32(seed_u32, n: int, device=None) -> torch.Tensor:
    """n pad words (int64 u32) from a 32-bit seed (threefry expansion), on
    the seed tensor's device, or on ``device`` for an int seed."""
    dev = (seed_u32.device if isinstance(seed_u32, torch.Tensor)
           else resolve_device(device))
    return prng.bits(_seed_keys(seed_u32, dev), (n,))


def pad_u32_rows(seeds_u32: torch.Tensor, n: int) -> torch.Tensor:
    """(E,) seeds -> (E, n) pad words; row e == ``pad_u32(seeds[e], n)``."""
    return prng.bits(_seed_keys(seeds_u32, seeds_u32.device), (n,))


def encrypt_flat_u32(msg_u32: torch.Tensor, seed_u32) -> torch.Tensor:
    """Bulk path: ciphertext = msg ⊕ pad for a flat (n,) stream of u32
    words (int64)."""
    return msg_u32 ^ pad_u32(seed_u32, msg_u32.shape[0], msg_u32.device)


def _leaf_pads(leaves: list, base: torch.Tensor, lead: int) -> list:
    """Per-leaf pad words shaped like each leaf: leaf i draws its own
    width's bits under ``fold_in(base, i)``; ``lead`` leading dims of each
    leaf are key-batch dims (0 for one tree, 1 for stacked rows)."""
    pads = []
    for i, leaf in enumerate(leaves):
        width = _width(leaf.dtype)
        b = prng.bits(prng.fold_in(base, i), tuple(leaf.shape[lead:]))
        pads.append(b & 0xFFFF if width == 16 else b)
    return pads


def _encrypt(tree, seeds, lead: int):
    leaves = tree_leaves(tree)
    if not leaves:
        return tree
    base = _seed_keys(seeds, leaves[0].device)
    out = [_from_words(_to_words(leaf) ^ pad, leaf.dtype)
           for leaf, pad in zip(leaves, _leaf_pads(leaves, base, lead))]
    return _unflatten(tree, out)


def encrypt_tree(tree, seed_u32):
    """OTP-encrypt every leaf of a tree. Involution: decrypt == encrypt."""
    return _encrypt(tree, seed_u32, 0)


def decrypt_tree(tree, seed_u32):
    return encrypt_tree(tree, seed_u32)       # XOR is an involution


def encrypt_tree_rows(tree, seeds_u32):
    """OTP-encrypt every row of a stacked tree: leaves (E, ...), seeds
    (E,). Row e is bit-identical to ``encrypt_tree(row_e, seeds[e])``."""
    return _encrypt(tree, seeds_u32, 1)


def decrypt_tree_rows(tree, seeds_u32):
    return encrypt_tree_rows(tree, seeds_u32)  # XOR is an involution


# ---------------------------------------------------------------------------
# tree <-> flat u32 wire view (the stream the MAC covers)
# ---------------------------------------------------------------------------

def _pack(words: list, widths: list, lead: tuple) -> torch.Tensor:
    """Concatenate per-leaf words (lead + (n_i,)) into u32 wire words:
    u16 words pack two to a word, low half first, odd length zero-padded."""
    out = []
    for w, width in zip(words, widths):
        w = w.reshape(lead + (-1,))
        if width == 16:
            if w.shape[-1] % 2:
                w = torch.cat([w, w.new_zeros(lead + (1,))], dim=-1)
            w = w[..., 0::2] | (w[..., 1::2] << 16)
        out.append(w)
    if not out:
        return torch.zeros(lead + (0,), dtype=torch.int64)
    return torch.cat(out, dim=-1)


def _unpack(vec: torch.Tensor, like_leaves: list, lead: int) -> list:
    out, off = [], 0
    for leaf in like_leaves:
        shape = tuple(leaf.shape[lead:])
        n = math.prod(shape)
        if _width(leaf.dtype) == 16:
            n_words = (n + 1) // 2
            w = vec[..., off:off + n_words]
            u = torch.stack([w & 0xFFFF, w >> 16], dim=-1).flatten(-2)
            u = u[..., :n]
            off += n_words
        else:
            u = vec[..., off:off + n]
            off += n
        out.append(_from_words(u.reshape(vec.shape[:-1] + shape),
                               leaf.dtype))
    return out


def tree_to_u32(tree) -> torch.Tensor:
    """All leaves as one flat (n,) stream of u32 words (int64)."""
    leaves = tree_leaves(tree)
    return _pack([_to_words(x) for x in leaves],
                 [_width(x.dtype) for x in leaves], ())


def tree_to_u32_rows(tree) -> torch.Tensor:
    """Stacked wire view: leaves (E, ...) -> (E, W) words; row e equals
    ``tree_to_u32`` of row e."""
    leaves = tree_leaves(tree)
    lead = (leaves[0].shape[0],) if leaves else (0,)
    return _pack([_to_words(x) for x in leaves],
                 [_width(x.dtype) for x in leaves], lead)


def _u32(vec: torch.Tensor) -> torch.Tensor:
    """Wire words as int64 u32, from int64 or from int32 bit storage."""
    return vec.to(torch.int64) & _M32


def u32_to_tree(vec: torch.Tensor, like):
    """Inverse of ``tree_to_u32`` given a structural template; ``vec`` is
    int64 u32 words or their int32 bit storage."""
    return _unflatten(like, _unpack(_u32(vec), tree_leaves(like), 0))


def u32_to_tree_rows(vec: torch.Tensor, like):
    """Inverse of ``tree_to_u32_rows`` given a stacked template."""
    return _unflatten(like, _unpack(_u32(vec), tree_leaves(like), 1))


def tree_pad_u32(like, seed_u32) -> torch.Tensor:
    """The pads ``encrypt_tree(like, seed)`` XORs in, in the wire layout
    of ``tree_to_u32(like)`` (the u16 padding half-word gets pad 0)."""
    leaves = tree_leaves(like)
    base = _seed_keys(seed_u32, leaves[0].device)
    return _pack(_leaf_pads(leaves, base, 0),
                 [_width(x.dtype) for x in leaves], ())


def tree_pad_u32_rows(like, seeds_u32) -> torch.Tensor:
    """Row form of ``tree_pad_u32``: stacked template, (E,) seeds ->
    (E, W) pad words in the layout of ``tree_to_u32_rows(like)``."""
    leaves = tree_leaves(like)
    base = _seed_keys(seeds_u32, leaves[0].device)
    return _pack(_leaf_pads(leaves, base, 1),
                 [_width(x.dtype) for x in leaves], (leaves[0].shape[0],))


# ---------------------------------------------------------------------------
# the pad layout: what the fused kernel needs to generate the pads itself
# ---------------------------------------------------------------------------

# (device, structure) -> layout, and id(layout) -> (layout, its rows as
# host ints); never evicted, so a layout built here stays alive and its id
# names it
_LAYOUTS: dict = {}
_LAYOUT_ROWS: dict = {}


def pad_layout(like, lead: int = 0) -> torch.Tensor:
    """The pads of ``like`` in its wire layout, as the fused kernel reads
    them: an int64 (L, 4) tensor on the leaves' device, one row per leaf in
    flatten order — the leaf index i (the ``fold_in`` datum), its first
    wire word, its element count per row and its width (32, or 16 for
    bf16, f16 and i16 leaves). ``lead`` leading dims of each leaf are row
    dims (0 for one tree, 1 for stacked rows).

    Built once per tree structure (each leaf's dtype and row shape) and
    device and cached, so a call on a known structure copies nothing to
    the device."""
    leaves = tree_leaves(like)
    if not leaves:
        raise ValueError("a pad layout needs at least one leaf")
    dev = leaves[0].device
    key = (dev, tuple((x.dtype, tuple(x.shape[lead:])) for x in leaves))
    hit = _LAYOUTS.get(key)
    if hit is not None:
        return hit
    rows, first = [], 0
    for i, leaf in enumerate(leaves):
        count = math.prod(leaf.shape[lead:])
        width = _width(leaf.dtype)
        rows.append((i, first, count, width))
        first += count if width == 32 else (count + 1) // 2
    layout = torch.tensor(rows, dtype=torch.int64, device=dev)
    _LAYOUTS[key] = layout
    _LAYOUT_ROWS[id(layout)] = (layout, tuple(rows))
    return layout


def layout_rows(layout: torch.Tensor) -> tuple:
    """A layout's rows as host ints: the copy kept by ``pad_layout`` (no
    device sync), or read from the tensor for a layout built elsewhere."""
    kept = _LAYOUT_ROWS.get(id(layout))
    if kept is not None and kept[0] is layout:
        return kept[1]
    return tuple(tuple(r) for r in layout.tolist())


# ---------------------------------------------------------------------------
# secagg fixed-point domain (dropout-tolerant secure aggregation)
#
# Pairwise masks must cancel under the aggregation SUM, which XOR pads
# cannot do, so secagg contributions live in a mod-2^32 fixed-point domain:
# parameters quantize to int32 with SECAGG_FRAC_BITS fractional bits
# (clipped to ±SECAGG_CLIP, |x| ≤ 16), scale by a small integer FedAvg
# weight, and add signed threefry pad streams. Wraparound arithmetic is
# exact and associative, so every execution order gives the same bits, and
# an absent partner's pads cancel EXACTLY by adding the mirrored signed
# streams (``sum_signed_pads``).
#
# Overflow budget: |w·q| ≤ SECAGG_W_MAX · SECAGG_CLIP < 2^23, so up to 2^7
# summed entries stay below 2^31 and the aggregate reads back as a faithful
# int32.
# ---------------------------------------------------------------------------

SECAGG_FRAC_BITS = 16                 # fixed-point scale 2^16 (~1.5e-5 step)
SECAGG_CLIP = 1 << 20                 # quantized magnitude cap (|x| ≤ 16.0)
SECAGG_W_MAX = 7                      # integer FedAvg weight cap


def _storage(words: torch.Tensor) -> torch.Tensor:
    """int64 words -> the int32 bit storage of their low 32 bits."""
    words = words & _M32
    return (words - ((words >> 31) << 32)).to(torch.int32)


def _int64(x, device=None) -> torch.Tensor:
    """An int64 tensor of ``x``: a tensor stays on its device, numpy or a
    list goes to ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64)
    return torch.as_tensor(np.asarray(x, np.int64),
                           device=resolve_device(device))


def _q32(leaves: list, lead: int) -> torch.Tensor:
    """Quantized leaves, flattened past ``lead`` dims and concatenated."""
    out = []
    for leaf in leaves:
        if leaf.dtype != torch.float32:
            raise TypeError("secagg quantization is defined for float32 "
                            f"leaves only, got {leaf.dtype}")
        q = torch.clamp(torch.round(leaf * float(1 << SECAGG_FRAC_BITS)),
                        -SECAGG_CLIP, SECAGG_CLIP)      # half to even
        out.append(q.to(torch.int32).reshape(tuple(leaf.shape[:lead])
                                             + (-1,)))
    return torch.cat(out, dim=-1)


def tree_to_q32(tree) -> torch.Tensor:
    """Quantize a float32 tree to a flat (n,) int32 fixed-point stream."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((0,), dtype=torch.int32)
    return _q32(leaves, 0)


def q32_to_tree(vec: torch.Tensor, like, denom):
    """Dequantize an aggregated mod-2^32 stream (int32 storage) into
    ``like``'s tree, divided by ``denom`` (the aggregate's integer-weight
    sum). Leading batch dims of ``vec`` (and of ``denom``) broadcast
    through: rows dequantize independently."""
    if vec.dtype != torch.int32:
        vec = _storage(vec)
    q = vec.to(torch.float32)
    scale = torch.clamp(torch.as_tensor(denom, dtype=torch.float32,
                                        device=vec.device), min=1.0)
    x = q / (scale * float(1 << SECAGG_FRAC_BITS))[..., None]
    batch = tuple(vec.shape[:-1])
    out, off = [], 0
    for leaf in tree_leaves(like):
        n = math.prod(leaf.shape)
        out.append(x[..., off:off + n].reshape(batch + tuple(leaf.shape)))
        off += n
    return _unflatten(like, out)


def sum_signed_pads(seeds_u32, signs, n: int, device=None) -> torch.Tensor:
    """Σ_p sign_p · pad(seed_p, n) mod 2^32 — the pairwise-mask stream.

    seeds (..., P) uint32 values (a tensor, on whose device the pads are
    made, or numpy on ``device``), signs (..., P) (+1 add, −1 subtract, 0
    skip) -> (..., n) int32 storage. Every (row, partner) seed expands in
    ONE threefry call; the modular sum is exact, so its order cannot
    change a bit."""
    seeds = _int64(seeds_u32, device)
    dev = seeds.device
    signs = _int64(signs, dev)
    if seeds.shape[-1] == 0:
        return torch.zeros(tuple(seeds.shape[:-1]) + (n,), dtype=torch.int32,
                           device=dev)
    pads = pad_u32_rows(seeds, n)                           # (..., P, n)
    signed = torch.where((signs > 0)[..., None], pads, -pads)
    signed = torch.where((signs != 0)[..., None], signed,
                         torch.zeros_like(signed))
    return _storage(signed.sum(dim=-2))


def secagg_mask_rows(stacked, w_int, pair_seeds, pair_signs) -> torch.Tensor:
    """Masked secagg contributions of every row of a stacked tree: leaves
    (K, ...), integer weights (K,), pair seeds and signs (K, P) -> (K, n)
    int32 storage; row k == ``secagg_mask_stream`` of row k."""
    q = _q32(tree_leaves(stacked), 1).to(torch.int64)
    w = _int64(w_int, q.device).reshape(-1, 1)
    pads = sum_signed_pads(pair_seeds, pair_signs, q.shape[-1],
                           device=q.device)
    return _storage(q * w + pads.to(torch.int64))


def secagg_mask_stream(tree, w_int, pair_seeds, pair_signs) -> torch.Tensor:
    """One satellite's masked secagg contribution (what goes on the wire):
    y = w_int · q(tree) + Σ sign · pad(seed) mod 2^32, as (n,) int32
    storage. Pair seeds and signs (P,) come from the cohort's pairwise mask
    shares (``KeyManager.share_edges`` / the plan's tables); partners that
    fail to deliver are cancelled later (``KeyManager.recover_masks`` / the
    plan's correction tables)."""
    rows = tree_map(lambda x: x[None], tree)
    dev = tree_leaves(rows)[0].device
    return secagg_mask_rows(rows, [int(w_int)],
                            _int64(pair_seeds, dev)[None],
                            _int64(pair_signs, dev)[None])[0]
