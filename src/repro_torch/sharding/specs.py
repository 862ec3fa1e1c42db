"""Per-leaf sharding specs of every architecture's parameter, batch and
cache trees (port of ``repro.sharding.specs``).

A spec ``P`` holds one entry per tensor dim: ``None`` (replicated), one
mesh axis name, or a tuple of axis names (the dim split over all of them,
major to minor), so ``tuple(P)`` compares with the JAX package's
``tuple(PartitionSpec)``. Name-based rules assign the *trailing* dims of
each leaf (leading stack axes — layers, or (groups, selfs) for the VLM —
get None), guarded by divisibility so the small models (whisper's 6 heads,
mamba2's 24 SSD heads, hymba's 25 heads) replicate instead of sharding
unevenly.

Strategy knobs live on ``DistCtx``: tensor parallelism over "model"
(attention heads, FFN hidden, experts, vocab), optional FSDP over the data
axes (``ctx.fsdp``), or the ``dp`` strategy (batch over every axis, every
big matrix split over all of them).

``to_placements`` turns a spec into DTensor placements on a
``DeviceMesh`` (``to_named``'s counterpart); ``distribute_tree`` places a
tree of tensors by a tree of specs; ``constrain`` is
``with_sharding_constraint``: a redistribute on a DTensor and nothing on a
plain tensor.
"""
from __future__ import annotations

import math

import torch

from repro_torch.sharding.context import DistCtx, is_dtensor


class P(tuple):
    """Immutable spec: one entry per tensor dim."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P" + tuple.__repr__(self)


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def map_with_path(fn, tree, path=(), is_leaf=None):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples; the path
    holds dict keys and NamedTuple fields as ``str``, sequence indices as
    ``int``;
    ``is_leaf(x)`` true stops the descent at x (a spec is a tuple)."""
    rec = lambda v, k: map_with_path(fn, v, path + (k,), is_leaf)
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree)
    if tree is None:                    # an empty subtree, as in JAX
        return None
    if isinstance(tree, dict):
        return {k: rec(v, k) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[rec(v, f) for f, v in zip(tree._fields, tree)])
    if isinstance(tree, (list, tuple)):
        return type(tree)(rec(v, i) for i, v in enumerate(tree))
    return fn(path, tree)


def _names(path) -> list:
    return [e for e in path if isinstance(e, str)]


def _leaf_spec(cfg, ctx: DistCtx, path: tuple, leaf) -> P:
    """(axis for dim -2, axis for dim -1) padded with leading Nones."""
    names = _names(path)
    name = names[-1] if names else None
    ms = ctx.model_size
    nd = leaf.dim()
    size = leaf.numel()
    shape = tuple(leaf.shape)
    d2 = d1 = None        # shardings for dims -2 / -1

    if ctx.strategy == "dp":
        # pure data-parallel + full FSDP: every big matrix shards one dim
        # over ALL mesh axes; no tensor parallelism at all
        spec = [None] * nd
        if nd >= 1 and size >= 1 << 16:
            total = ctx.data_size * ms
            if nd >= 2 and _div(shape[-1], total):
                spec[-1] = ctx.all_axes
            elif nd >= 2 and _div(shape[-2], total):
                spec[-2] = ctx.all_axes
            elif _div(shape[-1], ms):
                spec[-1] = "model"
        return P(*spec)

    H_ok = _div(cfg.n_heads, ms)
    KV_ok = _div(cfg.n_kv_heads, ms)
    FF_ok = _div(cfg.d_ff, ms) if cfg.d_ff else False
    V_ok = _div(cfg.padded_vocab, ms)
    E_ok = _div(cfg.n_experts, ms) if cfg.n_experts else False
    MOEFF_ok = _div(cfg.moe_d_ff, ms) if cfg.moe_d_ff else False

    if name in ("wq",):
        d1 = "model" if H_ok else None
    elif name in ("wk", "wv"):
        d1 = "model" if KV_ok else None
    elif name == "wo" and nd >= 2:
        # attention out-proj (H*hd, d) — also the SSM out-proj (d_inner, d)
        if "ssm" in names:
            d2 = "model" if _div(cfg.ssm_nheads, ms) else None
        else:
            d2 = "model" if H_ok else None
    elif name in ("wg", "wu"):
        d1 = "model" if _div(shape[-1], ms) else None
    elif name == "wd":
        d2 = "model" if _div(shape[-2], ms) else None
    elif name in ("wi",):                      # whisper gelu mlp in
        d1 = "model" if FF_ok else None
    elif name in ("we_g", "we_u", "we_d"):     # experts (L, E, d, f)
        # expert parallelism: shard the E dim (dim -3)
        spec = [None] * nd
        if E_ok:
            spec[nd - 3] = "model"
        elif MOEFF_ok:
            spec[nd - 1 if name != "we_d" else nd - 2] = "model"
        return P(*spec)
    elif name == "embed":
        d2 = "model" if V_ok else None         # (Vp, d) vocab rows
    elif name == "lm_head":
        d1 = "model" if V_ok else None         # (d, Vp)
    elif name in ("wx", "wz"):                 # ssm in-projections (d, d_inner)
        d1 = "model" if _div(cfg.ssm_nheads, ms) else None
    # every other leaf (norms, biases, router, SSM scalars, gates) is
    # replicated
    # FSDP: shard the other matrix dim over the data axes
    if ctx.fsdp and nd >= 2 and size >= 1 << 20:
        dp = ctx.data_spec_axes
        dp_n = ctx.data_size
        if d2 is None and _div(shape[-2], dp_n):
            d2 = dp
        elif d1 is None and _div(shape[-1], dp_n):
            d1 = dp
    spec = [None] * nd
    if nd >= 2:
        spec[-2], spec[-1] = d2, d1
    elif nd == 1:
        spec[-1] = d1
    return P(*spec)


def param_specs(cfg, params, ctx: DistCtx):
    """Tree of specs matching ``params``."""
    return map_with_path(lambda path, leaf: _leaf_spec(cfg, ctx, path, leaf),
                         params)


def batch_specs(cfg, batch, ctx: DistCtx):
    """Batch-dim sharding over the data axes (train and decode). Under the
    "dp" strategy the batch shards over EVERY mesh axis."""
    dp = ctx.data_spec_axes
    dp_n = ctx.data_size
    total = dp_n * ctx.model_size

    def spec(path, leaf):
        nd = leaf.dim()
        if nd == 0:
            return P()
        if ctx.strategy == "dp" and _div(leaf.shape[0], total):
            return P(*([ctx.all_axes] + [None] * (nd - 1)))
        if _div(leaf.shape[0], dp_n):
            return P(*([dp] + [None] * (nd - 1)))
        return P(*([None] * nd))

    return map_with_path(spec, batch)


def cache_specs(cfg, cache, ctx: DistCtx):
    """Serve-cache sharding.

    Preference order per attention-cache leaf (L, B, Sc, KV, hd):
      1. shard batch over data axes (decode_32k: B=128)
      2. else shard the context length Sc over data axes (long_500k: B=1 —
         sequence parallelism over the KV cache)
    KV heads shard over "model" when divisible. SSM states shard batch only.
    """
    dp = ctx.data_spec_axes
    dp_n = ctx.data_size
    ms = ctx.model_size
    KV_ok = _div(cfg.n_kv_heads, ms)

    def spec(path, leaf):
        names = _names(path)
        nd = leaf.dim()
        shape = tuple(leaf.shape)
        s = [None] * nd
        if "k" in names or "v" in names:
            # (L?, B, Sc, KV, hd) or cross (L?, B, Skv, KV, hd)
            b_dim, sc_dim, kv_dim = nd - 4, nd - 3, nd - 2
            if _div(shape[b_dim], dp_n):
                s[b_dim] = dp
            elif _div(shape[sc_dim], dp_n):
                s[sc_dim] = dp
            if KV_ok:
                s[kv_dim] = "model"
            return P(*s)
        if "pos" in names:
            # (L?, B, Sc)
            b_dim, sc_dim = nd - 2, nd - 1
            if _div(shape[b_dim], dp_n):
                s[b_dim] = dp
            elif _div(shape[sc_dim], dp_n):
                s[sc_dim] = dp
            return P(*s)
        if "state" in names:
            # (L, B, nh, hd, N)
            b_dim = nd - 4
            if _div(shape[b_dim], dp_n):
                s[b_dim] = dp
            if _div(cfg.ssm_nheads, ms):
                s[nd - 3] = "model"
            return P(*s)
        if "conv" in names:
            b_dim = nd - 3
            if _div(shape[b_dim], dp_n):
                s[b_dim] = dp
            return P(*s)
        return P(*s)

    return map_with_path(spec, cache)


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------

def to_placements(spec, mesh) -> tuple:
    """The DTensor placements (one per mesh dim) of ``spec``.

    A tensor dim split over a tuple of axes is ``Shard(d)`` on each of
    their mesh dims. DTensor splits repeated ``Shard(d)`` in mesh-dim
    order, the first mesh dim the major one, which is JAX's major-to-minor
    order when the tuple lists its axes in mesh order, as every spec here
    does (``("pod", "data")``, ``data_axes + ("model",)``); another order
    would need a flattened sub-mesh and raises.
    """
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise NotImplementedError(
                f"axes {axes} out of mesh order {names}")
        for md in dims:
            if not isinstance(out[md], Replicate):
                raise ValueError(f"mesh axis {names[md]!r} used twice in "
                                 f"{spec}")
            out[md] = Shard(d)
    return tuple(out)


def _zip_specs(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _zip_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(specs, P):
        vals = [_zip_specs(fn, v, s) for v, s in zip(tree, specs)]
        return (type(tree)(*vals) if hasattr(tree, "_fields")
                else type(tree)(vals))
    return fn(tree, specs)


def distribute(x, spec, mesh):
    """One tensor as a DTensor placed by ``spec``. A meta tensor becomes a
    DTensor over a meta local shard of the rank's shape (the dry-run's
    arguments: nothing is allocated); a real tensor, held whole on every
    rank, is split locally with no communication."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    pl = to_placements(spec, mesh)
    if x.device.type == "meta":
        local, _ = compute_local_shape_and_global_offset(x.shape, mesh, pl)
        loc = torch.empty(local, dtype=x.dtype, device=x.device)
        return DTensor.from_local(loc, mesh, pl, run_check=False,
                                  shape=x.shape, stride=x.stride())
    return distribute_tensor(x, mesh, pl, src_data_rank=None)


def distribute_tree(tree, specs, mesh):
    """Place every tensor of ``tree`` by the matching spec of ``specs``."""
    return _zip_specs(lambda x, s: distribute(x, s, mesh), tree, specs)


def constrain(x, spec, ctx):
    """``with_sharding_constraint``: a DTensor redistributed to ``spec``
    under ``ctx``'s mesh; a plain tensor unchanged."""
    if not is_dtensor(x):
        return x
    return x.redistribute(ctx.mesh, to_placements(spec, ctx.mesh))


def whole_dim(x, dim: int = 1):
    """x with dim ``dim`` whole on every rank: a DTensor split there (the
    sequence-sharded residual, dim 1) is gathered first, as GSPMD gathers
    before a projection (a DTensor view cannot merge a split dim on every
    torch version); anything else as it is."""
    if not is_dtensor(x) or x.dim() <= dim:
        return x
    from torch.distributed.tensor import Replicate
    pl = [Replicate() if p.is_shard(dim) else p for p in x.placements]
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def whole_grad(y, dim: int = 1):
    """y as it is, its gradient given dim ``dim`` whole (``whole_dim``): a
    block's output added to the sequence-sharded residual gets a
    sequence-sharded gradient, which the block's last projection could
    not take apart in its backward on every torch version."""
    if not is_dtensor(y) or y.dim() <= dim:
        return y
    return _WholeGrad.apply(y, dim)


class _WholeGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, dim):
        ctx.dim = dim
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return whole_dim(g, ctx.dim), None


def local_region(fn, mesh, in_specs: tuple, out_specs):
    """``local_map`` by specs, the counterpart of ``shard_map``: the
    returned function redistributes each DTensor argument to its spec in
    ``in_specs`` (``None`` for an argument that is not a tensor), runs
    ``fn`` on the local shards, and places what ``fn`` returns by
    ``out_specs`` (one spec, or a tuple of them for a tuple of outputs).
    Its gradient is ``local_placed``'s."""
    inp = tuple(None if s is None else to_placements(s, mesh)
                for s in in_specs)
    outp = (to_placements(out_specs, mesh) if isinstance(out_specs, P)
            else tuple(to_placements(s, mesh) for s in out_specs))
    return local_placed(fn, mesh, inp, outp)


def local_placed(fn, mesh, in_placements: tuple, out_placements):
    """``local_map`` by placements (one tuple per argument, ``None`` for
    one that is not a tensor; one tuple for a single output or a tuple of
    them), with the gradient of ``shard_map`` whose replication check is
    off, as the JAX package's regions run: an output replicated over mesh
    dims takes its gradient divided by their size, and the gradient of an
    input replicated over mesh dims is the sum of the ranks' shares there
    (``Partial``). So a weight replicated where the work is split gets
    the sum of every rank's part, and one used alike on every rank gets
    its gradient once; a collective inside ``fn`` must differentiate as
    its transpose (an all-reduce's gradient is the all-reduce of the
    output's). Mesh dims of size 1 are left as they are."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    def split(pl):
        return [md for md, p in enumerate(pl)
                if isinstance(p, Replicate) and mesh.size(md) > 1]

    grad = tuple(None if pl is None else tuple(
        Partial() if md in split(pl) else p for md, p in enumerate(pl))
        for pl in in_placements)
    single = not isinstance(out_placements[0], (tuple, list))
    outs = (out_placements,) if single else tuple(out_placements)
    scale = [math.prod(mesh.size(md) for md in split(pl)) for pl in outs]

    def body(*args):
        res = fn(*args)
        res = [_ScaleGrad.apply(t, n) if n > 1 else t
               for t, n in zip((res,) if single else res, scale)]
        return res[0] if single else tuple(res)

    # local_map reads a list as one output's placements, a tuple as several
    outp = list(outs[0]) if single else tuple(list(pl) for pl in outs)
    return local_map(body, out_placements=outp, in_placements=in_placements,
                     in_grad_placements=grad, device_mesh=mesh,
                     redistribute_inputs=True)


class _ScaleGrad(torch.autograd.Function):
    """y as it is, its gradient divided by n."""

    @staticmethod
    def forward(ctx, y, n):
        ctx.n = n
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None
