"""The MoE layer of the port (``repro_torch.models.blocks``) against
``repro``'s, and the slab draws of ``nn.init``.

At the smoke variants of deepseek-moe-16b (4 experts top-2, one shared
expert) and qwen3-moe-235b-a22b (no shared expert), in float32 on the
CPU: ``moe_init`` from a key equal to JAX's; ``_moe_local`` at capacity
factors 0.25 (tokens drop) and 16 with the routed ``idx``, ``keep`` and
``target`` equal to the arrays JAX's routing computes (``lax.top_k``,
the one-hot running count), the output rel ≤ 1e-6 and the aux within
1e-6; ``_moe_local_dynamic`` on each half of the experts; ``moe_apply``
and its gradients (1e-4 of each leaf's largest |g|); decode against the
teacher-forced forward at capacity 16 (tests/test_decode_parity.py's
contract); a tight capacity changes the output; a mesh ctx takes JAX's
expert-parallel branch.
Then the slab draws: a leaf filled 7 elements at a time is the one-shot
draw bit for bit, the words across the 2^32 counter boundary are the
threefry of their (hi, lo) words, and a leaf of deepseek's stacked
experts' size inits on ``meta`` without drawing. Inputs are numpy from a seed;
each arch's JAX values come from one module fixture.
"""
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax._src.prng import threefry_2x32 as jax_threefry_2x32

from repro.models import blocks as jB
from repro.models import get_config as jax_get_config
from repro.models import smoke_variant as jax_smoke_variant
from repro_torch import prng
from repro_torch.models import blocks as tB
from repro_torch.models import get_config, get_model, smoke_variant
from repro_torch.nn import init as tinit
from repro_torch.nn.pytree import tree_leaves, tree_unflatten

ARCHS = ["deepseek-moe-16b", "qwen3-moe-235b-a22b"]
CAPS = [0.25, 16.0]
T = 48                       # tokens of the _moe_local checks
B, S = 2, 24                 # moe_apply's batch
TOL = 1e-6
GRAD_TOL = 1e-4


def _jax_slots(x, router, cfg, e_off, e_num):
    """JAX's routing arrays, computed as ``repro``'s ``_moe_local`` does."""
    T_, E, k = x.shape[0], cfg.n_experts, cfg.n_experts_per_tok
    probs = jax.nn.softmax(jnp.einsum("td,de->te", x, router), axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    cap = max(int(cfg.capacity_factor * T_ * k / E), 4)
    a = idx.reshape(T_ * k)
    local = (a >= e_off) & (a < e_off + e_num)
    e_loc = jnp.where(local, a - e_off, e_num)
    onehot = jax.nn.one_hot(e_loc, e_num + 1, dtype=jnp.int32)
    slot = jnp.sum(jnp.cumsum(onehot, axis=0) * onehot, axis=1) - 1
    keep = local & (slot < cap) & (slot >= 0)
    target = jnp.where(keep, e_loc * cap + slot, e_num * cap)
    return cap, np.asarray(idx), np.asarray(keep), np.asarray(target)


def _apply_loss_j(cfg, w):
    return lambda p, x: (lambda y, aux: jnp.sum(y * w) + aux)(
        *jB.moe_apply(p, cfg, x))


@pytest.fixture(scope="module", params=ARCHS)
def moe(request):
    """Both packages' MoE parameters of one smoke arch from PRNGKey(5)
    (L=None), the inputs, and JAX's ``_moe_local`` at each capacity, its
    ``_moe_local_dynamic`` on each half of the experts and ``moe_apply``'s
    value and gradients."""
    arch = request.param
    cfg_j = jax_smoke_variant(jax_get_config(arch))
    cfg_t = smoke_variant(get_config(arch))
    p_j = jB.moe_init(jax.random.PRNGKey(5), cfg_j, None, jnp.float32)
    p_t = tB.moe_init(prng.PRNGKey(5, "cpu"), cfg_t, None, torch.float32)
    rng = np.random.default_rng(ARCHS.index(arch))
    d = cfg_j.d_model
    x = rng.standard_normal((T, d)).astype(np.float32)
    x3 = rng.standard_normal((B, S, d)).astype(np.float32)
    w = rng.standard_normal((B, S, d)).astype(np.float32)
    local = {}
    for cf in CAPS:
        c = cfg_j.replace(capacity_factor=cf)
        local[cf] = jax.jit(lambda p, x_, c=c: jB._moe_local(
            x_, p, c, 0, c.n_experts, 1))(p_j, x)
    half = cfg_j.n_experts // 2
    dyn_fn = jax.jit(lambda p, x_, off: jB._moe_local_dynamic(
        x_, p, cfg_j, off, half))
    dynamic = {}
    for off in (0, half):
        p_l = {k: (v if k == "router" else v[off:off + half])
               for k, v in p_j.items() if k != "shared"}
        dynamic[off] = dyn_fn(p_l, x, jnp.int32(off))
    y_j, aux_j = jB.moe_apply(p_j, cfg_j, jnp.asarray(x3))
    grads_j = jax.jit(jax.grad(_apply_loss_j(cfg_j, jnp.asarray(w)),
                               argnums=(0, 1)))(p_j, jnp.asarray(x3))
    return dict(arch=arch, cfg_j=cfg_j, cfg_t=cfg_t, p_j=p_j, p_t=p_t, x=x,
                x3=x3, w=w, local=local, dynamic=dynamic, half=half,
                y_j=np.asarray(y_j), aux_j=float(aux_j), grads_j=grads_j)


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def test_moe_init_from_a_key_matches_jax(moe):
    assert ("shared" in moe["p_t"]) == bool(moe["cfg_t"].n_shared_experts)
    leaves_j = jax.tree_util.tree_leaves(moe["p_j"])
    leaves_t = tree_leaves(moe["p_t"])
    assert len(leaves_t) == len(leaves_j)
    for a, b in zip(leaves_t, leaves_j):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).split(".")[-1] == b.dtype.name
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-7)
    # stacked over layers, in bf16 (the router stays float32)
    L = 2
    sj = jB.moe_init(jax.random.PRNGKey(6), moe["cfg_j"], L, jnp.bfloat16)
    st = tB.moe_init(prng.PRNGKey(6, "cpu"), moe["cfg_t"], L, torch.bfloat16)
    for a, b in zip(tree_leaves(st), jax.tree_util.tree_leaves(sj)):
        assert tuple(a.shape) == b.shape and a.shape[0] == L
        assert str(a.dtype).split(".")[-1] == b.dtype.name
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), rtol=1e-2,
                                   atol=1e-6)


@pytest.mark.parametrize("cf", CAPS)
def test_moe_local_matches_jax(moe, cf):
    cfg_t = moe["cfg_t"].replace(capacity_factor=cf)
    cfg_j = moe["cfg_j"].replace(capacity_factor=cf)
    E = cfg_t.n_experts
    xt = torch.tensor(moe["x"])
    gate, idx, _ = tB._moe_route(xt, moe["p_t"]["router"], cfg_t)
    cap, keep, target = tB._moe_slots(idx, cfg_t, 0, E)
    cap_j, idx_j, keep_j, target_j = _jax_slots(
        jnp.asarray(moe["x"]), moe["p_j"]["router"], cfg_j, 0, E)
    assert cap == cap_j
    np.testing.assert_array_equal(idx.numpy(), idx_j)
    np.testing.assert_array_equal(keep.numpy(), keep_j)
    np.testing.assert_array_equal(target.numpy(), target_j)
    # top-k largest first, the gates renormalised
    assert bool((gate[:, :-1] >= gate[:, 1:]).all())
    torch.testing.assert_close(gate.sum(-1), torch.ones(T), rtol=0,
                               atol=1e-6)
    # a tight capacity drops slots, a loose one none
    assert (not keep.all()) if cf < 1 else bool(keep.all())
    out, aux = tB._moe_local(xt, moe["p_t"], cfg_t, 0, E, 1)
    out_j, aux_j = moe["local"][cf]
    assert _rel(out.numpy(), out_j) <= TOL
    assert abs(float(aux) - float(aux_j)) <= TOL


def test_top_k_ties_take_the_lower_expert_first():
    cfg = smoke_variant(get_config("qwen3-moe-235b-a22b"))
    router = torch.zeros((3, cfg.n_experts))
    router[0, 3] = router[1, 1] = 1.0        # experts 1 and 3 tie high
    xt = torch.tensor([[1.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    _, idx, _ = tB._moe_route(xt, router, cfg)
    _, idx_j = jax.lax.top_k(jax.nn.softmax(jnp.asarray(
        (xt @ router).numpy()), axis=-1), cfg.n_experts_per_tok)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    assert idx.tolist() == [[1, 3], [0, 1]]


@pytest.mark.parametrize("which", ["low", "high"])
def test_moe_local_dynamic_matches_jax(moe, which):
    half = moe["half"]
    off = 0 if which == "low" else half
    p_l = {k: (v if k == "router" else v[off:off + half])
           for k, v in moe["p_t"].items() if k != "shared"}
    out, aux = tB._moe_local_dynamic(torch.tensor(moe["x"]), p_l,
                                     moe["cfg_t"], torch.tensor(off), half)
    out_j, aux_j = moe["dynamic"][off]
    assert _rel(out.numpy(), out_j) <= TOL
    assert abs(float(aux) - float(aux_j)) <= TOL


def test_moe_apply_and_grads_match_jax(moe):
    cfg_t = moe["cfg_t"]
    leaves = [p.detach().requires_grad_(True)
              for p in tree_leaves(moe["p_t"])]
    p = tree_unflatten(moe["p_t"], leaves)
    x3 = torch.tensor(moe["x3"], requires_grad=True)
    y, aux = tB.moe_apply(p, cfg_t, x3)
    assert _rel(y.detach().numpy(), moe["y_j"]) <= TOL
    assert abs(float(aux.detach()) - moe["aux_j"]) <= TOL
    loss = torch.sum(y * torch.tensor(moe["w"])) + aux
    grads = torch.autograd.grad(loss, leaves + [x3])
    gp_j, gx_j = moe["grads_j"]
    for g, gj in zip(grads, jax.tree_util.tree_leaves(gp_j) + [gx_j]):
        gj = np.asarray(gj)
        assert g.shape == gj.shape
        assert np.abs(g.numpy() - gj).max() <= GRAD_TOL * max(
            np.abs(gj).max(), 1e-30)


def test_decode_matches_forward_at_capacity_16(moe):
    """Token-by-token decode against the teacher-forced forward (the JAX
    contract of tests/test_decode_parity.py: rel < 2e-3 at capacity 16)."""
    cfg = moe["cfg_t"].replace(capacity_factor=16.0)
    api = get_model(cfg)
    key = prng.PRNGKey(0, "cpu")
    params = api.init(cfg, key)
    Bd, Sd = 2, 12
    tokens = prng.randint(prng.fold_in(key, 1), (Bd, Sd), 0, cfg.vocab_size)
    with torch.no_grad():
        full, aux = api.forward(cfg, params, {"tokens": tokens})
        cache = api.init_cache(cfg, Bd, Sd, device="cpu")
        outs = []
        for t in range(Sd):
            lg, cache = api.decode_step(cfg, params, cache, {
                "token": tokens[:, t],
                "pos": torch.full((Bd,), t, dtype=torch.int32)})
            outs.append(lg)
    assert float(aux) > 0
    dec = torch.stack(outs, dim=1)
    rel = float((dec - full).abs().max() / full.abs().max())
    assert rel < 2e-3


def test_capacity_semantics():
    """At a tight capacity tokens drop and the forward changes (the JAX
    package's ``test_moe_decode_capacity_semantics``)."""
    cfg = smoke_variant(get_config("deepseek-moe-16b")).replace(
        capacity_factor=16.0)
    api = get_model(cfg)
    key = prng.PRNGKey(0, "cpu")
    params = api.init(cfg, key)
    tokens = prng.randint(key, (2, 12), 0, cfg.vocab_size)
    with torch.no_grad():
        hi, _ = api.forward(cfg, params, {"tokens": tokens})
        lo, _ = api.forward(cfg.replace(capacity_factor=0.25), params,
                            {"tokens": tokens})
    assert float((hi - lo).abs().max()) > 1e-6


class _Mesh:
    """The two members ``DistCtx`` reads of a (data, model) DeviceMesh."""

    def __init__(self, data: int, model: int):
        self.mesh_dim_names = ("data", "model")
        self._sizes = (data, model)

    def size(self, dim):
        return self._sizes[dim]


def _jax_branch(B: int, S: int, ds: int, ms: int) -> str:
    """The branch JAX's ``moe_apply`` takes under a mesh of model > 1."""
    T = B * S
    if B % ds == 0 and S % ms == 0 and T // (ds * ms) >= ms:
        return "a2a"
    return "replicated" if T % ds == 0 else "local"


def test_mesh_ctx_raises_naming_12b(moe, monkeypatch):
    """A mesh ctx with model_size > 1 takes expert parallelism by JAX's
    conditions: ``_moe_a2a`` when B, S and the tokens per rank divide,
    ``_moe_replicated_ep`` when the data axes divide T, the local MoE on
    whole tokens otherwise (the three recorded here on stand-ins); a ctx
    without a multi-device mesh takes the single-device branch."""
    from repro_torch.sharding.context import DistCtx
    x3 = torch.tensor(moe["x3"])
    taken = []

    def stand_in(name):
        def run(x, p, cfg, ctx, *a, **kw):
            taken.append(name)
            return torch.zeros_like(x), torch.zeros(())
        return run

    monkeypatch.setattr(tB, "_moe_a2a", stand_in("a2a"))
    monkeypatch.setattr(tB, "_moe_replicated_ep", stand_in("replicated"))
    monkeypatch.setattr(tB, "_moe_local_gathered", stand_in("local"))
    monkeypatch.setattr(tB, "is_dtensor", lambda t: True)
    cases = [(1, 2), (1, 4), (2, 2), (2, 8), (1, 16), (4, 4), (5, 2),
             (3, 2), (7, 4)]
    for ds, ms in cases:
        ctx = DistCtx(mesh=_Mesh(ds, ms))
        y, a = tB.moe_apply(moe["p_t"], moe["cfg_t"], x3, ctx)
        assert taken[-1] == _jax_branch(B, S, ds, ms), (ds, ms)
        assert y.shape == x3.shape
    assert set(taken) == {"a2a", "replicated", "local"}
    monkeypatch.undo()
    # a ctx without a multi-device mesh takes the single-device branch
    y0, a0 = tB.moe_apply(moe["p_t"], moe["cfg_t"], x3)
    for ctx in (types.SimpleNamespace(mesh=None, model_size=1),
                types.SimpleNamespace(mesh=object(), model_size=1)):
        y, a = tB.moe_apply(moe["p_t"], moe["cfg_t"], x3, ctx)
        assert torch.equal(y, y0) and torch.equal(a, a0)


# ---------------------------------------------------------------------------
# slab draws (nn.init)
# ---------------------------------------------------------------------------

def _bits_of(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("init", ["normal", "scaled"])
def test_slab_draws_equal_the_one_shot_draw(init, dtype, monkeypatch):
    key = prng.PRNGKey(11, "cpu")
    shape = (3, 5, 11)                   # 165 elements: 23 slabs and 4
    fn = getattr(tinit, init + "_init")
    whole = fn(key, shape, dtype)
    if init == "normal":
        one_shot = (prng.normal(key, shape) * 0.02).to(dtype)
    else:
        one_shot = (prng.truncated_normal(key, -2.0, 2.0, shape)
                    * (1.0 / math.sqrt(5)) / tinit._TRUNC_STD).to(dtype)
    monkeypatch.setattr(tinit, "SLAB", 7)
    slabs = fn(key, shape, dtype)
    assert slabs.shape == shape and slabs.dtype == dtype
    assert torch.equal(_bits_of(slabs), _bits_of(whole))
    assert torch.equal(_bits_of(slabs), _bits_of(one_shot))


def test_words_across_the_2_32_counter_boundary():
    key = prng.PRNGKey(11, "cpu")
    start = 2 ** 32 - 4
    got = prng.bits(key, (8,), start=start)
    c = np.arange(start, start + 8, dtype=np.uint64)
    hi, lo = (c >> np.uint64(32)).astype(np.int64), (c & np.uint64(
        0xFFFFFFFF)).astype(np.int64)
    assert hi.tolist() == [0] * 4 + [1] * 4
    b1, b2 = prng.threefry2x32(key[0], key[1], torch.tensor(hi),
                               torch.tensor(lo))
    assert torch.equal(got, b1 ^ b2)
    # JAX's own threefry on the same counter words
    y = np.asarray(jax_threefry_2x32(
        jnp.asarray(key.numpy().astype(np.uint32)),
        jnp.asarray(np.concatenate([hi, lo]).astype(np.uint32))))
    np.testing.assert_array_equal(got.numpy(), (y[:8] ^ y[8:]).astype(
        np.int64))
    # an offset inside a small draw is that draw's tail
    np.testing.assert_array_equal(
        prng.bits(key, (5,), start=3).numpy(),
        np.asarray(jax.random.bits(jax.random.PRNGKey(11), (8,)))[3:])
    # and the draws built on the words take the offset alike
    u = prng.uniform(key, (8,), start=start)
    n = prng.normal(key, (8,), start=start)
    assert torch.equal(u[4:], prng.uniform(key, (4,), start=2 ** 32))
    assert torch.equal(n[4:], prng.normal(key, (4,), start=2 ** 32))


@pytest.mark.parametrize("init", ["normal", "scaled"])
def test_slab_draws_on_meta_return_the_empty_leaf(init):
    """On ``meta`` (``steps.abstract_params``) a leaf the size of
    deepseek-moe-16b's stacked experts, 5 B elements, comes back as its
    shape and dtype, drawing nothing; the full model's meta tree against
    ``jax.eval_shape`` is tests/test_torch_lm.py's
    ``test_input_specs_and_abstract_params_match_eval_shape``."""
    shape = (27, 64, 2048, 1408)
    leaf = getattr(tinit, init + "_init")(prng.PRNGKey(0, "meta"), shape,
                                          torch.bfloat16)
    assert leaf.is_meta and tuple(leaf.shape) == shape
    assert leaf.dtype == torch.bfloat16
