"""Port hybrid decoder (hymba-1.5b, smoke variant) vs the JAX package.

JAX's parameters are carried into the port with ``convert``, inputs are
made with numpy, and both run in one process on the CPU (the port's
kernels take their plain versions there). f32 throughout: blocks,
``nn.common`` and decode steps ≤ 1e-5; forward logits rel ≤ 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.models import blocks as jB
from repro.models import decoder as jD
from repro.models import get_config as jax_get_config
from repro.models import smoke_variant as jax_smoke_variant
from repro.nn import common as jC
from repro_torch import prng
from repro_torch.convert import params_from_jax
from repro_torch.models import blocks as tB
from repro_torch.models import decoder as tD
from repro_torch.models import get_config, get_model, smoke_variant
from repro_torch.nn import common as tC
from repro_torch.nn.pytree import tree_leaves, tree_map

TOL = 1e-5


@pytest.fixture(scope="module")
def smoke():
    """(JAX cfg, port cfg, JAX params, the same params in the port)."""
    cfg_j = jax_smoke_variant(jax_get_config("hymba-1.5b"))
    cfg_t = smoke_variant(get_config("hymba-1.5b"))
    params_j = jD.init(cfg_j, jax.random.PRNGKey(0))
    params_t = params_from_jax(jax.tree_util.tree_map(np.asarray, params_j),
                               device="cpu")
    return cfg_j, cfg_t, params_j, params_t


def _err(got, want) -> float:
    return float(np.abs(got.detach().numpy() - np.asarray(want)).max())


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _layer(params_j, params_t, seg: int, i: int = 0):
    return (jax.tree_util.tree_map(lambda a: a[i],
                                   params_j["segments"][seg]),
            tree_map(lambda a: a[i], params_t["segments"][seg]))


def test_common_matches_jax():
    x, s, b = _x((2, 5, 64), 1), _x((64,), 2), _x((64,), 3)
    assert _err(tC.rms_norm(torch.tensor(x), torch.tensor(s)),
                jC.rms_norm(jnp.asarray(x), jnp.asarray(s))) <= TOL
    assert _err(tC.layer_norm(torch.tensor(x), torch.tensor(s),
                              torch.tensor(b)),
                jC.layer_norm(jnp.asarray(x), jnp.asarray(s),
                              jnp.asarray(b))) <= TOL
    pos = np.arange(40, dtype=np.int32)[None].repeat(2, 0)
    cos_j, sin_j = jC.rope_angles(jnp.asarray(pos), 64, 10000.0)
    cos_t, sin_t = tC.rope_angles(torch.tensor(pos), 64, 10000.0)
    assert _err(cos_t, cos_j) <= TOL and _err(sin_t, sin_j) <= TOL
    q = _x((2, 40, 4, 64), 4)
    assert _err(tC.apply_rope(torch.tensor(q), cos_t, sin_t),
                jC.apply_rope(jnp.asarray(q), cos_j, sin_j)) <= TOL
    w = [_x(sh, 5 + i, 0.1) for i, sh in enumerate([(64, 96), (64, 96),
                                                   (96, 64)])]
    assert _err(tC.swiglu(torch.tensor(x), *map(torch.tensor, w)),
                jC.swiglu(jnp.asarray(x), *map(jnp.asarray, w))) <= TOL


def test_segment_plan_matches_jax(smoke):
    cfg_j, cfg_t = smoke[:2]
    for cj, ct in ((jax_get_config("hymba-1.5b"), get_config("hymba-1.5b")),
                   (cfg_j, cfg_t)):
        assert ([tuple(vars(s).values()) for s in tD.segment_plan(ct)]
                == [tuple(vars(s).values()) for s in jD.segment_plan(cj)])
    full = tD.segment_plan(get_config("hymba-1.5b"))
    assert [(s.n_layers, s.window) for s in full] == [
        (1, 0), (14, 1024), (1, 0), (15, 1024), (1, 0)]


@pytest.mark.parametrize("seg", [0, 1], ids=["global", "window16"])
def test_attn_apply_matches_jax(smoke, seg):
    cfg_j, cfg_t, params_j, params_t = smoke
    lj, lt = _layer(params_j, params_t, seg)
    window = jD.segment_plan(cfg_j)[seg].window
    x = _x((2, 40, cfg_j.d_model), 7)
    pos = np.arange(40, dtype=np.int32)[None].repeat(2, 0)
    want = jB.attn_apply(lj["attn"], cfg_j, jnp.asarray(x), jnp.asarray(pos),
                         window=window)
    got = tB.attn_apply(lt["attn"], cfg_t, torch.tensor(x), torch.tensor(pos),
                        window=window)
    assert _err(got, want) <= TOL


def test_ssm_and_ffn_apply_match_jax(smoke):
    cfg_j, cfg_t, params_j, params_t = smoke
    lj, lt = _layer(params_j, params_t, 1)
    x = _x((2, 40, cfg_j.d_model), 8)
    assert _err(tB.ssm_apply(lt["ssm"], cfg_t, torch.tensor(x)),
                jB.ssm_apply(lj["ssm"], cfg_j, jnp.asarray(x))) <= TOL
    assert _err(tB.ffn_apply(lt["ffn"], torch.tensor(x)),
                jB.ffn_apply(lj["ffn"], jnp.asarray(x))) <= TOL


def test_block_decode_matches_jax(smoke):
    """attn_decode (ring cache of 8 slots under window 16: wraps) and
    ssm_decode, 10 steps from empty caches."""
    cfg_j, cfg_t, params_j, params_t = smoke
    lj, lt = _layer(params_j, params_t, 1)
    B = 2
    ac_j = jB.attn_cache_init(cfg_j, None, B, 8, jnp.float32)
    ac_t = tB.attn_cache_init(cfg_t, None, B, 8, torch.float32, "cpu")
    sc_j = jB.ssm_cache_init(cfg_j, None, B, jnp.float32)
    sc_t = tB.ssm_cache_init(cfg_t, None, B, torch.float32, "cpu")
    for t in range(10):
        x = _x((B, 1, cfg_j.d_model), 20 + t)
        pos = np.full((B,), t, np.int32)
        ya, ac_j = jB.attn_decode(lj["attn"], cfg_j, jnp.asarray(x),
                                  jnp.asarray(pos), ac_j, window=16)
        yb, ac_t = tB.attn_decode(lt["attn"], cfg_t, torch.tensor(x),
                                  torch.tensor(pos), ac_t, window=16)
        assert _err(yb, ya) <= TOL
        ya, sc_j = jB.ssm_decode(lj["ssm"], cfg_j, jnp.asarray(x), sc_j)
        yb, sc_t = tB.ssm_decode(lt["ssm"], cfg_t, torch.tensor(x), sc_t)
        assert _err(yb, ya) <= TOL
    for k in ("k", "v", "pos"):
        assert _err(ac_t[k], ac_j[k]) <= TOL
    assert _err(sc_t["state"], sc_j["state"]) <= TOL


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S),
                                                dtype=np.int32)


def test_forward_matches_jax(smoke):
    cfg_j, cfg_t, params_j, params_t = smoke
    tokens = _tokens(cfg_j, 2, 40, 9)
    want, _ = jD.forward(cfg_j, params_j, {"tokens": jnp.asarray(tokens)})
    got, aux = tD.forward(cfg_t, params_t, {"tokens": torch.tensor(tokens)})
    want = np.asarray(want)
    assert got.shape == want.shape and float(aux) == 0.0
    real = slice(0, cfg_j.vocab_size)
    scale = np.abs(want[..., real]).max()
    assert _err(got[..., real], want[..., real]) / scale <= TOL
    assert bool((got[..., cfg_j.vocab_size:] == tB.NEG_INF).all())


def test_decode_steps_match_jax(smoke):
    """12 decode steps from empty caches: logits and every cache leaf."""
    cfg_j, cfg_t, params_j, params_t = smoke
    B, S = 2, 12
    tokens = _tokens(cfg_j, B, S, 10)
    cache_j = jD.init_cache(cfg_j, B, S)
    cache_t = tD.init_cache(cfg_t, B, S, device="cpu")
    for t in range(S):
        pos = np.full((B,), t, np.int32)
        lj, cache_j = jD.decode_step(cfg_j, params_j, cache_j, {
            "token": jnp.asarray(tokens[:, t]), "pos": jnp.asarray(pos)})
        lt, cache_t = tD.decode_step(cfg_t, params_t, cache_t, {
            "token": torch.tensor(tokens[:, t]), "pos": torch.tensor(pos)})
        assert _err(lt[:, :cfg_j.vocab_size],
                    np.asarray(lj)[:, :cfg_j.vocab_size]) <= TOL
    for a, b in zip(tree_leaves(cache_t),
                    jax.tree_util.tree_leaves(cache_j)):
        assert _err(a, b) <= TOL


def test_init_cache_shapes_match_jax(smoke):
    cfg_j, cfg_t = smoke[:2]
    for cj, ct in ((cfg_j, cfg_t),
                   (jax_get_config("hymba-1.5b"), get_config("hymba-1.5b"))):
        want = jax.eval_shape(lambda: jD.init_cache(cj, 4, 48))
        got = tD.init_cache(ct, 4, 48, device="meta")
        for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
            assert tuple(a.shape) == b.shape
            assert str(a.dtype).split(".")[-1] == b.dtype.name


def test_init_matches_jax_structure(smoke):
    """The port's init gives JAX's tree, shapes and dtypes at the smoke
    size and, on the meta device, at full size (1.64 B parameters); the
    values are JAX's too (``tests/test_torch_init.py``). The ModelApi's
    loss is the decoder's, JAX's loss on the same weights and batch."""
    cfg_j, cfg_t, params_j, _ = smoke
    got = tD.init(cfg_t, prng.PRNGKey(0, device="cpu"))
    assert (jax.tree_util.tree_structure(jax.tree_util.tree_map(
        np.asarray, params_j)) == jax.tree_util.tree_structure(
            tree_map(lambda a: a.numpy(), got)))
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(params_j)):
        assert tuple(a.shape) == b.shape
    full_j = jax.eval_shape(lambda: jD.init(jax_get_config("hymba-1.5b"),
                                            jax.random.PRNGKey(0)))
    n = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(full_j))
    assert 1.6e9 < n < 1.7e9
    api = get_model(cfg_t)
    assert api.init is tD.init and api.decode_step is tD.decode_step
    assert api.loss is tD.loss
    tokens = _tokens(cfg_j, 2, 24, 11)
    labels = _tokens(cfg_j, 2, 24, 12)
    want = float(jD.loss(cfg_j, params_j, {"tokens": jnp.asarray(tokens),
                                           "labels": jnp.asarray(labels)}))
    got = float(api.loss(cfg_t, smoke[3], {"tokens": torch.tensor(tokens),
                                           "labels": torch.tensor(labels)}))
    assert abs(got - want) <= TOL * abs(want)
