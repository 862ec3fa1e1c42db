"""The LM training path of the port against ``repro``, arch by arch.

For each of the dense, ssm and moe archs (tinyllama-1.1b, olmo-1b,
qwen3-0.6b, granite-34b, mamba2-130m, deepseek-moe-16b,
qwen3-moe-235b-a22b) at its smoke variant, and qwen3's at its own
head_dim of 128 (qk_norm over 128 lanes), in float32 on the CPU,
the port's kernels taking their plain versions: the same init from a key
(no weights carried across), forward logits and ``loss`` rel ≤ 1e-5, the
forward's aux (the MoE router loss; 0 for the others) within 1e-6,
every gradient leaf within 1e-4 of the leaf's largest |g|, ``chunked_ce``
with a mask and a chunk shorter than S (value and the gradient of x),
and one ``sgd`` train step that moves the parameters as JAX's does. Then,
once: the synthetic corpus and its batches bit for bit,
``INPUT_SHAPES`` and ``cfg_for_shape``, and at full size the shapes and
dtypes of ``input_specs`` and ``abstract_params`` against
``jax.eval_shape``. Inputs are numpy from a seed; each arch's JAX values
come from one module fixture with one jit of the loss's gradient.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import shapes as jshapes
from repro.data import tokens as jtokens
from repro.launch import steps as jsteps
from repro.models import decoder as jD
from repro.models import get_config as jax_get_config
from repro.models import get_model as jax_get_model
from repro.models import smoke_variant as jax_smoke_variant
from repro.nn.optim import sgd as jsgd
from repro_torch import prng
from repro_torch.configs import shapes as tshapes
from repro_torch.data import tokens as ttokens
from repro_torch.launch import steps as tsteps
from repro_torch.models import decoder as tD
from repro_torch.models import get_config, get_model, smoke_variant
from repro_torch.nn.optim import sgd as tsgd
from repro_torch.nn.pytree import tree_leaves, tree_unflatten

ARCHS = ["tinyllama-1.1b", "olmo-1b", "qwen3-0.6b", "granite-34b",
         "mamba2-130m", "deepseek-moe-16b", "qwen3-moe-235b-a22b"]
# the fixture's models: each arch's smoke variant, and qwen3's at its own
# head_dim of 128 (the smoke variant narrows it to 32)
HD128 = "qwen3-0.6b@hd128"
# (the hd128 case keeps index 5: MODELS' indices seed the batches)
MODELS = ARCHS[:5] + [HD128] + ARCHS[5:]
TOL = 1e-5
GRAD_TOL = 1e-4
B, S = 2, 32


@pytest.fixture(scope="module", params=MODELS)
def lm(request):
    """Both packages' smoke model of one arch from PRNGKey(0), a batch, and
    JAX's logits, loss and gradients on it."""
    arch = request.param
    cfg_j = jax_smoke_variant(jax_get_config(arch.split("@")[0]))
    cfg_t = smoke_variant(get_config(arch.split("@")[0]))
    if arch == HD128:
        cfg_j, cfg_t = cfg_j.replace(head_dim=128), cfg_t.replace(head_dim=128)
    params_j = jD.init(cfg_j, jax.random.PRNGKey(0))
    params_t = tD.init(cfg_t, prng.PRNGKey(0, "cpu"))
    rng = np.random.default_rng(MODELS.index(arch))
    batch = {"tokens": rng.integers(0, cfg_j.vocab_size, (B, S),
                                    dtype=np.int32),
             "labels": rng.integers(0, cfg_j.vocab_size, (B, S),
                                    dtype=np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits_j, aux_j = jD.forward(cfg_j, params_j, jb)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jD.loss(cfg_j, p, jb)))(params_j)
    return dict(arch=arch, cfg_j=cfg_j, cfg_t=cfg_t, params_j=params_j,
                params_t=params_t, batch=batch, logits_j=np.asarray(logits_j),
                aux_j=float(aux_j), loss_j=float(loss_j), grads_j=grads_j)


def _tbatch(lm):
    return {k: torch.tensor(v) for k, v in lm["batch"].items()}


def test_init_from_a_key_matches_jax(lm):
    leaves_j = jax.tree_util.tree_leaves(lm["params_j"])
    leaves_t = tree_leaves(lm["params_t"])
    assert (jax.tree_util.tree_structure(lm["params_j"]).num_leaves
            == len(leaves_t))
    for a, b in zip(leaves_t, leaves_j):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).split(".")[-1] == b.dtype.name
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-7)


def test_forward_matches_jax(lm):
    got, aux = tD.forward(lm["cfg_t"], lm["params_t"],
                          {"tokens": _tbatch(lm)["tokens"]})
    v = lm["cfg_j"].vocab_size
    want = lm["logits_j"][..., :v]
    assert abs(float(aux) - lm["aux_j"]) <= 1e-6
    assert (float(aux) > 0) == (lm["cfg_t"].family == "moe")
    assert (np.abs(got[..., :v].detach().numpy() - want).max()
            / np.abs(want).max()) <= TOL


def test_loss_and_grads_match_jax(lm):
    leaves = [p.detach().requires_grad_(True)
              for p in tree_leaves(lm["params_t"])]
    loss = tD.loss(lm["cfg_t"], tree_unflatten(lm["params_t"], leaves),
                   _tbatch(lm))
    grads = torch.autograd.grad(loss, leaves)
    want = lm["loss_j"]
    assert abs(float(loss.detach()) - want) <= TOL * abs(want)
    for g, gj in zip(grads, jax.tree_util.tree_leaves(lm["grads_j"])):
        gj = np.asarray(gj)
        scale = max(np.abs(gj).max(), 1e-30)
        assert np.abs(g.numpy() - gj).max() <= GRAD_TOL * scale


def test_chunked_ce_with_mask_matches_jax(lm):
    cfg_j, cfg_t = lm["cfg_j"], lm["cfg_t"]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, cfg_j.d_model)).astype(np.float32)
    labels = lm["batch"]["labels"]
    mask = (rng.random((B, S)) < 0.7).astype(np.float32)
    # a chunk of 12 does not divide 32: the divisor rule takes 8
    want, gx_j = jax.value_and_grad(lambda x_: jD.chunked_ce(
        cfg_j, lm["params_j"], x_, jnp.asarray(labels), jnp.asarray(mask),
        chunk=12))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = tD.chunked_ce(cfg_t, lm["params_t"], xt, torch.tensor(labels),
                        torch.tensor(mask), chunk=12)
    (gx,) = torch.autograd.grad(got, xt)
    assert abs(float(got) - float(want)) <= TOL * abs(float(want))
    gx_j = np.asarray(gx_j)
    assert np.abs(gx.numpy() - gx_j).max() <= GRAD_TOL * np.abs(gx_j).max()
    # no mask: the mean over every position, as loss takes it
    assert abs(float(tD.chunked_ce(cfg_t, lm["params_t"], torch.tensor(x),
                                   torch.tensor(labels), chunk=12))
               - float(jD.chunked_ce(cfg_j, lm["params_j"], jnp.asarray(x),
                                     jnp.asarray(labels), chunk=12))
               ) <= TOL * float(want)


def test_sgd_train_step_matches_jax(lm):
    cfg_j, cfg_t = lm["cfg_j"], lm["cfg_t"]
    step_j = jsteps.make_train_step(cfg_j, jax_get_model(cfg_j),
                                    jsgd(0.5), None)
    step_t = tsteps.make_train_step(cfg_t, get_model(cfg_t), tsgd(0.5))
    jb = {k: jnp.asarray(v) for k, v in lm["batch"].items()}
    pj, _, lj = step_j(lm["params_j"], jsgd(0.5).init(lm["params_j"]), jb,
                       jnp.asarray(0, jnp.int32))
    pt, _, lt = step_t(lm["params_t"], tsgd(0.5).init(lm["params_t"]),
                       _tbatch(lm), 0)
    assert abs(float(lt) - float(lj)) <= TOL * abs(float(lj))
    moved = 0
    for new, old, want in zip(tree_leaves(pt), tree_leaves(lm["params_t"]),
                              jax.tree_util.tree_leaves(pj)):
        want = np.asarray(want)
        moved += int(not torch.equal(new, old))
        np.testing.assert_allclose(new.numpy(), want, rtol=TOL, atol=TOL)
    assert moved > len(tree_leaves(pt)) // 2


def test_corpus_and_batches_bit_equal():
    for n, vocab, seed in ((100_000, 512, 0), (5_000, 151_936, 7)):
        cj = jtokens.synthetic_corpus(n, vocab, seed=seed)
        ct = ttokens.synthetic_corpus(n, vocab, seed=seed, device="cpu")
        assert ct.dtype == torch.int32
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        for bj, bt in zip(jtokens.lm_batches(cj, 4, 64, 3, seed=seed + 1),
                          ttokens.lm_batches(ct, 4, 64, 3, seed=seed + 1)):
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(bt[k].numpy(),
                                              np.asarray(bj[k]))


def test_input_shapes_and_cfg_for_shape_equal():
    assert ({k: dataclasses.astuple(v)
             for k, v in tshapes.INPUT_SHAPES.items()}
            == {k: dataclasses.astuple(v)
                for k, v in jshapes.INPUT_SHAPES.items()})
    for arch in ARCHS + ["hymba-1.5b"]:
        cj, ct = jax_get_config(arch), get_config(arch)
        assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
        for name in tshapes.INPUT_SHAPES:
            sj, st = jshapes.shape_for(name), tshapes.shape_for(name)
            assert (tshapes.needs_sliding_window(ct, st)
                    == jshapes.needs_sliding_window(cj, sj))
            assert (tshapes.supports_shape(ct, st)
                    == jshapes.supports_shape(cj, sj))
            assert (dataclasses.asdict(tshapes.cfg_for_shape(ct, name))
                    == dataclasses.asdict(jshapes.cfg_for_shape(cj, name)))


def _same_specs(got, want):
    leaves_t, leaves_j = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(leaves_t) == len(leaves_j)
    for a, b in zip(leaves_t, leaves_j):
        assert a.device.type == "meta"
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).split(".")[-1] == b.dtype.name


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_abstract_params_match_eval_shape(arch):
    cj, ct = jax_get_config(arch), get_config(arch)
    _same_specs(tsteps.abstract_params(ct, get_model(ct)),
                jsteps.abstract_params(cj, jax_get_model(cj)))
    _same_specs(tsteps.abstract_cache(ct, get_model(ct), 4, 64),
                jsteps.abstract_cache(cj, jax_get_model(cj), 4, 64))
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        _same_specs(tsteps.input_specs(ct, tshapes.shape_for(name)),
                    jsteps.input_specs(cj, jshapes.shape_for(name)))
