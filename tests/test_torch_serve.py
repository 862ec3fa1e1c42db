"""Port serving entry points vs the JAX package (the hymba-1.5b smoke
variant, and the MoE archs' smoke variants).

JAX's parameters are carried into the port with ``convert`` (the MoE
models are the port's own from the same key); prompts come from each
package's own threefry ``randint`` (bit-equal). Greedy ``generate`` must
give the same tokens, and the prefill step the same next-token logits
(rel ≤ 1e-5, float32, CPU).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.launch.serve import generate as jax_generate
from repro.launch.steps import make_prefill_step as jax_make_prefill_step
from repro.models import get_config as jax_get_config
from repro.models import get_model as jax_get_model
from repro.models import smoke_variant as jax_smoke_variant
from repro_torch import prng
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import get_config, get_model, smoke_variant

B, P, GEN = 2, 8, 10


@pytest.fixture(scope="module")
def setup():
    cfg_j = jax_smoke_variant(jax_get_config("hymba-1.5b"))
    api_j = jax_get_model(cfg_j)
    key = jax.random.PRNGKey(0)
    params_j = api_j.init(cfg_j, key)
    prompts_j = jax.random.randint(jax.random.fold_in(key, 1), (B, P), 0,
                                   cfg_j.vocab_size)
    cfg_t = smoke_variant(get_config("hymba-1.5b"))
    params_t = params_from_jax(jax.tree_util.tree_map(np.asarray, params_j),
                               device="cpu")
    prompts_t = prng.randint(prng.fold_in(prng.PRNGKey(0, device="cpu"), 1),
                             (B, P), 0, cfg_t.vocab_size)
    return cfg_j, api_j, params_j, prompts_j, cfg_t, params_t, prompts_t


def test_generate_matches_jax_tokens(setup):
    cfg_j, api_j, params_j, prompts_j, cfg_t, params_t, prompts_t = setup
    np.testing.assert_array_equal(prompts_t.numpy(), np.asarray(prompts_j))
    want = jax_generate(cfg_j, api_j, params_j, prompts_j, GEN,
                        cache_len=P + GEN)
    got = serve.generate(cfg_t, get_model(cfg_t), params_t, prompts_t, GEN,
                         cache_len=P + GEN)
    assert got.dtype == torch.int32 and got.shape == (B, P + GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_step_matches_jax(setup):
    cfg_j, api_j, params_j, prompts_j, cfg_t, params_t, prompts_t = setup
    want = np.asarray(jax_make_prefill_step(cfg_j, api_j, None)(
        params_j, {"tokens": prompts_j}))[:, :cfg_j.vocab_size]
    got = make_prefill_step(cfg_t, get_model(cfg_t))(
        params_t, {"tokens": prompts_t})[:, :cfg_t.vocab_size]
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() <= 1e-5


def test_make_decode_step_matches_the_api(setup):
    cfg_t, params_t, prompts_t = setup[4:]
    api = get_model(cfg_t)
    cache = api.init_cache(cfg_t, B, 4, device="cpu")
    batch = {"token": prompts_t[:, 0],
             "pos": torch.zeros((B,), dtype=torch.int32)}
    a, _ = make_decode_step(cfg_t, api)(params_t, cache, batch)
    b, _ = api.decode_step(cfg_t, params_t, cache, batch)
    assert torch.equal(a, b)


def test_serve_main_runs_on_the_cpu(capsys):
    serve.main(["--device", "cpu", "--requests", "2", "--prompt-len", "4",
                "--gen", "3"])
    out = capsys.readouterr().out
    assert "hymba-1.5b: 2 requests, 3 new tokens" in out
    assert "output shapes + token ranges OK" in out



@pytest.fixture(scope="module", params=["deepseek-moe-16b",
                                        "qwen3-moe-235b-a22b"])
def moe_setup(request):
    """Both packages' smoke MoE model from PRNGKey(0), each drawn by its
    own package, and each package's prompts."""
    cfg_j = jax_smoke_variant(jax_get_config(request.param))
    api_j = jax_get_model(cfg_j)
    key = jax.random.PRNGKey(0)
    params_j = api_j.init(cfg_j, key)
    prompts_j = jax.random.randint(jax.random.fold_in(key, 1), (B, P), 0,
                                   cfg_j.vocab_size)
    cfg_t = smoke_variant(get_config(request.param))
    tkey = prng.PRNGKey(0, device="cpu")
    params_t = get_model(cfg_t).init(cfg_t, tkey)
    prompts_t = prng.randint(prng.fold_in(tkey, 1), (B, P), 0,
                             cfg_t.vocab_size)
    return cfg_j, api_j, params_j, prompts_j, cfg_t, params_t, prompts_t


def test_moe_generate_matches_jax_tokens(moe_setup):
    cfg_j, api_j, params_j, prompts_j, cfg_t, params_t, prompts_t = moe_setup
    np.testing.assert_array_equal(prompts_t.numpy(), np.asarray(prompts_j))
    want = jax_generate(cfg_j, api_j, params_j, prompts_j, GEN,
                        cache_len=P + GEN)
    got = serve.generate(cfg_t, get_model(cfg_t), params_t, prompts_t, GEN,
                         cache_len=P + GEN)
    assert got.dtype == torch.int32 and got.shape == (B, P + GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_moe_prefill_step_matches_jax(moe_setup):
    cfg_j, api_j, params_j, prompts_j, cfg_t, params_t, prompts_t = moe_setup
    want = np.asarray(jax_make_prefill_step(cfg_j, api_j, None)(
        params_j, {"tokens": prompts_j}))[:, :cfg_j.vocab_size]
    got = make_prefill_step(cfg_t, get_model(cfg_t))(
        params_t, {"tokens": prompts_t})[:, :cfg_t.vocab_size]
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() <= 1e-5


def test_serve_main_runs_moe_on_the_cpu(capsys):
    serve.main(["--arch", "deepseek-moe-16b", "--smoke", "--device", "cpu",
                "--requests", "2", "--prompt-len", "4", "--gen", "3"])
    out = capsys.readouterr().out
    assert "deepseek-moe-16b: 2 requests, 3 new tokens" in out
    assert "output shapes + token ranges OK" in out
