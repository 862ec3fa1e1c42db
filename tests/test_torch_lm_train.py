"""The LM launcher, the in-graph LLM round and the federated-LLM twin.

* ``repro_torch.launch.train.main`` against ``repro.launch.train.main``
  on the same argv (qwen3-0.6b, mamba2-130m and deepseek-moe-16b smoke,
  3 adamw steps on the synthetic corpus; the MoE loss carries the router
  aux term): every step's loss rel ≤ 1e-4.
* ``core.dist.make_fl_round`` with a smoke qwen3-0.6b client (a decoder,
  whose loss has no client axis: the port loops over the rows) against
  JAX's round under none, otp and secagg, two sim rounds from the same
  key on the same batches, mask, pad seeds and weights: params ≤ 1e-5.
* ``repro_torch.examples.llm_federated`` on the CPU under otp and
  otp_gather (whose aggregator's MAC check must pass).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import SatQFLConfig as JConfig
from repro.core import dist as jdist
from repro.launch import train as jtrain
from repro.models import get_config as jax_get_config
from repro.models import get_model as jax_get_model
from repro.models import smoke_variant as jax_smoke_variant
from repro.nn.optim import sgd as jsgd
from repro_torch import prng
from repro_torch.core import SatQFLConfig
from repro_torch.core import dist as tdist
from repro_torch.examples import llm_federated
from repro_torch.launch import train as ttrain
from repro_torch.models import get_config, get_model, smoke_variant
from repro_torch.nn.optim import sgd
from repro_torch.nn.pytree import tree_leaves

LOSS_RTOL = 1e-4
PARAM_TOL = 1e-5
N_SATS, E, B, S, ROUNDS = 3, 2, 2, 16, 2


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-130m",
                                  "deepseek-moe-16b"])
def test_lm_launcher_matches_jax(arch, monkeypatch):
    argv = ["--arch", arch, "--smoke", "--steps", "3", "--batch", "2",
            "--seq", "32"]
    want = []
    run_lm = jtrain.run_lm
    monkeypatch.setattr(jtrain, "run_lm", lambda a: want.extend(run_lm(a)))
    jtrain.main(argv)
    got = ttrain.main(argv + ["--device", "cpu"])
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]


@pytest.fixture(scope="module")
def llm_round():
    """Both packages' smoke qwen3, the round's inputs, and a runner."""
    cfg_j = jax_smoke_variant(jax_get_config("qwen3-0.6b"))
    cfg_t = smoke_variant(get_config("qwen3-0.6b"))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg_j.vocab_size, (ROUNDS, N_SATS, E, B, S + 1),
                          dtype=np.int32)
    batches = [{"tokens": t[..., :-1], "labels": t[..., 1:]} for t in tokens]
    seeds = rng.integers(0, 2 ** 32, (ROUNDS, N_SATS), dtype=np.uint32)
    weights = rng.uniform(1.0, 3.0, (N_SATS,)).astype(np.float32)
    mask = np.ones((N_SATS,), np.float32)
    return cfg_j, cfg_t, batches, seeds, weights, mask


@pytest.mark.parametrize("security", ["none", "otp", "secagg"])
def test_llm_round_matches_jax(llm_round, security):
    cfg_j, cfg_t, batches, seeds, weights, mask = llm_round
    fl_j = JConfig(mode="sim", n_rounds=ROUNDS, local_steps=E,
                   batch_size=B, lr=5e-2)
    fl_t = SatQFLConfig(mode="sim", n_rounds=ROUNDS, local_steps=E,
                        batch_size=B, lr=5e-2)
    api_j, api_t = jax_get_model(cfg_j), get_model(cfg_t)
    state_j = jdist.fl_init_state(cfg_j, api_j, jsgd(fl_j.lr), N_SATS,
                                  jax.random.PRNGKey(0))
    state_t = tdist.fl_init_state(cfg_t, api_t, sgd(fl_t.lr), N_SATS,
                                  prng.PRNGKey(0, "cpu"))
    round_j = jax.jit(jdist.make_fl_round(cfg_j, api_j, fl_j, jsgd(fl_j.lr),
                                          N_SATS, security=security))
    round_t = tdist.make_fl_round(cfg_t, api_t, fl_t, sgd(fl_t.lr), N_SATS,
                                  security=security)
    for r in range(ROUNDS):
        state_j, m_j = round_j(
            state_j, {k: jnp.asarray(v) for k, v in batches[r].items()},
            jnp.asarray(mask), jnp.asarray(seeds[r]), jnp.asarray(weights))
        state_t, m_t = round_t(
            state_t, {k: torch.tensor(v) for k, v in batches[r].items()},
            torch.tensor(mask), torch.tensor(seeds[r].astype(np.int64)),
            torch.tensor(weights))
        assert abs(float(m_t["loss"]) - float(m_j["loss"])) <= (
            PARAM_TOL * abs(float(m_j["loss"])))
    for a, b in zip(tree_leaves(state_t.params),
                    jax.tree_util.tree_leaves(state_j.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=PARAM_TOL)
    # every satellite holds the aggregate
    for a in tree_leaves(state_t.params):
        assert torch.equal(a, a[:1].expand_as(a))


@pytest.mark.parametrize("security", ["otp", "otp_gather"])
def test_llm_federated_twin_runs_on_cpu(security):
    out = llm_federated.main(["--device", "cpu", "--rounds", "2",
                              "--security", security])
    rounds = out["rounds"]
    assert len(rounds) == 2
    for m in rounds:
        assert all(np.isfinite(m[k]) for k in ("local_loss",
                                                "global_eval_loss"))
        assert m["local_loss"] < 10.0
        if security == "otp_gather":
            assert m["mac_ok"] is True
    assert rounds[1]["global_eval_loss"] < rounds[0]["global_eval_loss"]
