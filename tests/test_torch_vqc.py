"""Port VQC, optimizers, local training and data vs the JAX package.

Exact: the VQC init draws, sampled batch indices, synthetic data and
partitions. ≤ 1e-6: states and loss at the ``vqc_satqfl`` shape, and
optimizer updates. ≤ 1e-5: gradients and params after E local steps.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import SatQFLConfig as JaxConfig
from repro.core.localtrain import (
    make_batched_local_train as jax_batched_train,
    sample_local_batches as jax_sample_local_batches,
)
from repro.data import (dirichlet_partition, equal_partition, make_eurosat,
                        make_statlog, server_split)
from repro.models import get_config as jax_get_config
from repro.models import get_model as jax_get_model
from repro.nn import optim as jopt
from repro.quantum import vqc as jvqc
from repro_torch import data as tdata
from repro_torch import prng
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import SatQFLConfig
from repro_torch.core.localtrain import (
    make_batched_local_train, sample_local_batches,
)
from repro_torch.models import get_config, get_model
from repro_torch.nn import optim as topt
from repro_torch.quantum import vqc as tvqc

CFG_J = jax_get_config("vqc-satqfl")
CFG_T = get_config("vqc-satqfl")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(rng, lead, n_feat=8, n_cls=7):
    x = rng.uniform(0, np.pi, lead + (n_feat,)).astype(np.float32)
    y = rng.integers(0, n_cls, lead)
    return x, y


def test_init_is_bit_exact_and_roundtrips():
    pj = jvqc.vqc_init(CFG_J, jax.random.PRNGKey(4))
    pt = tvqc.vqc_init(CFG_T, prng.PRNGKey(4, device="cpu"))
    got = params_to_numpy(pt)
    assert list(got) == sorted(pj)
    for k in pj:
        np.testing.assert_array_equal(np.asarray(pj[k]), got[k])
    back = params_to_numpy(params_from_jax(_np_tree(pj), device="cpu"))
    for k in pj:
        np.testing.assert_array_equal(np.asarray(pj[k]), back[k])


def test_states_logits_loss_at_satqfl_shape():
    """The fused kernel-path circuit at 8 qubits / 3 layers / 7 classes."""
    rng = np.random.default_rng(0)
    pj = jvqc.vqc_init(CFG_J, jax.random.PRNGKey(3))
    pt = params_from_jax(_np_tree(pj), device="cpu")
    x, y = _batch(rng, (16,))
    sj = np.asarray(jvqc._circuit_state_fused(CFG_J, pj, jnp.asarray(x)))
    re, im = tvqc._circuit_planes_fused(
        CFG_T, {k: v[None] for k, v in pt.items()}, torch.tensor(x)[None])
    np.testing.assert_allclose(re[0].numpy(), sj.real, atol=1e-6)
    np.testing.assert_allclose(im[0].numpy(), sj.imag, atol=1e-6)
    lj = np.asarray(jvqc.vqc_logits(CFG_J, pj, jnp.asarray(x)))
    # logits are 3·⟨Z⟩ near ±3, where one float32 ulp is 2.4e-7: measured
    # 1.43e-6 here, the same gap as the JAX package's own fused-vs-per-gate
    # logits on these inputs (summation order of 256 probabilities)
    for fused in (True, False):
        lt = tvqc.vqc_logits(CFG_T, pt, torch.tensor(x), fused=fused).numpy()
        np.testing.assert_allclose(lt, lj, atol=2e-6)
    bj = {"features": jnp.asarray(x), "labels": jnp.asarray(y, jnp.int32)}
    bt = {"features": torch.tensor(x), "labels": torch.tensor(y)}
    np.testing.assert_allclose(float(tvqc.vqc_loss(CFG_T, pt, bt)),
                               float(jvqc.vqc_loss(CFG_J, pj, bj)), atol=1e-6)


def test_client_axis_and_gradients():
    """(K, ...) params give each client its own logits/loss, and one
    backward of the summed losses gives each its jax.grad, ≤ 1e-5."""
    cfg_j = CFG_J.replace(vqc_qubits=5, vqc_layers=2, n_features=5,
                          n_classes=4)
    cfg_t = CFG_T.replace(vqc_qubits=5, vqc_layers=2, n_features=5,
                          n_classes=4)
    K, B = 3, 6
    rng = np.random.default_rng(1)
    pjs = [jvqc.vqc_init(cfg_j, jax.random.PRNGKey(k)) for k in range(K)]
    x, y = _batch(rng, (K, B), n_feat=5, n_cls=4)
    pt = {k: torch.tensor(np.stack([np.asarray(p[k]) for p in pjs]),
                          requires_grad=True) for k in pjs[0]}
    losses = tvqc.vqc_loss(cfg_t, pt, {"features": torch.tensor(x),
                                       "labels": torch.tensor(y)})
    assert losses.shape == (K,)
    losses.sum().backward()
    vg = jax.jit(jax.value_and_grad(lambda p, b: jvqc.vqc_loss(cfg_j, p, b)))
    for k in range(K):
        lj, gj = vg(pjs[k], {"features": jnp.asarray(x[k]),
                             "labels": jnp.asarray(y[k], jnp.int32)})
        np.testing.assert_allclose(float(losses[k]), float(lj), atol=1e-6)
        for name in gj:
            np.testing.assert_allclose(pt[name].grad[k].numpy(),
                                       np.asarray(gj[name]), atol=1e-5)


@pytest.mark.parametrize("name,sched", [
    ("sgd", "const"), ("sgd", "inv_sqrt"), ("momentum", "inv_sqrt"),
    ("adamw", "cosine")])
def test_optimizer_steps(name, sched):
    """Three updates from the same grads, client axis on, ≤ 1e-6."""
    mk = {"const": (lambda m: m.constant_schedule(0.05)),
          "inv_sqrt": (lambda m: m.inv_sqrt_schedule(0.05, warmup=2)),
          "cosine": (lambda m: m.cosine_schedule(0.05, 10, warmup=2))}[sched]
    rng = np.random.default_rng(2)
    p = {"a": rng.normal(size=(3, 4)).astype(np.float32),
         "b": rng.normal(size=(3,)).astype(np.float32)}
    oj, ot = jopt.get_optimizer(name, mk(jopt)), topt.get_optimizer(name,
                                                                    mk(topt))
    pj, pt = jax.tree_util.tree_map(jnp.asarray, p), params_from_jax(p, "cpu")
    sj, st = oj.init(pj), ot.init(pt)
    for step in range(3):
        g = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in p.items()}
        pj, sj = oj.update(jax.tree_util.tree_map(jnp.asarray, g), sj, pj,
                           jnp.asarray(step, jnp.int32))
        pt, st = ot.update(params_from_jax(g, "cpu"), st, pt, step)
    for k in p:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                   atol=1e-6)


def test_sampling_and_local_training_match():
    """Sampled indices are bit-equal and params after E local steps agree
    ≤ 1e-5 between the port's client axis and the JAX client vmap."""
    cfg_j = CFG_J.replace(vqc_qubits=4, vqc_layers=2, n_features=4)
    cfg_t = CFG_T.replace(vqc_qubits=4, vqc_layers=2, n_features=4)
    K, n_max, E, B = 3, 20, 3, 5
    rng = np.random.default_rng(3)
    x, y = _batch(rng, (K, n_max), n_feat=4)
    n = np.array([20, 7, 13])
    keys_j = jax.vmap(lambda s: jax.random.fold_in(
        jax.random.PRNGKey(9), s))(jnp.arange(K))
    keys_t = prng.fold_in(prng.PRNGKey(9, "cpu"), torch.arange(K))
    data_j = {"features": jnp.asarray(x), "labels": jnp.asarray(y, jnp.int32)}
    data_t = {"features": torch.tensor(x), "labels": torch.tensor(y)}
    bj = jax.vmap(lambda d, k, m: jax_sample_local_batches(d, k, B, m, E))(
        data_j, keys_j, jnp.asarray(n, jnp.int32))
    bt = sample_local_batches(data_t, keys_t, B, torch.tensor(n), E)
    for e in range(E):
        for k in ("features", "labels"):
            np.testing.assert_array_equal(bt[e][k].numpy(),
                                          np.asarray(bj[k][:, e]))

    fl = dict(local_steps=E, batch_size=B, lr=0.1, optimizer="momentum")
    opt_j = jopt.get_optimizer("momentum", jopt.inv_sqrt_schedule(0.1))
    opt_t = topt.get_optimizer("momentum", topt.inv_sqrt_schedule(0.1))
    pj = jax.vmap(lambda k: jvqc.vqc_init(cfg_j, k))(keys_j)
    run_j = jax_batched_train(jax_get_model(cfg_j), cfg_j, JaxConfig(**fl),
                              opt_j)
    pj2, _, lj = run_j(pj, jax.vmap(opt_j.init)(pj), data_j,
                       jnp.asarray(n, jnp.int32), keys_j, jnp.int32(4))
    pt = params_from_jax(_np_tree(pj), "cpu")
    run_t = make_batched_local_train(get_model(cfg_t), cfg_t,
                                     SatQFLConfig(**fl), opt_t)
    st = topt.OptState(slots={k: torch.zeros_like(v) for k, v in pt.items()})
    pt2, _, lt = run_t(pt, st, data_t, torch.tensor(n), keys_t, 4)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5)
    for k in pj2:
        np.testing.assert_allclose(pt2[k].numpy(), np.asarray(pj2[k]),
                                   atol=1e-5)


def test_data_and_partitions_are_bit_equal():
    xj, yj = make_statlog(n_features=8, seed=1)
    xt, yt = tdata.make_statlog(n_features=8, seed=1, device="cpu")
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    cj, lj, sj = server_split(xj, yj)
    ct, lt, st = tdata.server_split(xt, yt)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    for part in ("val", "test"):
        for k in ("features", "labels"):
            np.testing.assert_array_equal(st[part][k].numpy(),
                                          np.asarray(sj[part][k]))
    for dj, dt in zip(dirichlet_partition(cj, lj, 12) +
                      equal_partition(cj, lj, 5),
                      tdata.dirichlet_partition(ct, lt, 12) +
                      tdata.equal_partition(ct, lt, 5)):
        for k in ("features", "labels"):
            np.testing.assert_array_equal(dt[k].numpy(), np.asarray(dj[k]))
    ej = make_eurosat(n_features=6, n_samples=600)
    et = tdata.make_eurosat(n_features=6, n_samples=600, device="cpu")
    for a, b in zip(et, ej):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_registry_serves_only_the_vqc():
    """The VQC takes the shift rule; the encdec and vlm families resolve
    to their own models, with a cross-cache prefill and no shift rule."""
    assert get_config("vqc-satqfl") == CFG_T
    assert get_model(CFG_T).shift_grad is tvqc.parameter_shift_grad
    from repro_torch.models import encdec, vlm
    for arch, family, mod in (("whisper-tiny", "encdec", encdec),
                              ("llama-3.2-vision-90b", "vlm", vlm)):
        cfg = get_config(arch)
        # the JAX package's config, field for field
        assert vars(cfg) == vars(jax_get_config(arch))
        assert cfg.family == family and cfg.name == arch
        for api in (get_model(arch), get_model(cfg)):
            assert api.init is mod.init and api.prefill is mod.prefill
            assert api.prefill_cross is mod.prefill_cross
            assert api.shift_grad is None
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("no-such-arch")
