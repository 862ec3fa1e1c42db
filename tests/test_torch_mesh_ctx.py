"""The port's models under a mesh ``ctx`` (a world-1 gloo group, the
(1, 1) host mesh, DTensor parameters and inputs placed by the specs)
against ``repro``'s on ``make_host_mesh()``'s (1, 1) mesh, on the CPU in
float32.

A smoke decoder (qwen3-0.6b's smoke variant: GQA, so ``seq_attn``
applies) forward and loss, and the smoke VLM's forward (its tanh gates at
0.5 in both trees), under ``seq_shard`` alone and with ``quant_gather``,
``gather_once`` and ``seq_attn``: logits and loss within 1e-6 of JAX's
max |value| (rel; the VLM's 1e-5, the agreement of its forward with JAX's
without a mesh, 1.5e-6 here, being above 1e-6). ``quant_gather``'s int8 round trip runs on any mesh,
so the decoder's output differs from ``ctx=None``'s, as JAX's does (the
VLM's blocks have no gather point); the other levers are layout only and leave the port's output bit for bit as with
``ctx=None``. Then the in-graph otp_gather round with a ``ctx``: equal to
JAX's on the same inputs, ``mac_ok`` true.

The process group lives in a module fixture that destroys it, so nothing
leaks into the next file of a pytest worker.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import torch.distributed as dist

from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.models import get_config as jax_get_config
from repro.models import get_model as jax_get_model
from repro.models import smoke_variant as jax_smoke_variant
from repro.sharding.context import DistCtx as JaxCtx
from repro_torch.convert import params_from_jax
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_config, get_model, smoke_variant
from repro_torch.sharding.context import DistCtx
from repro_torch.sharding.specs import (batch_specs, distribute_tree,
                                        param_specs)

B, S = 2, 16
LEVERS = {"seq_shard": {}, "quant_gather": {"quant_gather": True},
          "gather_once": {"gather_once": True},
          "seq_attn": {"seq_attn": True}}


@pytest.fixture(scope="module")
def meshes():
    assert not dist.is_initialized()
    mesh = make_host_mesh(device="cpu")
    # the shape and axis names of JAX's make_host_mesh(); its axes are
    # Auto here, which with_sharding_constraint takes (make_mesh's
    # default Explicit axes reject it)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                              ("data", "model"))
    assert jmesh.shape == jax_host_mesh().shape
    yield mesh, jmesh
    dist.destroy_process_group()


def _rel(got, want) -> float:
    got = got.detach().numpy()
    want = np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _open_gates(tree):
    if isinstance(tree, dict):
        return {k: (np.full_like(v, 0.5) if k in ("gate_attn", "gate_ffn")
                    else _open_gates(v)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_open_gates(v) for v in tree]
    return np.asarray(tree)


def _models(arch: str, seed: int):
    jcfg = jax_smoke_variant(jax_get_config(arch))
    tcfg = smoke_variant(get_config(arch))
    jp = jax_get_model(jcfg).init(jcfg, jax.random.PRNGKey(seed))
    jp = _open_gates(jax.tree_util.tree_map(np.asarray, jp))
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S)
                                    ).astype(np.int32),
             "labels": rng.integers(0, jcfg.vocab_size, (B, S)
                                    ).astype(np.int32)}
    if jcfg.family == "vlm":
        batch["image_embeds"] = (0.02 * rng.standard_normal(
            (B, jcfg.n_image_tokens, jcfg.d_model))).astype(np.float32)
    return jcfg, tcfg, jp, batch


def _jax_run(jcfg, jp, batch, jmesh, kw, fn):
    api = jax_get_model(jcfg)
    ctx = None if jmesh is None else JaxCtx(mesh=jmesh, data_axes=("data",),
                                            **kw)
    f = jax.jit(lambda p, b: api.forward(jcfg, p, b, ctx)[0]
                if fn == "forward" else api.loss(jcfg, p, b, ctx))
    with jmesh or contextlib.nullcontext():
        return np.asarray(f(jp, batch))


def _torch_run(tcfg, jp, batch, mesh, kw, fn):
    api = get_model(tcfg)
    params = params_from_jax(jp, device="cpu")
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    if mesh is None:
        ctx = None
    else:
        ctx = DistCtx(mesh=mesh, data_axes=("data",), **kw)
        params = distribute_tree(params, param_specs(tcfg, params, ctx),
                                 mesh)
        tb = distribute_tree(tb, batch_specs(tcfg, tb, ctx), mesh)
    with torch.no_grad():
        out = getattr(api, fn)(tcfg, params, tb, ctx)
    out = out[0] if fn == "forward" else out
    return out.full_tensor() if hasattr(out, "full_tensor") else out


@pytest.mark.parametrize("lever", list(LEVERS))
@pytest.mark.parametrize("arch,fn", [("qwen3-0.6b", "forward"),
                                     ("qwen3-0.6b", "loss"),
                                     ("llama-3.2-vision-90b", "forward")])
def test_meshed_model_equals_jax(arch, fn, lever, meshes):
    mesh, jmesh = meshes
    jcfg, tcfg, jp, batch = _models(arch, 3)
    kw = LEVERS[lever]
    want = _jax_run(jcfg, jp, batch, jmesh, kw, fn)
    got = _torch_run(tcfg, jp, batch, mesh, kw, fn)
    assert not hasattr(got, "placements")
    # the VLM's f32 forward meets JAX's to 1.5e-6 without a mesh too
    assert _rel(got, want) <= (1e-6 if arch == "qwen3-0.6b" else 1e-5)
    plain = _torch_run(tcfg, jp, batch, None, kw, fn)
    if lever == "quant_gather" and arch == "qwen3-0.6b":
        # (the VLM's blocks have no gather point, in JAX as here)
        assert not torch.equal(got, plain)
        jplain = _jax_run(jcfg, jp, batch, None, {}, fn)
        assert not np.array_equal(want, jplain)
    elif lever != "seq_attn":
        assert torch.equal(got, plain)


def test_otp_gather_round_under_a_mesh_ctx(meshes):
    """The in-graph otp_gather round given the mesh ctx: bit for bit the
    round without one (its rows are plain tensors on one rank, so pinning
    the ciphertext replicated moves nothing), every tag verified, and
    within 1e-6 of JAX's round."""
    import test_torch_dist as td
    from repro_torch.core import dist as tdist
    from repro_torch.core.flconfig import SatQFLConfig
    from repro_torch.nn import optim
    from repro_torch import convert
    world = td.World()
    mesh, _ = meshes
    ctx = DistCtx(mesh=mesh, data_axes=("data",))
    rf = tdist.make_fl_round(world.cfg, world.api,
                             SatQFLConfig(**world._fl("sim")),
                             optim.sgd(0.1), td.N, security="otp_gather",
                             ctx=ctx)
    ts, tm = rf(world.states("sgd")[1],
                convert.params_from_jax(td._batches(1), "cpu"),
                torch.tensor(td.MASK), torch.tensor(
                    td.SEEDS.astype(np.int64)), None, None)
    assert bool(tm["mac_ok"])
    ps, pm = world.port("sim", "otp_gather")
    td._assert_bits(ts.params, ps.params)
    assert torch.equal(tm["loss"], pm["loss"])
    js, jm = world.jax("sim", "otp_gather")
    td._assert_state_close(ts, tm, js, jm, 1e-6)


def _local(tree):
    from repro_torch.nn.pytree import tree_leaves
    return [t.to_local() if hasattr(t, "to_local") else t
            for t in tree_leaves(tree)]


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_meshed_train_step_is_the_plain_step(optimizer, meshes):
    """``make_train_step`` under the (1, 1) mesh ctx with DTensor params,
    slots and batch: the loss, every new parameter and slot bit for bit
    those of the plain step (a size-1 mesh moves nothing)."""
    from repro_torch import prng
    from repro_torch.launch.steps import _opt_for, make_train_step
    from repro_torch.launch.steps import _opt_specs
    mesh, _ = meshes
    cfg = smoke_variant(get_config("qwen3-0.6b"))
    api = get_model(cfg)
    params = api.init(cfg, prng.PRNGKey(1, "cpu"))
    opt = _opt_for(cfg, optimizer)
    slots = opt.init(params)
    rng = np.random.default_rng(1)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)))
             for k in ("tokens", "labels")}
    want = make_train_step(cfg, api, opt)(params, slots, batch, 3)
    ctx = DistCtx(mesh=mesh, data_axes=("data",))
    p_spec = param_specs(cfg, params, ctx)
    dp = distribute_tree(params, p_spec, mesh)
    ds = distribute_tree(slots, _opt_specs(slots, p_spec), mesh)
    db = distribute_tree(batch, batch_specs(cfg, batch, ctx), mesh)
    got = make_train_step(cfg, api, opt, ctx)(dp, ds, db, 3)
    for a, b in zip(_local(got), _local(want)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b"])
def test_meshed_prefill_is_the_plain_prefill(arch, meshes):
    """The prefill step of an SSM and a hybrid decoder (the SSD scan and
    the attention kernel's wrappers called on each rank's local shard)
    under the (1, 1) mesh: bit for bit the plain prefill."""
    from repro_torch import prng
    from repro_torch.launch.steps import make_prefill_step
    mesh, _ = meshes
    cfg = smoke_variant(get_config(arch))
    api = get_model(cfg)
    params = api.init(cfg, prng.PRNGKey(2, "cpu"))
    batch = {"tokens": torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S)))}
    want = make_prefill_step(cfg, api)(params, batch)
    ctx = DistCtx(mesh=mesh, data_axes=("data",))
    got = make_prefill_step(cfg, api, ctx)(
        distribute_tree(params, param_specs(cfg, params, ctx), mesh),
        distribute_tree(batch, batch_specs(cfg, batch, ctx), mesh))
    assert torch.equal(got.full_tensor(), want)
