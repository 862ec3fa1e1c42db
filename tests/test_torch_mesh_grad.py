"""The port's meshed loss gradients on 4 gloo ranks, a (data, model) =
(2, 2) mesh, against ``jax.grad`` of ``repro``'s meshed loss on 4 forced
host devices, on the CPU in float32.

Three smoke models: deepseek-moe-16b's (its MoE layer through
``_moe_a2a``: the router replicated over both axes, the experts over
"data"), mamba2-130m's (the SSD scan's local region: ``A`` replicated
over "data", the one B/C group over "model") and qwen3-0.6b's under
``seq_attn`` (each rank's query block against K/V replicated over
"model"); all look their embeddings up per shard (the table replicated
over "data"). Each rank's
gradient of such a weight is only its share; the loss and every gradient
leaf, taken whole, must meet JAX's to 1e-5 of the leaf's largest
|value|, each gradient must come back with its parameter's placements,
and the ranks must hold the same bits of every replicated gradient, so
that they apply one update.

The JAX parameters are drawn once here and sent to both sides; the four
port ranks (joined through a file store, no network) and the JAX process
run in subprocesses started together.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.models import get_config as jax_get_config
from repro.models import get_model as jax_get_model
from repro.models import smoke_variant as jax_smoke_variant

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# arch -> the DistCtx levers it runs under
ARCHS = {"deepseek-moe-16b": {}, "mamba2-130m": {},
         "qwen3-0.6b": {"seq_attn": True}}
B, S, SEED = 2, 16, 5

_PORT = r"""
import pickle, sys, numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import get_config, get_model, smoke_variant
from repro_torch.nn.pytree import tree_leaves, tree_unflatten
from repro_torch.sharding.context import DistCtx
from repro_torch.sharding.specs import (batch_specs, distribute_tree,
                                        param_specs)
rank, store, inp, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
res = {}
for arch, (jp, batch, kw) in pickle.load(open(inp, "rb")).items():
    ctx = DistCtx(mesh=mesh, data_axes=("data",), **kw)
    cfg = smoke_variant(get_config(arch))
    api = get_model(cfg)
    params = params_from_jax(jp, device="cpu")
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    dp = distribute_tree(params, param_specs(cfg, params, ctx), mesh)
    db = distribute_tree(tb, batch_specs(cfg, tb, ctx), mesh)
    loss, grads = loss_and_grads(cfg, api, dp, db, ctx)
    same = all(g.placements == p.placements
               for g, p in zip(tree_leaves(grads), tree_leaves(dp)))
    # every rank's local gradient, to hold the replicated ones equal
    locs = [g.to_local().numpy() for g in tree_leaves(grads)]
    got = [None] * 4
    dist.all_gather_object(got, locs)
    full = [g.full_tensor() for g in tree_leaves(grads)]
    res[arch] = dict(loss=float(loss.full_tensor()), placements=same,
                     grads=params_to_numpy(tree_unflatten(dp, full)),
                     locals=got,
                     replicated=[all(p.is_replicate() for p in g.placements)
                                 for g in tree_leaves(grads)])
if rank == 0:
    with open(out, "wb") as f:
        pickle.dump(res, f)
dist.destroy_process_group()
"""

_JAX = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np, jax
from jax.sharding import Mesh
from repro.models import get_config, get_model, smoke_variant
from repro.sharding.context import DistCtx
inp, out = sys.argv[1], sys.argv[2]
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
res = {}
for arch, (jp, batch, kw) in pickle.load(open(inp, "rb")).items():
    ctx = DistCtx(mesh=mesh, data_axes=("data",), **kw)
    cfg = smoke_variant(get_config(arch))
    api = get_model(cfg)
    f = jax.jit(jax.value_and_grad(lambda p, b: api.loss(cfg, p, b, ctx)))
    with mesh:
        loss, g = f(jp, batch)
    res[arch] = dict(loss=float(loss),
                     grads=jax.tree_util.tree_map(np.asarray, g))
with open(out, "wb") as f:
    pickle.dump(res, f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_grad")
    inputs = {}
    for i, (arch, kw) in enumerate(ARCHS.items()):
        cfg = jax_smoke_variant(jax_get_config(arch))
        jp = jax_get_model(cfg).init(cfg, jax.random.PRNGKey(SEED + i))
        rng = np.random.default_rng(SEED + i)
        batch = {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
                 for k in ("tokens", "labels")}
        inputs[arch] = (jax.tree_util.tree_map(np.asarray, jp), batch, kw)
    inp = str(tmp / "inputs.pkl")
    with open(inp, "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    store = str(tmp / "store")
    port_out, jax_out = str(tmp / "port.pkl"), str(tmp / "jax.pkl")
    procs = [subprocess.Popen([sys.executable, "-c", _PORT, str(r), store,
                               inp, port_out], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    procs.append(subprocess.Popen([sys.executable, "-c", _JAX, inp, jax_out],
                                  env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    with open(port_out, "rb") as f, open(jax_out, "rb") as g:
        return pickle.load(f), pickle.load(g)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_meshed_loss_and_grads_equal_jax(runs, arch):
    port, jx = runs
    got, want = port[arch], jx[arch]
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    g_leaves = jax.tree_util.tree_leaves_with_path(got["grads"])
    w_leaves = jax.tree_util.tree_leaves_with_path(want["grads"])
    assert [p for p, _ in g_leaves] == [p for p, _ in w_leaves]
    for (path, g), (_, w) in zip(g_leaves, w_leaves):
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= 1e-5 * scale, (jax.tree_util.keystr(path), err, scale)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_meshed_grads_are_placed_and_agree_across_ranks(runs, arch):
    got = runs[0][arch]
    assert got["placements"]
    n_rep = 0
    for i, rep in enumerate(got["replicated"]):
        if rep:
            n_rep += 1
            for r in range(1, 4):
                np.testing.assert_array_equal(got["locals"][r][i],
                                              got["locals"][0][i])
    assert n_rep > 0
