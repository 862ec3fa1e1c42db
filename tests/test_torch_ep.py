"""The port's MoE expert parallelism (``models.blocks._moe_a2a``,
``_moe_replicated_ep``) on 4 gloo ranks against ``repro``'s ``shard_map``
versions on 4 forced host devices, and ``to_placements``' order of a dim
split over two mesh axes against JAX's.

deepseek-moe-16b's smoke variant (4 experts, top 2) at capacity factor
0.5, so tokens drop on both sides of the exchange, in float32, on meshes
(data, model) = (1, 4) and (2, 2): ``y`` and ``aux`` within 1e-6 (each
rank's router softmax meets XLA's to an ulp or two, so the mean over the
ranks, added in rank order as XLA adds it, does too), and
every rank's kept slots (``keep`` on the send side, ``keep2`` on the
receive side, JAX's from the same lines of ``_moe_a2a`` on the same
routing) exactly. Both sides run in subprocesses started together: four
port ranks joined through a file store (no network), and one JAX process
with its 4-device flag.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, CF, SEED = 2, 16, 0.5, 7
MESHES = [(1, 4), (2, 2)]

_INPUTS = """
import numpy as np
def inputs(cfg):
    rng = np.random.default_rng(%d)
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    n = lambda *s: (rng.standard_normal(s) / np.sqrt(s[-2] if len(s) > 1
                                                      else 1)).astype(np.float32)
    p = {"router": n(d, E), "we_g": n(E, d, f), "we_u": n(E, d, f),
         "we_d": n(E, f, d)}
    return p, rng.standard_normal((%d, %d, d)).astype(np.float32)
""" % (SEED, B, S)

_PORT = _INPUTS + r"""
import sys, numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate
from repro_torch.models import blocks as tB, get_config, smoke_variant
from repro_torch.sharding.context import DistCtx
from repro_torch.sharding.specs import P, distribute
rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=4)
cfg = smoke_variant(get_config("deepseek-moe-16b")).replace(
    capacity_factor=%r)
p_np, x_np = inputs(cfg)
res = {}
for shape in %r:
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    ctx = DistCtx(mesh=mesh, data_axes=("data",))
    rep = lambda a: DTensor.from_local(torch.tensor(a), mesh,
                                       [Replicate()] * 2, run_check=False)
    p = {k: rep(v) for k, v in p_np.items()}
    slots = {}
    y, aux = tB._moe_a2a(rep(x_np), p, cfg, ctx, slots=slots)
    tag = "%%dx%%d" %% shape
    res["a2a_y_" + tag] = y.full_tensor().numpy()
    res["a2a_aux_" + tag] = aux.to_local().numpy()
    for name in ("keep", "keep2"):
        got = [None] * 4
        dist.all_gather_object(got, slots[name].numpy())
        res["a2a_%%s_%%s" %% (name, tag)] = np.stack(got)
    y, aux = tB._moe_replicated_ep(rep(x_np.reshape(-1, x_np.shape[-1])),
                                   p, cfg, ctx)
    res["rep_y_" + tag] = y.full_tensor().numpy()
    res["rep_aux_" + tag] = aux.to_local().numpy()
    # a dim split over ("data", "model"): rank (i, j) holds chunk i*m + j
    t = distribute(torch.arange(16.0), P(("data", "model")), mesh)
    got = [None] * 4
    dist.all_gather_object(got, t.to_local().numpy())
    res["order_" + tag] = np.stack(got)
if rank == 0:
    np.savez(out, **res)
dist.destroy_process_group()
""" % (CF, MESHES)

_JAX = _INPUTS + r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS
from repro.models import blocks as jB, get_config, smoke_variant
from repro.sharding.context import DistCtx
cfg = smoke_variant(get_config("deepseek-moe-16b")).replace(
    capacity_factor=%r)
p_np, x_np = inputs(cfg)
res = {}
k = cfg.n_experts_per_tok
for dsz, msz in %r:
    mesh = Mesh(np.array(jax.devices()).reshape(dsz, msz), ("data", "model"))
    ctx = DistCtx(mesh=mesh, data_axes=("data",))
    tag = "%%dx%%d" %% (dsz, msz)
    p = {kk: jnp.asarray(v) for kk, v in p_np.items()}
    y, aux = jax.jit(lambda x, p: jB._moe_a2a(x, p, cfg, ctx))(
        jnp.asarray(x_np), p)
    res["a2a_y_" + tag], res["a2a_aux_" + tag] = np.asarray(y), np.asarray(aux)
    y, aux = jax.jit(lambda x, p: jB._moe_replicated_ep(x, p, cfg, ctx))(
        jnp.asarray(x_np.reshape(-1, x_np.shape[-1])), p)
    res["rep_y_" + tag], res["rep_aux_" + tag] = np.asarray(y), np.asarray(aux)
    # the kept slots: _moe_a2a's lines on each rank's routing
    Bl, Sl = x_np.shape[0] // dsz, x_np.shape[1] // msz
    e_num = cfg.n_experts // msz
    T = Bl * Sl
    c_send = max(int(cfg.capacity_factor * T * k / msz), 4)
    c_exp = max(int(cfg.capacity_factor * T * k / e_num), 4)
    keeps, sends = {}, {}
    for i in range(dsz):
        for j in range(msz):
            xt = jnp.asarray(x_np[i*Bl:(i+1)*Bl, j*Sl:(j+1)*Sl].reshape(T, -1))
            probs = jax.nn.softmax(xt @ p["router"], -1)
            _, idx = jax.lax.top_k(probs, k)
            a = idx.reshape(T * k)
            dst = a // e_num
            oh = jax.nn.one_hot(dst, msz, dtype=jnp.int32)
            slot = jnp.sum(jnp.cumsum(oh, 0) * oh, 1) - 1
            keep = slot < c_send
            tgt = jnp.where(keep, dst * c_send + slot, msz * c_send)
            be = jnp.full((msz * c_send + 1,), -1, jnp.int32).at[tgt].set(
                jnp.where(keep, a - dst * e_num, -1))
            keeps[i, j] = np.asarray(keep)
            sends[i, j] = np.asarray(be[:-1]).reshape(msz, c_send)
    k2 = {}
    for i in range(dsz):
        for j in range(msz):
            re_ = jnp.asarray(np.concatenate([sends[i, m][j]
                                              for m in range(msz)]))
            valid = re_ >= 0
            e_loc = jnp.where(valid, re_, e_num)
            oh2 = jax.nn.one_hot(e_loc, e_num + 1, dtype=jnp.int32)
            slot2 = jnp.sum(jnp.cumsum(oh2, 0) * oh2, 1) - 1
            k2[i, j] = np.asarray(valid & (slot2 < c_exp))
    order = [(i, j) for i in range(dsz) for j in range(msz)]
    res["a2a_keep_" + tag] = np.stack([keeps[o] for o in order])
    res["a2a_keep2_" + tag] = np.stack([k2[o] for o in order])
    t = jax.device_put(jnp.arange(16.0),
                       NamedSharding(mesh, PS(("data", "model"))))
    res["order_" + tag] = np.stack([np.asarray(t.addressable_data(r))
                                    for r in range(4)])
np.savez(sys.argv[1], **res)
""" % (CF, MESHES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    store = str(tmp / "store")
    port_out, jax_out = str(tmp / "port.npz"), str(tmp / "jax.npz")
    procs = [subprocess.Popen([sys.executable, "-c", _PORT, str(r), store,
                               port_out], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    procs.append(subprocess.Popen([sys.executable, "-c", _JAX, jax_out],
                                  env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return dict(np.load(port_out)), dict(np.load(jax_out))


def _tag(shape):
    return "%dx%d" % shape


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_a2a_equals_jax(runs, shape):
    port, jx = runs
    t = _tag(shape)
    np.testing.assert_allclose(port["a2a_y_" + t], jx["a2a_y_" + t],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(port["a2a_aux_" + t], jx["a2a_aux_" + t],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_a2a_kept_slots_equal_jax(runs, shape):
    port, jx = runs
    t = _tag(shape)
    for name in ("keep", "keep2"):
        np.testing.assert_array_equal(port["a2a_%s_%s" % (name, t)],
                                      jx["a2a_%s_%s" % (name, t)])
    # the capacity really drops slots on the send side
    assert not port["a2a_keep_" + t].all()


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_replicated_ep_equals_jax(runs, shape):
    port, jx = runs
    t = _tag(shape)
    np.testing.assert_allclose(port["rep_y_" + t], jx["rep_y_" + t],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(port["rep_aux_" + t], jx["rep_aux_" + t],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_tuple_axis_split_order_equals_jax(runs, shape):
    port, jx = runs
    np.testing.assert_array_equal(port["order_" + _tag(shape)],
                                  jx["order_" + _tag(shape)])
