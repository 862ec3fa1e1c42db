"""The port's sharding plane (``repro_torch.sharding``, ``launch.steps``'s
bundles, ``launch.analysis``) against ``repro``'s, with no process group.

``DistCtx`` on a stand-in mesh; the parameter, batch and cache spec trees
equal JAX's leaf for leaf (by path) for every LM arch under ``tp`` and
``dp``, FSDP on and off, on both production meshes; every sharded dim
divides its axes; ``to_placements`` on a tuple-axis spec; ``build_bundle``'s
shapes, dtypes and specs for a train, a prefill and a decode combo with
adamw and sgd; ``fl_input_specs``; and ``analytic_terms`` /
``analytic_memory_per_chip`` equal JAX's exactly for every pair of
``combos()`` on both meshes, FSDP on and off. JAX evaluates shapes only
(``jax.eval_shape``), the port builds meta tensors.
"""
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.shapes import shape_for as jax_shape_for
from repro.core import dist as jdist
from repro.core.flconfig import SatQFLConfig as JaxFL
from repro.launch import analysis as janalysis
from repro.launch import steps as jsteps
from repro.models import registry as jreg
from repro.sharding.context import DistCtx as JaxCtx
from repro.sharding import specs as jspecs
from repro_torch.configs.shapes import shape_for
from repro_torch.core import dist as tdist
from repro_torch.core.flconfig import SatQFLConfig
from repro_torch.launch import analysis as tanalysis
from repro_torch.launch import dryrun as tdryrun
from repro_torch.launch import steps as tsteps
from repro_torch.models import registry as treg
from repro_torch.sharding import specs as tspecs
from repro_torch.sharding.context import DistCtx

LM_ARCHS = [a for a in jreg.ARCH_IDS if a != "vqc-satqfl"]
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


class _JaxMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


class _TorchMesh:
    """The two members ``DistCtx`` reads of a ``DeviceMesh``."""

    def __init__(self, shape):
        self.mesh_dim_names = tuple(shape)
        self._sizes = tuple(shape.values())

    def size(self, dim=None):
        return int(np.prod(self._sizes)) if dim is None else self._sizes[dim]


def _ctxs(mesh: str, **kw):
    shape = MESHES[mesh]
    data = tuple(a for a in shape if a != "model")
    return (JaxCtx(mesh=_JaxMesh(shape), data_axes=data, **kw),
            DistCtx(mesh=_TorchMesh(shape), data_axes=data, **kw))


def _jax_by_path(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)):
        key = tuple(getattr(e, "key", getattr(e, "idx", getattr(
            e, "name", None))) for e in path)
        out[key] = leaf
    return out


def _torch_by_path(tree):
    out = {}
    tspecs.map_with_path(lambda p, leaf: out.__setitem__(p, leaf), tree,
                         is_leaf=lambda x: isinstance(x, tspecs.P))
    return out


def _same_specs(jtree, ttree):
    j, t = _jax_by_path(jtree), _torch_by_path(ttree)
    assert set(j) == set(t)
    bad = {k: (tuple(j[k]), tuple(t[k])) for k in j
           if tuple(j[k]) != tuple(t[k])}
    assert not bad, bad


@functools.lru_cache(maxsize=None)
def _abstract(arch: str):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    jp = jax.eval_shape(lambda: jreg.get_model(jcfg).init(
        jcfg, jax.random.PRNGKey(0)))
    tp = tsteps.abstract_params(tcfg, treg.get_model(tcfg))
    return jcfg, tcfg, jp, tp


# ---------------------------------------------------------------------------
# DistCtx
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
def test_distctx_on_a_stand_in_mesh(mesh):
    j, t = _ctxs(mesh)
    for name in ("all_axes", "model_size", "data_size", "data_spec_axes"):
        assert getattr(j, name) == getattr(t, name), name
    assert t.replace(fsdp=True).fsdp and not t.fsdp
    assert DistCtx(mesh=None).model_size == 1
    assert DistCtx(mesh=None).data_size == 1


# ---------------------------------------------------------------------------
# the three spec trees, leaf for leaf
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fsdp", [False, True], ids=["nofsdp", "fsdp"])
@pytest.mark.parametrize("strategy", ["tp", "dp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_specs_equal_jax(arch, mesh, strategy, fsdp):
    jcfg, tcfg, jp, tp = _abstract(arch)
    jctx, tctx = _ctxs(mesh, strategy=strategy, fsdp=fsdp)
    _same_specs(jspecs.param_specs(jcfg, jp, jctx),
                tspecs.param_specs(tcfg, tp, tctx))


@pytest.mark.parametrize("strategy", ["tp", "dp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_batch_and_cache_specs_equal_jax(arch, mesh, strategy):
    jctx, tctx = _ctxs(mesh, strategy=strategy)
    from repro.configs.shapes import (INPUT_SHAPES, cfg_for_shape,
                                      supports_shape)
    from repro_torch.configs.shapes import cfg_for_shape as tcfg_for_shape
    for name, shape in INPUT_SHAPES.items():
        if not supports_shape(jreg.get_config(arch), shape):
            continue
        jcfg = cfg_for_shape(jreg.get_config(arch), name)
        tcfg = tcfg_for_shape(treg.get_config(arch), name)
        jb = jsteps.input_specs(jcfg, shape)
        tb = tsteps.input_specs(tcfg, shape_for(name))
        _same_specs(jspecs.batch_specs(jcfg, jb, jctx),
                    tspecs.batch_specs(tcfg, tb, tctx))
        if shape.mode == "decode":
            jc = jsteps.abstract_cache(jcfg, jreg.get_model(jcfg),
                                       shape.global_batch, shape.seq_len)
            tc = tsteps.abstract_cache(tcfg, treg.get_model(tcfg),
                                       shape.global_batch, shape.seq_len)
            _same_specs(jspecs.cache_specs(jcfg, jc, jctx),
                        tspecs.cache_specs(tcfg, tc, tctx))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_specs_divide_their_dims(arch):
    """Property: every sharded dim divides by its axes' sizes, on both
    meshes, FSDP on, under both strategies."""
    _, tcfg, _, tp = _abstract(arch)
    leaves = []
    tspecs.map_with_path(lambda p, leaf: leaves.append((p, leaf)), tp)
    for mesh in MESHES:
        for strategy in ("tp", "dp"):
            _, ctx = _ctxs(mesh, strategy=strategy, fsdp=True)
            specs = _torch_by_path(tspecs.param_specs(tcfg, tp, ctx))
            for path, leaf in leaves:
                for dim, entry in zip(leaf.shape, specs[path]):
                    if entry is None:
                        continue
                    axes = entry if isinstance(entry, tuple) else (entry,)
                    size = int(np.prod([MESHES[mesh][a] for a in axes]))
                    assert dim % size == 0, (path, leaf.shape, specs[path])


def test_to_placements_tuple_axes():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _TorchMesh(MESHES["multi"])
    pl = tspecs.to_placements(tspecs.P(("pod", "data"), None, "model"), mesh)
    assert pl == (Shard(0), Shard(0), Shard(2))
    pl = tspecs.to_placements(tspecs.P(None, ("pod", "data", "model")), mesh)
    assert pl == (Shard(1), Shard(1), Shard(1))
    assert tspecs.to_placements(tspecs.P(None, None), mesh) == \
        (Replicate(),) * 3
    with pytest.raises(NotImplementedError):
        tspecs.to_placements(tspecs.P(("data", "pod")), mesh)
    with pytest.raises(ValueError):
        tspecs.to_placements(tspecs.P("model", "model"), mesh)


# ---------------------------------------------------------------------------
# bundles
# ---------------------------------------------------------------------------

def _dtype_name(d):
    return str(d).replace("torch.", "")


def _same_shapes(jtree, ttree):
    jl = jax.tree_util.tree_leaves(jtree)
    from repro_torch.nn.pytree import tree_leaves
    tl = tree_leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        assert _dtype_name(a.dtype) == _dtype_name(b.dtype)
        assert b.device.type == "meta"


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
@pytest.mark.parametrize("arch,shape", [("qwen3-0.6b", "train_4k"),
                                        ("hymba-1.5b", "prefill_32k"),
                                        ("deepseek-moe-16b", "decode_32k")])
def test_build_bundle_equals_jax(arch, shape, optimizer):
    jctx, tctx = _ctxs("single", fsdp=True)
    jb = jsteps.build_bundle(arch, shape, jctx, optimizer=optimizer)
    tb = tsteps.build_bundle(arch, shape, tctx, optimizer=optimizer)
    assert jb.mode == tb.mode
    assert len(jb.arg_shapes) == len(tb.arg_shapes)
    for ja, ta, js, ts in zip(jb.arg_shapes, tb.arg_shapes, jb.in_specs,
                              tb.in_specs):
        _same_shapes(ja, ta)
        _same_specs(js, ts)
    if jb.out_specs is not None:
        _same_specs(jb.out_specs, tb.out_specs)


def test_fl_input_specs():
    from repro.models.registry import get_config as jget
    jfl, tfl = JaxFL(mode="seq"), SatQFLConfig(mode="seq")
    j = jdist.fl_input_specs(jget("vqc-satqfl"), None, jfl, 6, (8,), 7,
                             seq_hops=3)
    t = tdist.fl_input_specs(treg.get_config("vqc-satqfl"), None, tfl, 6,
                             (8,), 7, seq_hops=3)
    jl = _jax_by_path(j)
    tl = _torch_by_path(t)
    assert set(jl) == set(tl)
    for k in jl:
        assert tuple(jl[k].shape) == tuple(tl[k].shape)
        want = "int64" if jl[k].dtype == np.uint32 else _dtype_name(
            jl[k].dtype)
        assert _dtype_name(tl[k].dtype) == want
        assert tl[k].device.type == "meta"


# ---------------------------------------------------------------------------
# the analytic roofline terms, exactly
# ---------------------------------------------------------------------------

_COMBOS = list(tdryrun.combos())


def test_combos_equal_jax():
    from repro.configs.shapes import INPUT_SHAPES, supports_shape
    want = [(a, s) for a in LM_ARCHS for s in INPUT_SHAPES
            if supports_shape(jreg.get_config(a), jax_shape_for(s))]
    assert sorted(_COMBOS) == sorted(want)


@pytest.fixture(scope="module")
def cached_counts():
    """Each side's parameter counts, memoised by config for the sweep."""
    jorig, torig = janalysis._param_counts, tanalysis._param_counts
    janalysis._param_counts = functools.lru_cache(maxsize=None)(jorig)
    tanalysis._param_counts = functools.lru_cache(maxsize=None)(torig)
    yield
    janalysis._param_counts, tanalysis._param_counts = jorig, torig


@pytest.mark.parametrize("arch,shape", _COMBOS)
def test_analytic_terms_equal_jax(arch, shape, cached_counts):
    from repro.configs.shapes import cfg_for_shape
    from repro_torch.configs.shapes import cfg_for_shape as tcfg_for_shape
    jcfg = cfg_for_shape(jreg.get_config(arch), shape)
    tcfg = tcfg_for_shape(treg.get_config(arch), shape)
    japi, tapi = jreg.get_model(jcfg), treg.get_model(tcfg)
    jshape, tshape = jax_shape_for(shape), shape_for(shape)
    assert janalysis.analytic_terms(jcfg, japi, jshape) == \
        tanalysis.analytic_terms(tcfg, tapi, tshape)
    for mesh, sizes in MESHES.items():
        n = int(np.prod(list(sizes.values())))
        data = n // sizes["model"]
        for fsdp in (False, True):
            args = (n, sizes["model"], data, fsdp)
            assert janalysis.analytic_memory_per_chip(
                jcfg, japi, jshape, *args) == \
                tanalysis.analytic_memory_per_chip(tcfg, tapi, tshape, *args)


def test_no_tpu_constants_in_the_port():
    assert tanalysis.PEAK_FLOPS == 989e12
    assert tanalysis.HBM_BW == 3.35e12
    assert tanalysis.LINK_BW == 450e9
    assert tdryrun.HBM_PER_CHIP > 80e9
