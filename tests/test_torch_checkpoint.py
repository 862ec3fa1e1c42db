"""The port's round checkpoints vs the JAX package's.

- ``repro_torch.checkpoint.io`` on the six I/O cases of
  tests/test_checkpoint_and_analysis.py (round trip with a bf16 leaf,
  corruption, keep-last-N, shape mismatch, the metadata read's MAC, a torn
  ``.tmp``), and files crossing between the packages both ways;
- the port's msgpack codec: bytes equal to ``msgpack.packb(doc,
  use_bin_type=True)`` on the trainer's own metadata and on every length
  and int boundary of the subset, and each side reads the other's bytes;
- kill at round 2, restore into a fresh trainer, run on: params bit for
  bit (int32 views), history, fault reports and accounting equal to the
  uninterrupted run, for qfl / sim / seq / async under qkd with faults on
  both executors, and async with secagg and retries;
- a different config or executor is refused; ``run(ckpt_dir=...)``
  resumes;
- the port resumes a checkpoint the JAX trainer wrote after 2 of 4
  rounds to within 1e-6 of the JAX run, with equal fault reports and
  accounting, and the JAX trainer resumes the port's.

The JAX package's ``poly_mac_u32`` runs jitted here (its eager form takes
10-20 s per stream length); the bits are the same.
"""
import dataclasses
import math
import os

import jax
import msgpack
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_async import _port_model
from test_torch_async import make_data as make_crafted_data
from test_torch_async import make_trace as make_crafted_trace
from test_torch_faults import FAULTS, _dense

import repro.checkpoint.io as jax_io
import repro.security.mac as jax_mac
from repro.core import SatQFLConfig as JaxConfig
from repro.core import SatQFLTrainer as JaxTrainer
from repro.models import get_config as jax_get_config
from repro.models import get_model as jax_get_model
from repro_torch.checkpoint import (CheckpointCorrupt, CheckpointManager,
                                    codec, latest_step, load_checkpoint,
                                    read_metadata, save_checkpoint)
from repro_torch.core import SatQFLConfig, SatQFLTrainer

FL = dict(n_rounds=4, local_steps=2, batch_size=4)
RESUME_CASES = {
    **{m: dict(mode=m, security="qkd",
               max_retries=2 if m == "async" else 0, **FAULTS)
       for m in ("qfl", "sim", "seq", "async")},
    "async_secagg_retry": dict(mode="async", agg_security="secagg",
                               crash_rate=0.2, link_flap_rate=0.2,
                               max_retries=1, fault_seed=5),
}


@pytest.fixture
def jax_mac_jit(monkeypatch):
    monkeypatch.setattr(jax_mac, "poly_mac_u32",
                        jax.jit(jax_mac.poly_mac_u32))


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": torch.tensor(rng.normal(size=(8, 16)),
                          dtype=torch.float32).to(torch.bfloat16),
        "b": torch.tensor(rng.normal(size=(16,)), dtype=torch.float32),
        "step": torch.tensor(7, dtype=torch.int32),
        "nested": {"m": torch.tensor(rng.normal(size=(3, 3, 3)),
                                     dtype=torch.float32)},
    }


def _assert_trees_equal(a, b):
    from repro_torch.nn.pytree import tree_leaves
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# checkpoint I/O (the six cases of tests/test_checkpoint_and_analysis.py)
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 42, tree, {"note": "hello"})
    out, step, meta = load_checkpoint(str(tmp_path), tree)
    assert step == 42 and meta["note"] == "hello"
    _assert_trees_equal(tree, out)


def test_checkpoint_corruption_detected(tmp_path):
    tree = _tree()
    path = save_checkpoint(str(tmp_path), 1, tree)
    blob = bytearray(open(path, "rb").read())
    blob[-100] ^= 0xFF                     # flip a payload byte
    open(path, "wb").write(bytes(blob))
    with pytest.raises(CheckpointCorrupt):
        load_checkpoint(str(tmp_path), tree)


def test_checkpoint_manager_keeps_last_n(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.latest == 4
    assert sorted(os.listdir(tmp_path)) == ["step_00000003.msgpack",
                                            "step_00000004.msgpack"]
    _, step, _ = mgr.restore(tree)
    assert step == 4 and latest_step(str(tmp_path)) == 4
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path) + "/nope", tree)


def test_checkpoint_shape_mismatch(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 5, tree)
    with pytest.raises(ValueError):
        load_checkpoint(str(tmp_path),
                        dict(tree, w=torch.zeros((4, 4), dtype=torch.bfloat16)))
    with pytest.raises(ValueError):        # same shape, another dtype
        load_checkpoint(str(tmp_path),
                        dict(tree, b=torch.zeros((16,), dtype=torch.float64)))


def test_read_metadata_verifies_mac(tmp_path):
    path = save_checkpoint(str(tmp_path), 9, _tree(), {"round": 9})
    step, meta = read_metadata(str(tmp_path))
    assert step == 9 and meta["round"] == 9
    blob = bytearray(open(path, "rb").read())
    blob[-50] ^= 0xFF                      # corrupt the payload
    open(path, "wb").write(bytes(blob))
    # a metadata-only read still fails loudly on a corrupted payload
    with pytest.raises(CheckpointCorrupt):
        read_metadata(str(tmp_path))


def test_leftover_tmp_ignored_and_gced(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    mgr.save(1, tree)
    torn = tmp_path / "step_00000002.msgpack.tmp"
    torn.write_bytes(b"half-written garbage")
    assert latest_step(str(tmp_path)) == 1     # the .tmp is invisible
    _, step, _ = mgr.restore(tree)
    assert step == 1
    mgr.save(2, tree)                          # a save collects it
    assert not torn.exists()
    assert latest_step(str(tmp_path)) == 2


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_files_cross_between_packages(tmp_path, jax_mac_jit, writer):
    """A file one package writes, the other reads: the same leaves (a
    bf16 leaf as its bit pattern), step, metadata and MAC."""
    tree = _tree(3)
    jtree = {"w": jax.numpy.asarray(tree["w"].view(torch.int16).numpy())
             .view(jax.numpy.bfloat16),
             "b": jax.numpy.asarray(tree["b"].numpy()),
             "step": jax.numpy.asarray(7, jax.numpy.int32),
             "nested": {"m": jax.numpy.asarray(tree["nested"]["m"].numpy())}}
    meta = {"round": 3, "edges": [[1, "gs"], [2, 5]], "x": 0.25}
    if writer == "port":
        path = save_checkpoint(str(tmp_path), 3, tree, meta)
        out, step, got = jax_io.load_checkpoint(str(tmp_path), jtree)
        for k in ("b", "step"):
            np.testing.assert_array_equal(np.asarray(out[k]),
                                          np.asarray(jtree[k]))
        assert np.array_equal(np.asarray(out["w"]).view(np.uint16),
                              np.asarray(jtree["w"]).view(np.uint16))
    else:
        path = jax_io.save_checkpoint(str(tmp_path), 3, jtree, meta)
        out, step, got = load_checkpoint(str(tmp_path), tree)
        _assert_trees_equal(tree, out)
    assert step == 3 and got == meta
    doc = msgpack.unpackb(open(path, "rb").read(), raw=False)
    assert doc["mac"] == jax_io._mac_bytes(doc["payload"])


# ---------------------------------------------------------------------------
# the msgpack codec
# ---------------------------------------------------------------------------

EDGE_VALUES = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536,
    2 ** 31, 2 ** 32 - 1, 2 ** 32, 2 ** 63, 2 ** 64 - 1, -1, -32, -33,
    -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63,
    0.0, -0.0, 1.5, 1e300, float("inf"), float("-inf"), "", "é", "x" * 31,
    "x" * 32, "y" * 255, "y" * 256, "z" * 65535, "z" * 65536, b"",
    b"\x00" * 255, b"\x01" * 256, b"\x02" * 65536, [], (), list(range(15)),
    list(range(16)), tuple(range(70000)), {}, {str(i): i for i in range(15)},
    {str(i): i for i in range(16)}, {"a": {"b": [1, (2, 3), {"c": None}]}},
]


def test_codec_bytes_equal_msgpack_on_the_subset():
    for v in EDGE_VALUES:
        raw = msgpack.packb(v, use_bin_type=True)
        assert codec.packb(v) == raw, repr(v)[:60]
        back = codec.unpackb(raw)
        assert back == msgpack.unpackb(raw, raw=False), repr(v)[:60]
    nan = codec.unpackb(codec.packb(float("nan")))
    assert math.isnan(nan)
    for bad in (1 << 64, -(1 << 63) - 1, np.int64(3), object()):
        with pytest.raises((TypeError, OverflowError)):
            msgpack.packb(bad, use_bin_type=True)
        with pytest.raises((TypeError, OverflowError)):
            codec.packb(bad)


# ---------------------------------------------------------------------------
# the trainer: kill at round 2, resume
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def crafted():
    """The dense 5-satellite trace and data of tests/test_faults.py on
    both sides, and a port trainer factory."""
    jtrace, trace = make_crafted_trace(*_dense())
    (jsats, jserver), (sats, server) = make_crafted_data(5)
    cfg, api = _port_model()

    def port(fl: dict, batched=True):
        return SatQFLTrainer(cfg, api, SatQFLConfig(**{**FL, **fl}), trace,
                             sats, server, batched=batched, device="cpu")

    return dict(port=port, jtrace=jtrace, jsats=jsats, jserver=jserver)


def _history(tr) -> list:
    # NaN-aware: metrics of a round without evaluation are NaN
    return [{k: ("nan" if isinstance(v, float) and math.isnan(v) else v)
             for k, v in dataclasses.asdict(h).items()} for h in tr.history]


def _assert_resumed_equal(a, c):
    for k in a.global_params:
        assert torch.equal(a.global_params[k].view(torch.int32),
                           c.global_params[k].view(torch.int32)), k
    assert _history(a) == _history(c)
    assert a.fault_reports == c.fault_reports
    assert dataclasses.asdict(a.log) == dataclasses.asdict(c.log)
    assert a.aborted_edges == c.aborted_edges


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "oracle"])
@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_kill_and_resume_bit_identical(crafted, tmp_path, case, batched):
    fl = RESUME_CASES[case]
    a = crafted["port"](fl, batched)
    a.run()
    b = crafted["port"](fl, batched)
    for r in range(2):
        b.run_round(r)
    path = b.save_round_checkpoint(str(tmp_path))
    c = crafted["port"](fl, batched)
    assert c.restore_round_checkpoint(str(tmp_path)) == 2
    for r in range(2, 4):
        c.run_round(r)
    _assert_resumed_equal(a, c)
    assert sum(f.crashes + f.link_flaps for f in a.fault_reports) > 0
    # the file is msgpack, byte for byte as msgpack itself writes it
    raw = open(path, "rb").read()
    doc = msgpack.unpackb(raw, raw=False)
    assert msgpack.packb(doc, use_bin_type=True) == raw
    assert codec.packb(b._ckpt_state()[1]) == msgpack.packb(
        b._ckpt_state()[1], use_bin_type=True)


def test_resume_rejects_config_mismatch(crafted, tmp_path):
    tr = crafted["port"](dict(mode="sim"))
    tr.run_round(0)
    tr.save_round_checkpoint(str(tmp_path))
    with pytest.raises(ValueError, match="different SatQFLConfig"):
        crafted["port"](dict(mode="sim", lr=0.01)).restore_round_checkpoint(
            str(tmp_path))
    with pytest.raises(ValueError, match="fingerprint"):
        crafted["port"](dict(mode="sim"),
                        batched=False).restore_round_checkpoint(str(tmp_path))


def test_run_auto_resumes_from_checkpoint_dir(crafted, tmp_path):
    fl = dict(mode="sim", security="qkd", **FAULTS)
    a = crafted["port"](fl)
    a.run()
    b = crafted["port"](fl)
    for r in range(2):
        b.run_round(r)
    b.save_round_checkpoint(str(tmp_path))
    c = crafted["port"](fl)
    assert len(c.run(ckpt_dir=str(tmp_path))) == FL["n_rounds"]
    _assert_resumed_equal(a, c)
    assert latest_step(str(tmp_path)) == FL["n_rounds"]


def test_port_resumes_a_jax_checkpoint(crafted, tmp_path, jax_mac_jit):
    """The JAX trainer saves after 2 of 4 rounds (async qkd, faults and
    retries, momentum slots in its stacked optimizer) and runs on; the port
    restores that file and runs rounds 2-3, saving after round 3; the JAX
    trainer restores the port's file and runs round 3. Both ends within
    1e-6 of the JAX run, with its fault reports and accounting."""
    fl = dict(FL, mode="async", security="qkd", max_retries=2,
              optimizer="momentum", **FAULTS)
    jcfg = jax_get_config("vqc-satqfl").replace(vqc_qubits=2, vqc_layers=1,
                                                n_features=2)
    japi = jax_get_model(jcfg)

    def jax_trainer():
        return JaxTrainer(jcfg, japi, JaxConfig(**fl), crafted["jtrace"],
                          crafted["jsats"], crafted["jserver"])

    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    j = jax_trainer()
    for r in range(2):
        j.run_round(r)
    j.save_round_checkpoint(jdir)
    for r in range(2, 4):
        j.run_round(r)
    p = crafted["port"](fl)
    assert p.restore_round_checkpoint(jdir) == 2
    p.run_round(2)
    p.save_round_checkpoint(pdir)
    p.run_round(3)
    j2 = jax_trainer()
    assert j2.restore_round_checkpoint(pdir) == 3
    j2.run_round(3)
    for got in (p, j2):
        assert [dataclasses.asdict(f) for f in got.fault_reports] == \
            [dataclasses.asdict(f) for f in j.fault_reports]
        assert got.log.round_details == j.log.round_details
        assert [h.participants for h in got.history] == \
            [h.participants for h in j.history]
        for k in j.global_params:
            np.testing.assert_allclose(np.asarray(got.global_params[k]),
                                       np.asarray(j.global_params[k]),
                                       atol=1e-6, rtol=0, err_msg=k)
    assert sum(f.retries for f in j.fault_reports) > 0
