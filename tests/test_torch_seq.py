"""The port's sequential mode (seq) vs the JAX package, on the 12-satellite
secure trace of tests/test_torch_round.py (4 qubits, 1 layer).

Each group's secondaries train as a serial chain (hop h trains on hop
h-1's model) and a QBER-aborted hop reverts its chain. Against the JAX
trainer's same executor, under security none, qkd (with eavesdropped
edges dropping hops) and teleport: accounting, delivered counts and abort
sets exactly equal, per-round metrics and params within 1e-6, the keyed
EdgeSchedule of the hop stages equal array for array. The port's batched
executor (one stage per hop across all chains) against its per-client
oracle: accounting exactly equal, params bit for bit; its edge-batched
plane against the per-edge oracle, bit for bit.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.constellation import build_trace
from repro.core import SatQFLConfig as JaxConfig
from repro.core import SatQFLTrainer as JaxTrainer
from repro.core.plan import compile_round_plan as jax_compile
from repro.data import dirichlet_partition, make_statlog, server_split
from repro.models import get_config as jax_get_config
from repro.models import get_model as jax_get_model
from repro.security.keys import KeyManager as JaxKeyManager
from repro.security.keys import canonical_edge
from repro_torch import data as tdata
from repro_torch import prng
from repro_torch.constellation import ConstellationTrace
from repro_torch.core import SatQFLConfig, SatQFLTrainer
from repro_torch.core.plan import compile_round_plan
from repro_torch.models import get_config, get_model
from repro_torch.security.keys import KeyManager

SEC_SATS = 12
SEC_SMALL = dict(vqc_qubits=4, vqc_layers=1, n_features=4)
SEC_FL = dict(mode="seq", n_rounds=2, local_steps=2, batch_size=8)
# every edge touching satellites 0-2 eavesdropped, as in
# tests/test_torch_round.py
EAV = frozenset(canonical_edge((a, b)) for a in range(3)
                for b in list(range(SEC_SATS)) + ["gs"] if a != b)
# (security, eavesdropped edges, executor the JAX trainer runs)
CASES = [("none", frozenset(), True), ("qkd", EAV, True),
         ("teleport", frozenset(), False)]
IDS = ["none", "qkd-drop", "teleport"]
EDGE_FIELDS = ("n_stages", "ptr", "src", "dst", "link", "conc", "mask",
               "first", "born", "abort", "seed", "mac_r", "mac_s")


def _fl(security, eav):
    return dict(SEC_FL, security=security,
                on_qber_abort="drop" if eav else "raise")


@pytest.fixture(scope="module")
def seq_world():
    """The JAX trainer on every case once, and a cached port runner."""
    jtrace = build_trace(n_sats=SEC_SATS, n_planes=4, duration_s=1800,
                         step_s=60)
    trace = ConstellationTrace(**{f.name: getattr(jtrace, f.name)
                                  for f in dataclasses.fields(
                                      ConstellationTrace)})
    X, y = make_statlog(n_features=4)
    Xc, yc, server = server_split(X, y)
    sats = dirichlet_partition(Xc, yc, SEC_SATS)
    cfg_j = jax_get_config("vqc-satqfl").replace(**SEC_SMALL)
    jax_runs = {}
    for security, eav, batched in CASES:
        tr = JaxTrainer(cfg_j, jax_get_model(cfg_j),
                        JaxConfig(**_fl(security, eav)), jtrace, sats,
                        server, eavesdrop_edges=eav, batched=batched)
        tr.run()
        jax_runs[security] = tr
    cfg = get_config("vqc-satqfl").replace(**SEC_SMALL)
    tX, ty = tdata.make_statlog(n_features=4, device="cpu")
    tXc, tyc, tserver = tdata.server_split(tX, ty)
    tsats = tdata.dirichlet_partition(tXc, tyc, SEC_SATS)
    cache = {}

    def port(security, eav, batched=True, edge_batched=True):
        key = (security, batched, edge_batched)
        if key not in cache:
            tr = SatQFLTrainer(cfg, get_model(cfg),
                               SatQFLConfig(**_fl(security, eav)), trace,
                               tsats, tserver, eavesdrop_edges=eav,
                               batched=batched, edge_batched=edge_batched,
                               device="cpu")
            tr.run()
            cache[key] = tr
        return cache[key]

    return jax_runs, port, jtrace, trace


def _assert_accounting_equal(a, b):
    for ma, mb in zip(a.history, b.history):
        assert (ma.participants, ma.comm_s, ma.security_s) == \
            (mb.participants, mb.comm_s, mb.security_s)
    for f in ("round_details", "wait_s", "transfer_s", "security_s",
              "bytes_moved", "n_transfers"):
        assert getattr(a.log, f) == getattr(b.log, f), f
    assert a.aborted_edges == b.aborted_edges


def _assert_metrics_close(a, b, atol=1e-6, fidelity=True):
    fields = ["server_val_loss", "dev_val_loss", "server_val_acc",
              "server_test_acc", "dev_train_acc"]
    for ma, mb in zip(a.history, b.history):
        for f in fields + (["teleport_fidelity"] if fidelity else []):
            np.testing.assert_allclose(getattr(ma, f), getattr(mb, f),
                                       atol=atol, rtol=0, err_msg=f)
    for k, v in a.global_params.items():
        w = b.global_params[k]
        np.testing.assert_allclose(
            v.numpy(), w.numpy() if isinstance(w, torch.Tensor)
            else np.asarray(w), atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("security,eav,batched", CASES, ids=IDS)
def test_seq_trainer_matches_jax(seq_world, security, eav, batched):
    jax_runs, port, _, _ = seq_world
    jt, tt = jax_runs[security], port(security, eav, batched)
    assert len(tt.history) == SEC_FL["n_rounds"]
    assert max(int(n) for n in tt.plan.edges.n_stages) > 2   # chains hop
    _assert_accounting_equal(tt, jt)
    _assert_metrics_close(tt, jt)
    if security == "teleport":
        # the exchanges split the trainer's key in the JAX trainer's order
        np.testing.assert_array_equal(tt.key.numpy().astype(np.uint32),
                                      np.asarray(jt.key))
        assert all(m.teleport_fidelity > 1 - 1e-5 for m in tt.history)


@pytest.mark.parametrize("security,eav,batched", CASES, ids=IDS)
def test_seq_batched_matches_oracle(seq_world, security, eav, batched):
    """One stage per hop across all chains == each chain walked hop by hop
    on the per-client loop: accounting exactly, params bit for bit (a
    client trains to the same bits in a stage of any size; the teleport
    draws follow each executor's exchange order but leave the payload
    as sent)."""
    _, port, _, _ = seq_world
    tb, to = port(security, eav, True), port(security, eav, False)
    assert tb.batched and not to.batched
    _assert_accounting_equal(tb, to)
    _assert_metrics_close(tb, to, fidelity=False)
    for k in tb.global_params:
        assert torch.equal(tb.global_params[k].view(torch.int32),
                           to.global_params[k].view(torch.int32)), k


def test_seq_qber_drop_reverts_chain(seq_world):
    """An eavesdropped hop aborts (dropped, not raised) and its chain
    reverts to the pre-hop model: the abort set is the JAX trainer's, fewer
    updates are delivered than without eavesdroppers, and the edge-batched
    plane equals the per-edge oracle bit for bit."""
    jax_runs, port, _, _ = seq_world
    tb = port("qkd", EAV)
    to = port("qkd", EAV, edge_batched=False)
    es = tb.plan.edges
    hop_aborts = [(r, j) for r in range(es.n_stages.shape[0])
                  for j in range(int(es.ptr[r, int(es.n_stages[r]) - 1]))
                  if es.abort[r, j]]
    assert hop_aborts                       # an ISL hop of a chain aborts
    assert tb.aborted_edges == jax_runs["qkd"].aborted_edges
    clean = port("none", frozenset())
    assert sum(m.participants for m in tb.history) \
        < sum(m.participants for m in clean.history)
    _assert_accounting_equal(tb, to)
    for k in tb.global_params:
        assert torch.equal(tb.global_params[k].view(torch.int32),
                           to.global_params[k].view(torch.int32)), k


def test_seq_keyed_plan_matches_jax(seq_world):
    """The hop stages of every round (one per chain position, then the
    feeder), their pad seeds, MAC keys and aborts, exactly as the JAX plan
    compiles them."""
    _, _, jtrace, trace = seq_world
    fl = _fl("qkd", EAV)
    pj = jax_compile(jtrace, JaxConfig(**fl), with_seeds=False,
                     keymgr=JaxKeyManager(jax.random.PRNGKey(7),
                                          eavesdrop_edges=EAV))
    pt = compile_round_plan(trace, SatQFLConfig(**fl),
                            keymgr=KeyManager(prng.PRNGKey(7, "cpu"),
                                              eavesdrop_edges=EAV),
                            with_seeds=False)
    for f in EDGE_FIELDS:
        a, b = getattr(pt.edges, f), getattr(pj.edges, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert pt.stale is None and pj.stale is None
