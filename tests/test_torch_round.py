"""The port's SatQFLTrainer vs the JAX package's, on one trace and one split.

Per-round val loss ≤ 1e-5, accuracies within one sample, and accounting
(comm seconds, participants, bytes and transfers) exactly equal, for modes
qfl and sim. The port's batched executor is also held against its own
per-client oracle. One module-scoped fixture builds the trace and data
and runs the JAX trainers once.

The secure exchange (security qkd / qkd_fernet) runs on the JAX security
tests' fixture (12 satellites, 4 qubits, 1 layer): per-round metrics
within 1e-6 of the JAX trainer, accounting and QBER-abort sets exactly
equal, the port's edge-batched plane bit-exact against its per-edge
oracle, and the raise paths (QBER abort, MAC mismatch) raising
``SecurityError`` with the failing edges.

Item 9 runs on the same 12-satellite fixture: the parameter-shift
gradient (qfl and sim, batched executor and per-client oracle, each
against the JAX trainer's same executor) and teleport security (sim):
per-round metrics, ``teleport_fidelity`` and params within 1e-6 of the
JAX trainer, accounting exactly equal, and the trainer's teleport key
stream bit-equal.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core.round as round_mod
from repro.constellation import build_trace
from repro.core import SatQFLConfig as JaxConfig
from repro.core import SatQFLTrainer as JaxTrainer
from repro.data import dirichlet_partition, make_statlog, server_split
from repro.models import get_config as jax_get_config
from repro.models import get_model as jax_get_model
from repro.security.keys import canonical_edge
from repro_torch import data as tdata
from repro_torch.constellation import ConstellationTrace
from repro_torch.core import SatQFLConfig, SatQFLTrainer
from repro_torch.models import get_config, get_model
from repro_torch.security import SecurityError

N_SATS = 8
SMALL = dict(vqc_qubits=4, vqc_layers=2, n_features=4)
FL = dict(n_rounds=2, local_steps=3, batch_size=8)
MODES = ("qfl", "sim")


@pytest.fixture(scope="module")
def world():
    jtrace = build_trace(n_sats=N_SATS, n_planes=4, duration_s=1800,
                         step_s=60)
    trace = ConstellationTrace(**{f.name: getattr(jtrace, f.name)
                                  for f in dataclasses.fields(
                                      ConstellationTrace)})
    cfg_j = jax_get_config("vqc-satqfl").replace(**SMALL)
    X, y = make_statlog(n_features=4)
    Xc, yc, server = server_split(X, y)
    sats = dirichlet_partition(Xc, yc, N_SATS)
    jax_runs = {}
    for mode in MODES:
        tr = JaxTrainer(cfg_j, jax_get_model(cfg_j),
                        JaxConfig(mode=mode, **FL), jtrace, sats, server)
        tr.run()
        jax_runs[mode] = tr
    cfg = get_config("vqc-satqfl").replace(**SMALL)
    tX, ty = tdata.make_statlog(n_features=4, device="cpu")
    tXc, tyc, tserver = tdata.server_split(tX, ty)
    tsats = tdata.dirichlet_partition(tXc, tyc, N_SATS)

    def port(mode, batched=True, run=True, **kw):
        tr = SatQFLTrainer(cfg, get_model(cfg),
                           SatQFLConfig(mode=mode, **{**FL, **kw}), trace,
                           tsats, tserver, batched=batched, device="cpu")
        if run:
            tr.run()
        return tr

    n_val = int(tserver["val"]["labels"].shape[0])
    return jax_runs, port, n_val


def _assert_accounting_equal(a, b):
    for ma, mb in zip(a.history, b.history):
        assert ma.comm_s == mb.comm_s
        assert ma.security_s == mb.security_s
        assert ma.participants == mb.participants
    for f in ("transfer_s", "wait_s", "bytes_moved", "n_transfers",
              "per_round", "round_details"):
        assert getattr(a.log, f) == getattr(b.log, f), f


@pytest.mark.parametrize("mode", MODES)
def test_trainer_matches_jax(world, mode):
    jax_runs, port, n_val = world
    jt, tt = jax_runs[mode], port(mode)
    assert len(tt.history) == FL["n_rounds"]
    _assert_accounting_equal(tt, jt)
    for mt, mj in zip(tt.history, jt.history):
        np.testing.assert_allclose(mt.server_val_loss, mj.server_val_loss,
                                   atol=1e-5)
        np.testing.assert_allclose(mt.dev_val_loss, mj.dev_val_loss,
                                   atol=1e-5)
        for f in ("server_val_acc", "server_test_acc", "dev_train_acc"):
            assert abs(getattr(mt, f) - getattr(mj, f)) <= 1.0 / n_val + 1e-7
    for k, v in tt.global_params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jt.global_params[k]),
                                   atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_batched_matches_per_client_oracle(world, mode):
    """The stacked-client executor == the per-client loop (momentum, so
    the stacked optimizer slots and their scratch-row scatter count)."""
    _, port, _ = world
    tb = port(mode, batched=True, optimizer="momentum")
    to = port(mode, batched=False, optimizer="momentum")
    _assert_accounting_equal(tb, to)
    for mb, mo in zip(tb.history, to.history):
        np.testing.assert_allclose(mb.server_val_loss, mo.server_val_loss,
                                   atol=1e-6)
        np.testing.assert_allclose(mb.server_val_acc, mo.server_val_acc,
                                   atol=1e-6)
    for s in range(N_SATS):
        for k, v in to.opt_states[s].slots.items():
            np.testing.assert_allclose(tb._opt_stacked.slots[k][s].numpy(),
                                       v.numpy(), atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(mode="async", max_retries=2), dict(mode="seq", straggler_rate=0.1),
    dict(straggler_rate=0.2), dict(crash_rate=0.1)])
def test_trainer_runs_the_fault_plane(world, kw):
    """Each fault option runs: one FaultReport a round where a rate is set
    (none without), its crash and straggler counts the plan's, and each
    round's details carry it."""
    _, port, _ = world
    tr = port(**{"mode": "sim", **kw})
    f = tr.plan.faults
    assert len(tr.history) == FL["n_rounds"]
    assert len(tr.fault_reports) == (0 if f is None else FL["n_rounds"])
    for r, rep in enumerate(tr.fault_reports):
        assert rep.round == r
        assert (rep.crashes, rep.stragglers) == (int(f.crash[r].sum()),
                                                 int(f.straggler[r].sum()))
        assert tr.log.round_details[r]["faults"] == dataclasses.asdict(rep)


def test_checkpoints_written(world, tmp_path):
    """``run(ckpt_dir=...)`` writes a checkpoint after every round, and a
    fresh trainer's ``run`` on that directory resumes at the end."""
    from repro_torch.checkpoint import latest_step
    _, port, _ = world
    tr = port("qfl", run=False)
    assert tr.run(ckpt_dir=str(tmp_path)) == tr.history
    assert latest_step(str(tmp_path)) == FL["n_rounds"]
    assert sorted(os.listdir(tmp_path)) == [
        f"step_{r + 1:08d}.msgpack" for r in range(FL["n_rounds"])]
    fresh = port("qfl", run=False)
    assert len(fresh.run(ckpt_dir=str(tmp_path))) == FL["n_rounds"]
    for k, v in tr.global_params.items():
        assert torch.equal(fresh.global_params[k], v)


def test_trainer_signatures_match_jax():
    """The constructor takes the reference's parameters in its order
    (``sample_batch`` 8th, before ``eavesdrop_edges``; the port adds
    ``device`` last), so a positional call written for ``repro`` binds the
    same arguments; ``run`` takes the reference's checkpoint options with
    the reference's defaults."""
    import inspect
    want = inspect.signature(JaxTrainer.__init__).parameters
    got = inspect.signature(SatQFLTrainer.__init__).parameters
    assert list(got) == list(want) + ["device"]
    assert list(got).index("sample_batch") == 8          # after self
    want_run = inspect.signature(JaxTrainer.run).parameters
    got_run = inspect.signature(SatQFLTrainer.run).parameters
    assert list(got_run) == list(want_run)
    for name, p in want_run.items():
        assert got_run[name].default == p.default, name


def test_checkpoint_options_accepted(world, tmp_path):
    """A run written for ``repro`` with every checkpoint option runs: it
    checkpoints every ``ckpt_every`` rounds and after the last, and
    leaves exactly ``ckpt_keep`` checkpoints."""
    from repro_torch.checkpoint import latest_step
    _, port, _ = world
    tr = port("qfl", run=False)
    tr.run(ckpt_dir=str(tmp_path), ckpt_every=2, ckpt_keep=1)
    assert os.listdir(tmp_path) == [f"step_{FL['n_rounds']:08d}.msgpack"]
    assert latest_step(str(tmp_path)) == FL["n_rounds"]


def _tail_sampler(randint):
    """A sampler other than the default: a uniform batch from the second
    half of one client's rows, through ``randint(key, shape, lo, hi)``."""
    def sample(data, key, batch_size):
        n = next(iter(data.values())).shape[0]
        idx = randint(key, (batch_size,), n // 2, n)
        return {k: v[idx] for k, v in data.items()}
    return sample


def test_custom_sampler_refused():
    """A custom sampler, once refused, now trains as the JAX trainer's
    does: the per-client oracle whatever ``batched`` says, each step's
    batch drawn by the caller's function with the same keys. 2 sim rounds
    on the 12-satellite trace: metrics within 1e-6, accounting equal."""
    import jax
    from repro_torch import prng
    (jtrace, cfg_j, sats, server), (trace, cfg, tsats, tserver) = \
        _secure_setup()
    jt = JaxTrainer(cfg_j, jax_get_model(cfg_j),
                    JaxConfig(mode="sim", **SEC_FL), jtrace, sats, server,
                    sample_batch=_tail_sampler(jax.random.randint))
    tt = SatQFLTrainer(cfg, get_model(cfg),
                       SatQFLConfig(mode="sim", **SEC_FL), trace, tsats,
                       tserver, sample_batch=_tail_sampler(prng.randint),
                       device="cpu")
    assert not jt.batched and not tt.batched
    jt.run()
    tt.run()
    _assert_accounting_equal(tt, jt)
    for mt, mj in zip(tt.history, jt.history):
        for f in ("server_val_loss", "dev_val_loss", "server_val_acc",
                  "server_test_acc", "dev_train_acc"):
            np.testing.assert_allclose(getattr(mt, f), getattr(mj, f),
                                       atol=1e-6, err_msg=f)
    for k, v in tt.global_params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jt.global_params[k]),
                                   atol=1e-6)
    # the custom draws are not the default sampler's
    default = SatQFLTrainer(cfg, get_model(cfg),
                            SatQFLConfig(mode="sim", **SEC_FL), trace, tsats,
                            tserver, batched=False, device="cpu")
    default.run()
    assert any(abs(a.server_val_loss - b.server_val_loss) > 1e-6
               for a, b in zip(default.history, tt.history))


def test_default_sampler_is_the_bounded_sampler():
    """The default sampler draws what the executors' bounded sampler
    draws for one client's unpadded rows."""
    from repro_torch import prng
    from repro_torch.core.localtrain import sample_batch_bounded
    data = {"features": torch.arange(40.0).reshape(20, 2),
            "labels": torch.arange(20)}
    key = prng.PRNGKey(3, "cpu")
    got = round_mod.default_sample_batch(data, key, 8)
    want = sample_batch_bounded({k: v[None] for k, v in data.items()},
                                key[None], 8, 20)
    for k in data:
        assert torch.equal(got[k], want[k][0])


# ---------------------------------------------------------------------------
# the secure exchange plane (Algorithm 2)
# ---------------------------------------------------------------------------

SEC_SATS = 12
SEC_SMALL = dict(vqc_qubits=4, vqc_layers=1, n_features=4)
SEC_FL = dict(n_rounds=2, local_steps=2, batch_size=8)
SECURE = [("sim", "qkd"), ("qfl", "qkd"), ("sim", "qkd_fernet")]
# every edge touching satellites 0-2 eavesdropped (tests/
# test_batched_security.py:_eav_subset)
EAV = frozenset(canonical_edge((a, b)) for a in range(3)
                for b in list(range(SEC_SATS)) + ["gs"] if a != b)


def _secure_setup():
    """The 12-satellite trace, configs and data, in both packages."""
    jtrace = build_trace(n_sats=SEC_SATS, n_planes=4, duration_s=1800,
                         step_s=60)
    trace = ConstellationTrace(**{f.name: getattr(jtrace, f.name)
                                  for f in dataclasses.fields(
                                      ConstellationTrace)})
    cfg_j = jax_get_config("vqc-satqfl").replace(**SEC_SMALL)
    X, y = make_statlog(n_features=4)
    Xc, yc, server = server_split(X, y)
    sats = dirichlet_partition(Xc, yc, SEC_SATS)
    cfg = get_config("vqc-satqfl").replace(**SEC_SMALL)
    tX, ty = tdata.make_statlog(n_features=4, device="cpu")
    tXc, tyc, tserver = tdata.server_split(tX, ty)
    tsats = tdata.dirichlet_partition(tXc, tyc, SEC_SATS)
    return (jtrace, cfg_j, sats, server), (trace, cfg, tsats, tserver)


@pytest.fixture(scope="module")
def secure_world():
    """The JAX runs of every secure case once, and a cached port runner."""
    (jtrace, cfg_j, sats, server), (trace, cfg, tsats, tserver) = \
        _secure_setup()
    cases = [(m, s, frozenset(), "raise") for m, s in SECURE] + [
        (m, "qkd", EAV, "drop") for m in ("sim", "qfl")]
    jax_runs = {}
    for mode, sec, eav, abort in cases:
        tr = JaxTrainer(cfg_j, jax_get_model(cfg_j),
                        JaxConfig(mode=mode, security=sec,
                                  on_qber_abort=abort, **SEC_FL),
                        jtrace, sats, server, eavesdrop_edges=eav)
        tr.run()
        jax_runs[(mode, sec, eav)] = tr
    cache = {}

    def make(mode, security, eav=frozenset(), edge_batched=True,
             batched=True, **kw):
        fl = SatQFLConfig(mode=mode, security=security, **{**SEC_FL, **kw})
        return SatQFLTrainer(cfg, get_model(cfg), fl, trace, tsats, tserver,
                             eavesdrop_edges=eav, batched=batched,
                             edge_batched=edge_batched, device="cpu")

    def port(mode, security, eav=frozenset(), edge_batched=True,
             batched=True):
        key = (mode, security, eav, edge_batched, batched)
        if key not in cache:
            tr = make(mode, security, eav, edge_batched, batched,
                      on_qber_abort="drop" if eav else "raise")
            tr.run()
            cache[key] = tr
        return cache[key]

    return jax_runs, port, make


def _assert_bit_equal(a, b):
    for k in a:
        assert torch.equal(a[k].view(torch.int32), b[k].view(torch.int32)), k


@pytest.mark.parametrize("mode,security", SECURE)
def test_secure_trainer_matches_jax(secure_world, mode, security):
    jax_runs, port, _ = secure_world
    jt, tt = jax_runs[(mode, security, frozenset())], port(mode, security)
    assert tt.edge_batched and tt.log.security_s > 0
    _assert_accounting_equal(tt, jt)
    assert tt.aborted_edges == jt.aborted_edges == set()
    for mt, mj in zip(tt.history, jt.history):
        for f in ("server_val_loss", "dev_val_loss", "server_val_acc",
                  "server_test_acc", "dev_train_acc"):
            np.testing.assert_allclose(getattr(mt, f), getattr(mj, f),
                                       atol=1e-6, err_msg=f)
    for k, v in tt.global_params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jt.global_params[k]),
                                   atol=1e-6)


@pytest.mark.parametrize("mode,security", SECURE)
def test_edge_batched_matches_per_edge_oracle(secure_world, mode, security):
    """One secure stage per dispatch == one exchange per edge, to the bit;
    and the exchange is transparent (== the same run without security)."""
    _, port, make = secure_world
    tb, to = port(mode, security), port(mode, security, edge_batched=False)
    assert not to.edge_batched
    _assert_accounting_equal(tb, to)
    _assert_bit_equal(tb.global_params, to.global_params)
    plain = make(mode, "none")
    plain.run()
    _assert_bit_equal(tb.global_params, plain.global_params)


@pytest.mark.parametrize("mode", ["sim", "qfl"])
def test_qber_drop_matches_jax(secure_world, mode):
    """Eavesdropped edges abort in drop mode: the same edge set as the JAX
    trainer, on both of the port's planes and its per-client oracle, with
    exactly equal accounting."""
    jax_runs, port, _ = secure_world
    jt = jax_runs[(mode, "qkd", EAV)]
    runs = [port(mode, "qkd", EAV, eb, b)
            for eb, b in ((True, True), (False, True), (False, False))]
    assert jt.aborted_edges and jt.aborted_edges <= EAV
    for tr in runs:
        assert tr.aborted_edges == jt.aborted_edges
        _assert_accounting_equal(tr, jt)
    for mt, mj in zip(runs[0].history, jt.history):
        np.testing.assert_allclose(mt.server_val_loss, mj.server_val_loss,
                                   atol=1e-6)
    _assert_bit_equal(runs[0].global_params, runs[1].global_params)


@pytest.mark.parametrize("edge_batched", [True, False])
def test_qber_abort_raise_mode(secure_world, edge_batched):
    _, _, make = secure_world
    eav = frozenset((s, m) for s in range(SEC_SATS) for m in range(SEC_SATS))
    tr = make("sim", "qkd", eav, edge_batched, n_rounds=1)
    with pytest.raises(SecurityError) as ei:
        tr.run_round(0)
    assert isinstance(ei.value, ConnectionAbortedError)
    assert len(ei.value.edges) == 1 and ei.value.edges[0] in tr.aborted_edges


@pytest.mark.parametrize("edge_batched", [True, False])
def test_mac_mismatch_raises(secure_world, monkeypatch, edge_batched):
    """A receiver whose MAC check fails raises SecurityError naming the
    edges (never an assert, which python -O would strip)."""
    _, _, make = secure_world
    monkeypatch.setattr(round_mod, "_mac_rows_verify",
                        lambda sent, received: torch.zeros_like(
                            sent, dtype=torch.bool))
    tr = make("sim", "qkd", edge_batched=edge_batched, n_rounds=1)
    with pytest.raises(SecurityError) as ei:
        tr.run_round(0)
    assert ei.value.edges


def test_secure_stage_rejects_a_tampered_row(secure_world):
    """A wire-corruption word on a row fails that row's MAC only, and the
    row still comes back as the sender's payload (so a dropped row stays
    finite in the masked reduction), as the JAX stage decrypts the clean
    ciphertext."""
    _, _, make = secure_world
    tr = make("sim", "qkd", n_rounds=1)
    stacked = tr._broadcast_global(4)
    seeds = np.asarray([5, 6, 7, 0], np.uint32)
    mac = np.asarray([11, 12, 13, 14], np.uint32)
    tamper = np.asarray([0, 0x80000000, 0, 1], np.uint32)
    out, ok = tr._secure_stage(stacked, seeds, mac, mac[::-1].copy(), tamper)
    assert ok.tolist() == [True, False, True, False]
    _assert_bit_equal(out, stacked)


# ---------------------------------------------------------------------------
# item 9: the parameter-shift gradient and teleport security
# ---------------------------------------------------------------------------

ITEM9 = [("qfl", "none", "param_shift", True),
         ("qfl", "none", "param_shift", False),
         ("sim", "none", "param_shift", True),
         ("sim", "none", "param_shift", False),
         ("sim", "teleport", "autodiff", True)]


@pytest.fixture(scope="module")
def item9_world():
    """The JAX trainer on every item-9 case of ITEM9 once (the same
    executor as the port's run it is held against), and the port's."""
    (jtrace, cfg_j, sats, server), (trace, cfg, tsats, tserver) = \
        _secure_setup()
    runs = {}
    for case in ITEM9:
        mode, security, grad, batched = case
        kw = dict(mode=mode, security=security, grad_method=grad, **SEC_FL)
        jt = JaxTrainer(cfg_j, jax_get_model(cfg_j), JaxConfig(**kw), jtrace,
                        sats, server, batched=batched)
        jt.run()
        tt = SatQFLTrainer(cfg, get_model(cfg), SatQFLConfig(**kw), trace,
                           tsats, tserver, batched=batched, device="cpu")
        tt.run()
        runs[case] = (jt, tt)
    return runs


def _assert_metrics_close(tt, jt, atol):
    fields = ("server_val_loss", "dev_val_loss", "server_val_acc",
              "server_test_acc", "dev_train_acc", "teleport_fidelity")
    for mt, mj in zip(tt.history, jt.history):
        for f in fields:
            np.testing.assert_allclose(getattr(mt, f), getattr(mj, f),
                                       atol=atol, err_msg=f)
    for k, v in tt.global_params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jt.global_params[k]),
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("case", ITEM9[:4],
                         ids=["qfl-batched", "qfl-oracle", "sim-batched",
                              "sim-oracle"])
def test_param_shift_trainer_matches_jax(item9_world, case):
    jt, tt = item9_world[case]
    assert len(tt.history) == SEC_FL["n_rounds"]
    _assert_accounting_equal(tt, jt)
    _assert_metrics_close(tt, jt, 1e-6)


def test_teleport_trainer_matches_jax(item9_world):
    """sim under teleport security: the per-edge exchange teleports each
    payload's angle sample with a key split from the trainer's key, in the
    JAX trainer's exchange order (the keys end bit-equal); fidelity ~1,
    metrics within 1e-6, accounting (teleport time included) equal."""
    jt, tt = item9_world[ITEM9[4]]
    assert not tt.edge_batched and tt.log.security_s > 0
    _assert_accounting_equal(tt, jt)
    _assert_metrics_close(tt, jt, 1e-6)
    assert all(m.teleport_fidelity > 1 - 1e-5 for m in tt.history)
    np.testing.assert_array_equal(tt.key.numpy().astype(np.uint32),
                                  np.asarray(jt.key))
    assert tt.aborted_edges == jt.aborted_edges == set()
