"""The port's SatQFLTrainer vs the JAX package's, on one trace and one split.

Per-round val loss ≤ 1e-5, accuracies within one sample, and accounting
(comm seconds, participants, bytes and transfers) exactly equal, for modes
qfl and sim. The port's batched executor is also held against its own
per-client oracle. One module-scoped fixture builds the trace and data
and runs the JAX trainers once.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.constellation import build_trace
from repro.core import SatQFLConfig as JaxConfig
from repro.core import SatQFLTrainer as JaxTrainer
from repro.data import dirichlet_partition, make_statlog, server_split
from repro.models import get_config as jax_get_config
from repro.models import get_model as jax_get_model
from repro_torch import data as tdata
from repro_torch.constellation import ConstellationTrace
from repro_torch.core import SatQFLConfig, SatQFLTrainer
from repro_torch.models import get_config, get_model

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

    def port(mode, batched=True, **kw):
        tr = SatQFLTrainer(cfg, get_model(cfg),
                           SatQFLConfig(mode=mode, **{**FL, **kw}), trace,
                           tsats, tserver, batched=batched, device="cpu")
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


@pytest.mark.parametrize("kw,item", [
    (dict(mode="seq"), "item 7"), (dict(security="qkd"), "item 6"),
    (dict(straggler_rate=0.2), "item 8"),
    (dict(grad_method="param_shift"), "item 9")])
def test_trainer_refuses_what_is_not_ported(world, kw, item):
    _, port, _ = world
    with pytest.raises(NotImplementedError, match=item):
        port(**{"mode": "sim", **kw})


def test_checkpoints_refused(world):
    _, port, _ = world
    tr = port("qfl", n_rounds=1)
    with pytest.raises(NotImplementedError, match="item 8"):
        tr.run(ckpt_dir="unused")
