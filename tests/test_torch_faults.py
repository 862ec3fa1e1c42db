"""The port's fault plane vs the JAX package's (tests/test_faults.py).

On the JAX suite's 5-satellite dense trace (every secondary sees main 0
at every step, so every round has fault sites to hit) and on the
12-satellite secure trace of tests/test_torch_round.py, at the JAX suite's
rates (flap 0.3, crash 0.2, straggler 0.3, tamper 0.3, seed 11):

- ``fault_site_u32`` bit-exact over a grid of sites, and every
  ``FaultSchedule`` array exactly equal (none at zero rates);
- for qfl, sim, seq and async under qkd, both executors against the JAX
  trainer's batched executor (the JAX suite holds its own two executors
  to equal accounting and params within 1e-6): ``FaultReport``s equal
  site for site, round details (accounting) float-equal, delivered counts
  equal, params within 1e-6;
- ``on_fault='raise'`` raises the JAX trainer's subclass with its sites,
  and a spent retry budget raises ``RetryExhaustedError``;
- an async retransmission never exposes a pad twice: every seed the
  seeded OTP kernel's sender launch takes is distinct;
- without a fault plane, round details carry no ``faults`` key.

One module-scoped fixture runs each mode's JAX trainer once.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_async import _port_model
from test_torch_async import make_data as make_crafted_data
from test_torch_async import make_trace as make_crafted_trace

import repro_torch.kernels.otp_xor.ops as otp_ops
import repro.security.errors as jax_errors
import repro_torch.security.errors as errors
from repro.constellation import build_trace
from repro.core import SatQFLConfig as JaxConfig
from repro.core import SatQFLTrainer as JaxTrainer
from repro.core.plan import compile_round_plan as jax_compile
from repro.core.plan import fault_site_u32 as jax_fault_site
from repro.models import get_config as jax_get_config
from repro.models import get_model as jax_get_model
from repro_torch.constellation import ConstellationTrace
from repro_torch.core import SatQFLConfig, SatQFLTrainer
from repro_torch.core.plan import compile_round_plan, fault_site_u32

FAULTS = dict(link_flap_rate=0.3, crash_rate=0.2, straggler_rate=0.3,
              corrupt_rate=0.3, fault_seed=11)
FL = dict(n_rounds=4, local_steps=2, batch_size=4, eval_every=10 ** 6)
MODES = ("qfl", "sim", "seq", "async")
SCHEDULE_FIELDS = ("crash", "straggler", "link_flap", "tamper", "attempt",
                   "flap_events", "retry_events", "lost_events",
                   "recovered_events", "recovered")
SEC_SATS = 12


def _dense(N=5, R=4):
    """The JAX suite's dense trace: mains 0 and N-1, every secondary on
    main 0's ISL at every step."""
    sg = np.zeros((N, R), bool)
    sg[0, :] = True
    sg[N - 1, :] = True
    ss = np.zeros((N, N, R), bool)
    ss[1:, 0, :] = True
    return sg, ss


def _fl(mode, **kw):
    return dict(FL, mode=mode, security="qkd",
                max_retries=2 if mode == "async" else 0, **FAULTS, **kw)


@pytest.fixture(scope="module")
def world():
    """The dense trace, its data and models on both sides, and each mode's
    JAX trainer (batched executor) once."""
    jtrace, trace = make_crafted_trace(*_dense())
    (jsats, jserver), (sats, server) = make_crafted_data(5)
    jcfg = jax_get_config("vqc-satqfl").replace(vqc_qubits=2, vqc_layers=1,
                                                n_features=2)
    japi = jax_get_model(jcfg)
    jax_runs = {}
    for mode in MODES:
        tr = JaxTrainer(jcfg, japi, JaxConfig(**_fl(mode)), jtrace, jsats,
                        jserver)
        tr.run()
        jax_runs[mode] = tr
    cfg, api = _port_model()

    def port(fl: dict, batched=True, edge_batched=True):
        return SatQFLTrainer(cfg, api, SatQFLConfig(**fl), trace, sats,
                             server, batched=batched,
                             edge_batched=edge_batched, device="cpu")

    def jax_trainer(fl: dict):
        return JaxTrainer(jcfg, japi, JaxConfig(**fl), jtrace, jsats,
                          jserver)

    return dict(jtrace=jtrace, trace=trace, jax_runs=jax_runs, port=port,
                jax_trainer=jax_trainer)


@pytest.fixture(scope="module")
def secure_traces():
    """The 12-satellite secure trace, built by the JAX package and handed
    to the port as the same arrays."""
    jtrace = build_trace(n_sats=SEC_SATS, n_planes=4, duration_s=1800,
                         step_s=60)
    trace = ConstellationTrace(**{f.name: getattr(jtrace, f.name)
                                  for f in dataclasses.fields(
                                      ConstellationTrace)})
    return jtrace, trace


def _assert_schedules_equal(pt, pj):
    ft, fj = pt.faults, pj.faults
    assert ft is not None and fj is not None
    for f in SCHEDULE_FIELDS:
        a, b = getattr(ft, f), getattr(fj, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("seed", "n_sats", "link_flap_rate", "crash_rate",
              "straggler_rate", "corrupt_rate", "straggler_extra_s",
              "max_retries", "retry_backoff_steps"):
        assert getattr(ft, f) == getattr(fj, f), f
    for r in range(pt.n_rounds):
        assert pt.live_groups(r) == pj.live_groups(r)
        assert pt.live_sats(r) == pj.live_sats(r)
        np.testing.assert_array_equal(pt.fault_mask(r, "cpu").numpy(),
                                      np.asarray(pj.fault_mask(r)))
    np.testing.assert_array_equal(pt.edges.src, pj.edges.src)
    np.testing.assert_array_equal(pt.edges.ptr, pj.edges.ptr)
    np.testing.assert_array_equal(pt.edges.born, pj.edges.born)


def _reports(tr) -> list:
    return [dataclasses.asdict(f) for f in tr.fault_reports]


# ---------------------------------------------------------------------------
# the fault-site hash and the compiled schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["flap", "crash", "strag", "tamper"])
def test_fault_site_u32_matches_jax(kind):
    for seed in (0, 11, 0xFFFFFFFF, 2 ** 40 + 3):
        for r in (0, 1, 7, 1000):
            for a, b in ((0, 0), (3, 12), (49, 50), (11, 2)):
                for attempt in (0, 1, 6):
                    s = seed & 0xFFFFFFFF
                    got = fault_site_u32(s, kind, r, a, b, attempt)
                    want = jax_fault_site(s, kind, r, a, b, attempt)
                    assert got.dtype == want.dtype == np.uint32
                    assert int(got) == int(want), (seed, r, a, b, attempt)


@pytest.mark.parametrize("where", ["dense", "secure"])
@pytest.mark.parametrize("mode", ["sim", "async"])
def test_fault_schedule_matches_jax(world, secure_traces, mode, where):
    """Every FaultSchedule array (crash, straggler, flap and tamper sites,
    attempts and the retransmit ledger), the live groups and the health
    vector, exactly as the JAX plan compiles them."""
    jt, tt = ((world["jtrace"], world["trace"]) if where == "dense"
              else secure_traces)
    fl = dict(_fl(mode), n_rounds=4 if where == "dense" else 3)
    pj = jax_compile(jt, JaxConfig(**fl), with_seeds=False)
    pt = compile_round_plan(tt, SatQFLConfig(**fl), with_seeds=False)
    _assert_schedules_equal(pt, pj)
    f = pt.faults
    assert f.crash.any() and f.tamper.any()
    assert not (f.crash & f.straggler).any()
    assert (f.tamper[f.tamper != 0] & 1).all()      # never a zero XOR
    if mode == "async":
        # arrivals carry the retransmit ledger's outcome, never a flap
        assert not f.link_flap[pt.edges.mask & (pt.edges.link == 0)].any()


def test_zero_rates_compile_no_schedule(world):
    fl = SatQFLConfig(**dict(FL, mode="async", security="qkd",
                             max_retries=2))
    pt = compile_round_plan(world["trace"], fl, with_seeds=False)
    assert pt.faults is None
    assert pt.fault_mask(0, "cpu").tolist() == [1.0] * pt.n_sats
    assert pt.live_sats(0) == list(range(pt.n_sats))


# ---------------------------------------------------------------------------
# the trainer under faults: both executors against the JAX trainer's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batched", [True, False], ids=["batched", "oracle"])
@pytest.mark.parametrize("mode", MODES)
def test_fault_parity_with_jax(world, mode, batched):
    jt = world["jax_runs"][mode]
    tt = world["port"](_fl(mode), batched=batched)
    tt.run()
    assert _reports(tt) == _reports(jt)
    assert sum(f.crashes + f.link_flaps + f.corruptions
               for f in tt.fault_reports) > 0, "degenerate: no fault hit"
    assert tt.log.round_details == jt.log.round_details
    for f in ("transfer_s", "wait_s", "security_s", "bytes_moved",
              "n_transfers"):
        assert getattr(tt.log, f) == getattr(jt.log, f), f
    assert tt.aborted_edges == jt.aborted_edges
    for a, b in zip(tt.history, jt.history):
        assert (a.participants, a.comm_s, a.security_s) == \
            (b.participants, b.comm_s, b.security_s)
    for k, v in tt.global_params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jt.global_params[k]),
                                   atol=1e-6, rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# on_fault='raise'
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,err", [
    (dict(crash_rate=1.0), "SatCrashError"),
    (dict(link_flap_rate=1.0), "LinkFlapError"),
    (dict(corrupt_rate=1.0, security="qkd"), "CorruptionError"),
], ids=["crash", "flap", "corrupt"])
def test_on_fault_raise_matches_jax(world, kw, err):
    fl = dict(FL, mode="sim", on_fault="raise", fault_seed=11, **kw)
    with pytest.raises(getattr(jax_errors, err)) as ej:
        world["jax_trainer"](fl).run()
    with pytest.raises(getattr(errors, err)) as et:
        world["port"](fl).run()
    assert isinstance(et.value, errors.FaultError)
    assert et.value.sites and et.value.sites == ej.value.sites


def test_retry_exhaustion_raises(world):
    """Under flap rate 1 and one retry, async updates are lost; the first
    lossy round raises RetryExhaustedError (it outranks the round's
    plain flaps), with the JAX trainer's sites and ledger."""
    fl = dict(FL, mode="async", n_rounds=4, link_flap_rate=1.0,
              max_retries=1, fault_seed=11)
    tt = world["port"](fl)
    tt.run()
    lossy = [f.round for f in tt.fault_reports if f.lost > 0]
    assert lossy, "degenerate: flap_rate=1.0 lost nothing"
    jt = world["jax_trainer"](fl)
    np.testing.assert_array_equal(tt.plan.faults.lost_events,
                                  jt.plan.faults.lost_events)
    with pytest.raises(jax_errors.RetryExhaustedError) as ej:
        jt._raise_round_faults(lossy[0])
    with pytest.raises(errors.RetryExhaustedError) as et:
        tt._raise_round_faults(lossy[0])
    assert et.value.sites == ej.value.sites


# ---------------------------------------------------------------------------
# one pad per (edge, born) under async retransmission
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batched", [True, False], ids=["batched", "oracle"])
def test_async_retransmit_recovers_without_pad_reuse(world, monkeypatch,
                                                     batched):
    """A flapped attempt drops the link before ciphertext moves, so the
    retransmission is its pad's first exposure: every pad seed that the
    seeded OTP kernel's sender launches take is distinct (the edge-batched
    stage's rows without an edge carry seed 0 and expose nothing)."""
    used = []
    stream, rows = (otp_ops.otp_xor_mac_stream_seeded,
                    otp_ops.otp_xor_mac_rows_seeded)

    def spy_stream(msg, seed, *a, tag_input=False, **kw):
        if not tag_input:
            used.append(int(seed) & 0xFFFFFFFF)
        return stream(msg, seed, *a, tag_input=tag_input, **kw)

    def spy_rows(msg, seeds, *a, tag_input=False, **kw):
        if not tag_input:
            used.extend(int(s) & 0xFFFFFFFF for s in seeds.tolist() if s)
        return rows(msg, seeds, *a, tag_input=tag_input, **kw)

    monkeypatch.setattr(otp_ops, "otp_xor_mac_stream_seeded", spy_stream)
    monkeypatch.setattr(otp_ops, "otp_xor_mac_rows_seeded", spy_rows)
    fl = dict(FL, mode="async", n_rounds=6, security="qkd",
              link_flap_rate=0.4, fault_seed=3, max_retries=2)
    sg, ss = _dense(R=6)
    _, trace = make_crafted_trace(sg, ss)
    _, (sats, server) = make_crafted_data(5)
    cfg, api = _port_model()
    tr = SatQFLTrainer(cfg, api, SatQFLConfig(**fl), trace, sats, server,
                       batched=batched, edge_batched=batched, device="cpu")
    tr.run()
    rep = {k: sum(getattr(f, k) for f in tr.fault_reports)
           for k in ("retries", "recovered", "link_flaps")}
    assert rep["retries"] > 0, "degenerate: no retransmission exercised"
    assert rep["recovered"] > 0, "retransmit never recovered a delivery"
    assert used and len(used) == len(set(used)), "a pad went out twice"


def test_fault_free_round_details_carry_no_fault_key(world):
    fl = dict(FL, mode="sim", security="qkd")
    for batched in (True, False):
        tr = world["port"](fl, batched=batched)
        tr.run()
        assert tr.plan.faults is None and tr.fault_reports == []
        assert all("faults" not in d for d in tr.log.round_details)
