"""Port constellation, config, comm model and plan compiler vs the JAX package.

The plan logic is held first on a trace built by the JAX package (plain
numpy), array for array and exactly; then the port's own trace is held
equal to the JAX package's (access exactly, positions to one float32
ulp at LEO radii), and so is the plan compiled from it.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.constellation import build_trace as jax_build_trace
from repro.core import CommLog as JaxCommLog
from repro.core import CommModel as JaxCommModel
from repro.core import SatQFLConfig as JaxConfig
from repro.core.plan import compile_round_plan as jax_compile
from repro.security.keys import KeyManager as JaxKeyManager
from repro.security.keys import canonical_edge
from repro_torch import prng
from repro_torch.constellation import ConstellationTrace, build_trace
from repro_torch.core import CommLog, CommModel, SatQFLConfig
from repro_torch.core.plan import compile_round_plan
from repro_torch.security.keys import KeyManager

TRACE_ARGS = dict(n_sats=12, n_planes=4, duration_s=1800, step_s=60)
PLAN_FIELDS = ("t_idx", "primary_mask", "assignment", "part_mask", "hops",
               "latency_s", "window_wait_s", "group_size", "seeds", "weights")
EDGE_FIELDS = ("n_stages", "ptr", "src", "dst", "link", "conc", "mask",
               "first", "born", "abort", "seed", "mac_r", "mac_s")


@pytest.fixture(scope="module")
def traces():
    jt = jax_build_trace(**TRACE_ARGS)
    return jt, build_trace(**TRACE_ARGS, device="cpu")


def _as_port_trace(jt):
    return ConstellationTrace(**{f.name: getattr(jt, f.name)
                                 for f in dataclasses.fields(
                                     ConstellationTrace)})


def _assert_plans_equal(pt, pj, latency_rtol=0.0):
    assert (pt.n_rounds, pt.n_sats, pt.step_s) == (pj.n_rounds, pj.n_sats,
                                                   pj.step_s)
    for f in PLAN_FIELDS:
        a, b = getattr(pt, f), getattr(pj, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_allclose(a, b, rtol=latency_rtol if f == "latency_s"
                                   else 0.0, atol=0, err_msg=f)
    for f in EDGE_FIELDS:
        a, b = getattr(pt.edges, f), getattr(pj.edges, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert pt.edges.with_keys == pj.edges.with_keys
    for r in range(pt.n_rounds):
        assert pt.groups(r) == pj.groups(r)
        assert pt.unreachable(r) == pj.unreachable(r)
        assert pt.participants(r) == pj.participants(r)
        for j in range(int(pt.edges.ptr[r, -1])):
            assert pt.edges.edge_tuple(r, j) == pj.edges.edge_tuple(r, j)


@pytest.mark.parametrize("mode", ["qfl", "sim"])
def test_plan_on_jax_trace_is_exact(traces, mode):
    jt, _ = traces
    counts = list(range(30, 42))
    fl = dict(mode=mode, n_rounds=4, h_max=2)
    pj = jax_compile(jt, JaxConfig(**fl), sample_counts=counts,
                     with_seeds=False)
    pt = compile_round_plan(_as_port_trace(jt), SatQFLConfig(**fl),
                            sample_counts=counts, with_seeds=False)
    _assert_plans_equal(pt, pj)


def test_port_trace_and_its_plan_match(traces):
    jt, tt = traces
    np.testing.assert_array_equal(tt.times_s, jt.times_s)
    for f in ("sg_access", "ss_access"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f),
                                      err_msg=f)
    # float32 trig: at most one ulp (2^-10 km at LEO radii) per coordinate
    np.testing.assert_allclose(tt.sat_pos, jt.sat_pos, rtol=0,
                               atol=2.0 ** -10)
    # latency sums ISL distances of those positions: measured 8.5e-8
    # relative apart; every discrete plan array stays exactly equal
    fl = dict(mode="sim", n_rounds=3)
    _assert_plans_equal(compile_round_plan(tt, SatQFLConfig(**fl),
                                           with_seeds=False),
                        jax_compile(jt, JaxConfig(**fl), with_seeds=False),
                        latency_rtol=1e-6)


@pytest.mark.parametrize("bad", [
    dict(mode="ring"), dict(security="tls"), dict(on_qber_abort="retry"),
    dict(agg_security="he"), dict(agg_security="secagg", mode="sim"),
    dict(max_staleness=-1), dict(n_rounds=0), dict(local_steps=0),
    dict(batch_size=0), dict(crash_rate=1.5), dict(straggler_extra_s=-1.0),
    dict(on_fault="ignore"), dict(max_retries=-1),
    dict(retry_backoff_steps=0), dict(max_retries=2, mode="sim"),
    dict(corrupt_rate=0.1)])
def test_config_rejections_match(bad):
    with pytest.raises(ValueError):
        JaxConfig(**bad)
    with pytest.raises(ValueError):
        SatQFLConfig(**bad)


FAULT_FIELDS = ("crash", "straggler", "link_flap", "tamper", "attempt",
                "flap_events", "retry_events", "lost_events",
                "recovered_events", "recovered")


@pytest.mark.parametrize("kw", [
    dict(mode="async", crash_rate=0.1), dict(mode="async", link_flap_rate=0.1),
    dict(straggler_rate=0.1), dict(security="qkd", corrupt_rate=0.1),
    dict(crash_rate=0.1), dict(link_flap_rate=0.1)])
def test_plan_fault_schedule_matches_jax(traces, kw):
    """Each single fault rate compiles, into the JAX plan's FaultSchedule
    and the JAX plan's stages (crashed senders leave them) exactly."""
    jt, _ = traces
    fl = dict(n_rounds=2, fault_seed=5, **kw)
    pj = jax_compile(jt, JaxConfig(**fl), with_seeds=False)
    pt = compile_round_plan(_as_port_trace(jt), SatQFLConfig(**fl),
                            with_seeds=False)
    _assert_plans_equal(pt, pj)
    assert pt.faults is not None
    for f in FAULT_FIELDS:
        a, b = getattr(pt.faults, f), getattr(pj.faults, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for r in range(2):
        assert pt.live_groups(r) == pj.live_groups(r)
        assert pt.live_sats(r) == pj.live_sats(r)


# every edge touching satellites 0-2 eavesdropped, as in
# tests/test_batched_security.py
EAV = frozenset(canonical_edge((a, b)) for a in range(3)
                for b in list(range(12)) + ["gs"] if a != b)


@pytest.mark.parametrize("eav", [frozenset(), EAV], ids=["clean", "eav"])
@pytest.mark.parametrize("mode", ["qfl", "sim"])
def test_keyed_edge_schedule_matches_jax(traces, mode, eav):
    """seed, mac_r, mac_s, first and abort of every (round, edge), keyed
    by the trainer's registry (one batched BB84), equal to the JAX plan's."""
    jt, _ = traces
    fl = dict(mode=mode, n_rounds=4, security="qkd")
    pj = jax_compile(jt, JaxConfig(**fl), with_seeds=False,
                     keymgr=JaxKeyManager(jax.random.PRNGKey(7),
                                          eavesdrop_edges=eav))
    pt = compile_round_plan(_as_port_trace(jt), SatQFLConfig(**fl),
                            keymgr=KeyManager(prng.PRNGKey(7, "cpu"),
                                              eavesdrop_edges=eav),
                            with_seeds=False)
    _assert_plans_equal(pt, pj)
    es = pt.edges
    assert es.with_keys and es.abort.any() == bool(eav)
    assert not es.abort[~es.mask].any()


@pytest.mark.parametrize("mode", ["qfl", "sim"])
def test_teleport_plan_matches_jax(traces, mode):
    """Teleport security compiles the keyed plan too (the JAX trainer hands
    its registry over whenever security is not 'none'): its abort masks
    and key columns equal the JAX plan's."""
    jt, _ = traces
    fl = dict(mode=mode, n_rounds=4, security="teleport")
    pj = jax_compile(jt, JaxConfig(**fl), with_seeds=False,
                     keymgr=JaxKeyManager(jax.random.PRNGKey(7),
                                          eavesdrop_edges=EAV))
    pt = compile_round_plan(_as_port_trace(jt), SatQFLConfig(**fl),
                            keymgr=KeyManager(prng.PRNGKey(7, "cpu"),
                                              eavesdrop_edges=EAV),
                            with_seeds=False)
    _assert_plans_equal(pt, pj)
    assert pt.edges.with_keys and pt.edges.abort.any()


@pytest.mark.parametrize("mode", ["qfl", "sim"])
def test_seed_schedule_matches_jax(traces, mode):
    """with_seeds: the per-(round, satellite) uplink seeds from a registry
    made from fl.seed, equal to the JAX plan's default."""
    jt, _ = traces
    fl = dict(mode=mode, n_rounds=3, security="qkd", seed=3)
    pj = jax_compile(jt, JaxConfig(**fl))
    pt = compile_round_plan(_as_port_trace(jt), SatQFLConfig(**fl),
                            with_seeds=True, device="cpu")
    assert pt.seeds.any()
    _assert_plans_equal(pt, pj)


def test_plan_seeds_by_default_match_jax(traces):
    """``compile_round_plan(trace, fl)`` with no ``with_seeds`` fills the
    uplink pad seeds as the JAX package's default does, bit for bit (the
    port's default was once False, which left every seed 0)."""
    jt, _ = traces
    fl = dict(mode="sim", n_rounds=3, security="qkd")
    pj = jax_compile(jt, JaxConfig(**fl))
    pt = compile_round_plan(_as_port_trace(jt), SatQFLConfig(**fl),
                            device="cpu")
    assert pj.seeds.any() and pt.seeds.dtype == pj.seeds.dtype
    np.testing.assert_array_equal(pt.seeds, pj.seeds)


def test_comm_model_and_log_match():
    cj, ct = JaxCommModel(), CommModel()
    for n, c in ((1000, 1), (123457, 3), (8, 16)):
        assert ct.isl_transfer(n, c) == cj.isl_transfer(n, c)
        assert ct.feeder_transfer(n, c) == cj.feeder_transfer(n, c)
    assert ct.qkd_time(512) == cj.qkd_time(512)
    lj, lt = JaxCommLog(), CommLog()
    for log in (lj, lt):
        for r in range(3):
            log.count_transfer(100 * (r + 1))
            log.add_wall(0.5 * r)
            log.add_wait(0.25)
            log.close_round()
    assert lt.round_details == lj.round_details
    assert (lt.per_round, lt.total_s) == (lj.per_round, lj.total_s)
