"""The port's in-graph round (``repro_torch.core.dist``), ``RoundPlan.
dist_inputs`` and the ``--fl`` launcher vs the JAX package's.

On ``tests/test_core_dist.py``'s fixture (6 satellites, 4 qubits, 1 layer,
E = 2 local steps of batch 8), with inputs made by numpy from a seed and
carried across by ``convert.params_from_jax``. One module fixture runs each
JAX round once. Held to the JAX package: every (mode, security) round's
params, optimizer slots, stale buffers and loss to 1e-6 and its round
index exactly; the OTP ciphertexts, MAC tags, the initial state, the plan's
inputs and the fault-mask identities bit for bit; the secagg masks to 2e-6
and the secagg round to 1e-5; the launcher's final params to 1e-6 on the
same argv.
"""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.launch.train as jax_train
from repro.constellation import build_trace as jax_build_trace
from repro.core import SatQFLConfig as JaxConfig
from repro.core import dist as jdist
from repro.core.plan import compile_round_plan as jax_compile
from repro.models import get_config as jax_get_config
from repro.models import get_model as jax_get_model
from repro.nn import optim as joptim
from repro.security.otp import tree_to_u32_rows as jax_to_u32_rows
from repro_torch import convert, prng
from repro_torch.constellation import ConstellationTrace
from repro_torch.core import SatQFLConfig, compile_round_plan
from repro_torch.core import dist
from repro_torch.launch import train as port_train
from repro_torch.models import get_config, get_model
from repro_torch.nn import optim
from repro_torch.nn.pytree import tree_leaves
from repro_torch.security.mac import mac_verify_rows
from repro_torch.security.otp import tree_to_u32_rows, u32_to_tree_rows

N, E, B = 6, 2, 8
SMALL = dict(vqc_qubits=4, vqc_layers=1, n_features=4)
MASK = np.array([1, 1, 0, 1, 0, 1], np.float32)
SEEDS = np.arange(N, dtype=np.uint32) + 11
WEIGHTS = np.array([1.0, 2.0, 1.0, 3.0, 1.0, 2.0], np.float32)
CRASH = np.array([1, 0, 1, 1, 0, 1], np.float32)
ROUNDS = [("sim", "none"), ("sim", "otp"), ("sim", "secagg"),
          ("async", "none"), ("async", "otp"), ("seq", "none"),
          ("seq", "otp")]


def _batches(seed: int, steps: int = E) -> dict:
    rng = np.random.default_rng(seed)
    return {"features": rng.uniform(0, np.pi, (N, steps, B, 4)
                                    ).astype(np.float32),
            "labels": rng.integers(0, 7, (N, steps, B))}


class World:
    """Both packages' configs and initial states, and memoized rounds:
    ``jax(...)`` and ``port(...)`` run one round of the same case once."""

    def __init__(self):
        self.cfg_j = jax_get_config("vqc-satqfl").replace(**SMALL)
        self.api_j = jax_get_model(self.cfg_j)
        self.cfg = get_config("vqc-satqfl").replace(**SMALL)
        self.api = get_model(self.cfg)
        self.batches = _batches(1)
        self.jax = lru_cache(maxsize=None)(self._jax)
        self.port = lru_cache(maxsize=None)(self._port)

    def states(self, opt: str):
        js = jdist.fl_init_state(self.cfg_j, self.api_j,
                                 getattr(joptim, opt)(0.1), N,
                                 jax.random.PRNGKey(0))
        ts = dist.fl_init_state(self.cfg, self.api,
                                getattr(optim, opt)(0.1), N,
                                prng.PRNGKey(0, "cpu"))
        return js, ts

    def _fl(self, mode, **kw):
        return dict(mode=mode, local_steps=E, batch_size=B, **kw)

    def _jax(self, mode, security, opt="sgd", weights=None, fault=None,
             mask=None, batches_seed=1, steps=E, hops=2, **kw):
        fl = JaxConfig(**self._fl(mode, **kw))
        rf = jax.jit(jdist.make_fl_round(self.cfg_j, self.api_j, fl,
                                         getattr(joptim, opt)(0.1), N,
                                         security=security, seq_hops=hops))
        b = _batches(batches_seed, steps)
        args = [self.states(opt)[0],
                {k: jnp.asarray(v) for k, v in b.items()},
                jnp.asarray(MASK if mask is None else np.asarray(mask)),
                jnp.asarray(SEEDS),
                None if weights is None else jnp.asarray(np.asarray(weights)),
                None if fault is None else jnp.asarray(np.asarray(fault))]
        with jax.sharding.Mesh(np.array(jax.devices()), ("data",)):
            state, metrics = rf(*args)
        return (jax.tree_util.tree_map(np.asarray, state),
                {k: np.asarray(v) for k, v in metrics.items()})

    def _port(self, mode, security, opt="sgd", weights=None, fault=None,
              mask=None, batches_seed=1, steps=E, hops=2, api=None, **kw):
        fl = SatQFLConfig(**self._fl(mode, **kw))
        rf = dist.make_fl_round(self.cfg, api or self.api, fl,
                                getattr(optim, opt)(0.1), N,
                                security=security, seq_hops=hops)
        t = lambda x: None if x is None else torch.tensor(
            np.asarray(x, np.float32))
        return rf(self.states(opt)[1],
                  convert.params_from_jax(_batches(batches_seed, steps),
                                          "cpu"),
                  t(MASK if mask is None else mask),
                  torch.tensor(SEEDS.astype(np.int64)), t(weights),
                  t(fault))


@pytest.fixture(scope="module")
def world():
    return World()


def _np(x) -> np.ndarray:
    """A tensor's values; a bfloat16 leaf as its 16-bit patterns."""
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy()
    return x.numpy()


def _leaves_np(tree) -> list:
    return [_np(x) for x in tree_leaves(tree)]


def _jleaves(tree) -> list:
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _assert_close(port_tree, jax_tree, atol):
    a, b = _leaves_np(port_tree), _jleaves(jax_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape
        np.testing.assert_allclose(x, y, rtol=0, atol=atol)


def _assert_bits(a, b):
    la, lb = _leaves_np(a), _leaves_np(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and np.array_equal(
            x.view(np.uint8), y.view(np.uint8))


def _assert_state_close(ts, tm, js, jm, atol):
    _assert_close(ts.params, js.params, atol)
    _assert_close(ts.opt_slots, js.opt_slots, atol)
    _assert_close(ts.stale, js.stale, atol)
    np.testing.assert_array_equal(ts.stale_age.numpy(), js.stale_age)
    assert ts.stale_age.dtype == torch.int32
    assert int(ts.round_idx) == int(js.round_idx) == 1
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("mode,security", ROUNDS)
def test_round_matches_jax(world, mode, security):
    """Every (mode, security) of the JAX suite's synchronisation test:
    within 1e-6 of the JAX round (1e-5 under secagg, whose masks are
    within 2 ulp of JAX's normal draws), every row the aggregate. (The
    fault-mask cases below hold momentum's slots.)"""
    ts, tm = world.port(mode, security)
    js, jm = world.jax(mode, security)
    _assert_state_close(ts, tm, js, jm, 1e-5 if security == "secagg"
                        else 1e-6)
    assert torch.isfinite(tm["loss"])
    for leaf in tree_leaves(ts.params):
        assert torch.equal(leaf, leaf[:1].expand(leaf.shape))


def test_fl_init_state_bit_equal(world):
    for opt in ("sgd", "momentum"):
        js, ts = world.states(opt)
        _assert_bits(ts.params, convert.params_from_jax(
            jax.tree_util.tree_map(np.asarray, js.params), "cpu"))
        _assert_close(ts.opt_slots, js.opt_slots, 0.0)
        _assert_close(ts.stale, js.stale, 0.0)
        assert ts.stale_age.tolist() == [-1] * N
        assert ts.round_idx.dtype == torch.int32 and int(ts.round_idx) == 0


def test_otp_bitexact_transparent(world):
    """OTP's encrypt and decrypt cancel bit for bit: the round equals the
    unsecured one."""
    _assert_bits(world.port("sim", "otp")[0].params,
                 world.port("sim", "none")[0].params)


@pytest.mark.parametrize("mode", ["sim", "qfl"])
def test_otp_gather_verifies_mac_and_matches(world, mode):
    """otp_gather: every sender's tag verifies at the aggregator
    (``mac_ok``), the aggregate is bit-equal to plain otp's, and the round
    is within 1e-6 of JAX's."""
    ts, tm = world.port(mode, "otp_gather")
    assert tm["mac_ok"].dtype == torch.bool and bool(tm["mac_ok"])
    assert "mac_ok" not in world.port(mode, "otp")[1]
    _assert_bits(ts.params, world.port(mode, "otp")[0].params)
    js, jm = world.jax(mode, "otp_gather")
    assert bool(jm["mac_ok"])
    _assert_state_close(ts, tm, js, jm, 1e-6)


def _mixed_tree(seed: int):
    """A stacked tree of f32, bf16 (odd length), f16 and i32 leaves."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=(N,) + s).astype(np.float32)
    jt = {"a": f(3, 5), "b": jnp.asarray(f(7)).astype(jnp.bfloat16),
          "c": f(2, 3).astype(np.float16),
          "d": rng.integers(-2 ** 31, 2 ** 31, (N, 4)).astype(np.int32)}
    return jt, convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jt), "cpu")


def test_otp_stacked_and_mac_tags_bit_equal():
    jt, tt = _mixed_tree(3)
    seeds = np.array([0, 1, 2 ** 32 - 1, 7, 0xA5A5A5A5, 12345], np.uint32)
    s_t = torch.tensor(seeds.astype(np.int64))
    ct_j = jax.jit(jdist.otp_stacked)(jt, jnp.asarray(seeds))
    ct_t = dist.otp_stacked(tt, s_t)
    _assert_bits(ct_t, convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, ct_j), "cpu"))
    _assert_bits(dist.otp_stacked(ct_t, s_t), tt)
    tags_j, r_j, s_j = jax.jit(jdist.mac_tags_stacked)(ct_j,
                                                       jnp.asarray(seeds))
    tags_t, r_t, s_t2 = dist.mac_tags_stacked(ct_t, s_t)
    for a, b in ((tags_t, tags_j), (r_t, r_j), (s_t2, s_j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b, np.int64))
    rows = tree_to_u32_rows(ct_t)
    np.testing.assert_array_equal(rows.numpy(),
                                  np.asarray(jax_to_u32_rows(ct_j), np.int64))
    assert bool(mac_verify_rows(rows, tags_t, r_t, s_t2).all())
    # one flipped word of row 2 fails that row's MAC and no other
    bad = rows.clone()
    bad[2, 5] ^= 1
    assert mac_verify_rows(bad, tags_t, r_t, s_t2).tolist() == [
        True, True, False, True, True, True]


def test_otp_gather_receiver_catches_a_flipped_word():
    """otp_gather's own check, as ``round_fn`` runs it: the sender's
    launch gives ``otp_stacked``'s ciphertext and ``mac_tags_stacked``'s
    tags, the aggregator's launch decrypts and tags what arrived, and one
    word flipped in transit makes that row's tags differ from its sender's
    and no other row's, so ``mac_ok`` would read false."""
    _, tt = _mixed_tree(4)
    seeds = torch.tensor([0, 1, 2 ** 32 - 1, 7, 0xA5A5A5A5, 12345])
    s = dist._round_seeds(seeds, 3, dist._OTP_MIX)
    ct, tags = dist._gather_send(tt, s)
    _assert_bits(ct, dist.otp_stacked(tt, s))
    np.testing.assert_array_equal(
        (tags.to(torch.int64) & 0xFFFFFFFF).numpy(),
        dist.mac_tags_stacked(ct, s)[0].numpy())
    moved, rx = dist._gather_receive(ct, s)
    _assert_bits(moved, tt)
    assert torch.equal(rx, tags)
    rows = tree_to_u32_rows(ct)
    rows[2, 5] ^= 1 << 9
    _, rx_bad = dist._gather_receive(u32_to_tree_rows(rows, ct), s)
    assert (rx_bad == tags).tolist() == [i != 2 for i in range(N)]


def test_secagg_mask_close_to_jax():
    """The masks are JAX's normal draws to 2 ulp: ≤ 2e-6 on each leaf,
    and the telescoping sum of the masks vanishes."""
    jt, tt = _mixed_tree(4)
    jt, tt = {"a": jt["a"], "b": jt["b"]}, {"a": tt["a"], "b": tt["b"]}
    seeds = np.array([5, 9, 2 ** 31, 3, 77, 1], np.uint32)
    mj = jdist.secagg_mask(jt, jnp.asarray(seeds), 1000)
    mt = dist.secagg_mask(tt, torch.tensor(seeds.astype(np.int64)), 1000)
    np.testing.assert_allclose(mt["a"].numpy(), np.asarray(mj["a"]), rtol=0,
                               atol=2e-6)
    # the bf16 leaf is masked in float32 and rounded back
    np.testing.assert_allclose(mt["b"].float().numpy(),
                               np.asarray(mj["b"], np.float32), rtol=0,
                               atol=2e-6 + 2 ** -6 * 4)
    m = mt["a"] - tt["a"]
    assert float(m.abs().max()) > 0.1
    assert float(m.sum(0).abs().max()) < 1e-5


def test_secagg_round_close_to_plain(world):
    _assert_close(world.port("sim", "secagg")[0].params,
                  world.port("sim", "none")[0].params, 1e-5)


def test_secagg_masks_blind_individuals():
    """One masked update differs from the raw update; the mean over the
    satellites is preserved (the masks telescope)."""
    ex = dist.make_secure_exchange("secagg")
    tree = {"w": torch.ones((4, 8))}
    masked = ex(tree, torch.arange(4), torch.zeros((), dtype=torch.int32))
    assert float((masked["w"] - tree["w"]).abs().max()) > 0.1
    assert abs(float(masked["w"].mean()) - 1.0) < 1e-5


@pytest.mark.parametrize("mode,security", [
    ("seq", "otp_gather"), ("async", "otp_gather"), ("async", "secagg"),
    ("seq", "secagg"), ("qfl", "secagg")])
def test_rejected_mode_security(world, mode, security):
    fl = SatQFLConfig(mode=mode, local_steps=E, batch_size=B)
    with pytest.raises(ValueError):
        dist.make_fl_round(world.cfg, world.api, fl, optim.sgd(0.1), N,
                           security=security)


def test_unknown_security_rejected():
    with pytest.raises(ValueError):
        dist.make_secure_exchange("tls")


def test_param_shift_requires_quantum_model(world):
    fl = SatQFLConfig(mode="sim", grad_method="param_shift")
    with pytest.raises(ValueError, match="shift_grad"):
        dist.make_fl_round(world.cfg, world.api._replace(shift_grad=None),
                           fl, optim.sgd(0.1), N)


def test_secagg_rejects_fault_mask_at_call_time(world):
    fl = SatQFLConfig(mode="sim", local_steps=E, batch_size=B)
    rf = dist.make_fl_round(world.cfg, world.api, fl, optim.sgd(0.1), N,
                            security="secagg")
    ts = world.states("sgd")[1]
    with pytest.raises(ValueError, match="secagg"):
        rf(ts, convert.params_from_jax(world.batches, "cpu"),
           torch.ones(N), torch.zeros(N, dtype=torch.int64), None,
           torch.ones(N))


def test_async_all_zero_mask_keeps_model(world):
    """Nobody delivers and no buffer is usable: the model is kept (not
    zeroed by a zero-weight mean), and every buffer ages."""
    ts, _ = world.port("async", "none", mask=(0.0,) * N)
    _assert_bits(ts.params, world.states("sgd")[1].params)
    assert ts.stale_age.tolist() == [0] * N
    js, _ = world.jax("async", "none", mask=(0.0,) * N)
    np.testing.assert_array_equal(ts.stale_age.numpy(), js.stale_age)


def _max_diff(a, b) -> float:
    return max(float((x - y).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_seq_differs_from_sim(world):
    assert _max_diff(world.port("seq", "none")[0].params,
                     world.port("sim", "none")[0].params) > 1e-6


def test_seq_hops_consume_distinct_batches(world):
    """Hop h trains on slice h: changing only the second slice changes the
    result, on both packages alike."""
    s1 = world.port("seq", "none", steps=2 * E, batches_seed=5)[0]
    b = _batches(5, 2 * E)
    b2 = {k: v.copy() for k, v in b.items()}
    b2["features"][:, E:] = _batches(6, E)["features"]
    fl = SatQFLConfig(mode="seq", local_steps=E, batch_size=B)
    rf = dist.make_fl_round(world.cfg, world.api, fl, optim.sgd(0.1), N,
                            seq_hops=2)
    s2 = rf(world.states("sgd")[1], convert.params_from_jax(b2, "cpu"),
            torch.tensor(MASK), torch.tensor(SEEDS.astype(np.int64)))[0]
    assert _max_diff(s1.params, s2.params) > 1e-7
    js, jm = world.jax("seq", "none", steps=2 * E, batches_seed=5)
    _assert_close(s1.params, js.params, 1e-6)


def test_weights_reach_the_aggregate(world):
    ts, tm = world.port("sim", "none", weights=tuple(WEIGHTS))
    assert _max_diff(ts.params, world.port("sim", "none")[0].params) > 1e-7
    js, jm = world.jax("sim", "none", weights=tuple(WEIGHTS))
    _assert_state_close(ts, tm, js, jm, 1e-6)


def test_param_shift_round(world):
    """The shift rule trains the model autodiff trains (≤ 1e-4) and
    matches the JAX shift-rule round (≤ 1e-6)."""
    ts, tm = world.port("sim", "none", grad_method="param_shift")
    _assert_close(ts.params, world.jax("sim", "none")[0].params, 1e-4)
    js, jm = world.jax("sim", "none", grad_method="param_shift")
    _assert_state_close(ts, tm, js, jm, 1e-6)


@pytest.mark.parametrize("mode,security", [("sim", "none"), ("sim", "otp"),
                                           ("async", "otp"), ("seq", "otp")])
def test_fault_mask_round_matches_jax(world, mode, security):
    ts, tm = world.port(mode, security, "momentum", weights=tuple(WEIGHTS),
                        fault=tuple(CRASH))
    js, jm = world.jax(mode, security, "momentum", weights=tuple(WEIGHTS),
                       fault=tuple(CRASH))
    _assert_state_close(ts, tm, js, jm, 1e-6)
    # the crashed rows' optimizer slots are frozen bit for bit
    s0 = world.states("momentum")[1].opt_slots
    for new, old in zip(tree_leaves(ts.opt_slots), tree_leaves(s0)):
        for row in np.where(CRASH == 0)[0]:
            assert torch.equal(new[row], old[row])


def test_fault_mask_identities(world):
    """tests/test_faults.py's identities, bit for bit: an all-ones mask is
    no mask, a crash is a zero FedAvg weight, and all crashed keeps the
    model."""
    w = tuple(WEIGHTS)
    plain = world.port("sim", "none", weights=w)[0]
    _assert_bits(world.port("sim", "none", weights=w,
                            fault=(1.0,) * N)[0].params, plain.params)
    _assert_bits(world.port("sim", "none", weights=w,
                            fault=tuple(CRASH))[0].params,
                 world.port("sim", "none",
                            weights=tuple(WEIGHTS * CRASH))[0].params)
    _assert_bits(world.port("sim", "none", weights=w,
                            fault=(0.0,) * N)[0].params,
                 world.states("sgd")[1].params)


# ---------------------------------------------------------------------------
# the plan's inputs and the launcher
# ---------------------------------------------------------------------------

def test_plan_dist_inputs_match_jax():
    """``plan.dist_inputs(r)`` on the 12-satellite secure trace of
    tests/test_torch_plan.py: masks and weights float32 and equal, seeds
    the JAX plan's uint32 values as int64 words, for every round."""
    jt = jax_build_trace(n_sats=12, n_planes=4, duration_s=1800, step_s=60)
    trace = ConstellationTrace(**{k: getattr(jt, k) for k in (
        "times_s", "sat_pos", "sg_access", "ss_access", "gs_names",
        "n_sats")})
    counts = list(range(30, 42))
    fl = dict(mode="sim", n_rounds=4, security="qkd", seed=3,
              weight_by_samples=True)
    pj = jax_compile(jt, JaxConfig(**fl), sample_counts=counts)
    pt = compile_round_plan(trace, SatQFLConfig(**fl), sample_counts=counts,
                            device="cpu")
    for r in range(4):
        got, want = pt.dist_inputs(r, "cpu"), pj.dist_inputs(r)
        for a, b, dtype in zip(got, want, (torch.float32, torch.int64,
                                           torch.float32)):
            assert a.dtype == dtype and a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(
                a.numpy().dtype))
    assert pt.seeds.any() and len(set(pt.weights.tolist())) > 1


@pytest.fixture(scope="module")
def jax_launcher():
    """The JAX launcher's final state for an argv (``main`` discards the
    value ``run_fl`` returns, so it is caught on the way out)."""
    cache = {}

    def run(argv):
        key = tuple(argv)
        if key not in cache:
            caught = []
            orig = jax_train.run_fl
            jax_train.run_fl = lambda a: caught.append(orig(a))
            try:
                jax_train.main(list(argv))
            finally:
                jax_train.run_fl = orig
            cache[key] = caught[0]
        return cache[key]

    return run


def _final_params(x):
    return x.global_params if hasattr(x, "global_params") else x.params


@pytest.mark.parametrize("extra", [
    ["--mode", "sim", "--security", "otp"], ["--mode", "async"],
    ["--engine", "host", "--mode", "sim"]],
    ids=["dist-sim-otp", "dist-async", "host-sim"])
def test_launcher_matches_jax(jax_launcher, extra):
    argv = ["--fl", "--rounds", "2", "--sats", "6"] + extra
    got = port_train.main(argv + ["--device", "cpu"])
    want = jax_launcher(argv)
    pg, pw = _final_params(got), _final_params(want)
    if not hasattr(got, "global_params"):
        assert int(got.round_idx) == 2
    assert sorted(pg) == sorted(pw)
    for k in pw:
        np.testing.assert_allclose(pg[k].numpy(), np.asarray(pw[k]), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_launcher_host_perclient_matches_host():
    """The per-client oracle engine ends where the batched one does."""
    argv = ["--fl", "--rounds", "2", "--sats", "6", "--mode", "sim",
            "--device", "cpu"]
    a = port_train.main(argv + ["--engine", "host"])
    b = port_train.main(argv + ["--engine", "host-perclient"])
    assert a.batched and not b.batched
    for k in a.global_params:
        np.testing.assert_allclose(a.global_params[k].numpy(),
                                   b.global_params[k].numpy(), rtol=0,
                                   atol=1e-6)


def test_launcher_runs_on_the_card_by_default():
    """Without --device the launcher asks for CUDA: here, with no card, it
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py runs this path")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_train.main(["--fl", "--rounds", "1", "--sats", "4"])


def test_launcher_lm_path_not_ported():
    """The LM path runs every family, the encdec and vlm archs included:
    each trains one smoke step on the CPU to a finite loss (their
    batches carry the launcher's stubbed embeddings)."""
    for arch in ("llama-3.2-vision-90b", "whisper-tiny"):
        losses = port_train.main(["--device", "cpu", "--arch", arch,
                                  "--smoke", "--steps", "1", "--batch", "2",
                                  "--seq", "16"])
        assert len(losses) == 1 and np.isfinite(losses[0])


@pytest.mark.parametrize("flag", [["--arch", "tinyllama-1.1b"], ["--smoke"],
                                  ["--steps", "100"], ["--seq", "64"],
                                  ["--optimizer", "adamw"]])
def test_launcher_refuses_lm_flags(flag):
    """The LM path's own flags are refused with --fl, which does not read
    them, rather than accepted and ignored."""
    with pytest.raises(SystemExit):
        port_train.main(["--fl", "--device", "cpu"] + flag)
