"""The rest of the ported files' public API against their ``repro`` twins.

Case for case as ``tests/test_{constellation,quantum,nn}.py`` use them:
the topology helpers equal on a 12- and a 50-satellite trace (one trace
built by the JAX package, read by both); the statevector gates within
1e-6 and ``sample_measure``'s outcomes equal; ``qber_estimate`` and
``encrypt_flat_u32`` bit for bit; the tree helpers exactly; the LM loss
and the GELU MLP within 1e-6; ``prng.normal`` within 2 ulp of
``jax.random.normal``; every name the JAX package's ``nn``,
``quantum``, ``security``, ``constellation``, ``core``, ``kernels``,
``configs`` and ``data`` export; and the kernel exports in the JAX call
forms.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.constellation as jcon
import repro.nn as jnn
import repro.quantum as jq
from repro.security import otp as jotp
from repro_torch import convert, prng
import repro_torch.constellation as tcon
import repro_torch.nn as tnn
import repro_torch.quantum as tq
from repro_torch.security import otp as totp


@pytest.fixture(scope="module", params=[(12, 4), (50, 10)],
                ids=["12sat", "50sat"])
def traces(request):
    n, planes = request.param
    jt = jcon.build_trace(n_sats=n, n_planes=planes, duration_s=1800,
                          step_s=60)
    tt = tcon.ConstellationTrace(**{f.name: getattr(jt, f.name)
                                    for f in dataclasses.fields(
                                        tcon.ConstellationTrace)})
    return jt, tt


def test_topology_matches_jax(traces):
    jt, tt = traces
    for t in (0, jt.n_steps // 2, jt.n_steps - 1):
        for a, b in zip(tcon.partition_roles(tt, t),
                        jcon.partition_roles(jt, t)):
            np.testing.assert_array_equal(a, b)
        assert tcon.assign_secondaries(tt, t) == jcon.assign_secondaries(jt,
                                                                         t)
        for kw in ({}, dict(h_max=2, l_max_s=0.05), dict(h_max=1)):
            # the scalar oracle: the JAX package's BFS, reach, hops and
            # latency all equal
            part, hops, lat = tcon.isl_routes(tt, t, **kw)
            jp, jh, jl = jcon.isl_routes(jt, t, **kw)
            for x, y in ((part, jp), (hops, jh), (lat, jl)):
                np.testing.assert_array_equal(x, y)
            # the batched relaxation against the JAX relaxation (to its
            # float32 distances), and against the oracle: the same reach
            # and hops where L_max is slack, a latency never above the
            # BFS's first-found one
            bp, bh, bl = (a[0] for a in tcon.isl_routes_batched(tt, [t],
                                                                 **kw))
            jbp, jbh, jbl = (a[0] for a in jcon.isl_routes_batched(jt, [t],
                                                                   **kw))
            np.testing.assert_array_equal(bp, jbp)
            np.testing.assert_array_equal(bh, jbh)
            np.testing.assert_allclose(bl, jbl, rtol=1e-6)
            assert (bp >= part).all()
            assert (bl[part] <= lat[part] * (1 + 1e-6)).all()
    for sat in range(0, jt.n_sats, 5):
        assert tcon.access_windows(tt, sat) == jcon.access_windows(jt, sat)
        assert (tcon.access_windows(tt, sat, ground=0)
                == jcon.access_windows(jt, sat, ground=0))
        other = (sat + 1) % jt.n_sats
        assert (tcon.access_windows(tt, sat, other=other)
                == jcon.access_windows(jt, sat, other=other))
    for kw in ({}, dict(h_max=2, l_max_s=0.05, round_stride=3)):
        np.testing.assert_array_equal(
            tcon.participation_series(tt, 7, **kw),
            jcon.participation_series(jt, 7, **kw))


def _states(nq: int, batch: int, seed: int):
    rng = np.random.default_rng(seed)
    st = (rng.normal(size=(batch, 2 ** nq))
          + 1j * rng.normal(size=(batch, 2 ** nq))).astype(np.complex64)
    st /= np.linalg.norm(st, axis=-1, keepdims=True)
    return jnp.asarray(st), torch.tensor(st)


def _close(a, b, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=atol)


def test_statevector_gates_match_jax():
    np.testing.assert_array_equal(tq.Y.numpy(), np.asarray(jq.statevector.Y))
    js, ts = _states(3, 4, 0)
    for q in range(3):
        for theta in (0.3, -2.1):
            _close(tq.apply_ry(ts, theta, q), jq.apply_ry(js, theta, q))
            _close(tq.apply_rz(ts, theta, q), jq.apply_rz(js, theta, q))
    th = np.array([0.2, -1.0, 2.5, 0.7], np.float32)    # one per state
    _close(tq.apply_ry(ts, torch.tensor(th), 1),
           jq.apply_ry(js, jnp.asarray(th), 1))
    _close(tq.apply_rz(ts, torch.tensor(th), 2),
           jq.apply_rz(js, jnp.asarray(th), 2))
    for gate in ("Y", "X", "H"):
        for c, t in ((0, 1), (2, 0), (1, 2)):
            _close(tq.apply_controlled_1q(ts, getattr(tq, gate), c, t),
                   jq.statevector.apply_controlled_1q(
                       js, getattr(jq.statevector, gate), c, t))
    u = jq.u3_gate(0.4, 1.1, -0.6)
    _close(tq.apply_controlled_1q(ts, torch.tensor(np.asarray(u)), 0, 2),
           jq.statevector.apply_controlled_1q(js, u, 0, 2))


@pytest.mark.parametrize("case", ["ry_075", "three_qubits", "batch_of_1"])
def test_sample_measure_matches_jax(case):
    """Outcomes equal to ``jax.random.categorical``'s: the JAX test's
    P(|0>) = 0.75 state over 4000 shots, a 3-qubit state, a batch of 1."""
    key = jax.random.PRNGKey(0)
    if case == "ry_075":
        theta = 2 * np.arccos(np.sqrt(0.75))
        js = jq.apply_ry(jq.init_state(1), theta, 0)
        ts = tq.apply_ry(tq.init_state(1, device="cpu"), theta, 0)
        shots = 4000
    else:
        js, ts = _states(3, 1, 5)
        if case == "three_qubits":
            js, ts = js[0], ts[0]
        shots = 999
    want = np.asarray(jq.sample_measure(key, js, shots))
    got = tq.sample_measure(prng.PRNGKey(0, "cpu"), ts, shots)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "ry_075":
        assert abs(float((got == 0).float().mean()) - 0.75) < 0.03


def test_qber_estimate_bit_equal():
    from repro.quantum.qkd import bb84_keygen as jax_bb84
    from repro_torch.quantum.qkd import bb84_keygen
    for eav in (False, True):
        jr = jax_bb84(jax.random.PRNGKey(3), 64, eav)
        tr = bb84_keygen(prng.PRNGKey(3, "cpu"), 64, eav)
        a, b = tq.qber_estimate(tr), np.asarray(jq.qber_estimate(jr))
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b)


def test_encrypt_flat_u32_bit_equal():
    rng = np.random.default_rng(2)
    msg = rng.integers(0, 2 ** 32, 1001, dtype=np.uint32)
    for seed in (0, 7, 2 ** 32 - 1):
        want = np.asarray(jotp.encrypt_flat_u32(jnp.asarray(msg),
                                                jnp.uint32(seed)))
        got = totp.encrypt_flat_u32(torch.tensor(msg.astype(np.int64)), seed)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        back = totp.encrypt_flat_u32(got, seed)
        np.testing.assert_array_equal(back.numpy(), msg.astype(np.int64))


def _trees():
    rng = np.random.default_rng(4)
    jt = {"w": rng.normal(size=(3, 4)).astype(np.float32),
          "b": (rng.normal(size=(5,)).astype(np.float32),
                rng.normal(size=(2, 2)).astype(np.float16))}
    return jt, convert.params_from_jax(jt, "cpu")


def _same(port_tree, jax_tree):
    a = tnn.tree_leaves(port_tree)
    b = jax.tree_util.tree_leaves(jax_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        y = np.asarray(y)
        assert str(x.dtype).split(".")[-1] == str(y.dtype), (x.dtype, y.dtype)
        np.testing.assert_array_equal(x.numpy(), y)


def test_tree_helpers_exact():
    jt, tt = _trees()
    assert tnn.tree_size(tt) == jnn.tree_size(jt) == 21
    assert tnn.tree_bytes(tt) == jnn.tree_bytes(jt)
    assert tnn.count_params(tt) == jnn.count_params(jt)
    vec_t = tnn.tree_flatten_to_vector(tt)
    vec_j = jnn.tree_flatten_to_vector(jt)
    np.testing.assert_array_equal(vec_t.numpy(), np.asarray(vec_j))
    _same(tnn.tree_unflatten_from_vector(vec_t * 3, tt),
          jnn.tree_unflatten_from_vector(vec_j * 3, jt))
    _same(tnn.tree_cast(tt, torch.float16), jnn.tree_cast(jt, jnp.float16))
    _same(tnn.tree_zeros_like(tt), jnn.tree_zeros_like(jt))
    _same(tnn.tree_add(tt, tt), jnn.tree_add(jt, jt))
    _same(tnn.tree_scale(tt, 0.37), jnn.tree_scale(jt, 0.37))


def test_cross_entropy_and_gelu_mlp_match_jax():
    rng = np.random.default_rng(5)
    logits = (rng.normal(size=(3, 5, 11)) * 4).astype(np.float32)
    labels = rng.integers(0, 11, (3, 5))
    mask = (rng.uniform(size=(3, 5)) > 0.3).astype(np.float32)
    t = torch.tensor
    _close(tnn.softmax_cross_entropy(t(logits), t(labels)),
           jnn.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    _close(tnn.softmax_cross_entropy(t(logits), t(labels), t(mask)),
           jnn.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                     jnp.asarray(mask)))
    x = rng.normal(size=(2, 3, 8)).astype(np.float32)
    w_in = rng.normal(size=(8, 16)).astype(np.float32) * 0.3
    b_in = rng.normal(size=(16,)).astype(np.float32)
    w_out = rng.normal(size=(16, 8)).astype(np.float32) * 0.3
    b_out = rng.normal(size=(8,)).astype(np.float32)
    for bi, bo in ((b_in, b_out), (None, None)):
        tt = lambda a: None if a is None else t(a)
        jj = lambda a: None if a is None else jnp.asarray(a)
        _close(tnn.gelu_mlp(t(x), t(w_in), tt(bi), t(w_out), tt(bo)),
               jnn.gelu_mlp(jnp.asarray(x), jnp.asarray(w_in), jj(bi),
                            jnp.asarray(w_out), jj(bo)))


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a − b| in float32 units in the last place (sign-magnitude order)."""
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


@pytest.mark.parametrize("seed,shape", [(0, (100003,)), (7, (333, 301)),
                                        (2 ** 31 - 1, (5, 7, 9)),
                                        (42, ())])
def test_normal_within_2_ulp(seed, shape):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                        jnp.float32))
    got = prng.normal(prng.PRNGKey(seed, "cpu"), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert _ulps(got.numpy().reshape(-1), want.reshape(-1)).max() <= 2


def test_normal_batched_keys_within_2_ulp():
    keys = jax.random.split(jax.random.PRNGKey(9), 6)
    want = np.asarray(jax.vmap(
        lambda k: jax.random.normal(k, (17, 3), jnp.float32))(keys))
    got = prng.normal(prng.split(prng.PRNGKey(9, "cpu"), 6), (17, 3))
    assert _ulps(got.numpy().reshape(-1), want.reshape(-1)).max() <= 2


# every name ``repro`` exports from these packages, less the dry-run's
# ShapeDtypeStruct builder (ROADMAP item 12b)
NOT_YET = {"core": {"fl_input_specs"}}


@pytest.mark.parametrize("pkg", ["nn", "quantum", "security",
                                 "constellation", "core", "kernels",
                                 "configs", "data"])
def test_reexports_present(pkg):
    jax_mod = importlib.import_module(f"repro.{pkg}")
    port_mod = importlib.import_module(f"repro_torch.{pkg}")
    missing = (set(jax_mod.__all__) - NOT_YET.get(pkg, set())
               - set(port_mod.__all__))
    assert not missing, sorted(missing)
    for name in port_mod.__all__:
        assert hasattr(port_mod, name), name


def test_kernel_exports_take_the_jax_call_forms():
    """``repro_torch.kernels``' gate ops take a complex state and (…, 2, 2)
    gates as ``repro.kernels``' do (JAX in Pallas interpret mode, as its
    own tests run it), within 1e-6; ``otp_xor_mac_ref`` is JAX's, bit for
    bit."""
    import repro.kernels as jk
    from repro.kernels.otp_xor.ref import otp_xor_mac_ref as j_ref
    import repro_torch.kernels as tk
    from repro_torch.kernels.otp_xor.ref import otp_xor_mac_ref as t_ref

    nq = 5
    js, ts = _states(nq, 3, 21)
    rng = np.random.default_rng(22)
    # unitary gates (a layer of the VQC's kind), so amplitudes stay ≤ 1
    gates = np.linalg.qr(rng.standard_normal((nq, 2, 2))
                         + 1j * rng.standard_normal((nq, 2, 2)))[0]
    gates = gates.astype(np.complex64)
    got = tk.apply_gate_layer(ts, torch.tensor(gates))
    assert got.dtype == torch.complex64 and got.shape == ts.shape
    _close(got, jk.apply_gate_layer(js, jnp.asarray(gates)))
    for q in (0, 3):
        _close(tk.apply_gate(ts[0], torch.tensor(gates[q]), q),
               jk.apply_gate(js[0], jnp.asarray(gates[q]), q))
    msg = rng.integers(0, 2 ** 32, 300, dtype=np.uint32)
    pad = rng.integers(0, 2 ** 32, 300, dtype=np.uint32)
    # jitted: the eager JAX MAC takes 10-20 s a stream length
    ct_j, tag_j = jax.jit(j_ref)(jnp.asarray(msg), jnp.asarray(pad),
                                 jnp.uint32(12345), jnp.uint32(678))
    ct_t, tag_t = t_ref(torch.tensor(msg.astype(np.int64)),
                        torch.tensor(pad.astype(np.int64)), 12345, 678)
    np.testing.assert_array_equal(ct_t.numpy(), np.asarray(ct_j))
    assert int(tag_t) == int(tag_j)
