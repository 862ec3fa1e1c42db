"""The port's async v2 (the bounded-staleness buffer) and secagg vs the JAX
package, on the JAX suite's crafted 5-satellite access patterns
(tests/test_async_buffer.py, copied here; tests/test_torch_seq.py holds
seq on the 12-satellite secure trace of tests/test_torch_round.py).

Held exactly against the JAX package: every StalenessSchedule array and the
keyed EdgeSchedule (born rounds, pad seeds, MAC keys, aborts); delivered
counts, ``CommLog.round_details`` and the wait, byte and transfer totals of
the JAX trainer's same executor; QBER-abort sets; the secagg primitives and
the ring's secagg aggregate, bit for bit on the same inputs. Held to 1e-6:
every (round, main) merge, end-of-round params and per-round metrics.

The port's ring against its own per-main-list oracle, for both gradient
rules and under secagg: counts and accounting exactly equal and every
(round, main) merge bit-equal — both merge through ``round._frame_merge``
over the same frame with the same weight shape (the JAX package's two
einsums differ in the last bits there), and the VQC computes a client's
contractions client by client, so the two executors train it to the same
bits.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.constellation.topology import ConstellationTrace as JaxTrace
from repro.core import SatQFLConfig as JaxConfig
from repro.core import SatQFLTrainer as JaxTrainer
from repro.core.plan import compile_round_plan as jax_compile
from repro.models import get_config as jax_get_config
from repro.models import get_model as jax_get_model
from repro.security import otp as jotp
from repro.security.keys import KeyManager as JaxKeyManager
from repro_torch import prng
from repro_torch.constellation import ConstellationTrace
from repro_torch.core import SatQFLConfig, SatQFLTrainer
from repro_torch.core.plan import compile_round_plan
from repro_torch.models import get_config, get_model
from repro_torch.nn.pytree import tree_map
from repro_torch.security import otp as totp
from repro_torch.security.keys import KeyManager

N_CLASSES = 7
PATTERNS = ["steady", "gappy", "horizon", "stale", "main_flicker"]
STALE_FIELDS = ("tx_wait_s", "delay_rounds", "deliver_round", "send_slot",
                "main_ids", "merge_w", "merge_born", "merge_any",
                "merge_count", "wq", "pair_seed", "pair_sign", "sum_wq",
                "corr_seed", "corr_sign")
EDGE_FIELDS = ("n_stages", "ptr", "src", "dst", "link", "conc", "mask",
               "first", "born", "abort", "seed", "mac_r", "mac_s")
SMALL = dict(vqc_qubits=2, vqc_layers=1, n_features=2)
FL = dict(mode="async", n_rounds=4, local_steps=2, batch_size=4,
          eval_every=1)


# ---------------------------------------------------------------------------
# the crafted world (helpers copied from tests/test_async_buffer.py)
# ---------------------------------------------------------------------------

def make_trace(sg: np.ndarray, ss: np.ndarray, step_s: float = 60.0):
    """(JAX trace, port trace) of hand-specified access matrices: sg (N, T)
    ground visibility, ss (N, N, T) ISL access, distinct static positions
    so the nearest-primary assignment is deterministic."""
    N, T = sg.shape
    ss = ss | ss.transpose(1, 0, 2)
    ss[np.arange(N), np.arange(N)] = False
    pos = np.zeros((N, T, 3))
    pos[:, :, 0] = (np.arange(N) + 1.0)[:, None] * 1000.0
    kw = dict(times_s=np.arange(T) * step_s, sat_pos=pos,
              sg_access=sg[:, None, :], ss_access=ss, gs_names=["GS0"],
              n_sats=N)
    return JaxTrace(**kw), ConstellationTrace(**kw)


def make_data(n_sats: int, seed: int = 0, equal_sizes: bool = False):
    """((JAX sats, server), (port sats, server)) from one numpy draw."""
    rng = np.random.default_rng(seed)
    sats = []
    for s in range(n_sats):
        n = 8 if equal_sizes else 6 + 2 * (s % 3)
        sats.append({
            "features": rng.uniform(0, np.pi, (n, 2)).astype(np.float32),
            "labels": rng.integers(0, N_CLASSES, (n,)).astype(np.int32)})
    batch = {"features": rng.uniform(0, np.pi, (8, 2)).astype(np.float32),
             "labels": rng.integers(0, N_CLASSES, (8,)).astype(np.int32)}
    server = {"val": batch, "test": batch}
    jx = lambda d: {k: jax.numpy.asarray(v) for k, v in d.items()}
    th = lambda d: {k: torch.tensor(v, dtype=torch.int64 if k == "labels"
                                    else torch.float32)
                    for k, v in d.items()}
    return (([jx(d) for d in sats], {k: jx(v) for k, v in server.items()}),
            ([th(d) for d in sats], {k: th(v) for k, v in server.items()}))


def pattern(name: str, R: int = 4):
    """Crafted (sg, ss) access matrices exercising one buffer behavior."""
    N, T = 5, R
    sg = np.zeros((N, T), bool)
    ss = np.zeros((N, N, T), bool)
    sg[0, :] = True                       # sat 0: always-visible main
    if name == "steady":
        ss[1:, 0, :] = True               # staleness 1 every round
    elif name == "gappy":
        ss[1, 0, 0::2] = True             # sat 1: staleness 2
        ss[2, 0, :] = True
    elif name == "horizon":
        ss[1, 0, :] = True
        ss[2, 0, T - 1:] = True           # sat 2 never transmits in time
    elif name == "stale":
        ss[1, 0, 0] = True
        ss[1, 0, T - 1] = True            # too stale on arrival
        ss[2, 0, :] = True
    elif name == "main_flicker":
        sg[0, :] = False                  # the main returns rounds later:
        sg[0, 0] = True                   # the multi-round ring case
        sg[0, T - 1] = True
        sg[4, :] = True
        ss[1, 0, :] = True
    else:
        raise ValueError(name)
    return sg, ss


def _port_model():
    cfg = get_config("vqc-satqfl").replace(**SMALL)
    return cfg, get_model(cfg)


def run_port(name, batched=True, eav=frozenset(), equal_sizes=False,
             edge_batched=True, **kw):
    sg, ss = pattern(name)
    _, trace = make_trace(sg, ss)
    _, (sats, server) = make_data(5, equal_sizes=equal_sizes)
    cfg, api = _port_model()
    tr = SatQFLTrainer(cfg, api, SatQFLConfig(**{**FL, **kw}), trace, sats,
                       server, eavesdrop_edges=eav, batched=batched,
                       edge_batched=edge_batched, device="cpu")
    tr.async_debug = True
    tr.run()
    return tr


# (pattern, batched, agg_security, security): each pattern on the ring
# (batched), two on the per-client oracle, and gappy (an absent partner
# every other round) under secagg: on the ring with qkd_fernet and an
# eavesdropped edge dropping its sender (deferred deliveries keyed by
# their born round, aborts, corrections), and on the oracle with teleport
# (its angle sample reads the masked stream)
JAX_CASES = ([(p, True, "none", "none") for p in PATTERNS]
             + [("steady", False, "none", "none"),
                ("main_flicker", False, "none", "none"),
                ("gappy", True, "secagg", "qkd_fernet"),
                ("gappy", False, "secagg", "teleport")])
EAV = frozenset({(0, 2)})


def _case_kw(agg, security):
    """Trainer options of a case: the secure OTP modes run with ``EAV``
    eavesdropped, dropping its sender."""
    kw = dict(agg_security=agg, security=security)
    if security.startswith("qkd"):
        kw["on_qber_abort"] = "drop"
    return kw, (EAV if security.startswith("qkd") else frozenset())


@pytest.fixture(scope="module")
def crafted():
    """Every JAX trainer of ``JAX_CASES`` once."""
    cfg = jax_get_config("vqc-satqfl").replace(**SMALL)
    api = jax_get_model(cfg)
    runs = {}
    for name, batched, agg, security in JAX_CASES:
        sg, ss = pattern(name)
        jtrace, _ = make_trace(sg, ss)
        (sats, server), _ = make_data(5)
        kw, eav = _case_kw(agg, security)
        tr = JaxTrainer(cfg, api, JaxConfig(**kw, **FL), jtrace, sats,
                        server, batched=batched, eavesdrop_edges=eav)
        tr.async_debug = True
        tr.run()
        runs[(name, batched, agg, security)] = tr
    return runs


def _merges(tr) -> dict:
    return {(r, m): t for r, m, t in tr.async_merge_log}


def _assert_accounting_equal(a, b):
    for ma, mb in zip(a.history, b.history):
        assert (ma.participants, ma.comm_s, ma.security_s) == \
            (mb.participants, mb.comm_s, mb.security_s)
    for f in ("round_details", "wait_s", "transfer_s", "security_s",
              "bytes_moved", "n_transfers"):
        assert getattr(a.log, f) == getattr(b.log, f), f
    assert a.aborted_edges == b.aborted_edges


def _assert_close_to_jax(tt, jt, atol=1e-6):
    _assert_accounting_equal(tt, jt)
    mt, mj = _merges(tt), _merges(jt)
    assert set(mt) == set(mj) and mt
    for k in mj:
        for leaf in mj[k]:
            np.testing.assert_allclose(mt[k][leaf].numpy(),
                                       np.asarray(mj[k][leaf]), atol=atol,
                                       rtol=0, err_msg=str((k, leaf)))
    for a, b in zip(tt.history, jt.history):
        for f in ("server_val_loss", "server_val_acc", "server_test_acc",
                  "dev_train_acc", "dev_val_loss"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       atol=atol, rtol=0, err_msg=f)
    for k, v in tt.global_params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jt.global_params[k]),
                                   atol=atol, rtol=0, err_msg=k)


def _assert_plans_equal(pt, pj):
    for f in EDGE_FIELDS:
        a, b = getattr(pt.edges, f), getattr(pj.edges, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    st, sj = pt.stale, pj.stale
    assert (st.D, st.n_mains_max, st.with_secagg) == \
        (sj.D, sj.n_mains_max, sj.with_secagg)
    for f in STALE_FIELDS:
        a, b = getattr(st, f), getattr(sj, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


# ---------------------------------------------------------------------------
# the compiled schedule
# ---------------------------------------------------------------------------

# keyed on the patterns with absent partners (gappy) and a multi-round
# buffer (main_flicker): each keyed case pays a JAX BB84 compile
SCHEDULE_CASES = ([(p, "none", "none") for p in PATTERNS]
                  + [(p, "qkd", "secagg") for p in ("gappy", "main_flicker")])


@pytest.mark.parametrize("name,security,agg", SCHEDULE_CASES)
def test_staleness_schedule_matches_jax(name, security, agg):
    """Every StalenessSchedule array (secagg pair and correction tables
    included) and the keyed EdgeSchedule (born rounds and the pad seeds
    folding them in), with an eavesdropped edge aborting, exactly as the
    JAX plan compiles them."""
    sg, ss = pattern(name)
    jtrace, trace = make_trace(sg, ss)
    fl = dict(mode="async", n_rounds=4, max_staleness=2, security=security,
              agg_security=agg, on_qber_abort="drop",
              weight_by_samples=True)
    counts = [6, 8, 10, 6, 8]
    eav = frozenset({(0, 2)}) if security != "none" else frozenset()
    keyed = security != "none" or agg != "none"
    pj = jax_compile(jtrace, JaxConfig(**fl), sample_counts=counts,
                     with_seeds=False,
                     keymgr=JaxKeyManager(jax.random.PRNGKey(7),
                                          eavesdrop_edges=eav)
                     if keyed else None)
    pt = compile_round_plan(trace, SatQFLConfig(**fl), sample_counts=counts,
                            keymgr=KeyManager(prng.PRNGKey(7, "cpu"),
                                              eavesdrop_edges=eav)
                            if keyed else None, with_seeds=False)
    _assert_plans_equal(pt, pj)
    for r in range(4):
        assert pt.live_groups(r) == pj.live_groups(r)


def test_secagg_plan_without_a_registry():
    """secagg under security='none' with no registry given: the compiler
    makes one from fl.seed (the JAX package's rule), so the pairwise mask
    tables equal those of a plan given that registry."""
    sg, ss = pattern("steady")
    _, trace = make_trace(sg, ss)
    fl = SatQFLConfig(mode="async", n_rounds=4, agg_security="secagg",
                      seed=3)
    pt = compile_round_plan(trace, fl, with_seeds=False, device="cpu")
    pk = compile_round_plan(trace, fl,
                            keymgr=KeyManager(prng.PRNGKey(10, "cpu")),
                            with_seeds=False)
    assert pt.stale.with_secagg and pt.stale.pair_seed.any()
    _assert_plans_equal(pt, pk)


def test_staleness_semantics_compiled():
    """The compiled delay/deliver/staleness numbers on crafted windows
    (Δ_max = 2, 5 rounds, stride-1 steps), as the JAX suite pins them."""
    R = 5
    sg, ss = pattern("gappy", R)
    _, trace = make_trace(sg, ss)
    st = compile_round_plan(trace, SatQFLConfig(mode="async", n_rounds=R,
                                                max_staleness=2),
                            with_seeds=False).stale
    for r in range(R - 1):                 # sat 2: open every step
        assert st.delay_rounds[r, 2] == 1 and st.deliver_round[r, 2] == r + 1
    assert st.deliver_round[R - 1, 2] == -1
    assert np.isinf(st.tx_wait_s[R - 1, 2])
    assert st.delay_rounds[0, 1] == 2 and st.deliver_round[0, 1] == 2
    assert st.delay_rounds[1, 1] == -1      # not grouped at odd rounds
    for r in range(R):
        for g in range(st.n_mains_max):
            borns = st.merge_born[r, g][st.merge_born[r, g] >= 0]
            assert all(0 < r - b <= 2 for b in borns)
    sg2, ss2 = pattern("stale", R)
    _, trace2 = make_trace(sg2, ss2)
    st2 = compile_round_plan(trace2, SatQFLConfig(mode="async", n_rounds=R,
                                                  max_staleness=1),
                             with_seeds=False).stale
    assert st2.deliver_round[0, 1] == -1          # d=4 > Δ=1
    assert np.isfinite(st2.tx_wait_s[0, 1])       # but it did wait


# ---------------------------------------------------------------------------
# the trainer against the JAX trainer's same executor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,batched,agg,security", JAX_CASES)
def test_async_trainer_matches_jax(crafted, name, batched, agg, security):
    jt = crafted[(name, batched, agg, security)]
    kw, eav = _case_kw(agg, security)
    tt = run_port(name, batched=batched, eav=eav, **kw)
    _assert_close_to_jax(tt, jt)
    if security == "teleport":
        # every arrival teleported its angle sample with a key split from
        # the trainer's, in the JAX trainer's order
        np.testing.assert_array_equal(tt.key.numpy().astype(np.uint32),
                                      np.asarray(jt.key))
        assert all(m.teleport_fidelity > 1 - 1e-5 for m in tt.history)


def test_secure_async_matches_jax(crafted):
    """Deferred deliveries under qkd_fernet (pad seeds and Fernet metadata
    keyed by the born round) with secagg and an eavesdropped edge: the
    keyed plan, the abort set, delivered counts and accounting exactly the
    JAX trainer's on both executors and both planes; the ring's merges on
    the two planes bit-equal."""
    jt = crafted[("gappy", True, "secagg", "qkd_fernet")]
    kw, eav = _case_kw("secagg", "qkd_fernet")
    runs = {(b, eb): run_port("gappy", batched=b, edge_batched=eb, eav=eav,
                              **kw)
            for b, eb in ((True, True), (True, False), (False, False))}
    _assert_plans_equal(runs[(True, True)].plan, jt.plan)
    assert jt.aborted_edges == {(0, 2)} and jt.plan.stale.corr_seed.any()
    es = jt.plan.edges
    assert (es.born != np.arange(es.born.shape[0])[:, None])[es.mask].any()
    for tr in runs.values():
        _assert_accounting_equal(tr, jt)
    ring, other = _merges(runs[(True, True)]), _merges(runs[(True, False)])
    for k, t in other.items():
        for leaf in t:
            assert torch.equal(t[leaf], ring[k][leaf])


def test_secagg_ring_aggregate_matches_jax(crafted):
    """The ring's secagg merge on the JAX trainer's own ring of masked
    streams (the selections, correction tables and Σwq of a round that
    cancels an absent partner; the ring is as deep as the run is long, so
    no cell was overwritten): the port's dequantized aggregate equals the
    JAX dispatch's bit for bit."""
    jt = crafted[("gappy", True, "secagg", "qkd_fernet")]
    kw, eav = _case_kw("secagg", "qkd_fernet")
    tt = run_port("gappy", eav=eav, **kw)
    st = jt.plan.stale
    assert st.D >= jt.plan.n_rounds
    r = max(r for r in range(jt.plan.n_rounds) if st.corr_seed[r].any())
    N, D, mp = jt.n_sats, st.D, jt._frame
    G = st.n_mains_max
    sel = np.zeros((mp, N + 1, D), np.uint32)
    sel[:G] = st.merge_w[r] > 0
    cs = np.zeros((mp,) + st.corr_seed.shape[2:], np.uint32)
    cg = np.zeros((mp,) + st.corr_sign.shape[2:], np.int32)
    cs[:G], cg[:G] = st.corr_seed[r], st.corr_sign[r]
    sw = np.zeros((mp,), np.float32)
    sw[:G] = st.sum_wq[r]
    anyv = np.zeros((mp,), bool)
    anyv[:G] = st.merge_any[r]
    assert anyv.any() and cs.any()
    want = jt._jit_async_merge_y(jt._ring_y, sel, cs, cg, sw, anyv,
                                 jt.global_params)
    tt._ring_y = torch.from_numpy(np.asarray(jt._ring_y).view(np.int32))
    tt.global_params = {k: torch.tensor(np.asarray(v))
                        for k, v in jt.global_params.items()}
    got = tt._async_merge_y(*(torch.from_numpy(a.astype(np.int64))
                              for a in (sel, cs, cg)),
                            torch.from_numpy(sw), torch.from_numpy(anyv))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy().view(np.uint32),
                                      np.asarray(want[k]).view(np.uint32))


# ---------------------------------------------------------------------------
# the port's ring against its own per-main-list oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", PATTERNS)
@pytest.mark.parametrize("grad,agg", [("autodiff", "none"),
                                      ("param_shift", "none"),
                                      ("autodiff", "secagg")])
def test_ring_matches_oracle(name, grad, agg):
    """The port's ring against its per-main-list oracle: delivered counts,
    accounting and abort sets exactly equal, and every (round, main) merge
    bit-equal — both merge through ``round._frame_merge`` over the same
    frame with the same weight shape (or the same integer secagg path),
    and both executors train a client to the same bits; end params within
    the executors' 1e-6 contract."""
    kw = dict(grad_method=grad, agg_security=agg)
    to, tb = run_port(name, batched=False, **kw), run_port(name, **kw)
    _assert_accounting_equal(to, tb)
    mo, mb = _merges(to), _merges(tb)
    assert set(mo) == set(mb) and mo
    for k in mo:
        for leaf in mo[k]:
            assert torch.equal(mo[k][leaf].view(torch.int32),
                               mb[k][leaf].view(torch.int32)), (k, leaf)
    for k in to.global_params:
        np.testing.assert_allclose(to.global_params[k].numpy(),
                                   tb.global_params[k].numpy(), atol=1e-6)


def test_secagg_dropout_recovery():
    """An eavesdropped sender aborts on both executors and both planes;
    its pairwise masks are cancelled exactly, so the secure aggregate
    equals the same scenario's float merge within quantization, and the
    ring's merges equal the oracle's."""
    eav = frozenset({(0, 1)})
    kw = dict(security="qkd", on_qber_abort="drop", equal_sizes=True,
              eav=eav)
    ts = run_port("steady", agg_security="secagg", **kw)
    tf = run_port("steady", **kw)
    assert ts.aborted_edges == tf.aborted_edges == {(0, 1)}
    assert not (ts.plan.stale.merge_w[:, :, 1, :] > 0).any()
    assert [m.participants for m in ts.history] \
        == [m.participants for m in tf.history]
    ms, mf = _merges(ts), _merges(tf)
    assert set(ms) == set(mf)
    for k in ms:
        for leaf in ms[k]:
            np.testing.assert_allclose(ms[k][leaf].numpy(),
                                       mf[k][leaf].numpy(), atol=2e-4)
    for batched, eb in ((False, True), (True, False), (False, False)):
        to = run_port("steady", agg_security="secagg", batched=batched,
                      edge_batched=eb, **kw)
        _assert_accounting_equal(to, ts)
        if not batched:
            continue
        for k in ms:            # the same executor on the other plane
            for leaf in ms[k]:
                assert torch.equal(_merges(to)[k][leaf], ms[k][leaf])


def test_wait_accounting_windowless_vs_open():
    """A sender whose window never reopens clamps to the comm model's mean
    window wait (18 s), an open-window sender waits one 5 s step, and both
    executors record the same numbers."""
    R = 4
    sg = np.zeros((4, R), bool)
    sg[0, :] = True
    ss = np.zeros((4, 4, R), bool)
    ss[1, 0, :] = True
    ss[2, 0, 0] = True
    _, trace = make_trace(sg, ss, step_s=5.0)
    _, (sats, server) = make_data(4)
    cfg, api = _port_model()
    waits = []
    for batched in (False, True):
        tr = SatQFLTrainer(cfg, api, SatQFLConfig(**FL), trace, sats, server,
                           batched=batched, device="cpu")
        tr.run()
        waits.append([d["wait_s"] for d in tr.log.round_details])
    assert waits[0] == waits[1] == [18.0, 5.0, 5.0, 18.0]


# ---------------------------------------------------------------------------
# the secagg primitives, bit for bit on the same inputs
# ---------------------------------------------------------------------------

def _params(seed, n=(3, 5)):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(0, 4, n).astype(np.float32),
            "b": rng.normal(0, 30, (7,)).astype(np.float32)}


def test_tree_to_q32_rounds_half_to_even():
    """Exact odd multiples of 2^-17 (ties of the 2^-16 grid) round to even
    in both packages, and values past ±16 clip."""
    ties = (np.arange(-9, 10, 2) * 2.0 ** -17).astype(np.float32)
    tree = {"t": np.concatenate([ties, np.float32([16.5, -17.0, 3e-6])])}
    want = np.asarray(jotp.tree_to_q32(
        {k: jax.numpy.asarray(v) for k, v in tree.items()}))
    got = totp.tree_to_q32({k: torch.tensor(v) for k, v in tree.items()})
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[:10].tolist() == [-4, -4, -2, -2, 0, 0, 2, 2, 4, 4]


@pytest.mark.parametrize("seed", [0, 1])
def test_secagg_mask_stream_matches_jax(seed):
    """y = w·q(tree) + Σ sign·pad mod 2^32, the q32 round trip and the
    signed pad sums (an empty partner list and 0-sign padding included)."""
    p = _params(seed)
    jp = {k: jax.numpy.asarray(v) for k, v in p.items()}
    tp = {k: torch.tensor(v) for k, v in p.items()}
    seeds = np.asarray([0, 0xFFFFFFFF, 12345 + seed, 7], np.uint32)
    signs = np.asarray([1, -1, 1, 0], np.int32)
    want = np.asarray(jotp.secagg_mask_stream(jp, 5, seeds, signs))
    got = totp.secagg_mask_stream(tp, 5, seeds, signs)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    rows = totp.secagg_mask_rows(tree_map(lambda x: x[None], tp), [5],
                                 seeds[None], signs[None])
    np.testing.assert_array_equal(rows[0].numpy(), got.numpy())
    for s, g in ((seeds, signs), (seeds[:0], signs[:0])):
        np.testing.assert_array_equal(
            totp.sum_signed_pads(s, g, 37, device="cpu").numpy()
            .view(np.uint32),
            np.asarray(jotp.sum_signed_pads(s, g, 37)))
    denom = np.float32(3.0)
    wj = jotp.q32_to_tree(jax.numpy.asarray(want), jp, denom)
    wt = totp.q32_to_tree(got, tp, denom)
    for k in wj:
        np.testing.assert_array_equal(wt[k].numpy(), np.asarray(wj[k]))


def test_share_and_recover_masks_match_jax(crafted):
    """``share_edges`` and ``recover_masks`` of the trainers' registries
    (both from fl.seed, the secagg cohort's pairs already established),
    bit for bit (the recovered correction is a uint32 stream)."""
    jt = crafted[("gappy", True, "secagg", "qkd_fernet")]
    kw, eav = _case_kw("secagg", "qkd_fernet")
    tt = run_port("gappy", eav=eav, **kw)
    pairs = [(1, 2), (1, 2), (1, 2)]
    assert tt.keymgr.share_edges(pairs) == jt.keymgr.share_edges(pairs)
    borns, signs = [0, 2, 1], [1, -1, -1]
    want = np.asarray(jt.keymgr.recover_masks(pairs, borns, signs, 50))
    got = tt.keymgr.recover_masks(pairs, borns, signs, 50)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert not tt.keymgr.recover_masks([], [], [], 50).any()
