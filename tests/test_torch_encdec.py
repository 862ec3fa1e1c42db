"""The port's encoder-decoder (whisper-tiny, smoke variant) and the
attention blocks it widened, against ``repro`` on the CPU in float32.

The model from a key equals JAX's within 2 ulp. With JAX's parameters
carried across by ``convert`` (their biases, LayerNorm shifts and scales
first set to nonzero numpy draws, in both trees: a fresh model has them
0 or 1, which hides a bias that is dropped or misplaced): ``encode``,
forward logits and loss rel ≤ 1e-5, gradients within 1e-4 of each
leaf's largest |g|, ``prefill_cross``'s caches rel ≤ 1e-6,
decode-stepped logits over 12 tokens within 1e-5 and rel < 2e-3 of the
forward's, ``generate``'s tokens (greedy and sampled) and the prefill
step as JAX's, and both launchers (``serve.main``'s tokens,
``train.main``'s losses rel ≤ 1e-5) as the JAX launcher's. Then the
blocks: the four cross functions (MHA with biases; GQA with qk-norm),
non-causal self-attention (plain and, past the threshold, in query
chunks) and ``_attn_qchunked`` at chunk 4 (causal, non-causal,
windowed). JAX's values come from one module fixture.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.launch.steps import make_prefill_step as jax_make_prefill_step
from repro.models import blocks as jB
from repro.models import encdec as jE
from repro.models import get_config as jax_get_config
from repro.models import get_model as jax_get_model
from repro.models import smoke_variant as jax_smoke_variant
from repro_torch import prng
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import blocks as tB
from repro_torch.models import encdec as tE
from repro_torch.models import get_config, get_model, smoke_variant
from repro_torch.nn.pytree import tree_leaves, tree_unflatten

ARCH = "whisper-tiny"
TOL = 1e-5
GRAD_TOL = 1e-4
B, S, GEN = 2, 12, 8


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in units of b's float32 spacing."""
    return np.abs(a.astype(np.float64) - b) / np.spacing(
        np.abs(b).astype(np.float32)).astype(np.float64)


def _rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _err(got, want) -> float:
    return float(np.abs(got.detach().numpy() - np.asarray(want)).max())


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _nonzero(tree, rng):
    """The numpy tree with every bias and LayerNorm leaf (``b*``, ``s``)
    drawn anew: biases N(0, 0.1), scales 1 + N(0, 0.1)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _nonzero(v, rng)
        elif k in ("bq", "bv", "bo", "bi", "b"):
            out[k] = (0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
        elif k == "s":
            out[k] = (1 + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
        else:
            out[k] = v
    return out


@pytest.fixture(scope="module")
def ed():
    """Both packages' smoke whisper from PRNGKey(0), the nonzero-bias
    parameters in both, a batch, and JAX's values on it."""
    cfg_j = jax_smoke_variant(jax_get_config(ARCH))
    cfg_t = smoke_variant(get_config(ARCH))
    api_j = jax_get_model(cfg_j)
    key_j = jax.random.PRNGKey(0)
    init_j = api_j.init(cfg_j, key_j)
    init_t = get_model(cfg_t).init(cfg_t, prng.PRNGKey(0, "cpu"))
    np_params = _nonzero(jax.tree_util.tree_map(np.asarray, init_j),
                         np.random.default_rng(1))
    params_j = jax.tree_util.tree_map(jnp.asarray, np_params)
    params_t = params_from_jax(np_params, device="cpu")
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, cfg_j.vocab_size, (B, S),
                                    dtype=np.int32),
             "labels": rng.integers(0, cfg_j.vocab_size, (B, S),
                                    dtype=np.int32),
             "audio_embeds": _x((B, cfg_j.n_audio_frames, cfg_j.d_model), 3,
                                0.1)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_and_outputs(p):
        logits, _ = api_j.forward(cfg_j, p, jb)
        return api_j.loss(cfg_j, p, jb), (logits, jE.encode(
            cfg_j, p, jb["audio_embeds"]))

    (loss_j, (logits_j, enc_j)), grads_j = jax.jit(jax.value_and_grad(
        loss_and_outputs, has_aux=True))(params_j)
    # JAX's model api with its prefill_cross and decode_step jitted once,
    # shared by the decode and generate cases (the same shapes: B x S)
    api_jit = api_j._replace(
        prefill_cross=jax.jit(api_j.prefill_cross, static_argnums=0),
        decode_step=jax.jit(api_j.decode_step, static_argnums=0))
    cache = api_jit.prefill_cross(cfg_j, params_j,
                                  api_j.init_cache(cfg_j, B, S),
                                  jb["audio_embeds"])
    cross_j = cache["cross"]
    steps = []
    for t in range(S):
        lg, cache = api_jit.decode_step(cfg_j, params_j, cache, {
            "token": jb["tokens"][:, t], "pos": jnp.full((B,), t, jnp.int32)})
        steps.append(np.asarray(lg))
    return dict(
        cfg_j=cfg_j, cfg_t=cfg_t, api_j=api_j, api_jit=api_jit,
        init_j=init_j, init_t=init_t, params_j=params_j, params_t=params_t,
        batch=batch, jb=jb, enc_j=np.asarray(enc_j),
        logits_j=np.asarray(logits_j), loss_j=float(loss_j),
        grads_j=grads_j, cross_j=cross_j, decode_j=np.stack(steps, 1))


def _tbatch(ed):
    return {k: torch.tensor(v) for k, v in ed["batch"].items()}


def test_init_from_a_key_matches_jax(ed):
    leaves_j = jax.tree_util.tree_leaves(ed["init_j"])
    leaves_t = tree_leaves(ed["init_t"])
    assert len(leaves_j) == len(leaves_t) == 45
    for a, b in zip(leaves_t, leaves_j):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape and str(a.dtype)[6:] == b.dtype.name
        assert _ulps(a.numpy(), b).max() <= 2


def test_encode_forward_and_loss_match_jax(ed):
    cfg, p, tb = ed["cfg_t"], ed["params_t"], _tbatch(ed)
    assert _rel(tE.encode(cfg, p, tb["audio_embeds"]), ed["enc_j"]) <= TOL
    logits, aux = tE.forward(cfg, p, tb)
    v = cfg.vocab_size
    assert float(aux) == 0.0
    assert _rel(logits[..., :v], ed["logits_j"][..., :v]) <= TOL
    assert np.all(logits[..., v:].detach().numpy() == tB.NEG_INF)
    loss = get_model(cfg).loss(cfg, p, tb)
    assert abs(float(loss) - ed["loss_j"]) <= TOL * abs(ed["loss_j"])


def test_grads_match_jax(ed):
    cfg, tb = ed["cfg_t"], _tbatch(ed)
    leaves = [x.detach().requires_grad_(True)
              for x in tree_leaves(ed["params_t"])]
    loss = tE.loss(cfg, tree_unflatten(ed["params_t"], leaves), tb)
    grads = torch.autograd.grad(loss, leaves)
    for g, gj in zip(grads, jax.tree_util.tree_leaves(ed["grads_j"])):
        gj = np.asarray(gj)
        assert np.abs(g.numpy() - gj).max() <= GRAD_TOL * max(
            np.abs(gj).max(), 1e-30)


def test_prefill_cross_and_decode_match_jax(ed):
    cfg, p, tb = ed["cfg_t"], ed["params_t"], _tbatch(ed)
    api = get_model(cfg)
    cache = api.prefill_cross(cfg, p, api.init_cache(cfg, B, S, "cpu"),
                              tb["audio_embeds"])
    for k in ("k", "v"):
        assert _rel(cache["cross"][k], ed["cross_j"][k]) <= 1e-6
    steps = []
    for t in range(S):
        lg, cache = api.decode_step(cfg, p, cache, {
            "token": tb["tokens"][:, t],
            "pos": torch.full((B,), t, dtype=torch.int32)})
        steps.append(lg)
    v = cfg.vocab_size
    dec = torch.stack(steps, 1)[..., :v]
    assert _err(dec, ed["decode_j"][..., :v]) <= TOL
    # decode-stepped against teacher-forced (tests/test_decode_parity.py)
    assert _rel(dec, ed["logits_j"][..., :v]) < 2e-3


@pytest.mark.parametrize("greedy", [True, False])
def test_generate_matches_jax_tokens(ed, greedy):
    cfg_j, cfg_t = ed["cfg_j"], ed["cfg_t"]
    prompts = ed["batch"]["tokens"][:, :4]
    extras = {"audio_embeds": ed["batch"]["audio_embeds"]}
    want = jserve.generate(
        cfg_j, ed["api_jit"], ed["params_j"], jnp.asarray(prompts), GEN,
        cache_len=4 + GEN,
        extras={k: jnp.asarray(v) for k, v in extras.items()},
        greedy=greedy, key=jax.random.PRNGKey(7))
    got = tserve.generate(
        cfg_t, get_model(cfg_t), ed["params_t"], torch.tensor(prompts), GEN,
        cache_len=4 + GEN,
        extras={k: torch.tensor(v) for k, v in extras.items()},
        greedy=greedy, key=prng.PRNGKey(7, "cpu"))
    assert got.dtype == torch.int32 and got.shape == (B, 4 + GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_step_matches_jax(ed):
    cfg_j, cfg_t = ed["cfg_j"], ed["cfg_t"]
    batch = {k: ed["batch"][k] for k in ("tokens", "audio_embeds")}
    want = np.asarray(jax.jit(jax_make_prefill_step(cfg_j, ed["api_j"], None))(
        ed["params_j"], {k: jnp.asarray(v) for k, v in batch.items()}))
    got = make_prefill_step(cfg_t, get_model(cfg_t))(
        ed["params_t"], {k: torch.tensor(v) for k, v in batch.items()})
    v = cfg_t.vocab_size
    assert _rel(got[:, :v], want[:, :v]) <= TOL


def _sample_line(out: str) -> list:
    line = next(x for x in out.splitlines() if "sample request 0" in x)
    return [int(t) for t in line.split(":", 1)[1].strip(" []").replace(
        ",", " ").split()]


def test_serve_main_matches_jax(capsys):
    argv = ["--arch", ARCH, "--requests", "2", "--prompt-len", "4", "--gen",
            "6"]
    jserve.main(argv)
    want = _sample_line(capsys.readouterr().out)
    tserve.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "output shapes + token ranges OK" in out
    assert _sample_line(out) == want


def test_train_main_matches_jax(monkeypatch):
    argv = ["--arch", ARCH, "--smoke", "--steps", "3", "--batch", "2",
            "--seq", "16"]
    want = []
    run_lm = jtrain.run_lm
    monkeypatch.setattr(jtrain, "run_lm", lambda a: want.extend(run_lm(a)))
    jtrain.main(argv)
    got = ttrain.main(argv + ["--device", "cpu"])
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=TOL)


# ---------------------------------------------------------------------------
# blocks: cross-attention, non-causal and query-chunked attention
# ---------------------------------------------------------------------------

CROSS_CASES = {"mha_bias": dict(bias=True),
               "gqa_qk_norm": dict(n_kv_heads=2, qk_norm=True)}


@pytest.fixture(scope="module", params=list(CROSS_CASES))
def xattn(request):
    """An unstacked attention layer of the smoke config (MHA with
    biases, or GQA 4/2 with qk-norm), nonzero biases and norm scales."""
    kw = dict(CROSS_CASES[request.param])
    bias = kw.pop("bias", False)
    cfg_j = jax_smoke_variant(jax_get_config(ARCH)).replace(**kw)
    cfg_t = smoke_variant(get_config(ARCH)).replace(**kw)
    p = jax.tree_util.tree_map(np.asarray, jB.attn_init(
        jax.random.PRNGKey(5), cfg_j, None, jnp.float32, bias=bias))
    rng = np.random.default_rng(6)
    for k in list(p):
        if k.startswith("b") or k.endswith("_norm"):
            p[k] = (p[k] + 0.1 * rng.standard_normal(p[k].shape)
                    ).astype(np.float32)
    return cfg_j, cfg_t, jax.tree_util.tree_map(jnp.asarray, p), \
        params_from_jax(p, device="cpu")


def test_attn_init_bias_matches_jax(xattn):
    cfg_j, cfg_t = xattn[:2]
    for bias in (False, True):
        pj = jB.attn_init(jax.random.PRNGKey(5), cfg_j, 3, jnp.float32,
                          bias=bias)
        pt = tB.attn_init(prng.PRNGKey(5, "cpu"), cfg_t, 3, torch.float32,
                          bias=bias)
        assert sorted(pj) == sorted(pt)
        assert ("bk" not in pt) and (("bq" in pt) == bias)
        for k in pj:
            assert _ulps(pt[k].numpy(), np.asarray(pj[k])).max() <= 2


def test_cross_attn_apply_matches_jax(xattn):
    cfg_j, cfg_t, pj, pt = xattn
    x, kv = _x((2, 7, cfg_j.d_model), 10), _x((2, 9, cfg_j.d_model), 11)
    assert _err(tB.cross_attn_apply(pt, cfg_t, torch.tensor(x),
                                    torch.tensor(kv)),
                jB.cross_attn_apply(pj, cfg_j, jnp.asarray(x),
                                    jnp.asarray(kv))) <= TOL


def test_cross_attn_cache_and_decode_match_jax(xattn):
    cfg_j, cfg_t, pj, pt = xattn
    kv = _x((2, 9, cfg_j.d_model), 12)
    empty_j = jB.cross_attn_cache_init(cfg_j, 3, 2, 9, jnp.float32)
    empty_t = tB.cross_attn_cache_init(cfg_t, 3, 2, 9, torch.float32, "cpu")
    for k in ("k", "v"):
        assert tuple(empty_t[k].shape) == empty_j[k].shape
    cj = jB.cross_attn_prefill_cache(pj, cfg_j, jnp.asarray(kv))
    ct = tB.cross_attn_prefill_cache(pt, cfg_t, torch.tensor(kv))
    for k in ("k", "v"):
        assert _rel(ct[k], cj[k]) <= 1e-6
    x = _x((2, 1, cfg_j.d_model), 13)
    assert _err(tB.cross_attn_decode(pt, cfg_t, torch.tensor(x), ct),
                jB.cross_attn_decode(pj, cfg_j, jnp.asarray(x), cj)) <= TOL


@pytest.mark.parametrize("window", [0, 5])
def test_attn_apply_non_causal_matches_jax(xattn, window):
    """Non-causal, no rope (the whisper encoder's call; with a window
    only its lower edge masks), and rope with causal=False."""
    cfg_j, cfg_t, pj, pt = xattn
    x = _x((2, 11, cfg_j.d_model), 14)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11))
    for use_rope in (False, True):
        got = tB.attn_apply(pt, cfg_t, torch.tensor(x), torch.tensor(pos),
                            window=window, causal=False, use_rope=use_rope)
        want = jB.attn_apply(pj, cfg_j, jnp.asarray(x), jnp.asarray(pos),
                             window=window, causal=False, use_rope=use_rope)
        assert _err(got, want) <= TOL


def test_attn_apply_past_the_threshold_runs_query_chunks(xattn, monkeypatch):
    """With both packages' ``QCHUNK_THRESHOLD`` lowered to 8, a 24-token
    non-causal call takes the query-chunked path (chunk 512 -> 24)."""
    cfg_j, cfg_t, pj, pt = xattn
    for mod in (jB, tB):
        monkeypatch.setattr(mod, "QCHUNK_THRESHOLD", 8)
    calls = []
    chunked = tB._attn_qchunked
    monkeypatch.setattr(tB, "_attn_qchunked",
                        lambda *a, **k: calls.append(1) or chunked(*a, **k))
    x = _x((2, 24, cfg_j.d_model), 15)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24))
    got = tB.attn_apply(pt, cfg_t, torch.tensor(x), torch.tensor(pos),
                        causal=False, use_rope=False)
    want = jB.attn_apply(pj, cfg_j, jnp.asarray(x), jnp.asarray(pos),
                         causal=False, use_rope=False)
    assert calls and _err(got, want) <= TOL


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 6), (False, 6)])
def test_attn_qchunked_matches_jax(causal, window):
    """Chunk 4 over S=18 (the largest divisor of 18 not above 4 is 3:
    six chunks), against JAX's scan."""
    q, k, v = (_x((2, 18, 4, 32), 20 + i) for i in range(3))
    pos = np.broadcast_to(np.arange(18, dtype=np.int32), (2, 18))
    got = tB._attn_qchunked(*(torch.tensor(a) for a in (q, k, v, pos)),
                            causal, window, chunk=4)
    want = jB._attn_qchunked(*(jnp.asarray(a) for a in (q, k, v, pos)),
                             causal, window, chunk=4)
    assert _err(got, want) <= TOL
