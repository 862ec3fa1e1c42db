"""The port's VLM (llama-3.2-vision-90b, smoke variant), the int8 KV
cache and the ``ssd_fn`` hook, against ``repro`` on the CPU in float32.

The model from a key equals JAX's within 2 ulp (the nested stacking:
``groups.cross`` on (G,), ``groups.selfs`` on (G, S)). With JAX's
parameters carried across by ``convert`` (the tanh gates set to 0.5 and
the RMSNorm scales to 1 + N(0, 0.1), in both trees: a fresh model's zero
gates switch every cross block off): forward logits and loss rel ≤ 1e-5,
gradients within 1e-4 of each leaf's largest |g|, ``prefill_cross``'s
caches rel ≤ 1e-6, decode-stepped logits over 12 tokens within 1e-5 and
rel < 2e-3 of the forward's, ``generate``'s tokens (greedy and sampled)
and the prefill step as JAX's, and both launchers as the JAX launcher's.
Then the int8 KV cache (tinyllama-1.1b's smoke variant): ``_quant_kv``
bit for bit, ``attn_decode`` on it within 1e-5 of JAX's (what it
writes bit for bit), the model's int8 decode against JAX's (logits rel
<= 1e-3, the cache within one int8 step) and, as
tests/test_decode_parity.py holds JAX's, rel < 0.05 of the forward with
the top-1 token kept on > 95% of positions; and ``ssm_apply`` with
``ssd_fn=ssd_ref`` (mamba2-130m's smoke layer) against JAX's.
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
from repro.models import get_config as jax_get_config
from repro.models import get_model as jax_get_model
from repro.models import smoke_variant as jax_smoke_variant
from repro_torch import prng
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import blocks as tB
from repro_torch.models import get_config, get_model, smoke_variant
from repro_torch.models import vlm as tV
from repro_torch.nn.pytree import tree_leaves, tree_map, tree_unflatten

ARCH = "llama-3.2-vision-90b"
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


def _open_gates(tree, rng):
    """The numpy tree with the tanh gates at 0.5 and every RMSNorm scale
    (``ln1``, ``ln2``, ``final_norm``) at 1 + N(0, 0.1)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _open_gates(v, rng)
        elif k in ("gate_attn", "gate_ffn"):
            out[k] = np.full(v.shape, 0.5, v.dtype)
        elif k in ("ln1", "ln2", "final_norm"):
            out[k] = (1 + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
        else:
            out[k] = v
    return out


@pytest.fixture(scope="module")
def vl():
    """Both packages' smoke VLM from PRNGKey(0), the open-gate parameters
    in both, a batch, and JAX's values on it."""
    cfg_j = jax_smoke_variant(jax_get_config(ARCH))
    cfg_t = smoke_variant(get_config(ARCH))
    api_j = jax_get_model(cfg_j)
    init_j = api_j.init(cfg_j, jax.random.PRNGKey(0))
    init_t = get_model(cfg_t).init(cfg_t, prng.PRNGKey(0, "cpu"))
    np_params = _open_gates(jax.tree_util.tree_map(np.asarray, init_j),
                            np.random.default_rng(1))
    params_j = jax.tree_util.tree_map(jnp.asarray, np_params)
    params_t = params_from_jax(np_params, device="cpu")
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, cfg_j.vocab_size, (B, S),
                                    dtype=np.int32),
             "labels": rng.integers(0, cfg_j.vocab_size, (B, S),
                                    dtype=np.int32),
             "image_embeds": _x((B, cfg_j.n_image_tokens, cfg_j.d_model), 3,
                                0.1)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_and_logits(p):
        return api_j.loss(cfg_j, p, jb), api_j.forward(cfg_j, p, jb)[0]

    (loss_j, logits_j), grads_j = jax.jit(jax.value_and_grad(
        loss_and_logits, has_aux=True))(params_j)
    # JAX's model api with its prefill_cross and decode_step jitted once,
    # shared by the decode and generate cases (the same shapes: B x S)
    api_jit = api_j._replace(
        prefill_cross=jax.jit(api_j.prefill_cross, static_argnums=0),
        decode_step=jax.jit(api_j.decode_step, static_argnums=0))
    cache = api_jit.prefill_cross(cfg_j, params_j,
                                  api_j.init_cache(cfg_j, B, S),
                                  jb["image_embeds"])
    cross_j = cache["cross"]
    steps = []
    for t in range(S):
        lg, cache = api_jit.decode_step(cfg_j, params_j, cache, {
            "token": jb["tokens"][:, t], "pos": jnp.full((B,), t, jnp.int32)})
        steps.append(np.asarray(lg))
    return dict(
        cfg_j=cfg_j, cfg_t=cfg_t, api_j=api_j, api_jit=api_jit,
        init_j=init_j, init_t=init_t, params_j=params_j, params_t=params_t,
        batch=batch, logits_j=np.asarray(logits_j), loss_j=float(loss_j),
        grads_j=grads_j, cross_j=cross_j, self_j=cache["self"],
        decode_j=np.stack(steps, 1))


def _tbatch(vl):
    return {k: torch.tensor(v) for k, v in vl["batch"].items()}


def test_init_from_a_key_matches_jax(vl):
    leaves_j = jax.tree_util.tree_leaves(vl["init_j"])
    leaves_t = tree_leaves(vl["init_t"])
    assert len(leaves_j) == len(leaves_t) == 23
    G, S_ = 2, 1                       # the smoke variant's 2 groups of 2
    groups = vl["init_t"]["groups"]
    assert tuple(groups["cross"]["gate_attn"].shape) == (G,)
    assert groups["cross"]["gate_attn"].dtype == torch.float32
    assert tuple(groups["selfs"]["ln1"].shape)[:2] == (G, S_)
    for a, b in zip(leaves_t, leaves_j):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape and str(a.dtype)[6:] == b.dtype.name
        assert _ulps(a.numpy(), b).max() <= 2


def test_forward_and_loss_match_jax(vl):
    cfg, p, tb = vl["cfg_t"], vl["params_t"], _tbatch(vl)
    logits, aux = tV.forward(cfg, p, tb)
    v = cfg.vocab_size
    assert float(aux) == 0.0
    assert _rel(logits[..., :v], vl["logits_j"][..., :v]) <= TOL
    # the open gates let the image tokens reach the logits
    tb2 = dict(tb, image_embeds=2 * tb["image_embeds"])
    assert _rel(tV.forward(cfg, p, tb2)[0][..., :v], logits[..., :v]) > 1e-4
    loss = get_model(cfg).loss(cfg, p, tb)
    assert abs(float(loss) - vl["loss_j"]) <= TOL * abs(vl["loss_j"])


def test_grads_match_jax(vl):
    cfg, tb = vl["cfg_t"], _tbatch(vl)
    leaves = [x.detach().requires_grad_(True)
              for x in tree_leaves(vl["params_t"])]
    loss = tV.loss(cfg, tree_unflatten(vl["params_t"], leaves), tb)
    grads = torch.autograd.grad(loss, leaves)
    for g, gj in zip(grads, jax.tree_util.tree_leaves(vl["grads_j"])):
        gj = np.asarray(gj)
        assert np.abs(g.numpy() - gj).max() <= GRAD_TOL * max(
            np.abs(gj).max(), 1e-30)


def test_prefill_cross_and_decode_match_jax(vl):
    cfg, p, tb = vl["cfg_t"], vl["params_t"], _tbatch(vl)
    api = get_model(cfg)
    cache = api.init_cache(cfg, B, S, "cpu")
    # the self cache stacks on (G, S): (G, S, B, clen, KV, hd)
    assert tuple(cache["self"]["k"].shape) == (2, 1, B, S, cfg.n_kv_heads,
                                               cfg.hd)
    cache = api.prefill_cross(cfg, p, cache, tb["image_embeds"])
    for k in ("k", "v"):
        assert _rel(cache["cross"][k], vl["cross_j"][k]) <= 1e-6
    steps = []
    for t in range(S):
        lg, cache = api.decode_step(cfg, p, cache, {
            "token": tb["tokens"][:, t],
            "pos": torch.full((B,), t, dtype=torch.int32)})
        steps.append(lg)
    v = cfg.vocab_size
    dec = torch.stack(steps, 1)[..., :v]
    assert _err(dec, vl["decode_j"][..., :v]) <= TOL
    for k in ("k", "v", "pos"):
        assert _err(cache["self"][k], vl["self_j"][k]) <= TOL
    # decode-stepped against teacher-forced (tests/test_decode_parity.py)
    assert _rel(dec, vl["logits_j"][..., :v]) < 2e-3


@pytest.mark.parametrize("greedy", [True, False])
def test_generate_matches_jax_tokens(vl, greedy):
    cfg_j, cfg_t = vl["cfg_j"], vl["cfg_t"]
    prompts = vl["batch"]["tokens"][:, :4]
    extras = {"image_embeds": vl["batch"]["image_embeds"]}
    want = jserve.generate(
        cfg_j, vl["api_jit"], vl["params_j"], jnp.asarray(prompts), GEN,
        cache_len=4 + GEN,
        extras={k: jnp.asarray(v) for k, v in extras.items()},
        greedy=greedy, key=jax.random.PRNGKey(7))
    got = tserve.generate(
        cfg_t, get_model(cfg_t), vl["params_t"], torch.tensor(prompts), GEN,
        cache_len=4 + GEN,
        extras={k: torch.tensor(v) for k, v in extras.items()},
        greedy=greedy, key=prng.PRNGKey(7, "cpu"))
    assert got.dtype == torch.int32 and got.shape == (B, 4 + GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_step_matches_jax(vl):
    cfg_j, cfg_t = vl["cfg_j"], vl["cfg_t"]
    batch = {k: vl["batch"][k] for k in ("tokens", "image_embeds")}
    want = np.asarray(jax.jit(jax_make_prefill_step(cfg_j, vl["api_j"], None))(
        vl["params_j"], {k: jnp.asarray(v) for k, v in batch.items()}))
    got = make_prefill_step(cfg_t, get_model(cfg_t))(
        vl["params_t"], {k: torch.tensor(v) for k, v in batch.items()})
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
# the int8 KV cache and the ssd_fn hook
# ---------------------------------------------------------------------------

def test_quant_kv_is_bit_equal():
    """Values and float16 scales bit for bit, on scales of 1e-3 to 1e2
    and on ties (x / scale exactly k + 0.5: half to even in both)."""
    for seed, scale in ((0, 1.0), (1, 1e-3), (2, 1e2)):
        x = _x((3, 4, 64), seed, scale)
        x[0, 0, :3] = [127.0, 0.5, 1.5]        # scale 1 + 1e-9: ties
        qj, sj = jB._quant_kv(jnp.asarray(x))
        qt, st = tB._quant_kv(torch.tensor(x))
        assert qt.dtype == torch.int8 and st.dtype == torch.float16
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(st.numpy().view(np.uint16),
                                      np.asarray(sj).view(np.uint16))
        np.testing.assert_array_equal(
            tB._dequant_kv(qt, st, torch.float32).numpy(),
            np.asarray(jB._dequant_kv(qj, sj, jnp.float32)))


@pytest.fixture(scope="module")
def int8():
    """tinyllama's smoke model (JAX's params carried across), 12 tokens,
    JAX's forward logits, its empty int8 cache, and its int8 decode over
    the 12 tokens: the logits of every step and the cache after the last
    (numpy)."""
    cfg_j = jax_smoke_variant(jax_get_config("tinyllama-1.1b"))
    cfg_t = smoke_variant(get_config("tinyllama-1.1b"))
    api_j = jax_get_model(cfg_j)
    params_j = api_j.init(cfg_j, jax.random.PRNGKey(0))
    params_t = params_from_jax(jax.tree_util.tree_map(np.asarray, params_j),
                               device="cpu")
    tokens = np.random.default_rng(4).integers(0, cfg_j.vocab_size, (B, S),
                                               dtype=np.int32)
    full, _ = api_j.forward(cfg_j, params_j, {"tokens": jnp.asarray(tokens)})
    cfg8_j = cfg_j.replace(kv_cache_dtype="int8")
    cache = api_j.init_cache(cfg8_j, B, S)
    empty = jax.tree_util.tree_map(np.asarray, cache)
    decode = jax.jit(api_j.decode_step, static_argnums=0)
    steps = []
    for t in range(S):
        lg, cache = decode(cfg8_j, params_j, cache, {
            "token": jnp.asarray(tokens[:, t]),
            "pos": jnp.full((B,), t, jnp.int32)})
        steps.append(np.asarray(lg))
    return dict(cfg8=cfg_t.replace(kv_cache_dtype="int8"), params=params_t,
                tokens=tokens, full=np.asarray(full), cache_j=empty,
                decode_j=np.stack(steps, 1),
                decoded_cache_j=jax.tree_util.tree_map(np.asarray, cache))


def _step8(int8, cache, t):
    cfg8 = int8["cfg8"]
    return get_model(cfg8).decode_step(cfg8, int8["params"], cache, {
        "token": torch.tensor(int8["tokens"][:, t]),
        "pos": torch.full((B,), t, dtype=torch.int32)})


def test_int8_cache_layout_matches_jax(int8):
    cache = get_model(int8["cfg8"]).init_cache(int8["cfg8"], B, S, "cpu")
    got = cache["segments"][0]["attn"]
    want = int8["cache_j"]["segments"][0]["attn"]
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype)[6:] == want[k].dtype.name


def _dyadic(shape, seed, denom):
    """Integers in [-4, 4] over ``denom``: products and sums of these stay
    exact in float32 in any order."""
    return (np.random.default_rng(seed).integers(-4, 5, shape) / denom
            ).astype(np.float32)


@pytest.mark.parametrize("window", [0, 8])
def test_int8_attn_decode_matches_jax(int8, window):
    """``attn_decode`` on the int8 cache, 12 steps of one layer (GQA 4/2,
    no rope) into 8 slots (the ring wraps; under W=8 the window masks).
    Inputs and weights sit on a dyadic grid, so q, k and v are exact in
    both packages whatever their summation order: every entry written
    (int8 values, float16 scales, positions) must equal JAX's bit for bit
    and each output be within 1e-5. With rounded k the two packages' k
    can differ by an ulp, which moves a value on a rounding boundary by
    one int8 step (``test_int8_decode_matches_jax`` bounds that through
    the model)."""
    cfg_t = int8["cfg8"]
    cfg_j = jax_smoke_variant(jax_get_config("tinyllama-1.1b")).replace(
        kv_cache_dtype="int8")
    d, H, KV, hd = cfg_t.d_model, cfg_t.n_heads, cfg_t.n_kv_heads, cfg_t.hd
    p = {"wq": _dyadic((d, H * hd), 1, 64), "wk": _dyadic((d, KV * hd), 2, 64),
         "wv": _dyadic((d, KV * hd), 3, 64), "wo": _dyadic((H * hd, d), 4, 64)}
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = params_from_jax(p, device="cpu")
    cj = jB.attn_cache_init(cfg_j, None, B, 8, jnp.float32)
    ct = tB.attn_cache_init(cfg_t, None, B, 8, torch.float32, "cpu")
    for t in range(S):
        x = _dyadic((B, 1, d), 10 + t, 8)
        pos = np.full((B,), t, np.int32)
        yj, cj = jB.attn_decode(pj, cfg_j, jnp.asarray(x), jnp.asarray(pos),
                                cj, window=window, use_rope=False)
        yt, ct = tB.attn_decode(pt, cfg_t, torch.tensor(x), torch.tensor(pos),
                                ct, window=window, use_rope=False)
        assert _err(yt, yj) <= TOL
        for k in ("k", "v", "pos"):
            np.testing.assert_array_equal(ct[k].numpy(), np.asarray(cj[k]))
        for k in ("k_scale", "v_scale"):
            np.testing.assert_array_equal(
                ct[k].numpy().view(np.uint16),
                np.asarray(cj[k]).view(np.uint16))


def test_int8_decode_matches_jax(int8):
    """The model's int8 decode against JAX's over the same 12 tokens:
    logits rel <= 1e-3; in the cache after the last step every int8 value
    within one step of JAX's and at most 0.1% of them off by that step,
    every float16 scale within one float16 ulp, the positions equal. A
    k that differs from JAX's by an ulp moves a value that sits on a
    rounding boundary by one int8 step (at this seed one of 6,144 k
    values, 1.9e-4 rel on the logits), so the two do not agree to 1e-5;
    a scale or a cache slot wired wrong moves the logits by far more."""
    cache = get_model(int8["cfg8"]).init_cache(int8["cfg8"], B, S, "cpu")
    steps = []
    for t in range(S):
        lg, cache = _step8(int8, cache, t)
        steps.append(lg)
    assert _rel(torch.stack(steps, 1), int8["decode_j"]) <= 1e-3
    for got, want in zip(cache["segments"], int8["decoded_cache_j"][
            "segments"]):
        got, want = got["attn"], want["attn"]
        for k in ("k", "v"):
            off = np.abs(got[k].numpy().astype(np.int32)
                         - want[k].astype(np.int32))
            assert off.max() <= 1 and np.mean(off > 0) <= 1e-3
        for k in ("k_scale", "v_scale"):
            ulps = np.abs(got[k].numpy().view(np.uint16).astype(np.int32)
                          - want[k].view(np.uint16).astype(np.int32))
            assert ulps.max() <= 1
        np.testing.assert_array_equal(got["pos"].numpy(), want["pos"])


def test_int8_decode_keeps_the_forward(int8):
    """tests/test_decode_parity.py's contract on the port's own int8
    decode: rel < 0.05 of the forward, top-1 kept on > 95%."""
    cache = get_model(int8["cfg8"]).init_cache(int8["cfg8"], B, S, "cpu")
    steps = []
    for t in range(S):
        lg, cache = _step8(int8, cache, t)
        steps.append(lg)
    dec = torch.stack(steps, 1)
    assert cache["segments"][0]["attn"]["k"].dtype == torch.int8
    assert _rel(dec, int8["full"]) < 0.05
    assert np.mean(dec.argmax(-1).numpy() == int8["full"].argmax(-1)) > 0.95


def test_ssm_apply_takes_ssd_fn():
    """``ssd_fn=ssd_ref`` replaces the kernel route (the spy sees every
    call), equal to JAX's ``ssm_apply`` with its default ``ssd_ref``."""
    cfg_j = jax_smoke_variant(jax_get_config("mamba2-130m"))
    cfg_t = smoke_variant(get_config("mamba2-130m"))
    lj = jB.ssm_init(jax.random.PRNGKey(3), cfg_j, None, jnp.float32)
    lt = params_from_jax(jax.tree_util.tree_map(np.asarray, lj), "cpu")
    x = _x((2, 40, cfg_j.d_model), 9)
    calls = []

    def spy(*a, **k):
        calls.append(k.get("chunk"))
        return tB.ssd_ref(*a, **k)
    got = tB.ssm_apply(lt, cfg_t, torch.tensor(x), chunk=16, ssd_fn=spy)
    want = jax.jit(lambda l, x: jB.ssm_apply(l, cfg_j, x, chunk=16,
                                             ssd_fn=jB.ssd_ref))(
        lj, jnp.asarray(x))
    assert calls == [16]
    assert _err(got, want) <= TOL
    assert _err(tB.ssm_apply(lt, cfg_t, torch.tensor(x), chunk=16),
                want) <= TOL
