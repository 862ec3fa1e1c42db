"""Serving entry point: batched autoregressive decode with KV/SSM caches
(port of ``repro.launch.serve``).

On-orbit inference of the aggregated global model. The reduced config
runs end to end on the CPU:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
        --smoke --requests 4 --prompt-len 16 --gen 24 --device cpu

and, without ``--device``, on the GPU. Any arch of the registry but the
VQC serves the same way (``--arch deepseek-moe-16b``, ``whisper-tiny``,
``llama-3.2-vision-90b``, ...); the encoder-decoder and the VLM take the
JAX launcher's stubbed audio or image embeddings.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import prng
from repro_torch.launch.steps import stub_embeds


def generate(cfg, api, params, prompts, gen_len: int, cache_len: int,
             extras=None, greedy: bool = True, key=None):
    """prompts (B, P) int -> (B, P+gen_len) int32 tokens. A model with a
    ``prefill_cross`` (encdec, vlm) first fills its cross K/V cache from
    ``extras["audio_embeds"]`` or ``extras["image_embeds"]``; the prompt
    is pre-filled by stepping the decoder over it (the cache fills slot
    by slot; the last logits seed generation). Tokens are the argmax, or
    with ``greedy=False`` and a ``key`` drawn as JAX draws them: the key
    split in two each step, ``prng.categorical`` of the logits under the
    second half."""
    B, P = prompts.shape
    dev = prompts.device
    cache = api.init_cache(cfg, B, cache_len, device=dev)
    if api.prefill_cross is not None:
        emb = extras.get("audio_embeds", extras.get("image_embeds"))
        cache = api.prefill_cross(cfg, params, cache, emb)

    def step(token, t, cache):
        return api.decode_step(cfg, params, cache, {
            "token": token,
            "pos": torch.full((B,), t, dtype=torch.int32, device=dev)})

    logits = None
    for t in range(P):
        logits, cache = step(prompts[:, t], t, cache)
    out = [prompts.to(torch.int32)]
    for t in range(P, P + gen_len):
        if greedy or key is None:
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            key, k = prng.split(key, 2)
            tok = prng.categorical(k, logits).to(torch.int32)
        out.append(tok[:, None])
        logits, cache = step(tok, t, cache)
    return torch.cat(out, dim=1)


def launcher_extras(cfg, key, batch: int) -> dict:
    """The JAX launcher's embeddings: ``steps.stub_embeds`` under
    ``fold_in(key, 2)`` (audio) or ``fold_in(key, 3)`` (image)."""
    return stub_embeds(cfg, batch, prng.fold_in(key, 2), prng.fold_in(key, 3))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.models import get_config, get_model, smoke_variant
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    api = get_model(cfg)
    key = prng.PRNGKey(args.seed, device=args.device)
    params = api.init(cfg, key)

    B, P = args.requests, args.prompt_len
    prompts = prng.randint(prng.fold_in(key, 1), (B, P), 0, cfg.vocab_size)
    extras = launcher_extras(cfg, key, B)

    t0 = time.time()
    with torch.inference_mode():
        toks = generate(cfg, api, params, prompts, args.gen,
                        cache_len=P + args.gen, extras=extras)
    dt = time.time() - t0
    n_new = B * args.gen
    print(f"[serve] {cfg.name}: {B} requests, {args.gen} new tokens each "
          f"-> {n_new/dt:.1f} tok/s (wall {dt:.1f}s)")
    print(f"[serve] sample request 0 tokens: {toks[0, :P + 8].tolist()}")
    assert toks.shape == (B, P + args.gen)
    assert bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
    print("[serve] output shapes + token ranges OK")


if __name__ == "__main__":
    main()
