#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card. It builds
the four hand-written CUDA sources in the checkout (one nvcc per source,
all at once) and then:

1. prints the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, and the kernels' build time;
2. holds the resident gate-layer kernel (#1) against its plain PyTorch
   version on the card at nq ∈ {1, 2, 5, 8, 10, 13} and at the trainer's
   shapes (nq=8: ansatz G=64 clients × S=32 samples, encoding G=2048 ×
   S=1, the per-client oracle's G=1 and G=32, the shift rule's suffix
   G=64 or 1 × S=512) and the in-graph round's (G=50, 1600 × 1, 50 ×
   512): max abs error ≤ 1e-5 on both planes, norms preserved to 1e-5;
   and times the kernel, the plain version and one batched complex matmul
   with the kron'ed layer unitary (the library yardstick, used nowhere in
   the port) with CUDA events over back-to-back calls, and on the device
   alone (``_device_ms``: the calls queued behind a spin kernel);
3. holds the single-gate kernel (#3) against its plain version (≤ 2e-6)
   at the shift rule's insertion shapes (64, 32, 2^8), (1, 32, 2^8) and
   the in-graph round's (50, 32, 2^8) on every qubit and
   with the stride past 2^13 (nq 14-20), and its backward (≤ 1e-5); holds
   the tiled layer (#2) (≤ 2e-6) at the JAX tests' forced small tiles and
   at nq 14, 16 and 20; times #3 at the insertion shape (a complex matmul
   of the (…, 2, lo) view as the library yardstick) and #2 at (64, 32,
   2^14) and (1, 4, 2^20), with one complex matmul by the kron'ed 2^14 x
   2^14 layer unitary (2 GiB; one gate set for all 2,048 rows) as #2's
   library yardstick; then holds the layer backward kernel against its
   plain version (``ref.layer_vjp_ref`` on the same passes) and autograd
   through the plain forward (≤ 1e-5, non-unitary gates) at the trainer's
   shapes (64, 32, 2^8) and (64, 32, 2^14) and the in-graph round's (50,
   32, 2^8), gate-only and state-only,
   forced small tiles and 20 qubits, checks that two calls give the same
   bits, and times it (device and call, the plain version, the autograd
   replay it replaced) at (64, 32, 2^8) and (64, 32, 2^14);
4. holds the fused OTP-XOR + MAC kernel against its plain version, bit
   for bit, in both tag modes: the given-pad body through the rows entry
   (the trainer's stage (64, 62), a multi-block (5, 16389), the bandwidth
   shape (64, 2^20)), the stream entry (62 and 16384·4+7 words) and the
   padded-convention wrappers; the seeded body (pads generated in the
   kernel from seeds and a pad layout, seeds 0 and 2^32 - 1 in every
   check) through the rows entry at the trainer's stage (64 rows of the
   VQC tree: 62 words, 4 leaves), the in-graph round's 50 rows of that
   tree, a mixed-width tree, a multi-block tree
   (5 rows with a 16389-element leaf), (64, 2^20) as one f32 leaf and as
   one bf16 leaf of 2^21 elements, and through the stream entry at 62 and
   65,543 words; times both bodies and their plain versions at those
   shapes against their bounds, and at the stage shape also the path the
   seeded body replaced (the pads built by ``tree_pad_u32_rows`` on the
   card, then the given-pad kernel);
5. runs the trainer at full width — the paper's 50-satellite / 10-plane
   trace over 6 h at 30 s, the 8-qubit 3-layer VQC, synthetic Statlog over
   50 Dirichlet shards, 10 local steps of batch 32 — on every path of the
   port (``TRAINER_PATHS``): qfl and sim without security, under qkd,
   qkd_fernet and the per-edge oracle; qfl and sim under the
   parameter-shift rule on the batched executor and the per-client
   oracle, and sim qkd under it; sim under teleport security; one sim
   round at 14 qubits (the tiled layer); and ROADMAP item 7's modes: seq
   (2 rounds, without security and under qkd), async's staleness ring (4
   rounds, so deferred deliveries arrive: without security, under qkd,
   secagg, and qkd + secagg) and async qkd on the per-client oracle and
   per-edge plane (3 rounds); and ROADMAP item 8's fault plane at
   tests/test_faults.py's rates (flap 0.3, crash 0.2, straggler 0.3,
   tamper 0.3, seed 11): sim qkd edge-batched and on the per-edge oracle
   (2 rounds, bit-equal params, equal accounting and fault reports), seq
   qkd (2) and async qkd + secagg with 2 retries (4; some round must
   retransmit). Every launch count is set to 0 just before
   each path and read just after; each path must launch each of its
   kernels and no other, and each round exactly what the compiled plan
   implies (``_plan_launches``: per local-training call — a stage of
   clients, or one client on the oracle — 10 steps of 1 + L forward and L
   backward layers, 2·len(bwd_passes) launches a backward layer, plus 12
   forward layers of evaluation; the seeded OTP kernel twice a non-empty
   exchange stage edge-batched and twice a delivered edge on the per-edge
   oracle — an edge whose payload moves, delivered or tampered, never a
   flapped or aborted one; crashed secondaries leave the training
   stages, crashed mains ride the mains' stage as masked rows; the
   given-pad entries never): #1 52 (qfl) and 92 (sim) a round,
   the layer backward qfl 60, sim 120 and 14 qubits 360, none under the
   shift rule, the seeded OTP kernel qfl 2 and sim 4; seq (hops + 1)·40 +
   12 of #1, async 92 (52 without a grouped secondary). Every round's val
   loss must be finite and below 10 (≈ ln 7). At the end of the async
   qkd and qkd + secagg paths the ring's last-round merges are held bit
   for bit against the per-main-list oracle's merges of the same entries
   on the card. On the fault paths every row with a tamper word must fail
   the seeded kernel's MAC on the card and every other delivered row pass
   (counts printed); async qkd + secagg with retries is run again for 2
   rounds, checkpointed, restored into a fresh trainer and run on, and
   must end bit-identical to its uninterrupted run (params as int32,
   history, fault reports, comm log); and with ``on_fault="raise"`` the
   first faulted round of sim qkd must raise the same ``FaultError``
   subclass with the same sites on the card as on the CPU;
6. runs the VQC at 20 qubits (one batch of 4): forward, autodiff and the
   parameter-shift rule, with their launches counted, against the same
   with the plain versions on the card; and one full-width local step of
   the parameter-shift rule (K=64 clients and the oracle's K=1, batch 32)
   with the kernels against the same step with the plain versions
   (≤ 1e-5), its launches counted (13 of #1, 96 of #3);
7. runs the sim trainer on the CPU (plain path) and on the card, without
   security, under the parameter-shift rule (2 local steps of batch 8)
   and under qkd, async under qkd + secagg (4 rounds) and sim under qkd
   with faults (2 rounds), and holds the metrics within 1e-4 and the
   accounting, delivered counts and fault reports exactly equal (async:
   the secagg merge of the card's ring, run on both devices, bit-equal);
   and one drop-mode round with forced eavesdroppers on both, whose
   aborted edges must agree;
8. profiles one warm round each of sim under qkd, under the
   parameter-shift rule and at 14 qubits, and of async under qkd and
   under secagg, with ``torch.profiler`` and prints the device-busy
   share, the round's device-op count and the kernels that take the most
   device time, and the device ops of secagg's two pad calls (the send's
   masks, the merge's corrections) at that round's shapes;
9. drives the in-graph round (``core.dist.make_fl_round``, ROADMAP item
   10) at the same full width — phase 5's trace and shards, the 8-qubit
   3-layer VQC, 10 local steps of batch 32, ``sgd(fl.lr)``, batches drawn
   as the JAX launcher draws them, the plan compiled with seeds
   (``DIST_PATHS``): sim under none, otp, otp_gather and secagg, qfl
   under otp, seq under none and otp (4 hops), 2 rounds each; async
   under none and otp, 4 rounds; sim under the shift rule, 1 round; sim
   otp and async otp with ``plan.fault_mask`` at tests/test_faults.py's
   rates (momentum, so frozen slots show), 2 rounds each. Every round
   must launch exactly ``_dist_round_launches`` (per round, H = 4 hops in
   seq and 1 otherwise: #1 40·H and the backward 60·H under autodiff;
   130 of #1 and 960 of #3 under the shift rule; the seeded OTP rows
   entry 2·H under otp, 2 under otp_gather, 0 otherwise) and no other
   kernel, with a finite loss below 10. sim, qfl and seq end with every
   row bit-equal to row 0; sim otp and otp_gather end bit-equal to sim;
   ``mac_ok`` holds; otp_gather's sender and aggregator launches on the
   last round's seeds equal the plain version bit for bit; one flipped
   ciphertext word fails its row's MAC and no other, under the plain
   verify and under the round's own check; sim secagg is within 1e-5 of
   sim; the CPU is within 1e-4 of the card's runs of sim otp (2 rounds)
   and async otp (4 rounds); crashed rows keep
   their optimizer slots bit for bit. It profiles one warm sim otp round
   and runs ``launch.train.main(["--fl", "--sats", "50", "--rounds",
   "2", "--security", "otp"])`` with no ``--device``, which must run on
   the card with its own launch counts;
10. holds the sliding-window attention kernel (tensor cores in bf16, CUDA
   cores in f32) against its plain version
   (f32 ≤ 2e-5; bf16 within one bf16 step of each element, see
   ``_bf16_steps``) at hymba-1.5b's prefill shape (4, 2048,
   25 heads over 5 kv heads, hd 64) at W=1024 and W=0 in bf16 and f32,
   qwen3-0.6b's hd 128 with GQA 16/8, and S=1000 with W=100, W > S and
   S=1, and at the LM training path's full causal shapes (4 x 2048 tokens:
   qwen3 in bf16 and f32, tinyllama's GQA 32/4, olmo's MHA at hd 128,
   granite's MQA; the smoke steps' f32 shapes) and at phase 15's MoE
   prefill shapes (qwen3-moe-235b-a22b's GQA 64/4 at hd 128 in bf16 and
   f32; deepseek-moe-16b's MHA 16/16 at hd 128 is olmo's shape) and at
   phase 16's (whisper-tiny's decoder, 16 x 448, MHA 6/6 at hd 64; the
   VLM's self layers, 4 x 2048, GQA 64/8 at hd 128; bf16 and f32); times
   the kernel (CUDA events, back to back and on the device alone), the
   plain version and
   SDPA with a boolean band mask (the library yardstick, used nowhere in
   the port) at hymba's shapes, the three full-width training shapes,
   qwen3-moe's and phase 16's two bf16 shapes, where in bf16 SDPA and the XLA path's bf16 softmax
   (``blocks._sdpa_core``) must fail the bf16 limit;
11. holds the SSD scan kernel (one launch over (batch, head, chunk)
   blocks) against its plain version (y and state ≤ 3e-5 in f32; y within
   one bf16 step of each element in bf16, which the plain version fed dt
   rounded to bf16 must fail; the state ≤ 3e-5 in both) at hymba's (4,
   2048, 50 heads, P 64, N 16), mamba2-130m's N=128 in f32 and bf16 (its
   training shape), two B/C groups and S=1000 (chunk 125), the smoke
   mamba2's, and once from a given initial state;
   times it at hymba's shape and at mamba2-130m's N=128 in bf16;
12. serves hymba-1.5b at full width and depth in bf16 from random weights:
   one ``make_prefill_step`` over 4 requests x 2048 tokens and
   ``generate`` for 4 requests of 16 prompt tokens and 32 new ones, the
   launch counts set to 0 just before each and read just after (the
   prefill must launch each kernel 32 times, 29 + 3 attention launches at
   W=1024 and W=0; decode neither), with prefill and decode rates, peak
   device memory and a profile of one prefill;
13. cross-checks the serving path in f32 at full width: forward vs
   decode-stepped logits over 64 tokens (rel < 2e-3), the full-depth
   prefill's next-token logits with the kernels vs their plain versions
   (rel ≤ 1e-4, TF32 off), and a 2-layer prefill of 2 x 256 tokens on
   the CPU vs the card (rel ≤ 1e-4);
14. trains the LM path (ROADMAP item 11a) in bf16 under adamw and the
   launcher's cosine schedule on the synthetic corpus (``LM_TRAIN``):
   qwen3-0.6b and mamba2-130m at full width and depth, 4 x 2048 tokens,
   10 steps each through ``make_train_step``; tinyllama-1.1b and olmo-1b
   one full-width step each through ``launch.train.main`` with no
   ``--device``; granite-34b's smoke variant (in bf16) 3 steps;
   deepseek-moe-16b at full width cut to 4 layers (1 dense, 3 MoE) 3
   steps, whose loss must be the chunked cross-entropy plus 0.01 times a
   positive router aux. Every
   step must launch #6 (dense, moe) or #7 (ssm) exactly 2·L times
   (forward and the per-layer recompute of the backward) and no other
   kernel, with a finite loss; it prints each arch's seconds per step,
   tokens per second, peak device memory and losses, and profiles one
   warm qwen3 step and one mamba2 step. Then a smoke step of qwen3,
   mamba2 and deepseek-moe-16b in f32 under sgd at lr 1,
   card vs CPU (loss and every parameter, so every gradient, ≤ 1e-4), and
   the federated-LLM twin
   (``repro_torch.examples.llm_federated``, the smoke qwen3 on 4
   satellites) on the card under none, otp, otp_gather and secagg, 2
   rounds each, with its launches held per round (#6 4·3·2·L + L, the
   seeded OTP rows entry 2 under otp and otp_gather) and otp_gather's
   MAC check passing;
15. serves the MoE decoders (ROADMAP item 11b) in bf16 from random
   weights of seed 0 (``MOE_SERVE``): deepseek-moe-16b at full width and
   depth (16.4 B parameters) and qwen3-moe-235b-a22b at full width cut to
   4 layers (11.2 B; 94 layers do not fit one card), each initialised
   (timed: the slab draws of ``nn.init``) and freed after: one
   ``make_prefill_step`` over 4 x 2048 tokens, which must launch #6 once
   a layer at W=0 and no other kernel (28; 4), profiled; deepseek also
   ``generate``s 4 requests of 16 prompt and 32 new tokens, launching no
   kernel, with one decode step profiled. Then deepseek in f32 at full
   width cut to 4 layers, TF32 off: the prefill of 2 x 2048 tokens with
   #6 against its plain version (rel ≤ 1e-4), forward vs decode-stepped
   logits over 64 tokens at capacity 16 (rel < 2e-3), and a 2-layer
   prefill of 2 x 256 tokens on the CPU against the card (rel ≤ 1e-4);
   each pair's routed experts compared layer by layer and the entries
   that differ (near ties) counted;
16. serves and trains the encoder-decoder and the VLM (ROADMAP item
   11c) in bf16 from random weights of seed 0, the launch counts set to
   0 just before each path and read just after, with the JAX launcher's
   stubbed embeddings (``launch.serve.launcher_extras``,
   ``launch.train.lm_extras``): whisper-tiny at full width and depth (4 +
   4 layers, d 384, 1500 frames) — one ``make_prefill_step`` over 16 x
   448 decoder tokens (exactly 4 launches of #6 at W=0 and no other
   kernel; profiled), ``generate`` of 4 requests x (4 + 60) tokens
   through ``prefill_cross`` (no kernel), 3 adamw steps at 16 x 448 (8
   of #6 a step); llama-3.2-vision-90b at full width cut to 10 of 100
   layers (2 groups of 1 cross + 4 self layers; 90 B bf16 weights do not
   fit one card) — init (timed), one prefill of 4 x 2048 tokens with 4 x
   1600 image tokens (exactly 8 of #6; profiled), ``generate`` of 4 x
   (16 + 32) (no kernel); then its first group (5 layers) 3 sgd steps at
   4 x 2048 (8 of #6 a step; adamw's moments would not fit). f32 checks,
   TF32 off: whisper at full depth with its biases and LayerNorm leaves
   drawn nonzero, the prefill with #6 against its plain
   version and the CPU against the card (rel <= 1e-4), forward against
   decode-stepped logits over 64 tokens (rel < 2e-3); the VLM's first
   group with its tanh gates at 0.5 (so the image tokens reach the
   logits), #6 against plain at 2 x 2048 and forward against decode;
   the smoke VLM, CPU against card. Last, the int8 KV cache on
   tinyllama-1.1b at full width: 4 x (16 + 32) tokens decoded on the int8
   and the bf16 cache, logits rel < 0.05, top-1 agreement and the
   caches' bytes printed;
17. runs ROADMAP item 12b's paths: (a) the four examples
   (``repro_torch.examples``) on the card at the JAX scripts' defaults
   (satqfl_statlog: 50 satellites, 6 rounds, 8 local steps, 6 qubits over
   the four frameworks), each example's launches read around it (#1 and
   the layer backward in every example that trains, the seeded OTP rows
   under qkd, secure_exchange's given-pad stream and rows entries), every
   val loss finite and below 10, secure_exchange's decryption exact and
   its one-bit tamper caught by the kernel's tag; (b) the (1, 1) host
   mesh on the card (a world-1 NCCL group from a file store): qwen3-0.6b
   at full width in bf16, DTensor parameters placed by ``param_specs``
   under ``seq_shard``, one ``make_prefill_step`` over 4 x 2048 tokens
   and one adamw ``make_train_step``, and mamba2-130m's prefill, each
   bit for bit its ``ctx=None`` run with the same #6/#7 launches; the
   analytic per-chip memory (``launch.analysis``) at one chip beside
   each of these steps' own peak (its inputs' bytes plus the most it
   allocated above what was held when it started) and phase 13's hymba
   and phase 15's deepseek prefill peaks; the card's ``total_memory``;
   (c) the dry-run (``python -m repro_torch.launch.dryrun``, a fake
   256-rank group, meta shards, no GPU) of whisper-tiny × decode_32k,
   mamba2-130m × long_500k and deepseek-moe-16b × train_4k (expert
   parallelism) in three subprocesses, one roofline row each.

It prints one ``{"kernels": [...]}`` line (the layer backward as
``statevec_gate_layer_bwd`` beside the seven ported TPU kernels; #4 and #5
as the OTP kernel's seeded entries, each with its given-pad body under
``given_pad``), the card
line, and as its last
line ``{"ok": true, "device": {...}}``. Each kernel's ``launches_by_path``
covers the trainer paths, the in-graph paths (``dist_*``), serving, the
LM training runs (``lm_*``), the twin (``twin_*``), the MoE serving
paths (``serve_moe_*``), phase 16's (``serve_encdec_*``,
``serve_vlm_*``, ``lm_whisper-tiny``, ``lm_vlm``, ``serve_int8_decode``)
and phase 17's (``example_*``, ``mesh_*``);
#6's entry carries the MoE readings (``moe_*``) and phase 16's
(``encdec_vlm_*``).
Without a CUDA device, or outside a
checkout, it exits non-zero and prints no result. Any failed phase exits
non-zero.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
# H100 SXM 32-bit integer rate: 64 INT32 lanes per SM (half the float32
# lanes, Hopper architecture white paper) x 132 SMs x 1.98 GHz boost
INT32_OPS = 64 * 132 * 1.98e9
TOL = 1e-5
# the last two put group boundaries inside blocks, across many blocks
# then the trainer's shapes: the ansatz and encoding layers on the batched
# executor (K=64 clients x B=32) and the per-client oracle (K=1), and the
# shift rule's suffix layers over the branch stacks (K, 2·nq·B, 2^8)
CHECK_SHAPES = [(4, 3, 1), (4, 3, 2), (4, 3, 5), (4, 3, 8), (3, 2, 10),
                (2, 2, 13), (40, 3, 8), (9, 7, 10),
                (64, 32, 8), (2048, 1, 8), (1, 32, 8), (32, 1, 8),
                (64, 512, 8), (1, 512, 8),
                # the in-graph round's 50 rows: ansatz, encoding, shift
                (50, 32, 8), (1600, 1, 8), (50, 512, 8)]
MAIN_SHAPES = {"ansatz": (64, 32, 8), "encoding": (2048, 1, 8),
               "shift_suffix": (64, 512, 8)}


class PhaseError(RuntimeError):
    pass


def _card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else (
        f"nvidia-smi failed: {out.stderr.strip()}")


def _cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of one call, from CUDA events over ``iters`` calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _dev_us(event) -> float:
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def _device_ms(torch, fn, iters: int) -> float | None:
    """Device time of one call of ``fn``: CUDA events around ``iters``
    calls queued behind a spin kernel that outlasts their enqueueing, so
    the events bracket device work only (the wrapper's host path, which
    ``_cuda_ms`` includes for short kernels, is left out).

    The spin is sized from the enqueue time of a first loop, and whether
    it outlasted the timed loop's enqueueing is checked: the start event
    must still be pending when the loop is queued. If it is not, the spin
    is doubled and the loop timed again; after four tries the reading is
    None ("not measured"), never a time that holds host work.

    Kernel-alone ``torch.profiler`` profiles, which this replaces, came
    back without device records on an H100 in most runs (every other
    profile, and one read half the event time), while the whole-path
    profiles of the same runs had them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    # ~2e9 cycles a second on an H100: spin for twice the enqueue time
    cycles = int(2e9 * (2 * enqueue_s + 1e-3))
    for _ in range(4):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        spun_past = not start.query()
        torch.cuda.synchronize()
        if spun_past:
            return start.elapsed_time(stop) / iters
        cycles *= 2
    print(f"device time not measured: the spin ended before {iters} calls "
          f"were queued, at {cycles // 2} cycles")
    return None


def _random_layer(torch, G, S, nq, seed):
    """Normalized random states and random unitary gate sets on the card."""
    g = torch.Generator().manual_seed(seed)
    st = torch.randn(G, S, 1 << nq, dtype=torch.complex64, generator=g)
    st = st / torch.linalg.norm(st, dim=-1, keepdim=True)
    th, ph, la = torch.rand(3, G, nq, generator=g) * 6.0 - 3.0
    c = torch.cos(th / 2).to(torch.complex64)
    s = torch.sin(th / 2).to(torch.complex64)
    e = lambda a: torch.exp(1j * a.to(torch.complex64))
    gates = torch.stack([torch.stack([c, -e(la) * s], -1),
                         torch.stack([e(ph) * s, e(ph + la) * c], -1)], -2)
    return (st.real.contiguous().cuda(), st.imag.contiguous().cuda(),
            gates.cuda())


def _kron_layer(torch, gates):
    """(G, nq, 2, 2) -> (G, 2^nq, 2^nq): gate q on qubit q, little-endian."""
    u = gates[:, 0]
    for q in range(1, gates.shape[1]):
        hi = gates[:, q]
        d = u.shape[-1]
        u = torch.einsum("ghk,gab->ghakb", hi, u).reshape(-1, 2 * d, 2 * d)
    return u


def phase_kernel(torch, ops, ref):
    """Kernel vs plain on the card; times at the trainer's shapes."""
    max_err = 0.0
    for i, (G, S, nq) in enumerate(CHECK_SHAPES):
        re, im, gates = _random_layer(torch, G, S, nq, seed=i)
        g8 = ops.pack_gates(gates)
        got = ops.apply_gate_layer(re, im, g8)
        want = ref.apply_layer_planes_ref(re, im, g8)
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        norm = (got[0] ** 2 + got[1] ** 2).sum(-1)
        norm_err = (norm - 1.0).abs().max().item()
        print(f"kernel check G={G} S={S} nq={nq}: max_abs_err={err:.3e} "
              f"norm_err={norm_err:.3e}")
        if not (err <= TOL and norm_err <= TOL):
            raise PhaseError(f"kernel disagrees at G={G} S={S} nq={nq}: "
                             f"err {err}, norm err {norm_err}")
        max_err = max(max_err, err)

    timings = {}
    for name, (G, S, nq) in MAIN_SHAPES.items():
        re, im, gates = _random_layer(torch, G, S, nq, seed=100)
        g8 = ops.pack_gates(gates)
        state = torch.complex(re, im)
        u_t = _kron_layer(torch, gates).transpose(-1, -2).contiguous()
        lib = torch.matmul(state, u_t)
        got = ops.apply_gate_layer(re, im, g8)
        lib_err = max((lib.real - got[0]).abs().max().item(),
                      (lib.imag - got[1]).abs().max().item())
        rows, dim = G * S, 1 << nq
        n_bytes = 2 * 4 * dim * rows * 2 + 4 * G * nq * 8
        n_flops = 28 * (dim // 2) * nq * rows
        layer = lambda: ops.apply_gate_layer(re, im, g8)
        t = {
            "kernel_ms": _cuda_ms(torch, layer, 200),
            "device_ms": _device_ms(torch, layer, 50),
            "plain_ms": _cuda_ms(torch, lambda: ref.apply_layer_planes_ref(
                re, im, g8), 50),
            "library_ms": _cuda_ms(torch, lambda: torch.matmul(state, u_t),
                                   50),
            "bytes_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
            "flops_ms": n_flops / FP32_FLOPS * 1e3,
            "library_max_abs_err": lib_err,
        }
        t["bound_ms"] = max(t["bytes_ms"], t["flops_ms"])
        t["bound_by"] = ("bytes" if t["bytes_ms"] >= t["flops_ms"]
                         else "operations")
        timings[name] = t
        print(f"kernel timing {name} G={G} S={S} nq={nq}: " + json.dumps(t))
    return max_err, timings


# (G, S, nq, q): the shift rule's insertions at the trainer's shapes (every
# qubit; batched executor K=64, per-client oracle K=1 and the in-graph
# round's K=50), the stride
# inside a warp's segment (q < 5) and past 2^13 (q >= 13)
GATE_SHAPES = [(K, 32, 8, q) for K in (64, 1, 50) for q in range(8)] + [
    (4, 3, 5, 4), (3, 1, 1, 0), (2, 2, 14, 13), (1, 3, 15, 14),
    (1, 1, 16, 15), (2, 1, 16, 2), (1, 4, 20, 17), (1, 4, 20, 3)]
# (G, S, nq, low_qubits, group_qubits, group_tile): the JAX tests' forced
# small tiles, then the wide registers of the wide paths
TILED_SHAPES = [(1, 1, 6, 3, 2, 4), (2, 3, 8, 4, 3, 8), (3, 2, 9, 5, 4, 16),
                (64, 32, 14, 13, 7, 512), (3, 2, 16, 13, 7, 512),
                (1, 4, 20, 13, 7, 512), (2, 1, 20, 13, 3, 512)]
GATE_TOL = 2e-6                # f32 max abs, kernels #2 and #3 forward
GRAD_TOL = 1e-5                # their gradients
# the wide paths' main shapes: a 14-qubit round's ansatz layer; nq=20, B=4
TILED_TIMED = {"nq14_ansatz": (64, 32, 14), "nq20_batch4": (1, 4, 20)}


def _sv_bound(n_amps: int, n_pairs_ops: int) -> dict:
    """Least time for a gate op: both planes read once and written once
    (16 B an amplitude), against 28 flops per amplitude pair and stage."""
    bytes_ms = 16 * n_amps / HBM_BYTES_PER_S * 1e3
    flops_ms = 28 * n_pairs_ops / FP32_FLOPS * 1e3
    return {"bound_ms": max(bytes_ms, flops_ms), "bytes_ms": bytes_ms,
            "flops_ms": flops_ms,
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}


def phase_gate_kernels(torch, ops, ref):
    """Kernels #3 (one gate) and #2 (the tiled layer) against their plain
    versions on the card, forward ≤ 2e-6 and #3's backward ≤ 1e-5; times
    at the shapes their paths give them: #3 at the shift rule's insertion
    (64, 32, 2^8) for every qubit, with a complex matmul of the (…, 2, lo)
    view as the library yardstick (used nowhere in the port); #2 at the
    wide paths' (64, 32, 2^14) and (1, 4, 2^20) (no single PyTorch call
    computes the layer)."""
    worst = {"statevec_gate_1q": 0.0, "statevec_gate_tiled": 0.0}
    for i, (G, S, nq, q) in enumerate(GATE_SHAPES):
        re, im, gates = _random_layer(torch, G, S, nq, seed=200 + i)
        g8 = ops.pack_gates(gates[:, q % nq])
        got = ops.apply_gate(re, im, g8, q)
        want = ref.apply_gate_planes_ref(re, im, g8, q)
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        print(f"gate check G={G} S={S} nq={nq} q={q}: max_abs_err={err:.3e}")
        if not err <= GATE_TOL:
            raise PhaseError(f"gate kernel disagrees at G={G} S={S} nq={nq} "
                             f"q={q}: {err}")
        worst["statevec_gate_1q"] = max(worst["statevec_gate_1q"], err)
    # the backward: the adjoint gate through the kernel + the plain cotangent
    re, im, gates = _random_layer(torch, 3, 2, 14, seed=300)
    g8 = ops.pack_gates(gates[:, 0])
    w = torch.randn(2, 3, 2, 1 << 14, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    grads = []
    for fn in (ops.apply_gate, ref.apply_gate_planes_ref):
        for q in (1, 13):
            args = [x.clone().requires_grad_(True) for x in (re, im, g8)]
            out_r, out_i = fn(*args, q)
            (w[0] * out_r + w[1] * out_i).sum().backward()
            grads.append([a.grad for a in args])
    grad_err = max((a - b).abs().max().item() for k, p in zip(grads[:2],
                                                              grads[2:])
                   for a, b in zip(k, p))
    print(f"gate backward check nq=14 q=1,13: max_abs_err={grad_err:.3e}")
    if not grad_err <= GRAD_TOL:
        raise PhaseError(f"gate kernel backward disagrees: {grad_err}")

    for i, (G, S, nq, low, gq, gt) in enumerate(TILED_SHAPES):
        re, im, gates = _random_layer(torch, G, S, nq, seed=400 + i)
        g8 = ops.pack_gates(gates)
        got = ops.apply_gate_layer(re, im, g8, low_qubits=low,
                                   group_qubits=gq, group_tile=gt)
        if ops.LAYER_DEBUG["path"] != "tiled":
            raise PhaseError(f"nq={nq} took the {ops.LAYER_DEBUG['path']} "
                             f"plan, not the tiled one")
        want = ref.apply_layer_planes_ref(re, im, g8)
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        # unitarity: the output's norm is the input's (summed in float64,
        # since a float32 sum of 2^20 squares is itself ~1e-4 off)
        sq = lambda r, i: (r.double() ** 2 + i.double() ** 2).sum(-1)
        norm_err = (sq(*got) - sq(re, im)).abs().max().item()
        print(f"tiled check G={G} S={S} nq={nq} low={low} group={gq} "
              f"tile={gt}: max_abs_err={err:.3e} norm_err={norm_err:.3e}")
        if not (err <= GATE_TOL and norm_err <= TOL):
            raise PhaseError(f"tiled kernel disagrees at nq={nq}, low={low}: "
                             f"{err}, norm {norm_err}")
        worst["statevec_gate_tiled"] = max(worst["statevec_gate_tiled"], err)
        del re, im, got, want

    timings = {"statevec_gate_1q": {}, "statevec_gate_tiled": {}}
    G, S, nq = 64, 32, 8
    re, im, gates = _random_layer(torch, G, S, nq, seed=500)
    state = torch.complex(re, im)
    for q in range(nq):
        g8 = ops.pack_gates(gates[:, q])
        lo = 1 << q
        view = state.reshape(G, S, -1, 2, lo)
        u = gates[:, q].reshape(G, 1, 1, 2, 2)
        lib = lambda: torch.matmul(u, view)
        out, lib_out = ops.apply_gate(re, im, g8, q), lib().reshape(G, S, -1)
        lib_err = max((lib_out.real - out[0]).abs().max().item(),
                      (lib_out.imag - out[1]).abs().max().item())
        call = lambda: ops.apply_gate(re, im, g8, q)
        t = {"shape": [G, S, 1 << nq], "qubit": q,
             "ms": _cuda_ms(torch, call, 200),
             "device_ms": _device_ms(torch, call, 50),
             "plain_ms": _cuda_ms(torch, lambda: ref.apply_gate_planes_ref(
                 re, im, g8, q), 50),
             "library_ms": _cuda_ms(torch, lib, 50),
             "library_max_abs_err": lib_err,
             **_sv_bound(G * S << nq, G * S << (nq - 1))}
        timings["statevec_gate_1q"][f"q{q}"] = t
        print(f"gate timing: " + json.dumps(t))
    for name, (G, S, nq) in TILED_TIMED.items():
        re, im, gates = _random_layer(torch, G, S, nq, seed=600)
        g8 = ops.pack_gates(gates)
        n_passes = 1 + len(ops.group_passes(nq))
        call = lambda: ops.apply_gate_layer(re, im, g8)
        amps = G * S << nq
        t = {"shape": [G, S, 1 << nq], "passes": n_passes,
             "ms": _cuda_ms(torch, call, 20),
             "device_ms": _device_ms(torch, call, 10),
             "plain_ms": _cuda_ms(torch, lambda: ref.apply_layer_planes_ref(
                 re, im, g8), 3),
             "library_ms": None, "library_max_abs_err": None,
             # the kernel's own traffic: every pass reads and writes the
             # state once
             "pass_bytes_ms": n_passes * 16 * amps / HBM_BYTES_PER_S * 1e3,
             **_sv_bound(amps, (amps >> 1) * nq)}
        if nq == 14:
            # the library yardstick: one complex matmul by the kron'ed
            # 2^14 x 2^14 layer unitary (2 GiB in complex64). 64 groups'
            # unitaries would take 128 GiB, so every row takes group 0's
            # gate set here, and the kernel is held to it on those gates
            shared = gates[:1]
            u_t = _kron_layer(torch, shared)[0].transpose(0, 1).contiguous()
            state = torch.complex(re, im).reshape(G * S, 1 << nq)
            lib = lambda: torch.matmul(state, u_t)
            want = ops.apply_gate_layer(re, im, ops.pack_gates(
                shared).expand(G, nq, 8).contiguous())
            got = lib().reshape(G, S, 1 << nq)
            t["library_max_abs_err"] = max(
                (got.real - want[0]).abs().max().item(),
                (got.imag - want[1]).abs().max().item())
            t["library_ms"] = _cuda_ms(torch, lib, 3)
            del u_t, state, got, want
        timings["statevec_gate_tiled"][name] = t
        print(f"tiled timing {name}: " + json.dumps(t))
        del re, im, gates, g8
    torch.cuda.empty_cache()
    return worst, grad_err, timings


# (G, S, nq, low_qubits, group_qubits, noise): the trainer's ansatz (and
# the in-graph round's 50 rows) and 14-qubit layers, forced small tiles (several column passes) and the
# 20-qubit VQC's layer. The gates are non-unitary (complex noise of scale
# 0.2) except at the 14-qubit trainer shape, which takes the trainer's
# unitary gates: there 14 noisy gates grow the cotangents to tens, where
# float32 rounding alone comes within a few ulps of 1e-5
BWD_SHAPES = [(64, 32, 8, 13, 7, 0.2), (50, 32, 8, 13, 7, 0.2),
              (64, 32, 14, 13, 7, 0.0),
              (1, 1, 6, 3, 2, 0.2), (2, 3, 8, 4, 3, 0.2),
              (3, 2, 10, 13, 7, 0.2), (1, 4, 20, 13, 7, 0.2)]
BWD_TIMED = {"ansatz": (64, 32, 8), "nq14_ansatz": (64, 32, 14)}


def _noisy_layer(torch, G, S, nq, seed, scale=0.2):
    """``_random_layer``'s states and its gates made non-unitary by complex
    noise of ``scale``: the backward never inverts a gate."""
    re, im, gates = _random_layer(torch, G, S, nq, seed)
    g = torch.Generator("cuda").manual_seed(seed)
    noise = torch.randn(gates.shape, dtype=torch.complex64, device="cuda",
                        generator=g)
    return re, im, gates, (gates + scale * noise)


def _bwd_bound(amps: int, nq: int, G: int, need_state: bool) -> dict:
    """Least time for the layer's backward: the input and the cotangent
    read, the state cotangent written (24 B an amplitude, 16 B gate-only)
    plus the gates and their cotangent; per amplitude and qubit the
    forward butterfly and the adjoint one (14 flops each) and the gate
    cotangent's 8 sums of 2 products over each pair (16 flops), the last
    adjoint only where the state cotangent is wanted."""
    n_bytes = (24 if need_state else 16) * amps + 2 * 4 * G * nq * 8
    n_flops = amps * nq * 44 - (0 if need_state else amps * 14)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    flops_ms = n_flops / FP32_FLOPS * 1e3
    return {"bound_ms": max(bytes_ms, flops_ms), "bytes_ms": bytes_ms,
            "flops_ms": flops_ms,
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}


def phase_layer_backward(torch, ops, ref):
    """The layer backward kernel (``ops._layer_backward``, which
    ``apply_gate_layer``'s autograd Function runs on the card) against its
    plain version (``ref.layer_vjp_ref`` on the same passes, on the card)
    and against autograd through the plain forward, ≤ 1e-5, with both
    cotangents, gate-only (the ansatz's first layer) and state-only; two
    calls must give the same bits. Times it at the trainer's shapes: the
    kernel (device and call), the plain version and the autograd replay of
    the plain forward that it replaced (no single PyTorch call computes
    it)."""
    worst = 0.0
    for i, (G, S, nq, low, gq, scale) in enumerate(BWD_SHAPES):
        re, im, _, gates = _noisy_layer(torch, G, S, nq, 700 + i, scale)
        g8 = ops.pack_gates(gates)
        w = torch.randn(2, G, S, 1 << nq, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(i))
        passes = ops.bwd_passes(nq, low, gq)
        args = [x.clone().requires_grad_(True) for x in (re, im, g8)]
        out = ref.apply_layer_planes_ref(*args)
        (w[0] * out[0] + w[1] * out[1]).sum().backward()
        replay = [a.grad for a in args]
        del args, out
        for need_state, need_gate in ((True, True), (False, True),
                                      (True, False)):
            got = ops._layer_backward(re, im, g8, w[0], w[1], passes,
                                      need_state, need_gate)
            again = ops._layer_backward(re, im, g8, w[0], w[1], passes,
                                        need_state, need_gate)
            plain = ref.layer_vjp_ref(re, im, g8, w[0], w[1], passes,
                                      need_state, need_gate)
            torch.cuda.synchronize()
            flat = lambda r: [*r[0], r[1]]
            pairs = [(a, b, c) for a, b, c in zip(flat(got), flat(plain),
                                                  replay) if a is not None]
            if len(pairs) != need_state * 2 + need_gate:
                raise PhaseError(f"layer backward returned "
                                 f"{len(pairs)} cotangents, wanted "
                                 f"state={need_state} gate={need_gate}")
            err = max((a - b).abs().max().item() for a, b, _ in pairs)
            err_ad = max((a - c).abs().max().item() for a, _, c in pairs)
            same = all(torch.equal(a, b) for a, b in zip(flat(got),
                                                         flat(again))
                       if a is not None)
            print(f"layer backward check G={G} S={S} nq={nq} low={low} "
                  f"group={gq} noise={scale} state={need_state} "
                  f"gate={need_gate}: "
                  f"max_abs_err={err:.3e} vs_autograd={err_ad:.3e} "
                  f"bit_identical={same}")
            if not (err <= GRAD_TOL and err_ad <= GRAD_TOL and same):
                raise PhaseError(f"layer backward disagrees at G={G} S={S} "
                                 f"nq={nq}: {err}, autograd {err_ad}, "
                                 f"bit-identical {same}")
            worst = max(worst, err, err_ad)
        del re, im, w, replay
    timings = {}
    for name, (G, S, nq) in BWD_TIMED.items():
        re, im, _, gates = _noisy_layer(torch, G, S, nq, 800)
        g8 = ops.pack_gates(gates)
        w = torch.randn(2, G, S, 1 << nq, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(8))
        passes = ops.bwd_passes(nq)
        big = nq > 13

        def replay():
            args = [x.detach().requires_grad_(True) for x in (re, im, g8)]
            with torch.enable_grad():
                out = ref.apply_layer_planes_ref(*args)
                return torch.autograd.grad(out, args, (w[0], w[1]))

        for label, need_state in (("both", True), ("gate_only", False)):
            call = lambda: ops._layer_backward(re, im, g8, w[0], w[1],
                                               passes, need_state, True)
            before = ops.LAYER_BWD_LAUNCHES
            call()
            t = {"shape": [G, S, 1 << nq], "passes": passes,
                 "launches": ops.LAYER_BWD_LAUNCHES - before,
                 "ms": _cuda_ms(torch, call, 20 if big else 200),
                 "device_ms": _device_ms(torch, call, 10 if big else 50),
                 "plain_ms": _cuda_ms(torch, lambda: ref.layer_vjp_ref(
                     re, im, g8, w[0], w[1], passes, need_state, True),
                     3 if big else 20),
                 "replay_ms": _cuda_ms(torch, replay, 3 if big else 20),
                 "library_ms": None,
                 **_bwd_bound(G * S << nq, nq, G, need_state)}
            timings[f"{name}_{label}"] = t
            print(f"layer backward timing {name} {label}: " + json.dumps(t))
        del re, im, w, g8, gates
    torch.cuda.empty_cache()
    return worst, timings


def _data(torch, n_sats):
    from repro_torch.data import dirichlet_partition, make_statlog, server_split
    X, y = make_statlog(n_features=8, device="cuda")
    Xc, yc, server = server_split(X, y)
    return dirichlet_partition(Xc, yc, n_sats), server


SV_SOURCE = "src/repro_torch/kernels/statevec_gate/csrc/statevec_gate.cu"
OTP_ROW_SHAPES = {"stage": (64, 62), "multiblock": (5, 16389),
                  "bandwidth": (64, 1 << 20)}
OTP_STREAM_SHAPES = {"edge": 62, "stream": 16384 * 4 + 7}
OTP_SOURCE = "src/repro_torch/kernels/otp_xor/csrc/otp_xor.cu"


def _words(torch, shape, seed):
    """Random u32 words in int32 bit storage, made on the card."""
    g = torch.Generator("cuda").manual_seed(seed)
    return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                         device="cuda", generator=g)


def _otp_gap(torch, got, want) -> int:
    """Largest |difference| of ciphertext words and tags (0 = bit-exact)."""
    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               for a, b in zip(got, want))


def _otp_bound(rows: int, n: int) -> dict:
    """Least time for XOR + MAC of rows × n words: msg and pad read, ct
    written (12 B a word) plus keys and tags; one XOR and two modular
    multiply-adds (5 integer ops) a word."""
    n_bytes = 12 * rows * n + 12 * rows
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 5 * rows * n / INT32_OPS * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bytes_ms": bytes_ms,
            "ops_ms": ops_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def phase_otp_kernel(torch, ops, ref):
    """The fused OTP-XOR + MAC kernel vs plain, bit for bit; timings."""
    worst = {"otp_xor_mac_edges": 0, "otp_xor_mac": 0}
    timings = {"otp_xor_mac_edges": {}, "otp_xor_mac": {}}
    for i, (name, (E, n)) in enumerate(OTP_ROW_SHAPES.items()):
        msg, pad = _words(torch, (E, n), 10 * i), _words(torch, (E, n),
                                                         10 * i + 1)
        rk, sk = _words(torch, (E,), 10 * i + 2), _words(torch, (E,),
                                                         10 * i + 3)
        for tag_input in (False, True):
            got = ops.otp_xor_mac_rows(msg, pad, rk, sk, tag_input)
            want = ref.otp_xor_mac_rows_ref(msg, pad, rk, sk, tag_input)
            torch.cuda.synchronize()
            gap = _otp_gap(torch, got, want)
            print(f"otp rows check {name} E={E} n={n} "
                  f"tag_input={tag_input}: max_abs_err={gap}")
            worst["otp_xor_mac_edges"] = max(worst["otp_xor_mac_edges"], gap)
        big = E * n > 1 << 24
        call = lambda: ops.otp_xor_mac_rows(msg, pad, rk, sk)
        t = {"shape": [E, n], "ms": _cuda_ms(torch, call, 20 if big else 200),
             "device_ms": _device_ms(torch, call, 20),
             "plain_ms": _cuda_ms(torch, lambda: ref.otp_xor_mac_rows_ref(
                 msg, pad, rk, sk), 3 if big else 20),
             **_otp_bound(E, n)}
        timings["otp_xor_mac_edges"][name] = t
        print(f"otp rows timing {name}: " + json.dumps(t))
        del msg, pad
    for i, (name, n) in enumerate(OTP_STREAM_SHAPES.items()):
        msg, pad = _words(torch, (n,), 100 + i), _words(torch, (n,), 200 + i)
        keys = _words(torch, (2,), 300 + i).tolist()
        for tag_input in (False, True):
            got = ops.otp_xor_mac_stream(msg, pad, keys[0], keys[1],
                                         tag_input)
            kt = torch.tensor(keys, dtype=torch.int32, device="cuda")
            ct, tag = ref.otp_xor_mac_rows_ref(msg[None], pad[None], kt[:1],
                                               kt[1:], tag_input)
            torch.cuda.synchronize()
            gap = _otp_gap(torch, got, (ct[0], tag[0]))
            print(f"otp stream check {name} n={n} tag_input={tag_input}: "
                  f"max_abs_err={gap}")
            worst["otp_xor_mac"] = max(worst["otp_xor_mac"], gap)
        call = lambda: ops.otp_xor_mac_stream(msg, pad, keys[0], keys[1])
        t = {"shape": [n], "ms": _cuda_ms(torch, call, 200),
             "device_ms": _device_ms(torch, call, 20),
             "plain_ms": _cuda_ms(torch, lambda: ref.otp_xor_mac_rows_ref(
                 msg[None], pad[None], kt[:1], kt[1:]), 20),
             **_otp_bound(1, n)}
        timings["otp_xor_mac"][name] = t
        print(f"otp stream timing {name}: " + json.dumps(t))
    # the JAX wrappers' convention: zero-padded to whole 16384-word blocks,
    # tag over the padded stream
    E, n = 5, 16389
    msg, pad = _words(torch, (E, n), 400), _words(torch, (E, n), 401)
    rk, sk = _words(torch, (E,), 402), _words(torch, (E,), 403)
    padded = 2 * 16384
    F = torch.nn.functional
    ct, tags = ref.otp_xor_mac_rows_ref(F.pad(msg, (0, padded - n)),
                                        F.pad(pad, (0, padded - n)), rk, sk)
    gap_e = _otp_gap(torch, ops.otp_xor_mac_edges(msg, pad, rk, sk),
                     (ct[:, :n], tags))
    gap_s = _otp_gap(torch, ops.otp_xor_mac(msg[3], pad[3], int(rk[3]),
                                            int(sk[3])), (ct[3, :n], tags[3]))
    print(f"otp padded wrappers: edges max_abs_err={gap_e}, "
          f"stream max_abs_err={gap_s}")
    worst["otp_xor_mac_edges"] = max(worst["otp_xor_mac_edges"], gap_e)
    worst["otp_xor_mac"] = max(worst["otp_xor_mac"], gap_s)
    if any(worst.values()):
        raise PhaseError(f"otp_xor kernel disagrees with plain: {worst}")
    return worst, timings


# the seeded body's trees: name -> (rows, leaves as (dtype, row shape) in
# flatten order); "vqc" is the trainer's VQC tree (4 leaves, 62 words),
# "qwen3_smoke" the federated-LLM twin's smoke qwen3-0.6b parameter tree
# (float32, 13 leaves, 1,115,520 words a row), at the twin's 4 satellites
OTP_SEEDED_TREES = {
    "stage": (64, "vqc"),
    "mixed": (5, [("float32", (3, 5)), ("bfloat16", (7,)),
                  ("float16", (2, 3)), ("int32", (4,))]),
    "multiblock": (5, [("float32", (3,)), ("float32", (16389,)),
                       ("bfloat16", (5,)), ("int32", (7,))]),
    "bandwidth": (64, [("float32", (1 << 20,))]),
    "bandwidth_bf16": (64, [("bfloat16", (1 << 21,))]),
    "ingraph": (50, "vqc"),         # the in-graph round's 50 rows
    "twin": (4, "qwen3_smoke"),     # the twin's otp and otp_gather rows
}
# the stream entry: the VQC tree (one edge, 62 words) and 65,543 words
OTP_SEEDED_STREAMS = {
    "edge": "vqc",
    "stream": [("float32", (1 << 16,)), ("bfloat16", (13,))],
}
# seeds 0 and 2^32 - 1 in every seeded check
OTP_EDGE_SEEDS = (0, (1 << 32) - 1)
THREEFRY_OPS = 80              # integer operations of one threefry2x32


def _seeded_like(torch, spec, rows):
    """A tree of the spec's leaf dtypes and shapes with ``rows`` leading
    rows (none when ``rows`` is None); "vqc" and "qwen3_smoke" are the
    trainer's VQC tree and the twin's smoke qwen3-0.6b tree from their
    inits. Its values are unused: the kernel reads only the message words
    and the tree's pad layout."""
    lead = () if rows is None else (rows,)
    if spec in ("vqc", "qwen3_smoke"):
        from repro_torch import prng
        from repro_torch.models import get_config, get_model, smoke_variant
        from repro_torch.nn.pytree import tree_map
        cfg = (get_config("vqc-satqfl") if spec == "vqc"
               else smoke_variant(get_config("qwen3-0.6b")))
        tree = get_model(cfg).init(cfg, prng.PRNGKey(0, device="cuda"))
        return tree_map(lambda v: v.expand(lead + v.shape), tree)
    return {f"l{i}": torch.zeros(lead + shape, dtype=getattr(torch, dt),
                                 device="cuda")
            for i, (dt, shape) in enumerate(spec)}


def _otp_seeded_bound(rows: int, layout_rows) -> dict:
    """Least time of the seeded body over ``rows`` rows of a pad layout:
    msg read and ct written (8 B a word) plus seed, keys and tag (12 B a
    row); one threefry2x32 (~80 integer ops) per leaf key and per element
    (a 16-bit leaf's odd tail costs none more), and the MAC's 5 a word."""
    n = sum(c if w == 32 else (c + 1) // 2 for _, _, c, w in layout_rows)
    threefry = len(layout_rows) + sum(c for _, _, c, _ in layout_rows)
    bytes_ms = (8 * rows * n + 12 * rows) / HBM_BYTES_PER_S * 1e3
    ops_ms = rows * (THREEFRY_OPS * threefry + 5 * n) / INT32_OPS * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "threefry_per_row": threefry,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def phase_otp_seeded(torch, ops, ref):
    """The fused kernel's seeded body (pads generated in the kernel) vs its
    plain version (the pads expanded from the same layout by the port's
    threefry), bit for bit, in both tag modes with seeds 0 and 2^32 - 1,
    at the trainer's stage, the in-graph round's 50 rows of the VQC
    tree, the federated-LLM twin's 4 rows of the smoke qwen3-0.6b tree, a
    mixed-width tree, a multi-block tree, (64,
    2^20) as one f32 leaf and as one bf16 leaf of 2^21 elements, and the
    stream entry at 62 and 65,543 words; times each against its bound, and
    at the stage shape also the path it replaced (the pads built by
    ``tree_pad_u32_rows`` on the card, then the given-pad kernel)."""
    from repro_torch.security.otp import (layout_rows, pad_layout,
                                          tree_pad_u32_rows)
    worst = {"otp_xor_mac_edges_seeded": 0, "otp_xor_mac_seeded": 0}
    timings = {"otp_xor_mac_edges_seeded": {}, "otp_xor_mac_seeded": {}}
    for i, (name, (E, spec)) in enumerate(OTP_SEEDED_TREES.items()):
        like = _seeded_like(torch, spec, E)
        layout = pad_layout(like, lead=1)
        lrows = layout_rows(layout)
        n = sum(c if w == 32 else (c + 1) // 2 for _, _, c, w in lrows)
        msg = _words(torch, (E, n), 500 + 10 * i)
        rk, sk = _words(torch, (E,), 501 + 10 * i), _words(torch, (E,),
                                                           502 + 10 * i)
        seeds = _words(torch, (E,), 503 + 10 * i)
        seeds[:2] = ref.as_storage(torch.tensor(OTP_EDGE_SEEDS,
                                                device="cuda"))
        for tag_input in (False, True):
            got = ops.otp_xor_mac_rows_seeded(msg, seeds, layout, rk, sk,
                                              tag_input)
            want = ref.otp_xor_mac_rows_seeded_ref(msg, seeds, layout, rk,
                                                   sk, tag_input)
            torch.cuda.synchronize()
            gap = _otp_gap(torch, got, want)
            print(f"otp seeded rows check {name} E={E} n={n} "
                  f"leaves={len(lrows)} tag_input={tag_input}: "
                  f"max_abs_err={gap}")
            worst["otp_xor_mac_edges_seeded"] = max(
                worst["otp_xor_mac_edges_seeded"], gap)
        big = E * n > 1 << 24
        call = lambda: ops.otp_xor_mac_rows_seeded(msg, seeds, layout, rk, sk)
        t = {"shape": [E, n], "leaves": len(lrows),
             "ms": _cuda_ms(torch, call, 20 if big else 200),
             "device_ms": _device_ms(torch, call, 20),
             "plain_ms": _cuda_ms(
                 torch, lambda: ref.otp_xor_mac_rows_seeded_ref(
                     msg, seeds, layout, rk, sk), 3 if big else 20),
             **_otp_seeded_bound(E, lrows)}
        if name == "stage":
            # what the trainer ran before: plain-torch pads, given-pad kernel
            seeds64 = seeds.to(torch.int64) & 0xFFFFFFFF
            t["replaced_ms"] = _cuda_ms(torch, lambda: ops.otp_xor_mac_rows(
                msg, ref.as_storage(tree_pad_u32_rows(like, seeds64)), rk, sk),
                20)
        timings["otp_xor_mac_edges_seeded"][name] = t
        print(f"otp seeded rows timing {name}: " + json.dumps(t))
        del msg, like
    for i, (name, spec) in enumerate(OTP_SEEDED_STREAMS.items()):
        layout = pad_layout(_seeded_like(torch, spec, None))
        lrows = layout_rows(layout)
        n = sum(c if w == 32 else (c + 1) // 2 for _, _, c, w in lrows)
        msg = _words(torch, (n,), 600 + i)
        keys = _words(torch, (2,), 610 + i).tolist()
        for seed in OTP_EDGE_SEEDS:
            row = torch.tensor([[seed], keys[:1], keys[1:]],
                               dtype=torch.int64, device="cuda")
            for tag_input in (False, True):
                got = ops.otp_xor_mac_stream_seeded(msg, seed, layout,
                                                    keys[0], keys[1],
                                                    tag_input)
                ct, tag = ref.otp_xor_mac_rows_seeded_ref(
                    msg[None], row[0], layout, row[1], row[2], tag_input)
                torch.cuda.synchronize()
                gap = _otp_gap(torch, got, (ct[0], tag[0]))
                print(f"otp seeded stream check {name} n={n} seed={seed} "
                      f"tag_input={tag_input}: max_abs_err={gap}")
                worst["otp_xor_mac_seeded"] = max(
                    worst["otp_xor_mac_seeded"], gap)
        call = lambda: ops.otp_xor_mac_stream_seeded(msg, OTP_EDGE_SEEDS[1],
                                                     layout, keys[0], keys[1])
        t = {"shape": [n], "leaves": len(lrows),
             "ms": _cuda_ms(torch, call, 200),
             "device_ms": _device_ms(torch, call, 20),
             "plain_ms": _cuda_ms(
                 torch, lambda: ref.otp_xor_mac_rows_seeded_ref(
                     msg[None], row[0], layout, row[1], row[2]), 20),
             **_otp_seeded_bound(1, lrows)}
        timings["otp_xor_mac_seeded"][name] = t
        print(f"otp seeded stream timing {name}: " + json.dumps(t))
    if any(worst.values()):
        raise PhaseError(f"otp_xor seeded kernel disagrees with plain: "
                         f"{worst}")
    return worst, timings


# the fault rates of tests/test_faults.py
FAULTS = dict(link_flap_rate=0.3, crash_rate=0.2, straggler_rate=0.3,
              corrupt_rate=0.3, fault_seed=11)

# name -> the path's config; "batched", "edge_batched" and "qubits" go to
# the trainer and the model config, the rest to SatQFLConfig
TRAINER_PATHS = {
    "qfl": dict(mode="qfl", n_rounds=2),
    "sim": dict(mode="sim", n_rounds=2),
    "qfl_qkd": dict(mode="qfl", security="qkd", n_rounds=3),
    "sim_qkd": dict(mode="sim", security="qkd", n_rounds=3),
    "sim_qkd_fernet": dict(mode="sim", security="qkd_fernet", n_rounds=2),
    "sim_qkd_oracle": dict(mode="sim", security="qkd", n_rounds=3,
                           edge_batched=False),
    "qfl_shift": dict(mode="qfl", grad_method="param_shift", n_rounds=2),
    "sim_shift": dict(mode="sim", grad_method="param_shift", n_rounds=2),
    "qfl_shift_oracle": dict(mode="qfl", grad_method="param_shift",
                             n_rounds=1, batched=False),
    "sim_shift_oracle": dict(mode="sim", grad_method="param_shift",
                             n_rounds=1, batched=False),
    "sim_qkd_shift": dict(mode="sim", security="qkd",
                          grad_method="param_shift", n_rounds=2),
    "sim_teleport": dict(mode="sim", security="teleport", n_rounds=2),
    "sim_nq14": dict(mode="sim", n_rounds=1, qubits=14),
    # ROADMAP item 7: the serial chains of seq, and async's staleness ring
    # over 4 rounds (deferred deliveries arrive at this trace's 30 s step)
    "seq": dict(mode="seq", n_rounds=2),
    "seq_qkd": dict(mode="seq", security="qkd", n_rounds=2),
    "async": dict(mode="async", n_rounds=4),
    "async_qkd": dict(mode="async", security="qkd", n_rounds=4),
    "async_secagg": dict(mode="async", agg_security="secagg", n_rounds=4),
    "async_qkd_secagg": dict(mode="async", security="qkd",
                             agg_security="secagg", n_rounds=4),
    "async_qkd_oracle": dict(mode="async", security="qkd", n_rounds=3,
                             batched=False, edge_batched=False),
    # ROADMAP item 8: the fault plane at tests/test_faults.py's rates —
    # crashed senders leave the stages (crashed mains ride the mains'
    # stage as masked rows), flapped links drop before data moves, and
    # tampered payloads ride the seeded OTP kernel with their real keys
    # and fail the receiver's MAC; async retransmits with backoff
    "sim_qkd_faults": dict(mode="sim", security="qkd", n_rounds=2,
                           **FAULTS),
    "sim_qkd_faults_oracle": dict(mode="sim", security="qkd", n_rounds=2,
                                  edge_batched=False, **FAULTS),
    "seq_qkd_faults": dict(mode="seq", security="qkd", n_rounds=2,
                           **FAULTS),
    "async_qkd_secagg_retry": dict(mode="async", security="qkd",
                                   agg_security="secagg", n_rounds=4,
                                   max_retries=2, **FAULTS),
}


def _counts(kops) -> dict:
    """Every kernel's launch count: ``kops`` holds the ops modules of the
    statevector, OTP, attention and SSD kernels."""
    sv_ops, otp_ops, swa_ops, ssd_ops = kops
    return {"statevec_gate_layer": sv_ops.LAUNCHES,
            "statevec_gate_tiled": sv_ops.TILED_LAUNCHES,
            "statevec_gate_1q": sv_ops.GATE_LAUNCHES,
            "statevec_gate_layer_bwd": sv_ops.LAYER_BWD_LAUNCHES,
            **otp_ops.LAUNCHES,
            "swa_attention": swa_ops.LAUNCHES, "ssd_scan": ssd_ops.LAUNCHES}


def _reset(kops):
    """Sets every kernel's launch count to 0."""
    sv_ops, otp_ops, swa_ops, ssd_ops = kops
    sv_ops.LAUNCHES = sv_ops.TILED_LAUNCHES = sv_ops.GATE_LAUNCHES = 0
    sv_ops.LAYER_BWD_LAUNCHES = 0
    swa_ops.LAUNCHES = ssd_ops.LAUNCHES = 0
    swa_ops.LAUNCHES_BY_WINDOW.clear()
    for k in otp_ops.LAUNCHES:
        otp_ops.LAUNCHES[k] = 0


def _path_kernels(spec: dict, edge_batched: bool, qubits: int) -> set:
    """The kernels a trainer path must launch; it must launch no other."""
    need = {"statevec_gate_layer" if qubits <= 13 else "statevec_gate_tiled"}
    if spec.get("grad_method") == "param_shift":
        need.add("statevec_gate_1q")
    else:
        need.add("statevec_gate_layer_bwd")
    if spec.get("security") in ("qkd", "qkd_fernet"):
        need.add("otp_xor_mac_edges_seeded" if edge_batched
                 else "otp_xor_mac_seeded")
    return need


def _train_calls(tr, r: int) -> int:
    """Local-training calls of round r, from the compiled plan and its
    fault schedule: one per stage of clients on the batched executor (qfl
    1 if any satellite is up; sim and async 1 for the secondaries if any,
    seq one per hop; 1 for the mains, crashed mains riding it as masked
    rows), one per client on the per-client oracle (crashed satellites
    and crashed mains train nothing). Crashed secondaries are out of the
    plan's live groups."""
    fl, groups = tr.fl, tr.plan.live_groups(r)
    if fl.mode == "qfl":
        n = len(tr.plan.live_sats(r))
        return int(n > 0) if tr.batched else n
    if not groups:
        return 0
    n_secs = sum(len(v) for v in groups.values())
    mains = len(groups) if fl.main_trains else 0
    if not tr.batched:
        return n_secs + (sum(not tr._crashed(r, m) for m in groups)
                         if fl.main_trains else 0)
    sec_stages = (max(len(v) for v in groups.values()) if fl.mode == "seq"
                  else int(n_secs > 0))
    return sec_stages + int(mains > 0)


def _exchanged_edges(tr, r: int) -> int:
    """Edges of round r whose payload moves, from the compiled plan: every
    scheduled edge but the QBER-aborted and the flapped ones (a tampered
    payload moves, then fails the receiver's MAC)."""
    es, fs = tr.plan.edges, tr.plan.faults
    n = int(es.ptr[r, -1])
    moved = ~es.abort[r, :n]
    if fs is not None:
        moved &= ~fs.link_flap[r, :n]
    return int(moved.sum())


def _plan_launches(tr, r: int, transfers: int) -> dict:
    """The launches round r must make, derived from the compiled plan.
    Under autodiff every local step runs 1 + L forward layers (past 13
    qubits 1 + len(group_passes) tiled launches each) and L backward
    layers (the encoding layer has no gradient) of 2·len(bwd_passes)
    backward launches each, and evaluation runs 3 forwards of 1 + L
    layers. Under qkd and qkd_fernet the seeded OTP kernel
    runs twice a non-empty exchange stage (sender and receiver) on the
    edge-batched plane, twice an edge whose payload moves on the per-edge
    oracle (``_exchanged_edges``: delivered or tampered, never flapped or
    aborted; the round's ``transfers`` must equal their count); the
    given-pad entries never."""
    from repro_torch.kernels.statevec_gate import ops
    fl, cfg = tr.fl, tr.model_cfg
    nq, L, E = cfg.vqc_qubits, cfg.vqc_layers, fl.local_steps
    want = {}
    if fl.grad_method != "param_shift":
        calls = _train_calls(tr, r)
        layers = (calls * E * (1 + L)
                  + (3 * (1 + L) if r % fl.eval_every == 0 else 0))
        if nq <= 13:
            want["statevec_gate_layer"] = layers
        else:           # the tiled layer: pass 0, then each group pass
            want["statevec_gate_tiled"] = layers * (
                1 + len(ops.group_passes(nq)))
        want["statevec_gate_layer_bwd"] = (calls * E * L * 2
                                           * len(ops.bwd_passes(nq)))
    if fl.security in ("qkd", "qkd_fernet"):
        es = tr.plan.edges
        moved = _exchanged_edges(tr, r)
        if transfers != moved:
            raise PhaseError(f"round {r}: {transfers} transfers, the plan "
                             f"moves {moved} payloads")
        stages = sum(int(es.ptr[r, s + 1] > es.ptr[r, s])
                     for s in range(int(es.n_stages[r])))
        want.update({"otp_xor_mac_edges": 0, "otp_xor_mac": 0,
                     "otp_xor_mac_edges_seeded":
                         2 * stages if tr.edge_batched else 0,
                     "otp_xor_mac_seeded":
                         0 if tr.edge_batched else 2 * moved})
    return want


def _check_round_launches(path, spec, tr, r, launches, transfers):
    """Every count ``_plan_launches`` derives, exactly; and the counts the
    design fixes: #1 52 (qfl) and 92 (sim) a round at 10 local steps, the
    layer backward qfl 60 and sim 120 (14 qubits 360), the seeded OTP
    kernel qfl 2 and sim 4 a round edge-batched; under the shift rule 96
    launches of #3 (4·nq·L) for every 13 of #1 (1 + L + L²) in training,
    beside the 12 of evaluation."""
    for key, want in _plan_launches(tr, r, transfers).items():
        if launches[key] != want:
            raise PhaseError(f"{path} round {r}: {launches[key]} launches of "
                             f"{key}, the plan implies {want}")
    n1, n3 = launches["statevec_gate_layer"], launches["statevec_gate_1q"]
    fixed = {"qfl": (52, 60), "sim": (92, 120)}
    if path in fixed and (n1, launches["statevec_gate_layer_bwd"]) \
            != fixed[path]:
        raise PhaseError(f"{path} round {r}: {n1} gate-layer and "
                         f"{launches['statevec_gate_layer_bwd']} backward "
                         f"launches, expected {fixed[path]}")
    if (path in ("qfl_qkd", "sim_qkd")
            and launches["otp_xor_mac_edges_seeded"]
            != {"qfl_qkd": 2, "sim_qkd": 4}[path]):
        raise PhaseError(f"{path} round {r}: "
                         f"{launches['otp_xor_mac_edges_seeded']} seeded "
                         f"OTP stage launches")
    if (spec.get("grad_method") == "param_shift" and spec.get("qubits", 8) == 8
            and (n1 - 12) * 96 != n3 * 13):
        raise PhaseError(f"{path} round {r}: {n3} single-gate launches for "
                         f"{n1} gate-layer launches, not 96 per 13")


def phase_trainer(torch, kops, trace, sats, server):
    """Every trainer path of the port at the paper's scenario (and one at
    14 qubits); counts each path's launches of each kernel, set to 0 just
    before the path and read just after: each path must launch each kernel
    it runs and no other. Holds the edge-batched secure plane against its
    per-edge oracle, bit for bit."""
    from repro_torch.core import SatQFLConfig, SatQFLTrainer
    from repro_torch.models import get_config, get_model
    report, launches, finals = {}, {}, {}
    for path, spec in TRAINER_PATHS.items():
        kw = dict(spec)
        batched = kw.pop("batched", True)
        edge_batched = kw.pop("edge_batched", True)
        qubits = kw.pop("qubits", 8)
        cfg = get_config("vqc-satqfl").replace(vqc_qubits=qubits)
        fl = SatQFLConfig(local_steps=10, batch_size=32, **kw)
        t0 = time.perf_counter()
        tr = SatQFLTrainer(cfg, get_model(cfg), fl, trace, sats, server,
                           batched=batched, edge_batched=edge_batched,
                           device="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        macs = _spy_macs(tr) if fl.corrupt_rate > 0 else None
        rounds = []
        _reset(kops)
        for r in range(fl.n_rounds):
            before = _counts(kops)
            sent = tr.log.n_transfers
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = tr.run_round(r)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            es = tr.plan.edges
            rounds.append({
                "round": r, "seconds": dt,
                "transfers": tr.log.n_transfers - sent,
                # async: updates arriving (window opened) and merged (fresh
                # in a primary main's buffer) this round
                "arrivals": (int(es.ptr[r, 1] - es.ptr[r, 0])
                             if fl.mode == "async" else None),
                "merged": (int(tr.plan.stale.merge_count[r].sum())
                           if fl.mode == "async" else None),
                "launches": {k: v - before[k] for k, v in
                             _counts(kops).items()},
                "val_loss": m.server_val_loss, "val_acc": m.server_val_acc,
                "participants": m.participants, "comm_s": m.comm_s,
                "security_s": m.security_s,
                "teleport_fidelity": m.teleport_fidelity,
                "faults": (dataclasses.asdict(tr.fault_reports[-1])
                           if tr.plan.faults is not None else None)})
            print(f"trainer {path} " + json.dumps(rounds[-1]))
            if not (math.isfinite(m.server_val_loss)
                    and m.server_val_loss < 10.0):
                raise PhaseError(f"{path} round {r}: val loss "
                                 f"{m.server_val_loss}")
            if fl.security == "teleport" and not m.teleport_fidelity > 0.999:
                raise PhaseError(f"{path} round {r}: teleport fidelity "
                                 f"{m.teleport_fidelity}")
            _check_round_launches(path, spec, tr, r, rounds[-1]["launches"],
                                  rounds[-1]["transfers"])
        launches[path] = _counts(kops)
        need = _path_kernels(spec, edge_batched, qubits)
        for k, n in launches[path].items():
            if (n > 0) != (k in need):
                raise PhaseError(f"the {path} trainer launched {k} {n} "
                                 f"times; it runs {sorted(need)}")
        report[path] = {"setup_s": setup_s, "rounds": rounds}
        finals[path] = tr
        if macs is not None:
            report[path]["mac_check"] = _check_tamper_macs(path, tr, macs)
        if fl.mode in ("seq", "async") or tr.plan.faults is not None:
            seconds = [round(x["seconds"], 4) for x in rounds]
            rs = range(fl.n_rounds)
            tail = (f"rounds with deliveries "
                    f"{[x['round'] for x in rounds if x['merged']]}"
                    if fl.mode == "async" else
                    f"hops {[int(tr.plan.edges.n_stages[r]) - 1 for r in rs]}"
                    if fl.mode == "seq" else
                    f"participants {[x['participants'] for x in rounds]}")
            print(f"trainer {path}: round seconds {seconds}, {tail}")
    a, b = finals["sim_qkd"], finals["sim_qkd_oracle"]
    for k in a.global_params:
        if not torch.equal(a.global_params[k].view(torch.int32),
                           b.global_params[k].view(torch.int32)):
            raise PhaseError(f"edge-batched and per-edge params differ: {k}")
    for ma, mb in zip(a.history, b.history):
        if ((ma.comm_s, ma.security_s, ma.participants)
                != (mb.comm_s, mb.security_s, mb.participants)):
            raise PhaseError(f"edge-batched and per-edge accounting differ "
                             f"at round {ma.round}")
    print("trainer: edge-batched == per-edge oracle, bit-exact params and "
          "equal accounting over 3 sim qkd rounds")
    a, b = finals["sim_qkd_faults"], finals["sim_qkd_faults_oracle"]
    for k in a.global_params:
        if not torch.equal(a.global_params[k].view(torch.int32),
                           b.global_params[k].view(torch.int32)):
            raise PhaseError(f"edge-batched and per-edge params differ under "
                             f"faults: {k}")
    if (a.fault_reports != b.fault_reports
            or a.log.round_details != b.log.round_details
            or [h.participants for h in a.history]
            != [h.participants for h in b.history]):
        raise PhaseError("edge-batched and per-edge fault reports or "
                         "accounting differ under faults")
    print(f"trainer: under faults, edge-batched == per-edge oracle, "
          f"bit-exact params, equal accounting and fault reports "
          f"{json.dumps([dataclasses.asdict(f) for f in a.fault_reports])}")
    retry = finals["async_qkd_secagg_retry"]
    retries = [f.retries for f in retry.fault_reports]
    if not any(retries):
        raise PhaseError(f"async_qkd_secagg_retry: no round retransmitted "
                         f"({retries})")
    report["fault_resume"] = phase_fault_resume(torch, trace, sats, server,
                                                retry)
    checked = {p: _check_ring_vs_list(torch, finals[p])
               for p in ("async_qkd", "async_qkd_secagg")}
    print(f"trainer: the ring's last-round merges == the per-main-list "
          f"oracle's merges of the same entries, bit for bit: "
          f"{json.dumps(checked)}")
    return launches, report


def _spy_macs(tr) -> list:
    """Record (tamper word, pad seed, MAC ok) of every row the trainer's
    secure stages and per-edge exchanges send through the seeded OTP
    kernel (the receiver's MAC of what it received against the sender's
    tag). Reads the results the trainer computes; launches nothing."""
    seen = []
    stage, edge = tr._secure_stage, tr._secure_edge

    def spy_stage(stacked, seeds, mac_r, mac_s, tamper):
        out, ok = stage(stacked, seeds, mac_r, mac_s, tamper)
        seen.extend(zip(tamper.tolist(), seeds.tolist(), ok.cpu().tolist()))
        return out, ok

    def spy_edge(params, seed, mac_r, mac_s, tamper=0):
        out, ok = edge(params, seed, mac_r, mac_s, tamper)
        seen.append((tamper, seed, ok))
        return out, ok

    tr._secure_stage, tr._secure_edge = spy_stage, spy_edge
    return seen


def _check_tamper_macs(path, tr, seen) -> dict:
    """Every row with a non-zero tamper word failed the MAC on the card;
    every other row with a pad seed (a delivered payload) passed; and the
    tampered rows are the plan's detected corruptions."""
    tampered = [ok for t, _, ok in seen if t]
    clean = [ok for t, sd, ok in seen if not t and sd]
    out = {"tampered_rows": len(tampered),
           "tampered_rejected": tampered.count(False),
           "delivered_rows": len(clean), "delivered_passed": clean.count(True)}
    print(f"trainer {path}: MAC on the card " + json.dumps(out))
    want = sum(f.corruptions for f in tr.fault_reports)
    if not tampered or any(tampered) or not all(clean) or not clean:
        raise PhaseError(f"{path}: the seeded kernel's MAC passed a tampered "
                         f"row or failed a delivered one: {out}")
    if len(tampered) != want:
        raise PhaseError(f"{path}: {len(tampered)} tampered rows reached the "
                         f"kernel, the plan detects {want} corruptions")
    return out


def phase_fault_resume(torch, trace, sats, server, reference) -> dict:
    """Kill/resume on the card: the trainer of ``reference``'s config runs
    2 rounds, writes a round checkpoint, and a fresh trainer restores it
    and runs the rest. Its params (int32 views), history, fault reports
    and comm log must equal ``reference``'s uninterrupted run."""
    import shutil
    import tempfile
    from repro_torch.core import SatQFLTrainer
    fl = reference.fl
    make = lambda: SatQFLTrainer(reference.model_cfg, reference.api, fl,
                                 trace, sats, server, device="cuda")
    base = ROOT / "build"
    base.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=base)
    try:
        t0 = time.perf_counter()
        b = make()
        for r in range(2):
            b.run_round(r)
        path = b.save_round_checkpoint(tmp)
        size = Path(path).stat().st_size
        c = make()
        if c.restore_round_checkpoint(tmp) != 2:
            raise PhaseError("resume: the checkpoint is not at round 2")
        for r in range(2, fl.n_rounds):
            c.run_round(r)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for k in reference.global_params:
        if not torch.equal(reference.global_params[k].view(torch.int32),
                           c.global_params[k].view(torch.int32)):
            raise PhaseError(f"resumed params differ from the uninterrupted "
                             f"run's: {k}")
    hist = lambda t: [json.dumps(dataclasses.asdict(h)) for h in t.history]
    if (hist(reference) != hist(c)
            or reference.fault_reports != c.fault_reports
            or dataclasses.asdict(reference.log) != dataclasses.asdict(c.log)):
        raise PhaseError("the resumed run's history, fault reports or comm "
                         "log differ from the uninterrupted run's")
    out = {"checkpoint_bytes": size, "seconds": seconds}
    print(f"resume: async qkd + secagg with faults and retries, killed "
          f"after round 2 and resumed on the card: bit-identical to the "
          f"uninterrupted {fl.n_rounds} rounds " + json.dumps(out))
    return out


def phase_fault_raise(torch, trace, sats, server):
    """``on_fault='raise'`` at sim_qkd_faults' rates: the first faulted
    round raises the same FaultError subclass with the same sites on the
    card as on the CPU."""
    from repro_torch.core import SatQFLConfig, SatQFLTrainer
    from repro_torch.models import get_config, get_model
    from repro_torch.security.errors import FaultError
    cfg = get_config("vqc-satqfl")
    fl = SatQFLConfig(**TRAINER_PATHS["sim_qkd_faults"], local_steps=10,
                      batch_size=32, on_fault="raise")
    got = {}
    for dev in ("cuda", "cpu"):
        tr = SatQFLTrainer(cfg, get_model(cfg), fl, trace, sats, server,
                           device=dev)
        try:
            tr.run()
        except FaultError as err:
            got[dev] = (type(err).__name__, err.sites, len(tr.history))
        else:
            raise PhaseError(f"on_fault='raise' raised nothing on {dev}")
    if got["cuda"] != got["cpu"]:
        raise PhaseError(f"on_fault='raise' differs: {got}")
    name, sites, done = got["cuda"]
    print(f"raise: {name} at round {done} on the card and the CPU, "
          f"{len(sites)} sites {sites[:4]}")
    return got["cuda"]


def _ring_entries(tr, r: int, g: int) -> list:
    """The entries main ``g``'s merge took from the ring at round r, as the
    per-main-list oracle holds them: [(payload, sat, born)] in (sat, born)
    order."""
    import numpy as np
    st = tr.plan.stale
    out = []
    for s, slot in np.argwhere(st.merge_born[r, g] >= 0):
        p = ({"y": tr._ring_y[s, slot].clone()}
             if tr.fl.agg_security == "secagg" else
             {k: v[s, slot].clone() for k, v in tr._ring.items()})
        out.append((p, int(s), int(st.merge_born[r, g, s, slot])))
    return sorted(out, key=lambda e: (e[1], e[2]))


def _check_ring_vs_list(torch, tr) -> int:
    """The ring's merge at the run's last round (nothing has written the
    ring since) against the oracle's merge of the same entries on the card:
    ``_list_merge`` (the one float reduction both executors call) or
    ``_secagg_merge_oracle`` (masks recovered from the key registry). Bit
    for bit at every main with entries; returns how many were held."""
    r = tr.plan.n_rounds - 1
    ring = tr._ring_merge(r)
    n = 0
    for g, m in enumerate(tr.plan.live_groups(r)):
        fresh = _ring_entries(tr, r, g)
        if not fresh:
            continue
        got = (tr._secagg_merge_oracle(m, fresh)
               if tr.fl.agg_security == "secagg" else tr._list_merge(g, fresh))
        for k in got:
            if not torch.equal(got[k].view(torch.int32),
                               ring[k][g].view(torch.int32)):
                raise PhaseError(f"ring and list merges differ at round {r}, "
                                 f"main {m}, leaf {k}")
        n += 1
    if n == 0:
        raise PhaseError(f"no merge at the last round of {tr.fl}")
    return n


@contextlib.contextmanager
def _plain_gates(vqc, ref):
    """Points the VQC's gate ops at their plain versions for the
    kernel-vs-plain cross-check, and back."""
    saved = vqc.apply_gate, vqc.apply_gate_layer
    vqc.apply_gate = ref.apply_gate_planes_ref
    vqc.apply_gate_layer = ref.apply_layer_planes_ref
    try:
        yield
    finally:
        vqc.apply_gate, vqc.apply_gate_layer = saved


WIDE_QUBITS, WIDE_BATCH = 20, 4


def phase_wide_vqc(torch, kops, ref):
    """The VQC at 20 qubits through its entry points: a forward, an
    autodiff gradient and a ``parameter_shift_grad`` of one batch of 4,
    the launch counts set to 0 just before and read just after (the
    tiled layer, 2 passes a layer, and the single gate at q >= 13); then
    the same with the plain versions on the card: logits and both grads
    ≤ 1e-5 of them, shift vs autodiff ≤ 2e-5 (the JAX package's
    contract)."""
    from repro_torch import prng
    from repro_torch.core import SatQFLConfig
    from repro_torch.core.gradients import make_grad_fn
    from repro_torch.models import get_config, get_model
    from repro_torch.kernels.statevec_gate import ops as sv_ops
    from repro_torch.quantum import vqc
    cfg = get_config("vqc-satqfl").replace(vqc_qubits=WIDE_QUBITS)
    api = get_model(cfg)
    params = api.init(cfg, prng.PRNGKey(0, device="cuda"))
    g = torch.Generator("cuda").manual_seed(20)
    batch = {"features": math.pi * torch.rand(
        WIDE_BATCH, cfg.n_features, device="cuda", generator=g),
        "labels": torch.randint(0, cfg.n_classes, (WIDE_BATCH,),
                                device="cuda", generator=g)}
    autodiff = make_grad_fn(api, cfg, SatQFLConfig())

    def run():
        t = {}
        for name, fn in (
                ("forward", lambda: vqc.vqc_logits(cfg, params,
                                                   batch["features"])),
                ("autodiff", lambda: autodiff(params, batch)),
                ("shift", lambda: vqc.parameter_shift_grad(
                    cfg, params, batch, with_loss=True))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            t[name] = (out, time.perf_counter() - t0)
        return t

    run()                                                  # warm
    _reset(kops)
    got = run()
    launches = _counts(kops)
    with _plain_gates(vqc, ref):
        want = run()
    (lt, gt), (lp, gp) = got["shift"][0], want["shift"][0]
    _, ga = got["autodiff"][0]
    errs = {"logits": (got["forward"][0] - want["forward"][0]).abs().max(),
            "autodiff": max((got["autodiff"][0][1][k]
                             - want["autodiff"][0][1][k]).abs().max()
                            for k in ga),
            "shift": max((gt[k] - gp[k]).abs().max() for k in gt),
            "shift_loss": (lt - lp).abs().max(),
            "shift_vs_autodiff": max((gt[k] - ga[k]).abs().max() for k in gt)}
    errs = {k: float(v) for k, v in errs.items()}
    report = {"qubits": WIDE_QUBITS, "batch": WIDE_BATCH, "errors": errs,
              "seconds": {k: v[1] for k, v in got.items()},
              "plain_seconds": {k: v[1] for k, v in want.items()},
              "launches": launches}
    print("wide vqc: " + json.dumps(report))
    want_n = {"statevec_gate_tiled": 2 * (1 + cfg.vqc_layers) * 2
              + 2 * (1 + cfg.vqc_layers + cfg.vqc_layers ** 2),
              "statevec_gate_1q": 4 * WIDE_QUBITS * cfg.vqc_layers,
              "statevec_gate_layer_bwd": cfg.vqc_layers * 2 * len(
                  sv_ops.bwd_passes(WIDE_QUBITS))}
    if {k: launches[k] for k in want_n} != want_n or any(
            n for k, n in launches.items() if k not in want_n):
        raise PhaseError(f"wide vqc launches {launches}, expected {want_n}")
    limits = {"logits": 1e-5, "autodiff": 1e-5, "shift": 1e-5,
              "shift_loss": 1e-5, "shift_vs_autodiff": 2e-5}
    bad = {k: v for k, v in errs.items() if not v <= limits[k]}
    if bad:
        raise PhaseError(f"wide vqc disagrees: {bad} (limits {limits})")
    del params, got, want
    torch.cuda.empty_cache()
    return {"vqc_nq20": launches}, report


# clients K of one local step (batch 32) on the batched executor and on the
# per-client oracle
SHIFT_STEP_CLIENTS = {"batched": 64, "oracle": 1}


def phase_shift_step(torch, kops, ref):
    """One local step of the parameter-shift rule at the trainer's full
    width (8 qubits, 3 layers, batch 32) for K=64 clients (the batched
    executor) and K=1 (the per-client oracle), through
    ``parameter_shift_grad``, which the trainer's shift branch calls. Its
    launches are counted from 0 (13 of #1, the suffix at (K, 512, 2^8), and
    96 of #3 at (K, 32, 2^8); no other kernel); the loss and grads are held
    against the same step with the plain versions on the card, on the same
    inputs, ≤ 1e-5 (the gradients' limit)."""
    from repro_torch import prng
    from repro_torch.models import get_config, get_model
    from repro_torch.quantum import vqc
    cfg = get_config("vqc-satqfl")
    api = get_model(cfg)
    nq, L, B = cfg.vqc_qubits, cfg.vqc_layers, 32
    want_n = {"statevec_gate_layer": 1 + L + L * L,
              "statevec_gate_1q": 4 * nq * L}
    report = {}
    for name, K in SHIFT_STEP_CLIENTS.items():
        g = torch.Generator("cuda").manual_seed(K)
        base = api.init(cfg, prng.PRNGKey(K, device="cuda"))
        # distinct clients: the shared init moved by a client's own noise
        params = {k: v.expand(K, *v.shape) + 0.3 * torch.randn(
            K, *v.shape, device="cuda", generator=g)
            for k, v in base.items()}
        batch = {"features": math.pi * torch.rand(
            K, B, cfg.n_features, device="cuda", generator=g),
            "labels": torch.randint(0, cfg.n_classes, (K, B),
                                    device="cuda", generator=g)}
        step = lambda: vqc.parameter_shift_grad(cfg, params, batch,
                                                with_loss=True)
        step()                                              # warm
        torch.cuda.synchronize()
        _reset(kops)
        t0 = time.perf_counter()
        got_loss, got = step()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _counts(kops)
        with _plain_gates(vqc, ref):
            step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want_loss, want = step()
            torch.cuda.synchronize()
            plain_seconds = time.perf_counter() - t0
        errs = {k: float((got[k] - want[k]).abs().max()) for k in got}
        errs["loss"] = float((got_loss - want_loss).abs().max())
        finite = all(bool(torch.isfinite(v).all()) for v in got.values())
        report[name] = {"clients": K, "batch": B, "errors": errs,
                        "seconds": seconds, "plain_seconds": plain_seconds,
                        "launches": launches}
        print(f"shift step {name}: " + json.dumps(report[name]))
        if {k: launches[k] for k in want_n} != want_n or any(
                n for k, n in launches.items() if k not in want_n):
            raise PhaseError(f"shift step {name}: launches {launches}, "
                             f"expected {want_n}")
        bad = {k: v for k, v in errs.items() if not v <= GRAD_TOL}
        if bad or not finite:
            raise PhaseError(f"shift step {name} disagrees with plain: "
                             f"{bad or 'non-finite grads'} (limit "
                             f"{GRAD_TOL})")
    return report


def phase_cross_device(torch, trace, sats, server):
    """The same runs on the CPU (plain path) and on the card: sim without
    security (1 round), under the parameter-shift rule (1 round of 2 local
    steps of batch 8), under qkd (2 rounds), async under qkd + secagg (4
    rounds) and sim under qkd with faults (2 rounds) within 1e-4 and with
    equal accounting and fault reports; one drop-mode round with forced
    eavesdroppers on every edge of satellites 0-4, whose aborted edges
    must agree."""
    from repro_torch.core import SatQFLConfig, SatQFLTrainer
    from repro_torch.models import get_config, get_model
    from repro_torch.security import canonical_edge
    cfg = get_config("vqc-satqfl")
    eav = frozenset(canonical_edge((a, b)) for a in range(5)
                    for b in list(range(50)) + ["gs"] if a != b)
    cases = {"sim": (dict(security="none", n_rounds=1), frozenset()),
             # the CPU's plain shift rule takes ~16 s a local step at
             # full width (321 s for this round at 10 steps of batch 32):
             # the cross-check runs 2 steps of batch 8
             "sim_shift": (dict(grad_method="param_shift", n_rounds=1,
                                local_steps=2, batch_size=8), frozenset()),
             "sim_qkd": (dict(security="qkd", n_rounds=2), frozenset()),
             "sim_qkd_drop": (dict(security="qkd", n_rounds=1,
                                   on_qber_abort="drop"), eav),
             # the staleness ring with secagg, deferred deliveries included
             "async_qkd_secagg": (dict(mode="async", security="qkd",
                                       agg_security="secagg", n_rounds=4),
                                  frozenset()),
             # the fault plane: equal fault reports on both devices
             "sim_qkd_faults": (dict(TRAINER_PATHS["sim_qkd_faults"]),
                                frozenset())}
    worst = {}
    for name, (kw, eavs) in cases.items():
        fl = SatQFLConfig(**{"mode": "sim", "local_steps": 10,
                             "batch_size": 32, **kw})
        runs = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            tr = SatQFLTrainer(cfg, get_model(cfg), fl, trace, sats, server,
                               eavesdrop_edges=eavs, device=dev)
            tr.run()
            runs[dev] = tr
            print(f"cross-device {name} {dev}: "
                  f"{time.perf_counter() - t0:.1f} s")
        a, b = runs["cuda"], runs["cpu"]
        gap = 0.0
        for ma, mb in zip(a.history, b.history):
            for f in ("server_val_loss", "server_val_acc", "server_test_acc",
                      "dev_train_acc", "dev_val_loss"):
                gap = max(gap, abs(getattr(ma, f) - getattr(mb, f)))
            if ((ma.comm_s, ma.security_s, ma.participants)
                    != (mb.comm_s, mb.security_s, mb.participants)):
                raise PhaseError(f"{name}: accounting differs at round "
                                 f"{ma.round}")
        for f in ("bytes_moved", "n_transfers", "round_details"):
            if getattr(a.log, f) != getattr(b.log, f):
                raise PhaseError(f"{name}: CommLog.{f} differs between "
                                 f"cuda and cpu")
        if a.aborted_edges != b.aborted_edges:
            raise PhaseError(f"{name}: aborted edges differ between cuda "
                             f"and cpu")
        if a.fault_reports != b.fault_reports:
            raise PhaseError(f"{name}: fault reports differ between cuda "
                             f"and cpu")
        if eavs and not a.aborted_edges:
            raise PhaseError(f"{name}: no edge aborted under eavesdropping")
        if fl.agg_security == "secagg":
            # the secagg merge of the same ring on both devices: integer
            # masks and recovery, then one float32 division a word
            r = fl.n_rounds - 1
            b._ring_y = a._ring_y.cpu()
            b.global_params = {k: v.cpu() for k, v in a.global_params.items()}
            ma, mb = a._ring_merge(r), b._ring_merge(r)
            for k in ma:
                if not torch.equal(ma[k].cpu().view(torch.int32),
                                   mb[k].view(torch.int32)):
                    raise PhaseError(f"{name}: the secagg merge of one ring "
                                     f"differs between cuda and cpu ({k})")
            print(f"cross-device {name}: round {r}'s secagg merge of the "
                  f"card's ring bit-equal on cuda and cpu; delivered "
                  f"{[m.participants for m in a.history]} on both")
        print(f"cross-device {name}: max metric gap {gap:.3e}, "
              f"{len(a.aborted_edges)} aborted edges on both")
        if gap > 1e-4:
            raise PhaseError(f"{name}: cuda and cpu metrics differ by {gap}")
        worst[name] = gap
    return worst


# name -> the profiled path's config (as in TRAINER_PATHS)
PROFILED_PATHS = {
    "sim_qkd": dict(mode="sim", security="qkd"),
    "sim_shift": dict(mode="sim", grad_method="param_shift"),
    "sim_nq14": dict(mode="sim", qubits=14),
    "async_qkd": dict(mode="async", security="qkd"),
    "async_secagg": dict(mode="async", agg_security="secagg"),
}


def phase_profile(torch, trace, sats, server):
    """Where a round's time goes: torch.profiler over one warm round of
    each of ``PROFILED_PATHS`` (the secure edge-batched plane, the
    parameter-shift rule, a 14-qubit register).

    Measurement only (the profiler's own overhead inflates the round); a
    profiler that records no device time prints "not measured".
    """
    from repro_torch.core import SatQFLConfig, SatQFLTrainer
    from repro_torch.models import get_config, get_model
    for name, spec in PROFILED_PATHS.items():
        kw = dict(spec)
        cfg = get_config("vqc-satqfl").replace(vqc_qubits=kw.pop("qubits",
                                                                 8))
        fl = SatQFLConfig(n_rounds=2, local_steps=10, batch_size=32, **kw)
        tr = SatQFLTrainer(cfg, get_model(cfg), fl, trace, sats, server,
                           device="cuda")
        tr.run_round(0)
        prof = _device_profile(torch, lambda: tr.run_round(1))
        print(f"profile {name}: " + (json.dumps(prof) if prof else
                                     "not measured (the profiler recorded "
                                     "no device time)"))
        if prof:
            print(f"profile {name}: {prof['device_ops']} device ops in one "
                  f"warm round, {prof['device_busy_share']:.3f} busy")
        if fl.agg_security == "secagg":
            _profile_secagg_pads(torch, tr)


def _profile_secagg_pads(torch, tr):
    """Device ops of the secagg pad calls at round 1's shapes: the send's
    quantize + mask of every row (one pad call over (rows, partners)) and
    the merge's corrections (one pad call over (mains, corrections))."""
    import numpy as np
    from repro_torch.security.otp import secagg_mask_rows, sum_signed_pads
    st, r, K, N = tr.plan.stale, 1, tr._frame, tr.n_sats
    rows = tr._broadcast_global(K)
    seeds, signs = (np.zeros((K,) + st.pair_seed.shape[2:], np.int64)
                    for _ in range(2))
    wq = np.ones((K,), np.int64)
    seeds[:N], signs[:N], wq[:N] = (st.pair_seed[r], st.pair_sign[r],
                                    st.wq)
    seeds, signs, wq = (torch.from_numpy(a).cuda()
                        for a in (seeds, signs, wq))
    cs, cg = (np.zeros((K,) + st.corr_seed.shape[2:], np.int64)
              for _ in range(2))
    cs[:st.n_mains_max], cg[:st.n_mains_max] = (st.corr_seed[r],
                                                st.corr_sign[r])
    cs, cg = torch.from_numpy(cs).cuda(), torch.from_numpy(cg).cuda()
    for label, fn in (
            (f"send {tuple(seeds.shape)} x {tr._q_words} words",
             lambda: secagg_mask_rows(rows, wq, seeds, signs)),
            (f"merge corrections {tuple(cs.shape)} x {tr._q_words} words",
             lambda: sum_signed_pads(cs, cg, tr._q_words))):
        fn()
        prof = _device_profile(torch, fn)
        print(f"profile secagg pads, {label}: " + (
            f"{prof['device_ops']} device ops, "
            f"{prof['device_busy_s'] * 1e3:.3f} ms device, "
            f"{prof['wall_s_under_profiler'] * 1e3:.3f} ms wall"
            if prof else "not measured"))


# --------------------------------------------------------------------------
# The in-graph round (ROADMAP item 10): core.dist.make_fl_round over the
# stacked satellite axis, and launch.train --fl
# --------------------------------------------------------------------------

SEQ_HOPS = 4
# name -> the path: mode, security, rounds, and optionally the gradient
# rule and the fault plane (plan.fault_mask at tests/test_faults.py's rates)
DIST_PATHS = {
    "dist_sim": dict(mode="sim", security="none", rounds=2),
    "dist_sim_otp": dict(mode="sim", security="otp", rounds=2),
    "dist_sim_otp_gather": dict(mode="sim", security="otp_gather", rounds=2),
    "dist_sim_secagg": dict(mode="sim", security="secagg", rounds=2),
    "dist_qfl_otp": dict(mode="qfl", security="otp", rounds=2),
    "dist_seq": dict(mode="seq", security="none", rounds=2),
    "dist_seq_otp": dict(mode="seq", security="otp", rounds=2),
    # 4 rounds, so that buffered updates fold in
    "dist_async": dict(mode="async", security="none", rounds=4),
    "dist_async_otp": dict(mode="async", security="otp", rounds=4),
    "dist_sim_shift": dict(mode="sim", security="none", rounds=1,
                           grad_method="param_shift"),
    "dist_sim_otp_faults": dict(mode="sim", security="otp", rounds=2,
                                faults=True),
    "dist_async_otp_faults": dict(mode="async", security="otp", rounds=2,
                                  faults=True),
}


def _dist_round_launches(spec: dict, nq: int, L: int, E: int) -> dict:
    """The launches one in-graph round must make, and no other kernel:
    under autodiff (1 + L) layers of #1 and L backward layers of
    2·len(bwd_passes) launches a local step, under the shift rule 1 + L +
    L² layers of #1 and 4·nq·L single gates; the seeded OTP rows entry
    twice an otp exchange and twice a gather; H = seq_hops exchanges (and
    trainings) in seq, else 1."""
    from repro_torch.kernels.statevec_gate import ops
    H = SEQ_HOPS if spec["mode"] == "seq" else 1
    want = {}
    if spec.get("grad_method") == "param_shift":
        want["statevec_gate_layer"] = E * (1 + L + L * L)
        want["statevec_gate_1q"] = E * 4 * nq * L
    else:
        want["statevec_gate_layer"] = E * (1 + L) * H
        want["statevec_gate_layer_bwd"] = (E * L * 2
                                           * len(ops.bwd_passes(nq)) * H)
    want["otp_xor_mac_edges_seeded"] = {"otp": 2 * H, "otp_gather": 2}.get(
        spec["security"], 0)
    return want


def _dist_batches(torch, np, sats, rng, steps: int, B: int, dev) -> dict:
    """One round's stacked batches as the JAX launcher draws them: numpy
    ``rng.integers`` indices into each satellite's rows."""
    per = min(len(s["features"]) for s in sats)
    idx = torch.from_numpy(rng.integers(0, per, (len(sats), steps, B))).to(
        dev)
    return {k: torch.stack([s[k].to(dev)[i] for s, i in zip(sats, idx)])
            for k in ("features", "labels")}


def _dist_run(torch, np, name, spec, trace, sats, dev, on_round=None):
    """Run one in-graph path on ``dev`` from the paper's scenario: (final
    state, per-round records, (cfg, api, fl, round_fn, plan)).
    ``on_round(r)`` is called just before round r and ``on_round(r, record,
    state, state before the round, fault mask)`` just after it."""
    from repro_torch import prng
    from repro_torch.core import SatQFLConfig, compile_round_plan
    from repro_torch.core.dist import fl_init_state, make_fl_round
    from repro_torch.models import get_config, get_model
    from repro_torch.nn.optim import momentum, sgd
    cfg = get_config("vqc-satqfl")
    api = get_model(cfg)
    n = len(sats)
    fl = SatQFLConfig(mode=spec["mode"], n_rounds=spec["rounds"],
                      local_steps=10, batch_size=32,
                      grad_method=spec.get("grad_method", "autodiff"),
                      security="qkd", **(FAULTS if spec.get("faults")
                                         else {}))
    # the fault paths take momentum, so that frozen slots are visible
    opt = (momentum if spec.get("faults") else sgd)(fl.lr)
    plan = compile_round_plan(trace, fl,
                              sample_counts=[len(s["labels"]) for s in sats],
                              device=dev)
    state = fl_init_state(cfg, api, opt, n, prng.PRNGKey(0, dev))
    rf = make_fl_round(cfg, api, fl, opt, n, security=spec["security"],
                       seq_hops=SEQ_HOPS)
    steps = fl.local_steps * (SEQ_HOPS if fl.mode == "seq" else 1)
    rng = np.random.default_rng(0)
    records = []
    for r in range(fl.n_rounds):
        batches = _dist_batches(torch, np, sats, rng, steps, fl.batch_size,
                                dev)
        mask, seeds, weights = plan.dist_inputs(r, dev)
        fault = plan.fault_mask(r, dev) if spec.get("faults") else None
        if on_round is not None:
            on_round(r)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        prev = state
        state, m = rf(state, batches, mask, seeds, weights, fault)
        loss = float(m["loss"])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        rec = {"round": r, "seconds": time.perf_counter() - t0,
               "loss": loss, "participants": int(mask.sum()),
               "crashed": (None if fault is None
                           else int((fault == 0).sum()))}
        if "mac_ok" in m:
            rec["mac_ok"] = bool(m["mac_ok"])
        records.append(rec)
        if on_round is not None:
            on_round(r, rec, state, prev, fault)
    return state, records, (cfg, api, fl, rf, plan)


def _rows_equal_row0(torch, params) -> bool:
    return all(torch.equal(x, x[:1].expand(x.shape))
               for x in params.values())


def _leaf_gap(a, b) -> float:
    return max((x.float().cpu() - y.float().cpu()).abs().max().item()
               for x, y in zip(a.values(), b.values()))


def phase_in_graph(torch, kops, trace, sats):
    """The in-graph engine at full width (``DIST_PATHS``): the paper's
    50-satellite scenario of phase 5, the 8-qubit 3-layer VQC, 10 local
    steps of batch 32, ``sgd(fl.lr)`` (momentum on the fault paths), the
    plan compiled with seeds, batches drawn as the JAX launcher draws
    them. Every launch count is set to 0 just before each round and read
    just after: each round must launch exactly ``_dist_round_launches``
    and no other kernel. Then the checks of the engine: finite losses
    below 10, synchronized rows, otp and otp_gather bit-equal to the
    unsecured round, ``mac_ok``, otp_gather's two launches bit-equal to
    the plain version on the round's seeds, a flipped ciphertext word
    caught by its row's MAC and no other (plain verify and the round's
    own check), secagg within 1e-5 of plain, the CPU within 1e-4 of the
    card's runs of sim and async otp, frozen slots of crashed rows;
    one profiled warm sim otp round; and ``launch.train.main`` with no
    ``--device`` on the card."""
    import numpy as np
    from repro_torch.core import dist
    from repro_torch.nn.pytree import tree_leaves
    from repro_torch.kernels.otp_xor import ref as otp_ref
    from repro_torch.security.mac import mac_verify_rows
    from repro_torch.security.otp import (pad_layout, tree_to_u32_rows,
                                          u32_to_tree_rows)
    dev = torch.device("cuda")
    launches, report, finals, contexts = {}, {}, {}, {}
    nq, L, E = 8, 3, 10
    for name, spec in DIST_PATHS.items():
        want = _dist_round_launches(spec, nq, L, E)
        counts = {}

        def on_round(r, rec=None, state=None, prev=None, fault=None,
                     want=want, counts=counts, name=name):
            if rec is None:                 # just before the round
                _reset(kops)
                return
            got = _counts(kops)
            rec["launches"] = {k: v for k, v in got.items() if v}
            for k, v in got.items():
                counts[k] = counts.get(k, 0) + v
                if v != want.get(k, 0):
                    raise PhaseError(f"{name} round {r}: {v} launches of "
                                     f"{k}, the table says "
                                     f"{want.get(k, 0)}")
            if not (math.isfinite(rec["loss"]) and rec["loss"] < 10.0):
                raise PhaseError(f"{name} round {r}: loss {rec['loss']}")
            if rec.get("mac_ok") is False:
                raise PhaseError(f"{name} round {r}: mac_ok false")
            if fault is not None:
                rows = (fault == 0).nonzero().flatten()
                for new, old in zip(tree_leaves(state.opt_slots),
                                    tree_leaves(prev.opt_slots)):
                    if not torch.equal(new[rows], old[rows]):
                        raise PhaseError(f"{name} round {r}: a crashed "
                                         f"row's optimizer slot moved")
                rec["frozen_rows"] = int((fault == 0).sum())
            print(f"dist {name} " + json.dumps(rec))

        state, records, contexts[name] = _dist_run(torch, np, name, spec,
                                                   trace, sats, dev,
                                                   on_round)
        if spec["mode"] in ("sim", "qfl", "seq") and not _rows_equal_row0(
                torch, state.params):
            raise PhaseError(f"{name}: rows differ from row 0 after the "
                             f"aggregate")
        if spec.get("faults") and not sum(x["crashed"] for x in records):
            raise PhaseError(f"{name}: the fault plane crashed no row")
        launches[name] = counts
        finals[name] = state
        report[name] = records
        print(f"dist {name}: seconds per round "
              f"{[x['seconds'] for x in records]}")
    for name in ("dist_sim_otp", "dist_sim_otp_gather"):
        if not all(torch.equal(a, b) for a, b in zip(
                finals[name].params.values(),
                finals["dist_sim"].params.values())):
            raise PhaseError(f"{name} is not bit-equal to dist_sim")
    gap = _leaf_gap(finals["dist_sim_secagg"].params,
                    finals["dist_sim"].params)
    print(f"dist: sim otp and otp_gather bit-equal to sim on the card; "
          f"secagg within {gap:.3e} of sim")
    if gap > 1e-5:
        raise PhaseError(f"dist_sim_secagg is {gap} from dist_sim")
    # outside round_fn: otp_gather's two launches on the last round's
    # inputs against the plain version bit for bit, and one ciphertext word
    # flipped in transit caught by the plain verify and by the round's own
    # check (the aggregator's tags against the sender's), in that row alone
    _, seeds_r, _ = contexts["dist_sim_otp_gather"][-1].dist_inputs(1, dev)
    s_r = dist._round_seeds(seeds_r, 1, dist._OTP_MIX)
    rk, sk = dist._mac_keys(s_r)
    p = finals["dist_sim"].params
    ct, tags = dist._gather_send(p, s_r)
    moved, tags_rx = dist._gather_receive(ct, s_r)
    layout = pad_layout(p, lead=1)
    want_ct, want_tags = otp_ref.otp_xor_mac_rows_seeded_ref(
        otp_ref.as_storage(tree_to_u32_rows(p)), otp_ref.as_storage(s_r),
        layout, otp_ref.as_storage(rk), otp_ref.as_storage(sk))
    want_pt, want_rx = otp_ref.otp_xor_mac_rows_seeded_ref(
        want_ct, otp_ref.as_storage(s_r), layout, otp_ref.as_storage(rk),
        otp_ref.as_storage(sk), True)
    gap = _otp_gap(torch, (otp_ref.as_storage(tree_to_u32_rows(ct)), tags,
                           otp_ref.as_storage(tree_to_u32_rows(moved)),
                           tags_rx), (want_ct, want_tags, want_pt, want_rx))
    print(f"dist otp_gather launches on the round's inputs (G={len(sats)}): "
          f"max_abs_err={gap} against the plain version")
    if gap or not torch.equal(tags, tags_rx):
        raise PhaseError(f"otp_gather's launches disagree with the plain "
                         f"version ({gap}) or with each other")
    rows = tree_to_u32_rows(ct)
    clean = mac_verify_rows(rows, tags, rk, sk)
    rows[7, 11] ^= 1 << 13
    flipped = mac_verify_rows(rows, tags, rk, sk).tolist()
    _, tags_bad = dist._gather_receive(u32_to_tree_rows(rows, ct), s_r)
    caught = (tags_bad == tags).tolist()
    healthy = [i != 7 for i in range(len(sats))]
    if not (bool(clean.all()) and flipped == healthy and caught == healthy):
        raise PhaseError(f"the flipped word was not caught in row 7 alone: "
                         f"plain verify {flipped}, the round's check "
                         f"{caught}")
    print("dist: one flipped ciphertext word fails row 7's MAC and no "
          "other row's, under the plain verify and the round's own check")
    # the CPU (plain path) against the card's runs above
    cpu_sats = [{k: v.cpu() for k, v in s.items()} for s in sats]
    for name in ("dist_sim_otp", "dist_async_otp"):
        spec = DIST_PATHS[name]
        t0 = time.perf_counter()
        sp, rp, _ = _dist_run(torch, np, name, spec, trace, cpu_sats,
                              torch.device("cpu"))
        sc, rc = finals[name], report[name]
        gap = max(_leaf_gap(sc.params, sp.params),
                  _leaf_gap(sc.stale, sp.stale),
                  max(abs(a["loss"] - b["loss"]) for a, b in zip(rc, rp)))
        print(f"dist cross-device {name}: max gap {gap:.3e} over "
              f"{spec['rounds']} rounds ({time.perf_counter() - t0:.1f} s "
              f"on the cpu)")
        if gap > 1e-4:
            raise PhaseError(f"{name}: cuda and cpu differ by {gap}")
    # one warm sim otp round under the profiler
    cfg, api, fl, rf, plan = contexts["dist_sim_otp"]
    state = finals["dist_sim_otp"]
    batches = _dist_batches(torch, np, sats, np.random.default_rng(1),
                            fl.local_steps, fl.batch_size, dev)
    mask, seeds_r, weights = plan.dist_inputs(1, dev)
    rf(state, batches, mask, seeds_r, weights)
    prof = _device_profile(torch, lambda: rf(state, batches, mask, seeds_r,
                                             weights))
    print("profile dist_sim_otp: " + (json.dumps(prof) if prof else
                                      "not measured (the profiler recorded "
                                      "no device time)"))
    if prof:
        print(f"profile dist_sim_otp: {prof['device_ops']} device ops in one "
              f"warm round, {prof['device_busy_share']:.3f} busy")
    report["profile_dist_sim_otp"] = prof
    # the launcher's --fl path, with no --device: it must run on the card
    from repro_torch.launch import train
    from repro_torch.kernels.statevec_gate import ops
    argv = ["--fl", "--sats", "50", "--rounds", "2", "--security", "otp"]
    _reset(kops)
    t0 = time.perf_counter()
    out = train.main(argv)
    torch.cuda.synchronize()
    got = _counts(kops)
    # the launcher's defaults: 6 qubits, 2 layers, 5 local steps, and one
    # evaluation (1 + L layers) a round
    q6, L2, E5, R = 6, 2, 5, 2
    want = {"statevec_gate_layer": R * (E5 * (1 + L2) + 1 + L2),
            "statevec_gate_layer_bwd": R * E5 * L2 * 2 * len(
                ops.bwd_passes(q6)),
            "otp_xor_mac_edges_seeded": 2 * R}
    for k, v in got.items():
        if v != want.get(k, 0):
            raise PhaseError(f"launch.train --fl: {v} launches of {k}, "
                             f"expected {want.get(k, 0)}")
    if out.params["theta"].device.type != "cuda":
        raise PhaseError("launch.train --fl without --device left the card")
    launches["dist_launch_train"] = got
    print(f"dist launch.train {' '.join(argv)}: on "
          f"{out.params['theta'].device}, {time.perf_counter() - t0:.1f} s, "
          f"launches {json.dumps({k: v for k, v in got.items() if v})}")
    return launches, report


# --------------------------------------------------------------------------
# The serving path: hymba-1.5b with kernels #6 (swa_attention) and
# #7 (ssd_scan)
# --------------------------------------------------------------------------

BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core rate
SWA_SOURCE = "src/repro_torch/kernels/swa_attention/csrc/swa_attention.cu"
SSD_SOURCE = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
SWA_TOL = 2e-5                 # float32 max abs (tests/test_kernels.py)
SSD_TOL = 3e-5                 # y and state in float32 (test_kernels.py)
# name -> (B, S, H, KV, hd, W, dtype); the first is the prefill's main case
SWA_SHAPES = {
    "hymba_w1024_bf16": (4, 2048, 25, 5, 64, 1024, "bfloat16"),
    "hymba_w0_bf16": (4, 2048, 25, 5, 64, 0, "bfloat16"),
    "hymba_w1024_f32": (4, 2048, 25, 5, 64, 1024, "float32"),
    "hymba_w0_f32": (4, 2048, 25, 5, 64, 0, "float32"),
    "qwen3_hd128_w0_bf16": (1, 2048, 16, 8, 128, 0, "bfloat16"),
    "qwen3_hd128_w0_f32": (1, 2048, 16, 8, 128, 0, "float32"),
    "s1000_w100_f32": (2, 1000, 25, 5, 64, 100, "float32"),
    "w_over_s_f32": (2, 300, 4, 2, 64, 1024, "float32"),
    "s1_bf16": (3, 1, 4, 2, 64, 1024, "bfloat16"),
    # the LM training path's full causal shapes (phase 14): batch 4 x 2048
    # tokens of qwen3 (hd 128, GQA 16/8), tinyllama (GQA 32/4), olmo (MHA
    # 16/16, hd 128), granite's smoke variant (MQA); the smoke steps of the
    # CPU-vs-card check and of the federated twin (f32, hd 32)
    "qwen3_train_bf16": (4, 2048, 16, 8, 128, 0, "bfloat16"),
    "qwen3_train_f32": (4, 2048, 16, 8, 128, 0, "float32"),
    "tinyllama_train_bf16": (4, 2048, 32, 4, 64, 0, "bfloat16"),
    "olmo_train_bf16": (4, 2048, 16, 16, 128, 0, "bfloat16"),
    "granite_smoke_train_bf16": (4, 2048, 4, 1, 64, 0, "bfloat16"),
    "qwen3_smoke_f32": (2, 128, 4, 2, 32, 0, "float32"),
    "qwen3_twin_f32": (4, 64, 4, 2, 32, 0, "float32"),
    # the MoE prefills of phase 15: qwen3-moe-235b-a22b's GQA 64/4 at hd
    # 128 (deepseek-moe-16b's MHA 16/16 at hd 128 is olmo_train_bf16's
    # shape), and the smoke deepseek's of phase 14's CPU-vs-card step (f32,
    # MHA 4/4 at hd 64)
    "qwen3_moe_bf16": (4, 2048, 64, 4, 128, 0, "bfloat16"),
    "qwen3_moe_f32": (4, 2048, 64, 4, 128, 0, "float32"),
    "deepseek_smoke_f32": (2, 128, 4, 4, 64, 0, "float32"),
    # phase 16: whisper-tiny's decoder self-attention (MHA 6/6, hd 64, no
    # rope) at the prefill's 16 x 448 and the f32 checks' 2 x 448; the
    # VLM's self layers (GQA 64/8, hd 128) at 4 x 2048 and 2 x 2048; the
    # smoke variants' CPU-vs-card prefills (f32, 2 x 256)
    "whisper_bf16": (16, 448, 6, 6, 64, 0, "bfloat16"),
    "whisper_f32": (2, 448, 6, 6, 64, 0, "float32"),
    "vlm_bf16": (4, 2048, 64, 8, 128, 0, "bfloat16"),
    "vlm_f32": (2, 2048, 64, 8, 128, 0, "float32"),
    "vlm_smoke_f32": (2, 256, 4, 2, 64, 0, "float32"),
}
SWA_TIMED = ("hymba_w1024_bf16", "hymba_w0_bf16", "qwen3_train_bf16",
             "tinyllama_train_bf16", "olmo_train_bf16", "qwen3_moe_bf16",
             "qwen3_moe_f32", "whisper_bf16", "vlm_bf16")
# the training shapes, where the backward's plain replay is timed too
SWA_REPLAY = ("qwen3_train_bf16", "tinyllama_train_bf16", "olmo_train_bf16")
# name -> (B, S, H, G, P, N, dtype), chunk 128 (the divisor rule applies)
SSD_SHAPES = {
    "hymba_bf16": (4, 2048, 50, 1, 64, 16, "bfloat16"),
    "hymba_f32": (4, 2048, 50, 1, 64, 16, "float32"),
    "mamba2_130m_f32": (4, 2048, 24, 1, 64, 128, "float32"),
    "mamba2_130m_bf16": (4, 2048, 24, 1, 64, 128, "bfloat16"),
    "g2_f32": (2, 512, 4, 2, 64, 16, "float32"),
    "s1000_chunk125_f32": (2, 1000, 50, 1, 64, 16, "float32"),
    # the smoke mamba2's SSM of phase 14's CPU-vs-card step (the full
    # model trains at mamba2_130m_bf16's shape)
    "mamba2_smoke_f32": (2, 128, 16, 1, 32, 16, "float32"),
}
# the prefill's shape, then N=128, where the look-back moves the most
SSD_TIMED = ("hymba_bf16", "mamba2_130m_bf16")
# the training shape, where the backward's plain replay is timed too
SSD_REPLAY = ("mamba2_130m_bf16",)
# what the prefill profile matches in device kernel names: #6 launches
# swa_fwd_bf16_kernel (swa_fwd_f32_kernel in float32), #7
# ssd_scan_mma_kernel (ssd_scan_f32_kernel)
SERVE_KERNEL_NAMES = ("swa_fwd", "ssd_scan_")
SERVE_PREFILL = (4, 2048)      # requests x prompt tokens
SERVE_GEN = (4, 16, 32)        # requests, prompt tokens, new tokens


def _swa_inputs(torch, B, S, H, KV, hd, dtype, seed):
    g = torch.Generator("cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    r = lambda shape, s: (s * torch.randn(shape, generator=g, device="cuda")
                          ).to(dt)
    return r((B, S, H, hd), 0.5), r((B, S, KV, hd), 0.5), r((B, S, KV, hd), 1.0)


def _swa_bound(B, S, H, KV, hd, W, dtype) -> dict:
    """Least time for the band: 4*hd flops per unmasked (q, k) pair at the
    inputs' peak rate (bf16 tensor cores; float32 CUDA cores), against q,
    k, v read and o written once (k, v unrepeated)."""
    pairs = B * H * sum(min(i + 1, W) if W > 0 else i + 1 for i in range(S))
    esize = 2 if dtype == "bfloat16" else 4
    ops_ms = 4 * hd * pairs / (BF16_FLOPS if esize == 2 else FP32_FLOPS) * 1e3
    bytes_ms = esize * hd * B * S * (2 * H + 2 * KV) / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms), "ops_ms": ops_ms,
            "bytes_ms": bytes_ms, "pairs": pairs,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def _bf16_steps(torch, got, want) -> float:
    """The bf16 limit: the largest |got - want| over the elements, in units
    of one bf16 step of that element of ``want`` (2^(floor(log2|want|) - 7))
    plus 2^-16. Two bf16 roundings of float32 values that agree to float32
    precision differ by at most one step, so a kernel that computes the
    plain version's function in float32 reads <= 1; one that keeps scores,
    probabilities or dt in bf16 reads far more (the controls below)."""
    w = want.float().abs().clamp_min(2.0 ** -126)
    step = torch.exp2(torch.floor(torch.log2(w)) - 7) + 2.0 ** -16
    return ((got.float() - want.float()).abs() / step).max().item()


def phase_swa_kernel(torch, ops, blocks):
    """Kernel #6 against its plain version at every listed shape; timings
    of the kernel, the plain version and SDPA with a boolean band mask (the
    library yardstick, called nowhere in the port) at the timed shapes.
    There, in bf16, two controls must fail the bf16 limit that the kernel
    meets: SDPA and the XLA path's bf16 softmax (``blocks._sdpa_core``)."""
    F = torch.nn.functional
    worst, timings = {"float32": 0.0, "bfloat16": 0.0}, {}
    steps = {}
    for i, (name, (B, S, H, KV, hd, W, dtype)) in enumerate(
            SWA_SHAPES.items()):
        q, k, v = _swa_inputs(torch, B, S, H, KV, hd, dtype, seed=i)
        got = ops.swa_attention(q, k, v, W)
        want = ops.swa_attention_plain(q, k, v, W)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if dtype == "float32":
            ok, limit = err <= SWA_TOL, f"max_abs <= {SWA_TOL}"
        else:
            steps[name] = _bf16_steps(torch, got, want)
            ok, limit = steps[name] <= 1.0, (
                f"bf16_steps={steps[name]:.4f} <= 1")
        print(f"swa check {name} B={B} S={S} H={H} KV={KV} hd={hd} W={W} "
              f"{dtype}: max_abs_err={err:.3e}, {limit}")
        if not (math.isfinite(err) and ok):
            raise PhaseError(f"swa kernel disagrees at {name}: {limit} "
                             f"fails (max abs {err})")
        worst[dtype] = max(worst[dtype], err)
        if name in SWA_TIMED:
            pos = torch.arange(S, device="cuda")
            band = pos[None, :] <= pos[:, None]
            if W > 0:
                band &= pos[None, :] > pos[:, None] - W
            qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib = lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=band, enable_gqa=True)
            lib_out = lib().transpose(1, 2)
            lib_err = (lib_out.float() - want.float()).abs().max().item()
            controls = None
            if dtype == "bfloat16":
                kk, vv = ops.repeat_kv(k, H), ops.repeat_kv(v, H)
                controls = {"sdpa": _bf16_steps(torch, lib_out, want),
                            "xla_bf16_softmax": _bf16_steps(
                                torch, blocks._sdpa_core(q, kk, vv,
                                                         band[None, None]),
                                want)}
                del kk, vv
                print(f"swa bf16 controls {name}: bf16_steps " +
                      json.dumps(controls))
                failed = {c: r for c, r in controls.items()
                          if not r > 1.0}
                if failed:
                    raise PhaseError(f"the bf16 limit cannot tell these "
                                     f"from the kernel at {name}: {failed}")
            del lib_out
            call = lambda: ops.swa_attention(q, k, v, W)
            if name in SWA_REPLAY:
                # what a training step's backward runs per layer: the
                # plain version's forward replayed under autograd and its
                # gradient (the kernel's backward)
                qr, kr, vr = (x.detach().requires_grad_(True)
                              for x in (q, k, v))
                gout = torch.ones_like(q)

                def replay():
                    out = ops.swa_attention_plain(qr, kr, vr, W)
                    torch.autograd.grad(out, (qr, kr, vr), gout)
                replay_ms = _cuda_ms(torch, replay, 5)
            else:
                replay_ms = None
            t = {"shape": [B, S, H, KV, hd, W, dtype],
                 "ms": _cuda_ms(torch, call, 20),
                 "device_ms": _device_ms(torch, call, 10),
                 "plain_ms": _cuda_ms(torch, lambda: ops.swa_attention_plain(
                     q, k, v, W), 5),
                 "library_ms": _cuda_ms(torch, lib, 20),
                 "bwd_replay_ms": replay_ms,
                 "library_max_abs_err": lib_err,
                 "bf16_steps": steps.get(name),
                 "control_bf16_steps": controls,
                 **_swa_bound(B, S, H, KV, hd, W, dtype)}
            timings[name] = t
            print(f"swa timing {name}: " + json.dumps(t))
        del q, k, v, got, want
    return worst, steps, timings


def _ssd_inputs(torch, B, S, H, G, P, N, dtype, seed):
    """The distributions of the JAX package's kernel tests."""
    g = torch.Generator("cuda").manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    dt_ = getattr(torch, dtype)
    return ((0.5 * r(B, S, H, P)).to(dt_),
            torch.nn.functional.softplus(r(B, S, H)),
            -torch.exp(0.3 * r(H)),
            (0.3 * r(B, S, G, N)).to(dt_), (0.3 * r(B, S, G, N)).to(dt_))


def _ssd_bound(B, S, H, G, P, N, dtype) -> dict:
    """Least time for the scan: x, dt, B, C, A read and y, the state
    written once, against the recurrent form's arithmetic (4 flops per
    (step, p, n)) at the inputs' peak rate: bf16 on the tensor cores (the
    bf16 kernel's chunk products are mma), float32 on the CUDA cores."""
    esize = 2 if dtype == "bfloat16" else 4
    n_bytes = (esize * (2 * B * S * H * P + 2 * B * S * G * N)
               + 4 * (B * S * H + H + B * H * P * N))
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * B * S * H * P * N / (BF16_FLOPS if esize == 2
                                      else FP32_FLOPS) * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms), "ops_ms": ops_ms,
            "bytes_ms": bytes_ms,
            "bound_by": "operations" if ops_ms > bytes_ms else "bytes"}


def _check_ssd(torch, ops, blocks, name, args, init, steps) -> float:
    """One kernel-vs-plain check of #7; returns its largest max abs error
    (y or state). bf16 y is held to ``_bf16_steps`` <= 1, f32 y and every
    state to SSD_TOL."""
    y, st = ops.ssd_scan(*args, chunk=128, init_state=init)
    y_r, st_r = blocks.ssd_ref(*args, chunk=128, init_state=init)
    torch.cuda.synchronize()
    err_y = (y.float() - y_r.float()).abs().max().item()
    err_st = (st - st_r).abs().max().item()
    if y.dtype == torch.float32:
        ok, limit = err_y <= SSD_TOL, f"y max_abs <= {SSD_TOL}"
    else:
        steps[name] = _bf16_steps(torch, y, y_r)
        ok, limit = steps[name] <= 1.0, f"y bf16_steps={steps[name]:.4f} <= 1"
    S = args[0].shape[1]
    print(f"ssd check {name} {tuple(args[0].shape)} G={args[3].shape[2]} "
          f"N={args[3].shape[3]} chunk={ops.chunk_len(S, 128)} {y.dtype}: "
          f"y max_abs_err={err_y:.3e}, {limit}, state max_abs_err="
          f"{err_st:.3e}")
    if not (ok and err_st <= SSD_TOL):
        raise PhaseError(f"ssd kernel disagrees at {name}: {limit} fails "
                         f"(y max abs {err_y}), state {err_st}")
    return max(err_y, err_st)


def phase_ssd_kernel(torch, ops, blocks):
    """Kernel #7 against its plain version (``blocks.ssd_ref``) at every
    listed shape, and from a given initial state at the first; timings at
    the shapes in SSD_TIMED. In bf16 the plain version fed dt rounded to
    bf16 (a kernel that kept dt in bf16) must fail the limit the kernel
    meets. No single PyTorch call computes the scan, so there is no
    library time."""
    worst, timings = {"float32": 0.0, "bfloat16": 0.0}, {}
    steps, controls = {}, {}
    for i, (name, (B, S, H, G, P, N, dtype)) in enumerate(
            SSD_SHAPES.items()):
        args = _ssd_inputs(torch, B, S, H, G, P, N, dtype, seed=100 + i)
        err = _check_ssd(torch, ops, blocks, name, args, None, steps)
        if i == 0:
            g = torch.Generator("cuda").manual_seed(99)
            init = 0.1 * torch.randn(B, H, P, N, generator=g, device="cuda")
            err = max(err, _check_ssd(torch, ops, blocks,
                                      name + "_init_state", args, init,
                                      steps))
        worst[dtype] = max(worst[dtype], err)
        if dtype == "bfloat16":
            x, dt, A, Bv, Cv = args
            y_r, _ = blocks.ssd_ref(*args, chunk=128)
            y_c, _ = blocks.ssd_ref(x, dt.bfloat16().float(), A, Bv, Cv,
                                    chunk=128)
            controls[name] = _bf16_steps(torch, y_c, y_r)
            print(f"ssd bf16 control {name}: dt in bf16, bf16_steps="
                  f"{controls[name]:.4f}")
            if not controls[name] > 1.0:
                raise PhaseError(f"the bf16 limit cannot tell dt in bf16 "
                                 f"from the kernel at {name}")
            del y_r, y_c
        if name in SSD_TIMED:
            call = lambda: ops.ssd_scan(*args, chunk=128)
            if name in SSD_REPLAY:
                # what a training step's backward runs per layer: the
                # plain version's forward replayed under autograd and its
                # gradient in every input (the kernel's backward)
                rargs = [a.detach().requires_grad_(True) for a in args]

                def replay():
                    y, st = blocks.ssd_ref(*rargs, chunk=128)
                    torch.autograd.grad((y, st), rargs,
                                        (torch.ones_like(y),
                                         torch.zeros_like(st)))
                replay_ms = _cuda_ms(torch, replay, 5)
                del rargs
            else:
                replay_ms = None
            t = {"shape": [B, S, H, G, P, N, dtype],
                 "ms": _cuda_ms(torch, call, 20),
                 "device_ms": _device_ms(torch, call, 10),
                 "plain_ms": _cuda_ms(torch, lambda: blocks.ssd_ref(
                     *args, chunk=128), 5),
                 "library_ms": None, "bwd_replay_ms": replay_ms,
                 "bf16_steps": steps[name],
                 "control_bf16_steps": controls[name],
                 **_ssd_bound(B, S, H, G, P, N, dtype)}
            timings[name] = t
            print(f"ssd timing {name}: " + json.dumps(t))
        del args
    return worst, steps, controls, timings


def _rel(a, b) -> float:
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


def _device_profile(torch, fn, kernels=()) -> dict | None:
    """Device-busy share and top device ops of one call of ``fn``, and the
    device time per launch of each kernel named in ``kernels``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == DeviceType.CUDA
              and _dev_us(e) > 0]
    busy_s = sum(_dev_us(e) for e in events) / 1e6
    if busy_s == 0:
        return None
    top = sorted(events, key=_dev_us, reverse=True)[:10]
    return {"wall_s_under_profiler": wall, "device_busy_s": busy_s,
            "device_busy_share": busy_s / wall,
            "device_ops": sum(e.count for e in events),
            "top": [{"name": e.key[:80], "device_ms": _dev_us(e) / 1e3,
                     "count": e.count} for e in top],
            "ms_per_launch": {k: _ms_per_launch(events, k)
                              for k in kernels}}


def _ms_per_launch(events, kernel_name: str):
    """Mean device time of one launch of the named kernel in a profile's
    device events; None where it has none."""
    mine = [e for e in events if kernel_name in e.key]
    count = sum(e.count for e in mine)
    total_us = sum(_dev_us(e) for e in mine)
    return total_us / count / 1e3 if count and total_us > 0 else None


def _timed_prefill(torch, kops, cfg, prefill, params, batch, name, want,
                   by_window):
    """A warm prefill, then one timed with the counts set to 0 just
    before and read just after: it must launch what ``want`` says and no
    other kernel, #6 ``by_window`` ({W: launches}) times, and give finite
    (B, padded vocab) next-token logits. Returns (logits, launches,
    timing and the launches by window as read)."""
    prefill(params, batch)                               # warm (cuBLAS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(kops)
    t0 = time.perf_counter()
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = _counts(kops)
    _check_lm_launches(f"{name} prefill", got, want)
    got_window = dict(kops[2].LAUNCHES_BY_WINDOW)
    if got_window != by_window:
        raise PhaseError(f"{name} prefill: #6 by window {got_window}, "
                         f"expected {by_window}")
    B, S = batch["tokens"].shape
    if logits.shape != (B, cfg.padded_vocab) or not bool(
            torch.isfinite(logits[:, :cfg.vocab_size]).all()):
        raise PhaseError(f"{name} prefill logits {tuple(logits.shape)} not "
                         f"finite")
    return logits, got, {"prefill_s": dt, "prefill_tokens_per_s": B * S / dt,
                         "prefill_peak_gb":
                             torch.cuda.max_memory_allocated() / 1e9,
                         "prefill_swa_launches_by_window": got_window}


def _timed_generate(torch, kops, cfg, api, params, prompts, ngen, name,
                    extras=None):
    """``generate`` (greedy) of ``ngen`` tokens after ``prompts``, warm,
    then timed with the counts set to 0 just before and read just after:
    it must launch no kernel. Returns (launches, timing)."""
    from repro_torch.launch.serve import generate
    nb, npr = prompts.shape
    generate(cfg, api, params, prompts, 2, cache_len=npr + 2, extras=extras)
    torch.cuda.synchronize()
    _reset(kops)
    t0 = time.perf_counter()
    toks = generate(cfg, api, params, prompts, ngen, cache_len=npr + ngen,
                    extras=extras)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = _counts(kops)
    if any(got.values()):
        raise PhaseError(f"{name} decode launched a kernel: {got}")
    if toks.shape != (nb, npr + ngen) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise PhaseError(f"{name}: generated tokens out of range")
    return got, {"generate_s": dt, "decode_steps": npr + ngen,
                 "decode_step_ms": dt / (npr + ngen) * 1e3,
                 "decode_tokens_per_s": nb * (npr + ngen) / dt,
                 "new_tokens_per_s": nb * ngen / dt,
                 "sample_tokens": toks[0, npr:npr + 8].tolist()}


def phase_serve(torch, kops):
    """hymba-1.5b at full width and depth in bf16 through the port's
    serving entry points: one prefill of 4 x 2048 tokens
    (``make_prefill_step``) and ``generate`` for 4 requests of 16 prompt
    tokens and 32 new ones. Counts every kernel's launches, set to 0 just
    before each and read just after: the prefill launches #6 32 times (29
    at W=1024, 3 at W=0) and #7 32 times; decode launches neither; neither
    launches a trainer kernel."""
    from repro_torch import prng
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import get_config, get_model
    from repro_torch.nn.pytree import tree_leaves
    cfg = get_config("hymba-1.5b")
    api = get_model(cfg)
    key = prng.PRNGKey(0, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = api.init(cfg, key)
    torch.cuda.synchronize()
    report = {"init_s": time.perf_counter() - t0,
              "n_params": sum(x.numel() for x in tree_leaves(params))}
    B, S = SERVE_PREFILL
    tokens = prng.randint(prng.fold_in(key, 1), (B, S), 0, cfg.vocab_size)
    prefill = make_prefill_step(cfg, api)
    launches = {}
    with torch.inference_mode():
        logits, launches["prefill"], t = _timed_prefill(
            torch, kops, cfg, prefill, params, {"tokens": tokens}, "hymba",
            {"swa_attention": 32, "ssd_scan": 32}, {1024: 29, 0: 3})
        report.update(t)
        nb, npr, ngen = SERVE_GEN
        prompts = prng.randint(prng.fold_in(key, 2), (nb, npr), 0,
                               cfg.vocab_size)
        launches["decode"], t = _timed_generate(torch, kops, cfg, api,
                                                params, prompts, ngen, "hymba")
        report.update(t)
        report["prefill_profile"] = _device_profile(
            torch, lambda: prefill(params, {"tokens": tokens}),
            kernels=SERVE_KERNEL_NAMES)
    print("serve: " + json.dumps(report))
    print(f"serve launches: {json.dumps(launches)}")
    del params, logits
    torch.cuda.empty_cache()
    return launches, report


@contextlib.contextmanager
def _plain_mixers(blocks, swa_ops):
    """Points the model's sequence mixers at their plain versions for the
    kernel-vs-plain cross-check, and back."""
    saved = blocks.swa_attention, blocks.ssd_scan
    blocks.swa_attention = swa_ops.swa_attention_plain
    blocks.ssd_scan = blocks.ssd_ref
    try:
        yield
    finally:
        blocks.swa_attention, blocks.ssd_scan = saved


def _forward_vs_decode(torch, cfg, api, params, batch):
    """Teacher-forced logits of ``batch`` against decode-stepped ones over
    its tokens (a model with a cross cache first fills it from the
    batch's embeddings): (rel, the forward's aux)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    full, aux = api.forward(cfg, params, batch)
    cache = api.init_cache(cfg, B, S, device="cuda")
    if api.prefill_cross is not None:
        cache = api.prefill_cross(cfg, params, cache, batch.get(
            "audio_embeds", batch.get("image_embeds")))
    steps = []
    for t in range(S):
        lg, cache = api.decode_step(cfg, params, cache, {
            "token": tokens[:, t],
            "pos": torch.full((B,), t, dtype=torch.int32, device="cuda")})
        steps.append(lg)
    v = cfg.vocab_size
    return _rel(torch.stack(steps, 1)[..., :v], full[..., :v]), float(aux)


def _kernel_vs_plain(torch, blocks, swa_ops, cfg, api, params, batch,
                     around=lambda i: contextlib.nullcontext()):
    """The prefill's next-token logits with the kernels (inside
    ``around(0)``) against their plain versions (inside ``around(1)``) on
    the same inputs, rel."""
    from repro_torch.launch.steps import make_prefill_step
    prefill = make_prefill_step(cfg, api)
    with around(0):
        got = prefill(params, batch)
    with _plain_mixers(blocks, swa_ops), around(1):
        want = prefill(params, batch)
    v = cfg.vocab_size
    return _rel(got[:, :v], want[:, :v])


def _cpu_vs_card(torch, cfg, api, params_cuda, batch,
                 around=lambda i: contextlib.nullcontext()) -> dict:
    """The prefill's next-token logits on the card (the kernels, inside
    ``around(0)``) against the CPU (their plain versions, inside
    ``around(1)``) from the same parameters, copied to the host, and the
    same inputs: rel, and the CPU's seconds."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.nn.pytree import tree_map
    prefill = make_prefill_step(cfg, api)
    with around(0):
        got = prefill(params_cuda, {k: x.cuda() for k, x in batch.items()})
    params_cpu = tree_map(lambda a: a.cpu(), params_cuda)
    t0 = time.perf_counter()
    with around(1):
        want = prefill(params_cpu, {k: x.cpu() for k, x in batch.items()})
    v = cfg.vocab_size
    return {"rel": _rel(got[:, :v].cpu(), want[:, :v]),
            "cpu_s": time.perf_counter() - t0}


def phase_serve_cross(torch, blocks, swa_ops):
    """Cross-checks of the serving path at full width in float32:
    forward vs decode-stepped logits over a 64-token prompt (rel < 2e-3,
    the JAX contract of tests/test_decode_parity.py); the prefill's
    next-token logits, kernel path vs plain path, full depth (rel <= 1e-4);
    a 2-layer prefill on the CPU (plain) vs the card (kernels) (rel <=
    1e-4)."""
    from repro_torch import prng
    from repro_torch.models import get_config, get_model
    cfg = get_config("hymba-1.5b").replace(dtype="float32")
    api = get_model(cfg)
    v = cfg.vocab_size
    out = {}
    with torch.inference_mode():
        key = prng.PRNGKey(1, device="cuda")
        params = api.init(cfg, key)
        out["forward_vs_decode_rel"], _ = _forward_vs_decode(
            torch, cfg, api, params,
            {"tokens": prng.randint(prng.fold_in(key, 1), (2, 64), 0, v)})
        out["prefill_kernel_vs_plain_rel"] = _kernel_vs_plain(
            torch, blocks, swa_ops, cfg, api, params,
            {"tokens": prng.randint(prng.fold_in(key, 2), (2, 2048), 0, v)})
        del params
        torch.cuda.empty_cache()

        cfg2 = cfg.replace(n_layers=2)
        # drawn on the card: the threefry draws of 60 M parameters take
        # ~50 s on the host's cores
        c = _cpu_vs_card(
            torch, cfg2, api, api.init(cfg2, prng.PRNGKey(2, device="cuda")),
            {"tokens": prng.randint(prng.PRNGKey(3, device="cpu"), (2, 256),
                                    0, v)})
        out["two_layer_cpu_vs_cuda_rel"] = c["rel"]
        out["two_layer_cpu_s"] = c["cpu_s"]
    print("serve cross-checks: " + json.dumps(out))
    if not out["forward_vs_decode_rel"] < 2e-3:
        raise PhaseError(f"forward vs decode: rel "
                         f"{out['forward_vs_decode_rel']}")
    for k in ("prefill_kernel_vs_plain_rel", "two_layer_cpu_vs_cuda_rel"):
        if not out[k] <= 1e-4:
            raise PhaseError(f"{k} = {out[k]} exceeds 1e-4")
    return out


# --------------------------------------------------------------------------
# The LM training path (ROADMAP item 11a): the dense and ssm decoders
# through launch.train's step, and the federated-LLM twin
# --------------------------------------------------------------------------

# name -> (arch, batch, seq, steps, smoke); bf16 and adamw throughout, the
# launcher's cosine schedule. granite-34b runs its smoke variant (in bf16):
# 34 B bf16 parameters and their adamw moments do not fit one 80 GB card
LM_TRAIN = {
    "qwen3-0.6b": ("qwen3-0.6b", 4, 2048, 10, False),
    "mamba2-130m": ("mamba2-130m", 4, 2048, 10, False),
    "tinyllama-1.1b": ("tinyllama-1.1b", 4, 2048, 1, False),
    "olmo-1b": ("olmo-1b", 4, 2048, 1, False),
    "granite-34b-smoke": ("granite-34b", 4, 2048, 3, True),
    "deepseek-moe-16b": ("deepseek-moe-16b", 4, 2048, 3, False),
}
# depth cuts of LM_TRAIN rows: deepseek-moe-16b at full width, 4 layers (1
# dense, 3 MoE): 16.4 B bf16 parameters and their adamw moments do not fit
# one 80 GB card
LM_DEPTH = {"deepseek-moe-16b": 4}
LM_LR = 3e-3                   # launch.train's default
LM_PROFILED = ("qwen3-0.6b", "mamba2-130m")   # one warm step profiled
# the archs run through launch.train.main itself (no --device: the card)
LM_MAIN = ("tinyllama-1.1b", "olmo-1b")
# a smoke step, CPU vs card: sgd at lr 1, so that the update is the
# gradient (adamw's first update is lr·g/(|g| + eps), a sign wherever
# |g| >> eps, which two summation orders can flip near g = 0)
LM_CROSS = ("qwen3-0.6b", "mamba2-130m", "deepseek-moe-16b")
LM_CROSS_SHAPE = (2, 128)
LM_CROSS_TOL = 1e-4
TWIN_SECURITY = ("none", "otp", "otp_gather", "secagg")
TWIN_ROUNDS = 2


def _causal_layers(cfg) -> int:
    """The layers that run the arch's own mixer (#6 or #7): every layer of
    a decoder, the encoder-decoder's decoder layers (its encoder is
    non-causal plain torch), the VLM's self layers (one of every
    ``cross_every`` is a cross layer)."""
    if cfg.family == "vlm":
        return cfg.n_layers // cfg.cross_every * (cfg.cross_every - 1)
    return cfg.n_layers


def _lm_mixer_launches(cfg, steps: int) -> dict:
    """#6 and #7 launches of ``steps`` training steps: 2·L of the arch's
    own mixer a step (the forward and the per-layer recompute of the
    backward; L its causal layers), none of the other."""
    own = ("ssd_scan" if cfg.family == "ssm" else "swa_attention")
    other = ("swa_attention" if own == "ssd_scan" else "ssd_scan")
    return {own: 2 * _causal_layers(cfg) * steps, other: 0}


def _check_lm_launches(name, got: dict, want: dict):
    """``got`` must launch what ``want`` says and no other kernel."""
    full = {k: 0 for k in got}
    full.update(want)
    if got != full:
        raise PhaseError(f"{name}: launches {got}, expected {full}")


def _moe_loss_terms(torch, cfg, params, batch) -> dict:
    """The MoE training loss's terms on one batch, without autograd:
    ``loss`` must be the chunked cross-entropy plus router_aux_weight
    times the forward's aux (≤ 1e-6 rel), and the aux positive (the sum
    of each MoE layer's router loss, which is k, the experts a token
    takes, at a perfectly balanced routing)."""
    from repro_torch.models import decoder
    with torch.no_grad():
        x, aux = decoder.forward_hidden(cfg, params, batch)
        ce = decoder.chunked_ce(cfg, params, x, batch["labels"])
        total = decoder.loss(cfg, params, batch)
    out = {"loss": float(total), "ce": float(ce), "aux": float(aux),
           "router_aux_weight": cfg.router_aux_weight}
    want = out["ce"] + cfg.router_aux_weight * out["aux"]
    if not (out["aux"] > 0 and abs(out["loss"] - want) <= 1e-6 * abs(want)):
        raise PhaseError(f"{cfg.name}: the loss is not ce + "
                         f"{cfg.router_aux_weight}·aux: {out}")
    return out


def _lm_train_batches(cfg, B: int, S: int, steps: int) -> list:
    """``steps`` (B, S) batches of the synthetic corpus on the card, each
    joined with the training launcher's extras (none for a decoder)."""
    from repro_torch.data.tokens import lm_batches, synthetic_corpus
    from repro_torch.launch.train import lm_extras
    corpus = synthetic_corpus(max(B * S * 50, 100_000), cfg.vocab_size,
                              device="cuda")
    ex = lm_extras(cfg, B, "cuda")
    return [dict(b, **ex) for b in lm_batches(corpus, B, S, steps)]


def _train_steps(torch, kops, cfg, step, params, opt_state, batches, name):
    """``step`` (``make_train_step``) over ``batches``, each timed on the
    host clock around its loss's synchronise, the counts set to 0 before
    the first and read around each: a step must launch what
    ``_lm_mixer_launches`` says and no other kernel, to a finite loss.
    Returns (params, opt_state, the launches of all steps, report); the
    report's ``launches_per_step`` is the last step's, as read."""
    per_step = _lm_mixer_launches(cfg, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(kops)
    losses, step_s = [], []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        before = _counts(kops)
        params, opt_state, loss = step(params, opt_state, batch, i)
        losses.append(float(loss))              # synchronises
        step_s.append(time.perf_counter() - t0)
        after = _counts(kops)
        one = {k: after[k] - before[k] for k in after}
        _check_lm_launches(f"{name} step {i}", one, per_step)
    if not losses or not all(math.isfinite(x) for x in losses):
        raise PhaseError(f"{name}: losses {losses}")
    B, S = batches[0]["tokens"].shape
    warm = step_s[1:] or step_s
    return params, opt_state, _counts(kops), {
        "steps": len(batches), "batch": B, "seq": S, "losses": losses,
        "step_s": step_s, "step_s_warm_mean": sum(warm) / len(warm),
        "tokens_per_s_warm": B * S * len(warm) / sum(warm),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches_per_step": {k: one[k] for k in per_step}}


def phase_lm_train(torch, kops):
    """The LM training path at full width and depth in bf16 on the
    synthetic corpus (``LM_TRAIN``): ``make_train_step`` under adamw and
    ``launch.train``'s cosine schedule, the step timed on the host clock
    around a synchronise, the launches of #6 and #7 read every step (2·L
    of the arch's own, 0 of the other), the loss finite every step, peak
    device memory; tinyllama and olmo through ``launch.train.main`` itself
    with no ``--device``; one warm qwen3 and mamba2 step each under
    ``torch.profiler``;
    a smoke step of qwen3 and mamba2 in float32 under sgd at lr 1 on the
    card against the CPU (loss and every parameter, so every gradient,
    ≤ 1e-4); and the federated-LLM twin
    (``repro_torch.examples.llm_federated``) on the card under each
    security mode, its launches held per round."""
    from repro_torch import prng
    from repro_torch.data.tokens import lm_batches, synthetic_corpus
    from repro_torch.examples import llm_federated
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import get_config, get_model, smoke_variant
    from repro_torch.nn.optim import cosine_schedule, get_optimizer
    from repro_torch.nn.pytree import tree_leaves
    launches, report = {}, {}
    for name, (arch, B, S, steps, smoke) in LM_TRAIN.items():
        cfg = get_config(arch)
        if smoke:
            cfg = smoke_variant(cfg).replace(dtype="bfloat16")
        if name in LM_DEPTH:
            cfg = cfg.replace(n_layers=LM_DEPTH[name])
        per_step = _lm_mixer_launches(cfg, 1)
        if arch in LM_MAIN:
            # the user's entry point, on the card by default
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset(kops)
            t0 = time.perf_counter()
            losses = launch_train.main([
                "--arch", arch, "--steps", str(steps), "--batch", str(B),
                "--seq", str(S), "--lr", str(LM_LR)])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            got = _counts(kops)
            _check_lm_launches(f"lm {name}", got,
                               _lm_mixer_launches(cfg, steps))
            r = {"entry": "launch.train.main", "steps": steps,
                 "run_s_with_init": dt, "losses": losses,
                 "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                 "launches_per_step": {k: got[k] / steps for k in per_step}}
        else:
            api = get_model(cfg)
            params = api.init(cfg, prng.PRNGKey(0, device="cuda"))
            opt = get_optimizer("adamw", cosine_schedule(LM_LR, steps,
                                                         warmup=10))
            step = make_train_step(cfg, api, opt)
            batches = _lm_train_batches(cfg, B, S, steps)
            if cfg.family == "moe":
                first_terms = _moe_loss_terms(torch, cfg, params, batches[0])
            params, opt_state, got, r = _train_steps(
                torch, kops, cfg, step, params, opt.init(params), batches,
                f"lm {name}")
            losses = r["losses"]
            r.update(entry="make_train_step", n_params=sum(
                x.numel() for x in tree_leaves(params)))
            if arch in LM_PROFILED:
                batch = batches[-1]
                r["profile"] = _device_profile(
                    torch, lambda: step(params, opt_state, batch, steps),
                    kernels=SERVE_KERNEL_NAMES)
            if cfg.family == "moe":
                # the terms before the first step and after the last
                r["loss_terms"] = [first_terms, _moe_loss_terms(
                    torch, cfg, params, batches[-1])]
            del params, opt_state, batches
        r.update(arch=arch, batch=B, seq=S, dtype=cfg.dtype,
                 smoke=smoke, n_layers=cfg.n_layers)
        if name in LM_DEPTH:
            r["reduced"] = {"n_layers": f"{get_config(arch).n_layers} -> "
                                        f"{cfg.n_layers}"}
        if not losses or not all(math.isfinite(x) for x in losses):
            raise PhaseError(f"lm {name}: losses {losses}")
        launches[f"lm_{name}"] = got
        report[name] = r
        print(f"lm train {name}: " + json.dumps(r))
        torch.cuda.empty_cache()

    # a smoke step in float32, CPU (plain versions) vs card (kernels)
    from repro_torch.nn.optim import sgd
    cross = {}
    for arch in LM_CROSS:
        cfg = smoke_variant(get_config(arch))
        api = get_model(cfg)
        B, S = LM_CROSS_SHAPE
        corpus = synthetic_corpus(20_000, cfg.vocab_size, device="cpu")
        batch = next(lm_batches(corpus, B, S, 1, seed=3))
        out = {}
        for dev in ("cpu", "cuda"):
            params = api.init(cfg, prng.PRNGKey(0, device=dev))
            opt = sgd(1.0)
            out[dev] = make_train_step(cfg, api, opt)(
                params, opt.init(params),
                {k: v.to(dev) for k, v in batch.items()}, 0)
        (p_c, _, l_c), (p_g, _, l_g) = out["cpu"], out["cuda"]
        cross[arch] = {
            "loss_rel": abs(float(l_g) - float(l_c)) / abs(float(l_c)),
            "param_max_abs": max((a.cpu() - b).abs().max().item()
                                 for a, b in zip(tree_leaves(p_g),
                                                 tree_leaves(p_c)))}
    print("lm train smoke cpu vs card: " + json.dumps(cross))
    for arch, c in cross.items():
        if not (c["loss_rel"] <= LM_CROSS_TOL
                and c["param_max_abs"] <= LM_CROSS_TOL):
            raise PhaseError(f"lm smoke step {arch}: card vs CPU {c} "
                             f"exceeds {LM_CROSS_TOL}")
    report["smoke_cpu_vs_card"] = cross

    # the federated-LLM twin: per round 4 satellites x E=3 steps of the
    # 2-layer smoke qwen3 (2·L launches a step) plus the eval forward (L),
    # and two launches of #4's seeded rows entry under otp and otp_gather
    twin = {}
    for sec in TWIN_SECURITY:
        _reset(kops)
        t0 = time.perf_counter()
        out = llm_federated.main(["--rounds", str(TWIN_ROUNDS),
                                  "--security", sec])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = _counts(kops)
        cfg = smoke_variant(get_config("qwen3-0.6b"))
        L = cfg.n_layers
        want = {"swa_attention": TWIN_ROUNDS * (
            4 * llm_federated.E * 2 * L + L)}
        if sec in ("otp", "otp_gather"):
            want["otp_xor_mac_edges_seeded"] = 2 * TWIN_ROUNDS
        _check_lm_launches(f"twin {sec}", got, want)
        rounds = out["rounds"]
        bad = [m for m in rounds if not (math.isfinite(m["local_loss"])
                                         and m["local_loss"] < 10.0)]
        if bad or (sec == "otp_gather"
                   and not all(m["mac_ok"] for m in rounds)):
            raise PhaseError(f"twin {sec}: rounds {rounds}")
        launches[f"twin_{sec}"] = got
        twin[sec] = {"rounds": rounds, "run_s": dt}
    # the rows #4's seeded entry takes on the twin's otp paths: one per
    # satellite, the smoke qwen3's float32 tree in u32 words
    rows = (tree_leaves(out["state"].params)[0].shape[0],
            sum(x[0].numel() for x in tree_leaves(out["state"].params)))
    print(f"lm twin (rows x words {rows}): " + json.dumps(twin))
    report["twin"] = twin
    report["twin_otp_rows_words"] = rows
    # the synthetic corpus is numpy's Zipf stream: its tokens, and so the
    # losses, follow this machine's numpy
    import numpy
    report["numpy"] = numpy.__version__
    print(f"lm corpus drawn by numpy {numpy.__version__}")
    for name, c in launches.items():
        print(f"lm launches {name}: " + json.dumps(
            {k: v for k, v in c.items() if v}))
    return launches, report


# --------------------------------------------------------------------------
# MoE serving (ROADMAP item 11b): deepseek-moe-16b and qwen3-moe-235b-a22b
# through the serving entry points; kernel #6 in every attention layer
# --------------------------------------------------------------------------

# name -> (arch, depth cut or None); full width, bf16, random weights from
# seed 0. qwen3-moe's 94 layers (235 B parameters) do not fit one card: 4
# layers are 11.2 B
MOE_SERVE = {"deepseek-moe-16b": ("deepseek-moe-16b", None),
             "qwen3-moe-4l": ("qwen3-moe-235b-a22b", 4)}
MOE_DECODE = ("deepseek-moe-16b",)          # the models that also decode
MOE_CROSS_LAYERS = 4           # deepseek's f32 cross-check: 1 dense + 3 MoE
MOE_CROSS_TOL = 1e-4
# tests/test_decode_parity.py's MoE decode setting: no slot drops
MOE_DECODE_CAPACITY = 16.0


@contextlib.contextmanager
def _routing_spy(blocks, seen: list):
    """Records every MoE layer's routed experts (idx, on the host) while
    it is on."""
    route = blocks._moe_route

    def spy(xt, router, cfg):
        out = route(xt, router, cfg)
        seen.append(out[1].cpu())
        return out
    blocks._moe_route = spy
    try:
        yield
    finally:
        blocks._moe_route = route


def _flips(a: list, b: list) -> int:
    """Routed (token, slot) entries that differ between two runs."""
    if len(a) != len(b):
        raise PhaseError(f"{len(a)} against {len(b)} routed MoE layers")
    return sum(int((x != y).sum()) for x, y in zip(a, b))


def phase_serve_moe(torch, kops):
    """The MoE decoders at full width in bf16 through the serving entry
    points (``MOE_SERVE``): init from seed 0 (timed), one
    ``make_prefill_step`` over 4 x 2048 tokens (warm, then timed and
    profiled), which must launch #6 once a layer at W=0 and no other
    kernel; deepseek-moe-16b at full depth also ``generate``s 4 requests
    of 16 prompt tokens and 32 new ones, launching no kernel. Each model
    is freed before the next."""
    from repro_torch import prng
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import get_config, get_model
    from repro_torch.nn.pytree import tree_leaves
    launches, report = {}, {}
    for name, (arch, depth) in MOE_SERVE.items():
        cfg = get_config(arch)
        r = {"arch": arch, "n_layers": cfg.n_layers}
        if depth:
            r["reduced"] = {"n_layers": f"{cfg.n_layers} -> {depth}"}
            cfg = cfg.replace(n_layers=depth)
            r["n_layers"] = depth
        api = get_model(cfg)
        key = prng.PRNGKey(0, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = api.init(cfg, key)
        torch.cuda.synchronize()
        r.update(init_s=time.perf_counter() - t0,
                 init_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                 n_params=sum(x.numel() for x in tree_leaves(params)),
                 param_gb=sum(x.numel() * x.element_size()
                              for x in tree_leaves(params)) / 1e9)
        B, S = SERVE_PREFILL
        tokens = prng.randint(prng.fold_in(key, 1), (B, S), 0,
                              cfg.vocab_size)
        prefill = make_prefill_step(cfg, api)
        L = cfg.n_layers
        with torch.inference_mode():
            logits, got, t = _timed_prefill(
                torch, kops, cfg, prefill, params, {"tokens": tokens}, name,
                {"swa_attention": L}, {0: L})
            launches[f"serve_moe_{name}_prefill"] = got
            r.update(t, capacity=max(int(cfg.capacity_factor * B * S
                                         * cfg.n_experts_per_tok
                                         / cfg.n_experts), 4))
            r["prefill_profile"] = _device_profile(
                torch, lambda: prefill(params, {"tokens": tokens}),
                kernels=SERVE_KERNEL_NAMES)
            if name in MOE_DECODE:
                nb, npr, ngen = SERVE_GEN
                prompts = prng.randint(prng.fold_in(key, 2), (nb, npr), 0,
                                       cfg.vocab_size)
                got, t = _timed_generate(torch, kops, cfg, api, params,
                                         prompts, ngen, name)
                launches[f"serve_moe_{name}_decode"] = got
                r.update(t)
                # one decode step under the profiler: the host's share
                cache = api.init_cache(cfg, nb, npr + ngen, device="cuda")
                step = {"token": prompts[:, 0], "pos": torch.zeros(
                    (nb,), dtype=torch.int32, device="cuda")}
                api.decode_step(cfg, params, cache, step)
                r["decode_step_profile"] = _device_profile(
                    torch, lambda: api.decode_step(cfg, params, cache, step))
                del cache
        report[name] = r
        print(f"serve moe {name}: " + json.dumps(r))
        del params, logits
        torch.cuda.empty_cache()
    print(f"serve moe launches: {json.dumps(launches)}")
    return launches, report


def phase_serve_moe_cross(torch, blocks, swa_ops):
    """Cross-checks of deepseek-moe-16b in float32 at full width, cut to
    ``MOE_CROSS_LAYERS`` layers, TF32 off: the prefill's next-token logits
    of 2 x 2048 tokens with #6 against its plain version (rel <= 1e-4);
    forward vs decode-stepped logits over 64 tokens at capacity 16 (rel <
    2e-3, tests/test_decode_parity.py's contract); a 2-layer (1 dense, 1
    MoE) prefill of 2 x 256 tokens on the CPU (plain) against the card
    (#6) (rel <= 1e-4). Each pair's routed experts are compared layer by
    layer and the entries that differ counted (a near tie can flip one)."""
    from repro_torch import prng
    from repro_torch.models import get_config, get_model
    cfg = get_config("deepseek-moe-16b").replace(
        dtype="float32", n_layers=MOE_CROSS_LAYERS)
    api = get_model(cfg)
    v = cfg.vocab_size
    out = {"n_layers": MOE_CROSS_LAYERS}
    with torch.inference_mode():
        key = prng.PRNGKey(1, device="cuda")
        params = api.init(cfg, key)
        seen = ([], [])
        out["prefill_kernel_vs_plain_rel"] = _kernel_vs_plain(
            torch, blocks, swa_ops, cfg, api, params,
            {"tokens": prng.randint(prng.fold_in(key, 2), (2, 2048), 0, v)},
            around=lambda i: _routing_spy(blocks, seen[i]))
        out["prefill_kernel_vs_plain_flips"] = _flips(*seen)

        cfg16 = cfg.replace(capacity_factor=MOE_DECODE_CAPACITY)
        out["forward_vs_decode_rel"], out["forward_aux"] = _forward_vs_decode(
            torch, cfg16, api, params,
            {"tokens": prng.randint(prng.fold_in(key, 1), (2, 64), 0, v)})
        del params
        torch.cuda.empty_cache()

        cfg2 = cfg.replace(n_layers=2)
        # drawn on the card: the threefry draws of 1.1 B parameters would
        # take minutes on the host's cores
        seen = ([], [])
        c = _cpu_vs_card(
            torch, cfg2, api, api.init(cfg2, prng.PRNGKey(2, device="cuda")),
            {"tokens": prng.randint(prng.PRNGKey(3, device="cpu"), (2, 256),
                                    0, v)},
            around=lambda i: _routing_spy(blocks, seen[i]))
        out["two_layer_cpu_s"] = c["cpu_s"]
        out["two_layer_cpu_vs_cuda_rel"] = c["rel"]
        out["two_layer_cpu_vs_cuda_flips"] = _flips(*seen)
        out["two_layer_routed_entries"] = sum(x.numel() for x in seen[1])
        torch.cuda.empty_cache()
    print("serve moe cross-checks: " + json.dumps(out))
    if not out["forward_vs_decode_rel"] < 2e-3:
        raise PhaseError(f"moe forward vs decode: rel "
                         f"{out['forward_vs_decode_rel']}")
    for k in ("prefill_kernel_vs_plain_rel", "two_layer_cpu_vs_cuda_rel"):
        if not out[k] <= MOE_CROSS_TOL:
            raise PhaseError(f"moe {k} = {out[k]} exceeds {MOE_CROSS_TOL} "
                             f"(routing flips: {out})")
    return out


# --------------------------------------------------------------------------
# The encoder-decoder and the VLM (ROADMAP item 11c), and the int8 KV
# cache (item 11d): whisper-tiny and llama-3.2-vision-90b through the
# serving and training entry points; #6 in every causal self-attention
# --------------------------------------------------------------------------

# llama-3.2-vision-90b's 100 layers (90 B bf16 parameters, ~180 GB) do not
# fit one card: serving takes 10 layers (2 groups of 1 cross + 4 self
# layers), training 1 group under sgd (adamw's two float32 moments of 6.4 B
# parameters are 51 GB, over 80 GB with the weights and gradients)
VLM_SERVE_LAYERS = 10
VLM_TRAIN_LAYERS = 5
ENCDEC_PREFILL = (16, 448)     # whisper: requests x decoder tokens
ENCDEC_GEN = (4, 4, 60)        # requests, prompt tokens, new tokens
ENCDEC_TRAIN = (16, 448, 3)    # batch, seq, adamw steps
VLM_TRAIN = (4, 2048, 3)       # batch, seq, sgd steps
VLM_GATE = 0.5                 # the f32 checks' tanh gates (0 at init)
CROSS_TOL = 1e-4
INT8_ARCH = "tinyllama-1.1b"
INT8_TOL = 0.05                # tests/test_decode_parity.py's int8 bound


def _open_gates(torch, params, value: float):
    """The VLM's parameters with every tanh gate set to ``value`` (a fresh
    model's zero gates switch every cross block off)."""
    groups = dict(params["groups"])
    cross = dict(groups["cross"])
    for g in ("gate_attn", "gate_ffn"):
        cross[g] = torch.full_like(cross[g], value)
    groups["cross"] = cross
    return dict(params, groups=groups)


def _batch(cfg, key, fold: int, B: int, S: int) -> dict:
    """(B, S) tokens under ``fold_in(key, fold)`` and the serving
    launcher's embeddings."""
    from repro_torch import prng
    from repro_torch.launch.serve import launcher_extras
    return dict(tokens=prng.randint(prng.fold_in(key, fold), (B, S), 0,
                                    cfg.vocab_size),
                **launcher_extras(cfg, key, B))


def _nonzero_biases(params, key):
    """``params`` with every attention and MLP bias and LayerNorm shift
    (``bq``, ``bv``, ``bo``, ``bi``, ``b``) drawn 0.1·N(0, 1) and every
    LayerNorm scale (``s``) 1 + 0.1·N(0, 1), each leaf under its own
    ``fold_in`` of ``key``: a fresh whisper has them 0 and 1, which hides
    a bias that is dropped or misplaced."""
    from repro_torch import prng
    index = itertools.count()

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("bq", "bv", "bo", "bi", "b", "s"):
                d = 0.1 * prng.normal(prng.fold_in(key, next(index)),
                                      tuple(v.shape))
                out[k] = (d + (1.0 if k == "s" else 0.0)).to(v.dtype)
            else:
                out[k] = v
        return out
    return walk(params)


def phase_encdec_vlm(torch, kops, blocks, swa_ops):
    """Phase 16: whisper-tiny at full width and depth and
    llama-3.2-vision-90b at full width (``VLM_SERVE_LAYERS`` layers to
    serve, ``VLM_TRAIN_LAYERS`` to train) in bf16 from random weights of
    seed 0 through the serving and training entry points, the launch
    counts set to 0 just before each path and read just after: every
    prefill launches #6 once per causal self-attention layer at W=0 and no
    other kernel, decode none, a training step twice that; the f32 checks
    (TF32 off); and the int8 KV cache against the bf16 one on
    tinyllama-1.1b at full width."""
    from repro_torch import prng
    from repro_torch.launch.serve import generate, launcher_extras
    from repro_torch.launch.steps import make_prefill_step, make_train_step
    from repro_torch.models import get_config, get_model, smoke_variant
    from repro_torch.nn.optim import cosine_schedule, get_optimizer
    from repro_torch.nn.pytree import tree_bytes, tree_leaves, tree_map
    launches, report = {}, {}
    key = prng.PRNGKey(0, device="cuda")

    # whisper-tiny, bf16, full width and depth
    cfg = get_config("whisper-tiny")
    api = get_model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = api.init(cfg, key)
    torch.cuda.synchronize()
    r = {"init_s": time.perf_counter() - t0,
         "n_params": sum(x.numel() for x in tree_leaves(params))}
    B, S = ENCDEC_PREFILL
    batch = dict(tokens=prng.randint(prng.fold_in(key, 1), (B, S), 0,
                                     cfg.vocab_size),
                 **launcher_extras(cfg, key, B))
    prefill = make_prefill_step(cfg, api)
    with torch.inference_mode():
        logits, got, t = _timed_prefill(
            torch, kops, cfg, prefill, params, batch, "whisper",
            {"swa_attention": cfg.n_layers}, {0: cfg.n_layers})
        launches["serve_encdec_prefill"] = got
        r.update(t)
        r["prefill_profile"] = _device_profile(
            torch, lambda: prefill(params, batch), kernels=SERVE_KERNEL_NAMES)
        nb, npr, ngen = ENCDEC_GEN
        got, t = _timed_generate(
            torch, kops, cfg, api, params,
            prng.randint(prng.fold_in(key, 4), (nb, npr), 0, cfg.vocab_size),
            ngen, "whisper", launcher_extras(cfg, key, nb))
        launches["serve_encdec_decode"] = got
        r.update(t)
    opt = get_optimizer("adamw", cosine_schedule(LM_LR, ENCDEC_TRAIN[2],
                                                 warmup=10))
    params, _, got, r["train"] = _train_steps(
        torch, kops, cfg, make_train_step(cfg, api, opt), params,
        opt.init(params), _lm_train_batches(cfg, *ENCDEC_TRAIN),
        "whisper train")
    launches["lm_whisper-tiny"] = got
    report["whisper-tiny"] = r
    print("encdec whisper-tiny: " + json.dumps(r))
    del params, batch, logits
    torch.cuda.empty_cache()

    # whisper in f32 at full depth, its biases and LayerNorm leaves drawn
    # nonzero: #6 vs plain, forward vs decode, CPU vs card
    cfg32 = cfg.replace(dtype="float32")
    checks = {}
    with torch.inference_mode():
        params = _nonzero_biases(
            api.init(cfg32, prng.PRNGKey(1, device="cuda")),
            prng.PRNGKey(5, device="cuda"))
        checks["prefill_kernel_vs_plain_rel"] = _kernel_vs_plain(
            torch, blocks, swa_ops, cfg32, api, params,
            _batch(cfg32, key, 6, 2, 448))
        checks["forward_vs_decode_rel"], _ = _forward_vs_decode(
            torch, cfg32, api, params, _batch(cfg32, key, 5, 2, 64))
        c = _cpu_vs_card(torch, cfg32, api, params,
                         _batch(cfg32, key, 7, 2, 448))
        checks.update(cpu_vs_card_rel=c["rel"], cpu_prefill_s=c["cpu_s"])
    report["whisper_f32"] = checks
    print("encdec whisper-tiny f32 checks: " + json.dumps(checks))
    del params
    torch.cuda.empty_cache()

    # llama-3.2-vision-90b, bf16, full width, VLM_SERVE_LAYERS layers
    full_cfg = get_config("llama-3.2-vision-90b")
    cfg = full_cfg.replace(n_layers=VLM_SERVE_LAYERS)
    api = get_model(cfg)
    r = {"n_layers": cfg.n_layers, "reduced": {
        "n_layers": f"{full_cfg.n_layers} -> {cfg.n_layers}"}}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(cfg, key)
    torch.cuda.synchronize()
    r.update(init_s=time.perf_counter() - t0,
             init_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
             n_params=sum(x.numel() for x in tree_leaves(params)),
             param_gb=tree_bytes(params) / 1e9)
    B, S = SERVE_PREFILL
    batch = dict(tokens=prng.randint(prng.fold_in(key, 1), (B, S), 0,
                                     cfg.vocab_size),
                 **launcher_extras(cfg, key, B))
    prefill = make_prefill_step(cfg, api)
    n_self = _causal_layers(cfg)
    with torch.inference_mode():
        logits, got, t = _timed_prefill(
            torch, kops, cfg, prefill, params, batch, "vlm",
            {"swa_attention": n_self}, {0: n_self})
        launches["serve_vlm_prefill"] = got
        r.update(t)
        r["prefill_profile"] = _device_profile(
            torch, lambda: prefill(params, batch), kernels=SERVE_KERNEL_NAMES)
        nb, npr, ngen = SERVE_GEN
        got, t = _timed_generate(
            torch, kops, cfg, api, params,
            prng.randint(prng.fold_in(key, 4), (nb, npr), 0, cfg.vocab_size),
            ngen, "vlm", launcher_extras(cfg, key, nb))
        launches["serve_vlm_decode"] = got
        r.update(t)
    del batch, logits
    # the first group (VLM_TRAIN_LAYERS layers) of these weights, copied
    cfg1 = full_cfg.replace(n_layers=VLM_TRAIN_LAYERS)
    params = dict(params, groups=tree_map(lambda a: a[:1].clone(),
                                          params["groups"]))
    torch.cuda.empty_cache()

    # the VLM in f32 at 1 group, gates open: #6 vs plain, forward vs decode
    checks = {}
    with torch.inference_mode():
        cfg32 = cfg1.replace(dtype="float32")
        p32 = _open_gates(torch, tree_map(lambda a: a.float(), params),
                          VLM_GATE)
        checks["prefill_kernel_vs_plain_rel"] = _kernel_vs_plain(
            torch, blocks, swa_ops, cfg32, api, p32,
            _batch(cfg32, key, 6, 2, 2048))
        checks["forward_vs_decode_rel"], _ = _forward_vs_decode(
            torch, cfg32, api, p32, _batch(cfg32, key, 5, 2, 64))
        del p32
        torch.cuda.empty_cache()
        # the smoke variant, CPU vs card (a full-width layer is 3.4 GB in
        # f32 on the host)
        cfgs = smoke_variant(full_cfg)
        ps = _open_gates(torch, api.init(cfgs, prng.PRNGKey(2, "cuda")),
                         VLM_GATE)
        c = _cpu_vs_card(torch, cfgs, api, ps, _batch(cfgs, key, 7, 2, 256))
        checks.update(smoke_cpu_vs_card_rel=c["rel"])
    report["vlm_f32"] = checks
    print("vlm f32 checks: " + json.dumps(checks))

    # training at 1 group under sgd
    opt = get_optimizer("sgd", cosine_schedule(LM_LR, VLM_TRAIN[2],
                                               warmup=10))
    params, _, got, r["train"] = _train_steps(
        torch, kops, cfg1, make_train_step(cfg1, api, opt), params,
        opt.init(params), _lm_train_batches(cfg1, *VLM_TRAIN), "vlm train")
    r["train"].update(n_layers=cfg1.n_layers, optimizer="sgd",
                      n_params=sum(x.numel() for x in tree_leaves(params)))
    launches["lm_vlm"] = got
    report["llama-3.2-vision-90b"] = r
    print("vlm llama-3.2-vision-90b: " + json.dumps(r))
    del params
    torch.cuda.empty_cache()

    # the int8 KV cache against the bf16 one: tinyllama at full width,
    # greedy tokens from the bf16 cache, then both caches teacher-forced
    # over them
    cfg = get_config(INT8_ARCH)
    api = get_model(cfg)
    nb, npr, ngen = SERVE_GEN
    out = {}
    with torch.inference_mode():
        params = api.init(cfg, key)
        prompts = prng.randint(prng.fold_in(key, 2), (nb, npr), 0,
                               cfg.vocab_size)
        toks = generate(cfg, api, params, prompts, ngen, npr + ngen)
        logits = {}
        for kv in ("bfloat16", "int8"):
            c = cfg.replace(kv_cache_dtype=kv)
            cache = api.init_cache(c, nb, npr + ngen, device="cuda")
            out[f"cache_bytes_{kv}"] = tree_bytes(cache)
            _reset(kops)
            t0 = time.perf_counter()
            steps = []
            for t in range(npr + ngen):
                lg, cache = api.decode_step(c, params, cache, {
                    "token": toks[:, t], "pos": torch.full(
                        (nb,), t, dtype=torch.int32, device="cuda")})
                steps.append(lg)
            logits[kv] = torch.stack(steps, 1)[..., :cfg.vocab_size]
            torch.cuda.synchronize()
            out[f"decode_step_ms_{kv}"] = ((time.perf_counter() - t0)
                                           / (npr + ngen) * 1e3)
            got = _counts(kops)
            if any(got.values()):
                raise PhaseError(f"int8 check: decode launched {got}")
        launches["serve_int8_decode"] = got
        out["logits_rel"] = _rel(logits["int8"], logits["bfloat16"])
        out["top1_agreement"] = (logits["int8"].argmax(-1) == logits[
            "bfloat16"].argmax(-1)).float().mean().item()
        out["cache_bytes_ratio"] = (out["cache_bytes_int8"]
                                    / out["cache_bytes_bfloat16"])
    report["int8_kv"] = out
    print(f"int8 kv cache ({INT8_ARCH}): " + json.dumps(out))
    del params, logits
    torch.cuda.empty_cache()

    for name, c in launches.items():
        print(f"encdec/vlm launches {name}: " + json.dumps(
            {k: v for k, v in c.items() if v}))
    bad = {k: v for k, v in (
        ("whisper prefill kernel vs plain",
         report["whisper_f32"]["prefill_kernel_vs_plain_rel"]),
        ("whisper cpu vs card", report["whisper_f32"]["cpu_vs_card_rel"]),
        ("vlm prefill kernel vs plain",
         report["vlm_f32"]["prefill_kernel_vs_plain_rel"]),
        ("vlm smoke cpu vs card",
         report["vlm_f32"]["smoke_cpu_vs_card_rel"])) if not v <= CROSS_TOL}
    for name in ("whisper_f32", "vlm_f32"):
        v = report[name]["forward_vs_decode_rel"]
        if not v < 2e-3:
            bad[f"{name} forward vs decode"] = v
    if not out["logits_rel"] < INT8_TOL:
        bad["int8 vs bf16 cache logits"] = out["logits_rel"]
    if bad:
        raise PhaseError(f"phase 16 checks out of bounds: {bad}")
    return launches, report



# ---------------------------------------------------------------------------
# phase 17: the examples, the host mesh and the dry-run (ROADMAP item 12b)
# ---------------------------------------------------------------------------

#: the examples at the JAX scripts' defaults: name -> (argv, whether it
#: trains, the other kernels whose launches must be nonzero)
EXAMPLES = {
    "quickstart": ([], True, ("otp_xor_mac_edges_seeded",)),
    "secure_exchange": ([], False, ("otp_xor_mac", "otp_xor_mac_edges")),
    "async_dropout": ([], True, ("otp_xor_mac_edges_seeded",)),
    "satqfl_statlog": ([], True, ()),
}
MESH_BATCH = (4, 2048)
DRYRUN_COMBOS = (("whisper-tiny", "decode_32k"), ("mamba2-130m", "long_500k"),
                 ("deepseek-moe-16b", "train_4k"))


def _example_losses(name: str, out: dict) -> list:
    """Every val loss an example reports."""
    if name == "satqfl_statlog":
        return [fw["server_val_loss_final"]
                for fw in out["table"]["frameworks"].values()]
    if name == "secure_exchange":
        return []
    return [m.server_val_loss for m in out["metrics"].values()]


def _phase_examples(torch, kops) -> tuple:
    import importlib
    launches, report = {}, {}
    for name, (argv, trains, nonzero) in EXAMPLES.items():
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        torch.cuda.synchronize()
        _reset(kops)
        t0 = time.perf_counter()
        out = mod.main(argv)                  # on the card by default
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = launches[f"example_{name}"] = _counts(kops)
        need = (("statevec_gate_layer", "statevec_gate_layer_bwd")
                if trains else ()) + nonzero
        zero = [k for k in need if not got[k]]
        losses = _example_losses(name, out)
        bad = [x for x in losses if not (math.isfinite(x) and x < 10)]
        if zero or bad:
            raise PhaseError(f"example {name}: launches {got}, none of "
                             f"{zero}; val losses {losses}")
        if name == "secure_exchange" and not (
                out["decrypt_exact"] and out["tamper_detected"]
                and out["edge_kernel_matches"]):
            raise PhaseError(f"secure_exchange checks failed: "
                             f"{ {k: v for k, v in out.items() if k != 'lines'} }")
        report[name] = {"run_s": dt, "val_losses": losses,
                        "launches": {k: v for k, v in got.items() if v}}
        print(f"example {name}: {dt:.1f} s, final lines "
              f"{json.dumps(out['lines'][-6:])}")
        print(f"example {name} launches: "
              f"{json.dumps(report[name]['launches'])}")
    return launches, report


def _bits_equal(torch, a, b) -> bool:
    from repro_torch.nn.pytree import tree_leaves
    loc = lambda t: t.to_local() if hasattr(t, "to_local") else t
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(loc(x), loc(y)) for x, y in zip(la, lb))


def _host_shape(mode: str):
    from repro_torch.configs.shapes import InputShape
    B, S = MESH_BATCH
    return InputShape(f"host_{mode}", S, B, mode)


def _analytic_gb(cfg, api, mode: str) -> float:
    from repro_torch.launch.analysis import analytic_memory_per_chip
    return analytic_memory_per_chip(cfg, api, _host_shape(mode), 1, 1, 1,
                                    False)["total"] / 1e9


def _host_copy(tree):
    """Every tensor of ``tree`` (DTensors as their local shard) on the
    host, so a kept result does not count in the next run's peak."""
    from repro_torch.nn.pytree import tree_map
    return tree_map(lambda t: (t.to_local() if hasattr(t, "to_local")
                               else t).detach().cpu(), tree)


def _tree_bytes(tree) -> int:
    """The bytes of the distinct storages under ``tree``'s tensors
    (DTensors by their local shard)."""
    from repro_torch.nn.pytree import tree_leaves
    seen = {}
    for t in tree_leaves(tree):
        t = t.to_local() if hasattr(t, "to_local") else t
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def _mesh_pair(torch, kops, name, plain, meshed):
    """``plain`` then ``meshed``, each (a step, the trees of its inputs),
    with the counts set to 0 just before and read just after and its
    result then copied to the host: the two results bit for bit equal and
    the launches equal. A step's peak is its own: its inputs' bytes plus
    the most the step allocated above what was held when it started (the
    harness holds both steps' inputs at once). Returns (launches of the
    meshed run, the plain and the meshed peak GB, the GB held besides the
    meshed step's inputs)."""
    runs = []
    for fn, inputs in (plain, meshed):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _reset(kops)
        out = fn()
        torch.cuda.synchronize()
        own = _tree_bytes(inputs)
        runs.append((_host_copy(out), _counts(kops),
                     (own + torch.cuda.max_memory_allocated() - base) / 1e9,
                     (base - own) / 1e9))
        del out
    (a, ca, plain_peak, _), (b, cb, peak, held) = runs
    if ca != cb or not _bits_equal(torch, a, b):
        raise PhaseError(f"mesh {name}: launches {cb} vs {ca} without the "
                         f"mesh; bit-equal {_bits_equal(torch, a, b)}")
    return cb, (plain_peak, peak, held)


def _host_mesh_arch(torch, kops, ctx, mesh, arch, train, launches, report):
    """One arch's plain and meshed prefill (and train step) on the host
    mesh, held bit for bit (``_mesh_pair``)."""
    from repro_torch import prng
    from repro_torch.launch.steps import (_opt_for, _opt_specs,
                                          make_prefill_step, make_train_step)
    from repro_torch.models import get_config, get_model
    from repro_torch.sharding.specs import (batch_specs, distribute_tree,
                                            param_specs)
    B, S = MESH_BATCH
    cfg = get_config(arch)
    api = get_model(cfg)
    key = prng.PRNGKey(0, device="cuda")
    params = api.init(cfg, key)
    toks = prng.randint(prng.fold_in(key, 1), (B, S), 0, cfg.vocab_size)
    batch = {"tokens": toks}
    dparams = distribute_tree(params, param_specs(cfg, params, ctx), mesh)
    dbatch = distribute_tree(batch, batch_specs(cfg, batch, ctx), mesh)
    plain, meshed = make_prefill_step(cfg, api), make_prefill_step(
        cfg, api, ctx)
    # (no_grad, not inference_mode: a DTensor's layer slice sets a
    # version counter, which an inference tensor refuses)
    with torch.no_grad():
        plain(params, batch)                               # warm
        got, (plain_peak, peak, held) = _mesh_pair(
            torch, kops, f"{arch} prefill",
            (lambda: plain(params, batch), (params, batch)),
            (lambda: meshed(dparams, dbatch), (dparams, dbatch)))
    launches[f"mesh_{arch}_prefill"] = got
    report[f"{arch}_prefill"] = {
        "peak_gb": peak, "plain_peak_gb": plain_peak, "held_gb": held,
        "analytic_gb": _analytic_gb(cfg, api, "prefill"),
        "launches": {k: v for k, v in got.items() if v}}
    if train:
        opt = _opt_for(cfg, "adamw")
        slots = opt.init(params)
        tbatch = dict(batch, labels=torch.roll(toks, -1, 1))
        dslots = distribute_tree(
            slots, _opt_specs(slots, param_specs(cfg, params, ctx)), mesh)
        dtb = distribute_tree(tbatch, batch_specs(cfg, tbatch, ctx), mesh)
        pstep, mstep = make_train_step(cfg, api, opt), make_train_step(
            cfg, api, opt, ctx)
        got, (plain_peak, peak, held) = _mesh_pair(
            torch, kops, f"{arch} train step",
            (lambda: pstep(params, slots, tbatch, 0),
             (params, slots, tbatch)),
            (lambda: mstep(dparams, dslots, dtb, 0), (dparams, dslots, dtb)))
        launches[f"mesh_{arch}_train"] = got
        report[f"{arch}_train"] = {
            "peak_gb": peak, "plain_peak_gb": plain_peak, "held_gb": held,
            "analytic_gb": _analytic_gb(cfg, api, "train"),
            "launches": {k: v for k, v in got.items() if v}}
        del slots, dslots
    del params, dparams
    torch.cuda.empty_cache()


def _phase_host_mesh(torch, kops, peaks: dict) -> tuple:
    """(b): the (1, 1) card mesh, qwen3-0.6b's prefill and train step and
    mamba2-130m's prefill each bit for bit its plain run; the analytic
    memory beside the measured peaks (``peaks``: other phases'); the
    card's total memory."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_config, get_model
    from repro_torch.sharding.context import DistCtx
    mesh = make_host_mesh()                   # world-1 NCCL, file store
    ctx = DistCtx(mesh=mesh, data_axes=("data",), seq_shard=True)
    launches, report = {}, {}
    for arch, train in (("qwen3-0.6b", True), ("mamba2-130m", False)):
        _host_mesh_arch(torch, kops, ctx, mesh, arch, train, launches,
                        report)
    for arch, measured in peaks.items():
        cfg = get_config(arch)
        report[f"{arch}_prefill"] = {
            "peak_gb": measured,
            "analytic_gb": _analytic_gb(cfg, get_model(cfg), "prefill")}
    total = torch.cuda.get_device_properties(0).total_memory
    from repro_torch.launch.dryrun import HBM_PER_CHIP
    report["total_memory"] = total
    report["total_memory_is_dryrun_hbm_per_chip"] = total == HBM_PER_CHIP
    dist.destroy_process_group()
    print("host mesh (1 x 1), bit-equal to ctx=None: " + json.dumps(report))
    for k, r in report.items():
        if isinstance(r, dict):
            print(f"  memory {k}: analytic/chip {r['analytic_gb']:.2f} GB, "
                  f"measured peak {r['peak_gb']:.2f} GB")
    print(f"  card total_memory {total} bytes (dryrun HBM_PER_CHIP "
          f"{HBM_PER_CHIP})")
    return launches, report


def _phase_dryrun() -> dict:
    """The dry-run's CLI in subprocesses (started together): exit 0 each,
    one roofline row each."""
    procs = {}
    env = dict(__import__("os").environ, PYTHONPATH=str(ROOT / "src"))
    for arch, shape in DRYRUN_COMBOS:
        procs[arch, shape] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "single"], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    rows = {}
    for key, p in procs.items():
        try:
            out = p.communicate(timeout=300)[0]
        finally:
            if p.poll() is None:
                p.kill()
        row = [line.strip() for line in out.splitlines() if " C=" in line]
        if p.returncode != 0 or not row:
            raise PhaseError(f"dryrun {key}: exit {p.returncode}: "
                             f"{out[-2000:]}")
        rows["x".join(key)] = row[0]
        print(f"dryrun: {row[0]}")
    return rows


def phase_mesh_examples(torch, kops, peaks: dict) -> tuple:
    """Phase 17: (a) the four examples on the card, (b) the host mesh on
    the card, (c) the dry-run in subprocesses. Returns (launches by path,
    report)."""
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    print(f"phase 17: torch {torch.__version__}; the dry-run's fake "
          f"process group imports")
    launches, report = _phase_examples(torch, kops)
    mesh_launches, report["host_mesh"] = _phase_host_mesh(torch, kops, peaks)
    launches.update(mesh_launches)
    report["dryrun"] = _phase_dryrun()
    return launches, report

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    try:
        from repro_torch.constellation import build_trace
        from repro_torch.kernels import build as kbuild
        from repro_torch.kernels.otp_xor import build as otp_build
        from repro_torch.kernels.otp_xor import ops as otp_ops
        from repro_torch.kernels.otp_xor import ref as otp_ref
        from repro_torch.kernels.ssd_scan import build as ssd_build
        from repro_torch.kernels.ssd_scan import ops as ssd_ops
        from repro_torch.kernels.statevec_gate import build, ops, ref
        from repro_torch.kernels.swa_attention import build as swa_build
        from repro_torch.kernels.swa_attention import ops as swa_ops
        from repro_torch.models import blocks
    except ImportError as err:
        print(f"chip_smoke: run from the root of a checkout ({err})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = _card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    kbuild.build(build.SOURCE, otp_build.SOURCE, swa_build.SOURCE,
                 ssd_build.SOURCE)                   # one nvcc each, at once
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")

    max_err, timings = phase_kernel(torch, ops, ref)
    gate_err, gate_grad_err, gate_timings = phase_gate_kernels(torch, ops, ref)
    bwd_err, bwd_timings = phase_layer_backward(torch, ops, ref)
    otp_err, otp_timings = phase_otp_kernel(torch, otp_ops, otp_ref)
    seeded_err, seeded_timings = phase_otp_seeded(torch, otp_ops, otp_ref)
    t0 = time.perf_counter()
    trace = build_trace(n_sats=50, n_planes=10, device="cuda")
    sats, server = _data(torch, 50)
    print(f"trace + data: {time.perf_counter() - t0:.1f} s")
    kops = (ops, otp_ops, swa_ops, ssd_ops)
    launches, report = phase_trainer(torch, kops, trace, sats, server)
    print(f"trainer launches by path: {json.dumps(launches)}")
    phase_fault_raise(torch, trace, sats, server)
    print("trainer report: " + json.dumps(report))
    wide_launches, _ = phase_wide_vqc(torch, kops, ref)
    launches.update(wide_launches)
    phase_shift_step(torch, kops, ref)
    phase_cross_device(torch, trace, sats, server)
    phase_profile(torch, trace, sats, server)
    dist_launches, _ = phase_in_graph(torch, kops, trace, sats)
    launches.update(dist_launches)
    del trace, sats, server
    torch.cuda.empty_cache()
    swa_err, swa_steps, swa_timings = phase_swa_kernel(torch, swa_ops,
                                                       blocks)
    ssd_err, ssd_steps, ssd_controls, ssd_timings = phase_ssd_kernel(
        torch, ssd_ops, blocks)
    llm_launches, serve_report = phase_serve(torch, kops)
    launches.update(llm_launches)
    prefill_ms = (serve_report["prefill_profile"] or {}).get(
        "ms_per_launch", {})
    phase_serve_cross(torch, blocks, swa_ops)
    lm_launches, lm_report = phase_lm_train(torch, kops)
    launches.update(lm_launches)
    lm_profile = lm_report["qwen3-0.6b"]["profile"] or {}
    t0 = time.perf_counter()
    moe_launches, moe_report = phase_serve_moe(torch, kops)
    launches.update(moe_launches)
    moe_cross = phase_serve_moe_cross(torch, blocks, swa_ops)
    print(f"phase 15 (MoE serving): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ev_launches, ev_report = phase_encdec_vlm(torch, kops, blocks, swa_ops)
    launches.update(ev_launches)
    print(f"phase 16 (encdec, VLM, int8 KV): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    peaks = {"hymba-1.5b": serve_report.get("prefill_peak_gb"),
             "deepseek-moe-16b": moe_report.get("deepseek-moe-16b", {}).get(
                 "prefill_peak_gb")}
    mesh_launches, _ = phase_mesh_examples(
        torch, kops, {k: v for k, v in peaks.items() if v is not None})
    launches.update(mesh_launches)
    print(f"phase 17 (examples, host mesh, dry-run): "
          f"{time.perf_counter() - t0:.1f} s")

    t = timings["ansatz"]
    entries = [{
        "name": "statevec_gate_layer", "route": "cuda",
        "source": SV_SOURCE,
        "replaces": "src/repro/kernels/statevec_gate/kernel.py:170",
        "max_abs_err": max_err,
        "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"], "device_ms": t["device_ms"],
        "shapes": timings,
    }]
    # kernel #3 at the shift rule's insertion shape, the mean over the 8
    # qubits it is launched on (each equally often); kernel #2 at the
    # 14-qubit round's ansatz layer, nq=20 beside it under "shapes"
    by_q = gate_timings["statevec_gate_1q"]
    mean = lambda key: (None if any(t[key] is None for t in by_q.values())
                        else sum(t[key] for t in by_q.values()) / len(by_q))
    q0 = next(iter(by_q.values()))
    entries.append({
        "name": "statevec_gate_1q", "route": "cuda", "source": SV_SOURCE,
        "replaces": "src/repro/kernels/statevec_gate/kernel.py:94",
        "max_abs_err": gate_err["statevec_gate_1q"],
        "backward_max_abs_err": gate_grad_err,
        "ms": mean("ms"), "plain_ms": mean("plain_ms"),
        "bound_ms": q0["bound_ms"], "bound_by": q0["bound_by"],
        "library_ms": mean("library_ms"), "device_ms": mean("device_ms"),
        "shapes": by_q})
    # (its library yardstick: the matmul by one 2^14 x 2^14 unitary for
    # every row, whose time does not depend on the gates' values)
    t = gate_timings["statevec_gate_tiled"]["nq14_ansatz"]
    entries.append({
        "name": "statevec_gate_tiled", "route": "cuda", "source": SV_SOURCE,
        "replaces": "src/repro/kernels/statevec_gate/kernel.py:234",
        "max_abs_err": gate_err["statevec_gate_tiled"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "library_gates": "one gate set for all rows",
        "device_ms": t["device_ms"],
        "shapes": gate_timings["statevec_gate_tiled"]})
    # the layer backward at the ansatz's (64, 32, 2^8) with both
    # cotangents (layers 2 and 3 of a step; layer 1 is gate-only, beside it
    # under "shapes", as is the 14-qubit round's (64, 32, 2^14))
    t = bwd_timings["ansatz_both"]
    entries.append({
        "name": "statevec_gate_layer_bwd", "route": "cuda",
        "source": SV_SOURCE,
        "replaces": "src/repro/kernels/statevec_gate/ops.py:180",
        "max_abs_err": bwd_err, "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": None, "device_ms": t["device_ms"],
        "replay_ms": t["replay_ms"], "shapes": bwd_timings})
    # the otp kernel's seeded body at the shape its entry meets on the
    # trainer's path: a secure stage's 64 rows of the VQC tree; one edge's
    # 62-word stream. The given-pad body (off the path since the pads are
    # generated in the kernel) rides along under "given_pad", with its
    # launches on every path (0)
    for name, given, replaces, main_shape, given_shape in (
            ("otp_xor_mac_edges_seeded", "otp_xor_mac_edges", "kernel.py:98",
             "stage", "stage"),
            ("otp_xor_mac_seeded", "otp_xor_mac", "kernel.py:131", "edge",
             "edge")):
        t = seeded_timings[name][main_shape]
        g = otp_timings[given][given_shape]
        entries.append({
            "name": name, "route": "cuda", "source": OTP_SOURCE,
            "replaces": "src/repro/kernels/otp_xor/" + replaces,
            "max_abs_err": seeded_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "device_ms": t["device_ms"], "shapes": seeded_timings[name],
            "lm_twin_rows_words": (lm_report["twin_otp_rows_words"]
                                   if name == "otp_xor_mac_edges_seeded"
                                   else None),
            "given_pad": {
                "name": given, "max_abs_err": otp_err[given],
                "ms": g["ms"], "device_ms": g["device_ms"],
                "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
                "bound_by": g["bound_by"], "shapes": otp_timings[given],
                "launches_by_path": {p: c[given]
                                     for p, c in launches.items()}}})
    # the serving kernels at the prefill's main shape (bf16; swa at W=1024,
    # 29 of the 32 layers); launches are those of one 4 x 2048 prefill
    # (device_ms is the kernel alone at that shape; the prefill's own
    # device time per launch, from its profile, is beside it). The bf16
    # limit's readings: the kernel's at every bf16 shape (<= 1 passes) and
    # the controls' that must fail it
    swa_controls = {n: t["control_bf16_steps"]
                    for n, t in swa_timings.items()}
    for name, kernel, source, replaces, err, steps, controls, t, timed in (
            ("swa_attention", SERVE_KERNEL_NAMES[0], SWA_SOURCE,
             "swa_attention/kernel.py:144", swa_err, swa_steps,
             swa_controls, swa_timings["hymba_w1024_bf16"], swa_timings),
            ("ssd_scan", SERVE_KERNEL_NAMES[1], SSD_SOURCE,
             "ssd_scan/kernel.py:89", ssd_err, ssd_steps, ssd_controls,
             ssd_timings["hymba_bf16"], ssd_timings)):
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": "src/repro/kernels/" + replaces,
            "max_abs_err": max(err.values()), "max_abs_err_by_dtype": err,
            "bf16_steps": steps, "control_bf16_steps": controls,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
            "prefill_device_ms_per_launch": prefill_ms.get(kernel),
            "lm_train_qwen3_device_ms_per_launch": lm_profile.get(
                "ms_per_launch", {}).get(kernel),
            "lm_train_launches_per_step": {
                n: r["launches_per_step"][name]
                for n, r in lm_report.items() if "launches_per_step" in r},
            "shapes": timed})
    # #6 in the MoE prefills of phase 15: its device time per launch there,
    # from each prefill's profile (the launches are launches_by_path's
    # serve_moe_* counts, the shapes' timings phase 10's), and the f32
    # cross-checks
    swa_entry = next(e for e in entries if e["name"] == "swa_attention")
    swa_entry["moe_prefill_device_ms_per_launch"] = {
        name: (r["prefill_profile"] or {}).get("ms_per_launch", {}).get(
            SERVE_KERNEL_NAMES[0]) for name, r in moe_report.items()}
    swa_entry["moe_f32_cross_checks"] = moe_cross
    # #6 in phase 16's prefills (whisper's decoder, the VLM's self layers):
    # its device time per launch from each prefill's profile, launches a
    # training step, and the f32 checks
    swa_entry["encdec_vlm_prefill_device_ms_per_launch"] = {
        name: (ev_report[name]["prefill_profile"] or {}).get(
            "ms_per_launch", {}).get(SERVE_KERNEL_NAMES[0])
        for name in ("whisper-tiny", "llama-3.2-vision-90b")}
    swa_entry["encdec_vlm_train_launches_per_step"] = {
        name: ev_report[name]["train"]["launches_per_step"]["swa_attention"]
        for name in ("whisper-tiny", "llama-3.2-vision-90b")}
    swa_entry["encdec_vlm_f32_checks"] = {
        k: ev_report[k] for k in ("whisper_f32", "vlm_f32", "int8_kv")}
    for entry in entries:
        # launches as read on every path: the trainer paths, the prefill
        # and decode, each counted from 0 (a kernel's own paths are its
        # main path; it must read 0 on the others)
        by_path = {p: c[entry["name"]] for p, c in launches.items()}
        entry["launches"] = sum(by_path.values())
        entry["launches_by_path"] = by_path
        # the same numbers again in microseconds, under the key names that
        # PERF.md's tables use; derived here so the two never disagree
        entry["max_err"] = entry["max_abs_err"]
        for us_key, ms_key in (("kernel_us", "ms"), ("plain_us", "plain_ms"),
                               ("library_us", "library_ms"),
                               ("bound_us", "bound_ms")):
            v = entry[ms_key]
            entry[us_key] = None if v is None else v * 1e3
    print(json.dumps({"kernels": entries}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr)
        sys.exit(1)
