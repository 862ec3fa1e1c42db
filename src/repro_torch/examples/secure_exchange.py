"""Security stack walkthrough (paper Algorithm 2): QKD keygen -> OTP+MAC
model exchange -> teleportation of (θ, φ) pairs, with an eavesdropper
detection demo — and the edge-batched plane: every edge of a round stage
established, encrypted and tagged in one stacked dispatch (the port's
twin of ``examples/secure_exchange.py``).

    PYTHONPATH=src python -m repro_torch.examples.secure_exchange \\
        [--device cpu]

It runs on the GPU unless ``--device cpu`` is given. The OTP + MAC of
the walkthrough run through the fused OTP kernel's given-pad entries
(``kernels.otp_xor``: the single-stream entry, TPU kernel #5, then the
edge-rows entry, TPU kernel #4), which take their pad words as a tensor;
the single-bit tamper is caught by the kernel's tag of the tampered
ciphertext.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import prng
from repro_torch.device import resolve_device
from repro_torch.examples._out import Printer
from repro_torch.kernels.otp_xor.ops import otp_xor_mac, otp_xor_mac_edges
from repro_torch.kernels.otp_xor.ref import as_storage, as_words
from repro_torch.models import get_config, get_model
from repro_torch.nn.pytree import tree_leaves, tree_map
from repro_torch.quantum import bb84_keygen, derive_pad_seed, teleport_params
from repro_torch.security import (KeyManager, decrypt_tree,
                                  decrypt_tree_rows, encrypt_tree,
                                  encrypt_tree_rows, mac_verify_rows,
                                  poly_mac_rows, poly_mac_u32, tree_to_u32,
                                  tree_to_u32_rows, u32_to_tree)
from repro_torch.security.otp import pad_u32, pad_u32_rows

_M32 = 0xFFFFFFFF


def _same_bits(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def main(argv=None) -> dict:
    """Run the example; returns {"lines": what it printed} and its
    figures: BB84 lengths and QBERs, the stream's tag, the checks."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    say = Printer()
    out = {}

    say("== Algorithm 2: secure model exchange ==")
    # 1. QKD key establishment (BB84)
    res = bb84_keygen(prng.PRNGKey(0, dev), 512)
    out["key_len"], out["qber"] = int(res.key_len), float(res.qber)
    say(f"BB84: {out['key_len']} sifted bits, QBER={out['qber']:.3f}")
    res_attacked = bb84_keygen(prng.PRNGKey(1, dev), 512, eavesdrop=True)
    out["qber_attacked"] = float(res_attacked.qber)
    say(f"BB84 under intercept-resend: QBER={out['qber_attacked']:.3f} "
        f"-> {'ABORT' if out['qber_attacked'] > 0.11 else 'ok'} "
        f"(no-cloning detection)")

    # 2. the model to protect: the paper's VQC
    cfg = get_config("vqc-satqfl")
    api = get_model(cfg)
    params = api.init(cfg, prng.PRNGKey(2, dev))
    seed = int(derive_pad_seed(res.sifted_key, res.key_len))
    s_key = seed ^ 0xDEAD

    # 3. OTP encrypt + MAC through the fused kernel (given-pad stream)
    stream = tree_to_u32(params)
    n = stream.shape[0]
    pad = pad_u32(seed, n, device=dev)
    ct, tag = otp_xor_mac(as_storage(stream), as_storage(pad), seed, s_key)
    out["n_words"], out["tag"] = n, int(tag) & _M32
    say(f"encrypted {n} words; tag={out['tag']:#010x}")

    # receiver: re-tag what arrived, then decrypt
    ct_w = as_words(ct)
    _, tag_rx = otp_xor_mac(as_storage(ct_w ^ pad), as_storage(pad), seed,
                            s_key)
    recovered = u32_to_tree(ct_w ^ pad, params)
    out["decrypt_exact"] = (_same_bits(params, recovered)
                            and int(tag_rx) == int(tag))
    say(f"decryption exact: {out['decrypt_exact']}")

    # tamper detection: the kernel's tag of the tampered ciphertext
    ct_bad = ct_w.clone()
    ct_bad[5] ^= 1
    _, tag_bad = otp_xor_mac(as_storage(ct_bad ^ pad), as_storage(pad),
                             seed, s_key)
    out["tamper_detected"] = int(tag_bad) != int(tag)
    say(f"single-bit tamper detected: {out['tamper_detected']}")

    # 4. teleportation feasibility for (θ, φ) parameter pairs
    thetas = torch.abs(params["theta"].reshape(-1))[:8] % torch.pi
    phis = params["phi"].reshape(-1)[:8] % torch.pi
    td, pd, fid = teleport_params(prng.PRNGKey(3, dev), thetas, phis)
    out["fidelity"] = float(fid)
    say(f"teleported 8 (θ,φ) pairs: fidelity={out['fidelity']:.6f}, "
        f"max θ err={float(torch.max(torch.abs(td - thetas))):.2e}")

    # 5. KeyManager end-to-end (per-edge oracle path)
    km = KeyManager(prng.PRNGKey(4, dev))
    ek = km.establish((3, 7))
    enc = encrypt_tree(params, int(ek.round_seed(0)))
    dec = decrypt_tree(enc, int(ek.round_seed(0)))
    ok2 = torch.equal(dec["theta"], params["theta"])
    say(f"KeyManager edge (3,7): qber={ek.qber:.3f}, roundtrip={ok2}")

    # 6. the edge-batched plane: a whole round stage in one dispatch
    say("\n== Edge-batched plane: one dispatch per round stage ==")
    edges = [(s, 8 + s % 4) for s in range(8)]          # 8 ISL uplinks
    eks = km.establish_edges(edges)                     # ONE batched BB84
    seeds = torch.tensor([int(e.round_seed(0)) for e in eks],
                         dtype=torch.int64, device=dev)
    macs = [e.mac_keys(0) for e in eks]
    rks = torch.tensor([m[0] for m in macs], dtype=torch.int64, device=dev)
    sks = torch.tensor([m[1] for m in macs], dtype=torch.int64, device=dev)
    stacked = tree_map(lambda x: x[None].expand((len(edges),) + x.shape)
                       .contiguous(), params)
    ct_rows = encrypt_tree_rows(stacked, seeds)         # stacked OTP
    streams = tree_to_u32_rows(ct_rows)
    tags = poly_mac_rows(streams, rks, sks)             # stacked MAC
    ok_rows = mac_verify_rows(streams, tags, rks, sks)
    back = decrypt_tree_rows(ct_rows, seeds)
    exact = _same_bits(stacked, back)
    out["edge_tags"] = [int(t) & _M32 for t in tags]
    say(f"established {len(eks)} edges in one BB84 dispatch; "
        f"QBER max={max(e.qber for e in eks):.3f}")
    say(f"stage encrypt+MAC+verify+decrypt: verified="
        f"{bool(ok_rows.all())}, roundtrip exact={exact}")

    # same stage through the fused kernel's edge rows (one launch, all
    # edges), the pads given
    pads = pad_u32_rows(seeds, streams.shape[1])
    msgs = streams ^ pads                               # the plaintexts
    cts_k, _ = otp_xor_mac_edges(as_storage(msgs), as_storage(pads),
                                 as_storage(rks), as_storage(sks),
                                 block_rows=8)
    out["edge_kernel_matches"] = torch.equal(as_words(cts_k), streams)
    say(f"edge-axis kernel: {cts_k.shape[0]} ciphertexts + tags from one "
        f"launch; matches stacked plane: {out['edge_kernel_matches']}")

    # per-edge check: the batched plane is bit-identical to the oracle
    oracle = encrypt_tree(params, int(seeds[0]))
    same = torch.equal(tree_to_u32(oracle), streams[0])
    tag0 = poly_mac_u32(tree_to_u32(oracle), int(rks[0]), int(sks[0]))
    say(f"edge 0 vs per-edge oracle: ciphertext identical={same}, "
        f"tag identical={int(tag0) == int(tags[0])}")
    out["lines"] = say.lines
    return out


if __name__ == "__main__":
    main()
