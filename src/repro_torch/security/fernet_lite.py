"""Fernet-structured token AEAD for the control plane (host-side); a copy
of ``repro.security.fernet_lite`` (hashlib and numpy only).

The paper's QFL-QKD-Fernet mode encrypts with Fernet (AES-128-CBC + HMAC).
This offline stand-in keeps Fernet's token structure —

    version(1) | timestamp(8) | IV(16) | ciphertext | HMAC-SHA256(32)

— with a SHA-256 counter-mode keystream replacing AES (no third-party
crypto libs in this container; hashlib only). Encrypt-then-MAC over the
full header+ciphertext, constant-time verification, TTL support with a
bounded clock-skew window (tokens time-stamped in the future beyond the
skew are rejected, like real Fernet's ``_MAX_CLOCK_SKEW``).

Besides the scalar token functions, the module exposes *row-batched*
entries (``fernet_encrypt_rows`` / ``fernet_decrypt_rows``): one call
frames every control token of a secure-exchange stage — shared timestamp,
numpy-vectorized keystream XOR — and is byte-for-byte identical to the
scalar loop (tests enforce). Used for metadata / key-agreement messages;
bulk tensors use the in-graph OTP path.
"""
from __future__ import annotations

import hashlib
import hmac
import os
import struct
import time

import numpy as np

VERSION = 0x80
# token bytes beyond the plaintext: version + timestamp + IV + HMAC tag
TOKEN_OVERHEAD = 1 + 8 + 16 + 32
# how far in the future a token's timestamp may sit before it is rejected
MAX_CLOCK_SKEW_S = 60.0


def _keystream(key: bytes, iv: bytes, n: int) -> bytes:
    out = bytearray()
    counter = 0
    while len(out) < n:
        block = hashlib.sha256(key + iv + struct.pack(">Q", counter)).digest()
        out.extend(block)
        counter += 1
    return bytes(out[:n])


def _xor_bytes(a: bytes, b: bytes) -> bytes:
    if not a:
        return b""
    return (np.frombuffer(a, np.uint8) ^ np.frombuffer(b, np.uint8)).tobytes()


def _split_key(key: bytes):
    """Fernet splits its 32-byte key into signing + encryption halves."""
    if len(key) != 32:
        key = hashlib.sha256(key).digest()
    return key[:16], key[16:]


def fernet_encrypt(key: bytes, plaintext: bytes, *, now: float | None = None,
                   iv: bytes | None = None) -> bytes:
    sign_key, enc_key = _split_key(key)
    ts = struct.pack(">Q", int(now if now is not None else time.time()))
    iv = iv if iv is not None else os.urandom(16)
    ct = _xor_bytes(plaintext, _keystream(enc_key, iv, len(plaintext)))
    body = bytes([VERSION]) + ts + iv + ct
    tag = hmac.new(sign_key, body, hashlib.sha256).digest()
    return body + tag


class InvalidToken(Exception):
    pass


def fernet_decrypt(key: bytes, token: bytes, *, ttl: float | None = None,
                   now: float | None = None,
                   max_clock_skew: float | None = MAX_CLOCK_SKEW_S) -> bytes:
    sign_key, enc_key = _split_key(key)
    if len(token) < TOKEN_OVERHEAD or token[0] != VERSION:
        raise InvalidToken("malformed token")
    body, tag = token[:-32], token[-32:]
    expect = hmac.new(sign_key, body, hashlib.sha256).digest()
    if not hmac.compare_digest(tag, expect):
        raise InvalidToken("MAC mismatch")
    ts = struct.unpack(">Q", body[1:9])[0]
    t = now if now is not None else time.time()
    if max_clock_skew is not None and ts - t > max_clock_skew:
        raise InvalidToken("token timestamped in the future")
    if ttl is not None and t - ts > ttl:
        raise InvalidToken("token expired")
    iv = body[9:25]
    ct = body[25:]
    return _xor_bytes(ct, _keystream(enc_key, iv, len(ct)))


# ---------------------------------------------------------------------------
# row-batched entries — one call per secure-exchange stage
# ---------------------------------------------------------------------------

def fernet_encrypt_rows(keys, plaintexts, *, now: float | None = None,
                        ivs=None) -> list[bytes]:
    """Encrypt a batch of control tokens in one call.

    All rows share one timestamp (the stage is framed at a single wall
    instant); ``ivs`` may pin per-row IVs for deterministic tokens. Row i
    is byte-for-byte ``fernet_encrypt(keys[i], plaintexts[i], now=now,
    iv=ivs[i])`` — the scalar path stays the oracle.
    """
    t = now if now is not None else time.time()
    if ivs is None:
        ivs = [os.urandom(16) for _ in plaintexts]
    return [fernet_encrypt(k, pt, now=t, iv=iv)
            for k, pt, iv in zip(keys, plaintexts, ivs)]


def fernet_decrypt_rows(keys, tokens, *, ttl: float | None = None,
                        now: float | None = None,
                        max_clock_skew: float | None = MAX_CLOCK_SKEW_S
                        ) -> list[bytes]:
    """Verify + decrypt a batch of tokens against one shared clock.

    Raises :class:`InvalidToken` on the FIRST failing row (a stage with a
    corrupt control token is aborted wholesale; callers that need the
    failing row index catch and re-verify per row).
    """
    t = now if now is not None else time.time()
    return [fernet_decrypt(k, tok, ttl=ttl, now=t,
                           max_clock_skew=max_clock_skew)
            for k, tok in zip(keys, tokens)]
