"""Checkpointing: trees of tensors plus a metadata dict, on disk (port of
``repro.checkpoint.io``, in the same file format).

A msgpack document (the port's own codec, ``checkpoint.codec``) holds the
header ``version``, ``step``, ``treedef`` (a plain description of the
tree; no loader parses it), ``n_leaves``, ``metadata``, ``mac`` and
``payload``; the payload is a msgpack document of the leaves in
``jax.tree_util`` order, each its dtype name, shape and raw little-endian
bytes (a bfloat16 leaf as its 16-bit patterns). Integrity: the GF(2³¹−1)
polynomial MAC of the payload bytes (``security.mac``, keys r = 0x5a5a5a5a
and s = the payload's length) rides in the header, so a corrupted file
fails loudly. Leaves leave the card with ``.cpu()``; a leaf may also be a
numpy array.

Layout:  <dir>/step_<n>.msgpack   (+ step_<n>.msgpack.tmp during a write)
"""
from __future__ import annotations

import os
import re

import numpy as np
import torch

from repro_torch.checkpoint import codec
from repro_torch.nn.pytree import tree_leaves, tree_unflatten
from repro_torch.security.mac import poly_mac_u32

_BF16 = "bfloat16"


def _encode_leaf(x) -> dict:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return {"dtype": _BF16, "shape": list(x.shape),
                    "data": x.view(torch.int16).numpy().tobytes()}
        x = x.numpy()
    arr = np.asarray(x)
    return {"dtype": str(arr.dtype), "shape": list(arr.shape),
            "data": np.ascontiguousarray(arr).tobytes()}


def _decode_leaf(rec: dict) -> tuple[str, np.ndarray]:
    """(dtype name, array); a bfloat16 leaf's array holds its bit
    patterns as uint16 (numpy has no bfloat16)."""
    dt = np.uint16 if rec["dtype"] == _BF16 else np.dtype(rec["dtype"])
    return rec["dtype"], np.frombuffer(rec["data"], dt).reshape(
        tuple(rec["shape"]))


def dtype_name(x: torch.Tensor) -> str:
    """The name a tensor's dtype has in a checkpoint (numpy's)."""
    return str(x.dtype).removeprefix("torch.")


def leaf_tensor(name: str, arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor of a decoded leaf, in its own dtype."""
    if name == _BF16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _mac_bytes(payload: bytes) -> int:
    n = len(payload)
    words = np.frombuffer(payload + b"\x00" * ((-n) % 4), np.uint32)
    if words.size == 0:
        return 0
    return int(poly_mac_u32(torch.from_numpy(words.astype(np.int64)),
                            0x5A5A5A5A, n & 0x7FFFFFFF))


def _describe(tree) -> str:
    """A plain description of the tree's structure (leaves as ``*``)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (f"{type(tree).__name__}("
                + ", ".join(f"{f}={_describe(v)}"
                            for f, v in zip(tree._fields, tree)) + ")")
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(_describe(t) for t in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def _path(path_dir: str, step: int) -> str:
    return os.path.join(path_dir, f"step_{step:08d}.msgpack")


def save_checkpoint(path_dir: str, step: int, tree,
                    metadata: dict | None = None) -> str:
    """Atomically write the tree for ``step``. Returns the file path."""
    os.makedirs(path_dir, exist_ok=True)
    leaves = tree_leaves(tree)
    payload = codec.packb({"leaves": [_encode_leaf(x) for x in leaves]})
    doc = codec.packb({
        "version": 1,
        "step": step,
        "treedef": f"PyTreeDef({_describe(tree)})",
        "n_leaves": len(leaves),
        "metadata": metadata or {},
        "mac": _mac_bytes(payload),
        "payload": payload,
    })
    path = _path(path_dir, step)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(doc)
    os.replace(tmp, path)
    return path


class CheckpointCorrupt(Exception):
    pass


def _read_doc(path_dir: str, step: int | None):
    if step is None:
        step = latest_step(path_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {path_dir}")
    path = _path(path_dir, step)
    with open(path, "rb") as f:
        doc = codec.unpackb(f.read())
    if _mac_bytes(doc["payload"]) != doc["mac"]:
        raise CheckpointCorrupt(f"MAC mismatch in {path}")
    return step, doc


def read_metadata(path_dir: str, step: int | None = None):
    """(step, metadata) of a checkpoint without decoding its leaves.

    Callers whose load template depends on the checkpoint's contents (the
    trainer's variable-length async buffer lists) read this first, build
    the matching template, then load. The payload's MAC is verified here
    too: a corrupted file fails loudly even when only its metadata is
    wanted."""
    step, doc = _read_doc(path_dir, step)
    return step, doc["metadata"]


def read_leaves(path_dir: str, step: int | None = None):
    """(leaves, step, metadata): every leaf as (dtype name, numpy array) in
    file order (``jax.tree_util`` order of the tree that was saved)."""
    step, doc = _read_doc(path_dir, step)
    rec = codec.unpackb(doc["payload"])
    if len(rec["leaves"]) != doc["n_leaves"]:
        raise CheckpointCorrupt(f"{len(rec['leaves'])} leaves for a header "
                                f"of {doc['n_leaves']}")
    return [_decode_leaf(r) for r in rec["leaves"]], step, doc["metadata"]


def load_checkpoint(path_dir: str, like, step: int | None = None):
    """Load into the structure of ``like`` (a tree of tensors; shapes and
    dtypes verified, each leaf on its template's device). step=None loads
    the latest. Returns (tree, step, metadata)."""
    leaves, step, meta = read_leaves(path_dir, step)
    tmpl = tree_leaves(like)
    if len(tmpl) != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, template "
                         f"has {len(tmpl)}")
    out = []
    for t, (name, arr) in zip(tmpl, leaves):
        if tuple(arr.shape) != tuple(t.shape) or name != dtype_name(t):
            raise ValueError(
                f"leaf mismatch: ckpt {tuple(arr.shape)}/{name} vs "
                f"template {tuple(t.shape)}/{dtype_name(t)}")
        out.append(leaf_tensor(name, arr).to(t.device))
    return tree_unflatten(like, out), step, meta


_STEP_RE = re.compile(r"step_(\d+)\.msgpack$")


def latest_step(path_dir: str):
    if not os.path.isdir(path_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(path_dir)
             if (m := _STEP_RE.match(f))]
    return max(steps) if steps else None


class CheckpointManager:
    """Keep-last-N manager (the save is synchronous)."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep

    def save(self, step: int, tree, metadata=None):
        path = save_checkpoint(self.dir, step, tree, metadata)
        self._gc()
        return path

    def restore(self, like, step=None):
        return load_checkpoint(self.dir, like, step)

    def _gc(self):
        steps = sorted(int(m.group(1)) for f in os.listdir(self.dir)
                       if (m := _STEP_RE.match(f)))
        for s in steps[:-self.keep]:
            os.remove(_path(self.dir, s))
        for f in os.listdir(self.dir):
            # a leftover .tmp is a torn write (the process died mid-save);
            # latest_step never saw it, so deleting it is always safe
            if f.endswith(".msgpack.tmp"):
                os.remove(os.path.join(self.dir, f))

    @property
    def latest(self):
        return latest_step(self.dir)
