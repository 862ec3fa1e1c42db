"""Build and load the port's hand-written CUDA kernels.

Each kernel package keeps its source in ``csrc/``. A source is compiled on
first use with ``nvcc`` into a shared library with a plain C interface
(no PyTorch headers, so it builds in seconds), cached under
``build/repro_torch_kernels/`` at the root of the checkout by a hash of
the source and the flags, and loaded with ``ctypes``. ``build`` starts one
``nvcc`` per missing library, all at once, and waits for them. Nothing is
compiled or loaded when a module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built from source on the machine with the GPU")
    return path


def library_path(source: Path) -> Path:
    """Where the library built from ``source`` with these flags lives."""
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def build(*sources: Path) -> list[Path]:
    """Compile every source whose library is missing, in parallel."""
    libs = [library_path(s) for s in sources]
    jobs = []
    for src, lib in zip(sources, libs):
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(src)], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((src, lib, tmp, proc))
    failed = []
    for src, lib, tmp, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src.name}:\n{err}")
        else:
            os.replace(tmp, lib)     # atomic: a concurrent build never sees half
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


@functools.lru_cache(maxsize=None)
def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, built on first call."""
    return ctypes.CDLL(str(build(source)[0]))
