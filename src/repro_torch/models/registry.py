"""Model registry: arch id -> (config, ModelApi) (port of ``repro.models.registry``).

The port runs the paper's VQC and, through the decoder, the dense
(tinyllama-1.1b, olmo-1b, qwen3-0.6b, granite-34b), moe (deepseek-moe-16b,
qwen3-moe-235b-a22b), ssm (mamba2-130m) and hybrid (hymba-1.5b)
families, for training and serving. The encdec and vlm archs (ROADMAP
queue 1, item 11c) raise ``NotImplementedError`` until they are ported.
"""
from __future__ import annotations

import importlib
from typing import Callable, NamedTuple

from repro_torch.models.config import ArchConfig


class ModelApi(NamedTuple):
    init: Callable            # (cfg, key) -> params
    forward: Callable         # (cfg, params, batch, ctx=None) -> (logits, aux)
    loss: Callable            # (cfg, params, batch, ctx=None) -> loss
    init_cache: Callable      # (cfg, batch, cache_len) -> cache
    decode_step: Callable     # (cfg, params, cache, batch, ctx=None) -> ...
    prefill_cross: Callable | None = None
    shift_grad: Callable | None = None     # parameter-shift gradient rule
    prefill: Callable | None = None        # (cfg, params, batch, ctx=None)
                                           # -> next-token logits (B, Vp)
    client_axis_loss: bool = False         # loss takes the client axis
                                           # (core/gradients.py)


ARCH_IDS = ["vqc-satqfl", "hymba-1.5b", "tinyllama-1.1b", "olmo-1b",
            "qwen3-0.6b", "granite-34b", "mamba2-130m", "deepseek-moe-16b",
            "qwen3-moe-235b-a22b"]

#: the JAX package's arch ids the port has not ported yet, by ROADMAP item
_NOT_PORTED = {"whisper-tiny": "11c", "llama-3.2-vision-90b": "11c"}
_FAMILY_ITEM = {"encdec": "11c", "vlm": "11c"}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1, item {item}); the port "
        f"runs " + ", ".join(repr(a) for a in ARCH_IDS))


def _decoder_api() -> ModelApi:
    from repro_torch.models import decoder as M
    return ModelApi(M.init, M.forward, M.loss, M.init_cache, M.decode_step,
                    prefill=M.prefill)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id in _NOT_PORTED:
        raise _not_ported(repr(arch_id), _NOT_PORTED[arch_id])
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}")
    mod = importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))
    return mod.CONFIG


def get_model(cfg_or_id) -> ModelApi:
    if isinstance(cfg_or_id, str):
        cfg_or_id = get_config(cfg_or_id)
    family = cfg_or_id.family
    if family == "vqc":
        from repro_torch.quantum.vqc import vqc_api
        return vqc_api()
    if family in ("dense", "moe", "ssm", "hybrid"):
        return _decoder_api()
    if family in _FAMILY_ITEM:
        raise _not_ported(f"family {family!r}", _FAMILY_ITEM[family])
    raise ValueError(f"unknown family {family!r}")


def list_archs() -> list[str]:
    return list(ARCH_IDS)
