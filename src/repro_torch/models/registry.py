"""Model registry: arch id -> (config, ModelApi) (port of ``repro.models.registry``).

The port serves the paper's VQC and, through the decoder, the hybrid
``hymba-1.5b``; every other arch id of the JAX package raises
``NotImplementedError`` until the rest of the LLM client zoo is ported.
"""
from __future__ import annotations

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


ARCH_IDS = ["vqc-satqfl", "hymba-1.5b"]

_NOT_PORTED = ("this part of the LLM client zoo is not ported yet (ROADMAP "
               "queue 1, item 11); the port serves " + ", ".join(
                   repr(a) for a in ARCH_IDS))


def _decoder_api() -> ModelApi:
    from repro_torch.models import decoder as M
    return ModelApi(M.init, M.forward, M.loss, M.init_cache, M.decode_step,
                    prefill=M.prefill)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id == "vqc-satqfl":
        from repro_torch.configs.vqc_satqfl import CONFIG
        return CONFIG
    if arch_id == "hymba-1.5b":
        from repro_torch.configs.hymba_1_5b import CONFIG
        return CONFIG
    raise NotImplementedError(f"{arch_id!r}: {_NOT_PORTED}")


def get_model(cfg_or_id) -> ModelApi:
    if isinstance(cfg_or_id, str):
        cfg_or_id = get_config(cfg_or_id)
    if cfg_or_id.family == "vqc":
        from repro_torch.quantum.vqc import vqc_api
        return vqc_api()
    if cfg_or_id.family == "hybrid":
        return _decoder_api()
    raise NotImplementedError(f"family {cfg_or_id.family!r}: {_NOT_PORTED}")


def list_archs() -> list[str]:
    return list(ARCH_IDS)
