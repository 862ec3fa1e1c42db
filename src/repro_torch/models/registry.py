"""Model registry: arch id -> (config, ModelApi) (port of ``repro.models.registry``).

The port runs every arch of the JAX package's registry, for training and
serving: the paper's VQC; through the decoder the dense (tinyllama-1.1b,
olmo-1b, qwen3-0.6b, granite-34b), moe (deepseek-moe-16b,
qwen3-moe-235b-a22b), ssm (mamba2-130m) and hybrid (hymba-1.5b)
families; the encoder-decoder (whisper-tiny) and the VLM
(llama-3.2-vision-90b), whose ``prefill_cross`` fills the cross K/V
cache from the stubbed audio or image embeddings.
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
            "qwen3-moe-235b-a22b", "whisper-tiny", "llama-3.2-vision-90b"]


def _decoder_api() -> ModelApi:
    from repro_torch.models import decoder as M
    return ModelApi(M.init, M.forward, M.loss, M.init_cache, M.decode_step,
                    prefill=M.prefill)


def _encdec_api() -> ModelApi:
    from repro_torch.models import encdec as M
    return ModelApi(M.init, M.forward, M.loss, M.init_cache, M.decode_step,
                    M.prefill_cross, prefill=M.prefill)


def _vlm_api() -> ModelApi:
    from repro_torch.models import vlm as M
    return ModelApi(M.init, M.forward, M.loss, M.init_cache, M.decode_step,
                    M.prefill_cross, prefill=M.prefill)


_FAMILY_API = {
    "dense": _decoder_api,
    "moe": _decoder_api,
    "ssm": _decoder_api,
    "hybrid": _decoder_api,
    "encdec": _encdec_api,
    "vlm": _vlm_api,
}


def get_config(arch_id: str) -> ArchConfig:
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
    if family not in _FAMILY_API:
        raise ValueError(f"unknown family {family!r}")
    return _FAMILY_API[family]()


def list_archs() -> list[str]:
    return list(ARCH_IDS)
