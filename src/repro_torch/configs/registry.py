"""Architecture registry: ``--arch <id>`` -> ``ModelConfig``.

Counterpart of ``repro/configs/registry.py``, cut to what the port runs on
one device.  Every arch of the reference is here: the dense stacks of
``granite-3-2b``, ``internlm2-1.8b``, ``starcoder2-3b`` and
``deepseek-67b``, the Mamba-2 stack of ``mamba2-130m``, the MoE stacks of
``kimi-k2-1t-a32b`` and ``deepseek-v3-671b`` (MLA), the hybrid
``jamba-v0.1-52b``, the encoder-decoder ``whisper-medium`` and the VLM
``llama-3.2-vision-90b``.  The reference's sharding-rule and input-spec
helpers wait for ROADMAP.md queue 1 item 13.
"""

from __future__ import annotations

import importlib

from .base import ModelConfig

__all__ = ["ARCH_IDS", "get_arch"]

# arch id -> module name
ARCH_IDS = {
    "whisper-medium": "whisper_medium",
    "deepseek-67b": "deepseek_67b",
    "starcoder2-3b": "starcoder2_3b",
    "granite-3-2b": "granite_3_2b",
    "internlm2-1.8b": "internlm2_1_8b",
    "mamba2-130m": "mamba2_130m",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
}

# the reference's archs that the port does not run yet: none
NOT_PORTED = ()


def get_arch(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        raise ValueError(f"arch {arch_id!r} is unknown; the port runs {sorted(ARCH_IDS)}")
    mod = importlib.import_module(f".{ARCH_IDS[arch_id]}", package=__package__)
    return mod.CONFIG
