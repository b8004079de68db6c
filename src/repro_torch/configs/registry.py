"""Architecture registry: ``--arch <id>`` -> ``ModelConfig``.

Counterpart of ``repro/configs/registry.py``, cut to what the port runs on
one device: the dense stacks of ``granite-3-2b``, ``internlm2-1.8b``,
``starcoder2-3b`` and ``deepseek-67b``, the Mamba-2 stack of
``mamba2-130m`` and the MoE stack of ``kimi-k2-1t-a32b``.  The reference's
other archs (MLA, hybrid, encoder-decoder, VLM) and its sharding-rule and
input-spec helpers wait for ROADMAP.md queue 1 items 10 and 13; asking for
one of those archs raises.
"""

from __future__ import annotations

import importlib

from .base import ModelConfig

__all__ = ["ARCH_IDS", "get_arch"]

# arch id -> module name
ARCH_IDS = {
    "deepseek-67b": "deepseek_67b",
    "starcoder2-3b": "starcoder2_3b",
    "granite-3-2b": "granite_3_2b",
    "internlm2-1.8b": "internlm2_1_8b",
    "mamba2-130m": "mamba2_130m",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
}

# the reference's archs that the port does not run yet
NOT_PORTED = (
    "whisper-medium", "jamba-v0.1-52b", "deepseek-v3-671b", "llama-3.2-vision-90b",
)


def get_arch(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        what = "is not ported yet" if arch_id in NOT_PORTED else "is unknown"
        raise ValueError(
            f"arch {arch_id!r} {what}; the port runs {sorted(ARCH_IDS)} "
            "(the other model families are ROADMAP.md queue 1 item 10)"
        )
    mod = importlib.import_module(f".{ARCH_IDS[arch_id]}", package=__package__)
    return mod.CONFIG
