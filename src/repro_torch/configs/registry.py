"""Architecture registry: ``--arch <id>`` -> ``ModelConfig``.

Counterpart of ``repro/configs/registry.py``.  Every arch of the reference
is here: the dense stacks of ``granite-3-2b``, ``internlm2-1.8b``,
``starcoder2-3b`` and ``deepseek-67b``, the Mamba-2 stack of
``mamba2-130m``, the MoE stacks of ``kimi-k2-1t-a32b`` and
``deepseek-v3-671b`` (MLA), the hybrid ``jamba-v0.1-52b``, the
encoder-decoder ``whisper-medium`` and the VLM ``llama-3.2-vision-90b``.
:func:`rules_for` resolves the logical-to-mesh rule table of one (arch,
shape) cell, as the reference's does; the sharded train step places its
parameters and optimizer state by it (``models.sharding``).  The reference's input-spec helpers feed its
dry-run, which the port does not have yet.
"""

from __future__ import annotations

import importlib

from ..models.sharding import BASE_RULES, ShardingRules
from .base import SHAPES, ModelConfig, ShapeConfig

__all__ = ["ARCH_IDS", "SHAPES", "get_arch", "rules_for"]

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


def rules_for(cfg: ModelConfig, shape: ShapeConfig, mesh_model: int = 16,
              mesh_data: int = 16) -> ShardingRules:
    """The logical->mesh rule table of one (arch, shape) cell (the reference's)."""
    rules = BASE_RULES
    if cfg.use_fsdp:
        rules = rules.with_fsdp()
    param: dict = {}
    act: dict = {}

    # tensor parallelism only over dims the mesh divides evenly
    if not cfg.shard_heads or cfg.n_heads % mesh_model:
        param["heads"] = ()
        act["heads"] = ()
    if cfg.kv_heads % mesh_model:
        param["kv_heads"] = ()
    if cfg.d_ff and cfg.d_ff % mesh_model:
        param["mlp"] = ()
        act["mlp"] = ()
    if cfg.vocab % mesh_model:
        param["vocab"] = ()
        act["vocab"] = ()
    if not cfg.shard_ssm:
        param["ssm_inner"] = ()
        act["ssm_inner"] = ()
        act["ssm_heads"] = ()

    # Megatron-style sequence parallelism on the residual stream at
    # train/prefill
    if shape.kind in ("train", "prefill") and shape.seq_len % mesh_model == 0:
        act["res_seq"] = ("model",)

    # decode: KV caches shard their sequence dim (batch 1 also over data);
    # heads are replicated, so attention reduces over the sharded sequence
    if shape.kind == "decode":
        act["kv_seq"] = ("data", "model") if shape.global_batch == 1 else ("model",)
        act["kv_enc"] = ("model",)
        act["heads"] = ()

    return rules.with_overrides(param=param, act=act)
