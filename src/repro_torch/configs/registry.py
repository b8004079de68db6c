"""Architecture registry: ``--arch <id>`` -> ``ModelConfig``.

Counterpart of ``repro/configs/registry.py``.  Every arch of the reference
is here: the dense stacks of ``granite-3-2b``, ``internlm2-1.8b``,
``starcoder2-3b`` and ``deepseek-67b``, the Mamba-2 stack of
``mamba2-130m``, the MoE stacks of ``kimi-k2-1t-a32b`` and
``deepseek-v3-671b`` (MLA), the hybrid ``jamba-v0.1-52b``, the
encoder-decoder ``whisper-medium`` and the VLM ``llama-3.2-vision-90b``.
:func:`rules_for` resolves the logical-to-mesh rule table of one (arch,
shape) cell, as the reference's does; the sharded train, prefill and decode
steps place their parameters, optimizer state, batch and cache by it
(``models.sharding``).  The cell grid's helpers are the reference's:
:func:`cell_status` (``long_500k`` runs only the :data:`SUBQUADRATIC`
archs), :func:`arch_for_shape` (the shape's ``max_seq`` and the causal
block-skip policy, which the port's kernels do not read and the cost probes
do) and :func:`input_specs`, the step's data inputs as ``meta`` tensors
(shape and dtype, no storage), which the dry-run (``launch.lowering``)
turns into fake tensors on its device.
"""

from __future__ import annotations

import importlib
from dataclasses import replace

import torch

from ..models.sharding import BASE_RULES, ShardingRules
from .base import SHAPES, ModelConfig, ShapeConfig

__all__ = ["ARCH_IDS", "SHAPES", "SUBQUADRATIC", "get_arch", "cell_status", "arch_for_shape",
           "rules_for", "input_specs"]

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

# archs with sub-quadratic decode state: the only ones that run long_500k
SUBQUADRATIC = {"mamba2-130m", "jamba-v0.1-52b"}


def get_arch(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        raise ValueError(f"arch {arch_id!r} is unknown; the port runs {sorted(ARCH_IDS)}")
    mod = importlib.import_module(f".{ARCH_IDS[arch_id]}", package=__package__)
    return mod.CONFIG


def cell_status(arch_id: str, shape_name: str) -> str:
    """'run' or a skip reason, per the assignment's shape/skip policy."""
    if shape_name == "long_500k" and arch_id not in SUBQUADRATIC:
        return ("skip: pure full-attention arch -- O(seq) per decoded token over a "
                "524288-token dense KV cache (assignment directs the skip)")
    return "run"


def arch_for_shape(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """The shape's config: ``max_seq`` at least the shape's sequence, and
    causal block skipping at prefill or from 16k tokens on (the reference's
    measured policy; the port's K7 and blockwise attention skip masked
    blocks whatever the flag says)."""
    skip = shape.kind == "prefill" or shape.seq_len >= 16384
    return replace(cfg, max_seq=max(shape.seq_len, cfg.max_seq), causal_block_skip=skip)


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


def input_specs(cfg: ModelConfig, shape: ShapeConfig, dtype=torch.bfloat16) -> dict:
    """The step's data inputs as ``meta`` tensors (shape and dtype, no storage).

    train   -> {"batch": {tokens, labels[, enc_embeds | img_embeds]}}
    prefill -> {"tokens"[, "enc_embeds" | "img_embeds"]}
    decode  -> {"tokens" (B, 1), "index" ()}   (the cache: ``launch.steps.abstract_cache``)

    Tokens, labels and the index are int32, as in the reference.
    """
    b, s = shape.global_batch, shape.seq_len
    d = cfg.d_model

    def sds(shp, dt=torch.int32):
        return torch.empty(shp, dtype=dt, device="meta")

    frontends = {}
    if cfg.encoder is not None:
        frontends["enc_embeds"] = sds((b, cfg.encoder.n_ctx, d), dtype)
    if cfg.n_img_tokens:
        frontends["img_embeds"] = sds((b, cfg.n_img_tokens, d), dtype)

    if shape.kind == "train":
        return {"batch": {"tokens": sds((b, s)), "labels": sds((b, s)), **frontends}}
    if shape.kind == "prefill":
        return {"tokens": sds((b, s)), **frontends}
    if shape.kind == "decode":
        return {"tokens": sds((b, 1)), "index": sds(())}
    raise ValueError(f"unknown shape kind {shape.kind!r}")
