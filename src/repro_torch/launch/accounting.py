"""Parameter accounting: total vs active (MoE) non-embedding params.

Counterpart of ``repro/launch/accounting.py``, a plain copy over the port's
configs.
"""

from __future__ import annotations

from ..configs.base import ModelConfig

__all__ = ["param_counts"]


def _attn_params(cfg: ModelConfig, mixer: str) -> int:
    d, h, g, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.resolved_head_dim
    if mixer == "mla":
        m = cfg.mla
        qd = m.nope_head_dim + m.rope_head_dim
        return (
            d * m.q_lora_rank + m.q_lora_rank * h * qd
            + d * (m.kv_lora_rank + m.rope_head_dim)
            + m.kv_lora_rank * h * (m.nope_head_dim + m.v_head_dim)
            + h * m.v_head_dim * d
        )
    if mixer == "mamba":
        s = cfg.ssm
        di = s.expand * d
        nh = di // s.head_dim
        cd = di + 2 * s.n_groups * s.d_state
        dip = 2 * di + 2 * s.n_groups * s.d_state + nh
        return d * dip + s.d_conv * cd + di * d + di + cd + 3 * nh
    qkv = d * h * hd + 2 * d * g * hd + h * hd * d
    if mixer == "attn_x":           # self + cross
        return 2 * qkv
    return qkv                      # attn, attn_nc, xattn


def _mlp_params(cfg: ModelConfig, mlp: str) -> tuple[int, int]:
    """(total, active) params of one MLP."""
    d = cfg.d_model
    if mlp == "none":
        return 0, 0
    if mlp == "dense":
        n = (3 if cfg.act == "swiglu" else 2) * d * cfg.d_ff
        return n, n
    e = cfg.moe
    per_exp = 3 * d * e.d_ff_expert
    total = e.n_experts * per_exp + d * e.n_experts
    active = e.top_k * per_exp + d * e.n_experts
    if e.n_shared:
        shared = (3 if cfg.act == "swiglu" else 2) * d * (e.n_shared * e.d_ff_expert)
        total += shared
        active += shared
    return total, active


def param_counts(cfg: ModelConfig) -> dict:
    """{"total", "active", "embedding", "total_nonemb", "active_nonemb"}
    parameter counts (analytic)."""
    total = active = 0
    for stage in cfg.stages:
        for mixer, mlp in stage.layers:
            a = _attn_params(cfg, mixer)
            mt, ma = _mlp_params(cfg, mlp)
            total += stage.repeats * (a + mt + 2 * cfg.d_model)
            active += stage.repeats * (a + ma + 2 * cfg.d_model)
    if cfg.encoder is not None:
        enc = cfg.encoder.n_layers * (
            _attn_params(cfg, "attn_nc") + _mlp_params(cfg, "dense")[0]
            + 2 * cfg.d_model
        )
        total += enc
        active += enc
    emb = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    return {"total": total + emb, "active": active + emb, "embedding": emb,
            "total_nonemb": total, "active_nonemb": active}
