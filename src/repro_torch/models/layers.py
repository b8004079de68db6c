"""Shared neural layers: norms, dense/gated MLPs, embeddings.

Counterpart of ``repro/models/layers.py``; the rotary helpers the attention
layer uses are ``attention.rope_cos_sin`` / ``rope_rotate``, where the
reference keeps them too.  Functions take and return tensors in the
reference's layouts.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .spec import ParamSpec

__all__ = [
    "rmsnorm",
    "sinusoid_pos",
    "mlp_spec",
    "mlp_apply",
    "embed_spec",
]


def sinusoid_pos(positions: torch.Tensor, d_model: int, base: float = 10_000.0) -> torch.Tensor:
    """Transformer sinusoidal absolute position embeddings: (S,) -> (S, d) f32."""
    half = d_model // 2
    ar = torch.arange(half, dtype=torch.float32, device=positions.device)
    freq = torch.exp(-math.log(base) * ar / max(half - 1, 1))
    ang = positions[:, None].to(torch.float32) * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(torch.float32)
    scale = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * scale).to(x.dtype) * gamma


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_spec(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == "swiglu":
        return {
            "w_gate": ParamSpec((d, f), ("embed", "mlp")),
            "w_up": ParamSpec((d, f), ("embed", "mlp")),
            "w_down": ParamSpec((f, d), ("mlp", "embed")),
        }
    return {
        "w_up": ParamSpec((d, f), ("embed", "mlp")),
        "w_down": ParamSpec((f, d), ("mlp", "embed")),
    }


def mlp_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, axo=None) -> torch.Tensor:
    """Dense FFN.  ``axo`` = (AxODeployment, entries) runs each named
    projection through the approximate operator on the cached weight codes
    (activations are quantized per call)."""
    ent = axo[1] if axo is not None else {}

    def lin(name, v):
        if name in ent:
            return axo[0].apply(v, ent[name])
        return v @ p[name]

    if cfg.act == "swiglu":
        h = F.silu(lin("w_gate", x)) * lin("w_up", x)
    else:
        h = F.gelu(lin("w_up", x), approximate="tanh")   # jax.nn.gelu's default
    return lin("w_down", h)


def embed_spec(cfg: ModelConfig) -> dict:
    out = {"tok": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"), scale=1.0)}
    if not cfg.tie_embeddings:
        out["unembed"] = ParamSpec((cfg.d_model, cfg.vocab), ("embed", "vocab"))
    return out
