"""Attention: rotary embeddings, direct softmax for decode, GQA self-attention.

Counterpart of ``repro/models/attention.py``, dense GQA path only.  A prefill
or training pass (more than 4 query rows) runs kernel K7,
``kernels.flash_attention``: causal online-softmax attention over the KV
cache with the query offset and ``kv_len`` as runtime arguments, which is
what the reference's XLA ``chunked_attention`` computes there (its module
docstring names the Pallas flash kernel as its deployment counterpart).  A
decode step (at most 4 query rows, the reference's threshold) runs
:func:`direct_attention` in plain torch, as the reference does in jnp.

Caches are fixed-capacity ``(B, Smax, G, hd)`` buffers.  Unlike the
reference's functional ``dynamic_update_slice``, the port writes the new keys
and values into the buffer in place and returns it: a serving loop holds one
cache per request, and a copy per step would double its memory traffic.

MLA, cross-attention and the encoder-decoder's ``attn_x`` are not ported
(ROADMAP.md queue 1 item 10); ``models.model`` raises on those mixers.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..kernels.flash_attention import flash_attention, flash_attention_plain
from .spec import ParamSpec

__all__ = [
    "rope_cos_sin",
    "rope_rotate",
    "direct_attention",
    "attn_spec",
    "attn_apply",
]

NEG_INF = -1e30


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (..., S) int -> cos, sin (..., S, head_dim//2) f32."""
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
    inv = 1.0 / (theta ** (ar / head_dim))
    ang = positions[..., None].to(torch.float32) * inv
    return torch.cos(ang), torch.sin(ang)


def rope_rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, hd); cos/sin (..., S, hd//2)."""
    hd = x.shape[-1]
    c = cos[..., None, :]
    s = sin[..., None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def direct_attention(
    q: torch.Tensor,                # (B, Sq, H, hd) -- decode: Sq small
    k: torch.Tensor,                # (B, Skv, G, hd)
    v: torch.Tensor,
    *,
    causal: bool,
    q_positions: torch.Tensor,      # (Sq,) absolute positions
    kv_len: int,
    scale: float | None = None,
) -> torch.Tensor:
    """Direct softmax attention over the whole KV; the decode path (Sq tiny).

    Queries stay in grouped ``(g, rep)`` form, so the KV is never repeated.
    Scores and the weighted sum run in f32 on the inputs' values (the
    reference's ``preferred_element_type=f32``); the softmax weights are
    rounded to the value type first, as the reference does.
    """
    b, sq, h, hd = q.shape
    g = k.shape[2]
    rep = h // g
    scale = (1.0 / (hd ** 0.5)) if scale is None else scale
    qg = q.reshape(b, sq, g, rep, hd).to(torch.float32)
    s = torch.einsum("bqgrk,bsgk->bgrqs", qg, k.to(torch.float32)) * scale
    kv_pos = torch.arange(k.shape[1], device=q.device)
    valid = (kv_pos < kv_len)[None, :]
    if causal:
        valid = valid & (q_positions[:, None] >= kv_pos[None, :])
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype).to(torch.float32)
    out = torch.einsum("bgrqs,bsgk->bqgrk", p, v.to(torch.float32))
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA self-attention layer
# ---------------------------------------------------------------------------


def attn_spec(cfg: ModelConfig) -> dict:
    d, h, g, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.resolved_head_dim
    return {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, g, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, g, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed")),
    }


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) @ (d, *tail) -> (B, S, *tail)."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:2], *w.shape[1:])


def attn_apply(
    p: dict,
    x: torch.Tensor,                      # (B, S, d)
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,              # (S,) absolute positions
    causal: bool = True,
    use_rope: bool = True,
    cache: dict | None = None,            # {'k','v'}: (B, Smax, G, hd), written in place
    cache_index: int | None = None,
    axo=None,                             # (AxODeployment, layer mixer entries)
    impl: str = "kernel",                 # the attention engine: "kernel" (K7) | "plain"
):
    """Returns (out, new_cache).

    ``axo`` routes the q/k/v/o projections through the approximate operator
    (scores and softmax stay exact: AxO replaces multipliers, i.e. matmuls).
    """
    b, s = x.shape[:2]
    h, hd = p["wq"].shape[1], p["wq"].shape[2]
    g = p["wk"].shape[1]
    if axo is not None and "wq" in axo[1]:
        dep, ent = axo
        q = dep.apply(x, ent["wq"]).reshape(b, s, h, hd)
        k = dep.apply(x, ent["wk"]).reshape(b, s, g, hd)
        v = dep.apply(x, ent["wv"]).reshape(b, s, g, hd)
    else:
        q = _proj(x, p["wq"])
        k = _proj(x, p["wk"])
        v = _proj(x, p["wv"])

    if use_rope:
        cos, sin = rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)
        q = rope_rotate(q, cos, sin)
        k = rope_rotate(k, cos, sin)

    new_cache = None
    q_offset = 0
    if cache is not None:
        q_offset = int(cache_index)
        cache["k"][:, q_offset:q_offset + s] = k.to(cache["k"].dtype)
        cache["v"][:, q_offset:q_offset + s] = v.to(cache["v"].dtype)
        new_cache = cache
        k, v = cache["k"], cache["v"]
        kv_len = q_offset + s
    else:
        kv_len = s

    if s <= 4:  # decode path
        out = direct_attention(q, k, v, causal=causal, q_positions=positions, kv_len=kv_len)
    else:
        fn = flash_attention if impl == "kernel" else flash_attention_plain
        out = fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal,
                 q_offset=q_offset, kv_len=kv_len).transpose(1, 2)
    out = out.reshape(b, s, h * hd)
    if axo is not None and "wo" in axo[1]:
        out = axo[0].apply(out, axo[1]["wo"])
    else:
        out = out @ p["wo"].reshape(h * hd, -1)
    return out, new_cache
