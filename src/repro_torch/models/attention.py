"""Attention: rotary embeddings, direct softmax, blockwise attention, GQA
self-attention, MLA and cross-attention.

Counterpart of ``repro/models/attention.py``.  A prefill or training pass
(more than 4 query rows) runs blockwise, as the reference's
``chunked_attention`` does, in blocks of the config's ``attn_q_chunk`` x
``attn_kv_chunk``, skipping the fully masked causal blocks whatever
``causal_block_skip`` says (a knob of the reference's XLA scan; the skip
changes no bit).  On a CUDA tensor with the
kernel engine (``impl="kernel"``) GQA self-attention, the encoder's
``attn_nc`` layers and the cross-attention of the encoder-decoder's
``attn_x`` and of the VLM's gated ``xattn`` (those three with
``causal=False``, the last two at Sq != Skv) run kernel K7,
``kernels.flash_attention``: online-softmax attention over the KV cache
with the query offset and ``kv_len`` as runtime arguments, which is what
the reference's ``chunked_attention`` computes there (its module docstring
names the Pallas flash kernel as its deployment counterpart).  A training
pass takes K7 as ``FlashAttentionFn``, which ``flash_attention`` picks
itself where a gradient is wanted; its backward is the blockwise one over
the config's blocks.  On a CPU tensor, or with ``impl="plain"``, they run
:func:`chunked_attention` (``kernels.flash_attention.blockwise_attention``
in the reference's ``(B, S, H, hd)`` layout), whose forward and backward
hold O(S hd) a head, so a CPU trace or train step holds what the
reference's does.  A decode step (at most 4 query rows, the reference's
threshold) runs :func:`direct_attention` in plain torch, as the reference
does in jnp.

Under a sharded step each rank attends over its local batch rows and query
heads (``sharding.local_call``).  Where the model axis splits the query
heads but not GQA's KV heads, each rank narrows its replicated K and V to
the one group its heads read (``grouped``), as the reference repeats each
KV block to its local heads; where a rank's heads span two groups, the
heads are gathered.

MLA (DeepSeek-V3) runs in the reference's absorbed / MQA form: the latent
cache ``ckv`` plus the shared rope key is one KV head of width
``kv_lora_rank + rope_head_dim`` (576 at full width) and the values its
first ``kv_lora_rank`` (512) columns.  K7 is built for equal q and v widths,
and the reference runs this attention through its XLA paths, never its
Pallas kernel; so MLA's prefill and training attention is
:func:`chunked_attention` at those widths on every device (ROADMAP.md lists
a K7 instance for unequal widths), its decode the direct softmax.

Caches are fixed-capacity ``(B, Smax, G, hd)`` buffers (MLA's ``ckv`` and
``kpe``: ``(B, Smax, r)``).  Unlike the reference's functional
``dynamic_update_slice``, the port writes the new keys and values into the
buffer in place and returns it: a serving loop holds one cache per request,
and a copy per step would double its memory traffic.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..kernels.flash_attention import blockwise_attention, flash_attention
from .layers import rmsnorm
from .sharding import constrain, local_call, write_slice
from .spec import ParamSpec

__all__ = [
    "rope_cos_sin",
    "rope_rotate",
    "chunked_attention",
    "direct_attention",
    "attn_spec",
    "attn_apply",
    "mla_spec",
    "mla_apply",
    "xattn_spec",
    "xattn_kv",
    "xattn_apply",
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


def chunked_attention(
    q: torch.Tensor,                # (B, Sq, H, hd)
    k: torch.Tensor,                # (B, Skv, G, hd)
    v: torch.Tensor,                # (B, Skv, G, hd_v)
    *,
    causal: bool,
    q_offset: int = 0,              # absolute position of query row 0
    kv_len: int | None = None,      # number of valid kv entries
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    scale: float | None = None,
) -> torch.Tensor:
    """Online-softmax blockwise attention, (B, Sq, H, hd_v); f32 accumulators
    and O(Sq hd) memory, its backward too.

    The reference's ``chunked_attention`` (name, layout, chunks): query row i
    sits at ``q_offset + i`` (the reference's ``q_positions``, which the
    port's callers always give as a run from the cache index), and with
    ``causal`` each query block skips its fully masked KV blocks (the
    reference's static ``q_start``; the output bits are the same).
    ``kernels.flash_attention.blockwise_attention`` on the transposed
    views."""
    out = blockwise_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              causal=causal, scale=scale, q_offset=q_offset, kv_len=kv_len,
                              q_chunk=q_chunk, kv_chunk=kv_chunk)
    return out.transpose(1, 2)


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
    q = constrain(q, None, "batch", "seq", "heads", "head_dim")
    k = constrain(k, None, "batch", "seq", "kv_heads", "head_dim")

    if use_rope:
        cos, sin = rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)
        q = rope_rotate(q, cos, sin)
        k = rope_rotate(k, cos, sin)

    new_cache = None
    q_offset = 0
    if cache is not None:
        q_offset = int(cache_index)
        write_slice(cache["k"], k.to(cache["k"].dtype), 1, q_offset)
        write_slice(cache["v"], v.to(cache["v"].dtype), 1, q_offset)
        new_cache = cache
        k, v = cache["k"], cache["v"]
        kv_len = q_offset + s
    else:
        kv_len = s

    out = _attend(q, k, v, cfg, causal=causal, positions=positions, q_offset=q_offset,
                  kv_len=kv_len, impl=impl)
    return constrain(_out_proj(p, out, axo), None, "batch", "seq", "embed"), new_cache


def _attend(q, k, v, cfg: ModelConfig, *, causal: bool, positions, q_offset: int,
            kv_len: int, impl: str):
    """(B, Sq, H, hd) attention over (B, Skv, G, hd) keys and values: the
    direct softmax for a decode step (Sq <= 4), else K7 on a CUDA tensor
    with ``impl="kernel"`` (``FlashAttentionFn`` where a gradient is wanted,
    its backward over ``cfg``'s blocks), else :func:`chunked_attention`.
    Under a sharded step each rank runs its local batch rows and query heads
    against the KV group they read (module docstring)."""
    if q.shape[1] <= 4:  # decode path
        return direct_attention(q, k, v, causal=causal, q_positions=positions, kv_len=kv_len)
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len, q_chunk=cfg.attn_q_chunk,
              kv_chunk=cfg.attn_kv_chunk)
    rep = q.shape[2] // k.shape[2]
    if impl == "kernel" and q.device.type != "cpu":
        q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        out = local_call(flash_attention, [q, k, v], [(0, 1)] * 3, [(0, 1)],
                         grouped=[None, rep, rep], **kw)
        return out.transpose(1, 2)
    return local_call(chunked_attention, [q, k, v], [(0, 2)] * 3, [(0, 2)],
                      grouped=[None, rep, rep], **kw)


def _out_proj(p: dict, out: torch.Tensor, axo) -> torch.Tensor:
    """(B, S, H, hd) heads -> (B, S, d) through ``wo``, exact or on the operator."""
    out = out.reshape(*out.shape[:2], -1)
    if axo is not None and "wo" in axo[1]:
        return axo[0].apply(out, axo[1]["wo"])
    return out @ p["wo"].reshape(out.shape[-1], -1)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3 latent attention) -- absorbed / MQA-equivalent form
# ---------------------------------------------------------------------------


def mla_spec(cfg: ModelConfig) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qd = m.nope_head_dim + m.rope_head_dim
    return {
        "wq_a": ParamSpec((d, m.q_lora_rank), ("embed", "lora")),
        "q_norm": ParamSpec((m.q_lora_rank,), ("lora",), init="ones"),
        "wq_b": ParamSpec((m.q_lora_rank, h, qd), ("lora", "heads", "head_dim")),
        "wkv_a": ParamSpec((d, m.kv_lora_rank + m.rope_head_dim), ("embed", "lora")),
        "kv_norm": ParamSpec((m.kv_lora_rank,), ("lora",), init="ones"),
        "wkv_b": ParamSpec(
            (m.kv_lora_rank, h, m.nope_head_dim + m.v_head_dim),
            ("lora", "heads", "head_dim"),
        ),
        "wo": ParamSpec((h, m.v_head_dim, d), ("heads", "head_dim", "embed")),
    }


def mla_apply(
    p: dict,
    x: torch.Tensor,                      # (B, S, d)
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,              # (S,) absolute positions
    cache: dict | None = None,            # {'ckv': (B, Smax, r), 'kpe': (B, Smax, rope)}
    cache_index: int | None = None,
    axo=None,                             # (AxODeployment, layer mixer entries)
):
    """Absorbed-form MLA; returns (out, new_cache).

    The latent ``ckv`` (+ the shared rope key) is the whole KV: one shared
    "KV head" of width r + rope.  q_nope is absorbed through the K half of
    ``wkv_b``, so scores live in latent space, and the attention output (in
    latent space) is re-projected through its V half.  The softmax scale is
    that of the unabsorbed head width (nope + rope).  With ``axo`` the plain
    last-dim linears (wq_a, wq_b, wkv_a, wo) run on the approximate
    operator; ``wkv_b`` stays exact, as in the reference: its halves
    contract per head against latents, not as a (K, N) linear.  The
    attention is :func:`chunked_attention` at Sq > 4 and the direct
    softmax at a decode step (see the module docstring).
    """
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    nope = m.nope_head_dim
    ent = axo[1] if axo is not None else {}

    def lin(name, v):
        if name in ent:
            return axo[0].apply(v, ent[name])
        return v @ p[name]

    q = rmsnorm(lin("wq_a", x), p["q_norm"], cfg.norm_eps)
    if "wq_b" in ent:
        q = axo[0].apply(q, ent["wq_b"]).reshape(b, s, h, nope + m.rope_head_dim)
    else:
        q = _proj(q, p["wq_b"])
    q = constrain(q, None, "batch", "seq", "heads", "head_dim")
    q_nope, q_pe = q[..., :nope], q[..., nope:]

    kv = lin("wkv_a", x)
    ckv = rmsnorm(kv[..., :m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    kpe = kv[..., m.kv_lora_rank:][:, :, None, :]          # (B, S, 1, rope) shared head

    cos, sin = rope_cos_sin(positions, m.rope_head_dim, cfg.rope_theta)
    q_pe = rope_rotate(q_pe, cos, sin)
    kpe = rope_rotate(kpe, cos, sin)[:, :, 0, :]

    # absorb q_nope through wkv_b's K half: (B,S,H,nope) x (r,H,nope) -> (B,S,H,r)
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["wkv_b"][..., :nope])
    q_full = torch.cat([q_lat, q_pe], dim=-1)             # (B, S, H, r + rope)

    ci = 0
    if cache is not None:
        ci = int(cache_index)
        write_slice(cache["ckv"], ckv.to(cache["ckv"].dtype), 1, ci)
        write_slice(cache["kpe"], kpe.to(cache["kpe"].dtype), 1, ci)
        ckv, kpe = cache["ckv"], cache["kpe"]
        kv_len = ci + s
    else:
        kv_len = s

    # latent K and V: one shared head (MQA form)
    k_lat = torch.cat([ckv, kpe], dim=-1)[:, :, None, :]  # (B, Skv, 1, r + rope)
    v_lat = ckv[:, :, None, :]                            # (B, Skv, 1, r)
    scale = 1.0 / ((nope + m.rope_head_dim) ** 0.5)
    if s > 4:
        # under a sharded step each rank attends over its local batch rows and
        # query heads against the one shared latent head: DTensor cannot run
        # the heads-split products of the scores and the values, which
        # flatten (head, query) with the heads split
        lat = local_call(chunked_attention, [q_full, k_lat, v_lat],
                         [(0, 2), (0, None), (0, None)], [(0, 2)],
                         causal=True, q_offset=ci, kv_len=kv_len, scale=scale,
                         q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk)
    else:
        lat = direct_attention(q_full, k_lat, v_lat, causal=True, q_positions=positions,
                               kv_len=kv_len, scale=scale)
    # (B, S, H, r) in latent space -> through wkv_b's V half
    out = torch.einsum("bshr,rhk->bshk", lat, p["wkv_b"][..., nope:])
    return constrain(_out_proj(p, out, axo), None, "batch", "seq", "embed"), cache


# ---------------------------------------------------------------------------
# Cross-attention (whisper decoder / VLM image layers)
# ---------------------------------------------------------------------------


def xattn_spec(cfg: ModelConfig) -> dict:
    return {**attn_spec(cfg),
            "gate": ParamSpec((1,), (None,), init="zeros")}   # VLM-style tanh gate


def xattn_kv(p: dict, enc: torch.Tensor, axo=None):
    """Cross K/V, (B, S_enc, G, hd) each, from encoder or image states
    (computed at the prefill and cached for decode)."""
    b, s = enc.shape[:2]
    g, hd = p["wk"].shape[1], p["wk"].shape[2]
    if axo is not None and "wk" in axo[1]:
        dep, ent = axo
        return (dep.apply(enc, ent["wk"]).reshape(b, s, g, hd),
                dep.apply(enc, ent["wv"]).reshape(b, s, g, hd))
    return _proj(enc, p["wk"]), _proj(enc, p["wv"])


def xattn_apply(
    p: dict,
    x: torch.Tensor,                      # (B, S, d)
    cfg: ModelConfig,
    *,
    kv: tuple[torch.Tensor, torch.Tensor],   # (k, v) from xattn_kv or the cache
    gated: bool = False,
    axo=None,                             # (AxODeployment, layer mixer entries)
    impl: str = "kernel",                 # the attention engine: "kernel" (K7) | "plain"
) -> torch.Tensor:
    """Non-causal attention of ``x``'s queries over every encoder/image key:
    K7 (or :func:`chunked_attention`) with ``causal=False`` at the prefill
    (Sq != Skv), the direct softmax at a decode step.  ``gated`` scales the output by ``tanh(gate)`` (the VLM)."""
    b, s = x.shape[:2]
    h, hd = p["wq"].shape[1], p["wq"].shape[2]
    if axo is not None and "wq" in axo[1]:
        q = axo[0].apply(x, axo[1]["wq"]).reshape(b, s, h, hd)
    else:
        q = _proj(x, p["wq"])
    q = constrain(q, None, "batch", "seq", "heads", "head_dim")
    k, v = kv
    out = _attend(q, k, v, cfg, causal=False, positions=torch.arange(s, device=x.device),
                  q_offset=0, kv_len=k.shape[1], impl=impl)
    out = _out_proj(p, out, axo)
    if gated:
        out = torch.tanh(p["gate"].to(out.dtype)) * out
    return constrain(out, None, "batch", "seq", "embed")
