"""Model assembly: spec trees, caches, forward (train / prefill / decode).

Counterpart of ``repro/models/model.py``.  A model is ``embed -> stages ->
final norm -> unembed``; a stage repeats a super-block of ``(mixer, mlp)``
layers ``repeats`` times.  Parameters and caches keep the reference's tree:
each leaf of a stage is stacked over ``repeats``, and the forward pass takes
layer r's slice of every leaf in a Python loop where the reference scans.
Every family of the reference runs:

  dense    [(attn, dense)]      granite-3-2b, internlm2-1.8b, starcoder2-3b,
                                deepseek-67b
  moe      [(attn|mla, moe)]    kimi-k2-1t-a32b; deepseek-v3-671b (MLA, after
                                a leading dense stage; its MTP leaves are in
                                the tree)
  ssm      [(mamba, none)]      mamba2-130m
  hybrid   jamba-v0.1-52b's 8-layer block: 7 mamba + 1 attn, dense and moe
           MLPs alternating
  encdec   whisper-medium: an encoder stage of (attn_nc, dense) over stub
           frame embeddings + a decoder of (attn_x, dense)
  vlm      llama-3.2-vision-90b's 5-layer block: 4 (attn, dense) + 1 gated
           (xattn, dense) over stub patch embeddings

The modality frontends are stubs, as in the reference: ``forward`` takes
precomputed ``enc_embeds`` (whisper) or ``img_embeds`` (the VLM).  The MTP
head's leaves are used only by the training loss, :func:`compute_loss`.
``forward`` returns the sum of the MoE layers' router aux losses, as the
reference's does.

A training pass (``mode="train"``) writes no cache.  It hands layer r the
r-th piece of each stacked leaf, unbound once a stage (``unbind``'s backward
is one ``stack``; taking ``leaf[r]`` a layer would make its backward
allocate a zero tensor of the whole stacked leaf for every layer), and, when
``cfg.remat``, recomputes each repeat of a stage's super-block in the
backward (``torch.utils.checkpoint``, non-reentrant), as the reference wraps
its scan body in ``jax.checkpoint``: under remat every K7 and K8 forward of
a training step runs twice.

``forward`` takes an optional ``ExecutionContext`` whose ``attention`` menu
picks kernel K7 or its plain version for prefill attention (self, encoder
and cross), and whose ``ssd_scan`` menu picks kernel K8 or its plain version
for the Mamba-2 prefill scan; an ``AxODeployment`` carries its own context
for the AxO projections (K6).
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig, StageConfig
from .attention import (
    attn_apply,
    attn_spec,
    mla_apply,
    mla_spec,
    xattn_apply,
    xattn_kv,
    xattn_spec,
)
from .layers import embed_spec, mlp_apply, mlp_spec, rmsnorm, sinusoid_pos
from .sharding import assign, constrain, gather_dims, local_call
from .moe import moe_apply, moe_spec
from .spec import ParamSpec, stacked
from .ssm import mamba_apply, mamba_decode, mamba_dims, mamba_spec

__all__ = [
    "model_spec",
    "cache_spec",
    "forward",
    "logits_fn",
    "compute_loss",
    "HAS_CACHE",
]

# Which mixer kinds carry decode state.
HAS_CACHE = {"attn": True, "attn_x": True, "xattn": True, "mla": True,
             "mamba": True, "attn_nc": False}
MLPS = ("dense", "moe", "none")


def _check_config(cfg: ModelConfig) -> None:
    for stage in cfg.stages:
        for mixer, mlp in stage.layers:
            if mixer not in HAS_CACHE:
                raise ValueError(f"{cfg.name}: unknown mixer {mixer!r}")
            if mlp not in MLPS:
                raise ValueError(f"{cfg.name}: unknown mlp {mlp!r}")


def _encoder_stage(cfg: ModelConfig) -> StageConfig:
    return StageConfig(repeats=cfg.encoder.n_layers, layers=(("attn_nc", "dense"),))


# ---------------------------------------------------------------------------
# Param spec tree
# ---------------------------------------------------------------------------


def _mixer_spec(cfg: ModelConfig, mixer: str) -> dict:
    if mixer == "attn_x":                      # whisper decoder: self + cross
        return {
            "self": attn_spec(cfg),
            "cross": xattn_spec(cfg),
            "norm_x": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        }
    if mixer == "xattn":
        return xattn_spec(cfg)
    if mixer == "mla":
        return mla_spec(cfg)
    if mixer == "mamba":
        return mamba_spec(cfg)
    return attn_spec(cfg)                      # attn, attn_nc


def _layer_spec(cfg: ModelConfig, mixer: str, mlp: str) -> dict:
    out = {
        "norm1": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "mixer": _mixer_spec(cfg, mixer),
    }
    if mlp != "none":
        out["norm2"] = ParamSpec((cfg.d_model,), ("embed",), init="ones")
        out["mlp"] = moe_spec(cfg) if mlp == "moe" else mlp_spec(cfg)
    return out


def _stack_tree(tree, n: int):
    if isinstance(tree, dict):
        return {k: _stack_tree(v, n) for k, v in tree.items()}
    return stacked(tree, n)


def _stage_spec(cfg: ModelConfig, stage: StageConfig) -> dict:
    block = {str(i): _layer_spec(cfg, mixer, mlp) for i, (mixer, mlp) in enumerate(stage.layers)}
    return _stack_tree(block, stage.repeats)


def model_spec(cfg: ModelConfig) -> dict:
    _check_config(cfg)
    out = {
        "embed": embed_spec(cfg),
        "stages": {str(i): _stage_spec(cfg, s) for i, s in enumerate(cfg.stages)},
        "norm_f": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
    }
    if cfg.encoder is not None:
        out["encoder"] = {
            "stage": _stage_spec(cfg, _encoder_stage(cfg)),
            "norm_f": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        }
    if cfg.mtp:
        d = cfg.d_model
        out["mtp"] = {
            "norm_h": ParamSpec((d,), ("embed",), init="ones"),
            "norm_e": ParamSpec((d,), ("embed",), init="ones"),
            "proj": ParamSpec((2 * d, d), (None, "embed")),
        }
    return out


# ---------------------------------------------------------------------------
# Cache spec tree
# ---------------------------------------------------------------------------


def _layer_cache_spec(cfg: ModelConfig, mixer: str, batch: int, max_seq: int,
                      enc_len: int) -> dict:
    if mixer == "mamba":
        s = cfg.ssm
        dims = mamba_dims(cfg)
        return {
            "conv": ParamSpec((batch, s.d_conv - 1, dims["conv_dim"]),
                              ("batch", None, "ssm_inner"), init="zeros"),
            "state": ParamSpec(
                (batch, dims["n_heads"], s.head_dim, s.d_state),
                ("batch", "ssm_heads", None, None), init="zeros", dtype="float32",
            ),
        }
    if mixer == "mla":
        m = cfg.mla
        return {
            "ckv": ParamSpec((batch, max_seq, m.kv_lora_rank),
                             ("batch", "kv_seq", "lora"), init="zeros"),
            "kpe": ParamSpec((batch, max_seq, m.rope_head_dim),
                             ("batch", "kv_seq", None), init="zeros"),
        }
    g, hd = cfg.kv_heads, cfg.resolved_head_dim
    kv_axes = ("batch", "kv_seq", "kv_heads", "head_dim")
    enc_axes = ("batch", "kv_enc", "kv_heads", "head_dim")
    out = {}
    if mixer in ("attn", "attn_x"):
        out["k"] = ParamSpec((batch, max_seq, g, hd), kv_axes, init="zeros")
        out["v"] = ParamSpec((batch, max_seq, g, hd), kv_axes, init="zeros")
    if mixer in ("attn_x", "xattn"):
        out["xk"] = ParamSpec((batch, enc_len, g, hd), enc_axes, init="zeros")
        out["xv"] = ParamSpec((batch, enc_len, g, hd), enc_axes, init="zeros")
    return out


def cache_spec(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """Spec tree for the decode cache (same nesting as the param stages tree).

    A mamba layer's ``state`` leaf is f32 whatever the tree's dtype; the
    cross-attention's ``xk``/``xv`` hold ``enc_len`` rows, the encoder's
    frames or the image tokens."""
    _check_config(cfg)
    enc_len = cfg.encoder.n_ctx if cfg.encoder is not None else cfg.n_img_tokens
    out = {}
    for si, stage in enumerate(cfg.stages):
        blk = {str(i): _layer_cache_spec(cfg, mixer, batch, max_seq, enc_len)
               for i, (mixer, _) in enumerate(stage.layers) if HAS_CACHE[mixer]}
        out[str(si)] = _stack_tree(blk, stage.repeats)
    return out


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------


def _at(tree, r: int):
    """Layer ``r``'s slice of every leaf of a stacked tree (views, no copies),
    or its piece of an unbound one (:func:`_unbind`)."""
    if isinstance(tree, dict):
        return {k: _at(v, r) for k, v in tree.items()}
    return tree[r]


def _unbind(tree):
    """Every leaf of a stacked tree unbound into its layers' pieces."""
    if isinstance(tree, dict):
        return {k: _unbind(v) for k, v in tree.items()}
    return tree.unbind(0)


def _mamba(p: dict, h: torch.Tensor, cfg: ModelConfig, ctx: dict, cache: dict | None):
    """The mamba mixer; its cache ``{conv, state}`` is written in place."""
    if ctx["mode"] == "decode":
        out, (conv, state) = mamba_decode(p, h, cfg, cache["conv"], cache["state"])
    else:
        out, (conv, state) = mamba_apply(p, h, cfg, impl=ctx["ssd_impl"])
    if cache is not None:
        assign(cache["conv"], conv)
        assign(cache["state"], state)
    return out, cache


def _cross_kv(p: dict, ctx: dict, cache: dict | None, axo):
    """Cross K/V: from the encoder/image states at the prefill (written into
    the cache's ``xk``/``xv``), else the cached ones."""
    if ctx["enc_out"] is None:
        if cache is None:
            raise ValueError("cross-attention needs enc_embeds / img_embeds or a filled cache")
        return cache["xk"], cache["xv"]
    kv = xattn_kv(p, ctx["enc_out"], axo=axo)
    if cache is not None:
        assign(cache["xk"], kv[0])
        assign(cache["xv"], kv[1])
    return kv


def _full_seq(h: torch.Tensor) -> torch.Tensor:
    """A block's input with its sequence whole.  Under Megatron sequence
    parallelism (the ``res_seq`` rule at train and prefill) the residual
    stream is split over the sequence between blocks; each block's
    projections take the whole sequence, as Megatron all-gathers it before
    a column-parallel linear (DTensor in some PyTorch releases cannot
    flatten a sequence-split (batch, seq) for a matmul).  A no-op on a
    plain tensor or an unsplit sequence."""
    return gather_dims(h, 1)


class _WholeSeqGrad(torch.autograd.Function):
    """Identity whose backward gathers the gradient's sequence dim: a block's
    output joins a sequence-split residual stream, so its gradient comes
    back split over the sequence, and the projection that made it takes
    the whole sequence (Megatron's all-gather before a row-parallel
    linear's backward; see :func:`_full_seq`)."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return gather_dims(g, 1)


def _block_out(out: torch.Tensor) -> torch.Tensor:
    """A block's output, about to join the residual stream."""
    from torch.distributed.tensor import DTensor

    return _WholeSeqGrad.apply(out) if isinstance(out, DTensor) and out.requires_grad \
        else out


def _apply_layer(mixer: str, mlp: str, p: dict, x: torch.Tensor, cfg: ModelConfig,
                 ctx: dict, cache: dict | None, axo_layer: dict | None = None):
    """Pre-norm residual layer.  Returns (x, aux, new_cache).

    ``axo_layer`` is this layer's entry dict from an ``AxODeployment``
    (``ctx["axo"]``): its named projections run through the approximate
    operator instead of exact matmuls.  A mamba mixer has no entries (the
    reference's ``deploy_axo`` gives it none); its MLP has.  The cache is
    written in place: an attention layer's KV rows, MLA's latent rows, the
    cross K/V at the prefill, and a mamba layer's conv tail and f32 SSD state
    (by prefill from the whole prompt, by decode one step on).  ``aux`` is a
    moe layer's router aux loss, ``None`` for other layers.
    """
    dep = ctx["axo"]

    def ax(part, sub=None):
        ent = axo_layer.get(part) if dep is not None and axo_layer else None
        if ent is not None and sub is not None:
            ent = ent.get(sub)
        return None if ent is None else (dep, ent)

    h = _full_seq(rmsnorm(x, p["norm1"], cfg.norm_eps))
    use_rope = cfg.pos_encoding == "rope"
    attn_kw = dict(positions=ctx["positions"], cache_index=ctx["cache_index"],
                   impl=ctx["attn_impl"])
    if mixer == "mamba":
        out, new_cache = _mamba(p["mixer"], h, cfg, ctx, cache)
    elif mixer in ("attn", "attn_nc"):
        out, new_cache = attn_apply(
            p["mixer"], h, cfg, causal=(mixer == "attn"), use_rope=use_rope and mixer == "attn",
            cache=cache if mixer == "attn" else None, axo=ax("mixer"), **attn_kw)
    elif mixer == "attn_x":
        self_cache = None if cache is None else {"k": cache["k"], "v": cache["v"]}
        out, _ = attn_apply(p["mixer"]["self"], h, cfg, causal=True, use_rope=use_rope,
                            cache=self_cache, axo=ax("mixer", "self"), **attn_kw)
        x = x + _block_out(out)
        h = _full_seq(rmsnorm(x, p["mixer"]["norm_x"], cfg.norm_eps))
        cross = ax("mixer", "cross")
        kv = _cross_kv(p["mixer"]["cross"], ctx, cache, cross)
        out = xattn_apply(p["mixer"]["cross"], h, cfg, kv=kv, axo=cross,
                          impl=ctx["attn_impl"])
        new_cache = cache
    elif mixer == "xattn":
        kv = _cross_kv(p["mixer"], ctx, cache, ax("mixer"))
        out = xattn_apply(p["mixer"], h, cfg, kv=kv, gated=True, axo=ax("mixer"),
                          impl=ctx["attn_impl"])
        new_cache = cache
    elif mixer == "mla":
        out, new_cache = mla_apply(p["mixer"], h, cfg, positions=ctx["positions"], cache=cache,
                                   cache_index=ctx["cache_index"], axo=ax("mixer"))
    else:
        raise ValueError(f"unknown mixer {mixer!r}")
    x = x + _block_out(out)
    aux = None
    if mlp != "none":
        h = _full_seq(rmsnorm(x, p["norm2"], cfg.norm_eps))
        if mlp == "moe":
            out, aux = moe_apply(p["mlp"], h, cfg, axo=ax("mlp"))
        else:
            out = mlp_apply(p["mlp"], h, cfg, axo=ax("mlp"))
        x = x + _block_out(out)
    x = constrain(x, None, "batch", "res_seq", "embed")
    return x, aux, new_cache


def _run_stage(sp: dict, stage: StageConfig, x: torch.Tensor, cfg: ModelConfig, ctx: dict,
               sc: dict, sa: dict):
    """The stage's super-block over its ``repeats``; returns (x, summed aux or None).

    ``sp``, ``sc`` and ``sa`` are the stage's parameters, cache and AxO
    entries, each stacked over ``repeats``.  A training pass unbinds the
    parameters once and, under ``cfg.remat``, checkpoints each repeat."""
    train = ctx["mode"] == "train"

    def block(x, p_blk, c_blk, a_blk):
        aux = None
        for li, (mixer, mlp) in enumerate(stage.layers):
            key = str(li)
            x, da, _ = _apply_layer(mixer, mlp, p_blk[key], x, cfg, ctx, c_blk.get(key),
                                    axo_layer=a_blk.get(key))
            if da is not None:
                aux = da if aux is None else aux + da
        return x, aux

    layers = _unbind(sp) if train else sp
    aux = None
    for r in range(stage.repeats):
        args = (x, _at(layers, r), _at(sc, r), _at(sa, r))
        if train and cfg.remat:
            x, da = checkpoint(block, *args, use_reentrant=False)
        else:
            x, da = block(*args)
        if da is not None:
            aux = da if aux is None else aux + da
    return x, aux


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _encode(params: dict, cfg: ModelConfig, enc_embeds: torch.Tensor, ctx: dict, axo=None):
    """Whisper-style encoder over precomputed frame embeddings (stub frontend):
    ``n_layers`` non-causal (attn_nc, dense) layers, then its final norm."""
    x = enc_embeds
    positions = torch.arange(x.shape[1], device=x.device)
    if cfg.pos_encoding == "sinusoid":
        x = x + sinusoid_pos(positions, cfg.d_model).to(x.dtype)[None]
    ectx = dict(ctx, positions=positions, cache_index=0, enc_out=None)
    ea = axo.encoder if axo is not None and axo.encoder else {}
    x, _ = _run_stage(params["encoder"]["stage"], _encoder_stage(cfg), x, cfg, ectx, {}, ea)
    return _full_seq(rmsnorm(x, params["encoder"]["norm_f"], cfg.norm_eps))


def forward(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,                 # (B, S) int
    *,
    mode: str = "train",                  # train | prefill | decode
    cache: dict | None = None,
    cache_index: int | None = None,
    enc_embeds: torch.Tensor | None = None,   # (B, n_ctx, d) whisper stub frontend
    img_embeds: torch.Tensor | None = None,   # (B, n_img, d) VLM stub frontend
    axo=None,                             # optional axo.deploy.AxODeployment
    ctx=None,                             # optional core.engine.ExecutionContext
):
    """Returns (hidden (B, S, d), aux, new_cache).

    ``aux`` is the f32 sum of the moe layers' router aux losses (0 without
    one); ``cache`` is updated in place and returned (``None`` without a
    cache).  The encoder runs where ``cfg`` has one and ``enc_embeds`` is
    given (the prefill); the VLM's image states are ``img_embeds`` as given.
    Without them (a decode step) cross-attention reads its cached K/V.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "train" and cache is not None:
        raise ValueError("a training pass writes no cache")
    _check_config(cfg)
    b, s = tokens.shape
    ci = 0 if cache_index is None else int(cache_index)
    positions = ci + torch.arange(s, device=tokens.device)

    x = constrain(_embed(params, tokens), None, "batch", "res_seq", "embed")
    if cfg.pos_encoding == "sinusoid":
        x = x + sinusoid_pos(positions, cfg.d_model).to(x.dtype)[None]

    lctx = {
        "mode": mode,
        "positions": positions,
        "cache_index": ci,
        "axo": axo,
        "enc_out": None,
        "attn_impl": "kernel" if ctx is None else ctx.resolve_impl("attention", "kernel"),
        "ssd_impl": "kernel" if ctx is None else ctx.resolve_impl("ssd_scan", "kernel"),
    }
    if cfg.encoder is not None and enc_embeds is not None:
        lctx["enc_out"] = _encode(params, cfg, enc_embeds, lctx, axo)
    elif cfg.n_img_tokens and img_embeds is not None:
        lctx["enc_out"] = img_embeds

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, stage in enumerate(cfg.stages):
        sc = cache.get(str(si), {}) if cache is not None else {}
        sa = axo.stages.get(str(si), {}) if axo is not None else {}
        x, da = _run_stage(params["stages"][str(si)], stage, x, cfg, lctx, sc, sa)
        if da is not None:
            aux = aux + da

    x = rmsnorm(x, params["norm_f"], cfg.norm_eps)
    return x, aux, cache


def _lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def _embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The token embeddings.  Under a sharded step the lookup runs on each
    rank's local tokens against the whole table: DTensor's sharding rule for
    the lookup's backward (``index_put``) fails in some PyTorch releases."""
    return local_call(_lookup, [params["embed"]["tok"], tokens], [(None,), (0,)], [(0,)])


def logits_fn(params: dict, cfg: ModelConfig, x: torch.Tensor, axo=None) -> torch.Tensor:
    """The serving steps' logits (B, S, V) from the final hidden state."""
    x = _full_seq(x)
    if axo is not None and axo.head is not None:
        logits = axo.apply(x, axo.head)
    elif cfg.tie_embeddings:
        logits = x @ params["embed"]["tok"].T
    else:
        logits = x @ params["embed"]["unembed"]
    return constrain(logits, None, "batch", "res_seq", "vocab")


def _token_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each token's CE in f32, 0 where ``labels < 0``."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    return (lse - tgt) * (labels >= 0).to(torch.float32)


class _SumOver(torch.autograd.Function):
    """All-reduce SUM over ``groups``.  Every rank of the groups consumes the
    sum alike and the loss counts it once, so the gradient passes through
    (Megatron's reduce from the model-parallel region)."""

    @staticmethod
    def forward(ctx, t, groups):
        import torch.distributed as dist

        out = t.clone()
        for group in groups:
            dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor, offset: int,
                       groups: list) -> torch.Tensor:
    """:func:`_token_ce` where this rank holds the vocabulary entries
    ``[offset, offset + V_local)`` of the logits and the ranks of ``groups``
    the rest: the max and the sum of exponentials are combined over them,
    and the target logit comes from the rank that holds its entry."""
    import torch.distributed as dist

    logits = logits.to(torch.float32)
    with torch.no_grad():
        top = logits.max(dim=-1).values
        for group in groups:
            dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    sumexp = _SumOver.apply(torch.exp(logits - top[..., None]).sum(-1), groups)
    local = labels.long() - offset
    mine = (local >= 0) & (local < logits.shape[-1])
    tgt = torch.gather(logits, -1, torch.where(mine, local, 0)[..., None])[..., 0]
    tgt = _SumOver.apply(torch.where(mine, tgt, 0.0), groups)
    return (torch.log(sumexp) + top - tgt) * (labels >= 0).to(torch.float32)


def _head_token_ce(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, vdim: int,
                   split: tuple | None = None) -> torch.Tensor:
    """The head's logits from ``x`` (B, S, d) and its weight ``w`` ((V, d)
    tied, ``vdim`` 0; (d, V) untied, ``vdim`` 1), then each token's CE: over
    the whole vocabulary, or with ``split = (offset, groups)`` over this
    rank's slice of it (:func:`_vocab_parallel_ce`)."""
    logits = x @ w.T if vdim == 0 else x @ w
    if split is None:
        return _token_ce(logits, labels)
    return _vocab_parallel_ce(logits, labels, *split)


def _head_ce(params: dict, cfg: ModelConfig, x: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over ``labels >= 0`` of the head on ``x`` (B, S, d), in f32.

    Under a sharded step the head and the CE run on each rank's own tokens
    (``local_call``), in the layout the reference resolves: where ``x`` or
    ``labels`` is split over a mesh dim (the batch over ``data``, the
    sequence over ``model``), the weight is gathered there and each rank
    holds its (B/d, S/m, V) logits; where neither is split and the weight's
    vocabulary is, evenly, each rank keeps its vocabulary slice and the CE
    is combined across those ranks (:func:`_vocab_parallel_ce`).  The
    weight's gradient is the ranks' sum.  No (B, S, V) logits exist."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    w, vdim = (params["embed"]["tok"], 0) if cfg.tie_embeddings else \
        (params["embed"]["unembed"], 1)
    keep_w, split = (), None
    if isinstance(w, DTensor):
        mesh = w.device_mesh
        busy = {m for t in (x, labels) if isinstance(t, DTensor)
                for m, p in enumerate(t.placements) if not isinstance(p, Replicate)}
        dims = [m for m, p in enumerate(w.placements)
                if p == Shard(vdim) and m not in busy and mesh.size(m) > 1]
        if w.shape[vdim] % math.prod(mesh.size(m) for m in dims):
            dims = []
        want = [Shard(vdim) if m in dims else Replicate() for m in range(mesh.ndim)]
        if list(w.placements) != want:
            w = w.redistribute(mesh, want)
        if dims:
            size, offset = w.shape[vdim], 0
            for m in dims:
                size //= mesh.size(m)
                offset += mesh.get_local_rank(m) * size
            keep_w, split = (None, None, vdim), (offset, [mesh.get_group(m) for m in dims])
    per_token = local_call(_head_token_ce, [x, w, labels], [(0, 1), keep_w, (0, 1)],
                           [(0, 1)], vdim, split=split)
    return per_token.sum() / torch.clamp((labels >= 0).to(torch.float32).sum(), min=1.0)


def compute_loss(params: dict, cfg: ModelConfig, batch: dict, ctx=None):
    """Training loss: CE + MoE aux (+ DeepSeek-style MTP head loss); (loss, metrics).

    ``batch``: {"tokens": (B, S) int64, "labels": (B, S)} (+ "enc_embeds" /
    "img_embeds", cast to the parameters' dtype).  ``metrics`` holds ``ce``,
    ``moe_aux``, ``loss`` and, with ``cfg.mtp``, ``mtp_ce``: the MTP head
    merges hidden state t with the embedding of token t + 1 and predicts
    label t + 1, through the shared unembedding, weighted by
    ``cfg.mtp_weight``.  ``ctx`` picks K7/K8 or their plain versions.
    """
    dtype = params["norm_f"].dtype
    front = {k: batch[k].to(dtype) for k in ("enc_embeds", "img_embeds") if k in batch}
    x, aux, _ = forward(params, cfg, batch["tokens"], mode="train", ctx=ctx, **front)
    ce = _head_ce(params, cfg, x, batch["labels"])
    loss = ce + aux
    metrics = {"ce": ce, "moe_aux": aux}
    if cfg.mtp:
        mtp = params["mtp"]
        emb_next = _embed(params, batch["tokens"][:, 1:])
        x = _full_seq(x)
        h = torch.cat([rmsnorm(x[:, :-1], mtp["norm_h"], cfg.norm_eps),
                       rmsnorm(emb_next, mtp["norm_e"], cfg.norm_eps)], dim=-1)
        mtp_ce = _head_ce(params, cfg, h @ mtp["proj"], batch["labels"][:, 1:])
        loss = loss + cfg.mtp_weight * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    metrics["loss"] = loss
    return loss, metrics
