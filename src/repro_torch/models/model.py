"""Model assembly: spec trees, caches, forward (train / prefill / decode).

Counterpart of ``repro/models/model.py``, dense, MoE and Mamba-2 stages.  A
model is ``embed -> stages -> final norm -> unembed``; a stage repeats a
super-block of ``(mixer, mlp)`` layers ``repeats`` times.  Parameters and
caches keep the reference's tree: each leaf of a stage is stacked over
``repeats``, and the forward pass takes layer r's slice of every leaf in a
Python loop where the reference scans.  The port runs the ``attn``/``attn_nc``
mixers with ``dense``/``moe``/``none`` MLPs (the ``dense`` family, e.g.
granite-3-2b, internlm2-1.8b, starcoder2-3b, deepseek-67b; the ``moe`` family,
kimi-k2-1t-a32b) and the ``mamba`` mixer with no MLP (the ``ssm`` family,
mamba2-130m); MLA, cross-attention, the hybrid stack and the
encoder-decoder and VLM frontends raise (ROADMAP.md queue 1 item 10), as
does ``compute_loss`` with the train step (queue 1 item 11).  ``forward``
returns the sum of the MoE layers' router aux losses, as the reference's
does.

``forward`` takes an optional ``ExecutionContext`` whose ``attention`` menu
picks kernel K7 or its plain version for prefill attention, and whose
``ssd_scan`` menu picks kernel K8 or its plain version for the Mamba-2
prefill scan; an ``AxODeployment`` carries its own context for the AxO
projections (K6).
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig, StageConfig
from .attention import attn_apply, attn_spec
from .layers import embed_spec, mlp_apply, mlp_spec, rmsnorm, sinusoid_pos
from .moe import moe_apply, moe_spec
from .spec import ParamSpec, stacked
from .ssm import mamba_apply, mamba_decode, mamba_dims, mamba_spec

__all__ = [
    "model_spec",
    "cache_spec",
    "forward",
    "logits_fn",
    "HAS_CACHE",
]

# Which mixer kinds carry decode state.
HAS_CACHE = {"attn": True, "attn_nc": False, "mamba": True}
_LATER = "is not ported yet (ROADMAP.md queue 1 item 10)"


def _check_config(cfg: ModelConfig) -> None:
    if cfg.encoder is not None or cfg.n_img_tokens or cfg.mtp:
        raise NotImplementedError(f"{cfg.name}: its encoder / image / MTP frontend {_LATER}")
    for stage in cfg.stages:
        for mixer, mlp in stage.layers:
            if mixer not in HAS_CACHE:
                raise NotImplementedError(f"{cfg.name}: mixer {mixer!r} {_LATER}")
            if mlp not in ("dense", "moe", "none"):
                raise NotImplementedError(f"{cfg.name}: mlp {mlp!r} {_LATER}")


# ---------------------------------------------------------------------------
# Param spec tree
# ---------------------------------------------------------------------------


def _layer_spec(cfg: ModelConfig, mixer: str, mlp: str) -> dict:
    out = {
        "norm1": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "mixer": mamba_spec(cfg) if mixer == "mamba" else attn_spec(cfg),
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
    return {
        "embed": embed_spec(cfg),
        "stages": {str(i): _stage_spec(cfg, s) for i, s in enumerate(cfg.stages)},
        "norm_f": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
    }


# ---------------------------------------------------------------------------
# Cache spec tree
# ---------------------------------------------------------------------------


def _layer_cache_spec(cfg: ModelConfig, mixer: str, batch: int, max_seq: int) -> dict:
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
    g, hd = cfg.kv_heads, cfg.resolved_head_dim
    kv_axes = ("batch", "kv_seq", "kv_heads", "head_dim")
    return {
        "k": ParamSpec((batch, max_seq, g, hd), kv_axes, init="zeros"),
        "v": ParamSpec((batch, max_seq, g, hd), kv_axes, init="zeros"),
    }


def cache_spec(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """Spec tree for the decode cache (same nesting as the param stages tree).

    A mamba layer's ``state`` leaf is f32 whatever the tree's dtype."""
    _check_config(cfg)
    out = {}
    for si, stage in enumerate(cfg.stages):
        blk = {str(i): _layer_cache_spec(cfg, mixer, batch, max_seq)
               for i, (mixer, _) in enumerate(stage.layers) if HAS_CACHE[mixer]}
        out[str(si)] = _stack_tree(blk, stage.repeats)
    return out


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------


def _at(tree, r: int):
    """Layer ``r``'s slice of every leaf of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _at(v, r) for k, v in tree.items()}
    return tree[r]


def _mamba(p: dict, h: torch.Tensor, cfg: ModelConfig, ctx: dict, cache: dict | None):
    """The mamba mixer; its cache ``{conv, state}`` is written in place."""
    if ctx["mode"] == "decode":
        out, (conv, state) = mamba_decode(p, h, cfg, cache["conv"], cache["state"])
    else:
        out, (conv, state) = mamba_apply(p, h, cfg, impl=ctx["ssd_impl"])
    if cache is not None:
        cache["conv"].copy_(conv)
        cache["state"].copy_(state)
    return out, cache


def _apply_layer(mixer: str, mlp: str, p: dict, x: torch.Tensor, cfg: ModelConfig,
                 ctx: dict, cache: dict | None, axo_layer: dict | None = None):
    """Pre-norm residual layer.  Returns (x, aux, new_cache).

    ``axo_layer`` is this layer's entry dict from an ``AxODeployment``
    (``ctx["axo"]``): its named projections run through the approximate
    operator instead of exact matmuls.  A mamba layer has no entries (the
    reference's ``deploy_axo`` gives it none).  The cache is written in
    place: an attention layer's KV rows, and a mamba layer's conv tail and
    f32 SSD state (by prefill from the whole prompt, by decode one step on).
    ``aux`` is a moe layer's router aux loss, ``None`` for other layers.
    """
    dep = ctx["axo"]

    def ax(part):
        if dep is None or not axo_layer or part not in axo_layer:
            return None
        return (dep, axo_layer[part])

    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    if mixer == "mamba":
        out, new_cache = _mamba(p["mixer"], h, cfg, ctx, cache)
    else:
        out, new_cache = attn_apply(
            p["mixer"], h, cfg,
            positions=ctx["positions"], causal=(mixer == "attn"),
            use_rope=cfg.pos_encoding == "rope" and mixer == "attn",
            cache=cache if mixer == "attn" else None, cache_index=ctx["cache_index"],
            axo=ax("mixer"), impl=ctx["attn_impl"],
        )
    x = x + out
    aux = None
    if mlp != "none":
        h = rmsnorm(x, p["norm2"], cfg.norm_eps)
        if mlp == "moe":
            out, aux = moe_apply(p["mlp"], h, cfg, axo=ax("mlp"))
        else:
            out = mlp_apply(p["mlp"], h, cfg, axo=ax("mlp"))
        x = x + out
    return x, aux, new_cache


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def forward(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,                 # (B, S) int
    *,
    mode: str = "train",                  # train | prefill | decode
    cache: dict | None = None,
    cache_index: int | None = None,
    axo=None,                             # optional axo.deploy.AxODeployment
    ctx=None,                             # optional core.engine.ExecutionContext
):
    """Returns (hidden (B, S, d), aux, new_cache).

    ``aux`` is the f32 sum of the moe layers' router aux losses (0 without
    one); ``cache`` is updated in place and returned (``None`` without a
    cache).
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    _check_config(cfg)
    b, s = tokens.shape
    ci = 0 if cache_index is None else int(cache_index)
    positions = ci + torch.arange(s, device=tokens.device)

    x = params["embed"]["tok"][tokens]
    if cfg.pos_encoding == "sinusoid":
        x = x + sinusoid_pos(positions, cfg.d_model).to(x.dtype)[None]

    lctx = {
        "mode": mode,
        "positions": positions,
        "cache_index": ci,
        "axo": axo,
        "attn_impl": "kernel" if ctx is None else ctx.resolve_impl("attention", "kernel"),
        "ssd_impl": "kernel" if ctx is None else ctx.resolve_impl("ssd_scan", "kernel"),
    }
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, stage in enumerate(cfg.stages):
        sp = params["stages"][str(si)]
        sc = cache.get(str(si), {}) if cache is not None else {}
        sa = axo.stages.get(str(si), {}) if axo is not None else {}
        for r in range(stage.repeats):
            for li, (mixer, mlp) in enumerate(stage.layers):
                key = str(li)
                lc = _at(sc[key], r) if key in sc else None
                la = _at(sa[key], r) if key in sa else None
                x, da, _ = _apply_layer(mixer, mlp, _at(sp[key], r), x, cfg, lctx, lc,
                                        axo_layer=la)
                if da is not None:
                    aux = aux + da

    x = rmsnorm(x, params["norm_f"], cfg.norm_eps)
    return x, aux, cache


def _unembed(params: dict, cfg: ModelConfig, x: torch.Tensor, axo=None) -> torch.Tensor:
    if axo is not None and axo.head is not None:
        return axo.apply(x, axo.head)
    if cfg.tie_embeddings:
        return x @ params["embed"]["tok"].T
    return x @ params["embed"]["unembed"]


def logits_fn(params: dict, cfg: ModelConfig, x: torch.Tensor, axo=None) -> torch.Tensor:
    return _unembed(params, cfg, x, axo=axo)
