"""The serving steps: prefill and decode.

Counterpart of the serving half of ``repro/launch/steps.py``.  Each ``make_*``
closes over the config (and an optional ``AxODeployment`` and
``ExecutionContext``) and returns a function of tensors; one pair serves every
arch of ``configs.registry`` (a MoE layer's router aux loss is computed and
dropped, as the reference's serving steps drop it).  The prefill takes the
stubbed modality input of the encoder-decoder and VLM families.  PyTorch runs them eagerly; the reference's sharding trees and abstract caches have no use on
one device, and the train step waits for ROADMAP.md queue 1 item 11.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models.model import cache_spec, forward, logits_fn
from ..models.spec import init_params

__all__ = ["init_cache", "make_prefill_step", "make_decode_step"]


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """A zero decode cache (on the card unless ``device`` says).

    Attention layers get KV rows of capacity ``max_seq`` in ``dtype``; mamba
    layers a conv tail in ``dtype`` and an SSD state in f32 whatever
    ``dtype`` is (the leaf's own spec dtype wins), which their prefill and
    decode write in place.
    """
    return init_params(cache_spec(cfg, batch, max_seq), dtype=dtype, device=device)


def make_prefill_step(cfg: ModelConfig, max_seq: int, axo=None, ctx=None):
    """(params, tokens[, frontend]) -> (last-position logits (B, 1, V), cache).

    ``frontend`` is the stubbed modality input: frame embeddings for the
    encoder-decoder family, patch embeddings for the VLM (``cfg`` decides
    which), as the reference's step takes it.

    The cache is created inside the step (zeros, the parameters' dtype and
    device; a mamba state in f32) at capacity ``max_seq`` and filled by the
    prefill pass.  ``axo``
    (an ``axo.deploy.AxODeployment``) serves every deployed projection through
    the approximate operator on its cached weight codes; ``ctx`` picks the
    prefill attention (K7 or its plain version) and the Mamba-2 prefill scan
    (K8 or its plain version).
    """

    def prefill_step(params, tokens, frontend=None):
        norm = params["norm_f"]
        cache = init_cache(cfg, tokens.shape[0], max_seq, dtype=norm.dtype,
                           device=norm.device)
        enc = frontend if cfg.encoder is not None else None
        img = frontend if cfg.n_img_tokens else None
        x, _, cache = forward(params, cfg, tokens, mode="prefill", cache=cache,
                              cache_index=0, enc_embeds=enc, img_embeds=img, axo=axo,
                              ctx=ctx)
        logits = logits_fn(params, cfg, x[:, -1:], axo=axo)
        return logits, cache

    return prefill_step


def make_decode_step(cfg: ModelConfig, axo=None, ctx=None):
    """(params, cache, tokens (B, 1), index) -> (logits (B, 1, V), cache).

    The cache is written in place and returned.  ``axo`` and ``ctx`` as in
    :func:`make_prefill_step`."""

    def decode_step(params, cache, tokens, index):
        x, _, cache = forward(params, cfg, tokens, mode="decode", cache=cache,
                              cache_index=int(index), axo=axo, ctx=ctx)
        logits = logits_fn(params, cfg, x, axo=axo)
        return logits, cache

    return decode_step
