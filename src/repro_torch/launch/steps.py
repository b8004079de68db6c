"""Step functions: train, prefill and decode.

Counterpart of ``repro/launch/steps.py``.  Each ``make_*`` closes over the
config (and an optimizer, an optional ``AxODeployment`` and
``ExecutionContext``) and returns a function of tensors; one set serves
every arch of ``configs.registry``.  The train step differentiates
``compute_loss`` (CE, the MoE aux loss and deepseek-v3's MTP term) with
autograd; the serving steps drop a MoE layer's aux loss, as the reference's
do, and run under ``torch.no_grad()``.  The prefill takes the stubbed
modality input of the encoder-decoder and VLM families.  PyTorch runs them
eagerly.

Given a ``DeviceMesh``, the train step is the reference's sharded step:
parameters and optimizer state are DTensors placed by a rule table
(:func:`train_state_placements`, ``configs.registry.rules_for``), the batch
is split over the mesh's batch axes, and the forward and backward run on
DTensors (each op's sharding propagated by DTensor, the reference's SPMD
partitioner).  K7 and K8 take each rank's local batch rows and heads
(``models.sharding.local_call``).  Where DTensor lacks an op the model
uses, the model redistributes around it: the CE gathers the vocab dim
(DTensor's gather cannot take it sharded) and the token lookup runs on
local tokens (``model._embed``).  Each gradient is redistributed to its
parameter's placements before clipping and the update.

Given a mesh, the prefill and decode steps are the reference's sharded
serving steps: parameters placed by ``rules`` (``param_placements``), the
token batch (and a frontend) split over the batch axes
(:func:`batch_placements`), and the decode cache a tree of DTensors placed
by the activation rules (:func:`cache_placements`: at decode its sequence
dim over ``model``, or ``data`` and ``model`` at batch 1), which the
prefill creates so and the decode step writes in place on each rank's
block.  The model's activation sites (``models.sharding.constrain``) place
the activations by the same rules.  :func:`abstract_cache` is the cache as
fake tensors, which the dry-run (``launch.lowering``) traces.
"""

from __future__ import annotations

import contextlib

import torch

from ..configs.base import ModelConfig
from ..models.model import cache_spec, compute_loss, forward, logits_fn
from ..models.sharding import BASE_RULES, ShardingRules, gather_dims, placements, set_mesh
from ..models.spec import abstract_params, init_params, param_placements
from ..optim import Optimizer, apply_updates, clip_by_global_norm, tree_leaves, tree_map
from ..optim.compress import compress_int8, decompress_int8

__all__ = ["init_cache", "abstract_cache", "make_train_step", "make_prefill_step",
           "make_decode_step", "train_state_placements", "batch_placements",
           "cache_placements", "shard_batch"]


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def _split_microbatches(batch: dict, accum: int) -> list[dict]:
    """``batch`` as ``accum`` microbatches along its leading (batch) axis."""
    out = [{} for _ in range(accum)]
    for k, x in batch.items():
        b = x.shape[0]
        if b % accum:
            raise ValueError(f"batch {b} not divisible by accum {accum}")
        for i, part in enumerate(x.reshape(accum, b // accum, *x.shape[1:]).unbind(0)):
            out[i][k] = part
    return out


def train_state_placements(cfg: ModelConfig, rules: ShardingRules, mesh, opt: Optimizer):
    """(parameter placements, optimizer-state placements) from the spec tree."""
    from ..models.model import model_spec

    spec = model_spec(cfg)
    return (param_placements(spec, rules, mesh),
            param_placements(opt.state_spec(spec), rules, mesh))


def _batch_leaf_placements(rules: ShardingRules, mesh, shape: tuple[int, ...]) -> list:
    spec = rules.resolve(("batch",) + (None,) * (len(shape) - 1), kind="act")
    return placements(mesh, spec, tuple(shape))


def batch_placements(rules: ShardingRules, mesh, batch_specs: dict) -> dict:
    """Data-input placements (the reference's ``batch_shardings``): each
    input (tokens, labels, a frontend's embeddings; a tensor or anything with
    a ``shape``) split over the batch axes on its leading dim."""
    return {k: _batch_leaf_placements(rules, mesh, tuple(x.shape))
            for k, x in batch_specs.items()}


def shard_batch(batch: dict, rules: ShardingRules, mesh) -> dict:
    """The full batch (the same on every rank) as DTensors split over the
    batch axes (:func:`batch_placements`); each rank keeps its rows."""
    from torch.distributed.tensor import distribute_tensor

    def one(x):
        return distribute_tensor(x, mesh, _batch_leaf_placements(rules, mesh, tuple(x.shape)),
                                 src_data_rank=None)

    return {k: one(v) for k, v in batch.items()}


def _mesh_scope(mesh, rules: ShardingRules):
    """``set_mesh(mesh, rules)`` and ``implicit_replication`` (host constants
    as replicated) for a sharded step; nothing without a mesh."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    stack = contextlib.ExitStack()
    stack.enter_context(set_mesh(mesh, rules))
    stack.enter_context(implicit_replication())
    return stack


def make_train_step(cfg: ModelConfig, opt: Optimizer, accum_steps: int = 1,
                    clip_norm: float = 1.0, int8_accum: bool = False, ctx=None,
                    mesh=None, rules: ShardingRules | None = None):
    """(params, opt_state, step, batch) -> (params, opt_state, metrics).

    The gradient of ``compute_loss`` over every parameter leaf, clipped to
    ``clip_norm`` by global norm, then ``opt.update`` and ``apply_updates``.
    Parameters and optimizer state are updated in place and returned.
    ``accum_steps > 1`` runs the microbatches in a Python loop and sums
    their gradients in f32 (the reference's ``lax.scan``); ``int8_accum``
    keeps that sum as int8 with a per-tensor scale and an f32 error-feedback
    residual, re-compressed after every microbatch, as the reference does.
    ``metrics``: ``loss``, ``ce``, ``moe_aux`` (and ``mtp_ce``), means over
    the microbatches, and ``grad_norm``, the norm before clipping; 0-d f32
    tensors.  ``ctx`` picks K7/K8 (default) or their plain versions.

    With ``mesh`` (a ``DeviceMesh`` over ``data``/``model``, ``pod``) the
    step is sharded (module docstring): ``params`` and ``opt_state`` are
    DTensors placed by ``rules`` (default ``BASE_RULES``;
    :func:`train_state_placements`), ``batch`` the full batch on every rank,
    split here; the metrics are plain tensors, the same on every rank.

    ``train_step.grads(params, batch) -> (grads, metrics)`` is the step's
    forward and backward alone (one microbatch, no clip, no update): what
    ``lowering.lower_step(..., grads_only=True)`` traces and a measurement
    of that phase runs.
    """
    rules = BASE_RULES if rules is None else rules

    def grads_of(params, mb):
        if mesh is not None:
            mb = shard_batch(mb, rules, mesh)
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        flat = tree_leaves(leaves)
        with torch.enable_grad():
            loss, metrics = compute_loss(leaves, cfg, mb, ctx=ctx)
            got = torch.autograd.grad(loss, flat, allow_unused=True)
        by_leaf = {id(p): g for p, g in zip(flat, got)}

        def grad(p):
            g = by_leaf[id(p)]
            if g is None:
                return torch.zeros_like(p)
            if mesh is not None:   # sum the partial gradients onto the leaf's shards
                g = g.redistribute(p.device_mesh, p.placements)
            return g

        grads = tree_map(grad, leaves)
        return grads, {k: _plain(v.detach()) for k, v in metrics.items()}

    def train_step(params, opt_state, step, batch):
        with _mesh_scope(mesh, rules):
            params, opt_state, metrics = _step(params, opt_state, step, batch)
        return params, opt_state, {k: _plain(v) for k, v in metrics.items()}

    def grads(params, batch):
        with _mesh_scope(mesh, rules):
            return grads_of(params, batch)

    def _step(params, opt_state, step, batch):
        if accum_steps == 1:
            grads, metrics = grads_of(params, batch)
        else:
            f32 = torch.float32
            zeros = lambda p, dt: torch.zeros_like(p, dtype=dt)   # a DTensor keeps its shards
            if int8_accum:
                acc_q = tree_map(lambda p: zeros(p, torch.int8), params)
                acc_s = tree_map(lambda p: torch.ones((), dtype=f32, device=p.device), params)
                err = tree_map(lambda p: zeros(p, f32), params)
            else:
                acc = tree_map(lambda p: zeros(p, f32), params)
            seen = []
            for mb in _split_microbatches(batch, accum_steps):
                g, m = grads_of(params, mb)
                if int8_accum:
                    # accumulate in an f32 view, re-compress with error feedback
                    new = tree_map(lambda q, s, e, gi: compress_int8(
                        decompress_int8(q, s) + gi.to(f32), e), acc_q, acc_s, err, g)
                    acc_q, acc_s, err = (tree_map(lambda t, i=i: t[i], new) for i in range(3))
                else:
                    acc = tree_map(lambda a, gi: a + gi.to(f32), acc, g)
                seen.append(m)
                del g
            if int8_accum:
                grads = tree_map(lambda q, s: decompress_int8(q, s) / accum_steps, acc_q, acc_s)
                del acc_q, acc_s, err, new
            else:
                grads = tree_map(lambda a: a / accum_steps, acc)
                del acc
            metrics = {k: torch.stack([m[k] for m in seen]).mean() for k in seen[0]}
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        updates, opt_state = opt.update(grads, opt_state, params, step)
        del grads
        params = apply_updates(params, updates)
        metrics["grad_norm"] = gnorm
        return params, opt_state, metrics

    train_step.grads = grads
    return train_step


def _plain(x):
    """A DTensor metric as its full value (a plain tensor); others as they are."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
               device=None, mesh=None, rules: ShardingRules | None = None) -> dict:
    """A zero decode cache (on the card unless ``device`` says).

    Attention layers get KV rows of capacity ``max_seq`` in ``dtype``; mamba
    layers a conv tail in ``dtype`` and an SSD state in f32 whatever
    ``dtype`` is (the leaf's own spec dtype wins), which their prefill and
    decode write in place.  With ``mesh`` every leaf is a DTensor placed by
    :func:`cache_placements`, each rank holding its block.
    """
    return init_params(cache_spec(cfg, batch, max_seq), dtype=dtype, device=device,
                       mesh=mesh, rules=rules, kind="act")


def abstract_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
                   device="cuda", mesh=None, rules: ShardingRules | None = None,
                   mode=None) -> dict:
    """:func:`init_cache`'s tree as fake tensors (``models.spec.abstract_params``)."""
    return abstract_params(cache_spec(cfg, batch, max_seq), dtype=dtype, device=device,
                           mesh=mesh, rules=rules, kind="act", mode=mode)


def cache_placements(cfg: ModelConfig, rules: ShardingRules, mesh, batch: int,
                     max_seq: int) -> dict:
    """Each cache leaf's placements (the reference's ``cache_shardings``):
    its logical axes resolved by the activation rules."""
    return param_placements(cache_spec(cfg, batch, max_seq), rules, mesh, kind="act")


def make_prefill_step(cfg: ModelConfig, max_seq: int, axo=None, ctx=None, mesh=None,
                      rules: ShardingRules | None = None):
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

    With ``mesh`` (a ``DeviceMesh``) the step is sharded (module docstring):
    ``params`` are DTensors placed by ``rules`` (default ``BASE_RULES``),
    ``tokens`` and ``frontend`` the full batch on every rank, split here, and
    the cache and the logits come back as DTensors.
    """
    rules = BASE_RULES if rules is None else rules

    @torch.no_grad()
    def prefill_step(params, tokens, frontend=None):
        with _mesh_scope(mesh, rules):
            if mesh is not None:
                inputs = {"tokens": tokens}
                if frontend is not None:
                    inputs["frontend"] = frontend
                inputs = shard_batch(inputs, rules, mesh)
                tokens, frontend = inputs["tokens"], inputs.get("frontend")
            norm = params["norm_f"]
            dev = norm.to_local().device if mesh is not None else norm.device
            cache = init_cache(cfg, tokens.shape[0], max_seq, dtype=norm.dtype, device=dev,
                               mesh=mesh, rules=rules)
            enc = frontend if cfg.encoder is not None else None
            img = frontend if cfg.n_img_tokens else None
            x, _, cache = forward(params, cfg, tokens, mode="prefill", cache=cache,
                                  cache_index=0, enc_embeds=enc, img_embeds=img, axo=axo,
                                  ctx=ctx)
            # the last position's hidden state (the sequence gathered first
            # where sequence parallelism splits it)
            logits = logits_fn(params, cfg, gather_dims(x, 1)[:, -1:], axo=axo)
        return logits, cache

    return prefill_step


def make_decode_step(cfg: ModelConfig, axo=None, ctx=None, mesh=None,
                     rules: ShardingRules | None = None):
    """(params, cache, tokens (B, 1), index) -> (logits (B, 1, V), cache).

    The cache is written in place and returned.  ``axo``, ``ctx``, ``mesh``
    and ``rules`` as in :func:`make_prefill_step`; under a mesh the cache is
    the DTensor tree the sharded prefill returns (or one placed by
    :func:`cache_placements`), written on each rank's block."""
    rules = BASE_RULES if rules is None else rules

    @torch.no_grad()
    def decode_step(params, cache, tokens, index):
        with _mesh_scope(mesh, rules):
            if mesh is not None:
                tokens = shard_batch({"tokens": tokens}, rules, mesh)["tokens"]
            x, _, cache = forward(params, cfg, tokens, mode="decode", cache=cache,
                                  cache_index=int(index), axo=axo, ctx=ctx)
            logits = logits_fn(params, cfg, x, axo=axo)
        return logits, cache

    return decode_step
