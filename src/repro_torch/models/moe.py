"""Mixture-of-Experts with sort-based (one-hot-free) dispatch and expert parallelism.

Counterpart of ``repro/models/moe.py``.  Dispatch and combine go through an
argsort by expert and a capacity-bounded scatter and gather: entries past an
expert's capacity are dropped, as in the capacity-factor semantics of
Switch/GShard.

Two execution paths, one math, as in the reference:

* **single device**: every expert local, plain dispatch.
* **expert parallel (EP)**, when a mesh is set (``models.sharding.set_mesh``,
  a ``DeviceMesh`` whose ranks are processes of a ``torch.distributed``
  world) with a ``model`` dim of more than one rank that divides the expert
  count.  Each model rank holds E/ep experts and dispatches *its own*
  experts' tokens from its full copy of the activations; the combine is one
  all-reduce over the model group (the reference's ``psum``).  With a
  ``data`` dim the tokens are split over it (:func:`_ep_body`, the output
  batch-sharded).  A small token batch (``t <= 8192``) on a mesh whose data
  dim divides d takes the weight-stationary body (:func:`_ep_decode_body`):
  the weights stay sharded (experts over model, d over data), every rank
  sees every token, and the pre-activations are all-reduced over data before
  the nonlinearity, the output over model; the output is d-sharded over
  data.  Each rank routes the tokens it holds (softmax, top-k); the aux
  loss's means over tokens sum across the ranks that hold the others.  On
  the EP paths the output is a DTensor with those placements; ``x`` and the
  expert leaves may be plain tensors, the same on every rank (each rank
  takes its slice), or DTensors (redistributed to the body's placements),
  as in the sharded train step.  There the gradients follow the reference's
  math: an all-reduce whose sum every rank consumes alike passes its
  gradient through, one whose ranks consume it differently sums it, and the
  tokens and gates each rank's experts take sum their gradients over the
  ranks (:class:`_Psum`, :class:`_Fan`).  On plain tensors the bodies'
  only collective is the all-reduce, which gloo runs on CUDA tensors too;
  :data:`EP_STATS` counts their forward all-reduces, bytes and host seconds.

The exact expert FFN is three batched products over the ``(E, cap, d)``
capacity buffer; the reference computes them with XLA einsums, outside any
Pallas kernel, so no kernel runs here.  With an ``AxODeployment`` whose layer
entries hold ``"experts"``, each expert's FFN instead runs through the
approximate operator (K6) in a Python loop over the experts on the
single-device path, mesh or not, as the reference's does: each
``dep.apply`` quantizes its own ``(cap, d)`` buffer, padding rows included,
and launches kernel K6 at M = cap.  Routing stays exact and in f32.
"""

from __future__ import annotations

import math
import time

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import mlp_apply, mlp_spec
from .sharding import constrain, current_mesh
from .spec import ParamSpec

__all__ = ["moe_spec", "moe_apply", "moe_capacity", "EP_STATS"]

# the EP bodies' all-reduces: calls, bytes of the reduced tensors, host seconds
EP_STATS = {"calls": 0, "bytes": 0, "seconds": 0.0}


def moe_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    e = cfg.moe
    c = math.ceil(n_tokens * e.top_k / e.n_experts * e.capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to 8, as the reference does


def moe_spec(cfg: ModelConfig) -> dict:
    e = cfg.moe
    d, f = cfg.d_model, e.d_ff_expert
    out = {
        "router": ParamSpec((d, e.n_experts), ("embed", "experts")),
        "w_gate": ParamSpec((e.n_experts, d, f), ("experts", "embed", "mlp")),
        "w_up": ParamSpec((e.n_experts, d, f), ("experts", "embed", "mlp")),
        "w_down": ParamSpec((e.n_experts, f, d), ("experts", "mlp", "embed")),
    }
    if e.n_shared:
        out["shared"] = mlp_spec(cfg, d_ff=e.n_shared * f)
    return out


def _dispatch_compute(
    x: torch.Tensor,          # (T, d) tokens
    top_i: torch.Tensor,      # (T, k) expert ids
    gates: torch.Tensor,      # (T, k)
    w_gate: torch.Tensor,     # (E_loc, d, f)
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    e0: int,                  # first expert id held here
    cap: int,
    axo=None,                 # (AxODeployment, expert entry dict) or None
) -> torch.Tensor:
    """Sort-based dispatch -> expert FFN -> gate-weighted combine: (T, d).

    Entries routed to experts not held here go to the sentinel bucket
    ``E_loc``; they and the entries past an expert's ``cap`` slots are
    dropped, where the reference's scatter drops them (``mode="drop"``).  The
    sort is stable, so an expert's slots fill in token order.  A token's k
    slots go to k distinct experts, so the order ``top_k`` gives its slots
    (which may differ between ``torch.topk`` and ``jax.lax.top_k`` where two
    probabilities tie) moves no entry past another in an expert's queue and
    does not change which entries are dropped.

    Scatter and gather run on clamped indices with one spare row for the
    dropped entries, so nothing here syncs the host.
    """
    t, d = x.shape
    e_loc = w_gate.shape[0]
    k = top_i.shape[1]
    dev = x.device

    lid = top_i.reshape(-1) - e0
    assign = torch.where((lid >= 0) & (lid < e_loc), lid, torch.full_like(lid, e_loc))
    sort_idx = torch.argsort(assign, stable=True)
    sorted_e = assign[sort_idx]
    tok = sort_idx // k
    starts = torch.searchsorted(sorted_e, torch.arange(e_loc + 1, device=dev, dtype=sorted_e.dtype),
                                side="left")
    pos = torch.arange(t * k, device=dev) - starts[sorted_e]
    kept = (sorted_e < e_loc) & (pos < cap)
    # slot of each entry in the flattened (E_loc * cap) buffer; dropped ones
    # land in the spare row past its end
    slot = torch.where(kept, sorted_e * cap + pos, torch.full_like(pos, e_loc * cap))
    flat = torch.zeros((e_loc * cap + 1, d), dtype=x.dtype, device=dev)
    flat[slot] = x[tok]
    buf = flat[:-1].view(e_loc, cap, d)

    if axo is None:
        h = F.silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
        y = torch.bmm(h, w_down)
    else:
        dep, ent = axo
        ys = []
        for ei in range(e_loc):
            sel = {name: {kk: vv[ei] for kk, vv in sub.items()} for name, sub in ent.items()}
            he = F.silu(dep.apply(buf[ei], sel["w_gate"])) * dep.apply(buf[ei], sel["w_up"])
            ys.append(dep.apply(he, sel["w_down"]))
        y = torch.stack(ys).to(buf.dtype)

    y_flat = torch.cat([y.reshape(e_loc * cap, d), torch.zeros((1, d), dtype=y.dtype,
                                                               device=dev)])
    w = gates.reshape(-1)[sort_idx].to(y.dtype)
    y_tok = y_flat[slot] * w[:, None]          # the spare row is zero: dropped entries add 0
    return torch.zeros((t, d), dtype=y.dtype, device=dev).index_add_(0, tok, y_tok)


class _Psum(torch.autograd.Function):
    """All-reduce SUM over ``group`` (the reference's ``psum``).  Backward:
    ``"identity"`` where every rank of the group consumes the sum alike (the
    loss counts it once), ``"sum"`` where each rank consumes it differently."""

    @staticmethod
    def forward(ctx, t, group, backward: str):
        import torch.distributed as dist

        ctx.group, ctx.backward = group, backward
        out = t.contiguous().clone()
        t0 = time.perf_counter()
        dist.all_reduce(out, group=group)
        EP_STATS["seconds"] += time.perf_counter() - t0
        EP_STATS["calls"] += 1
        EP_STATS["bytes"] += out.numel() * out.element_size()
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        if ctx.backward == "sum":
            g = g.contiguous().clone()
            dist.all_reduce(g, group=ctx.group)
        return g, None, None


class _Fan(torch.autograd.Function):
    """Identity; backward: the gradient summed over ``groups``.  A tensor the
    same on every rank of the groups, fanned out to computations that differ
    by rank (each rank's experts, or d-slice)."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        for group in ctx.groups:
            dist.all_reduce(g, group=group)
        return g, None


def _psum(t: torch.Tensor, group, backward: str = "identity") -> torch.Tensor:
    return _Psum.apply(t, group, backward)


def _fan(t: torch.Tensor, *groups) -> torch.Tensor:
    return _Fan.apply(t, groups) if t.requires_grad else t


def _ep_body(cap: int, w_gate, w_up, w_down, x, top_i, gates, model_rank: int, group):
    """One model rank's experts over its local token copy; summed over model."""
    e_loc = w_gate.shape[0]
    b, s, d = x.shape
    x, gates = _fan(x, group), _fan(gates, group)
    out = _dispatch_compute(
        x.reshape(b * s, d), top_i.reshape(b * s, -1), gates.reshape(b * s, -1),
        w_gate, w_up, w_down, model_rank * e_loc, cap,
    )
    return _psum(out.reshape(b, s, d), group)


def _ep_decode_body(cap: int, w_gate, w_up, w_down, x, top_i, gates, model_rank: int,
                    data_rank: int, model_group, data_group):
    """Weight-stationary body: weights stay sharded (experts over model, d over
    data); every rank sees the full (small) token batch, contracts its d-slice,
    and the partial sums are all-reduced over data (before the nonlinearity)
    and over model (the expert partition).

    w_gate/w_up: (E_loc, d_loc, f); w_down: (E_loc, f, d_loc); x: (B, S, d).
    Returns this data rank's (B, S, d_loc) slice of the output.
    """
    e_loc, d_loc = w_gate.shape[0], w_gate.shape[1]
    b, s, d = x.shape
    t = b * s
    k = top_i.shape[-1]
    dev = x.device
    x, gates = _fan(x, model_group, data_group), _fan(gates, model_group, data_group)
    xs = x.reshape(t, d)[:, data_rank * d_loc:(data_rank + 1) * d_loc]

    lid = top_i.reshape(-1) - model_rank * e_loc
    assign = torch.where((lid >= 0) & (lid < e_loc), lid, torch.full_like(lid, e_loc))
    sort_idx = torch.argsort(assign, stable=True)
    sorted_e = assign[sort_idx]
    tok = sort_idx // k
    starts = torch.searchsorted(sorted_e, torch.arange(e_loc + 1, device=dev, dtype=sorted_e.dtype),
                                side="left")
    pos = torch.arange(t * k, device=dev) - starts[sorted_e]
    kept = (sorted_e < e_loc) & (pos < cap)
    slot = torch.where(kept, sorted_e * cap + pos, torch.full_like(pos, e_loc * cap))
    flat = torch.zeros((e_loc * cap + 1, d_loc), dtype=xs.dtype, device=dev)
    flat[slot] = xs[tok]
    buf = flat[:-1].view(e_loc, cap, d_loc)

    # contract the local d-slice; all-reduce over data BEFORE the nonlinearity
    # (each data rank feeds its own output slice from the sums: their
    # gradients are summed over data)
    pre_g = _psum(torch.bmm(buf, w_gate), data_group, "sum")
    pre_u = _psum(torch.bmm(buf, w_up), data_group, "sum")
    y = torch.bmm(F.silu(pre_g) * pre_u, w_down)               # (E_loc, cap, d_loc)

    y_flat = torch.cat([y.reshape(e_loc * cap, d_loc),
                        torch.zeros((1, d_loc), dtype=y.dtype, device=dev)])
    w = gates.reshape(-1)[sort_idx].to(y.dtype)
    out = torch.zeros((t, d_loc), dtype=y.dtype, device=dev).index_add_(
        0, tok, y_flat[slot] * w[:, None])
    return _psum(out, model_group).reshape(b, s, d_loc)


def _batch_axes(mesh, b: int) -> tuple:
    """The mesh dims the token batch is split over (the reference's
    ``_batch_spec``): ``pod``/``data`` where their product divides ``b``."""
    names = mesh.mesh_dim_names
    axes = tuple(a for a in ("pod", "data") if a in names)
    n = math.prod(mesh.size(names.index(a)) for a in axes) if axes else 1
    return axes if (axes and b % n == 0) else ()


def _local(x, mesh, want: dict, partial: tuple = ()):
    """``x`` (a plain tensor, the same on every rank, or a DTensor) as this
    rank's block of the placement ``want`` ({mesh dim name: tensor dim});
    its gradient is the block's, summed over the mesh dims ``partial``
    (where the ranks hold different tokens)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    names = mesh.mesh_dim_names
    pl = [Shard(want[n]) if n in want else Replicate() for n in names]
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    else:   # a split over a mesh dim of one rank is no split: relabel it, no collective
        have = [Replicate() if q.is_shard() and mesh.size(i) == 1 else q
                for i, q in enumerate(x.placements)]
        if have != list(x.placements):
            x = DTensor.from_local(x.to_local(), mesh, have, run_check=False,
                                   shape=x.shape, stride=x.stride())
    grad = [Partial() if n in partial else q for n, q in zip(names, pl)]
    return x.redistribute(mesh, pl).to_local(grad_placements=grad)


def _route(x, router, cfg: ModelConfig, n_tokens: int, groups=()):
    """Routing in f32 -> (top_i, gates, aux loss).  With ``groups`` the
    ranks of those groups hold the other tokens of ``n_tokens``: the aux
    loss's means over tokens sum across them."""
    e = cfg.moe
    k = e.top_k
    logits = (x @ router).to(torch.float32)                  # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)              # (B, S, k)
    gates = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # Switch-style load-balance auxiliary loss
    flat_i = top_i.reshape(-1)
    counts = torch.zeros((e.n_experts,), dtype=torch.float32, device=x.device).index_add_(
        0, flat_i, torch.ones(flat_i.shape, dtype=torch.float32, device=x.device))
    if groups:
        me = probs.reshape(-1, e.n_experts).sum(dim=0)
        for group in groups:   # the aux loss is counted once: identity backward
            me, counts = _psum(me, group), _psum(counts, group)
        me = me / n_tokens
    else:
        me = probs.reshape(n_tokens, -1).mean(dim=0)         # (E,)
    ce = counts / (n_tokens * k)
    return top_i, gates, e.n_experts * torch.sum(me * ce) * e.router_aux_weight


def _moe_ep(p: dict, x, cfg: ModelConfig, mesh, weight_stationary: bool):
    """The EP paths: (out DTensor, aux loss).  Each rank routes its own
    tokens (the batch over ``pod``/``data`` for ``_ep_body``, all of them for
    the weight-stationary body) and runs its experts' shard of the weights."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    names = mesh.mesh_dim_names
    b, s, d = x.shape
    t = b * s
    bax = () if weight_stationary else _batch_axes(mesh, b)
    xl = _local(x, mesh, {a: 0 for a in bax})
    top_i, gates, aux = _route(xl, _local(p["router"], mesh, {}, partial=bax), cfg, t,
                               [mesh.get_group(a) for a in bax
                                if mesh.size(names.index(a)) > 1])
    model_rank, model_group = mesh.get_local_rank("model"), mesh.get_group("model")
    if weight_stationary:
        w = [_local(p[k], mesh, {"model": 0, "data": dim})
             for k, dim in (("w_gate", 1), ("w_up", 1), ("w_down", 2))]
        out = _ep_decode_body(moe_capacity(t, cfg), *w, xl, top_i, gates, model_rank,
                              mesh.get_local_rank("data"), model_group,
                              mesh.get_group("data"))
        pl = [Shard(2) if n == "data" else Replicate() for n in names]
    else:
        n_tok = math.prod(mesh.size(names.index(a)) for a in bax) if bax else 1
        w = [_local(p[k], mesh, {"model": 0}, partial=bax) for k in ("w_gate", "w_up", "w_down")]
        out = _ep_body(moe_capacity(t // n_tok, cfg), *w, xl, top_i, gates, model_rank,
                       model_group)
        pl = [Shard(0) if n in bax else Replicate() for n in names]
    out = DTensor.from_local(out, mesh, pl, run_check=False)
    if isinstance(x, DTensor):   # the loss it joins is a DTensor too
        aux = DTensor.from_local(aux, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return out, aux


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, axo=None):
    """Returns (out (B, S, d), router aux loss scalar).

    ``axo`` = (AxODeployment, the layer's mlp entries) puts the routed
    experts (its ``"experts"`` entries) and the shared expert (``"shared"``)
    on the approximate operator; AxO experts take the single-device path.
    The router stays exact: it picks which experts run, a routing decision
    rather than arithmetic.  Under a mesh (``set_mesh``) the exact experts
    take the EP paths (module docstring) and ``out`` is a DTensor; ``x`` is
    the full token batch, the same on every rank, or, in the sharded train
    step, a DTensor.
    """
    e = cfg.moe
    b, s, d = x.shape
    t = b * s

    mesh = current_mesh()
    names = () if mesh is None else mesh.mesh_dim_names
    ep = mesh.size(names.index("model")) if "model" in names else 1
    ep_ok = ep > 1 and e.n_experts % ep == 0
    data_n = mesh.size(names.index("data")) if ep_ok and "data" in names else 1
    decode_ws = ep_ok and t <= 8192 and data_n > 1 and d % data_n == 0
    ex_axo = (axo[0], axo[1]["experts"]) if axo is not None and "experts" in axo[1] else None

    if ex_axo is None and ep_ok:
        out, aux = _moe_ep(p, x, cfg, mesh, decode_ws)
    else:
        top_i, gates, aux = _route(x, p["router"], cfg, t)
        out = _dispatch_compute(
            x.reshape(t, d), top_i.reshape(t, -1), gates.reshape(t, -1),
            p["w_gate"], p["w_up"], p["w_down"], 0, moe_capacity(t, cfg), axo=ex_axo,
        ).reshape(b, s, d)

    if "shared" in p:
        sh_axo = (axo[0], axo[1]["shared"]) if axo is not None and "shared" in axo[1] else None
        shared = mlp_apply(p["shared"], x, cfg, axo=sh_axo)
        if ex_axo is None and ep_ok and not hasattr(shared, "placements"):
            from torch.distributed.tensor import DTensor, Replicate

            shared = DTensor.from_local(shared, mesh, [Replicate()] * mesh.ndim,
                                        run_check=False)
        out = out + shared
    return constrain(out, None, "batch", "seq", "embed").to(x.dtype), aux
