"""Mixture-of-Experts with sort-based (one-hot-free) dispatch.

Counterpart of ``repro/models/moe.py``, its single-device path.  Dispatch and
combine go through an argsort by expert and a capacity-bounded scatter and
gather: entries past an expert's capacity are dropped, as in the
capacity-factor semantics of Switch/GShard.  The reference's expert-parallel
``shard_map`` bodies (``_ep_body``, ``_ep_decode_body``) are not ported
(ROADMAP.md queue 1 item 13): on one device every expert is local.

The exact expert FFN is three batched products over the ``(E, cap, d)``
capacity buffer.  With an ``AxODeployment`` whose layer entries hold
``"experts"``, each expert's FFN instead runs through the approximate
operator in a Python loop over the experts, as the reference's does: each
``dep.apply`` quantizes its own ``(cap, d)`` buffer, padding rows included,
and launches kernel K6 at M = cap.  Routing stays exact and in f32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import mlp_apply, mlp_spec
from .spec import ParamSpec

__all__ = ["moe_spec", "moe_apply", "moe_capacity"]


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


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, axo=None):
    """Returns (out (B, S, d), router aux loss scalar).

    ``axo`` = (AxODeployment, the layer's mlp entries) puts the routed
    experts (its ``"experts"`` entries) and the shared expert (``"shared"``)
    on the approximate operator.  The router stays exact: it picks which
    experts run, a routing decision rather than arithmetic.
    """
    e = cfg.moe
    b, s, d = x.shape
    t = b * s
    k = e.top_k

    # routing, in f32
    logits = (x @ p["router"]).to(torch.float32)             # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)              # (B, S, k)
    gates = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # Switch-style load-balance auxiliary loss
    me = probs.reshape(t, -1).mean(dim=0)                    # (E,)
    ce = torch.zeros((e.n_experts,), dtype=torch.float32, device=x.device).index_add_(
        0, top_i.reshape(-1), torch.ones((t * k,), dtype=torch.float32, device=x.device)
    ) / (t * k)
    aux = e.n_experts * torch.sum(me * ce) * e.router_aux_weight

    ex_axo = (axo[0], axo[1]["experts"]) if axo is not None and "experts" in axo[1] else None
    out = _dispatch_compute(
        x.reshape(t, d), top_i.reshape(t, k), gates.reshape(t, k),
        p["w_gate"], p["w_up"], p["w_down"], 0, moe_capacity(t, cfg), axo=ex_axo,
    ).reshape(b, s, d)

    if "shared" in p:
        sh_axo = (axo[0], axo[1]["shared"]) if axo is not None and "shared" in axo[1] else None
        out = out + mlp_apply(p["shared"], x, cfg, axo=sh_axo)
    return out.to(x.dtype), aux
