"""AdamW with f32 moments (parameters may be bf16) and decoupled weight decay.

Counterpart of ``repro/optim/adamw.py``, its formulas and their order of
rounding: the moments in f32, bias correction at ``t = step + 1``, the decay
inside the f32 update.  ``torch.optim.AdamW`` is not a substitute: it rounds
the decay and the step into a bf16 parameter separately.  The moments are
updated in place (``optim/base.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.spec import ParamSpec
from .base import Optimizer, spec_map, tree_map

__all__ = ["adamw"]


def adamw(
    lr_fn,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)   # keeps a DTensor's placement
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        f32 = np.float32
        lr = float(f32(lr_fn(step)))
        t = f32(int(step) + 1)
        bc1 = float(f32(1) - f32(b1) ** t)
        bc2 = float(f32(1) - f32(b2) ** t)

        def one(g, m, v, p):
            g = g.to(torch.float32)
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g * (1 - b2) * g)
            denom = (v / bc2).sqrt_().add_(eps)
            upd = (m / bc1).div_(denom)
            if weight_decay:
                upd.add_(p.to(torch.float32) * weight_decay)
            return upd.mul_(-lr)

        return tree_map(one, grads, state["m"], state["v"], params), state

    def state_spec(spec_tree):
        def one(s):
            return ParamSpec(s.shape, s.axes, init="zeros", dtype="float32")

        moments = spec_map(one, spec_tree)
        return {"m": moments, "v": moments}

    return Optimizer(init=init, update=update, state_spec=state_spec)
