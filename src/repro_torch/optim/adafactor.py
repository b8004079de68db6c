"""Adafactor: factored second moments, no first moment, RMS update clipping
(Shazeer & Stern, 2018).

Counterpart of ``repro/optim/adafactor.py``: a leaf of two or more axes keeps
row and column factors of its second moment over its last two axes
(``{"vr", "vc"}``), a vector keeps the whole moment (``{"v"}``); the decay
is the step-dependent ``min(decay, 1 - t^-0.8)`` at ``t = step + 1``.  The
large archs (deepseek-v3, kimi-k2, the VLM) train with it.  The factors are
updated in place (``optim/base.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.spec import ParamSpec
from .base import Optimizer, spec_map, tree_map

__all__ = ["adafactor"]


def _is_factored(shape) -> bool:
    return len(shape) >= 2


def adafactor(
    lr_fn,
    decay: float = 0.99,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
) -> Optimizer:
    def init(params):
        def one(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32, device=p.device)
            if _is_factored(p.shape):
                return {"vr": z(p.shape[:-1]), "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}

        return tree_map(one, params)

    @torch.no_grad()
    def update(grads, state, params, step):
        f32 = np.float32
        lr = float(f32(lr_fn(step)))
        t = f32(int(step) + 1)
        beta = min(f32(decay), f32(1) - t ** f32(-0.8))
        keep, mix = float(beta), float(f32(1) - beta)

        def one(g, s, p):
            g = g.to(torch.float32)
            g2 = (g * g).add_(eps)
            if _is_factored(g.shape):
                vr = s["vr"].mul_(keep).add_(g2.mean(dim=-1) * mix)
                vc = s["vc"].mul_(keep).add_(g2.mean(dim=-2) * mix)
                del g2
                # the rank-1 reconstruction of the second moment
                denom = vr[..., :, None] * vc[..., None, :]
                denom.div_(torch.clamp(vr.mean(dim=-1)[..., None, None], min=eps))
            else:
                denom = s["v"].mul_(keep).add_(g2 * mix).clone()
            upd = g * denom.clamp_(min=eps).rsqrt_()
            del denom
            rms = torch.sqrt(torch.mean(upd * upd) + eps)
            upd.div_(torch.clamp(rms / clip_threshold, min=1.0))
            if weight_decay:
                upd.add_(p.to(torch.float32) * weight_decay)
            return upd.mul_(-lr)

        return tree_map(one, grads, state, params), state

    def state_spec(spec_tree):
        def one(s):
            if _is_factored(s.shape):
                return {
                    "vr": ParamSpec(s.shape[:-1], s.axes[:-1], init="zeros", dtype="float32"),
                    "vc": ParamSpec(s.shape[:-2] + s.shape[-1:], s.axes[:-2] + s.axes[-1:],
                                    init="zeros", dtype="float32"),
                }
            return {"v": ParamSpec(s.shape, s.axes, init="zeros", dtype="float32")}

        return spec_map(one, spec_tree)

    return Optimizer(init=init, update=update, state_spec=state_spec)
