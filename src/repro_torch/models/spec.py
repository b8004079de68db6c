"""Parameter-spec trees: declare shapes once, then materialize them as tensors.

Counterpart of ``repro/models/spec.py``.  A spec tree is a nested dict of
:class:`ParamSpec` leaves; :func:`init_params` turns it into the same nested
dict of tensors.  Each normal leaf is drawn from its own ``torch.Generator``,
seeded from the leaf's path and the base seed exactly as the reference seeds
its ``jax.random`` keys, with the same ``std = scale / sqrt(fan_in)``.  The
values differ from ``jax.random``'s; two implementations compare on the same
weights through ``convert.params_from_jax``.  A leaf of more than two axes is
drawn one trailing (K, N) matrix at a time from its generator (an expert bank
of kimi-k2, (384, 7168, 2048), would be 22.5 GB as one f32 draw).  The
reference's sharding helpers
(``abstract_params``, ``param_pspecs``, ``param_shardings``) are not ported:
the port runs on one device.
"""

from __future__ import annotations

import hashlib
import itertools
import math
from dataclasses import dataclass

import torch

from ..core.engine import ExecutionContext

__all__ = ["ParamSpec", "init_params", "count_params", "stacked"]


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"          # normal | zeros | ones
    scale: float = 1.0            # stddev multiplier for normal init
    dtype: str | None = None      # override the tree-level dtype (e.g. fp32 states)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")

    def resolved_dtype(self, default: torch.dtype) -> torch.dtype:
        return getattr(torch, self.dtype) if self.dtype else default


def stacked(spec: ParamSpec, n: int) -> ParamSpec:
    """Add a leading layer-stack axis; the leaf keeps its own dtype.

    The reference's ``stacked`` drops the dtype, so its stacked Mamba state
    starts in the tree's dtype until the functional prefill replaces it with
    the scan's f32 state; the port writes that state into the cache in place,
    so the f32 has to be there from the start.
    """
    return ParamSpec(
        shape=(n, *spec.shape), axes=("stack", *spec.axes), init=spec.init, scale=spec.scale,
        dtype=spec.dtype,
    )


def _path_seed(path: str, base_seed: int) -> int:
    h = hashlib.blake2s(f"{base_seed}:{path}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") % (2**63)


def _leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def init_params(tree, seed: int = 0, dtype: torch.dtype = torch.bfloat16,
                device: str | torch.device | None = None):
    """Materialize a spec tree with deterministic per-leaf seeding.

    ``device`` defaults to the card and raises when none is present; pass
    ``"cpu"`` for the host.  A normal leaf of more than two axes is drawn
    one trailing (K, N) matrix at a time, each scaled and cast into the
    output, so the f32 scratch is one matrix.  On the CPU the draws come in
    the same order from the same generator, so the values equal one draw of
    the whole leaf bit for bit where a matrix holds a multiple of 16 elements
    (PyTorch's CPU normal sampler transforms uniforms 16 at a time); on the
    card they are the leaf's own values, drawn from its seed, not those one
    draw of the whole leaf would give.
    """
    dev = torch.device(ExecutionContext(device=device).device)

    def make(path: str, spec: ParamSpec):
        dt = spec.resolved_dtype(dtype)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=dev)
        gen = torch.Generator(device=dev).manual_seed(_path_seed(path, seed))
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale / math.sqrt(max(fan_in, 1))
        if len(spec.shape) <= 2:
            x = torch.randn(spec.shape, generator=gen, dtype=torch.float32, device=dev)
            return (x * std).to(dt)
        out = torch.empty(spec.shape, dtype=dt, device=dev)
        for idx in itertools.product(*map(range, spec.shape[:-2])):
            x = torch.randn(spec.shape[-2:], generator=gen, dtype=torch.float32, device=dev)
            out[idx] = x * std
        return out

    return _map_with_path(tree, make)


def count_params(tree) -> int:
    return sum(math.prod(s.shape) for _, s in _leaf_paths(tree))


def _map_with_path(tree, fn, prefix=""):
    if isinstance(tree, dict):
        return {k: _map_with_path(v, fn, f"{prefix}/{k}") for k, v in tree.items()}
    return fn(prefix, tree)
