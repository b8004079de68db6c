"""Parameter-spec trees: declare shapes once, then materialize them as tensors.

Counterpart of ``repro/models/spec.py``.  A spec tree is a nested dict of
:class:`ParamSpec` leaves; :func:`init_params` turns it into the same nested
dict of tensors.  Each normal leaf is drawn from its own ``torch.Generator``,
seeded from the leaf's path and the base seed exactly as the reference seeds
its ``jax.random`` keys, with the same ``std = scale / sqrt(fan_in)``.  The
values differ from ``jax.random``'s; two implementations compare on the same
weights through ``convert.params_from_jax``.  A leaf of more than two axes is
drawn one trailing (K, N) matrix at a time from its generator (an expert bank
of kimi-k2, (384, 7168, 2048), would be 22.5 GB as one f32 draw).

The reference's ``param_shardings`` becomes :func:`param_placements` (each
leaf's DTensor placements on a ``DeviceMesh``, with ``models.sharding``'s
safeguards); :func:`distribute_params` turns a tree of full tensors, the
same on every rank, into DTensors placed so.  :func:`abstract_params` is
the reference's: the tree's leaves with their shapes, dtypes and placements
and no storage (fake tensors), which is what the dry-run traces.
"""

from __future__ import annotations

import hashlib
import itertools
import math
from dataclasses import dataclass

import torch

from ..core.engine import ExecutionContext

__all__ = ["ParamSpec", "init_params", "abstract_params", "count_params", "stacked",
           "param_placements", "distribute_params"]


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
                device: str | torch.device | None = None, mesh=None, rules=None,
                kind: str = "param"):
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

    With ``mesh`` (a ``DeviceMesh``) every leaf comes back as a DTensor
    placed by ``rules`` (default ``BASE_RULES``; :func:`param_placements`),
    and each rank keeps only its block: the draws run in the same order (a
    leaf of up to two axes drawn whole and cut, a stacked leaf a matrix at a
    time, the matrices outside the block drawn and dropped), so the blocks
    equal those of the unplaced tree and no rank keeps a whole leaf.
    ``kind="act"`` places the leaves by the activation rules (a decode cache).
    A ``torch.device`` (a tensor's own) is taken as it is.
    """
    dev = device if isinstance(device, torch.device) else \
        torch.device(ExecutionContext(device=device).device)
    if mesh is not None:
        from .sharding import BASE_RULES, placements

        rules = BASE_RULES if rules is None else rules

    def make(path: str, spec: ParamSpec):
        dt = spec.resolved_dtype(dtype)
        if mesh is None:
            block = tuple(slice(0, n) for n in spec.shape)
        else:
            pl = placements(mesh, rules.resolve(spec.axes, kind=kind), spec.shape)
            block = _block(spec.shape, mesh, pl)
        shape = tuple(b.stop - b.start for b in block)
        if spec.init == "zeros":
            out = torch.zeros(shape, dtype=dt, device=dev)
        elif spec.init == "ones":
            out = torch.ones(shape, dtype=dt, device=dev)
        else:
            gen = torch.Generator(device=dev).manual_seed(_path_seed(path, seed))
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            std = spec.scale / math.sqrt(max(fan_in, 1))
            if len(spec.shape) <= 2:
                x = torch.randn(spec.shape, generator=gen, dtype=torch.float32, device=dev)
                out = (x[block] * std).to(dt)
            else:
                out = torch.empty(shape, dtype=dt, device=dev)
                lead = block[:-2]
                for idx in itertools.product(*map(range, spec.shape[:-2])):
                    x = torch.randn(spec.shape[-2:], generator=gen, dtype=torch.float32,
                                    device=dev)
                    if all(b.start <= i < b.stop for i, b in zip(idx, lead)):
                        out[tuple(i - b.start for i, b in zip(idx, lead))] = \
                            x[block[-2:]] * std
        if mesh is None:
            return out
        return _placed(out.contiguous(), mesh, pl, spec.shape)

    return _map_with_path(tree, make)


def _placed(local: torch.Tensor, mesh, pl, shape: tuple[int, ...]):
    """A DTensor of global ``shape`` (contiguous) from this rank's block."""
    from torch.distributed.tensor import DTensor

    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


def abstract_params(tree, dtype: torch.dtype = torch.bfloat16,
                    device: str | torch.device = "cuda", mesh=None, rules=None,
                    kind: str = "param", mode=None):
    """The tree :func:`init_params` would give, as fake tensors: each leaf's
    shape, dtype and device (and, with ``mesh``, its placements and this
    rank's block of a DTensor) with nothing allocated.

    ``mode`` is the ``FakeTensorMode`` the leaves belong to (default: a new
    one); a step traced on them runs under that mode.  No card is needed for
    ``device="cuda"``.
    """
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode(allow_non_fake_inputs=True) if mode is None else mode
    dev = torch.device(device)
    if mesh is not None:
        from .sharding import BASE_RULES, placements

        rules = BASE_RULES if rules is None else rules

    def make(_, spec: ParamSpec):
        dt = spec.resolved_dtype(dtype)
        if mesh is None:
            with mode:
                return torch.empty(spec.shape, dtype=dt, device=dev)
        pl = placements(mesh, rules.resolve(spec.axes, kind=kind), spec.shape)
        shape = tuple(b.stop - b.start for b in _block(spec.shape, mesh, pl))
        with mode:
            return _placed(torch.empty(shape, dtype=dt, device=dev), mesh, pl, spec.shape)

    return _map_with_path(tree, make)


def _block(shape: tuple[int, ...], mesh, pl) -> tuple[slice, ...]:
    """This rank's block of a leaf of ``shape`` under placements ``pl``: a
    dim split over several mesh dims is split by each in mesh order, as
    DTensor splits it.  The splits are even (the rules' safeguards keep only
    mesh axes that divide the dim)."""
    start, size = [0] * len(shape), list(shape)
    for i, q in enumerate(pl):
        if q.is_shard():
            n, d = mesh.size(i), q.dim
            if size[d] % n:
                raise ValueError(f"dim {d} of {shape} does not split {n} ways")
            size[d] //= n
            start[d] += mesh.get_local_rank(i) * size[d]
    return tuple(slice(a, a + n) for a, n in zip(start, size))


def count_params(tree) -> int:
    return sum(math.prod(s.shape) for _, s in _leaf_paths(tree))


def _map_with_path(tree, fn, prefix=""):
    if isinstance(tree, dict):
        return {k: _map_with_path(v, fn, f"{prefix}/{k}") for k, v in tree.items()}
    return fn(prefix, tree)


def param_placements(tree, rules, mesh, kind: str = "param"):
    """Each leaf's DTensor placements on ``mesh`` (the reference's
    ``param_shardings``): its resolved spec, pruned to what divides its shape."""
    from .sharding import placements

    return _map_with_path(
        tree, lambda _, s: placements(mesh, rules.resolve(s.axes, kind=kind), s.shape))


def distribute_params(values, tree, rules, mesh, kind: str = "param"):
    """Full tensors (the same on every rank) -> DTensors placed by ``rules``.

    ``values`` mirrors the spec ``tree``; each rank keeps its own shard, cut
    locally (no collective) and never sharing storage with ``values``.
    """
    from torch.distributed.tensor import distribute_tensor

    place = param_placements(tree, rules, mesh, kind)

    def put(v, pl):
        if isinstance(v, dict):
            return {k: put(v[k], pl[k]) for k in v}
        out = distribute_tensor(v, mesh, pl, src_data_rank=None)
        # a replicated leaf may alias ``v``; the train step updates in place
        local = out.to_local()
        if local.untyped_storage().data_ptr() == v.untyped_storage().data_ptr():
            out = out.clone()
        return out

    return put(values, place)
