"""Logical-axis sharding on a ``torch.distributed`` ``DeviceMesh``.

Counterpart of ``repro/models/sharding.py``.  Parameters and activations
carry *logical* axis names; a rule table maps each name to zero or more mesh
axes.  Two tables exist because FSDP shards a weight's logical dim
differently from the matching activation dim.  Mesh axes: ``pod``
(multi-pod only), ``data``, ``model``.

The reference resolves a leaf to a ``PartitionSpec`` (one entry per tensor
dim) and hands it to ``NamedSharding``.  Here :meth:`ShardingRules.resolve`
gives the same spec, a tuple with one entry per tensor dim (``None``, a mesh
axis name, or a tuple of them), and :func:`placements` turns it into DTensor
placements, one per *mesh* dim: ``Shard(i)`` on every mesh dim that tensor
dim ``i`` names, ``Replicate()`` on the others.  A dim over ``("pod",
"data")`` becomes ``Shard(i)`` on both mesh dims, split in mesh order, which
is the order of every multi-axis rule here.  The reference's two safeguards
stay: mesh axes the mesh lacks are dropped, and, given the shape, axes whose
size does not divide what is left of the dim are pruned greedily.

:func:`constrain` redistributes a DTensor activation to its logical
placements when a mesh is set (:func:`set_mesh`, which also sets the rule
table the model's activation sites read); off the mesh, or on a plain
tensor, it returns its argument.  The model calls it at the reference's
activation sites: the residual stream after the embedding and after each
layer (``res_seq``: Megatron sequence parallelism at train and prefill), the
logits, each mixer's queries (keys too for GQA) and output, and the MoE's
and Mamba-2's output.  :func:`write_slice` and :func:`assign` write a decode
cache in place, on each rank's block where the cache is a DTensor (a slice of
a sharded dim would be a gathered copy, and the write would be lost).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field, replace

__all__ = [
    "ShardingRules", "BASE_RULES", "mesh_spec", "spec_placements", "placements",
    "constrain", "set_mesh", "current_mesh", "gather_dims", "local_call", "write_slice",
    "assign",
]

MeshAxes = tuple[str, ...]


@dataclass(frozen=True)
class ShardingRules:
    """logical name -> tuple of mesh axes (() = replicated)."""

    param_rules: dict[str, MeshAxes] = field(default_factory=dict)
    act_rules: dict[str, MeshAxes] = field(default_factory=dict)

    def with_fsdp(self) -> "ShardingRules":
        """ZeRO-3 style: also shard the weights' 'embed' dims over data."""
        pr = dict(self.param_rules)
        pr["embed"] = ("data",)
        pr["expert_ff"] = ("data",)   # second expert dim: EP over model, FSDP over data
        return replace(self, param_rules=pr)

    def with_overrides(self, param: dict | None = None, act: dict | None = None) -> "ShardingRules":
        pr = dict(self.param_rules)
        pr.update(param or {})
        ar = dict(self.act_rules)
        ar.update(act or {})
        return ShardingRules(param_rules=pr, act_rules=ar)

    def resolve(self, axes: tuple[str | None, ...], kind: str = "param") -> tuple:
        """The spec of a leaf with logical ``axes``: per dim ``None``, one mesh
        axis, or a tuple of them; a mesh axis is used by one dim at most."""
        table = self.param_rules if kind == "param" else self.act_rules
        used: set[str] = set()
        parts = []
        for name in axes:
            if name is None:
                parts.append(None)
                continue
            mesh_axes = tuple(a for a in table.get(name, ()) if a not in used)
            used.update(mesh_axes)
            if len(mesh_axes) == 0:
                parts.append(None)
            elif len(mesh_axes) == 1:
                parts.append(mesh_axes[0])
            else:
                parts.append(mesh_axes)
        return tuple(parts)


BASE_RULES = ShardingRules(
    param_rules={
        # weight dims
        "embed": (),              # replicated unless FSDP
        "vocab": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "mlp": ("model",),
        "experts": ("model",),    # expert parallelism
        "expert_ff": (),
        "stack": (),              # layer-stack axis: never sharded
        "ssm_inner": ("model",),
        "lora": (),
        "head_dim": (),
    },
    act_rules={
        "batch": ("pod", "data"),
        "seq": (),
        "res_seq": (),            # residual-stream seq: ("model",) = Megatron-SP
        "kv_seq": (),             # decode KV caches: ("model",) / ("data","model")
        "kv_enc": (),             # cross-attention KV length (encoder/image tokens)
        "embed": (),
        "heads": ("model",),
        "kv_heads": (),           # KV heads: replicated
        "mlp": ("model",),
        "vocab": ("model",),
        "experts": ("model",),
        "capacity": (),
        "ssm_inner": ("model",),
        "ssm_heads": ("model",),
        "head_dim": (),
        "lora": (),
    },
)


def mesh_spec(mesh_names: tuple[str, ...], mesh_sizes: tuple[int, ...], spec: tuple,
              shape: tuple[int, ...] | None = None) -> tuple:
    """``spec`` with the reference's two safeguards (its ``named_sharding``):
    mesh axes not in ``mesh_names`` are dropped and, given ``shape``, axes
    whose size does not divide what is left of the dim are pruned greedily."""
    size = dict(zip(mesh_names, mesh_sizes))

    def keep(i: int, part):
        if part is None:
            return None
        parts = part if isinstance(part, tuple) else (part,)
        parts = tuple(p for p in parts if p in size)
        if shape is not None:
            kept = []
            dim = shape[i]
            for p in parts:
                if dim % size[p] == 0:
                    kept.append(p)
                    dim //= size[p]
            parts = tuple(kept)
        if not parts:
            return None
        return parts[0] if len(parts) == 1 else parts

    return tuple(keep(i, p) for i, p in enumerate(spec))


def spec_placements(mesh_names: tuple[str, ...], spec: tuple) -> list:
    """A resolved spec -> DTensor placements, one per mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh_names:
        dims = [i for i, part in enumerate(spec)
                if part == name or (isinstance(part, tuple) and name in part)]
        out.append(Shard(dims[0]) if dims else Replicate())
    for i, part in enumerate(spec):
        if isinstance(part, tuple) and list(part) != [n for n in mesh_names if n in part]:
            raise ValueError(f"dim {i} is split over {part}, not in the mesh's order "
                             f"{mesh_names}: DTensor's Shard splits in mesh order")
    return out


def placements(mesh, spec: tuple, shape: tuple[int, ...] | None = None) -> list:
    """DTensor placements of a leaf with resolved ``spec`` on ``mesh``."""
    names = tuple(mesh.mesh_dim_names)
    return spec_placements(names, mesh_spec(names, tuple(mesh.shape), spec, shape))


# the (mesh, rules) in scope (set_mesh); the reference reads JAX's ambient mesh
_MESH: list = []


@contextlib.contextmanager
def set_mesh(mesh, rules: ShardingRules | None = None):
    """Make ``mesh`` the ambient mesh of :func:`constrain` and the MoE's
    expert-parallel selection for the ``with`` block, and ``rules`` (default
    ``BASE_RULES``) the table the model's activation sites resolve by."""
    _MESH.append((mesh, BASE_RULES if rules is None else rules))
    try:
        yield mesh
    finally:
        _MESH.pop()


def current_mesh():
    """The mesh set by the innermost :func:`set_mesh`, or None."""
    return _MESH[-1][0] if _MESH else None


def constrain(x, rules: ShardingRules | None, *axes: str | None):
    """Redistribute a DTensor activation to its logical placements (no-op off
    the mesh or on a plain tensor).  ``rules=None`` reads the table
    :func:`set_mesh` set, as the model's sites do."""
    mesh = current_mesh()
    if mesh is None or math.prod(mesh.shape) == 1:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    rules = _MESH[-1][1] if rules is None else rules
    spec = rules.resolve(tuple(axes), kind="act")
    want = placements(x.device_mesh, spec, tuple(x.shape))
    return x if list(x.placements) == want else x.redistribute(x.device_mesh, want)


def assign(buf, val) -> None:
    """``buf.copy_(val)`` in place; on a DTensor ``buf`` each rank copies its
    block of the DTensor ``val`` (redistributed to ``buf``'s placements) into
    its shard."""
    from torch.distributed.tensor import DTensor

    if not isinstance(buf, DTensor):
        buf.copy_(val)
        return
    buf.to_local().copy_(val.redistribute(buf.device_mesh, buf.placements).to_local())


def write_slice(buf, val, dim: int, start: int) -> None:
    """``buf.narrow(dim, start, n).copy_(val)`` in place (n = ``val.shape[dim]``).

    On a DTensor ``buf`` each rank writes the rows of ``[start, start + n)``
    that fall in its block of ``dim`` into its local shard: the DTensor
    ``val`` is brought to ``buf``'s placements with ``dim`` replicated, and a rank
    whose block misses the rows writes nothing.  Splits are even (the rules'
    safeguards)."""
    from torch.distributed.tensor import DTensor, Replicate

    n = val.shape[dim]
    if not isinstance(buf, DTensor):
        buf.narrow(dim, start, n).copy_(val)
        return
    mesh = buf.device_mesh
    lo, size = 0, buf.shape[dim]
    want = []
    for i, p in enumerate(buf.placements):
        if p.is_shard(dim):
            size //= mesh.size(i)
            lo += mesh.get_local_rank(i) * size
            want.append(Replicate())
        else:
            want.append(p)
    a, b = max(start, lo), min(start + n, lo + size)
    val = val.redistribute(mesh, want).to_local()
    if a < b:
        buf.to_local().narrow(dim, a - lo, b - a).copy_(val.narrow(dim, a - start, b - a))


def gather_dims(x, *dims: int):
    """A DTensor with tensor ``dims`` all-gathered (its other shards kept),
    for the ops DTensor cannot run on a sharded dim; a plain tensor as is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    dims = {d % x.ndim for d in dims}
    pl = [Replicate() if isinstance(p, Shard) and p.dim in dims else p for p in x.placements]
    return x if list(x.placements) == pl else x.redistribute(x.device_mesh, pl)


def local_call(fn, xs: list, keep: list[tuple], out_keep: list[tuple], *args,
               grouped: list | None = None, **kw):
    """``fn`` on the local shards of DTensor operands, its outputs as DTensors.

    This is how a hand-written kernel (K7, K8) runs under a sharded step: it
    takes each rank's local tensors, never a DTensor.  ``keep[i]`` names, by
    role (role 0 the batch dim, role 1 the head dim or the sequence, role 2
    the head weight's vocabulary; ``None`` where ``xs[i]`` has none), the
    dims of ``xs[i]`` that may stay sharded; every other dim
    is all-gathered first.  A mesh dim keeps its shard only where every
    operand sharded on it is sharded on one role and every operand with that
    role divides evenly there; a replicated operand with the role is cut to
    match (a local slice), and one without it stays replicated.  Elsewhere
    the operands are gathered on it.  Outputs are sharded by role as
    ``out_keep`` says.  The gradient of an operand left replicated on a mesh
    dim the computation is split over is the sum of the ranks' (``Partial``).
    ``None`` operands pass through; with no DTensor operand ``fn`` runs as
    it is.

    ``grouped[i] = rep`` declares that ``xs[i]``'s head entries each serve
    ``rep`` contiguous heads of the other operands (GQA's K and V against
    the query heads).  Where a mesh dim of size n divides the heads H but
    not ``xs[i]``'s groups, and each rank's H / n heads lie in one group
    (H / n divides ``rep``), the heads stay split: ``xs[i]`` is replicated
    there and each rank narrows its local copy to the one group its heads
    read.  The narrow is a view (the group dim's stride, the head dim kept
    contiguous); the gradient outside it is zero, so the ``Partial`` sum is
    the whole gradient.  Otherwise the heads are gathered on that mesh dim.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    dts = [x for x in xs if isinstance(x, DTensor)]
    if not dts:
        return fn(*xs, *args, **kw)
    mesh = dts[0].device_mesh
    grouped = grouped or [None] * len(xs)

    def role_dim(x, kp, role):
        return kp[role] if isinstance(x, DTensor) and role < len(kp) else None

    roles = []    # per mesh dim: the role kept sharded, or None
    narrow = []   # per mesh dim: the grouped operands narrowed there
    for m in range(mesh.ndim):
        found = set()
        for x, kp in zip(xs, keep):
            if not isinstance(x, DTensor) or isinstance(x.placements[m], Replicate):
                continue
            p = x.placements[m]
            r = next((r for r, d in enumerate(kp) if isinstance(p, Shard) and p.dim == d),
                     None)
            found.add(-1 if r is None else r)   # Partial or a dim not kept: gather
        role = found.pop() if len(found) == 1 and -1 not in found else None
        cut = set()
        if role is not None:
            n = mesh.size(m)
            uneven = {i for i, (x, kp) in enumerate(zip(xs, keep))
                      if role_dim(x, kp, role) is not None and x.shape[kp[role]] % n}
            heads = [x.shape[kp[role]] for i, (x, kp) in enumerate(zip(xs, keep))
                     if role_dim(x, kp, role) is not None and not grouped[i]]
            if uneven and role == 1 and heads and all(grouped[i] for i in uneven) \
                    and all(grouped[i] % (heads[0] // n) == 0 for i in uneven):
                cut = uneven     # every rank reads one group of each
            elif uneven:         # every operand with the role cut evenly, or none
                role = None
        roles.append(role)
        narrow.append(cut)

    def want(kp, i=None):   # i: the operand, for the mesh dims that narrow it
        return [Shard(kp[r]) if r is not None and r < len(kp) and kp[r] is not None
                and i not in cut else Replicate() for r, cut in zip(roles, narrow)]

    def grad_of(i):
        # a replicated operand of a computation split over a mesh dim gets a
        # different gradient on each rank there: its gradient is their sum
        return [Partial() if isinstance(p, Replicate) and r is not None else p
                for p, r in zip(want(keep[i], i), roles)]

    def offset(i):
        """The global index of this rank's first entry of ``xs[i]``'s role-1
        dim under ``want(i)``."""
        d = keep[i][1]
        size, off = xs[i].shape[d], 0
        for m, p in enumerate(want(keep[i], i)):
            if isinstance(p, Shard) and p.dim == d:
                size //= mesh.size(m)
                off += mesh.get_local_rank(m) * size
        return off

    local = [x.redistribute(mesh, want(keep[i], i)).to_local(grad_placements=grad_of(i))
             if isinstance(x, DTensor) else x for i, x in enumerate(xs)]
    if any(narrow):
        lead = next(i for i, (x, kp) in enumerate(zip(xs, keep))
                    if role_dim(x, kp, 1) is not None and not grouped[i])
        for i in set().union(*narrow):
            local[i] = local[i].narrow(keep[i][1], offset(lead) // grouped[i] - offset(i), 1)
    out = fn(*local, *args, **kw)
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    wrapped = tuple(None if o is None else DTensor.from_local(o, mesh, want(kp),
                                                              run_check=False)
                    for o, kp in zip(outs, out_keep))
    return wrapped[0] if single else wrapped
