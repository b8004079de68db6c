"""Trace one dry-run cell's step on fake tensors: the per-device record.

Counterpart of ``repro/launch/lowering.py``.  The reference lowers the
cell's jitted step from ShapeDtypeStructs and compiles it for 256 or 512
forced host devices.  The port runs the step once, eagerly, on fake tensors
(``FakeTensorMode``: shapes, dtypes and devices, no storage, no launch) on a
``DeviceMesh`` over a world of fake ranks (:func:`fake_world`,
``torch.distributed``'s ``fake`` backend: every collective returns at once
and moves nothing).  The parameters (and the optimizer state of a train
cell, the cache of a decode cell) are ``models.spec.abstract_params``
DTensors; the data inputs are ``configs.registry.input_specs``.  K7 and K8
pass as their custom ops' fake implementations and are counted by their
cost formulas (``kernels.flash_attention``, ``kernels.ssd_scan``); on a
``cpu`` device they take their plain versions, as on real CPU tensors.

:class:`StepCounter`, a dispatch mode, sees every op that runs on a local
tensor (DTensor hands each op's local shards down to it; the sharding
propagation's own global-shape trial runs are left out), so every count is
one rank's:

* ``flops``: the ``torch.utils.flop_counter`` formula of each local op (a
  matmul sharded N ways counts 1/N of its FLOPs, a replicated one all of
  them), the custom ops' formulas included;
* ``bytes``: each local op's operand and result bytes (views, metadata ops
  and ``empty`` allocations count nothing);
* ``coll_<kind>``: the operand bytes of each collective by kind
  (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``), DTensor's functional collectives and the c10d
  calls of the expert-parallel MoE bodies alike, and ``coll_total``;
* ``peak_bytes``: the most bytes of live storage at any point of the step,
  the arguments included (each storage counted from the op that made it
  until it is freed);
* ``argument_size_in_bytes``: the local bytes of the parameters, optimizer
  state, batch (or tokens, frontend, cache and index) and the step counter.

``lower_step(..., grads_only=True)`` traces a train cell's forward and
backward alone (``train_step.grads``: no clip, no optimizer update), with
the same arguments held, so its ``peak_bytes`` is that phase's peak.

The record is rank 0's.  The rules' safeguards split every sharded dim
evenly; where a split is uneven DTensor gives rank 0 the largest chunk, so
rank 0's numbers are the per-device maximum.

A decode step reads its cache index on the host (``int(index)``); the trace
gives it ``seq_len - 1``, the last slot (the direct decode attention reads
the whole cache, masked, so the costs do not depend on it).  Under a fake
tensor mode PyTorch builds some strided-shard index lists as fake tensors
and then reads them (``_StridedShard.local_shard_size_and_offset``, met when
a residual stream sharded over batch and sequence is flattened for a
matmul); :func:`lower_step` runs that host arithmetic on real tensors.
"""

from __future__ import annotations

import contextlib
import sys
import time
import weakref

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..configs.registry import input_specs
from ..models.model import model_spec
from ..models.sharding import ShardingRules
from ..models.spec import abstract_params
from ..optim import cosine_schedule, make_optimizer, tree_leaves
from .steps import (
    abstract_cache,
    batch_placements,
    make_decode_step,
    make_prefill_step,
    make_train_step,
)

__all__ = ["lower_step", "fake_world", "StepCounter", "COLLECTIVES"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# collective op -> (kind, index of its operand argument)
_COLL_OPS = {
    "_c10d_functional::all_gather_into_tensor": ("all-gather", 0),
    "_c10d_functional::all_gather_into_tensor_coalesced": ("all-gather", 0),
    "_c10d_functional::all_reduce": ("all-reduce", 0),
    "_c10d_functional::all_reduce_coalesced": ("all-reduce", 0),
    "_c10d_functional::reduce_scatter_tensor": ("reduce-scatter", 0),
    "_c10d_functional::reduce_scatter_tensor_coalesced": ("reduce-scatter", 0),
    "_c10d_functional::all_to_all_single": ("all-to-all", 0),
    "_dtensor::shard_dim_alltoall": ("all-to-all", 0),
    "c10d::allreduce_": ("all-reduce", 0),
    "c10d::allreduce_coalesced_": ("all-reduce", 0),
    "c10d::allgather_": ("all-gather", 1),
    "c10d::_allgather_base_": ("all-gather", 1),
    "c10d::allgather_into_tensor_coalesced_": ("all-gather", 1),
    "c10d::reduce_scatter_": ("reduce-scatter", 1),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d::alltoall_": ("all-to-all", 1),
    "c10d::alltoall_base_": ("all-to-all", 1),
    "c10d::send": ("collective-permute", 0),
}
_NO_BYTES = ("aten::empty", "aten::new_empty", "aten::detach", "aten::lift_fresh",
             "aten::alias", "prim::")


def fake_world(world_size: int) -> None:
    """(Re)start this process as rank 0 of a fake world of ``world_size``
    ranks (``torch.distributed``'s ``fake`` backend); no card is needed."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _in_propagation() -> bool:
    """Whether the running op is one of DTensor's sharding-propagation trial
    runs (global shapes, not work a rank does)."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


class StepCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts one rank's FLOPs, bytes, collective bytes and live storage
    (module docstring).  Enter it inside the ``FakeTensorMode`` the
    tensors belong to; :meth:`track` registers tensors that exist before
    the step (its arguments)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flops = flop_registry
        self.flops = 0
        self.bytes = 0
        self.coll = {k: 0 for k in COLLECTIVES}
        self.n_ops = 0
        self.live = 0
        self.peak = 0
        self._storages: dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def _hold(self, t: torch.Tensor) -> None:
        from torch.distributed.tensor import DTensor

        if isinstance(t, DTensor):
            t = t.to_local()
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        weakref.finalize(st, self._free, key)
        self.live += n
        self.peak = max(self.peak, self.live)

    def hold_bytes(self, n: int) -> None:
        """Count ``n`` bytes live from now on (arguments held elsewhere)."""
        self.live += n
        self.peak = max(self.peak, self.live)

    def track(self, tree) -> int:
        """Hold every tensor leaf of ``tree``; returns their local bytes."""
        from torch.distributed.tensor import DTensor

        leaves = [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]
        for x in leaves:
            self._hold(x)
        return sum(_nbytes(x.to_local() if isinstance(x, DTensor) else x) for x in leaves)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented   # DTensor runs the op on its local shards, seen below
        out = func(*args, **kwargs)
        outs = list(_tensors(out))
        if not any(isinstance(t, FakeTensor) for t in outs) or _in_propagation():
            return out
        self.n_ops += 1
        name = func._schema.name
        coll = _COLL_OPS.get(name)
        if coll is not None:
            kind, i = coll
            self.coll[kind] += _nbytes(args[i] if i < len(args) else 0)
        fn = self._flops.get(func._overloadpacket)
        if fn is not None:
            self.flops += int(fn(*args, **kwargs, out_val=out))
        if not func.is_view and not name.startswith(_NO_BYTES):
            self.bytes += (sum(_nbytes(t) for t in _tensors(args))
                           + sum(_nbytes(t) for t in _tensors(kwargs)) + _nbytes(outs))
        for t in outs:
            self._hold(t)
        return out

    def record(self) -> dict:
        out = {"flops": float(self.flops), "bytes": float(self.bytes),
               "coll_total": float(sum(self.coll.values()))}
        out.update({f"coll_{k}": float(v) for k, v in self.coll.items()})
        out["peak_bytes"] = int(self.peak)
        out["n_ops"] = self.n_ops
        return out


@contextlib.contextmanager
def _strided_shard_on_host():
    """Run ``_StridedShard.local_shard_size_and_offset``'s index arithmetic
    on real tensors while a fake mode is active (module docstring)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor.placement_types import _StridedShard

    orig = _StridedShard.__dict__.get("local_shard_size_and_offset")
    if orig is None:   # a release without it
        yield
        return

    def on_host(*a, **k):
        with unset_fake_temporarily():
            return orig(*a, **k)

    _StridedShard.local_shard_size_and_offset = on_host
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = orig


def _local_bytes(specs: dict, mesh, rules: ShardingRules) -> int:
    """This rank's bytes of the data inputs ``specs`` (global shapes), split
    as ``batch_placements`` splits them."""
    place = {} if mesh is None else batch_placements(rules, mesh, specs)
    total = 0
    for k, x in specs.items():
        n = x.numel() * x.element_size()
        for i, p in enumerate(place.get(k, ())):
            if p.is_shard():
                n //= mesh.size(i)
        total += n
    return total


def lower_step(cfg: ModelConfig, shape: ShapeConfig, mesh, rules: ShardingRules, *,
               device: str = "cuda", dtype: torch.dtype = torch.bfloat16, ctx=None,
               grads_only: bool = False) -> dict:
    """Trace the cell's step once on fake tensors; returns rank 0's record
    (module docstring) with ``t_trace_s``, the trace's wall seconds.

    ``mesh`` is a ``DeviceMesh`` over a fake world (:func:`fake_world`) or
    None for one device; ``ctx`` picks K7/K8 (default) or their plain
    versions.  Nothing is allocated on ``device`` (no card is needed for
    ``"cuda"``; a train cell's backward on fake ``cuda`` tensors needs the
    CUDA build of PyTorch).  ``grads_only`` traces a train cell's forward
    and backward without the clip and the update (module docstring).
    """
    if grads_only and shape.kind != "train":
        raise ValueError(f"grads_only traces a train cell, not {shape.kind!r}")
    from torch._subclasses.fake_tensor import FakeTensorMode

    spec = model_spec(cfg)
    specs = input_specs(cfg, shape, dtype)
    dev = torch.device(device)
    t0 = time.time()
    with contextlib.ExitStack() as stack:
        mode = stack.enter_context(FakeTensorMode(allow_non_fake_inputs=True))
        stack.enter_context(_strided_shard_on_host())

        def fake(x):
            return {k: fake(v) for k, v in x.items()} if isinstance(x, dict) else \
                torch.empty(x.shape, dtype=x.dtype, device=dev)

        counter = StepCounter()

        def data_bytes(data: dict) -> int:
            """The data inputs' local bytes, held from the start (each rank
            keeps its rows of the full batch the step is handed)."""
            n = _local_bytes(data, mesh, rules)
            counter.hold_bytes(n)
            return n

        params = abstract_params(spec, dtype, dev, mesh=mesh, rules=rules, mode=mode)
        args = counter.track(params)
        if shape.kind == "train":
            opt = make_optimizer(cfg.optimizer, cosine_schedule(3e-4))
            state = abstract_params(opt.state_spec(spec), dtype, dev, mesh=mesh, rules=rules,
                                    mode=mode)
            args += counter.track(state) + data_bytes(specs["batch"])
            args += 4   # the int32 step counter
            fn = make_train_step(cfg, opt, ctx=ctx, mesh=mesh, rules=rules)
            with counter:
                if grads_only:
                    fn.grads(params, fake(specs["batch"]))
                else:
                    fn(params, state, 0, fake(specs["batch"]))
        elif shape.kind == "prefill":
            args += data_bytes(dict(specs))
            front = specs.get("enc_embeds", specs.get("img_embeds"))
            fn = make_prefill_step(cfg, shape.seq_len, ctx=ctx, mesh=mesh, rules=rules)
            with counter:
                fn(params, fake(specs["tokens"]), None if front is None else fake(front))
        elif shape.kind == "decode":
            cache = abstract_cache(cfg, shape.global_batch, shape.seq_len, dtype=dtype,
                                   device=dev, mesh=mesh, rules=rules, mode=mode)
            args += counter.track(cache) + data_bytes({"tokens": specs["tokens"]})
            args += 4   # the int32 index
            fn = make_decode_step(cfg, ctx=ctx, mesh=mesh, rules=rules)
            with counter:
                fn(params, cache, fake(specs["tokens"]), shape.seq_len - 1)
        else:
            raise ValueError(f"unknown shape kind {shape.kind!r}")
    rec = counter.record()
    rec["argument_size_in_bytes"] = int(args)
    rec["peak_bytes"] = max(rec["peak_bytes"], int(args))
    rec["temp_size_in_bytes"] = rec["peak_bytes"] - int(args)
    rec["t_trace_s"] = time.time() - t0
    return rec
