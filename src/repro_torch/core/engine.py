"""Execution policy of the port's DSE stack (the ``ExecutionContext``).

Counterpart of ``repro/core/engine.py``.  One frozen object, threaded through
every engine, says:

  * ``backend`` -- ``"torch"`` (the device engines: characterization kernels,
    device GA, batched MaP scoring) or ``"numpy"`` (the host oracles);
  * ``device`` -- where the torch engines run.  It defaults to ``"cuda"`` under
    the torch backend and construction raises when no card is present, so an
    entry point runs on the card unless its caller asks for the CPU;
  * ``kernel_impl`` -- a preference resolved against each engine's menu
    (:data:`ENGINE_MENUS`): ``fastchar`` offers ``"table"`` (kernel K1),
    ``"entry"`` (kernel K2) and ``"plain"`` (the plain torch reduction);
    ``fastmoo`` offers ``"kernel"`` (K3) and ``"plain"``; ``fastapp`` (the
    application table matmuls) offers ``"table"`` (kernel K4), ``"entry"``
    (kernel K5), ``"gemm"`` (pair-plane f32 GEMMs), ``"entry_gather"``
    (gathers from synthesized planes, K5's plain version) and ``"plain"``
    (flattened gathers from the product tables, K4's plain version);
    ``axo_matmul`` (the AxO projections of the serving path) offers
    ``"kernel"`` (K6) and ``"plain"``, ``attention`` (the model's prefill
    attention) ``"kernel"`` (K7) and ``"plain"``, and ``ssd_scan`` (the
    Mamba-2 mixer's prefill scan) ``"kernel"`` (K8) and ``"plain"``.  One
    name means the same in every engine:
    ``"table"`` and ``"entry"`` pick the table-fed and the table-free kernel,
    ``"plain"`` the plain torch versions.  An engine whose menu does not hold
    the preference uses its own default.

The menus come from the kernel registry (``kernels.registry``), the one
place every implementation registers.

``tuning`` says where the engines' launch tiles come from
(:meth:`ExecutionContext.tuned_tiles`, ``kernels.tuning.tiles_for``):
``"off"`` (the default) the registry's defaults, which are the engines'
untuned choices bit for bit; ``"cached"`` the tuned winner of the on-disk
cache, searched once on a miss; ``"search"`` a fresh search once a process.

``telemetry`` is where the context's engines report spans and counters
(``"on"``, ``"off"``, a ``repro_torch.obs.Telemetry`` or ``None`` for the
process-wide current sink, :attr:`ExecutionContext.tel`); ``"on"`` also
turns the device taps on (the GA's per-generation curve).

``n_devices`` and ``shard_axes`` shard the DSE engines' independent batch
axes, as the reference's 1-D mesh does: ``"configs"`` (the D axis of
fastchar's partials and of fastapp's table primitives) and ``"lanes"`` (the
lanes of ``fastmoo.CompiledNSGA2.run_sweep``).  The design is single-
controller and in-process, like the reference's ``shard_map``: with
``device="cuda"`` shard *i* runs on ``cuda:i`` (construction raises when the
machine has fewer cards), with ``device="cpu"`` the *n* shards all run on the
host (the counterpart of the reference's forced host devices).  The host
launches each shard's slice on its device, so the launches of the shards
overlap on their cards, and gathers the results onto the first device in
shard order.  Batch entries are independent, so a sharded call is the
unsharded one on 1/n-th of the batch and its results are bit-identical.
No ``torch.distributed`` is used here.

On a CPU device the kernel wrappers run their plain versions; on a CUDA device
they launch the kernels or raise.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, replace

import torch

from ..kernels import registry

__all__ = ["BACKENDS", "ENGINE_MENUS", "KERNEL_IMPLS", "SHARD_AXES", "TUNING_POLICIES",
           "ExecutionContext", "as_context", "shard_plan"]

BACKENDS = ("torch", "numpy")
SHARD_AXES = ("configs", "lanes")
TUNING_POLICIES = ("off", "cached", "search")
ENGINE_MENUS = {engine: registry.impl_names(engine) for engine in registry.ENGINES}
KERNEL_IMPLS = tuple(sorted({i for menu in ENGINE_MENUS.values() for i in menu}))


@dataclass(frozen=True)
class ExecutionContext:
    """The execution-policy object consumed by every DSE engine of the port."""

    backend: str = "torch"
    device: str | None = None
    kernel_impl: str | None = None
    tuning: str = "off"
    telemetry: object | None = None
    n_devices: int | None = None
    shard_axes: tuple[str, ...] = SHARD_AXES

    def __post_init__(self) -> None:
        if self.telemetry is not None:
            # "on"/"off" become sink objects once, at construction
            from ..obs.telemetry import Telemetry, as_telemetry

            if not isinstance(self.telemetry, Telemetry):
                object.__setattr__(self, "telemetry", as_telemetry(self.telemetry))
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {self.backend!r}")
        if self.kernel_impl not in (None,) + KERNEL_IMPLS:
            raise ValueError(
                f"kernel_impl must be one of {(None,) + KERNEL_IMPLS}, "
                f"got {self.kernel_impl!r}"
            )
        if self.tuning not in TUNING_POLICIES:
            raise ValueError(f"tuning must be one of {TUNING_POLICIES}, got {self.tuning!r}")
        device = self.device
        if device is None:
            device = "cuda" if self.backend == "torch" else "cpu"
        device = str(torch.device(device))
        if device.startswith("cuda") and not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the torch engines on the CPU"
            )
        object.__setattr__(self, "device", device)
        axes = (self.shard_axes,) if isinstance(self.shard_axes, str) else tuple(self.shard_axes)
        object.__setattr__(self, "shard_axes", axes)
        if [a for a in axes if a not in SHARD_AXES] or len(set(axes)) != len(axes):
            raise ValueError(f"shard_axes must be distinct names from {SHARD_AXES}, got {axes!r}")
        if self.n_devices is not None:
            if not isinstance(self.n_devices, int) or self.n_devices < 1:
                raise ValueError(
                    f"n_devices must be a positive int or None, got {self.n_devices!r}")
            if self.n_devices > 1:
                if self.backend != "torch":
                    raise ValueError("sharded execution (n_devices > 1) requires "
                                     f"backend='torch', got backend={self.backend!r}")
                if not axes:
                    raise ValueError("n_devices > 1 with empty shard_axes: nothing to shard "
                                     f"-- name at least one of {SHARD_AXES} or drop n_devices")
                first = torch.device(device).index or 0
                if device.startswith("cuda") and torch.cuda.device_count() < first + self.n_devices:
                    raise ValueError(f"n_devices={self.n_devices} from {device} but the machine "
                                     f"has {torch.cuda.device_count()} CUDA devices")

    @property
    def is_torch(self) -> bool:
        return self.backend == "torch"

    @property
    def tel(self):
        """This context's telemetry sink (never None): the explicit sink, or
        the process-wide current one when the field was left default."""
        from ..obs.telemetry import current

        return current() if self.telemetry is None else self.telemetry

    @property
    def device_count(self) -> int:
        return 1 if self.n_devices is None else self.n_devices

    def shards(self, axis: str) -> bool:
        """Whether batch axis ``axis`` ('configs' | 'lanes') is sharded."""
        if axis not in SHARD_AXES:
            raise ValueError(f"unknown shard axis {axis!r} (not in {SHARD_AXES})")
        return self.device_count > 1 and axis in self.shard_axes

    def devices(self) -> list[str]:
        """The shards' devices: ``cuda:0 .. cuda:n-1``, or the host n times."""
        if not self.device.startswith("cuda"):
            return [self.device] * self.device_count
        first = torch.device(self.device).index or 0
        return [f"cuda:{first + i}" for i in range(self.device_count)]

    def shard_context(self, i: int) -> "ExecutionContext":
        """The unsharded context of shard ``i``: this policy on its device."""
        return replace(self, device=self.devices()[i], n_devices=None)

    def resolve_impl(self, engine: str, default: str) -> str:
        """The context's kernel impl if ``engine``'s menu offers it, else ``default``."""
        menu = ENGINE_MENUS[engine]
        if default not in menu:
            raise ValueError(f"default {default!r} is not on the {engine} menu {menu}")
        return self.kernel_impl if self.kernel_impl in menu else default

    def tuned_tiles(self, kernel: str, **shape) -> dict:
        """Launch tiles of registered kernel ``kernel`` at ``shape`` under
        this context's ``tuning`` policy (the registry's defaults when "off")."""
        from ..kernels.tuning import tiles_for

        return tiles_for(self, kernel, **shape)


# context -> the (engine, impl, shape bucket) shard plans it has built
_SHARD_PLANS_SEEN: "weakref.WeakKeyDictionary[ExecutionContext, set]" = \
    weakref.WeakKeyDictionary()


def shard_plan(ctx: ExecutionContext, engine: str, impl: str, bucket) -> list[ExecutionContext]:
    """The shard contexts of a sharded ``ctx`` for one (engine, impl, shape
    bucket).  The first plan of each is counted as ``shard.rebuild.<engine>``
    on the context's telemetry, as the reference counts its rebuilt sharded
    programs; the contexts themselves are cheap and built on every call."""
    seen = _SHARD_PLANS_SEEN.setdefault(ctx, set())
    if (engine, impl, bucket) not in seen:
        seen.add((engine, impl, bucket))
        ctx.tel.count(f"shard.rebuild.{engine}")
    return [ctx.shard_context(i) for i in range(ctx.device_count)]


def as_context(backend: "str | ExecutionContext | None") -> ExecutionContext:
    """Normalize a backend string (or an existing context) to a context.

    ``None`` and ``"torch"`` give the device engines on the card (raising when
    no card is present); ``"numpy"`` gives the host oracle.
    """
    if isinstance(backend, ExecutionContext):
        return backend
    return ExecutionContext(backend="torch" if backend is None else backend)
