"""The application-BEHAV engine on the device (the apps' ``backend="torch"`` path).

Counterpart of ``repro/apps/fastapp.py``.  The numpy application substrate
scores a ``(D, L)`` config batch one product table at a time; this module
scores a whole :class:`TableBatch` per call through interchangeable routes for
the batched table matmul ``out[d, m, n] = sum_k T_d[a[m, k], b[k, n]]``
(:data:`MATMUL_IMPLS`, the ``fastapp`` menu of ``core.engine``):

  ``"table"``  (the default for config-shared ``(M, K)`` codes) -- kernel K4,
      ``kernels.app_kernels.table_gemv``, over the flattened product tables.
  ``"entry"``  -- kernel K5, ``entry_gemv``: table-free, the planes are
      synthesized from the ``(D, R)`` config masks inside the kernel.
  ``"gemm"``   -- pair-plane f32 GEMMs: ``T_d[a, b] = sum_r 4^r S_d[r,
      pair_r(a), b]`` with ``pair_r(a)`` one of 4 values, so a table matmul is
      R dense GEMMs against the per-row ``(R, D, 4, B)`` planes.  Every
      partial is an integer below 2^24 (``_gemm_ok``), so f32 is exact.
  ``"plain"``  -- flattened gathers from the product tables (K4's plain
      version; no kernel, as ``"plain"`` means in every engine).
  ``"entry_gather"`` -- flattened per-row gathers from planes synthesized in
      torch (K5's plain version).

Per-config ``(D, M, K)`` codes (the FFN's requantized activations) take the
gather routes.  A convolution is the N=1 table matmul of its windows against
its taps: ``"table"`` launches K4 on them, ``"gemm"`` and the entry routes
contract them with the pair-plane GEMM as the reference does, and
``"plain"`` gathers.
A route asked for explicitly that cannot run the batch raises; a context
preference gives way only where the reference's does.

12-bit operators take the table-free routes only: their product and row
tables (67 MB and 1 GB) are not built, so ``"entry"`` launches K5's 12-bit
instance (``entry_gemv_wide``) on config-shared codes, per-config codes take
``"entry_gather"``, and a convolution within the f32 bound contracts the
synthesized planes with the pair-plane GEMM, as the reference does.  Sums
are int32 modulo 2^32, as the reference's.

Per-app BEHAV heads combine the integer device outputs on the host in float64
with exactly the oracle's expressions, which keeps every app BEHAV equal to
the numpy path.  A table matmul counts ``dispatch.fastapp.<impl>`` on the
batch context's telemetry, and K4's route and gather tiles resolve through
the kernel registry under its ``tuning`` policy (``kernels.tuning.
tiles_for``; ``app_kernels.plan``'s choice untuned).

A batch whose context shards ``"configs"`` (``ExecutionContext(n_devices=
n)``) and whose D the shard count divides (the reference's
``_config_mesh_ctx``) runs every primitive shard by shard: the batch is cut
once into n contiguous sub-batches on the shards' devices (their planes and
tables built there, once), each shard takes the route the unsharded call
takes (K4 staged or gather as ``app_kernels.plan`` picks, K5, ``gemm``,
``entry_gather`` or ``plain``), and the outputs are gathered onto the first
device in shard order; configs are independent, so the results are the
unsharded call's bit for bit.  Each (context, route, shape bucket) counts
``shard.rebuild.fastapp`` once.  Left out against the reference: the
power-of-two bucket padding of config chunks, which only bounds JAX
recompiles.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.engine import ENGINE_MENUS, ExecutionContext, shard_plan
from ..core.fastchar import _gather_small
from ..core.operator_model import OperatorSpec, _synth_small, config_to_masks, spec_for
from ..kernels import app_kernels, registry
from ..kernels.app_kernels import _pair
from ..kernels.tuning import launch_overrides
from ..obs.telemetry import current

__all__ = [
    "MATMUL_IMPLS",
    "TableBatch",
    "table_batch",
    "product_tables_torch",
    "table_matmul_torch",
    "table_conv1d_torch",
    "table_conv2d_torch",
    "mismatch_counts",
    "app_behav_torch",
    "multi_app_behav_torch",
]

MATMUL_IMPLS = ENGINE_MENUS["fastapp"]
_ENTRY_ROUTES = ("entry", "entry_gather")
CONV_D_CHUNK = 16  # configs per gather of the convolutions (reference conv2d default)


# ---------------------------------------------------------------------------
# Device-resident tables
# ---------------------------------------------------------------------------


def _tables_from_small(small: torch.Tensor, n_bits: int) -> torch.Tensor:
    """(R, D, 4, B) per-row planes -> (D, 2^N, 2^N) int32 product tables."""
    codes = torch.arange(1 << n_bits, device=small.device)
    approx = None
    for r in range(small.shape[0]):
        term = small[r][:, _pair(codes, r), :] << (2 * r)     # (D, A, B)
        approx = term if approx is None else approx + term
    return approx.contiguous()


@dataclass
class TableBatch:
    """A config batch on the device: masks now, planes and tables on demand.

    ``small`` (the ``(R, D, 4, 2^N)`` planes gathered from the row tables)
    feeds the pair-plane GEMM; ``entry_small`` (the same planes synthesized
    from the masks) feeds the table-free gathers; the full ``(D, 2^N, 2^N)``
    product tables are built from ``small`` only when a table route asks.
    Each is built once and shared by every app head scoring the batch.
    """

    masks: torch.Tensor | None       # (D, R) int32, None when built from tables
    n_bits: int
    ctx: ExecutionContext | None = None  # execution policy for the primitives
    _small: torch.Tensor | None = field(default=None, repr=False)
    _tables: torch.Tensor | None = field(default=None, repr=False)
    _entry_small: torch.Tensor | None = field(default=None, repr=False)
    _shards: list | None = field(default=None, repr=False)

    def __len__(self) -> int:
        src = self.masks if self.masks is not None else self._tables
        return src.shape[0]

    @property
    def device(self) -> torch.device:
        src = self.masks if self.masks is not None else self._tables
        return src.device

    @property
    def n_codes(self) -> int:
        return 1 << self.n_bits

    @property
    def has_small(self) -> bool:
        return self._small is not None or (
            self.masks is not None and self.n_bits <= app_kernels.MAX_BITS)

    def _need_masks(self, what: str) -> None:
        if self.masks is None:
            raise ValueError(
                f"TableBatch built from raw product tables has no config masks "
                f"for {what}; construct it with table_batch(spec, configs)"
            )

    @property
    def small(self) -> torch.Tensor:
        if self._small is None:
            self._need_masks("the per-row planes")
            if self.n_bits > app_kernels.MAX_BITS:
                raise ValueError(f"the row tables stop at {app_kernels.MAX_BITS} bits: a "
                                 f"{self.n_bits}-bit batch takes the table-free routes")
            self._small = _gather_small(self.masks, self.n_bits)
        return self._small

    @property
    def entry_small(self) -> torch.Tensor:
        """Per-row planes synthesized from the masks; equal to ``small``."""
        if self._entry_small is None:
            self._need_masks("the table-free routes")
            planes = _synth_small(spec_for(self.n_bits), self.masks, torch, torch.int32)
            self._entry_small = torch.stack(planes)
        return self._entry_small

    @property
    def tables(self) -> torch.Tensor:
        if self._tables is None:
            self._tables = _tables_from_small(self.small, self.n_bits)
        return self._tables


def table_batch(
    spec: OperatorSpec, configs: np.ndarray, ctx: ExecutionContext | None = None
) -> TableBatch:
    """(D, L) {0,1} configs -> a TableBatch on ``ctx.device`` (default the card).

    Signed multipliers of up to 12 bits (above 8 bits the table-free routes
    only).  The batch carries ``ctx``, so every primitive scoring it
    resolves its route from the same kernel-impl preference.
    """
    if spec.op != "mul" or not spec.signed or spec.n_bits > app_kernels.ENTRY_MAX_BITS:
        raise ValueError(f"application BEHAV takes signed multipliers of up to "
                         f"{app_kernels.ENTRY_MAX_BITS} bits, got {spec.tag}")
    ctx = ctx if ctx is not None else ExecutionContext()
    configs = np.atleast_2d(np.asarray(configs)).astype(np.uint8)
    masks = torch.from_numpy(config_to_masks(spec, configs).astype(np.int32))
    return TableBatch(masks=masks.to(ctx.device), n_bits=spec.n_bits, ctx=ctx)


def _as_batch(tables) -> TableBatch:
    """A TableBatch as it is, or raw ``(D, 2^N, 2^N)`` tables as a table-only
    batch: a tensor stays on its device, a numpy array goes to the card."""
    if isinstance(tables, TableBatch):
        return tables
    device = tables.device if isinstance(tables, torch.Tensor) else ExecutionContext().device
    tables = torch.as_tensor(tables, dtype=torch.int32).to(device)
    if tables.dim() == 2:  # single table, like the numpy behav_from_tables
        tables = tables[None]
    n_bits = int(tables.shape[-1]).bit_length() - 1
    return TableBatch(masks=None, n_bits=n_bits, _tables=tables.contiguous())


def product_tables_torch(
    spec: OperatorSpec, configs: np.ndarray, ctx: ExecutionContext | None = None
) -> torch.Tensor:
    """(D, L) configs -> (D, 2^N, 2^N) int32 product tables on the device.

    Equal to ``operator_model.product_tables`` (same row tables).
    """
    return table_batch(spec, configs, ctx).tables


def _codes(x, device) -> torch.Tensor:
    """Operand codes as a contiguous int32 tensor on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.int32))
    return x.to(device=device, dtype=torch.int32).contiguous()


# ---------------------------------------------------------------------------
# Pair-plane GEMM route (impl="gemm")
# ---------------------------------------------------------------------------
#
# f32 exactness: every GEMM operand and partial is an integer of magnitude at
# most K * 2^(n_bits+1) (guarded < 2^24 by _gemm_ok), and the int32 combine of
# the R shifted row results stays below 2^31.


def _gemm_ok(k: int, n_bits: int) -> bool:
    return k * (1 << (n_bits + 1)) < (1 << 24)


def _pair_planes(a: torch.Tensor, r: int) -> torch.Tensor:
    """(M, K) codes -> (M, 4K) f32 one-hot over (pair_r(code), k)."""
    m, k = a.shape
    q = _pair(a.long(), r) * k + torch.arange(k, device=a.device)
    onehot = torch.zeros((m, 4 * k), dtype=torch.float32, device=a.device)
    return onehot.scatter_(1, q, 1.0)


def _matmul_gemm(small: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """small (R, D, 4, B); a (M, K); b (K, N) -> (D, M, N) int32, R f32 GEMMs."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the gemm route needs full-f32 matmuls: "
                           "torch.backends.cuda.matmul.allow_tf32 is True")
    rows, d, _, nb = small.shape
    k, n = b.shape
    bl = b.long() & (nb - 1)
    out = None
    for r in range(rows):
        w = small[r][:, :, bl].reshape(d, 4 * k, n).to(torch.float32)   # (D, 4K, N)
        res = torch.matmul(_pair_planes(a & (nb - 1), r), w)            # (D, M, N)
        term = res.to(torch.int32) << (2 * r)
        out = term if out is None else out + term
    return out


# ---------------------------------------------------------------------------
# Public primitives
# ---------------------------------------------------------------------------


def _resolve_impl(impl: str | None, batch: TableBatch, k: int,
                  per_config: bool = False) -> str:
    """The route for one primitive call (mirrors the reference's ``_resolve_impl``)."""
    explicit = impl is not None
    if impl is None:
        impl = "table" if batch.ctx is None else batch.ctx.resolve_impl("fastapp", "table")
    if impl not in MATMUL_IMPLS:
        raise ValueError(f"unknown fastapp impl {impl!r} (menu: {MATMUL_IMPLS})")
    if batch.n_bits > app_kernels.MAX_BITS and impl not in _ENTRY_ROUTES:
        raise ValueError(f"{batch.n_bits}-bit codes take the table-free routes "
                         f"{_ENTRY_ROUTES}: the tables stop at {app_kernels.MAX_BITS} bits "
                         f"(got impl={impl!r})")
    if impl == "gemm" and not (batch.has_small and _gemm_ok(k, batch.n_bits)):
        if explicit:  # never hand back another route than the one asked for
            raise ValueError(
                "impl='gemm' unavailable: "
                + (f"K={k} exceeds the f32-exactness bound for {batch.n_bits}-bit"
                   if batch.has_small
                   else "TableBatch built from raw tables has no per-row planes")
            )
        impl = "plain"
    if impl in _ENTRY_ROUTES and batch.masks is None:
        if explicit:
            raise ValueError(f"impl={impl!r} unavailable: TableBatch built from raw "
                             "tables has no config masks to synthesize entries from")
        impl = "plain"
    if per_config and impl in ("table", "entry", "gemm"):
        if explicit:
            raise ValueError(f"impl={impl!r} takes config-shared (M, K) codes; "
                             "per-config (D, M, K) codes take 'plain' or 'entry_gather'")
        impl = "entry_gather" if impl == "entry" else "plain"
    return impl


def _config_mesh_ctx(batch: TableBatch, d: int) -> ExecutionContext | None:
    """The batch's context iff it shards 'configs' and ``d`` divides evenly."""
    ctx = batch.ctx
    if ctx is None or not ctx.shards("configs") or d % ctx.device_count:
        return None
    return ctx


def _shard_batches(batch: TableBatch, ctx: ExecutionContext, impl: str,
                   bucket) -> list[TableBatch]:
    """The batch cut into its shards' contiguous sub-batches, each on its
    shard's device with its shard's context; cut once a batch."""
    contexts = shard_plan(ctx, "fastapp", impl, bucket)
    if batch._shards is None:
        n = len(contexts)
        per = len(batch) // n
        src = batch.masks if batch.masks is not None else batch._tables
        parts = [src[i * per:(i + 1) * per].to(sc.device) for i, sc in enumerate(contexts)]
        batch._shards = [
            TableBatch(masks=p, n_bits=batch.n_bits, ctx=sc) if batch.masks is not None
            else TableBatch(masks=None, n_bits=batch.n_bits, ctx=sc, _tables=p.contiguous())
            for p, sc in zip(parts, contexts)]
    return batch._shards


def _on_shards(batch: TableBatch, ctx: ExecutionContext, impl: str, shape: dict, route,
               per_config: tuple = (), shared: tuple = ()) -> torch.Tensor:
    """``route(sub_batch, *args)`` on every shard, gathered in shard order:
    ``per_config`` operands are cut along their leading D axis, ``shared``
    ones copied to each shard's device.  Every shard is launched before any
    result is gathered, so the shards' launches overlap on their cards."""
    bucket = registry.get(f"fastapp.{impl}").bucket(n_bits=batch.n_bits, d=len(batch), **shape)
    subs = _shard_batches(batch, ctx, impl, bucket)
    per = len(batch) // len(subs)
    outs = [route(sb, *(x[i * per:(i + 1) * per].to(sb.device) for x in per_config),
                  *(x.to(sb.device) for x in shared))
            for i, sb in enumerate(subs)]
    return torch.cat([o.to(batch.device) for o in outs])


def _matmul(batch: TableBatch, a: torch.Tensor, b: torch.Tensor, impl: str) -> torch.Tensor:
    """One batch's table matmul on the resolved route ``impl``."""
    d = len(batch)
    if impl == "table":
        (m, k), n = a.shape, b.shape[1]
        tuned = launch_overrides(batch.ctx, "fastapp.table", n_bits=batch.n_bits, d=d, m=m,
                                 k=k, n=n)
        kw = {} if not tuned else dict(route=tuned["route"], m_tile=tuned["m_tile"] or None,
                                       k_tile=tuned["k_tile"] or None)
        return app_kernels.table_gemv(batch.tables.reshape(d, -1), a, b, **kw)
    if impl == "entry":
        return app_kernels.entry_gemv(batch.masks, a, b, batch.n_bits)
    if impl == "gemm":
        return _matmul_gemm(batch.small, a, b)
    if impl == "entry_gather":
        return app_kernels.planes_gemv_plain(batch.entry_small, a, b)
    return app_kernels.table_gemv_plain(batch.tables.reshape(d, -1), a, b)


def _count(batch: TableBatch, impl: str) -> None:
    tel = batch.ctx.tel if batch.ctx is not None else current()
    tel.count(f"dispatch.fastapp.{impl}")


def table_matmul_torch(tables, a_codes, b_codes, impl: str | None = None) -> torch.Tensor:
    """Batched table matmul: (D, M, N) int32, every multiply a table lookup.

    ``tables`` is a ``TableBatch`` (preferred: it offers every route) or raw
    ``(D, 2^N, 2^N)`` tables.  ``a_codes`` is ``(M, K)`` (shared across
    configs) or ``(D, M, K)`` (per config, e.g. the FFN's requantized hidden
    activations).
    """
    batch = _as_batch(tables)
    a = _codes(a_codes, batch.device)
    b = _codes(b_codes, batch.device)
    impl = _resolve_impl(impl, batch, a.shape[-1], per_config=a.dim() == 3)
    _count(batch, impl)
    mesh = _config_mesh_ctx(batch, len(batch))
    if mesh is None:
        return _matmul(batch, a, b, impl)
    shape = dict(m=a.shape[-2], k=a.shape[-1], n=b.shape[1])
    route = lambda sb, *ops: _matmul(sb, *ops, impl)
    if a.dim() == 3:
        return _on_shards(batch, mesh, impl, shape, route, per_config=(a,), shared=(b,))
    return _on_shards(batch, mesh, impl, shape, route, shared=(a, b))


def _contract_route(batch: TableBatch, win: torch.Tensor, b: torch.Tensor,
                    impl: str) -> torch.Tensor:
    """One batch's (M, K) windows against (K, 1) taps on the resolved route."""
    if impl in _ENTRY_ROUTES and _gemm_ok(b.shape[0], batch.n_bits):
        return _matmul_gemm(batch.entry_small, win, b)
    if impl != "plain":
        return _matmul(batch, win, b, impl)
    return app_kernels.table_gemv_plain(batch.tables.reshape(len(batch), -1), win, b,
                                        CONV_D_CHUNK)


def _contract(batch: TableBatch, win: torch.Tensor, taps: torch.Tensor,
              impl: str | None) -> torch.Tensor:
    """(M, K) windows against (K,) taps -> (D, M): a convolution as the N=1
    table matmul.  ``"table"`` launches K4; ``"gemm"`` and the entry routes
    (within the f32 bound) take the pair-plane GEMM; past that bound
    ``"entry"`` launches K5 and ``"entry_gather"`` runs K5's plain version;
    ``"plain"`` runs the flattened gather (K4's plain version)."""
    k = taps.shape[0]
    impl = _resolve_impl(impl, batch, k)
    win = win.contiguous()
    b = taps[:, None].contiguous()
    if impl != "plain" and not (impl in _ENTRY_ROUTES and _gemm_ok(k, batch.n_bits)):
        _count(batch, impl)   # a table matmul, counted as one
    mesh = _config_mesh_ctx(batch, len(batch))
    if mesh is None:
        out = _contract_route(batch, win, b, impl)
    else:
        out = _on_shards(batch, mesh, impl, dict(m=win.shape[0], k=k, n=1),
                         lambda sb, w, t: _contract_route(sb, w, t, impl), shared=(win, b))
    return out[..., 0]


def table_conv1d_torch(tables, x_codes, h_codes, impl: str | None = None) -> torch.Tensor:
    """Valid-mode 1-D correlation through per-config tables: (D, T-k+1) int32."""
    batch = _as_batch(tables)
    x = _codes(x_codes, batch.device)
    h = _codes(h_codes, batch.device)
    return _contract(batch, x.unfold(0, h.shape[0], 1), h, impl)


def table_conv2d_torch(tables, img_codes, k_codes, impl: str | None = None) -> torch.Tensor:
    """Valid-mode 2-D convolution through per-config tables: (D, H', W') int32."""
    batch = _as_batch(tables)
    img = _codes(img_codes, batch.device)
    kern = _codes(k_codes, batch.device)
    kh, kw = kern.shape
    win = img.unfold(0, kh, 1).unfold(1, kw, 1)                 # (oy, ox, kh, kw)
    oy, ox = win.shape[:2]
    out = _contract(batch, win.reshape(oy * ox, kh * kw), kern.reshape(-1), impl)
    return out.reshape(len(batch), oy, ox)


def mismatch_counts(tables, x_codes, w_codes, labels, impl: str | None = None) -> torch.Tensor:
    """Classification head: table-matmul logits -> (D,) misclassification counts.

    The prediction is the *first* maximum of the integer logits, as numpy's
    ``argmax`` breaks ties, so the counts equal the oracle's.
    """
    logits = table_matmul_torch(tables, x_codes, w_codes, impl=impl)   # (D, S, C)
    c = logits.shape[-1]
    cls = torch.arange(c, device=logits.device)
    is_max = logits == logits.amax(-1, keepdim=True)
    pred = torch.where(is_max, cls, c).amin(-1)
    lab = torch.as_tensor(np.asarray(labels), dtype=torch.int64).to(logits.device)
    return (pred != lab[None]).sum(-1)


# ---------------------------------------------------------------------------
# Batch entry points
# ---------------------------------------------------------------------------


def multi_app_behav_torch(
    apps, spec: OperatorSpec, configs: np.ndarray, batch: int = 128,
    ctx: ExecutionContext | None = None,
) -> dict[str, np.ndarray]:
    """(D, L) configs -> {app.name: (D,) BEHAV} with one TableBatch per chunk.

    Each chunk of ``batch`` configs is staged once and its lazily built
    planes and tables are shared by every app's ``behav_torch_from_tables``
    head.  A (128, 256, 256) int32 table batch is 33.5 MB at 8 bits.
    """
    apps = list(apps)
    ctx = ctx if ctx is not None else ExecutionContext()
    configs = np.atleast_2d(np.asarray(configs)).astype(np.uint8)
    d = len(configs)
    out = {app.name: np.empty(d, dtype=np.float64) for app in apps}
    for lo in range(0, d, batch):
        hi = min(lo + batch, d)
        tb = table_batch(spec, configs[lo:hi], ctx=ctx)
        for app in apps:
            out[app.name][lo:hi] = app.behav_torch_from_tables(tb)
    return out


def app_behav_torch(
    app, spec: OperatorSpec, configs: np.ndarray, batch: int = 128,
    ctx: ExecutionContext | None = None,
) -> np.ndarray:
    """(D, L) configs -> (D,) app BEHAV through the device engine."""
    return multi_app_behav_torch([app], spec, configs, batch=batch, ctx=ctx)[app.name]
