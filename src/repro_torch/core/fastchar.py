"""Batched characterization, surrogate and MaP scoring on the device (the ``backend="torch"`` path).

Counterpart of ``repro/core/fastchar.py``.  The numpy oracle
(``metrics.behav_metrics``) materializes ``(D, 2^N, 2^N)`` float64 error
tables; this module evaluates the same exhaustive BEHAV statistics as a few
kernel launches:

  1. **Per-row planes** -- the ``(R, D, 4, B)`` int32 tables of each config are
     gathered out of the precomputed ``RowTables`` (``_gather_small``) or, for
     the table-free kernel, synthesized from the masks.
  2. **Tiled reduction** -- kernel K1 (``kernels.char_kernels.
     behav_stats_table``) or K2 (``behav_stats_entry``) reduces each
     (config, A-tile) block to integer and f32 partials.  On a CPU tensor the
     wrappers run their plain versions.
  3. **Exact host combine** -- integer partials are summed in int64 and divided
     by the power-of-two pair count in float64, so AVG_ABS_ERR, PROB_ERR,
     MAX_ABS_ERR and MSE are bit-identical to the numpy oracle; AVG_ABS_REL_ERR
     accumulates ``|e| * w`` in f32 and matches to ~1e-6 relative.

Unsigned multipliers take K1 (or its plain version) over planes built from
the carry-chain model (``operator_model._entry_row_values``); the row tables
and K2 are the signed multiplier's.  The reference's device paths compute the
signed operator for an unsigned spec (they call ``spec_for(n_bits)``), so the
port holds its unsigned results against the numpy oracle instead.

Wider operators and adders take the sampled estimator
(:func:`behav_metrics_sampled`): common random numbers drawn on the host
exactly as the reference draws them, per-row int32 values streamed on the
device in ``(D, s_block, R)`` chunks, an exact int64 combine and a host
block bootstrap.  :func:`entry_fn` is the table-free product of one config.

Also here: the f32 surrogate evaluators the device GA calls every
generation (``surrogate_objs_device``, ``compile_surrogate_batch``) and the
batched MaP quadratic-form scorers behind ``miqcp``'s torch routing
(``map_problem_values``, ``tabu_neighbor_values``,
``tabu_neighbor_values_multi``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..kernels.char_kernels import (
    behav_stats_entry,
    behav_stats_table,
    behav_stats_table_plain,
)
from ..kernels.tuning import launch_overrides
from ..obs.telemetry import current
from .engine import ENGINE_MENUS, ExecutionContext, shard_plan
from .metrics import BEHAV_METRICS
from .operator_model import (
    OperatorSpec,
    _entry_product,
    _entry_row_values,
    config_to_masks,
    exact_product_table,
    exact_table,
    row_tables,
    spec_for,
)

__all__ = [
    "CHAR_IMPLS",
    "max_abs_error_bound",
    "default_a_tile",
    "behav_metrics_torch",
    "entry_fn",
    "behav_metrics_sampled",
    "surrogate_objs_device",
    "compile_surrogate_batch",
    "map_problem_values",
    "tabu_neighbor_values",
    "tabu_neighbor_values_multi",
]

# "table": K1 over gathered RowTables planes; "entry": K2, planes synthesized
# from the masks; "plain": the plain torch reduction (no kernel) on the device.
CHAR_IMPLS = ENGINE_MENUS["fastchar"]


# ---------------------------------------------------------------------------
# BEHAV characterization
# ---------------------------------------------------------------------------


def max_abs_error_bound(spec: OperatorSpec) -> int:
    """Static bound on ``|approx - exact|`` for any config and input pair.

    A signed row reaches ``2^(W-1)`` in magnitude.  An unsigned row is read
    as a plain W-bit pattern, up to ``2^W - 1``, and both the approximate and
    the exact result are non-negative, so the error is at most the larger of
    their maxima (86,955 at ``mul8u``, where the signed formula gives 59,904).
    The reference's copy ignores ``signed``.
    """
    if not spec.signed:
        row_max = (1 << spec.width) - 1
        top = spec.n_inputs - 1
        if spec.op == "add":
            return max(row_max, 2 * top)
        return max(row_max * ((4**spec.rows - 1) // 3), top * top)
    row_mag = 1 << (spec.width - 1)
    if spec.op == "add":
        return row_mag + (1 << spec.n_bits)
    approx = row_mag * ((4**spec.rows - 1) // 3)
    exact = 1 << (2 * spec.n_bits - 2)
    return approx + exact


def default_a_tile(spec: OperatorSpec) -> int:
    """Largest power-of-two A-tile keeping every int32 tile partial < 2^30."""
    b = spec.n_inputs
    bound = max_abs_error_bound(spec)
    tile = spec.n_inputs
    while tile > 1 and tile * b * bound >= (1 << 30):
        tile //= 2
    return tile


@functools.lru_cache(maxsize=None)
def _host_tables(n_bits: int):
    """(row_tab (2, 4, B, M) i32, exact (A, B) i32, w (A, B) f32) on the host.

    ``w`` is ``1 / max(|exact|, 1)`` divided in f64 and rounded to f32, as the
    reference stages it for the table kernel.
    """
    spec = spec_for(n_bits)
    tabs = row_tables(n_bits)
    row_tab = np.ascontiguousarray(
        tabs.value.reshape(2, 4, spec.n_inputs, spec.n_row_masks), dtype=np.int32
    )
    exact = exact_product_table(n_bits).astype(np.int32)
    w = (1.0 / np.maximum(np.abs(exact).astype(np.float64), 1.0)).astype(np.float32)
    return row_tab, exact, w


@functools.lru_cache(maxsize=None)
def _device_tables(n_bits: int, device: str):
    """The host tables as tensors on ``device`` (cached per device)."""
    return tuple(torch.from_numpy(x).to(device) for x in _host_tables(n_bits))


def _gather_small(masks: torch.Tensor, n_bits: int) -> torch.Tensor:
    """(D, R) int32 masks -> (R, D, 4, B) int32 row planes, one gather per row."""
    spec = spec_for(n_bits)
    row_tab, _, _ = _device_tables(n_bits, str(masks.device))
    idx = masks.to(torch.int64)
    smalls = []
    for r in range(spec.rows):
        top = 1 if r == spec.rows - 1 else 0
        sel = row_tab[top][:, :, idx[:, r]]                # (4, B, D)
        smalls.append(sel.permute(2, 0, 1))                # (D, 4, B)
    return torch.stack(smalls).contiguous()                # (R, D, 4, B)


@functools.lru_cache(maxsize=None)
def _host_exact(spec: OperatorSpec):
    """(exact (A, B) i32, w (A, B) f32) of any multiplier family on the host;
    ``w`` is ``1 / max(|exact|, 1)`` divided in f64 and rounded to f32."""
    exact = exact_table(spec)
    w = (1.0 / np.maximum(np.abs(exact).astype(np.float64), 1.0)).astype(np.float32)
    return exact.astype(np.int32), w


@functools.lru_cache(maxsize=None)
def _device_exact(spec: OperatorSpec, device: str):
    return tuple(torch.from_numpy(x).to(device) for x in _host_exact(spec))


def _model_planes(spec: OperatorSpec, masks: torch.Tensor) -> torch.Tensor:
    """(D, R) int32 masks -> (R, D, 4, B) int32 planes from the carry-chain
    model, on the masks' device: plane ``p = 2*a0 + a1`` of row ``r`` is the
    row's value at an operand ``a`` with bits (2r, 2r+1) = (a0, a1).  Any
    signedness; equal to ``_gather_small`` for the signed multiplier."""
    dev = masks.device
    p = torch.arange(4, dtype=torch.int32, device=dev)
    a = torch.zeros_like(p)
    for r in range(spec.rows):   # pair p in every row at once
        a = a | (((p >> 1) & 1) << (2 * r)) | ((p & 1) << (2 * r + 1))
    b = torch.arange(spec.n_inputs, dtype=torch.int32, device=dev)
    vals = _entry_row_values(spec, masks[:, None, None, :], a[None, :, None],
                             b[None, None, :], torch, torch.int32)
    shape = (masks.shape[0], 4, spec.n_inputs)
    return torch.stack([v.expand(shape) for v in vals]).contiguous()


def _partials(spec: OperatorSpec, masks: torch.Tensor, impl: str,
              a_tile: int | None = None,
              ctx: ExecutionContext | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """One device evaluation of a (D, R) int32 mask batch -> (n_ta, D, 8) partials.

    ``"plain"`` is K1's plain torch version (the reference ``_partials_xla``
    tiling) over the same planes.  Signed planes are gathered from the row
    tables; unsigned ones come from the carry-chain model.  A ``None``
    ``a_tile`` (and K2's configs a thread) resolves through the kernel
    registry under ``ctx``'s ``tuning`` policy.
    """
    if impl not in CHAR_IMPLS:
        raise ValueError(f"unknown fastchar impl {impl!r} (menu: {CHAR_IMPLS})")
    tel = ctx.tel if ctx is not None else current()
    tel.count(f"dispatch.fastchar.{impl}")
    tuned = launch_overrides(ctx, f"fastchar.{impl}", n_bits=spec.n_bits, d=masks.shape[0],
                             signed=spec.signed)
    if a_tile is None:
        a_tile = tuned.get("a_tile", default_a_tile(spec))
    if impl == "entry":
        if not spec.signed:
            raise ValueError(f"the table-free kernel K2 synthesizes the signed "
                             f"multiplier only, got {spec.tag}")
        return behav_stats_entry(masks, spec.n_bits, a_tile,
                                 *((tuned["configs"],) if tuned else ()))
    if impl in ("table", "plain"):
        if spec.signed:
            _, exact, w = _device_tables(spec.n_bits, str(masks.device))
            small = _gather_small(masks, spec.n_bits)
        else:
            exact, w = _device_exact(spec, str(masks.device))
            small = _model_planes(spec, masks)
        stats = behav_stats_table if impl == "table" else behav_stats_table_plain
        return stats(small, exact, w, a_tile)


def _sharded_partials(spec: OperatorSpec, masks: torch.Tensor, impl: str,
                      a_tile: int | None, ctx: ExecutionContext):
    """The partials of a (D, R) host mask chunk with its configs split over
    ``ctx``'s shards: D is padded with zero masks to a multiple of the shard
    count, shard i's contiguous slice runs through :func:`_partials` on its
    device (its kernel on a card), and the slices' partials are gathered onto
    the first device in shard order.  Configs are independent and the A tile
    is resolved once at the whole chunk's D, so the result equals the
    unsharded call's on the first D configs."""
    from ..kernels import registry

    n = ctx.device_count
    d = masks.shape[0]
    if a_tile is None:
        tuned = launch_overrides(ctx, f"fastchar.{impl}", n_bits=spec.n_bits, d=d,
                                 signed=spec.signed)
        a_tile = tuned.get("a_tile", default_a_tile(spec))
    pad = (-d) % n
    if pad:
        masks = torch.cat([masks, torch.zeros((pad, masks.shape[1]), dtype=masks.dtype)])
    bucket = registry.get(f"fastchar.{impl}").bucket(n_bits=spec.n_bits, d=d)
    shards = shard_plan(ctx, "fastchar", impl, bucket)
    per = masks.shape[0] // n
    parts = [_partials(spec, masks[i * per:(i + 1) * per].to(sc.device), impl, a_tile, sc)
             for i, sc in enumerate(shards)]     # every shard launched before any gather
    first = torch.device(ctx.device)
    return tuple(torch.cat([p[j].to(first) for p in parts], dim=1) for j in range(2))


def _combine(spec: OperatorSpec, int_p: np.ndarray, rel_p: np.ndarray, d: int):
    """Exact int64/f64 host combine of per-tile partials -> BEHAV metric dict."""
    ip = np.asarray(int_p, dtype=np.int64)[:, :d, :]
    rp = np.asarray(rel_p, dtype=np.float64)[:, :d, 0]
    n2 = float(spec.n_inputs) ** 2

    s_abs = ip[..., 0].sum(axis=0)
    cnt = ip[..., 1].sum(axis=0)
    mx = ip[..., 2].max(axis=0)
    sq = 65536 * ip[..., 3].sum(axis=0) + 512 * ip[..., 4].sum(axis=0) + ip[..., 5].sum(axis=0)
    return {
        "AVG_ABS_ERR": s_abs.astype(np.float64) / n2,
        "AVG_ABS_REL_ERR": 100.0 * (rp.sum(axis=0) / n2),
        "PROB_ERR": 100.0 * (cnt.astype(np.float64) / n2),
        "MAX_ABS_ERR": mx.astype(np.float64),
        "MSE": sq.astype(np.float64) / n2,
    }


def _check_exhaustive(spec: OperatorSpec) -> None:
    if spec.op != "mul" or spec.n_bits > 8:
        raise ValueError(
            f"exhaustive device characterization takes multipliers up to 8 bits "
            f"(got {spec.tag}), as the reference's does: the (D, 2^N, 2^N) working "
            f"set and the int32 tile partials do not fit -- use "
            f"behav_metrics_sampled for wider operators and adders"
        )


def behav_metrics_torch(
    spec: OperatorSpec,
    configs: np.ndarray,
    impl: str | None = None,
    batch_size: int = 1024,
    a_tile: int | None = None,
    ctx: ExecutionContext | None = None,
) -> dict[str, np.ndarray]:
    """Exhaustive BEHAV metrics on ``ctx.device``; drop-in for ``behav_metrics``.

    Signed and unsigned multipliers of up to 8 bits.  ``impl`` defaults to the
    context's fastchar preference, then to ``"table"`` (kernel K1); ``"entry"``
    (K2) takes signed multipliers only.  Batches go ``batch_size`` configs
    per launch; a ``None`` ``a_tile`` resolves through the kernel registry
    under the context's ``tuning`` policy, per batch (``default_a_tile``
    untuned).  A context that shards ``"configs"`` splits each batch over
    its devices (:func:`_sharded_partials`); the metrics are the same.
    """
    ctx = ctx if ctx is not None else ExecutionContext()
    if impl is None:
        impl = ctx.resolve_impl("fastchar", "table")
    if impl not in CHAR_IMPLS:
        raise ValueError(f"unknown fastchar impl {impl!r} (menu: {CHAR_IMPLS})")
    _check_exhaustive(spec)
    configs = np.atleast_2d(np.asarray(configs)).astype(np.uint8)
    d = configs.shape[0]
    masks = torch.from_numpy(config_to_masks(spec, configs).astype(np.int32))
    out = {k: np.empty(d, dtype=np.float64) for k in BEHAV_METRICS}
    for lo in range(0, d, batch_size):
        hi = min(lo + batch_size, d)
        if ctx.shards("configs"):
            int_p, rel_p = _sharded_partials(spec, masks[lo:hi], impl, a_tile, ctx)
        else:
            int_p, rel_p = _partials(spec, masks[lo:hi].to(ctx.device), impl, a_tile, ctx)
        part = _combine(spec, int_p.cpu().numpy(), rel_p.cpu().numpy(), hi - lo)
        for k in BEHAV_METRICS:
            out[k][lo:hi] = part[k]
    return out


# ---------------------------------------------------------------------------
# Table-free entry function + sampled/streamed characterization (12/16-bit)
# ---------------------------------------------------------------------------


def entry_fn(spec: OperatorSpec):
    """``fn(config, a, b) -> product`` on tensors for one operator family.

    ``config`` is the (L,) {0,1} LUT tuple; ``a``/``b`` are int32 codes
    (two's complement for a signed spec; negative int32 inputs carry the same
    low bits) of any mutually broadcastable shape, on one device.  Every
    product is synthesized from the carry-chain model; there is no table.
    Exact in int32 for adders at any width and multipliers up to N=14;
    16-bit multiplier products can exceed int32, so that family streams
    per-row values instead (:func:`behav_metrics_sampled`).
    """
    if spec.op == "mul" and spec.n_bits > 14:
        raise ValueError(
            f"{spec.n_bits}-bit multiplier products overflow int32; use the "
            f"streamed per-row path (behav_metrics_sampled)"
        )
    cpr = spec.cols_removable

    def fn(config, a, b):
        a = torch.as_tensor(a).to(torch.int32)
        b = torch.as_tensor(b).to(device=a.device, dtype=torch.int32)
        c = torch.as_tensor(config).to(device=a.device, dtype=torch.int32)
        shifts = torch.arange(cpr, dtype=torch.int32, device=a.device)
        masks = (c.reshape(spec.rows, cpr) << shifts[None, :]).sum(1, dtype=torch.int32)
        return _entry_product(spec, masks, a, b, torch, torch.int32)

    return fn


def _sampled_row_values(spec: OperatorSpec, masks: torch.Tensor, a_codes: torch.Tensor,
                        b_codes: torch.Tensor) -> torch.Tensor:
    """(D, R) masks x (S,) code samples -> (D, S, R) int32 per-row values.

    Row values fit int32 at every width, so their combine ``sum_r vals << 2r``
    is exact in int64 even for 16-bit multipliers, whose products do not.
    """
    vals = _entry_row_values(spec, masks[:, None, :], a_codes[None, :], b_codes[None, :],
                             torch, torch.int32)
    shape = (masks.shape[0], a_codes.shape[0])
    return torch.stack([v.expand(shape) for v in vals], dim=-1)


def behav_metrics_sampled(
    spec: OperatorSpec,
    configs: np.ndarray,
    n_samples: int = 32768,
    seed: int = 0,
    s_block: int = 4096,
    b_block: int = 512,
    n_boot: int = 200,
    ci_level: float = 0.95,
    ctx: ExecutionContext | None = None,
) -> tuple[dict[str, np.ndarray], dict[str, tuple[np.ndarray, np.ndarray]]]:
    """Monte-Carlo BEHAV metrics for operators too wide for the exhaustive path.

    Draws ``n_samples`` (rounded up to whole ``s_block`` chunks) input pairs
    with ``np.random.default_rng(seed)``, as the reference does, shared
    across configs (common random numbers), and streams them through the
    carry-chain model on ``ctx.device`` (default the card) in ``(D, s_block,
    R)`` int32 chunks.  The device combines products and errors exactly in
    int64 and reduces them to per-block partials (at 16-bit multipliers the
    squared errors can exceed int64, so MSE sums in float64 there); the host
    adds them up and draws the block bootstrap (``default_rng(seed + 1)``).
    Exact results read the codes as the spec's signedness says.

    Returns ``(metrics, ci)`` as the reference does: the BEHAV_METRICS
    estimates (MAX_ABS_ERR is a sample max) and a ``ci_level`` percentile
    interval of each mean-type metric over ``b_block``-sample blocks.  The
    integer channels equal the reference's bit for bit; AVG_ABS_REL_ERR and
    a float64 MSE sum in another order.
    """
    ctx = ctx if ctx is not None else ExecutionContext()
    configs = np.atleast_2d(np.asarray(configs)).astype(np.uint8)
    d = configs.shape[0]
    dev = ctx.device
    masks = torch.from_numpy(config_to_masks(spec, configs).astype(np.int32)).to(dev)
    n_chunks = max(1, -(-n_samples // s_block))
    total = n_chunks * s_block

    rng = np.random.default_rng(seed)
    a_codes = rng.integers(0, spec.n_inputs, size=total).astype(np.int32)
    b_codes = rng.integers(0, spec.n_inputs, size=total).astype(np.int32)
    a_v = spec.operand_values[a_codes]
    b_v = spec.operand_values[b_codes]
    exact = a_v + b_v if spec.op == "add" else a_v * b_v    # int64, exact
    denom = np.maximum(np.abs(exact), 1).astype(np.float64)

    bound = max_abs_error_bound(spec)
    sq_exact = bound * bound * total < (1 << 62)           # int64-exact totals

    # bootstrap blocks finer than the device chunks, always dividing s_block
    b_block = math.gcd(s_block, max(1, b_block))
    n_sub = s_block // b_block
    a_t = torch.from_numpy(a_codes).to(dev)
    b_t = torch.from_numpy(b_codes).to(dev)
    exact_t = torch.from_numpy(exact).to(dev)
    denom_t = torch.from_numpy(denom).to(dev)
    shifts = torch.arange(spec.rows, dtype=torch.int64, device=dev) * 2
    parts = {k: [] for k in ("abs", "cnt", "max", "sq", "rel")}
    for c in range(n_chunks):
        sl = slice(c * s_block, (c + 1) * s_block)
        vals = _sampled_row_values(spec, masks, a_t[sl], b_t[sl]).to(torch.int64)
        approx = (vals << shifts).sum(-1)                   # (D, s) int64
        abs_e = (approx - exact_t[None, sl]).abs()
        by_block = abs_e.reshape(d, n_sub, b_block)
        parts["abs"].append(by_block.sum(2).T)
        parts["cnt"].append((by_block != 0).sum(2).T)
        parts["max"].append(abs_e.amax(1)[None])
        sq = by_block * by_block if sq_exact else by_block.to(torch.float64) ** 2
        parts["sq"].append(sq.sum(2).T)
        parts["rel"].append((abs_e / denom_t[None, sl]).reshape(d, n_sub, b_block).sum(2).T)
    host = {k: torch.cat(v).cpu().numpy() for k, v in parts.items()}
    p_abs, p_cnt, p_max = host["abs"], host["cnt"], host["max"]
    p_sq, p_rel = host["sq"], host["rel"]
    n_blocks = n_chunks * n_sub

    inv = 1.0 / total
    metrics = {
        "AVG_ABS_ERR": p_abs.sum(axis=0).astype(np.float64) * inv,
        "AVG_ABS_REL_ERR": 100.0 * p_rel.sum(axis=0) * inv,
        "PROB_ERR": 100.0 * p_cnt.sum(axis=0).astype(np.float64) * inv,
        "MAX_ABS_ERR": p_max.max(axis=0).astype(np.float64),
        "MSE": p_sq.sum(axis=0).astype(np.float64) * inv,
    }

    boot_rng = np.random.default_rng(seed + 1)
    idx = boot_rng.integers(0, n_blocks, size=(n_boot, n_blocks))
    q_lo, q_hi = 100.0 * (1 - ci_level) / 2, 100.0 * (1 + ci_level) / 2

    def _boot(partials, scale):
        est = partials[idx].sum(axis=1).astype(np.float64) * (scale * inv)
        return (np.percentile(est, q_lo, axis=0), np.percentile(est, q_hi, axis=0))

    ci = {
        "AVG_ABS_ERR": _boot(p_abs, 1.0),
        "AVG_ABS_REL_ERR": _boot(p_rel, 100.0),
        "PROB_ERR": _boot(p_cnt, 100.0),
        "MSE": _boot(p_sq, 1.0),
    }
    return metrics, ci


# ---------------------------------------------------------------------------
# Batched surrogate evaluation (NSGA-II fitness on the device, f32)
# ---------------------------------------------------------------------------


def _poly_predict(model, device):
    """PolyRegModel -> f32 closure over its coefficients on ``device``."""
    qi = torch.tensor([p[0] for p in model.quad_pairs], dtype=torch.int64, device=device)
    qj = torch.tensor([p[1] for p in model.quad_pairs], dtype=torch.int64, device=device)
    lin = torch.as_tensor(np.asarray(model.linear), dtype=torch.float32, device=device)
    quad = torch.as_tensor(np.asarray(model.quad), dtype=torch.float32, device=device)
    c0 = float(np.float32(model.intercept))
    lo = float(np.float32(model.scaler.lo))
    span = float(np.float32(model.scaler.hi - model.scaler.lo))
    has_quad = len(model.quad_pairs) > 0

    def predict(X):
        y = c0 + X @ lin
        if has_quad:
            y = y + (X[:, qi] * X[:, qj]) @ quad
        return y * span + lo

    return predict


def _gbt_predict(model, device):
    """GBTRegressor -> f32 closure over padded tree arrays (int64 node indices)."""
    n_nodes = max(t.feature.shape[0] for t in model.trees)

    def pack(attr, fill):
        out = np.full((len(model.trees), n_nodes), fill, dtype=np.float64)
        for i, t in enumerate(model.trees):
            a = getattr(t, attr)
            out[i, : a.shape[0]] = a
        return out

    feature = torch.as_tensor(pack("feature", -1), dtype=torch.int64, device=device)
    left = torch.as_tensor(np.maximum(pack("left", 0), 0), dtype=torch.int64, device=device)
    right = torch.as_tensor(np.maximum(pack("right", 0), 0), dtype=torch.int64, device=device)
    value = torch.as_tensor(pack("value", 0.0), dtype=torch.float32, device=device)
    base = float(np.float32(model.base))
    lr = float(np.float32(model.learning_rate))
    n_trees = len(model.trees)
    depth = model.max_depth

    def predict(X):
        b = X.shape[0]
        node = torch.zeros((n_trees, b), dtype=torch.int64, device=X.device)
        cols = torch.arange(b, device=X.device)[None, :]
        for _ in range(depth):  # a root-to-leaf path has <= depth edges
            feat = torch.gather(feature, 1, node)                    # (T, B)
            xf = X[cols, feat.clamp(min=0)]                          # (T, B)
            nxt = torch.where(
                xf > 0.5, torch.gather(right, 1, node), torch.gather(left, 1, node)
            )
            node = torch.where(feat >= 0, nxt, node)
        leaves = torch.gather(value, 1, node)                        # (T, B)
        return base + lr * leaves.sum(dim=0)

    return predict


def _estimator_predict(est, device):
    """AutoMLRegressor -> f32 predict closure for whichever family won."""
    from .gbt import GBTRegressor
    from .regression import PolyRegModel

    model = est.model
    if isinstance(model, PolyRegModel):
        return _poly_predict(model, device)
    if isinstance(model, GBTRegressor):
        return _gbt_predict(model, device)
    raise TypeError(f"no device path for estimator {type(model).__name__}")


def surrogate_objs_device(estimators: dict, behav_key: str, ppa_key: str,
                          device="cuda"):
    """(B, L) f32 -> (B, 2) f32 surrogate-objective closure on ``device``.

    The device GA (``fastmoo.CompiledNSGA2``) calls it on every generation's
    population; poly models become matmuls, GBT forests batched gather walks.
    """
    pb = _estimator_predict(estimators[behav_key], device)
    pp = _estimator_predict(estimators[ppa_key], device)

    def objs_fn(X):
        X = X.to(torch.float32)
        return torch.stack([pb(X), pp(X)], dim=-1)

    objs_fn.on = lambda dev: surrogate_objs_device(estimators, behav_key, ppa_key, dev)
    return objs_fn


def compile_surrogate_batch(
    estimators: dict,
    behav_key: str,
    ppa_key: str,
    max_behav: float,
    max_ppa: float,
    ctx: ExecutionContext | None = None,
):
    """One (B, L) -> ((B, 2) objectives, (B,) violation) device evaluation.

    Results come back as float64 numpy arrays computed in f32 on
    ``ctx.device``; the numpy estimators stay the reference.  The device
    closure is exposed as ``fn.objs_fn`` for the device GA.
    """
    ctx = ctx if ctx is not None else ExecutionContext()
    objs_fn = surrogate_objs_device(estimators, behav_key, ppa_key, ctx.device)
    nb = float(np.float32(max(abs(max_behav), 1e-9)))
    np_ = float(np.float32(max(abs(max_ppa), 1e-9)))
    mb = float(np.float32(max_behav))
    mp = float(np.float32(max_ppa))

    def fn(configs: np.ndarray):
        X = torch.as_tensor(np.asarray(configs), dtype=torch.float32, device=ctx.device)
        objs = objs_fn(X)
        yb, yp = objs[:, 0], objs[:, 1]
        viol = (yb - mb).clamp(min=0.0) / nb + (yp - mp).clamp(min=0.0) / np_
        return (
            objs.cpu().numpy().astype(np.float64),
            viol.cpu().numpy().astype(np.float64),
        )

    fn.objs_fn = objs_fn
    return fn


# ---------------------------------------------------------------------------
# Batched MaP quadratic-form evaluation (miqcp torch routing)
# ---------------------------------------------------------------------------


def _exprs_f32(problem, device):
    """(const (3,), lin (3, L), quad (3, L, L), sym (3, L, L)) f32 tensors."""
    exprs = (problem.obj, problem.behav, problem.ppa)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)

    return (
        t([e.const for e in exprs]),
        t(np.stack([e.lin for e in exprs])),
        t(np.stack([e.quad for e in exprs])),
        t(np.stack([e.quad + e.quad.T for e in exprs])),
    )


def map_problem_values(problem, configs: np.ndarray, device="cuda"):
    """(obj, behav, ppa) values of a MapProblem over a config batch, one dispatch."""
    const, lin, quad, _ = _exprs_f32(problem, device)
    X = torch.as_tensor(np.asarray(configs), dtype=torch.float32, device=device)
    vals = const[:, None] + lin @ X.T + torch.einsum("di,kij,dj->kd", X, quad, X)
    v = vals.cpu().numpy().astype(np.float64)
    return v[0], v[1], v[2]


def _tabu_step(states, const, lin, quad, sym):
    """states (..., S, L), expr stacks (..., K, *) -> vals (..., K, S), deltas (..., K, S, L).

    ``vals`` is each expression at each start's current point, ``deltas`` the
    change from flipping each single bit (``QuadExpr.flip_deltas`` batched).
    """
    lin_t = torch.einsum("...sl,...kl->...ks", states, lin)
    quad_t = torch.einsum("...si,...kij,...sj->...ks", states, quad, states)
    vals = const[..., None] + lin_t + quad_t
    grad = lin[..., :, None, :] + torch.einsum("...kij,...sj->...ksi", sym, states)
    deltas = (1.0 - 2.0 * states)[..., None, :, :] * grad
    return vals, deltas


def tabu_neighbor_values(problem, device="cuda"):
    """Multi-start neighborhood scorer for ``miqcp.solve_tabu`` (torch routing).

    Returns ``step(states (S, L)) -> (vals (3, S), deltas (3, S, L))`` float64
    numpy arrays in expression order (obj, behav, ppa), scored in f32.
    """
    stacks = _exprs_f32(problem, device)

    def step(states: np.ndarray):
        s = torch.as_tensor(states, dtype=torch.float32, device=device)
        vals, deltas = _tabu_step(s, *stacks)
        return vals.cpu().numpy().astype(np.float64), deltas.cpu().numpy().astype(np.float64)

    return step


def tabu_neighbor_values_multi(problems, device="cuda"):
    """Cross-problem lockstep scorer for ``miqcp.solve_tabu_multi``.

    Returns ``step(states (P, S, L)) -> (vals (P, 3, S), deltas (P, 3, S, L))``
    float64 numpy arrays: the whole battery's every start's single-flip
    neighborhood in one batched evaluation.
    """
    per = [_exprs_f32(p, device) for p in problems]
    stacks = tuple(torch.stack([s[i] for s in per]) for i in range(4))

    def step(states: np.ndarray):
        s = torch.as_tensor(states, dtype=torch.float32, device=device)
        vals, deltas = _tabu_step(s, *stacks)
        return vals.cpu().numpy().astype(np.float64), deltas.cpu().numpy().astype(np.float64)

    return step
