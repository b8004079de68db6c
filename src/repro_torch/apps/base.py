"""Shared machinery: int8 quantization + table-based approximate arithmetic.

Counterpart of ``repro/apps/base.py``.  An approximate signed NxN multiplier
is fully described by its product table ``T[(a & mask), (b & mask)] -> int``;
applications compute every multiply through that table, so swapping tables
swaps operators.  The accurate table reproduces exact integer arithmetic, so
"accurate operator" baselines use the same code path.

``table_matmul``/``table_conv1d``/``table_conv2d`` here are the numpy oracle
(``backend="numpy"``).  Every entry point takes ``backend=None``, which means
the torch engine of :mod:`repro_torch.apps.fastapp` on the card, as in the
rest of the port; ``"numpy"`` asks for the oracle.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.dataset import Dataset, characterize
from ..core.engine import as_context
from ..core.operator_model import OperatorSpec, accurate_config, product_tables
from .fastapp import app_behav_torch, multi_app_behav_torch

__all__ = [
    "quantize_int8",
    "table_matmul",
    "table_conv1d",
    "table_conv2d",
    "AxOApplication",
    "characterized_dataset_multi",
]


def quantize_int8(x: np.ndarray, n_bits: int = 8) -> tuple[np.ndarray, float]:
    """Symmetric per-tensor quantization to signed ``n_bits`` codes.

    Returns (codes, scale) with ``codes`` already masked to table-index space
    (two's complement & (2^n - 1)) and ``x ~= scale * signed(codes)``.
    """
    x = np.asarray(x, dtype=np.float64)
    qmax = (1 << (n_bits - 1)) - 1
    amax = float(np.abs(x).max())
    scale = (amax / qmax) if amax > 0 else 1.0
    q = np.clip(np.round(x / scale), -qmax - 1, qmax).astype(np.int64)
    return (q & ((1 << n_bits) - 1)).astype(np.int64), scale


def table_matmul(
    table: np.ndarray, a_codes: np.ndarray, b_codes: np.ndarray, k_chunk: int = 64
) -> np.ndarray:
    """(M, K) x (K, N) -> (M, N) int64 via product-table lookups.

    The K reduction is chunked so the gather scratch stays (M, k_chunk, N)
    instead of the full (M, K, N) product tensor; integer partial sums make the
    result independent of ``k_chunk``.
    """
    m, k = a_codes.shape
    n = b_codes.shape[1]
    out = np.zeros((m, n), dtype=np.int64)
    for lo in range(0, k, k_chunk):
        hi = min(lo + k_chunk, k)
        prod = table[a_codes[:, lo:hi, None], b_codes[None, lo:hi, :]].astype(np.int64)
        out += prod.sum(axis=1)
    return out


def table_conv1d(table: np.ndarray, x_codes: np.ndarray, h_codes: np.ndarray) -> np.ndarray:
    """Valid-mode 1-D convolution (correlation) through the product table."""
    k = h_codes.shape[0]
    win = np.lib.stride_tricks.sliding_window_view(x_codes, k)   # (T-k+1, k)
    prod = table[win, h_codes[None, :]].astype(np.int64)
    return prod.sum(axis=-1)


def table_conv2d(table: np.ndarray, img_codes: np.ndarray, k_codes: np.ndarray) -> np.ndarray:
    """Valid-mode 2-D convolution through the product table."""
    kh, kw = k_codes.shape
    win = np.lib.stride_tricks.sliding_window_view(img_codes, (kh, kw))  # (H', W', kh, kw)
    prod = table[win, k_codes[None, None, :, :]].astype(np.int64)
    return prod.sum(axis=(-1, -2))


@dataclass
class AxOApplication:
    """Base: evaluate BEHAV for batches of configs / product tables."""

    name: str = "base"

    def behav_from_tables(self, tables: np.ndarray) -> np.ndarray:
        """(D, 2^N, 2^N) int32 product tables -> (D,) BEHAV values (minimized)."""
        raise NotImplementedError

    def behav_torch_from_tables(self, tables) -> np.ndarray:
        """A ``fastapp.TableBatch`` (or raw device tables) -> (D,) BEHAV.

        Implemented per app on top of :mod:`repro_torch.apps.fastapp`; the
        numpy ``behav_from_tables`` stays the bit-exact oracle.
        """
        raise NotImplementedError(f"no torch BEHAV engine for app {self.name!r}")

    # -- conveniences used by the DSE layer ---------------------------------

    def behav_metric_name(self) -> str:
        return f"APP_{self.name.upper()}"

    def behav(
        self,
        spec: OperatorSpec,
        configs: np.ndarray,
        batch: int = 128,
        backend=None,
    ) -> np.ndarray:
        """(D, L) configs -> (D,) BEHAV.

        ``backend`` is a string or an ``ExecutionContext``; ``None`` (the
        default) scores on the card through :mod:`repro_torch.apps.fastapp`,
        ``"numpy"`` builds host product tables ``batch`` configs at a time
        (the oracle).
        """
        ctx = as_context(backend)
        if ctx.is_torch:
            return app_behav_torch(self, spec, configs, batch=batch, ctx=ctx)
        configs = np.atleast_2d(np.asarray(configs))
        out = np.empty(len(configs), dtype=np.float64)
        for lo in range(0, len(configs), batch):
            hi = min(lo + batch, len(configs))
            tables = product_tables(spec, configs[lo:hi])
            out[lo:hi] = self.behav_from_tables(tables)
        return out

    def accurate_behav(self, spec: OperatorSpec, backend=None) -> float:
        return float(self.behav(spec, accurate_config(spec)[None], backend=backend)[0])

    def characterized_dataset(
        self, spec: OperatorSpec, base: Dataset, backend=None
    ) -> Dataset:
        """Attach this app's BEHAV metric to an existing characterized dataset."""
        metrics = dict(base.metrics)
        metrics[self.behav_metric_name()] = self.behav(spec, base.configs, backend=backend)
        return Dataset(configs=base.configs, metrics=metrics, source=base.source)

    def characterize_fn(
        self, spec: OperatorSpec, ppa_key: str = "PDPLUT", backend=None
    ):
        """(D, L) -> (D, 2) [app BEHAV, operator PPA] for ``dse.run_dse``."""
        ctx = as_context(backend)

        def fn(configs: np.ndarray) -> np.ndarray:
            ds = characterize(spec, configs, backend=ctx)
            b = self.behav(spec, configs, backend=ctx)
            return np.stack([b, ds.metrics[ppa_key]], axis=-1)

        return fn


def characterized_dataset_multi(
    apps,
    spec: OperatorSpec,
    base: Dataset,
    backend=None,
    batch: int = 128,
) -> Dataset:
    """Attach *every* app's BEHAV metric with one shared table pass per chunk.

    Each config chunk's tables are built once and scored by all apps: on the
    torch backend a single ``TableBatch`` (lazily shared per-row planes and
    full tables) feeds every ``behav_torch_from_tables`` head; on ``"numpy"``
    the host product tables are likewise built once per chunk.  Per-app
    results are identical to the one-app-at-a-time path.
    """
    ctx = as_context(backend)
    apps = list(apps)
    metrics = dict(base.metrics)
    if ctx.is_torch:
        vals = multi_app_behav_torch(apps, spec, base.configs, batch=batch, ctx=ctx)
        for app in apps:
            metrics[app.behav_metric_name()] = vals[app.name]
    else:
        configs = np.atleast_2d(np.asarray(base.configs))
        d = len(configs)
        out = {app.name: np.empty(d, dtype=np.float64) for app in apps}
        for lo in range(0, d, batch):
            hi = min(lo + batch, d)
            tables = product_tables(spec, configs[lo:hi])
            for app in apps:
                out[app.name][lo:hi] = app.behav_from_tables(tables)
        for app in apps:
            metrics[app.behav_metric_name()] = out[app.name]
    return Dataset(configs=base.configs, metrics=metrics, source=base.source)
