"""Gaussian image smoothing via 2-D conv on AxO arithmetic (Table 2, Fig. 19).

Procedural test image (smooth field + edges + texture), 5x5 Gaussian kernel,
conv through the operator's product table.  BEHAV = AVG_PSNR_RED: PSNR of the
accurate-operator output minus PSNR of the approximate output, both measured
against the float convolution -- matching the paper's "average reduction in PSNR"
(negative values mean the approximation happens to land closer; Fig. 19 notes
useful EvoApprox designs need AVG_PSNR_RED < 0 under that convention).

Counterpart of ``repro/apps/gauss.py``; the data generators are the same code.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.operator_model import exact_product_table
from .base import AxOApplication, quantize_int8, table_conv2d
from .fastapp import _as_batch, table_conv2d_torch

__all__ = ["GaussianSmoothing"]


def _test_image(side: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:side, 0:side] / side
    img = 0.5 + 0.3 * np.sin(6.0 * xx) * np.cos(4.0 * yy)
    img += np.where(xx + yy > 1.0, 0.25, -0.1)              # hard edge
    img += 0.1 * rng.standard_normal((side, side))          # texture/noise
    lo, hi = img.min(), img.max()
    return (img - lo) / (hi - lo)


def _gauss_kernel(k: int, sigma: float) -> np.ndarray:
    m = np.arange(k) - (k - 1) / 2
    g = np.exp(-0.5 * (m / sigma) ** 2)
    kern = np.outer(g, g)
    return kern / kern.sum()


def _psnr(a: np.ndarray, b: np.ndarray, peak: float) -> float:
    mse = float(((a - b) ** 2).mean())
    if mse <= 0:
        return 99.0  # identical within float: cap as the paper's plots do
    return float(10.0 * np.log10(peak**2 / mse))


@dataclass
class GaussianSmoothing(AxOApplication):
    name: str = "gauss"
    side: int = 96
    ksize: int = 5
    sigma: float = 1.0
    seed: int = 13

    _img: np.ndarray = field(init=False, repr=False)
    _kern: np.ndarray = field(init=False, repr=False)
    _img_codes: np.ndarray = field(init=False, repr=False)
    _k_codes: np.ndarray = field(init=False, repr=False)
    _scale: float = field(init=False, repr=False)
    _float_ref: np.ndarray = field(init=False, repr=False)
    _psnr_accurate: float | None = field(init=False, repr=False, default=None)
    _prep_bits: int = field(init=False, repr=False, default=0)

    def __post_init__(self) -> None:
        self._img = _test_image(self.side, self.seed)
        self._kern = _gauss_kernel(self.ksize, self.sigma)
        # float reference: valid-mode convolution of the *float* image/kernel
        win = np.lib.stride_tricks.sliding_window_view(self._img, (self.ksize, self.ksize))
        self._float_ref = (win * self._kern[None, None]).sum(axis=(-1, -2))
        self._prepare(8)

    def _prepare(self, n_bits: int) -> None:
        if self._prep_bits == n_bits:
            return
        self._img_codes, sx = quantize_int8(self._img, n_bits=n_bits)
        self._k_codes, sk = quantize_int8(self._kern, n_bits=n_bits)
        self._scale = sx * sk
        self._psnr_accurate = None
        self._prep_bits = n_bits

    def _psnr_from_int(self, y: np.ndarray) -> float:
        """Exact integer conv output -> PSNR vs the float reference (f64 host math)."""
        return _psnr(y.astype(np.float64) * self._scale, self._float_ref, peak=1.0)

    def _psnr_for_table(self, table: np.ndarray) -> float:
        return self._psnr_from_int(table_conv2d(table, self._img_codes, self._k_codes))

    def _ensure_accurate_psnr(self) -> None:
        if self._psnr_accurate is None:
            self._psnr_accurate = self._psnr_for_table(
                exact_product_table(self._prep_bits)
            )

    def behav_from_tables(self, tables: np.ndarray) -> np.ndarray:
        tables = np.asarray(tables)
        if tables.ndim == 2:
            tables = tables[None]
        self._prepare(int(tables.shape[-1]).bit_length() - 1)
        self._ensure_accurate_psnr()
        out = np.empty(len(tables), dtype=np.float64)
        for d, tab in enumerate(tables):
            out[d] = self._psnr_accurate - self._psnr_for_table(tab)
        return out

    def behav_torch_from_tables(self, tables) -> np.ndarray:
        """Device batched table-conv2d; the PSNR combine stays in host float64.

        The conv output is exact integer arithmetic (identical to the numpy
        path), and the float64 PSNR reduction reuses the oracle expression.
        """
        batch = _as_batch(tables)
        self._prepare(batch.n_bits)
        self._ensure_accurate_psnr()
        y = table_conv2d_torch(batch, self._img_codes, self._k_codes).cpu().numpy()
        return np.array(
            [self._psnr_accurate - self._psnr_from_int(yd) for yd in y],
            dtype=np.float64,
        )
