"""Digit classification: dense (GEMV) layer on AxO arithmetic (Table 2, Fig. 18).

Counterpart of ``repro/apps/mnist.py``; the data generators are the same code,
so the same seeds give the same arrays.

MNIST is unavailable offline, so a deterministic procedural surrogate with the
same structure: 10 fixed smooth class prototypes on a 16x16 grid, samples are
shifted/noised prototypes, and the classifier is a ridge-trained linear layer --
i.e. exactly the paper's "last dense layer" GEMV workload.  Inference runs the
GEMV through the operator's product table; BEHAV = classification error (%).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .base import AxOApplication, quantize_int8, table_matmul
from .fastapp import _as_batch, mismatch_counts

__all__ = ["DigitClassification"]


def _prototypes(side: int, n_classes: int, seed: int) -> np.ndarray:
    """Smooth random blobs: (C, side*side) in [0, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float64)
    protos = []
    for _ in range(n_classes):
        img = np.zeros((side, side))
        for _ in range(4):  # a few Gaussian strokes per class
            cy, cx = rng.uniform(2, side - 2, size=2)
            sy, sx = rng.uniform(1.0, 3.0, size=2)
            img += np.exp(-(((yy - cy) / sy) ** 2 + ((xx - cx) / sx) ** 2))
        img /= img.max()
        protos.append(img.ravel())
    return np.stack(protos)


def _samples(
    protos: np.ndarray, side: int, n_per_class: int, noise: float, seed: int,
    max_shift: int = 1,
) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for c, p in enumerate(protos):
        img = p.reshape(side, side)
        for _ in range(n_per_class):
            dy, dx = rng.integers(-max_shift, max_shift + 1, size=2)
            s = np.roll(np.roll(img, dy, axis=0), dx, axis=1)
            s = s + noise * rng.standard_normal(s.shape)
            xs.append(s.ravel())
            ys.append(c)
    return np.stack(xs), np.array(ys)


@dataclass
class DigitClassification(AxOApplication):
    name: str = "mnist"
    side: int = 16
    n_classes: int = 10
    n_train_per_class: int = 40
    n_test_per_class: int = 25
    noise: float = 0.12
    max_shift: int = 1
    seed: int = 11

    _xte: np.ndarray = field(init=False, repr=False)       # (S, F) float
    _W: np.ndarray = field(init=False, repr=False)         # (F, C) float
    _x_codes: np.ndarray = field(init=False, repr=False)   # (S, F)
    _w_codes: np.ndarray = field(init=False, repr=False)   # (F, C)
    _labels: np.ndarray = field(init=False, repr=False)
    _prep_bits: int = field(init=False, repr=False, default=0)

    def __post_init__(self) -> None:
        protos = _prototypes(self.side, self.n_classes, self.seed)
        xtr, ytr = _samples(
            protos, self.side, self.n_train_per_class, self.noise, self.seed + 1, self.max_shift
        )
        xte, yte = _samples(
            protos, self.side, self.n_test_per_class, self.noise, self.seed + 2, self.max_shift
        )
        # ridge-trained dense layer (float training; int8 inference as in the paper)
        onehot = np.eye(self.n_classes)[ytr] - 1.0 / self.n_classes
        A = xtr.T @ xtr + 1e-2 * np.eye(xtr.shape[1])
        self._xte = xte
        self._W = np.linalg.solve(A, xtr.T @ onehot)        # (F, C)
        self._labels = yte
        self._prepare(8)

    def _prepare(self, n_bits: int) -> None:
        if self._prep_bits == n_bits:
            return
        self._x_codes, _ = quantize_int8(self._xte, n_bits=n_bits)
        self._w_codes, _ = quantize_int8(self._W, n_bits=n_bits)
        self._prep_bits = n_bits

    def behav_from_tables(self, tables: np.ndarray) -> np.ndarray:
        tables = np.asarray(tables)
        if tables.ndim == 2:
            tables = tables[None]
        self._prepare(int(tables.shape[-1]).bit_length() - 1)
        out = np.empty(len(tables), dtype=np.float64)
        for d, tab in enumerate(tables):
            logits = table_matmul(tab, self._x_codes, self._w_codes)
            pred = logits.argmax(axis=1)
            out[d] = 100.0 * (pred != self._labels).mean()
        return out

    def behav_torch_from_tables(self, tables) -> np.ndarray:
        """Batched device table matmul + argmax head: error rates for a batch.

        Integer logits and first-maximum ties match the oracle, so the
        misclassification counts -- and hence the error percentages -- are
        bit-identical across backends.
        """
        batch = _as_batch(tables)
        self._prepare(batch.n_bits)
        wrong = mismatch_counts(batch, self._x_codes, self._w_codes, self._labels)
        return 100.0 * (wrong.cpu().numpy().astype(np.float64) / len(self._labels))
