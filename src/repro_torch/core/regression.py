"""Polynomial regression over LUT-usage bits (AxOMaP §4.2, Figs. 2/10).

A PR model over binary decision variables ``l_i`` is

    M(l) = c0 + sum_i c_i l_i + sum_{(i,j) in Q} c_ij l_i l_j

where the quadratic pair set ``Q`` is chosen by multivariate-correlation ranking
(``correlation.rank_quadratic_terms``).  Targets are MinMax-scaled before fitting
(paper Fig. 10 caption); coefficients are kept in scaled space -- the MaP problems
of ``miqcp.py`` consume them directly, and predictions can be inverted.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["MinMaxScaler", "PolyRegModel", "fit_poly", "r2_score", "mae", "mse"]


def r2_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    ss_res = ((y_true - y_pred) ** 2).sum()
    ss_tot = ((y_true - y_true.mean()) ** 2).sum()
    if ss_tot <= 0:
        return 1.0 if ss_res <= 0 else 0.0
    return float(1.0 - ss_res / ss_tot)


def mae(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    return float(np.abs(np.asarray(y_true) - np.asarray(y_pred)).mean())


def mse(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    return float(((np.asarray(y_true) - np.asarray(y_pred)) ** 2).mean())


@dataclass
class MinMaxScaler:
    lo: float = 0.0
    hi: float = 1.0

    @staticmethod
    def fit(y: np.ndarray) -> "MinMaxScaler":
        lo = float(np.min(y))
        hi = float(np.max(y))
        if hi <= lo:
            hi = lo + 1.0
        return MinMaxScaler(lo, hi)

    def transform(self, y: np.ndarray) -> np.ndarray:
        return (np.asarray(y, dtype=np.float64) - self.lo) / (self.hi - self.lo)

    def inverse(self, y: np.ndarray) -> np.ndarray:
        return np.asarray(y, dtype=np.float64) * (self.hi - self.lo) + self.lo


def _design_matrix(X: np.ndarray, quad_pairs: list[tuple[int, int]]) -> np.ndarray:
    X = np.asarray(X, dtype=np.float64)
    cols = [np.ones((X.shape[0], 1)), X]
    if quad_pairs:
        qi = np.array([p[0] for p in quad_pairs])
        qj = np.array([p[1] for p in quad_pairs])
        cols.append(X[:, qi] * X[:, qj])
    return np.concatenate(cols, axis=1)


@dataclass
class PolyRegModel:
    """Fitted polynomial-regression model in MinMax-scaled target space."""

    n_features: int
    quad_pairs: list[tuple[int, int]]
    intercept: float
    linear: np.ndarray                 # (L,)
    quad: np.ndarray                   # (len(quad_pairs),)
    scaler: MinMaxScaler = field(default_factory=MinMaxScaler)

    def predict_scaled(self, X: np.ndarray) -> np.ndarray:
        A = _design_matrix(X, self.quad_pairs)
        w = np.concatenate([[self.intercept], self.linear, self.quad])
        return A @ w

    def predict(self, X: np.ndarray) -> np.ndarray:
        return self.scaler.inverse(self.predict_scaled(X))

    def map_terms(self) -> tuple[float, np.ndarray, list[tuple[int, int, float]]]:
        """(const, linear (L,), [(i, j, coef)]) in scaled space, for MaP building."""
        quads = [
            (i, j, float(c)) for (i, j), c in zip(self.quad_pairs, self.quad)
        ]
        return float(self.intercept), self.linear.copy(), quads


def fit_poly(
    X: np.ndarray,
    y: np.ndarray,
    quad_pairs: list[tuple[int, int]] | None = None,
    alpha: float = 1e-6,
    scale_y: bool = True,
) -> PolyRegModel:
    """Ridge-regularized least squares on [1, l, l_i l_j] features."""
    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    quad_pairs = list(quad_pairs or [])
    scaler = MinMaxScaler.fit(y) if scale_y else MinMaxScaler(0.0, 1.0)
    ys = scaler.transform(y)

    A = _design_matrix(X, quad_pairs)
    n_col = A.shape[1]
    reg = alpha * np.eye(n_col)
    reg[0, 0] = 0.0  # do not penalize the intercept
    w = np.linalg.solve(A.T @ A + reg, A.T @ ys)

    L = X.shape[1]
    return PolyRegModel(
        n_features=L,
        quad_pairs=quad_pairs,
        intercept=float(w[0]),
        linear=w[1 : 1 + L],
        quad=w[1 + L :],
        scaler=scaler,
    )
