"""Mini-AutoML estimator selection (AxOMaP §4.1.3, Table 3).

The paper uses MLJAR AutoML to pick per-metric estimators (CatBoost/LightGBM win).
Here the candidate pool is {ridge-linear, ridge-poly2 (correlation-ranked quadratic
features), small/large GBT}; selection is by validation R^2 and the winner is
refitted on the full dataset -- same role: PPA/BEHAV surrogates for DSE fitness and
Pareto filtering.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .correlation import rank_quadratic_terms
from .gbt import GBTRegressor
from .regression import fit_poly, mae, mse, r2_score

__all__ = ["EstimatorReport", "AutoMLRegressor", "fit_estimators"]


@dataclass
class EstimatorReport:
    metric: str
    selected: str
    mse_train: float
    mse_test: float
    mae_train: float
    mae_test: float
    r2_train: float
    r2_test: float


class AutoMLRegressor:
    """Fit-and-select across candidate model families."""

    def __init__(self, n_quad: int = 48, seed: int = 0):
        self.n_quad = n_quad
        self.seed = seed
        self.model = None
        self.name = "unfit"
        self.report: EstimatorReport | None = None

    def fit(self, X: np.ndarray, y: np.ndarray, metric_name: str = "") -> "AutoMLRegressor":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        rng = np.random.default_rng(self.seed)
        n = X.shape[0]
        perm = rng.permutation(n)
        n_test = max(1, n // 5)
        test, train = perm[:n_test], perm[n_test:]
        Xtr, ytr, Xte, yte = X[train], y[train], X[test], y[test]

        quad = rank_quadratic_terms(Xtr, ytr)[: self.n_quad]
        candidates = {
            "ridge-linear": lambda: fit_poly(Xtr, ytr, quad_pairs=[]),
            "ridge-poly2": lambda: fit_poly(Xtr, ytr, quad_pairs=quad),
            "gbt-small": lambda: GBTRegressor(
                n_trees=80, max_depth=3, seed=self.seed
            ).fit(Xtr, ytr),
            "gbt-large": lambda: GBTRegressor(
                n_trees=200, max_depth=4, learning_rate=0.08, seed=self.seed
            ).fit(Xtr, ytr),
        }

        best_name, best_model, best_r2 = None, None, -np.inf
        for name, make in candidates.items():
            model = make()
            r2 = r2_score(yte, model.predict(Xte))
            if r2 > best_r2:
                best_name, best_model, best_r2 = name, model, r2

        # Test-set numbers come from the held-out fit; then refit on everything.
        pred_tr = best_model.predict(Xtr)
        pred_te = best_model.predict(Xte)
        self.report = EstimatorReport(
            metric=metric_name,
            selected=best_name,
            mse_train=mse(ytr, pred_tr),
            mse_test=mse(yte, pred_te),
            mae_train=mae(ytr, pred_tr),
            mae_test=mae(yte, pred_te),
            r2_train=r2_score(ytr, pred_tr),
            r2_test=r2_score(yte, pred_te),
        )

        quad_full = rank_quadratic_terms(X, y)[: self.n_quad]
        refit = {
            "ridge-linear": lambda: fit_poly(X, y, quad_pairs=[]),
            "ridge-poly2": lambda: fit_poly(X, y, quad_pairs=quad_full),
            "gbt-small": lambda: GBTRegressor(
                n_trees=80, max_depth=3, seed=self.seed
            ).fit(X, y),
            "gbt-large": lambda: GBTRegressor(
                n_trees=200, max_depth=4, learning_rate=0.08, seed=self.seed
            ).fit(X, y),
        }
        self.model = refit[best_name]()
        self.name = best_name
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        return self.model.predict(np.asarray(X, dtype=np.float64))


def fit_estimators(
    X: np.ndarray, metrics: dict[str, np.ndarray], n_quad: int = 48, seed: int = 0
) -> dict[str, AutoMLRegressor]:
    """One selected estimator per metric name."""
    return {
        name: AutoMLRegressor(n_quad=n_quad, seed=seed).fit(X, y, metric_name=name)
        for name, y in metrics.items()
    }
