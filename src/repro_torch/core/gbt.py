"""Gradient-boosted regression trees (numpy) for binary LUT-usage features.

Stands in for the paper's CatBoost/LightGBM estimators (Table 3): the features are
categorical {0,1} bits, so exact greedy splits on ``x_f == 1`` with depth-limited
trees recover the same model class those libraries reduce to on this data.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["GBTRegressor"]


@dataclass
class _Tree:
    feature: np.ndarray         # (n_nodes,) int; -1 => leaf
    left: np.ndarray            # child when x[f] == 0
    right: np.ndarray           # child when x[f] == 1
    value: np.ndarray           # (n_nodes,) leaf/internal mean

    def predict(self, X: np.ndarray) -> np.ndarray:
        node = np.zeros(X.shape[0], dtype=np.int64)
        for _ in range(32):  # depth bound; loop exits early when all at leaves
            feat = self.feature[node]
            active = feat >= 0
            if not active.any():
                break
            f = np.where(active, feat, 0)
            go_right = X[np.arange(X.shape[0]), f].astype(bool) & active
            go_left = (~X[np.arange(X.shape[0]), f].astype(bool)) & active
            node = np.where(go_right, self.right[node], node)
            node = np.where(go_left, self.left[node], node)
        return self.value[node]


def _fit_tree(
    X: np.ndarray, y: np.ndarray, max_depth: int, min_leaf: int
) -> _Tree:
    feature: list[int] = []
    left: list[int] = []
    right: list[int] = []
    value: list[float] = []

    def new_node(mean: float) -> int:
        feature.append(-1)
        left.append(-1)
        right.append(-1)
        value.append(mean)
        return len(feature) - 1

    def build(idx: np.ndarray, depth: int) -> int:
        yn = y[idx]
        node = new_node(float(yn.mean()))
        if depth >= max_depth or idx.size < 2 * min_leaf:
            return node
        Xn = X[idx]
        n = idx.size
        s_tot = yn.sum()
        q_tot = (yn**2).sum()
        n1 = Xn.sum(axis=0).astype(np.float64)             # (L,)
        s1 = Xn.T.astype(np.float64) @ yn                  # (L,)
        n0 = n - n1
        s0 = s_tot - s1
        with np.errstate(invalid="ignore", divide="ignore"):
            sse_split = (
                q_tot
                - np.where(n0 > 0, s0**2 / np.maximum(n0, 1), 0.0)
                - np.where(n1 > 0, s1**2 / np.maximum(n1, 1), 0.0)
            )
        valid = (n0 >= min_leaf) & (n1 >= min_leaf)
        if not valid.any():
            return node
        sse_split = np.where(valid, sse_split, np.inf)
        f = int(np.argmin(sse_split))
        sse_parent = q_tot - s_tot**2 / n
        if sse_parent - sse_split[f] <= 1e-12:
            return node
        mask = Xn[:, f].astype(bool)
        feature[node] = f
        left[node] = build(idx[~mask], depth + 1)
        right[node] = build(idx[mask], depth + 1)
        return node

    build(np.arange(X.shape[0]), 0)
    return _Tree(
        feature=np.array(feature, dtype=np.int64),
        left=np.array(left, dtype=np.int64),
        right=np.array(right, dtype=np.int64),
        value=np.array(value, dtype=np.float64),
    )


@dataclass
class GBTRegressor:
    n_trees: int = 120
    max_depth: int = 3
    learning_rate: float = 0.1
    subsample: float = 0.8
    min_leaf: int = 8
    seed: int = 0
    base: float = field(default=0.0, init=False)
    trees: list[_Tree] = field(default_factory=list, init=False)

    def fit(self, X: np.ndarray, y: np.ndarray) -> "GBTRegressor":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        rng = np.random.default_rng(self.seed)
        self.base = float(y.mean())
        self.trees = []
        pred = np.full(y.shape, self.base)
        n = X.shape[0]
        for _ in range(self.n_trees):
            resid = y - pred
            if self.subsample < 1.0:
                idx = rng.choice(n, size=max(2 * self.min_leaf, int(n * self.subsample)),
                                 replace=False)
            else:
                idx = np.arange(n)
            tree = _fit_tree(X[idx], resid[idx], self.max_depth, self.min_leaf)
            self.trees.append(tree)
            pred = pred + self.learning_rate * tree.predict(X)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        pred = np.full(X.shape[0], self.base)
        for tree in self.trees:
            pred = pred + self.learning_rate * tree.predict(X)
        return pred
