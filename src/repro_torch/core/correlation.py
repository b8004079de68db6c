"""Correlation analysis of characterization data (AxOMaP §4.1.2, Alg. 1, Figs. 1/9).

* Bivariate: Pearson correlation of each LUT-usage bit with a metric.
* Multivariate (paper Alg. 1): for a LUT pair (x, y), fit the 2-variable linear
  regression ``M = c0 + c1*l_x + c2*l_y`` and report ``r = sqrt(R^2)``.
* ``rank_quadratic_terms``: pairs (i < j) ranked by multivariate correlation --
  the order in which quadratic features are added to the polynomial-regression
  models that seed the MIQCP formulations.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "bivariate_correlation",
    "multivariate_correlation",
    "rank_quadratic_terms",
]


def bivariate_correlation(X: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Pearson r of each column of X (D, L) against y (D,).  Zero-variance -> 0."""
    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    xc = X - X.mean(axis=0)
    yc = y - y.mean()
    sx = np.sqrt((xc**2).sum(axis=0))
    sy = np.sqrt((yc**2).sum())
    denom = sx * sy
    num = xc.T @ yc
    with np.errstate(invalid="ignore", divide="ignore"):
        r = np.where(denom > 0, num / np.maximum(denom, 1e-30), 0.0)
    return r


def multivariate_correlation(X: np.ndarray, y: np.ndarray) -> np.ndarray:
    """(L, L) matrix: entry (i, j) = sqrt(R^2) of regressing y on [1, x_i, x_j].

    Diagonal holds |bivariate r|.  Closed form via the 2x2 covariance system, fully
    vectorized over all pairs (paper Alg. 1 computes this per selected pair).
    """
    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    d, L = X.shape
    xc = X - X.mean(axis=0)
    yc = y - y.mean()
    var_y = (yc**2).mean()
    if var_y <= 0:
        return np.zeros((L, L))

    S = (xc.T @ xc) / d          # (L, L) feature covariance
    c = (xc.T @ yc) / d          # (L,)   feature-target covariance

    sii = np.diag(S)[:, None]    # (L, 1)
    sjj = np.diag(S)[None, :]
    sij = S
    det = sii * sjj - sij**2

    ci = c[:, None]
    cj = c[None, :]
    # beta = S_pair^{-1} c_pair; explained variance = c' beta
    with np.errstate(invalid="ignore", divide="ignore"):
        explained = (sjj * ci**2 - 2 * sij * ci * cj + sii * cj**2) / det
    r2 = explained / var_y

    # Degenerate pairs (collinear / zero-variance): fall back to best single-feature.
    biv = bivariate_correlation(X, y)
    r2_single = np.maximum(biv[:, None] ** 2, biv[None, :] ** 2)
    bad = ~np.isfinite(r2) | (det <= 1e-12)
    r2 = np.where(bad, r2_single, r2)
    r2 = np.clip(r2, 0.0, 1.0)

    out = np.sqrt(r2)
    np.fill_diagonal(out, np.abs(biv))
    return out


def rank_quadratic_terms(
    X: np.ndarray, y: np.ndarray, descending: bool = True
) -> list[tuple[int, int]]:
    """All pairs (i < j) ordered by multivariate correlation with y."""
    m = multivariate_correlation(X, y)
    L = m.shape[0]
    iu, ju = np.triu_indices(L, k=1)
    order = np.argsort(m[iu, ju])
    if descending:
        order = order[::-1]
    return [(int(iu[k]), int(ju[k])) for k in order]
