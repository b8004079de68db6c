"""Behavioral-accuracy (BEHAV) metrics for approximate operator configs.

Metrics follow AxOMaP Table 3: AVG_ABS_ERR, AVG_ABS_REL_ERR (percent), PROB_ERR
(percent of input pairs producing any error), plus MAX_ABS_ERR and MSE.  All are
computed exhaustively over all ``2^{2N}`` input pairs, as in the paper.

Two backends share this entry point: the numpy path below is the bit-exact
oracle; ``backend="torch"`` routes to :mod:`repro_torch.core.fastchar`, which
evaluates the same statistics with the BEHAV kernels (tiled reductions, no
float64 error tables).  AVG_ABS_ERR/PROB_ERR/MAX_ABS_ERR/MSE are
bit-identical across backends; AVG_ABS_REL_ERR agrees to ~1e-6 relative
(float32 accumulation of the relative-error weights on device).
"""

from __future__ import annotations

import numpy as np

from .operator_model import OperatorSpec, exact_table, product_tables

BEHAV_METRICS = ("AVG_ABS_ERR", "AVG_ABS_REL_ERR", "PROB_ERR", "MAX_ABS_ERR", "MSE")

__all__ = ["BEHAV_METRICS", "behav_metrics"]


def behav_metrics(
    spec: OperatorSpec, configs: np.ndarray, batch_size: int = 256,
    backend=None,
) -> dict[str, np.ndarray]:
    """Exhaustive BEHAV metrics for a batch of configs.

    Returns a dict of float64 arrays of shape (D,).  ``backend`` is a string
    (``"torch"``, the default, runs the device engine on the card; ``"numpy"``
    the host oracle)
    or an :class:`repro_torch.core.engine.ExecutionContext`, which also names
    the device and the kernel impl.
    """
    from .engine import as_context

    ctx = as_context(backend)
    if ctx.is_torch:
        from .fastchar import behav_metrics_torch

        return behav_metrics_torch(spec, configs, batch_size=batch_size, ctx=ctx)
    configs = np.atleast_2d(np.asarray(configs))
    d = configs.shape[0]
    exact = exact_table(spec)
    denom = np.maximum(np.abs(exact), 1).astype(np.float64)

    out = {k: np.empty(d, dtype=np.float64) for k in BEHAV_METRICS}
    for lo in range(0, d, batch_size):
        hi = min(lo + batch_size, d)
        approx = product_tables(spec, configs[lo:hi]).astype(np.int64)
        err = approx - exact[None]
        abs_err = np.abs(err).astype(np.float64)
        out["AVG_ABS_ERR"][lo:hi] = abs_err.mean(axis=(1, 2))
        out["AVG_ABS_REL_ERR"][lo:hi] = 100.0 * (abs_err / denom[None]).mean(axis=(1, 2))
        out["PROB_ERR"][lo:hi] = 100.0 * (err != 0).mean(axis=(1, 2))
        out["MAX_ABS_ERR"][lo:hi] = abs_err.max(axis=(1, 2))
        out["MSE"][lo:hi] = (abs_err**2).mean(axis=(1, 2))
    return out
