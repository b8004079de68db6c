"""Characterization dataset generation (AxOMaP §4.1.1, Figs. 5/7/8).

The paper observes that uniform random sampling of LUT configs concentrates the PPA
metrics in a narrow band, and augments RANDOM sampling with PATTERN sampling --
"moving windows of consecutive and/or alternating ones and zeros" -- to widen the
metric distribution.  ``gen_pattern`` reproduces that scheme.

``characterize`` accepts ``backend="torch"`` / an ``ExecutionContext`` (the
``repro_torch.core.fastchar`` kernels on the card, the default) or
``"numpy"`` (the bit-exact host oracle) for the BEHAV half of the
characterization; PPA always uses the shared numpy synthesis tables.

Config generation (``gen_random``) is the numpy ``default_rng`` stream on
every backend, so training sets are bit-identical to the reference's.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from .engine import as_context
from .metrics import BEHAV_METRICS, behav_metrics
from .operator_model import OperatorSpec, accurate_config
from .ppa import PPA_METRICS, SynthesisModel, DEFAULT_SYNTH, ppa_metrics

# Headline objectives used throughout the paper's DSE experiments.
PPA_KEY = "PDPLUT"
BEHAV_KEY = "AVG_ABS_REL_ERR"

ALL_METRICS = tuple(BEHAV_METRICS) + tuple(PPA_METRICS)

__all__ = [
    "PPA_KEY",
    "BEHAV_KEY",
    "ALL_METRICS",
    "Dataset",
    "gen_random",
    "gen_pattern",
    "characterize",
    "dedup_configs",
    "build_training_dataset",
]


@dataclass
class Dataset:
    """A characterized set of operator configs."""

    configs: np.ndarray                       # (D, L) uint8
    metrics: dict[str, np.ndarray]            # name -> (D,) float64
    source: np.ndarray = field(default=None)  # (D,) uint8: 0=random 1=pattern 2=dse

    def __post_init__(self) -> None:
        if self.source is None:
            self.source = np.zeros(len(self.configs), dtype=np.uint8)

    def __len__(self) -> int:
        return len(self.configs)

    def subset(self, idx: np.ndarray) -> "Dataset":
        return Dataset(
            configs=self.configs[idx],
            metrics={k: v[idx] for k, v in self.metrics.items()},
            source=self.source[idx],
        )

    def concat(self, other: "Dataset") -> "Dataset":
        keys = [k for k in self.metrics if k in other.metrics]
        return Dataset(
            configs=np.concatenate([self.configs, other.configs]),
            metrics={k: np.concatenate([self.metrics[k], other.metrics[k]]) for k in keys},
            source=np.concatenate([self.source, other.source]),
        )

    def objectives(self, ppa_key: str = PPA_KEY, behav_key: str = BEHAV_KEY) -> np.ndarray:
        """(D, 2) [BEHAV, PPA] objective matrix (both minimized)."""
        return np.stack([self.metrics[behav_key], self.metrics[ppa_key]], axis=-1)

    def save(self, path: str) -> None:
        if not path.endswith(".npz"):
            raise ValueError("dataset path must end with .npz")
        tmp = path + ".tmp.npz"
        np.savez_compressed(
            tmp, configs=self.configs, source=self.source,
            **{f"metric_{k}": v for k, v in self.metrics.items()},
        )
        os.replace(tmp, path)

    @staticmethod
    def load(path: str) -> "Dataset":
        with np.load(path) as z:
            metrics = {
                k[len("metric_"):]: z[k] for k in z.files if k.startswith("metric_")
            }
            return Dataset(configs=z["configs"], metrics=metrics, source=z["source"])


def gen_random(spec: OperatorSpec, n: int, seed: int = 0) -> np.ndarray:
    """Uniform random configs (the paper's RANDOM set), numpy ``default_rng``."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, size=(n, spec.n_luts)).astype(np.uint8)


def gen_pattern(spec: OperatorSpec) -> np.ndarray:
    """PATTERN configs: moving windows of consecutive / alternating ones and zeros."""
    L = spec.n_luts
    rows: list[np.ndarray] = []

    # Moving windows of zeros in a field of ones and vice versa, all widths/offsets.
    for width in range(1, L + 1):
        for off in range(0, L - width + 1):
            c = np.ones(L, dtype=np.uint8)
            c[off : off + width] = 0
            rows.append(c)
            rows.append(1 - c)

    # Alternating patterns at strides 1..4 and both phases.
    idx = np.arange(L)
    for stride in range(1, 5):
        for phase in range(stride + 1):
            rows.append(((idx + phase) // max(stride, 1) % 2).astype(np.uint8))

    # Whole-row removal patterns (each subset of rows removed is too many for 8x8;
    # use single-row and prefix-of-rows removals).
    cpr = spec.cols_removable
    for r in range(spec.rows):
        c = np.ones(L, dtype=np.uint8)
        c[r * cpr : (r + 1) * cpr] = 0
        rows.append(c)
        c2 = np.ones(L, dtype=np.uint8)
        c2[: (r + 1) * cpr] = 0
        rows.append(c2)

    # Per-row truncation ladders (drop lowest j columns of every row) -- the classic
    # truncated-multiplier family; gives very low PPA corners.
    for j in range(1, cpr + 1):
        c = np.ones(L, dtype=np.uint8)
        for r in range(spec.rows):
            c[r * cpr : r * cpr + j] = 0
        rows.append(c)

    out = np.stack(rows)
    return dedup_configs(out)


def dedup_configs(configs: np.ndarray) -> np.ndarray:
    """Remove duplicate rows, preserving first-seen order."""
    _, idx = np.unique(configs, axis=0, return_index=True)
    return configs[np.sort(idx)]


def characterize(
    spec: OperatorSpec,
    configs: np.ndarray,
    synth: SynthesisModel = DEFAULT_SYNTH,
    source: int = 0,
    batch_size: int = 256,
    backend=None,
) -> Dataset:
    """Full characterization (exhaustive BEHAV + simulated-synthesis PPA).

    ``backend`` is a string or an ``ExecutionContext``; the torch backend (the
    default, on the card) evaluates the BEHAV metrics with the
    ``repro_torch.core.fastchar`` kernels on the context's device (PPA stays on
    the cheap numpy tables).  ``"numpy"`` is the bit-exact host oracle.
    """
    backend = as_context(backend)
    configs = np.atleast_2d(np.asarray(configs)).astype(np.uint8)
    metrics = dict(
        behav_metrics(spec, configs, batch_size=batch_size, backend=backend)
    )
    metrics.update(ppa_metrics(spec, configs, synth))
    return Dataset(
        configs=configs,
        metrics=metrics,
        source=np.full(len(configs), source, dtype=np.uint8),
    )


def build_training_dataset(
    spec: OperatorSpec,
    n_random: int = 2000,
    seed: int = 0,
    include_pattern: bool = True,
    cache_path: str | None = None,
    include_accurate: bool = True,
    backend=None,
) -> Dataset:
    """RANDOM + PATTERN training dataset (cached to ``cache_path`` if given).

    ``backend`` (a string or an ``ExecutionContext``; default the card) is
    forwarded to :func:`characterize` for the BEHAV half; the configs
    themselves are the same on every backend.
    """
    backend = as_context(backend)
    if cache_path is not None and os.path.exists(cache_path):
        return Dataset.load(cache_path)

    parts = [gen_random(spec, n_random, seed=seed)]
    sources = [np.zeros(n_random, dtype=np.uint8)]
    if include_pattern:
        pat = gen_pattern(spec)
        parts.append(pat)
        sources.append(np.ones(len(pat), dtype=np.uint8))
    if include_accurate:
        parts.append(accurate_config(spec)[None])
        sources.append(np.zeros(1, dtype=np.uint8))

    configs = np.concatenate(parts)
    source = np.concatenate(sources)
    # dedup while keeping source labels of first occurrence
    _, idx = np.unique(configs, axis=0, return_index=True)
    idx = np.sort(idx)
    configs, source = configs[idx], source[idx]

    ds = characterize(spec, configs, backend=backend)
    ds.source = source
    if cache_path is not None:
        os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
        ds.save(cache_path)
    return ds
