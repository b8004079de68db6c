"""ECG peak detection through an AxO low-pass filter (paper Table 2, Fig. 17).

Deterministic procedural ECG: periodic QRS-like spikes with jittered intervals +
baseline wander + broadband noise.  The 1-D FIR low-pass (windowed sinc) runs on
int8 arithmetic through the operator's product table; peaks are local maxima above
an adaptive threshold.  BEHAV = percentage of reference peaks missed + spurious
detections, where the reference is the *accurate operator's* detection output
(exactly the paper's framing: error introduced by the approximation).

Counterpart of ``repro/apps/ecg.py``; the data generators are the same code.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.operator_model import exact_product_table
from .base import AxOApplication, quantize_int8, table_conv1d
from .fastapp import _as_batch, table_conv1d_torch

__all__ = ["ECGPeakDetection"]


def _synthetic_ecg(n: int, fs: float, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(signal, true peak indices).  Smooth QRS surrogates with deterministic jitter."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    sig = np.zeros(n)
    peaks = []
    pos = fs * 0.4
    while pos < n - fs * 0.3:
        peaks.append(int(pos))
        width = fs * 0.02
        x = (np.arange(n) - pos) / width
        sig += 1.0 * np.exp(-0.5 * x**2)           # R wave
        sig -= 0.18 * np.exp(-0.5 * ((np.arange(n) - pos - 3 * width) / (2 * width)) ** 2)
        pos += fs * (0.75 + 0.25 * rng.random())   # RR interval jitter
    sig += 0.15 * np.sin(2 * np.pi * 0.33 * t)      # baseline wander
    sig += 0.08 * np.sin(2 * np.pi * 50.0 * t)      # mains interference
    sig += 0.05 * rng.standard_normal(n)            # broadband noise
    return sig, np.array(peaks)


def _lowpass_taps(n_taps: int, cutoff: float, fs: float) -> np.ndarray:
    """Hamming-windowed sinc FIR low-pass."""
    m = np.arange(n_taps) - (n_taps - 1) / 2
    h = np.sinc(2 * cutoff / fs * m)
    h *= np.hamming(n_taps)
    return h / h.sum()


def _detect_peaks(y: np.ndarray, min_dist: int, rel_thresh: float = 0.5) -> np.ndarray:
    """Local maxima above rel_thresh x max, separated by >= min_dist samples."""
    if y.size < 3:
        return np.array([], dtype=np.int64)
    thresh = rel_thresh * y.max()
    cand = np.where((y[1:-1] > y[:-2]) & (y[1:-1] >= y[2:]) & (y[1:-1] > thresh))[0] + 1
    picked: list[int] = []
    for i in cand[np.argsort(-y[cand])]:  # strongest first
        if all(abs(i - j) >= min_dist for j in picked):
            picked.append(int(i))
    return np.sort(np.array(picked, dtype=np.int64))


@dataclass
class ECGPeakDetection(AxOApplication):
    name: str = "ecg"
    n_samples: int = 2048
    fs: float = 250.0
    n_taps: int = 15
    cutoff_hz: float = 35.0
    seed: int = 7
    match_tol: int = 10   # samples; +-40 ms at 250 Hz

    _sig: np.ndarray = field(init=False, repr=False)
    _taps: np.ndarray = field(init=False, repr=False)
    _x_codes: np.ndarray = field(init=False, repr=False)
    _h_codes: np.ndarray = field(init=False, repr=False)
    _ref_peaks: np.ndarray | None = field(init=False, repr=False, default=None)
    _prep_bits: int = field(init=False, repr=False, default=0)

    def __post_init__(self) -> None:
        self._sig, _ = _synthetic_ecg(self.n_samples, self.fs, self.seed)
        self._taps = _lowpass_taps(self.n_taps, self.cutoff_hz, self.fs)
        self._prepare(8)

    def _prepare(self, n_bits: int) -> None:
        """(Re)quantize inputs for an ``n_bits`` operator's table-index space."""
        if self._prep_bits == n_bits:
            return
        self._x_codes, _ = quantize_int8(self._sig, n_bits=n_bits)
        self._h_codes, _ = quantize_int8(self._taps, n_bits=n_bits)
        self._ref_peaks = None
        self._prep_bits = n_bits

    def _peaks_from_signal(self, y: np.ndarray) -> np.ndarray:
        return _detect_peaks(y.astype(np.float64), min_dist=int(0.4 * self.fs))

    def _peaks_for_table(self, table: np.ndarray) -> np.ndarray:
        return self._peaks_from_signal(table_conv1d(table, self._x_codes, self._h_codes))

    def set_reference(self, accurate_table: np.ndarray) -> None:
        self._ref_peaks = self._peaks_for_table(accurate_table)

    def _ensure_reference(self) -> None:
        if self._ref_peaks is None:
            # reference = exact integer arithmetic (== accurate operator, tested)
            self.set_reference(exact_product_table(self._prep_bits))

    def _match_score(self, got: np.ndarray) -> float:
        """Greedy strongest-first peak matching -> missed+spurious percentage."""
        ref = self._ref_peaks
        matched = 0
        used = np.zeros(len(got), dtype=bool)
        for p in ref:
            if len(got) == 0:
                break
            j = int(np.argmin(np.abs(got - p) + 1e9 * used))
            if not used[j] and abs(int(got[j]) - int(p)) <= self.match_tol:
                used[j] = True
                matched += 1
        missed = len(ref) - matched
        spurious = len(got) - matched
        return 100.0 * (missed + spurious) / max(len(ref), 1)

    def behav_from_tables(self, tables: np.ndarray) -> np.ndarray:
        tables = np.asarray(tables)
        if tables.ndim == 2:
            tables = tables[None]
        self._prepare(int(tables.shape[-1]).bit_length() - 1)
        self._ensure_reference()
        out = np.empty(len(tables), dtype=np.float64)
        for d, tab in enumerate(tables):
            out[d] = self._match_score(self._peaks_for_table(tab))
        return out

    def behav_torch_from_tables(self, tables) -> np.ndarray:
        """Device batched FIR filtering; peak picking/matching stays on the host.

        The filtered signal is an exact integer convolution, so the device
        batch equals the per-table numpy path bit-for-bit; the sequential
        greedy matching reuses the oracle code, making the count-based score
        identical across backends.
        """
        batch = _as_batch(tables)
        self._prepare(batch.n_bits)
        self._ensure_reference()
        y = table_conv1d_torch(batch, self._x_codes, self._h_codes).cpu().numpy()
        return np.array(
            [self._match_score(self._peaks_from_signal(yd)) for yd in y],
            dtype=np.float64,
        )
