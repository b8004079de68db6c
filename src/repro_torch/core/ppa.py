"""Simulated-synthesis PPA model (the "Vivado" stage of AxOMaP, see DESIGN.md §3.1).

The paper characterizes every sampled config with Xilinx Vivado (synthesis +
simulation-driven switching activity + power analysis) on a Virtex-7 device.  No FPGA
toolchain exists here, so this module is a *deterministic analytical synthesis model*
with the same interface and the same qualitative structure:

  * LUTS  -- kept removable LUTs + always-present logic (per-row sign column +
             row-merge adder tree).
  * CPD   -- dominated by the longest surviving carry-chain run (MUXCY segments are
             fast but serial); removal of a mid-row LUT *shortens* the chain.  This
             is a step-like nonlinear function of the config, which is why CPD is
             the hardest metric to regress (paper Table 3: R2 ~ 0.82-0.88).
  * POWER -- dynamic switching power from the exact per-bit toggle statistics of the
             behavioral model under uniform inputs (2*p*(1-p) activity per net),
             plus per-LUT static/clock overhead.
  * PDP = POWER * CPD  (fJ);  PDPLUT = PDP * LUTS  (the paper's headline PPA metric).

All constants are in ``SynthesisModel`` so tests/benchmarks can use alternative
technology points.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from .operator_model import OperatorSpec, config_to_masks, row_tables

PPA_METRICS = ("POWER", "CPD", "LUTS", "PDP", "PDPLUT")

__all__ = ["PPA_METRICS", "SynthesisModel", "ppa_metrics", "merge_tree_luts"]


@dataclass(frozen=True)
class SynthesisModel:
    """Technology constants (loosely modeled on a Virtex-7 speedgrade -2)."""

    t_route: float = 0.60   # ns, input routing + net delay
    t_lut: float = 0.45     # ns, LUT6 logic delay
    t_mux: float = 0.065    # ns, MUXCY carry hop
    t_fan: float = 0.004    # ns per kept LUT (routing congestion term)
    p_base: float = 40.0    # uW, clock tree + static
    k_sum: float = 9.0      # uW per unit of row sum-bit activity
    k_merge: float = 7.0    # uW per unit of merge-adder input activity
    k_lut: float = 1.4      # uW per kept LUT


DEFAULT_SYNTH = SynthesisModel()


def merge_tree_luts(spec: OperatorSpec) -> tuple[int, float, int]:
    """(total merge LUTs, merge delay ns, levels) for the always-accurate adder tree."""
    synth = DEFAULT_SYNTH
    n_vals = spec.rows
    width = spec.width
    luts = 0
    delay = 0.0
    levels = 0
    offset = 2
    while n_vals > 1:
        n_adders = n_vals // 2
        width = width + offset * 2  # operands are offset by 2*2^level bit positions
        luts += n_adders * width
        delay += synth.t_lut + width * synth.t_mux
        n_vals = n_adders + (n_vals % 2)
        levels += 1
        offset *= 2
    return luts, delay, levels


@functools.lru_cache(maxsize=None)
def _longest_run_table(cols: int) -> np.ndarray:
    """For every row mask, the longest run of consecutive kept carry cells.

    The always-kept top (sign) column extends the chain by one, so the run is
    computed over ``bits(mask) + [1]``.
    """
    n_mask = 1 << cols
    out = np.zeros(n_mask, dtype=np.int64)
    for m in range(n_mask):
        best = run = 0
        for j in range(cols):
            if (m >> j) & 1:
                run += 1
            else:
                best = max(best, run)
                run = 0
        out[m] = max(best, run + 1)  # +1: top sign column is always kept
    return out


@functools.lru_cache(maxsize=None)
def _activity_tables(n_bits: int) -> tuple[np.ndarray, np.ndarray]:
    """(act_sum, act_merge), each (2[top], 2^(N+1)[mask]) float64.

    act_sum   = sum_j 2 p (1-p) over the row's carry-chain sum bits.
    act_merge = sum_j 2 p (1-p) over the row-output bits feeding the merge tree.
    """
    tabs = row_tables(n_bits)
    act_sum = (2.0 * tabs.sum_p1 * (1.0 - tabs.sum_p1)).sum(axis=-1)
    act_merge = (2.0 * tabs.out_p1 * (1.0 - tabs.out_p1)).sum(axis=-1)
    return act_sum, act_merge


def ppa_metrics(
    spec: OperatorSpec,
    configs: np.ndarray,
    synth: SynthesisModel = DEFAULT_SYNTH,
) -> dict[str, np.ndarray]:
    """Deterministic PPA metrics for a batch of configs; dict of (D,) float64."""
    configs = np.atleast_2d(np.asarray(configs))
    masks = config_to_masks(spec, configs)            # (D, R)
    kept = configs.sum(axis=-1).astype(np.float64)    # (D,)

    run_tab = _longest_run_table(spec.cols_removable)
    max_run = run_tab[masks].max(axis=-1).astype(np.float64)  # (D,)

    merge_luts, merge_delay, _ = merge_tree_luts(spec)
    luts = kept + spec.rows + merge_luts

    cpd = (
        synth.t_route
        + synth.t_lut
        + synth.t_mux * max_run
        + merge_delay
        + synth.t_fan * kept
    )

    act_sum, act_merge = _activity_tables(spec.n_bits)
    top_idx = np.zeros(spec.rows, dtype=np.int64)
    top_idx[-1] = 1
    a_sum = act_sum[top_idx[None, :], masks].sum(axis=-1)      # (D,)
    a_merge = act_merge[top_idx[None, :], masks].sum(axis=-1)  # (D,)
    power = synth.p_base + synth.k_sum * a_sum + synth.k_merge * a_merge + synth.k_lut * kept

    pdp = power * cpd
    return {
        "POWER": power,
        "CPD": cpd,
        "LUTS": luts,
        "PDP": pdp,
        "PDPLUT": pdp * luts,
    }
