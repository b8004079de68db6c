"""Cost probes: a full-depth cell's costs from one- and two-block traces.

Counterpart of ``repro/launch/costprobe.py``.  XLA counts a ``while`` body
once, so the reference needs probes to correct a scan-over-layers program's
costs.  The port's dry-run (``launch.lowering``) runs the step eagerly and
counts every layer, so it needs no correction of a loop count.  The probes
are here to keep a full-depth cell tractable: a step traced through
DTensor's dispatch on a fake world costs host time per op and per layer
(95 layers of deepseek-67b, kimi-k2's 384 experts in each of 61), while a
probe model holds one or two super-blocks a stage:

* probe **P1** = every stage at ``repeats=1``;  **P2[s]** = stage ``s``'s
  super-block layer list doubled;  **P2enc** = the encoder two layers deep.

With per-probe measures m(.), linearity gives the full step's

    full = m(P1) + sum_s (repeats_s - 1) * (m(P2[s]) - m(P1))
                 + (enc_layers - 1)     * (m(P2enc) - m(P1))

for FLOPs, bytes accessed and each kind's collective bytes: every repeat of
a super-block runs the same ops on the same local shapes (the model
constrains the residual stream to one placement after each layer).

``probe_variants`` and ``corrected_costs`` are the reference's, with one
difference: a probe keeps the cell's own attention chunks.  The reference
raises them to at least 4096 for a cell without causal block skipping
(its cap on unrolled attention blocks, a limit of XLA); the port's block
loops are Python loops that always skip, so its probes run the blocks
that the cell's step runs.  ``unroll_loops``, which a probe sets, is not
read by the port.  The reference doubles a stage's *layer list* in
one repeat, since its scan must run one trip; for a prefill or decode cell
that extrapolation equals the port's full trace exactly.  A train cell's
does not: the doubled block is one remat checkpoint where the full step
has one a repeat (a checkpoint's recompute stops at its last saved tensor,
so a repeat's tail is counted once more: +2.5% FLOPs on reduced granite at
3 repeats; and the peak, with two layers' activations live in one
recompute, is off: 4% above the full trace's on the reduced granite cell
the tests run), and the clip's and the optimizer's per-leaf scalars follow the
leaf count.  The port's dry-run therefore doubles the *repeats*
(``double="repeats"``): each repeat is its own checkpoint and the stacked
leaves keep their count, as in the full step, so the extrapolation equals
the full trace exactly for every kind (FLOPs, bytes, collectives,
argument bytes).  The peak live bytes are extrapolated the same way, an
estimate: the peak of a step is not a sum over layers.
"""

from __future__ import annotations

from dataclasses import replace

from ..configs.base import EncoderConfig, ModelConfig, StageConfig
from .lowering import COLLECTIVES

__all__ = ["probe_variants", "measure", "corrected_costs", "MEASURE_KEYS"]

# what a probe measures: the costs, then the memory the dry-run extrapolates
MEASURE_KEYS = (("flops", "bytes", "coll_total") + tuple(f"coll_{k}" for k in COLLECTIVES)
                + ("argument_size_in_bytes", "peak_bytes"))


def _probe_base(cfg: ModelConfig) -> ModelConfig:
    return replace(cfg, unroll_loops=True)


def probe_variants(cfg: ModelConfig, double: str = "layers") -> dict[str, ModelConfig]:
    """{"P1": ..., "P2s<k>": ..., "P2enc": ...} probe configs.

    ``double="layers"`` doubles stage k's layer list in one repeat (the
    reference's layouts); ``"repeats"`` runs its super-block twice (the
    dry-run's: module docstring)."""
    if double not in ("layers", "repeats"):
        raise ValueError(f"double must be 'layers' or 'repeats', got {double!r}")
    base = _probe_base(cfg)
    ones = tuple(StageConfig(repeats=1, layers=s.layers) for s in cfg.stages)
    enc1 = EncoderConfig(n_layers=1, n_ctx=cfg.encoder.n_ctx) if cfg.encoder else None

    out = {"P1": replace(base, stages=ones, encoder=enc1)}
    for k, s in enumerate(cfg.stages):
        doubled = list(ones)
        doubled[k] = (StageConfig(repeats=1, layers=s.layers + s.layers) if double == "layers"
                      else StageConfig(repeats=2, layers=s.layers))
        out[f"P2s{k}"] = replace(base, stages=tuple(doubled), encoder=enc1)
    if cfg.encoder is not None:
        enc2 = EncoderConfig(n_layers=2, n_ctx=cfg.encoder.n_ctx)
        out["P2enc"] = replace(base, stages=ones, encoder=enc2)
    return out


def measure(record: dict) -> dict:
    """A ``lowering.lower_step`` record's measures (:data:`MEASURE_KEYS`)."""
    return {k: float(record.get(k, 0.0)) for k in MEASURE_KEYS}


def corrected_costs(cfg: ModelConfig, measures: dict[str, dict]) -> dict:
    """Apply the linear correction over probe measurements."""
    m1 = measures["P1"]
    out = dict(m1)
    for k, s in enumerate(cfg.stages):
        mk = measures[f"P2s{k}"]
        w = s.repeats - 1
        for key in out:
            out[key] = out[key] + w * max(mk[key] - m1[key], 0.0)
    if cfg.encoder is not None:
        me = measures["P2enc"]
        w = cfg.encoder.n_layers - 1
        for key in out:
            out[key] = out[key] + w * max(me[key] - m1[key], 0.0)
    return out
