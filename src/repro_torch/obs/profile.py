"""Profiling: measured cost as telemetry gauges, checked against the registry.

Counterpart of ``repro/obs/profile.py``.  The registry's cost formulas
(``KernelSpec.cost_fn``) and the roofline (``launch.roofline``) predict
FLOPs and bytes; this module measures and cross-checks them:

  * :func:`profile_fn` runs a callable once under
    ``torch.utils.flop_counter.FlopCounterMode`` (FLOPs of the aten
    operations it issues) and times it -- CUDA events over back-to-back
    calls after a warm-up where its tensors are on the card, the host
    clock otherwise -- with the peak device memory
    (``torch.cuda.max_memory_allocated``).  These land as gauges
    ``profile.<name>.<stat>`` and one record in the ``profile`` series, and
    count ``profile.calls`` (the reference's ``profile.compiles``: it
    compiles where the port calls);
  * :func:`check_estimate` compares a measurement with an estimate and flags
    a stat off by more than :data:`DIVERGENCE_RATIO` either way (counter
    ``profile.estimate_divergence``, gauge ``profile.<name>.divergence.<stat>``);
  * :func:`profile_registry` does both for every kernel of the port, at
    small example shapes or at the caller's (``chip_smoke.py`` passes its
    main paths').  ``FlopCounterMode`` cannot see a kernel launched through
    ``ctypes`` (K7 and K8 are counted through their custom ops, whose FLOP
    formulas are the registry's ``cost_fn``), so the FLOP check runs on the
    plain version wherever its operations are counted (K6, K7 and the
    ``gemm`` route of the table matmul), and every kernel's record holds its time and that time's share
    of its roofline bound on :meth:`launch.roofline.HW.h100_sxm` (the
    operands' own bytes, ``cost_fn``'s FLOPs); a divergence is
    informational, as in the reference;
  * :func:`trace_capture` wraps a block in ``torch.profiler.profile`` (CPU and
    CUDA activities) and writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import telemetry as obs

__all__ = [
    "ProfileRecord",
    "profile_fn",
    "check_estimate",
    "profile_registry",
    "trace_capture",
    "time_ms",
    "DIVERGENCE_RATIO",
]

#: estimate-vs-measured ratio beyond which a cost formula is flagged
DIVERGENCE_RATIO = 2.0

#: stats cross-checked against the estimates (time and memory have no
#: analytical twin)
_CHECKED = ("flops", "bytes_accessed")


@dataclass
class ProfileRecord:
    """One profiled callable: the measurement and an optional estimate check."""

    name: str
    cost: dict                               # flops, ms, peak_bytes
    estimate: dict | None = None             # the cost_fn's counts
    divergence: dict = field(default_factory=dict)   # stat -> measured / estimated
    flagged: tuple = ()                      # stats beyond DIVERGENCE_RATIO
    extra: dict = field(default_factory=dict)        # bound_ms, share, ...

    def to_record(self) -> dict:
        return {
            "name": self.name,
            "cost": dict(self.cost),
            "estimate": None if self.estimate is None else dict(self.estimate),
            "divergence": dict(self.divergence),
            "flagged": list(self.flagged),
            **self.extra,
        }


def _device_of(args, kwargs) -> torch.device:
    for v in (*args, *kwargs.values()):
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


def time_ms(fn, device: torch.device, iters: int) -> float:
    """Ms a call: the mean of CUDA events over ``iters`` back-to-back calls
    after a warm-up on the card; the best of ``iters`` host-clock calls on
    the CPU."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def profile_fn(fn, *args, name: str | None = None, tel=None, iters: int = 10,
               device=None, **kwargs) -> ProfileRecord:
    """Measure ``fn(*args, **kwargs)``: its counted FLOPs, its time and the
    peak device memory of one call, as gauges ``profile.<name>.<stat>`` and
    one ``profile`` series record on ``tel`` (default: the current one).
    ``device`` is where ``fn`` runs (default: the first tensor argument's);
    a closure over card tensors needs it, or the host clock would time its
    launch alone."""
    from torch.utils.flop_counter import FlopCounterMode

    tel = obs.current() if tel is None else tel
    label = name or getattr(fn, "__name__", "fn")
    device = _device_of(args, kwargs) if device is None else torch.device(device)
    call = lambda: fn(*args, **kwargs)  # noqa: E731
    with tel.span(f"profile.{label}"):
        with FlopCounterMode(display=False) as counter:
            call()
        flops = float(counter.get_total_flops())
        peak = 0.0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            call()
            torch.cuda.synchronize(device)
            peak = float(torch.cuda.max_memory_allocated(device))
        ms = time_ms(call, device, iters)
    cost = {"flops": flops, "ms": ms, "peak_bytes": peak}
    for stat, val in cost.items():
        tel.gauge(f"profile.{label}.{stat}", val)
    rec = ProfileRecord(name=label, cost=cost)
    tel.emit("profile", rec.to_record())
    tel.count("profile.calls")
    return rec


def check_estimate(record: ProfileRecord, estimate: dict, tel=None,
                   ratio: float = DIVERGENCE_RATIO) -> ProfileRecord:
    """Compare the measurement with an analytical estimate: for each stat in
    both, the divergence is ``measured / estimate``, flagged outside
    ``[1/ratio, ratio]``; a zero estimate with a nonzero measurement flags
    as ``inf``."""
    tel = obs.current() if tel is None else tel
    record.estimate = dict(estimate)
    flagged = []
    for stat in _CHECKED:
        if stat not in estimate or stat not in record.cost:
            continue
        est = float(estimate[stat])
        meas = float(record.cost[stat])
        div = (float("inf") if meas > 0.0 else 1.0) if est <= 0.0 else meas / est
        record.divergence[stat] = div
        tel.gauge(f"profile.{record.name}.divergence.{stat}", div)
        if not (1.0 / ratio <= div <= ratio):
            flagged.append(stat)
            tel.count("profile.estimate_divergence")
    record.flagged = tuple(flagged)
    return record


# ---------------------------------------------------------------------------
# The registry sweep: every kernel at a small example shape
# ---------------------------------------------------------------------------

def _nbytes(x) -> int:
    """Bytes of every tensor in ``x`` (a tensor or a tuple/list of them)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (tuple, list)):
        return sum(_nbytes(t) for t in x)
    return 0


def _configs(spec, d: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, (d, spec.n_luts)).astype(np.uint8)


# Each case builder returns {spec name: (kernel call, plain call, shape,
# operands)}: ``shape`` is the cost_fn's keywords, ``operands`` the tensors
# the kernel reads (once each, for the roofline's bytes).

def _char_case(device, n_bits: int, d: int = 8):
    """K1 and K2 at ``d`` configs."""
    from ..core import fastchar
    from ..core.operator_model import config_to_masks, spec_for
    from ..kernels import char_kernels

    spec = spec_for(n_bits)
    masks = torch.from_numpy(config_to_masks(spec, _configs(spec, d, 0)).astype(np.int32))
    masks = masks.to(device)
    _, exact, w = fastchar._device_tables(n_bits, str(device))
    small = fastchar._gather_small(masks, n_bits)
    a_tile = fastchar.default_a_tile(spec)
    shape = dict(rows=spec.rows, d=d, a=spec.n_inputs, b=spec.n_inputs, a_tile=a_tile,
                 width=spec.width)
    return {
        "fastchar.table": (lambda: char_kernels.behav_stats_table(small, exact, w, a_tile),
                           None, shape, (small, exact, w)),
        "fastchar.entry": (lambda: char_kernels.behav_stats_entry(masks, n_bits, a_tile),
                           None, shape, (masks,)),
    }


def _app_case(device, n_bits: int, d: int = 4, m: int = 8, k: int = 16, n: int = 8):
    """K4, K5 and the gemm route: ``d`` configs' (m, k) x (k, n) codes (the
    reference's (D, M, K, N) = (4, 8, 16, 8) by default)."""
    from ..apps import fastapp
    from ..core.engine import ExecutionContext
    from ..core.operator_model import spec_for
    from ..kernels import app_kernels

    spec = spec_for(n_bits)
    batch = fastapp.table_batch(spec, _configs(spec, d, 1), ExecutionContext(device=str(device)))
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.integers(0, spec.n_inputs, (m, k)).astype(np.int32)).to(device)
    b = torch.from_numpy(rng.integers(0, spec.n_inputs, (k, n)).astype(np.int32)).to(device)
    tables = batch.tables.reshape(d, -1).contiguous()
    shape = dict(d=d, m=m, k=k, n=n, n_bits=n_bits)
    return {
        "fastapp.table": (lambda: app_kernels.table_gemv(tables, a, b), None, shape,
                          (tables, a, b)),
        "fastapp.entry": (lambda: app_kernels.entry_gemv(batch.masks, a, b, n_bits), None,
                          shape, (batch.masks, a, b)),
        "fastapp.gemm": (None, lambda: fastapp._matmul_gemm(batch.small, a, b), shape, ()),
    }


def _moo_case(device, p: int = 128):
    from ..kernels import moo_kernels

    rng = np.random.default_rng(2)
    objs = torch.from_numpy(rng.standard_normal((p, 2)).astype(np.float32)).to(device)
    viol = torch.from_numpy(np.where(rng.uniform(size=p) < 0.5, 0.0,
                                     rng.uniform(0.1, 2.0, size=p)).astype(np.float32))
    viol = viol.to(device)
    return {"fastmoo.kernel": (lambda: moo_kernels.constraint_fronts(objs, viol), None,
                               dict(p=p, n_obj=2), (objs, viol))}


def _axo_case(device, m: int = 16, k: int = 256, n: int = 512, rank: int = 8):
    """K6 on uint8 codes and its (2^n, R) tables."""
    from ..axo.deploy import AxOOperator, _tables
    from ..core.operator_model import spec_for
    from ..kernels import axo_matmul

    op = AxOOperator.from_config(_configs(spec_for(8), 1, 3)[0], rank=rank)
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(0, 256, (m, k)).astype(np.uint8)).to(device)
    b = torch.from_numpy(rng.integers(0, 256, (k, n)).astype(np.uint8)).to(device)
    args = (a, b, *_tables(op, device))
    return {"axo_matmul.kernel": (lambda: axo_matmul.axo_matmul(*args),
                                  lambda: axo_matmul.axo_matmul_plain(*args),
                                  dict(m=m, k=k, n=n, rank=rank), args)}


def _attn_case(device, b: int = 1, h: int = 4, g: int = 2, s: int = 128, hd: int = 64):
    """Causal GQA prefill: ``h`` query heads over ``g`` K/V heads, S x S."""
    from ..kernels import flash_attention

    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    gen = torch.Generator(device=device).manual_seed(4)
    q = torch.randn((b, h, s, hd), generator=gen, device=device).to(dtype)
    kv = [torch.randn((b, g, s, hd), generator=gen, device=device).to(dtype) for _ in range(2)]
    return {"attention.kernel": (lambda: flash_attention.flash_attention(q, *kv),
                                 lambda: flash_attention.flash_attention_plain(q, *kv),
                                 dict(b=b, h=h, g=g, sq=s, skv=s, hd=hd, causal=True),
                                 (q, *kv))}


def _ssd_case(device, b: int = 1, s: int = 128, h: int = 4, g: int = 1, p: int = 16,
              n: int = 16, chunk: int = 32):
    from ..kernels import ssd_scan

    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    gen = torch.Generator(device=device).manual_seed(5)
    x = torch.randn((b, s, h, p), generator=gen, device=device).to(dtype)
    bm, cm = (torch.randn((b, s, g, n), generator=gen, device=device).to(dtype)
              for _ in range(2))
    dt = 0.01 + 0.19 * torch.rand((b, s, h), generator=gen, device=device)
    a = -(0.5 + 1.5 * torch.rand((h,), generator=gen, device=device))
    return {"ssd_scan.kernel": (lambda: ssd_scan.ssd_scan(x, dt, a, bm, cm, chunk=chunk), None,
                                dict(b=b, s=s, h=h, g=g, p=p, n=n, chunk=chunk),
                                (x, dt, a, bm, cm))}


_CASES = {"fastchar": _char_case, "fastapp": _app_case, "fastmoo": _moo_case,
          "axo_matmul": _axo_case, "attention": _attn_case, "ssd_scan": _ssd_case}


def profile_registry(tel=None, device="cuda", n_bits: int = 8, iters: int = 10,
                     hw=None, shapes: dict | None = None) -> list[ProfileRecord]:
    """Profile every kernel of the port on ``device`` (the card unless the
    caller asks for the CPU; without CUDA the card raises): its time, its ``cost_fn`` counts and that time's share of its
    roofline bound on ``hw`` (default ``HW.h100_sxm()``); where the plain
    version's operations are counted (K6, K7, the ``gemm`` route),
    ``FlopCounterMode``'s FLOPs of the plain version checked against
    ``cost_fn`` (:func:`check_estimate`).

    ``shapes`` maps an engine (``"fastchar"``, ``"fastapp"``, ``"fastmoo"``,
    ``"axo_matmul"``, ``"attention"``, ``"ssd_scan"``) to its example case's
    keywords (``d``; ``d, m, k, n``; ``p``; ``m, k, n, rank``; ``b, h, g, s,
    hd``; ``b, s, h, g, p, n, chunk``); an engine left out runs at a small
    shape.  The bound is the larger of the bytes the call must move -- each
    operand it reads once, at its own dtype, and its outputs written once --
    at ``hw.hbm_bw``, and ``cost_fn``'s FLOPs at the spec's ``peak_type``
    rate.  ``cost_fn``'s own bytes are the reference's count for its
    design (f32 factors, K/V once a head) and stay in the record's
    ``estimate``.  Records are named after the registry's specs; the gemm
    route's is ``fastapp.gemm`` and holds the FLOP check alone.
    """
    from ..kernels import registry
    from ..launch.roofline import HW

    tel = obs.current() if tel is None else tel
    hw = HW.h100_sxm() if hw is None else hw
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("profile_registry measures the card and no CUDA device answers; "
                           "pass device='cpu' to run the plain versions on the host")
    shapes = shapes or {}
    cases = {}
    for engine, build in _CASES.items():
        kw = dict(shapes.get(engine, {}))
        if engine in ("fastchar", "fastapp"):
            kw.setdefault("n_bits", n_bits)
        cases.update(build(device, **kw))
    records = []
    with torch.no_grad():
        for name, (kernel, plain, shape, operands) in cases.items():
            spec = registry.get(name)
            est = spec.cost_estimate(**shape)
            if kernel is None:          # the gemm route: the FLOP check alone
                rec = check_estimate(profile_fn(plain, name=name, tel=tel, iters=iters,
                                                device=device),
                                     {"flops": est["flops"]}, tel=tel)
                records.append(rec)
                continue
            moved = _nbytes(operands) + _nbytes(kernel())
            rec = profile_fn(kernel, name=name, tel=tel, iters=iters, device=device)
            rec.estimate = dict(est)
            if plain is not None:
                # the kernel's own FLOPs are invisible to the counter: the
                # check counts the plain version's
                counted = check_estimate(profile_fn(plain, name=f"{name}.plain", tel=tel,
                                                    iters=1, device=device),
                                         {"flops": est["flops"]}, tel=tel)
                rec.cost.update(plain_flops=counted.cost["flops"], plain_ms=counted.cost["ms"])
                rec.divergence, rec.flagged = counted.divergence, counted.flagged
            t_bytes = moved / hw.hbm_bw
            t_ops = est["flops"] / hw.peak(spec.peak_type)
            bound_ms = max(t_bytes, t_ops) * 1e3
            rec.extra.update(shape=dict(shape), bytes_moved=moved, bound_ms=bound_ms,
                             bound_by="bytes" if t_bytes >= t_ops else "operations",
                             peak_type=spec.peak_type, device=str(device),
                             bound_share=bound_ms / rec.cost["ms"] if rec.cost["ms"] else 0.0)
            tel.gauge(f"profile.{name}.bound_share", rec.extra["bound_share"])
            records.append(rec)
    return records


@contextlib.contextmanager
def trace_capture(path: str, tel=None):
    """``with trace_capture("trace.json") as prof:`` -- a ``torch.profiler``
    session (CPU activity, and CUDA where a card answers) whose Chrome trace
    is written to ``path`` at the block's end; counts ``profile.traces``.
    Spans of a telemetry with ``annotate=True`` show in it as ranges."""
    from torch.profiler import ProfilerActivity, profile

    tel = obs.current() if tel is None else tel
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with tel.span("profile.trace_capture", path=path):
        with profile(activities=acts) as prof:
            yield prof
        prof.export_chrome_trace(path)
        tel.count("profile.traces")
