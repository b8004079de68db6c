"""Telemetry: spans, counters/gauges/histograms, one sink per run.

Counterpart of ``repro/obs/telemetry.py``.  ``core.dse.run_dse`` and
``run_dse_sweep`` wrap their stages (characterize / MaP / GA / validate) in
**spans**; the kernel registry and autotuner, the engines' dispatches, the
operator library and the DSE job queue count their traffic with
**counters**; the K6 and K7 wrappers record pad-to-tile waste **gauges**;
the serving entry point fills latency **histograms**.  :mod:`.device` adds
device taps: rows staged on the card and drained into :attr:`Telemetry.
series` without a host sync at the firing, which ``fastmoo.CompiledNSGA2``
uses for its per-generation hypervolume curve.

Design rules, as the reference's:

  * **One sink.**  A :class:`Telemetry` is carried by
    ``ExecutionContext(telemetry=...)``.  Code without a context reports to
    the process-wide :data:`GLOBAL` aggregate (or whatever :func:`use` has
    made current); counters on a child telemetry propagate to its
    ``parent`` so process totals stay queryable.
  * **Disabled means no-op.**  :data:`NULL` (``telemetry="off"``) swallows
    everything: ``span`` returns a shared reusable context manager and
    counters are ``pass``.
  * **Spans mark the profiler too** when asked (``annotate=True``): each
    opens a ``torch.profiler.record_function`` range, so spans line up with
    the kernels in a ``torch.profiler`` trace.

Spans are thread- and contextvar-safe: the open-span stack lives in a
``contextvars.ContextVar``, so concurrent threads nest correctly without
sharing parents.  Export formats: JSONL (one record per line; see
:mod:`repro_torch.obs.export`) and Chrome-trace JSON loadable in Perfetto.
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field

__all__ = [
    "Span",
    "Telemetry",
    "NullTelemetry",
    "GLOBAL",
    "NULL",
    "as_telemetry",
    "current",
    "of",
    "use",
    "note_trace",
    "record_pad_waste",
]

# open-span stack (tuple of Span) per thread/task; shared mutable state stays
# on the Telemetry object itself, guarded by its lock
_SPAN_STACK: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "repro_torch_obs_span_stack", default=()
)

_MAX_SPANS = 100_000          # ring buffer: long processes never grow unbounded
_MAX_HIST = 100_000
_MAX_SERIES = 1_000_000


@dataclass
class Span:
    """One finished (or open) wall-clock interval."""

    name: str
    t0: float                          # perf_counter seconds (monotonic)
    t1: float | None = None
    span_id: int = 0
    parent_id: int | None = None
    tid: int = 0
    attrs: dict = field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return 0.0 if self.t1 is None else self.t1 - self.t0

    def to_record(self) -> dict:
        return {
            "type": "span",
            "name": self.name,
            "t0": self.t0,
            "t1": self.t1,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "tid": self.tid,
            "attrs": dict(self.attrs),
        }


class _SpanCM:
    """Context manager entering/exiting one span on one telemetry object."""

    __slots__ = ("_tel", "_span", "_token", "_annot")

    def __init__(self, tel: "Telemetry", span: Span):
        self._tel = tel
        self._span = span
        self._token = None
        self._annot = None

    def __enter__(self) -> Span:
        stack = _SPAN_STACK.get()
        if stack:
            self._span.parent_id = stack[-1].span_id
        self._token = _SPAN_STACK.set(stack + (self._span,))
        self._span.t0 = time.perf_counter()
        if self._tel.annotate:
            self._annot = _trace_annotation(self._span.name)
            self._annot.__enter__()
        return self._span

    def __exit__(self, *exc) -> None:
        self._span.t1 = time.perf_counter()
        if self._annot is not None:
            self._annot.__exit__(*exc)
        _SPAN_STACK.reset(self._token)
        self._tel._finish_span(self._span)


def _trace_annotation(name: str):
    """A ``torch.profiler.record_function`` range, so that spans line up with
    the kernels in a ``torch.profiler`` trace."""
    import torch.profiler

    return torch.profiler.record_function(name)


class Telemetry:
    """Span + metric sink.  Thread-safe; cheap enough to leave on.

    ``parent`` chains counter/gauge/histogram updates upward (child sinks
    created per run still feed process-wide totals); spans and device-tap
    series stay local to the object that recorded them.  ``device_taps``
    opts the engines into device taps (per-generation work inside the GA
    loop), so it is False unless the telemetry was asked for with ``"on"``.
    ``annotate`` opens a ``torch.profiler.record_function`` range for every
    span.
    """

    enabled = True

    def __init__(
        self,
        name: str = "telemetry",
        parent: "Telemetry | None" = None,
        device_taps: bool = False,
        annotate: bool = False,
    ) -> None:
        self.name = name
        self.parent = parent
        self.device_taps = bool(device_taps)
        self.annotate = bool(annotate)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self.spans: deque = deque(maxlen=_MAX_SPANS)
        self.counters: dict[str, int] = {}
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, deque] = {}
        self.series: dict[str, list] = {}
        self._seen: set = set()

    # -- spans ----------------------------------------------------------------

    def span(self, name: str, **attrs) -> _SpanCM:
        """Context manager: ``with tel.span("dse.ga", pop=64) as s: ...``"""
        sp = Span(
            name=name, t0=0.0, span_id=next(self._ids),
            tid=threading.get_ident(), attrs=attrs,
        )
        return _SpanCM(self, sp)

    def _finish_span(self, span: Span) -> None:
        with self._lock:
            self.spans.append(span)

    # -- metrics --------------------------------------------------------------

    def first(self, key) -> bool:
        """True the first time ``key`` reaches this sink, False after: the
        kernel wrappers' once-a-shape bookkeeping (:func:`note_trace`,
        :func:`record_pad_waste`) keys on it, so every telemetry sees each
        shape it launches once, whichever telemetry saw it before."""
        if key in self._seen:
            return False
        with self._lock:
            if key in self._seen:
                return False
            self._seen.add(key)
        return True

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n
        if self.parent is not None:
            self.parent.count(name, n)

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = float(value)
        if self.parent is not None:
            self.parent.gauge(name, value)

    def observe(self, name: str, value: float) -> None:
        """Histogram sample (stored raw; percentiles computed on demand)."""
        with self._lock:
            self.histograms.setdefault(name, deque(maxlen=_MAX_HIST)).append(
                float(value)
            )
        if self.parent is not None:
            self.parent.observe(name, value)

    def set_counter(self, name: str, value: int) -> None:
        """Force a counter value (``kernels.tuning.STATS`` writes; not propagated)."""
        with self._lock:
            self.counters[name] = int(value)

    def emit(self, name: str, record: dict) -> None:
        """Append one record to a named series (device taps land here)."""
        with self._lock:
            s = self.series.setdefault(name, [])
            if len(s) < _MAX_SERIES:
                s.append(record)

    # -- device taps ----------------------------------------------------------

    def device_tap(self, name: str, fields: tuple):
        """A tap ``tap(*values)`` staging one row a firing; see ``obs.device``."""
        from .device import make_tap

        return make_tap(self, name, fields)

    def device_batched_tap(self, name: str, fields: tuple):
        """A tap ``tap(rows, valid)`` staging a chunk of rows; see ``obs.device``."""
        from .device import make_batched_tap

        return make_batched_tap(self, name, fields)

    # -- queries / export -----------------------------------------------------

    def counter(self, name: str) -> int:
        return self.counters.get(name, 0)

    def histogram_summary(self, name: str) -> dict:
        vals = sorted(self.histograms.get(name, ()))
        if not vals:
            return {"count": 0}
        n = len(vals)
        pick = lambda q: vals[min(n - 1, int(q * n))]
        return {
            "count": n,
            "mean": sum(vals) / n,
            "min": vals[0],
            "p50": pick(0.50),
            "p90": pick(0.90),
            "p99": pick(0.99),
            "max": vals[-1],
        }

    def to_jsonl(self, path: str) -> None:
        from .export import write_jsonl

        write_jsonl(self, path)

    def to_chrome_trace(self, path: str) -> None:
        from .export import write_chrome_trace

        write_chrome_trace(self, path)


class _NullSpanCM:
    """Shared, reusable no-op span context manager (zero allocation per use)."""

    __slots__ = ()

    def __enter__(self):
        return _NULL_SPAN

    def __exit__(self, *exc):
        return None


_NULL_SPAN = Span(name="<null>", t0=0.0, t1=0.0)
_NULL_CM = _NullSpanCM()


class NullTelemetry(Telemetry):
    """A true no-op sink: ``telemetry="off"``.

    Every method is constant-time and allocation-free, and its device taps
    stage nothing.
    """

    enabled = False

    def __init__(self) -> None:
        super().__init__(name="null", parent=None, device_taps=False)

    def span(self, name: str, **attrs):
        return _NULL_CM

    def first(self, key) -> bool:
        return False

    def count(self, name: str, n: int = 1) -> None:
        pass

    def gauge(self, name: str, value: float) -> None:
        pass

    def observe(self, name: str, value: float) -> None:
        pass

    def set_counter(self, name: str, value: int) -> None:
        pass

    def emit(self, name: str, record: dict) -> None:
        pass

    def device_tap(self, name: str, fields: tuple):
        from .device import null_tap

        return null_tap

    def device_batched_tap(self, name: str, fields: tuple):
        from .device import null_tap

        return null_tap


#: process-wide aggregate: code without an ExecutionContext reports here, and
#: child telemetries propagate counters here
GLOBAL = Telemetry(name="global")

#: the disabled sink (``telemetry="off"``); a singleton so identity checks work
NULL = NullTelemetry()

_CURRENT: contextvars.ContextVar[Telemetry | None] = contextvars.ContextVar(
    "repro_torch_obs_current", default=None
)


def current() -> Telemetry:
    """The active telemetry: the innermost :func:`use`, else :data:`GLOBAL`."""
    tel = _CURRENT.get()
    return GLOBAL if tel is None else tel


class use:
    """``with use(tel): ...`` makes ``tel`` the current telemetry for code
    that has no ExecutionContext to read it from (library internals).
    Re-entrant and contextvar-scoped."""

    def __init__(self, tel: Telemetry):
        self._tel = tel
        self._token = None

    def __enter__(self) -> Telemetry:
        self._token = _CURRENT.set(self._tel)
        return self._tel

    def __exit__(self, *exc) -> None:
        _CURRENT.reset(self._token)


def as_telemetry(value, default: Telemetry | None = None) -> Telemetry:
    """Normalize the ``ExecutionContext(telemetry=...)`` knob.

    ``None`` -> ``default`` (or :data:`GLOBAL`); ``"on"`` -> a fresh sink with
    device taps enabled, counters chained to :data:`GLOBAL`; ``"off"`` ->
    :data:`NULL`; a :class:`Telemetry` instance passes through unchanged.
    """
    if value is None:
        return GLOBAL if default is None else default
    if isinstance(value, Telemetry):
        return value
    if value == "on":
        return Telemetry(name="run", parent=GLOBAL, device_taps=True)
    if value == "off":
        return NULL
    raise ValueError(
        f"telemetry must be None, 'on', 'off' or a Telemetry, got {value!r}"
    )


def of(ctx) -> Telemetry:
    """The telemetry carried by an ExecutionContext (or the current sink).

    Accepts None and legacy-string backends so shim call sites can forward
    whatever they were given.
    """
    tel = getattr(ctx, "telemetry", None)
    return current() if tel is None or isinstance(tel, str) else tel


def note_trace(name: str) -> None:
    """Count one piece of once-per-shape work: counter ``jit.retrace.<name>``.

    The reference counts (re)traces of a jitted function here; the port
    traces nothing, so it counts the work it does once per shape and then
    caches, never once per call.  The sites:

      * ``kernels.build.library`` -- the first load of a kernel library in
        the process (``jit.retrace.build.<source>``);
      * ``kernels.app_kernels.table_gemv`` -- the first launch of a K4 plan
        (route and tiles at a shape) that the current telemetry sees
        (``jit.retrace.app_kernels.plan``);
      * ``kernels.axo_matmul.axo_matmul`` -- the same for a K6 plan
        (``jit.retrace.axo_matmul.plan``).

    ``plan()`` itself records nothing, so the registry's admissibility
    probes and the tuner's candidates (run under :data:`NULL`) leave the
    counter alone.  A hot counter here means some argument keeps changing
    shape and the caches never warm.
    """
    current().count(f"jit.retrace.{name}")


def record_pad_waste(kernel: str, logical: tuple, padded: tuple) -> None:
    """Pad-to-tile waste of a kernel's iteration space: ``1 - prod(logical) /
    prod(padded)``, the fraction of the padded space that computes nothing.

    Recorded on the current telemetry as the gauge ``<kernel>.pad_waste``
    (last value) and a histogram of the same name.  The K6 and K7 wrappers
    call it at the first launch of a plan (K6) or shape (K7) that the
    current telemetry sees (:meth:`Telemetry.first`), not at every launch.
    """
    num = den = 1
    for lo, pa in zip(logical, padded):
        num *= int(lo)
        den *= int(pa)
    waste = 0.0 if den == 0 else 1.0 - num / den
    tel = current()
    tel.gauge(f"{kernel}.pad_waste", waste)
    tel.observe(f"{kernel}.pad_waste", waste)
