"""Telemetry: spans, counters/gauges/histograms, one sink per run.

Counterpart of ``repro/obs/telemetry.py``.  ``core.dse.run_dse`` and
``run_dse_sweep`` wrap their stages (characterize / MaP / GA / validate) in
**spans**; the operator library and the DSE job queue count their traffic
with **counters**, **gauges** and **histograms**.  The reference's device
taps (``io_callback`` sinks inside a jitted GA), ``note_trace`` and
``record_pad_waste`` are not ported yet (ROADMAP.md queue 1 item 12).

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
]

# open-span stack (tuple of Span) per thread/task; shared mutable state stays
# on the Telemetry object itself, guarded by its lock
_SPAN_STACK: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "repro_torch_obs_span_stack", default=()
)

_MAX_SPANS = 100_000          # ring buffer: long processes never grow unbounded
_MAX_HIST = 100_000


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
    created per run still feed process-wide totals); spans stay local to the
    object that recorded them.  ``annotate`` opens a
    ``torch.profiler.record_function`` range for every span.
    """

    enabled = True

    def __init__(
        self,
        name: str = "telemetry",
        parent: "Telemetry | None" = None,
        annotate: bool = False,
    ) -> None:
        self.name = name
        self.parent = parent
        self.annotate = bool(annotate)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self.spans: deque = deque(maxlen=_MAX_SPANS)
        self.counters: dict[str, int] = {}
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, deque] = {}

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

    Every method is constant-time and allocation-free.
    """

    enabled = False

    def __init__(self) -> None:
        super().__init__(name="null", parent=None)

    def span(self, name: str, **attrs):
        return _NULL_CM

    def count(self, name: str, n: int = 1) -> None:
        pass

    def gauge(self, name: str, value: float) -> None:
        pass

    def observe(self, name: str, value: float) -> None:
        pass

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

    ``None`` -> ``default`` (or :data:`GLOBAL`); ``"on"`` -> a fresh sink,
    counters chained to :data:`GLOBAL`; ``"off"`` ->
    :data:`NULL`; a :class:`Telemetry` instance passes through unchanged.
    """
    if value is None:
        return GLOBAL if default is None else default
    if isinstance(value, Telemetry):
        return value
    if value == "on":
        return Telemetry(name="run", parent=GLOBAL)
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
