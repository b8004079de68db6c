"""repro_torch.obs -- telemetry for the port's DSE service and serving entry point.

Counterpart of ``repro/obs``: spans + counters/gauges/histograms
(:mod:`.telemetry`), JSONL/Chrome-trace export (:mod:`.export`) and the
Prometheus ``/metrics`` + ``/healthz`` server (:mod:`.prom`, imported on
use).  The reference's device taps, regression sentinel and compiled-cost
profiling wait for ROADMAP.md queue 1 item 12.
"""

from .telemetry import (
    GLOBAL,
    NULL,
    NullTelemetry,
    Span,
    Telemetry,
    as_telemetry,
    current,
    of,
    use,
)
from .export import chrome_trace_dict, read_jsonl, write_chrome_trace, write_jsonl

__all__ = [
    "GLOBAL",
    "NULL",
    "NullTelemetry",
    "Span",
    "Telemetry",
    "as_telemetry",
    "current",
    "of",
    "use",
    "chrome_trace_dict",
    "read_jsonl",
    "write_chrome_trace",
    "write_jsonl",
]
