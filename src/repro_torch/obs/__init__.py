"""repro_torch.obs -- telemetry for the port's DSE engines, service and serving.

Counterpart of ``repro/obs``.  Collection: spans + counters/gauges/histograms
(:mod:`.telemetry`), JSONL/Chrome-trace export (:mod:`.export`) and device
taps that stage rows on the card without a host sync (:mod:`.device`).
Analysis and exposure: profiling against the kernel registry's cost
formulas (:mod:`.profile`) and the Prometheus ``/metrics`` + ``/healthz``
server (:mod:`.prom`), both imported on use, and the bench-history
regression sentinel (:mod:`.regress`, stdlib only, imported on use: its
history store is the port's own).
"""

from .telemetry import (
    GLOBAL,
    NULL,
    NullTelemetry,
    Span,
    Telemetry,
    as_telemetry,
    current,
    note_trace,
    of,
    record_pad_waste,
    use,
)
from .export import chrome_trace_dict, read_jsonl, write_chrome_trace, write_jsonl
from .device import flush, make_batched_tap, make_tap, null_tap

# The analysis/exposure layer resolves lazily (PEP 562), as the reference's.
_LAZY = {
    "MetricsServer": "prom", "health_payload": "prom", "render_prometheus": "prom",
    "ProfileRecord": "profile", "check_estimate": "profile", "profile_fn": "profile",
    "profile_registry": "profile", "trace_capture": "profile",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{mod}", __name__), name)


__all__ = [
    "GLOBAL",
    "NULL",
    "NullTelemetry",
    "Span",
    "Telemetry",
    "as_telemetry",
    "current",
    "note_trace",
    "of",
    "record_pad_waste",
    "use",
    "chrome_trace_dict",
    "read_jsonl",
    "write_chrome_trace",
    "write_jsonl",
    "flush",
    "make_batched_tap",
    "make_tap",
    "null_tap",
    "MetricsServer",
    "health_payload",
    "render_prometheus",
    "ProfileRecord",
    "check_estimate",
    "profile_fn",
    "profile_registry",
    "trace_capture",
]
