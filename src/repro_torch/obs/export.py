"""Telemetry export: JSONL records and Chrome-trace JSON (Perfetto-loadable).

Counterpart of ``repro/obs/export.py``.

Chrome trace format reference: the "Trace Event Format" spec -- complete
events (``ph="X"``) carry microsecond ``ts``/``dur``.  Load the file at
https://ui.perfetto.dev or chrome://tracing.
"""

from __future__ import annotations

import json

__all__ = ["write_jsonl", "read_jsonl", "write_chrome_trace", "chrome_trace_dict"]


def _records(tel) -> list[dict]:
    with tel._lock:
        recs = [s.to_record() for s in tel.spans]
        recs += [
            {"type": "counter", "name": k, "value": v}
            for k, v in sorted(tel.counters.items())
        ]
        recs += [
            {"type": "gauge", "name": k, "value": v}
            for k, v in sorted(tel.gauges.items())
        ]
        recs += [
            {"type": "histogram", "name": k, **tel.histogram_summary(k)}
            for k in sorted(tel.histograms)
        ]
    return recs


def write_jsonl(tel, path: str) -> None:
    """One JSON record per line: spans first, then counters/gauges/
    histogram summaries.  Round-trips through :func:`read_jsonl`."""
    with open(path, "w") as f:
        for rec in _records(tel):
            f.write(json.dumps(rec) + "\n")


def read_jsonl(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def chrome_trace_dict(tel) -> dict:
    """The Chrome-trace object for one telemetry sink.

    Span t0/t1 are perf_counter seconds; the earliest span anchors ts=0 so
    traces are readable regardless of process uptime.  Open spans (t1 None)
    are skipped.  Counters and gauges ride in ``otherData``.
    """
    with tel._lock:
        spans = [s for s in tel.spans if s.t1 is not None]
        counters = dict(tel.counters)
        gauges = dict(tel.gauges)
    epoch = min((s.t0 for s in spans), default=0.0)
    events = [{
        "name": s.name,
        "ph": "X",
        "ts": (s.t0 - epoch) * 1e6,
        "dur": (s.t1 - s.t0) * 1e6,
        "pid": 0,
        "tid": s.tid % 2**31,
        "args": {k: _jsonable(v) for k, v in s.attrs.items()},
    } for s in spans]
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "telemetry": tel.name,
            "counters": {k: _jsonable(v) for k, v in sorted(counters.items())},
            "gauges": {k: _jsonable(v) for k, v in sorted(gauges.items())},
        },
    }


def write_chrome_trace(tel, path: str) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace_dict(tel), f)


def _jsonable(v):
    """Numpy scalars/arrays -> python scalars/lists; everything else as-is
    (json.dumps rejects leftovers loudly, which is what we want)."""
    item = getattr(v, "item", None)
    if item is not None and getattr(v, "ndim", None) == 0:
        return v.item()
    tolist = getattr(v, "tolist", None)
    if tolist is not None:
        return v.tolist()
    return v
