"""Prometheus text exposition + the serving /metrics and /healthz endpoints.

Counterpart of ``repro/obs/prom.py``; the health probe asks the CUDA card
(``torch.cuda``) where the reference asks JAX.

The serving entry point (``launch/serve.py``) fills latency histograms and
throughput gauges on a live :class:`~repro.obs.telemetry.Telemetry`, but
until now an operator could only see them post-mortem (``--trace`` export).
This module makes the process scrapeable while it serves:

  * :func:`render_prometheus` renders a telemetry's counters / gauges /
    histograms as Prometheus **text exposition format 0.0.4** -- counters as
    ``<name>_total``, gauges as plain gauges, histograms as summaries
    (p50/p90/p99 quantile samples plus ``_count``/``_sum``).  Metric names
    are sanitized to the Prometheus charset and prefixed ``repro_``
    (``serve.decode_step_ms`` -> ``repro_serve_decode_step_ms``); a name
    that is both a gauge and a histogram keeps the summary under the base
    name and the gauge under ``<name>_last``.
  * :class:`MetricsServer` is a stdlib ``http.server`` on a background
    thread serving ``GET /metrics`` (live exposition of a telemetry --
    usually ``obs.GLOBAL``, which sees every child sink's counters) and
    ``GET /healthz`` (JSON: device liveness, optional deployment
    descriptor).  Application endpoints (the DSE service's
    ``POST /dse`` job intake, ``GET /dse`` result polling) mount through
    :meth:`MetricsServer.add_route`: a route fn takes the JSON body (POST)
    or the query params (GET) as a dict and returns a JSON-able dict.

The health probe imports torch lazily and reports ``"unavailable"`` where no
card answers.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qsl

from . import telemetry as obs

__all__ = [
    "CONTENT_TYPE",
    "render_prometheus",
    "health_payload",
    "MetricsServer",
]

#: the exposition-format content type Prometheus scrapers expect
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_QUANTILES = (("0.5", "p50"), ("0.9", "p90"), ("0.99", "p99"))


def _prom_name(name: str) -> str:
    """``serve.decode_step_ms`` -> ``repro_serve_decode_step_ms``."""
    clean = _NAME_RE.sub("_", name)
    if not clean or not (clean[0].isalpha() or clean[0] == "_"):
        clean = "_" + clean
    return f"repro_{clean}"


def _fmt(value: float) -> str:
    """Prometheus sample value: floats as-is, +Inf/-Inf/NaN spelled out."""
    if value != value:
        return "NaN"
    if value == float("inf"):
        return "+Inf"
    if value == float("-inf"):
        return "-Inf"
    return repr(float(value))


def render_prometheus(tel: obs.Telemetry | None = None) -> str:
    """The telemetry's metrics in Prometheus text exposition format 0.0.4.

    Counters become ``<name>_total`` counters, gauges stay gauges, histogram
    deques render as summaries (quantiles computed from the retained
    samples).  Spans are not exposed: they are trace-shaped, not
    scrape-shaped (JSONL / Chrome-trace export).
    """
    tel = obs.GLOBAL if tel is None else tel
    with tel._lock:
        counters = dict(tel.counters)
        gauges = dict(tel.gauges)
        hist_names = list(tel.histograms)
    lines: list[str] = []

    for name in sorted(counters):
        pn = _prom_name(name) + "_total"
        lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn} {counters[name]}")

    hist_set = set(hist_names)
    for name in sorted(gauges):
        pn = _prom_name(name)
        if name in hist_set:
            pn += "_last"  # the summary owns the base name
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {_fmt(gauges[name])}")

    for name in sorted(hist_names):
        s = tel.histogram_summary(name)
        if not s.get("count"):
            continue
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} summary")
        for q, key in _QUANTILES:
            lines.append(f'{pn}{{quantile="{q}"}} {_fmt(s[key])}')
        lines.append(f"{pn}_count {s['count']}")
        lines.append(f"{pn}_sum {_fmt(s['mean'] * s['count'])}")

    return "\n".join(lines) + "\n" if lines else "\n"


def _device_health() -> dict:
    """Liveness of the CUDA card: a tiny launch and a sync must land.

    A process with no card (or a card that does not answer) reports
    ``"unavailable"`` rather than failing the probe -- the HTTP layer
    decides what that means for status.
    """
    try:
        import torch

        if not torch.cuda.is_available():
            return {"status": "unavailable",
                    "error": "torch.cuda.is_available() is False"}
        dev = torch.cuda.current_device()
        val = int((torch.ones(1, device=dev) + 1).item())  # a launch + readback
        return {
            "status": "ok" if val == 2 else "error",
            "backend": "cuda",
            "kind": torch.cuda.get_device_name(dev),
            "count": torch.cuda.device_count(),
        }
    except Exception as exc:
        return {"status": "unavailable", "error": f"{type(exc).__name__}: {exc}"}


def health_payload(tel: obs.Telemetry | None = None,
                   deployment: dict | None = None,
                   check_device: bool = True) -> dict:
    """The ``/healthz`` JSON: device liveness + tuning cache + deployment.

    ``deployment`` is whatever descriptor the server was registered with
    (e.g. the AxO deployment summary from ``launch/serve.py``); ``None``
    reports ``"exact"`` -- no approximate operators deployed is a valid,
    healthy configuration, not a missing one.  ``tuning_cache`` is
    ``kernels.tuning.cache_status()``, which never raises.
    """
    from ..kernels.tuning import cache_status

    tel = obs.GLOBAL if tel is None else tel
    device = _device_health() if check_device else {"status": "skipped"}
    return {
        "status": "ok" if device["status"] in ("ok", "skipped") else "degraded",
        "device": device,
        "tuning_cache": cache_status(),
        "deployment": deployment if deployment is not None else {"mode": "exact"},
        "requests": tel.counter("serve.requests"),
    }


class MetricsServer:
    """Background HTTP server: ``/metrics`` (Prometheus) + ``/healthz`` (JSON).

    ::

        srv = MetricsServer(tel=obs.GLOBAL, port=9100)
        srv.start()                 # returns once the socket is bound
        srv.set_deployment({...})   # reflected in /healthz
        ...
        srv.stop()

    ``port=0`` binds an ephemeral port (``srv.port`` reports the real one --
    the tests use this).  The handler holds no per-request state; the
    telemetry object is read live on every scrape, so whatever the serving
    loop recorded since the last scrape is visible immediately.
    """

    def __init__(self, tel: obs.Telemetry | None = None, port: int = 9100,
                 host: str = "127.0.0.1", check_device: bool = True) -> None:
        self.tel = obs.GLOBAL if tel is None else tel
        self.host = host
        self.port = port
        self.check_device = check_device
        self.deployment: dict | None = None
        self.routes: dict[tuple[str, str], object] = {}
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def set_deployment(self, deployment: dict | None) -> None:
        self.deployment = deployment

    def add_route(self, method: str, path: str, fn) -> None:
        """Mount ``fn(payload: dict) -> dict`` at (method, path).

        POST routes get the parsed JSON body; GET routes get the query
        params (single values).  The return dict is sent as JSON with 200;
        a ``ValueError``/``KeyError`` raised by the fn maps to 400, any
        other exception to 500.  Routes can be added before or after
        :meth:`start` -- the handler reads the table live.
        """
        self.routes[(method.upper(), path)] = fn

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "MetricsServer":
        if self._httpd is not None:
            return self
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # no stderr chatter per scrape
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code: int, payload: dict) -> None:
                body = (json.dumps(payload, indent=2) + "\n").encode()
                self._send(code, body, "application/json")

            def _route(self, method: str, path: str, payload: dict) -> bool:
                fn = server.routes.get((method, path))
                if fn is None:
                    return False
                try:
                    self._send_json(200, fn(payload))
                except (ValueError, KeyError, TypeError) as exc:
                    self._send_json(
                        400, {"error": f"{type(exc).__name__}: {exc}"}
                    )
                except Exception as exc:  # route bug: report, don't hang
                    self._send_json(
                        500, {"error": f"{type(exc).__name__}: {exc}"}
                    )
                return True

            def do_GET(self):
                path, _, query = self.path.partition("?")
                if path == "/metrics":
                    body = render_prometheus(server.tel).encode()
                    self._send(200, body, CONTENT_TYPE)
                elif path == "/healthz":
                    payload = health_payload(
                        server.tel, server.deployment,
                        check_device=server.check_device,
                    )
                    code = 200 if payload["status"] == "ok" else 503
                    self._send_json(code, payload)
                elif not self._route("GET", path, dict(parse_qsl(query))):
                    self._send(404, b"not found\n", "text/plain")

            def do_POST(self):
                path = self.path.split("?", 1)[0]
                try:
                    n = int(self.headers.get("Content-Length") or 0)
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(payload, dict):
                        raise ValueError("request body must be a JSON object")
                except ValueError as exc:
                    self._send_json(400, {"error": f"bad request body: {exc}"})
                    return
                if not self._route("POST", path, payload):
                    self._send(404, b"not found\n", "text/plain")

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]  # resolve port=0
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="repro-torch-metrics", daemon=True
        )
        self._thread.start()
        self.tel.count("metrics.server_starts")
        return self

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._httpd = None
        self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
