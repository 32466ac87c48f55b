"""Stdlib-only HTTP telemetry endpoint: /metrics, /healthz, /slo,
/memory, /series, /tenants.

Counterpart of ``paddle_tpu/observability/exporter.py``, kept as the
port's own copy of its single-server half (the fleet's /trace and
/alerts planes and its aggregate registry view wait for the fleet).
``GenerationServer.serve_metrics(port=...)`` wraps it; a bare
``serve_metrics()`` exports just the process-wide registry.

- ``GET /metrics``: Prometheus text exposition
  (``MetricsRegistry.to_prometheus()``; label values and HELP text are
  escaped per the format spec).
- ``GET /healthz``: JSON ``{"status": "ok", ...health_fn()}``; any
  exception from health_fn turns into ``{"status": "error"}`` + HTTP
  500, so a wedged component reads as unhealthy instead of silent.
- ``GET /slo``: JSON from ``slo_fn()`` (the serving SLO digest
  snapshot), ``{}`` when the component has none.
- ``GET /memory``: JSON HBM-ledger snapshot (``memory_fn()``; default
  is the process-wide ``compile_insight.hbm_ledger()``).
- ``GET /series``: JSON time-series payload (``series_fn()``; the
  engine mounts its SeriesStore); the empty schema shape otherwise.
- ``GET /tenants``: JSON per-tenant cost attribution
  (``tenants_fn()``; ``{}`` when the component tracks none).

Security note: binds 127.0.0.1 by default: the exposition includes
shape names and the SLO surface leaks traffic patterns. Bind a routable
host explicitly only behind your own authn/network policy; the server
itself adds none.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .metrics import global_registry

__all__ = ["TelemetryServer", "serve_metrics", "check_remount"]


def _help(name):
    from . import _help as pkg_help
    return pkg_help(name)


class _Handler(BaseHTTPRequestHandler):
    server_version = "paddle-tpu-telemetry/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, *_a):     # stdout silence: scrapes are periodic
        pass

    def do_GET(self):               # noqa: N802 (http.server contract)
        owner = self.server._owner
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                body = owner.registry.to_prometheus().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
                code = 200
            elif path == "/healthz":
                payload = {"status": "ok"}
                if owner.health_fn is not None:
                    payload.update(owner.health_fn() or {})
                body = (json.dumps(payload, sort_keys=True) + "\n").encode()
                ctype = "application/json"
                code = 200
            elif path == "/slo":
                payload = owner.slo_fn() if owner.slo_fn is not None else {}
                body = (json.dumps(payload, sort_keys=True) + "\n").encode()
                ctype = "application/json"
                code = 200
            elif path == "/memory":
                if owner.memory_fn is not None:
                    payload = owner.memory_fn()
                else:
                    from .compile_insight import hbm_ledger
                    payload = hbm_ledger().snapshot()
                body = (json.dumps(payload, sort_keys=True) + "\n").encode()
                ctype = "application/json"
                code = 200
            elif path == "/series":
                # the fleet-health time-series store
                # (observability/timeseries.py); components without a
                # signal plane serve the empty schema shape
                if owner.series_fn is not None:
                    payload = owner.series_fn()
                else:
                    payload = None
                if payload is None:
                    from .timeseries import empty_series
                    payload = empty_series()
                body = (json.dumps(payload, sort_keys=True) + "\n").encode()
                ctype = "application/json"
                code = 200
            elif path == "/tenants":
                payload = (owner.tenants_fn()
                           if owner.tenants_fn is not None else {})
                body = (json.dumps(payload, sort_keys=True) + "\n").encode()
                ctype = "application/json"
                code = 200
            else:
                body = (json.dumps(
                    {"error": "not found",
                     "endpoints": ["/metrics", "/healthz", "/slo",
                                   "/memory", "/series", "/tenants"]})
                    + "\n").encode()
                ctype = "application/json"
                code = 404
        except Exception as e:      # noqa: BLE001 — a broken stats fn
            # must surface as an unhealthy scrape, never kill the server
            body = (json.dumps({"status": "error", "error": repr(e)})
                    + "\n").encode()
            ctype = "application/json"
            code = 500
        owner._count(path, code)
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class TelemetryServer:
    """One mounted telemetry endpoint. start() binds and spawns the
    daemon serve thread; close() shuts it down (idempotent)."""

    def __init__(self, registry=None, host="127.0.0.1", port=0,
                 slo_fn=None, health_fn=None, memory_fn=None,
                 series_fn=None, tenants_fn=None):
        self.registry = registry if registry is not None \
            else global_registry()
        self.slo_fn = slo_fn
        self.health_fn = health_fn
        # None -> the process-wide HBM ledger, resolved per request so
        # a custom memory view stays injectable for tests
        self.memory_fn = memory_fn
        # /series time-series store and /tenants cost attribution;
        # None serves the schema's empty shape (series) or {} (tenants)
        self.series_fn = series_fn
        self.tenants_fn = tenants_fn
        self._requested = (host, int(port))
        self._httpd = None
        self._thread = None
        # counts land on the SERVED registry: a custom-registry
        # endpoint's own traffic shows up in its own /metrics output
        # instead of polluting the process-wide registry
        self._requests = self.registry.counter(
            "exporter.requests", _help("exporter.requests"))

    _KNOWN_PATHS = ("/metrics", "/healthz", "/slo", "/memory",
                    "/series", "/tenants")

    def _count(self, path, code):
        # unknown paths collapse to one label value: a crawler probing
        # /a1../aN must not mint unbounded series in the global registry
        if path not in self._KNOWN_PATHS:
            path = "<other>"
        self._requests.labels(path=path, code=str(code)).inc()
        self._requests.inc()        # unlabeled aggregate

    def start(self):
        if self._httpd is not None:
            return self
        self._httpd = ThreadingHTTPServer(self._requested, _Handler)
        self._httpd.daemon_threads = True
        self._httpd._owner = self
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"paddle-tpu-telemetry:{self.port}", daemon=True)
        self._thread.start()
        return self

    @property
    def host(self):
        if self._httpd is not None:
            return self._httpd.server_address[0]
        return self._requested[0]

    @property
    def port(self):
        """The BOUND port (port=0 requests an ephemeral one)."""
        if self._httpd is not None:
            return self._httpd.server_address[1]
        return self._requested[1]

    @property
    def url(self):
        return f"http://{self.host}:{self.port}"

    @property
    def closed(self):
        """True once close() ran (or start() never did) — component
        mounts check this to remount instead of returning a dead
        endpoint."""
        return self._httpd is None

    def close(self):
        httpd, self._httpd = self._httpd, None
        if httpd is None:
            return
        httpd.shutdown()
        httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *_exc):
        self.close()
        return False


def check_remount(live, port, host):
    """Component-mount guard (GenerationServer.serve_metrics):
    with a mount already live, an explicit request for a DIFFERENT
    port/host must raise — silently returning the old endpoint leaves
    the asked-for port unbound while the call looks successful.
    ``port=0`` / ``host=None`` mean "whatever is mounted"."""
    want_port = int(port)
    if want_port and want_port != live.port:
        raise ValueError(
            f"telemetry endpoint already mounted on port {live.port}; "
            f"close() it before asking for port {want_port}")
    if host is not None and host != live._requested[0]:
        raise ValueError(
            f"telemetry endpoint already mounted on host "
            f"{live._requested[0]!r}; close() it before asking for "
            f"host {host!r}")


def serve_metrics(port=0, host="127.0.0.1", registry=None, slo_fn=None,
                  health_fn=None, memory_fn=None, series_fn=None,
                  tenants_fn=None):
    """Mount and start a telemetry endpoint; returns the running
    TelemetryServer (``.port`` holds the bound port, ``.close()`` stops
    it). Binds loopback by default — see the module security note."""
    return TelemetryServer(registry=registry, host=host, port=port,
                           slo_fn=slo_fn, health_fn=health_fn,
                           memory_fn=memory_fn, series_fn=series_fn,
                           tenants_fn=tenants_fn).start()
