"""Stdlib HTTP telemetry endpoint: /metrics (Prometheus), /healthz, /slo,
/memory, /trace, /series, /alerts, /tenants.

Counterpart of ``paddle_tpu/observability/exporter.py``, kept as the
port's own copy. ``GenerationServer.serve_metrics(port=...)`` and
``FleetRouter.serve_metrics(port=...)`` wrap it; a bare
``serve_metrics()`` exports just the process-wide registry.

- ``GET /metrics``: Prometheus text exposition
  (``FleetRegistryView`` splices each replica's own ``serving.*``
  numbers in, labeled ``replica=``, when a fleet router mounts it).
- ``GET /healthz``: JSON ``{"status": "ok", ...health_fn()}``; any
  exception in health_fn (or a ``status`` it returns other than ok)
  turns into a 503 with the error text.
- ``GET /slo``: JSON from ``slo_fn()`` (the serving SLO digest).
- ``GET /memory``: JSON HBM-ledger snapshot (``memory_fn()``; default
  is the process-wide ``compile_insight.hbm_ledger()``).
- ``GET /trace``: JSON bounded ring of recently completed request
  traces (``trace_fn()``; the fleet router mounts its completed-trace
  ring); components without a trace plane serve an empty ring.
- ``GET /series``: JSON time-series payload (``series_fn()``; the
  engine mounts its SeriesStore, the fleet router its merged
  fleet+replica view incl. dead replicas' snapshots); the empty schema
  shape otherwise.
- ``GET /alerts``: JSON alert lifecycle record (``alerts_fn()``; the
  fleet router mounts its AlertManager); the empty schema shape
  otherwise.
- ``GET /tenants``: JSON per-tenant cost attribution
  (``tenants_fn()``; ``{}`` when the component tracks none).

Security note: binds 127.0.0.1 by default: the exposition includes
shape names and the SLO surface leaks traffic patterns. Bind a routable
host explicitly only behind your own authn/network policy; the server
itself adds none.
"""

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .metrics import _escape, _escape_help, global_registry

__all__ = ["TelemetryServer", "serve_metrics", "FleetRegistryView"]


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
            elif path == "/trace":
                # the fleet router's bounded ring of recent completed
                # request traces (observability/fleet_trace.py); a
                # component without a trace plane serves an empty ring
                # so the route is always probeable
                if owner.trace_fn is not None:
                    payload = owner.trace_fn()
                else:
                    # the ONE definition of the schema's empty shape —
                    # FleetTracer.completed_payload() builds on the
                    # same helper, so the two producers of trace_ring/1
                    # cannot diverge
                    from .fleet_trace import empty_trace_ring
                    payload = empty_trace_ring()
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
            elif path == "/alerts":
                # the alert rule engine's latched lifecycle record
                # (observability/alerts.py), the autoscaler's input
                if owner.alerts_fn is not None:
                    payload = owner.alerts_fn()
                else:
                    payload = None
                if payload is None:
                    from .alerts import empty_alerts
                    payload = empty_alerts()
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
                                   "/memory", "/trace", "/series",
                                   "/alerts", "/tenants"]})
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
                 trace_fn=None, series_fn=None, alerts_fn=None,
                 tenants_fn=None):
        self.registry = registry if registry is not None \
            else global_registry()
        self.slo_fn = slo_fn
        self.health_fn = health_fn
        # None -> the process-wide HBM ledger, resolved per request so
        # a custom memory view stays injectable for tests
        self.memory_fn = memory_fn
        # /trace body (the fleet router's completed-trace ring); None
        # serves an always-probeable empty ring
        self.trace_fn = trace_fn
        # fleet health signals: /series time-series store,
        # /alerts rule engine, /tenants cost attribution; None serves
        # the schema's empty shape (series/alerts) or {} (tenants)
        self.series_fn = series_fn
        self.alerts_fn = alerts_fn
        self.tenants_fn = tenants_fn
        self._requested = (host, int(port))
        self._httpd = None
        self._thread = None
        # counts land on the SERVED registry: a custom-registry
        # endpoint's own traffic shows up in its own /metrics output
        # instead of polluting the process-wide registry
        self._requests = self.registry.counter(
            "exporter.requests", _help("exporter.requests"))

    _KNOWN_PATHS = ("/metrics", "/healthz", "/slo", "/memory", "/trace",
                    "/series", "/alerts", "/tenants")

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


class FleetRegistryView:
    """Fleet-aware aggregate /metrics view.

    Counters and histograms aggregate UNLABELED in the process-wide
    registry, so two GenerationServers in one
    process were only separable by mounting one exporter PORT each —
    a fleet of N replicas would need N scrape targets. This view is
    ONE scrape target for the whole fleet: the base registry's
    exposition (process aggregates, exactly as before) with every
    replica's own ``serving.*`` numbers spliced INTO the same metric
    families as additional ``replica="<name>"``-labeled samples. The
    per-replica values come from each replica's ``get_stats()`` (the
    scheduler's per-instance counts — the numbers the global
    aggregate cannot attribute), re-read on every scrape, so a
    dead/closed replica's series vanish instead of going stale.

    Duck-types the registry surface TelemetryServer touches
    (``to_prometheus``/``counter``/``to_dict``); mounted by
    ``FleetRouter.serve_metrics``.
    """

    # stats() key -> exposition family, per kind
    _COUNTERS = (("serving.iterations", "iteration"),
                 ("serving.admitted", "admitted"),
                 ("serving.retired", "retired"),
                 ("serving.cancelled", "cancelled"),
                 ("serving.deadline_cancels", "deadline_cancels"),
                 ("serving.generated_tokens", "generated_tokens"),
                 ("serving.prefill_tokens", "prefill_tokens"))
    _GAUGES = (("serving.queue_depth", "queue_depth"),
               ("serving.active_slots", "active_slots"))
    _PREFIX_COUNTERS = (("serving.prefix.hits", "hits"),
                        ("serving.prefix.misses", "misses"),
                        ("serving.prefix.evictions", "evictions"),
                        ("serving.prefix.cow_copies", "cow_copies"))

    def __init__(self, fleet_fn, base=None):
        self._base = base if base is not None else global_registry()
        # -> [(replica_name, server.get_stats()), ...], re-read per
        # scrape (live replicas only — the router's closure filters)
        self._fleet_fn = fleet_fn

    # -- registry facade (what TelemetryServer/_Handler touch) -------------
    def counter(self, name, help=""):
        return self._base.counter(name, help)

    def gauge(self, name, help=""):
        return self._base.gauge(name, help)

    def get(self, name):
        return self._base.get(name)

    def to_dict(self):
        out = self._base.to_dict()
        out["fleet"] = {name: stats for name, stats in self._fleet_fn()}
        return out

    # -- exposition ---------------------------------------------------------
    def _replica_samples(self, stats):
        """-> (family, kind, value) triples for one replica's stats."""
        for fam, key in self._COUNTERS:
            if key in stats:
                yield fam, "counter", stats[key]
        for fam, key in self._GAUGES:
            if key in stats:
                yield fam, "gauge", stats[key]
        if "blocks_total" in stats and "blocks_free" in stats:
            yield ("serving.blocks_in_use", "gauge",
                   stats["blocks_total"] - stats["blocks_free"])
        pfx = stats.get("prefix")
        if pfx:
            for fam, key in self._PREFIX_COUNTERS:
                if key in pfx:
                    yield fam, "counter", pfx[key]
            if "shared_blocks" in pfx:
                yield ("serving.prefix.shared_blocks", "gauge",
                       pfx["shared_blocks"])

    def _collect(self):
        from . import _help
        extras = {}     # sanitized family -> [kind, help, [lines]]
        for rep, stats in self._fleet_fn():
            for fam, kind, value in self._replica_samples(stats):
                pname = re.sub(r"[^a-zA-Z0-9_:]", "_", fam)
                ent = extras.setdefault(
                    pname, [kind, _escape_help(_help(fam)), []])
                ent[2].append(
                    f'{pname}{{replica="{_escape(rep)}"}} {value}')
        return extras

    def to_prometheus(self):
        """The base exposition with per-replica samples spliced into
        their families (all samples of one family stay contiguous —
        the format's parser contract); families the base never
        recorded are appended with their own HELP/TYPE header."""
        extras = self._collect()
        out, current = [], None

        def _flush(next_family):
            nonlocal current
            if current is not None and current in extras:
                out.extend(extras.pop(current)[2])
            current = next_family

        for line in self._base.to_prometheus().splitlines():
            if line.startswith("# HELP ") or line.startswith("# TYPE "):
                fam = line.split(" ", 3)[2]
                if fam != current:
                    _flush(fam)
            out.append(line)
        _flush(None)
        for pname in sorted(extras):
            kind, help_, lines = extras[pname]
            if help_:
                out.append(f"# HELP {pname} {help_}")
            out.append(f"# TYPE {pname} {kind}")
            out.extend(lines)
        return "\n".join(out) + "\n"


def check_remount(live, port, host):
    """Component-mount guard (GenerationServer/Executor.serve_metrics):
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
                  health_fn=None, memory_fn=None, trace_fn=None,
                  series_fn=None, alerts_fn=None, tenants_fn=None):
    """Mount and start a telemetry endpoint; returns the running
    TelemetryServer (``.port`` holds the bound port, ``.close()`` stops
    it). Binds loopback by default — see the module security note."""
    return TelemetryServer(registry=registry, host=host, port=port,
                           slo_fn=slo_fn, health_fn=health_fn,
                           memory_fn=memory_fn, trace_fn=trace_fn,
                           series_fn=series_fn, alerts_fn=alerts_fn,
                           tenants_fn=tenants_fn).start()
