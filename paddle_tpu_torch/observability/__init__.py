"""Runtime observability of the port: metrics, tracing, serving telemetry.

Counterpart of ``paddle_tpu/observability``, kept as the port's own copy
(the port imports nothing of the JAX package). The pieces:

- metrics.py: the process-wide MetricsRegistry (counters, gauges,
  ms-histograms; JSON and Prometheus export) and ``METRIC_SPECS``, the
  JAX package's metric namespace, name for name and kind for kind.
- tracing.py: the Chrome trace_event recorder (Perfetto-loadable), off
  by default, a bounded drop-oldest ring.
- sketch.py: the deterministic mergeable quantile digest behind the
  SLO p50/p90/p99.
- timeseries.py: ``SeriesStore``, bounded (t, value) rings a server's
  telemetry feeds every iteration.
- serving_telemetry.py: request lifecycle span trees, SLO digests, the
  per-tenant ledger and the fault flight recorder
  (``GenerationServer`` wires them).
- exporter.py: the stdlib HTTP endpoint (/metrics, /healthz, /slo,
  /memory, /series, /tenants) ``serve_metrics`` mounts.
- compile_insight.py: the HBM ledger (``hbm_ledger()``): block pools,
  the host KV tier, parameters and the fused step's peak estimate per
  server.
- fleet_trace.py, alerts.py: the fleet router's trace correlation
  (one trace id a request across replicas) and its alert rules over
  the merged series (``FleetSeriesStore`` in timeseries.py).
- ComponentStats (here): the per-component view an instrumented object
  (the checkpoint manager) holds: every update lands in both the
  component's private registry and the process-wide one.

serving_telemetry, exporter and compile_insight are imported by their
users, not here (the exporter pulls http.server in).
"""

import contextlib
import time

from . import metrics
from . import sketch
from . import tracing
from .metrics import (DEFAULT_MS_BUCKETS, METRIC_SPECS, MetricsRegistry,
                      global_registry)
from .sketch import QuantileSketch
from .tracing import TraceRecorder, get_recorder

__all__ = ["metrics", "tracing", "sketch", "MetricsRegistry",
           "global_registry", "METRIC_SPECS", "DEFAULT_MS_BUCKETS",
           "QuantileSketch", "TraceRecorder", "get_recorder",
           "ComponentStats"]


class ComponentStats:
    """Local + global metrics fan-out for one instrumented component.

    `gauge_labels` (e.g. {"executor": "exe0"}) distinguish this
    component's gauge series in the process-wide registry — two live
    Executors must not stomp each other's cache-size gauges. Counters
    and histograms aggregate unlabeled globally (per-instance numbers
    come from the local registry via get_stats())."""

    def __init__(self, gauge_labels=None):
        self.local = MetricsRegistry()
        self.gauge_labels = dict(gauge_labels or {})
        # name -> (local metric, global metric) handles, resolved once,
        # so a hot path does not pay the registry lock and name check on
        # each update. reset() zeroes values in place, so cached handles
        # stay valid across it.
        self._handles = {}

    def _pair(self, name, method):
        pair = self._handles.get((name, method))
        if pair is None:
            make_local = getattr(self.local, method)
            make_global = getattr(global_registry(), method)
            pair = (make_local(name, _help(name)),
                    make_global(name, _help(name)))
            self._handles[(name, method)] = pair
        return pair

    def count(self, name, n=1):
        local, glob = self._pair(name, "counter")
        local.inc(n)
        glob.inc(n)

    def observe(self, name, ms, labels=None):
        local, glob = self._pair(name, "histogram")
        (local.labels(**labels) if labels else local).observe(ms)
        # the global side aggregates UNLABELED: per-(program, shapes)
        # label sets are unbounded in a long-lived process, so labeled
        # series live only in this component's registry, which dies with
        # the component
        glob.observe(ms)

    def set_gauge(self, name, value):
        local, glob = self._pair(name, "gauge")
        local.set(value)
        (glob.labels(**self.gauge_labels) if self.gauge_labels
         else glob).set(value)

    def drop_gauges(self, *names):
        """Zero local gauges and REMOVE this component's global gauge
        series — a closed executor must not report stale cache sizes
        forever from a long-lived process."""
        for name in names:
            m = self.local.get(name)
            if m is not None:
                m.reset()
            g = global_registry().get(name)
            if g is not None:
                if self.gauge_labels:
                    g.remove(**self.gauge_labels)
                else:
                    g.reset()

    @contextlib.contextmanager
    def span(self, trace_name, metric_name, trace_args=None):
        """Time a region into metric_name (both registries) and, when a
        capture is live, into the global Chrome-trace recorder. The
        metric observes even when the body raises (the trace recorder
        records the event in its own finally) so timeline and histograms
        never disagree about what happened."""
        t0 = time.perf_counter()
        try:
            with get_recorder().span(trace_name, cat="executor",
                                     args=trace_args):
                yield
        finally:
            self.observe(metric_name, (time.perf_counter() - t0) * 1e3)

    def reset(self):
        self.local.reset()


_HELP = {name: help for name, _kind, help in METRIC_SPECS}


def _help(name):
    """The METRIC_SPECS help text of a metric name ("" if undeclared)."""
    return _HELP.get(name, "")
