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

serving_telemetry, exporter and compile_insight are imported by their
users, not here (the exporter pulls http.server in).
"""

from . import metrics
from . import sketch
from . import tracing
from .metrics import (DEFAULT_MS_BUCKETS, METRIC_SPECS, MetricsRegistry,
                      global_registry)
from .sketch import QuantileSketch
from .tracing import TraceRecorder, get_recorder

__all__ = ["metrics", "tracing", "sketch", "MetricsRegistry",
           "global_registry", "METRIC_SPECS", "DEFAULT_MS_BUCKETS",
           "QuantileSketch", "TraceRecorder", "get_recorder"]

_HELP = {name: help for name, _kind, help in METRIC_SPECS}


def _help(name):
    """The METRIC_SPECS help text of a metric name ("" if undeclared)."""
    return _HELP.get(name, "")
