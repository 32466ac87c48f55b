"""The metric time-series store (``SeriesStore``).

Counterpart of ``paddle_tpu/observability/timeseries.py``, kept as the
port's own copy of its single-server half: a dict of bounded
drop-oldest rings of ``(t, value)`` points, one ring per series key.
Points arrive through ``observe(name, t, value)`` /
``observe_many(t, pairs)``, injected-clock-safe (callers pass ``t`` from
the clock that drives the serving tier): the engine's ServingTelemetry
feeds per-iteration scalars (step_ms, queue depth, block occupancy) and
every completed SLO window's quantiles. The JAX store's registry
sampling feeds the fleet's burn rates and waits for the fleet.

Series keys are Prometheus-flavored: ``name`` for the unlabeled
series, ``name{k=v,...}`` (sorted) for labeled children. Total key
cardinality is bounded (``max_series``); series beyond the cap are
dropped and counted. Served at ``/series`` (exporter.py). Metrics:
``serving.series.{points,dropped_points}``.
"""

import collections
import threading

from .metrics import global_registry

__all__ = ["SeriesStore", "empty_series", "series_key"]

SCHEMA = "paddle_tpu.series/1"


def empty_series():
    """The ``paddle_tpu.series/1`` payload with no store behind it —
    the /series body a component WITHOUT a signal plane serves
    (exporter.py)."""
    return {"schema": SCHEMA, "label": None, "capacity": 0,
            "points": 0, "dropped_points": 0, "dropped_series": 0,
            "series": {}}


def series_key(name, labels=None):
    """Prometheus-flavored series key: ``name`` unlabeled,
    ``name{k=v,...}`` (keys sorted) otherwise."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class _Ring:
    """One series: a bounded drop-oldest ring of (t, value) points."""

    __slots__ = ("points", "dropped")

    def __init__(self, capacity):
        self.points = collections.deque(maxlen=capacity)
        self.dropped = 0

    def append(self, t, v):
        if len(self.points) == self.points.maxlen:
            self.dropped += 1
        self.points.append((t, v))


class SeriesStore:
    """Bounded rings of (t, value) points keyed by series name.

    Callers own the clock: every entry point takes ``t`` explicitly,
    so a chaos-driven injected clock produces bit-identical stores on
    replay. Thread-safe (router heartbeat thread + engine callback
    threads feed one store)."""

    def __init__(self, capacity=512, max_series=256, label=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.max_series = int(max_series)
        self.label = label
        self._rings = {}                 # key -> _Ring
        self._lock = threading.Lock()
        self._points_total = 0
        self._dropped_series = 0
        reg = global_registry()
        self._m_points = reg.counter(
            "serving.series.points",
            "time-series points recorded (all stores)")
        self._m_dropped = reg.counter(
            "serving.series.dropped_points",
            "time-series points evicted by ring wrap (all stores)")

    # -- direct appends -----------------------------------------------------
    def _ring(self, key):
        ring = self._rings.get(key)
        if ring is None:
            if len(self._rings) >= self.max_series:
                self._dropped_series += 1
                return None
            ring = self._rings[key] = _Ring(self.capacity)
        return ring

    def observe(self, name, t, value):
        """Append one point to series `name` at caller-supplied t."""
        self.observe_many(t, ((name, value),))

    def observe_many(self, t, pairs):
        """Append a batch of (name, value) points at one t — the
        engine's per-iteration hot path uses this so the metric inc
        and lock round-trip are paid once per iteration, not once per
        point."""
        n = dropped = 0
        with self._lock:
            for name, value in pairs:
                ring = self._ring(name)
                if ring is None:
                    continue
                before = ring.dropped
                ring.append(t, value)
                dropped += ring.dropped - before
                n += 1
            self._points_total += n
        if n:
            self._m_points.inc(n)
        if dropped:
            self._m_dropped.inc(dropped)

    # -- read side ----------------------------------------------------------
    def series(self, name):
        """[(t, value), ...] for one series (empty when absent)."""
        with self._lock:
            ring = self._rings.get(name)
            return list(ring.points) if ring is not None else []

    def latest(self, name):
        """The newest (t, value) of a series, or None."""
        with self._lock:
            ring = self._rings.get(name)
            if ring is None or not ring.points:
                return None
            return ring.points[-1]

    def names(self):
        with self._lock:
            return sorted(self._rings)

    def payload(self):
        """The /series body: the empty_series shape, filled in."""
        with self._lock:
            series = {k: {"points": [[t, v] for t, v in r.points],
                          "dropped": r.dropped}
                      for k, r in sorted(self._rings.items())}
            return dict(empty_series(), label=self.label,
                        capacity=self.capacity,
                        points=self._points_total,
                        dropped_points=sum(r.dropped for r in
                                           self._rings.values()),
                        dropped_series=self._dropped_series,
                        series=series)
