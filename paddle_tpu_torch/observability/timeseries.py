"""Fleet health signals, part 1: the metric time-series store.

Counterpart of ``paddle_tpu/observability/timeseries.py``, kept as the
port's own copy (host-side only; the payload schemas are the JAX
package's).

Everything the observability stack exposed before this module is
instantaneous — a gauge is its last value, `check_slo` answers only
"now", and `SLOTracker` keeps one completed window. The fleet's
autoscaler ("spawn/retire replica slots from live check_slo burn
rates") and the alert engine (observability/alerts.py) both need
HISTORY: is the burn rate rising, falling, or flapping?

`SeriesStore` is that history: a dict of bounded drop-oldest rings of
``(t, value)`` points, one ring per series key. Points arrive three
ways, all injected-clock-safe (no wall clocks, no RNG — callers pass
``t`` from the same clock that drives the serving tier):

- ``observe(name, t, value)`` / ``observe_many(t, pairs)`` — direct
  appends. The engine's ServingTelemetry feeds per-iteration scalars
  (step_ms, queue depth, block occupancy) and every completed SLO
  window's quantiles this way; the router feeds windowed burn rates.
- ``sample(t, registry=...)`` — one sampling tick over a
  MetricsRegistry: every gauge series under the configured name
  prefixes becomes a point, and every counter becomes a RATE point
  (delta since the previous tick / elapsed seconds, key suffixed
  ``:rate``) — a counter's absolute value is monotone noise on a
  chart, its slope is the signal. The router calls this once per
  heartbeat.

Series keys are Prometheus-flavored: ``name`` for the unlabeled
series, ``name{k=v,...}`` (sorted) for labeled children. Total key
cardinality is bounded (``max_series``); series beyond the cap are
dropped and counted, never silently absorbed.

Fleet merging follows the fleet tracer's dead-snapshot idiom
(fleet_trace.FleetTracer): `FleetSeriesStore` tracks each replica's
live store by slot name + generation, freezes a dying replica's
payload into a bounded snapshot ring BEFORE the slot is resurrected
with a fresh store, and `merged()` emits fleet + dead + live sources
in one payload — a killed replica's history survives into the merged
``/series`` view, and a dropped snapshot marks the payload truncated.

Served at ``/series`` (exporter.py) and dumpable beside the Perfetto
trace via ``FleetRouter.dump_signals``. Metrics:
``serving.series.{points,dropped_points}``.
"""

import collections
import json
import threading

from .metrics import global_registry

__all__ = ["SeriesStore", "FleetSeriesStore", "empty_series",
           "series_key"]

SCHEMA = "paddle_tpu.series/1"
FLEET_SCHEMA = "paddle_tpu.series_fleet/1"


def empty_series():
    """The ``paddle_tpu.series/1`` payload with no store behind it —
    the /series body a component WITHOUT a signal plane serves
    (exporter.py). One definition of the schema's empty shape, same
    contract as fleet_trace.empty_trace_ring."""
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

    def __init__(self, capacity=512, max_series=256,
                 prefixes=("serving.",), label=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.max_series = int(max_series)
        self.prefixes = tuple(prefixes)
        self.label = label
        self._rings = {}                 # key -> _Ring
        self._prev = {}                  # counter key -> (t, total)
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

    # -- registry sampling --------------------------------------------------
    def _wants(self, name):
        return any(name.startswith(p) for p in self.prefixes)

    def sample(self, t, registry=None):
        """One sampling tick over a MetricsRegistry: gauges become
        points, counters become rate points (delta/dt vs the previous
        tick, key suffixed ``:rate``; the first tick only establishes
        the baseline). Returns the number of points recorded."""
        reg = registry if registry is not None else global_registry()
        pairs = []
        for name in reg.names():
            if not self._wants(name):
                continue
            metric = reg.get(name)
            kind = getattr(metric, "kind", None)
            if kind == "gauge":
                for labels, child in metric.series():
                    pairs.append((series_key(name, labels),
                                  child.value()))
            elif kind == "counter":
                key = f"{name}:rate"
                total = metric.value()
                prev = self._prev.get(key)
                self._prev[key] = (t, total)
                if prev is not None and t > prev[0]:
                    rate = (total - prev[1]) / (t - prev[0])
                    pairs.append((key, rate))
        self.observe_many(t, pairs)
        return len(pairs)

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

    to_dict = payload

    @classmethod
    def from_dict(cls, d):
        s = cls(capacity=max(int(d.get("capacity", 1)), 1),
                label=d.get("label"))
        for key, ser in d.get("series", {}).items():
            ring = _Ring(s.capacity)
            ring.dropped = int(ser.get("dropped", 0))
            for t, v in ser.get("points", ()):
                ring.points.append((t, v))
            s._rings[key] = ring
        s._points_total = int(d.get("points", 0))
        s._dropped_series = int(d.get("dropped_series", 0))
        return s

    def save(self, path):
        with open(path, "w") as f:
            json.dump(self.payload(), f, separators=(",", ":"),
                      sort_keys=True)
            f.write("\n")
        return path


class FleetSeriesStore:
    """The router's series plane: its own fleet-level store plus a
    reference to each replica's engine-level store, merged with the
    fleet_trace death-snapshot idiom — a killed replica's history is
    frozen into a bounded postmortem ring before the slot is
    resurrected with a fresh store, so ``merged()`` never loses the
    victim's half of a storm."""

    #: bounded postmortem snapshots of dead replicas' series
    MAX_SNAPSHOTS = 16

    def __init__(self, name, capacity=512, max_series=256):
        self.name = name
        self.fleet = SeriesStore(capacity=capacity,
                                 max_series=max_series,
                                 label=f"fleet router {name}")
        self._live = {}              # replica name -> (generation, store)
        self._dead = collections.deque(maxlen=self.MAX_SNAPSHOTS)
        self._snapshots_dropped = 0
        self._lock = threading.Lock()

    def attach(self, name, store, generation=0):
        """Register replica slot `name`'s live store at `generation`.
        A resurrection re-registers the slot name with the fresh
        engine's store — the old history must already be snapshotted
        (snapshot_replica) or it is snapshotted here."""
        with self._lock:
            old = self._live.get(name)
            if old is not None and old[1] is store:
                return
            if old is not None:
                self._snapshot_locked(name)
            self._live[name] = (int(generation), store)

    def snapshot_replica(self, name):
        """Freeze a dying replica's series into the postmortem ring
        (idempotent per registration), mirroring
        FleetTracer.snapshot_replica."""
        with self._lock:
            self._snapshot_locked(name)

    def _snapshot_locked(self, name):
        entry = self._live.pop(name, None)
        if entry is None:
            return
        gen, store = entry
        if len(self._dead) == self._dead.maxlen:
            self._snapshots_dropped += 1
        self._dead.append((f"replica {name} gen{gen} (dead)",
                           store.payload()))

    def merged(self):
        """ONE payload over every source: the fleet store, each dead
        replica's snapshot, and each live replica's store. A dropped
        snapshot marks the payload truncated — a partial history must
        never read as a complete one."""
        with self._lock:
            sources = [(f"fleet router {self.name}",
                        self.fleet.payload())]
            sources.extend(self._dead)
            for name in sorted(self._live):
                gen, store = self._live[name]
                label = (f"replica {name}" if gen == 0
                         else f"replica {name} gen{gen}")
                sources.append((label, store.payload()))
            snapshots_dropped = self._snapshots_dropped
        return {"schema": FLEET_SCHEMA, "router": self.name,
                "sources": [{"name": label, **payload}
                            for label, payload in sources],
                "snapshots_dropped": snapshots_dropped,
                "truncated": snapshots_dropped > 0}

    def save(self, path, payload=None):
        payload = payload if payload is not None else self.merged()
        with open(path, "w") as f:
            json.dump(payload, f, separators=(",", ":"),
                      sort_keys=True)
            f.write("\n")
        return path

    def stats(self):
        with self._lock:
            return {"live_stores": len(self._live),
                    "dead_snapshots": len(self._dead),
                    "snapshots_dropped": self._snapshots_dropped,
                    "fleet_points": self.fleet._points_total}
