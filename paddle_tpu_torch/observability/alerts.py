"""Fleet health signals, part 2: the declarative alert rule engine.

Counterpart of ``paddle_tpu/observability/alerts.py``, kept as the
port's own copy (host-side only; the payload schema is the JAX
package's).

`check_slo` can say "the burn rate is 3.1 right now"; nothing in the
stack can say "and it has been for two minutes, page someone" — or the
opposite, "that was a one-heartbeat blip, stand down". This module is
that judgment layer: a set of declarative rules over SeriesStore
series (observability/timeseries.py), evaluated once per sample tick
with the SAME injected clock that produced the points, so a chaos
storm replays to an identical alert timeline.

Rule kinds (AlertRule classmethod constructors):

- ``threshold(series, op, threshold, for_s=...)`` — the newest point
  must satisfy ``value OP threshold`` continuously for ``for_s``
  seconds before the alert fires (a streak, tracked per rule; any
  non-satisfying point resets it).
- ``delta(series, threshold, window_s=...)`` — the change across the
  trailing window (newest minus oldest point in window) crosses the
  threshold: leak and runaway detection.
- ``absence(series, window_s=...)`` — no new point for ``window_s``:
  staleness, the "replica stopped reporting" signal. Grace-gated on
  the rule's first evaluation so a young fleet isn't instantly stale.
- ``burn_rate(series, threshold, fast_s, slow_s)`` — the SRE
  multi-window form: the MEAN over the fast window AND the mean over
  the slow window must both exceed the threshold before paging. The
  fast window gives detection latency, the slow window proves the
  burn is sustained — a single-heartbeat spike satisfies neither
  alone, so blips don't flap the pager.

Lifecycle is latched: ``ok → firing → resolved → firing → ...``. An
alert that has ever fired stays in the payload with its fired/resolved
stamps and counts — the /alerts body is a record, not just a snapshot.
Transitions move ``serving.alerts.{fired,resolved,active}`` and invoke
``on_event`` — the router mirrors that into the fleet trace track and
fleet FlightRecorder as instants (the `_flight_event` path), so alert
history lands in the same postmortem artifacts as the storm that
caused it. Served at ``/alerts`` (exporter.py), and read by the
fleet's autoscaler.
"""

import operator
import threading

from .metrics import global_registry

__all__ = ["AlertRule", "AlertManager", "empty_alerts"]

SCHEMA = "paddle_tpu.alerts/1"

_OPS = {">": operator.gt, ">=": operator.ge,
        "<": operator.lt, "<=": operator.le}


def empty_alerts():
    """The ``paddle_tpu.alerts/1`` payload with no alert plane behind
    it — the /alerts body a component WITHOUT a signal plane serves
    (exporter.py); AlertManager.payload() builds on it."""
    return {"schema": SCHEMA, "label": None, "rules": 0,
            "evaluations": 0, "active": 0, "alerts": []}


class AlertRule:
    """One declarative rule over one series. Build via the classmethod
    constructors — they pin the per-kind parameter set."""

    KINDS = ("threshold", "delta", "absence", "burn_rate")

    def __init__(self, kind, name, series, op=">", threshold=0.0,
                 for_s=0.0, window_s=0.0, fast_s=0.0, slow_s=0.0):
        if kind not in self.KINDS:
            raise ValueError(f"unknown rule kind {kind!r}; "
                             f"expected one of {self.KINDS}")
        if op not in _OPS:
            raise ValueError(f"unknown op {op!r}; "
                             f"expected one of {tuple(_OPS)}")
        if kind == "burn_rate" and not 0 < fast_s <= slow_s:
            raise ValueError("burn_rate needs 0 < fast_s <= slow_s, "
                             f"got fast_s={fast_s} slow_s={slow_s}")
        self.kind = kind
        self.name = name
        self.series = series
        self.op = op
        self.threshold = float(threshold)
        self.for_s = float(for_s)
        self.window_s = float(window_s)
        self.fast_s = float(fast_s)
        self.slow_s = float(slow_s)

    @classmethod
    def threshold_rule(cls, name, series, threshold, op=">",
                       for_s=0.0):
        return cls("threshold", name, series, op=op,
                   threshold=threshold, for_s=for_s)

    @classmethod
    def delta(cls, name, series, threshold, op=">", window_s=60.0):
        return cls("delta", name, series, op=op, threshold=threshold,
                   window_s=window_s)

    @classmethod
    def absence(cls, name, series, window_s=60.0):
        return cls("absence", name, series, window_s=window_s)

    @classmethod
    def burn_rate(cls, name, series, threshold, fast_s, slow_s):
        return cls("burn_rate", name, series, threshold=threshold,
                   fast_s=fast_s, slow_s=slow_s)

    def to_dict(self):
        d = {"kind": self.kind, "name": self.name,
             "series": self.series}
        if self.kind == "threshold":
            d.update(op=self.op, threshold=self.threshold,
                     for_s=self.for_s)
        elif self.kind == "delta":
            d.update(op=self.op, threshold=self.threshold,
                     window_s=self.window_s)
        elif self.kind == "absence":
            d.update(window_s=self.window_s)
        else:
            d.update(threshold=self.threshold, fast_s=self.fast_s,
                     slow_s=self.slow_s)
        return d


class _AlertState:
    """One rule's latched lifecycle record."""

    __slots__ = ("rule", "state", "fired_at", "resolved_at",
                 "fired_count", "resolved_count", "last_value",
                 "streak_since", "first_eval")

    def __init__(self, rule):
        self.rule = rule
        self.state = "ok"
        self.fired_at = None
        self.resolved_at = None
        self.fired_count = 0
        self.resolved_count = 0
        self.last_value = None
        self.streak_since = None     # threshold streak anchor
        self.first_eval = None       # absence grace anchor

    def to_dict(self):
        return {"name": self.rule.name, "state": self.state,
                "rule": self.rule.to_dict(),
                "fired_at": self.fired_at,
                "resolved_at": self.resolved_at,
                "fired_count": self.fired_count,
                "resolved_count": self.resolved_count,
                "last_value": self.last_value}


def _window_points(points, t, window_s):
    """Points with stamp in [t - window_s, t], oldest first."""
    lo = t - window_s
    return [(pt, v) for pt, v in points if pt >= lo]


class AlertManager:
    """Evaluates rules against one SeriesStore on each sample tick.

    `on_event(kind, alert, t)` (kind in {"fired", "resolved"}) is the
    mirror hook — the router points it at its `_flight_event` path so
    transitions become fleet-trace instants and flight records."""

    def __init__(self, store, rules=(), label=None, on_event=None):
        self.store = store
        self.label = label
        self.on_event = on_event
        self._alerts = {}           # rule name -> _AlertState
        self._lock = threading.Lock()
        self._evaluations = 0
        reg = global_registry()
        self._m_fired = reg.counter(
            "serving.alerts.fired", "alert rule transitions to firing")
        self._m_resolved = reg.counter(
            "serving.alerts.resolved",
            "alert rule transitions firing -> resolved")
        self._g_active = reg.gauge(
            "serving.alerts.active", "alert rules currently firing")
        self._labels = {"manager": label} if label is not None else {}
        for r in rules:
            self.add_rule(r)

    def add_rule(self, rule):
        with self._lock:
            if rule.name in self._alerts:
                raise ValueError(f"duplicate alert rule {rule.name!r}")
            self._alerts[rule.name] = _AlertState(rule)

    # -- condition evaluation -----------------------------------------------
    def _condition(self, st, t):
        """(condition_holds, observed_value) for one rule at t."""
        rule = st.rule
        if rule.kind == "absence":
            if st.first_eval is None:
                st.first_eval = t
            latest = self.store.latest(rule.series)
            last_t = latest[0] if latest is not None else st.first_eval
            stale_s = t - last_t
            return stale_s >= rule.window_s, round(stale_s, 6)
        points = self.store.series(rule.series)
        if rule.kind == "threshold":
            if not points:
                st.streak_since = None
                return False, None
            pt, v = points[-1]
            if not _OPS[rule.op](v, rule.threshold):
                st.streak_since = None
                return False, v
            if st.streak_since is None:
                st.streak_since = pt
            return t - st.streak_since >= rule.for_s, v
        if rule.kind == "delta":
            win = _window_points(points, t, rule.window_s)
            if len(win) < 2:
                return False, None
            change = win[-1][1] - win[0][1]
            return _OPS[rule.op](change, rule.threshold), \
                round(change, 6)
        # burn_rate: both windows' means must exceed the threshold
        fast = _window_points(points, t, rule.fast_s)
        slow = _window_points(points, t, rule.slow_s)
        if not fast or not slow:
            return False, None
        mean_fast = sum(v for _t, v in fast) / len(fast)
        mean_slow = sum(v for _t, v in slow) / len(slow)
        return (mean_fast > rule.threshold
                and mean_slow > rule.threshold), round(mean_fast, 6)

    # -- tick ---------------------------------------------------------------
    def evaluate(self, t):
        """One evaluation tick at caller-supplied t. Returns the list
        of (kind, alert_dict) transition events this tick produced."""
        events = []
        with self._lock:
            self._evaluations += 1
            for st in self._alerts.values():
                holds, value = self._condition(st, t)
                st.last_value = value
                if holds and st.state != "firing":
                    st.state = "firing"
                    st.fired_at = round(t, 6)
                    st.fired_count += 1
                    events.append(("fired", st.to_dict()))
                elif not holds and st.state == "firing":
                    st.state = "resolved"
                    st.resolved_at = round(t, 6)
                    st.resolved_count += 1
                    events.append(("resolved", st.to_dict()))
            active = sum(1 for s in self._alerts.values()
                         if s.state == "firing")
            if self._labels:
                self._g_active.labels(**self._labels).set(active)
            self._g_active.set(active)
        for kind, alert in events:
            m = self._m_fired if kind == "fired" else self._m_resolved
            m.inc()
            if self.on_event is not None:
                self.on_event(kind, alert, t)
        return events

    # -- read side ----------------------------------------------------------
    @property
    def active(self):
        with self._lock:
            return sorted(s.rule.name for s in self._alerts.values()
                          if s.state == "firing")

    def state(self, name):
        with self._lock:
            return self._alerts[name].state

    def payload(self):
        """The /alerts body: the empty_alerts shape, filled in.
        Firing alerts sort first so the autoscaler reads the pageable
        set off the top."""
        order = {"firing": 0, "resolved": 1, "ok": 2}
        with self._lock:
            alerts = sorted((s.to_dict() for s in
                             self._alerts.values()),
                            key=lambda a: (order[a["state"]],
                                           a["name"]))
            return dict(empty_alerts(), label=self.label,
                        rules=len(self._alerts),
                        evaluations=self._evaluations,
                        active=sum(1 for a in alerts
                                   if a["state"] == "firing"),
                        alerts=alerts)

    def stats(self):
        """Cheap counters for get_stats() embedding (no alert list)."""
        with self._lock:
            return {"rules": len(self._alerts),
                    "active": sum(1 for s in self._alerts.values()
                                  if s.state == "firing"),
                    "evaluations": self._evaluations}

    def drop_gauges(self):
        """Retire this manager's active-alert series (router close
        path — a dead router must not report stale alert gauges)."""
        if self._labels:
            self._g_active.remove(**self._labels)
