"""Structured trace recorder: Chrome trace_event JSON.

Counterpart of ``paddle_tpu/observability/tracing.py``, kept as the
port's own copy. Host-side spans (the serving engine's iterations,
request lifecycles) land here as complete ('X') events and export in the
chrome://tracing / Perfetto schema. Device timelines come from
torch.profiler; these spans are the host's side of them.

The recorder is OFF by default: a disabled span() costs one attribute
check, so the engine calls it unconditionally on the hot path;
recorder.start() turns it on.

The event buffer is a bounded ring (drop-oldest): a long-lived
GenerationServer with tracing on keeps the most recent
`PADDLE_TPU_TRACE_BUFFER` events (default 200k) instead of growing host
memory without limit. Drops are counted in the `tracing.dropped_events`
metric and reported in the export's otherData so a truncated capture is
never mistaken for a complete one.

Besides thread-keyed spans, events can target a named *track* (the
`track=` argument): serving request lifecycles render one Perfetto track
per decode slot instead of interleaving on the engine thread's row.
"""

import collections
import contextlib
import json
import os
import threading
import time
import warnings

__all__ = ["TraceRecorder", "get_recorder", "DEFAULT_MAX_EVENTS"]

DEFAULT_MAX_EVENTS = 200_000


def _default_max_events():
    raw = os.environ.get("PADDLE_TPU_TRACE_BUFFER", "").strip()
    if not raw:
        return DEFAULT_MAX_EVENTS
    try:
        n = int(raw)
        if n <= 0:
            raise ValueError(n)
    except ValueError:
        # a typo'd knob must not silently shrink the ring to 1 event
        # (or silently revert to the default): warn and use the default
        warnings.warn(
            f"ignoring bad PADDLE_TPU_TRACE_BUFFER={raw!r} (want a "
            f"positive event count); using {DEFAULT_MAX_EVENTS}",
            RuntimeWarning, stacklevel=2)
        return DEFAULT_MAX_EVENTS
    return n


class TraceRecorder:
    def __init__(self, max_events=None):
        self._lock = threading.Lock()
        self._explicit_max = max_events is not None
        self._max_events = int(max_events if max_events is not None
                               else _default_max_events())
        self._events = collections.deque(maxlen=self._max_events)
        self._dropped = 0
        self._dropped_counter = None    # lazy: metrics must not import us
        self._enabled = False
        self._t0 = 0.0          # perf_counter origin of ts=0
        self._epoch0 = 0.0      # wall clock at start() (metadata only)
        self._pid = os.getpid()

    @property
    def enabled(self):
        return self._enabled

    @property
    def max_events(self):
        return self._max_events

    @property
    def dropped(self):
        """Events dropped by the ring since the last start()/clear()."""
        return self._dropped

    def start(self, origin=None):
        """Begin a capture (clears any previous one). `origin` pins the
        perf_counter instant that maps to ts=0 — the fleet tracer
        starts every replica's recorder against ONE shared origin so
        cross-replica stamps merge into a single comparable timeline
        (observability/fleet_trace.py); default is "now"."""
        with self._lock:
            # the global recorder is built at import time; honour a
            # PADDLE_TPU_TRACE_BUFFER set programmatically afterwards by
            # re-reading the knob at capture start (explicit max_events
            # passed to the constructor still wins)
            if not self._explicit_max:
                n = _default_max_events()
                if n != self._max_events:
                    self._max_events = n
                    self._events = collections.deque(maxlen=n)
            self._events.clear()
            self._dropped = 0
            self._t0 = (time.perf_counter() if origin is None
                        else float(origin))
            self._epoch0 = time.time()
            self._enabled = True

    def stop(self):
        self._enabled = False

    def clear(self):
        with self._lock:
            self._events.clear()
            self._dropped = 0

    def events(self):
        with self._lock:
            return list(self._events)

    # -- recording ----------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name, cat="host", args=None):
        """Time a region into a complete event. No-op while disabled."""
        if not self._enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if self._enabled:   # capture may have stopped mid-span: drop
                self._emit(name, cat, (t0 - self._t0) * 1e6,
                           (t1 - t0) * 1e6, args)

    def complete(self, name, start, end, cat="host", args=None, track=None):
        """Record a complete event from explicit perf_counter stamps.

        Request lifecycle span trees are emitted retroactively (the whole
        tree is known only at retirement), so they cannot use the span()
        context manager. `track` names a dedicated Perfetto track (e.g.
        "serving slot 0") instead of keying on the calling thread.

        Stamps predating the capture are clamped to the capture origin:
        a request already in flight when the capture started would
        otherwise emit ts < 0, which Perfetto renders outside the
        viewport — its pre-capture portion is truncated instead."""
        if not self._enabled:
            return
        start_us = max(start - self._t0, 0.0) * 1e6
        end_us = max(end - self._t0, 0.0) * 1e6
        self._emit(name, cat, start_us,
                   max(end_us - start_us, 0.0), args, tid=track)

    def instant(self, name, cat="host", args=None, ts=None, track=None):
        if not self._enabled:
            return
        self._append({
            "ph": "i", "s": "t", "cat": cat, "name": name,
            "pid": self._pid,
            "tid": track if track is not None else threading.get_ident(),
            "ts": max((ts if ts is not None else time.perf_counter())
                      - self._t0, 0.0) * 1e6,
            "args": args or {}})

    def _emit(self, name, cat, ts_us, dur_us, args, tid=None):
        self._append({"ph": "X", "cat": cat, "name": name, "pid": self._pid,
                      "tid": tid if tid is not None
                      else threading.get_ident(),
                      "ts": round(ts_us, 3), "dur": round(dur_us, 3),
                      "args": args or {}})

    def _append(self, evt):
        with self._lock:
            if len(self._events) == self._max_events:
                self._dropped += 1
                if self._dropped_counter is None:
                    from .metrics import global_registry
                    self._dropped_counter = global_registry().counter(
                        "tracing.dropped_events",
                        "trace events dropped by the bounded ring buffer "
                        "(drop-oldest)")
                self._dropped_counter.inc()
            self._events.append(evt)    # deque(maxlen) evicts the oldest

    # -- export -------------------------------------------------------------
    def to_chrome(self):
        """{"traceEvents": [...]} with thread ids renumbered small and
        process/thread metadata ('M') events prepended. String tids
        (named tracks) keep their name on the Perfetto track label."""
        with self._lock:
            events = [dict(e) for e in self._events]
            dropped = self._dropped
        tids = {}
        for e in events:
            e["tid"] = tids.setdefault(e["tid"], len(tids))
        meta = [{"name": "process_name", "ph": "M", "pid": self._pid,
                 "tid": 0, "args": {"name": "paddle_tpu_torch host"}}]
        for raw, small in tids.items():
            meta.append({"name": "thread_name", "ph": "M",
                         "pid": self._pid, "tid": small,
                         "args": {"name": raw if isinstance(raw, str)
                                  else f"thread {raw}"}})
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "otherData": {"start_epoch_s": self._epoch0,
                              "dropped_events": dropped,
                              "max_events": self._max_events}}

    def save(self, path, pretty=False):
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=2 if pretty else None,
                      separators=None if pretty else (",", ":"))


_GLOBAL = TraceRecorder()


def get_recorder():
    return _GLOBAL
