"""Fleet-wide distributed tracing: one trace id per request across
routing, handoff, failover, and resurrection.

Counterpart of ``paddle_tpu/observability/fleet_trace.py``, kept as the
port's own copy (host-side bookkeeping only; the schemas are the JAX
package's, so a dump of either fleet reads the same). Each replica's
span trees and flight recorder stop at the replica boundary: a request
that is routed, shed, handed off, failed over, or quarantined has its
story scattered across N replicas' telemetry with no shared
correlation key. This module is the correlation layer the fleet router
(serving/router.py) threads through every hop:

- **TraceContext** — the router mints ONE deterministic trace id per
  request at submit (blake2b of router name + router rid: no clocks,
  no RNG — injected-clock-safe and replay-stable) plus a hop counter
  that increments on every replica submission (first routing,
  disaggregated prefill→decode handoff, each failover re-admission).
  The context rides the router's ``_Routed`` record and is passed to
  ``GenerationServer.submit(trace_ctx=...)``, so every replica's
  ServingTelemetry span tree carries ``trace_id``/``hop`` in its args.
  The SAMPLING decision travels IN the context: the router evaluates
  ``PADDLE_TPU_TRACE_REQUESTS`` once per request, and every hop obeys
  that one verdict — engines never re-hash their replica-local rid
  (which changes on failover and would desync hops).

- **FleetTracer** — one TraceRecorder per replica slot (so the merged
  Perfetto view renders per-replica PROCESS groups) plus a dedicated
  fleet recorder for router-level events: route decisions (policy,
  affinity depth, candidate loads), SLO sheds (burn rate,
  retry-after), KV handoffs (chunks/blocks/bytes moved), failover
  re-admissions (cause, source→target), and supervisor lifecycle
  events (kill, hang, resurrection, crash loop, quarantine) as
  instants on the ``fleet router`` track. All recorders share one
  perf_counter origin, so cross-replica stamps are directly
  comparable — a failed-over request's hop-1 spans land strictly
  after its hop-0 spans in the merged timeline.

- **Death snapshots** — when a replica dies (kill, hang teardown,
  engine fault) its capture is snapshotted before the slot is
  resurrected with a fresh recorder, so the victim's half of a
  failover survives into the postmortem dump. Snapshots are a bounded
  ring; dropping one marks the merged dump truncated.

- **Completed-trace ring** — a bounded drop-oldest ring of per-request
  summaries (trace id, hops, lineage, outcome) served by the
  ``/trace`` exporter endpoint and consumed by
  ``tools/request_trace.py`` to reconstruct one rid's end-to-end
  timeline.

``FleetRouter.dump_trace()`` merges everything into ONE Perfetto JSON
(``merge()`` here): each source becomes its own pid with a
``process_name`` metadata row, and ``otherData`` carries per-source
dropped-event counts plus a ``truncated`` flag so a partial capture is
never mistaken for a complete one. Metrics:
``serving.fleet.trace.{requests,completed,dumps}``.
"""

import collections
import hashlib
import json
import threading
import time

from .tracing import TraceRecorder

__all__ = ["TraceContext", "FleetTracer", "mint_trace_id",
           "empty_trace_ring"]


def empty_trace_ring():
    """The ``paddle_tpu.trace_ring/1`` payload with no trace plane
    behind it — the /trace body a component WITHOUT a fleet tracer
    serves (exporter.py). One definition for the schema's empty shape:
    ``FleetTracer.completed_payload()`` builds on it, so a field added
    there automatically appears here and the two producers of the
    declared schema can never diverge."""
    return {"schema": "paddle_tpu.trace_ring/1", "router": None,
            "capacity": 0, "recorded": 0, "truncated": False,
            "traces": []}


def mint_trace_id(router_ident, rid):
    """Deterministic 16-hex-char trace id for one router request.

    blake2b over "<router identity>:<router rid>" — no wall clock, no
    RNG (the injected-clock serving tier must mint the same id on
    every replay). `router_ident` must be process-unique: auto-named
    routers pass their name (fleet<N>); explicitly-named routers pass
    a per-instance disambiguated form (router._trace_ident), because
    two routers sharing one explicit name would otherwise mint
    identical ids for unrelated requests."""
    return hashlib.blake2b(f"{router_ident}:{int(rid)}".encode(),
                           digest_size=8).hexdigest()


class TraceContext:
    """One request's fleet trace coordinates: the router-minted trace
    id, the hop this submission is (0 = first routing; +1 per
    handoff/failover re-admission), and the router's ONE sampling
    verdict — a replica given a context must not re-decide sampling
    from its replica-local rid (which changes on failover and would
    trace some hops of a request but not others)."""

    __slots__ = ("trace_id", "hop", "sampled")

    def __init__(self, trace_id, hop=0, sampled=True):
        self.trace_id = trace_id
        self.hop = int(hop)
        self.sampled = bool(sampled)

    def at(self, hop):
        """The same trace at a later hop (contexts are immutable —
        every replica submission gets its own)."""
        return TraceContext(self.trace_id, hop, self.sampled)

    def args(self):
        """The correlation args every span/instant of this trace
        carries."""
        return {"trace_id": self.trace_id, "hop": self.hop}

    def __repr__(self):
        return (f"TraceContext({self.trace_id}, hop={self.hop}, "
                f"sampled={self.sampled})")


class FleetTracer:
    """The router's trace plane: a fleet recorder (router-level track)
    plus one TraceRecorder per replica slot, all sharing one
    perf_counter origin; death snapshots; the completed-trace ring.

    start()/stop() gate capture exactly like the global recorder —
    everything except the completed ring is a no-op while stopped, so
    a tracing-off fleet pays only the per-submit context mint."""

    #: bounded postmortem snapshots of dead replicas' captures
    MAX_SNAPSHOTS = 16

    def __init__(self, name, max_events=None, completed_capacity=256):
        self.name = name
        self._max_events = max_events
        self.fleet = TraceRecorder(max_events=max_events)
        self._live = {}             # replica name -> (generation, rec)
        self._dead = collections.deque(maxlen=self.MAX_SNAPSHOTS)
        self._snapshots_dropped = 0
        self._completed = collections.deque(maxlen=completed_capacity)
        self._completed_total = 0
        self._lock = threading.Lock()
        self._origin = None
        self._epoch0 = None

    # -- lifecycle ----------------------------------------------------------
    @property
    def enabled(self):
        return self.fleet.enabled

    def start(self):
        """Begin a fleet-wide capture: every recorder (fleet + all live
        replicas) starts against ONE shared perf_counter origin, so
        stamps merge into a single comparable timeline."""
        with self._lock:
            self._origin = time.perf_counter()
            self._epoch0 = time.time()
            self.fleet.start(origin=self._origin)
            for _gen, rec in self._live.values():
                rec.start(origin=self._origin)
            self._dead.clear()
            self._snapshots_dropped = 0

    def stop(self):
        with self._lock:
            self.fleet.stop()
            for _gen, rec in self._live.values():
                rec.stop()

    # -- replica recorders --------------------------------------------------
    def recorder_for(self, name, generation=0):
        """The (fresh) recorder for replica slot `name` at
        `generation`. A resurrection re-registers the slot name with a
        new recorder — the old capture must already be snapshotted
        (snapshot_replica) or it is snapshotted here."""
        with self._lock:
            old = self._live.get(name)
            if old is not None and old[0] == generation:
                return old[1]
            if old is not None:
                self._snapshot_locked(name)
            rec = TraceRecorder(max_events=self._max_events)
            if self.fleet.enabled:
                rec.start(origin=self._origin)
            self._live[name] = (int(generation), rec)
            return rec

    def snapshot_replica(self, name):
        """Freeze a dying replica's capture into the postmortem ring
        (idempotent per registration): the victim's half of a failover
        must survive the slot's resurrection, which swaps in a fresh
        recorder under the same name."""
        with self._lock:
            self._snapshot_locked(name)

    def _snapshot_locked(self, name):
        entry = self._live.pop(name, None)
        if entry is None:
            return
        gen, rec = entry
        if len(self._dead) == self._dead.maxlen:
            self._snapshots_dropped += 1
        rec.stop()
        self._dead.append((f"replica {name} gen{gen} (dead)",
                           rec.to_chrome()))

    # -- completed-trace ring -----------------------------------------------
    def note_completed(self, record):
        """Append one finished request's trace summary (served by the
        /trace endpoint; host bookkeeping, live even while the span
        capture is stopped)."""
        with self._lock:
            self._completed.append(record)
            self._completed_total += 1

    def completed_payload(self):
        """The /trace endpoint body: newest-last bounded ring (the
        empty_trace_ring shape, filled in)."""
        with self._lock:
            return dict(empty_trace_ring(),
                        router=self.name,
                        capacity=self._completed.maxlen,
                        recorded=self._completed_total,
                        truncated=self._completed_total
                        > len(self._completed),
                        traces=list(self._completed))

    # -- merge --------------------------------------------------------------
    def merge(self):
        """ONE Perfetto JSON over every capture: the fleet track, each
        dead replica's snapshot, and each live replica's recorder —
        one pid per source with a process_name metadata row, so
        Perfetto renders per-replica process groups. otherData carries
        per-source dropped counts and a `truncated` flag (any ring
        drop anywhere means the dump is partial)."""
        with self._lock:
            sources = [(f"fleet router {self.name}",
                        self.fleet.to_chrome())]
            sources.extend(self._dead)
            for name in sorted(self._live):
                gen, rec = self._live[name]
                label = (f"replica {name}" if gen == 0
                         else f"replica {name} gen{gen}")
                sources.append((label, rec.to_chrome()))
            snapshots_dropped = self._snapshots_dropped
            epoch0 = self._epoch0
        events, source_meta = [], []
        for pid, (label, chrome) in enumerate(sources):
            dropped = chrome.get("otherData", {}).get(
                "dropped_events", 0)
            n = 0
            for e in chrome.get("traceEvents", ()):
                e = dict(e)
                e["pid"] = pid
                if e.get("ph") == "M" and e.get("name") == \
                        "process_name":
                    e["args"] = {"name": label}
                else:
                    n += 1 if e.get("ph") != "M" else 0
                events.append(e)
            source_meta.append({"name": label, "pid": pid,
                                "events": n,
                                "dropped_events": dropped})
        truncated = snapshots_dropped > 0 or any(
            s["dropped_events"] for s in source_meta)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {
                    "schema": "paddle_tpu.fleet_trace/1",
                    "router": self.name,
                    "start_epoch_s": epoch0,
                    "sources": source_meta,
                    "snapshots_dropped": snapshots_dropped,
                    "truncated": truncated,
                }}

    def save(self, path, payload=None):
        payload = payload if payload is not None else self.merge()
        with open(path, "w") as f:
            json.dump(payload, f, separators=(",", ":"))
            f.write("\n")
        return path

    def stats(self):
        with self._lock:
            return {"enabled": self.fleet.enabled,
                    "replica_recorders": len(self._live),
                    "dead_snapshots": len(self._dead),
                    "snapshots_dropped": self._snapshots_dropped,
                    "completed": len(self._completed),
                    "completed_total": self._completed_total,
                    "completed_capacity": self._completed.maxlen}
