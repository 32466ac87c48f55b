"""Replica: one GenerationServer behind the fleet router's lifecycle
contract.

Counterpart of ``paddle_tpu/serving/replica.py``, kept as the port's own
copy. A fleet (serving/router.py) is N GenerationServers (in-process,
or worker processes behind serving/remote.py's proxy): data parallelism
ACROSS replicas. The wrapper owns everything the router needs that the
engine should not grow itself:

- **health** — the engine's /healthz payload read in-process
  (``GenerationServer.health()``), folded with the router-side state
  machine: ``ok -> draining -> drained`` (graceful) or ``-> dead``
  (kill/fault). A replica whose engine latched a fault reads ``dead``
  even before the router noticed.
- **load** — (queue_depth, active_slots, free_blocks) in one scheduler
  lock hold, the power-of-two-choices comparison key.
- **affinity** — how many leading prompt chunks this replica's prefix
  index already holds (``PrefixCacheIndex.match``, the PURE probe: a
  routing probe must not move hit/miss counters or LRU recency).
- **shedding** — ``burn_rate(targets)``: the worst SRE burn rate over
  the engine's cumulative SLO digests (``check_slo``); the router
  sheds on THIS, never on queue depth.
- **pump / kill / drain** — manual-drive step for the deterministic
  tier (an engine NonFiniteError marks the replica dead instead of
  propagating — the router fails over, it does not die), close(drain
  =False) on kill so in-flight futures fail fast and the replica's
  HBM-ledger rows / gauge series retire immediately.
"""

from .scheduler import RequestCancelled

__all__ = ["Replica"]


class Replica:
    """One fleet member. States: ok (routing), draining (no new
    routes, in-flight finishing), drained (empty + closed), dead
    (killed or engine-faulted; in-flight failed over), evicted
    (crash-loop circuit breaker gave up — never respawned again)."""

    def __init__(self, index, server, name=None):
        self.index = int(index)
        self.server = server
        self.name = name or f"r{index}"
        self.state = "ok"
        self.role = "mixed"         # "mixed" | "prefill" | "decode"
        self.condition = "ok"       # "ok" | "slow" (watchdog verdict)
        self.generation = 0         # resurrection count for this slot
        self.step_ms_ema = None     # router-measured pump time (EMA)
        # the transport seam: "inproc" wraps an in-process engine,
        # "subprocess" a WorkerProxy speaking the socket RPC to a
        # worker process (serving/remote.py). The wrapper itself is
        # backend-blind — every probe below reads the same surface —
        # but the router branches on it for the KV handoff (pool-slice
        # copy vs serialized wire transfer) and stamps it into /trace
        # hop records.
        self.backend = ("subprocess" if getattr(server, "remote",
                                                False) else "inproc")

    @property
    def pid(self):
        """The process serving this replica: the worker's pid for the
        subprocess backend, our own for inproc (trace hop records)."""
        import os
        return (self.server.pid if self.backend == "subprocess"
                else os.getpid())

    # -- health ------------------------------------------------------------
    def health(self):
        """The engine /healthz payload + the router-side state. An
        engine fault or an unexpected close dominates: the wrapper may
        learn of a death FROM this probe."""
        h = self.server.health()
        if self.state in ("dead", "drained", "evicted"):
            h["status"] = self.state
        elif h["status"] in ("fault", "closed"):
            h["status"] = "dead"
        elif self.state == "draining":
            h["status"] = "draining"
        h["replica"] = self.name
        h["role"] = self.role
        h["condition"] = self.condition
        h["generation"] = self.generation
        return h

    def alive(self):
        """Engine still serviceable (ok or draining)."""
        return (self.state in ("ok", "draining")
                and self.server._fault is None
                and not self.server._closed)

    def accepting(self):
        """May receive NEW routed requests."""
        return self.state == "ok" and self.alive()

    # -- routing signals ---------------------------------------------------
    def load(self):
        """(queue_depth, active_slots, free_blocks) — one lock hold."""
        return self.server._sched.load_snapshot()

    def affinity_depth(self, prompt, keys):
        """Leading prompt chunks whose KV this replica's prefix cache
        already holds (0 without a prefix cache). Pure — see
        PrefixCacheIndex.match; taken under the scheduler lock because
        the engine thread mutates the index under it."""
        idx = self.server._prefix
        if idx is None or not keys:
            return 0
        with self.server._sched._lock:
            return len(idx.match(prompt, keys))

    def progress_mark(self):
        """The watchdog's heartbeat sample: a tuple that MUST advance
        whenever the engine does real work (scheduler iteration count +
        token/admission/retirement counters). A replica whose mark is
        frozen across N heartbeats while has_work() stays True is hung
        — stuck inside (or never entering) an engine iteration — which
        neither health() nor failover can see: the engine is not dead,
        its futures never resolve, nothing raises. Pure counter reads,
        no clocks — the supervisor's hang verdict is deterministic
        under the injected serving clock."""
        st = self.server._sched
        c = st.counts
        return (st.iteration, c["generated_tokens"],
                c["prefill_tokens"], c["admitted"], c["retired"],
                c["cancelled"], c["deadline_cancels"])

    def note_step_ms(self, ms):
        """Record one pump's duration (router-measured; chaos may
        inflate it). EMA so one slow iteration does not flip the
        slow verdict."""
        self.step_ms_ema = (float(ms) if self.step_ms_ema is None
                            else 0.5 * self.step_ms_ema + 0.5 * float(ms))

    def burn_rate(self, targets):
        """Worst burn rate over `targets` (check_slo semantics), or
        None with no observations yet — a cold replica must read
        healthy, not infinitely breached."""
        if self.server.telemetry is None:
            return None
        worst = None
        for c in self.server.check_slo(targets)["checks"]:
            b = c["burn_rate"]
            if b is not None and (worst is None or b > worst):
                worst = b
        return worst

    # -- lifecycle ---------------------------------------------------------
    def pump(self):
        """One engine iteration in manual-drive mode. An engine fault
        (NonFiniteError — e.g. a chaos KV poison) marks this replica
        dead instead of propagating: a fleet outlives one replica, and
        the router re-admits the in-flight requests the fault failed."""
        from ..robustness.guard import NonFiniteError
        try:
            return self.server.step()
        except NonFiniteError:
            self.state = "dead"
            return False

    def has_work(self):
        return self.alive() and self.server._sched.has_work()

    def kill(self):
        """Replica death (chaos kill_replica_at, or operator action):
        fail every in-flight/queued request NOW (their futures raise
        RequestCancelled — the router's failover hook re-admits them
        elsewhere) and tear the engine down. close() retires the
        replica's HBM-ledger rows, SLO gauge series, and prefix gauge —
        a dead replica must not keep reporting live pool bytes."""
        if self.state in ("dead", "drained", "evicted"):
            return
        self.state = "dead"
        self.server.close(drain=False)

    def drain(self):
        """Graceful: stop accepting routed requests; in-flight and
        queued requests keep running to completion. The router's step()
        closes the engine once the replica is empty (state 'drained')."""
        if self.state == "ok":
            self.state = "draining"

    def notify_preempt(self):
        """Fleet preempt drain reaching this replica: a no-op for the
        in-process backend (the router's own drain covers it); the
        subprocess backend forwards it so the WORKER finishes its
        in-flight work, closes, and exits cleanly — SIGTERM semantics
        across the process boundary."""
        fwd = getattr(self.server, "notify_preempt", None)
        if fwd is not None and self.alive():
            fwd()

    def finish_drain_if_idle(self):
        """draining + empty -> close + 'drained'. Returns True when the
        transition happened."""
        if self.state != "draining" or self.server._sched.has_work():
            return False
        self.server.close(drain=False)
        self.state = "drained"
        return True

    def close(self):
        if self.state in ("dead", "drained", "evicted"):
            # engine close already ran; it is idempotent about gauges
            self.server.close()
            return
        self.state = "drained"
        self.server.close()

    def __repr__(self):
        return (f"Replica({self.name}, state={self.state!r}, "
                f"role={self.role!r})")
