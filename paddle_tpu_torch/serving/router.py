"""FleetRouter: the fleet front door over a pool of GenerationServer
replicas.

Counterpart of ``paddle_tpu/serving/router.py``, kept as the port's own
copy. A fleet serving many users is N replicas behind a router: data
parallelism across server replicas (in-process engines, or worker
processes behind serving/remote.py), each replica running the paged
attention kernel in its own fused steps. Everything the router needs
already existed as loose parts; this module is the composition:

- **Prefix-affinity routing** — the prompt's chunk chain keys
  (``prefix_cache.prompt_chain_keys`` — the SAME blake2b chain as the
  per-replica index, no second hasher) are probed against each
  replica's ``PrefixCacheIndex.match`` (pure: a routing probe moves no
  counters, no LRU recency). The request lands on the replica already
  holding the deepest prefix; with no match anywhere it falls back to
  power-of-two-choices on live (queue_depth, active_slots) load
  snapshots — hot tenants land warm without starving cold ones on one
  hoarding replica.
- **SLO-driven admission** — shedding keys off the engines' ``check_slo`` burn
  rates (error-budget spend), NEVER raw queue depth: a deep queue the
  fleet is digesting within budget admits; a shallow queue behind a
  latency cliff sheds. Rejections are a structured
  ``AdmissionRejected`` carrying a retry-after hint — backpressure a
  client can act on, instead of silent queueing collapse.
- **Replica lifecycle** — health checks reuse the engine's /healthz
  payload in-process; ``drain_replica`` stops routing and closes the
  engine once empty; a replica that dies mid-stream (chaos
  ``kill_replica_at``, or an engine NonFiniteError) has its in-flight
  requests re-admitted on survivors. Re-prefill is correct by
  construction — prefill is deterministic, so the replayed stream is
  bitwise the dead replica's — and the client stream callback is
  deduplicated so no token is delivered twice.
- **Disaggregated prefill/decode** — ``RouterPolicy(kind=
  "disaggregated", prefill=..., decode=...)`` dedicates replicas to
  chunked prefill vs decode. The KV handoff is a block-table +
  pool-slice transfer between sibling caches: the prefill replica's
  prefix index IS the handoff manifest (full prompt chunks it
  registered), each chunk's pool block is copied across caches with
  ``PagedKVCache.adopt_block_from`` (one indexed copy per layer and
  pool entry, cow_copy pointed across replicas; over the wire for a
  worker process, ``serialize_block``) and registered into the decode replica's index — so
  the decode admission matches the chain and skips prefill for every
  transferred chunk. Only the tail partial chunk re-prefills.

The fleet is SELF-HEALING (robustness/supervisor.py):

- **Supervision** — ``supervisor=True`` (or a SupervisorConfig) runs a
  FleetSupervisor heartbeat every router iteration: a hung replica
  (progress marks frozen with work pending — chaos
  ``hang_replica_at``) is detected and torn down by the WATCHDOG, not
  failover; dead replicas are respawned through ``spawn_fn(index)``
  under a crash-loop circuit breaker, probed half-open, and re-warmed
  from the router's fleet-wide chunk-popularity digest before
  rejoining.
- **Poison quarantine** — every failover records the death in the
  request's lineage; an engine fault IMPLICATES the requests its
  NonFiniteError names (``bad_rids``), and a request implicated in
  ``poison_threshold`` (default 2) deaths is failed with a structured
  ``PoisonRequestError`` (recorded + dumped in the fleet flight
  recorder) instead of cascading onto the next survivor. Every
  re-admission already propagates only the REMAINING deadline; a
  per-request ``retry_budget`` (submit kwarg) additionally caps the
  failover allowance below the router-wide ``max_failovers``.
- **Preemption** — ``preemption=PreemptionHandler(...)`` (or True)
  polls the handler's flag each step: SIGTERM triggers a fleet-wide
  graceful drain (close(drain=True) semantics — in-flight requests
  and pending failovers finish, then every replica closes), the
  serving twin of GuardedTrainer's drain-and-save.

**Fleet-wide distributed tracing** (observability/fleet_trace.py):
every submit mints ONE deterministic trace context (trace
id + hop counter + the sampling verdict, decided here once so a
request traces on all hops or none), each replica's span trees carry
``trace_id``/``hop``, router-level events (route decision, shed,
handoff, failover, supervisor lifecycle) land on a dedicated fleet
track, ``dump_trace()`` merges everything into one Perfetto JSON with
per-replica process groups (a dying replica's capture is snapshotted
at teardown so the victim's half of a failover survives), and the
``/trace`` exporter endpoint serves a bounded ring of completed
request traces.

Threading mirrors the engine: ``start=True`` runs a router worker that
pumps replica engines; ``start=False`` is the deterministic
manual-drive mode (``step()``/``run_until_idle()``, injectable clocks,
no sleeps) the fleet test tier uses. Metrics:
``serving.fleet.{routed,sheds,failovers,handoffs,handoff_blocks,
replicas,replica_load,hangs,resurrections,crash_loops,quarantines}``
plus ``serving.fleet.trace.{requests,completed,dumps}``.
"""

import collections
import itertools
import threading
import time
from concurrent.futures import Future, InvalidStateError

import numpy as np

from ..observability import _help
from ..observability.alerts import AlertManager, empty_alerts
from ..observability.fleet_trace import TraceContext, mint_trace_id
from ..observability.metrics import global_registry
from ..observability.serving_telemetry import (TenantLedger, _parse_qtag,
                                               _rid_hash01,
                                               aggregate_tenant_snapshots)
from ..observability.timeseries import FleetSeriesStore
from .decode_strategies import GroupResult
from .prefix_cache import prompt_chain_keys
from .replica import Replica
from .scheduler import (DeadlineExceeded, GenerationResult,
                        RequestCancelled)

__all__ = ["FleetRouter", "RouterPolicy", "AdmissionPolicy",
           "AdmissionRejected", "FleetFuture"]

_ROUTER_SEQ = itertools.count()


class AdmissionRejected(RuntimeError):
    """The fleet shed this request instead of queueing it into an SLO
    breach. `retry_after_ms` is the router's backoff hint (scaled by
    live fleet load); `scope` names what breached ("fleet" burn rate,
    or "capacity" when no live replica could take the request);
    `burn_rate` carries the worst observed burn when SLO-driven."""

    def __init__(self, message, retry_after_ms, scope="fleet",
                 burn_rate=None):
        super().__init__(message)
        self.retry_after_ms = float(retry_after_ms)
        self.scope = scope
        self.burn_rate = burn_rate


class AdmissionPolicy:
    """SLO-driven admission config.

    `targets` is check_slo's shape ({"ttft_ms": {"p99": 250.0}, ...}):
    a replica whose worst burn rate over these exceeds
    `burn_threshold` is excluded from routing; when EVERY live replica
    is excluded the submit sheds fleet-wide. `fleet_targets`
    (optional) additionally checks the MERGED fleet digests — a
    fleet-level SLO no single replica owns. Burn 1.0 means spending
    exactly the error budget; the default threshold sheds only when
    the budget is actively burning down."""

    def __init__(self, targets, burn_threshold=1.0, fleet_targets=None,
                 retry_after_ms=100.0):
        if not targets:
            raise ValueError("AdmissionPolicy needs non-empty targets")
        self.targets = dict(targets)
        self.burn_threshold = float(burn_threshold)
        self.fleet_targets = dict(fleet_targets) if fleet_targets \
            else None
        self.retry_after_ms = float(retry_after_ms)


class RouterPolicy:
    """How the fleet divides work. kind="affinity" (default): every
    replica serves prefill+decode, requests routed by prefix affinity
    then least-load. kind="disaggregated": `prefill` / `decode` name
    disjoint replica indices; prompts with at least one full chunk
    prefill on the prefill pool, hand their KV off, and decode on the
    decode pool (shorter prompts route straight to decode — there is
    no full-chunk KV to move)."""

    def __init__(self, kind="affinity", prefill=(), decode=()):
        if kind not in ("affinity", "disaggregated"):
            raise ValueError(
                f"RouterPolicy kind {kind!r}: expected 'affinity' or "
                f"'disaggregated'")
        self.kind = kind
        self.prefill = tuple(prefill)
        self.decode = tuple(decode)
        if kind == "disaggregated":
            if not self.prefill or not self.decode:
                raise ValueError(
                    "disaggregated policy needs at least one prefill "
                    "and one decode replica index")
            if set(self.prefill) & set(self.decode):
                raise ValueError(
                    f"prefill and decode pools must be disjoint; both "
                    f"contain {sorted(set(self.prefill) & set(self.decode))}")


class FleetFuture(Future):
    """The router-side request future. cancel() propagates to the
    replica currently serving the request (reclaiming its slot and
    blocks) and wins any race with a failover re-admission."""

    def __init__(self, router, request_id):
        super().__init__()
        self._router = router
        self.request_id = request_id

    def cancel(self):
        if self.done():
            return False
        self._router._client_cancel(self.request_id)
        if not super().cancel():
            return False
        self.set_running_or_notify_cancel()
        return True


class _Routed:
    """Router-side record of one request: everything needed to re-admit
    it verbatim on another replica."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "eos_id", "priority",
                 "deadline_ms", "stream", "future", "keys", "replica",
                 "rep_fut", "phase", "emitted", "seen", "attempts",
                 "client_cancelled", "first_submit_mono", "lineage",
                 "implicated", "retry_budget", "ctx", "hops",
                 "submit_perf", "trace_done", "tenant", "group_k",
                 "sampling", "beam", "guided", "lane_base", "lane_seen",
                 "lane_emitted")

    def __init__(self, rid, prompt, max_new_tokens, eos_id, priority,
                 deadline_ms, stream, future, keys):
        self.rid = rid
        self.prompt = prompt            # np.int32 (P,)
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.priority = priority
        self.deadline_ms = deadline_ms
        self.first_submit_mono = None   # router wall clock at first
        #                                 routing (deadline accounting
        #                                 across failovers)
        self.stream = stream
        self.future = future
        self.keys = keys                # prompt chunk chain keys
        self.replica = None             # Replica currently serving
        self.rep_fut = None             # that replica's GenerationFuture
        self.phase = "decode"           # "prefill" | "decode"
        self.emitted = 0    # tokens DELIVERED to the client stream
        self.seen = 0       # tokens seen from the current attempt
        self.attempts = 0   # failover re-admissions so far
        self.client_cancelled = False
        self.lineage = []   # replica deaths this request was in-flight
        #                     on: {"replica", "kind", "implicated"}
        self.implicated = 0     # deaths whose fault NAMED this request
        self.retry_budget = None    # per-request failover cap (None ->
        #                             the router-wide max_failovers)
        self.ctx = None     # fleet TraceContext (one trace id, one
        #                     sampling verdict — every hop rides it)
        self.hops = []      # [{"hop", "replica", "phase", "policy"}]
        self.submit_perf = None     # perf stamp of the client submit
        #                             (the fleet-track request span)
        self.trace_done = False     # /trace summary recorded (once)
        self.tenant = None          # cost-attribution identity: every
        #                             hop (prefill, decode, failover
        #                             replay) bills the same tenant
        self.group_k = 1    # fork-group width (1 = plain request)
        self.sampling = None        # SamplingParams for forked lanes
        self.beam = None            # BeamParams (paged beam search)
        self.guided = None          # Constraint (guided decoding)
        self.lane_base = None   # current attempt's lane_rids[0]: the
        #                         replica allocates K consecutive lane
        #                         rids, so rank = lane_rid - base
        self.lane_seen = None       # per-rank tokens from this attempt
        self.lane_emitted = None    # per-rank tokens DELIVERED


class FleetRouter:
    """N in-process GenerationServers behind one submit() front door.

        servers = [GenerationServer(model_fn(), prefix_cache=True,
                                    start=False) for _ in range(3)]
        router = FleetRouter(servers, admission=AdmissionPolicy(
            {"ttft_ms": {"p99": 250.0}}), start=False)
        fut = router.submit(prompt, max_new_tokens=16)
        router.run_until_idle()
        fut.result()

    Replicas must share block_size (affinity keys chunk by it) and be
    handed over un-started (`start=False`) when the router itself runs
    manual-drive; with `start=True` on both, replica workers pump
    themselves and the router worker handles health/failover/handoff.
    """

    def __init__(self, servers, *, policy=None, admission=None,
                 chaos=None, start=True, p2c_seed=0, name=None,
                 max_failovers=None, spawn_fn=None, supervisor=None,
                 preemption=None, poison_threshold=2, flight_dir=None,
                 trace=False, trace_sample=None, signals=True,
                 alert_rules=None, signals_every=8, autoscale=None):
        if not servers:
            raise ValueError("FleetRouter needs at least one replica")
        self.name = name or f"fleet{next(_ROUTER_SEQ)}"
        # trace-mint identity: auto names are process-unique by
        # construction, but an EXPLICIT name may be reused across
        # routers (dashboards often pin one) — duplicate names must
        # not conflate two requests' lineages in /trace or merged
        # dumps, so explicitly-named routers mint under a
        # per-instance disambiguator
        self._trace_ident = (self.name if name is None
                             else f"{name}#{next(_ROUTER_SEQ)}")
        self.policy = policy or RouterPolicy()
        self.admission = admission
        self._chaos = chaos
        self._replicas = [s if isinstance(s, Replica) else Replica(i, s)
                          for i, s in enumerate(servers)]
        sizes = {r.server.block_size for r in self._replicas}
        if len(sizes) != 1:
            raise ValueError(
                f"replicas must share one block_size (affinity chain "
                f"keys chunk by it); got {sorted(sizes)}")
        self._block_size = sizes.pop()
        # ... and one quantization layout: the disaggregated KV handoff
        # is a raw pool-slice transfer, and adopt_block_from refuses a
        # quantized<->dense copy (int8 codes mean nothing without their
        # scales; dense<->dense float casts remain fine). Failing here
        # beats a mixed fleet that looks healthy until the first
        # shared-prefix handoff kills the router worker mid-request.
        quant = {getattr(r.server.cache, "quantized", False)
                 for r in self._replicas}
        if len(quant) != 1:
            raise ValueError(
                "replicas mix quantized (kv_dtype='int8') and dense KV "
                "pools — the disaggregated handoff transfers raw pool "
                "blocks and quantized<->dense is not transferable; "
                "build every tier with the same kv_dtype")
        if self.policy.kind == "disaggregated":
            n = len(self._replicas)
            for i in self.policy.prefill + self.policy.decode:
                if not 0 <= i < n:
                    raise ValueError(
                        f"policy names replica {i} but the fleet has "
                        f"{n} replicas")
            for i in self.policy.prefill:
                self._replicas[i].role = "prefill"
            for i in self.policy.decode:
                self._replicas[i].role = "decode"
            for r in self._replicas:
                if r.role in ("prefill", "decode") and \
                        r.server._prefix is None:
                    raise ValueError(
                        f"disaggregated serving needs prefix_cache=True "
                        f"on every pooled replica ({r.name} has none): "
                        f"the prefill replica's index is the handoff "
                        f"manifest and the decode replica's index is "
                        f"what admission matches against")
                if getattr(r.server, "mesh", None) is not None:
                    raise NotImplementedError(
                        "disaggregated handoff across mesh-sharded "
                        "replicas is not supported yet: the pool-slice "
                        "transfer is validated single-device only")
        if admission is not None:
            for r in self._replicas:
                if r.server.telemetry is None:
                    raise ValueError(
                        f"SLO-driven admission needs telemetry on every "
                        f"replica ({r.name} was built with "
                        f"telemetry=False)")
        self._rng = np.random.default_rng(p2c_seed)
        self._lock = threading.RLock()
        self._cv = threading.Condition()
        self._events = collections.deque()   # (kind, rr, payload)
        self._inflight = {}                  # rid -> _Routed
        self._next_rid = 0
        self._closed = False
        self._close_drain = False   # close(drain=True) in progress:
        #                             pending failovers still re-admit
        self._exporter = None
        self.iteration = 0
        self.max_failovers = (len(self._replicas) if max_failovers
                              is None else int(max_failovers))
        # poison quarantine: a request implicated in this many replica
        # deaths stops failing over and fails as PoisonRequestError —
        # the fleet-size-independent cap that keeps one bad request
        # from eating the whole fleet (max_failovers scales with N)
        self.poison_threshold = int(poison_threshold)
        self.spawn_fn = spawn_fn
        from ..robustness.supervisor import (ChunkPopularityDigest,
                                             FleetSupervisor,
                                             SupervisorConfig)
        # fleet-wide chunk popularity: fed on every submit, read by
        # resurrection re-warm — it survives any replica's death
        # because it lives here, not in a dead prefix index
        self._digest = ChunkPopularityDigest()
        if supervisor is True:
            supervisor = FleetSupervisor(self)
        elif isinstance(supervisor, SupervisorConfig):
            supervisor = FleetSupervisor(self, supervisor)
        self.supervisor = supervisor
        # SLO-driven autoscaling (robustness/supervisor.py Autoscaler):
        # spawn/retire replica slots from the live windowed burn-rate
        # series, with the crash-loop breaker as the safety rail.
        # Needs spawn_fn (how would it add capacity?) and the signals
        # plane (where would it read burn from?).
        from ..robustness.supervisor import Autoscaler, AutoscalerConfig
        if autoscale is True:
            autoscale = Autoscaler(self)
        elif isinstance(autoscale, AutoscalerConfig):
            autoscale = Autoscaler(self, autoscale)
        self.autoscaler = autoscale
        if autoscale is not None:
            if spawn_fn is None:
                raise ValueError(
                    "autoscale= needs spawn_fn= — scaling up means "
                    "spawning a replica")
            if not signals:
                raise ValueError(
                    "autoscale= needs signals=True — the autoscaler "
                    "reads the slo.window_burn.* series")
        self._preempt_owned = preemption is True
        if preemption is True:
            from ..robustness.preemption import PreemptionHandler
            preemption = PreemptionHandler().install()
        self._preempt = preemption
        self._preempted = False
        self._teardown_done = False
        self._chaos_hung = set()    # replica indices chaos is stalling
        # fleet flight recorder: kills/hangs/resurrections/quarantines
        # as a bounded postmortem ring, dumped on a quarantine
        from ..observability.serving_telemetry import FlightRecorder
        self._flight = FlightRecorder(capacity=64, out_dir=flight_dir)
        # fleet-wide distributed tracing (observability/fleet_trace.py):
        # the router mints ONE trace context per request (trace id +
        # hop counter + the sampling verdict, evaluated HERE once from
        # PADDLE_TPU_TRACE_REQUESTS / trace_sample so every hop of a
        # request traces or none does), gives every replica slot its
        # own TraceRecorder (per-replica process groups in the merged
        # Perfetto dump), and records router-level events on a
        # dedicated fleet track. dump_trace() merges it all.
        from ..observability.fleet_trace import FleetTracer
        from ..observability.serving_telemetry import trace_request_mode
        self._trace_mode = trace_request_mode(trace_sample)
        self._tracer = FleetTracer(self.name)
        # replica recorders bind LAZILY at start_trace(): an untraced
        # fleet keeps its replicas' span trees on the process-wide
        # recorder, so the pre-existing global-capture workflow
        # (profiler.start_profiler / get_recorder().start()) still
        # sees fleet serving spans until fleet tracing is opted into
        self._trace_bound = False
        self.counts = {"routed": 0, "sheds": 0, "failovers": 0,
                       "handoffs": 0, "handoff_blocks": 0,
                       "replica_kills": 0, "hangs": 0,
                       "resurrections": 0, "crash_loops": 0,
                       "quarantines": 0, "preempt_drains": 0}
        reg = global_registry()
        self._m_routed = reg.counter("serving.fleet.routed",
                                     _help("serving.fleet.routed"))
        self._m_sheds = reg.counter("serving.fleet.sheds",
                                    _help("serving.fleet.sheds"))
        self._m_failovers = reg.counter(
            "serving.fleet.failovers", _help("serving.fleet.failovers"))
        self._m_handoffs = reg.counter(
            "serving.fleet.handoffs", _help("serving.fleet.handoffs"))
        self._m_handoff_blocks = reg.counter(
            "serving.fleet.handoff_blocks",
            _help("serving.fleet.handoff_blocks"))
        self._g_replicas = reg.gauge("serving.fleet.replicas",
                                     _help("serving.fleet.replicas"))
        self._g_load = reg.gauge("serving.fleet.replica_load",
                                 _help("serving.fleet.replica_load"))
        self._m_fleet = {
            k: reg.counter(f"serving.fleet.{k}",
                           _help(f"serving.fleet.{k}"))
            for k in ("hangs", "resurrections", "crash_loops",
                      "quarantines")}
        self._m_trace = {
            k: reg.counter(f"serving.fleet.trace.{k}",
                           _help(f"serving.fleet.trace.{k}"))
            for k in ("requests", "completed", "dumps")}
        self._load_series = set()       # replica names with a live series
        # fleet health signals (observability/timeseries.py + alerts.py):
        # the router-side time-series store samples the shared registry
        # at every heartbeat, replica engine stores attach for the
        # merged /series view (dead generations freeze into bounded
        # snapshots, same idiom as the fleet tracer), and the alert
        # manager evaluates its rules against the router's own series
        # — including the per-heartbeat windowed fleet burn rate fed
        # by _sample_signals(). signals=False removes the whole plane.
        self._tenants = TenantLedger()      # router-side costs only:
        #                                     sheds/failovers/handoff
        #                                     bytes (engines own the
        #                                     token/block ledger)
        self._dead_tenant_snaps = collections.deque(maxlen=16)
        self._dead_snapped = set()          # (name, generation) seen
        self._signals_clock = (chaos.serving_clock
                               if chaos is not None
                               and chaos.drives_clock()
                               else time.monotonic)
        # registry-sampling decimation: the per-heartbeat registry
        # walk + burn-rate digest merge + alert evaluation cost real
        # microseconds, and at tiny step times paying them every
        # iteration is a double-digit tax. Keyed to the iteration counter, so
        # decimated timelines replay bit-identically under injected
        # clocks; deterministic storm tests pin signals_every=1.
        self._signals_every = max(1, int(signals_every))
        if signals:
            self._signals = FleetSeriesStore(self.name)
            for r in self._replicas:
                tel = r.server.telemetry
                if tel is not None and tel.series is not None:
                    self._signals.attach(r.name, tel.series,
                                         r.generation)
            self._alerts = AlertManager(self._signals.fleet,
                                        rules=alert_rules or (),
                                        label=self.name,
                                        on_event=self._on_alert_event)
        else:
            self._signals = None
            self._alerts = None
        self._publish_gauges()
        if trace:
            self.start_trace()
        self._worker = None
        if start:
            self._worker = threading.Thread(target=self._serve,
                                            daemon=True)
            self._worker.start()

    # -- client surface ----------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens=32, eos_id=None,
               priority=0, deadline_ms=None, stream=None,
               retry_budget=None, tenant=None, n=1, sampling=None,
               beam=None, guided=None):
        """Route one generation request into the fleet. Returns a
        FleetFuture resolving to a GenerationResult whose request_id is
        the ROUTER's id (replica-local ids are an implementation
        detail that changes on failover). Raises AdmissionRejected
        (with .retry_after_ms) when admission control sheds.
        `retry_budget` caps THIS request's failover re-admissions below
        the router-wide max_failovers (each re-admission also carries
        only the REMAINING deadline budget). `tenant` is an opaque
        cost-attribution identity threaded to every replica hop — it
        never affects scheduling or token ids.

        `n` / `sampling` / `beam` / `guided` mirror the engine's forked
        submit: a fork group
        routes AND fails over as a unit — one replica owns all K lanes
        (the lanes share prompt KV, which cannot span replicas), a
        failover replays the whole group on the survivor, and the
        future resolves to a GroupResult whose group_id is the router's
        rid. Group stream callbacks fire `stream(rid, rank, token)` —
        the extra lane-rank argument replaces replica-local lane ids,
        which change on failover; dedup on replay is per rank. `tenant`
        billing counts every lane's tokens (the replica stamps each
        lane with the same tenant). Groups route to decode replicas
        directly — a disaggregated prefill handoff would strand the
        fork boundary mid-transfer."""
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if beam is not None:
            if stream is not None:
                raise ValueError("beam search does not stream")
            if eos_id is None:
                raise ValueError("beam search requires eos_id")
            if sampling is not None or n != 1:
                raise ValueError("beam excludes sampling/n")
        group_k = (beam.beam_size if beam is not None
                   else max(int(n), sampling.n if sampling else 1))
        with self._lock:
            if self._closed:
                raise RuntimeError("FleetRouter is closed")
            rid = self._next_rid
            self._next_rid += 1
        keys = prompt_chain_keys(prompt, self._block_size) \
            if self._any_prefix() else []
        if keys:
            # fleet-wide popularity digest (resurrection re-warm reads
            # it): every routed prompt's full chunks count, wherever
            # they land
            self._digest.observe(keys, prompt, self._block_size)
        fut = FleetFuture(self, rid)
        rr = _Routed(rid, prompt, int(max_new_tokens), eos_id, priority,
                     deadline_ms, stream, fut, keys)
        rr.tenant = tenant
        rr.group_k = group_k
        rr.sampling = sampling
        rr.beam = beam
        rr.guided = guided
        if retry_budget is not None:
            rr.retry_budget = int(retry_budget)
        # ONE trace context per request, minted HERE: deterministic id
        # (no clocks), hop counter, and the single sampling verdict
        # every hop obeys — engines must never re-decide from their
        # replica-local rid, which changes on failover
        mode, rate = self._trace_mode
        sampled = (mode == "all" or
                   (mode == "sampled" and _rid_hash01(rid) < rate))
        rr.ctx = TraceContext(mint_trace_id(self._trace_ident, rid),
                              sampled=sampled)
        rr.submit_perf = time.perf_counter()
        if sampled:
            self._m_trace["requests"].inc()
        grouped = beam is not None or group_k > 1
        if self.policy.kind == "disaggregated" and keys and not grouped:
            pool, phase = self._pool("prefill"), "prefill"
        elif self.policy.kind == "disaggregated":
            pool, phase = self._pool("decode"), "decode"
        else:
            pool, phase = None, "decode"
        with self._lock:
            self._inflight[rid] = rr
        try:
            # pick + submit can race a concurrent replica kill (the
            # worker thread, chaos): a replica that closed between
            # accepting() and submit raises — re-pick among the rest
            # instead of surfacing the engine's RuntimeError
            for attempt in range(len(self._replicas)):
                target, label = self._pick(rr, shed=True, pool=pool)
                if self.policy.kind == "disaggregated":
                    label = phase
                try:
                    self._submit_to(rr, target, phase, label)
                    return fut
                except (RuntimeError, ValueError):
                    if attempt + 1 >= len(self._replicas):
                        raise
        except AdmissionRejected as e:
            with self._lock:
                self._inflight.pop(rid, None)
            self._tenants.count(rr.tenant, "sheds")
            # the shed lands on the fleet track with the facts a client
            # postmortem needs: what breached, how hard, the backoff —
            # sampled requests only (the verdict governs every artifact)
            if rr.ctx.sampled:
                self._tracer.fleet.instant(
                    "shed", cat="serving.fleet",
                    args=dict(rr.ctx.args(), rid=rid, scope=e.scope,
                              burn_rate=e.burn_rate,
                              retry_after_ms=e.retry_after_ms),
                    track="fleet router")
            # ... and closes its /trace ring summary like every other
            # terminal outcome (the ring is the only live trace plane
            # while the span capture is off)
            self._note_trace_done(rr, "shed", reason=e.scope,
                                  error=str(e)[:200])
            raise
        except BaseException as exc:
            with self._lock:
                self._inflight.pop(rid, None)
            # any submit-time failure is a terminal outcome: the ring
            # must not show a sampled request that simply vanished
            # (trace.requests incremented, no completed record)
            self._note_trace_done(rr, "failed",
                                  reason=type(exc).__name__,
                                  error=repr(exc)[:200])
            raise

    def _any_prefix(self):
        return any(r.server._prefix is not None for r in self._replicas)

    def _pool(self, role):
        return [r for r in self._replicas if r.role == role]

    def _client_cancel(self, rid):
        with self._lock:
            rr = self._inflight.get(rid)
        if rr is None:
            return
        rr.client_cancelled = True
        f = rr.rep_fut
        if f is not None:
            f.cancel()
        self._notify()

    def pending(self):
        with self._lock:
            return len(self._inflight)

    # -- routing -----------------------------------------------------------
    def _pick(self, rr, shed=True, pool=None):
        """Choose a replica for `rr`: deepest prefix affinity first,
        else power-of-two-choices on live load. `shed=True` applies
        SLO admission (first routing only — a failover re-admission is
        an already-admitted request and bypasses shedding). Raises
        AdmissionRejected when nothing can take the request."""
        cands = [r for r in (pool if pool is not None
                             else self._replicas) if r.accepting()]
        if not cands:
            if shed:
                self.counts["sheds"] += 1
                self._m_sheds.inc()
                self._m_sheds.labels(scope="capacity").inc()
            raise AdmissionRejected(
                "no live replica can accept the request",
                self._retry_after_ms(), scope="capacity")
        if shed and self.admission is not None:
            cands = self._apply_admission(cands)
        # affinity: deepest matched prefix wins; ties break on load
        if rr.keys:
            best, depth, bload = None, 0, None
            for r in cands:
                d = r.affinity_depth(rr.prompt, rr.keys)
                if d == 0:
                    continue
                ld = r.load()
                load = ld[0] + ld[1]
                if d > depth or (d == depth and load < bload):
                    best, depth, bload = r, d, load
            if best is not None:
                return best, "affinity"
        # power-of-two-choices on (queue_depth + active_slots)
        if len(cands) == 1:
            return cands[0], "least_loaded"
        i, j = self._rng.choice(len(cands), size=2, replace=False)
        a, b = cands[int(i)], cands[int(j)]
        la, lb = a.load(), b.load()
        pick = a if (la[0] + la[1], -la[2]) <= (lb[0] + lb[1], -lb[2]) \
            else b
        return pick, "least_loaded"

    def _apply_admission(self, cands):
        adm = self.admission
        if adm.fleet_targets is not None:
            worst = self._worst_burn(self.check_slo(adm.fleet_targets))
            if worst is not None and worst > adm.burn_threshold:
                self._shed("fleet", worst)
        healthy, worst_seen = [], None
        for r in cands:
            b = r.burn_rate(adm.targets)
            if b is not None and b > adm.burn_threshold:
                if worst_seen is None or b > worst_seen:
                    worst_seen = b
                continue
            healthy.append(r)
        if not healthy:
            self._shed("fleet", worst_seen)
        return healthy

    def _shed(self, scope, burn):
        self.counts["sheds"] += 1
        self._m_sheds.inc()
        self._m_sheds.labels(scope=scope).inc()
        raise AdmissionRejected(
            f"fleet admission shed: SLO burn rate "
            f"{burn if burn is not None else float('nan'):.3f} exceeds "
            f"threshold {self.admission.burn_threshold:.3f} "
            f"(retry after {self._retry_after_ms():.0f} ms)",
            self._retry_after_ms(), scope=scope, burn_rate=burn)

    def _retry_after_ms(self):
        """Deterministic backoff hint scaled by live fleet pressure:
        base x (1 + total queue depth / total slots)."""
        base = (self.admission.retry_after_ms
                if self.admission is not None else 100.0)
        q = s = 0
        for r in self._replicas:
            if r.alive():
                ld = r.load()
                q += ld[0]
                s += r.server._sched.num_slots
        return round(base * (1.0 + q / max(s, 1)), 3)

    @staticmethod
    def _worst_burn(report):
        worst = None
        for c in report["checks"]:
            b = c["burn_rate"]
            if b is not None and (worst is None or b > worst):
                worst = b
        return worst

    def _submit_to(self, rr, target, phase, label):
        rr.replica = target
        rr.phase = phase
        rr.seen = 0
        grouped = rr.beam is not None or rr.group_k > 1
        if grouped:
            # replay dedup is PER RANK: lane r of the re-admitted group
            # regenerates lane r's exact stream (per-lane RNG keys fold
            # (seed, rank, position) — replica-independent)
            rr.lane_seen = [0] * rr.group_k
        if rr.first_submit_mono is None:
            rr.first_submit_mono = time.monotonic()
        # a re-admission must not silently grant a fresh deadline
        # budget: the replica converts deadline_ms to an absolute
        # deadline at ITS submit time, so pass only what remains of the
        # client's original allowance (router wall clock; a request out
        # of budget fails as DeadlineExceeded instead of re-running).
        # Under the injected test clocks wall elapsed is ~0, so
        # deterministic tests see the full original value.
        deadline_ms = rr.deadline_ms
        if deadline_ms is not None:
            deadline_ms -= (time.monotonic()
                            - rr.first_submit_mono) * 1e3
            if deadline_ms <= 0:
                self._fail(rr, DeadlineExceeded(
                    f"request {rr.rid} deadline exhausted across "
                    f"{rr.attempts} failover(s)"))
                return
        srv = target.server
        # this submission is one HOP of the request's fleet trace: the
        # context the replica's telemetry stamps on its span tree, and
        # the router-side hop record /trace serves
        hop = len(rr.hops)
        ctx = rr.ctx.at(hop) if rr.ctx is not None else None
        if phase == "prefill":
            # the prefill replica is a KV producer: one forced token
            # completes the prompt's chunks (ignored — the decode
            # replica regenerates it deterministically from the
            # handed-off KV), nothing streams to the client from here
            fut = srv.submit(rr.prompt, max_new_tokens=1,
                             priority=rr.priority, trace_ctx=ctx,
                             tenant=rr.tenant)
        elif grouped or rr.sampling is not None or \
                rr.guided is not None:
            # the whole fork group lands on ONE replica: lanes alias
            # the leader's prompt blocks, and a block table cannot
            # reference another replica's pool
            fut = srv.submit(rr.prompt,
                             max_new_tokens=rr.max_new_tokens,
                             eos_id=rr.eos_id, priority=rr.priority,
                             deadline_ms=deadline_ms,
                             stream=(self._group_stream_cb(rr)
                                     if grouped else
                                     self._stream_cb(rr)),
                             trace_ctx=ctx, tenant=rr.tenant,
                             n=rr.group_k if rr.beam is None else 1,
                             sampling=rr.sampling, beam=rr.beam,
                             guided=rr.guided)
            if grouped:
                rr.lane_base = fut.lane_rids[0]
                if rr.lane_emitted is None:
                    rr.lane_emitted = [0] * rr.group_k
        else:
            fut = srv.submit(rr.prompt,
                             max_new_tokens=rr.max_new_tokens,
                             eos_id=rr.eos_id, priority=rr.priority,
                             deadline_ms=deadline_ms,
                             stream=self._stream_cb(rr),
                             trace_ctx=ctx, tenant=rr.tenant)
        # pid + transport make the hop record process-true: a /trace
        # lineage crossing a subprocess boundary names the worker pid
        # that served each hop
        rr.hops.append({"hop": hop, "replica": target.name,
                        "phase": phase, "policy": label,
                        "pid": target.pid,
                        "transport": target.backend})
        rr.rep_fut = fut
        self.counts["routed"] += 1
        self._m_routed.inc()
        self._m_routed.labels(policy=label).inc()
        if self._tracer.enabled and ctx is not None and ctx.sampled:
            # the route decision on the fleet track: why THIS replica
            # (policy + affinity depth) against what the alternatives
            # looked like (candidate loads) — computed only while a
            # capture is live AND only for sampled requests: the
            # sampling verdict governs EVERY artifact of a trace, and
            # unsampled traffic must not churn the bounded fleet ring
            # out from under the requests sampling chose to keep
            depth = (target.affinity_depth(rr.prompt, rr.keys)
                     if rr.keys else 0)
            loads = {r.name: list(r.load()) for r in self._replicas
                     if r.alive()}
            self._tracer.fleet.instant(
                "route", cat="serving.fleet",
                args=dict(ctx.args(), rid=rr.rid,
                          replica=target.name, phase=phase,
                          policy=label, affinity_depth=depth,
                          served_by_pid=target.pid,
                          transport=target.backend,
                          candidate_loads=loads),
                track="fleet router")
        fut.add_done_callback(lambda f, rr=rr: self._on_replica_done(
            rr, f))
        self._notify()

    def _stream_cb(self, rr):
        if rr.stream is None:
            return None

        def cb(_rid, tok):
            # failover dedupe: a re-admitted request REPLAYS its whole
            # stream (deterministic prefill+decode — same ids); tokens
            # the client already received are suppressed, continuation
            # tokens flow with the router's rid
            rr.seen += 1
            if rr.seen > rr.emitted:
                rr.emitted += 1
                rr.stream(rr.rid, tok)
        return cb

    def _group_stream_cb(self, rr):
        if rr.stream is None:
            return None

        def cb(lane_rid, tok):
            # the replica allocates K consecutive lane rids per group
            # submit, so the rank is recoverable from the current
            # attempt's base — the client sees STABLE (router rid,
            # rank) coordinates while replica-local lane ids churn
            # across failovers; dedup replays per rank
            base = rr.lane_base
            if base is None:
                return
            rank = int(lane_rid) - base
            if not 0 <= rank < rr.group_k:
                return
            rr.lane_seen[rank] += 1
            if rr.lane_seen[rank] > rr.lane_emitted[rank]:
                rr.lane_emitted[rank] += 1
                rr.stream(rr.rid, rank, tok)
        return cb

    # -- completion / failover ---------------------------------------------
    def _on_replica_done(self, rr, f):
        """Replica-future done callback (runs on whatever thread
        resolved it — only enqueues work or resolves the router
        future; handoffs and re-admissions run in step())."""
        if f.cancelled() or rr.client_cancelled:
            with self._lock:
                self._inflight.pop(rr.rid, None)
            self._note_trace_done(rr, "cancelled")
            return
        exc = f.exception()
        if exc is None:
            res = f.result()
            if rr.phase == "prefill":
                self._enqueue(("handoff", rr, res))
            else:
                self._finish(rr, res)
            return
        if isinstance(exc, DeadlineExceeded):
            self._fail(rr, exc)     # the client's own deadline: honest
            return
        # anything else is the replica dying under the request
        # (RequestCancelled from a kill's cancel_all, NonFiniteError
        # from an engine fault, RuntimeError from a closed engine):
        # re-admit elsewhere
        self._enqueue(("failover", rr, exc))

    def _enqueue(self, event):
        with self._lock:
            self._events.append(event)
        self._notify()

    def _finish(self, rr, res):
        if isinstance(res, GroupResult):
            # re-key the group under the ROUTER's rid (replica-local
            # group/lane ids change on failover); lanes/hypotheses pass
            # through untouched — the replica already assembled them
            out = GroupResult(rr.rid, res.kind, lanes=res.lanes,
                              hypotheses=res.hypotheses,
                              prompt_len=res.prompt_len)
            generated = sum(
                len(x.token_ids)
                for x in (res.lanes or res.hypotheses or ()))
            reason = "group"
        else:
            out = GenerationResult(rr.rid, res.token_ids, res.score,
                                   res.finish_reason, res.prompt_len,
                                   res.ttft_ms)
            generated = len(res.token_ids)
            reason = res.finish_reason
        with self._lock:
            self._inflight.pop(rr.rid, None)
        try:
            if not rr.future.cancelled():
                rr.future.set_result(out)
        except InvalidStateError:
            pass
        self._note_trace_done(rr, "retired", reason=reason,
                              generated=generated)
        self._notify()

    def _fail(self, rr, exc):
        with self._lock:
            self._inflight.pop(rr.rid, None)
        try:
            if not rr.future.cancelled():
                rr.future.set_exception(exc)
        except InvalidStateError:
            pass
        self._note_trace_done(rr, "failed",
                              reason=type(exc).__name__,
                              error=repr(exc)[:200])
        self._notify()

    def _note_trace_done(self, rr, outcome, reason=None, error=None,
                         generated=None):
        """Close out one request's fleet trace: the router-side summary
        (trace id, hops, lineage, outcome) lands in the /trace ring,
        and a fleet-track root span covers submit→end. Sampled
        requests only — the router's ONE verdict, same as the replica
        span trees."""
        ctx = rr.ctx
        if ctx is None or not ctx.sampled:
            return
        with self._lock:
            # once, under the lock: completion paths can race across
            # threads (a client-thread cancel vs the worker draining a
            # queued failover event) — the first verdict wins, the
            # ring and trace.completed never double-count a request
            if rr.trace_done:
                return
            rr.trace_done = True
        self._tracer.note_completed({
            "trace_id": ctx.trace_id, "rid": rr.rid,
            "outcome": outcome, "reason": reason, "error": error,
            "prompt_len": int(rr.prompt.size),
            "generated": generated,
            "hops": list(rr.hops), "attempts": rr.attempts,
            "lineage": list(rr.lineage),
            "implicated_deaths": rr.implicated})
        self._m_trace["completed"].inc()
        if self._tracer.enabled and rr.submit_perf is not None:
            # the root span covers EVERY hop, so it carries no hop key
            # of its own — just the trace id and the hop count
            self._tracer.fleet.complete(
                f"request {rr.rid}", rr.submit_perf,
                time.perf_counter(), cat="serving.fleet",
                args={"trace_id": ctx.trace_id, "rid": rr.rid,
                      "outcome": outcome, "reason": reason,
                      "generated": generated, "hops": len(rr.hops),
                      "attempts": rr.attempts},
                track="fleet requests")

    def _note_lineage(self, rr, exc):
        """Record a replica DEATH in the request's failover lineage
        and quarantine the request when implicated in too many.

        Death exceptions are RequestCancelled (a kill's cancel_all) and
        NonFiniteError (an engine fault) — a submit-race RuntimeError
        or a geometry ValueError re-pick is not a death and records
        nothing. An engine fault IMPLICATES exactly the requests its
        NonFiniteError names (bad_rids — the lanes that actually went
        non-finite): the poison request collects a strike per replica
        it faults, while innocent bystanders on the same replica fail
        over strike-free. Kills and hangs implicate no one (no request
        caused them). Returns True when the request was quarantined."""
        from ..robustness.guard import NonFiniteError
        if not isinstance(exc, (RequestCancelled, NonFiniteError)):
            return False
        name = rr.replica.name if rr.replica is not None else None
        implicated = isinstance(exc, NonFiniteError)
        if implicated and hasattr(exc, "bad_rids") and \
                rr.rep_fut is not None:
            implicated = rr.rep_fut.request_id in exc.bad_rids
        rr.lineage.append({"replica": name,
                           "kind": ("fault" if isinstance(
                               exc, NonFiniteError) else "death"),
                           "implicated": bool(implicated)})
        if not implicated:
            return False
        rr.implicated += 1
        if rr.implicated < self.poison_threshold:
            return False
        # quarantine: this request's replay predictably kills replicas
        # — fail it HERE with the structured error instead of feeding
        # it a third one, and leave a postmortem artifact
        from ..robustness.supervisor import PoisonRequestError
        self.counts["quarantines"] += 1
        self._m_fleet["quarantines"].inc()
        # the poison prompt's chains must not survive in the popularity
        # digest: resurrection re-warm (or the half-open probe) would
        # otherwise replay the exact payload that faults engines —
        # the cascade re-entering through the healing path
        self._digest.forget(rr.keys)
        # trace_id only when the request is SAMPLED: the verdict
        # governs every per-request trace artifact, and the mirrored
        # fleet-track instant must not mint an orphan trace id that
        # /trace and the span trees know nothing about
        self._flight_event("quarantine", rid=rr.rid,
                           trace_id=(rr.ctx.trace_id
                                     if rr.ctx is not None
                                     and rr.ctx.sampled else None),
                           attempts=rr.attempts,
                           lineage=list(rr.lineage))
        dump = self._flight.dump(
            "poison_request_quarantined", step=self.iteration,
            extra={"rid": rr.rid, "lineage": rr.lineage,
                   "attempts": rr.attempts,
                   "implicated_deaths": rr.implicated})
        self._fail(rr, PoisonRequestError(
            f"request {rr.rid} quarantined: implicated in "
            f"{rr.implicated} replica deaths across {rr.attempts} "
            f"failover(s) — not re-admitting a request whose replay "
            f"deterministically faults the engine",
            rr.rid, rr.lineage, rr.attempts, flight_dump=dump))
        return True

    def _do_failover(self, rr, exc):
        if rr.client_cancelled or rr.future.done():
            with self._lock:
                self._inflight.pop(rr.rid, None)
            # a request cancelled while its failover sat queued still
            # closes its /trace summary (idempotent: a future already
            # failed/finished kept its first verdict)
            self._note_trace_done(rr, "cancelled")
            return
        if self._note_lineage(rr, exc):
            return      # quarantined: future already failed
        # a draining close still honors its contract (finish every
        # in-flight request, including pending failovers); only a
        # non-drain close fails them fast
        budget = (self.max_failovers if rr.retry_budget is None
                  else min(rr.retry_budget, self.max_failovers))
        if (self._closed and not self._close_drain) or \
                rr.attempts >= budget:
            self._fail(rr, exc)
            return
        rr.attempts += 1
        self.counts["failovers"] += 1
        self._m_failovers.inc()
        self._tenants.count(rr.tenant, "failovers")
        pool = (self._pool(rr.phase)
                if self.policy.kind == "disaggregated" else None)
        try:
            # shedding OFF: this request was already admitted once —
            # re-admission is the fleet honoring that admission
            target, label = self._pick(rr, shed=False, pool=pool)
        except AdmissionRejected:
            self._fail(rr, exc)
            return
        src_name = rr.replica.name if rr.replica is not None else None
        hops_before = len(rr.hops)
        try:
            self._submit_to(
                rr, target, rr.phase,
                label if self.policy.kind == "affinity" else rr.phase)
        except (RuntimeError, ValueError) as sub_exc:
            # RuntimeError: the picked replica closed between pick and
            # submit; ValueError: this survivor's pool/max_context
            # cannot hold the request (replica geometry may differ) —
            # either way, one more failover attempt re-picks among the
            # rest (bounded by max_failovers)
            self._enqueue(("failover", rr, sub_exc))
            return
        if self._tracer.enabled and rr.ctx is not None \
                and rr.ctx.sampled and len(rr.hops) > hops_before:
            # the re-admission on the fleet track: what killed the
            # previous hop, and where the request moved — emitted only
            # AFTER the re-submission actually landed (a raced/failed
            # submit must not leave a phantom row naming a target that
            # never received the request), stamped with the hop the
            # route instant and span tree of the re-admission carry
            self._tracer.fleet.instant(
                "failover", cat="serving.fleet",
                args=dict(rr.ctx.at(hops_before).args(), rid=rr.rid,
                          cause=type(exc).__name__, source=src_name,
                          target=rr.hops[-1]["replica"],
                          attempt=rr.attempts),
                track="fleet router")

    # -- disaggregated handoff ---------------------------------------------
    def _do_handoff(self, rr, _prefill_res):
        if rr.client_cancelled or rr.future.done():
            with self._lock:
                self._inflight.pop(rr.rid, None)
            self._note_trace_done(rr, "cancelled")
            return
        src = rr.replica
        try:
            target, _label = self._pick(rr, shed=False,
                                        pool=self._pool("decode"))
        except AdmissionRejected as e:
            self._fail(rr, e)
            return
        moved = 0
        t0 = time.perf_counter() if (
            self._tracer.enabled and rr.ctx is not None
            and rr.ctx.sampled) else None
        if src is not None and src.alive():
            moved = self._transfer_chain(src, target, rr)
        self.counts["handoffs"] += 1
        self.counts["handoff_blocks"] += moved
        self._m_handoffs.inc()
        if moved:
            self._m_handoff_blocks.inc(moved)
            cache = target.server.cache
            self._tenants.count(
                rr.tenant, "handoff_bytes",
                moved * (cache.pool_bytes() // cache.num_blocks))
        if t0 is not None and rr.ctx is not None:
            # the disaggregated KV handoff, timed on the fleet track:
            # one block per full prompt chunk, bytes = pool slice cost
            # (stamped with the DECODE hop the transfer feeds into)
            cache = target.server.cache
            self._tracer.fleet.complete(
                "kv_handoff", t0, time.perf_counter(),
                cat="serving.fleet",
                args=dict(rr.ctx.at(len(rr.hops)).args(), rid=rr.rid,
                          source=(src.name if src is not None
                                  else None),
                          target=target.name, chunks=moved,
                          blocks=moved,
                          bytes=moved * (cache.pool_bytes()
                                         // cache.num_blocks)),
                track="fleet router")
        try:
            self._submit_to(rr, target, "decode", "decode")
        except (RuntimeError, ValueError) as sub_exc:
            self._enqueue(("failover", rr, sub_exc))

    def _transfer_chain(self, src_rep, dst_rep, rr):
        """Dispatch the chain handoff by backend: two in-process
        replicas take the direct pool-slice path (one indexed device
        copy per layer and pool entry, no host round-trip); any subprocess end goes
        through the serialized wire transfer (export_chain /
        import_chain, serving/worker.py): codes + scales + chain keys
        over the socket RPC, geometry-validated on receive. A worker
        dying mid-handoff is survivable by construction — the export
        half unrefs its pins in a finally BEFORE any bytes travel, so
        the donor's refcounts/ledger stay consistent and the decode
        side simply re-prefills what never arrived."""
        src, dst = src_rep.server, dst_rep.server
        if src_rep.backend == "inproc" and dst_rep.backend == "inproc":
            return self._transfer_chain_local(src, dst, rr)
        from ..serving.transport import TransportError
        from .worker import export_chain, import_chain
        try:
            if src_rep.backend == "subprocess":
                chunks, arrays = src.export_chain(rr.prompt, rr.keys)
            else:
                chunks, arrays = export_chain(src, rr.prompt, rr.keys)
            if not chunks:
                return 0
            if dst_rep.backend == "subprocess":
                return dst.import_chain(chunks, arrays)
            return import_chain(dst, chunks, arrays)
        except TransportError:
            # a worker died mid-handoff: partial transfer is safe (the
            # decode replica re-prefills); the death itself surfaces
            # on that replica's next pump/RPC through the normal
            # dead-classification path
            return 0

    def _transfer_chain_local(self, src, dst, rr):
        """Move the prompt's cached chunk KV from the prefill replica
        into the decode replica: walk the chain through the prefill
        index (peek — the handoff manifest), PIN each source block with
        a ref so a concurrent eviction cannot recycle it mid-copy,
        device-copy the pool slice across caches, and register the
        chunk into the decode index (whose own ref keeps the block; the
        transfer's allocation ref is dropped). Chunks the decode index
        already holds are skipped — a hot tenant hands off only the
        suffix it is missing. Partial transfer is safe by construction:
        whatever did not move simply re-prefills on the decode side.
        A chain chunk the source SPILLED to its host tier peeks as
        None; rather than truncating the transfer there, lift it back
        into the device pool (materialize_key — one swap-in, charged
        against the source's free list) so the handoff serves spilled
        chains too. A lift that cannot get a device block ends the
        walk exactly like a missing entry."""
        bs = self._block_size
        pinned = []                 # (key, src_block, tokens)
        with src._sched._lock:
            if src._prefix is None:
                return 0
            for i, key in enumerate(rr.keys):
                got = src._prefix.peek(key)
                if got is None and \
                        src._prefix.materialize_key(key) is not None:
                    got = src._prefix.peek(key)
                if got is None:
                    break
                block, tokens, _parent = got
                if not np.array_equal(
                        tokens, rr.prompt[i * bs:(i + 1) * bs]):
                    break       # collision-sentinel chain: not ours
                src.cache.ref(block)
                pinned.append((key, block,
                               np.array(tokens, np.int32, copy=True)))
        moved = 0
        try:
            parent = None
            with dst._sched._lock:
                for key, sblock, tokens in pinned:
                    if dst._prefix.peek(key) is not None:
                        parent = key
                        continue
                    got = dst.cache.allocate(1)
                    if got is None:
                        dst._prefix.evict_for(1)
                        got = dst.cache.allocate(1)
                    if got is None:
                        break   # pool full even after eviction: the
                        #         rest re-prefills
                    nb = got[0]
                    dst.cache.adopt_block_from(src.cache, sblock, nb)
                    if dst._prefix.register(key, parent, tokens, nb):
                        dst.cache.unref(nb)     # index ref keeps it
                        moved += 1
                        parent = key
                    else:       # raced an identical registration
                        dst.cache.free([nb])
                        parent = key
        finally:
            with src._sched._lock:
                for _k, b, _t in pinned:
                    src.cache.unref(b)
        return moved

    # -- serve loop --------------------------------------------------------
    def step(self):
        """One router iteration: process failover/handoff events, fire
        chaos replica kills/hangs, pump every live replica one engine
        iteration, run the supervisor heartbeat (watchdog +
        resurrection), finish drains. Returns True when anything
        happened OR a supervision duty is pending (a resurrection
        backoff) — the manual-drive / run_until_idle contract keeps
        pumping until the fleet is healed, not merely drained."""
        if self._teardown_done:
            return False
        if self._preempt is not None and not self._closed and \
                self._preempt.requested():
            self._begin_preempt_drain()
        did = self._drain_events()
        any_work = any(r.has_work() for r in self._replicas)
        if any_work:
            self.iteration += 1
            if self._chaos is not None:
                for idx in self._chaos.replica_kills_at(self.iteration):
                    self.kill_replica(idx)
                    did = True
                for idx in self._chaos.process_kills_at(self.iteration):
                    # the REAL death path: SIGKILL the worker pid and
                    # touch nothing parent-side — the proxy discovers
                    # the corpse on its next RPC, classifies it dead,
                    # and failover/resurrection run exactly as they
                    # would for a production crash
                    r = self._replicas[idx]
                    if r.alive() and r.backend == "subprocess" and \
                            r.server.kill_process():
                        self._chaos.process_kill_applied()
                        self._flight_event("chaos_process_kill",
                                           replica=r.name,
                                           pid=r.server.pid)
                        did = True
                for idx in self._chaos.replica_hangs_at(self.iteration):
                    if self._replicas[idx].alive():
                        # the replica STALLS without dying: the router
                        # stops pumping it, no future fails, failover
                        # never fires — only the watchdog can see it
                        self._chaos_hung.add(idx)
                        self._chaos.replica_hang_applied()
                        self._flight_event(
                            "chaos_hang",
                            replica=self._replicas[idx].name)
            for r in self._replicas:
                if not r.has_work():
                    continue
                if r.index in self._chaos_hung:
                    # frozen mid-stream; with a supervisor aboard this
                    # still counts as fleet activity (the watchdog owes
                    # a verdict), without one the fleet simply never
                    # notices
                    if self.supervisor is not None:
                        did = True
                    continue
                t0 = time.perf_counter()
                pumped = r.pump()
                ms = (time.perf_counter() - t0) * 1e3
                if self._chaos is not None:
                    extra = self._chaos.replica_slow_ms(r.index)
                    if extra:
                        ms += extra
                r.note_step_ms(ms)
                if pumped:
                    did = True
            did = self._drain_events() or did
        if self.supervisor is not None:
            if self.supervisor.on_heartbeat():
                did = True
            # a hung-replica teardown enqueues failover re-admissions;
            # land them THIS step so recovery latency is deterministic
            did = self._drain_events() or did
        if self.autoscaler is not None and any_work and \
                not self._closed:
            # after the supervisor: the breaker state the safety rail
            # reads is this heartbeat's verdict, not last iteration's
            if self.autoscaler.on_heartbeat():
                did = True
        for r in self._replicas:
            if r.finish_drain_if_idle():
                did = True
        if self._preempted and not self._teardown_done and \
                not any(r.has_work() for r in self._replicas) and \
                not self._events:
            self._teardown(drain=True)
            return True
        self._publish_gauges()
        if any_work and self.iteration % self._signals_every == 0:
            # one signals heartbeat per signals_every WORKING
            # iterations: registry gauges/counter-rates into the
            # router series, the windowed fleet burn rate, then the
            # alert rules — idle spins (the worker's wait loop) must
            # not dilute the series or age absence rules faster than
            # the fleet actually runs
            self._sample_signals()
        return did

    def _drain_events(self):
        did = False
        while True:
            with self._lock:
                if not self._events:
                    return did
                kind, rr, payload = self._events.popleft()
            did = True
            if kind == "failover":
                self._do_failover(rr, payload)
            else:
                self._do_handoff(rr, payload)

    def run_until_idle(self, max_iterations=100000):
        """Pump step() until the whole fleet is idle (manual-drive)."""
        n = 0
        while self.step():
            n += 1
            if n >= max_iterations:
                raise RuntimeError(
                    f"fleet did not drain in {max_iterations} "
                    f"iterations")
        return n

    def _notify(self):
        with self._cv:
            self._cv.notify()

    def _serve(self):
        while True:
            did = self.step()
            # spin ONLY on real work: a pending supervision duty (a
            # resurrection backoff) also returns True, but looping hot
            # on it would tick heartbeats at CPU speed — collapsing the
            # crash-loop breaker's backoff window to microseconds and
            # pegging a core. Idle-with-duty falls through to the wait,
            # so threaded heartbeats tick at ~wait-timeout rate.
            if did and (self._events
                        or any(r.has_work() for r in self._replicas)):
                continue
            with self._cv:
                if self._closed or self._teardown_done:
                    return
                if not (self._events
                        or any(r.has_work() for r in self._replicas)):
                    self._cv.wait(timeout=0.05)

    # -- lifecycle ---------------------------------------------------------
    def kill_replica(self, index):
        """Replica death: fail its in-flight requests NOW (the done
        callbacks enqueue their failover re-admission) and tear the
        engine down — ledger rows and gauge series retire with it."""
        r = self._replicas[index]
        if not r.alive():
            return
        self.counts["replica_kills"] += 1
        self._flight_event("replica_kill", replica=r.name,
                           pending=r.server.pending())
        # a hung-then-killed replica must not leave its slot in the
        # chaos stall set — the RESURRECTED replica there would never
        # be pumped again
        self._chaos_hung.discard(index)
        r.kill()
        # kill() ran cancel_all, so the victim's in-flight span trees
        # were just emitted into its recorder — freeze that capture
        # NOW: the slot's resurrection swaps in a fresh recorder, and
        # the victim's half of every failover must survive into the
        # merged postmortem dump
        self._tracer.snapshot_replica(r.name)
        self._signals_replica_death(r)
        if self._chaos is not None:
            self._chaos.replica_kill_applied()
        self._publish_gauges()      # drops the dead replica's series
        self._notify()

    def drain_replica(self, index):
        """Graceful: stop routing to the replica; its in-flight and
        queued requests finish normally, then step() closes it."""
        self._replicas[index].drain()
        self._notify()

    def add_replica_slot(self):
        """Grow the fleet by one slot: spawn a fresh replica through
        spawn_fn (a new worker process under the subprocess backend),
        validate the fleet contracts a mixed pool would break
        (block_size — affinity chain keys chunk by it; quantization
        layout — the handoff is a raw pool transfer), and start
        routing to it. The autoscaler's scale-up primitive, also
        usable directly by an operator. Returns the new Replica."""
        if self.spawn_fn is None:
            raise ValueError("add_replica_slot needs spawn_fn=")
        index = len(self._replicas)
        server = self.spawn_fn(index)
        if server.block_size != self._block_size:
            server.close(drain=False)
            raise ValueError(
                f"spawned replica has block_size={server.block_size}, "
                f"fleet uses {self._block_size}")
        if bool(getattr(server.cache, "quantized", False)) != \
                bool(getattr(self._replicas[0].server.cache,
                             "quantized", False)):
            server.close(drain=False)
            raise ValueError(
                "spawned replica's KV quantization layout does not "
                "match the fleet — the handoff contract forbids a "
                "mixed pool")
        rep = Replica(index, server)
        if self._trace_bound:
            self._bind_replica_recorder(rep)
        with self._lock:
            self._replicas.append(rep)
        if self._signals is not None:
            tel = rep.server.telemetry
            if tel is not None and tel.series is not None:
                self._signals.attach(rep.name, tel.series,
                                     rep.generation)
        self._flight_event("scale_up", replica=rep.name,
                           live=sum(1 for r in self._replicas
                                    if r.alive()))
        self._publish_gauges()
        self._notify()
        return rep

    def _declare_hung(self, index):
        """The watchdog's verdict: progress marks frozen for N
        heartbeats with work pending. The hung engine is torn down
        exactly like a death — close(drain=False) fails its in-flight
        futures (draining its stream registrations: the engine is
        never pumped again, so no late token can reach a client) and
        the failover path re-admits each request bitwise on a
        survivor."""
        r = self._replicas[index]
        if not r.alive():
            return
        self.counts["hangs"] += 1
        self._m_fleet["hangs"].inc()
        self._flight_event("hung_replica", replica=r.name,
                           iteration=self.iteration,
                           pending=r.server.pending())
        self._chaos_hung.discard(index)
        r.kill()
        self._tracer.snapshot_replica(r.name)   # postmortem capture
        self._signals_replica_death(r)
        self._publish_gauges()
        self._notify()

    def _count_fleet(self, key):
        """Supervisor-side counter hook (resurrections, crash_loops):
        the router owns the serving.fleet.* metric objects."""
        self.counts[key] += 1
        self._m_fleet[key].inc()

    def _flight_event(self, kind, **fields):
        """One fleet lifecycle event into the router's flight recorder
        (kills, hangs, resurrections, quarantines — the postmortem
        ring a quarantine dumps) AND, while a trace capture is live,
        an instant on the fleet track — supervisor events line up
        against the request spans they explain."""
        self._tracer.fleet.instant(
            kind, cat="serving.fleet",
            args=dict(fields, iteration=self.iteration),
            track="fleet router")
        self._flight.record(self.iteration, kind=kind, **fields)

    def _adopt_replica(self, index, server, generation=1):
        """Swap a freshly-resurrected server into replica slot
        `index` (supervisor-only; the old replica's engine is already
        closed). The slot keeps its name — gauge series and routing
        identity continue — and records its resurrection
        generation."""
        old = self._replicas[index]
        rep = Replica(index, server, name=old.name)
        rep.role = old.role
        rep.generation = int(generation)
        # the dead generation's capture is frozen (idempotent if the
        # kill/hang path already snapshotted it) and the slot's fresh
        # engine traces into a NEW recorder under the same name — the
        # merged dump shows both generations as separate process
        # groups. Only once fleet tracing was engaged: an untraced
        # fleet's resurrected replicas stay on the global recorder.
        if self._trace_bound:
            self._tracer.snapshot_replica(rep.name)
            self._bind_replica_recorder(rep)
        # the dead generation's series store and tenant ledger freeze
        # (idempotent with the kill/hang/gauge-sweep sites) before the
        # slot's NEW store attaches under the same name — the merged
        # /series view shows both generations
        self._signals_replica_death(old)
        with self._lock:
            self._replicas[index] = rep
        if self._signals is not None:
            tel = rep.server.telemetry
            if tel is not None and tel.series is not None:
                self._signals.attach(rep.name, tel.series,
                                     rep.generation)
        self._chaos_hung.discard(index)     # a fresh engine is never
        #                                     born into a chaos stall
        self._publish_gauges()
        self._notify()
        return rep

    # -- preemption --------------------------------------------------------
    def _begin_preempt_drain(self):
        """The PreemptionHandler flag is set (SIGTERM/SIGINT, or the
        chaos tier's request()): begin a fleet-wide graceful drain —
        close(drain=True) semantics without blocking the caller. New
        submits raise immediately; in-flight requests, pending
        failovers, and handoffs finish; then every replica closes and
        the router tears down (step()/the worker complete it)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._close_drain = True
            self._preempted = True
        self.counts["preempt_drains"] += 1
        self._flight_event("preempt_drain", pending=self.pending())
        # the drain must reach CHILD processes too: subprocess workers
        # get the preempt forwarded (finish in-flight, close, exit 0)
        # (the SIGTERM flag alone would only stop the parent loop and
        # orphan the workers)
        for r in self._replicas:
            r.notify_preempt()
        self._notify()

    # -- fleet tracing ------------------------------------------------------
    def _bind_replica_recorder(self, rep):
        if rep.server.telemetry is not None:
            rep.server.telemetry.set_recorder(
                self._tracer.recorder_for(rep.name, rep.generation))

    def start_trace(self):
        """Begin a fleet-wide trace capture: every replica's telemetry
        is (re)bound to its own per-slot recorder — from here on the
        fleet owns replica span emission; the process-wide recorder no
        longer sees these replicas' trees — and all recorders start
        against one shared time origin. Sampling is governed by PADDLE_TPU_TRACE_REQUESTS /
        the trace_sample ctor arg — decided ONCE per request at the
        router, obeyed on every hop."""
        self._trace_bound = True
        for r in self._replicas:
            self._bind_replica_recorder(r)
        self._tracer.start()

    def stop_trace(self):
        self._tracer.stop()

    def dump_trace(self, path=None):
        """Merge every capture — the fleet track, each live replica's
        recorder, and the frozen captures of replicas that died
        mid-capture — into ONE Perfetto JSON with per-replica process
        groups. `otherData.truncated` marks a partial capture (any
        ring dropped events, or a death snapshot was evicted). Writes
        to `path` when given; returns the payload either way."""
        payload = self._tracer.merge()
        self._m_trace["dumps"].inc()
        if path is not None:
            self._tracer.save(path, payload)
        return payload

    # -- fleet health signals ------------------------------------------------
    def _on_alert_event(self, kind, alert, t):
        """An alert transition mirrors into BOTH postmortem planes —
        a fleet-track instant (so the firing lines up against the
        request spans and kill events that explain it) and the fleet
        flight-recorder ring (the artifact a quarantine dumps)."""
        self._flight_event(f"alert_{kind}", rule=alert["name"],
                           series=alert["rule"]["series"],
                           value=alert["last_value"], t=round(t, 6))

    def _sample_signals(self):
        """One health-signals heartbeat (step(), working iterations
        only): sample the shared registry into the router series store
        (gauges + counter rates), derive the WINDOWED fleet burn-rate
        series for every admission SLO target, then run the alert
        rules — all at one injected-clock timestamp, so a chaos storm
        replays to the identical series and alert timeline."""
        if self._signals is None:
            return
        t = self._signals_clock()
        self._signals.fleet.sample(t)
        adm = self.admission
        targets = {}
        if adm is not None:
            targets = {m: dict(q) for m, q in adm.targets.items()}
            if adm.fleet_targets:
                for metric, qmap in adm.fleet_targets.items():
                    targets.setdefault(metric, {}).update(qmap)
        if self.autoscaler is not None:
            # the autoscaler's SLO targets feed the same burn series —
            # an autoscaled fleet without admission control still needs
            # slo.window_burn.* to exist before it can track it
            for metric, qmap in self.autoscaler.config.targets.items():
                targets.setdefault(metric, {}).update(qmap)
        if targets:
            pts = []
            live_tels = [r.server.telemetry for r in self._replicas
                         if r.alive() and r.server.telemetry is not None]
            for tel in live_tels:
                # window rotation normally rides the engine step loop,
                # so an IDLE replica's last breached window would pin
                # the fleet burn rate high forever (and the autoscaler
                # could never scale down) — the signals heartbeat
                # rolls idle engines' windows by clock. Remote
                # telemetries have no maybe_roll (the worker process
                # rolls its own).
                roll = getattr(tel.slo, "maybe_roll", None)
                if roll is not None:
                    roll()
            for metric, qmap in targets.items():
                # the ~2-window rolling view, count-weighted across
                # live replicas — unlike check_slo's cumulative
                # digests this view decays after recovery, so a
                # burn-rate alert built on it can actually resolve.
                # window_frac_over reads each replica's sketches in
                # place (no copies/merges); the weighted mean of
                # per-replica over-fractions IS the fleet fraction,
                # since the sample sets are disjoint.
                for tag, target in qmap.items():
                    q = _parse_qtag(tag)
                    budget = 1.0 - q
                    if budget <= 0:
                        continue
                    over = total = 0.0
                    for tel in live_tels:
                        fo, n = tel.slo.window_frac_over(
                            metric, float(target))
                        if fo is not None:
                            over += fo * n
                            total += n
                    if not total:
                        continue
                    pts.append((f"slo.window_burn.{metric}.{tag}",
                                round(over / total / budget, 4)))
            if pts:
                self._signals.fleet.observe_many(t, pts)
        if self._alerts is not None:
            self._alerts.evaluate(t)

    def _signals_replica_death(self, rep):
        """Freeze a dying replica's health-signal state, idempotent
        per (name, generation) — a death is noticed from several sites
        (kill_replica, the watchdog verdict, the gauge sweep that
        catches engine-fault deaths, resurrection's swap). Its series
        store snapshots into the merged /series view and its tenant
        ledger survives into tenant_stats() — cost attribution must
        not lose the work a replica billed before it died."""
        key = (rep.name, rep.generation)
        if key in self._dead_snapped:
            return
        self._dead_snapped.add(key)
        if self._signals is not None:
            self._signals.snapshot_replica(rep.name)
        tel = rep.server.telemetry
        if tel is not None:
            snap = tel.tenants.snapshot()
            if snap.get("tenants"):
                self._dead_tenant_snaps.append(snap)

    def tenant_stats(self):
        """Fleet per-tenant cost attribution (the /tenants body):
        every live replica's engine-side ledger (tokens, block
        residency, queue wait), the frozen ledgers of dead
        generations, and the router's own ledger (sheds, failovers,
        handoff bytes) aggregated into one snapshot. Engine ledgers
        bill every replica hop — a failover replay costs real compute
        and is attributed honestly."""
        snaps = []
        for r in self._replicas:
            if not r.alive():
                continue
            tel = r.server.telemetry
            if tel is not None:
                snaps.append(tel.tenants.snapshot())
        snaps.extend(self._dead_tenant_snaps)
        snaps.append(self._tenants.snapshot())
        return aggregate_tenant_snapshots(snaps)

    def dump_signals(self, path=None):
        """The health-signal postmortem artifact, sibling of
        dump_trace(): ONE JSON with the merged fleet series (dead
        replicas' frozen stores included), the alert record, and the
        per-tenant cost attribution. Writes to `path` when given;
        returns the payload either way."""
        payload = {
            "series": (self._signals.merged()
                       if self._signals is not None else None),
            "alerts": (self._alerts.payload()
                       if self._alerts is not None else empty_alerts()),
            "tenants": self.tenant_stats()}
        if path is not None:
            import json
            with open(path, "w") as f:
                json.dump(payload, f, sort_keys=True,
                          separators=(",", ":"))
        return payload

    def replicas(self):
        return list(self._replicas)

    def health(self):
        """Fleet health: per-replica /healthz payloads + the router's
        own status (the router /healthz endpoint body)."""
        reps = [r.health() for r in self._replicas]
        live = sum(1 for r in self._replicas if r.alive())
        status = ("closed" if self._closed
                  else "ok" if live else "dead")
        return {"status": status, "router": self.name,
                "live_replicas": live,
                "replicas": reps, "pending": self.pending(),
                "iteration": self.iteration}

    def check_slo(self, targets):
        """Fleet-level burn-rate check: each metric's CUMULATIVE
        digests MERGED across replicas (QuantileSketch.merge — the
        digests were built mergeable for exactly this), then the same
        burn-rate math as SLOTracker.check_slo. The fleet view can
        breach while every replica individually meets its target (and
        vice versa) — tail mass adds up."""
        from ..observability.serving_telemetry import (SLO_METRICS,
                                                       _parse_qtag)
        checks, ok = [], True
        for metric, qmap in targets.items():
            if metric not in SLO_METRICS:
                raise ValueError(
                    f"unknown SLO metric {metric!r} "
                    f"(know: {SLO_METRICS})")
            merged = None
            for r in self._replicas:
                tel = r.server.telemetry
                if tel is None:
                    continue
                d = tel.slo.digest(metric)
                merged = d if merged is None else merged.merge(d)
            for tag, target in qmap.items():
                q = _parse_qtag(tag)
                observed = merged.quantile(q) if merged is not None \
                    else None
                if observed is None:
                    checks.append({"metric": metric, "quantile": tag,
                                   "target_ms": float(target),
                                   "observed_ms": None, "met": None,
                                   "frac_over": None,
                                   "burn_rate": None})
                    continue
                frac_over = 1.0 - merged.rank(float(target))
                budget = 1.0 - q
                burn = frac_over / budget if budget > 0 else None
                met = observed <= float(target)
                ok = ok and met
                checks.append({"metric": metric, "quantile": tag,
                               "target_ms": float(target),
                               "observed_ms": round(observed, 3),
                               "met": met,
                               "frac_over": round(frac_over, 6),
                               "burn_rate": round(burn, 4)
                               if burn is not None else None})
        return {"ok": ok, "checks": checks}

    def _publish_gauges(self):
        live = sum(1 for r in self._replicas if r.alive())
        self._g_replicas.labels(router=self.name).set(live)
        for r in self._replicas:
            if not r.alive():
                # a replica dead by ANY path (kill_replica, engine
                # fault caught in pump) stops reporting load — the
                # spec's 'series removed when the replica dies'
                if r.name in self._load_series:
                    self._g_load.remove(router=self.name,
                                        replica=r.name)
                    self._load_series.discard(r.name)
                    # same trigger freezes its trace capture: an
                    # engine-fault death never passes through
                    # kill_replica, but its span trees (emitted by the
                    # fault's cancel_all) must survive resurrection
                    self._tracer.snapshot_replica(r.name)
                    self._signals_replica_death(r)
                continue
            ld = r.load()
            self._g_load.labels(router=self.name,
                                replica=r.name).set(ld[0] + ld[1])
            self._load_series.add(r.name)

    def get_stats(self):
        with self._lock:
            counts = dict(self.counts)
            inflight = len(self._inflight)
        reps = []
        for r in self._replicas:
            h = r.health()
            entry = {"name": r.name, "role": r.role,
                     "status": h["status"], "pending": h.get("pending"),
                     "condition": r.condition,
                     "generation": r.generation}
            if r.alive():
                q, a, f = r.load()
                entry.update(queue_depth=q, active_slots=a,
                             blocks_free=f)
                pfx = r.server._prefix
                if pfx is not None:
                    entry["prefix"] = pfx.stats()
            reps.append(entry)
        return {"router": self.name, "policy": self.policy.kind,
                "iteration": self.iteration, "inflight": inflight,
                "live_replicas": sum(
                    1 for r in self._replicas if r.alive()),
                "admission": (None if self.admission is None else {
                    "targets": self.admission.targets,
                    "burn_threshold": self.admission.burn_threshold,
                    "fleet_targets": self.admission.fleet_targets}),
                "supervisor": (self.supervisor.stats()
                               if self.supervisor is not None else None),
                "trace": dict(self._tracer.stats(),
                              sample_mode=self._trace_mode[0],
                              sample_rate=self._trace_mode[1]),
                "signals": (None if self._signals is None else dict(
                    self._signals.stats(),
                    alerts=(self._alerts.stats()
                            if self._alerts is not None else None))),
                "tenants": self.tenant_stats(),
                "popularity_digest": self._digest.stats(),
                "poison_threshold": self.poison_threshold,
                "replicas": reps, **counts}

    def serve_metrics(self, port=0, host=None):
        """Mount the router telemetry endpoint: /metrics serves the
        FLEET aggregate view (process-wide registry + every replica's
        serving.* series re-labeled replica=<name> — one scrape target
        for the whole fleet instead of one port per engine), /healthz
        the fleet health payload, /slo the per-replica SLO snapshots.
        Same mount/remount contract as the engine's serve_metrics."""
        from ..observability.exporter import (FleetRegistryView,
                                              check_remount,
                                              serve_metrics as _serve)
        if self._exporter is not None and not self._exporter.closed:
            check_remount(self._exporter, port, host)
            return self._exporter

        def _fleet_stats():
            out = []
            for r in self._replicas:
                if r.alive():
                    out.append((r.name, r.server.get_stats()))
            return out

        def _slo():
            return {r.name: (r.server.telemetry.stats()
                             if r.server.telemetry is not None else {})
                    for r in self._replicas if r.alive()}

        self._exporter = _serve(
            port=port, host=host or "127.0.0.1",
            registry=FleetRegistryView(_fleet_stats),
            slo_fn=_slo, health_fn=self.health,
            trace_fn=self._tracer.completed_payload,
            series_fn=(self._signals.merged
                       if self._signals is not None else None),
            alerts_fn=(self._alerts.payload
                       if self._alerts is not None else None),
            tenants_fn=self.tenant_stats)
        return self._exporter

    def close(self, drain=True, timeout=60):
        """Close the front door. drain=True finishes every in-flight
        request first (including pending failovers/handoffs);
        drain=False fails them. Replica engines close with the router
        — their HBM-ledger rows, SLO gauges, and prefix gauges retire,
        and the router's own serving.fleet.* gauge series are removed
        (a dead fleet must not keep reporting replica load)."""
        with self._lock:
            if self._closed:
                if self._teardown_done:
                    return
                # a preemption drain is in progress: this close joins
                # it (waits it out / finishes the teardown) instead of
                # returning while replicas still run
                drain = True
            else:
                self._closed = True
                self._close_drain = bool(drain)
        if self._worker is not None:
            deadline = time.monotonic() + timeout
            while drain and time.monotonic() < deadline and (
                    self._events
                    or any(r.has_work() for r in self._replicas)):
                self._notify()
                time.sleep(0.01)
            self._notify()
            self._worker.join(timeout=max(
                0.0, deadline - time.monotonic()))
        elif drain and not self._teardown_done:
            self.run_until_idle()
        self._teardown(drain)

    def _teardown(self, drain):
        """The one-shot tail of close(): close/kill replicas, drain
        the event queue, release the exporter, and retire the router's
        gauge series. Idempotent — reached from close() AND from the
        preemption drain's final step()."""
        with self._lock:
            if self._teardown_done:
                return
            self._teardown_done = True
        for r in self._replicas:
            if drain:
                r.close()
            else:
                r.kill()    # fail in-flight now; the event drain below
                #             routes their failovers into _fail (closed)
        self._drain_events()
        self._tracer.stop()     # captures stay mergeable after close —
        #                         dump_trace() still works for postmortems
        if self._alerts is not None:
            self._alerts.drop_gauges()      # a dead router must not
            #                                 report stale alert gauges
        if self._exporter is not None:
            self._exporter.close()
            self._exporter = None
        reg = global_registry()
        reg.gauge("serving.fleet.replicas").remove(router=self.name)
        for name in self._load_series:
            self._g_load.remove(router=self.name, replica=name)
        self._load_series.clear()
        if self._preempt is not None and self._preempt_owned:
            self._preempt.uninstall()
