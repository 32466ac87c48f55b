"""Process-wide metrics: counters, gauges, ms-bucket histograms.

Counterpart of ``paddle_tpu/observability/metrics.py``, kept as the
port's own copy (the port imports nothing of the JAX package). The
registry is thread-safe and label-aware, and exports JSON (one line,
machine-diffable; tools/trace_report.py reads it) and Prometheus text
exposition (dots sanitized to underscores).

``METRIC_SPECS`` is the JAX package's namespace, name for name and kind
for kind, so one report reads both packages' exports; the port records
the serving, prefix, tier, SLO, tracing and memory names among them.
"""

import contextlib
import json
import re
import threading
import time

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "global_registry", "DEFAULT_MS_BUCKETS", "METRIC_SPECS",
]

# Wall-clock millisecond buckets spanning host-dispatch overhead (~0.1ms)
# through big-model XLA compiles (minutes).
DEFAULT_MS_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                      100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
                      10000.0, 30000.0, 60000.0, 120000.0, float("inf"))


# Canonical metric namespace: (name, kind, help). The instrumentation
# and tools/trace_report.py both key off these names; the lint test
# asserts uniqueness here and that the live registry never strays.
METRIC_SPECS = [
    ("ops.traced", "counter",
     "op dispatches into the jax trace (trace-time, not run-time)"),
    ("executor.steps", "counter", "Executor.run() calls"),
    ("executor.step_ms", "histogram", "wall ms of a whole Executor.run()"),
    ("executor.compiles", "counter",
     "step functions built AND executed for the first time"),
    ("executor.compile_ms", "histogram",
     "first-execution wall ms per (program, shapes): jax trace + XLA "
     "compile + first device run"),
    ("executor.backend_compile_ms", "histogram",
     "XLA backend compile time reported by jax.monitoring, per event"),
    ("executor.span.key_build_ms", "histogram",
     "feed canonicalization + cache-key build + program validation"),
    ("executor.span.trace_ms", "histogram",
     "program -> step-closure construction on a jit-cache miss"),
    ("executor.span.compile_ms", "histogram",
     "first invocation of a fresh step fn (trace+compile+run)"),
    ("executor.span.execute_ms", "histogram",
     "cached step fn invocation"),
    ("executor.span.fetch_ms", "histogram",
     "fetch conversion (device sync + numpy copy)"),
    ("executor.jit_cache.hits", "counter", "step-fn cache hits"),
    ("executor.jit_cache.misses", "counter", "step-fn cache misses"),
    ("executor.jit_cache.evictions", "counter",
     "step-fn cache entries dropped (close()/clear_caches())"),
    ("executor.jit_cache.size", "gauge", "live step-fn cache entries"),
    ("executor.meta_cache.hits", "counter",
     "static (program, feed-keys, fetches) metadata cache hits"),
    ("executor.meta_cache.misses", "counter", "metadata cache misses"),
    ("executor.meta_cache.evictions", "counter",
     "metadata cache entries dropped"),
    ("executor.meta_cache.size", "gauge", "live metadata cache entries"),
    ("executor.uncached_runs", "counter",
     "run() calls with use_program_cache=False (caches bypassed, not "
     "missed)"),
    ("executor.async.dispatches", "counter",
     "run_async() steps dispatched into the in-flight window"),
    ("executor.async.dispatch_ms", "histogram",
     "host wall ms of one run_async dispatch (no device sync)"),
    ("executor.async.inflight", "gauge",
     "async steps dispatched but not yet resolved"),
    ("executor.async.window_waits", "counter",
     "dispatches that found the window full and blocked on the oldest "
     "in-flight step"),
    ("executor.async.host_sync_wait_ms", "histogram",
     "host wall ms blocked on an in-flight step (window admission + "
     "FetchHandle.wait)"),
    ("executor.async.errors", "counter",
     "exceptions captured into FetchHandles (dispatch or device)"),
    ("executor.bucket.batches", "counter",
     "feed dicts padded by a FeedBucketer"),
    ("executor.bucket.pad_waste_elems", "counter",
     "padding elements FeedBucketer added (bucketed minus real size)"),
    ("executor.bucket.shapes", "gauge",
     "distinct post-bucketing feed signatures a FeedBucketer produced"),
    ("executor.fault.guard_steps", "counter",
     "guarded steps whose NaN/Inf sentinel vector was checked"),
    ("executor.fault.nonfinite", "counter",
     "steps on which the NaN/Inf sentinel tripped (NonFiniteError)"),
    ("executor.fault.rollbacks", "counter",
     "GuardedTrainer checkpoint rollbacks after a fault"),
    ("executor.fault.skipped_batches", "counter",
     "offending feeds dropped by RecoveryPolicy(skip_bad_batch=True)"),
    ("executor.fault.preemptions", "counter",
     "preemption requests honored (drain + emergency checkpoint)"),
    ("checkpoint.saves", "counter",
     "checkpoints committed (atomic rename + manifest landed)"),
    ("checkpoint.save_ms", "histogram",
     "wall ms of one committed checkpoint write (payload + manifest)"),
    ("checkpoint.restores", "counter", "checkpoint restores completed"),
    ("checkpoint.restore_ms", "histogram",
     "wall ms of one checkpoint restore (load + CRC validation)"),
    ("checkpoint.write_failures", "counter",
     "checkpoint write attempts that raised (counted before any retry)"),
    ("checkpoint.crc_failures", "counter",
     "manifest/CRC validation failures at load (torn or corrupt file)"),
    ("checkpoint.fallbacks", "counter",
     "restores that skipped a corrupt/incomplete checkpoint and fell "
     "back to an older one"),
    ("checkpoint.evictions", "counter",
     "checkpoints pruned by a CheckpointManager retention policy"),
    ("checkpoint.emergency_saves", "counter",
     "checkpoints written by the preemption drain path"),
    ("checkpoint.retained", "gauge",
     "checkpoints currently retained by a CheckpointManager"),
    ("inference.int8.weights", "counter",
     "weight tensors rewritten to int8 (per-output-channel absmax) by "
     "AnalysisConfig.enable_int8 — the serving-model fold-in "
     "(GPTServingModel.quantize_int8) and the program-path PTQ rewrite "
     "both count here"),
    ("inference.int8.calibrated_activations", "counter",
     "activation tensors given a static quant-dequant scale by the "
     "enable_int8 calibration pass (quant/ptq.calibrate_program over "
     "the predictor's feeds)"),
    ("serving.requests", "counter",
     "generation requests submitted to a GenerationServer"),
    ("serving.admitted", "counter",
     "requests admitted from the queue into a decode slot"),
    ("serving.retired", "counter",
     "requests finished and resolved (eos or length)"),
    ("serving.cancelled", "counter",
     "requests cancelled by the client (queued or mid-stream)"),
    ("serving.deadline_cancels", "counter",
     "requests cancelled because their deadline passed"),
    ("serving.iterations", "counter",
     "scheduler iterations (one fused prefill/decode step each)"),
    ("serving.step_ms", "histogram",
     "wall ms of one serving iteration (plan + fused step + commit)"),
    ("serving.generated_tokens", "counter",
     "tokens emitted across all requests (tokens/s numerator)"),
    ("serving.prefill_tokens", "counter",
     "prompt tokens chunk-prefilled into the paged cache"),
    ("serving.queue_depth", "gauge",
     "requests waiting for a decode slot"),
    ("serving.active_slots", "gauge",
     "decode slots currently owned by a request"),
    ("serving.blocks_in_use", "gauge",
     "KV pool blocks currently allocated (pool utilization numerator)"),
    ("serving.ttft_ms", "histogram",
     "time to first token: submit -> first generated token"),
    ("serving.itl_ms", "histogram",
     "inter-token latency between consecutive generated tokens"),
    ("serving.kernel.traced", "counter",
     "paged_attention dispatches that traced a Pallas ragged paged "
     "attention kernel (one per layer per fused-step trace; unlabeled "
     "aggregate plus a version label: v1, v2)"),
    ("serving.kernel.fallback", "counter",
     "paged_attention dispatches that took the pure-JAX reference path "
     "(unlabeled aggregate plus a reason label — pinned_off, "
     "unsupported, vmap_trace, unsupported_under_shard_map — and a "
     "version=reference label mirroring serving.kernel.traced's)"),
    ("serving.kernel.version", "gauge",
     "kernel generation the LAST paged_attention dispatch took: 1 = "
     "v1 (gather-then-compute, bitwise-stable), 2 = v2 (double-"
     "buffered block streaming + online softmax), 0 = reference "
     "fallback"),
    ("serving.kernel.interpret", "gauge",
     "1 when the paged kernel runs under the Pallas interpreter "
     "(off-TPU), 0 when compiled for a real TPU"),
    ("serving.prefix.hits", "counter",
     "prefix-cache chunk probes that matched an indexed block (token-"
     "verified; the bench's hit-rate numerator)"),
    ("serving.prefix.misses", "counter",
     "prefix-cache chunk probes that missed (absent key, or a hash "
     "collision rejected by the token verify — the chain walk stops "
     "at the first miss, so one admission counts at most one miss)"),
    ("serving.prefix.shared_blocks", "gauge",
     "indexed KV blocks currently referenced by at least one live "
     "request on top of the index's own ref"),
    ("serving.prefix.evictions", "counter",
     "cached blocks evicted from the prefix index (LRU leaf-first, "
     "under watermark pressure or chaos injection)"),
    ("serving.prefix.cow_copies", "counter",
     "copy-on-write block copies (a shared block about to be written "
     "was copied to a fresh block and the table repointed)"),
    ("serving.group.requests", "counter",
     "fork-group submissions admitted (one per RequestGroup: n>1 "
     "parallel sampling or beam search)"),
    ("serving.group.lanes", "counter",
     "lanes admitted on behalf of fork groups (K per group — the "
     "per-lane cousin of serving.group.requests)"),
    ("serving.group.forks", "counter",
     "follower lanes forked off a completed leader prefill (table "
     "aliases of the shared prompt blocks — K-1 per group, zero "
     "block copies)"),
    ("serving.group.cow_copies", "counter",
     "copy-on-write copies taken by fork-group lanes diverging off "
     "shared blocks (prompt boundary or post-reorder suffix)"),
    ("serving.beam.reorders", "counter",
     "beam-search steps whose top-K selection changed parent "
     "hypotheses — each one is a host-side block-TABLE remap, not a "
     "KV move"),
    ("serving.guided.masked_steps", "counter",
     "lane-iterations whose logits carried a guided-decoding "
     "constraint mask (additive -inf rows inside the fused step)"),
    ("serving.guided.violations", "counter",
     "tokens committed with no automaton transition (unreachable "
     "while masks are fed; counted, not raised, under chaos "
     "mask-starve so the serving loop survives)"),
    ("serving.spec.proposed", "counter",
     "draft tokens submitted to fused-step verification (columns "
     "1..q-1 of speculative decode lanes)"),
    ("serving.spec.accepted", "counter",
     "verified draft tokens accepted (greedy: matched the target's "
     "own argmax; rejection mode: passed the acceptance draw)"),
    ("serving.spec.accept_rate", "gauge",
     "process-cumulative accepted/proposed ratio across all "
     "speculative schedulers"),
    ("serving.kv.quant.pool_bytes", "gauge",
     "TRUE footprint of a quantized KV block pool: int8 codes plus the "
     "f32 per-row scale pools, across k+v and every layer (label: "
     "server; absent for dense pools)"),
    ("serving.kv.quant.bytes_saved", "gauge",
     "bytes the int8 KV pool saves vs the same block count dense in "
     "the compute dtype (dense_equiv - int8+scales; label: server)"),
    ("serving.kv.tier.host_blocks", "gauge",
     "host-RAM spill-pool capacity in blocks (the tier the device "
     "pool evicts into and preemption parks in; label: server; "
     "absent without a host tier)"),
    ("serving.kv.tier.spills", "gauge",
     "cumulative device->host block copies: evictions that kept the "
     "prefix KV alive in the host tier plus preempted requests' "
     "parked blocks (label: server)"),
    ("serving.kv.tier.swap_ins", "gauge",
     "cumulative host->device block copies: spilled chains re-adopted "
     "on a prefix hit plus preempted requests resumed (label: server)"),
    ("serving.kv.tier.preempts", "gauge",
     "cumulative decode lanes parked in the host tier under block "
     "pressure, position and stream state intact (label: server)"),
    ("serving.kv.tier.resumes", "gauge",
     "cumulative preempted requests swapped back into device blocks "
     "and continued bitwise (label: server)"),
    ("serving.kv.tier.reprefills_avoided", "gauge",
     "cumulative prefix-chain blocks served by host-tier swap-in "
     "instead of re-running prefill (label: server)"),
    ("serving.mesh.axis_size", "gauge",
     "tensor-parallel mesh axis size a GenerationServer shards its "
     "fused step and KV pools over (label: server; absent single-"
     "device)"),
    ("serving.mesh.shard_pool_bytes", "gauge",
     "KV block-pool bytes ONE device commits under the serving mesh "
     "(pool_bytes/tp — the capacity unit admission watermarks "
     "protect; label: server)"),
    ("serving.mesh.psums_per_step", "gauge",
     "psum collectives one fused serving step pays (2 per layer: "
     "attention o-proj + ffn down-projection; label: server)"),
    ("serving.fleet.routed", "counter",
     "requests routed to a replica by the FleetRouter (unlabeled "
     "aggregate plus a policy label: affinity, least_loaded, prefill, "
     "decode)"),
    ("serving.fleet.sheds", "counter",
     "requests rejected by fleet admission control (AdmissionRejected "
     "raised; unlabeled aggregate plus a scope label: fleet = SLO "
     "burn-rate breach, capacity = no live replica)"),
    ("serving.fleet.failovers", "counter",
     "in-flight requests re-admitted on a surviving replica after "
     "their replica died mid-stream"),
    ("serving.fleet.handoffs", "counter",
     "disaggregated prefill->decode migrations (one per request that "
     "finished chunked prefill on the prefill pool and moved to a "
     "decode replica)"),
    ("serving.fleet.handoff_blocks", "counter",
     "KV pool blocks copied across replica caches by disaggregated "
     "handoffs (blocks the decode replica did NOT have to re-prefill)"),
    ("serving.fleet.replicas", "gauge",
     "live (ok or draining) replicas behind a FleetRouter (label: "
     "router)"),
    ("serving.fleet.replica_load", "gauge",
     "per-replica live load the router balances on: queue_depth + "
     "active_slots (labels: router, replica; series removed when the "
     "replica dies, is evicted by the crash-loop breaker, or the "
     "router closes)"),
    ("serving.fleet.hangs", "counter",
     "replicas declared HUNG by the supervisor watchdog (progress "
     "marks frozen for N heartbeats with work pending) and torn down "
     "so failover re-admits their in-flight requests"),
    ("serving.fleet.resurrections", "counter",
     "dead replicas respawned by the fleet supervisor and returned "
     "to rotation after a half-open probe, prefix cache re-warmed "
     "from the router's chunk-popularity digest"),
    ("serving.fleet.crash_loops", "counter",
     "failed resurrection attempts (spawn/probe failure, or a "
     "resurrected replica dying again before retiring a single "
     "request); max_crash_loops consecutive trips permanently evict "
     "the replica slot"),
    ("serving.fleet.quarantines", "counter",
     "poison requests quarantined by the router: implicated in >= "
     "poison_threshold replica deaths (engine faults naming their "
     "lane), failed with PoisonRequestError instead of re-admitted "
     "onto another survivor"),
    ("serving.fleet.trace.requests", "counter",
     "requests the router minted a SAMPLED fleet trace context for "
     "(one trace id + one sampling verdict per request, obeyed on "
     "every hop across handoff/failover/resurrection)"),
    ("serving.fleet.trace.completed", "counter",
     "finished request traces recorded into the router's bounded "
     "/trace ring (trace id, hops, lineage, outcome)"),
    ("serving.fleet.trace.dumps", "counter",
     "merged fleet Perfetto dumps produced by FleetRouter.dump_trace "
     "(fleet track + per-replica captures incl. death snapshots)"),
    ("serving.fleet.rpc.requests", "counter",
     "RPC calls issued to subprocess replica workers over the "
     "localhost socket transport (submit/step/cancel/handoff/...)"),
    ("serving.fleet.rpc.retries", "counter",
     "RPC attempts retried after a connection-level failure "
     "(reset/refused/truncated frame) with exponential backoff; "
     "exhausting the budget classifies the worker DEAD"),
    ("serving.fleet.rpc.timeouts", "counter",
     "RPC calls that hit their deadline with the connection still "
     "open — never retried (the worker may be mid-step); classifies "
     "the worker HUNG-suspect for the watchdog"),
    ("serving.fleet.autoscale.scale_ups", "counter",
     "replica slots added by the SLO-driven autoscaler (burn rate "
     "above up_threshold for up_samples consecutive signal samples)"),
    ("serving.fleet.autoscale.scale_downs", "counter",
     "replicas drained by the autoscaler (burn rate below "
     "down_threshold for down_samples consecutive samples — "
     "scale-down-slow hysteresis)"),
    ("serving.fleet.autoscale.blocked", "counter",
     "autoscaler scale-ups refused by the safety rail: a crash-loop "
     "breaker entry open, a slot evicted, or a death awaiting "
     "resurrection — a crashing image must never trigger a spawn "
     "storm"),
    ("serving.fleet.autoscale.desired", "gauge",
     "replica count the autoscaler currently wants (label: router); "
     "compare with serving.fleet.replicas to watch convergence"),
    ("tracing.dropped_events", "counter",
     "trace events dropped by the bounded ring buffer (drop-oldest)"),
    ("serving.queue_wait_ms", "histogram",
     "submit -> decode-slot admission wait"),
    ("serving.e2e_ms", "histogram",
     "submit -> retirement end-to-end latency (retired requests only)"),
    ("serving.slo.quantile_ms", "gauge",
     "per-window latency quantiles from the SLO digests (labels: "
     "metric=ttft|itl|e2e|queue_wait, q=p50|p90|p99, server=<per-"
     "tracker id> so concurrent servers never clobber each other)"),
    ("serving.slo.tokens_per_s", "gauge",
     "generated tokens/sec over the last completed SLO window "
     "(label: server)"),
    ("serving.slo.windows", "counter", "completed SLO digest windows"),
    ("serving.series.points", "counter",
     "time-series points recorded (all stores)"),
    ("serving.series.dropped_points", "counter",
     "time-series points evicted by ring wrap (all stores)"),
    ("serving.alerts.fired", "counter",
     "alert rule transitions to firing"),
    ("serving.alerts.resolved", "counter",
     "alert rule transitions firing -> resolved"),
    ("serving.alerts.active", "gauge",
     "alert rules currently firing (label: manager; plus an unlabeled "
     "aggregate)"),
    ("serving.tenant.requests", "counter",
     "finished requests per tenant (label: tenant; bounded "
     "cardinality, overflow collapses to <other>, untagged to <anon>)"),
    ("serving.tenant.generated_tokens", "counter",
     "decode tokens generated per tenant (label: tenant)"),
    ("serving.tenant.block_iterations", "counter",
     "KV block-residency per tenant in block*iterations — blocks "
     "reserved x engine iterations held (label: tenant)"),
    ("serving.tenant.sheds", "counter",
     "router admission sheds per tenant (label: tenant)"),
    ("serving.requests_traced", "counter",
     "requests whose lifecycle span tree was emitted into the trace "
     "recorder (PADDLE_TPU_TRACE_REQUESTS sampling knob)"),
    ("serving.faults", "counter",
     "engine fault events (non-finite logits, deadline storms) that "
     "dumped the flight recorder"),
    ("flight.dumps", "counter",
     "flight-recorder JSON artifacts written (engine faults, "
     "GuardedTrainer NaN rollbacks)"),
    ("exporter.requests", "counter",
     "telemetry HTTP endpoint requests served (labels: path, code; "
     "plus an unlabeled aggregate)"),
    ("executor.recompile.events", "counter",
     "post-warm jit-cache misses (recompiles) with a recorded key diff "
     "(which feed var changed shape/dtype vs the nearest cached "
     "signature)"),
    ("executor.recompile.storms", "counter",
     "recompile-storm warnings raised (>= storm-threshold recompiles "
     "inside the rate window; see docs/observability.md)"),
    ("executor.recompile.window_events", "gauge",
     "recompiles inside the current rate window (labeled per "
     "executor)"),
    ("memory.bytes", "gauge",
     "HBM-ledger bytes per (component, kind): params, optimizer, "
     "kv_cache, other, peak_hbm (docs/observability.md 'Compile & "
     "memory')"),
    ("memory.total_bytes", "gauge",
     "sum of live resident HBM-ledger bytes (params + optimizer + "
     "kv_cache + other; peak_hbm estimates excluded — they overlap "
     "the same buffers)"),
    ("memory.entries", "gauge", "live HBM-ledger entries"),
    ("executor.dp.runs", "counter", "data-parallel (mesh) run() calls"),
    ("executor.dp.shard_state_ms", "histogram",
     "feed/state device placement on the data-parallel path"),
    ("profiler.events", "counter", "profiler.record_event regions"),
]


def _label_key(labels):
    return tuple(sorted(labels.items())) if labels else ()


class _Child:
    """One (metric, label-set) time series."""

    __slots__ = ("_lock",)

    def __init__(self):
        self._lock = threading.Lock()


class _CounterChild(_Child):
    __slots__ = ("_value",)

    def __init__(self):
        super().__init__()
        self._value = 0

    def inc(self, n=1):
        if n < 0:
            raise ValueError("counters only go up; use a gauge")
        with self._lock:
            self._value += n

    def value(self):
        return self._value

    def reset(self):
        with self._lock:
            self._value = 0

    def snapshot(self):
        return {"value": self._value}


class _GaugeChild(_Child):
    __slots__ = ("_value",)

    def __init__(self):
        super().__init__()
        self._value = 0

    def set(self, v):
        with self._lock:
            self._value = v

    def inc(self, n=1):
        with self._lock:
            self._value += n

    def dec(self, n=1):
        self.inc(-n)

    def value(self):
        return self._value

    def reset(self):
        self.set(0)

    def snapshot(self):
        return {"value": self._value}


class _HistogramChild(_Child):
    __slots__ = ("_buckets", "_counts", "_count", "_sum", "_min", "_max")

    def __init__(self, buckets=DEFAULT_MS_BUCKETS):
        super().__init__()
        bs = tuple(sorted(buckets))
        if not bs or bs[-1] != float("inf"):
            bs = bs + (float("inf"),)
        self._buckets = bs
        self._counts = [0] * len(bs)
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None

    def observe(self, v):
        v = float(v)
        with self._lock:
            for i, le in enumerate(self._buckets):
                if v <= le:
                    self._counts[i] += 1
                    break
            self._count += 1
            self._sum += v
            self._min = v if self._min is None else min(self._min, v)
            self._max = v if self._max is None else max(self._max, v)

    @contextlib.contextmanager
    def time_ms(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe((time.perf_counter() - t0) * 1e3)

    def value(self):
        return self._count

    def reset(self):
        with self._lock:
            self._counts = [0] * len(self._buckets)
            self._count = 0
            self._sum = 0.0
            self._min = None
            self._max = None

    def summary(self):
        with self._lock:
            avg = self._sum / self._count if self._count else 0.0
            return {"count": self._count, "sum": round(self._sum, 6),
                    "min": self._min, "max": self._max,
                    "avg": round(avg, 6)}

    def snapshot(self):
        with self._lock:
            cum, buckets = 0, []
            for le, c in zip(self._buckets, self._counts):
                cum += c
                buckets.append([le if le != float("inf") else "+Inf", cum])
        out = self.summary()
        out["buckets"] = buckets
        return out


class _Metric:
    kind = None
    _child_cls = None

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._children = {}
        self._default = None    # lazily-created no-label child

    def _make_child(self):
        return self._child_cls()

    def labels(self, **labels):
        key = _label_key(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                self._children[key] = child
                if not key:
                    self._default = child
        return child

    def remove(self, **labels):
        """Drop one label-set's series (e.g. a closed executor's gauges)."""
        with self._lock:
            self._children.pop(_label_key(labels), None)

    def _base(self):
        d = self._default
        return d if d is not None else self.labels()

    # no-label convenience: metric acts as its own unlabeled child
    def value(self):
        return self._base().value()

    def reset(self):
        with self._lock:
            children = list(self._children.values())
        for c in children:
            c.reset()

    def series(self):
        """[(labels_dict, child), ...] snapshot."""
        with self._lock:
            return [(dict(k), c) for k, c in self._children.items()]

    def snapshot(self):
        return {"name": self.name, "type": self.kind, "help": self.help,
                "values": [dict(labels=lbl, **c.snapshot())
                           for lbl, c in self.series()]}


class Counter(_Metric):
    kind = "counter"
    _child_cls = _CounterChild

    def inc(self, n=1):
        self._base().inc(n)


class Gauge(_Metric):
    kind = "gauge"
    _child_cls = _GaugeChild

    def set(self, v):
        self._base().set(v)

    def inc(self, n=1):
        self._base().inc(n)

    def dec(self, n=1):
        self._base().dec(n)


class Histogram(_Metric):
    kind = "histogram"
    _child_cls = _HistogramChild

    def __init__(self, name, help="", buckets=DEFAULT_MS_BUCKETS):
        super().__init__(name, help)
        self._buckets_spec = buckets

    def _make_child(self):
        return _HistogramChild(self._buckets_spec)

    def observe(self, v):
        self._base().observe(v)

    def time_ms(self):
        return self._base().time_ms()

    def summary(self):
        return self._base().summary()

    def summaries(self):
        return [(lbl, c.summary()) for lbl, c in self.series()]


_NAME_RE = re.compile(r"^[a-z][a-z0-9_.]*$")


class MetricsRegistry:
    """Name -> metric store. Process-wide singleton via global_registry();
    components (each Executor) also keep a private instance so
    get_stats() can answer per-instance questions."""

    def __init__(self):
        self._metrics = {}
        self._lock = threading.RLock()

    def _get_or_create(self, name, cls, help, **kw):
        if not _NAME_RE.match(name):
            raise ValueError(
                f"bad metric name {name!r}: lowercase dotted identifiers "
                f"only (pattern {_NAME_RE.pattern})")
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kw)
                self._metrics[name] = m
            elif type(m) is not cls:
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name, help=""):
        return self._get_or_create(name, Counter, help)

    def gauge(self, name, help=""):
        return self._get_or_create(name, Gauge, help)

    def histogram(self, name, help="", buckets=DEFAULT_MS_BUCKETS):
        return self._get_or_create(name, Histogram, help, buckets=buckets)

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def names(self):
        with self._lock:
            return sorted(self._metrics)

    def reset(self):
        """Zero every series (keeps registrations)."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.reset()

    def clear(self):
        """Drop every metric (tests only)."""
        with self._lock:
            self._metrics.clear()

    # -- export -------------------------------------------------------------
    def to_dict(self):
        with self._lock:
            metrics = list(self._metrics.values())
        return {"metrics": [m.snapshot() for m in
                            sorted(metrics, key=lambda m: m.name)]}

    def to_json(self, indent=None):
        """One-line JSON by default: perf/ artifacts are parsed line-wise
        (tools/bench_watch.py _artifact_ok reads the LAST line)."""
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    def to_prometheus(self):
        """Prometheus text exposition format, 'name.with.dots' sanitized
        to legal underscore form. Label values AND help text are escaped
        per the format spec (labels: backslash/quote/newline; HELP:
        backslash/newline) — a label like shape="(4, 8)" or a help
        string spanning lines must never emit an unscrapeable line."""
        lines = []
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        for m in metrics:
            pname = re.sub(r"[^a-zA-Z0-9_:]", "_", m.name)
            if m.help:
                lines.append(f"# HELP {pname} {_escape_help(m.help)}")
            lines.append(f"# TYPE {pname} {m.kind}")
            for lbl, child in m.series():
                base_lbl = _fmt_labels(lbl)
                if m.kind in ("counter", "gauge"):
                    lines.append(f"{pname}{base_lbl} {child.value()}")
                else:
                    snap = child.snapshot()
                    for le, cum in snap["buckets"]:
                        le_lbl = _fmt_labels(dict(lbl, le=str(le)))
                        lines.append(f"{pname}_bucket{le_lbl} {cum}")
                    lines.append(f"{pname}_sum{base_lbl} {snap['sum']}")
                    lines.append(f"{pname}_count{base_lbl} {snap['count']}")
        return "\n".join(lines) + "\n"


def _fmt_labels(labels):
    if not labels:
        return ""
    body = ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(labels.items()))
    return "{" + body + "}"


def _escape(v):
    """Label-value escaping per the exposition format: backslash,
    double-quote, newline."""
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _escape_help(v):
    """HELP-line escaping per the exposition format: backslash and
    newline only (quotes are legal in help text)."""
    return str(v).replace("\\", r"\\").replace("\n", r"\n")


_GLOBAL = MetricsRegistry()


def global_registry():
    return _GLOBAL
