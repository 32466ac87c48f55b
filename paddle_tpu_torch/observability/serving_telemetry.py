"""Request-level serving telemetry: lifecycle traces, SLO digests, the
per-tenant ledger and the fault flight recorder.

Counterpart of ``paddle_tpu/observability/serving_telemetry.py``, kept
as the port's own copy (with the fleet's tenant aggregation,
``aggregate_tenant_snapshots``). The serving engine's unit of work is a request that lives
across many fused-step iterations; this is the layer the engine and
scheduler call into:

- **Lifecycle tracing**: every sampled request gets a retroactively
  emitted span tree in the global TraceRecorder (Perfetto):
  ``request <rid>`` root covering submit to end, with ``queue``,
  ``prefill.chunk`` xN and ``decode`` children, ended by a
  ``retire``/``cancel``/``deadline`` instant, on one track per decode
  slot (``serving slot <n>``; never-admitted requests on ``serving
  queue``). Sampling knob: ``PADDLE_TPU_TRACE_REQUESTS=off|
  sampled:<rate>|all`` (deterministic per-request-id hash, no RNG).
- **SLO digests**: TTFT / ITL / e2e / queue-wait in mergeable quantile
  sketches (sketch.py), cumulative and per rolling window. Each
  completed window publishes ``serving.slo.quantile_ms{metric=...,
  q=p50|p90|p99}`` and ``serving.slo.tokens_per_s``;
  ``GenerationServer.get_stats()["slo"]`` snapshots the views and
  ``check_slo(targets)`` turns them into burn rates.
- **Flight recorder**: a bounded ring of the last K engine iterations
  (scheduler decisions, slot occupancy, block-pool watermarks,
  per-lane positions and KV tier). Engine faults (non-finite logits,
  deadline storms) dump it as one ``flight-<step>.json``.

Everything here is host-side bookkeeping (dict appends and float
arithmetic), and the engine can switch the whole layer off
(``GenerationServer(telemetry=False)``).
"""

import collections
import itertools
import json
import math
import os
import threading
import time
import warnings

from .metrics import global_registry
from .sketch import QuantileSketch
from .timeseries import SeriesStore
from .tracing import get_recorder

__all__ = ["ServingTelemetry", "SLOTracker", "TenantLedger",
           "FlightRecorder", "trace_request_mode"]


def _help(name):
    from . import _help as pkg_help
    return pkg_help(name)


# ---------------------------------------------------------------------------
# sampling knob
# ---------------------------------------------------------------------------

def trace_request_mode(raw=None):
    """-> (mode, rate) from PADDLE_TPU_TRACE_REQUESTS.

    off | sampled:<rate in (0,1]> | all (default). Request-id sampling
    is deterministic (splitmix-style integer hash), so a replayed
    stream traces the same requests.

    A malformed value raises ONLY when passed explicitly (programmer
    error); a typo in the env var warns and falls back to the default —
    an observability sampling knob must never be fatal to serving."""
    from_env = raw is None
    if from_env:
        raw = os.environ.get("PADDLE_TPU_TRACE_REQUESTS", "all")
    try:
        return _parse_trace_request_mode(raw)
    except ValueError:
        if not from_env:
            raise
        warnings.warn(
            f"ignoring bad PADDLE_TPU_TRACE_REQUESTS={raw!r} "
            f"(expected off | sampled:<rate> | all); tracing all "
            f"requests", RuntimeWarning, stacklevel=2)
        return "all", 1.0


def _parse_trace_request_mode(raw):
    raw = str(raw).strip().lower()
    if raw in ("", "all", "on", "1", "true"):
        return "all", 1.0
    if raw in ("off", "none", "0", "false"):
        return "off", 0.0
    if raw.startswith("sampled:"):
        try:
            rate = float(raw.split(":", 1)[1])
        except ValueError:
            raise ValueError(
                f"bad PADDLE_TPU_TRACE_REQUESTS rate in {raw!r}")
        if not 0.0 <= rate <= 1.0:
            raise ValueError(
                f"PADDLE_TPU_TRACE_REQUESTS rate must be in [0, 1], "
                f"got {rate}")
        return "sampled", rate
    raise ValueError(
        f"bad PADDLE_TPU_TRACE_REQUESTS {raw!r}: "
        f"expected off | sampled:<rate> | all")


_MASK64 = (1 << 64) - 1


def _rid_hash01(rid):
    """Deterministic rid -> [0, 1) (splitmix64 finalizer)."""
    x = (int(rid) * 0x9E3779B97F4A7C15) & _MASK64
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & _MASK64
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & _MASK64
    x ^= x >> 31
    return x / 2.0 ** 64


def _jsonable(v):
    """Best-effort conversion of flight-entry values to JSON-safe types
    (numpy scalars/arrays arrive from scheduler snapshots)."""
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, set, frozenset)):
        return [_jsonable(x) for x in v]
    if isinstance(v, (str, bool)) or v is None:
        return v
    if isinstance(v, float):
        return v if math.isfinite(v) else repr(v)
    if isinstance(v, int):
        return v
    item = getattr(v, "item", None)
    if item is not None:
        try:
            return _jsonable(item())
        except Exception:
            pass
    tolist = getattr(v, "tolist", None)
    if tolist is not None:
        try:
            return _jsonable(tolist())
        except Exception:
            pass
    return repr(v)


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

# Fixed schema of the engine's per-iteration hot-path entry
# (FlightRecorder.record_iteration) and of one lane in lanes_detail
# (ContinuousBatchingScheduler.lane_snapshot). The hot path stores
# plain tuples in this field order — CPython untracks tuples of
# scalars, so unlike per-iteration dicts they add no GC pressure next
# to a ~0.25 ms fused step — and entries()/dump() expand them back to
# the documented dict form.
ITER_FIELDS = ("step_ms", "lanes", "emitting", "prefill_tokens",
               "admitted", "retired", "queue_depth", "active_slots",
               "blocks_free", "blocks_in_use", "watermark_blocks",
               "lanes_detail", "kernel", "deadline_cancels")
LANE_FIELDS = ("slot", "rid", "pos", "prefilling", "admit_seq",
               "generated", "first_block", "shared_blocks",
               "cow_copies", "tier", "group", "beam_rank")


def _expand_lanes(lanes):
    """lanes_detail tuples -> the documented list-of-dicts form."""
    if lanes is None:
        return None
    return [dict(zip(LANE_FIELDS, lane)) if isinstance(lane, tuple)
            else lane for lane in lanes]


class FlightRecorder:
    """Bounded ring of per-iteration engine/trainer state, dumped as one
    JSON artifact on a fault.

    Schema (``paddle_tpu.flight/1``)::

        {"schema": "paddle_tpu.flight/1",
         "reason": "non_finite_logits" | "deadline_storm" |
                   "nonfinite_rollback" | ...,
         "step": <step/iteration the fault fired on>,
         "dumped_at_epoch_s": <wall clock>,
         "capacity": K, "recorded": <entries ever recorded>,
         "extra": {...fault detail...},
         "entries": [{"step": ..., "kind": "iteration"|"dispatch"|...,
                      "t_epoch_s": ..., ...recorder-specific fields...},
                     ...]}          # oldest-first, last entry = newest

    The newest entry is annotated with the fault detail before the dump,
    so the LAST element always identifies the offending step."""

    SCHEMA = "paddle_tpu.flight/1"

    def __init__(self, capacity=256, out_dir=None):
        self.capacity = max(1, int(capacity))
        self.out_dir = out_dir if out_dir is not None else \
            os.environ.get("PADDLE_TPU_FLIGHT_DIR", ".")
        self._entries = collections.deque(maxlen=self.capacity)
        self._recorded = 0
        self._lock = threading.Lock()
        self.dump_paths = []
        self._dumps = global_registry().counter(
            "flight.dumps", _help("flight.dumps"))

    def record(self, step, kind="iteration", **fields):
        self.record_fields(step, fields, kind)

    def record_fields(self, step, fields, kind="iteration"):
        """record() without the kwargs repack: `fields` is adopted as
        the entry (mutated in place — pass a dict the caller is done
        with). The engine records an entry every iteration next to a
        ~0.25 ms fused step, where rebuilding an ~18-key dict per call
        is a measurable slice of the <5% telemetry-overhead budget."""
        fields["step"] = int(step)
        fields["kind"] = kind
        fields["t_epoch_s"] = round(time.time(), 6)
        with self._lock:
            self._entries.append(fields)
            self._recorded += 1

    def record_iteration(self, step, values):
        """The engine's per-iteration hot path: `values` is a tuple in
        ITER_FIELDS order (no dicts — a tuple of scalars is untracked
        by the GC, so the ring's constant churn next to a ~0.25 ms
        fused step stops promoting garbage into the older GC
        generations). Expanded back to the documented dict form by
        entries()/dump()/annotate_last()."""
        with self._lock:
            self._entries.append((int(step), round(time.time(), 6),
                                  values))
            self._recorded += 1

    @staticmethod
    def _expand(entry):
        """Ring entry (hot-path tuple OR dict) -> the documented dict
        form, lanes_detail normalized to list-of-dicts."""
        if isinstance(entry, tuple):
            step, t, values = entry
            out = {"step": step, "kind": "iteration", "t_epoch_s": t}
            out.update(zip(ITER_FIELDS, values))
        else:
            out = dict(entry)
        if "lanes_detail" in out:
            out["lanes_detail"] = _expand_lanes(out["lanes_detail"])
        return out

    def annotate_last(self, **fields):
        """Attach fault detail to the newest entry (so the dump's last
        element identifies the offending iteration)."""
        with self._lock:
            if not self._entries:
                return
            last = self._expand(self._entries[-1])
            last.update(fields)
            self._entries[-1] = last

    def entries(self):
        with self._lock:
            return [self._expand(e) for e in self._entries]

    def __len__(self):
        with self._lock:
            return len(self._entries)

    def dump(self, reason, step=None, extra=None, path=None):
        """Write flight-<step>.json into out_dir; returns the path."""
        with self._lock:
            entries = [self._expand(e) for e in self._entries]
            recorded = self._recorded
        if step is None:
            step = entries[-1]["step"] if entries else 0
        if path is None:
            os.makedirs(self.out_dir, exist_ok=True)
            path = os.path.join(self.out_dir, f"flight-{int(step):08d}.json")
            # repeated faults at one step (e.g. GuardedTrainer retries of
            # a deterministic NaN) must not overwrite earlier postmortems
            n = 1
            while os.path.exists(path):
                path = os.path.join(
                    self.out_dir, f"flight-{int(step):08d}-r{n}.json")
                n += 1
        payload = {"schema": self.SCHEMA, "reason": reason,
                   "step": int(step),
                   "dumped_at_epoch_s": round(time.time(), 6),
                   "capacity": self.capacity, "recorded": recorded,
                   "extra": _jsonable(extra or {}),
                   "entries": _jsonable(entries)}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        self.dump_paths.append(path)
        self._dumps.inc()
        return path


# ---------------------------------------------------------------------------
# SLO digests
# ---------------------------------------------------------------------------

SLO_METRICS = ("ttft_ms", "itl_ms", "e2e_ms", "queue_wait_ms")
_QUANTS = ((0.5, "p50"), (0.9, "p90"), (0.99, "p99"))


def _parse_qtag(tag):
    """'p99' -> 0.99, 'p99.9' -> 0.999."""
    t = str(tag).strip().lower()
    if not t.startswith("p"):
        raise ValueError(f"bad quantile tag {tag!r} (want e.g. 'p99')")
    pct = float(t[1:])
    if not 0.0 < pct < 100.0:
        raise ValueError(f"quantile tag {tag!r} out of (0, 100)")
    return pct / 100.0


_TRACKER_SEQ = itertools.count()


class SLOTracker:
    """Cumulative + rolling-window quantile digests for the serving
    latency metrics, published as gauges on each completed window.

    Gauge series carry a per-tracker label (default
    ``{"server": "srv<N>"}``) — two live GenerationServers in one
    process must not clobber each other's window quantiles (the
    Executor's per-instance gauge-label convention). drop_gauges()
    removes this tracker's series from the process-wide registry."""

    #: completed windows retained in snapshot()["recent_windows"]
    RECENT_WINDOWS = 32

    def __init__(self, clock=time.monotonic, window_s=60.0,
                 compression=128, labels=None, recent_windows=None):
        self._clock = clock
        self.window_s = float(window_s)
        self._compression = int(compression)
        self.labels = dict(labels) if labels else \
            {"server": f"srv{next(_TRACKER_SEQ)}"}
        self._published = set()     # label tuples set on _g_quant
        self._lock = threading.Lock()
        self._cum = {m: QuantileSketch(compression) for m in SLO_METRICS}
        self._win = {m: QuantileSketch(compression) for m in SLO_METRICS}
        self._win_start = clock()
        self._started = self._win_start
        self._win_tokens = 0
        self._cum_tokens = 0
        self._last_window = None
        self._last_win_sketches = None      # the previous window's raw
        #                                     digests (window_digest())
        self._recent = collections.deque(
            maxlen=max(1, int(recent_windows if recent_windows
                              is not None else self.RECENT_WINDOWS)))
        self.windows_completed = 0
        reg = global_registry()
        self._g_quant = reg.gauge("serving.slo.quantile_ms",
                                  _help("serving.slo.quantile_ms"))
        self._g_tps = reg.gauge("serving.slo.tokens_per_s",
                                _help("serving.slo.tokens_per_s"))
        self._c_windows = reg.counter("serving.slo.windows",
                                      _help("serving.slo.windows"))

    def observe(self, metric, value_ms):
        with self._lock:
            self._cum[metric].add(value_ms)
            self._win[metric].add(value_ms)

    def count_tokens(self, n=1):
        with self._lock:
            self._win_tokens += n
            self._cum_tokens += n

    def observe_token(self, metric, value_ms):
        """observe(metric) + count_tokens(1) under ONE lock, via the
        sketches' validation-free add_unit — the per-token hot path
        runs this for every generated token next to a ~0.25 ms CPU
        fused step, where each microsecond is ~0.4% of the <5%
        telemetry-overhead budget. value_ms is always an
        engine-computed finite float (add_unit's contract)."""
        v = float(value_ms)
        with self._lock:
            self._cum[metric].add_unit(v)
            self._win[metric].add_unit(v)
            self._win_tokens += 1
            self._cum_tokens += 1

    def digest(self, metric):
        """A COPY of the cumulative sketch for `metric` (mergeable
        across servers/processes via QuantileSketch.merge). A copy, not
        the live object: quantile()/rank() compress in place, and the
        engine worker concurrently observe()s into the original — the
        caller gets a consistent snapshot instead of a race."""
        with self._lock:
            return QuantileSketch.from_dict(self._cum[metric].to_dict())

    def window_digest(self, metric):
        """A COPY of the last-completed-window sketch merged with the
        live window for `metric` — the rolling ~2-window view the
        fleet's burn-rate SERIES is computed from. Unlike the
        cumulative digest (which never forgets a storm), this one
        decays within two window lengths of recovery, so an alert on
        it can actually resolve."""
        with self._lock:
            d = QuantileSketch.from_dict(self._win[metric].to_dict())
            last = self._last_win_sketches
            if last is not None and last[metric].count:
                d.merge(QuantileSketch.from_dict(
                    last[metric].to_dict()))
            return d

    def window_frac_over(self, metric, target):
        """(fraction of rolling-window samples ABOVE target, sample
        count) over the same ~2-window view as window_digest, but
        with NO sketch copies or merges — rank() reads the sketches
        in place. This is the router's per-heartbeat burn-rate feed,
        where a copy and merge a heartbeat would be a per-step tax.
        Returns (None, 0) when the window
        holds no samples. Cross-sketch combination is exact: rank is
        a fraction of mass, so the union's rank is the count-weighted
        mean of member ranks."""
        with self._lock:
            live = self._win[metric]
            last = (self._last_win_sketches[metric]
                    if self._last_win_sketches is not None else None)
            n = live.count + (last.count if last is not None else 0)
            if not n:
                return None, 0
            over = 0.0
            for sk in (live, last):
                if sk is not None and sk.count:
                    over += (1.0 - sk.rank(float(target))) * sk.count
            return over / n, n

    def maybe_roll(self):
        """Close the window if window_s elapsed; publish its quantile
        gauges. Returns True when a window completed."""
        now = self._clock()
        # lock-free fast path: _win_start is a float read; the worst a
        # racing roll can do is make this read stale and the window
        # close one engine iteration later — this runs every iteration
        if now - self._win_start < self.window_s:
            return False
        with self._lock:
            elapsed = now - self._win_start
            if elapsed < self.window_s:
                return False
            summary = {}
            for m in SLO_METRICS:
                d = self._win[m]
                if d.count:
                    summary[m] = d.summary()
                    for q, tag in _QUANTS:
                        lbl = dict(self.labels, metric=m[:-3], q=tag)
                        self._g_quant.labels(**lbl).set(
                            round(d.quantile(q), 3))
                        self._published.add(tuple(sorted(lbl.items())))
            tps = self._win_tokens / max(elapsed, 1e-9)
            summary["tokens_per_s"] = round(tps, 3)
            summary["elapsed_s"] = round(elapsed, 6)
            summary["tokens"] = self._win_tokens
            summary["closed_at"] = round(now, 6)
            self._g_tps.labels(**self.labels).set(round(tps, 3))
            self._last_window = summary
            self._recent.append(summary)
            # keep the closed window's raw sketches (not just the
            # summary): window_digest() merges them with the live
            # window so windowed burn rates never go blind at a
            # window boundary
            self._last_win_sketches = self._win
            self._win = {m: QuantileSketch(self._compression)
                         for m in SLO_METRICS}
            self._win_tokens = 0
            self._win_start = now
            self.windows_completed += 1
            self._c_windows.inc()
            return True

    def drop_gauges(self):
        """Remove this tracker's gauge series from the process-wide
        registry — a closed server must not report stale window
        quantiles forever (ComponentStats.drop_gauges convention)."""
        with self._lock:
            for lbl in self._published:
                self._g_quant.remove(**dict(lbl))
            self._published.clear()
            self._g_tps.remove(**self.labels)

    def snapshot(self):
        with self._lock:
            now = self._clock()
            cum_elapsed = max(now - self._started, 1e-9)
            return {
                "window_s": self.window_s,
                "windows_completed": self.windows_completed,
                "cumulative": {
                    **{m: self._cum[m].summary() for m in SLO_METRICS
                       if self._cum[m].count},
                    "tokens": self._cum_tokens,
                    "tokens_per_s": round(self._cum_tokens / cum_elapsed,
                                          3),
                },
                "last_window": self._last_window,
                "recent_windows": list(self._recent),
                "current_window": {
                    **{m: self._win[m].summary() for m in SLO_METRICS
                       if self._win[m].count},
                    "tokens": self._win_tokens,
                    "elapsed_s": round(now - self._win_start, 6),
                },
            }

    def check_slo(self, targets):
        """targets: {"ttft_ms": {"p99": 200.0}, "itl_ms": {"p50": 20}}.

        For each (metric, quantile, target) computes, over the
        CUMULATIVE digest: the observed quantile, whether it meets the
        target, the fraction of mass over the target, and the SRE burn
        rate = frac_over / error_budget (budget = 1 - q; burn 1.0 means
        exactly spending the budget, > 1 means burning it down)."""
        checks = []
        ok = True
        for metric, qmap in targets.items():
            if metric not in self._cum:
                raise ValueError(
                    f"unknown SLO metric {metric!r} "
                    f"(know: {SLO_METRICS})")
            # digest() snapshots under the lock: quantile()/rank()
            # compress in place and must not race the worker's observe()
            d = self.digest(metric)
            for tag, target in qmap.items():
                q = _parse_qtag(tag)
                observed = d.quantile(q)
                if observed is None:
                    checks.append({"metric": metric, "quantile": tag,
                                   "target_ms": float(target),
                                   "observed_ms": None, "met": None,
                                   "frac_over": None, "burn_rate": None})
                    continue
                frac_over = 1.0 - d.rank(float(target))
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


# ---------------------------------------------------------------------------
# per-tenant cost attribution
# ---------------------------------------------------------------------------

class TenantLedger:
    """Per-tenant cost vectors + SLO digests, bounded cardinality.

    Requests carry an opaque ``tenant`` identity (``submit(tenant=)``,
    threaded engine→scheduler→telemetry); this ledger is where the
    costs they incur are attributed, using data that already exists on
    the request path: prefill/decode tokens, KV block-residency in
    block·iterations (blocks held x engine iterations held) and queue
    wait; the fleet router adds handoff_bytes, sheds and failovers
    (``count``). ``get_stats()["tenants"]`` and the ``/tenants`` endpoint
    serve the snapshot.

    Cardinality is bounded the exporter's way: beyond ``max_tenants``
    distinct identities, new tenants collapse into ``<other>`` (and
    the collapse is counted) — a tenant id is client-supplied input
    and must never grow unbounded label sets. ``None`` attributes to
    ``<anon>``, so un-tenanted traffic is still accounted.

    Latency digests (ttft/e2e per tenant, mergeable QuantileSketch)
    use a smaller default compression than the global SLOTracker:
    there are up to max_tenants × 2 of them per server."""

    ANON = "<anon>"
    OTHER = "<other>"
    #: per-tenant latency digests (per-token metrics stay global —
    #: a per-token per-tenant sketch add would bust the hot path)
    SLO = ("ttft_ms", "e2e_ms")

    def __init__(self, max_tenants=32, compression=64):
        self._max = max(1, int(max_tenants))
        self._compression = int(compression)
        self._lock = threading.Lock()
        self._t = {}                # tenant key -> cost dict
        self._slo = {}              # tenant key -> {metric: sketch}
        self.collapsed = 0
        reg = global_registry()
        self._m_requests = reg.counter(
            "serving.tenant.requests", _help("serving.tenant.requests"))
        self._m_tokens = reg.counter(
            "serving.tenant.generated_tokens",
            _help("serving.tenant.generated_tokens"))
        self._m_blocks = reg.counter(
            "serving.tenant.block_iterations",
            _help("serving.tenant.block_iterations"))
        self._m_sheds = reg.counter(
            "serving.tenant.sheds", _help("serving.tenant.sheds"))

    def _key_locked(self, tenant):
        key = self.ANON if tenant is None else str(tenant)
        if key not in self._t:
            if len(self._t) >= self._max and key != self.OTHER:
                self.collapsed += 1
                return self._key_locked(self.OTHER)
            self._t[key] = {"requests": 0, "prefill_tokens": 0,
                            "decode_tokens": 0, "block_iterations": 0,
                            "queue_wait_ms": 0.0, "handoff_bytes": 0,
                            "sheds": 0, "failovers": 0}
            self._slo[key] = {m: QuantileSketch(self._compression)
                              for m in self.SLO}
        return key

    # -- write side ---------------------------------------------------------
    def finish(self, tenant, prefill_tokens=0, decode_tokens=0,
               block_iterations=0, queue_wait_ms=0.0):
        """One finished request's engine-side cost vector (every
        outcome — a cancelled request's prefill still cost flops)."""
        with self._lock:
            key = self._key_locked(tenant)
            c = self._t[key]
            c["requests"] += 1
            c["prefill_tokens"] += int(prefill_tokens)
            c["decode_tokens"] += int(decode_tokens)
            c["block_iterations"] += int(block_iterations)
            c["queue_wait_ms"] += float(queue_wait_ms)
        self._m_requests.labels(tenant=key).inc()
        self._m_requests.inc()
        if decode_tokens:
            self._m_tokens.labels(tenant=key).inc(int(decode_tokens))
            self._m_tokens.inc(int(decode_tokens))
        if block_iterations:
            self._m_blocks.labels(tenant=key).inc(int(block_iterations))
            self._m_blocks.inc(int(block_iterations))

    def observe(self, tenant, metric, value_ms):
        """One latency sample into the tenant's digest (SLO tuple)."""
        with self._lock:
            key = self._key_locked(tenant)
            self._slo[key][metric].add(float(value_ms))

    def count(self, tenant, kind, n=1):
        """Router-side cost events: sheds / failovers /
        handoff_bytes."""
        with self._lock:
            key = self._key_locked(tenant)
            self._t[key][kind] += n
        if kind == "sheds":
            self._m_sheds.labels(tenant=key).inc(n)
            self._m_sheds.inc(n)

    # -- read side ----------------------------------------------------------
    def digest(self, tenant, metric):
        """Mergeable COPY of one tenant digest (fleet aggregation)."""
        with self._lock:
            key = self.ANON if tenant is None else str(tenant)
            sk = self._slo.get(key)
            if sk is None:
                return QuantileSketch(self._compression)
            return QuantileSketch.from_dict(sk[metric].to_dict())

    def snapshot(self):
        with self._lock:
            tenants = {}
            for key in sorted(self._t):
                entry = dict(self._t[key],
                             queue_wait_ms=round(
                                 self._t[key]["queue_wait_ms"], 3))
                entry["slo"] = {m: self._slo[key][m].summary()
                                for m in self.SLO
                                if self._slo[key][m].count}
                tenants[key] = entry
            return {"max_tenants": self._max,
                    "collapsed": self.collapsed,
                    "tenants": tenants}


def aggregate_tenant_snapshots(snapshots):
    """Sum N TenantLedger.snapshot() payloads into one fleet view:
    scalar costs add; per-tenant SLO summary fields merge
    conservatively (count sums, min takes min, max/avg/quantiles take
    the worst replica — the honest cross-replica read without the raw
    sketches). The router's /tenants endpoint layers its own
    router-side costs (sheds/failovers/handoff_bytes) on top."""
    out = {"max_tenants": 0, "collapsed": 0, "tenants": {}}
    for snap in snapshots:
        if not snap:
            continue
        out["max_tenants"] = max(out["max_tenants"],
                                 snap.get("max_tenants", 0))
        out["collapsed"] += snap.get("collapsed", 0)
        for key, entry in snap.get("tenants", {}).items():
            agg = out["tenants"].setdefault(
                key, {"requests": 0, "prefill_tokens": 0,
                      "decode_tokens": 0, "block_iterations": 0,
                      "queue_wait_ms": 0.0, "handoff_bytes": 0,
                      "sheds": 0, "failovers": 0, "slo": {}})
            for k, v in entry.items():
                if k != "slo":
                    agg[k] = round(agg.get(k, 0) + v, 3)
                    continue
                for m, s in v.items():
                    cur = agg["slo"].setdefault(m, {})
                    for f, fv in s.items():
                        if fv is None:
                            continue
                        old = cur.get(f)
                        if old is None:
                            cur[f] = fv
                        elif f == "count":
                            cur[f] = round(old + fv, 6)
                        elif f == "min":
                            cur[f] = min(old, fv)
                        else:
                            cur[f] = max(old, fv)
    return out


# ---------------------------------------------------------------------------
# per-request lifecycle state
# ---------------------------------------------------------------------------

class _ReqTrace:
    __slots__ = ("rid", "sampled", "submit_perf", "admit_perf",
                 "admit_iteration", "slot", "chunks", "first_token_perf",
                 "first_token_iteration", "last_token_perf", "tokens",
                 "trace_id", "hop", "tenant", "blocks", "queue_wait_ms")

    def __init__(self, rid, sampled, submit_perf):
        self.rid = rid
        self.sampled = sampled
        self.submit_perf = submit_perf
        self.trace_id = None    # fleet trace correlation (router-minted
        self.hop = 0            # TraceContext; None outside a fleet)
        self.tenant = None      # cost-attribution identity
        self.blocks = 0         # KV blocks reserved at admission
        self.queue_wait_ms = 0.0
        self.admit_perf = None
        self.admit_iteration = None
        self.slot = None
        self.chunks = []            # [iteration, ntokens, t_start]
        self.first_token_perf = None
        self.first_token_iteration = None
        self.last_token_perf = None
        self.tokens = 0


class ServingTelemetry:
    """The engine/scheduler-facing facade: lifecycle hooks + SLO
    tracker + flight recorder. All hooks are cheap host bookkeeping and
    safe to call under the scheduler lock; span trees are emitted only
    at request end (and only while a trace capture is live)."""

    def __init__(self, clock=None, window_s=60.0, sample=None,
                 flight_capacity=256, flight_dir=None, deadline_storm=3,
                 compression=128, recorder=None, series_capacity=512,
                 max_tenants=32):
        self.mode, self.sample_rate = trace_request_mode(sample)
        self._clock = clock or time.monotonic
        self.slo = SLOTracker(clock=self._clock,
                              window_s=window_s, compression=compression)
        # the signal plane: per-iteration scalars + SLO window closes
        # land here as (t, value) points on the SAME injected clock;
        # series_capacity=0 switches the store off (the bench's
        # signals-off arm)
        self.series = (SeriesStore(capacity=series_capacity,
                                   label=self.slo.labels.get("server"))
                       if series_capacity else None)
        self.tenants = TenantLedger(max_tenants=max_tenants)
        self.flight = FlightRecorder(capacity=flight_capacity,
                                     out_dir=flight_dir)
        self.deadline_storm = max(1, int(deadline_storm))
        self._rec = recorder or get_recorder()
        self._req = {}
        self._lock = threading.Lock()
        self._iter_deadline_cancels = 0
        self._storm_latched = False
        self._traced_local = 0      # THIS instance's emitted trees (the
        #                             registry counter aggregates
        #                             process-wide across servers)
        reg = global_registry()
        self._m_queue_wait = reg.histogram(
            "serving.queue_wait_ms", _help("serving.queue_wait_ms"))
        self._m_e2e = reg.histogram("serving.e2e_ms",
                                    _help("serving.e2e_ms"))
        self._m_traced = reg.counter("serving.requests_traced",
                                     _help("serving.requests_traced"))
        self._m_faults = reg.counter("serving.faults",
                                     _help("serving.faults"))

    def set_recorder(self, recorder):
        """Re-point span-tree emission at a dedicated recorder (the
        fleet router gives every replica its own, so the merged
        Perfetto dump renders per-replica process groups,
        observability/fleet_trace.py)."""
        self._rec = recorder

    # -- sampling ----------------------------------------------------------
    def sampled(self, rid):
        if self.mode == "all":
            return True
        if self.mode == "off":
            return False
        return _rid_hash01(rid) < self.sample_rate

    # -- request lifecycle hooks (scheduler/engine) ------------------------
    def on_submit(self, rid, ctx=None, tenant=None):
        """`ctx` is a fleet TraceContext: its router-minted sampling
        verdict WINS over this engine's own mode — the decision is
        made once per request so every hop traces or none does (an
        engine re-hashing its replica-local rid, which changes on
        failover, would desync the hops)."""
        sampled = ctx.sampled if ctx is not None else self.sampled(rid)
        st = _ReqTrace(rid, sampled, time.perf_counter())
        if ctx is not None:
            st.trace_id = ctx.trace_id
            st.hop = ctx.hop
        st.tenant = tenant
        with self._lock:
            self._req[rid] = st

    def on_admit(self, rid, slot, iteration, queue_wait_ms, blocks=0):
        self._m_queue_wait.observe(queue_wait_ms)
        self.slo.observe("queue_wait_ms", queue_wait_ms)
        with self._lock:
            st = self._req.get(rid)
            if st is None:
                return
            st.admit_perf = time.perf_counter()
            st.admit_iteration = iteration
            st.slot = slot
            st.blocks = int(blocks)
            st.queue_wait_ms = float(queue_wait_ms)

    def on_prefill_chunk(self, rid, iteration, ntokens):
        # lock-free: dict.get is GIL-atomic and every mutation of an
        # existing _ReqTrace happens on the engine thread (on_submit
        # inserts the rid from the client thread BEFORE it is enqueued,
        # so the engine can never see a half-built entry)
        st = self._req.get(rid)
        if st is None:
            return
        st.chunks.append([iteration, int(ntokens), time.perf_counter()])

    def on_first_token(self, rid, iteration, ttft_ms):
        self.slo.observe_token("ttft_ms", ttft_ms)
        st = self._req.get(rid)     # lock-free: see on_prefill_chunk
        if st is None:
            return
        st.first_token_perf = st.last_token_perf = time.perf_counter()
        st.first_token_iteration = iteration
        st.tokens += 1
        self.tenants.observe(st.tenant, "ttft_ms", ttft_ms)

    def on_token(self, rid, iteration, itl_ms):
        self.slo.observe_token("itl_ms", itl_ms)
        st = self._req.get(rid)     # lock-free: see on_prefill_chunk
        if st is not None:
            st.last_token_perf = time.perf_counter()
            st.tokens += 1

    def on_deadline_cancel(self, rid, iteration):
        # no lock: iteration-scoped counter, engine-thread only (reset
        # in begin_iteration, incremented from _fail during the same
        # thread's plan(), read in end_iteration)
        self._iter_deadline_cancels += 1

    def on_finish(self, rid, iteration, outcome, reason=None, e2e_ms=None,
                  prompt_len=None, generated=None):
        """outcome: 'retire' | 'cancel' | 'deadline'. Emits the span
        tree for sampled requests and drops the per-request state."""
        if outcome == "retire" and e2e_ms is not None:
            self._m_e2e.observe(e2e_ms)
            self.slo.observe("e2e_ms", e2e_ms)
        with self._lock:
            st = self._req.pop(rid, None)
        if st is None:
            return
        # tenant cost attribution happens for EVERY finished request
        # (a cancelled request's prefill still cost flops), regardless
        # of the trace-sampling verdict
        iters = (max(int(iteration) - int(st.admit_iteration) + 1, 1)
                 if st.admit_iteration is not None else 0)
        self.tenants.finish(
            st.tenant,
            prefill_tokens=sum(c[1] for c in st.chunks),
            decode_tokens=st.tokens,
            block_iterations=st.blocks * iters,
            queue_wait_ms=st.queue_wait_ms)
        if outcome == "retire" and e2e_ms is not None:
            self.tenants.observe(st.tenant, "e2e_ms", e2e_ms)
        if not st.sampled or not self._rec.enabled:
            return
        self._emit_tree(st, iteration, outcome, reason, prompt_len,
                        generated)
        self._m_traced.inc()
        with self._lock:
            self._traced_local += 1

    # -- span-tree emission ------------------------------------------------
    def _emit_tree(self, st, end_iteration, outcome, reason, prompt_len,
                   generated):
        rec = self._rec
        end = time.perf_counter()
        track = (f"serving slot {st.slot}" if st.slot is not None
                 else "serving queue")
        # fleet correlation rides EVERY span of the tree: the merged
        # fleet dump is queried by trace_id, and a child span must be
        # attributable without walking back to its root
        base = {"rid": st.rid}
        if st.trace_id is not None:
            base["trace_id"] = st.trace_id
            base["hop"] = st.hop
        root_args = dict(base, outcome=outcome, finish_reason=reason,
                         prompt_len=prompt_len, generated=generated,
                         admit_iteration=st.admit_iteration,
                         end_iteration=end_iteration, slot=st.slot)
        rec.complete(f"request {st.rid}", st.submit_perf, end,
                     cat="serving.request", args=root_args, track=track)
        queue_end = st.admit_perf if st.admit_perf is not None else end
        rec.complete("queue", st.submit_perf, queue_end,
                     cat="serving.request", args=dict(base),
                     track=track)
        # prefill chunks: each closes where the next one opens; the last
        # closes at the first token (or the end, if cut short)
        for i, (it, ntok, t0) in enumerate(st.chunks):
            if i + 1 < len(st.chunks):
                t1 = st.chunks[i + 1][2]
            elif st.first_token_perf is not None:
                t1 = st.first_token_perf
            else:
                t1 = end
            rec.complete("prefill.chunk", t0, t1, cat="serving.request",
                         args=dict(base, iteration=it, tokens=ntok),
                         track=track)
        if st.first_token_perf is not None:
            rec.complete(
                "decode", st.first_token_perf,
                st.last_token_perf or end, cat="serving.request",
                args=dict(base, tokens=st.tokens,
                          first_token_iteration=st.first_token_iteration),
                track=track)
        rec.instant(outcome, cat="serving.request",
                    args=dict(base, iteration=end_iteration),
                    ts=end, track=track)

    # -- engine iteration bracketing --------------------------------------
    def begin_iteration(self, iteration):
        self._iter_deadline_cancels = 0     # engine-thread only

    def end_iteration(self, iteration, values=None, **flight_fields):
        """Record the iteration into the flight ring, roll the SLO
        window, and detect deadline storms. Returns a flight-dump path
        when a storm fired (None otherwise).

        Hot path: `values` is a tuple of the first len(ITER_FIELDS)-1
        fields in ITER_FIELDS order (deadline_cancels is appended
        here) — no per-iteration dicts. Keyword fields are the
        readable fallback for cold callers."""
        cancels = self._iter_deadline_cancels
        if values is not None:
            self.flight.record_iteration(iteration, values + (cancels,))
        else:
            flight_fields["deadline_cancels"] = cancels
            # the **flight_fields kwargs dict is fresh per call; adopt
            # it as the flight entry instead of repacking it
            self.flight.record_fields(iteration, flight_fields)
        rolled = self.slo.maybe_roll()
        if self.series is not None:
            if values is not None:
                step_ms, qd = values[0], values[6]
                slots, in_use = values[7], values[9]
            else:
                step_ms = flight_fields.get("step_ms", 0.0)
                qd = flight_fields.get("queue_depth", 0)
                slots = flight_fields.get("active_slots", 0)
                in_use = flight_fields.get("blocks_in_use", 0)
            self.series.observe_many(
                self._clock(),
                (("engine.step_ms", step_ms),
                 ("engine.queue_depth", qd),
                 ("engine.active_slots", slots),
                 ("engine.blocks_in_use", in_use)))
            if rolled:
                self._series_window_close()
        if cancels >= self.deadline_storm:
            if self._storm_latched:
                return None
            self._storm_latched = True
            return self.fault(iteration, "deadline_storm",
                              {"deadline_cancels": cancels,
                               "threshold": self.deadline_storm})
        self._storm_latched = False
        return None

    def _series_window_close(self):
        """Feed the just-closed SLO window into the series store (the
        recent-windows deque is the source): one
        point per published quantile plus the window throughput, all
        stamped at the window's close time."""
        w = self.slo.snapshot()["recent_windows"][-1]
        t = w["closed_at"]
        pts = [("slo.tokens_per_s", w["tokens_per_s"])]
        for m in SLO_METRICS:
            s = w.get(m)
            if not s:
                continue
            for tag in ("p50", "p90", "p99"):
                if s.get(tag) is not None:
                    pts.append((f"slo.{m}.{tag}", s[tag]))
        self.series.observe_many(t, pts)

    def fault(self, step, kind, detail=None):
        """Mark the newest flight entry with the fault and dump the
        ring. Returns the dump path."""
        self._m_faults.inc()
        self.flight.annotate_last(fault={"kind": kind,
                                         "detail": _jsonable(detail or {})})
        return self.flight.dump(kind, step=step, extra=detail)

    # -- introspection -----------------------------------------------------
    def stats(self):
        out = self.slo.snapshot()
        out["server"] = self.slo.labels.get("server")
        out["trace_requests"] = {
            "mode": self.mode, "rate": self.sample_rate,
            "traced": self._traced_local}
        out["flight"] = {"capacity": self.flight.capacity,
                         "entries": len(self.flight),
                         "dumps": list(self.flight.dump_paths)}
        out["series"] = (None if self.series is None else
                         {"capacity": self.series.capacity,
                          "names": len(self.series.names()),
                          "points": self.series._points_total})
        return out

    def check_slo(self, targets):
        return self.slo.check_slo(targets)

    def close(self):
        """Retire this instance's gauge series (called by the engine's
        close(); counters/histograms aggregate globally and stay)."""
        self.slo.drop_gauges()
