"""Self-healing fleet supervision: watchdog, resurrection, quarantine.

The fleet front door (serving/router.py) survives a replica death only
by SHRINKING: killed replicas never come back, a replica that *hangs*
(stuck engine iteration — no death, no failed future, nothing raises)
is never detected, and a request whose replay deterministically faults
the engine is re-admitted on survivor after survivor until the whole
fleet is gone. This module is the missing control loop: a fleet is
defined by what it survives. Counterpart of
``paddle_tpu/robustness/supervisor.py``, kept as the port's own copy
(host-side; its spawn functions build the port's engines, which run
the paged attention kernel on the card).

Three mechanisms, one heartbeat (``FleetSupervisor.on_heartbeat``,
driven by ``FleetRouter.step()`` — so the whole tier runs under the
injected serving clock, with zero wall-clock dependence):

- **Watchdog** — per-replica progress marks (``Replica.progress_mark``:
  scheduler iteration + token/admission counters, pure counter reads).
  A replica with work whose mark is frozen for ``hang_heartbeats``
  consecutive heartbeats is declared HUNG: torn down like a death
  (its stream registrations drain — the dead engine is never pumped
  again, so no late token can reach a client), its in-flight requests
  re-admitted bitwise on survivors by the router's failover path. A
  replica whose pumps run but take longer than ``slow_ms`` is labeled
  ``slow`` (surfaced in health/stats — an operator signal, not a
  teardown: slow is a capacity problem, hung is a correctness one).
  Dead replicas (kill, engine fault) are picked up the same heartbeat.

- **Resurrection** — a failed replica slot is respawned through
  ``spawn_fn(index)`` under a crash-loop circuit breaker: exponential
  backoff measured in heartbeats (``backoff_heartbeats`` ·
  ``backoff_factor``^failures), a half-open PROBE request served
  end-to-end before the replica rejoins rotation, and permanent
  eviction after ``max_crash_loops`` consecutive failures (a failed
  spawn/probe, or a resurrected replica dying again before retiring a
  single request). ``make_checkpoint_spawn`` builds a spawn_fn that
  reloads weights through robustness/checkpoint_manager.py (newest
  valid checkpoint, CRC-validated, walking back past corrupt ones).
  Before rejoining, the new replica's prefix cache is RE-WARMED from
  the router's fleet-wide ``ChunkPopularityDigest`` — the most popular
  prompt chains re-prefill into its index, so a resurrected replica
  rejoins near its pre-death hit rate instead of cold.

- **Quarantine** (lives in the router; this module owns the error) —
  the router tracks per-request failover lineage; a request implicated
  in ``poison_threshold`` (default 2) replica deaths is failed with a
  structured ``PoisonRequestError`` and recorded in the fleet flight
  recorder instead of cascading onward.

Everything is deterministic: heartbeats are router iterations, backoff
is heartbeat counts, probes and warm-ups pump manual-drive engines
synchronously. Metrics are ``serving.fleet.{hangs,resurrections,crash_loops,
quarantines}``.
"""

import numpy as np

__all__ = ["FleetSupervisor", "SupervisorConfig", "PoisonRequestError",
           "ChunkPopularityDigest", "make_checkpoint_spawn",
           "Autoscaler", "AutoscalerConfig"]


class PoisonRequestError(RuntimeError):
    """The router quarantined this request: its failover lineage
    implicates it in `deaths` replica deaths (engine faults naming its
    lane), so re-admitting it again would predictably kill another
    replica. `lineage` lists the deaths it was present for (replica
    name + kind), `attempts` the failovers it consumed, `flight_dump`
    the fleet flight-recorder artifact written at quarantine time."""

    def __init__(self, message, request_id, lineage, attempts,
                 flight_dump=None):
        super().__init__(message)
        self.request_id = request_id
        self.lineage = list(lineage)
        self.deaths = sum(1 for d in self.lineage if d.get("implicated"))
        self.attempts = attempts
        self.flight_dump = flight_dump


class ChunkPopularityDigest:
    """Fleet-wide chunk popularity, kept by the router: chain key ->
    (parent key, chunk tokens, hit count). Fed on every submit from
    the prompt's chain keys (the same blake2b chain the per-replica
    prefix indexes use), consumed by resurrection to re-warm a fresh
    replica's cache with the prompts the FLEET actually serves —
    popularity survives any single replica's death because it lives
    here, not in the dead index.

    Bounded: past `max_entries` the least-popular entries are dropped;
    a chain whose ancestor was dropped reconstructs to None and is
    skipped at warm time (re-warm is best-effort by design)."""

    def __init__(self, max_entries=512):
        self.max_entries = int(max_entries)
        self._entries = {}          # key -> [parent, tokens, hits]

    def observe(self, keys, prompt, block_size):
        """Record one routed prompt's full chunks."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        parent = None
        for i, key in enumerate(keys):
            e = self._entries.get(key)
            if e is None:
                self._entries[key] = [
                    parent, np.array(
                        prompt[i * block_size:(i + 1) * block_size],
                        np.int32, copy=True), 1]
            else:
                e[2] += 1
            parent = key
        if len(self._entries) > self.max_entries:
            self._shrink()

    def _shrink(self):
        keep = sorted(self._entries.items(),
                      key=lambda kv: kv[1][2],
                      reverse=True)[:self.max_entries]
        self._entries = dict(keep)

    def forget(self, keys):
        """Drop these chain keys (the router calls this when a request
        is QUARANTINED: re-warming a resurrected replica with the very
        prompt whose replay faults engines would re-enter the cascade
        through the healing path). Descendants that survive reconstruct
        to None once an ancestor is gone and are skipped at warm
        time."""
        for key in keys:
            self._entries.pop(key, None)

    def prompt_for(self, key):
        """Reconstruct the full token prefix ending at chain `key` by
        walking parents to the root; None when the chain is broken
        (an ancestor was shrunk away)."""
        chunks = []
        while key is not None:
            e = self._entries.get(key)
            if e is None:
                return None
            chunks.append(e[1])
            key = e[0]
        return np.concatenate(list(reversed(chunks)))

    def top_chains(self, n):
        """The `n` most popular chain endpoints, deepest-first within
        a chain (a taken key covers all its ancestors, so they are
        skipped — warming the deepest chunk warms the whole prefix)."""
        parents = {e[0] for e in self._entries.values()
                   if e[0] is not None}
        ranked = sorted(self._entries.items(),
                        key=lambda kv: (kv[1][2], kv[0]), reverse=True)
        taken, covered = [], set()
        for key, _e in ranked:
            if key in covered:
                continue
            # prefer leaves; an interior key only if no descendant of
            # it was (or will be) taken — approximated by skipping
            # keys that are parents of a live entry with >= its hits
            if key in parents:
                continue
            taken.append(key)
            walk = key
            while walk is not None:
                covered.add(walk)
                walk = self._entries[walk][0] \
                    if walk in self._entries else None
            if len(taken) >= n:
                break
        if len(taken) < n:
            # chains may be all-interior after a shrink: top up with
            # the most popular uncovered keys of any shape
            for key, _e in ranked:
                if key not in covered:
                    taken.append(key)
                    covered.add(key)
                    if len(taken) >= n:
                        break
        return taken

    def __len__(self):
        return len(self._entries)

    def stats(self):
        return {"entries": len(self._entries),
                "max_entries": self.max_entries}


class SupervisorConfig:
    """Tuning knobs for FleetSupervisor:

    - hang_heartbeats: consecutive no-progress heartbeats (with work
      pending) before a replica is declared hung and torn down.
    - slow_ms: pump-time EMA above which a replica is labeled `slow`
      (None disables the classification).
    - resurrect: respawn failed replicas (needs the router's spawn_fn).
    - backoff_heartbeats / backoff_factor: crash-loop circuit breaker
      delay = backoff_heartbeats * backoff_factor**failures, in
      heartbeats (deterministic under injected clocks).
    - max_crash_loops: consecutive failed resurrections (or
      die-before-serving relapses) before the slot is PERMANENTLY
      evicted.
    - probe_tokens / probe_timeout_s: the half-open probe request a
      respawned engine must serve end-to-end before rejoining.
    - warm_chains: how many popular prompt chains to re-prefill into
      the resurrected replica's prefix cache (0 disables re-warm).
    """

    def __init__(self, hang_heartbeats=3, slow_ms=None, resurrect=True,
                 backoff_heartbeats=2, backoff_factor=2.0,
                 max_crash_loops=3, probe_tokens=2, probe_timeout_s=30.0,
                 warm_chains=8):
        if hang_heartbeats < 1:
            raise ValueError("hang_heartbeats must be >= 1")
        if max_crash_loops < 1:
            raise ValueError("max_crash_loops must be >= 1")
        self.hang_heartbeats = int(hang_heartbeats)
        self.slow_ms = None if slow_ms is None else float(slow_ms)
        self.resurrect = bool(resurrect)
        self.backoff_heartbeats = int(backoff_heartbeats)
        self.backoff_factor = float(backoff_factor)
        self.max_crash_loops = int(max_crash_loops)
        self.probe_tokens = int(probe_tokens)
        self.probe_timeout_s = float(probe_timeout_s)
        self.warm_chains = int(warm_chains)


class FleetSupervisor:
    """The router's self-healing control loop. Constructed by
    FleetRouter (``supervisor=True`` / ``SupervisorConfig(...)``) and
    driven by its step(): one on_heartbeat() per router iteration —
    plus idle ticks while any duty (a pending resurrection backoff)
    remains, so manual-drive ``run_until_idle`` keeps pumping until
    the fleet is back at strength."""

    def __init__(self, router, config=None):
        self.router = router
        self.config = config or SupervisorConfig()
        self.heartbeat = 0
        self._watch = {}        # index -> [last mark, stale count]
        self._breaker = {}      # index -> breaker dict
        self.counts = {"hangs": 0, "resurrections": 0, "crash_loops": 0,
                       "evictions": 0, "slow_flags": 0, "probes": 0,
                       "warm_prompts": 0}

    # -- heartbeat ---------------------------------------------------------
    def on_heartbeat(self):
        """One supervision pass over every replica slot. Returns True
        when the supervisor acted or still owes work (a backoff timer
        pending) — the router's step() treats that as fleet activity."""
        self.heartbeat += 1
        did = False
        for r in list(self.router._replicas):
            if r.state in ("evicted", "drained"):
                continue
            if not r.alive():
                did = self._supervise_dead(r) or did
                continue
            # a previously-resurrected replica that has now served
            # CLIENT traffic (retired anything beyond its own probe +
            # warm-up requests — the adoption baseline) closes its
            # crash-loop window
            b = self._breaker.get(r.index)
            if b and b["failures"] and r.generation > 0 and \
                    r.server._sched.counts["retired"] > \
                    b.get("adopted_retired", 0):
                b["failures"] = 0
            did = self._watchdog(r) or did
        return did

    def _watchdog(self, r):
        cfg = self.config
        mark = r.progress_mark()
        w = self._watch.setdefault(r.index, [mark, 0])
        if r.server._sched.has_work() and mark == w[0]:
            w[1] += 1
            if w[1] >= cfg.hang_heartbeats:
                w[0], w[1] = mark, 0
                self.counts["hangs"] += 1
                self.router._declare_hung(r.index)
                return True
        else:
            w[0], w[1] = mark, 0
        if cfg.slow_ms is not None and r.step_ms_ema is not None:
            verdict = "slow" if r.step_ms_ema > cfg.slow_ms else "ok"
            if verdict == "slow" and r.condition != "slow":
                self.counts["slow_flags"] += 1
            r.condition = verdict
        return False

    # -- resurrection ------------------------------------------------------
    def _supervise_dead(self, r):
        if not self.config.resurrect or self.router.spawn_fn is None:
            return False
        b = self._breaker.get(r.index)
        if b is None:
            b = {"failures": 0, "retry_at": 0, "relapse_gen": None}
            self._breaker[r.index] = b
        # a resurrected replica that died again before retiring a
        # single CLIENT request (beyond its own probe/warm-up — the
        # adoption baseline) is a crash-loop relapse — count it once
        # per generation, toward permanent eviction
        if r.generation > 0 and b["relapse_gen"] != r.generation and \
                r.server._sched.counts["retired"] <= \
                b.get("adopted_retired", 0):
            b["relapse_gen"] = r.generation
            self._crash_loop(r, b, "died before serving any request")
            if r.state == "evicted":
                return False
        if b["retry_at"] == 0:
            b["retry_at"] = self.heartbeat + self._backoff(b["failures"])
            return True
        if self.heartbeat < b["retry_at"]:
            return True     # duty pending: keep the router stepping
        b["retry_at"] = 0
        self._attempt_resurrection(r, b)
        return True

    def _backoff(self, failures):
        return max(1, round(self.config.backoff_heartbeats
                            * self.config.backoff_factor ** failures))

    def _crash_loop(self, r, b, why):
        b["failures"] += 1
        self.counts["crash_loops"] += 1
        self.router._count_fleet("crash_loops")
        self.router._flight_event(
            "crash_loop", replica=r.name, failures=b["failures"],
            why=why)
        if b["failures"] >= self.config.max_crash_loops:
            r.state = "evicted"
            self.counts["evictions"] += 1
            self.router._flight_event(
                "replica_evicted", replica=r.name,
                crash_loops=b["failures"])
            self.router._publish_gauges()

    def _attempt_resurrection(self, r, b):
        router = self.router
        try:
            server = router.spawn_fn(r.index)
        except Exception as e:      # noqa: BLE001 — spawn is user code
            self._crash_loop(r, b, f"spawn_fn raised: {e!r}")
            return
        try:
            if server.block_size != router._block_size:
                raise ValueError(
                    f"spawn_fn returned block_size "
                    f"{server.block_size}, fleet uses "
                    f"{router._block_size} (affinity keys chunk by it)")
            self._probe(server)
            self._warm(server)
        except Exception as e:      # noqa: BLE001 — half-open probe:
            #                         ANY failure re-opens the breaker
            try:
                server.close(drain=False)
            except Exception:       # noqa: BLE001
                pass
            self._crash_loop(r, b, f"probe/warm failed: {e!r}")
            return
        router._adopt_replica(r.index, server,
                              generation=r.generation + 1)
        self._watch.pop(r.index, None)
        b["relapse_gen"] = None
        # relapse baseline: retirements at adoption are the probe +
        # warm-ups, not client traffic
        b["adopted_retired"] = server._sched.counts["retired"]
        self.counts["resurrections"] += 1
        router._count_fleet("resurrections")
        router._flight_event(
            "resurrection", replica=r.name,
            generation=r.generation + 1,
            warmed_chains=min(self.config.warm_chains,
                              len(router._digest)))

    def _probe(self, server):
        """Half-open probe: the respawned engine must serve ONE real
        request end-to-end before any client traffic routes to it."""
        cfg = self.config
        prompt = self._probe_prompt()
        fut = server.submit(prompt, max_new_tokens=cfg.probe_tokens)
        self._pump(server, [fut])
        fut.result(timeout=cfg.probe_timeout_s)
        self.counts["probes"] += 1

    def _probe_prompt(self):
        """The most popular cached chain doubles as the probe payload
        (it exercises the exact path production traffic will); with an
        empty digest, a minimal token-0 prompt."""
        digest = self.router._digest
        for key in digest.top_chains(1):
            p = digest.prompt_for(key)
            if p is not None:
                return p
        return np.zeros(2, np.int32)

    def _warm(self, server):
        """Prefix re-warm: re-prefill the fleet's most popular prompt
        chains into the fresh replica's index BEFORE it rejoins, so
        affinity routing finds it warm. Best-effort: a chain that no
        longer fits (or was shrunk out of the digest) is skipped."""
        cfg = self.config
        if cfg.warm_chains <= 0 or server._prefix is None:
            return
        futs = []
        for key in self.router._digest.top_chains(cfg.warm_chains):
            prompt = self.router._digest.prompt_for(key)
            if prompt is None:
                continue
            try:
                futs.append(server.submit(prompt, max_new_tokens=1))
            except (ValueError, RuntimeError):
                continue    # too big for this pool / raced a close
        self._pump(server, futs)
        done = 0
        for f in futs:
            f.result(timeout=cfg.probe_timeout_s)
            done += 1
        self.counts["warm_prompts"] += done

    @staticmethod
    def _pump(server, futs):
        """Drive a not-yet-adopted server: manual-drive engines are
        pumped synchronously (deterministic tier); worker-threaded
        engines drain on their own and the caller waits on futures."""
        if server._worker is None:
            server.run_until_idle()

    def stats(self):
        return {
            "heartbeat": self.heartbeat,
            "config": {
                "hang_heartbeats": self.config.hang_heartbeats,
                "slow_ms": self.config.slow_ms,
                "max_crash_loops": self.config.max_crash_loops,
                "backoff_heartbeats": self.config.backoff_heartbeats,
                "warm_chains": self.config.warm_chains,
            },
            "breaker": {
                i: {"failures": b["failures"],
                    "retry_at_heartbeat": b["retry_at"] or None}
                for i, b in self._breaker.items()},
            **dict(self.counts),
        }


class AutoscalerConfig:
    """Tuning knobs for the SLO-driven Autoscaler:

    - min_replicas / max_replicas: hard fleet-size bounds; the
      controller never drains below the floor or spawns past the
      ceiling, no matter what the burn series says.
    - targets: check_slo's shape ({"ttft_ms": {"p95": 250.0}, ...}) —
      the SLOs whose windowed burn rates drive scaling. The router
      folds these into its ``slo.window_burn.<metric>.<qtag>`` series
      sampling, so an autoscaled fleet needs no AdmissionPolicy for
      the series to exist.
    - up_threshold / down_threshold: burn-rate hysteresis band. Above
      up_threshold the error budget is actively burning (scale up);
      below down_threshold the fleet is comfortably over-provisioned
      (scale down); in between, hold. up > down is enforced — a
      touching band would oscillate.
    - up_samples / down_samples: consecutive NEW burn samples past the
      threshold before acting. Scale-up-fast / scale-down-slow is
      expressed here: the defaults react to 2 bad samples but demand 6
      calm ones — adding capacity late costs user latency, removing it
      early costs a re-spawn (and its cold caches) minutes later.
    - cooldown_heartbeats: router heartbeats to hold after ANY scale
      action before considering another — the new replica's effect
      must reach the burn series before the controller trusts it.

    Deterministic like everything in this module: samples are counted
    by series-point arrival (the router's injected signals clock), the
    cooldown in router heartbeats — no wall clocks."""

    def __init__(self, min_replicas=1, max_replicas=4, targets=None,
                 up_threshold=1.0, down_threshold=0.25,
                 up_samples=2, down_samples=6, cooldown_heartbeats=8):
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if max_replicas < min_replicas:
            raise ValueError(
                f"max_replicas ({max_replicas}) must be >= "
                f"min_replicas ({min_replicas})")
        if not (up_threshold > down_threshold):
            raise ValueError(
                f"up_threshold ({up_threshold}) must exceed "
                f"down_threshold ({down_threshold}) — the hysteresis "
                f"band is what stops flapping")
        if up_samples < 1 or down_samples < 1:
            raise ValueError("up_samples/down_samples must be >= 1")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.targets = ({m: dict(q) for m, q in targets.items()}
                        if targets else {"ttft_ms": {"p95": 250.0}})
        self.up_threshold = float(up_threshold)
        self.down_threshold = float(down_threshold)
        self.up_samples = int(up_samples)
        self.down_samples = int(down_samples)
        self.cooldown_heartbeats = int(cooldown_heartbeats)


class Autoscaler:
    """SLO-driven fleet sizing: spawn and retire replica slots from
    the live windowed burn-rate series, with the crash-loop breaker
    as the safety rail.

    Constructed by FleetRouter (``autoscale=True`` /
    ``AutoscalerConfig(...)``) and driven by its step(): one
    on_heartbeat() per router iteration, exactly like the supervisor.
    The controller reads the fleet's ``slo.window_burn.<metric>.
    <qtag>`` series (the fleet health signals' ~2-window rolling
    view that decays after recovery, so a scale-up it causes can
    actually register as relief). Streaks count NEW series points,
    not heartbeats: idle heartbeats between signal samples neither
    age the evidence nor fake more of it.

    The safety rail: while any crash-loop breaker entry is open, any
    slot is permanently evicted, or any death is still awaiting
    resurrection, scale-ups are BLOCKED (counted in
    ``serving.fleet.autoscale.blocked``). A crashing image makes its
    own burn rate terrible — survivors absorb its load — and an
    autoscaler without this rail would read that as demand and spawn
    the same broken image in a storm. Capacity problems get capacity;
    health problems stay the supervisor's.

    Scale-up goes through ``router.add_replica_slot()`` (spawn_fn +
    fleet-contract validation); scale-down drains the least-loaded
    accepting replica — its in-flight work finishes, then the
    router's step() closes it. Metrics:
    ``serving.fleet.autoscale.{scale_ups,scale_downs,blocked}`` and
    the ``serving.fleet.autoscale.desired`` gauge."""

    def __init__(self, router, config=None):
        from ..observability import _help
        from ..observability.metrics import global_registry
        self.router = router
        self.config = config or AutoscalerConfig()
        self.heartbeat = 0
        self.desired = None         # set from live count, first tick
        self._last_t = None         # newest burn sample consumed
        self._up_streak = 0
        self._down_streak = 0
        self._cooldown_until = 0
        self.counts = {"scale_ups": 0, "scale_downs": 0, "blocked": 0,
                       "spawn_failures": 0, "samples": 0}
        reg = global_registry()
        self._m_ups = reg.counter(
            "serving.fleet.autoscale.scale_ups",
            _help("serving.fleet.autoscale.scale_ups"))
        self._m_downs = reg.counter(
            "serving.fleet.autoscale.scale_downs",
            _help("serving.fleet.autoscale.scale_downs"))
        self._m_blocked = reg.counter(
            "serving.fleet.autoscale.blocked",
            _help("serving.fleet.autoscale.blocked"))
        self._g_desired = reg.gauge(
            "serving.fleet.autoscale.desired",
            _help("serving.fleet.autoscale.desired"))

    # -- heartbeat ---------------------------------------------------------
    def on_heartbeat(self):
        """One control pass. Returns True when the fleet size changed
        (the router's step() treats that as activity)."""
        self.heartbeat += 1
        router = self.router
        live = [r for r in router._replicas if r.accepting()]
        if self.desired is None:
            self.desired = len(live)
        self._g_desired.labels(router=router.name).set(self.desired)
        point = self._worst_burn()
        if point is not None:
            t, worst = point
            if t != self._last_t:       # a NEW sample — fresh evidence
                self._last_t = t
                self.counts["samples"] += 1
                cfg = self.config
                if worst > cfg.up_threshold:
                    self._up_streak += 1
                    self._down_streak = 0
                elif worst < cfg.down_threshold:
                    self._down_streak += 1
                    self._up_streak = 0
                else:                   # inside the hysteresis band
                    self._up_streak = self._down_streak = 0
        if self.heartbeat < self._cooldown_until:
            return False
        cfg = self.config
        if self._up_streak >= cfg.up_samples:
            return self._try_scale_up(live)
        if self._down_streak >= cfg.down_samples:
            return self._try_scale_down(live)
        return False

    def _worst_burn(self):
        """The newest value across every configured burn series, as
        (t, worst); None before the first sample lands. Worst-of is
        the right fold: one breached SLO is a capacity problem even
        while the others are green."""
        store = getattr(self.router._signals, "fleet", None)
        if store is None:
            return None
        newest_t = worst = None
        for metric, qmap in self.config.targets.items():
            for tag in qmap:
                p = store.latest(f"slo.window_burn.{metric}.{tag}")
                if p is None:
                    continue
                t, v = p
                if newest_t is None or t > newest_t:
                    newest_t = t
                if worst is None or v > worst:
                    worst = v
        if newest_t is None:
            return None
        return (newest_t, worst)

    def _rail_open(self):
        """True while scale-ups must be blocked: an open crash-loop
        breaker entry, a permanently evicted slot, or a death still
        awaiting resurrection. All three mean the fleet is losing
        replicas to something a fresh spawn would inherit."""
        for r in self.router._replicas:
            if r.state == "evicted":
                return True
            if not r.alive() and r.state not in ("drained",):
                return True
        sup = self.router.supervisor
        if sup is not None:
            for b in sup._breaker.values():
                if b["failures"]:
                    return True
        return False

    def _try_scale_up(self, live):
        router = self.router
        if len(live) >= self.config.max_replicas:
            self._up_streak = 0     # at the ceiling: demand re-proves
            return False
        if self._rail_open():
            self.counts["blocked"] += 1
            self._m_blocked.inc()
            self._up_streak = 0
            router._flight_event(
                "scale_up_blocked", live=len(live),
                reason="crash-loop breaker / unresolved death")
            return False
        try:
            rep = router.add_replica_slot()
        except Exception as e:  # noqa: BLE001 — spawn_fn is user code
            self.counts["spawn_failures"] += 1
            self._up_streak = 0
            self._cooldown_until = (self.heartbeat
                                    + self.config.cooldown_heartbeats)
            router._flight_event("scale_up_failed", why=repr(e))
            return False
        self.counts["scale_ups"] += 1
        self._m_ups.inc()
        self.desired = len(live) + 1
        self._g_desired.labels(router=router.name).set(self.desired)
        self._up_streak = self._down_streak = 0
        self._cooldown_until = (self.heartbeat
                                + self.config.cooldown_heartbeats)
        router._flight_event("autoscale_up", replica=rep.name,
                             desired=self.desired)
        return True

    def _try_scale_down(self, live):
        router = self.router
        if len(live) <= self.config.min_replicas:
            self._down_streak = 0   # at the floor: calm re-proves
            return False
        # retire the least-loaded accepting replica: fewest in-flight
        # requests to finish, so the drain completes soonest
        victim = min(live, key=lambda r: r.load())
        router.drain_replica(victim.index)
        self.counts["scale_downs"] += 1
        self._m_downs.inc()
        self.desired = len(live) - 1
        self._g_desired.labels(router=router.name).set(self.desired)
        self._up_streak = self._down_streak = 0
        self._cooldown_until = (self.heartbeat
                                + self.config.cooldown_heartbeats)
        router._flight_event("autoscale_down", replica=victim.name,
                             desired=self.desired)
        return True

    def stats(self):
        return {
            "heartbeat": self.heartbeat,
            "desired": self.desired,
            "up_streak": self._up_streak,
            "down_streak": self._down_streak,
            "cooldown_until": self._cooldown_until or None,
            "rail_open": self._rail_open(),
            "config": {
                "min_replicas": self.config.min_replicas,
                "max_replicas": self.config.max_replicas,
                "targets": {m: dict(q) for m, q in
                            self.config.targets.items()},
                "up_threshold": self.config.up_threshold,
                "down_threshold": self.config.down_threshold,
                "up_samples": self.config.up_samples,
                "down_samples": self.config.down_samples,
                "cooldown_heartbeats": self.config.cooldown_heartbeats,
            },
            **dict(self.counts),
        }


def make_checkpoint_spawn(manager, cfg, scope_factory=None,
                          executor=None, **server_kwargs):
    """Build a resurrection ``spawn_fn`` that reloads model weights
    through a robustness.CheckpointManager: each call restores the
    newest VALID checkpoint (CRC-validated, walking back past corrupt
    candidates) into a fresh scope and builds a GenerationServer over
    it, the serving twin of a trainer's rollback-restore.

        manager = CheckpointManager(root, program=main_program)
        router = FleetRouter(servers, spawn_fn=make_checkpoint_spawn(
            manager, gpt_cfg, num_slots=4, start=False),
            supervisor=True)

    `server_kwargs` pass through to GenerationServer (start=False for
    manual-drive fleets); their `device` (None: the card) is where the
    checkpoint is restored and the model served. Raises
    CheckpointError/CheckpointCorruptError when no loadable checkpoint
    exists: the supervisor counts that as a crash-loop, exactly like a
    failed spawn."""
    from ..core.executor import Executor, Scope
    from ..core.place import CPUPlace, CUDAPlace
    from ..device import resolve_device
    from ..models.gpt import load_params
    from ..serving.engine import GenerationServer, GPTServingModel
    from .checkpoint_manager import CheckpointError

    device = resolve_device(server_kwargs.get("device"))

    def spawn(index):
        scope = (scope_factory or Scope)()
        exe = executor
        if exe is None:
            exe = Executor(CPUPlace() if device.type == "cpu"
                           else CUDAPlace(device.index or 0))
        meta = manager.restore(exe, scope=scope,
                               restore_step_counter=False)
        if meta is None:
            raise CheckpointError(
                f"resurrection of replica {index}: no checkpoint "
                f"under {manager.root}")
        model = GPTServingModel(load_params(scope, cfg), cfg,
                                device=device)
        return GenerationServer(model, **server_kwargs)

    return spawn
