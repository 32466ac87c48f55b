"""Deterministic fault injection for the serving engine's recovery paths.

Counterpart of the serving half of ``paddle_tpu/robustness/chaos.py``,
kept as the port's own copy. Every fault fires at an exact scheduler
iteration (or hash ordinal), never with a probability, so the chaos
tests stay deterministic: a cancel of the n-th oldest request, an
injected clock advance, a NaN written into a lane's first KV block
before the fused step (the non-finite guard must trip on real attention
arithmetic), forced prefix-cache evictions and host-tier spills, a named
request parked in the host tier, forced copy-on-write bursts on fork
groups, starved guided masks, forced content-hash collisions, and a
standing poison keyed to a prompt's bytes. The fleet's hooks fire at an
exact router iteration (a replica killed, hung or slowed; a worker
process SIGKILLed) or RPC ordinal (a dropped or timed-out connection).
The trainer's faults fire at an exact step: a grad poisoned at step k (by
NaN-ing a float feed entry before dispatch, so the real sentinel trips on
real arithmetic), a SIGTERM delivered at step k (the same flag a
PreemptionHandler's signal sets), and the Nth physical checkpoint write
failing (through io/checkpoint.py's write-fault hook, so the torn-file
handling runs on the real write path).
"""

import numpy as np

__all__ = ["ChaosInjector", "CheckpointWriteFault"]


class CheckpointWriteFault(OSError):
    """The injected checkpoint I/O failure (an OSError subclass, so the
    retry/backoff path treats it exactly like a real disk error)."""


class ChaosInjector:
    """One injector instance = one fault plan, consumed by a
    GuardedTrainer (`chaos=`) and/or installed into io.checkpoint
    (`install_io_faults()` / `with injector:`), by a
    GenerationServer (`chaos=`): its scheduler's plan() and its engine's
    step() pop the entries keyed to their iteration; a FleetRouter
    (`chaos=`) pops the fleet entries keyed to its own iteration, and an
    RpcClient built with it the connection faults keyed to its calls. `fired` counts the
    faults actually applied."""

    def __init__(self, seed=0):
        self._rng = np.random.default_rng(seed)
        # trainer plan (robustness/trainer.py hooks)
        self._poison_steps = {}      # step -> var name or None (any)
        self._sigterm_steps = set()
        self._fail_writes = set()    # 1-based physical-write ordinals
        self._write_count = 0
        self._installed = False
        self.fired = {"poison": 0, "sigterm": 0, "write_fault": 0,
                      "cancel": 0, "clock_advance": 0,
                      "serving_poison": 0, "evict": 0,
                      "hash_collision": 0, "prompt_poison": 0,
                      "spill": 0, "preempt": 0, "fork_storm": 0,
                      "mask_starve": 0, "replica_kill": 0,
                      "replica_hang": 0, "replica_slow": 0,
                      "process_kill": 0, "conn_drop": 0}
        # serving-engine plan: iteration -> actions (scheduler hooks)
        self._serving_cancels = {}   # iteration -> [active-request index]
        self._serving_poisons = {}   # iteration -> KV layer to NaN
        self._clock_advances = {}    # iteration -> seconds to advance
        self._fake_now_s = 0.0
        self._drives_clock = False
        # prefix-cache plan (serving/prefix_cache.py hooks)
        self._serving_evicts = {}    # iteration -> evictions to force
        # KV tier plan (serving/scheduler.py host-tier hooks)
        self._serving_spills = {}    # iteration -> spills to force
        self._serving_preempts = {}  # iteration -> [request id]
        self._collide_hashes = set()  # 1-based content-hash ordinals
        self._hash_count = 0
        self._prompt_poisons = []    # (np.int32 prompt, kv layer)
        # fleet plan (serving/router.py hooks)
        self._replica_kills = {}     # router iteration -> [replica idx]
        self._replica_hangs = {}     # router iteration -> [replica idx]
        self._replica_slow = {}      # replica idx -> ms per iteration
        self._slow_counted = set()   # replicas whose slow plan fired
        # out-of-process fleet plan (serving/router.py + transport.py)
        self._process_kills = {}     # router iteration -> [replica idx]
        self._conn_drops = {}        # 1-based rpc ordinal -> fault kind
        # fork-group plan (serving/scheduler.py + engine.py)
        self._fork_storms = {}       # iteration -> lanes to force-COW
        self._mask_starves = set()   # iterations to starve guided masks

    # -- trainer plan --------------------------------------------------
    def poison_grad_at(self, step, var=None):
        """NaN a float feed entry of dispatch `step` (0-based trainer
        step): the forward then produces a NaN loss and every grad goes
        NaN — the sentinel path from real arithmetic, not a mock. `var`
        pins which feed entry; default: the first float feed (stable
        iteration order)."""
        self._poison_steps[int(step)] = var
        return self

    def sigterm_at(self, step):
        """Request preemption just before dispatching `step`, through
        the same flag the installed signal handler sets."""
        self._sigterm_steps.add(int(step))
        return self

    def fail_checkpoint_write(self, nth=1, times=1):
        """Fail physical checkpoint writes nth..nth+times-1 (1-based,
        counted across every file the io.checkpoint writers touch while
        this injector is installed)."""
        for i in range(int(nth), int(nth) + int(times)):
            self._fail_writes.add(i)
        return self

    # -- io fault hook (io.checkpoint._WRITE_FAULT_HOOK) ---------------
    def install_io_faults(self):
        from ..io import checkpoint as ckpt_mod
        ckpt_mod.set_write_fault_hook(self._on_checkpoint_write)
        self._installed = True
        return self

    def uninstall_io_faults(self):
        from ..io import checkpoint as ckpt_mod
        ckpt_mod.set_write_fault_hook(None)
        self._installed = False

    def __enter__(self):
        return self.install_io_faults()

    def __exit__(self, *exc):
        self.uninstall_io_faults()
        return False

    def _on_checkpoint_write(self, kind, path):
        self._write_count += 1
        if self._write_count in self._fail_writes:
            self.fired["write_fault"] += 1
            raise CheckpointWriteFault(
                f"chaos: injected failure on checkpoint write "
                f"#{self._write_count} ({kind}: {path})")

    @property
    def write_count(self):
        return self._write_count

    # -- trainer hooks (robustness/trainer.py) -------------------------
    def should_preempt(self, step):
        if int(step) in self._sigterm_steps:
            self._sigterm_steps.discard(int(step))
            self.fired["sigterm"] += 1
            return True
        return False

    def on_dispatch(self, step, feed):
        """Return the (possibly poisoned) feed for dispatch `step`.
        Fires at most once per planned step — a replay after rollback
        gets the clean original."""
        var = self._poison_steps.pop(int(step), "*absent*")
        if var == "*absent*":
            return feed
        target = var
        if target is None:
            for k in sorted(feed):
                v = np.asarray(feed[k])
                if np.issubdtype(v.dtype, np.floating):
                    target = k
                    break
        if target is None or target not in feed:
            raise ValueError(
                f"chaos: no float feed entry to poison at step {step} "
                f"(feed keys: {sorted(feed)})")
        bad = np.array(np.asarray(feed[target]), copy=True)
        bad.ravel()[0] = np.nan
        self.fired["poison"] += 1
        out = dict(feed)
        out[target] = bad
        return out

    # -- serving hooks (serving/scheduler.py) --------------------------
    def cancel_request_at(self, iteration, index=0):
        """Cancel the index-th OLDEST active request at the start of
        scheduler iteration `iteration` (1-based, like the scheduler's
        own counter) — the deterministic mid-stream-cancel path for the
        continuous-batching engine."""
        self._serving_cancels.setdefault(int(iteration), []).append(
            int(index))
        return self

    def advance_clock_at(self, iteration, ms):
        """Advance the injected serving clock by `ms` at the start of
        iteration `iteration`. Pair with `serving_clock` as the
        scheduler's clock so deadline expiry is an exact iteration
        count, never a sleep."""
        self._clock_advances[int(iteration)] = \
            self._clock_advances.get(int(iteration), 0.0) + ms / 1e3
        self._drives_clock = True
        return self

    def tick_clock(self, ms):
        """Advance the injected serving clock NOW — the unconditional
        twin of advance_clock_at. A per-iteration plan pops each key
        ONCE, so a fleet whose engine population changes mid-run (an
        autoscaler spawning replicas whose fresh engines re-walk
        iteration numbers the plan already consumed) starves the
        clock; fleet tests tick it directly between requests
        instead."""
        self._fake_now_s += float(ms) / 1e3
        self._drives_clock = True
        self.fired["clock_advance"] += 1
        return self

    def serving_clock(self):
        """Deterministic clock (seconds) driven by advance_clock_at."""
        return self._fake_now_s

    def drives_clock(self):
        return self._drives_clock

    def on_serving_iteration(self, iteration):
        adv = self._clock_advances.pop(int(iteration), None)
        if adv is not None:
            self._fake_now_s += adv
            self.fired["clock_advance"] += 1

    def serving_cancels_at(self, iteration):
        idxs = self._serving_cancels.pop(int(iteration), [])
        self.fired["cancel"] += len(idxs)
        return idxs

    def poison_serving_at(self, iteration, layer=0):
        """NaN the first live KV block of the oldest active lane just
        before engine iteration `iteration` runs its fused step. The
        NaN flows through REAL attention arithmetic into that lane's
        logits, so the engine's non-finite guard trips on genuine
        propagation (flight-recorder dump + NonFiniteError), not a
        mocked output."""
        self._serving_poisons[int(iteration)] = int(layer)
        return self

    def serving_poison_at(self, iteration):
        """-> the KV layer to poison at this iteration, or None.
        Consumed by GenerationServer.step(). `fired` counts only when
        the engine reports the poison APPLIED (serving_poison_applied)
        — a step with no lane past position 0 defers to the next
        iteration instead of silently no-op'ing (a pos-0 lane's block
        is fully overwritten by its own prefill write, so the NaN
        could never propagate)."""
        return self._serving_poisons.pop(int(iteration), None)

    def serving_poison_applied(self):
        self.fired["serving_poison"] += 1

    # -- prefix-cache hooks (serving/prefix_cache.py) ------------------
    def evict_block_at(self, iteration, n=1):
        """Force `n` LRU prefix-cache evictions at the start of
        scheduler iteration `iteration` (1-based) — the deterministic
        eviction-under-pressure path, testable without streaming enough
        requests to actually exhaust the pool. Fires only for blocks
        that ARE evictable (idle leaf entries); a plan keyed to an
        iteration with nothing evictable is a no-op by design (tests
        arrange an idle entry first)."""
        self._serving_evicts[int(iteration)] = \
            self._serving_evicts.get(int(iteration), 0) + int(n)
        return self

    def serving_evictions_at(self, iteration):
        """-> number of forced evictions planned for this iteration.
        Consumed by the scheduler's plan(); `fired["evict"]` is counted
        by `serving_eviction_applied` only when a block was actually
        evicted."""
        return self._serving_evicts.pop(int(iteration), 0)

    def serving_eviction_applied(self):
        self.fired["evict"] += 1

    # -- KV tier hooks (serving/scheduler.py host tier) ----------------
    def spill_chain_at(self, iteration, n=1):
        """Force `n` prefix-chain spills (device->host evictions) at
        the start of scheduler iteration `iteration` (1-based) — the
        deterministic tiering path, testable without streaming enough
        requests to exhaust the device pool. Fires only when the
        eviction actually took the spill path (host tier attached,
        with space, and an idle leaf entry to take) — the plan is a
        no-op otherwise, exactly like evict_block_at."""
        self._serving_spills[int(iteration)] = \
            self._serving_spills.get(int(iteration), 0) + int(n)
        return self

    def serving_spills_at(self, iteration):
        """-> number of forced spills planned for this iteration.
        Consumed by the scheduler's plan(); `fired["spill"]` is counted
        by serving_spill_applied only when an eviction went
        device->host (destroy-evictions don't count)."""
        return self._serving_spills.pop(int(iteration), 0)

    def serving_spill_applied(self):
        self.fired["spill"] += 1

    def preempt_request_at(self, iteration, rid):
        """Park in-flight request `rid` in the host KV tier at the
        start of scheduler iteration `iteration` (1-based): its blocks
        swap out, its position/stream state stays queued, and the
        normal resume path swaps it back in when blocks free up (next
        iteration at the earliest — the park must span a real step).
        Fires only when `rid` was an active DECODE lane and the host
        pool held its blocks; no sleeps, injected-clock friendly."""
        self._serving_preempts.setdefault(int(iteration), []).append(
            rid)
        return self

    def serving_preempts_at(self, iteration):
        """-> request ids to preempt at this iteration. Consumed by
        the scheduler's plan(); `fired["preempt"]` counts via
        serving_preempt_applied only when a lane was actually parked."""
        return self._serving_preempts.pop(int(iteration), [])

    def serving_preempt_applied(self):
        self.fired["preempt"] += 1

    # -- fork-group hooks (serving/scheduler.py + engine.py) -----------
    def fork_storm_at(self, iteration, k=1):
        """Force copy-on-write divergence on up to `k` live fork-group
        lanes at the start of scheduler iteration `iteration` (1-based):
        each targeted lane's current block is COW'd even though nothing
        wrote it — the max-divergence burst path (every lane peels off
        the shared prompt at once), testable without arranging K real
        divergent writes. Fires (fork_storm_applied) only for lanes
        whose current block was actually copied — held followers,
        prefilling leaders, and lanes sitting on a NULL block are
        skipped by design."""
        self._fork_storms[int(iteration)] = \
            self._fork_storms.get(int(iteration), 0) + int(k)
        return self

    def fork_storms_at(self, iteration):
        """-> number of forced fork-COWs planned for this iteration.
        Consumed by the scheduler's plan(); `fired["fork_storm"]`
        counts via fork_storm_applied only for lanes actually COW'd."""
        return self._fork_storms.pop(int(iteration), 0)

    def fork_storm_applied(self, n=1):
        self.fired["fork_storm"] += int(n)

    def mask_starve_at(self, iteration):
        """Starve every guided-decoding lane's token mask at engine
        iteration `iteration` (1-based): the mask keeps exactly ONE
        allowed token (the lowest-id member of the constraint's allowed
        set), so generation stays conformant but the lane is forced
        down a single path — the degenerate-mask resilience path (the
        serving loop must keep stepping, never raise). Fires only when
        a guided lane was planned that iteration."""
        self._mask_starves.add(int(iteration))
        return self

    def mask_starves_at(self, iteration):
        """-> True if guided masks should be starved this iteration.
        Consumed by GenerationServer.step(); `fired["mask_starve"]`
        counts via mask_starve_applied only when a guided lane's mask
        was actually narrowed."""
        if int(iteration) in self._mask_starves:
            self._mask_starves.discard(int(iteration))
            return True
        return False

    def mask_starve_applied(self):
        self.fired["mask_starve"] += 1

    def hash_collision_at(self, nth, times=1):
        """Make content-hash computations nth..nth+times-1 (1-based,
        counted across every chunk the PrefixCacheIndex hashes while
        this injector is attached) return the COLLISION SENTINEL
        instead of the real hash. Two different chunks forced onto the
        sentinel collide in the index, and the token-verify fallback
        (collision -> miss, never another prompt's KV) is exercised on
        the real lookup path."""
        for i in range(int(nth), int(nth) + int(times)):
            self._collide_hashes.add(i)
        return self

    def prefix_hash_collides(self):
        self._hash_count += 1
        if self._hash_count in self._collide_hashes:
            self.fired["hash_collision"] += 1
            return True
        return False

    # -- fleet hooks (serving/router.py) -------------------------------
    def kill_replica_at(self, iteration, replica):
        """Kill fleet replica index `replica` at the START of router
        iteration `iteration` (1-based, the FleetRouter's own counter —
        a router iteration only counts when the fleet has work, so the
        plan is an exact point in the stream, never a wall-clock
        race). The kill is the real death path: the engine closes
        without drain, every in-flight future fails, and the router's
        failover re-admits them on survivors — mirroring
        poison_serving_at/evict_block_at, no sleeps anywhere."""
        self._replica_kills.setdefault(int(iteration), []).append(
            int(replica))
        return self

    def replica_kills_at(self, iteration):
        """-> replica indices to kill at this router iteration.
        Consumed by FleetRouter.step(); `fired["replica_kill"]` counts
        via replica_kill_applied only when a LIVE replica was actually
        torn down (a plan naming an already-dead replica is a no-op)."""
        return self._replica_kills.pop(int(iteration), [])

    def replica_kill_applied(self):
        self.fired["replica_kill"] += 1

    def hang_replica_at(self, iteration, replica):
        """Make fleet replica index `replica` HANG from the start of
        router iteration `iteration` (1-based): the router stops
        pumping its engine, so the replica stalls — queue and slots
        frozen mid-stream — WITHOUT dying. Nothing fails a future, so
        failover never triggers; only the supervisor's watchdog (stale
        progress marks across N heartbeats) can catch it. The hang is
        standing: it ends when the watchdog declares the replica hung
        and tears it down."""
        self._replica_hangs.setdefault(int(iteration), []).append(
            int(replica))
        return self

    def replica_hangs_at(self, iteration):
        """-> replica indices that begin hanging at this router
        iteration. Consumed by FleetRouter.step();
        `fired["replica_hang"]` counts via replica_hang_applied only
        when a LIVE replica actually started stalling."""
        return self._replica_hangs.pop(int(iteration), [])

    def replica_hang_applied(self):
        self.fired["replica_hang"] += 1

    def kill_process_at(self, iteration, replica):
        """SIGKILL the subprocess behind fleet replica index `replica`
        at the START of router iteration `iteration` (1-based, same
        counter as kill_replica_at). Unlike kill_replica_at — which
        closes an in-process engine through its own close path — this
        is a REAL `os.kill(pid, SIGKILL)`: the worker gets no chance
        to flush, the parent only learns of the death when the next
        RPC fails, and the whole dead-replica pipeline (failover,
        supervisor resurrection) must hold against an actual process
        corpse. `fired["process_kill"]` counts via
        process_kill_applied only when a live worker pid was
        actually signalled."""
        self._process_kills.setdefault(int(iteration), []).append(
            int(replica))
        return self

    def process_kills_at(self, iteration):
        """-> replica indices whose worker process to SIGKILL at this
        router iteration. Consumed by FleetRouter.step()."""
        return self._process_kills.pop(int(iteration), [])

    def process_kill_applied(self):
        self.fired["process_kill"] += 1

    def drop_connection_at(self, nth, kind="reset"):
        """Inject exactly one transport fault on the `nth` RPC call
        (1-based, counted per RpcClient) of any client built with this
        injector. kind="reset" drops the connection before the send —
        the client's bounded-backoff retry path must recover; kind=
        "timeout" makes the call time out — the proxy's hung-suspect
        classification path must engage. Deterministic (keyed to the
        call ordinal, no sleeps needed to hit the window)."""
        if kind not in ("reset", "timeout"):
            raise ValueError(
                f"drop_connection_at kind must be 'reset' or "
                f"'timeout', got {kind!r}")
        self._conn_drops[int(nth)] = kind
        return self

    def conn_drop_for(self, ncall):
        """-> the fault kind planned for this rpc ordinal, or None.
        Consumed by transport.RpcClient; counts fired["conn_drop"]
        when a fault is actually injected."""
        kind = self._conn_drops.pop(int(ncall), None)
        if kind is not None:
            self.fired["conn_drop"] += 1
        return kind

    def slow_replica(self, replica, ms_per_iteration):
        """Standing plan: every pump of fleet replica index `replica`
        reports an extra `ms_per_iteration` of step time to the
        router's per-replica timing (the watchdog's slow-classification
        input). The replica still advances — progress marks move — so
        the watchdog must label it `slow`, never hung or dead."""
        self._replica_slow[int(replica)] = float(ms_per_iteration)
        return self

    def replica_slow_ms(self, replica):
        """-> the injected extra ms for this replica's pumps, or None.
        Counted once on first application (the plan is standing)."""
        ms = self._replica_slow.get(int(replica))
        if ms is not None and int(replica) not in self._slow_counted:
            self._slow_counted.add(int(replica))
            self.fired["replica_slow"] += 1
        return ms

    def poison_prompt(self, prompt_ids, layer=0):
        """Mark a PROMPT as poison: whenever a lane serving exactly
        this prompt has advanced past position 0, the engine NaNs the
        lane's first KV block (layer `layer`) before its next fused
        step — the NaN flows through real attention into that lane's
        logits and trips the non-finite fail-stop. Unlike
        poison_serving_at (keyed to one engine iteration), this plan is
        STANDING and content-addressed, so the request's failover
        REPLAY re-faults every replica it lands on — the deterministic
        poison-request cascade the router's quarantine exists to stop
        (fired["prompt_poison"] counts one per application, i.e. one
        per replica death it causes)."""
        self._prompt_poisons.append(
            (np.asarray(prompt_ids, np.int32).reshape(-1), int(layer)))
        return self

    def prompt_poison_plan(self):
        """-> the standing [(prompt, layer)] plan (empty list when no
        prompt is marked). Consumed every engine step."""
        return self._prompt_poisons

    def prompt_poison_applied(self):
        self.fired["prompt_poison"] += 1
