"""Twins of tests/api/test_fleet_supervisor.py on the port
(paddle_tpu_torch), on the CPU, with the fleet twin of
tests/api/test_kv_tier.py (spilled chains through a kill into the
resurrection re-warm). The tiny GPT is built and checkpointed by the
port's own startup and CheckpointManager. Besides, the checkpoint
format interchanges with the JAX package's both ways (bitwise), and a
fleet resurrects a killed replica from a checkpoint the JAX
CheckpointManager wrote, serving the JAX server's ids (``jax_engine``'s
probe patch, as in tests/test_torch_serving.py). The reference's
``fused_step_signatures == 1`` check is a JAX compile-count fact; its
twin checks that the CPU path launched no kernel.

Self-healing fleet (robustness/supervisor.py + router wiring).

Tier-1 (`fleet` marker): manual-drive replicas pumped by the router's
step() loop, heartbeats = router iterations, zero sleeps and zero
wall-clock dependence. The contract under test:

- the WATCHDOG declares a chaos-hung replica (progress marks frozen
  with work pending, no death — failover can never see it) within N
  injected heartbeats, tears it down, and its in-flight requests
  re-admit bitwise on survivors;
- a chaos-slowed replica is labeled `slow` and NOT torn down;
- RESURRECTION respawns a killed replica through a checkpoint-reload
  spawn_fn, half-open-probes it, re-warms its prefix cache from the
  router's fleet-wide popularity digest (rejoins warm, not cold), and
  returns the fleet to full strength;
- the crash-loop circuit breaker backs off exponentially (never
  hot-loops) and PERMANENTLY evicts a slot after K consecutive failed
  spawns, dropping its gauge series;
- a POISON request (chaos prompt-poison: its replay NaNs its own KV
  and faults any engine that serves it) is quarantined with a
  structured PoisonRequestError after at most 2 replica deaths —
  innocent bystanders on the faulted replicas fail over strike-free;
- SIGTERM (the PreemptionHandler flag) triggers a fleet-wide graceful
  drain: in-flight requests finish, then every replica closes;
- the chaos STORM e2e: scripted kill + hang + poison in one stream —
  the fleet returns to its configured replica count, every non-poison
  request completes with bitwise-identical streams, the poison request
  dies quarantined.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import framework
from paddle_tpu_torch.core.executor import Scope, scope_guard
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.observability.metrics import global_registry
from paddle_tpu_torch.robustness import (ChaosInjector, CheckpointManager,
                                   PoisonRequestError, PreemptionHandler,
                                   SupervisorConfig,
                                   make_checkpoint_spawn)
from paddle_tpu_torch.serving import (FleetRouter, GenerationServer,
                                      GPTServingModel, prompt_chain_keys)

pytestmark = [pytest.mark.fleet, pytest.mark.chaos]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module: the suite runs
    several pytest workers at once, and torch's default of one thread a
    core in each worker oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SERVER_KW = dict(num_slots=3, block_size=8, max_context=64, chunk=4,
                 start=False, prefix_cache=True)


@pytest.fixture(scope="module")
def tiny_gpt():
    cfg = gpt.gpt_tiny()
    main, startup = framework.Program(), framework.Program()
    main.random_seed = startup.random_seed = 13
    with framework.program_guard(main, startup):
        gpt.build_lm_net(cfg, seq_len=8)
    scope = Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with scope_guard(scope):
        exe.run(startup)
    return cfg, gpt.load_params(scope, cfg), main, scope, exe


def _server(params, cfg, **kw):
    merged = dict(SERVER_KW)
    merged.update(kw)
    return GenerationServer(GPTServingModel(params, cfg, device="cpu"),
                            device="cpu", **merged)


def _reference_ids(params, cfg, prompts, n_new):
    srv = _server(params, cfg)
    futs = [srv.submit(p, max_new_tokens=n_new) for p in prompts]
    srv.run_until_idle()
    ids = [list(f.result(timeout=5).token_ids) for f in futs]
    srv.close()
    return ids


# ---------------------------------------------------------------------------
# watchdog: hung and slow replicas
# ---------------------------------------------------------------------------

def test_watchdog_declares_hung_replica_within_n_heartbeats(tiny_gpt):
    """A hang stalls progress WITHOUT dying: no future fails, so
    failover never fires — the watchdog (stale progress marks across N
    heartbeats) must catch it, tear the replica down, and re-admit its
    in-flight requests bitwise on the survivor."""
    cfg, params, *_ = tiny_gpt
    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, cfg.vocab_size,
                            int(rng.integers(9, 20))).astype(np.int32)
               for _ in range(4)]
    ref_ids = _reference_ids(params, cfg, prompts, 6)

    n_hb = 3
    chaos = ChaosInjector().hang_replica_at(3, 0)
    servers = [_server(params, cfg) for _ in range(2)]
    router = FleetRouter(servers, start=False, chaos=chaos,
                         supervisor=SupervisorConfig(
                             hang_heartbeats=n_hb, resurrect=False))
    futs = [router.submit(p, max_new_tokens=6) for p in prompts]
    router.run_until_idle()

    assert chaos.fired["replica_hang"] == 1
    assert router.counts["hangs"] == 1
    assert router.replicas()[0].state == "dead"
    assert router.counts["failovers"] >= 1   # someone was on replica 0
    # detection latency: the hung_replica flight event fired within
    # N+1 router iterations of the hang starting at iteration 3
    events = [e for e in router._flight.entries()
              if e["kind"] == "hung_replica"]
    assert len(events) == 1
    assert events[0]["step"] - 3 <= n_hb + 1
    # bitwise re-admission on the survivor
    ids = [list(f.result(timeout=5).token_ids) for f in futs]
    assert ids == ref_ids
    assert global_registry().counter("serving.fleet.hangs").value() >= 1
    router.close()


def test_slow_replica_is_flagged_not_torn_down(tiny_gpt):
    """Slow is a capacity signal, hung is a correctness one: a replica
    whose pumps advance (marks move) but report a high step time is
    labeled `slow` in health/stats and keeps serving."""
    cfg, params, *_ = tiny_gpt
    rng = np.random.default_rng(2)
    chaos = ChaosInjector().slow_replica(0, 500.0)
    servers = [_server(params, cfg) for _ in range(2)]
    router = FleetRouter(servers, start=False, chaos=chaos,
                         supervisor=SupervisorConfig(
                             hang_heartbeats=3, slow_ms=100.0,
                             resurrect=False))
    futs = [router.submit(rng.integers(3, cfg.vocab_size,
                                       10).astype(np.int32),
                          max_new_tokens=4) for _ in range(4)]
    router.run_until_idle()
    for f in futs:
        f.result(timeout=5)
    assert chaos.fired["replica_slow"] == 1
    reps = router.get_stats()["replicas"]
    assert reps[0]["condition"] == "slow"
    assert reps[0]["status"] == "ok"        # alive, never torn down
    assert router.counts["hangs"] == 0
    assert router.replicas()[0].health()["condition"] == "slow"
    router.close()


# ---------------------------------------------------------------------------
# resurrection: checkpoint reload, prefix re-warm, crash-loop breaker
# ---------------------------------------------------------------------------

def test_resurrection_restores_full_strength_with_warm_prefix(
        tiny_gpt, tmp_path):
    """A killed replica comes BACK: weights reload through
    CheckpointManager (newest valid checkpoint), the respawned engine
    serves a half-open probe, its prefix cache re-warms from the
    router's popularity digest (it rejoins holding the hot tenant
    chain — above cold-start, which is an empty index), and the fleet
    returns to its configured replica count."""
    cfg, params, main, scope, exe = tiny_gpt
    rng = np.random.default_rng(3)
    manager = CheckpointManager(str(tmp_path / "ck"), program=main)
    manager.save(exe, 0, scope=scope)
    spawn = make_checkpoint_spawn(manager, cfg, device="cpu",
                                  **SERVER_KW)

    tenant = rng.integers(3, cfg.vocab_size, 16).astype(np.int32)
    prompts = [np.concatenate([tenant, rng.integers(
        3, cfg.vocab_size, 3).astype(np.int32)]) for _ in range(6)]
    ref_ids = _reference_ids(params, cfg, prompts, 5)

    chaos = ChaosInjector().kill_replica_at(4, 0)
    servers = [_server(params, cfg) for _ in range(3)]
    router = FleetRouter(
        servers, start=False, chaos=chaos, spawn_fn=spawn,
        supervisor=SupervisorConfig(backoff_heartbeats=2,
                                    warm_chains=4))
    futs = []
    for p in prompts:
        futs.append(router.submit(p, max_new_tokens=5))
        router.step()
    router.run_until_idle()

    assert chaos.fired["replica_kill"] == 1
    st = router.get_stats()
    assert st["live_replicas"] == 3          # back at full strength
    assert st["resurrections"] == 1
    rep0 = router.replicas()[0]
    assert rep0.state == "ok" and rep0.generation == 1
    assert rep0.server is not servers[0]     # a fresh engine
    # checkpoint-reloaded weights are bitwise: every request (some of
    # them replayed through the kill) matches the clean reference
    ids = [list(f.result(timeout=5).token_ids) for f in futs]
    assert ids == ref_ids
    # prefix RE-WARM: the resurrected replica's index already holds
    # the tenant chain (cold-start would be an empty index), so a
    # follow-up tenant request lands on it warm and scores hits
    from paddle_tpu_torch.serving import prompt_chain_keys
    warm_idx = rep0.server._prefix
    assert len(warm_idx) >= 2                # warmed chain registered
    # the tenant chain is IN the resurrected index: an affinity probe
    # for a tenant prompt matches at least its first chunk
    tkeys = prompt_chain_keys(prompts[0], 8)
    assert rep0.affinity_depth(prompts[0], tkeys) >= 1
    hits_before = rep0.server.get_stats()["prefix"]["hits"]
    f2 = router.submit(np.concatenate([tenant, rng.integers(
        3, cfg.vocab_size, 2).astype(np.int32)]), max_new_tokens=2)
    router.run_until_idle()
    f2.result(timeout=5)
    fleet_hits = sum(r.server.get_stats()["prefix"]["hits"]
                     for r in router.replicas() if r.alive())
    assert fleet_hits > 0
    assert global_registry().counter(
        "serving.fleet.resurrections").value() >= 1
    sup = st["supervisor"]
    assert sup["probes"] == 1 and sup["warm_prompts"] >= 1
    router.close()
    del hits_before


def test_crash_loop_breaker_backs_off_then_evicts(tiny_gpt):
    """A slot whose spawn keeps failing is retried under exponential
    backoff (never hot-looped: attempt gaps grow) and PERMANENTLY
    evicted after max_crash_loops consecutive failures — its load
    gauge series stays dropped and the fleet runs on without it."""
    cfg, params, *_ = tiny_gpt
    rng = np.random.default_rng(4)
    spawn_at = []

    chaos = ChaosInjector().kill_replica_at(2, 0)
    servers = [_server(params, cfg) for _ in range(2)]
    router = FleetRouter(
        servers, start=False, chaos=chaos,
        supervisor=SupervisorConfig(backoff_heartbeats=2,
                                    backoff_factor=2.0,
                                    max_crash_loops=2))

    def bad_spawn(index):
        spawn_at.append(router.supervisor.heartbeat)
        raise RuntimeError("no capacity")

    router.spawn_fn = bad_spawn
    futs = [router.submit(rng.integers(3, cfg.vocab_size,
                                       10).astype(np.int32),
                          max_new_tokens=8) for _ in range(4)]
    router.run_until_idle()
    for f in futs:
        f.result(timeout=5)

    assert len(spawn_at) == 2               # exactly K attempts, then
    assert router.replicas()[0].state == "evicted"      # ... eviction
    assert router.counts["crash_loops"] == 2
    assert router.get_stats()["live_replicas"] == 1
    # exponential backoff: the second attempt waited LONGER than the
    # first (2 then 4 heartbeats) — the breaker never hot-loops
    assert spawn_at[1] - spawn_at[0] >= 4
    # the evicted slot reports no load series and is never respawned
    g = global_registry().gauge("serving.fleet.replica_load")
    series = {lbl.get("replica") for lbl, _c in g.series()
              if lbl.get("router") == router.name}
    assert router.replicas()[0].name not in series
    assert global_registry().counter(
        "serving.fleet.crash_loops").value() >= 2
    more = router.submit(rng.integers(3, cfg.vocab_size,
                                      8).astype(np.int32),
                         max_new_tokens=2)
    router.run_until_idle()
    more.result(timeout=5)                  # fleet serves on 1 replica
    assert len(spawn_at) == 2               # eviction is permanent
    router.close()


# ---------------------------------------------------------------------------
# poison-request quarantine
# ---------------------------------------------------------------------------

def test_poison_request_kills_at_most_two_replicas(tiny_gpt, tmp_path):
    """THE regression for the cascade seed: a request whose replay
    deterministically faults the engine used to be re-admitted on
    survivor after survivor until the fleet was gone. Lineage tracking
    quarantines it after 2 implicated deaths — with 4 replicas and no
    resurrection, at most 2 die, innocents complete bitwise."""
    cfg, params, *_ = tiny_gpt
    rng = np.random.default_rng(5)
    good = [rng.integers(3, cfg.vocab_size,
                         int(rng.integers(9, 16))).astype(np.int32)
            for _ in range(6)]
    poison = rng.integers(3, cfg.vocab_size, 12).astype(np.int32)
    ref_ids = _reference_ids(params, cfg, good, 6)

    chaos = ChaosInjector().poison_prompt(poison)
    # flight_dir on the ENGINES too: their fault postmortems must land
    # in tmp, not the cwd
    servers = [_server(params, cfg, chaos=chaos,
                       flight_dir=str(tmp_path)) for _ in range(4)]
    router = FleetRouter(servers, start=False, chaos=chaos,
                         flight_dir=str(tmp_path))
    good_futs = [router.submit(p, max_new_tokens=6) for p in good]
    pfut = router.submit(poison, max_new_tokens=6)
    router.run_until_idle()

    with pytest.raises(PoisonRequestError) as ei:
        pfut.result(timeout=5)
    err = ei.value
    assert err.deaths == 2                  # implicated deaths
    assert len([d for d in err.lineage if d["implicated"]]) == 2
    assert chaos.fired["prompt_poison"] == 2
    dead = [r for r in router.replicas() if not r.alive()]
    assert len(dead) == 2                   # kills <= 2 replicas
    assert router.get_stats()["live_replicas"] == 2
    assert router.counts["quarantines"] == 1
    # innocents riding the faulted replicas failed over strike-free
    ids = [list(f.result(timeout=5).token_ids) for f in good_futs]
    assert ids == ref_ids
    for rr_ids in ids:
        assert len(rr_ids) == 6
    # the quarantine left a postmortem artifact in the fleet flight
    # recorder, and the structured error points at it
    assert err.flight_dump is not None
    import json
    with open(err.flight_dump) as f:
        dump = json.load(f)
    assert dump["reason"] == "poison_request_quarantined"
    assert dump["extra"]["rid"] == pfut.request_id
    assert dump["entries"][-1]["kind"] == "quarantine"
    assert global_registry().counter(
        "serving.fleet.quarantines").value() >= 1
    router.close()


def test_per_request_retry_budget_caps_failovers(tiny_gpt):
    """submit(retry_budget=0): the request gets NO failover allowance
    — its first replica death surfaces to the client instead of
    re-admitting (deadline budgets already propagate; this is the
    attempt budget)."""
    cfg, params, *_ = tiny_gpt
    rng = np.random.default_rng(6)
    chaos = ChaosInjector().kill_replica_at(3, 0)
    servers = [_server(params, cfg) for _ in range(2)]
    router = FleetRouter(servers, start=False, chaos=chaos, p2c_seed=1)
    futs = [router.submit(rng.integers(3, cfg.vocab_size,
                                       10).astype(np.int32),
                          max_new_tokens=8, retry_budget=0)
            for _ in range(4)]
    router.run_until_idle()
    outcomes = []
    for f in futs:
        try:
            f.result(timeout=5)
            outcomes.append("ok")
        except Exception as e:      # noqa: BLE001 — asserting the type
            outcomes.append(type(e).__name__)
    # whoever was on the killed replica surfaced the death un-retried
    assert "RequestCancelled" in outcomes
    assert router.counts["failovers"] == 0
    router.close()


# ---------------------------------------------------------------------------
# preemption: SIGTERM -> fleet-wide graceful drain
# ---------------------------------------------------------------------------

def test_preemption_flag_drains_fleet_gracefully(tiny_gpt):
    """The PreemptionHandler flag (a real SIGTERM sets the same one —
    preemption.py keeps both paths identical) triggers close(drain=
    True) semantics fleet-wide: new submits refuse, in-flight requests
    FINISH, every replica closes, gauge series retire."""
    cfg, params, *_ = tiny_gpt
    rng = np.random.default_rng(7)
    handler = PreemptionHandler()
    servers = [_server(params, cfg) for _ in range(2)]
    router = FleetRouter(servers, start=False, preemption=handler)
    futs = [router.submit(rng.integers(3, cfg.vocab_size,
                                       12).astype(np.int32),
                          max_new_tokens=8) for _ in range(4)]
    for _ in range(2):
        router.step()
    handler.request()                        # "SIGTERM"
    router.run_until_idle()
    for f in futs:
        assert len(f.result(timeout=5).token_ids) == 8   # drained, not
        #                                                  dropped
    assert router.counts["preempt_drains"] == 1
    with pytest.raises(RuntimeError, match="closed"):
        router.submit(rng.integers(3, cfg.vocab_size,
                                   8).astype(np.int32))
    for r in router.replicas():
        assert r.state == "drained"
    series = {lbl for lbl, _c in global_registry().gauge(
        "serving.fleet.replica_load").series()
        if lbl.get("router") == router.name}
    assert not series                        # teardown retired gauges
    router.close()                           # idempotent after drain


# ---------------------------------------------------------------------------
# the chaos storm e2e (acceptance)
# ---------------------------------------------------------------------------

def test_chaos_storm_kill_hang_poison_e2e(tiny_gpt, tmp_path):
    """THE acceptance storm: kill + hang + poison faults in one
    deterministic stream over a supervised 3-replica fleet. The fleet
    returns to its configured replica count, every non-poison request
    completes with bitwise-identical streams (dedup through every
    failover), and the poison request is quarantined after at most 2
    replica deaths."""
    cfg, params, main, scope, exe = tiny_gpt
    rng = np.random.default_rng(8)
    manager = CheckpointManager(str(tmp_path / "ck"), program=main)
    manager.save(exe, 0, scope=scope)

    tenant = rng.integers(3, cfg.vocab_size, 16).astype(np.int32)
    good = []
    for i in range(8):
        if i % 3 == 0:
            good.append(np.concatenate([tenant, rng.integers(
                3, cfg.vocab_size, 3).astype(np.int32)]))
        else:
            good.append(rng.integers(
                3, cfg.vocab_size,
                int(rng.integers(9, 22))).astype(np.int32))
    poison = rng.integers(3, cfg.vocab_size, 12).astype(np.int32)
    ref_ids = _reference_ids(params, cfg, good, 7)

    chaos = (ChaosInjector()
             .kill_replica_at(3, 0)
             .hang_replica_at(7, 1)
             .poison_prompt(poison))
    # resurrected engines carry the injector too: the poison payload
    # faults WHATEVER engine serves it, including a fresh one — that
    # is what makes quarantine (not resurrection) the only way out
    spawn = make_checkpoint_spawn(manager, cfg, chaos=chaos,
                                  flight_dir=str(tmp_path),
                                  device="cpu", **SERVER_KW)
    servers = [_server(params, cfg, chaos=chaos,
                       flight_dir=str(tmp_path)) for _ in range(3)]
    router = FleetRouter(
        servers, start=False, chaos=chaos, spawn_fn=spawn,
        flight_dir=str(tmp_path),
        supervisor=SupervisorConfig(hang_heartbeats=3,
                                    backoff_heartbeats=2,
                                    warm_chains=3))
    streams = {i: [] for i in range(len(good))}
    futs = []
    for i, p in enumerate(good[:4]):
        futs.append(router.submit(
            p, max_new_tokens=7,
            stream=lambda rid, t, toks=streams[i]: toks.append(t)))
    router.step()
    pfut = router.submit(poison, max_new_tokens=7)
    router.step()
    for i, p in enumerate(good[4:], start=4):
        futs.append(router.submit(
            p, max_new_tokens=7,
            stream=lambda rid, t, toks=streams[i]: toks.append(t)))
        router.step()
    router.run_until_idle()

    # every scripted fault actually fired
    assert chaos.fired["replica_kill"] == 1
    assert chaos.fired["replica_hang"] == 1
    assert chaos.fired["prompt_poison"] == 2
    # the poison request is quarantined after at most 2 deaths
    with pytest.raises(PoisonRequestError) as ei:
        pfut.result(timeout=5)
    assert ei.value.deaths <= 2
    st = router.get_stats()
    assert st["quarantines"] == 1
    # the fleet healed back to its CONFIGURED replica count
    assert st["live_replicas"] == 3
    assert st["hangs"] == 1
    # one resurrection per death: kill + hang + 2 poison faults
    assert st["resurrections"] == st["replica_kills"] + st["hangs"] + 2
    for r in router.replicas():
        assert r.state == "ok"
    # every non-poison request: bitwise ids, streams deduplicated
    results = [f.result(timeout=5) for f in futs]
    ids = [list(r.token_ids) for r in results]
    assert ids == ref_ids
    for i, r in enumerate(results):
        assert streams[i] == list(r.token_ids)
    # engine invariants survived the storm on every LIVE engine
    for r in router.replicas():
        assert r.server.get_stats()["kernel"]["launches"] == 0
    router.close()


# ---------------------------------------------------------------------------
# spilled chains survive a replica kill into resurrection re-warm
# (tests/api/test_kv_tier.py's fleet test)
# ---------------------------------------------------------------------------

def _run(srv, prompts, n_new):
    futs = [srv.submit(p, max_new_tokens=n_new) for p in prompts]
    srv.run_until_idle()
    return [list(f.result(timeout=5).token_ids) for f in futs]


def test_spilled_chains_survive_kill_into_resurrection_rewarm(
        tiny_gpt, tmp_path):
    """Kill-a-replica chaos over a host-tiered fleet: the tenant chain
    is SPILLED on the survivor when replica 0 dies. The popularity
    digest still names the chain (it lives in the router, not the dead
    index), resurrection re-warms the fresh replica from it, the
    survivor's affinity depth still counts the spilled chunks, and a
    follow-up tenant request is served from the HOST tier: swap-ins
    move, re-prefills are avoided, the stream is bitwise."""
    cfg, params, main, scope, exe = tiny_gpt
    rng = np.random.default_rng(55)
    kw = dict(num_slots=3, block_size=8, max_context=64, chunk=4,
              start=False, prefix_cache=True, host_kv_blocks=16)
    manager = CheckpointManager(str(tmp_path / "ck"), program=main)
    manager.save(exe, 0, scope=scope)
    spawn = make_checkpoint_spawn(manager, cfg, device="cpu", **kw)

    tenant = rng.integers(3, cfg.vocab_size, 16).astype(np.int32)
    prompts = [np.concatenate([tenant, rng.integers(
        3, cfg.vocab_size, 3).astype(np.int32)]) for _ in range(4)]
    ref_ids = _run(_server(params, cfg, prefix_cache=True), prompts, 5)

    kill_chaos = ChaosInjector()
    engine_chaos = [ChaosInjector() for _ in range(2)]
    servers = [_server(params, cfg, **dict(kw, chaos=engine_chaos[i]))
               for i in range(2)]
    router = FleetRouter(
        servers, start=False, chaos=kill_chaos, spawn_fn=spawn,
        supervisor=SupervisorConfig(backoff_heartbeats=2,
                                    warm_chains=2))
    futs = [router.submit(p, max_new_tokens=5) for p in prompts]
    router.run_until_idle()
    assert [list(f.result(timeout=5).token_ids)
            for f in futs] == ref_ids

    # spill every idle chain on every replica that holds one (the
    # deterministic chaos hook, fired at the next engine iteration)
    tkeys = prompt_chain_keys(prompts[0], 8)
    for ci, rep in zip(engine_chaos, router.replicas()):
        idx = rep.server._prefix
        if not len(idx):
            continue
        ci.spill_chain_at(rep.server._sched.iteration + 1, len(idx))
        probe = rep.server.submit(
            rng.integers(3, cfg.vocab_size, 4).astype(np.int32),
            max_new_tokens=1)
        rep.server.run_until_idle()
        probe.result(timeout=5)
        assert ci.fired["spill"] >= 1
        assert idx.host_entry_count() >= 2
        # spilled chunks STILL count toward affinity depth
        assert rep.affinity_depth(prompts[0], tkeys) >= 2

    # kill replica 0 at the next router iteration; the supervisor
    # resurrects it and re-warms from the digest, which survived the
    # death AND names the (now spilled) tenant chain
    survivor = router.replicas()[1]
    before = survivor.server._prefix.counts["reprefills_avoided"]
    kill_chaos.kill_replica_at(router.iteration + 1, 0)
    f2 = router.submit(prompts[0], max_new_tokens=5)
    router.run_until_idle()
    assert list(f2.result(timeout=5).token_ids) == ref_ids[0]
    assert kill_chaos.fired["replica_kill"] == 1
    st = router.get_stats()
    assert st["live_replicas"] == 2 and st["resurrections"] == 1
    assert st["supervisor"]["warm_prompts"] >= 1
    assert st["popularity_digest"]["entries"] >= 2

    # the HOST tier served the chain: affinity routed f2 to the
    # survivor (spilled depth beats cold replicas) and claim swapped
    # the tenant chunks in instead of re-prefilling
    assert survivor.server._prefix.counts["reprefills_avoided"] >= \
        before + 2
    assert survivor.server.get_stats()["kv_tier"]["swap_ins"] >= 2

    # follow-up tenant traffic now finds the chain device-tier, bitwise
    f3 = survivor.server.submit(prompts[1], max_new_tokens=5)
    survivor.server.run_until_idle()
    assert list(f3.result(timeout=5).token_ids) == ref_ids[1]
    router.close()


# ---------------------------------------------------------------------------
# checkpoints across the packages: the JAX CheckpointManager's format-2
# directory restores into the port and the reverse, and a fleet resurrects
# from a JAX-written checkpoint with the JAX server's ids
# ---------------------------------------------------------------------------

def _jax_checkpoint(root, seed=13):
    """gpt_tiny's startup run by the JAX package, saved by its
    CheckpointManager; -> (cfg, JAX params)."""
    from paddle_tpu import Executor as JExecutor
    from paddle_tpu.core import framework as jframework
    from paddle_tpu.core import unique_name as junique
    from paddle_tpu.core.executor import Scope as JScope
    from paddle_tpu.core.executor import scope_guard as jscope_guard
    from paddle_tpu.models import gpt as jgpt
    from paddle_tpu.robustness import CheckpointManager as JManager
    cfg = jgpt.gpt_tiny()
    main, startup = jframework.Program(), jframework.Program()
    main.random_seed = startup.random_seed = seed
    with junique.guard(), jframework.program_guard(main, startup):
        jgpt.build_lm_net(cfg, seq_len=8)
    scope, exe = JScope(), JExecutor()
    with jscope_guard(scope):
        exe.run(startup)
    JManager(str(root), program=main).save(exe, 0, scope=scope)
    return cfg, jgpt.load_params(scope, cfg), main, scope


def _port_program(cfg, seed=13):
    from paddle_tpu_torch.core import unique_name
    main, startup = framework.Program(), framework.Program()
    main.random_seed = startup.random_seed = seed
    with unique_name.guard(), framework.program_guard(main, startup):
        gpt.build_lm_net(cfg, seq_len=8)
    return main, startup


def test_checkpoint_format_interchanges_with_jax(tmp_path):
    """A format-2 retention root written by the JAX CheckpointManager
    restores into the port bitwise (CRC manifest validated), and one the
    port writes restores into the JAX package bitwise."""
    from paddle_tpu import Executor as JExecutor
    from paddle_tpu.core.executor import Scope as JScope
    from paddle_tpu.robustness import CheckpointManager as JManager
    cfg, _jp, jmain, jscope = _jax_checkpoint(tmp_path / "jax")
    tmain, _ = _port_program(cfg)
    names = sorted(v.name for v in tmain.list_vars() if v.persistable)
    assert names == sorted(v.name for v in jmain.list_vars()
                           if v.persistable)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = Scope()
    meta = CheckpointManager(str(tmp_path / "jax"), program=tmain) \
        .restore(exe, scope=scope)
    assert meta["format"] == 2 and meta["step"] == 0
    for n in names:
        np.testing.assert_array_equal(scope.get(n).numpy(),
                                      np.asarray(jscope.get(n)))
    # the reverse: the port saves, the JAX package restores
    for n in names:
        scope.set(n, scope.get(n) * 2)
    CheckpointManager(str(tmp_path / "port"), program=tmain).save(
        exe, 4, scope=scope)
    back = JScope()
    jmeta = JManager(str(tmp_path / "port"), program=jmain).restore(
        JExecutor(), scope=back)
    assert jmeta["step"] == 4
    for n in names:
        np.testing.assert_array_equal(np.asarray(back.get(n)),
                                      scope.get(n).numpy())


def test_checkpoint_crc_mismatch_falls_back(tiny_gpt, tmp_path):
    """A torn newest checkpoint (a flipped byte in state.npz) fails its
    CRC check and the manager restores the previous good one."""
    cfg, params, main, scope, exe = tiny_gpt
    manager = CheckpointManager(str(tmp_path / "ck"), program=main,
                                sleep_fn=lambda s: None)
    manager.save(exe, 1, scope=scope)
    last = manager.save(exe, 2, scope=scope)
    path = f"{last}/state.npz"
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    meta = manager.restore(exe, scope=Scope())
    assert meta["step"] == 1 and meta["dir"].endswith("ckpt-00000001")


def test_resurrection_from_jax_checkpoint_matches_jax_server(
        tmp_path, monkeypatch):
    """A fleet whose replica 0 is killed mid-stream resurrects it through
    make_checkpoint_spawn from a checkpoint the JAX CheckpointManager
    wrote: every request's ids, through the failover and on the
    resurrected replica, equal the JAX server's on the same weights."""
    from paddle_tpu.serving import GenerationServer as JServer
    from paddle_tpu.serving import GPTServingModel as JModel
    from paddle_tpu.serving import kv_cache as jkvc
    monkeypatch.setattr(jkvc, "_transform_trace_kind", lambda *ops: None)
    cfg, jparams, _jmain, _jscope = _jax_checkpoint(tmp_path / "ck")
    tmain, _ = _port_program(cfg)
    manager = CheckpointManager(str(tmp_path / "ck"), program=tmain)
    spawn = make_checkpoint_spawn(manager, cfg, device="cpu", **SERVER_KW)
    rng = np.random.default_rng(21)
    tenant = rng.integers(3, cfg.vocab_size, 16).astype(np.int32)
    prompts = [np.concatenate([tenant, rng.integers(
        3, cfg.vocab_size, 3).astype(np.int32)]) for _ in range(3)]
    prompts += [rng.integers(3, cfg.vocab_size, 10).astype(np.int32)
                for _ in range(3)]
    jsrv = JServer(JModel(jparams, cfg), telemetry=False, **SERVER_KW)
    jfuts = [jsrv.submit(p, max_new_tokens=6) for p in prompts]
    jsrv.run_until_idle()
    want = [list(f.result(timeout=30).token_ids) for f in jfuts]
    jsrv.close()

    chaos = ChaosInjector().kill_replica_at(3, 0)
    router = FleetRouter([spawn(i) for i in range(2)], start=False,
                         chaos=chaos, spawn_fn=spawn,
                         supervisor=SupervisorConfig(
                             backoff_heartbeats=1, warm_chains=1))
    futs = [router.submit(p, max_new_tokens=6) for p in prompts]
    router.run_until_idle()
    assert [list(f.result(timeout=5).token_ids) for f in futs] == want
    assert chaos.fired["replica_kill"] == 1
    st = router.get_stats()
    assert st["resurrections"] == 1 and st["live_replicas"] == 2
    rep0 = router.replicas()[0]
    assert rep0.generation >= 1
    # the resurrected replica serves the JAX server's ids too
    f = rep0.server.submit(prompts[-1], max_new_tokens=6)
    rep0.server.run_until_idle()
    assert list(f.result(timeout=5).token_ids) == want[-1]
    router.close()
