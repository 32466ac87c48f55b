"""Twins of tests/api/test_autoscaler.py on the port
(paddle_tpu_torch), on the CPU, over in-process replicas built by
the port's own startup (the autoscaler is backend-agnostic).

SLO-driven autoscaler (robustness/supervisor.py Autoscaler +
FleetRouter.add_replica_slot).

Tier-1, zero wall-clock dependence: the chaos injector's
``tick_clock`` drives every SLO window roll and burn-rate sample, so
"fast window" and "hysteresis" are injected-clock facts, not sleeps.
The contract under test:

- a 4x load swing scales UP within the fast burn window (consecutive
  breach samples over ``up_threshold``), through the router's
  ``add_replica_slot`` — the new replica joins live traffic and the
  flight recorder logs the decision;
- scale-DOWN happens only after the calm streak outlasts the
  hysteresis band (``down_samples`` > up path, scale-up-fast /
  scale-down-slow) and drains the least-loaded replica rather than
  killing it;
- the safety rail: while the crash-loop breaker is open (a dead slot
  with a failing spawn) the autoscaler makes ZERO scale-ups and
  counts the refusals — an autoscaler fighting a crash loop would
  spawn into the same failure forever;
- min/max bounds hold absolutely, and the config rejects an inverted
  hysteresis band loudly.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import framework
from paddle_tpu_torch.core.executor import Scope, scope_guard
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.observability.metrics import global_registry
from paddle_tpu_torch.robustness import ChaosInjector, SupervisorConfig
from paddle_tpu_torch.robustness.supervisor import AutoscalerConfig
from paddle_tpu_torch.serving import FleetRouter, GenerationServer, GPTServingModel

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
    return cfg, gpt.load_params(scope, cfg)


def _spawn_fn(params, cfg, chaos):
    def spawn(_index):
        return GenerationServer(GPTServingModel(params, cfg, device="cpu"),
                                device="cpu", chaos=chaos,
                                telemetry=True, slo_window_s=0.25,
                                **SERVER_KW)
    return spawn


def test_config_validates_hysteresis_and_bounds():
    with pytest.raises(ValueError, match="hysteresis"):
        AutoscalerConfig(up_threshold=0.5, down_threshold=0.5)
    with pytest.raises(ValueError, match="min_replicas"):
        AutoscalerConfig(min_replicas=0)
    with pytest.raises(ValueError, match="max_replicas"):
        AutoscalerConfig(min_replicas=3, max_replicas=2)


def test_autoscaler_requires_spawn_and_signals(tiny_gpt):
    cfg, params = tiny_gpt
    srv = GenerationServer(GPTServingModel(params, cfg, device="cpu"),
                           device="cpu", telemetry=True, **SERVER_KW)
    with pytest.raises(ValueError, match="spawn_fn"):
        FleetRouter([srv], start=False, autoscale=True)
    srv.close()


def test_load_swing_scales_up_fast_and_down_after_hysteresis(tiny_gpt):
    """The headline e2e: 12 requests onto 3 slots (4x) must breach the
    fast burn window and add a replica within a couple of router
    iterations; a calm trickle must hold the fleet size through the
    hysteresis band and only then drain the idlest replica."""
    cfg, params = tiny_gpt
    chaos = ChaosInjector().tick_clock(0)
    spawn = _spawn_fn(params, cfg, chaos)
    reg = global_registry()
    ups = reg.counter("serving.fleet.autoscale.scale_ups")
    downs = reg.counter("serving.fleet.autoscale.scale_downs")
    ups0, downs0 = ups.value(), downs.value()

    router = FleetRouter([spawn(0)], start=False, chaos=chaos,
                         spawn_fn=spawn, signals=True, signals_every=1,
                         autoscale=AutoscalerConfig(
                             min_replicas=1, max_replicas=3,
                             targets={"ttft_ms": {"p99": 100.0}},
                             up_threshold=1.0, down_threshold=0.25,
                             up_samples=2, down_samples=6,
                             cooldown_heartbeats=4))
    asc = router.autoscaler
    rng = np.random.default_rng(3)

    # phase 1: 4x overload
    futs = [router.submit(
        rng.integers(3, cfg.vocab_size,
                     int(rng.integers(4, 12))).astype(np.int32),
        max_new_tokens=6) for _ in range(12)]
    it_up = None
    for _ in range(60):
        chaos.tick_clock(20.0)
        router.step()
        if asc.counts["scale_ups"] and it_up is None:
            it_up = router.iteration
    router.run_until_idle()
    for f in futs:
        f.result(timeout=5)
    assert asc.counts["scale_ups"] >= 1, "overload never scaled up"
    assert it_up is not None and it_up <= 30, \
        f"scale-up came too late (iteration {it_up})"
    assert ups.value() >= ups0 + 1
    assert sum(1 for r in router.replicas() if r.accepting()) >= 2
    assert any(e["kind"] == "autoscale_up"
               for e in router._flight.entries())

    # phase 2: calm trickle — the burn decays, but ONLY after the
    # hysteresis streak does the fleet shrink
    scale_downs0 = asc.counts["scale_downs"]
    for _ in range(80):
        chaos.tick_clock(40.0)
        f = router.submit(
            rng.integers(3, cfg.vocab_size, 4).astype(np.int32),
            max_new_tokens=1)
        router.run_until_idle()
        f.result(timeout=5)
        if asc.counts["scale_downs"] > scale_downs0:
            break
    assert asc.counts["scale_downs"] >= 1, \
        f"calm fleet never scaled down: {asc.stats()}"
    assert downs.value() >= downs0 + 1
    # scale-down DRAINS (in-flight work finishes), never kills
    assert any(r.state == "drained" for r in router.replicas())
    assert any(e["kind"] == "autoscale_down"
               for e in router._flight.entries())
    live = sum(1 for r in router.replicas() if r.accepting())
    assert live >= 1 and asc.desired == live
    st = asc.stats()
    assert st["samples"] >= asc.config.up_samples
    router.close()


def test_breaker_open_blocks_every_scale_up(tiny_gpt):
    """Safety rail: replica 0 dies, resurrection spawns keep failing
    (crash loop), and THEN load breaches the SLO. The autoscaler must
    refuse to add capacity while the rail is open — spawning into a
    crash loop is how autoscalers melt fleets — and count each
    refusal."""
    cfg, params = tiny_gpt
    chaos = ChaosInjector().tick_clock(0).kill_replica_at(2, 0)
    spawn = _spawn_fn(params, cfg, chaos)
    calls = {"n": 0}

    def flaky_spawn(index):
        calls["n"] += 1
        raise RuntimeError("chaos: node pool exhausted")

    reg = global_registry()
    blocked = reg.counter("serving.fleet.autoscale.blocked")
    blocked0 = blocked.value()
    router = FleetRouter([spawn(0), spawn(1)], start=False, chaos=chaos,
                         spawn_fn=flaky_spawn, signals=True,
                         signals_every=1,
                         supervisor=SupervisorConfig(backoff_heartbeats=1,
                                                     max_crash_loops=8),
                         autoscale=AutoscalerConfig(
                             min_replicas=1, max_replicas=4,
                             targets={"ttft_ms": {"p99": 50.0}},
                             up_samples=1, down_samples=50,
                             cooldown_heartbeats=1))
    asc = router.autoscaler
    rng = np.random.default_rng(9)
    futs = [router.submit(
        rng.integers(3, cfg.vocab_size, 10).astype(np.int32),
        max_new_tokens=6) for _ in range(10)]
    for _ in range(40):
        chaos.tick_clock(20.0)
        router.step()
    router.run_until_idle()
    for f in futs:
        f.result(timeout=5)

    assert chaos.fired["replica_kill"] == 1
    assert calls["n"] >= 1, "the crash loop never tried to spawn"
    assert asc.counts["scale_ups"] == 0, \
        "scaled up while the breaker rail was open"
    assert asc.counts["blocked"] >= 1
    assert blocked.value() >= blocked0 + 1
    assert asc.stats()["rail_open"] is True
    assert any(e["kind"] == "scale_up_blocked"
               for e in router._flight.entries())
    router.close()


def test_bounds_hold_at_floor_and_ceiling(tiny_gpt):
    """min==max==1: neither overload nor calm may change the fleet
    size — the bounds are absolute, not advisory."""
    cfg, params = tiny_gpt
    chaos = ChaosInjector().tick_clock(0)
    spawn = _spawn_fn(params, cfg, chaos)
    router = FleetRouter([spawn(0)], start=False, chaos=chaos,
                         spawn_fn=spawn, signals=True, signals_every=1,
                         autoscale=AutoscalerConfig(
                             min_replicas=1, max_replicas=1,
                             targets={"ttft_ms": {"p99": 50.0}},
                             up_samples=1, down_samples=1,
                             cooldown_heartbeats=1))
    asc = router.autoscaler
    rng = np.random.default_rng(5)
    futs = [router.submit(
        rng.integers(3, cfg.vocab_size, 10).astype(np.int32),
        max_new_tokens=4) for _ in range(8)]
    for _ in range(30):
        chaos.tick_clock(20.0)
        router.step()
    router.run_until_idle()
    for f in futs:
        f.result(timeout=5)
    # calm phase: plenty of below-threshold samples
    for _ in range(12):
        chaos.tick_clock(40.0)
        f = router.submit(
            rng.integers(3, cfg.vocab_size, 4).astype(np.int32),
            max_new_tokens=1)
        router.run_until_idle()
        f.result(timeout=5)
    assert asc.counts["scale_ups"] == 0
    assert asc.counts["scale_downs"] == 0
    assert len(router.replicas()) == 1
    assert asc.desired == 1
    router.close()
