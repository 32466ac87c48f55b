"""Twins of tests/api/test_fleet_signals.py on the port
(paddle_tpu_torch), on the CPU. The tiny GPT is built by the port's own
startup program: the contracts here are structural (timelines, series,
billing, and ids against the port's own runs).

Fleet health signals: SeriesStore rings + registry
sampling, the declarative alert rule engine with its latched
lifecycle, per-tenant cost attribution threaded submit()→ledger, and
the acceptance storm — a supervised 3-replica fleet under injected
20 ms/iteration clocks whose alert timeline is bit-identical across
two runs, whose merged /series view keeps the killed replica's
history, and whose per-tenant decode sums match stream-callback
ground truth.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import framework
from paddle_tpu_torch.core.executor import Scope, scope_guard
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.observability.alerts import (AlertManager, AlertRule,
                                             empty_alerts)
from paddle_tpu_torch.observability.metrics import (MetricsRegistry,
                                              global_registry)
from paddle_tpu_torch.observability.serving_telemetry import (
    ServingTelemetry, SLOTracker)
from paddle_tpu_torch.observability.timeseries import (SeriesStore,
                                                 empty_series,
                                                 series_key)
from paddle_tpu_torch.robustness import ChaosInjector, SupervisorConfig
from paddle_tpu_torch.serving import (AdmissionPolicy, FleetRouter,
                                GenerationServer, GPTServingModel)

pytestmark = [pytest.mark.fleet, pytest.mark.serving]


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
                 start=False)


@pytest.fixture(scope="module")
def tiny_gpt():
    cfg = gpt.gpt_tiny()
    main, startup = framework.Program(), framework.Program()
    main.random_seed = startup.random_seed = 23
    scope = Scope()
    with framework.program_guard(main, startup):
        gpt.build_lm_net(cfg, seq_len=8)
    exe = fluid.Executor(fluid.CPUPlace())
    with scope_guard(scope):
        exe.run(startup)
    return cfg, gpt.load_params(scope, cfg)


def _server(params, cfg, **kw):
    merged = dict(SERVER_KW)
    merged.update(kw)
    return GenerationServer(GPTServingModel(params, cfg, device="cpu"),
                            device="cpu", **merged)


def _ticking_chaos(ms_of_iteration, n=600):
    chaos = ChaosInjector()
    for it in range(1, n):
        chaos.advance_clock_at(it, ms=ms_of_iteration(it))
    return chaos


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read().decode()


# ---------------------------------------------------------------------------
# SeriesStore: rings, sampling, payload
# ---------------------------------------------------------------------------

def test_series_ring_bounds_and_drop_oldest():
    s = SeriesStore(capacity=4, label="t")
    for i in range(10):
        s.observe("serving.x", float(i), float(i * i))
    pts = s.series("serving.x")
    assert len(pts) == 4
    assert pts == [(6.0, 36.0), (7.0, 49.0), (8.0, 64.0), (9.0, 81.0)]
    assert s.latest("serving.x") == (9.0, 81.0)
    p = s.payload()
    assert p["schema"] == "paddle_tpu.series/1"
    assert p["label"] == "t" and p["capacity"] == 4
    assert p["points"] == 10
    assert p["dropped_points"] == 6
    assert p["series"]["serving.x"]["dropped"] == 6
    # round trip keeps the ring and the accounting
    r = SeriesStore.from_dict(p)
    assert r.series("serving.x") == pts
    assert r.payload()["dropped_points"] == 6


def test_series_max_series_cap_counts_drops():
    s = SeriesStore(capacity=8, max_series=2)
    s.observe_many(1.0, (("a", 1.0), ("b", 2.0), ("c", 3.0),
                         ("d", 4.0)))
    assert s.names() == ["a", "b"]
    assert s.payload()["dropped_series"] == 2
    assert s.series("c") == []
    # an existing series still accepts points at the cap
    s.observe("a", 2.0, 5.0)
    assert s.latest("a") == (2.0, 5.0)


def test_series_registry_sampling_gauges_and_counter_rates():
    reg = MetricsRegistry()
    g = reg.gauge("serving.depth", "d")
    c = reg.counter("serving.done", "d")
    other = reg.gauge("executor.other", "outside the prefix")
    other.set(99)
    s = SeriesStore(capacity=16)
    g.set(3)
    g.labels(replica="r0").set(5)
    c.inc(10)
    n = s.sample(1.0, registry=reg)
    # first tick: gauges only — the counter tick just sets the baseline
    assert n == 2
    assert s.series("serving.done:rate") == []
    c.inc(30)
    g.set(4)
    s.sample(3.0, registry=reg)
    assert s.series("serving.depth") == [(1.0, 3.0), (3.0, 4.0)]
    assert s.series(series_key("serving.depth",
                               {"replica": "r0"})) == [(1.0, 5.0),
                                                       (3.0, 5.0)]
    # rate = delta / dt = 30 / 2
    assert s.series("serving.done:rate") == [(3.0, 15.0)]
    assert "executor.other" not in s.names()


def test_empty_series_shape():
    e = empty_series()
    assert e["schema"] == "paddle_tpu.series/1"
    assert e["series"] == {} and e["points"] == 0


# ---------------------------------------------------------------------------
# AlertManager: rule kinds + latched lifecycle
# ---------------------------------------------------------------------------

def test_threshold_rule_streak_and_latched_lifecycle():
    s = SeriesStore(capacity=64)
    events = []
    mgr = AlertManager(
        s, rules=[AlertRule.threshold_rule("deep", "q", 5.0,
                                           for_s=1.0)],
        label="t", on_event=lambda k, a, t: events.append((k, t)))
    s.observe("q", 0.0, 9.0)
    assert mgr.evaluate(0.0) == []          # streak just anchored
    s.observe("q", 0.9, 9.0)
    assert mgr.evaluate(0.9) == []          # 0.9 s < for_s
    s.observe("q", 1.0, 9.0)
    [(kind, alert)] = mgr.evaluate(1.0)
    assert kind == "fired" and alert["name"] == "deep"
    assert alert["fired_at"] == 1.0 and mgr.active == ["deep"]
    s.observe("q", 2.0, 2.0)                # recovers
    [(kind, alert)] = mgr.evaluate(2.0)
    assert kind == "resolved" and alert["resolved_at"] == 2.0
    assert mgr.state("deep") == "resolved" and mgr.active == []
    # a non-satisfying point resets the streak: a blip can't re-fire
    s.observe("q", 2.5, 9.0)
    assert mgr.evaluate(2.5) == []
    s.observe("q", 3.6, 9.0)
    [(kind, alert)] = mgr.evaluate(3.6)
    assert kind == "fired" and alert["fired_count"] == 2
    assert events == [("fired", 1.0), ("resolved", 2.0),
                      ("fired", 3.6)]


def test_delta_and_absence_rules():
    s = SeriesStore(capacity=64)
    mgr = AlertManager(s, rules=[
        AlertRule.delta("leak", "mem", 100.0, window_s=2.0),
        AlertRule.absence("stale", "beat", window_s=1.0)])
    s.observe("mem", 0.0, 1000.0)
    s.observe("beat", 0.0, 1.0)
    assert mgr.evaluate(0.0) == []
    s.observe("mem", 1.0, 1050.0)
    s.observe("beat", 1.0, 1.0)
    assert mgr.evaluate(1.0) == []          # +50 in window, beat fresh
    s.observe("mem", 2.0, 1200.0)           # +200 across the window
    s.observe("beat", 2.0, 1.0)
    events = dict(mgr.evaluate(2.0))
    assert events["fired"]["name"] == "leak"
    assert events["fired"]["last_value"] == 200.0
    assert mgr.state("stale") == "ok"       # beat is fresh
    events = dict(mgr.evaluate(3.5))        # beat now 1.5 s stale
    assert events["fired"]["name"] == "stale"
    s.observe("beat", 3.6, 1.0)
    events = dict(mgr.evaluate(3.7))
    assert events["resolved"]["name"] == "stale"


def test_burn_rate_needs_both_windows():
    s = SeriesStore(capacity=64)
    mgr = AlertManager(s, rules=[
        AlertRule.burn_rate("burn", "b", 1.0, fast_s=1.0, slow_s=4.0)])
    # a single-tick spike: fast mean crosses, slow mean (diluted by
    # history) does not -> no page
    for t in range(4):
        s.observe("b", float(t), 0.1)
    s.observe("b", 4.0, 3.0)       # fast mean 1.55, slow mean 0.68
    assert mgr.evaluate(4.0) == []
    # sustained burn: both windows' means cross -> fires
    s.observe("b", 5.0, 3.0)
    s.observe("b", 6.0, 3.0)
    [(kind, alert)] = mgr.evaluate(6.0)
    assert kind == "fired"
    # recovery drains the fast window first; once the slow window's
    # mean decays too the alert resolves
    for t in (7.0, 8.0, 9.0, 10.0, 11.0):
        s.observe("b", t, 0.0)
    [(kind, _)] = mgr.evaluate(11.0)
    assert kind == "resolved"


def test_alert_metrics_payload_and_duplicate_rule():
    reg = global_registry()
    fired0 = reg.counter("serving.alerts.fired", "x").value()
    s = SeriesStore(capacity=16)
    mgr = AlertManager(s, rules=[
        AlertRule.threshold_rule("hot", "v", 1.0)], label="m")
    with pytest.raises(ValueError):
        mgr.add_rule(AlertRule.absence("hot", "v"))
    s.observe("v", 1.0, 5.0)
    mgr.evaluate(1.0)
    assert reg.counter("serving.alerts.fired", "x").value() == \
        fired0 + 1
    assert reg.gauge("serving.alerts.active", "x").value() == 1
    p = mgr.payload()
    assert p["schema"] == "paddle_tpu.alerts/1"
    assert p["label"] == "m" and p["rules"] == 1 and p["active"] == 1
    assert p["alerts"][0]["state"] == "firing"
    assert p["alerts"][0]["rule"] == {"kind": "threshold",
                                      "name": "hot", "series": "v",
                                      "op": ">", "threshold": 1.0,
                                      "for_s": 0.0}
    assert mgr.stats() == {"rules": 1, "active": 1, "evaluations": 1}
    s.observe("v", 2.0, 0.0)
    mgr.evaluate(2.0)
    assert reg.gauge("serving.alerts.active", "x").value() == 0
    mgr.drop_gauges()
    e = empty_alerts()
    assert e["schema"] == "paddle_tpu.alerts/1" and e["alerts"] == []


# ---------------------------------------------------------------------------
# SLOTracker: bounded window history + the no-copy burn read
# ---------------------------------------------------------------------------

def test_slo_recent_windows_bounded():
    t = [0.0]
    trk = SLOTracker(clock=lambda: t[0], window_s=1.0,
                     recent_windows=4)
    for i in range(20):
        t[0] = float(i)
        trk.observe("ttft_ms", 10.0 + i)
        trk.maybe_roll()
    snap = trk.snapshot()
    assert trk.windows_completed >= 10
    assert len(snap["recent_windows"]) == 4
    # the deque keeps the NEWEST windows
    assert snap["recent_windows"][-1] == snap["last_window"]


def test_window_frac_over_matches_window_digest():
    t = [0.0]
    trk = SLOTracker(clock=lambda: t[0], window_s=10.0)
    assert trk.window_frac_over("ttft_ms", 5.0) == (None, 0)
    for i, v in enumerate((1.0, 2.0, 3.0, 40.0, 50.0)):
        t[0] = float(i)
        trk.observe("ttft_ms", v)
    frac, n = trk.window_frac_over("ttft_ms", 5.0)
    assert n == 5
    d = trk.window_digest("ttft_ms")
    assert frac == pytest.approx(1.0 - d.rank(5.0))
    assert frac == pytest.approx(2.0 / 5.0, abs=0.21)
    # spans the live + previous window after a rollover
    t[0] = 11.0
    trk.maybe_roll()
    trk.observe("ttft_ms", 60.0)
    frac, n = trk.window_frac_over("ttft_ms", 5.0)
    assert n == 6
    assert frac == pytest.approx(1.0 - trk.window_digest(
        "ttft_ms").rank(5.0))


# ---------------------------------------------------------------------------
# per-tenant cost attribution, engine level
# ---------------------------------------------------------------------------

def test_engine_tenant_attribution_matches_stream_ground_truth(
        tiny_gpt):
    cfg, params = tiny_gpt
    chaos = _ticking_chaos(lambda it: 10.0)
    srv = _server(params, cfg, chaos=chaos, telemetry=True)
    rng = np.random.default_rng(3)
    got = {}

    def stream_for(key):
        def cb(_rid, _tok):
            got[key] = got.get(key, 0) + 1
        return cb

    futs, plan = [], []
    for i in range(7):
        tenant = ("acme", "globex", None)[i % 3]
        key = "<anon>" if tenant is None else tenant
        p = rng.integers(3, cfg.vocab_size,
                         int(rng.integers(4, 12))).astype(np.int32)
        futs.append(srv.submit(p, max_new_tokens=3 + i,
                               tenant=tenant, stream=stream_for(key)))
        plan.append((key, len(p)))
    srv.run_until_idle()
    for f in futs:
        f.result(timeout=5)
    snap = srv.get_stats()["tenants"]
    assert sorted(snap["tenants"]) == ["<anon>", "acme", "globex"]
    for key, entry in snap["tenants"].items():
        assert entry["decode_tokens"] == got[key]
        assert entry["prefill_tokens"] == sum(
            n for k, n in plan if k == key)
        assert entry["requests"] == sum(1 for k, _ in plan if k == key)
        assert entry["block_iterations"] > 0
        # the ledger's latency digests saw every retired request
        assert entry["slo"]["ttft_ms"]["count"] == entry["requests"]
        assert entry["slo"]["e2e_ms"]["count"] == entry["requests"]
    srv.close()


def test_tenant_cardinality_collapses_to_other(tiny_gpt):
    cfg, params = tiny_gpt
    tel = ServingTelemetry(max_tenants=2)
    srv = _server(params, cfg, telemetry=tel)
    futs = [srv.submit([5, 6, 7], max_new_tokens=2,
                       tenant=f"tenant{i}") for i in range(5)]
    srv.run_until_idle()
    for f in futs:
        f.result(timeout=5)
    snap = tel.tenants.snapshot()
    assert sorted(snap["tenants"]) == ["<other>", "tenant0", "tenant1"]
    assert snap["tenants"]["<other>"]["requests"] == 3
    # every ledger touch past the cap counts (finish + latency
    # observes), so >= one per collapsed request
    assert snap["collapsed"] >= 3
    srv.close()


# ---------------------------------------------------------------------------
# the acceptance storm: deterministic alert timeline on a supervised
# fleet, dead-replica series survival, tenant ground truth
# ---------------------------------------------------------------------------

def _storm_run(params, cfg, name):
    """One full storm pass; returns (alert timeline payload, merged
    series payload, tenant snapshot, per-tenant stream token counts,
    result ids)."""
    chaos = _ticking_chaos(lambda it: 20.0).kill_replica_at(8, 0)

    def spawn(_index):
        # 0.25 s SLO windows (12-13 iterations of injected clock):
        # the rolling ~2-window burn view must decay within the
        # test's horizon for the burn alert to resolve
        return _server(params, cfg, chaos=chaos, telemetry=True,
                       slo_window_s=0.25)

    rules = [
        AlertRule.threshold_rule(
            "replica-down",
            f"serving.fleet.replicas{{router={name}}}", 3.0, op="<"),
        AlertRule.burn_rate(
            "ttft-burn", "slo.window_burn.ttft_ms.p99", 1.0,
            fast_s=0.5, slow_s=1.0),
    ]
    router = FleetRouter(
        [spawn(i) for i in range(3)], start=False, chaos=chaos,
        spawn_fn=spawn, name=name,
        # p99 TTFT target 100 ms: queued overload requests wait 8+
        # iterations (160 ms+) of injected clock, so the windowed
        # burn crosses; the huge burn_threshold means nothing sheds
        admission=AdmissionPolicy({"ttft_ms": {"p99": 100.0}},
                                  burn_threshold=1e9),
        signals=True, signals_every=1, alert_rules=rules,
        supervisor=SupervisorConfig(backoff_heartbeats=1,
                                    warm_chains=2))
    rng = np.random.default_rng(9)
    tenants = ("acme", "globex", None)
    got = {}

    def stream_for(key):
        def cb(_rid, _tok):
            got[key] = got.get(key, 0) + 1
        return cb

    futs = []
    # overload wave: 12 requests onto 9 slots — queued requests wait
    # > 500 ms of injected clock, the windowed p99 burn crosses 1.0
    for i in range(12):
        tenant = tenants[i % 3]
        key = "<anon>" if tenant is None else tenant
        p = rng.integers(3, cfg.vocab_size,
                         int(rng.integers(4, 12))).astype(np.int32)
        futs.append(router.submit(p, max_new_tokens=8, tenant=tenant,
                                  stream=stream_for(key)))
    router.run_until_idle()
    # calm waves: 3 distinct-prompt requests at a time, so every
    # ORIGINAL replica keeps iterating — their high scheduler
    # iteration counters are what still consume clock advances (the
    # resurrected replica restarts at iteration 0, whose advances the
    # storm already spent). Fresh SLO windows close with sub-target
    # TTFTs, the storm's burn points age out of the 1 s slow window,
    # the alert resolves.
    for w in range(12):
        wave = []
        for i in range(3):
            tenant = tenants[i]
            key = "<anon>" if tenant is None else tenant
            wave.append(router.submit(
                [7 + w, 8 + w, 9 + i], max_new_tokens=6,
                tenant=tenant, stream=stream_for(key)))
        router.run_until_idle()
        for f in wave:
            f.result(timeout=5)
        futs.extend(wave)
    ids = [list(f.result(timeout=5).token_ids) for f in futs]
    assert chaos.fired["replica_kill"] == 1
    st = router.get_stats()
    assert st["live_replicas"] == 3
    alerts = router._alerts.payload()
    merged = router.dump_signals()
    tenants_snap = router.tenant_stats()
    router.close()
    return alerts, merged, tenants_snap, got, ids


def test_storm_alert_timeline_deterministic_and_complete(tiny_gpt):
    cfg, params = tiny_gpt
    a1, m1, t1, got1, ids1 = _storm_run(params, cfg, "storm-a")
    a2, m2, t2, got2, ids2 = _storm_run(params, cfg, "storm-b")

    # -- (1) the timeline is REPRODUCIBLE: same stamps, same counts --
    def timeline(p):
        return [(a["name"], a["state"], a["fired_at"],
                 a["resolved_at"], a["fired_count"],
                 a["resolved_count"]) for a in p["alerts"]]

    assert timeline(a1) == timeline(a2)
    assert ids1 == ids2

    by_name = {a["name"]: a for a in a1["alerts"]}
    # -- (2) the kill fired replica-down and resurrection resolved it
    down = by_name["replica-down"]
    assert down["fired_count"] >= 1 and down["state"] == "resolved"
    assert down["resolved_at"] > down["fired_at"]
    # -- (3) the overload fired the burn alert within the fast window
    # of the first sampled burn point, and recovery resolved it
    burn = by_name["ttft-burn"]
    assert burn["fired_count"] >= 1
    assert burn["state"] == "resolved"
    burn_series = None
    for src in m1["series"]["sources"]:
        if src["name"].startswith("fleet router"):
            burn_series = src["series"].get(
                "slo.window_burn.ttft_ms.p99")
    assert burn_series is not None and burn_series["points"]
    first_hot = next(t for t, v in burn_series["points"] if v > 1.0)
    assert burn["fired_at"] <= first_hot + 0.5 + 0.25

    # -- (4) the killed replica's series history survived the merge --
    dead = [s["name"] for s in m1["series"]["sources"]
            if "(dead)" in s["name"]]
    assert dead, "killed replica's series missing from merged view"
    live_engine = [s for s in m1["series"]["sources"]
                   if s["name"].startswith("replica")
                   and "(dead)" not in s["name"]]
    assert len(live_engine) == 3
    for src in live_engine + \
            [s for s in m1["series"]["sources"]
             if "(dead)" in s["name"]]:
        assert "engine.step_ms" in src["series"]

    # -- (5) per-tenant decode sums match stream-callback ground truth
    # — exactly for tenants the kill never touched; a failed-over
    # tenant is billed MORE than it streamed (replay re-decodes the
    # already-delivered prefix without re-emitting it: the flops were
    # spent twice and the ledger says so), bounded by max_new per
    # failover
    snap = t1["tenants"]
    assert sorted(snap) == ["<anon>", "acme", "globex"]
    for key, entry in snap.items():
        if entry["failovers"] == 0:
            assert entry["decode_tokens"] == got1[key], key
        else:
            replayed = entry["decode_tokens"] - got1[key]
            assert 0 <= replayed <= entry["failovers"] * 8, key
    assert sum(e["requests"] for e in snap.values()) >= 48
    # the kill's in-flight requests billed failovers to their tenants
    assert sum(e["failovers"] for e in snap.values()) >= 1
    assert a1["evaluations"] > 0


def test_storm_ids_bitwise_with_signals_off(tiny_gpt):
    """The signal plane must be write-path-passive: the same stream
    through signals=False produces bitwise-identical token ids."""
    cfg, params = tiny_gpt
    rng = np.random.default_rng(5)
    prompts = [rng.integers(3, cfg.vocab_size,
                            int(rng.integers(4, 12))).astype(np.int32)
               for _ in range(6)]

    def run(signals):
        router = FleetRouter(
            [_server(params, cfg, telemetry=True) for _ in range(2)],
            start=False, signals=signals, signals_every=1,
            admission=AdmissionPolicy({"ttft_ms": {"p99": 1e9}},
                                      burn_threshold=1e9))
        futs = [router.submit(p, max_new_tokens=6,
                              tenant=("t0" if signals else None))
                for p in prompts]
        router.run_until_idle()
        ids = [list(f.result(timeout=5).token_ids) for f in futs]
        router.close()
        return ids

    assert run(True) == run(False)


# ---------------------------------------------------------------------------
# endpoints
# ---------------------------------------------------------------------------

def test_router_series_alerts_tenants_endpoints(tiny_gpt):
    cfg, params = tiny_gpt
    router = FleetRouter(
        [_server(params, cfg, telemetry=True) for _ in range(2)],
        start=False, signals=True, signals_every=1,
        admission=AdmissionPolicy({"ttft_ms": {"p99": 1e9}},
                                  burn_threshold=1e9),
        alert_rules=[AlertRule.absence("quiet", "engine.step_ms",
                                       window_s=1e9)])
    exp = router.serve_metrics(port=0)
    fut = router.submit([5, 6, 7, 8], max_new_tokens=4, tenant="acme")
    router.run_until_idle()
    fut.result(timeout=5)

    code, body = _get(f"{exp.url}/series")
    assert code == 200
    p = json.loads(body)
    assert p["schema"] == "paddle_tpu.series_fleet/1"
    assert p["router"] == router.name
    names = [s["name"] for s in p["sources"]]
    assert names[0] == f"fleet router {router.name}"
    assert len([n for n in names if n.startswith("replica")]) == 2
    fleet_series = p["sources"][0]["series"]
    assert any(k.startswith("serving.fleet.replicas")
               for k in fleet_series)

    code, body = _get(f"{exp.url}/alerts")
    assert code == 200
    p = json.loads(body)
    assert p["schema"] == "paddle_tpu.alerts/1"
    assert p["rules"] == 1 and p["alerts"][0]["name"] == "quiet"

    code, body = _get(f"{exp.url}/tenants")
    assert code == 200
    p = json.loads(body)
    assert p["tenants"]["acme"]["requests"] == 1
    assert p["tenants"]["acme"]["decode_tokens"] == 4

    # the 404 help body names the new routes
    try:
        _get(f"{exp.url}/nope")
        assert False, "404 expected"
    except urllib.error.HTTPError as e:
        assert e.code == 404
        help_body = e.read().decode()
        for route in ("/series", "/alerts", "/tenants"):
            assert route in help_body
    router.close()


def test_engine_endpoints_without_signal_plane(tiny_gpt):
    """A bare engine still answers /series (its own store), /alerts
    (the empty shape) and /tenants — scrape configs stay uniform."""
    cfg, params = tiny_gpt
    srv = _server(params, cfg, telemetry=True)
    exp = srv.serve_metrics(port=0)
    fut = srv.submit([4, 5, 6], max_new_tokens=2)
    srv.run_until_idle()
    fut.result(timeout=5)
    code, body = _get(f"{exp.url}/series")
    assert code == 200
    p = json.loads(body)
    assert p["schema"] == "paddle_tpu.series/1"
    assert "engine.step_ms" in p["series"]
    code, body = _get(f"{exp.url}/alerts")
    assert json.loads(body) == empty_alerts()
    code, body = _get(f"{exp.url}/tenants")
    assert json.loads(body)["tenants"]["<anon>"]["requests"] == 1
    srv.close()
