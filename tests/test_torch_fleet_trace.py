"""Twins of tests/api/test_fleet_trace.py on the port
(paddle_tpu_torch), on the CPU. The tiny GPT is built by the port's own
startup program; the contracts are structural (trace ids, hops, merged
dumps, rings) and against the port's own untraced runs. Two reference
tests of this file have failed in full-suite runs under six workers
(test_trace_buffer_bounds_annotate_truncation and
test_trace_endpoint_serves_completed_ring): their twins are held to the
bounds and ring contents the tracer's rules give, not to the JAX run.

Fleet-wide distributed tracing (observability/fleet_trace.py +
serving/router.py wiring).

Tier-1 (`fleet` marker): manual-drive replicas pumped by the router's
step() loop, zero sleeps. The contract under test:

- ONE trace id per request across every hop: a failed-over request's
  span trees land on BOTH replicas' captures under the same router-
  minted trace id, with monotone stamps (hop 1 strictly after hop 0)
  and per-replica process groups in the merged Perfetto dump — the
  dying replica's capture snapshotted at teardown so the victim's
  half survives;
- the SAMPLING verdict is minted ONCE at the router and propagated in
  the trace context: engines never re-hash their replica-local rid
  (which changes on failover), so a request is traced on all hops or
  none — regression-locked in both directions (router off beats
  engine all; router sampled beats engine off) and across a kill;
- per-replica trace rings are bounded drop-oldest
  (`tracing.dropped_events` counts) and the merged dump annotates
  truncation so a partial capture is never mistaken for complete;
- the `/trace` exporter endpoint serves the bounded completed-trace
  ring, joins the 404 help body, and its scrapes land on
  `exporter.requests` with unknown paths still collapsing to
  `<other>`;
- `tools/request_trace.py` reconstructs one rid's end-to-end lineage
  from the merged dump (route → failover → re-route, quarantine
  verdict included);
- THE storm e2e (kill + hang + poison on a supervised 3-replica
  fleet, injected clocks): one merged dump, the quarantined request's
  trace records every implicated hop, and tracing-on vs off token ids
  are bitwise identical.
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
from paddle_tpu_torch.observability.fleet_trace import mint_trace_id
from paddle_tpu_torch.observability.metrics import global_registry
from paddle_tpu_torch.observability.serving_telemetry import (ServingTelemetry,
                                                        _rid_hash01)
from paddle_tpu_torch.robustness import (ChaosInjector, PoisonRequestError,
                                   SupervisorConfig)
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
    main.random_seed = startup.random_seed = 17
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


def _reference_ids(params, cfg, prompts, n_new):
    srv = _server(params, cfg)
    futs = [srv.submit(p, max_new_tokens=n_new) for p in prompts]
    srv.run_until_idle()
    ids = [list(f.result(timeout=5).token_ids) for f in futs]
    srv.close()
    return ids


def _request_roots(dump):
    """{trace_id: [(pid, hop, ts_us, dur_us)]} over per-replica
    request-root spans carrying a trace id."""
    out = {}
    for e in dump["traceEvents"]:
        if e.get("cat") != "serving.request" or \
                not e.get("name", "").startswith("request "):
            continue
        tid = e.get("args", {}).get("trace_id")
        if tid is None:
            continue
        out.setdefault(tid, []).append(
            (e["pid"], e["args"].get("hop"), e["ts"], e.get("dur", 0)))
    return out


def _fleet_events(dump, name):
    return [e for e in dump["traceEvents"]
            if e.get("cat") == "serving.fleet" and e.get("name") == name]


# ---------------------------------------------------------------------------
# one trace id across a failover, per-replica process groups
# ---------------------------------------------------------------------------

def test_failover_spans_chain_under_one_trace_id(tiny_gpt):
    cfg, params = tiny_gpt
    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, cfg.vocab_size,
                            int(rng.integers(9, 20))).astype(np.int32)
               for _ in range(4)]
    ref_ids = _reference_ids(params, cfg, prompts, 6)

    reg = global_registry()
    req0 = reg.counter("serving.fleet.trace.requests").value()
    chaos = ChaosInjector().kill_replica_at(3, 0)
    router = FleetRouter([_server(params, cfg) for _ in range(2)],
                         start=False, chaos=chaos,
                         supervisor=SupervisorConfig(resurrect=False))
    router.start_trace()
    futs = [router.submit(p, max_new_tokens=6) for p in prompts]
    router.run_until_idle()
    # tracing-on vs tracing-off (the reference engine): BITWISE ids
    ids = [list(f.result(timeout=5).token_ids) for f in futs]
    assert ids == ref_ids

    dump = router.dump_trace()
    # per-replica PROCESS groups, the dead victim's snapshot included
    names = [s["name"] for s in dump["otherData"]["sources"]]
    assert f"fleet router {router.name}" in names
    assert "replica r0 gen0 (dead)" in names     # snapshotted victim
    assert "replica r1" in names
    assert dump["otherData"]["truncated"] is False
    # the killed replica's in-flight requests chain across BOTH
    # replicas under one trace id, hop 1 strictly after hop 0
    roots = _request_roots(dump)
    moved = {t: sorted(v, key=lambda x: x[1]) for t, v in roots.items()
             if len({pid for pid, *_ in v}) > 1}
    assert moved, "no failed-over request spans found"
    for _tid, hops in moved.items():
        assert [h[1] for h in hops] == list(range(len(hops)))
        for a, b in zip(hops, hops[1:]):
            assert b[2] >= a[2] + a[3]      # monotone: starts after
            #                                 the previous hop ended
    # route decisions carry policy + affinity depth + candidate loads
    routes = _fleet_events(dump, "route")
    assert len(routes) == len(prompts) + router.counts["failovers"]
    for e in routes:
        assert {"trace_id", "hop", "rid", "replica", "policy",
                "affinity_depth", "candidate_loads"} <= set(e["args"])
    # the failover instant names cause and source->target
    fo = _fleet_events(dump, "failover")
    assert fo and fo[0]["args"]["source"] == "r0"
    assert fo[0]["args"]["cause"] == "RequestCancelled"
    assert fo[0]["args"]["target"] == "r1"
    # the kill landed on the fleet track too
    assert _fleet_events(dump, "replica_kill")
    # /trace ring: the victim's summary records both hops
    payload = router._tracer.completed_payload()
    assert payload["recorded"] == len(prompts)
    victims = [t for t in payload["traces"] if t["attempts"] >= 1]
    assert victims
    assert [h["replica"] for h in victims[0]["hops"]] == ["r0", "r1"]
    assert victims[0]["trace_id"] in moved
    # trace ids are the deterministic mint (injected-clock-safe)
    assert {t["trace_id"] for t in payload["traces"]} == {
        mint_trace_id(router.name, t["rid"]) for t in payload["traces"]}
    # metrics moved (zz-lint coverage for serving.fleet.trace.*)
    assert reg.counter("serving.fleet.trace.requests").value() \
        >= req0 + len(prompts)
    assert reg.counter("serving.fleet.trace.completed").value() >= 4
    assert reg.counter("serving.fleet.trace.dumps").value() >= 1
    assert router.get_stats()["trace"]["enabled"] is True
    router.close()


# ---------------------------------------------------------------------------
# sampling: minted ONCE at the router, consistent across hops
# ---------------------------------------------------------------------------

def test_sampling_verdict_minted_once_at_router(tiny_gpt):
    cfg, params = tiny_gpt
    rng = np.random.default_rng(2)
    prompts = [rng.integers(3, cfg.vocab_size, 10).astype(np.int32)
               for _ in range(6)]

    # router OFF beats engine ALL: engines default to tracing every
    # request, but the router's verdict rides the context
    router = FleetRouter([_server(params, cfg) for _ in range(2)],
                         start=False, trace_sample="off")
    router.start_trace()
    futs = [router.submit(p, max_new_tokens=4) for p in prompts]
    router.run_until_idle()
    for f in futs:
        f.result(timeout=5)
    dump = router.dump_trace()
    assert not _request_roots(dump)
    # the verdict governs EVERY artifact: no per-request fleet
    # instants either (unsampled traffic must not churn the bounded
    # fleet ring out from under sampled requests)
    assert not _fleet_events(dump, "route")
    assert router._tracer.completed_payload()["recorded"] == 0
    for r in router.replicas():
        assert r.server.telemetry.stats()["trace_requests"]["traced"] \
            == 0
    router.close()

    # router SAMPLED beats engine OFF, and the one verdict survives a
    # kill: every hop of a sampled request is traced, no hop of an
    # unsampled one — engines never re-hash their replica-local rid
    rate = 0.6
    chaos = ChaosInjector().kill_replica_at(3, 0)
    router = FleetRouter(
        [_server(params, cfg,
                 telemetry=ServingTelemetry(sample="off"))
         for _ in range(2)],
        start=False, chaos=chaos, trace_sample=f"sampled:{rate}",
        supervisor=SupervisorConfig(resurrect=False))
    router.start_trace()
    futs = [router.submit(p, max_new_tokens=6) for p in prompts]
    router.run_until_idle()
    for f in futs:
        f.result(timeout=5)
    dump = router.dump_trace()
    roots = _request_roots(dump)
    expected = {mint_trace_id(router.name, rid)
                for rid in range(len(prompts))
                if _rid_hash01(rid) < rate}
    assert 0 < len(expected) < len(prompts)     # the rate actually
    #                                             splits this stream
    assert set(roots) == expected
    # cross-hop consistency through the kill: every traced request
    # has EVERY one of its hops in the dump (hop numbers contiguous
    # from 0), and its /trace summary agrees
    payload = router._tracer.completed_payload()
    by_tid = {t["trace_id"]: t for t in payload["traces"]}
    assert set(by_tid) == expected
    for tid, spans in roots.items():
        hops = sorted(h for _pid, h, *_ in spans)
        assert hops == list(range(len(by_tid[tid]["hops"])))
    # at least one sampled request actually failed over (else this
    # proves nothing about hops)
    assert any(t["attempts"] >= 1 for t in payload["traces"])
    # fleet route instants obey the same verdict
    assert {e["args"]["trace_id"]
            for e in _fleet_events(dump, "route")} <= expected
    router.close()


def test_submit_shed_closes_trace_ring_and_names_collide_safely(
        tiny_gpt):
    """A submit-time shed is a terminal outcome like any other: its
    /trace ring summary is recorded even with the span capture off
    (the ring is the only live trace plane in the default posture).
    And two routers sharing one EXPLICIT name still mint distinct
    trace ids — duplicate names must not conflate lineages."""
    from paddle_tpu_torch.serving import AdmissionRejected
    cfg, params = tiny_gpt
    rng = np.random.default_rng(12)
    prompt = rng.integers(3, cfg.vocab_size, 10).astype(np.int32)
    router = FleetRouter([_server(params, cfg)], start=False)
    router.drain_replica(0)     # nothing accepting -> capacity shed
    with pytest.raises(AdmissionRejected):
        router.submit(prompt, max_new_tokens=4)
    ring = router._tracer.completed_payload()
    assert ring["recorded"] == 1
    assert ring["traces"][0]["outcome"] == "shed"
    assert ring["traces"][0]["reason"] == "capacity"
    assert ring["traces"][0]["hops"] == []
    router.close()

    a = FleetRouter([_server(params, cfg)], start=False, name="prod")
    b = FleetRouter([_server(params, cfg)], start=False, name="prod")
    fa = a.submit(prompt, max_new_tokens=2)
    fb = b.submit(prompt, max_new_tokens=2)
    a.run_until_idle(), b.run_until_idle()
    fa.result(timeout=5), fb.result(timeout=5)
    ta = a._tracer.completed_payload()["traces"][0]["trace_id"]
    tb = b._tracer.completed_payload()["traces"][0]["trace_id"]
    assert fa.request_id == fb.request_id == 0
    assert ta != tb
    a.close(), b.close()


def test_untraced_fleet_keeps_global_recorder_capture(tiny_gpt):
    """Replica recorders bind to the fleet tracer LAZILY at
    start_trace(): a fleet that never opts into fleet tracing keeps
    its replicas' span trees on the process-wide recorder, so the
    pre-existing profiler/global-capture workflow still sees them
    (and the router-minted trace_id rides their args even there)."""
    from paddle_tpu_torch.observability.tracing import get_recorder
    cfg, params = tiny_gpt
    rng = np.random.default_rng(11)
    router = FleetRouter([_server(params, cfg) for _ in range(2)],
                         start=False)
    rec = get_recorder()
    rec.start()
    try:
        fut = router.submit(rng.integers(3, cfg.vocab_size,
                                         10).astype(np.int32),
                            max_new_tokens=4)
        router.run_until_idle()
        fut.result(timeout=5)
    finally:
        rec.stop()
    roots = [e for e in rec.events()
             if e.get("cat") == "serving.request"
             and e["name"].startswith("request ")]
    rec.clear()
    assert len(roots) == 1
    assert roots[0]["args"]["trace_id"] == mint_trace_id(
        router.name, fut.request_id)
    router.close()


def test_cancel_while_failover_queued_still_closes_trace(tiny_gpt):
    """A client cancel landing between a replica death and the router
    draining its queued failover event must still close the request's
    /trace summary (outcome 'cancelled', recorded exactly once)."""
    cfg, params = tiny_gpt
    rng = np.random.default_rng(9)
    router = FleetRouter([_server(params, cfg) for _ in range(2)],
                         start=False)
    fut = router.submit(rng.integers(3, cfg.vocab_size,
                                     12).astype(np.int32),
                        max_new_tokens=8)
    for _ in range(2):
        router.step()       # admitted + prefilling on some replica
    serving = next(r for r in router.replicas()
                   if r.server._sched.has_work())
    # the kill fails the replica future -> its done callback ENQUEUES
    # the failover; the cancel lands before step() drains it
    router.kill_replica(serving.index)
    fut.cancel()
    router.run_until_idle()
    ring = router._tracer.completed_payload()
    mine = [t for t in ring["traces"] if t["rid"] == fut.request_id]
    assert len(mine) == 1
    assert mine[0]["outcome"] == "cancelled"
    router.close()


# ---------------------------------------------------------------------------
# bounded rings: drops counted, merged dump annotated
# ---------------------------------------------------------------------------

def test_trace_buffer_bounds_annotate_truncation(tiny_gpt, monkeypatch):
    cfg, params = tiny_gpt
    monkeypatch.setenv("PADDLE_TPU_TRACE_BUFFER", "25")
    rng = np.random.default_rng(3)
    reg = global_registry()
    dropped0 = reg.counter("tracing.dropped_events").value()
    router = FleetRouter([_server(params, cfg)], start=False)
    router.start_trace()
    futs = [router.submit(rng.integers(3, cfg.vocab_size,
                                       12).astype(np.int32),
                          max_new_tokens=6) for _ in range(8)]
    router.run_until_idle()
    for f in futs:
        f.result(timeout=5)
    dump = router.dump_trace()
    # the per-replica ring dropped oldest events, counted the drops,
    # and the merged dump says so — a partial capture is never
    # mistaken for a complete one
    assert reg.counter("tracing.dropped_events").value() > dropped0
    assert dump["otherData"]["truncated"] is True
    per_source = {s["name"]: s["dropped_events"]
                  for s in dump["otherData"]["sources"]}
    assert per_source["replica r0"] > 0
    router.close()


# ---------------------------------------------------------------------------
# the /trace endpoint
# ---------------------------------------------------------------------------

def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read().decode()


def test_trace_endpoint_serves_completed_ring(tiny_gpt):
    cfg, params = tiny_gpt
    rng = np.random.default_rng(4)
    router = FleetRouter([_server(params, cfg) for _ in range(2)],
                         start=False)
    exp = router.serve_metrics(port=0)
    fut = router.submit(rng.integers(3, cfg.vocab_size,
                                     10).astype(np.int32),
                        max_new_tokens=4)
    router.run_until_idle()
    fut.result(timeout=5)
    code, body = _get(f"{exp.url}/trace")
    assert code == 200
    payload = json.loads(body)
    assert payload["schema"] == "paddle_tpu.trace_ring/1"
    assert payload["router"] == router.name
    assert payload["recorded"] == 1 and len(payload["traces"]) == 1
    tr = payload["traces"][0]
    assert tr["outcome"] == "retired" and tr["hops"][0]["hop"] == 0
    assert tr["trace_id"] == mint_trace_id(router.name, tr["rid"])
    # /trace joins the 404 help body next to the older routes
    try:
        _get(f"{exp.url}/nope")
        assert False, "404 expected"
    except urllib.error.HTTPError as e:
        assert e.code == 404
        help_body = e.read().decode()
        for route in ("/metrics", "/healthz", "/slo", "/memory",
                      "/trace"):
            assert route in help_body
    # scrape accounting on the SERVED registry: /trace is a known
    # path label, the unknown probe still collapses to <other>
    series = {tuple(sorted(lbl.items())): c.value()
              for lbl, c in global_registry().counter(
                  "exporter.requests").series()}
    assert series[(("code", "200"), ("path", "/trace"))] >= 1
    assert series[(("code", "404"), ("path", "<other>"))] >= 1
    assert not any(dict(lbl).get("path") == "/nope" for lbl in series)
    router.close()


def test_engine_endpoint_serves_empty_trace_ring(tiny_gpt):
    """A component without a trace plane still answers /trace (an
    always-probeable empty ring), so scrape configs stay uniform."""
    cfg, params = tiny_gpt
    srv = _server(params, cfg)
    exp = srv.serve_metrics(port=0)
    code, body = _get(f"{exp.url}/trace")
    assert code == 200
    payload = json.loads(body)
    assert payload["traces"] == [] and payload["capacity"] == 0
    srv.close()


# ---------------------------------------------------------------------------
# request-lineage reconstruction (tools/request_trace.py)
# ---------------------------------------------------------------------------

def test_request_trace_reconstructs_failover_lineage(tiny_gpt):
    import tools.request_trace as rt

    cfg, params = tiny_gpt
    rng = np.random.default_rng(5)
    chaos = ChaosInjector().kill_replica_at(3, 0)
    router = FleetRouter([_server(params, cfg) for _ in range(2)],
                         start=False, chaos=chaos, trace=True,
                         supervisor=SupervisorConfig(resurrect=False))
    futs = [router.submit(rng.integers(3, cfg.vocab_size,
                                       12).astype(np.int32),
                          max_new_tokens=5) for _ in range(3)]
    router.run_until_idle()
    for f in futs:
        f.result(timeout=5)
    victim = next(t for t in router._tracer.completed_payload()["traces"]
                  if t["attempts"] >= 1)
    dump = router.dump_trace()
    router.close()

    assert rt.find_trace_id(dump, victim["rid"]) == victim["trace_id"]
    rows = rt.build_timeline(dump, victim["trace_id"])
    assert rows == sorted(rows, key=lambda r: r["ts_ms"])
    names = [r["name"] for r in rows]
    assert names.count("route") == 2        # hop 0 + the re-route
    assert "failover" in names and "replica_kill" in names
    # spans from two distinct replicas' process groups
    sources = {r["source"] for r in rows
               if r["name"].startswith("request")}
    assert len(sources) >= 2
    # the kill context row is flagged, the request's own rows are not
    assert all(r["context"] for r in rows
               if r["name"] == "replica_kill")


def test_request_trace_demo_reconstructs_poison_lineage(tiny_gpt,
                                                        tmp_path):
    """The `tools/request_trace.py --demo` storm (kill@3 + a poison
    prompt on a traced, supervised 3-replica fleet) run on the port's
    fleet: the trace reader's JSON functions reconstruct the
    quarantined request's lineage from the port's merged dump (the
    quarantine verdict appears, the lineage spans >= 2 routed hops),
    and the dump has the JAX package's schema. The demo itself drives
    the JAX package, so its twin drives the same scenario here."""
    import tools.request_trace as rt
    cfg, params = tiny_gpt
    flight_dir = str(tmp_path / "flight")
    rng = np.random.default_rng(0)
    good = [rng.integers(3, cfg.vocab_size,
                         int(rng.integers(9, 18))).astype(np.int32)
            for _ in range(5)]
    poison = rng.integers(3, cfg.vocab_size, 12).astype(np.int32)
    chaos = (ChaosInjector().kill_replica_at(3, 0)
             .poison_prompt(poison))

    def spawn(_index):
        return _server(params, cfg, num_slots=2, chaos=chaos,
                       flight_dir=flight_dir)

    router = FleetRouter(
        [spawn(i) for i in range(3)], start=False, chaos=chaos,
        spawn_fn=spawn, flight_dir=flight_dir, trace=True,
        supervisor=SupervisorConfig(backoff_heartbeats=1,
                                    warm_chains=2))
    futs = [router.submit(p, max_new_tokens=5) for p in good[:3]]
    router.step()
    pfut = router.submit(poison, max_new_tokens=5)
    for p in good[3:]:
        futs.append(router.submit(p, max_new_tokens=5))
        router.step()
    router.run_until_idle()
    with pytest.raises(PoisonRequestError):
        pfut.result(timeout=5)
    for f in futs:
        f.result(timeout=5)
    dump_path = tmp_path / "fleet_trace_demo.json"
    router.dump_trace(str(dump_path))
    router.close()
    with open(dump_path) as f:
        dump = json.load(f)
    assert dump["otherData"]["schema"] == "paddle_tpu.fleet_trace/1"
    assert len(dump["otherData"]["sources"]) >= 4   # fleet + 3 slots
    tid = rt.find_trace_id(dump, pfut.request_id)
    rows = rt.build_timeline(dump, tid)
    assert any(r["name"] == "quarantine" for r in rows)
    assert len({r["hop"] for r in rows
                if r["hop"] is not None and r["name"] == "route"}) >= 2
    assert rt.flight_entries_for_rid(flight_dir, pfut.request_id)


# ---------------------------------------------------------------------------
# THE storm e2e (acceptance): kill + hang + poison, traced
# ---------------------------------------------------------------------------

def test_storm_e2e_one_merged_dump_with_full_poison_lineage(
        tiny_gpt, tmp_path):
    """The self-healing storm with tracing on: kill@3 + hang@7 + poison on a
    supervised 3-replica fleet. One merged Perfetto dump where a
    failed-over request's spans share a single trace id across both
    replicas with monotone timestamps (engine clocks injected — span
    stamps must not come from them), the quarantined request's trace
    records every implicated hop, and tracing-on vs tracing-off token
    ids are bitwise identical."""
    cfg, params = tiny_gpt
    rng = np.random.default_rng(8)
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
    # tracing OFF reference: the engine untraced — ids must be bitwise
    ref_ids = _reference_ids(params, cfg, good, 7)

    chaos = (ChaosInjector()
             .kill_replica_at(3, 0)
             .hang_replica_at(7, 1)
             .poison_prompt(poison))
    for it in range(1, 400):    # injected engine clocks: 20 ms/iter
        chaos.advance_clock_at(it, ms=20)

    def spawn(_index):
        return _server(params, cfg, chaos=chaos,
                       flight_dir=str(tmp_path))

    router = FleetRouter(
        [spawn(i) for i in range(3)], start=False, chaos=chaos,
        spawn_fn=spawn, flight_dir=str(tmp_path), trace=True,
        supervisor=SupervisorConfig(hang_heartbeats=3,
                                    backoff_heartbeats=2,
                                    warm_chains=3))
    futs = []
    for p in good[:4]:
        futs.append(router.submit(p, max_new_tokens=7))
    router.step()
    pfut = router.submit(poison, max_new_tokens=7)
    router.step()
    for p in good[4:]:
        futs.append(router.submit(p, max_new_tokens=7))
        router.step()
    router.run_until_idle()

    # the storm actually happened and healed
    assert chaos.fired["replica_kill"] == 1
    assert chaos.fired["replica_hang"] == 1
    with pytest.raises(PoisonRequestError) as ei:
        pfut.result(timeout=5)
    st = router.get_stats()
    assert st["live_replicas"] == 3 and st["quarantines"] == 1
    # tracing on vs off: BITWISE token ids through the whole storm
    ids = [list(f.result(timeout=5).token_ids) for f in futs]
    assert ids == ref_ids

    dump = router.dump_trace(str(tmp_path / "storm_trace.json"))
    assert (tmp_path / "storm_trace.json").exists()
    names = [s["name"] for s in dump["otherData"]["sources"]]
    # every dead generation's capture survived as its own process
    # group (kill + hang + 2 poison faults = 4 dead captures)
    assert sum(1 for n in names if "(dead)" in n) == 4
    # a failed-over request's spans chain across two replicas under
    # one trace id with monotone stamps
    roots = _request_roots(dump)
    moved = {t: sorted(v, key=lambda x: x[1]) for t, v in roots.items()
             if len({pid for pid, *_ in v}) > 1}
    assert moved
    for _tid, hops in moved.items():
        for a, b in zip(hops, hops[1:]):
            assert b[2] >= a[2] + a[3]
    # the QUARANTINED request's trace records every implicated hop:
    # its ring summary lists each hop, its lineage names the replicas
    # that died under it, and its span trees exist on every hop's
    # process group
    ring = router._tracer.completed_payload()
    prec = next(t for t in ring["traces"] if t["rid"] == pfut.request_id)
    assert prec["outcome"] == "failed"
    assert prec["reason"] == "PoisonRequestError"
    assert prec["implicated_deaths"] == ei.value.deaths == 2
    assert len(prec["hops"]) == prec["attempts"] + 1
    implicated = [d["replica"] for d in prec["lineage"]
                  if d["implicated"]]
    assert set(implicated) <= {h["replica"] for h in prec["hops"]}
    ptid = prec["trace_id"]
    assert ptid == mint_trace_id(router.name, pfut.request_id)
    phops = sorted(h for _pid, h, *_ in roots[ptid])
    assert phops == [h["hop"] for h in prec["hops"]]
    # ... and the quarantine verdict sits on the fleet track with the
    # same trace id
    quar = _fleet_events(dump, "quarantine")
    assert len(quar) == 1 and quar[0]["args"]["trace_id"] == ptid
    # resurrections framed the storm on the fleet track
    assert len(_fleet_events(dump, "resurrection")) == 4
    assert dump["otherData"]["truncated"] is False
    router.close()
