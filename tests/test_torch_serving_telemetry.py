"""The port's serving telemetry against the JAX package, on the CPU.

Twins of ``tests/api/test_serving_telemetry.py`` (all but the trainer's
flight dump and the Executor's metrics mount, which wait for the
trainer's slice): the same gpt_tiny params (the JAX package's startup,
handed over as numpy), the same chaos plans on injected clocks, both
servers stepped by hand:

- the acceptance stream (staggered arrivals, a chaos cancel, a chaos
  NaN poison): the same span-tree names per request, the same TTFT/ITL
  sample counts, SLO quantiles within the sketch's bound of the exact
  offline ones, and a flight dump whose last entry is the poisoned
  iteration, with the JAX server's fault iteration and bad request ids;
- SLO windows publish server-labeled gauges that close() retires, two
  servers do not alias, check_slo's burn rates;
- the sampling knob, the trace recorder's ring, the flight recorder's
  ring and dump, a deadline storm's dump;
- /metrics, /healthz, /slo and 404 over loopback, idempotent mounts;
- telemetry off: the same ids; the non-finite guard still fires; a
  poison keyed to a cancel-only iteration is deferred; a faulted server
  still retires its gauges.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.core import framework
from paddle_tpu.core.executor import Scope, scope_guard
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.observability.serving_telemetry import \
    ServingTelemetry as JTelemetry
from paddle_tpu.observability.tracing import get_recorder as jget_recorder
from paddle_tpu.robustness import ChaosInjector as JChaos
from paddle_tpu.robustness.guard import NonFiniteError as JNonFinite
from paddle_tpu.serving import GenerationServer as JServer
from paddle_tpu.serving import GPTServingModel as JModel
from paddle_tpu.serving import kv_cache as jkvc
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.observability.metrics import global_registry
from paddle_tpu_torch.observability.serving_telemetry import (
    ITER_FIELDS, LANE_FIELDS, FlightRecorder, ServingTelemetry,
    trace_request_mode)
from paddle_tpu_torch.observability.tracing import (TraceRecorder,
                                                    get_recorder)
from paddle_tpu_torch.robustness import ChaosInjector, NonFiniteError
from paddle_tpu_torch.serving import GenerationServer, GPTServingModel
from paddle_tpu_torch.serving import NonFiniteError as ServingNonFinite


@pytest.fixture(scope="module")
def tiny():
    cfg = jgpt.gpt_tiny()
    main, startup = framework.Program(), framework.Program()
    main.random_seed = startup.random_seed = 11
    with framework.program_guard(main, startup):
        jgpt.build_lm_net(cfg, seq_len=8)
    scope = Scope()
    with scope_guard(scope):
        fluid.Executor().run(startup)
    params = jgpt.load_params(scope, cfg)
    tree = {k: ({kk: np.asarray(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else np.asarray(v))
            for k, v in params.items()}
    return cfg, params, tree


@pytest.fixture
def jax_engine(monkeypatch):
    """The JAX dispatcher's vmap probe reads an attribute this jax
    removed; outside vmap/shard_map its answer is None."""
    monkeypatch.setattr(jkvc, "_transform_trace_kind", lambda *ops: None)


def _kw(kw):
    kw.setdefault("num_slots", 3)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_context", 64)
    kw.setdefault("chunk", 4)
    kw.setdefault("start", False)
    return kw


def _port(tree, cfg, **kw):
    return GenerationServer(
        GPTServingModel(tgpt.params_from_numpy(tree, "cpu"), cfg,
                        device="cpu"), device="cpu", **_kw(kw))


def _jax(params, cfg, **kw):
    return JServer(JModel(params, cfg), **_kw(kw))


def _ticking(chaos_cls, ms_of_iteration, n=200):
    """A chaos injector whose clock advances ms_of_iteration(it) ms at
    the start of each iteration."""
    chaos = chaos_cls()
    for it in range(1, n):
        chaos.advance_clock_at(it, ms=ms_of_iteration(it))
    return chaos


# the two packages side by side: (make server, chaos class, telemetry
# class, trace recorder, NonFiniteError)
def _sides(tiny):
    cfg, params, tree = tiny
    return (
        (lambda **kw: _port(tree, cfg, **kw), ChaosInjector,
         ServingTelemetry, get_recorder(), NonFiniteError),
        (lambda **kw: _jax(params, cfg, **kw), JChaos, JTelemetry,
         jget_recorder(), JNonFinite))


def test_nonfinite_error_has_the_jax_contract():
    assert ServingNonFinite is NonFiniteError
    assert issubclass(NonFiniteError, ArithmeticError)
    e, j = NonFiniteError("a", 3, ["a", "b"]), JNonFinite("a", 3, ["a", "b"])
    assert (e.var, e.step, e.bad_vars, str(e)) == \
        (j.var, j.step, j.bad_vars, str(j))


def test_acceptance_mixed_stream_cancel_and_poison(tiny, jax_engine,
                                                   tmp_path):
    out = []
    for side, (make, chaos_cls, tel_cls, rec, nonfinite) in \
            enumerate(_sides(tiny)):
        chaos = (_ticking(chaos_cls, lambda it: 5.0 + (it % 7))
                 .cancel_request_at(4, index=0).poison_serving_at(14))
        tel = tel_cls(clock=chaos.serving_clock, window_s=1e9,
                      flight_dir=str(tmp_path / str(side)),
                      flight_capacity=6)
        srv = make(chaos=chaos, telemetry=tel)
        token_times, submit_clock = {}, {}

        def stream(rid, _tok, chaos=chaos, token_times=token_times):
            token_times.setdefault(rid, []).append(chaos.serving_clock())

        def sub(*args, srv=srv, chaos=chaos, submit_clock=submit_clock,
                **kw):
            fut = srv.submit(*args, **kw)
            submit_clock[fut.request_id] = chaos.serving_clock()
            return fut

        rec.start()
        try:
            victim = sub(np.arange(3, 15, dtype=np.int32),
                         max_new_tokens=30, stream=stream)
            staggered = [sub([5 + i] * (3 + 4 * i),
                             max_new_tokens=4 + 2 * i, stream=stream)
                         for i in range(2)]
            srv.step()
            srv.step()
            late = sub([9, 10, 11], max_new_tokens=20, stream=stream)
            with pytest.raises(nonfinite) as ei:
                srv.run_until_idle()
        finally:
            rec.stop()
        events = rec.events()
        rec.clear()
        futs = [victim, *staggered, late]
        by_rid = {}
        for e in events:
            if e.get("cat") == "serving.request":
                by_rid.setdefault(e["args"]["rid"], []).append(e)
        assert set(by_rid) == {f.request_id for f in futs}
        trees = {rid: sorted(e["name"] for e in evs)
                 for rid, evs in by_rid.items()}
        slo = srv.get_stats()["slo"]["cumulative"]
        dump = json.loads(open(ei.value.flight_dump).read())
        out.append(dict(srv=srv, futs=futs, by_rid=by_rid, trees=trees,
                        slo=slo, dump=dump, err=ei.value, chaos=chaos,
                        token_times=token_times,
                        submit_clock=submit_clock))
    port, jax = out
    assert port["trees"] == jax["trees"]
    for key in ("ttft_ms", "itl_ms"):
        assert port["slo"][key]["count"] == jax["slo"][key]["count"]
    assert port["err"].step == jax["err"].step == 14
    assert port["err"].bad_rids == jax["err"].bad_rids
    assert port["err"].bad_vars == jax["err"].bad_vars
    assert port["chaos"].fired["serving_poison"] == 1
    # the port's span trees in detail
    srv, futs, by_rid = port["srv"], port["futs"], port["by_rid"]
    victim, staggered, late = futs[0], futs[1:3], futs[3]
    retired = [f.request_id for f in staggered if f.done()
               and not f.cancelled() and f.exception() is None]
    assert retired
    for rid in retired:
        names = [e["name"] for e in by_rid[rid]]
        root = next(e for e in by_rid[rid]
                    if e["name"] == f"request {rid}")
        assert root["args"]["outcome"] == "retire"
        assert root["args"]["finish_reason"] == "length"
        assert {"queue", "decode", "retire"} <= set(names)
        chunks = [e for e in by_rid[rid] if e["name"] == "prefill.chunk"]
        prompt_len = root["args"]["prompt_len"]
        assert sum(c["args"]["tokens"] for c in chunks) == prompt_len
        assert len(chunks) == -(-prompt_len // 4)
        its = [c["args"]["iteration"] for c in chunks]
        assert its == sorted(its)
        assert {e["tid"] for e in by_rid[rid]} == \
            {f"serving slot {root['args']['slot']}"}
        t0, t1 = root["ts"], root["ts"] + root["dur"]
        for e in by_rid[rid]:
            if e["ph"] == "X":
                assert t0 - 1e-3 <= e["ts"]
                assert e["ts"] + e["dur"] <= t1 + 1e-3
    vroot = next(e for e in by_rid[victim.request_id]
                 if e["name"].startswith("request"))
    assert vroot["args"]["outcome"] == "cancel"
    assert victim.done() and victim.exception() is not None
    # SLO digests against the exact offline quantiles
    exact_ttft, exact_itl = [], []
    for fut in futs:
        times = port["token_times"].get(fut.request_id)
        if not times:
            continue
        exact_ttft.append(
            (times[0] - port["submit_clock"][fut.request_id]) * 1e3)
        exact_itl.extend((b - a) * 1e3 for a, b in zip(times, times[1:]))
    assert port["slo"]["ttft_ms"]["count"] == len(exact_ttft)
    assert port["slo"]["itl_ms"]["count"] == len(exact_itl)
    for metric, exact in (("ttft_ms", exact_ttft), ("itl_ms", exact_itl)):
        srt = np.sort(exact)
        d = srv.telemetry.slo.digest(metric)
        for q in (0.5, 0.99):
            est = d.quantile(q)
            lo = np.searchsorted(srt, est - 1e-6) / len(srt)
            hi = np.searchsorted(srt, est + 1e-6, side="right") / len(srt)
            bound = 2.0 / d.compression
            assert lo - bound <= q <= hi + bound, (metric, q, est)
    # the flight dump: its last entry is the poisoned iteration
    dump = port["dump"]
    assert port["err"].flight_dump in \
        srv.get_stats()["slo"]["flight"]["dumps"]
    assert dump["schema"] == "paddle_tpu.flight/1"
    assert dump["reason"] == "non_finite_logits" and dump["step"] == 14
    last = dump["entries"][-1]
    assert last["step"] == 14 and last["kind"] == "iteration"
    assert last["fault"]["kind"] == "non_finite_logits"
    assert last["fault"]["detail"]["bad_slots"]
    assert last["fault"]["detail"]["bad_rids"] == port["err"].bad_rids
    assert len(dump["entries"]) <= 6
    # the hot-path entries keep the ITER_FIELDS and LANE_FIELDS schema,
    # the JAX package's
    jdump = jax["dump"]
    for e, je in zip(dump["entries"][:-1], jdump["entries"][:-1]):
        assert set(ITER_FIELDS) <= set(e) and set(e) == set(je)
        for lane, jlane in zip(e["lanes_detail"], je["lanes_detail"]):
            assert set(lane) == set(LANE_FIELDS) == set(jlane)
            assert {k: lane[k] for k in ("slot", "rid", "pos", "tier")} \
                == {k: jlane[k] for k in ("slot", "rid", "pos", "tier")}
    assert srv.get_stats()["engine_fault"] is not None
    for f in (late, *staggered):
        assert f.done()
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit([1, 2], max_new_tokens=2)


def test_slo_windows_publish_quantile_gauges(tiny):
    cfg, _params, tree = tiny
    chaos = _ticking(ChaosInjector, lambda it: 10.0)
    tel = ServingTelemetry(clock=chaos.serving_clock, window_s=0.05)
    srv = _port(tree, cfg, chaos=chaos, telemetry=tel)
    reg = global_registry()
    windows0 = reg.counter("serving.slo.windows").value()
    futs = [srv.submit([5 + i, 9, 11], max_new_tokens=6) for i in range(4)]
    srv.run_until_idle()
    for f in futs:
        f.result(timeout=5)
    slo = srv.get_stats()["slo"]
    assert slo["windows_completed"] >= 2
    assert reg.counter("serving.slo.windows").value() - windows0 == \
        slo["windows_completed"]
    last = slo["last_window"]
    assert last is not None and last["elapsed_s"] >= 0.05
    sid = slo["server"]
    labels = [lbl for lbl, _c in
              reg.gauge("serving.slo.quantile_ms").series()
              if lbl.get("server") == sid]
    assert labels and any(lb["metric"] == "ttft" for lb in labels)
    assert {lb["q"] for lb in labels} >= {"p50", "p90", "p99"}
    tps = [c.value() for lbl, c in
           reg.gauge("serving.slo.tokens_per_s").series()
           if lbl.get("server") == sid]
    assert len(tps) == 1 and tps[0] >= 0
    assert slo["cumulative"]["tokens"] == 24
    srv.close()
    for name in ("serving.slo.quantile_ms", "serving.slo.tokens_per_s"):
        assert not [lbl for lbl, _c in reg.gauge(name).series()
                    if lbl.get("server") == sid]


def test_two_servers_do_not_alias_slo_stats(tiny):
    cfg, _params, tree = tiny
    servers = []
    for _ in range(2):
        chaos = _ticking(ChaosInjector, lambda it: 10.0)
        servers.append(_port(tree, cfg, chaos=chaos,
                             telemetry=ServingTelemetry(
                                 clock=chaos.serving_clock,
                                 window_s=0.02)))
    rec = get_recorder()
    rec.start()
    try:
        futs = [srv.submit([5 + i, 9], max_new_tokens=3 + i)
                for i, srv in enumerate(servers)]
        for srv in servers:
            srv.run_until_idle()
        for f in futs:
            f.result(timeout=5)
    finally:
        rec.stop()
    rec.clear()
    slos = [srv.get_stats()["slo"] for srv in servers]
    assert slos[0]["server"] != slos[1]["server"]
    assert [s["cumulative"]["tokens"] for s in slos] == [3, 4]
    assert [s["trace_requests"]["traced"] for s in slos] == [1, 1]
    reg = global_registry()
    for slo in slos:
        assert [lbl for lbl, _c in
                reg.gauge("serving.slo.quantile_ms").series()
                if lbl.get("server") == slo["server"]]
    for srv in servers:
        srv.close()


def test_check_slo_burn_rates(tiny):
    cfg, _params, tree = tiny
    results = []
    for tel_cls in (ServingTelemetry, JTelemetry):
        tel = tel_cls(clock=None, window_s=1e9)
        for _ in range(90):
            tel.slo.observe("ttft_ms", 50.0)
        for _ in range(10):
            tel.slo.observe("ttft_ms", 200.0)
        results.append(tel.check_slo({"ttft_ms": {"p50": 60.0,
                                                  "p99": 100.0}}))
        with pytest.raises(ValueError):
            tel.check_slo({"nope_ms": {"p99": 1.0}})
        with pytest.raises(ValueError):
            tel.check_slo({"ttft_ms": {"q99": 1.0}})
        tel.close()
    out = results[0]
    assert out == results[1]
    assert out["ok"] is False
    by_q = {c["quantile"]: c for c in out["checks"]}
    assert by_q["p50"]["met"] is True
    assert by_q["p50"]["observed_ms"] == pytest.approx(50.0)
    assert by_q["p99"]["met"] is False
    assert by_q["p99"]["frac_over"] == pytest.approx(0.1, abs=0.02)
    assert by_q["p99"]["burn_rate"] == pytest.approx(10.0, abs=2.0)
    srv = _port(tree, cfg, telemetry=False)
    with pytest.raises(RuntimeError, match="telemetry"):
        srv.check_slo({"ttft_ms": {"p99": 1.0}})
    assert srv.get_stats()["slo"] is None


def test_trace_request_mode_parsing():
    assert trace_request_mode("all") == ("all", 1.0)
    assert trace_request_mode("off") == ("off", 0.0)
    assert trace_request_mode("sampled:0.25") == ("sampled", 0.25)
    assert trace_request_mode(None)[0] in ("all", "off", "sampled")
    for bad in ("sampled:2", "sampled:x", "sometimes"):
        with pytest.raises(ValueError):
            trace_request_mode(bad)


def test_trace_request_mode_env_typo_is_not_fatal(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TRACE_REQUESTS", "sample:0.1")
    with pytest.warns(RuntimeWarning, match="PADDLE_TPU_TRACE_REQUESTS"):
        assert trace_request_mode() == ("all", 1.0)
    with pytest.warns(RuntimeWarning):
        tel = ServingTelemetry(window_s=1e9)
    assert tel.mode == "all"
    tel.close()


def test_sampling_is_deterministic_and_off_suppresses_trees(tiny):
    cfg, _params, tree = tiny
    tel = ServingTelemetry(sample="sampled:0.5", window_s=1e9)
    jtel = JTelemetry(sample="sampled:0.5", window_s=1e9)
    picks = [tel.sampled(rid) for rid in range(200)]
    assert picks == [jtel.sampled(rid) for rid in range(200)]
    assert 40 < sum(picks) < 160
    tel.close()
    jtel.close()
    srv = _port(tree, cfg,
                telemetry=ServingTelemetry(sample="off", window_s=1e9))
    rec = get_recorder()
    rec.start()
    try:
        srv.submit([5, 6, 7], max_new_tokens=3)
        srv.run_until_idle()
    finally:
        rec.stop()
    events = rec.events()
    rec.clear()
    assert any(e["name"] == "serving.iteration" for e in events)
    assert not any(e.get("cat") == "serving.request" for e in events)
    assert srv.get_stats()["slo"]["cumulative"]["ttft_ms"]["count"] == 1


def test_trace_recorder_ring_drops_oldest_and_counts():
    reg = global_registry()
    base = reg.counter("tracing.dropped_events").value()
    rec = TraceRecorder(max_events=10)
    rec.start()
    for i in range(25):
        rec.instant(f"e{i}")
    rec.stop()
    events = rec.events()
    assert [e["name"] for e in events] == [f"e{i}" for i in range(15, 25)]
    assert rec.dropped == 15
    assert reg.counter("tracing.dropped_events").value() == base + 15
    chrome = rec.to_chrome()
    assert chrome["otherData"]["dropped_events"] == 15
    assert chrome["otherData"]["max_events"] == 10
    rec.start()
    assert rec.dropped == 0 and rec.events() == []
    rec.stop()


def test_trace_recorder_env_buffer_knob(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TRACE_BUFFER", "7")
    assert TraceRecorder().max_events == 7
    for bad in ("not-a-number", "0", "-5"):
        monkeypatch.setenv("PADDLE_TPU_TRACE_BUFFER", bad)
        with pytest.warns(RuntimeWarning, match="PADDLE_TPU_TRACE_BUFFER"):
            assert TraceRecorder().max_events == 200_000


def test_flight_recorder_ring_dump_and_annotation(tmp_path):
    fr = FlightRecorder(capacity=4, out_dir=str(tmp_path))
    for i in range(9):
        fr.record(i, kind="iteration", lanes=[0, 1], numpy_val=np.int32(i))
    assert len(fr) == 4
    fr.annotate_last(fault={"kind": "test"})
    path = fr.dump("test_reason", extra={"arr": np.arange(3)})
    assert path.endswith("flight-00000008.json")
    d = json.loads(open(path).read())
    assert d["reason"] == "test_reason" and d["step"] == 8
    assert d["recorded"] == 9 and d["capacity"] == 4
    assert [e["step"] for e in d["entries"]] == [5, 6, 7, 8]
    assert d["entries"][-1]["fault"] == {"kind": "test"}
    assert d["entries"][0]["numpy_val"] == 5
    assert d["extra"]["arr"] == [0, 1, 2]
    assert fr.dump_paths == [path]


def test_deadline_storm_dumps_flight_recorder(tiny, jax_engine, tmp_path):
    dumps = []
    for side, (make, chaos_cls, tel_cls, _rec, _nf) in \
            enumerate(_sides(tiny)):
        chaos = chaos_cls()
        chaos.advance_clock_at(3, ms=10000)
        for it in (1, 2, 4, 5, 6, 7, 8):
            chaos.advance_clock_at(it, ms=1)
        tel = tel_cls(clock=chaos.serving_clock, window_s=1e9,
                      flight_dir=str(tmp_path / str(side)),
                      deadline_storm=3)
        srv = make(num_slots=2, chaos=chaos, telemetry=tel)
        faults0 = (global_registry().counter("serving.faults").value()
                   if side == 0 else None)
        futs = [srv.submit([5 + i, 9], max_new_tokens=20, deadline_ms=2000)
                for i in range(4)]
        srv.run_until_idle()
        assert all(f.exception(timeout=1) is not None for f in futs)
        assert srv.get_stats()["deadline_cancels"] == 4
        assert len(tel.flight.dump_paths) == 1
        if side == 0:
            assert global_registry().counter("serving.faults").value() \
                == faults0 + 1
        dumps.append(json.loads(open(tel.flight.dump_paths[0]).read()))
    for d in dumps:
        assert d["reason"] == "deadline_storm"
        assert d["extra"]["deadline_cancels"] >= 3
    assert dumps[0]["step"] == dumps[1]["step"]
    assert dumps[0]["extra"] == dumps[1]["extra"]


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read().decode()


def test_engine_serve_metrics_endpoints(tiny):
    cfg, _params, tree = tiny
    srv = _port(tree, cfg, host_kv_blocks=4)
    exp = srv.serve_metrics(port=0)
    assert srv.serve_metrics() is exp
    assert srv.serve_metrics(port=exp.port) is exp
    assert exp.host == "127.0.0.1"
    with pytest.raises(ValueError, match="already mounted"):
        srv.serve_metrics(port=exp.port + 1)
    with pytest.raises(ValueError, match="already mounted"):
        srv.serve_metrics(host="0.0.0.0")
    fut = srv.submit([5, 6, 7], max_new_tokens=4)
    srv.run_until_idle()
    fut.result(timeout=5)
    code, prom = _get(f"{exp.url}/metrics")
    assert code == 200
    assert "# TYPE serving_requests counter" in prom
    assert "serving_generated_tokens" in prom
    assert f'serving_kv_tier_host_blocks{{server="{srv._ledger_id}"}} 4' \
        in prom
    code, health = _get(f"{exp.url}/healthz")
    h = json.loads(health)
    assert code == 200 and h["status"] == "ok" and h["pending"] == 0
    code, slo = _get(f"{exp.url}/slo")
    assert code == 200
    assert json.loads(slo)["cumulative"]["ttft_ms"]["count"] == 1
    code, mem = _get(f"{exp.url}/memory")
    rows = [e for e in json.loads(mem)["entries"]
            if e["component"] == srv._ledger_id]
    assert {e["name"] for e in rows} >= {"kv_pool", "kv_pool_host",
                                         "model_params", "fused_step"}
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(f"{exp.url}/nope")
    assert ei.value.code == 404 and "/metrics" in ei.value.read().decode()
    series = {tuple(sorted(lbl.items())): c.value() for lbl, c in
              global_registry().counter("exporter.requests").series()}
    assert series[(("code", "200"), ("path", "/metrics"))] >= 1
    srv.close()
    assert srv._exporter is None


def test_telemetry_off_is_bitwise_equal_and_hookless(tiny, jax_engine):
    cfg, params, tree = tiny
    prompt = np.array([5, 9, 11, 2], np.int32)
    ids = {}
    for mode in (True, False):
        srv = _port(tree, cfg, telemetry=mode)
        fut = srv.submit(prompt, max_new_tokens=8)
        srv.run_until_idle()
        ids[mode] = list(fut.result(timeout=5).token_ids)
        assert srv.get_stats()["telemetry_enabled"] is mode
    jsrv = _jax(params, cfg, telemetry=False)
    jf = jsrv.submit(prompt, max_new_tokens=8)
    jsrv.run_until_idle()
    assert ids[True] == ids[False] == list(jf.result(timeout=5).token_ids)


def test_prefill_chunk_spans_cover_prompt_exactly(tiny):
    cfg, _params, tree = tiny
    srv = _port(tree, cfg, chunk=4,
                telemetry=ServingTelemetry(window_s=1e9))
    rec = get_recorder()
    rec.start()
    try:
        fut = srv.submit(np.arange(2, 13, dtype=np.int32),
                         max_new_tokens=2)
        srv.run_until_idle()
    finally:
        rec.stop()
    fut.result(timeout=5)
    chunks = [e for e in rec.events() if e["name"] == "prefill.chunk"]
    rec.clear()
    assert [c["args"]["tokens"] for c in chunks] == [4, 4, 3]
    for a, b in zip(chunks, chunks[1:]):
        assert b["ts"] == pytest.approx(a["ts"] + a["dur"], abs=1.0)


def test_fault_stopped_server_still_drops_slo_gauges(tiny, tmp_path):
    cfg, _params, tree = tiny
    chaos = _ticking(ChaosInjector, lambda it: 10.0).poison_serving_at(8)
    tel = ServingTelemetry(clock=chaos.serving_clock, window_s=0.05,
                           flight_dir=str(tmp_path))
    srv = _port(tree, cfg, chaos=chaos, telemetry=tel, host_kv_blocks=4)
    for i in range(3):
        srv.submit(np.arange(3, 8 + i, dtype=np.int32), max_new_tokens=12)
    with pytest.raises(NonFiniteError):
        srv.run_until_idle()
    sid = tel.slo.labels["server"]
    reg = global_registry()
    assert [lbl for lbl, _c in reg.gauge("serving.slo.tokens_per_s")
            .series() if lbl.get("server") == sid]
    srv.close()
    for gname in ("serving.slo.tokens_per_s", "serving.slo.quantile_ms"):
        assert not [lbl for lbl, _c in reg.gauge(gname).series()
                    if lbl.get("server") == sid]
    # and its ledger rows and tier gauges
    assert srv.get_stats()["memory"] == {}
    assert not [lbl for lbl, _c in
                reg.gauge("serving.kv.tier.host_blocks").series()
                if lbl.get("server") == srv._ledger_id]


def test_nonfinite_guard_fires_without_telemetry(tiny, jax_engine):
    errs = []
    for make, chaos_cls, _tel, _rec, nonfinite in _sides(tiny):
        chaos = chaos_cls().poison_serving_at(6)
        srv = make(chaos=chaos, telemetry=False)
        futs = [srv.submit(np.arange(3, 9, dtype=np.int32),
                           max_new_tokens=16) for _ in range(2)]
        with pytest.raises(nonfinite) as ei:
            srv.run_until_idle()
        assert ei.value.flight_dump is None
        assert chaos.fired["serving_poison"] == 1
        for f in futs:
            with pytest.raises(nonfinite):
                f.result(timeout=5)
        srv.close()
        errs.append(ei.value)
    assert (errs[0].step, errs[0].bad_rids, errs[0].bad_vars) == \
        (errs[1].step, errs[1].bad_rids, errs[1].bad_vars)


def test_poison_on_cancel_only_iteration_is_deferred(tiny, jax_engine,
                                                     tmp_path):
    steps = []
    for side, (make, chaos_cls, tel_cls, _rec, nonfinite) in \
            enumerate(_sides(tiny)):
        chaos = (chaos_cls().cancel_request_at(3, index=0)
                 .poison_serving_at(3))
        srv = make(chaos=chaos, telemetry=tel_cls(
            flight_dir=str(tmp_path / str(side))))
        fa = srv.submit(np.arange(3, 8, dtype=np.int32), max_new_tokens=20)
        srv.run_until_idle()
        assert fa.done()
        assert chaos.fired["cancel"] == 1
        assert chaos.fired["serving_poison"] == 0
        fb = srv.submit(np.arange(4, 9, dtype=np.int32), max_new_tokens=20)
        with pytest.raises(nonfinite) as ei:
            srv.run_until_idle()
        assert chaos.fired["serving_poison"] == 1
        with pytest.raises(nonfinite):
            fb.result(timeout=5)
        steps.append((ei.value.step, ei.value.bad_rids))
    assert steps[0] == steps[1]
