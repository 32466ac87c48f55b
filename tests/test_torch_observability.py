"""The port's observability package against the JAX package's, on the
CPU.

- QuantileSketch: the cases of ``tests/api/test_quantile_sketch.py`` on
  the port's sketch (rank-error bound on adversarial streams, fixed
  insertion order, merges, rank, weights, serialization, bounds), and
  the port's quantiles and serialized state equal to the JAX sketch's
  for the same stream;
- METRIC_SPECS: the same names and kinds as the JAX package's, so one
  report reads both packages' exports; every metric the port's server
  records is declared there;
- the trace recorder: the bounded ring drops the oldest and exports
  the same Chrome schema as the JAX recorder;
- the HBM ledger's register / retire / snapshot;
- a bare ``serve_metrics`` over loopback;
- the port's observability and robustness packages import neither jax
  nor the JAX package.
"""

import json
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu.observability.metrics import METRIC_SPECS as J_SPECS
from paddle_tpu.observability.sketch import QuantileSketch as JSketch
from paddle_tpu.observability.tracing import TraceRecorder as JRecorder
from paddle_tpu_torch.observability import (METRIC_SPECS, QuantileSketch,
                                            TraceRecorder, global_registry)
from paddle_tpu_torch.observability.compile_insight import (
    LEDGER_KINDS, RESIDENT_KINDS, HBMLedger, array_nbytes)
from paddle_tpu_torch.observability.exporter import serve_metrics
from paddle_tpu_torch.observability.metrics import MetricsRegistry
from paddle_tpu_torch.observability.serving_telemetry import SLOTracker

REPO = Path(__file__).resolve().parent.parent
COMPRESSION = 128
BOUND = 2.0 / COMPRESSION
QS = (0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 0.999)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module: the suite runs
    several pytest workers at once, and torch's default of one thread a
    core in each worker oversubscribes the CPU, where the small eager ops
    of these tests then wait on each other's threads (six concurrent
    80-step tiny-BERT runs took 1448 s each at 8 threads, 4 s at one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rank_interval_error(sorted_data, est, q):
    """Distance from q to [frac strictly below est, frac <= est]."""
    lo = np.searchsorted(sorted_data, est, side="left") / len(sorted_data)
    hi = np.searchsorted(sorted_data, est, side="right") / len(sorted_data)
    if lo <= q <= hi:
        return 0.0
    return min(abs(q - lo), abs(q - hi))


def _adversarial_streams():
    rng = np.random.default_rng(7)
    n = 20000
    return {
        "uniform": rng.uniform(0, 100, n),
        "sorted_ascending": np.sort(rng.uniform(0, 100, n)),
        "sorted_descending": np.sort(rng.uniform(0, 100, n))[::-1],
        "heavy_duplicates": np.repeat([1.0, 2.0, 50.0, 99.0], n // 4),
        "bimodal": np.concatenate([rng.normal(10, 1, n // 2),
                                   rng.normal(1000, 5, n // 2)]),
        "log_tailed": rng.lognormal(3, 2, n),
    }


@pytest.mark.parametrize("name,data", list(_adversarial_streams().items()),
                         ids=list(_adversarial_streams()))
def test_rank_error_bound_and_jax_quantiles(name, data):
    s, j = QuantileSketch(COMPRESSION), JSketch(COMPRESSION)
    for v in data:
        s.add(v)
        j.add(v)
    srt = np.sort(data)
    for q in QS:
        est = s.quantile(q)
        assert _rank_interval_error(srt, est, q) <= BOUND, (name, q)
        assert est == j.quantile(q)
    assert s.min == srt[0] and s.max == srt[-1]
    assert s.quantile(0.0) == s.min and s.quantile(1.0) == s.max
    assert s.count == len(data)
    assert s.mean == pytest.approx(float(np.mean(data)), rel=1e-9)
    assert s.to_dict() == j.to_dict()


def test_deterministic_under_fixed_insertion_order():
    data = np.random.default_rng(3).lognormal(2, 1.5, 5000)
    a, b = QuantileSketch(64), QuantileSketch(64)
    for v in data:
        a.add(v)
        b.add(v)
    assert a.to_dict() == b.to_dict()
    c = QuantileSketch(64)
    for v in data[::-1]:
        c.add(v)
    srt = np.sort(data)
    for q in (0.5, 0.9, 0.99):
        assert _rank_interval_error(srt, c.quantile(q), q) <= 2.0 / 64


def test_merge_associativity_within_rank_error_bound():
    data = np.random.default_rng(11).gamma(2.0, 30.0, 18000)
    parts = np.array_split(data, 6)

    def build(cls):
        out = []
        for p in parts:
            s = cls(COMPRESSION)
            for v in p:
                s.add(v)
            out.append(s)
        return out

    sketches, jsketches = build(QuantileSketch), build(JSketch)

    def fold(cls, group):
        acc = cls(COMPRESSION)
        for s in group:
            acc.merge(s)
        return acc

    left = fold(QuantileSketch, sketches)
    pair = fold(QuantileSketch, sketches[:3]).merge(
        fold(QuantileSketch, sketches[3:]))
    right = QuantileSketch(COMPRESSION)
    for s in reversed(sketches):
        tmp = QuantileSketch(COMPRESSION)
        tmp.merge(s)
        tmp.merge(right)
        right = tmp
    srt = np.sort(data)
    for grouping in (left, right, pair):
        assert grouping.count == pytest.approx(len(data))
        for q in QS:
            assert _rank_interval_error(srt, grouping.quantile(q), q) \
                <= BOUND
    jleft = fold(JSketch, jsketches)
    assert [left.quantile(q) for q in QS] == [jleft.quantile(q)
                                              for q in QS]


def test_rank_is_inverse_of_quantile():
    data = np.random.default_rng(5).normal(50, 10, 10000)
    s = QuantileSketch(COMPRESSION)
    for v in data:
        s.add(v)
    for q in (0.1, 0.5, 0.9, 0.99):
        assert s.rank(s.quantile(q)) == pytest.approx(q, abs=BOUND)
    assert s.rank(s.min - 1) == 0.0
    assert s.rank(s.max + 1) == 1.0


def test_weighted_adds_and_serialization_roundtrip():
    s = QuantileSketch(32)
    s.add(10.0, weight=3)
    s.add(20.0, weight=1)
    assert s.count == 4 and s.mean == pytest.approx(12.5)
    assert s.quantile(0.25) <= 10.0 + 1e-9
    d = s.to_dict()
    r = QuantileSketch.from_dict(d)
    assert r.to_dict() == d
    # the JAX sketch reads the port's serialized state and vice versa
    assert JSketch.from_dict(d).to_dict() == d
    for q in (0.0, 0.5, 1.0):
        assert r.quantile(q) == s.quantile(q)
    r.add(30.0)
    assert r.count == 5 and r.max == 30.0


def test_empty_and_invalid_inputs():
    s = QuantileSketch()
    assert s.quantile(0.5) is None and s.rank(1.0) is None
    assert s.count == 0 and s.mean is None
    for bad in (float("nan"), float("inf")):
        with pytest.raises(ValueError):
            s.add(bad)
    with pytest.raises(ValueError):
        s.add(1.0, weight=0)
    with pytest.raises(ValueError):
        QuantileSketch(compression=4)
    t = QuantileSketch()
    t.add(5.0)
    t.merge(s)
    assert t.count == 1 and t.quantile(0.5) == 5.0


def test_memory_stays_bounded():
    s = QuantileSketch(COMPRESSION)
    for i in range(50000):
        s.add(float(i % 997))
    s._compress()
    assert len(s._means) <= 2 * COMPRESSION
    assert s.count == 50000


def test_summary_shape():
    s, j = QuantileSketch(), JSketch()
    for v in range(1, 101):
        s.add(float(v))
        j.add(float(v))
    out = s.summary()
    assert set(out) == {"count", "min", "max", "avg", "p50", "p90", "p99"}
    assert out["min"] == 1.0 and out["max"] == 100.0
    assert abs(out["p50"] - 50.5) <= 1.0
    assert out == j.summary()


def test_add_unit_matches_add():
    rng = np.random.default_rng(11)
    vals = [float(v) for v in rng.lognormal(3.0, 1.0, 3000)]
    a, b = QuantileSketch(COMPRESSION), QuantileSketch(COMPRESSION)
    for v in vals:
        a.add(v)
        b.add_unit(v)
    assert a.to_dict() == b.to_dict()
    tr = SLOTracker(clock=lambda: 0.0, compression=COMPRESSION)
    ref = QuantileSketch(COMPRESSION)
    for v in vals[:500]:
        tr.observe_token("itl_ms", v)
        ref.add(v)
    assert tr.digest("itl_ms").to_dict() == ref.to_dict()
    tr.drop_gauges()


# ---------------------------------------------------------------------------
# the metric namespace
# ---------------------------------------------------------------------------

def test_metric_specs_equal_the_jax_namespace():
    assert [(n, k) for n, k, _h in METRIC_SPECS] == \
        [(n, k) for n, k, _h in J_SPECS]
    names = [n for n, _k, _h in METRIC_SPECS]
    assert len(names) == len(set(names))


def test_server_metrics_are_declared(tmp_path):
    """Every serving.*, flight.*, memory.* and tracing.* series the
    port's registry holds is declared in METRIC_SPECS with its kind (a
    tier server with a prefix cache, a request, a chaos spill, a
    close)."""
    from paddle_tpu_torch.models.gpt import GPTConfig, init_params
    from paddle_tpu_torch.models.gpt import params_from_numpy
    from paddle_tpu_torch.robustness import ChaosInjector
    from paddle_tpu_torch.serving import GenerationServer, GPTServingModel
    cfg = GPTConfig(vocab_size=64, hidden_size=32, num_layers=1,
                    num_heads=2, inner_size=64, max_position=64)
    model = GPTServingModel(params_from_numpy(init_params(cfg, seed=0),
                                              "cpu"), cfg, device="cpu")
    chaos = ChaosInjector()
    srv = GenerationServer(model, device="cpu", start=False, num_slots=2,
                           block_size=8, max_context=64, chunk=4,
                           prefix_cache=True, host_kv_blocks=4,
                           chaos=chaos, flight_dir=str(tmp_path))
    prompt = np.arange(1, 18, dtype=np.int32)
    srv.submit(prompt, max_new_tokens=3)
    srv.run_until_idle()
    chaos.spill_chain_at(srv._sched.iteration + 1, 2)
    srv.submit(prompt, max_new_tokens=3)
    srv.run_until_idle()
    srv.close()
    spec = {n: k for n, k, _h in METRIC_SPECS}
    reg = global_registry()
    for name in reg.names():
        if name.split(".")[0] in ("serving", "flight", "memory",
                                  "tracing", "exporter"):
            assert name in spec, name
            assert reg.get(name).kind == spec[name], name


# ---------------------------------------------------------------------------
# trace recorder, HBM ledger, exporter
# ---------------------------------------------------------------------------

def test_trace_recorder_ring_matches_jax_export_schema():
    out = []
    for cls in (TraceRecorder, JRecorder):
        rec = cls(max_events=10)
        rec.start()
        for i in range(25):
            rec.instant(f"e{i}", args={"i": i})
        with rec.span("s", cat="serving", args={"x": 1}):
            pass
        rec.complete("c", 0.0, 1e-3, track="serving slot 0")
        rec.stop()
        ch = rec.to_chrome()
        out.append((rec.dropped, [e["name"] for e in rec.events()],
                    sorted(ch), sorted(ch["otherData"]),
                    [sorted(e) for e in ch["traceEvents"]]))
    assert out[0] == out[1]
    assert out[0][0] == 17


def test_hbm_ledger_register_retire_snapshot():
    reg = MetricsRegistry()
    led = HBMLedger(registry=reg)
    assert "host_ram" in LEDGER_KINDS and "host_ram" not in RESIDENT_KINDS
    t = torch.zeros((3, 5), dtype=torch.bfloat16)
    assert array_nbytes(t) == 30
    led.register("s0", "kv_pool", "kv_cache", 100)
    led.register("s0", "kv_pool_host", "host_ram", 1000)
    led.register("s0", "fused_step", "peak_hbm", 50)
    led.register("s0", "fused_step2", "peak_hbm", 70)
    led.register("s1", "model_params", "params", 7)
    snap = led.snapshot()
    assert snap["total_bytes"] == 107       # resident kinds only
    assert snap["by_component"]["s0"] == {"kv_cache": 100,
                                          "host_ram": 1000,
                                          "peak_hbm": 70}
    assert led.component_bytes("s0")["peak_hbm"] == 70   # max, not sum
    assert reg.gauge("memory.total_bytes").value() == 107
    with pytest.raises(ValueError, match="unknown ledger kind"):
        led.register("s0", "x", "vram", 1)
    led.retire("s0")
    assert led.component_bytes("s0") == {}
    assert led.snapshot()["total_bytes"] == 7
    assert not [lbl for lbl, _c in reg.gauge("memory.bytes").series()
                if lbl.get("component") == "s0"]


def test_bare_serve_metrics_over_loopback():
    reg = MetricsRegistry()
    reg.counter("serving.requests", "requests").inc(3)
    exp = serve_metrics(port=0, registry=reg)
    try:
        assert exp.host == "127.0.0.1"
        with urllib.request.urlopen(f"{exp.url}/metrics", timeout=10) as r:
            body = r.read().decode()
        assert "# TYPE serving_requests counter" in body
        assert "serving_requests 3" in body
        for path, want in (("/healthz", {"status": "ok"}), ("/slo", {}),
                           ("/tenants", {})):
            with urllib.request.urlopen(f"{exp.url}{path}",
                                        timeout=10) as r:
                assert json.loads(r.read()) == want
        with urllib.request.urlopen(f"{exp.url}/series", timeout=10) as r:
            assert json.loads(r.read())["schema"] == "paddle_tpu.series/1"
    finally:
        exp.close()
    assert exp.closed


def test_new_packages_import_neither_jax_nor_reference_package():
    code = (
        "import sys\n"
        "import paddle_tpu_torch.observability as o\n"
        "import paddle_tpu_torch.observability.serving_telemetry\n"
        "import paddle_tpu_torch.observability.exporter\n"
        "import paddle_tpu_torch.observability.compile_insight\n"
        "import paddle_tpu_torch.observability.timeseries\n"
        "import paddle_tpu_torch.robustness\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'paddle_tpu')]\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
