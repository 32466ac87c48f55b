"""The port's serving slice against the JAX package, on the CPU.

paddle_tpu_torch serves the same gpt_tiny params (built by the JAX
package's training startup, handed over as numpy) on the CPU; the JAX
GenerationServer is the oracle:

- the weights converter: ``params_from_numpy`` of ``gpt.load_params``
  output gives fused-step logp rows and written KV within 1e-5 of the
  JAX fused step;
- the staggered mixed-length stream with a mid-stream cancel
  (tests/api/test_serving_engine.py:142) gives identical greedy ids and
  per-token logps within 1e-5; a sampled n=1 stream with a fixed seed
  gives identical ids;
- scheduler behaviour (eos, priority, watermark, deadlines) matches;
- the package imports neither jax nor paddle_tpu, and its entry points
  default to the card and raise without one.

On this container's jax (0.9) the JAX dispatcher's vmap probe
(``kv_cache._transform_trace_kind``) reads the removed
``jax.interpreters.batching.BatchTracer`` and raises, which breaks every
JAX GenerationServer step. These tests trace no vmap and no shard_map,
where the probe answers None, so the ``jax_engine`` fixture puts that
answer in its place; the JAX engine's math and its Pallas kernels run
unchanged. The JAX threaded drain test fails on this container, so the
port's threaded drain is held against the port's own manual-drive ids.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu.core import framework
from paddle_tpu.core.executor import Scope, scope_guard
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import GenerationServer as JServer
from paddle_tpu.serving import GPTServingModel as JModel
from paddle_tpu.serving import SamplingParams as JSampling
from paddle_tpu.serving import kv_cache as jkvc
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.serving import (DeadlineExceeded, GenerationServer,
                                      GPTServingModel, PagedKVCache,
                                      SamplingParams)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5


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


@pytest.fixture(scope="module")
def tiny():
    """gpt_tiny params from the JAX package's startup program, as a
    numpy tree (the same recipe as test_serving_engine's fixture)."""
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
    monkeypatch.setattr(jkvc, "_transform_trace_kind", lambda *ops: None)


def _servers(cfg, params, tree, **kw):
    kw.setdefault("num_slots", 3)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_context", 64)
    kw.setdefault("chunk", 4)
    kw.setdefault("start", False)
    js = JServer(JModel(params, cfg), telemetry=False, **kw)
    ts = GenerationServer(
        GPTServingModel(tgpt.params_from_numpy(tree, "cpu"), cfg,
                        device="cpu"), device="cpu", **kw)
    return js, ts


def _record_logps(srv):
    """Per-request committed-token logps, recorded at the scheduler's
    one emission point."""
    log = {}
    emit = srv._sched._emit_token

    def wrapped(req, tok, lp, now):
        log.setdefault(req.rid, []).append(lp)
        return emit(req, tok, lp, now)

    srv._sched._emit_token = wrapped
    return log


def _mixed_stream(srv, sampling=None):
    """test_serving_engine's acceptance scenario: staggered arrivals,
    different prompt and output lengths, one mid-stream cancel."""
    sp = sampling or (lambda i: None)
    f1 = srv.submit(np.array([5, 9, 11, 2, 7]), max_new_tokens=8,
                    sampling=sp(1))
    f2 = srv.submit(np.array([7] * 11), max_new_tokens=6, sampling=sp(2))
    for _ in range(2):
        srv.step()
    f3 = srv.submit(np.array([3, 4]), max_new_tokens=10, sampling=sp(3))
    f4 = srv.submit(np.array([12, 13, 14, 15, 16, 17, 18]),
                    max_new_tokens=12, sampling=sp(4))
    srv.step()
    assert f4.cancel()
    srv.run_until_idle()
    assert f4.cancelled()
    return [f.result(timeout=5) for f in (f1, f2, f3)]


# ---------------------------------------------------------------------------
# weights converter + fused step
# ---------------------------------------------------------------------------

def test_params_from_numpy_layout_and_dtype(tiny):
    cfg, _params, tree = tiny
    p = tgpt.params_from_numpy(tree, "cpu", torch.bfloat16)
    assert set(p) == set(tree)
    assert set(p["l0"]) == set(tree["l0"])
    assert p["l1"]["wq"].shape == tree["l1"]["wq"].shape
    assert p["word_emb"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tgpt.params_from_numpy(tree, "cpu")["l2"]["f0w"].numpy(),
        tree["l2"]["f0w"])


def test_init_params_matches_load_params_layout(tiny):
    cfg, _params, tree = tiny
    mine = tgpt.init_params(cfg, seed=0)
    assert set(mine) == set(tree)
    for k in tree:
        if isinstance(tree[k], dict):
            for kk in tree[k]:
                assert mine[k][kk].shape == tree[k][kk].shape, (k, kk)
        else:
            assert mine[k].shape == tree[k].shape
    assert np.array_equal(mine["l0"]["wq"],
                          tgpt.init_params(cfg, seed=0)["l0"]["wq"])


def test_fused_step_matches_jax(tiny, jax_engine):
    """One mixed step: lane 0 prefills a 4-token chunk, lane 1 decodes
    at position 9 over a written history, lane 2 is idle. Logp rows and
    every written KV row agree with the JAX fused step to 1e-5."""
    cfg, params, tree = tiny
    bs, s, c, m = 8, 3, 4, 8
    jm = JModel(params, cfg)
    tm = GPTServingModel(tgpt.params_from_numpy(tree, "cpu"), cfg,
                         device="cpu")
    d = cfg.hidden_size // cfg.num_heads
    jcache = jkvc.PagedKVCache(cfg.num_layers, cfg.num_heads, d, 20,
                               block_size=bs)
    tcache = PagedKVCache(cfg.num_layers, cfg.num_heads, d, 20,
                          block_size=bs, device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (s, c)).astype(np.int32)
    positions = np.zeros((s, c), np.int32)
    valid = np.zeros((s, c), bool)
    tables = np.zeros((s, m), np.int32)
    positions[0] = np.arange(4)
    valid[0] = True
    tables[0, :2] = [3, 7]
    positions[1, 0] = 9
    valid[1, 0] = True
    tables[1, :2] = [5, 2]
    # lane 1's history: the same random KV in both pools
    for layer in range(cfg.num_layers):
        for name in ("k", "v"):
            hist = rng.standard_normal((20, cfg.num_heads, bs, d)) \
                .astype(np.float32)
            jcache.pools[layer][name] = jnp.asarray(hist)
            tcache.pools[layer][name] = torch.from_numpy(hist.copy())
    keys = np.zeros((s, 2), np.uint32)
    ones = np.ones((s,), np.float32)
    off = np.zeros((s,), bool)
    jout = jax.jit(jm.build_fused_step(bs, sampling=True))(
        jcache.pools, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(valid), jnp.asarray(tables),
        jnp.zeros((s, cfg.vocab_size), jnp.float32), jnp.asarray(keys),
        jnp.asarray(ones), jnp.asarray(off), jnp.zeros((s,), jnp.int32),
        jnp.full((s,), 2.0, jnp.float32))
    nxt, chosen, logp = tm.fused_step(
        bs, tcache.pools, torch.from_numpy(tokens),
        torch.from_numpy(positions), torch.from_numpy(valid),
        torch.from_numpy(tables), torch.from_numpy(keys.astype(np.int64)),
        torch.from_numpy(ones), torch.from_numpy(off),
        torch.zeros((s,), dtype=torch.int32),
        torch.full((s,), 2.0))
    # the idle lane's outputs are garbage by design (its attention reads
    # the NULL block in the plain version and nothing in the kernel)
    np.testing.assert_allclose(logp.numpy()[:2], np.asarray(jout[3])[:2],
                               rtol=0, atol=ATOL)
    np.testing.assert_array_equal(nxt.numpy()[:2], np.asarray(jout[1])[:2])
    np.testing.assert_allclose(chosen.numpy()[:2], np.asarray(jout[2])[:2],
                               rtol=0, atol=ATOL)
    for layer in range(cfg.num_layers):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                tcache.pools[layer][name][1:].numpy(),
                np.asarray(jout[0][layer][name])[1:], rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# the engine: the same streams through both servers
# ---------------------------------------------------------------------------

def test_mixed_length_stream_greedy_ids_and_logps(tiny, jax_engine):
    cfg, params, tree = tiny
    js, ts = _servers(cfg, params, tree)
    jlog, tlog = _record_logps(js), _record_logps(ts)
    jres, tres = _mixed_stream(js), _mixed_stream(ts)
    for a, b in zip(jres, tres):
        assert b.finish_reason == a.finish_reason == "length"
        assert list(b.token_ids) == list(a.token_ids)
        np.testing.assert_allclose(tlog[b.request_id], jlog[a.request_id],
                                   rtol=0, atol=ATOL)
    st = ts.get_stats()
    assert st["cancelled"] == 1 and st["retired"] == 3
    assert st["blocks_free"] == st["blocks_total"]
    assert st["active_slots"] == 0 and st["queue_depth"] == 0
    assert st["iterations"] == js.get_stats()["iteration"]
    assert st["kernel"]["launches"] == 0        # the CPU takes the plain op


def test_mixed_length_stream_sampled_ids(tiny, jax_engine):
    cfg, params, tree = tiny

    def sampling(cls):
        # greedy, plain sampling, top-k and nucleus lanes in one stream
        knobs = {1: dict(temperature=0.8, seed=5),
                 2: None,
                 3: dict(temperature=1.2, top_k=12, seed=9),
                 4: dict(temperature=0.6, top_p=0.9, seed=1)}
        return lambda i: None if knobs[i] is None else cls(**knobs[i])

    js, ts = _servers(cfg, params, tree)
    jres = _mixed_stream(js, sampling(JSampling))
    tres = _mixed_stream(ts, sampling(SamplingParams))
    for a, b in zip(jres, tres):
        assert list(b.token_ids) == list(a.token_ids)
        assert abs(b.score - a.score) <= ATOL * len(a.token_ids)


def test_eos_stops_generation(tiny, jax_engine):
    cfg, params, tree = tiny
    prompt = np.array([5, 9, 11], np.int32)
    js, ts = _servers(cfg, params, tree)
    ref = js.submit(prompt, max_new_tokens=8)
    js.run_until_idle()
    ids = list(ref.result(5).token_ids)
    eos = ids[2]
    res = ts.submit(prompt, max_new_tokens=8, eos_id=eos)
    ts.run_until_idle()
    out = res.result(5)
    assert out.finish_reason == "eos"
    assert list(out.token_ids) == ids[:ids.index(eos) + 1]


def test_priority_order_and_fifo_within_priority(tiny, jax_engine):
    cfg, params, tree = tiny
    orders = []
    for srv in _servers(cfg, params, tree, num_slots=1):
        order, futs = [], {}
        futs["first"] = srv.submit([5, 6], max_new_tokens=2)
        srv.step()
        futs["low"] = srv.submit([7, 8], max_new_tokens=2, priority=5)
        futs["high"] = srv.submit([9, 10], max_new_tokens=2, priority=0)
        futs["low2"] = srv.submit([11, 12], max_new_tokens=2, priority=5)
        for name, f in futs.items():
            f.add_done_callback(lambda _f, n=name: order.append(n))
        srv.run_until_idle()
        orders.append(order)
    assert orders[1] == orders[0] == ["first", "high", "low", "low2"]


def test_watermark_backpressure_defers_admission(tiny, jax_engine):
    cfg, params, tree = tiny
    js, ts = _servers(cfg, params, tree, num_blocks=5, max_context=32)
    for srv in (js, ts):
        f1 = srv.submit([5, 6, 7, 8], max_new_tokens=20)
        f2 = srv.submit([9, 10, 11, 12], max_new_tokens=20)
        srv.step()
        st = srv.get_stats()
        assert st["active_slots"] == 1 and st["queue_depth"] == 1
        srv.run_until_idle()
        assert srv.get_stats()["blocks_free"] == 4
    assert list(f1.result(5).token_ids) != []
    assert len(f2.result(5).token_ids) == 20


def test_deadline_cancels_and_reclaims(tiny):
    cfg, _params, tree = tiny
    now = [0.0]
    srv = GenerationServer(
        GPTServingModel(tgpt.params_from_numpy(tree, "cpu"), cfg,
                        device="cpu"),
        num_slots=2, block_size=8, max_context=64, chunk=4, start=False,
        clock=lambda: now[0], device="cpu")
    late = srv.submit([1, 2, 3], max_new_tokens=30, deadline_ms=50)
    ok = srv.submit([4, 5], max_new_tokens=3)
    srv.step()
    now[0] = 1.0
    srv.run_until_idle()
    with pytest.raises(DeadlineExceeded):
        late.result(timeout=5)
    assert len(ok.result(timeout=5).token_ids) == 3
    st = srv.get_stats()
    assert st["deadline_cancels"] == 1
    assert st["blocks_free"] == st["blocks_total"]


def test_threaded_server_drains_on_close(tiny):
    cfg, _params, tree = tiny
    model = GPTServingModel(tgpt.params_from_numpy(tree, "cpu"), cfg,
                            device="cpu")
    prompts = [[5, 9, 11], [7] * 6, [3]]
    manual = GenerationServer(model, num_slots=2, block_size=8,
                              max_context=64, chunk=4, start=False,
                              device="cpu")
    want = [manual.submit(p, max_new_tokens=5) for p in prompts]
    manual.run_until_idle()
    srv = GenerationServer(model, num_slots=2, block_size=8,
                           max_context=64, chunk=4, device="cpu")
    streamed = []
    futs = [srv.submit(p, max_new_tokens=5,
                       stream=lambda rid, t: streamed.append((rid, t)))
            for p in prompts]
    srv.close()
    for f, w in zip(futs, want):
        assert list(f.result(timeout=60).token_ids) == \
            list(w.result().token_ids)
    assert len(streamed) == 15
    with pytest.raises(RuntimeError):
        srv.submit([1], max_new_tokens=1)


# ---------------------------------------------------------------------------
# isolation and device
# ---------------------------------------------------------------------------

def _port_sources():
    pkg = os.path.join(REPO, "paddle_tpu_torch")
    for root, dirs, files in os.walk(pkg):
        # csrc/ holds the CUDA sources and, ignored by git, their builds
        dirs[:] = [d for d in dirs if d != "csrc"]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_neither_jax_nor_reference_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import paddle_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    paddle_tpu_torch.__path__, 'paddle_tpu_torch.')]\n"
        "need = ['paddle_tpu_torch.ops.flash',\n"
        "        'paddle_tpu_torch.ops.cuda.flash',\n"
        "        'paddle_tpu_torch.inference.decoding',\n"
        "        'paddle_tpu_torch.core.framework',\n"
        "        'paddle_tpu_torch.core.executor',\n"
        "        'paddle_tpu_torch.core.backward',\n"
        "        'paddle_tpu_torch.core.layer_helper',\n"
        "        'paddle_tpu_torch.initializer',\n"
        "        'paddle_tpu_torch.ops.attention_ops',\n"
        "        'paddle_tpu_torch.ops.optimizer_ops',\n"
        "        'paddle_tpu_torch.layers.nn',\n"
        "        'paddle_tpu_torch.layers.attention',\n"
        "        'paddle_tpu_torch.optimizer.optimizers',\n"
        "        'paddle_tpu_torch.serving.prefix_cache',\n"
        "        'paddle_tpu_torch.serving.spec_decode',\n"
        "        'paddle_tpu_torch.serving.guided',\n"
        "        'paddle_tpu_torch.serving.decode_strategies',\n"
        "        'paddle_tpu_torch.serving.scheduler',\n"
        "        'paddle_tpu_torch.observability.metrics',\n"
        "        'paddle_tpu_torch.observability.sketch',\n"
        "        'paddle_tpu_torch.observability.tracing',\n"
        "        'paddle_tpu_torch.observability.timeseries',\n"
        "        'paddle_tpu_torch.observability.serving_telemetry',\n"
        "        'paddle_tpu_torch.observability.exporter',\n"
        "        'paddle_tpu_torch.observability.compile_insight',\n"
        "        'paddle_tpu_torch.robustness.chaos',\n"
        "        'paddle_tpu_torch.robustness.guard',\n"
        "        'paddle_tpu_torch.models.bert',\n"
        "        'paddle_tpu_torch.models.ernie',\n"
        "        'paddle_tpu_torch.reader.packing',\n"
        "        'paddle_tpu_torch.parallel.mesh',\n"
        "        'paddle_tpu_torch.parallel.ring_attention',\n"
        "        'paddle_tpu_torch.ops.metric_ops',\n"
        "        'paddle_tpu_torch.layers.metric_op',\n"
        "        'paddle_tpu_torch.layers.control_flow']\n"
        "assert set(need) <= set(mods), need\n"
        "for name in mods + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'paddle_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 10


# names of the reference's serving __all__ the port does not export yet,
# each with the ROADMAP item it waits for
SERVING_NAMES_LEFT = {
    # queue A item 8, the fleet
    "Replica": "A8", "FleetRouter": "A8", "FleetFuture": "A8",
    "RouterPolicy": "A8", "AdmissionPolicy": "A8",
    "AdmissionRejected": "A8", "WorkerProxy": "A8",
    "make_subprocess_spawn": "A8", "spawn_worker": "A8",
    "TransportError": "A8", "FrameError": "A8", "VersionMismatch": "A8",
    "RpcTimeout": "A8", "RemoteError": "A8",
    # queue A, left for later (item 9 or 11)
    "PagedDecodeLayer": "A, left for later",
    "build_paged_decode_cache": "A, left for later",
}


def test_serving_exports_the_reference_names():
    """Every name of the reference's ``paddle_tpu.serving.__all__`` is in
    the port's, but those SERVING_NAMES_LEFT lists; the re-exports are the
    port's own objects."""
    import paddle_tpu.serving as jserving
    import paddle_tpu_torch.serving as tserving
    from paddle_tpu_torch.ops.cuda import paged as tpaged
    from paddle_tpu_torch.serving import scheduler as tsched
    missing = set(jserving.__all__) - set(tserving.__all__)
    assert missing == set(SERVING_NAMES_LEFT), missing
    for name in tserving.__all__:
        assert hasattr(tserving, name), name
    from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                          gather_block_kv,
                                          paged_attention_reference)
    assert ContinuousBatchingScheduler is tsched.ContinuousBatchingScheduler
    assert paged_attention_reference is tpaged.paged_attention_reference
    assert gather_block_kv is tpaged.gather_block_kv


def test_port_sources_name_no_reference_import():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|paddle_tpu)\b",
                     re.M)
    for path in _port_sources():
        with open(path) as f:
            assert not pat.search(f.read()), path


def test_entry_points_default_to_the_card(tiny):
    cfg, _params, tree = tiny
    params = tgpt.params_from_numpy(tree, "cpu")
    cpu_model = GPTServingModel(params, cfg, device="cpu")
    if torch.cuda.is_available():
        assert GPTServingModel(params, cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        GPTServingModel(params, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        GenerationServer(cpu_model, start=False)
    with pytest.raises(ValueError, match="lives on"):
        GenerationServer(cpu_model, start=False, device="meta")
