"""Tensor-parallel serving in the port against the JAX package, on the CPU.

Twins of ``tests/parallel/test_serving_tp.py`` and of
``tests/api/test_spec_decode.py::test_spec_on_mesh_not_supported``. The
JAX side serves on its conftest-forced virtual CPU devices
(``jax.sharding.Mesh(devices[:tp], ("tp",))``) with only the dispatcher's
vmap probe replaced (the ``jax_engine`` idiom of
``tests/test_torch_serving.py``: on this jax the probe reads a removed
attribute and raises). The port serves the same numpy parameters on a
local tp mesh (``make_named_mesh(("tp",), (tp,), ["cpu"] * tp)``: every
rank in this process, in turn) and, in one test module fixture, over a
``torch.distributed`` world of two gloo processes, one rank each.

Tolerances: ids are compared exactly (f32; the model is briefly trained,
as in the reference, so the greedy argmax is decisive against the
reduction's different summation order); per-token logps within 1e-5 of
the JAX tp-1 server; plain paged attention over a head shard equals the
full plain version on that head slice exactly; block round trips are
bitwise.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

import paddle_tpu as fluid
from paddle_tpu.core import framework
from paddle_tpu.core.executor import Scope, scope_guard
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import GenerationServer as JServer
from paddle_tpu.serving import GPTServingModel as JModel
from paddle_tpu.serving import kv_cache as jkvc
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.observability.compile_insight import hbm_ledger
from paddle_tpu_torch.observability.metrics import global_registry
from paddle_tpu_torch.parallel.mesh import make_named_mesh
from paddle_tpu_torch.robustness import ChaosInjector
from paddle_tpu_torch.robustness.guard import NonFiniteError
from paddle_tpu_torch.serving import (FleetRouter, GenerationServer,
                                      GPTServingModel, PagedKVCache,
                                      RouterPolicy, SamplingParams,
                                      SpecDecodeConfig, BeamParams)
from paddle_tpu_torch.serving import kv_cache as tkvc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGP_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module: the suite runs
    several pytest workers at once, and torch's default of one thread a
    core in each worker oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trained():
    """test_serving_tp's briefly-trained gpt_tiny (30 Adam steps on four
    sequences), as the JAX tree and a numpy copy."""
    cfg = jgpt.gpt_tiny()
    main, startup = framework.Program(), framework.Program()
    with framework.program_guard(main, startup):
        _tokens, loss, _ = jgpt.build_lm_net(cfg, seq_len=16)
        fluid.optimizer.AdamOptimizer(learning_rate=1e-2).minimize(loss)
    scope = Scope()
    exe = fluid.Executor(fluid.TPUPlace(0))
    rng = np.random.default_rng(0)
    seq = rng.integers(3, cfg.vocab_size, (4, 16)).astype(np.int32)
    with scope_guard(scope):
        exe.run(startup)
        for _ in range(30):
            exe.run(main, feed={"tokens": seq}, fetch_list=[loss])
        params = jgpt.load_params(scope, cfg)
    tree = {k: ({kk: np.asarray(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else np.asarray(v))
            for k, v in params.items()}
    return cfg, params, tree


@pytest.fixture
def jax_engine(monkeypatch):
    monkeypatch.setattr(jkvc, "_transform_trace_kind", lambda *ops: None)


def _kw(kw):
    kw.setdefault("num_slots", 3)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_context", 64)
    kw.setdefault("chunk", 4)
    kw.setdefault("start", False)
    return kw


def _tmesh(tp, axis="tp"):
    return make_named_mesh((axis,), (tp,), ["cpu"] * tp)


def _jmesh(tp):
    return JMesh(np.array(jax.devices()[:tp]), ("tp",))


def _port(tree, cfg, tp=1, **kw):
    if tp > 1:
        kw["mesh"] = _tmesh(tp)
    return GenerationServer(
        GPTServingModel(tgpt.params_from_numpy(tree, "cpu"), cfg,
                        device="cpu"), device="cpu", **_kw(kw))


def _jax(params, cfg, tp=1, **kw):
    if tp > 1:
        kw["mesh"] = _jmesh(tp)
    return JServer(JModel(params, cfg), telemetry=False, **_kw(kw))


def _record_logps(srv):
    log = {}
    emit = srv._sched._emit_token

    def wrapped(req, tok, lp, now):
        log.setdefault(req.rid, []).append(lp)
        return emit(req, tok, lp, now)

    srv._sched._emit_token = wrapped
    return log


def _drive_staggered_stream(srv):
    """test_serving_tp's acceptance scenario: staggered arrivals, mixed
    prompt and output lengths, one mid-stream cancel. Returns the
    surviving requests' ids."""
    p1 = np.array([5, 9, 11, 2, 7], np.int32)
    p2 = np.array([7] * 11, np.int32)
    f1 = srv.submit(p1, max_new_tokens=8)
    f2 = srv.submit(p2, max_new_tokens=6)
    for _ in range(2):
        srv.step()
    f3 = srv.submit(np.array([3, 4], np.int32), max_new_tokens=10)
    f4 = srv.submit(np.array([12, 13, 14, 15, 16, 17, 18], np.int32),
                    max_new_tokens=12)
    srv.step()
    assert f4.cancel()
    srv.run_until_idle()
    assert f4.cancelled()
    return [list(f.result(timeout=5).token_ids) for f in (f1, f2, f3)]


def _gqa(cfg, params, kv=2):
    gcfg = jgpt.GPTConfig(
        **{k: getattr(cfg, k)
           for k in ("vocab_size", "hidden_size", "num_layers",
                     "num_heads", "inner_size", "max_position",
                     "dropout")}, kv_heads=kv)
    gparams = jgpt.gqa_slice_kv_params(params, cfg, kv)
    gtree = {k: ({kk: np.asarray(vv) for kk, vv in v.items()}
                 if isinstance(v, dict) else np.asarray(v))
             for k, v in gparams.items()}
    return gcfg, gparams, gtree


# ---------------------------------------------------------------------------
# the acceptance stream: tp 2 and 4 == the JAX tp-1 and tp-2 servers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_stream(trained):
    """The JAX servers' ids on the acceptance stream at tp 1 and tp 2
    (dense f32 and int8 KV), and the tp-1 server's logps."""
    cfg, params, _tree = trained
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jkvc, "_transform_trace_kind", lambda *ops: None)
        for kv in (None, "int8"):
            for tp in (1, 2):
                srv = _jax(params, cfg, tp=tp, kv_dtype=kv)
                log = _record_logps(srv)
                out[kv, tp] = (_drive_staggered_stream(srv), log)
                srv.close()
    return out


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_engine_ids_equal_jax_tp1_and_tp2(trained, jax_stream, tp):
    cfg, _params, tree = trained
    jids1, jlog1 = jax_stream[None, 1]
    jids2, _ = jax_stream[None, 2]
    assert jids1 == jids2
    srv = _port(tree, cfg, tp=tp)
    log = _record_logps(srv)
    assert _drive_staggered_stream(srv) == jids1
    for rid, lps in jlog1.items():
        np.testing.assert_allclose(log[rid], lps, rtol=0, atol=LOGP_TOL)
    st = srv.get_stats()
    # bookkeeping stays replicated host state
    assert st["cancelled"] == 1 and st["retired"] == 3
    assert st["blocks_free"] == st["blocks_total"]
    # mesh facts surface in get_stats
    assert st["mesh"]["tp"] == tp and st["mesh"]["axis"] == "tp"
    assert st["mesh"]["form"] == "local"
    assert st["mesh"]["shard_pool_bytes"] * tp == st["mesh"]["pool_bytes"]
    assert st["mesh"]["psums_per_step"] == 2 * cfg.num_layers
    assert st["mesh"]["reductions"] == \
        2 * cfg.num_layers * st["iterations"]
    # the watermark's unit: one device's bytes
    shard_block = srv.cache.shard_pool_bytes() // srv.cache.num_blocks
    assert st["free_shard_bytes"] == st["blocks_free"] * shard_block
    assert st["watermark_shard_bytes"] == 0
    srv.close()


def test_single_device_stats_have_no_mesh(trained):
    cfg, _params, tree = trained
    srv = _port(tree, cfg, watermark_blocks=2)
    st = srv.get_stats()
    assert st["mesh"] is None
    block = srv.cache.pool_bytes() // srv.cache.num_blocks
    assert st["free_shard_bytes"] == st["blocks_free"] * block
    assert st["watermark_shard_bytes"] == 2 * block
    srv.close()


def test_tp2_shared_prefix_stream_equals_jax_tp1(trained, jax_engine):
    """Prefix caching composes with the mesh: block sharing is replicated
    host state, so a shared-prefix stream (repeats, divergent suffixes,
    the full-cover copy-on-write) through a tp-2 server gives the JAX
    tp-1 prefix server's ids with the same hit and copy accounting."""
    cfg, params, tree = trained

    def drive(srv):
        shared = np.arange(3, 19, dtype=np.int32)   # 2 full blocks
        f = srv.submit(shared, max_new_tokens=4)
        srv.run_until_idle()
        ids = [list(f.result(timeout=5).token_ids)]
        futs = [srv.submit(np.concatenate([shared, extra]).astype(
            np.int32), max_new_tokens=5)
            for extra in ([30, 31], [40, 41, 42])]
        futs.append(srv.submit(shared, max_new_tokens=4))   # full cover
        srv.run_until_idle()
        return ids + [list(f.result(timeout=5).token_ids) for f in futs]

    js = _jax(params, cfg, prefix_cache=True)
    jids = drive(js)
    jprefix = js.get_stats()["prefix"]
    js.close()
    srv = _port(tree, cfg, tp=2, prefix_cache=True)
    assert drive(srv) == jids
    st = srv.get_stats()
    assert st["prefix"]["hits"] == jprefix["hits"] > 0
    assert st["prefix"]["cow_copies"] == jprefix["cow_copies"] == 1
    assert srv.cache.num_free == \
        srv.cache.usable_blocks - st["prefix"]["entries"]
    srv.close()


def test_tp2_mesh_metrics_recorded_and_retired(trained):
    cfg, _params, tree = trained
    srv = _port(tree, cfg, tp=2)
    reg = global_registry()
    sid = srv._ledger_id
    assert reg.gauge("serving.mesh.axis_size").labels(
        server=sid).value() == 2
    assert reg.gauge("serving.mesh.shard_pool_bytes").labels(
        server=sid).value() == srv.cache.shard_pool_bytes()
    assert reg.gauge("serving.mesh.psums_per_step").labels(
        server=sid).value() == 2 * cfg.num_layers
    srv.close()
    for name in ("serving.mesh.axis_size",
                 "serving.mesh.shard_pool_bytes",
                 "serving.mesh.psums_per_step"):
        assert not [lbl for lbl, _c in reg.get(name).series()
                    if lbl.get("server") == sid], name


def test_tp2_step_reduces_twice_a_layer_over_contiguous_shards(trained):
    """The reference reads its compiled step for all-reduces and
    (N, H/tp, bs, D) pool tensors. Here: every step makes 2 x layers
    reductions, the attention runs once a layer and rank on that rank's
    own contiguous (N, H/tp, bs, D) shards (the kernel takes no strided
    view), and q carries H/tp heads."""
    cfg, _params, tree = trained
    srv = _port(tree, cfg, tp=2)
    calls = []
    attn = srv.model.attention

    def spy(q, kp, vp, tables, pos, k_scale=None, v_scale=None):
        calls.append((tuple(q.shape), kp.data_ptr(), kp.is_contiguous(),
                      vp.is_contiguous(), tuple(kp.shape)))
        return attn(q, kp, vp, tables, pos, k_scale=k_scale,
                    v_scale=v_scale)

    srv.model.attention = spy
    srv.submit(np.arange(3, 12, dtype=np.int32), max_new_tokens=3)
    mesh = srv.mesh
    n, d = srv.cache.num_blocks, cfg.hidden_size // cfg.num_heads
    for _ in range(3):
        r0, c0 = mesh.reductions, len(calls)
        assert srv.step()
        assert mesh.reductions - r0 == 2 * cfg.num_layers
        step = calls[c0:]
        assert len(step) == 2 * cfg.num_layers
        for q_shape, _ptr, kc, vc, k_shape in step:
            assert q_shape[1] == cfg.num_heads // 2 and kc and vc
            assert k_shape == (n, cfg.num_heads // 2, srv.cache.block_size,
                               d)
        assert len({ptr for _q, ptr, *_ in step}) == 2 * cfg.num_layers
    srv.run_until_idle()
    srv.close()


# ---------------------------------------------------------------------------
# head-sharded plain paged attention
# ---------------------------------------------------------------------------

def _ragged_case(h=4, h_kv=4, b=3, c=2, d=8, bs=4, m=5, seed=0):
    """test_serving_tp's ragged tables with NULL padding and one idle
    lane."""
    rng = np.random.default_rng(seed)
    n = 1 + b * m
    k_pool = rng.standard_normal((n, h_kv, bs, d)).astype(np.float32)
    v_pool = rng.standard_normal((n, h_kv, bs, d)).astype(np.float32)
    k_pool[0] = v_pool[0] = 0.0
    q = rng.standard_normal((b, h, c, d)).astype(np.float32)
    tables = np.zeros((b, m), np.int32)
    q_pos = np.zeros((b, c), np.int32)
    free = list(range(1, n))
    rng.shuffle(free)
    for i in range(1, b):               # lane 0 stays idle
        length = int(rng.integers(1, m * bs - c))
        for j in range(-(-(length + c) // bs)):
            tables[i, j] = free.pop()
        q_pos[i] = np.arange(length, length + c)
    return q, k_pool, v_pool, tables, q_pos


@pytest.mark.parametrize("h_kv", [4, 2], ids=["mha", "gqa"])
def test_head_sharded_paged_attention_exact(h_kv):
    """Attention is head-independent: the plain paged attention over each
    tp-2 shard's contiguous (N, H_kv/2, bs, D) pools and its H/2 query
    heads equals the full plain version on that head slice exactly, and
    the full plain version is the JAX gather reference's within 1e-6."""
    q, kp, vp, tables, pos = _ragged_case(h_kv=h_kv)
    full = tkvc.paged_attention_reference(*(torch.from_numpy(a) for a in
                                            (q, kp, vp, tables, pos)))
    jref = jax.jit(jkvc.paged_attention_reference)(q, kp, vp, tables, pos)
    np.testing.assert_allclose(full.numpy(), np.asarray(jref), rtol=0,
                               atol=1e-6)
    hq, hk = q.shape[1] // 2, h_kv // 2
    for r in range(2):
        shard = [torch.from_numpy(np.ascontiguousarray(a)) for a in
                 (q[:, r * hq:(r + 1) * hq], kp[:, r * hk:(r + 1) * hk],
                  vp[:, r * hk:(r + 1) * hk])]
        out = tkvc.paged_attention(*shard, torch.from_numpy(tables),
                                   torch.from_numpy(pos))
        np.testing.assert_array_equal(out.numpy(),
                                      full[:, r * hq:(r + 1) * hq].numpy())


# ---------------------------------------------------------------------------
# HBM ledger per-device rows
# ---------------------------------------------------------------------------

def _kv_rows(srv):
    return [e for e in hbm_ledger().snapshot()["entries"]
            if e["component"] == srv._ledger_id and e["kind"] == "kv_cache"]


def test_tp2_ledger_per_device_rows_sum_to_pool_bytes(trained):
    cfg, _params, tree = trained
    srv = _port(tree, cfg, tp=2)
    pool_bytes = srv.cache.pool_bytes()
    rows = _kv_rows(srv)
    assert {r["name"] for r in rows} == {"kv_pool/shard0", "kv_pool/shard1"}
    assert all(r["bytes"] == pool_bytes // 2 for r in rows)
    assert [r["detail"]["mesh_index"] for r in
            sorted(rows, key=lambda r: r["name"])] == [0, 1]
    assert all(r["detail"]["heads_local"] == cfg.num_heads // 2
               and r["detail"]["device"] == "cpu" for r in rows)
    mem = srv.get_stats()["memory"]
    assert mem["kv_cache"] == pool_bytes
    # the model's row is the whole tree; the peak is one device's
    model = srv.model
    assert mem["params"] == model.param_bytes()
    per_dev = model.param_bytes_per_device(srv.mesh, "tp")
    assert per_dev < model.param_bytes() < 2 * per_dev
    srv.close()
    assert srv.get_stats()["memory"] == {}

    # the fault-stop path retires the rows and gauges too
    srv2 = _port(tree, cfg, tp=2)
    assert srv2.get_stats()["memory"]["kv_cache"] == pool_bytes
    with srv2._rid_lock:
        srv2._closed = True             # what _on_engine_fault does
    srv2.close()
    assert srv2.get_stats()["memory"] == {}
    assert not [lbl for lbl, _c in
                global_registry().get("serving.mesh.axis_size").series()
                if lbl.get("server") == srv2._ledger_id]


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

def test_mesh_divisibility_validated(trained):
    cfg, _params, tree = trained
    with pytest.raises(ValueError, match="divide"):
        _port(tree, cfg, tp=3)
    with pytest.raises(ValueError, match="divide"):
        PagedKVCache(2, 4, 8, 9, block_size=4, device="cpu", mesh=_tmesh(3))
    # tp divides the heads but not inner_size: refused before any pool
    # is allocated
    cfg_odd = tgpt.GPTConfig(
        **{k: getattr(cfg, k)
           for k in ("vocab_size", "hidden_size", "num_layers",
                     "num_heads", "max_position", "dropout")},
        inner_size=513)
    with pytest.raises(ValueError, match="inner_size"):
        GenerationServer(GPTServingModel(tgpt.params_from_numpy(
            tree, "cpu"), cfg_odd, device="cpu"), device="cpu",
            mesh=_tmesh(2), **_kw({}))


def test_mesh_must_be_1d_and_name_its_axis(trained):
    cfg, _params, tree = trained
    mesh2d = make_named_mesh(("dp", "tp"), (2, 2), ["cpu"] * 4)
    model = GPTServingModel(tgpt.params_from_numpy(tree, "cpu"), cfg,
                            device="cpu")
    with pytest.raises(ValueError, match="must be 1-D"):
        GenerationServer(model, device="cpu", mesh=mesh2d, **_kw({}))
    with pytest.raises(ValueError, match="must be 1-D"):
        PagedKVCache(2, 4, 8, 9, block_size=4, device="cpu", mesh=mesh2d)
    # a refused server left the model unsharded
    assert model.mesh is None and model.params is not None
    mesh_m = _tmesh(2, axis="model")
    with pytest.raises(ValueError, match="not a mesh axis"):
        GenerationServer(model, device="cpu", mesh=mesh_m, **_kw({}))
    with pytest.raises(ValueError, match="not a mesh axis"):
        PagedKVCache(2, 4, 8, 9, block_size=4, device="cpu", mesh=mesh_m)
    # naming the axis serves
    srv = GenerationServer(model, device="cpu", mesh=mesh_m,
                           mesh_axis="model", **_kw({}))
    assert srv.get_stats()["mesh"]["axis"] == "model"
    srv.close()


# ---------------------------------------------------------------------------
# int8 KV pools and GQA on the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
def test_tp_int8_pools_equal_jax_int8(trained, jax_stream, tp):
    """Quantization is per (lane, column, head) row and the pools shard by
    head, so each shard quantizes exactly the rows it owns: the port's
    tp int8 server gives the JAX tp-1 and tp-2 int8 servers' ids, with
    the scale pools sharded beside the code pools."""
    cfg, _params, tree = trained
    jids1, jlog1 = jax_stream["int8", 1]
    assert jax_stream["int8", 2][0] == jids1
    srv = _port(tree, cfg, tp=tp, kv_dtype="int8")
    log = _record_logps(srv)
    assert _drive_staggered_stream(srv) == jids1
    for rid, lps in jlog1.items():
        np.testing.assert_allclose(log[rid], lps, rtol=0, atol=LOGP_TOL)
    st = srv.get_stats()
    assert st["blocks_free"] == st["blocks_total"]
    for shard in srv.cache.shards:
        ks = shard[0]["k_scale"]
        assert ks.shape == (srv.cache.num_blocks, cfg.num_heads // tp,
                            srv.cache.block_size) and ks.is_contiguous()
    assert srv.cache.shard_pool_bytes() * tp == srv.cache.pool_bytes()
    assert st["kv_quant"]["kv_dtype"] == "int8"
    assert st["kv_quant"]["pool_bytes"] < \
        st["kv_quant"]["dense_equiv_bytes"]
    srv.close()


def test_tp2_gqa_equals_jax_gqa(trained, jax_engine):
    """GQA composes with the mesh: the pools shard on the KV heads (one a
    rank here, each serving 2 query heads), and the tp-2 server gives the
    JAX tp-1 GQA server's ids. tp must divide H_kv, not only H."""
    cfg, params, _tree = trained
    gcfg, gparams, gtree = _gqa(cfg, params)
    js = _jax(gparams, gcfg)
    jids = _drive_staggered_stream(js)
    js.close()
    srv = _port(gtree, gcfg, tp=2)
    assert _drive_staggered_stream(srv) == jids
    st = srv.get_stats()
    assert st["blocks_free"] == st["blocks_total"]
    d = cfg.hidden_size // cfg.num_heads
    for shard in srv.cache.shards:
        kp = shard[0]["k"]
        assert kp.shape == (srv.cache.num_blocks, 1, srv.cache.block_size,
                            d) and kp.is_contiguous()
    assert srv.cache.shard_pool_bytes() * 2 == srv.cache.pool_bytes()
    srv.close()
    with pytest.raises(ValueError, match="divide kv_heads"):
        _port(gtree, gcfg, tp=4)
    with pytest.raises(ValueError, match="divide num_kv_heads"):
        PagedKVCache(2, 4, 8, 9, block_size=4, device="cpu",
                     mesh=_tmesh(4), num_kv_heads=2)


# ---------------------------------------------------------------------------
# refusals: what the mesh server does not take (as in the JAX package)
# ---------------------------------------------------------------------------

def test_spec_on_mesh_not_supported(trained):
    cfg, _params, tree = trained
    draft = GPTServingModel(tgpt.params_from_numpy(tree, "cpu"), cfg,
                            device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        _port(tree, cfg, tp=2, spec=SpecDecodeConfig(draft, k=2))


def test_mesh_refuses_strategies_and_int8_weights(trained):
    cfg, _params, tree = trained
    srv = _port(tree, cfg, tp=2)
    prompt = np.arange(3, 9, dtype=np.int32)
    for kw in ({"sampling": SamplingParams(temperature=0.8, seed=1)},
               {"n": 2}, {"beam": BeamParams(2), "eos_id": 1}):
        with pytest.raises(NotImplementedError, match="mesh"):
            srv.submit(prompt, max_new_tokens=4, **kw)
    # the model's greedy step refuses sampling controls, a guided mask
    # and per-column outputs
    s, c, m = 3, 4, srv._sched.max_blocks
    feed = [torch.zeros((s, c), dtype=torch.int32),
            torch.zeros((s, c), dtype=torch.int32),
            torch.zeros((s, c), dtype=torch.bool),
            torch.zeros((s, m), dtype=torch.int32)]
    for kw in ({"rng": torch.zeros((s, 2), dtype=torch.int64)},
               {"mask": torch.zeros((s, cfg.vocab_size))},
               {"per_column": True}):
        with pytest.raises(NotImplementedError, match="mesh"):
            srv.model.fused_step(srv.block_size, srv.cache.shards, *feed,
                                 **kw)
    # a greedy submit still serves
    f = srv.submit(prompt, max_new_tokens=4)
    srv.run_until_idle()
    assert len(f.result(timeout=5).token_ids) == 4
    srv.close()
    int8 = GPTServingModel(tgpt.params_from_numpy(tree, "cpu"), cfg,
                           device="cpu").quantize_int8()
    with pytest.raises(NotImplementedError, match="mesh"):
        GenerationServer(int8, device="cpu", mesh=_tmesh(2), **_kw({}))
    with pytest.raises(NotImplementedError, match="mesh"):
        srv.model.quantize_int8()


def test_router_refuses_handoff_across_meshes(trained):
    cfg, _params, tree = trained
    servers = [_port(tree, cfg, tp=2, prefix_cache=True) for _ in range(2)]
    with pytest.raises(NotImplementedError, match="mesh"):
        FleetRouter(servers, start=False,
                    policy=RouterPolicy("disaggregated", prefill=(0,),
                                        decode=(1,)))
    for srv in servers:
        srv.close()


def test_chaos_poison_reaches_every_shard(trained, tmp_path):
    """The NaN poison hook writes every head shard, and the next step
    fails every request with a NonFiniteError (its flight dump lands in
    tmp_path)."""
    cfg, _params, tree = trained
    chaos = ChaosInjector()
    srv = _port(tree, cfg, tp=2, chaos=chaos, flight_dir=str(tmp_path))
    f = srv.submit(np.arange(3, 14, dtype=np.int32), max_new_tokens=6)
    srv.step()
    srv.step()
    blk = srv._sched.lane_block_for_prompt(np.arange(3, 14,
                                                     dtype=np.int32))
    srv._nan_block(1, blk)
    for shard in srv.cache.shards:
        assert torch.isnan(shard[1]["k"][blk]).all()
    with pytest.raises(NonFiniteError):
        srv.run_until_idle()
    with pytest.raises(NonFiniteError):
        f.result(timeout=5)
    srv.close()


# ---------------------------------------------------------------------------
# block round trips across shards: tier, copy-on-write, handoff, wire
# ---------------------------------------------------------------------------

def _filled(tp, kv_dtype=None, seed=0, host=0):
    """A 2-layer (H 4, D 8, bs 4, N 9) cache, tp-sharded, with random rows
    in every block (int8: random codes and scales)."""
    c = PagedKVCache(2, 4, 8, 9, block_size=4, device="cpu",
                     kv_dtype=kv_dtype, mesh=_tmesh(tp) if tp > 1 else None)
    g = torch.Generator().manual_seed(seed)
    for li in range(2):
        for name in c.shards[0][li]:
            full = torch.randn((9, 4) + tuple(c.shards[0][li][name]
                                               .shape[2:]), generator=g)
            if name in ("k", "v") and kv_dtype == "int8":
                full = (full * 40).round().clamp(-127, 127)
            full = full.to(c.shards[0][li][name].dtype)
            for r, shard in zip(c.ranks, c.shards):
                shard[li][name].copy_(full[:, r * c.heads_local:
                                           (r + 1) * c.heads_local])
    if host:
        c.enable_host_tier(host)
    return c


def _full_rows(c, block):
    return [{n: torch.cat([s[li][n][block] for s in c.shards])
             for n in c.shards[0][li]} for li in range(c.num_layers)]


def _same(a, b):
    for la, lb in zip(a, b):
        assert la.keys() == lb.keys()
        for n in la:
            assert torch.equal(la[n], lb[n]), n


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_tp2_tier_round_trip_bitwise(kv_dtype):
    """spill_block / swap_in_block / cow_copy on a tp-2 cache move every
    shard's rows (scales beside codes): the host shards hold the device
    shards' rows bitwise, and a swap-in into another block gives the
    spilled rows back bitwise."""
    c = _filled(2, kv_dtype, host=4)
    before = _full_rows(c, 3)
    hb = c.spill_block(3)
    for dev, host in zip(c.shards, c.host.shards):
        for dl, hl in zip(dev, host):
            for n in dl:
                assert torch.equal(hl[n][hb], dl[n][3])
    c.swap_in_block(hb, 6)
    _same(_full_rows(c, 6), before)
    c.cow_copy(6, 7)
    _same(_full_rows(c, 7), before)
    assert c.host_pool_bytes() == sum(
        t.numel() * t.element_size() for s in c.host.shards for layer in s
        for t in layer.values())


def test_tp2_preempt_resume_equals_tp1(trained, jax_engine):
    """Preemption to the host tier and resume on a tp-2 server: the same
    ids as the uninterrupted tp-1 port server and as the JAX tp-1 server
    preempted at the same iteration (tests/test_torch_kv_tier.py's
    stream)."""
    from paddle_tpu.robustness import ChaosInjector as JChaos
    cfg, params, tree = trained
    rng = np.random.default_rng(33)
    prompts = [rng.integers(3, cfg.vocab_size,
                            int(rng.integers(9, 14))).astype(np.int32)
               for _ in range(3)]

    def run(srv, chaos=None):
        futs = [srv.submit(q, max_new_tokens=10) for q in prompts]
        if chaos is not None:
            chaos.preempt_request_at(6, futs[0].request_id)
        srv.run_until_idle()
        return [list(f.result(timeout=5).token_ids) for f in futs]

    ref = run(_port(tree, cfg))
    jchaos = JChaos()
    jids = run(_jax(params, cfg, host_kv_blocks=24, chaos=jchaos), jchaos)
    chaos = ChaosInjector()
    srv = _port(tree, cfg, tp=2, host_kv_blocks=24, chaos=chaos)
    assert run(srv, chaos) == ref == jids
    st = srv.get_stats()
    assert chaos.fired["preempt"] == 1 == jchaos.fired["preempt"]
    assert st["kv_tier"]["preempts"] == 1 and st["kv_tier"]["resumes"] == 1
    assert st["kv_tier"]["spills"] > 0 and st["kv_tier"]["swap_ins"] > 0
    srv.close()


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_handoff_and_wire_across_tp_degrees_bitwise(kv_dtype):
    """A block serialized from a tp-2 cache is the tp-1 cache's payload
    (the JAX package's head-major (H_kv, bs, D) rows) bitwise;
    deserialize_block and adopt_block_from move a block between tp 1, 2
    and 4 bitwise."""
    one, two = _filled(1, kv_dtype, seed=5), _filled(2, kv_dtype, seed=5)
    meta1, arr1 = one.serialize_block(4)
    meta2, arr2 = two.serialize_block(4)
    assert meta1 == meta2
    for a, b in zip(arr1, arr2):
        assert a.shape[0] == 4 and torch.equal(a, b)
    four = _filled(4, kv_dtype, seed=9)
    four.deserialize_block(2, meta1, [a.numpy() if a.dtype != torch.bfloat16
                                      else a for a in arr1])
    _same(_full_rows(four, 2), _full_rows(one, 4))
    two.adopt_block_from(four, 2, 8)
    _same(_full_rows(two, 8), _full_rows(one, 4))
    one.adopt_block_from(two, 8, 1)
    _same(_full_rows(one, 1), _full_rows(one, 4))
    two2 = _filled(2, kv_dtype, seed=11)
    two2.adopt_block_from(two, 8, 5)            # the same split
    _same(_full_rows(two2, 5), _full_rows(one, 4))


# ---------------------------------------------------------------------------
# the world form: two gloo processes, one rank each
# ---------------------------------------------------------------------------

WORKER = r'''
import datetime
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

STREAM = [([5, 9, 11, 2, 7], 8), ([7] * 11, 6), ([3, 4], 10),
          ([12, 13, 14, 15, 16, 17, 18], 12)]


def drive(srv):
    f1 = srv.submit(np.array(STREAM[0][0], np.int32), max_new_tokens=8)
    f2 = srv.submit(np.array(STREAM[1][0], np.int32), max_new_tokens=6)
    for _ in range(2):
        srv.step()
    f3 = srv.submit(np.array(STREAM[2][0], np.int32), max_new_tokens=10)
    f4 = srv.submit(np.array(STREAM[3][0], np.int32), max_new_tokens=12)
    srv.step()
    assert f4.cancel()
    tables, reductions = [], []
    while True:
        r0 = srv.mesh.reductions
        if not srv.step():
            break
        reductions.append(srv.mesh.reductions - r0)
        tables.append(np.array([s.table[:8] if s is not None else
                                [0] * 8 for s in srv._sched._slots]))
    return ([list(f.result(timeout=5).token_ids) for f in (f1, f2, f3)],
            np.stack(tables), reductions)


def rank_main(rank, world, init, out, tree_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        from paddle_tpu_torch.models import gpt
        from paddle_tpu_torch.parallel.mesh import make_named_mesh
        from paddle_tpu_torch.serving import (GenerationServer,
                                              GPTServingModel, PagedKVCache)
        data = np.load(tree_path, allow_pickle=True)
        tree = data["tree"].item()
        cfg = gpt.gpt_tiny()
        mesh = make_named_mesh(("tp",), (world,))
        assert mesh.world and mesh.held("tp") == [rank]
        res = {}
        # the recipe: one shard a process, the byte math halves
        cache = PagedKVCache(2, 4, 8, 9, block_size=4, device="cpu",
                             mesh=mesh)
        res["recipe_shape"] = np.array(cache.pools[0]["k"].shape)
        res["recipe_bytes"] = np.array([cache.shard_pool_bytes(),
                                        cache.pool_bytes()])
        model = GPTServingModel(gpt.params_from_numpy(tree, "cpu"), cfg,
                                device="cpu")
        srv = GenerationServer(model, num_slots=3, block_size=8,
                               max_context=64, chunk=4, start=False,
                               device="cpu", mesh=mesh)
        ids, tables, reductions = drive(srv)
        res["ids"] = np.array(sum(ids, []))
        res["lens"] = np.array([len(x) for x in ids])
        res["tables"] = tables
        res["reductions"] = np.array(reductions)
        res["shard_shape"] = np.array(srv.cache.pools[0]["k"].shape)
        st = srv.get_stats()
        res["form"] = np.array(st["mesh"]["form"])
        srv.close()
        # the dense tp decoder and the prompt decoder over the world
        params = gpt.params_from_numpy(tree, "cpu")
        bos = torch.tensor([5, 9, 17])
        gids, gscores = gpt.make_tp_greedy_decoder(
            params, cfg, mesh, 16, device="cpu")(bos)
        res["greedy_ids"], res["greedy_scores"] = gids.numpy(), \
            gscores.numpy()
        prompt = torch.tensor(np.arange(3, 27).reshape(3, 8))
        pids, pscores = gpt.make_tp_prompt_decoder(
            params, cfg, mesh, 8, 20, device="cpu")(prompt)
        res["prompt_ids"], res["prompt_scores"] = pids.numpy(), \
            pscores.numpy()
        # dp over the world (one batch slice a process, the outputs
        # gathered back whole)
        dmesh = make_named_mesh(("dp", "tp"), (world, 1))
        dids, dscores = gpt.make_tp_decoder(
            params, cfg, dmesh, 16, dp_axis="dp", device="cpu")(
            torch.tensor([5, 9, 17, 23]))
        res["dp_ids"], res["dp_scores"] = dids.numpy(), dscores.numpy()
        np.savez(out + "/rank%d.npz" % rank, **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    world, init, out, tree_path = (int(sys.argv[1]), sys.argv[2],
                                   sys.argv[3], sys.argv[4])
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main,
                         args=(r, world, init, out, tree_path))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(150)
    codes = [p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    sys.exit(0 if codes == [0] * world else 1)
'''


@pytest.fixture(scope="module")
def world_run(trained, tmp_path_factory):
    """Two gloo processes (``file://`` rendezvous in a temporary
    directory, so parallel test workers never race for a port), each
    holding one rank of a tp-2 world mesh: the recipe cache, the
    acceptance stream through a GenerationServer, and the tp decoders.
    Every wait is bounded: the group's 60 s, the joins' 150 s, the
    run's 200 s. Returns each rank's npz."""
    _cfg, _params, tree = trained
    tmp = tmp_path_factory.mktemp("tp_world")
    tree_path = tmp / "tree.npz"
    np.savez(tree_path, tree=np.array(tree, dtype=object))
    script = tmp / "tp_worker.py"
    script.write_text(WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run(
        [sys.executable, str(script), "2",
         "file://" + str(tmp / "rendezvous"), str(tmp), str(tree_path)],
        env=env, cwd=str(tmp), capture_output=True, text=True, timeout=200)
    assert res.returncode == 0, res.stderr[-4000:]
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


def test_tp2_world_recipe_holds_one_shard_a_process(world_run):
    """The reference's standalone two-device recipe, as a world of two
    processes: each holds its own (N, H/2, bs, D) shard and the byte
    accounting halves."""
    for r in world_run:
        assert tuple(r["recipe_shape"]) == (9, 2, 4, 8)
        shard, pool = r["recipe_bytes"]
        assert shard * 2 == pool


def test_tp2_world_engine_ids_equal_across_ranks_and_jax(
        trained, world_run, jax_stream):
    """Both ranks of the gloo world serve the acceptance stream with the
    JAX tp-1 and tp-2 servers' ids; their scheduler state is replicated
    (the same block tables every step), each step makes 2 x layers
    all-reduces, and each rank's pool is its (N, H/2, bs, D) shard."""
    cfg, _params, _tree = trained
    jids1 = jax_stream[None, 1][0]
    assert jax_stream[None, 2][0] == jids1
    want = sum(jids1, [])
    r0, r1 = world_run
    for r in world_run:
        assert r["ids"].tolist() == want
        assert r["lens"].tolist() == [len(x) for x in jids1]
        assert set(r["reductions"].tolist()) == {2 * cfg.num_layers}
        assert r["shard_shape"][1] == cfg.num_heads // 2
        assert str(r["form"]) == "world"
    np.testing.assert_array_equal(r0["tables"], r1["tables"])


def test_tp2_world_decoders_equal_local(trained, world_run):
    """The dense and prompt tp decoders over the world give the JAX
    package's ids on the same inputs (its single-device decoders and its
    tp-2 decoders on two virtual devices) and the local tp-2 mesh's, with
    scores within 2e-5; so does the dense decoder with its batch split
    over a dp 2 world (each rank gathers the whole batch back)."""
    cfg, jparams, tree = trained
    params = tgpt.params_from_numpy(tree, "cpu")
    dp_bos, bos = np.array([5, 9, 17, 23], np.int32), np.array([5, 9, 17],
                                                                np.int32)
    prompt = np.arange(3, 27, dtype=np.int32).reshape(3, 8)
    want = {
        "dp": [jgpt.make_greedy_decoder(jparams, cfg, 16)(
            jnp.asarray(dp_bos))],
        "greedy": [
            jgpt.make_greedy_decoder(jparams, cfg, 16)(jnp.asarray(bos)),
            jgpt.make_tp_greedy_decoder(jparams, cfg, _jmesh(2), 16)(
                jnp.asarray(bos)),
            tgpt.make_tp_greedy_decoder(params, cfg, _tmesh(2), 16,
                                        device="cpu")(torch.tensor(bos))],
        "prompt": [
            jgpt.make_prompt_decoder(jparams, cfg, 8, 20)(
                jnp.asarray(prompt)),
            jgpt.make_tp_prompt_decoder(jparams, cfg, _jmesh(2), 8, 20)(
                jnp.asarray(prompt)),
            tgpt.make_tp_prompt_decoder(params, cfg, _tmesh(2), 8, 20,
                                        device="cpu")(torch.tensor(prompt))],
    }
    for r in world_run:
        for name, refs in want.items():
            for ref_ids, ref_scores in refs:
                np.testing.assert_array_equal(r[name + "_ids"],
                                              np.asarray(ref_ids))
                np.testing.assert_allclose(r[name + "_scores"],
                                           np.asarray(ref_scores),
                                           rtol=2e-5, atol=2e-5)
