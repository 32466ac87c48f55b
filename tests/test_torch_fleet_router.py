"""The port's FleetRouter (paddle_tpu_torch/serving/router.py) against
the JAX package's, on the CPU: the twins of
tests/api/test_fleet_router.py and of the router tests of
tests/api/test_decode_strategies.py.

Manual-drive replicas pumped by the router's own step() loop, time from
injected chaos clocks, no sleeps. Every reference test's contract is
held on the port's fleet (affinity keys from the prefix index's chain
hash, burn-rate shedding, drain, cancel, kill and engine-fault
failover with stream dedupe, the disaggregated handoff, the fleet
registry view, fork groups and beams through the router). Where a
contract is "ids equal a single server's", the single server is the
port's own; besides, the same seeded weights and prompts go through the
JAX fleet (``jax_engine`` replaces only the JAX dispatcher's vmap probe,
as in tests/test_torch_serving.py) under affinity routing, a mid-stream
replica kill, and the disaggregated handoff over dense and int8 pools:
ids identical, scores within ``SCORE_ATOL`` a token, and the same
routes and handoff block counts.

The reference's ``fused_step_signatures == 1`` checks are a JAX
compile-count fact with no counterpart in the port (the port's fused
step is eager torch); the twins check instead that the CPU path
launched no kernel. Two reference tests of this file have failed in
full-suite runs under six workers
(test_disaggregated_short_prompt_skips_prefill_pool and
test_fleet_registry_view_drops_dead_replica_series); their twins are
held to the counts and series derived from the routing rules, not to
the JAX run.
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as jfluid
from paddle_tpu.core import framework as jframework
from paddle_tpu.core.executor import Scope as JScope
from paddle_tpu.core.executor import scope_guard as jscope_guard
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import FleetRouter as JFleetRouter
from paddle_tpu.serving import GenerationServer as JServer
from paddle_tpu.serving import GPTServingModel as JModel
from paddle_tpu.serving import RouterPolicy as JRouterPolicy
from paddle_tpu.serving import kv_cache as jkvc
from paddle_tpu.robustness import ChaosInjector as JChaos
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.observability.metrics import global_registry
from paddle_tpu_torch.robustness import ChaosInjector
from paddle_tpu_torch.serving import (AdmissionPolicy, AdmissionRejected,
                                      BeamParams, FleetRouter,
                                      GenerationServer, GPTServingModel,
                                      PagedKVCache, PrefixCacheIndex,
                                      RouterPolicy, SamplingParams,
                                      prompt_chain_keys)

pytestmark = pytest.mark.fleet

# a finished request's score (sum of its token logps) from the port
# against the JAX fleet: per-token logps agree within 1e-5 (the serving
# twins' tolerance), so a score within 1e-5 per token
SCORE_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module: the suite runs
    several pytest workers at once, and torch's default of one thread a
    core in each worker oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture
def jax_engine(monkeypatch):
    monkeypatch.setattr(jkvc, "_transform_trace_kind", lambda *ops: None)


def _jax_params(seed, steps=0, seq_len=8):
    """gpt_tiny params from the JAX package's startup (seed `seed`),
    optionally trained `steps` Adam steps on four sequences (as
    test_quant_serving does, so greedy argmaxes are decisive); returns
    (cfg, JAX params, port params on the CPU)."""
    cfg = jgpt.gpt_tiny()
    main, startup = jframework.Program(), jframework.Program()
    main.random_seed = startup.random_seed = seed
    with jframework.program_guard(main, startup):
        _t, loss, _ = jgpt.build_lm_net(cfg, seq_len=seq_len)
        if steps:
            jfluid.optimizer.AdamOptimizer(
                learning_rate=1e-2).minimize(loss)
    scope = JScope()
    exe = jfluid.Executor()
    seq = np.random.default_rng(0).integers(
        3, cfg.vocab_size, (4, seq_len)).astype(np.int32)
    with jscope_guard(scope):
        exe.run(startup)
        for _ in range(steps):
            exe.run(main, feed={"tokens": seq}, fetch_list=[loss])
        params = jgpt.load_params(scope, cfg)
    tree = {k: ({kk: np.asarray(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else np.asarray(v))
            for k, v in params.items()}
    return cfg, params, tgpt.params_from_numpy(tree, "cpu")


@pytest.fixture(scope="module")
def tiny_gpt():
    """The reference fixture's gpt_tiny (JAX startup, seed 11), as the
    port's params on the CPU."""
    cfg, _jparams, params = _jax_params(11)
    return cfg, params


@pytest.fixture(scope="module")
def trained():
    """A briefly-trained gpt_tiny (30 Adam steps), for the twins that run
    the JAX fleet beside the port's: (cfg, JAX params, port params)."""
    return _jax_params(5, steps=30, seq_len=16)


def _server(params, cfg, **kw):
    kw.setdefault("num_slots", 3)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_context", 64)
    kw.setdefault("chunk", 4)
    kw.setdefault("start", False)
    kw.setdefault("prefix_cache", True)
    kw.setdefault("device", "cpu")
    return GenerationServer(GPTServingModel(params, cfg, device="cpu"),
                            **kw)


def _jserver(params, cfg, **kw):
    kw.setdefault("num_slots", 3)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_context", 64)
    kw.setdefault("chunk", 4)
    kw.setdefault("start", False)
    kw.setdefault("prefix_cache", True)
    kw.setdefault("telemetry", False)
    return JServer(JModel(params, cfg), **kw)


def _assert_same_results(tres, jres):
    """Port and JAX fleet results: ids identical, scores within
    SCORE_ATOL a token, finish reasons equal."""
    assert len(tres) == len(jres)
    for t, j in zip(tres, jres):
        assert list(t.token_ids) == list(j.token_ids)
        assert t.finish_reason == j.finish_reason
        assert abs(t.score - j.score) <= SCORE_ATOL * len(j.token_ids)


def _mixed_prompts(cfg, n, rng, tenant, shared_every=3):
    """Mixed-tenant stream: every `shared_every`-th request shares the
    tenant prefix plus a short unique suffix; the rest are private."""
    out = []
    for i in range(n):
        if i % shared_every == 0:
            sfx = rng.integers(3, cfg.vocab_size, 3).astype(np.int32)
            out.append(np.concatenate([tenant, sfx]))
        else:
            out.append(rng.integers(
                3, cfg.vocab_size,
                int(rng.integers(8, 24))).astype(np.int32))
    return out


def _reference_ids(params, cfg, prompts, n_new):
    srv = _server(params, cfg)
    futs = [srv.submit(p, max_new_tokens=n_new) for p in prompts]
    srv.run_until_idle()
    ids = [list(f.result(timeout=5).token_ids) for f in futs]
    srv.close()
    return ids


# ---------------------------------------------------------------------------
# affinity keys + transfer primitive
# ---------------------------------------------------------------------------

def test_chain_keys_match_index_derivation():
    """The router's affinity keys ARE the index's chain keys — one
    hash implementation, bitwise-equal keys (a second hasher would
    silently never match a replica's cache)."""
    cache = PagedKVCache(1, 2, 4, 9, block_size=8, device="cpu")
    idx = PrefixCacheIndex(cache)
    prompt = np.arange(35, dtype=np.int32)
    assert prompt_chain_keys(prompt, 8) == idx.chain_keys(prompt, 4)
    # partial chunks never key
    assert prompt_chain_keys(prompt[:7], 8) == []


def test_adopt_block_from_copies_rows_across_caches():
    src = PagedKVCache(2, 2, 4, 6, block_size=4, device="cpu")
    dst = PagedKVCache(2, 2, 4, 9, block_size=4, device="cpu")    # num_blocks may differ
    (sb,) = src.allocate(1)
    (db,) = dst.allocate(1)
    rng = np.random.default_rng(3)
    for i in range(2):
        rows = rng.standard_normal((2, 4, 4)).astype(np.float32)
        src.pools[i]["k"][sb] = torch.from_numpy(rows)
        src.pools[i]["v"][sb] = torch.from_numpy(rows + 1)
    before = [dst.pools[i]["k"] for i in range(2)]
    dst.adopt_block_from(src, sb, db)
    for i in range(2):
        assert dst.pools[i]["k"] is before[i]       # in place
        np.testing.assert_array_equal(dst.pools[i]["k"][db].numpy(),
                                      src.pools[i]["k"][sb].numpy())
        np.testing.assert_array_equal(dst.pools[i]["v"][db].numpy(),
                                      src.pools[i]["v"][sb].numpy())
    other = PagedKVCache(2, 4, 4, 6, block_size=4, device="cpu")  # heads
    with pytest.raises(ValueError, match="matching pool geometry"):
        other.adopt_block_from(src, sb, 1)
    # a dense bf16 -> f32 pair is a cast; int8 <-> dense refuses
    b16 = PagedKVCache(2, 2, 4, 6, block_size=4, device="cpu",
                       kv_dtype="bf16")
    (hb,) = b16.allocate(1)
    b16.pools[1]["k"][hb] = torch.from_numpy(rows).bfloat16()
    dst.adopt_block_from(b16, hb, db)
    np.testing.assert_array_equal(dst.pools[1]["k"][db].numpy(),
                                  b16.pools[1]["k"][hb].float().numpy())
    q8 = PagedKVCache(2, 2, 4, 6, block_size=4, device="cpu",
                      kv_dtype="int8")
    with pytest.raises(ValueError, match="quantized and a dense"):
        dst.adopt_block_from(q8, 1, db)
    with pytest.raises(ValueError, match="quantized and a dense"):
        q8.adopt_block_from(dst, db, 1)


def test_adopt_block_from_int8_carries_scale_rows():
    """An int8 handoff moves the codes and their f32 scale rows: the
    destination block dequantizes to exactly the source's rows."""
    src = PagedKVCache(2, 4, 8, 5, block_size=4, device="cpu",
                       num_kv_heads=2, kv_dtype="int8")
    dst = PagedKVCache(2, 4, 8, 7, block_size=4, device="cpu",
                       num_kv_heads=2, kv_dtype="int8")
    (sb,) = src.allocate(1)
    (db,) = dst.allocate(1)
    g = torch.Generator().manual_seed(4)
    for layer in src.pools:
        for name in ("k", "v"):
            layer[name][sb] = torch.randint(-127, 128, (2, 4, 8),
                                            generator=g).to(torch.int8)
            layer[name + "_scale"][sb] = torch.rand((2, 4), generator=g)
    dst.adopt_block_from(src, sb, db)
    for sl, dl in zip(src.pools, dst.pools):
        assert sorted(dl) == ["k", "k_scale", "v", "v_scale"]
        for name in dl:
            assert torch.equal(dl[name][db], sl[name][sb]), name


# ---------------------------------------------------------------------------
# construction validation
# ---------------------------------------------------------------------------

def test_router_validation(tiny_gpt):
    cfg, params = tiny_gpt
    a = _server(params, cfg, block_size=8)
    b = _server(params, cfg, block_size=16, max_context=32)
    with pytest.raises(ValueError, match="block_size"):
        FleetRouter([a, b], start=False)
    b.close()
    # disaggregated pools must be disjoint and prefix-cached
    with pytest.raises(ValueError, match="disjoint"):
        RouterPolicy("disaggregated", prefill=(0,), decode=(0, 1))
    no_pfx = _server(params, cfg, prefix_cache=False)
    with pytest.raises(ValueError, match="prefix_cache"):
        FleetRouter([a, no_pfx], start=False,
                    policy=RouterPolicy("disaggregated", prefill=(0,),
                                        decode=(1,)))
    # SLO admission needs telemetry everywhere
    no_tel = _server(params, cfg, telemetry=False)
    with pytest.raises(ValueError, match="telemetry"):
        FleetRouter([a, no_tel], start=False,
                    admission=AdmissionPolicy({"ttft_ms": {"p99": 1.0}}))
    for s in (a, no_pfx, no_tel):
        s.close()


# ---------------------------------------------------------------------------
# routing policy
# ---------------------------------------------------------------------------

def test_affinity_beats_least_loaded_on_shared_prefix(tiny_gpt):
    """A shared-prefix request routes to the replica whose cache holds
    the prefix even when that replica is the BUSIER one; a cold prompt
    falls back to power-of-two-choices (the less-loaded replica)."""
    cfg, params = tiny_gpt
    servers = [_server(params, cfg) for _ in range(2)]
    router = FleetRouter(servers, start=False)
    rng = np.random.default_rng(1)
    tenant = rng.integers(3, cfg.vocab_size, 16).astype(np.int32)
    warm = np.concatenate([tenant,
                           rng.integers(3, cfg.vocab_size,
                                        2).astype(np.int32)])
    # warm replica 0's prefix cache directly (router pumps all replicas)
    f0 = servers[0].submit(warm, max_new_tokens=2)
    router.run_until_idle()
    f0.result(timeout=5)
    # make replica 0 the busier one: a long private request keeps its
    # slots occupied while the shared-prefix submit routes
    busy = servers[0].submit(
        rng.integers(3, cfg.vocab_size, 30).astype(np.int32),
        max_new_tokens=30)
    for _ in range(3):
        router.step()
    load0 = servers[0]._sched.load_snapshot()
    load1 = servers[1]._sched.load_snapshot()
    assert load0[1] > load1[1]          # replica 0 busier by active slots
    reg = global_registry()
    aff0 = reg.counter("serving.fleet.routed").labels(
        policy="affinity").value()
    adm1_before = servers[1].get_stats()["admitted"]
    hits_before = servers[0].get_stats()["prefix"]["hits"]
    fut = router.submit(
        np.concatenate([tenant, rng.integers(3, cfg.vocab_size,
                                             2).astype(np.int32)]),
        max_new_tokens=2)
    router.run_until_idle()
    fut.result(timeout=5)
    busy.result(timeout=5)
    assert reg.counter("serving.fleet.routed").labels(
        policy="affinity").value() == aff0 + 1
    assert servers[0].get_stats()["prefix"]["hits"] > hits_before
    assert servers[1].get_stats()["admitted"] == adm1_before
    # cold prompt: no affinity anywhere -> p2c lands on the less-loaded
    busy2 = servers[0].submit(
        rng.integers(3, cfg.vocab_size, 30).astype(np.int32),
        max_new_tokens=30)
    for _ in range(2):
        router.step()
    ll0 = reg.counter("serving.fleet.routed").labels(
        policy="least_loaded").value()
    cold = router.submit(rng.integers(3, cfg.vocab_size,
                                      9).astype(np.int32),
                         max_new_tokens=2)
    assert servers[1].get_stats()["admitted"] == adm1_before  # queued yet
    router.run_until_idle()
    cold.result(timeout=5)
    busy2.result(timeout=5)
    assert reg.counter("serving.fleet.routed").labels(
        policy="least_loaded").value() == ll0 + 1
    assert servers[1].get_stats()["admitted"] == adm1_before + 1
    router.close()


def test_shed_on_burn_rate_not_queue_depth(tiny_gpt):
    """Admission control is SLO-driven: a breached burn rate sheds
    even with an EMPTY queue, and a deep queue admits as long as the
    error budget holds. Rejections carry the retry-after hint."""
    cfg, params = tiny_gpt
    rng = np.random.default_rng(2)
    prompt = rng.integers(3, cfg.vocab_size, 12).astype(np.int32)
    # (a) burn breach, empty queue -> shed
    chaos = ChaosInjector()
    for it in range(1, 50):
        chaos.advance_clock_at(it, 500.0)   # 500 ms per iteration
    srv = _server(params, cfg, chaos=chaos)
    router = FleetRouter(
        [srv], start=False,
        admission=AdmissionPolicy({"ttft_ms": {"p50": 10.0}},
                                  retry_after_ms=50.0))
    f = router.submit(prompt, max_new_tokens=3)     # cold digest admits
    router.run_until_idle()
    f.result(timeout=5)
    assert srv.get_stats()["queue_depth"] == 0      # nothing queued
    sheds0 = router.counts["sheds"]
    with pytest.raises(AdmissionRejected) as ei:
        router.submit(prompt, max_new_tokens=3)
    assert ei.value.scope == "fleet"
    assert ei.value.burn_rate is not None and ei.value.burn_rate > 1.0
    assert ei.value.retry_after_ms >= 50.0
    assert router.counts["sheds"] == sheds0 + 1
    assert global_registry().counter("serving.fleet.sheds").labels(
        scope="fleet").value() >= 1
    router.close()
    # (b) deep queue, healthy burn -> admits (queue depth is NOT the
    # signal)
    srv2 = _server(params, cfg, num_slots=1)
    router2 = FleetRouter(
        [srv2], start=False,
        admission=AdmissionPolicy({"ttft_ms": {"p50": 1e9}}))
    futs = [router2.submit(prompt, max_new_tokens=2) for _ in range(5)]
    assert srv2.get_stats()["queue_depth"] >= 3     # deep queue, no shed
    router2.run_until_idle()
    for f in futs:
        f.result(timeout=5)
    router2.close()


def test_fleet_check_slo_merges_replica_digests(tiny_gpt):
    cfg, params = tiny_gpt
    rng = np.random.default_rng(4)
    prompt = rng.integers(3, cfg.vocab_size, 12).astype(np.int32)
    servers = [_server(params, cfg) for _ in range(2)]
    router = FleetRouter(servers, start=False)
    futs = [router.submit(prompt, max_new_tokens=2,
                          priority=i % 2) for i in range(4)]
    router.run_until_idle()
    for f in futs:
        f.result(timeout=5)
    rep = router.check_slo({"ttft_ms": {"p50": 1e9}})
    (chk,) = rep["checks"]
    assert rep["ok"] and chk["met"] and chk["observed_ms"] is not None
    assert chk["burn_rate"] == 0.0      # nothing over a 1e9 ms target
    with pytest.raises(ValueError, match="unknown SLO metric"):
        router.check_slo({"nope_ms": {"p50": 1.0}})
    router.close()


# ---------------------------------------------------------------------------
# lifecycle: drain, cancel, kill + failover (the acceptance chaos test)
# ---------------------------------------------------------------------------

def test_drain_replica_finishes_inflight_then_closes(tiny_gpt):
    cfg, params = tiny_gpt
    rng = np.random.default_rng(5)
    servers = [_server(params, cfg) for _ in range(2)]
    router = FleetRouter(servers, start=False)
    long = router.submit(rng.integers(3, cfg.vocab_size,
                                      10).astype(np.int32),
                         max_new_tokens=12)
    for _ in range(2):
        router.step()
    router.drain_replica(0)
    assert servers[0] is router.replicas()[0].server
    # new submits only land on replica 1
    adm0 = servers[0].get_stats()["admitted"]
    f2 = router.submit(rng.integers(3, cfg.vocab_size,
                                    9).astype(np.int32),
                       max_new_tokens=2)
    router.run_until_idle()
    long.result(timeout=5)              # in-flight finished normally
    f2.result(timeout=5)
    assert servers[0].get_stats()["admitted"] == adm0
    assert router.replicas()[0].state == "drained"
    assert router.health()["live_replicas"] == 1
    router.close()


def test_client_cancel_through_router(tiny_gpt):
    cfg, params = tiny_gpt
    rng = np.random.default_rng(6)
    servers = [_server(params, cfg)]
    router = FleetRouter(servers, start=False)
    fut = router.submit(rng.integers(3, cfg.vocab_size,
                                     16).astype(np.int32),
                        max_new_tokens=20)
    for _ in range(3):
        router.step()
    assert fut.cancel()
    router.run_until_idle()
    assert fut.cancelled()
    # the slot and blocks came back; no failover was attempted
    assert servers[0].get_stats()["active_slots"] == 0
    assert router.counts["failovers"] == 0
    assert router.pending() == 0
    router.close()


def test_fleet_kill_mid_stream_failover_e2e(tiny_gpt):
    """THE acceptance chaos test: 3 replicas, mixed-tenant staggered
    stream, one replica killed mid-stream. Every request completes
    with ids bitwise-identical to an unkilled single-server run, no
    stream delivers a token twice, a shared-prefix follow-up hits a
    SURVIVOR's prefix cache, and every replica keeps its invariants
    (fused-step signature budget, ledger rows retired on kill)."""
    cfg, params = tiny_gpt
    rng = np.random.default_rng(0)
    tenant = rng.integers(3, cfg.vocab_size, 16).astype(np.int32)
    prompts = _mixed_prompts(cfg, 9, rng, tenant)
    ref_ids = _reference_ids(params, cfg, prompts, 8)

    chaos = ChaosInjector().kill_replica_at(4, 0)
    servers = [_server(params, cfg) for _ in range(3)]
    router = FleetRouter(servers, start=False, chaos=chaos)
    streams = {i: [] for i in range(len(prompts))}
    futs = []
    # staggered: first wave, a few iterations, second wave
    for i, p in enumerate(prompts[:5]):
        futs.append(router.submit(
            p, max_new_tokens=8,
            stream=lambda rid, t, toks=streams[i]: toks.append(t)))
    for _ in range(2):
        router.step()
    for i, p in enumerate(prompts[5:], start=5):
        futs.append(router.submit(
            p, max_new_tokens=8,
            stream=lambda rid, t, toks=streams[i]: toks.append(t)))
    router.run_until_idle()
    results = [f.result(timeout=5) for f in futs]

    assert chaos.fired["replica_kill"] == 1
    assert router.counts["failovers"] >= 1      # someone was in flight
    assert router.replicas()[0].state == "dead"
    assert router.get_stats()["live_replicas"] == 2
    # bitwise-correct completed ids, router rids preserved
    ids = [list(r.token_ids) for r in results]
    assert ids == ref_ids
    assert [r.request_id for r in results] == list(range(len(prompts)))
    # stream dedupe: exactly the result ids, no token twice
    for i, r in enumerate(results):
        assert streams[i] == list(r.token_ids)
    # shared-prefix follow-up re-hits a survivor's cache
    hits0 = sum(s.get_stats()["prefix"]["hits"] for s in servers[1:])
    f2 = router.submit(
        np.concatenate([tenant, rng.integers(
            3, cfg.vocab_size, 2).astype(np.int32)]), max_new_tokens=2)
    router.run_until_idle()
    f2.result(timeout=5)
    assert sum(s.get_stats()["prefix"]["hits"]
               for s in servers[1:]) > hits0
    # invariants through the router: one fused signature per replica,
    # the dead replica's HBM-ledger rows retired by the kill
    from paddle_tpu_torch.observability.compile_insight import hbm_ledger
    for s in servers:
        assert s.get_stats()["kernel"]["launches"] == 0     # CPU: plain
    assert not hbm_ledger().component_bytes(servers[0]._ledger_id)
    # failover metric recorded
    assert global_registry().counter(
        "serving.fleet.failovers").value() >= 1
    # replica gauges: the dead replica's load series is gone, the
    # live-replica gauge reads 2
    g = global_registry().gauge("serving.fleet.replica_load")
    series = {lbl.get("replica") for lbl, _c in g.series()
              if lbl.get("router") == router.name}
    assert router.replicas()[0].name not in series
    assert global_registry().gauge("serving.fleet.replicas").labels(
        router=router.name).value() == 2
    router.close()
    # close retires the router's gauge series entirely
    series_after = {lbl for lbl, _c in global_registry().gauge(
        "serving.fleet.replica_load").series()
        if lbl.get("router") == router.name}
    assert not series_after


def test_engine_fault_death_fails_over(tiny_gpt):
    """A replica dying ORGANICALLY (chaos KV poison -> NonFiniteError
    fail-stop) is also a fleet event: the router marks it dead and
    re-admits its stream on the survivor, ids intact."""
    cfg, params = tiny_gpt
    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, cfg.vocab_size, 12).astype(np.int32)
               for _ in range(2)]
    ref_ids = _reference_ids(params, cfg, prompts, 6)
    poison = ChaosInjector().poison_serving_at(4)
    a = _server(params, cfg, chaos=poison, telemetry=False)
    b = _server(params, cfg)
    router = FleetRouter([a, b], start=False)
    # route both onto the poisoned replica deliberately; the pump
    # CONTAINS the engine's NonFiniteError (the fleet outlives one
    # replica) — the direct submits fail, the replica reads dead
    futs = [a.submit(p, max_new_tokens=6) for p in prompts]
    for _ in range(200):
        if all(f.done() for f in futs):
            break
        router.step()
    for f in futs:
        with pytest.raises(Exception):
            f.result(timeout=5)
    assert router.replicas()[0].state == "dead"
    # an ORGANIC death (no kill_replica call) also drops the dead
    # replica's load-gauge series — the spec's 'removed when the
    # replica dies' holds on every death path
    series = {lbl.get("replica") for lbl, _c in global_registry().gauge(
        "serving.fleet.replica_load").series()
        if lbl.get("router") == router.name}
    assert router.replicas()[0].name not in series
    # router-routed requests now land on the survivor and complete
    futs2 = [router.submit(p, max_new_tokens=6) for p in prompts]
    router.run_until_idle()
    assert [list(f.result(timeout=5).token_ids)
            for f in futs2] == ref_ids
    router.close()


# ---------------------------------------------------------------------------
# disaggregated prefill/decode
# ---------------------------------------------------------------------------

def test_disaggregated_handoff_bitwise_and_sublinear(tiny_gpt):
    cfg, params = tiny_gpt
    rng = np.random.default_rng(8)
    prompts = [rng.integers(3, cfg.vocab_size, 19).astype(np.int32)
               for _ in range(4)]
    ref_ids = _reference_ids(params, cfg, prompts, 6)
    servers = [_server(params, cfg) for _ in range(3)]
    router = FleetRouter(
        servers, start=False,
        policy=RouterPolicy("disaggregated", prefill=(0,),
                            decode=(1, 2)))
    futs = [router.submit(p, max_new_tokens=6) for p in prompts]
    router.run_until_idle()
    ids = [list(f.result(timeout=5).token_ids) for f in futs]
    assert ids == ref_ids
    st = router.get_stats()
    assert st["handoffs"] == len(prompts)
    # every full chunk moved as KV, not recomputed: 19 tokens / bs 8
    # -> 2 full chunks per prompt
    assert st["handoff_blocks"] == 2 * len(prompts)
    # decode replicas prefilled ONLY the tails (3 tokens each + the
    # full-cover re-feed never applies here), prefill replica did the
    # chunks
    decode_prefill = sum(s.get_stats()["prefill_tokens"]
                         for s in servers[1:])
    total_prompt = sum(len(p) for p in prompts)
    assert decode_prefill < total_prompt / 2
    assert servers[0].get_stats()["prefill_tokens"] == total_prompt
    # the prefill pool emitted exactly its one forced token per request
    assert servers[0].get_stats()["generated_tokens"] == len(prompts)
    # handoff metrics recorded
    reg = global_registry()
    assert reg.counter("serving.fleet.handoffs").value() >= len(prompts)
    assert reg.counter("serving.fleet.handoff_blocks").value() >= \
        st["handoff_blocks"]
    assert reg.counter("serving.fleet.routed").labels(
        policy="prefill").value() >= len(prompts)
    assert reg.counter("serving.fleet.routed").labels(
        policy="decode").value() >= len(prompts)
    router.close()


def test_disaggregated_short_prompt_skips_prefill_pool(tiny_gpt):
    """A prompt with no full chunk has no KV to hand off: it routes
    straight to the decode pool."""
    cfg, params = tiny_gpt
    rng = np.random.default_rng(9)
    servers = [_server(params, cfg) for _ in range(2)]
    router = FleetRouter(
        servers, start=False,
        policy=RouterPolicy("disaggregated", prefill=(0,),
                            decode=(1,)))
    f = router.submit(rng.integers(3, cfg.vocab_size,
                                   5).astype(np.int32),
                      max_new_tokens=3)
    router.run_until_idle()
    f.result(timeout=5)
    assert router.counts["handoffs"] == 0
    assert servers[0].get_stats()["admitted"] == 0
    assert servers[1].get_stats()["admitted"] == 1
    router.close()


# ---------------------------------------------------------------------------
# fleet registry view
# ---------------------------------------------------------------------------

def test_fleet_registry_view_labels_every_replica(tiny_gpt):
    """ONE /metrics mount exposes every replica's serving.* series
    with a replica= label — previously two servers in one process
    needed two ports to be scraped without clobbering context."""
    cfg, params = tiny_gpt
    rng = np.random.default_rng(10)
    servers = [_server(params, cfg) for _ in range(2)]
    router = FleetRouter(servers, start=False)
    futs = [router.submit(rng.integers(3, cfg.vocab_size,
                                       10).astype(np.int32),
                          max_new_tokens=2) for _ in range(4)]
    router.run_until_idle()
    for f in futs:
        f.result(timeout=5)
    ep = router.serve_metrics(port=0)
    try:
        body = urllib.request.urlopen(
            f"{ep.url}/metrics", timeout=5).read().decode()
        names = [r.name for r in router.replicas()]
        for name in names:
            assert f'serving_admitted{{replica="{name}"}}' in body
            assert f'serving_iterations{{replica="{name}"}}' in body
            assert f'serving_prefix_hits{{replica="{name}"}}' in body
        # exposition stays parseable: one family block per name, all
        # samples contiguous inside it
        assert body.count("# TYPE serving_admitted ") == 1
        lines = body.splitlines()
        fam = [i for i, ln in enumerate(lines)
               if ln.startswith("serving_admitted")]
        assert fam == list(range(fam[0], fam[0] + len(fam)))
        # replica-labeled values are the PER-REPLICA numbers; the
        # unlabeled sample stays the process aggregate
        per = {name: int(float(next(
            ln.split()[-1] for ln in lines
            if ln.startswith(f'serving_admitted{{replica="{name}"}}'))))
            for name in names}
        assert sum(per.values()) == 4
        assert sorted(per.values()) == sorted(
            s.get_stats()["admitted"] for s in servers)
        # /healthz carries the fleet payload
        health = json.loads(urllib.request.urlopen(
            f"{ep.url}/healthz", timeout=5).read().decode())
        assert health["status"] == "ok"
        assert health["live_replicas"] == 2
        assert len(health["replicas"]) == 2
    finally:
        router.close()      # closes the exporter with the router
    assert ep.closed


def test_fleet_registry_view_drops_dead_replica_series(tiny_gpt):
    cfg, params = tiny_gpt
    servers = [_server(params, cfg) for _ in range(2)]
    router = FleetRouter(servers, start=False)
    from paddle_tpu_torch.observability.exporter import FleetRegistryView
    view = FleetRegistryView(lambda: [
        (r.name, r.server.get_stats()) for r in router.replicas()
        if r.alive()])
    assert 'replica="r0"' in view.to_prometheus()
    router.kill_replica(0)
    text = view.to_prometheus()
    assert 'replica="r0"' not in text
    assert 'replica="r1"' in text
    router.close()


# ---------------------------------------------------------------------------
# the port's fleet against the JAX fleet on the same weights and traffic
# ---------------------------------------------------------------------------

def _run_fleet(router, prompts, n_new, waves=(5,), between=2):
    """Submit `prompts` in waves with `between` router steps between
    them, then drain; -> results in submit order."""
    futs, start = [], 0
    for end in list(waves) + [len(prompts)]:
        for p in prompts[start:end]:
            futs.append(router.submit(p, max_new_tokens=n_new))
        start = end
        if end < len(prompts):
            for _ in range(between):
                router.step()
    router.run_until_idle()
    return [f.result(timeout=30) for f in futs]


def _admitted(servers):
    return [s._sched.counts["admitted"] for s in servers]


def test_affinity_fleet_matches_jax_fleet(trained, jax_engine):
    """A mixed-tenant staggered stream over 3 replicas under affinity
    routing: the port's fleet sends every request to the replica the
    JAX fleet sends it to (the same chain keys, the same loads, the same
    seeded power-of-two-choices), and every request's ids equal the JAX
    fleet's."""
    cfg, jparams, params = trained
    rng = np.random.default_rng(0)
    tenant = rng.integers(3, cfg.vocab_size, 16).astype(np.int32)
    prompts = _mixed_prompts(cfg, 9, rng, tenant)
    tsrv = [_server(params, cfg) for _ in range(3)]
    jsrv = [_jserver(jparams, cfg) for _ in range(3)]
    trouter = FleetRouter(tsrv, start=False)
    jrouter = JFleetRouter(jsrv, start=False)
    tres = _run_fleet(trouter, prompts, 8)
    jres = _run_fleet(jrouter, prompts, 8)
    _assert_same_results(tres, jres)
    assert _admitted(tsrv) == _admitted(jsrv)
    assert trouter.counts["routed"] == jrouter.counts["routed"] == 9
    assert [s._prefix.stats()["hits"] for s in tsrv] == \
        [s._prefix.stats()["hits"] for s in jsrv]
    assert sum(s._prefix.stats()["hits"] for s in tsrv) > 0
    trouter.close()
    jrouter.close()


def test_failover_fleet_matches_jax_fleet(trained, jax_engine):
    """The same stream with replica 0 killed at router iteration 4 in
    both fleets: the same failovers, and every re-admitted request's ids
    equal the JAX fleet's (and the port's single server's)."""
    cfg, jparams, params = trained
    rng = np.random.default_rng(1)
    tenant = rng.integers(3, cfg.vocab_size, 16).astype(np.int32)
    prompts = _mixed_prompts(cfg, 9, rng, tenant)
    tsrv = [_server(params, cfg) for _ in range(3)]
    jsrv = [_jserver(jparams, cfg) for _ in range(3)]
    tchaos = ChaosInjector().kill_replica_at(4, 0)
    jchaos = JChaos().kill_replica_at(4, 0)
    trouter = FleetRouter(tsrv, start=False, chaos=tchaos)
    jrouter = JFleetRouter(jsrv, start=False, chaos=jchaos)
    tres = _run_fleet(trouter, prompts, 8)
    jres = _run_fleet(jrouter, prompts, 8)
    assert tchaos.fired["replica_kill"] == jchaos.fired["replica_kill"] \
        == 1
    assert trouter.counts["failovers"] == jrouter.counts["failovers"] >= 1
    _assert_same_results(tres, jres)
    assert [list(r.token_ids) for r in tres] == \
        _reference_ids(params, cfg, prompts, 8)
    trouter.close()
    jrouter.close()


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_disaggregated_handoff_matches_jax_fleet(trained, jax_engine,
                                                 kv_dtype):
    """One prefill replica and two decode replicas, dense and int8 pools
    (an int8 block moves with its scale rows): the port hands off as
    many blocks as the JAX fleet, each request's ids equal the JAX
    fleet's, and the port's disaggregated ids equal its colocated
    single server's."""
    cfg, jparams, params = trained
    rng = np.random.default_rng(8)
    prompts = [rng.integers(3, cfg.vocab_size, 19).astype(np.int32)
               for _ in range(4)]
    kw = {"kv_dtype": kv_dtype} if kv_dtype else {}
    tsrv = [_server(params, cfg, **kw) for _ in range(3)]
    jsrv = [_jserver(jparams, cfg, **kw) for _ in range(3)]
    trouter = FleetRouter(tsrv, start=False, policy=RouterPolicy(
        "disaggregated", prefill=(0,), decode=(1, 2)))
    jrouter = JFleetRouter(jsrv, start=False, policy=JRouterPolicy(
        "disaggregated", prefill=(0,), decode=(1, 2)))
    tres = _run_fleet(trouter, prompts, 6, waves=())
    jres = _run_fleet(jrouter, prompts, 6, waves=())
    assert trouter.counts["handoff_blocks"] == \
        jrouter.counts["handoff_blocks"] == 2 * len(prompts)
    assert trouter.counts["handoffs"] == jrouter.counts["handoffs"]
    _assert_same_results(tres, jres)
    single = _server(params, cfg, **kw)
    futs = [single.submit(p, max_new_tokens=6) for p in prompts]
    single.run_until_idle()
    assert [list(r.token_ids) for r in tres] == \
        [list(f.result(timeout=5).token_ids) for f in futs]
    single.close()
    trouter.close()
    jrouter.close()


# ---------------------------------------------------------------------------
# fleet: fork-group affinity, unit failover, per-lane billing
# (tests/api/test_decode_strategies.py's router tests)
# ---------------------------------------------------------------------------

def test_router_fork_group_unit_failover_and_billing(tiny_gpt):
    """A fork group routes and fails over AS A UNIT: one replica owns
    all K lanes, killing it mid-group replays the whole group on the
    survivor with ids bitwise the single-server run's (counter RNG is
    replica-independent), per-rank streams never deliver a token
    twice, and the survivor's tenant ledger bills every lane's
    tokens."""
    cfg, params = tiny_gpt
    prompt = np.array([5, 9, 11, 2], np.int32)
    sp = SamplingParams(n=3, temperature=1.2, seed=11)
    n_new = 6

    ref_srv = _server(params, cfg)
    rf = ref_srv.submit(prompt, max_new_tokens=n_new, sampling=sp)
    ref_srv.run_until_idle()
    ref = [list(lane.token_ids) for lane in rf.result(timeout=5).lanes]
    ref_srv.close()

    servers = [_server(params, cfg) for _ in range(2)]
    router = FleetRouter(servers, start=False)
    streams = {}

    def stream(rid, rank, tok):
        streams.setdefault(rank, []).append((rid, tok))

    fut = router.submit(prompt, max_new_tokens=n_new, sampling=sp,
                        stream=stream, tenant="acme")
    for _ in range(3):
        router.step()
    owner = next(i for i, s in enumerate(servers)
                 if s.get_stats()["active_slots"] > 0)
    # unit ownership: the OTHER replica holds no lane of this group
    assert servers[1 - owner].get_stats()["active_slots"] == 0
    router.kill_replica(owner)
    router.run_until_idle()
    res = fut.result(timeout=5)

    assert res.group_id == fut.request_id   # router-rid'd GroupResult
    assert [list(lane.token_ids) for lane in res.lanes] == ref
    assert router.counts["failovers"] >= 1
    survivor = servers[1 - owner].get_stats()
    # the survivor served the WHOLE group (group re-admission is
    # all-or-nothing) and billed the tenant for every lane's tokens
    assert survivor["group.requests"] == 1
    assert survivor["group.lanes"] == 3
    acme = survivor["tenants"]["tenants"]["acme"]
    assert acme["requests"] == 3            # one ledger row per lane
    assert acme["decode_tokens"] == 3 * n_new
    # per-rank stream dedup: exactly the lane ids, all under the
    # router's rid, no token twice
    for r in range(3):
        assert streams[r] == [(fut.request_id, t) for t in ref[r]]
    router.close()


def test_router_routes_beam_group(tiny_gpt):
    """Paged beam search through the fleet front door: the GroupResult
    comes back re-keyed under the router's rid with the same
    hypotheses a direct server submit produces."""
    cfg, params = tiny_gpt
    prompt = np.array([7, 3, 12, 4], np.int32)
    K, n_new, eos = 3, 5, 1

    direct = _server(params, cfg)
    df = direct.submit(prompt, max_new_tokens=n_new, eos_id=eos,
                       beam=BeamParams(K))
    direct.run_until_idle()
    want = [list(h.token_ids) for h in df.result(timeout=5).hypotheses]
    direct.close()

    servers = [_server(params, cfg) for _ in range(2)]
    router = FleetRouter(servers, start=False)
    with pytest.raises(ValueError, match="does not stream"):
        router.submit(prompt, max_new_tokens=n_new, eos_id=eos,
                      beam=BeamParams(K), stream=lambda *a: None)
    fut = router.submit(prompt, max_new_tokens=n_new, eos_id=eos,
                        beam=BeamParams(K))
    router.run_until_idle()
    res = fut.result(timeout=5)
    assert res.kind == "beam"
    assert res.group_id == fut.request_id
    assert [list(h.token_ids) for h in res.hypotheses] == want
    router.close()
