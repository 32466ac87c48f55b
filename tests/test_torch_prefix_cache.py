"""The port's prefix cache against the JAX package, on the CPU.

Twins of ``tests/api/test_prefix_cache.py``: paddle_tpu_torch and the
JAX GenerationServer serve the same gpt_tiny params (the JAX package's
startup, handed over as numpy), block 8, chunk 4, and both are stepped
by hand:

- refcounts: double free and free-while-shared raise, unref frees on the
  last reference;
- chain keys equal the JAX package's for the same prompt (blake2b over
  the same bytes), from both ``prompt_chain_keys`` and the index;
- sharing, copy-on-write and concurrent divergence give the ids of the
  JAX prefix server and of an unshared port server, logps within 1e-5,
  and the same hit, miss, copy and block counts;
- eviction is LRU and leaf-first, and runs before backpressure. The
  reference drives eviction with its chaos injector; here the test calls
  ``evict_lru`` at the same iterations;
- a hash collision (the reference's chaos hook; here a substituted
  ``chunk_key``) degrades to a miss;
- int8 pools: ``cow_copy`` carries the scale rows, and the prefix server
  gives the unshared server's ids.

The ledger and flight-recorder twins wait for the telemetry slice.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core import framework
from paddle_tpu.core.executor import Scope, scope_guard
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import GenerationServer as JServer
from paddle_tpu.serving import GPTServingModel as JModel
from paddle_tpu.serving import kv_cache as jkvc
from paddle_tpu.serving import prefix_cache as jprefix
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.serving import (GenerationServer, GPTServingModel,
                                      PagedKVCache, PrefixCacheIndex,
                                      chain_hash, prompt_chain_keys)

ATOL = 1e-5


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
    return JServer(JModel(params, cfg), telemetry=False, **_kw(kw))


def _run(srv, prompt, n, **kw):
    fut = srv.submit(prompt, max_new_tokens=n, **kw)
    srv.run_until_idle()
    return list(fut.result(timeout=5).token_ids)


def _record_logps(srv):
    log = []
    emit = srv._sched._emit_token

    def wrapped(req, tok, lp, now):
        log.append(lp)
        return emit(req, tok, lp, now)

    srv._sched._emit_token = wrapped
    return log


PREFIX_KEYS = ("hits", "misses", "evictions", "cow_copies", "entries",
               "evictable", "shared_blocks")


def _same_prefix_stats(ts, js):
    tp, jp = ts.get_stats()["prefix"], js.get_stats()["prefix"]
    assert {k: tp[k] for k in PREFIX_KEYS} == \
        {k: jp[k] for k in PREFIX_KEYS}
    return tp


# ---------------------------------------------------------------------------
# refcounts and the sharing primitives
# ---------------------------------------------------------------------------

def test_double_free_raises():
    pool = PagedKVCache(num_layers=1, num_heads=2, head_dim=4,
                        num_blocks=9, block_size=4, device="cpu")
    a = pool.allocate(3)
    pool.free(a)
    with pytest.raises(ValueError, match="double free"):
        pool.free(a)
    b = pool.allocate(2)
    pool.free([b[0]])
    with pytest.raises(ValueError, match="double free"):
        pool.free(b)


def test_free_while_shared_raises():
    pool = PagedKVCache(num_layers=1, num_heads=2, head_dim=4,
                        num_blocks=9, block_size=4, device="cpu")
    (b,) = pool.allocate(1)
    pool.ref(b)
    with pytest.raises(ValueError, match="unref"):
        pool.free([b])
    assert pool.refcount(b) == 2 and pool.is_shared(b)
    assert pool.unref(b) is False
    assert pool.unref(b) is True
    with pytest.raises(ValueError, match="unref of free block"):
        pool.unref(b)
    with pytest.raises(ValueError, match="ref of free block"):
        pool.ref(b)


def test_fork_table_and_unref_blocks_match_jax():
    """The same sequence of allocations, forks and releases leaves both
    caches with the same refcounts and free counts."""
    kw = dict(num_layers=1, num_heads=2, head_dim=4, num_blocks=9,
              block_size=4)
    tc, jc = PagedKVCache(device="cpu", **kw), jkvc.PagedKVCache(**kw)
    for c in (tc, jc):
        a = c.allocate(3)
        forked = c.fork_table(a)
        assert forked == a
        assert all(c.is_shared(b) for b in a)
        assert c.unref_blocks(a + c.allocate(2)) == 2
    assert [tc.refcount(b) for b in range(9)] == \
        [jc.refcount(b) for b in range(9)]
    assert tc.num_free == jc.num_free


def test_cow_copy_copies_every_layer_scales_and_siblings():
    """cow_copy writes dst with src's rows in every layer, the int8
    scale rows included, in this cache's pools and its sibling's; other
    blocks stay as they were; the NULL block is refused."""
    gen = torch.Generator().manual_seed(0)
    cache = PagedKVCache(2, 4, 32, 6, block_size=8, device="cpu",
                         num_kv_heads=2, kv_dtype="int8")
    draft = PagedKVCache(1, 2, 32, 6, block_size=8, device="cpu")
    cache.attach_sibling(draft)
    for holder in (cache, draft):
        for layer in holder.pools:
            for name, arr in layer.items():
                if arr.dtype == torch.int8:
                    arr.copy_(torch.randint(-127, 128, arr.shape,
                                            generator=gen))
                else:
                    arr.copy_(torch.rand(arr.shape, generator=gen) + 0.5)
    before = [[{n: a.clone() for n, a in layer.items()}
               for layer in h.pools] for h in (cache, draft)]
    cache.cow_copy(2, 4)
    assert cache.cow_copies == 1
    for h, snap in zip((cache, draft), before):
        for layer, old in zip(h.pools, snap):
            assert set(layer) == set(old)
            for name, arr in layer.items():
                assert torch.equal(arr[4], old[name][2]), name
                keep = [b for b in range(6) if b != 4]
                assert torch.equal(arr[keep], old[name][keep]), name
    assert set(cache.pools[0]) == {"k", "v", "k_scale", "v_scale"}
    with pytest.raises(ValueError, match="NULL"):
        cache.cow_copy(0, 3)
    with pytest.raises(ValueError, match="NULL"):
        cache.cow_copy(3, 0)


# ---------------------------------------------------------------------------
# chain keys
# ---------------------------------------------------------------------------

def test_chain_keys_equal_jax():
    rng = np.random.default_rng(3)
    for n in (1, 8, 17, 40):
        prompt = rng.integers(0, 50000, n).astype(np.int32)
        assert prompt_chain_keys(prompt, 8) == \
            jprefix.prompt_chain_keys(prompt, 8)
        assert chain_hash(None, prompt[:8]) == \
            jprefix.chain_hash(None, prompt[:8])
        tc = PagedKVCache(1, 2, 4, 9, block_size=8, device="cpu")
        jc = jkvc.PagedKVCache(1, 2, 4, 9, block_size=8)
        tkeys = PrefixCacheIndex(tc).chain_keys(prompt, n // 8)
        assert tkeys == jprefix.PrefixCacheIndex(jc).chain_keys(
            prompt, n // 8)
        # extending a computed prefix gives the same chain
        if n >= 16:
            assert PrefixCacheIndex(tc).chain_keys(
                prompt, n // 8, have=tkeys[:1]) == tkeys


# ---------------------------------------------------------------------------
# block sharing
# ---------------------------------------------------------------------------

def test_second_request_shares_prefix_blocks_bitwise(tiny, jax_engine):
    """Same 2-full-chunk prompt twice: the repeat matches both chunks,
    skips their prefill, copies the last shared block (full cover), and
    gives the ids of the JAX prefix server and of an unshared run."""
    cfg, params, tree = tiny
    prompt = np.arange(3, 19, dtype=np.int32)
    ref_ids = _run(_port(tree, cfg), prompt, 6)

    ts = _port(tree, cfg, prefix_cache=True)
    js = _jax(params, cfg, prefix_cache=True)
    tlog, jlog = _record_logps(ts), _record_logps(js)
    for _ in range(2):
        assert _run(ts, prompt, 6) == _run(js, prompt, 6) == ref_ids

    np.testing.assert_allclose(tlog, jlog, rtol=0, atol=ATOL)
    st = ts.get_stats()
    assert _same_prefix_stats(ts, js)["hits"] == 2
    assert st["prefix"]["cow_copies"] == 1
    assert st["prefill_tokens"] == 17 == js.get_stats()["prefill_tokens"]
    assert st["iteration"] == js.get_stats()["iteration"]


def test_lane_block_for_prompt_finds_the_shared_first_block(tiny):
    cfg, _params, tree = tiny
    prompt = np.arange(3, 19, dtype=np.int32)
    srv = _port(tree, cfg, prefix_cache=True)
    _run(srv, prompt, 2)
    fut = srv.submit(prompt, max_new_tokens=2)
    assert srv._sched.lane_block_for_prompt(prompt) is None     # queued
    srv.step()
    assert srv._sched.lane_block_for_prompt(prompt) == \
        srv._prefix.peek(prompt_chain_keys(prompt, 8)[0])[0]
    assert srv._sched.lane_block_for_prompt(prompt[:8]) is None
    srv.run_until_idle()
    fut.result(timeout=5)


def test_shared_then_diverge_concurrent_accounting_exact(tiny, jax_engine):
    cfg, params, tree = tiny
    shared = np.arange(3, 19, dtype=np.int32)
    p_a = np.concatenate([shared, [30, 31]]).astype(np.int32)
    p_b = np.concatenate([shared, [40, 41, 42]]).astype(np.int32)
    ref_a = _run(_port(tree, cfg), p_a, 5)
    ref_b = _run(_port(tree, cfg), p_b, 5)
    outs = []
    for srv in (_port(tree, cfg, prefix_cache=True),
                _jax(params, cfg, prefix_cache=True)):
        assert len(_run(srv, shared, 2)) == 2
        fa = srv.submit(p_a, max_new_tokens=5)
        fb = srv.submit(p_b, max_new_tokens=5)
        srv.step()
        st = srv.get_stats()
        assert st["active_slots"] == 2
        assert st["prefix"]["hits"] == 4
        assert st["prefix"]["shared_blocks"] == 2
        if isinstance(srv, GenerationServer):
            # the shared blocks carry the index's ref and both requests'
            for b in srv._sched._slots[0].shared:
                assert srv.cache.refcount(b) == 3
        srv.run_until_idle()
        outs.append((list(fa.result(5).token_ids),
                     list(fb.result(5).token_ids)))
        st = srv.get_stats()
        cached = st["prefix"]["entries"]
        assert srv.cache.num_free == srv.cache.usable_blocks - cached
        assert st["prefix"]["shared_blocks"] == 0
        assert st["prefix"]["evictable"] == cached
    assert outs[0] == outs[1] == (ref_a, ref_b)


def test_cow_divergence_bitwise_and_original_survives(tiny, jax_engine):
    cfg, params, tree = tiny
    prompt = np.arange(50, 66, dtype=np.int32)
    ref_ids = _run(_port(tree, cfg), prompt, 4)
    ts = _port(tree, cfg, prefix_cache=True)
    js = _jax(params, cfg, prefix_cache=True)
    for i in range(3):
        assert _run(ts, prompt, 4) == _run(js, prompt, 4) == ref_ids, i
    tp = _same_prefix_stats(ts, js)
    assert tp["cow_copies"] == 2 and tp["entries"] == 2
    assert ts.cache.cow_copies == 2
    # the cached originals still hold the first run's KV: the index's
    # blocks are untouched by the copies' writes
    idx = ts._prefix
    for key in prompt_chain_keys(prompt, 8):
        assert idx.peek(key) is not None


def test_partial_prompt_registers_full_chunks_only(tiny, jax_engine):
    """A 20-token prompt caches its 2 full chunks; a repeat matches both
    and prefills the 4-token tail (no copy-on-write)."""
    cfg, params, tree = tiny
    prompt = np.arange(7, 27, dtype=np.int32)
    ts = _port(tree, cfg, prefix_cache=True)
    js = _jax(params, cfg, prefix_cache=True)
    for _ in range(2):
        assert _run(ts, prompt, 3) == _run(js, prompt, 3)
    tp = _same_prefix_stats(ts, js)
    assert tp["entries"] == 2 and tp["hits"] == 2
    assert tp["cow_copies"] == 0
    assert ts.get_stats()["prefill_tokens"] == 24


# ---------------------------------------------------------------------------
# LRU eviction
# ---------------------------------------------------------------------------

def test_evict_lru_leaf_first(tiny):
    """Evictions drain the index leaf-first in least-recently-used order:
    the untouched prompt's chain before the re-used one, children before
    parents. The reference's chaos injector evicts one entry at each of
    four iterations; here the test evicts before each of four steps."""
    cfg, _params, tree = tiny
    p_old = np.arange(3, 19, dtype=np.int32)
    p_new = np.arange(100, 116, dtype=np.int32)
    srv = _port(tree, cfg, prefix_cache=True)
    _run(srv, p_old, 2)
    _run(srv, p_new, 2)
    _run(srv, p_new, 2)
    idx = srv._prefix
    st0 = srv.get_stats()["prefix"]
    assert st0["entries"] == 4 and st0["evictable"] == 4
    blk = {("A" if e.tokens[0] < 100 else "B",
            "parent" if e.parent is None else "child"): e.block
           for e in idx._entries.values()}
    fut = srv.submit([7, 8], max_new_tokens=8)
    order = []
    for _ in range(4):
        order.append(idx.evict_lru())
        srv.step()
    srv.run_until_idle()
    assert len(fut.result(timeout=5).token_ids) == 8
    st = srv.get_stats()["prefix"]
    assert st["entries"] == 0 and st["evictions"] == 4
    assert order == [blk[("A", "child")], blk[("A", "parent")],
                     blk[("B", "child")], blk[("B", "parent")]]
    assert srv.cache.num_free == srv.cache.usable_blocks


def test_evict_lru_protects_matched_keys(tiny):
    cfg, _params, tree = tiny
    srv = _port(tree, cfg, prefix_cache=True)
    prompt = np.arange(3, 19, dtype=np.int32)
    _run(srv, prompt, 2)
    idx = srv._prefix
    keys = prompt_chain_keys(prompt, 8)
    assert idx.evict_lru(protect=frozenset(keys)) is None
    assert idx.evict_for(srv.cache.usable_blocks,
                         protect=frozenset(keys[:1])) == 1
    assert len(idx) == 1 and idx.peek(keys[0]) is not None


def test_eviction_under_pressure_before_backpressure(tiny, jax_engine):
    cfg, params, tree = tiny
    kw = dict(prefix_cache=True, num_blocks=9, max_context=32, num_slots=2)
    outs = []
    for srv in (_port(tree, cfg, **kw), _jax(params, cfg, **kw)):
        for base in (3, 40, 80):
            _run(srv, np.arange(base, base + 16).astype(np.int32), 2)
        st = srv.get_stats()
        assert st["prefix"]["entries"] == 6
        assert st["blocks_free"] == 2
        outs.append(_run(srv, np.arange(200, 216).astype(np.int32), 12))
        st = srv.get_stats()
        assert st["prefix"]["evictions"] >= 2
        assert st["deadline_cancels"] == 0
        outs.append(st["prefix"]["evictions"])
    assert len(outs[0]) == 12
    assert outs[0] == outs[2] and outs[1] == outs[3]


# ---------------------------------------------------------------------------
# hash collisions
# ---------------------------------------------------------------------------

def test_hash_collision_degrades_to_miss(tiny, jax_engine):
    """Two different first chunks share one chain key (the reference
    forces this with its chaos injector; here the index's chunk_key is
    substituted): the second prompt finds the first's entry, the token
    check rejects it, and generation proceeds as a miss with the ids of
    an unshared server."""
    cfg, params, tree = tiny
    p1 = np.arange(3, 19, dtype=np.int32)
    p2 = np.arange(60, 76, dtype=np.int32)
    ref2 = _run(_port(tree, cfg), p2, 4)
    srv = _port(tree, cfg, prefix_cache=True)
    idx = srv._prefix
    real = idx.chunk_key

    def colliding(parent, tokens):
        if parent is None:
            return "collision!"
        return real(parent, tokens)

    idx.chunk_key = colliding
    _run(srv, p1, 4)
    assert idx.peek("collision!") is not None
    assert _run(srv, p2, 4) == ref2
    st = srv.get_stats()["prefix"]
    assert st["hits"] == 0 and st["misses"] == 2
    assert ref2 == _run(_jax(params, cfg), p2, 4)


# ---------------------------------------------------------------------------
# int8 pools
# ---------------------------------------------------------------------------

def test_int8_prefix_cow_carries_scales(tiny, jax_engine):
    """int8 KV pools under the prefix cache: the full-cover repeat copies
    the last shared block's codes AND scale rows (the copy's scales equal
    the cached original's before the re-fed token overwrites its row),
    ids equal the unshared int8 server's, and the hit and copy counts
    equal the JAX int8 prefix server's."""
    cfg, params, tree = tiny
    prompt = np.arange(3, 19, dtype=np.int32)
    ref = _run(_port(tree, cfg, kv_dtype="int8"), prompt, 5)
    ts = _port(tree, cfg, kv_dtype="int8", prefix_cache=True)
    js = _jax(params, cfg, kv_dtype="int8", prefix_cache=True)
    assert _run(ts, prompt, 5) == ref
    _run(js, prompt, 5)
    copies = []
    real = ts.cache.cow_copy

    def spy(src, dst):
        real(src, dst)
        # the copy happens before the step writes the re-fed row
        copies.append([{n: (a[src].clone(), a[dst].clone())
                        for n, a in layer.items()}
                       for layer in ts.cache.pools])

    ts.cache.cow_copy = spy
    assert _run(ts, prompt, 5) == ref
    _run(js, prompt, 5)
    assert len(copies) == 1
    for layer in copies[0]:
        assert set(layer) == {"k", "v", "k_scale", "v_scale"}
        for src_rows, dst_rows in layer.values():
            assert torch.equal(src_rows, dst_rows)
    _same_prefix_stats(ts, js)
    assert ts.get_stats()["prefix"]["cow_copies"] == 1


# ---------------------------------------------------------------------------
# chaos hooks, the HBM ledger and the lane tuples
# ---------------------------------------------------------------------------

def test_chaos_evict_block_lru_leaf_first(tiny, jax_engine):
    """ChaosInjector.evict_block_at drains the index leaf-first in LRU
    order, at the same iterations and in the same block order as the
    JAX server's (test_prefix_cache.py's chaos eviction test)."""
    from paddle_tpu.robustness import ChaosInjector as JChaos
    from paddle_tpu_torch.robustness import ChaosInjector
    cfg, params, tree = tiny
    p_old = np.arange(3, 19, dtype=np.int32)
    p_new = np.arange(100, 116, dtype=np.int32)
    outs = []
    for make, chaos_cls, p in ((_port, ChaosInjector, tree),
                               (_jax, JChaos, params)):
        chaos = chaos_cls()
        srv = make(p, cfg, prefix_cache=True, chaos=chaos)
        _run(srv, p_old, 2)
        _run(srv, p_new, 2)
        _run(srv, p_new, 2)
        idx = srv._prefix
        blk = {("A" if e.tokens[0] < 100 else "B",
                "parent" if e.parent is None else "child"): e.block
               for e in idx._entries.values()}
        it0 = srv.get_stats()["iteration"]
        for k in range(1, 5):
            chaos.evict_block_at(it0 + k)
        order = []
        real_evict = idx.evict_lru
        idx.evict_lru = lambda real=real_evict, order=order: \
            order.append(real()) or order[-1]
        try:
            fut = srv.submit([7, 8], max_new_tokens=8)
            srv.run_until_idle()
            fut.result(timeout=5)
        finally:
            idx.evict_lru = real_evict
        assert chaos.fired["evict"] == 4
        st = srv.get_stats()["prefix"]
        assert st["entries"] == 0 and st["evictions"] == 4
        assert order == [blk[("A", "child")], blk[("A", "parent")],
                         blk[("B", "child")], blk[("B", "parent")]]
        outs.append(order)
    assert outs[0] == outs[1]


def test_chaos_hash_collision_degrades_to_miss(tiny, jax_engine):
    """ChaosInjector.hash_collision_at puts two different first chunks
    on one key: the token check turns the probe into a miss, with the
    JAX server's counts and the unshared server's ids."""
    from paddle_tpu.robustness import ChaosInjector as JChaos
    from paddle_tpu_torch.robustness import ChaosInjector
    cfg, params, tree = tiny
    p1 = np.arange(3, 19, dtype=np.int32)
    p2 = np.arange(60, 76, dtype=np.int32)
    ref2 = _run(_port(tree, cfg), p2, 4)
    stats = []
    for make, chaos_cls, p in ((_port, ChaosInjector, tree),
                               (_jax, JChaos, params)):
        chaos = chaos_cls().hash_collision_at(1).hash_collision_at(3)
        srv = make(p, cfg, prefix_cache=True, chaos=chaos)
        _run(srv, p1, 4)
        assert _run(srv, p2, 4) == ref2
        st = srv.get_stats()["prefix"]
        assert chaos.fired["hash_collision"] == 2
        assert st["collisions"] == 2
        assert st["hits"] == 0 and st["misses"] == 2
        stats.append({k: st[k] for k in PREFIX_KEYS + ("collisions",)})
    assert stats[0] == stats[1]


def test_ledger_never_double_counts_shared_blocks(tiny):
    """The kv_cache ledger row is the preallocated pool's bytes: sharing,
    copy-on-write and chaos evictions move refs, never bytes, and
    close() retires the rows."""
    from paddle_tpu_torch.observability.compile_insight import hbm_ledger
    from paddle_tpu_torch.robustness import ChaosInjector
    cfg, _params, tree = tiny
    chaos = ChaosInjector().evict_block_at(20, n=2)
    srv = _port(tree, cfg, prefix_cache=True, chaos=chaos)
    prompt = np.arange(3, 19, dtype=np.int32)
    expect = srv.cache.pool_bytes()

    def kv_bytes():
        return hbm_ledger().component_bytes(
            srv._ledger_id).get("kv_cache", 0)

    _run(srv, prompt, 2)
    assert kv_bytes() == expect
    _run(srv, prompt, 2)
    assert kv_bytes() == expect
    fut = srv.submit([7, 8], max_new_tokens=25)
    srv.run_until_idle()
    fut.result(timeout=5)
    assert chaos.fired["evict"] == 2
    assert kv_bytes() == expect
    srv.close()
    assert hbm_ledger().component_bytes(srv._ledger_id) == {}


def test_lane_tuple_matches_lane_fields_schema(tiny, jax_engine):
    """Lane tuples zip against LANE_FIELDS (the JAX package's schema);
    a full-cover admission's lane shows its copy-on-write, as the JAX
    server's does."""
    from paddle_tpu.observability.serving_telemetry import \
        LANE_FIELDS as J_FIELDS
    from paddle_tpu_torch.observability.serving_telemetry import \
        LANE_FIELDS
    assert LANE_FIELDS == J_FIELDS
    cfg, params, tree = tiny
    prompt = np.arange(3, 19, dtype=np.int32)
    lanes_of = []
    for srv in (_port(tree, cfg, prefix_cache=True),
                _jax(params, cfg, prefix_cache=True)):
        _run(srv, prompt, 2)
        fut = srv.submit(prompt, max_new_tokens=2)
        srv.step()
        lanes = srv._sched.lane_snapshot()
        assert lanes and all(len(t) == len(LANE_FIELDS) for t in lanes)
        assert dict(zip(LANE_FIELDS, lanes[0]))["cow_copies"] == 1
        srv.run_until_idle()
        fut.result(timeout=5)
        lanes_of.append(lanes)
    assert lanes_of[0] == lanes_of[1]
