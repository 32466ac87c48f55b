"""The port's host KV tier against the JAX package, on the CPU.

Twins of ``tests/api/test_kv_tier.py`` (all but the fleet's
kill-into-resurrection test, which waits for the fleet): the same cache
geometries, the same block contents and the same gpt_tiny params (the
JAX package's startup, handed over as numpy) through both packages:

- HostKVTier mirrors the device geometry (int8 scales beside codes),
  every id is usable, a double free raises, one tier per cache;
- spill and swap-in round-trip bitwise in f32, bf16 (compared as int16
  bit patterns) and int8 with scales, hold the JAX package's host rows,
  and write the pools in place (the reference's one jit signature per
  direction becomes: no pool is reallocated, every data_ptr stays);
- a sibling (draft) cache spills and swaps at mirrored ids;
- the prefix index spills instead of destroying, claims swap back in,
  materialize_key lifts a spilled entry, a protected entry survives host
  pressure: the same blocks, counts and host entries as the JAX index;
- served through both engines: a chaos spill then a hit, preemption and
  resume (greedy dense, int8, GQA, rejection-sampled speculation) and
  lazy admission past the full-reservation ceiling give the JAX
  server's ids, and the same preempts, resumes, spills, swap-ins,
  iterations and preemption victims;
- the host_ram ledger row, the serving.kv.tier.* gauges and the lane
  tuples' tier tag.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu.core import framework
from paddle_tpu.core.executor import Scope, scope_guard
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.robustness import ChaosInjector as JChaos
from paddle_tpu.serving import GenerationServer as JServer
from paddle_tpu.serving import GPTServingModel as JModel
from paddle_tpu.serving import PagedKVCache as JCache
from paddle_tpu.serving import SpecDecodeConfig as JSpec
from paddle_tpu.serving import kv_cache as jkvc
from paddle_tpu.serving.prefix_cache import PrefixCacheIndex as JIndex
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.observability.metrics import global_registry
from paddle_tpu_torch.robustness import ChaosInjector
from paddle_tpu_torch.serving import (GenerationServer, GPTServingModel,
                                      HostKVTier, PagedKVCache,
                                      PrefixCacheIndex, SpecDecodeConfig,
                                      prompt_chain_keys)


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


def _numpy_tree(params):
    return {k: ({kk: np.asarray(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else np.asarray(v))
            for k, v in params.items()}


def _startup(cfg, seed):
    main, startup = framework.Program(), framework.Program()
    main.random_seed = startup.random_seed = seed
    with framework.program_guard(main, startup):
        jgpt.build_lm_net(cfg, seq_len=8)
    scope = Scope()
    with scope_guard(scope):
        fluid.Executor().run(startup)
    return jgpt.load_params(scope, cfg)


@pytest.fixture(scope="module")
def tiny():
    cfg = jgpt.gpt_tiny()
    params = _startup(cfg, 11)
    return cfg, params, _numpy_tree(params)


@pytest.fixture
def jax_engine(monkeypatch):
    """The JAX dispatcher's vmap probe reads an attribute this jax
    removed; outside vmap/shard_map its answer is None."""
    monkeypatch.setattr(jkvc, "_transform_trace_kind", lambda *ops: None)


# ---------------------------------------------------------------------------
# HostKVTier: geometry and accounting
# ---------------------------------------------------------------------------

def _geom(kw):
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 2)
    kw.setdefault("head_dim", 4)
    kw.setdefault("num_blocks", 8)
    kw.setdefault("block_size", 4)
    return kw


def _cache(**kw):
    return PagedKVCache(device="cpu", **_geom(kw))


def _jcache(**kw):
    return JCache(**_geom(kw))


def _bits(x):
    """Comparable bits of a torch or JAX/numpy block: bf16 as int16."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


def test_host_tier_mirrors_device_geometry():
    c, j = _cache(), _jcache()
    host, jhost = c.enable_host_tier(5), j.enable_host_tier(5)
    assert host is c.host and isinstance(host, HostKVTier)
    assert len(host.pools) == c.num_layers == len(jhost.pools)
    for layer, jlayer in zip(host.pools, jhost.pools):
        assert set(layer) == set(jlayer) == {"k", "v"}
        assert tuple(layer["k"].shape) == jlayer["k"].shape == \
            (5, c.num_kv_heads, c.block_size, c.head_dim)
        assert layer["k"].dtype == c.dtype
        assert not layer["k"].is_pinned()       # a CPU cache: plain
    got = host.allocate(5)
    assert got == jhost.allocate(5)
    assert sorted(got) == [0, 1, 2, 3, 4]       # no NULL reservation
    assert host.num_free == 0 and host.allocate(1) is None
    host.free(got)
    assert host.num_free == 5 and host.num_used == 0


def test_host_tier_int8_carries_scale_pools():
    c, j = _cache(kv_dtype="int8"), _jcache(kv_dtype="int8")
    host, jhost = c.enable_host_tier(3), j.enable_host_tier(3)
    layer = host.pools[0]
    assert set(layer) == {"k", "v", "k_scale", "v_scale"}
    assert layer["k"].dtype == torch.int8
    assert layer["k_scale"].dtype == torch.float32
    assert tuple(layer["k_scale"].shape) == (3, c.num_kv_heads,
                                             c.block_size)
    assert float(layer["k_scale"][0, 0, 0]) == 1.0
    per_layer = (layer["k"].numel() * layer["k"].element_size()
                 + layer["k_scale"].numel() * 4)
    assert host.pool_bytes() == 2 * c.num_layers * per_layer \
        == jhost.pool_bytes()


def test_host_tier_double_free_raises():
    host = _cache().enable_host_tier(2)
    b = host.allocate(1)
    host.free(b)
    with pytest.raises(ValueError, match="double free"):
        host.free(b)


def test_enable_host_tier_is_once_per_lifetime():
    c = _cache()
    c.enable_host_tier(2)
    with pytest.raises(ValueError, match="already enabled"):
        c.enable_host_tier(4)
    with pytest.raises(ValueError, match="host tier needs"):
        _cache().enable_host_tier(0)


def test_spill_without_tier_raises():
    c = _cache()
    with pytest.raises(ValueError, match="enable_host_tier"):
        c.spill_block(1)
    with pytest.raises(ValueError, match="enable_host_tier"):
        c.swap_in_block(0, 1)


# ---------------------------------------------------------------------------
# spill / swap-in: bitwise round trip, in place
# ---------------------------------------------------------------------------

def _fill_both(c, j, blk, seed):
    """Write the same seeded rows into device block `blk` of every layer
    and pool of the port cache `c` and the JAX cache `j`; returns the
    port's rows (cloned)."""
    rng = np.random.default_rng(seed)
    want = []
    for li in range(c.num_layers):
        row = {}
        for name, arr in c.pools[li].items():
            shape = tuple(arr.shape[1:])
            if arr.dtype == torch.int8:
                vals = rng.integers(-127, 128, shape).astype(np.int8)
            else:
                vals = rng.standard_normal(shape).astype(np.float32)
            t = torch.from_numpy(vals).to(arr.dtype)
            arr[blk] = t
            if j is not None:
                ja = j.pools[li][name]
                j.pools[li][name] = ja.at[blk].set(
                    jnp.asarray(vals).astype(ja.dtype))
            row[name] = t.clone()
        want.append(row)
    return want


@pytest.mark.parametrize("kv_dtype", [None, "bf16", "int8"])
def test_spill_swap_in_roundtrip_bitwise(kv_dtype):
    c, j = _cache(kv_dtype=kv_dtype), _jcache(kv_dtype=kv_dtype)
    c.enable_host_tier(4)
    j.enable_host_tier(4)
    blocks = c.allocate(2)
    assert blocks == j.allocate(2)
    want = {b: _fill_both(c, j, b, seed=b + 1) for b in blocks}
    hbs = {b: c.spill_block(b) for b in blocks}
    jhbs = {b: j.spill_block(b) for b in blocks}
    assert hbs == jhbs
    assert c.host_spills == 2 == j.host_spills and c.host.num_used == 2
    for b, hb in hbs.items():
        for li in range(c.num_layers):
            for name, vals in want[b][li].items():
                host_row = c.host.pools[li][name][hb]
                np.testing.assert_array_equal(_bits(host_row), _bits(vals))
                np.testing.assert_array_equal(
                    _bits(host_row), _bits(j.host.pools[li][name][hb]))
    dst = c.allocate(2)
    assert dst == j.allocate(2)
    for (b, hb), d in zip(hbs.items(), dst):
        c.swap_in_block(hb, d)
        j.swap_in_block(hb, d)
        for li in range(c.num_layers):
            for name, vals in want[b][li].items():
                np.testing.assert_array_equal(
                    _bits(c.pools[li][name][d]), _bits(vals))
                np.testing.assert_array_equal(
                    _bits(c.pools[li][name][d]),
                    _bits(j.pools[li][name][d]))
    assert c.host_swap_ins == 2 == j.host_swap_ins
    # the owner frees host blocks: swap_in does not
    c.host.free(list(hbs.values()))
    assert c.host.num_used == 0


def test_spill_and_swap_in_write_the_pools_in_place():
    """The reference's one jit signature per direction: the port's form
    is that no pool is ever reallocated, so every device and host pool
    keeps its storage across any number of spills and swap-ins."""
    c = _cache(kv_dtype="int8")
    c.enable_host_tier(6)

    def ptrs():
        return [t.data_ptr() for pools in (c.pools, c.host.pools)
                for layer in pools for t in layer.values()]

    before = ptrs()
    blocks = c.allocate(4)
    for b in blocks:
        _fill_both(c, None, b, seed=b)
    hbs = [c.spill_block(b) for b in blocks]
    for hb, d in zip(hbs, c.allocate(3)):
        c.swap_in_block(hb, d)
    assert ptrs() == before
    assert c.host_spills == 4 and c.host_swap_ins == 3


def test_sibling_pools_spill_and_swap_at_mirrored_ids():
    c, d = _cache(), _cache(num_layers=1)
    j, jd = _jcache(), _jcache(num_layers=1)
    c.attach_sibling(d)
    j.attach_sibling(jd)
    c.enable_host_tier(4)
    j.enable_host_tier(4)
    assert d.host is not None and d.host.num_blocks == 4
    blk = c.allocate(1)[0]
    assert blk == j.allocate(1)[0]
    want_c = _fill_both(c, j, blk, seed=3)
    want_d = _fill_both(d, jd, blk, seed=4)
    hb = c.spill_block(blk)
    assert hb == j.spill_block(blk)
    np.testing.assert_array_equal(_bits(d.host.pools[0]["k"][hb]),
                                  _bits(want_d[0]["k"]))
    np.testing.assert_array_equal(_bits(d.host.pools[0]["k"][hb]),
                                  _bits(jd.host.pools[0]["k"][hb]))
    nb = c.allocate(1)[0]
    c.swap_in_block(hb, nb)
    np.testing.assert_array_equal(_bits(c.pools[1]["v"][nb]),
                                  _bits(want_c[1]["v"]))
    np.testing.assert_array_equal(_bits(d.pools[0]["v"][nb]),
                                  _bits(want_d[0]["v"]))
    # a sibling attached after the tier gets its mirror too
    late = _cache(num_layers=1)
    c.attach_sibling(late)
    assert late.host is not None and late.host.num_blocks == 4
    c.host.free([hb])


# ---------------------------------------------------------------------------
# prefix index: spill instead of destroy, materialize on claim
# ---------------------------------------------------------------------------

def _chain(idx, c, prompt):
    """Register `prompt`'s full chunks as an idle chain (authors
    retired); returns (keys, blocks)."""
    bs = c.block_size
    n = len(prompt) // bs
    keys = prompt_chain_keys(prompt, bs)
    blocks = c.allocate(n)
    parent = None
    for i, (k, b) in enumerate(zip(keys, blocks)):
        assert idx.register(k, parent, prompt[i * bs:(i + 1) * bs], b)
        parent = k
    for b in blocks:
        c.unref(b)
    return keys, blocks


def _both_indexes(num_blocks, host_blocks):
    c = _cache(num_blocks=num_blocks, block_size=4)
    j = _jcache(num_blocks=num_blocks, block_size=4)
    c.enable_host_tier(host_blocks)
    j.enable_host_tier(host_blocks)
    return (c, PrefixCacheIndex(c)), (j, JIndex(j))


def test_evict_spills_chain_and_claim_materializes():
    outs = []
    for c, idx in _both_indexes(6, 4):
        prompt = np.arange(3, 11, dtype=np.int32)
        keys, blocks = _chain(idx, c, prompt)
        # leaf first: the child spills, then the parent
        assert idx.evict_lru() == blocks[1]
        assert idx.evict_lru() == blocks[0]
        assert idx.counts["spills"] == 2 and idx.host_entry_count() == 2
        assert c.num_free == c.usable_blocks
        m = idx.match(prompt, keys)
        assert m == [None, None] and idx.peek(keys[0]) is None
        got = idx.claim(keys, m, probed=2)
        assert len(got) == 2 and all(b is not None for b in got)
        assert idx.counts["swap_ins"] == 2
        assert idx.counts["reprefills_avoided"] == 2
        assert idx.host_entry_count() == 0 and c.host.num_used == 0
        assert idx.peek(keys[1]) is not None
        idx.release(got)
        idx.drop_gauges()
        outs.append((got, dict(idx.counts), idx.stats()))
    assert outs[0] == outs[1]


def test_materialize_key_lifts_spilled_entry_for_rewarm():
    outs = []
    for c, idx in _both_indexes(5, 2):
        prompt = np.arange(5, 9, dtype=np.int32)
        keys, _ = _chain(idx, c, prompt)
        assert idx.evict_lru() is not None
        assert idx.peek(keys[0]) is None
        db = idx.materialize_key(keys[0])
        assert db is not None and idx.peek(keys[0])[0] == db
        assert idx.materialize_key(keys[0]) is None     # device already
        assert idx.materialize_key("nope") is None      # absent
        idx.drop_gauges()
        outs.append((db, dict(idx.counts)))
    assert outs[0] == outs[1]


def test_protected_entry_survives_match_to_claim_race_across_spill():
    outs = []
    for c, idx in _both_indexes(6, 1):
        prompt_a = np.arange(3, 7, dtype=np.int32)
        prompt_b = np.arange(20, 24, dtype=np.int32)
        keys_a, _ = _chain(idx, c, prompt_a)
        keys_b, blocks_b = _chain(idx, c, prompt_b)
        protect = frozenset(keys_a)
        assert idx.match(prompt_a, keys_a) == [idx.peek(keys_a[0])[0]]
        assert idx.evict_lru(frozenset()) is not None   # A spills
        assert idx.host_entry_count() == 1 and c.host.num_free == 0
        # host full, its one entry protected: B is destroyed instead
        assert idx._drop_host_lru(protect) is None
        assert idx.evict_lru(protect) == blocks_b[0]
        assert idx.counts["host_drops"] == 0
        assert keys_a[0] in idx._entries and keys_b[0] not in idx._entries
        m2 = idx.match(prompt_a, keys_a)
        assert m2 == [None]
        got = idx.claim(keys_a, m2, probed=1)
        assert len(got) == 1 and got[0] is not None
        assert idx.counts["reprefills_avoided"] == 1
        idx.release(got)
        assert idx.evict_lru() is not None              # A spills again
        assert idx._drop_host_lru() is not None
        assert idx.counts["host_drops"] == 1
        idx.drop_gauges()
        outs.append((got, dict(idx.counts)))
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# engine integration: gpt_tiny through both engines
# ---------------------------------------------------------------------------

def _kw(kw):
    kw.setdefault("num_slots", 3)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_context", 64)
    kw.setdefault("chunk", 4)
    kw.setdefault("start", False)
    return kw


def _port(tree, cfg, spec_tree=None, **kw):
    return GenerationServer(
        GPTServingModel(tgpt.params_from_numpy(tree, "cpu"), cfg,
                        device="cpu"), device="cpu", **_kw(kw))


def _jax(params, cfg, **kw):
    return JServer(JModel(params, cfg), **_kw(kw))


def _run(srv, prompts, n_new):
    futs = [srv.submit(p, max_new_tokens=n_new) for p in prompts]
    srv.run_until_idle()
    return [list(f.result(timeout=5).token_ids) for f in futs]


def _victims(srv):
    """Records the request id of every preemption victim (the
    scheduler's one parking point)."""
    log = []
    sched = srv._sched
    real = sched._preempt_slot

    def wrapped(sid):
        rid = sched._slots[sid].req.rid
        ok = real(sid)
        if ok:
            log.append(rid)
        return ok

    sched._preempt_slot = wrapped
    return log


TIER_KEYS = ("host_blocks", "host_blocks_used", "spills", "swap_ins",
             "preempts", "resumes", "preempted_depth",
             "reprefills_avoided")


def _same_tier_stats(ts, js):
    tst, jst = ts.get_stats(), js.get_stats()
    assert {k: tst["kv_tier"][k] for k in TIER_KEYS} == \
        {k: jst["kv_tier"][k] for k in TIER_KEYS}
    for k in ("preempts", "resumes", "preempted_depth", "iteration",
              "blocks_free", "admitted", "retired"):
        assert tst[k] == jst[k], k
    return tst


def test_chaos_spill_then_hit_serves_from_host_tier(tiny, jax_engine):
    cfg, params, tree = tiny
    rng = np.random.default_rng(21)
    prompt = rng.integers(3, cfg.vocab_size, 17).astype(np.int32)
    ref = _run(_port(tree, cfg, prefix_cache=True), [prompt], 6)[0]
    runs = []
    for make, chaos_cls, p in ((_port, ChaosInjector, tree),
                               (_jax, JChaos, params)):
        chaos = chaos_cls()
        srv = make(p, cfg, prefix_cache=True, host_kv_blocks=8,
                   chaos=chaos)
        first = _run(srv, [prompt], 6)[0]
        chaos.spill_chain_at(srv._sched.iteration + 1, 2)
        second = _run(srv, [prompt], 6)[0]
        assert chaos.fired["spill"] == 2
        runs.append((srv, first, second))
    (ts, tf, tsec), (js, jf, jsec) = runs
    assert tf == tsec == ref == jf == jsec
    st = _same_tier_stats(ts, js)
    kt = st["kv_tier"]
    assert kt["host_blocks"] == 8
    assert kt["spills"] >= 2 and kt["swap_ins"] >= 2
    assert kt["reprefills_avoided"] >= 2
    assert st["prefix"]["hits"] >= 2
    assert st["prefix"]["hits"] == js.get_stats()["prefix"]["hits"]
    g = global_registry().gauge("serving.kv.tier.reprefills_avoided")
    assert any(c.value() >= 2 for lbl, c in g.series()
               if lbl.get("server") == ts._ledger_id)
    ts.close()
    js.close()
    for name in ("serving.kv.tier.host_blocks",
                 "serving.kv.tier.reprefills_avoided"):
        assert not [lbl for lbl, _ in global_registry().gauge(name)
                    .series() if lbl.get("server") == ts._ledger_id]


def test_host_ram_ledger_rows_never_inflate_resident_total(tiny):
    from paddle_tpu_torch.observability.compile_insight import (
        LEDGER_KINDS, RESIDENT_KINDS, hbm_ledger)
    assert "host_ram" in LEDGER_KINDS
    assert "host_ram" not in RESIDENT_KINDS
    cfg, _params, tree = tiny
    off = _port(tree, cfg)
    on = _port(tree, cfg, host_kv_blocks=8)
    st_off, st_on = off.get_stats(), on.get_stats()
    assert st_on["memory"]["host_ram"] == on.cache.host_pool_bytes()
    assert "host_ram" not in st_off["memory"]
    assert st_on["memory"]["kv_cache"] == st_off["memory"]["kv_cache"]
    assert st_on["memory"]["params"] == st_off["memory"]["params"]
    rows = {e["name"]: e for e in hbm_ledger().snapshot()["entries"]
            if e["component"] == on._ledger_id}
    host_row = rows["kv_pool_host"]
    assert host_row["kind"] == "host_ram"
    assert host_row["detail"]["tier"] == "host"
    assert host_row["detail"]["num_blocks"] == 8
    assert rows["kv_pool"]["detail"]["tier"] == "device"
    assert st_off.get("kv_tier") is None
    assert st_on["kv_tier"]["host_pool_bytes"] > 0
    # the host pool's bytes: 8 blocks x the device block's bytes
    assert on.cache.host_pool_bytes() == \
        on.cache.pool_bytes() // on.cache.num_blocks * 8
    total = hbm_ledger().snapshot()["total_bytes"]
    off.close()
    on.close()
    assert hbm_ledger().snapshot()["total_bytes"] == total - (
        st_on["memory"]["kv_cache"] + st_on["memory"]["params"]
        + st_off["memory"]["kv_cache"] + st_off["memory"]["params"])


def _preempt_both(tree, params, cfg, n_new=10, **kw):
    """The same greedy stream uninterrupted (port) and preempted at
    iteration 6 through both engines: (ref, port ids, JAX ids, port
    server, JAX server, port chaos)."""
    rng = np.random.default_rng(33)
    prompts = [rng.integers(3, cfg.vocab_size,
                            int(rng.integers(9, 14))).astype(np.int32)
               for _ in range(3)]
    ref = _run(_port(tree, cfg, **kw), prompts, n_new)
    out = []
    for make, chaos_cls, p in ((_port, ChaosInjector, tree),
                               (_jax, JChaos, params)):
        chaos = chaos_cls()
        srv = make(p, cfg, host_kv_blocks=24, chaos=chaos, **kw)
        futs = [srv.submit(q, max_new_tokens=n_new) for q in prompts]
        chaos.preempt_request_at(6, futs[0].request_id)
        srv.run_until_idle()
        out.append(([list(f.result(timeout=5).token_ids) for f in futs],
                    srv, chaos))
    (ids, ts, tchaos), (jids, js, jchaos) = out
    assert tchaos.fired["preempt"] == 1 == jchaos.fired["preempt"]
    return ref, ids, jids, ts, js


def test_preempt_resume_bitwise_greedy_dense(tiny, jax_engine):
    cfg, params, tree = tiny
    ref, ids, jids, ts, js = _preempt_both(tree, params, cfg)
    assert ids == ref == jids
    st = _same_tier_stats(ts, js)
    assert st["preempts"] == 1 and st["resumes"] == 1
    assert st["blocks_free"] == st["blocks_total"]
    assert st["kv_tier"]["host_blocks_used"] == 0
    assert st["kv_tier"]["preempted_depth"] == 0


def test_preempt_resume_bitwise_int8(tiny, jax_engine):
    cfg, params, tree = tiny
    ref, ids, jids, ts, js = _preempt_both(tree, params, cfg,
                                           kv_dtype="int8")
    assert ids == ref
    st = _same_tier_stats(ts, js)
    assert st["preempts"] == 1 and st["resumes"] == 1
    assert st["kv_quant"]["kv_dtype"] == "int8"
    # int8 codes can round differently from the JAX server's jitted
    # scales (an ulp in a few rows), so ids are held to the port's own
    # uninterrupted run; the JAX server's preempted run equals its own
    assert jids == _run(_jax(params, cfg, kv_dtype="int8"),
                        _prompts33(cfg), 10)


def _prompts33(cfg):
    rng = np.random.default_rng(33)
    return [rng.integers(3, cfg.vocab_size,
                         int(rng.integers(9, 14))).astype(np.int32)
            for _ in range(3)]


def test_preempt_resume_bitwise_gqa(tiny, jax_engine):
    cfg, params, _tree = tiny
    kv = 2
    gqa_cfg = jgpt.GPTConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        num_layers=cfg.num_layers, num_heads=cfg.num_heads,
        inner_size=cfg.inner_size, max_position=cfg.max_position,
        dropout=0.0, kv_heads=kv)
    gqa_params = jgpt.gqa_slice_kv_params(params, cfg, kv)
    ref, ids, jids, ts, js = _preempt_both(_numpy_tree(gqa_params),
                                           gqa_params, gqa_cfg)
    assert ids == ref == jids
    st = _same_tier_stats(ts, js)
    assert st["preempts"] == 1 and st["resumes"] == 1


def test_preempt_resume_bitwise_sampled_spec(tiny, jax_engine):
    """Rejection-sampled speculation with a seeded RNG is deterministic
    for one request, so a preemption and resume reproduce the
    uninterrupted sampled stream (the draft's KV rides the same host
    blocks)."""
    cfg, params, tree = tiny
    dcfg = jgpt.GPTConfig(vocab_size=cfg.vocab_size, hidden_size=64,
                          num_layers=2, num_heads=2, inner_size=128,
                          max_position=128, dropout=0.0)
    dparams = _startup(dcfg, 99)
    dtree = _numpy_tree(dparams)

    def port_spec(**kw):
        draft = GPTServingModel(tgpt.params_from_numpy(dtree, "cpu"), dcfg,
                                device="cpu")
        return _port(tree, cfg, spec=SpecDecodeConfig(
            draft, k=3, mode="rejection", seed=123), **kw)

    def jax_spec(**kw):
        return _jax(params, cfg, spec=JSpec(JModel(dparams, dcfg), k=3,
                                            mode="rejection", seed=123),
                    **kw)

    prompt = np.arange(3, 15, dtype=np.int32)
    out = []
    for make, chaos_cls in ((port_spec, ChaosInjector), (jax_spec, JChaos)):
        ref = _run(make(), [prompt], 8)[0]
        chaos = chaos_cls()
        srv = make(host_kv_blocks=24, chaos=chaos)
        f = srv.submit(prompt, max_new_tokens=8)
        chaos.preempt_request_at(5, f.request_id)
        srv.run_until_idle()
        ids = list(f.result(timeout=5).token_ids)
        st = srv.get_stats()
        assert chaos.fired["preempt"] == 1
        assert st["preempts"] == 1 and st["resumes"] == 1
        assert ids == ref
        assert st["spec"]["mode"] == "rejection"
        out.append((ids, srv))
    # the draft caches differ by the port's stale-row fix (ROADMAP C2),
    # so the two packages' sampled streams are each held to their own
    # uninterrupted run; the tier's traffic is the same
    _same_tier_stats(out[0][1], out[1][1])


def test_lazy_admission_exceeds_full_reservation_ceiling(tiny, jax_engine):
    """A 9-block pool full-reserves 4 blocks a (8 prompt + 24 new)
    request: at most 2 at once. With a host tier admission reserves the
    prefill and pledges the rest against host blocks, so all 3 run at
    once; pressure preempts and resumes, and every stream is still the
    big-pool stream. Both engines preempt the same victims at the same
    iterations."""
    cfg, params, tree = tiny
    rng = np.random.default_rng(44)
    prompts = [rng.integers(3, cfg.vocab_size, 8).astype(np.int32)
               for _ in range(3)]
    ref = _run(_port(tree, cfg), prompts, 24)

    def max_active(srv):
        futs = [srv.submit(p, max_new_tokens=24) for p in prompts]
        peak = 0
        while srv.step():
            peak = max(peak, srv._sched.active_count)
        return peak, [list(f.result(timeout=5).token_ids) for f in futs]

    base = _port(tree, cfg, num_blocks=9)
    base_peak, base_ids = max_active(base)
    assert base_peak <= 2 and base_ids == ref
    base.close()
    ts = _port(tree, cfg, num_blocks=9, host_kv_blocks=16)
    js = _jax(params, cfg, num_blocks=9, host_kv_blocks=16)
    tv, jv = _victims(ts), _victims(js)
    peak, ids = max_active(ts)
    jpeak, jids = max_active(js)
    assert peak == 3 == jpeak and peak > base_peak
    assert ids == ref == jids
    st = _same_tier_stats(ts, js)
    assert tv == jv and len(tv) == st["preempts"] >= 1
    assert st["resumes"] == st["preempts"]
    assert st["blocks_free"] == st["blocks_total"]
    assert st["kv_tier"]["host_blocks_used"] == 0
    ts.close()
    js.close()


def test_preemption_storm_counts_equal_jax(tiny, jax_engine):
    """A longer stream under pressure (six requests of mixed lengths
    over a 13-block pool, a 40-block host tier, a chaos preemption on
    top): the port's scheduling equals the JAX package's, victim for
    victim, and every block comes back."""
    cfg, params, tree = tiny
    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, cfg.vocab_size,
                            int(rng.integers(5, 20))).astype(np.int32)
               for _ in range(6)]
    news = [int(x) for x in rng.integers(8, 30, 6)]
    ref = _port(tree, cfg)
    rf = [ref.submit(p, max_new_tokens=n) for p, n in zip(prompts, news)]
    ref.run_until_idle()
    want = [list(f.result(timeout=5).token_ids) for f in rf]
    got = []
    for make, chaos_cls, p in ((_port, ChaosInjector, tree),
                               (_jax, JChaos, params)):
        chaos = chaos_cls()
        srv = make(p, cfg, num_blocks=13, host_kv_blocks=40, chaos=chaos)
        victims = _victims(srv)
        futs = [srv.submit(q, max_new_tokens=n)
                for q, n in zip(prompts, news)]
        chaos.preempt_request_at(9, futs[1].request_id)
        srv.run_until_idle()
        got.append(([list(f.result(timeout=5).token_ids) for f in futs],
                    victims, srv))
    (ids, tv, ts), (jids, jv, js) = got
    assert ids == want == jids
    assert tv == jv and len(tv) >= 2
    st = _same_tier_stats(ts, js)
    assert st["resumes"] == st["preempts"] == len(tv)
    assert st["blocks_free"] == st["blocks_total"]
    assert st["kv_tier"]["host_blocks_used"] == 0


def test_lane_records_carry_tier_tag(tiny):
    from paddle_tpu_torch.observability.serving_telemetry import \
        LANE_FIELDS
    assert LANE_FIELDS[-3:] == ("tier", "group", "beam_rank")
    cfg, _params, tree = tiny
    chaos = ChaosInjector()
    srv = _port(tree, cfg, host_kv_blocks=16, chaos=chaos)
    f = srv.submit(np.arange(3, 13, dtype=np.int32), max_new_tokens=8)
    chaos.preempt_request_at(5, f.request_id)
    tiers = set()
    while srv.step():
        for t in srv._sched.lane_snapshot():
            tiers.add(dict(zip(LANE_FIELDS, t))["tier"])
    f.result(timeout=5)
    assert tiers == {"device", "host"}
    srv.close()
