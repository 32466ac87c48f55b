"""The port's speculative decoding against the JAX package, on the CPU.

Twins of ``tests/api/test_spec_decode.py``: a gpt_tiny target and a
smaller draft over the same vocab (hidden 64, 2 heads: head dim 32, one
the paged kernel takes on the card; its own startup seed, so its
proposals are imperfect), built by the JAX package and handed to the port
as numpy. Both servers are stepped by hand:

- greedy acceptance is exact: the staggered stream with a mid-stream
  cancel gives the ids of the plain port server and of the JAX spec
  server, logps within 1e-5, and the same proposed/accepted counts;
- a perfect draft (the target itself) accepts everything in fewer
  iterations; an eos inside an accepted burst truncates at the eos;
- construction validates chunk >= k+1, k, mode and the vocab;
- rejection mode commits accepted drafts as drafts, and a fixed seed
  gives the JAX server's ids on two runs;
- the per-column fused step and the draft step equal the JAX package's.

`test_spec_on_mesh_not_supported` waits for TP serving.
"""

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
from paddle_tpu.serving import SpecDecodeConfig as JSpec
from paddle_tpu.serving import kv_cache as jkvc
from paddle_tpu.serving.spec_decode import build_draft_step as jdraft
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.serving import (GenerationServer, GPTServingModel,
                                      PagedKVCache, SpecDecodeConfig)
from paddle_tpu_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                                IterationPlan)
from paddle_tpu_torch.serving.spec_decode import build_draft_step

ATOL = 1e-5


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
    params = jgpt.load_params(scope, cfg)
    return cfg, params, _numpy_tree(params)


@pytest.fixture(scope="module")
def models():
    cfg = jgpt.gpt_tiny()
    dcfg = jgpt.GPTConfig(vocab_size=cfg.vocab_size, hidden_size=64,
                          num_layers=2, num_heads=2, inner_size=128,
                          max_position=128, dropout=0.0)
    return _startup(cfg, 11), _startup(dcfg, 99)


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


def _tmodel(tree, cfg):
    return GPTServingModel(tgpt.params_from_numpy(tree, "cpu"), cfg,
                           device="cpu")


def _port(m, draft=None, k=3, mode="greedy", seed=0, **kw):
    cfg, _params, tree = m
    spec = None
    if draft is not None:
        spec = SpecDecodeConfig(_tmodel(draft[2], draft[0]), k=k,
                                mode=mode, seed=seed)
    return GenerationServer(_tmodel(tree, cfg), device="cpu", spec=spec,
                            **_kw(kw))


def _jax(m, draft=None, k=3, mode="greedy", seed=0, **kw):
    cfg, params, _tree = m
    spec = None
    if draft is not None:
        spec = JSpec(JModel(draft[1], draft[0]), k=k, mode=mode, seed=seed)
    return JServer(JModel(params, cfg), telemetry=False, spec=spec,
                   **_kw(kw))


def _record_logps(srv):
    log = {}
    emit = srv._sched._emit_token

    def wrapped(req, tok, lp, now):
        log.setdefault(req.rid, []).append(lp)
        return emit(req, tok, lp, now)

    srv._sched._emit_token = wrapped
    return log


def _drive_staggered_stream(srv):
    f1 = srv.submit(np.array([5, 9, 11, 2, 7], np.int32), max_new_tokens=8)
    f2 = srv.submit(np.array([7] * 11, np.int32), max_new_tokens=6)
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


def _one(srv, prompt, n, **kw):
    f = srv.submit(prompt, max_new_tokens=n, **kw)
    srv.run_until_idle()
    return f.result(5)


# ---------------------------------------------------------------------------
# greedy acceptance: exact
# ---------------------------------------------------------------------------

def test_spec_greedy_parity_staggered_stream_with_cancel(models, jax_engine):
    target, draft = models
    plain = _port(target)
    ref_ids = _drive_staggered_stream(plain)
    ts, js = _port(target, draft), _jax(target, draft)
    tlog, jlog = _record_logps(ts), _record_logps(js)
    assert _drive_staggered_stream(ts) == ref_ids
    assert _drive_staggered_stream(js) == ref_ids
    for rid in (0, 1, 2):
        np.testing.assert_allclose(tlog[rid], jlog[rid], rtol=0, atol=ATOL)
    st, jst = ts.get_stats(), js.get_stats()
    assert st["spec"]["k"] == 3 and st["spec"]["mode"] == "greedy"
    assert st["spec"]["proposed"] > 0
    for key in ("proposed", "accepted", "accept_rate"):
        assert st["spec"][key] == jst["spec"][key], key
    assert st["blocks_free"] == st["blocks_total"]
    assert st["cancelled"] == 1 and st["retired"] == 3
    assert st["iteration"] == jst["iteration"] <= \
        plain.get_stats()["iteration"]
    assert st["spec"]["draft_launches"] == 0    # the CPU takes the plain op


def test_perfect_draft_accepts_everything_fewer_iterations(models,
                                                           jax_engine):
    target, _ = models
    prompt = np.arange(3, 15, dtype=np.int32)
    plain = _port(target)
    ref = list(_one(plain, prompt, 9).token_ids)
    ts, js = _port(target, target), _jax(target, target)
    assert list(_one(ts, prompt, 9).token_ids) == ref
    assert list(_one(js, prompt, 9).token_ids) == ref
    st = ts.get_stats()
    assert st["spec"]["accept_rate"] == 1.0
    assert st["iteration"] < plain.get_stats()["iteration"]
    assert st["iteration"] == js.get_stats()["iteration"]


def test_eos_inside_accepted_burst_truncates_exactly(models, jax_engine):
    target, _ = models
    prompt = np.array([5, 9, 11], np.int32)
    ref = list(_one(_port(target), prompt, 8).token_ids)
    eos = ref[2]
    ref_eos = list(_one(_port(target), prompt, 8, eos_id=eos).token_ids)
    assert ref_eos == ref[:ref.index(eos) + 1]
    srv = _port(target, target)
    out = _one(srv, prompt, 8, eos_id=eos)
    assert list(out.token_ids) == ref_eos
    assert out.finish_reason == "eos"
    st = srv.get_stats()
    assert st["blocks_free"] == st["blocks_total"]
    jout = _one(_jax(target, target), prompt, 8, eos_id=eos)
    assert list(jout.token_ids) == ref_eos


def test_spec_composes_with_prefix_cache(models, jax_engine):
    """Shared prompt blocks carry the draft's KV too (the draft pools
    share the target's block ids, and copy-on-write copies both): three
    runs of one prompt give the plain ids with every draft accepted."""
    target, _ = models
    prompt = np.arange(3, 19, dtype=np.int32)
    ref = list(_one(_port(target), prompt, 8).token_ids)
    srv = _port(target, target, prefix_cache=True)
    for _ in range(3):
        assert list(_one(srv, prompt, 8).token_ids) == ref
    st = srv.get_stats()
    assert st["spec"]["accept_rate"] == 1.0
    assert st["prefix"]["hits"] == 4 and st["prefix"]["cow_copies"] == 2
    assert srv.cache.cow_copies == 2


# ---------------------------------------------------------------------------
# construction validation
# ---------------------------------------------------------------------------

def test_spec_k_needs_wide_enough_chunk(models):
    target, draft = models
    with pytest.raises(ValueError, match="chunk"):
        _port(target, draft, k=4)
    with pytest.raises(ValueError, match="k must be"):
        SpecDecodeConfig(None, k=0)
    with pytest.raises(ValueError, match="mode"):
        SpecDecodeConfig(None, k=2, mode="banana")


def test_spec_vocab_mismatch_raises(models):
    target, draft = models
    bad_cfg = tgpt.GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                             num_heads=2, inner_size=128, max_position=128,
                             dropout=0.0)
    bad = GPTServingModel(tgpt.params_from_numpy(draft[2], "cpu"), bad_cfg,
                          device="cpu")
    cfg, _params, tree = target
    with pytest.raises(ValueError, match="vocab"):
        GenerationServer(_tmodel(tree, cfg), device="cpu",
                         spec=SpecDecodeConfig(bad, k=2), **_kw({}))


# ---------------------------------------------------------------------------
# rejection-sampled mode
# ---------------------------------------------------------------------------

def test_rejection_mode_commits_the_draft_tokens():
    """White-box _accept: an accepted draft is committed AS the draft
    token even where the target's argmax differs; the correction after
    the accepted prefix is the target's argmax."""
    cache = PagedKVCache(num_layers=1, num_heads=2, head_dim=4,
                         num_blocks=9, block_size=4, device="cpu")
    sched = ContinuousBatchingScheduler(cache, num_slots=1, chunk=4,
                                        max_context=16, spec_k=3,
                                        spec_mode="rejection")
    plan = IterationPlan(
        tokens=np.array([[7, 20, 21, 0]], np.int32),
        positions=np.zeros((1, 4), np.int32),
        valid=np.array([[1, 1, 1, 0]], bool),
        tables=np.zeros((1, 4), np.int32), slot_ids=[0],
        emitting={0}, prefill_tokens=0,
        decode_cols=np.array([3], np.int32),
        limits=np.array([16], np.int32))
    ids = np.array([[30, 31, 32, 33]], np.int32)
    logps = np.full((1, 4), -1.0, np.float32)
    fed = np.full((1, 4), -2.0, np.float32)
    dlp = np.full((1, 3), -2.0, np.float32)
    commits, advance = sched._accept(plan, 0, ids, logps, fed, dlp)
    assert [t for t, _lp in commits] == [20, 21, 32]
    assert advance == 3
    assert [lp for _t, lp in commits] == [-2.0, -2.0, -1.0]


def test_rejection_mode_seed_deterministic_and_equals_jax(models,
                                                          jax_engine):
    target, draft = models
    prompt = np.arange(3, 15, dtype=np.int32)
    outs = []
    for _ in range(2):
        srv = _port(target, draft, mode="rejection", seed=123)
        outs.append(list(_one(srv, prompt, 8).token_ids))
        st = srv.get_stats()
        assert st["spec"]["mode"] == "rejection"
        assert st["blocks_free"] == st["blocks_total"]
    assert outs[0] == outs[1] and len(outs[0]) == 8
    jsrv = _jax(target, draft, mode="rejection", seed=123)
    assert list(_one(jsrv, prompt, 8).token_ids) == outs[0]
    assert jsrv.get_stats()["spec"]["accepted"] == st["spec"]["accepted"]


# ---------------------------------------------------------------------------
# the per-column fused step and the draft step
# ---------------------------------------------------------------------------

def _step_inputs(cfg, bs, s=3, c=4, m=8, seed=0):
    """Lane 0 prefills a full chunk, lane 1 verifies 3 columns at
    position 9 over a written history, lane 2 is idle."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (s, c)).astype(np.int32)
    positions = np.zeros((s, c), np.int32)
    valid = np.zeros((s, c), bool)
    tables = np.zeros((s, m), np.int32)
    positions[0] = np.arange(c)
    valid[0] = True
    tables[0, :2] = [3, 7]
    positions[1, :3] = np.arange(9, 12)
    valid[1, :3] = True
    tables[1, :2] = [5, 2]
    return rng, tokens, positions, valid, tables


def _random_pools(rng, cfg, bs, n_blocks):
    d = cfg.hidden_size // cfg.num_heads
    jc = jkvc.PagedKVCache(cfg.num_layers, cfg.num_heads, d, n_blocks,
                           block_size=bs)
    tc = PagedKVCache(cfg.num_layers, cfg.num_heads, d, n_blocks,
                      block_size=bs, device="cpu")
    for layer in range(cfg.num_layers):
        for name in ("k", "v"):
            hist = rng.standard_normal(
                (n_blocks, cfg.num_heads, bs, d)).astype(np.float32)
            jc.pools[layer][name] = jnp.asarray(hist)
            tc.pools[layer][name] = torch.from_numpy(hist.copy())
    return jc, tc


def test_per_column_fused_step_matches_jax(models, jax_engine):
    """Every column's ids, chosen logps, logp rows and fed-token logps
    equal JAX's per-column step; the wide product's rows equal the
    narrow last-column step's."""
    (cfg, params, tree), _ = models
    bs = 8
    rng, tokens, positions, valid, tables = _step_inputs(cfg, bs)
    jc, tc = _random_pools(rng, cfg, bs, 20)
    s = tokens.shape[0]
    jm, tm = JModel(params, cfg), _tmodel(tree, cfg)
    jout = jax.jit(jm.build_fused_step(bs, per_column=True))(
        jc.pools, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(valid), jnp.asarray(tables))
    args = (torch.from_numpy(tokens), torch.from_numpy(positions),
            torch.from_numpy(valid), torch.from_numpy(tables),
            torch.zeros((s, 2), dtype=torch.int64), torch.ones(s),
            torch.zeros(s, dtype=torch.bool),
            torch.zeros(s, dtype=torch.int32), torch.full((s,), 2.0))
    narrow = [t.clone() for t in (tc.pools[0]["k"], tc.pools[0]["v"])]
    nxt, chosen, logp, fed = tm.fused_step(bs, tc.pools, *args,
                                           per_column=True)
    live = [(0, j) for j in range(4)] + [(1, j) for j in range(3)]
    rows = tuple(np.array(x) for x in zip(*live))
    np.testing.assert_array_equal(nxt.numpy()[rows],
                                  np.asarray(jout[1])[rows])
    np.testing.assert_allclose(chosen.numpy()[rows],
                               np.asarray(jout[2])[rows], rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(fed.numpy()[rows],
                               np.asarray(jout[3])[rows], rtol=0,
                               atol=ATOL)
    for layer in range(cfg.num_layers):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                tc.pools[layer][name][1:].numpy(),
                np.asarray(jout[0][layer][name])[1:], rtol=0, atol=ATOL)
    # the narrow step over the same pools (rewriting the same rows)
    # gives each lane's last valid column's logp row
    tc.pools[0]["k"].copy_(narrow[0])
    tc.pools[0]["v"].copy_(narrow[1])
    _n, _c, logp_narrow = tm.fused_step(bs, tc.pools, *args)
    np.testing.assert_allclose(logp_narrow.numpy()[0], logp.numpy()[0, 3],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(logp_narrow.numpy()[1], logp.numpy()[1, 2],
                               rtol=0, atol=1e-6)


def test_draft_step_matches_jax(models, jax_engine):
    """The draft step's proposals equal JAX's, their logps and the draft
    pools within 1e-5; a rollout past a lane's limit writes nothing but
    the NULL block."""
    _, (dcfg, dparams, dtree) = models
    bs, k = 8, 3
    rng, tokens, positions, valid, tables = _step_inputs(dcfg, bs)
    valid[1, 1:] = False        # the sync pass feeds the committed token
    spec_go = np.array([False, True, False])
    limits = np.array([40, 11, 0], np.int32)   # lane 1: positions < 11
    jc, tc = _random_pools(rng, dcfg, bs, 20)
    jpools, jprops, jlps = jax.jit(jdraft(JModel(dparams, dcfg), bs, k))(
        jc.pools, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(valid), jnp.asarray(tables), jnp.asarray(spec_go),
        jnp.asarray(limits))
    before = [{n: a.clone() for n, a in layer.items()}
              for layer in tc.pools]
    props, lps = build_draft_step(_tmodel(dtree, dcfg), bs, k)(
        tc.pools, torch.from_numpy(tokens), torch.from_numpy(positions),
        torch.from_numpy(valid), torch.from_numpy(tables),
        torch.from_numpy(spec_go), torch.from_numpy(limits))
    assert props.shape == (3, k) and lps.shape == (3, k)
    np.testing.assert_array_equal(props.numpy()[:2],
                                  np.asarray(jprops)[:2])
    np.testing.assert_allclose(lps.numpy()[:2], np.asarray(jlps)[:2],
                               rtol=0, atol=ATOL)
    for layer, old in zip(range(dcfg.num_layers), before):
        for name in ("k", "v"):
            new = tc.pools[layer][name]
            np.testing.assert_allclose(
                new[1:].numpy(), np.asarray(jpools[layer][name])[1:],
                rtol=0, atol=ATOL)
            # lane 0's chunk went to block 3; lane 1 wrote position 9
            # (sync) and 10 (rollout) into block 2 rows 1..2, and its
            # limit kept position 11 (row 3) out
            changed = (new != old[name]).flatten(1).any(1).nonzero()
            assert set(changed[:, 0].tolist()) <= {0, 2, 3}
            assert not torch.equal(new[2, :, 1:3], old[name][2, :, 1:3])
            assert torch.equal(new[2, :, 3:], old[name][2, :, 3:])


def _stale_draft_rows(srv, cache_of):
    """Positions below pos - 1 of the lane (next fed at pos) whose
    layer-0 draft K row differs from the target's: the draft is the
    target itself, so both pools should hold the same rows there (the
    next sync pass writes pos - 1 and pos before it attends)."""
    slot = srv._sched._slots[0]
    bad = []
    for p in range(slot.pos - 1):
        b, r = slot.table[p // 8], p % 8
        t = np.asarray(cache_of(srv.cache)[b, :, r])
        d = np.asarray(cache_of(srv._draft_cache)[b, :, r])
        if np.abs(t - d).max() > 1e-4:
            bad.append(p)
    return bad


def test_self_draft_kv_tracks_the_target_and_accepts_everything(
        models, jax_engine):
    """A divergence from the JAX package, on purpose: its draft step
    writes the KV of proposals d_1..d_{k-1} only, so after a burst of k
    accepted proposals the draft holds no row at d_k's position and the
    next proposals attend a stale one; the JAX self-draft then misses
    proposals (accept rate below 1) and its draft pools differ from the
    target's at those positions. The port's sync pass re-feeds the token
    before the committed one: its draft rows equal the target's at every
    fed position, and the self-draft accepts everything, with the same
    ids."""
    target, _ = models
    prompt = np.arange(3, 15, dtype=np.int32)
    ts, js = _port(target, target), _jax(target, target)
    stale = {"port": set(), "jax": set()}
    futs = []
    for tag, srv, pools in (
            ("port", ts, lambda c: c.pools[0]["k"].numpy()),
            ("jax", js, lambda c: np.asarray(c.pools[0]["k"]))):
        futs.append(srv.submit(prompt, max_new_tokens=20))
        while True:
            if srv._sched._slots[0] is not None:
                stale[tag] |= set(_stale_draft_rows(srv, pools))
            if not srv.step():
                break
    ids = [list(f.result(5).token_ids) for f in futs]
    assert ids[0] == ids[1] == list(_one(_port(target), prompt,
                                         20).token_ids)
    assert stale["port"] == set()
    assert ts.get_stats()["spec"]["accept_rate"] == 1.0
    # the reference's hole, pinned: stale rows, missed proposals
    assert stale["jax"]
    assert js.get_stats()["spec"]["accept_rate"] < 1.0
