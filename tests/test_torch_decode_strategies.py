"""The port's fork groups, paged beam search and guided decoding against
the JAX package, on the CPU.

Twins of ``tests/api/test_decode_strategies.py``: paddle_tpu_torch and
the JAX GenerationServer serve the same gpt_tiny params (the JAX
package's startup, handed over as numpy), 4 slots, block 8, chunk 4,
stepped by hand:

- paged beam search: the hypotheses' ids equal the JAX paged beam's and
  the port's dense ``inference.decoding.beam_decode``'s (the reference
  test's own oracle), normalized scores within 1e-5, f32 and GQA, with an
  eos that lands mid-run; beam + greedy speculation gives the plain beam
  server's hypotheses on f32 and int8 pools;
- fork groups: n=4 lanes off one prefill peak under half the blocks of 4
  independent submits, every block comes back, sampled lanes equal the
  JAX server's lanes and replay identically, and cancel and deadline
  reclaim every lane;
- guided decoding: regex and JSON outputs conform, mask rows equal the
  JAX package's exactly, and ids equal JAX's;
- the host pieces: ``host_sample``, ``beam_step`` and ``finalize_beam``
  equal the JAX package's.

The reference's chaos hooks (a fork storm, a starved mask) are pinned by
forcing the same copy-on-write burst and narrowing the same mask from the
test. The router twins (`test_router_fork_group_unit_failover_and_
billing`, `test_router_routes_beam_group`) wait for the fleet slice.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core import framework
from paddle_tpu.core.executor import Scope, scope_guard
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import BeamParams as JBeam
from paddle_tpu.serving import GenerationServer as JServer
from paddle_tpu.serving import GPTServingModel as JModel
from paddle_tpu.serving import JsonConstraint as JJson
from paddle_tpu.serving import RegexConstraint as JRegex
from paddle_tpu.serving import SamplingParams as JSampling
from paddle_tpu.serving import SpecDecodeConfig as JSpec
from paddle_tpu.serving import decode_strategies as jds
from paddle_tpu.serving import guided as jguided
from paddle_tpu.serving import kv_cache as jkvc
from paddle_tpu_torch.inference import decoding as tdec
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.serving import (BeamParams, ChoiceConstraint,
                                      DeadlineExceeded, GenerationServer,
                                      GPTServingModel, JsonConstraint,
                                      RegexConstraint, RequestCancelled,
                                      SamplingParams, SpecDecodeConfig)
from paddle_tpu_torch.serving import decode_strategies as tds
from paddle_tpu_torch.serving.kv_cache import NEG_INF

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
    kw.setdefault("num_slots", 4)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_context", 64)
    kw.setdefault("chunk", 4)
    kw.setdefault("start", False)
    return kw


def _tmodel(tree, cfg):
    return GPTServingModel(tgpt.params_from_numpy(tree, "cpu"), cfg,
                           device="cpu")


def _port(tree, cfg, **kw):
    return GenerationServer(_tmodel(tree, cfg), device="cpu", **_kw(kw))


def _jax(params, cfg, **kw):
    return JServer(JModel(params, cfg), telemetry=False, **_kw(kw))


def _gqa_cfg(cfg, kv_heads):
    return tgpt.GPTConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        num_layers=cfg.num_layers, num_heads=cfg.num_heads,
        inner_size=cfg.inner_size, max_position=cfg.max_position,
        dropout=0.0, kv_heads=kv_heads)


def _dense_beam(tree, cfg, prompt, n_new, k, eos, lp=0.6, max_len=64):
    """The port's dense reference: teacher-force the prompt into a K-tiled
    dense cache, then beam_decode from the prompt's last token."""
    params = tgpt.params_from_numpy(tree, "cpu")
    d = cfg.hidden_size // cfg.num_heads
    step = tgpt.build_kv_step(params, cfg, max_len)
    cache = tdec.init_kv_cache(k, cfg.num_layers, cfg.num_heads, max_len, d,
                               device="cpu")
    with torch.no_grad():
        for t, tok in enumerate(prompt[:-1]):
            _, cache = step(torch.full((k,), int(tok)), cache, t)
        ids, norm = tdec.beam_decode(
            step, cache, torch.tensor([int(prompt[-1])]), n_new, k, eos,
            length_penalty=lp, start_t=len(prompt) - 1)
    return ids[0].numpy(), norm[0].numpy()


def _char_vocab(vocab_size):
    special = {3: "0", 4: "1", 5: "2", 6: "3", 7: "4", 8: "5", 9: "6",
               10: "7", 11: "8", 12: "9", 13: '"', 14: "{", 15: "}",
               16: ":", 17: ",", 18: "[", 19: "]", 20: "a", 21: "b",
               22: "t", 23: "r", 24: "u", 25: "e", 26: "."}
    return [special.get(i, chr(0x4E00 + i)) for i in range(vocab_size)]


def _assert_conforms(constraint, token_ids, eos):
    state = constraint.initial_state()
    for t in token_ids:
        t = int(t)
        if t == eos:
            assert (constraint.accepting(state)
                    or not constraint.allowed_tokens(state).any())
            return
        state = constraint.advance(state, t)
        assert state is not None, f"token {t} violates the constraint"


def _lanes(fut):
    return [list(lane.token_ids) for lane in fut.result(timeout=5).lanes]


def _hyps(fut):
    return fut.result(timeout=5).hypotheses


# ---------------------------------------------------------------------------
# params surface
# ---------------------------------------------------------------------------

def test_params_validation():
    sp = SamplingParams(n=4, temperature=0.7, top_k=20, top_p=0.9, seed=3)
    assert sp.do_sample and sp.n == 4
    assert not SamplingParams(temperature=0.0).do_sample
    assert not SamplingParams(temperature=None).do_sample
    for bad in (dict(n=0), dict(top_k=0), dict(top_p=1.5)):
        with pytest.raises(ValueError):
            SamplingParams(**bad)
    assert BeamParams(3).length_penalty == 0.6
    with pytest.raises(ValueError):
        BeamParams(0)


# ---------------------------------------------------------------------------
# host pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("knobs", [dict(temperature=1.0),
                                   dict(temperature=0.7, top_k=20),
                                   dict(temperature=1.3, top_p=0.9),
                                   dict(temperature=0.9, top_k=40,
                                        top_p=0.5),
                                   dict(temperature=0.0)])
def test_host_sample_equals_jax(knobs):
    rng = np.random.default_rng(1)
    for lane in range(6):
        row = (rng.standard_normal(256) * 3).astype(np.float32)
        key = tds.fold_key(17, lane, 40 + lane)
        np.testing.assert_array_equal(key, jds.fold_key(17, lane, 40 + lane))
        t, lp = tds.host_sample(row, key, **knobs)
        jt, jlp = jds.host_sample(row, key, **knobs)
        assert t == jt
        assert lp == pytest.approx(jlp, abs=1e-6)


def test_beam_step_and_finalize_equal_jax():
    """Random rows with planted ties (equal totals resolve to the lower
    flat index in both) and finished lanes."""
    rng = np.random.default_rng(2)
    k, v, eos = 4, 64, 5
    scores = np.array([0.0, -1.5, -1.5, NEG_INF], np.float32)
    done = np.array([False, True, False, False])
    for _ in range(5):
        rows = np.log(rng.dirichlet(np.ones(v), k)).astype(np.float32)
        rows[2, 7] = rows[1, 7] = rows[0, 9] = -0.25
        out = tds.beam_step(rows, scores, done, eos)
        ref = jds.beam_step(rows, scores, done, eos)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)
        scores, done = out[2], out[3]
    hist = rng.integers(0, v, (k, 7)).astype(np.int32)
    hist[1, 3:] = eos
    hist[2, 5:] = eos
    ids, norm, order = tds.finalize_beam(hist, scores, eos, 0.6)
    jids, jnorm, jorder = jds.finalize_beam(hist, scores, eos, 0.6)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(order, jorder)
    np.testing.assert_allclose(norm, jnorm, rtol=1e-6)


def _walk_mask_rows(tc, jc, tokens, eos):
    """mask_row of every state along a token walk, port vs JAX, exact;
    returns the number of states compared."""
    ts, js = tc.initial_state(), jc.initial_state()
    n = 0
    for tok in list(tokens) + [None]:
        np.testing.assert_array_equal(tc.mask_row(ts, eos),
                                      jc.mask_row(js, eos))
        assert tc.accepting(ts) == jc.accepting(js)
        n += 1
        if tok is None:
            break
        ts, js = tc.advance(ts, tok), jc.advance(js, tok)
        assert (ts is None) == (js is None)
        if ts is None:
            break
    return n


def test_mask_rows_equal_jax(tiny):
    cfg, _params, _tree = tiny
    vocab = _char_vocab(cfg.vocab_size)
    eos = 1
    # "[0-9]+" over digits; the JSON walk spells {"ab":[12,true]}
    walks = [
        (RegexConstraint("[0-9]+", vocab), JRegex("[0-9]+", vocab),
         [4, 5, 6]),
        (RegexConstraint("(ab|a)*t?[^x]", vocab),
         JRegex("(ab|a)*t?[^x]", vocab), [20, 21, 20, 22, 3]),
        (JsonConstraint(vocab), JJson(vocab),
         [14, 13, 20, 21, 13, 16, 18, 4, 5, 17, 22, 23, 24, 25, 19, 15]),
        (ChoiceConstraint(["12", "1a", "b"], vocab=vocab),
         jguided.ChoiceConstraint(["12", "1a", "b"], vocab=vocab), [4, 5]),
        (ChoiceConstraint([[7, 8, 9], [7, 2]], vocab_size=cfg.vocab_size),
         jguided.ChoiceConstraint([[7, 8, 9], [7, 2]],
                                  vocab_size=cfg.vocab_size), [7, 8, 9]),
    ]
    for tc, jc, tokens in walks:
        assert _walk_mask_rows(tc, jc, tokens, eos) == len(tokens) + 1
    # a violating token kills both automata alike
    tc, jc = RegexConstraint("[0-9]+", vocab), JRegex("[0-9]+", vocab)
    assert tc.advance(tc.initial_state(), 20) is None
    assert jc.advance(jc.initial_state(), 20) is None
    with pytest.raises(ValueError):
        RegexConstraint("(ab", vocab)
    with pytest.raises(ValueError):
        ChoiceConstraint(["a"])


# ---------------------------------------------------------------------------
# paged beam search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["f32", "gqa"])
def test_paged_beam_matches_dense_and_jax(tiny, variant, jax_engine):
    cfg, params, tree = tiny
    k, n_new = 3, 6
    prompt = np.array([5, 9, 11, 2, 7], np.int32)
    if variant == "gqa":
        srv_tree = tgpt.gqa_slice_kv_params(tree, cfg, 2)
        dense_tree = tgpt.gqa_repeat_kv_params(srv_tree, cfg, 2)
        srv_cfg = _gqa_cfg(cfg, 2)
        jparams = jgpt.gqa_slice_kv_params(params, cfg, 2)
        jcfg = jgpt.GPTConfig(
            vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
            num_layers=cfg.num_layers, num_heads=cfg.num_heads,
            inner_size=cfg.inner_size, max_position=cfg.max_position,
            dropout=0.0, kv_heads=2)
    else:
        srv_tree, dense_tree, srv_cfg = tree, tree, cfg
        jparams, jcfg = params, cfg
    probe, _ = _dense_beam(dense_tree, cfg, prompt, n_new, k, eos=0)
    eos = int(probe[0, 2])
    ids, norm = _dense_beam(dense_tree, cfg, prompt, n_new, k, eos)

    srv = _port(srv_tree, srv_cfg)
    fut = srv.submit(prompt, max_new_tokens=n_new, eos_id=eos,
                     beam=BeamParams(k))
    srv.run_until_idle()
    res = fut.result(timeout=5)
    assert res.kind == "beam" and len(res.hypotheses) == k
    jsrv = _jax(jparams, jcfg)
    jf = jsrv.submit(prompt, max_new_tokens=n_new, eos_id=eos,
                     beam=JBeam(k))
    jsrv.run_until_idle()
    jhyps = _hyps(jf)
    for r in range(k):
        got = np.asarray(res.hypotheses[r].token_ids, np.int32)
        np.testing.assert_array_equal(got, ids[r])
        np.testing.assert_array_equal(
            got, np.asarray(jhyps[r].token_ids, np.int32))
        np.testing.assert_allclose(res.hypotheses[r].norm_score, norm[r],
                                   rtol=1e-5)
        assert res.hypotheses[r].norm_score == pytest.approx(
            jhyps[r].norm_score, abs=ATOL)
        assert res.hypotheses[r].score == pytest.approx(
            jhyps[r].score, abs=ATOL)
    st = srv.get_stats()
    assert st["group.requests"] == 1 and st["group.lanes"] == k
    assert st["beam.reorders"] == jsrv.get_stats()["beam.reorders"]
    assert st["blocks_free"] == st["blocks_total"]


def test_beam_spec_parity(tiny, jax_engine):
    """Beam + greedy speculation (the target as its own draft) commits
    the plain beam server's hypotheses on f32 and int8 pools; the f32
    plain beam is JAX's."""
    cfg, params, tree = tiny
    k, n_new, eos = 3, 6, 1
    prompt = np.array([7, 3, 12, 4], np.int32)
    for kw in ({}, {"kv_dtype": "int8"}):
        plain = _port(tree, cfg, **kw)
        f1 = plain.submit(prompt, max_new_tokens=n_new, eos_id=eos,
                          beam=BeamParams(k))
        plain.run_until_idle()
        spec = _port(tree, cfg, spec=SpecDecodeConfig(_tmodel(tree, cfg),
                                                      k=2), **kw)
        f2 = spec.submit(prompt, max_new_tokens=n_new, eos_id=eos,
                         beam=BeamParams(k))
        spec.run_until_idle()
        for a, b in zip(_hyps(f1), _hyps(f2)):
            assert list(a.token_ids) == list(b.token_ids)
            assert a.norm_score == pytest.approx(b.norm_score, rel=1e-6)
        st = spec.get_stats()
        assert st["spec"]["proposed"] > 0
        assert st["blocks_free"] == st["blocks_total"]
        if not kw:
            js = _jax(params, cfg, spec=JSpec(JModel(params, cfg), k=2))
            jf = js.submit(prompt, max_new_tokens=n_new, eos_id=eos,
                           beam=JBeam(k))
            js.run_until_idle()
            assert [list(h.token_ids) for h in _hyps(jf)] == \
                [list(h.token_ids) for h in _hyps(f2)]
            assert js.get_stats()["spec"]["proposed"] == \
                st["spec"]["proposed"]


def test_beam_rejects_invalid_compositions(tiny):
    cfg, _params, tree = tiny
    srv = _port(tree, cfg)
    p = np.array([5, 6, 7], np.int32)
    with pytest.raises(ValueError, match="requires eos_id"):
        srv.submit(p, max_new_tokens=4, beam=BeamParams(2))
    with pytest.raises(ValueError, match="excludes sampling"):
        srv.submit(p, max_new_tokens=4, eos_id=1, beam=BeamParams(2),
                   sampling=SamplingParams())
    with pytest.raises(ValueError, match="cannot stream"):
        srv.submit(p, max_new_tokens=4, eos_id=1, beam=BeamParams(2),
                   stream=lambda r, t: None)
    with pytest.raises(ValueError, match="exceeds num_slots"):
        srv.submit(p, max_new_tokens=4, eos_id=1, beam=BeamParams(9))
    with pytest.raises(ValueError, match="conflicts"):
        srv.submit(p, max_new_tokens=4, n=3,
                   sampling=SamplingParams(n=2))
    with pytest.raises(ValueError, match="requires eos_id"):
        srv.submit(p, max_new_tokens=4,
                   guided=RegexConstraint("[0-9]+", ["0"] * 256))
    with pytest.raises(ValueError, match="pool only has"):
        _port(tree, cfg, num_blocks=12).submit(
            np.arange(3, 27, dtype=np.int32), max_new_tokens=24, n=4)
    spec = _port(tree, cfg, spec=SpecDecodeConfig(_tmodel(tree, cfg), k=2,
                                                  mode="rejection"))
    with pytest.raises(NotImplementedError, match="greedy"):
        spec.submit(p, max_new_tokens=4, eos_id=1, beam=BeamParams(2))
    srv.close()


# ---------------------------------------------------------------------------
# fork groups
# ---------------------------------------------------------------------------

def test_fork_group_halves_block_footprint(tiny, jax_engine):
    cfg, params, tree = tiny
    prompt = np.arange(3, 99, dtype=np.int32)       # 96 toks = 12 blocks
    kw = dict(num_slots=4, max_context=128, num_blocks=60, chunk=16)

    def peak_blocks(srv):
        peak = 0
        while srv.step():
            st = srv.get_stats()
            peak = max(peak, st["blocks_total"] - st["blocks_free"])
        return peak

    grp = _port(tree, cfg, **kw)
    gf = grp.submit(prompt, max_new_tokens=4, n=4)
    peak_group = peak_blocks(grp)
    lanes = _lanes(gf)
    st = grp.get_stats()
    assert len(lanes) == 4 and all(len(l) == 4 for l in lanes)
    assert st["group.requests"] == 1 and st["group.lanes"] == 4
    assert st["group.forks"] == 3
    assert st["prefill_tokens"] == 96               # one prefill
    assert st["blocks_free"] == st["blocks_total"]

    jgrp = _jax(params, cfg, **kw)
    jf = jgrp.submit(prompt, max_new_tokens=4, n=4)
    jpeak = peak_blocks(jgrp)
    assert _lanes(jf) == lanes
    assert jpeak == peak_group
    assert jgrp.get_stats()["group.cow_copies"] == st["group.cow_copies"]

    ind = _port(tree, cfg, **kw)
    futs = [ind.submit(prompt, max_new_tokens=4) for _ in range(4)]
    peak_indep = peak_blocks(ind)
    for f in futs:
        f.result(timeout=5)
    assert peak_group < 0.5 * peak_indep, (peak_group, peak_indep)


def test_fork_group_sampling_replays_and_equals_jax(tiny, jax_engine):
    cfg, params, tree = tiny
    prompt = np.array([5, 9, 11, 2, 7], np.int32)
    kw = dict(n=3, temperature=1.3, top_k=40, seed=17)

    def run(srv, sp):
        fut = srv.submit(prompt, max_new_tokens=6, sampling=sp)
        srv.run_until_idle()
        return _lanes(fut)

    a = run(_port(tree, cfg), SamplingParams(**kw))
    b = run(_port(tree, cfg), SamplingParams(**kw))
    assert a == b
    assert len({tuple(x) for x in a}) > 1
    assert run(_jax(params, cfg), JSampling(**kw)) == a


def test_group_streams_fire_per_lane(tiny):
    cfg, _params, tree = tiny
    srv = _port(tree, cfg)
    seen = {}
    fut = srv.submit(np.array([5, 9, 11], np.int32), max_new_tokens=5,
                     n=3, stream=lambda rid, t: seen.setdefault(
                         rid, []).append(t))
    srv.run_until_idle()
    lanes = _lanes(fut)
    assert [seen[rid] for rid in fut.lane_rids] == lanes


def test_group_cancel_and_deadline_reclaim_all_lanes(tiny, tmp_path):
    cfg, _params, tree = tiny
    prompt = np.arange(5, 29, dtype=np.int32)       # 24 toks = 3 blocks
    srv = _port(tree, cfg)
    fut = srv.submit(prompt, max_new_tokens=12, n=4)
    for _ in range(3):
        srv.step()
    assert fut.cancel()
    srv.run_until_idle()
    with pytest.raises(RequestCancelled):
        fut.result(timeout=5)
    st = srv.get_stats()
    assert st["blocks_free"] == st["blocks_total"]
    assert st["active_slots"] == 0
    f2 = srv.submit(prompt, max_new_tokens=2, n=4)
    srv.run_until_idle()
    assert len(f2.result(timeout=5).lanes) == 4

    # the reference's chaos clock advances 100 ms at each iteration; the
    # four lanes' deadline cancels are a deadline storm, whose flight
    # dump goes to tmp_path
    now = [0.0]
    srv2 = _port(tree, cfg, clock=lambda: now[0], flight_dir=str(tmp_path))
    f3 = srv2.submit(prompt, max_new_tokens=20, n=4, deadline_ms=450)
    while True:
        now[0] += 0.1
        if not srv2.step():
            break
    with pytest.raises(DeadlineExceeded):
        f3.result(timeout=5)
    st2 = srv2.get_stats()
    assert st2["blocks_free"] == st2["blocks_total"]
    assert st2["active_slots"] == 0
    assert st2["deadline_cancels"] >= 1


# ---------------------------------------------------------------------------
# guided decoding
# ---------------------------------------------------------------------------

def test_guided_regex_conformance_and_equals_jax(tiny, jax_engine):
    cfg, params, tree = tiny
    vocab = _char_vocab(cfg.vocab_size)
    eos = 1
    prompt = np.array([5, 9, 11, 2], np.int32)
    c = RegexConstraint("[0-9]+", vocab)
    srv = _port(tree, cfg)
    fut = srv.submit(prompt, max_new_tokens=8, eos_id=eos, guided=c)
    srv.run_until_idle()
    res = fut.result(timeout=5)
    _assert_conforms(c, res.token_ids, eos)
    digits = [t for t in res.token_ids if t != eos]
    assert digits and all(3 <= t <= 12 for t in digits)
    st = srv.get_stats()
    assert st["guided.masked_steps"] >= len(res.token_ids)
    assert st["guided.violations"] == 0
    js = _jax(params, cfg)
    jf = js.submit(prompt, max_new_tokens=8, eos_id=eos,
                   guided=JRegex("[0-9]+", vocab))
    js.run_until_idle()
    assert list(jf.result(5).token_ids) == list(res.token_ids)
    assert js.get_stats()["guided.masked_steps"] == \
        st["guided.masked_steps"]


def test_guided_json_composes_with_fork_group(tiny, jax_engine):
    cfg, params, tree = tiny
    vocab = _char_vocab(cfg.vocab_size)
    eos = 1
    prompt = np.array([7, 3, 12], np.int32)
    c = JsonConstraint(vocab)
    srv = _port(tree, cfg)
    fut = srv.submit(prompt, max_new_tokens=8, eos_id=eos, n=3,
                     sampling=SamplingParams(n=3, temperature=1.0, seed=5),
                     guided=c)
    srv.run_until_idle()
    lanes = _lanes(fut)
    assert len(lanes) == 3
    for lane in lanes:
        _assert_conforms(c, lane, eos)
    assert srv.get_stats()["guided.violations"] == 0
    js = _jax(params, cfg)
    jf = js.submit(prompt, max_new_tokens=8, eos_id=eos, n=3,
                   sampling=JSampling(n=3, temperature=1.0, seed=5),
                   guided=JJson(vocab))
    js.run_until_idle()
    assert _lanes(jf) == lanes


def test_guided_beam_and_spec(tiny, jax_engine):
    """Guided decoding under beam search (eos on the group) and under
    speculation (verify columns masked through a scratch automaton)
    conforms and equals JAX's ids. The draft proposes unmasked, so the
    target's masked choices reject its proposals, and acceptance
    matches JAX's."""
    cfg, params, tree = tiny
    vocab = _char_vocab(cfg.vocab_size)
    eos = 1
    prompt = np.array([5, 9, 11, 2], np.int32)
    srv = _port(tree, cfg)
    bf = srv.submit(prompt, max_new_tokens=6, eos_id=eos, beam=BeamParams(3),
                    guided=RegexConstraint("[0-9]+", vocab))
    srv.run_until_idle()
    js = _jax(params, cfg)
    jbf = js.submit(prompt, max_new_tokens=6, eos_id=eos, beam=JBeam(3),
                    guided=JRegex("[0-9]+", vocab))
    js.run_until_idle()
    for h, jh in zip(_hyps(bf), _hyps(jbf)):
        _assert_conforms(RegexConstraint("[0-9]+", vocab), h.token_ids, eos)
        assert list(h.token_ids) == list(jh.token_ids)
    spec = _port(tree, cfg, spec=SpecDecodeConfig(_tmodel(tree, cfg), k=3))
    c = JsonConstraint(vocab)
    sf = spec.submit(prompt, max_new_tokens=8, eos_id=eos, guided=c)
    spec.run_until_idle()
    ids = list(sf.result(5).token_ids)
    _assert_conforms(c, ids, eos)
    plain = _port(tree, cfg)
    pf = plain.submit(prompt, max_new_tokens=8, eos_id=eos,
                      guided=JsonConstraint(vocab))
    plain.run_until_idle()
    assert list(pf.result(5).token_ids) == ids
    jspec = _jax(params, cfg, spec=JSpec(JModel(params, cfg), k=3))
    jsf = jspec.submit(prompt, max_new_tokens=8, eos_id=eos,
                       guided=JJson(vocab))
    jspec.run_until_idle()
    assert list(jsf.result(5).token_ids) == ids
    st, jst = spec.get_stats()["spec"], jspec.get_stats()["spec"]
    assert st["proposed"] > 0
    assert (st["proposed"], st["accepted"]) == \
        (jst["proposed"], jst["accepted"])


# ---------------------------------------------------------------------------
# forced divergence and starved masks (the reference's chaos hooks)
# ---------------------------------------------------------------------------

def test_forced_cow_burst_keeps_lane_results(tiny):
    """Copy-on-write of two live forked lanes' current blocks at
    iteration 2 (the reference's fork_storm_at(2, 2), forced from the
    test right after admission): the copies come out of the group's
    spares and the lanes' results are unchanged."""
    cfg, _params, tree = tiny
    prompt = np.array([5, 9, 11, 2], np.int32)
    sp = SamplingParams(n=3, temperature=1.0, seed=3)
    ref_srv = _port(tree, cfg)
    rf = ref_srv.submit(prompt, max_new_tokens=6, sampling=sp)
    ref_srv.run_until_idle()
    ref = _lanes(rf)

    srv = _port(tree, cfg)
    sched = srv._sched
    admit = sched._admit
    forced = []

    def admit_then_storm():
        admit()
        if sched.iteration != 2:
            return
        for slot in sched._slots:
            if len(forced) >= 2:
                break
            if slot is None or slot.hold or slot.req.group is None \
                    or slot.prefilling:
                continue
            if sched._force_cow(slot):
                forced.append(slot.req.lane)

    sched._admit = admit_then_storm
    fut = srv.submit(prompt, max_new_tokens=6, sampling=sp)
    srv.run_until_idle()
    assert len(forced) == 2
    st = srv.get_stats()
    assert st["group.cow_copies"] >= 2
    assert st["blocks_free"] == st["blocks_total"]
    assert _lanes(fut) == ref


def test_starved_mask_keeps_conformance(tiny):
    """At iteration 2 the guided lane's mask is narrowed to its single
    lowest allowed token (the reference's mask_starve_at(2)): output
    stays conformant and the loop goes on."""
    cfg, _params, tree = tiny
    vocab = _char_vocab(cfg.vocab_size)
    eos = 1
    c = RegexConstraint("[0-9]+", vocab)
    srv = _port(tree, cfg)
    real = srv._guided_mask
    starved = []

    def narrowed(plan):
        mask = real(plan)
        if srv._sched.iteration == 2 and mask is not None:
            for sid, _req in plan.guided_lanes:
                allowed = torch.nonzero(mask[sid] > NEG_INF / 2)[:, 0]
                mask[sid] = NEG_INF
                mask[sid, allowed[0]] = 0.0
                starved.append(int(allowed[0]))
        return mask

    srv._guided_mask = narrowed
    fut = srv.submit(np.array([5, 9, 11, 2], np.int32), max_new_tokens=6,
                     eos_id=eos, guided=c)
    srv.run_until_idle()
    res = fut.result(timeout=5)
    assert len(starved) == 1
    assert int(res.token_ids[1]) == starved[0]
    _assert_conforms(c, res.token_ids, eos)
    assert srv.get_stats()["guided.violations"] == 0


# ---------------------------------------------------------------------------
# chaos hooks
# ---------------------------------------------------------------------------

def test_chaos_fork_storm_forces_cow_burst(tiny, jax_engine):
    """ChaosInjector.fork_storm_at(2, 2) copies two live forked lanes'
    current blocks out of the group's spares: it fires for exactly the
    lanes it copied, every block comes back, and the lanes' results are
    the unstormed server's. The JAX server fires the same storm with the
    same counts."""
    from paddle_tpu.robustness import ChaosInjector as JChaos
    from paddle_tpu_torch.robustness import ChaosInjector
    cfg, params, tree = tiny
    prompt = np.array([5, 9, 11, 2], np.int32)
    sp = SamplingParams(n=3, temperature=1.0, seed=3)
    ref_srv = _port(tree, cfg)
    rf = ref_srv.submit(prompt, max_new_tokens=6, sampling=sp)
    ref_srv.run_until_idle()
    ref = _lanes(rf)
    counts = []
    for make, chaos_cls, p, sampling in (
            (_port, ChaosInjector, tree, sp),
            (_jax, JChaos, params, JSampling(n=3, temperature=1.0,
                                             seed=3))):
        chaos = chaos_cls().fork_storm_at(2, 2)
        srv = make(p, cfg, chaos=chaos)
        fut = srv.submit(prompt, max_new_tokens=6, sampling=sampling)
        srv.run_until_idle()
        assert chaos.fired["fork_storm"] == 2
        st = srv.get_stats()
        assert st["group.cow_copies"] >= 2
        assert st["blocks_free"] == st["blocks_total"]
        if make is _port:
            assert _lanes(fut) == ref
        counts.append((st["group.cow_copies"], st["iteration"]))
    assert counts[0] == counts[1]


def test_chaos_mask_starve_keeps_conformance(tiny, jax_engine):
    """ChaosInjector.mask_starve_at(2) narrows a guided lane's mask to
    its lowest allowed token for one iteration: the output conforms, the
    loop never raises, and the ids are the JAX server's under the same
    starve."""
    from paddle_tpu.robustness import ChaosInjector as JChaos
    from paddle_tpu_torch.robustness import ChaosInjector
    cfg, params, tree = tiny
    vocab = _char_vocab(cfg.vocab_size)
    eos = 1
    prompt = np.array([5, 9, 11, 2], np.int32)
    ids = []
    for make, chaos_cls, p, cls in ((_port, ChaosInjector, tree,
                                     RegexConstraint),
                                    (_jax, JChaos, params, JRegex)):
        c = cls("[0-9]+", vocab)
        chaos = chaos_cls().mask_starve_at(2)
        srv = make(p, cfg, chaos=chaos)
        fut = srv.submit(prompt, max_new_tokens=6, eos_id=eos, guided=c)
        srv.run_until_idle()
        res = fut.result(timeout=5)
        assert chaos.fired["mask_starve"] == 1
        _assert_conforms(c, res.token_ids, eos)
        assert srv.get_stats()["guided.violations"] == 0
        ids.append(list(res.token_ids))
    assert ids[0] == ids[1]
