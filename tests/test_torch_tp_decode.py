"""Tensor-parallel dense KV decoding in the port against the JAX package,
on the CPU.

Twins of ``tests/parallel/test_tp_decode.py``: ``make_tp_decoder`` /
``make_tp_greedy_decoder`` (greedy, beam, dp x tp) and
``make_tp_prompt_decoder`` over a local tp mesh
(``make_named_mesh(("tp",), (tp,), ["cpu"] * tp)``: every rank in this
process, in turn) against the JAX package's single-chip decoders and its
tp decoders on its conftest-forced virtual CPU devices, all on one
briefly-trained gpt_tiny (30 Adam steps, as in the reference, so the
greedy argmax is decisive against the reductions' summation order). The
JAX reference reads its compiled text for all-reduces and
(B, H/tp, L, D) cache tensors; the port counts the mesh's reductions and
reads its caches' shapes.

Tolerances: ids exactly; scores rtol = atol = 2e-5 (the reference's);
the sharded cache within rtol 1e-5 of the single-device cache (its
later layers see a residual summed in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

import paddle_tpu as fluid
from paddle_tpu.core import framework
from paddle_tpu.core.executor import Scope, scope_guard
from paddle_tpu.inference import decoding as jdec
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.inference import decoding as tdec
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.parallel.mesh import make_named_mesh

TOL = 2e-5


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
    """test_tp_decode's briefly-trained gpt_tiny: (cfg, JAX params, the
    port's params on the CPU)."""
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
    return cfg, params, tgpt.params_from_numpy(tree, "cpu")


def _tmesh(tp):
    return make_named_mesh(("tp",), (tp,), ["cpu"] * tp)


def _jmesh(tp):
    return JMesh(np.array(jax.devices()[:tp]), ("tp",))


def _same(got, want):
    ids, scores = got
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want[1]),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_decode_matches_single_chip(trained, tp):
    """The port's tp greedy decoder gives the JAX single-chip decoder's
    ids and scores, and the JAX tp decoder's."""
    cfg, params, tparams = trained
    max_len = 24
    bos = np.array([5, 9, 17], np.int32)
    ref = jgpt.make_greedy_decoder(params, cfg, max_len)(jnp.asarray(bos))
    got = tgpt.make_tp_greedy_decoder(tparams, cfg, _tmesh(tp), max_len,
                                      device="cpu")(bos)
    _same(got, ref)
    if tp == 2:
        jtp = jgpt.make_tp_greedy_decoder(params, cfg, _jmesh(2),
                                          max_len)(jnp.asarray(bos))
        _same(got, jtp)


def test_tp_decode_reduces_twice_a_layer_a_step(trained):
    """The partitioned step communicates: one reduction after the o-proj
    and one after the ffn-down of every layer, every step (the reference
    reads all-reduces in its compiled text)."""
    cfg, _params, tparams = trained
    mesh = _tmesh(4)
    decode = tgpt.make_tp_greedy_decoder(tparams, cfg, mesh, 16,
                                         device="cpu")
    r0 = mesh.reductions
    decode(np.array([5], np.int32))
    assert mesh.reductions - r0 == 16 * 2 * cfg.num_layers


def test_tp_decode_cache_is_head_sharded(trained):
    """White-box: the tp step's cache is one (B, H/tp, L, D) tensor a
    rank and layer (rank-major), and the ranks' caches joined on the head
    axis are the single-device decoder's cache."""
    cfg, _params, tparams = trained
    tp, max_len, b = 4, 16, 2
    d = cfg.hidden_size // cfg.num_heads
    mesh = _tmesh(tp)
    trees = tgpt.shard_params(tparams, cfg, tp)
    step = tgpt.build_kv_step(trees, cfg, max_len,
                              h_count=cfg.num_heads // tp,
                              reduce_fn=mesh.reduce_fn("tp"))
    cache = tdec.init_kv_cache(b, tp * cfg.num_layers, cfg.num_heads // tp,
                               max_len, d, device="cpu")
    bos = torch.tensor([2, 3])
    with torch.inference_mode():
        ids, _ = tdec.greedy_decode(step, cache, bos, max_len)
        ref_cache = tdec.init_kv_cache(b, cfg.num_layers, cfg.num_heads,
                                       max_len, d, device="cpu")
        ref_ids, _ = tdec.greedy_decode(
            tgpt.build_kv_step(tparams, cfg, max_len), ref_cache, bos,
            max_len)
    assert torch.equal(ids, ref_ids) and ids.shape == (b, max_len)
    assert len(cache) == tp * cfg.num_layers
    for entry in cache:
        for x in entry.values():
            assert x.shape == (b, cfg.num_heads // tp, max_len, d)
    for i in range(cfg.num_layers):
        for name in ("k", "v"):
            joined = torch.cat([cache[r * cfg.num_layers + i][name]
                                for r in range(tp)], dim=1)
            np.testing.assert_allclose(joined.numpy(),
                                       ref_cache[i][name].numpy(),
                                       rtol=1e-5, atol=1e-6)


def test_tp_beam_decode_matches_single_chip(trained):
    """Beam search through the tp step: beam lanes ride the batch rows,
    the cache stays head-sharded; sequences and scores equal JAX's
    single-chip beam_decode."""
    cfg, params, tparams = trained
    max_len, k = 12, 3
    bos = np.array([5, 9], np.int32)
    step = jgpt.build_kv_step(params, cfg, max_len)
    d = cfg.hidden_size // cfg.num_heads
    cache = jdec.init_kv_cache(2 * k, cfg.num_layers, cfg.num_heads,
                               max_len, d)
    ref = jdec.beam_decode(step, cache, jnp.asarray(bos), max_len, k,
                           eos_id=-1)
    got = tgpt.make_tp_decoder(tparams, cfg, _tmesh(4), max_len,
                               beam_size=k, device="cpu")(bos)
    _same(got, ref)


def test_dp_tp_decode_matches_single_chip(trained):
    """The throughput layout: the batch over dp 2 and the heads over tp 2
    on one 4-rank mesh give the single-chip decoder's ids, greedy and
    beam."""
    cfg, params, tparams = trained
    max_len = 16
    bos = np.array([5, 9, 17, 23], np.int32)
    mesh = make_named_mesh(("dp", "tp"), (2, 2), ["cpu"] * 4)
    ref = jgpt.make_greedy_decoder(params, cfg, max_len)(jnp.asarray(bos))
    got = tgpt.make_tp_decoder(tparams, cfg, mesh, max_len, dp_axis="dp",
                               device="cpu")(bos)
    _same(got, ref)
    k = 2
    step = jgpt.build_kv_step(params, cfg, max_len)
    d = cfg.hidden_size // cfg.num_heads
    cache = jdec.init_kv_cache(4 * k, cfg.num_layers, cfg.num_heads,
                               max_len, d)
    ref_b = jdec.beam_decode(step, cache, jnp.asarray(bos), max_len, k,
                             eos_id=-1)
    got_b = tgpt.make_tp_decoder(tparams, cfg, mesh, max_len, beam_size=k,
                                 dp_axis="dp", device="cpu")(bos)
    _same(got_b, ref_b)


def test_tp_prompt_decoder_matches_single_chip(trained):
    """tp prompt decoding: the prefill runs the attention once a layer on
    each rank's H/tp heads, then the tp step continues; greedy and beam
    K 2 give JAX's make_prompt_decoder's ids and scores."""
    cfg, params, tparams = trained
    max_len, p_len = 20, 8
    rng = np.random.default_rng(3)
    prompt = rng.integers(3, cfg.vocab_size, (3, p_len)).astype(np.int32)
    calls = []

    def attention(q, k, v, **kw):
        from paddle_tpu_torch.ops.flash import flash_attention
        calls.append(tuple(q.shape))
        return flash_attention(q, k, v, **kw)

    mesh = _tmesh(4)
    ref = jgpt.make_prompt_decoder(params, cfg, p_len, max_len)(
        jnp.asarray(prompt))
    got = tgpt.make_tp_prompt_decoder(tparams, cfg, mesh, p_len, max_len,
                                      device="cpu",
                                      attention=attention)(prompt)
    _same(got, ref)
    assert calls == [(3, cfg.num_heads // 4, p_len,
                      cfg.hidden_size // cfg.num_heads)] \
        * (4 * cfg.num_layers)
    ref_b = jgpt.make_prompt_decoder(params, cfg, p_len, max_len,
                                     beam_size=2)(jnp.asarray(prompt))
    got_b = tgpt.make_tp_prompt_decoder(tparams, cfg, mesh, p_len, max_len,
                                        beam_size=2, device="cpu")(prompt)
    _same(got_b, ref_b)


def test_tp_validates_divisibility(trained):
    cfg, _params, tparams = trained
    with pytest.raises(ValueError, match="must divide"):
        tgpt.make_tp_greedy_decoder(tparams, cfg, _tmesh(3), 16,
                                    device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        tgpt.make_tp_prompt_decoder(tparams, cfg, _tmesh(3), 8, 16,
                                    device="cpu")
    # dp must divide the batch
    mesh = make_named_mesh(("dp", "tp"), (2, 2), ["cpu"] * 4)
    dec = tgpt.make_tp_decoder(tparams, cfg, mesh, 16, dp_axis="dp",
                               device="cpu")
    with pytest.raises(ValueError, match="divisible by"):
        dec(np.array([1, 2, 3], np.int32))


def test_tp_sampling_composes(trained):
    """Sampled decoding over the tp step: temperature 0 is the tp greedy
    decoder; a warm draw is reproducible under one generator seed, and
    draws the single-device sampler's ids from the same seed."""
    cfg, _params, tparams = trained
    max_len, tp = 14, 4
    d = cfg.hidden_size // cfg.num_heads
    mesh = _tmesh(tp)
    bos = torch.tensor([5, 9])
    step = tgpt.build_kv_step(tgpt.shard_params(tparams, cfg, tp), cfg,
                              max_len, h_count=cfg.num_heads // tp,
                              reduce_fn=mesh.reduce_fn("tp"))

    def run(seed, temperature, step=step, heads=cfg.num_heads // tp,
            shards=tp):
        cache = tdec.init_kv_cache(2, shards * cfg.num_layers, heads,
                                   max_len, d, device="cpu")
        gen = torch.Generator().manual_seed(seed)
        with torch.inference_mode():
            return tdec.sample_decode(step, cache, bos, max_len, gen,
                                      temperature=temperature, top_k=10)

    cold, _ = run(0, 0.0)
    greedy, _ = tgpt.make_tp_greedy_decoder(tparams, cfg, mesh, max_len,
                                            device="cpu")(bos)
    assert torch.equal(cold, greedy)
    warm1, s1 = run(7, 0.8)
    warm2, s2 = run(7, 0.8)
    assert torch.equal(warm1, warm2) and torch.equal(s1, s2)
    single, ss = run(7, 0.8, step=tgpt.build_kv_step(tparams, cfg, max_len),
                     heads=cfg.num_heads, shards=1)
    assert torch.equal(warm1, single)
    np.testing.assert_allclose(s1.numpy(), ss.numpy(), rtol=TOL, atol=TOL)


def test_shard_params_layout_matches_jax_shardings(trained):
    """gpt_tp_shardings marks every leaf as the JAX package's
    NamedSharding tree shards it (col: P(None, tp), row: P(tp), rep:
    P()); shard_params cuts contiguous copies (the JAX numpy tree or the
    port's tensors alike) that join back into the tree, and shares each
    replicated leaf among the ranks. Under GQA rank r holds KV heads
    [r H_kv/tp, (r+1) H_kv/tp)."""
    cfg, params, tparams = trained
    jspec = jax.tree_util.tree_map(lambda ns: tuple(ns.spec),
                                   jgpt.gpt_tp_shardings(cfg, _jmesh(2)))
    word = {(): "rep", (None, "tp"): "col", ("tp",): "row"}
    marks = tgpt.gpt_tp_shardings(cfg)
    for k, v in jspec.items():
        if isinstance(v, dict):
            assert {kk: word[vv] for kk, vv in v.items()} == marks[k], k
        else:
            assert word[v] == marks[k], k
    tree = {k: ({kk: np.asarray(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else np.asarray(v))
            for k, v in params.items()}
    for src, to_np in ((tparams, lambda x: x.numpy()), (tree, np.asarray)):
        ranks = tgpt.shard_params(src, cfg, 4)
        for name, mark in marks["l1"].items():
            pieces = [r["l1"][name] for r in ranks]
            whole = to_np(src["l1"][name])
            if mark == "rep":
                assert all(p is src["l1"][name] for p in pieces)
                continue
            axis = 1 if mark == "col" else 0
            np.testing.assert_array_equal(
                np.concatenate([to_np(p) for p in pieces], axis), whole)
            for p in pieces:
                assert (p.is_contiguous() if torch.is_tensor(p)
                        else p.flags["C_CONTIGUOUS"])
        assert ranks[0]["word_emb"] is src["word_emb"]
    gcfg = tgpt.GPTConfig(**{k: getattr(cfg, k) for k in (
        "vocab_size", "hidden_size", "num_layers", "num_heads",
        "inner_size", "max_position", "dropout")}, kv_heads=2)
    gq = tgpt.gqa_slice_kv_params(tparams, cfg, 2)
    d = cfg.hidden_size // cfg.num_heads
    for r, rank in enumerate(tgpt.shard_params(gq, gcfg, 2)):
        assert torch.equal(rank["l0"]["wk"],
                           gq["l0"]["wk"][:, r * d:(r + 1) * d])
        assert rank["l0"]["wq"].shape[1] == 2 * d
    with pytest.raises(ValueError, match="divide kv_heads"):
        tgpt.shard_params(gq, gcfg, 4)
