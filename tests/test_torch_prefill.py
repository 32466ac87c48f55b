"""The port's prompt-conditioned GPT decoding against the JAX package, on
the CPU, and the f32-model / bf16-pool serving repair.

A tiny GPT is trained briefly with the JAX package (the recipe of
``tests/models/test_gpt_prefill.py``: memorized sequences, so greedy
argmaxes are decisive); its numpy params go through both packages:

- ``build_prefill``: the cache to 2e-5 and the logits to 2e-4 of JAX's,
  the tolerances of ``test_gpt_prefill.py`` (the prefill's flash
  attention is the port's plain version on the CPU);
- ``generate_with_prompt`` greedy: ids identical, scores to 2e-5; beam
  K = 1 equal to greedy and K = 3 identical to JAX's, scores to 2e-5;
  ``make_greedy_decoder`` ids identical;
- ``_filter_logits`` identical to JAX's; ``make_sampler`` at temperature
  0 equal to the greedy prompt decoder. Sampled ids cannot match JAX's
  threefry bits, so they are held to JAX's own filter and scores instead:
  each chosen id lies in the filtered support of JAX's teacher-forced
  logits, the port's scores equal the filtered log-probs of the chosen
  ids, and one generator seed gives one sequence.

The repair: an f32 model serves ``kv_dtype="bf16"`` (bf16 pools; f32 q
scored against bf16 keys, the output in the pools' dtype): the plain
paged attention matches JAX's reference and Pallas kernels on that pair,
the kernel's checks take it, and the port server's ids equal the JAX
server's. ``jax_engine`` replaces only the JAX dispatcher's vmap probe,
which this container's jax cannot run (as in ``test_torch_serving.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu.core import framework
from paddle_tpu.core.executor import Scope, scope_guard
from paddle_tpu.inference import decoding as jdec
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.ops.pallas import paged as jpaged
from paddle_tpu.serving import GenerationServer as JServer
from paddle_tpu.serving import GPTServingModel as JModel
from paddle_tpu.serving import kv_cache as jkvc
from paddle_tpu_torch.inference import decoding as tdec
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops.cuda import paged as tpaged
from paddle_tpu_torch.serving import GenerationServer, GPTServingModel

CACHE_ATOL = 2e-5       # test_gpt_prefill.py's pins
LOGITS_ATOL = 2e-4
SCORE_ATOL = 2e-5
P = 8                   # prompt length of the decoding twins
MAX_LEN = 18


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


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture
def jax_engine(monkeypatch):
    monkeypatch.setattr(jkvc, "_transform_trace_kind", lambda *ops: None)


@pytest.fixture(scope="module")
def trained():
    """test_gpt_prefill's tiny GPT, memorizing four 24-token sequences.
    Returns (cfg, JAX params, the port's params on the CPU, numpy tree,
    sequences)."""
    cfg = jgpt.gpt_tiny()
    main, startup = framework.Program(), framework.Program()
    main.random_seed = startup.random_seed = 5
    with framework.program_guard(main, startup):
        _tokens, loss, _ = jgpt.build_lm_net(cfg, seq_len=24)
        fluid.optimizer.AdamOptimizer(learning_rate=2e-2).minimize(loss)
    scope = Scope()
    exe = fluid.Executor(fluid.TPUPlace(0))
    seq = np.random.default_rng(0).integers(
        3, cfg.vocab_size, (4, 24)).astype(np.int32)
    with scope_guard(scope):
        exe.run(startup)
        for _ in range(40):
            exe.run(main, feed={"tokens": seq}, fetch_list=[loss])
        params = jgpt.load_params(scope, cfg)
    tree = {k: ({kk: np.asarray(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else np.asarray(v))
            for k, v in params.items()}
    return cfg, params, tgpt.params_from_numpy(tree, "cpu"), tree, seq


def test_prefill_cache_and_logits_match_jax(trained):
    cfg, jp, tp, _tree, seq = trained
    prompt = seq[:, :9]                         # off every tile grid
    max_len = 16
    jcache, jlogits = jgpt.build_prefill(jp, cfg, max_len)(
        jnp.asarray(prompt))
    with torch.inference_mode():
        tcache, tlogits = tgpt.build_prefill(tp, cfg, max_len)(
            torch.from_numpy(prompt))
    for i in range(cfg.num_layers):
        for kv in ("k", "v"):
            assert tcache[i][kv].shape == (4, cfg.num_heads, max_len, 32)
            np.testing.assert_allclose(tcache[i][kv].numpy(),
                                       np.asarray(jcache[i][kv]), rtol=0,
                                       atol=CACHE_ATOL)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0,
                               atol=LOGITS_ATOL)


def _greedy_pair(trained):
    cfg, jp, tp, _tree, seq = trained
    prompt = seq[:, :P]
    jids, jscores = jgpt.generate_with_prompt(jp, cfg, prompt, MAX_LEN)
    tids, tscores = tgpt.generate_with_prompt(tp, cfg, prompt, MAX_LEN,
                                              device="cpu")
    return np.asarray(jids), np.asarray(jscores), tids, tscores


def test_generate_with_prompt_greedy_matches_jax(trained):
    jids, jscores, tids, tscores = _greedy_pair(trained)
    assert tids.shape == (4, MAX_LEN - P)
    np.testing.assert_array_equal(tids.numpy(), jids)
    np.testing.assert_allclose(tscores.numpy(), jscores, rtol=0,
                               atol=SCORE_ATOL)
    # the memorized tail comes back
    assert (tids.numpy() == trained[4][:, P:MAX_LEN]).mean() >= 0.9


@pytest.mark.parametrize("beam", [1, 3])
def test_prompt_beam_matches_jax(trained, beam):
    cfg, jp, tp, _tree, seq = trained
    prompt = seq[:, :P]
    tids, tscores = tgpt.generate_with_prompt(tp, cfg, prompt, MAX_LEN,
                                              beam_size=beam, device="cpu")
    assert tids.shape == (4, beam, MAX_LEN - P)
    if beam == 1:
        greedy = tgpt.generate_with_prompt(tp, cfg, prompt, MAX_LEN,
                                           device="cpu")[0]
        np.testing.assert_array_equal(tids[:, 0].numpy(), greedy.numpy())
        return
    jids, jscores = jgpt.generate_with_prompt(jp, cfg, prompt, MAX_LEN,
                                              beam_size=beam)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tscores.numpy(), np.asarray(jscores), rtol=0,
                               atol=SCORE_ATOL)


def test_make_greedy_decoder_matches_jax(trained):
    cfg, jp, tp, _tree, seq = trained
    bos = seq[:, 0]
    jids, jscores = jgpt.make_greedy_decoder(jp, cfg, 12)(jnp.asarray(bos))
    tids, tscores = tgpt.make_greedy_decoder(tp, cfg, 12, device="cpu")(bos)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tscores.numpy(), np.asarray(jscores), rtol=0,
                               atol=SCORE_ATOL)


@pytest.mark.parametrize("top_k,top_p", [(5, None), (None, 0.9), (40, 0.5)])
def test_filter_logits_matches_jax(top_k, top_p):
    logits = np.random.default_rng(3).standard_normal((6, 256)).astype(
        np.float32) * 3
    logits[0, :4] = logits[0, 4]                # ties at the threshold
    want = np.asarray(jdec._filter_logits(jnp.asarray(logits), top_k=top_k,
                                          top_p=top_p))
    got = tdec._filter_logits(torch.from_numpy(logits), top_k=top_k,
                              top_p=top_p)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampler_temperature_zero_is_greedy(trained):
    cfg, _jp, tp, _tree, seq = trained
    prompt = seq[:, :P]
    sample = tgpt.make_sampler(tp, cfg, MAX_LEN, temperature=0.0,
                               prompt_len=P, device="cpu")
    ids, scores = sample(prompt, torch.Generator().manual_seed(0))
    gids, gscores = tgpt.make_prompt_decoder(tp, cfg, P, MAX_LEN,
                                             device="cpu")(prompt)
    assert torch.equal(ids, gids) and torch.equal(scores, gscores)
    # and without a prompt, from a BOS token
    ids, scores = tgpt.make_sampler(tp, cfg, 12, temperature=0.0,
                                    device="cpu")(seq[:, 0], None)
    gids, gscores = tgpt.make_greedy_decoder(tp, cfg, 12,
                                             device="cpu")(seq[:, 0])
    assert torch.equal(ids, gids) and torch.equal(scores, gscores)


def _jax_teacher_forced_logits(jp, cfg, prompt, gen_ids):
    """JAX's last-position logits before each generated id: the prefill's,
    then build_kv_step's fed the chosen ids."""
    p = prompt.shape[1]
    max_len = p + gen_ids.shape[1]
    cache, logits = jgpt.build_prefill(jp, cfg, max_len)(jnp.asarray(prompt))
    step = jgpt.build_kv_step(jp, cfg, max_len)
    out = [np.asarray(logits[:, -1], np.float32)]
    for j in range(gen_ids.shape[1] - 1):
        logits, cache = step(jnp.asarray(gen_ids[:, j]), cache, p + j)
        out.append(np.asarray(logits, np.float32))
    return out


def test_sampled_ids_in_support_and_scored_like_jax(trained):
    cfg, jp, tp, _tree, seq = trained
    prompt = seq[:, :P]
    temp, top_k, top_p = 0.8, 5, 0.9
    sample = tgpt.make_sampler(tp, cfg, MAX_LEN, temperature=temp,
                               top_k=top_k, top_p=top_p, prompt_len=P,
                               device="cpu")
    ids, scores = sample(prompt, torch.Generator().manual_seed(11))
    again, _ = sample(prompt, torch.Generator().manual_seed(11))
    assert torch.equal(ids, again)
    ids = ids.numpy()
    want = np.zeros(ids.shape[0], np.float32)
    for j, logits in enumerate(_jax_teacher_forced_logits(jp, cfg, prompt,
                                                          ids)):
        filt = jdec._filter_logits(jnp.asarray(logits / temp), top_k=top_k,
                                   top_p=top_p)
        chosen = np.take_along_axis(np.asarray(filt), ids[:, j:j + 1], 1)
        assert (chosen > jdec.NEG_INF / 2).all(), j       # in the support
        want += np.take_along_axis(np.asarray(jax.nn.log_softmax(filt)),
                                   ids[:, j:j + 1], 1)[:, 0]
    np.testing.assert_allclose(scores.numpy(), want, rtol=0, atol=SCORE_ATOL)


# ---------------------------------------------------------------------------
# the repair: f32 model, bf16 pools
# ---------------------------------------------------------------------------

def test_paged_f32_q_over_bf16_pools_matches_jax():
    """The plain paged attention on (f32 q, bf16 pools) against JAX's
    reference and Pallas v1/v2 (interpret): f32 scores, bf16
    probabilities before PV, a bf16 output."""
    rng = np.random.default_rng(5)
    b, h, c, d, bs, m = 3, 4, 4, 32, 8, 6
    n = 1 + b * m
    q = rng.standard_normal((b, h, c, d)).astype(np.float32)
    kp = rng.standard_normal((n, h, bs, d)).astype(np.float32)
    vp = rng.standard_normal((n, h, bs, d)).astype(np.float32)
    table = np.zeros((b, m), np.int32)
    pos = np.zeros((b, c), np.int32)
    free = list(rng.permutation(np.arange(1, n)))
    for i in range(b):
        length = int(rng.integers(1, m * bs - c))
        for j in range(-(-(length + c) // bs)):
            table[i, j] = free.pop()
        pos[i] = np.arange(length, length + c)
    jargs = (jnp.asarray(q), jnp.asarray(kp, jnp.bfloat16),
             jnp.asarray(vp, jnp.bfloat16), jnp.asarray(table),
             jnp.asarray(pos))
    kb = torch.from_numpy(kp).to(torch.bfloat16)
    vb = torch.from_numpy(vp).to(torch.bfloat16)
    targs = (torch.from_numpy(q), kb, vb, torch.from_numpy(table),
             torch.from_numpy(pos))
    got = tpaged.paged_attention_reference(*targs)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jkvc.paged_attention_reference(*jargs), np.float32)
    np.testing.assert_array_equal(got.float().numpy(), want)
    for kernel in (jpaged.ragged_paged_attention,
                   jpaged.ragged_paged_attention_v2):
        k_out = np.asarray(kernel(*jargs, interpret=True), np.float32)
        np.testing.assert_allclose(got.float().numpy(), k_out, rtol=0,
                                   atol=tpaged.TOLERANCE[torch.bfloat16])
    # the kernel's checks take the pair: off the card only the device fails
    with pytest.raises(ValueError, match="CUDA tensor"):
        tpaged.paged_attention_cuda(*targs)


SERVER_KW = dict(num_slots=3, block_size=8, max_context=64, chunk=4,
                 start=False)


def _stream(srv):
    futs = [srv.submit(np.array([5, 9, 11], np.int32), max_new_tokens=4),
            srv.submit(np.array([7] * 11, np.int32), max_new_tokens=6)]
    srv.step()
    futs.append(srv.submit(np.array([3, 4], np.int32), max_new_tokens=5))
    srv.run_until_idle()
    return [list(f.result(timeout=5).token_ids) for f in futs]


def test_kv_dtype_bf16_under_f32_model(trained, jax_engine):
    """test_kv_dtype_bf16_alias's twin: an f32 model with bf16 pools
    serves 4 tokens, its attention gets f32 q over bf16 pools and returns
    bf16, the kernel's checks take those operands, and the ids equal the
    JAX server's on the same pools."""
    cfg, jp, tp, _tree, _seq = trained
    seen = []

    def attention(q, k_pool, v_pool, *args, **kw):
        out = tpaged.paged_attention_reference(q, k_pool, v_pool, *args,
                                               **kw)
        seen.append((q, k_pool, v_pool, *args, out.dtype))
        return out

    model = GPTServingModel(tp, cfg, device="cpu", attention=attention)
    srv = GenerationServer(model, device="cpu", kv_dtype="bf16", **SERVER_KW)
    assert srv.cache.dtype == torch.bfloat16 and not srv.cache.quantized
    assert srv.cache.pools[0]["k"].dtype == torch.bfloat16
    fut = srv.submit([5, 9, 11], max_new_tokens=4)
    srv.run_until_idle()
    assert len(fut.result(timeout=5).token_ids) == 4
    q, kp, vp, table, pos, out_dtype = seen[-1]
    assert (q.dtype, kp.dtype, out_dtype) == (torch.float32, torch.bfloat16,
                                              torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tpaged._check(q, kp, vp, table, pos, None, None)
    port = GenerationServer(GPTServingModel(tp, cfg, device="cpu"),
                            device="cpu", kv_dtype="bf16", **SERVER_KW)
    js = JServer(JModel(jp, cfg), telemetry=False, kv_dtype="bf16",
                 **SERVER_KW)
    assert _stream(port) == _stream(js)
