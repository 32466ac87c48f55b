"""The port's int8 KV pools, int8 weights and grouped-query serving
against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX functions and
their paddle_tpu_torch counterparts:

- ``quantize_kv_rows`` and ``write_block_kv_quant``: codes and scales
  bitwise equal to JAX's (eager), apart from the NULL block;
- ``GPTServingModel.quantize_int8``: weight codes and scales bitwise;
- the int8 ``paged_attention_reference`` against JAX's reference and the
  Pallas kernels v1/v2 in interpret mode, q f32 and bf16, MHA and GQA,
  C 1 and 4, an idle lane, NaN-poisoned NULL scales (the kernels never
  read them; the plain versions read a clean copy); tolerance 1e-5 (f32)
  and 2e-2 (bf16), ``TOLERANCE`` of ``ops/cuda/paged.py``;
- ``gqa_slice_kv_params`` / ``gqa_repeat_kv_params`` exactly JAX's;
- ``PagedKVCache`` byte math as ``tests/api/test_quant_serving.py`` and
  ``tests/api/test_gqa_serving.py`` pin it;
- on the briefly-trained tiny GPT of ``test_quant_serving.py``, the
  staggered stream with a cancel gives identical greedy ids from the JAX
  and the port ``GenerationServer(kv_dtype="int8")``, with and without
  int8 weights, and a GQA (kv_heads 2) port server gives the JAX GQA
  server's ids and the port's repeat-KV MHA server's.

Under jit XLA rewrites ``absmax / 127.0`` into a product with the
reciprocal, so the jitted JAX server's scales differ from eager
``quantize_kv_rows`` (and from the port) by one ulp in a few rows; the
servers are compared on ids and on logps within ``LOGP_ATOL``. The JAX
server's ``get_stats()`` is not an oracle here (its ledger path fails on
this container's jax): ``kv_quant`` is held against the JAX cache's own
byte methods. ``jax_engine`` replaces only the JAX dispatcher's vmap
probe, as in ``tests/test_torch_serving.py``.
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
from paddle_tpu.ops.pallas import paged as jpaged
from paddle_tpu.serving import GenerationServer as JServer
from paddle_tpu.serving import GPTServingModel as JModel
from paddle_tpu.serving import kv_cache as jkvc
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops.cuda import paged as tpaged
from paddle_tpu_torch.serving import (GenerationServer, GPTServingModel,
                                      PagedKVCache)
from paddle_tpu_torch.serving import kv_cache as tkvc

TOL = {"f32": tpaged.TOLERANCE[torch.float32],
       "bf16": tpaged.TOLERANCE[torch.bfloat16]}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
# per-token logps of the port vs the JAX server on int8 pools: both
# quantize the same K/V, the jitted JAX scales may differ by an ulp, and
# the two frameworks sum in other orders (measured: 1.5e-6)
LOGP_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture
def jax_engine(monkeypatch):
    monkeypatch.setattr(jkvc, "_transform_trace_kind", lambda *ops: None)


@pytest.fixture(scope="module")
def trained():
    """test_quant_serving's briefly-trained tiny GPT (30 Adam steps on
    four sequences): greedy argmaxes are decisive, so int8 rounding and
    the two frameworks' float differences do not flip them. Returns
    (cfg, JAX params, numpy tree)."""
    cfg = jgpt.gpt_tiny()
    main, startup = framework.Program(), framework.Program()
    main.random_seed = startup.random_seed = 5
    with framework.program_guard(main, startup):
        _tokens, loss, _ = jgpt.build_lm_net(cfg, seq_len=16)
        fluid.optimizer.AdamOptimizer(learning_rate=1e-2).minimize(loss)
    scope = Scope()
    exe = fluid.Executor(fluid.TPUPlace(0))
    seq = np.random.default_rng(0).integers(
        3, cfg.vocab_size, (4, 16)).astype(np.int32)
    with scope_guard(scope):
        exe.run(startup)
        for _ in range(30):
            exe.run(main, feed={"tokens": seq}, fetch_list=[loss])
        params = jgpt.load_params(scope, cfg)
    tree = {k: ({kk: np.asarray(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else np.asarray(v))
            for k, v in params.items()}
    return cfg, params, tree


def _gqa_cfg(cfg, kv_heads):
    return jgpt.GPTConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        num_layers=cfg.num_layers, num_heads=cfg.num_heads,
        inner_size=cfg.inner_size, max_position=cfg.max_position,
        dropout=0.0, kv_heads=kv_heads)


SERVER_KW = dict(num_slots=3, block_size=8, max_context=64, chunk=4,
                 start=False)


def _jax_server(params, cfg, int8_weights=False, **kw):
    model = JModel(params, cfg)
    if int8_weights:
        model.quantize_int8()
    return JServer(model, telemetry=False, **SERVER_KW, **kw)


def _port_server(tree, cfg, int8_weights=False, **kw):
    model = GPTServingModel(tgpt.params_from_numpy(tree, "cpu"), cfg,
                            device="cpu")
    if int8_weights:
        model.quantize_int8()
    return GenerationServer(model, device="cpu", **SERVER_KW, **kw)


def _record_logps(srv):
    log = {}
    emit = srv._sched._emit_token

    def wrapped(req, tok, lp, now):
        log.setdefault(req.rid, []).append(lp)
        return emit(req, tok, lp, now)

    srv._sched._emit_token = wrapped
    return log


def _staggered_stream(srv):
    """test_quant_serving's acceptance stream: staggered arrivals, mixed
    lengths, one mid-stream cancel. Returns the three survivors'
    results."""
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
    return [f.result(timeout=5) for f in (f1, f2, f3)]


def _ids(results):
    return [list(r.token_ids) for r in results]


# ---------------------------------------------------------------------------
# quantization: KV rows and weights, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_quantize_kv_rows_bitwise(dt):
    rng = np.random.default_rng(1)
    vals = rng.standard_normal((5, 4, 3, 16)).astype(np.float32) * 3
    vals[1, 2, 0] = 0.0                       # an all-zero row: scale 1.0
    # absmax 127 gives scale 1.0, so these are ties at half steps: round
    # half to even in both frameworks
    vals[0, 0, 0] = [0.5, -0.5, 1.5, 2.5, -3.5, 126.5, 127.0] + [0.0] * 9
    jv = jnp.asarray(vals, JDT[dt])
    jq, js = jkvc.quantize_kv_rows(jv)
    tq, ts = tkvc.quantize_kv_rows(torch.from_numpy(vals).to(TDT[dt]))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[1, 2, 0] == 1.0 and not tq[1, 2, 0].any()
    assert int(tq.abs().max()) == tkvc.KV_QMAX == jkvc.KV_QMAX


def test_write_block_kv_quant_bitwise():
    rng = np.random.default_rng(2)
    n, h, bs, d, s, c = 9, 2, 4, 16, 3, 4
    codes = rng.integers(-127, 128, (n, h, bs, d)).astype(np.int8)
    scales = rng.random((n, h, bs)).astype(np.float32)
    vals = rng.standard_normal((s, c, h, d)).astype(np.float32)
    targets = rng.permutation((n - 1) * bs)[:s * c] + bs
    bidx = (targets // bs).reshape(s, c).astype(np.int32)
    off = (targets % bs).reshape(s, c).astype(np.int32)
    bidx[0, 3] = bidx[2, 1] = jkvc.NULL_BLOCK     # masked tokens
    off[0, 3] = off[2, 1] = 0
    jp, js = jkvc.write_block_kv_quant(
        jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(vals),
        jnp.asarray(bidx), jnp.asarray(off))
    tp, ts = torch.from_numpy(codes.copy()), torch.from_numpy(scales.copy())
    op, os_ = tkvc.write_block_kv_quant(
        tp, ts, torch.from_numpy(vals), torch.from_numpy(bidx),
        torch.from_numpy(off))
    assert op.data_ptr() == tp.data_ptr() and os_.data_ptr() == ts.data_ptr()
    np.testing.assert_array_equal(tp[1:].numpy(), np.asarray(jp)[1:])
    np.testing.assert_array_equal(ts[1:].numpy(), np.asarray(js)[1:])


def test_quantize_int8_weights_bitwise():
    cfg = jgpt.gpt_tiny()
    tree = tgpt.init_params(cfg, seed=3)
    tree["l1"]["wk"][:, 5] = 0.0                  # an all-zero channel
    jm = JModel(jax.tree_util.tree_map(jnp.asarray, tree), cfg)
    jm.quantize_int8()
    tm = GPTServingModel(tgpt.params_from_numpy(tree, "cpu"), cfg,
                         device="cpu")
    caller = tm.params
    assert tm.quantize_int8() is tm
    assert tm.quantize_int8().int8_weights == jm.int8_weights == \
        6 * cfg.num_layers                        # idempotent
    assert "wq" in caller["l0"] and "wq@q8" not in caller["l0"]
    for i in range(cfg.num_layers):
        jl, tl = jm.params[f"l{i}"], tm.params[f"l{i}"]
        assert set(tl) == set(jl)
        for name in GPTServingModel.INT8_WEIGHT_NAMES:
            assert tl[name + "@q8"].dtype == torch.int8
            assert tuple(tl[name + "@scale"].shape) == \
                (1, tree[f"l{i}"][name].shape[1])
            np.testing.assert_array_equal(tl[name + "@q8"].numpy(),
                                          np.asarray(jl[name + "@q8"]))
            np.testing.assert_array_equal(tl[name + "@scale"].numpy(),
                                          np.asarray(jl[name + "@scale"]))
    assert tm.params["l1"]["wk@scale"][0, 5] == 1.0


# ---------------------------------------------------------------------------
# int8 paged attention: the plain version against JAX's reference and the
# Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

def make_int8_case(b=3, h=4, hp=4, c=4, d=16, bs=8, m=6, seed=0,
                   poison=False):
    """numpy operands: int8 pools and f32 scales quantized from normal
    values, shuffled live blocks per lane, lane 0 idle, and the NULL
    block's codes 127 and scales NaN on request (clean: codes 0, scales
    1.0, as a fresh cache holds them)."""
    rng = np.random.default_rng(seed)
    n = 1 + b * m
    kq, ks = tkvc.quantize_kv_rows(torch.from_numpy(
        rng.standard_normal((n, hp, bs, d)).astype(np.float32)))
    vq, vs = tkvc.quantize_kv_rows(torch.from_numpy(
        rng.standard_normal((n, hp, bs, d)).astype(np.float32)))
    kq, ks, vq, vs = (x.numpy().copy() for x in (kq, ks, vq, vs))
    kq[0] = vq[0] = 127 if poison else 0
    ks[0] = vs[0] = np.nan if poison else 1.0
    q = rng.standard_normal((b, h, c, d)).astype(np.float32)
    tables = np.zeros((b, m), np.int32)
    q_pos = np.zeros((b, c), np.int32)
    free = list(range(1, n))
    rng.shuffle(free)
    for i in range(1, b):
        length = int(rng.integers(1, m * bs - c))
        for j in range(-(-(length + c) // bs)):
            tables[i, j] = free.pop()
        q_pos[i] = np.arange(length, length + c)
    return q, kq, vq, tables, q_pos, ks, vs


def _jax_int8(case, dt):
    q, kq, vq, t, p, ks, vs = case
    return ((jnp.asarray(q, JDT[dt]), jnp.asarray(kq), jnp.asarray(vq),
             jnp.asarray(t), jnp.asarray(p)),
            dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))


def _torch_int8(case, dt):
    q, kq, vq, t, p, ks, vs = case
    return ((torch.from_numpy(q).to(TDT[dt]), torch.from_numpy(kq),
             torch.from_numpy(vq), torch.from_numpy(t), torch.from_numpy(p)),
            dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs)))


def _max_err(port, ref):
    return float(np.max(np.abs(port.float().numpy()
                               - np.asarray(jnp.asarray(ref, jnp.float32)))))


# (dtype, pool heads, columns, head dim): head dim 16 at every other axis,
# and head dim 128 (GPTConfig(hidden_size=1024, num_heads=8)'s) for MHA
# prefill and GQA decode
INT8_CASES = ([(dt, hp, c, 16) for dt in ("f32", "bf16") for hp in (4, 2)
               for c in (1, 4)]
              + [(dt, hp, c, 128) for dt in ("f32", "bf16")
                 for hp, c in ((4, 4), (2, 1))])


def _int8_case_id(case):
    dt, hp, c, d = case
    return f"{dt}-{hp}-{c}" + ("" if d == 16 else f"-d{d}")


@pytest.mark.parametrize("dt,hp,c,d", INT8_CASES,
                         ids=map(_int8_case_id, INT8_CASES))
def test_int8_plain_matches_jax_reference_and_kernels(dt, hp, c, d):
    clean = make_int8_case(hp=hp, c=c, d=d, seed=7)
    poisoned = make_int8_case(hp=hp, c=c, d=d, seed=7, poison=True)
    args, scales = _torch_int8(clean, dt)
    out = tkvc.paged_attention(*args, **scales)
    assert out.dtype == TDT[dt] and out.shape == clean[0].shape
    assert float(out[0].abs().max()) == 0.0           # the idle lane
    jargs, jscales = _jax_int8(clean, dt)
    ref = jkvc.paged_attention_reference(*jargs, **jscales)
    assert _max_err(out, ref) <= TOL[dt]
    pargs, pscales = _jax_int8(poisoned, dt)
    for fn in (jpaged.ragged_paged_attention,
               jpaged.ragged_paged_attention_v2):
        kern = fn(*pargs, **pscales, interpret=True)
        assert np.isfinite(np.asarray(jnp.asarray(kern, jnp.float32))).all()
        assert _max_err(out, kern) <= TOL[dt], fn.__name__


@pytest.mark.parametrize("hp", [4, 2])
@pytest.mark.parametrize("d", [16, 128])
def test_int8_scale_factoring_matches_reference(hp, d):
    """The kernel's int8 arithmetic: codes stay codes in both products,
    the key scale multiplies the scores (s = k_scale * (q . code)) and the
    value scale rides on the probabilities (sum_t p_t v_scale_t code_t),
    in f32; within 1e-5 of the plain version, which dequantizes first.
    The NULL block (codes 127, NaN scales) is never read."""
    clean = make_int8_case(hp=hp, c=4, d=d, seed=12)
    poisoned = make_int8_case(hp=hp, c=4, d=d, seed=12, poison=True)
    q, kq, vq, t, p, ks, vs = (torch.from_numpy(x) for x in poisoned)
    b, h, c, _ = q.shape
    bs, m = kq.shape[2], t.shape[1]
    g = h // hp
    out = torch.zeros(b, h, c, d)
    for lane in range(b):
        live = [int(x) for x in t[lane] if int(x) != tkvc.NULL_BLOCK]
        if not live:
            continue            # the idle lane: exactly 0
        n = len(live)
        codes_k = kq[live].float().repeat_interleave(g, 1)  # (n, h, bs, d)
        codes_v = vq[live].float().repeat_interleave(g, 1)
        sk = ks[live].repeat_interleave(g, 1)               # (n, h, bs)
        sv = vs[live].repeat_interleave(g, 1)
        s = torch.einsum("hcd,nhtd->hcnt", q[lane], codes_k)
        s = s * sk.permute(1, 0, 2)[:, None] / d ** 0.5
        key_pos = (torch.arange(m)[t[lane] != tkvc.NULL_BLOCK][:, None] * bs
                   + torch.arange(bs)).reshape(n * bs)
        s = s.reshape(h, c, n * bs)
        mask = key_pos[None, None, :] <= p[lane][None, :, None]
        s = torch.where(mask, s, torch.tensor(tkvc.NEG_INF))
        pr = torch.softmax(s, -1).reshape(h, c, n, bs)
        pr = pr * sv.permute(1, 0, 2)[:, None]
        out[lane] = torch.einsum("hcnt,nhtd->hcd", pr, codes_v)
    cq, ckq, cvq, ct, cp, cks, cvs = (torch.from_numpy(x) for x in clean)
    ref = tkvc.paged_attention_reference(cq, ckq, cvq, ct, cp,
                                         k_scale=cks, v_scale=cvs)
    assert torch.isfinite(out).all()
    assert float(out[0].abs().max()) == 0.0
    assert float((out - ref).abs().max()) <= TOL["f32"]


def test_gather_block_scales_matches_jax():
    *_, t, _p, ks, _vs = make_int8_case(hp=2, seed=8)
    np.testing.assert_array_equal(
        tkvc.gather_block_scales(torch.from_numpy(ks), torch.from_numpy(t)),
        np.asarray(jkvc.gather_block_scales(jnp.asarray(ks),
                                            jnp.asarray(t))))


def test_scale_guards_raise_like_jax():
    q, kq, vq, t, p, ks, vs = make_int8_case(seed=9)
    dense = np.zeros(kq.shape, np.float32)
    for ref, conv in ((jkvc.paged_attention_reference, jnp.asarray),
                      (tkvc.paged_attention, torch.from_numpy)):
        with pytest.raises(ValueError,
                           match="scale pools passed with non-int8 pools"):
            ref(conv(q), conv(dense), conv(dense), conv(t), conv(p),
                k_scale=conv(ks), v_scale=conv(vs))
        with pytest.raises(ValueError, match="int8 pools need k_scale"):
            ref(conv(q), conv(kq), conv(vq), conv(t), conv(p))


# ---------------------------------------------------------------------------
# GQA param helpers and pool bytes
# ---------------------------------------------------------------------------

def test_gqa_param_helpers_match_jax_exactly():
    cfg = jgpt.gpt_tiny()
    tree = tgpt.init_params(cfg, seed=4)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    tensors = tgpt.params_from_numpy(tree, "cpu")
    d = cfg.hidden_size // cfg.num_heads
    for params in (tree, tensors):
        sliced = tgpt.gqa_slice_kv_params(params, cfg, 2)
        rep = tgpt.gqa_repeat_kv_params(sliced, cfg, 2)
        jsliced = jgpt.gqa_slice_kv_params(jtree, cfg, 2)
        jrep = jgpt.gqa_repeat_kv_params(jsliced, cfg, 2)
        assert sliced["l0"]["wq"] is params["l0"]["wq"]  # shared, not copied
        assert "wk" in params["l0"] and params["l0"]["wk"].shape[1] == \
            cfg.hidden_size                              # caller untouched
        for i in range(cfg.num_layers):
            for name in ("wk", "wv", "bk", "bv"):
                np.testing.assert_array_equal(
                    np.asarray(sliced[f"l{i}"][name]),
                    np.asarray(jsliced[f"l{i}"][name]))
                np.testing.assert_array_equal(
                    np.asarray(rep[f"l{i}"][name]),
                    np.asarray(jrep[f"l{i}"][name]))
        assert sliced["l0"]["wk"].shape == (cfg.hidden_size, 2 * d)
        again = tgpt.gqa_slice_kv_params(rep, cfg, 2)
        np.testing.assert_array_equal(np.asarray(again["l3"]["wv"]),
                                      np.asarray(sliced["l3"]["wv"]))
        for fn in (tgpt.gqa_slice_kv_params, tgpt.gqa_repeat_kv_params):
            with pytest.raises(ValueError, match="must divide num_heads"):
                fn(params, cfg, 3)


def test_pool_bytes_int8_gqa_and_dtype_guard():
    """test_int8_pool_bytes_beat_056x_dense_bf16 and
    test_gqa_pool_bytes_divide_by_group_factor on the port's cache, each
    count equal to the JAX cache's at the same geometry."""
    q = PagedKVCache(4, 2, 64, 32, block_size=16, dtype=torch.bfloat16,
                     kv_dtype="int8", device="cpu")
    d = PagedKVCache(4, 2, 64, 32, block_size=16, dtype=torch.bfloat16,
                     device="cpu")
    assert q.scale_bytes() > 0
    assert q.pool_bytes() == q.dense_pool_bytes(torch.int8) + \
        q.scale_bytes()
    assert q.pool_bytes() / d.pool_bytes() <= 0.56
    assert q.dense_pool_bytes() == d.pool_bytes()
    jq = jkvc.PagedKVCache(4, 2, 64, 32, block_size=16, dtype=jnp.bfloat16,
                           kv_dtype="int8")
    assert (q.pool_bytes(), q.scale_bytes(), q.dense_pool_bytes()) == \
        (jq.pool_bytes(), jq.scale_bytes(), jq.dense_pool_bytes())
    assert q.quantized and q.dtype == torch.int8
    assert q.compute_dtype == torch.bfloat16
    layer = q.pools[0]
    assert layer["k"].dtype == torch.int8
    assert layer["k_scale"].shape == (32, 2, 16)
    assert bool((layer["k_scale"] == 1.0).all())         # 1.0, never 0
    assert bool((layer["v_scale"] == 1.0).all())
    mha = PagedKVCache(4, 4, 32, 9, block_size=8, device="cpu")
    gqa = PagedKVCache(4, 4, 32, 9, block_size=8, num_kv_heads=2,
                       device="cpu")
    mqa = PagedKVCache(4, 4, 32, 9, block_size=8, num_kv_heads=1,
                       device="cpu")
    assert mha.pool_bytes() == 2 * gqa.pool_bytes() == 4 * mqa.pool_bytes()
    q_mha = PagedKVCache(4, 4, 32, 9, block_size=8, kv_dtype="int8",
                         device="cpu")
    q_gqa = PagedKVCache(4, 4, 32, 9, block_size=8, kv_dtype="int8",
                         num_kv_heads=2, device="cpu")
    assert q_mha.pool_bytes() == 2 * q_gqa.pool_bytes()
    assert q_mha.scale_bytes() == 2 * q_gqa.scale_bytes()
    assert q_mha.dense_pool_bytes() == 2 * q_gqa.dense_pool_bytes()
    assert q_gqa.pools[0]["k_scale"].shape == (9, 2, 8)
    b16 = PagedKVCache(1, 2, 8, 4, kv_dtype="bf16", device="cpu")
    assert b16.dtype == torch.bfloat16 and not b16.quantized
    assert b16.scale_bytes() == 0 and "k_scale" not in b16.pools[0]
    with pytest.raises(ValueError, match="kv_dtype"):
        PagedKVCache(1, 2, 8, 4, kv_dtype="fp8", device="cpu")


# ---------------------------------------------------------------------------
# serving: the staggered stream through the JAX and the port servers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("int8_weights", [False, True])
def test_int8_stream_ids_match_jax(trained, jax_engine, int8_weights):
    cfg, params, tree = trained
    js = _jax_server(params, cfg, int8_weights, kv_dtype="int8")
    ts = _port_server(tree, cfg, int8_weights, kv_dtype="int8")
    jlog, tlog = _record_logps(js), _record_logps(ts)
    jres, tres = _staggered_stream(js), _staggered_stream(ts)
    assert _ids(tres) == _ids(jres)
    for a, b in zip(jres, tres):
        np.testing.assert_allclose(tlog[b.request_id], jlog[a.request_id],
                                   rtol=0, atol=LOGP_ATOL)
    st = ts.get_stats()
    assert st["cancelled"] == 1 and st["retired"] == 3
    assert st["blocks_free"] == st["blocks_total"]
    kq = st["kv_quant"]
    assert kq == {
        "kv_dtype": "int8", "compute_dtype": "float32",
        "pool_bytes": js.cache.pool_bytes(),
        "scale_bytes": js.cache.scale_bytes(),
        "dense_equiv_bytes": js.cache.dense_pool_bytes(),
        "bytes_ratio_vs_dense": round(js.cache.pool_bytes()
                                      / js.cache.dense_pool_bytes(), 4),
        "int8_weights": 6 * cfg.num_layers if int8_weights else 0}
    # the int8 server against the port's dense one: the JAX test's floor
    dense = _port_server(tree, cfg)
    assert dense.get_stats()["kv_quant"] is None
    a = [t for r in _ids(_staggered_stream(dense)) for t in r]
    b = [t for r in _ids(tres) for t in r]
    rate = sum(x == y for x, y in zip(a, b)) / len(a)
    assert len(a) == len(b) and rate >= 0.9, rate


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_gqa_stream_ids_match_jax_and_repeat_kv(trained, jax_engine,
                                                kv_dtype):
    cfg, params, tree = trained
    kv = 2
    gcfg = _gqa_cfg(cfg, kv)
    jsliced = jgpt.gqa_slice_kv_params(params, cfg, kv)
    sliced = tgpt.gqa_slice_kv_params(tree, cfg, kv)
    ts = _port_server(sliced, gcfg, kv_dtype=kv_dtype)
    assert ts.cache.num_kv_heads == kv
    assert ts.cache.pools[0]["k"].shape[1] == kv
    ids = _ids(_staggered_stream(ts))
    assert ids == _ids(_staggered_stream(
        _jax_server(jsliced, gcfg, kv_dtype=kv_dtype)))
    rep = _port_server(tgpt.gqa_repeat_kv_params(sliced, cfg, kv), cfg,
                       kv_dtype=kv_dtype)
    assert rep.cache.num_kv_heads == cfg.num_heads
    assert ids == _ids(_staggered_stream(rep))
    mha = PagedKVCache(cfg.num_layers, cfg.num_heads, 32, 9,
                       kv_dtype=kv_dtype, device="cpu")
    gqa = PagedKVCache(cfg.num_layers, cfg.num_heads, 32, 9,
                       kv_dtype=kv_dtype, num_kv_heads=kv, device="cpu")
    assert mha.pool_bytes() == 2 * gqa.pool_bytes()


def test_bf16_pools_need_a_bf16_model(trained):
    """bf16 pools serve under a bf16 model and, as in the JAX package,
    under an f32 one too (f32 q scored against the bf16 keys)."""
    cfg, _params, tree = trained
    for dtype in (torch.bfloat16, None):
        model = GPTServingModel(tgpt.params_from_numpy(tree, "cpu"), cfg,
                                device="cpu", dtype=dtype)
        srv = GenerationServer(model, device="cpu", kv_dtype="bf16",
                               **SERVER_KW)
        assert srv.cache.dtype == torch.bfloat16 and not srv.cache.quantized
        fut = srv.submit([5, 9, 11], max_new_tokens=4)
        srv.run_until_idle()
        assert len(fut.result(timeout=5).token_ids) == 4


def test_gqa_ledger_and_stats_report_kv_truth(trained):
    """Twin of test_gqa_serving.py's ledger test, pinned against the
    bytes computed from the geometry, not against that test (which
    fails on the CPU: it also asserts that the Pallas kernel engaged).
    An int8 GQA server's kv_pool row carries the pools' physical head
    count (H_kv) beside the model's, and its bytes are the codes plus
    the f32 scales of 2 x layers x blocks x H_kv x bs rows; get_stats'
    kv_quant reports the same bytes."""
    from paddle_tpu_torch.observability.compile_insight import hbm_ledger
    cfg, params, tree = trained
    kv = 2
    gcfg = _gqa_cfg(cfg, kv)
    srv = _port_server(tgpt.gqa_slice_kv_params(tree, cfg, kv), gcfg,
                       kv_dtype="int8")
    try:
        n, bs = srv.cache.num_blocks, srv.block_size
        d = cfg.hidden_size // cfg.num_heads
        rows = 2 * cfg.num_layers * n * kv * bs
        want = rows * d + rows * 4          # int8 codes + f32 scales
        dense = rows * d * 4                # the same blocks dense in f32
        ledger = {r["name"]: r for r in hbm_ledger().snapshot()["entries"]
                  if r["component"] == srv._ledger_id}
        det = ledger["kv_pool"]["detail"]
        assert det["heads"] == kv and det["q_heads"] == cfg.num_heads
        assert ledger["kv_pool"]["bytes"] == want == srv.cache.pool_bytes()
        assert det["dense_equiv_bytes"] == dense
        assert det["scale_bytes"] == rows * 4
        fut = srv.submit([5, 9, 11], max_new_tokens=4)
        srv.run_until_idle()
        assert len(fut.result(timeout=5).token_ids) == 4
        q = srv.get_stats()["kv_quant"]
        assert q["pool_bytes"] == want and q["dense_equiv_bytes"] == dense
        assert q["pool_bytes"] < q["dense_equiv_bytes"]
        assert srv.get_stats()["memory"]["kv_cache"] == want
    finally:
        srv.close()
