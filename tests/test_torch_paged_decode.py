"""The port's paged decode adapter (``serving.PagedDecodeLayer``,
``build_paged_decode_cache``) and ``update_kv_cache``'s paged branch
against the JAX package, on the CPU.

Twins of ``tests/models/test_decoding_edges.py:62,149,170``:

- the paged update's dtype contract (a bf16 pool takes f32 K/V, the
  gathered view bitwise JAX's);
- paged against dense decoding of the tiny GPT (the JAX startup's
  weights, seed 23, carried over as numpy): greedy ids bitwise equal,
  scores within 1e-6 / 1e-7 (JAX's bar), in f32 and in bf16, and the
  port's ids equal to the JAX package's greedy decode; sampled ids
  bitwise equal under one ``torch.Generator`` seed (the port's draws
  cannot be JAX's threefry bits; what is shared is that both caches give
  the same filtered distributions);
- int8 pools: one paged update writes JAX's codes and scales bitwise,
  the gathered view dequantizes them as JAX's does, and the pool gets
  its blocks back.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu import serving as jserving
from paddle_tpu.core import framework as jframework
from paddle_tpu.inference import decoding as jdec
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch import serving
from paddle_tpu_torch.inference import decoding as dec
from paddle_tpu_torch.models import gpt as tgpt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def test_paged_update_kv_cache_dtype_wins_too():
    pool = serving.PagedKVCache(num_layers=1, num_heads=2, head_dim=4,
                                num_blocks=5, block_size=4,
                                dtype=torch.bfloat16, device="cpu")
    layers, _tables, blocks = serving.build_paged_decode_cache(
        pool, batch=2, max_len=8)
    k_t = torch.full((2, 2, 1, 4), 1.0078125, dtype=torch.float32)
    out = dec.update_kv_cache(layers[0], k_t, k_t, 5)
    assert isinstance(out, serving.PagedDecodeLayer)
    dense_view = out["k"]
    assert dense_view.dtype == torch.bfloat16
    assert dense_view.shape == (2, 2, 8, 4)
    np.testing.assert_array_equal(
        dense_view[:, :, 5, :].float().numpy(), 1.0078125)
    # the JAX adapter over the same allocation order gives the same view
    jpool = jserving.PagedKVCache(num_layers=1, num_heads=2, head_dim=4,
                                  num_blocks=5, block_size=4,
                                  dtype=jnp.bfloat16)
    jlayers, jtables, jblocks = jserving.build_paged_decode_cache(
        jpool, batch=2, max_len=8)
    np.testing.assert_array_equal(np.asarray(jtables), _tables.numpy())
    jout = jdec.update_kv_cache(jlayers[0], jnp.asarray(k_t.numpy()),
                                jnp.asarray(k_t.numpy()), 5)
    np.testing.assert_array_equal(
        np.asarray(jout["k"], np.float32), dense_view.float().numpy())
    free = pool.num_free
    pool.free(blocks)
    assert pool.num_free == free + len(blocks) == pool.usable_blocks
    jpool.free(jblocks)


def test_paged_decode_cache_exhausted_allocates_nothing():
    pool = serving.PagedKVCache(num_layers=1, num_heads=2, head_dim=4,
                                num_blocks=5, block_size=4, device="cpu")
    with pytest.raises(MemoryError, match="paged pool exhausted"):
        serving.build_paged_decode_cache(pool, batch=3, max_len=8)
    assert pool.num_free == pool.usable_blocks


@pytest.fixture(scope="module")
def tiny_gpt_params():
    """test_decoding_edges.py's tiny GPT (startup seed 23): (JAX cfg,
    JAX params, numpy tree)."""
    cfg = jgpt.gpt_tiny()
    main, startup = jframework.Program(), jframework.Program()
    main.random_seed = startup.random_seed = 23
    with jframework.program_guard(main, startup):
        jgpt.build_lm_net(cfg, seq_len=8)
    scope = jfluid.Scope()
    exe = jfluid.Executor()
    with jfluid.scope_guard(scope):
        exe.run(startup)
    params = jgpt.load_params(scope, cfg)
    tree = {k: ({kk: np.asarray(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else np.asarray(v))
            for k, v in params.items()}
    return cfg, params, tree


def _port_cfg(cfg):
    return tgpt.GPTConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        num_layers=cfg.num_layers, num_heads=cfg.num_heads,
        inner_size=cfg.inner_size, max_position=cfg.max_position,
        dropout=0.0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_paged_vs_dense_greedy_bitwise(tiny_gpt_params, dtype):
    cfg, jparams, tree = tiny_gpt_params
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    tcfg = _port_cfg(cfg)
    params = tgpt.params_from_numpy(tree, "cpu", dtype=tdt)
    d = cfg.hidden_size // cfg.num_heads
    max_len, gen = 32, 16
    step = tgpt.build_kv_step(params, tcfg, max_len)
    bos = torch.tensor([5, 9, 200])
    dense = dec.init_kv_cache(3, cfg.num_layers, cfg.num_heads, max_len, d,
                              dtype=tdt, device="cpu")
    ids_d, sc_d = dec.greedy_decode(step, dense, bos, max_len=gen)
    pool = serving.PagedKVCache(cfg.num_layers, cfg.num_heads, d,
                                num_blocks=16, block_size=8, dtype=tdt,
                                device="cpu")
    paged, _tables, blocks = serving.build_paged_decode_cache(
        pool, batch=3, max_len=max_len)
    ids_p, sc_p = dec.greedy_decode(step, paged, bos, max_len=gen)
    pool.free(blocks)
    assert pool.num_free == pool.usable_blocks
    # bitwise token ids; scores allclose (bitwise in practice: the
    # gathered view runs the identical contraction)
    np.testing.assert_array_equal(ids_d.numpy(), ids_p.numpy())
    np.testing.assert_allclose(sc_d.numpy(), sc_p.numpy(), rtol=1e-6,
                               atol=1e-7)
    if dtype == "f32":
        jstep = jgpt.build_kv_step(jparams, cfg, max_len)
        jcache = jdec.init_kv_cache(3, cfg.num_layers, cfg.num_heads,
                                    max_len, d)
        jids, _ = jdec.greedy_decode(jstep, jcache,
                                     jnp.asarray([5, 9, 200], jnp.int32),
                                     max_len=gen)
        np.testing.assert_array_equal(ids_p.numpy(), np.asarray(jids))


def test_paged_vs_dense_sampling_same_generator_bitwise(tiny_gpt_params):
    """sample_decode under one torch.Generator seed picks the same tokens
    against either cache: the filtered distributions agree."""
    cfg, _jparams, tree = tiny_gpt_params
    tcfg = _port_cfg(cfg)
    params = tgpt.params_from_numpy(tree, "cpu")
    d = cfg.hidden_size // cfg.num_heads
    max_len, gen = 16, 8
    step = tgpt.build_kv_step(params, tcfg, max_len)
    bos = torch.tensor([5, 9])
    dense = dec.init_kv_cache(2, cfg.num_layers, cfg.num_heads, max_len, d,
                              device="cpu")
    ids_d, sc_d = dec.sample_decode(
        step, dense, bos, gen, torch.Generator().manual_seed(3),
        temperature=1.0, top_k=16)
    pool = serving.PagedKVCache(cfg.num_layers, cfg.num_heads, d,
                                num_blocks=8, block_size=8, device="cpu")
    paged, _t, blocks = serving.build_paged_decode_cache(pool, 2, max_len)
    ids_p, sc_p = dec.sample_decode(
        step, paged, bos, gen, torch.Generator().manual_seed(3),
        temperature=1.0, top_k=16)
    pool.free(blocks)
    np.testing.assert_array_equal(ids_d.numpy(), ids_p.numpy())
    np.testing.assert_allclose(sc_d.numpy(), sc_p.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_paged_int8_update_writes_jax_codes():
    """int8 pools: one paged update quantizes at write as JAX's eager
    write_block_kv_quant does (codes and scales bitwise), and the
    gathered view is JAX's dequantized view."""
    rng = np.random.default_rng(7)
    k = rng.standard_normal((2, 2, 1, 4)).astype(np.float32)
    v = rng.standard_normal((2, 2, 1, 4)).astype(np.float32)
    pool = serving.PagedKVCache(num_layers=1, num_heads=2, head_dim=4,
                                num_blocks=5, block_size=4, device="cpu",
                                kv_dtype="int8")
    layers, _tables, blocks = serving.build_paged_decode_cache(pool, 2, 8)
    out = dec.update_kv_cache(layers[0], torch.from_numpy(k),
                              torch.from_numpy(v), 6)
    jpool = jserving.PagedKVCache(num_layers=1, num_heads=2, head_dim=4,
                                  num_blocks=5, block_size=4,
                                  kv_dtype="int8")
    jlayers, _jt, jblocks = jserving.build_paged_decode_cache(jpool, 2, 8)
    jout = jdec.update_kv_cache(jlayers[0], jnp.asarray(k), jnp.asarray(v),
                                6)
    for ours, theirs in ((out.k_pool, jout.k_pool),
                         (out.v_pool, jout.v_pool),
                         (out.k_scale, jout.k_scale),
                         (out.v_scale, jout.v_scale)):
        np.testing.assert_array_equal(ours[1:].numpy(),
                                      np.asarray(theirs)[1:])
    for key in ("k", "v"):
        assert out[key].dtype == torch.float32
        np.testing.assert_array_equal(out[key].numpy(),
                                      np.asarray(jout[key]))
    pool.free(blocks)
    jpool.free(jblocks)
    assert pool.num_free == pool.usable_blocks
