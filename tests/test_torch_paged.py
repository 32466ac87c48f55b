"""The port's paged-attention ops against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX functions and
their paddle_tpu_torch counterparts:

- the plain paged attention (the port's ``paged_attention_reference``)
  against JAX's ``paged_attention_reference`` and against the Pallas
  kernels v1/v2 run in interpret mode, for f32 and bf16, MHA and GQA,
  C=1 and C=4, with an idle lane; tolerance 1e-5 (f32) and 2e-2 (bf16);
- NaN-poisoned NULL blocks: the Pallas kernels never read them, so on a
  poisoned pool they must equal the plain version on a clean one;
- ``write_block_kv`` equal to JAX's everywhere but the NULL block;
- the counter RNG: ``fold_key`` and the Gumbel hash bitwise numpy's;
- ``_sample_rows`` ids equal to JAX's on fixed rows.

On the CPU the dispatcher takes the plain version; the CUDA kernel itself
is held against it on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import paged as jpaged
from paddle_tpu.serving import decode_strategies as jds
from paddle_tpu.serving import engine as jengine
from paddle_tpu.serving import kv_cache as jkvc
from paddle_tpu_torch.ops.cuda import paged as tpaged
from paddle_tpu_torch.serving import decode_strategies as tds
from paddle_tpu_torch.serving import engine as tengine
from paddle_tpu_torch.serving import kv_cache as tkvc

TOL = {"f32": 1e-5, "bf16": 2e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def make_case(b=3, h=4, hp=4, c=4, d=8, bs=8, m=6, seed=0, poison=False,
              idle_lane=True):
    """numpy operands: pools (1 + b*m, hp, bs, d) f32, shuffled live
    blocks per lane, lane 0 idle on request, NULL block NaN on request."""
    rng = np.random.default_rng(seed)
    n = 1 + b * m
    k_pool = rng.standard_normal((n, hp, bs, d)).astype(np.float32)
    v_pool = rng.standard_normal((n, hp, bs, d)).astype(np.float32)
    k_pool[0] = np.nan if poison else 0.0
    v_pool[0] = np.nan if poison else 0.0
    q = rng.standard_normal((b, h, c, d)).astype(np.float32)
    tables = np.zeros((b, m), np.int32)
    q_pos = np.zeros((b, c), np.int32)
    free = list(range(1, n))
    rng.shuffle(free)
    for i in range(b):
        if idle_lane and i == 0:
            continue
        length = int(rng.integers(1, m * bs - c))
        for j in range(-(-(length + c) // bs)):
            tables[i, j] = free.pop()
        q_pos[i] = np.arange(length, length + c)
    return q, k_pool, v_pool, tables, q_pos


def _jax_args(case, dt):
    q, k, v, t, p = case
    return (jnp.asarray(q, JDT[dt]), jnp.asarray(k, JDT[dt]),
            jnp.asarray(v, JDT[dt]), jnp.asarray(t), jnp.asarray(p))


def _torch_args(case, dt):
    q, k, v, t, p = case
    return (torch.from_numpy(q).to(TDT[dt]), torch.from_numpy(k).to(TDT[dt]),
            torch.from_numpy(v).to(TDT[dt]), torch.from_numpy(t),
            torch.from_numpy(p))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _max_err(port, ref):
    return float(np.max(np.abs(port.float().numpy() - ref)))


# (dtype, pool heads, columns, head dim): head dim 8 at every other axis,
# and head dim 128 (the card's largest, GPTConfig(hidden_size=1024,
# num_heads=8)'s) for MHA prefill and GQA decode
CASES = ([(dt, hp, c, 8) for dt in ("f32", "bf16") for hp in (4, 2)
          for c in (1, 4)]
         + [(dt, hp, c, 128) for dt in ("f32", "bf16")
            for hp, c in ((4, 4), (2, 1))])


def _case_id(case):
    dt, hp, c, d = case
    return f"{dt}-{hp}-{c}" + ("" if d == 8 else f"-d{d}")


@pytest.mark.parametrize("dt,hp,c,d", CASES, ids=map(_case_id, CASES))
def test_plain_matches_jax_reference(dt, hp, c, d):
    case = make_case(hp=hp, c=c, d=d, seed=3)
    ref = _np(jkvc.paged_attention_reference(*_jax_args(case, dt)))
    out = tkvc.paged_attention(*_torch_args(case, dt))
    assert out.dtype == TDT[dt] and out.shape == case[0].shape
    assert _max_err(out, ref) <= TOL[dt]
    assert float(out[0].abs().max()) == 0.0       # the idle lane


@pytest.mark.parametrize("dt,hp,c,d", CASES, ids=map(_case_id, CASES))
def test_plain_matches_pallas_kernels_interpret(dt, hp, c, d):
    """The Pallas kernels v1/v2 run in interpret mode on a NaN-poisoned
    NULL block; the plain version reads a clean copy of the same pools."""
    clean = make_case(hp=hp, c=c, d=d, seed=5)
    poisoned = make_case(hp=hp, c=c, d=d, seed=5, poison=True)
    out = tkvc.paged_attention(*_torch_args(clean, dt))
    for fn in (jpaged.ragged_paged_attention,
               jpaged.ragged_paged_attention_v2):
        ref = _np(fn(*_jax_args(poisoned, dt), interpret=True))
        assert np.isfinite(ref).all()
        assert _max_err(out, ref) <= TOL[dt], fn.__name__


@pytest.mark.parametrize("d", tpaged.HEAD_DIMS)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_kernel_checks_take_head_dims_off_the_card(dt, d):
    """paged_attention_cuda's checks take every head dim of HEAD_DIMS (the
    dense and the int8 pools): on CPU tensors they fail only at the last
    check, that every operand lie on the card."""
    case = make_case(hp=2, c=4, d=d, seed=6)
    with pytest.raises(ValueError, match="every operand must be a CUDA"):
        tpaged.paged_attention_cuda(*_torch_args(case, dt))
    q, k, v, t, p = _torch_args(case, dt)
    kq, ks = tkvc.quantize_kv_rows(k.float())
    vq, vs = tkvc.quantize_kv_rows(v.float())
    with pytest.raises(ValueError, match="every operand must be a CUDA"):
        tpaged.paged_attention_cuda(q, kq, vq, t, p, k_scale=ks, v_scale=vs)


@pytest.mark.parametrize("d", [16, 48, 256])
def test_kernel_checks_refuse_other_head_dims(d):
    case = make_case(hp=2, c=4, d=d, seed=6)
    with pytest.raises(ValueError, match=r"head_dim .* the kernel takes "
                                         r"\(32, 64, 128\)"):
        tpaged.paged_attention_cuda(*_torch_args(case, "f32"))


# ---------------------------------------------------------------------------
# the kernel's split-K walk and merge, modelled in plain PyTorch
# ---------------------------------------------------------------------------

def split_merge_model(q, k_pool, v_pool, table, pos, splits, k_scale=None,
                      v_scale=None, seen=None):
    """The kernel's algorithm in f32, block by block: each of `splits`
    splits walks a contiguous range of ceil(M / splits) table entries up
    to the lane's early stop max(pos) // bs + 1, skips NULL entries (never
    reading them), and folds each block into an online softmax (m, l,
    acc); int8 scales factor out (k_scale on the scores, v_scale on the
    probabilities). The partials merge with weights exp(m_s - M) over the
    splits with l_s > 0; an idle lane gives exactly 0. `seen` collects
    the (lane, split) pairs and the table entries read."""
    b, h, c, d = q.shape
    _, hp, bs, _ = k_pool.shape
    m = table.shape[1]
    g = h // hp
    per = -(-m // splits)
    q = q.float()
    out = torch.zeros(b, h, c, d)
    for lane in range(b):
        n_live = min(int(pos[lane].max()) // bs + 1, m)
        parts = []
        for sp in range(splits):
            mm = torch.full((h, c), tpaged.NEG_INF)
            l = torch.zeros(h, c)
            acc = torch.zeros(h, c, d)
            for j in range(sp * per, min(sp * per + per, m, n_live)):
                blk = int(table[lane, j])
                if blk == tpaged.NULL_BLOCK:
                    continue
                if seen is not None:
                    seen["blocks"].add(blk)
                kt = k_pool[blk].float().repeat_interleave(g, 0)
                vt = v_pool[blk].float().repeat_interleave(g, 0)
                s = torch.einsum("hcd,htd->hct", q[lane], kt)
                if k_scale is not None:
                    s = s * k_scale[blk].repeat_interleave(g, 0)[:, None, :]
                s = s / d ** 0.5
                key_pos = j * bs + torch.arange(bs)
                mask = key_pos[None, None, :] <= pos[lane][None, :, None]
                s = torch.where(mask, s, torch.tensor(tpaged.NEG_INF))
                m_new = torch.maximum(mm, s.amax(-1))
                corr = torch.exp(mm - m_new)
                p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
                l = l * corr + p.sum(-1)
                if v_scale is not None:
                    p = p * v_scale[blk].repeat_interleave(g, 0)[:, None, :]
                acc = acc * corr[..., None] + torch.einsum("hct,htd->hcd",
                                                           p, vt)
                mm = m_new
            if seen is not None and not bool((l > 0).any()):
                seen["empty"].add((lane, sp))
            parts.append((mm, l, acc))
        ms = torch.stack([p[0] for p in parts])
        ls = torch.stack([p[1] for p in parts])
        top = torch.where(ls > 0, ms,
                          torch.tensor(tpaged.NEG_INF)).amax(0)
        w = torch.where(ls > 0, torch.exp(ms - top), 0.0)
        total = (ls * w).sum(0)
        accs = torch.stack([p[2] for p in parts])
        merged = (w[..., None] * accs).sum(0)
        out[lane] = merged / torch.where(total > 0, total, 1.0)[..., None]
    return out


@pytest.mark.parametrize("splits", range(1, 9))
@pytest.mark.parametrize("hp", [4, 2])
def test_split_merge_model_matches_reference(splits, hp):
    """Split counts 1-8 over a 12-entry table, the NULL block NaN-poisoned
    (no split reads it), lane 0 idle (exactly 0), and at least one split
    that sees no live block; f32 within 1e-5 of the plain version on the
    clean pools."""
    clean = make_case(b=4, hp=hp, c=4, m=12, seed=11)
    poisoned = make_case(b=4, hp=hp, c=4, m=12, seed=11, poison=True)
    seen = {"blocks": set(), "empty": set()}
    out = split_merge_model(*_torch_args(poisoned, "f32"), splits=splits,
                            seen=seen)
    ref = tkvc.paged_attention_reference(*_torch_args(clean, "f32"))
    assert tpaged.NULL_BLOCK not in seen["blocks"]
    assert any(lane > 0 for lane, _ in seen["empty"]) or splits == 1
    assert torch.isfinite(out).all()
    assert float(out[0].abs().max()) == 0.0
    assert float((out - ref).abs().max()) <= TOL["f32"]


def test_gather_block_kv_matches_jax():
    _, k, v, t, _ = make_case(hp=2, seed=7)
    jk, jv = jkvc.gather_block_kv_pair(jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(t))
    tk, tv = tkvc.gather_block_kv_pair(torch.from_numpy(k),
                                       torch.from_numpy(v),
                                       torch.from_numpy(t))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(
        tkvc.gather_block_kv(torch.from_numpy(k), torch.from_numpy(t)),
        np.asarray(jkvc.gather_block_kv(jnp.asarray(k), jnp.asarray(t))))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_write_block_kv_matches_jax(dt):
    rng = np.random.default_rng(11)
    n, h, bs, d, s, c = 9, 2, 4, 8, 3, 4
    pool = rng.standard_normal((n, h, bs, d)).astype(np.float32)
    vals = rng.standard_normal((s, c, h, d)).astype(np.float32)
    # distinct (block, offset) targets for valid tokens; two masked
    # tokens routed to (NULL_BLOCK, 0) like the fused step does
    targets = rng.permutation((n - 1) * bs)[:s * c] + bs
    bidx = (targets // bs).reshape(s, c).astype(np.int32)
    off = (targets % bs).reshape(s, c).astype(np.int32)
    bidx[0, 3] = bidx[2, 1] = jkvc.NULL_BLOCK
    off[0, 3] = off[2, 1] = 0
    ref = np.asarray(jkvc.write_block_kv(
        jnp.asarray(pool, JDT[dt]), jnp.asarray(vals), jnp.asarray(bidx),
        jnp.asarray(off)).astype(jnp.float32))
    tpool = torch.from_numpy(pool).to(TDT[dt])
    out = tkvc.write_block_kv(tpool, torch.from_numpy(vals),
                              torch.from_numpy(bidx), torch.from_numpy(off))
    assert out.data_ptr() == tpool.data_ptr()       # written in place
    np.testing.assert_array_equal(out[1:].float().numpy(), ref[1:])


def test_pool_device_defaults_to_the_card(monkeypatch):
    """PagedKVCache(device=None) means the card, as every entry point of
    the port: without CUDA it raises; device="cpu" builds the pools the
    CPU default used to, equal to the JAX cache's zeros."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tkvc.PagedKVCache(num_layers=2, num_heads=2, head_dim=4,
                          num_blocks=9, block_size=4)
    pool = tkvc.PagedKVCache(num_layers=2, num_heads=2, head_dim=4,
                             num_blocks=9, block_size=4, device="cpu")
    jpool = jkvc.PagedKVCache(num_layers=2, num_heads=2, head_dim=4,
                              num_blocks=9, block_size=4)
    assert pool.device == torch.device("cpu")
    for layer, jlayer in zip(pool.pools, jpool.pools):
        for name in ("k", "v"):
            assert layer[name].device.type == "cpu"
            assert layer[name].dtype == torch.float32
            np.testing.assert_array_equal(layer[name].numpy(),
                                          np.asarray(jlayer[name]))


def test_pool_allocate_free_accounting():
    pool = tkvc.PagedKVCache(num_layers=2, num_heads=2, head_dim=4,
                             num_blocks=9, block_size=4, device="cpu")
    assert pool.usable_blocks == 8 and pool.num_free == 8
    a = pool.allocate(3)
    b = pool.allocate(5)
    assert pool.num_free == 0 and pool.allocate(1) is None
    assert tkvc.NULL_BLOCK not in a + b
    assert pool.utilization() == 1.0
    pool.free(a)
    assert pool.num_free == 3
    assert pool.blocks_for_tokens(9) == 3
    with pytest.raises(ValueError):
        pool.free([tkvc.NULL_BLOCK])
    with pytest.raises(ValueError):
        pool.free(a)                                # double free
    pool.ref(b[0])
    with pytest.raises(ValueError):
        pool.free([b[0]])                           # shared block
    assert pool.unref(b[0]) is False and pool.unref(b[0]) is True
    assert pool.refcount(b[0]) == 0
    assert pool.pool_bytes() == 2 * 2 * 9 * 2 * 4 * 4 * 4
    np.testing.assert_array_equal(pool.make_table([3, 5], 4), [3, 5, 0, 0])


# ---------------------------------------------------------------------------
# counter RNG and in-step sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,lane,pos", [(0, 0, 0), (7, 3, 511),
                                           (2 ** 40 + 5, 1, 1023),
                                           (-1, 0, 17)])
def test_fold_key_bitwise(seed, lane, pos):
    a = jds.fold_key(seed, lane, pos)
    b = tds.fold_key(seed, lane, pos)
    assert a.dtype == b.dtype == np.uint32
    np.testing.assert_array_equal(a, b)


def test_gumbel_noise_matches_numpy():
    """The uint32 hash and the uniforms are bitwise numpy's; the noise
    applies two f32 logs, which numpy and torch each compute their own
    way, so the noise is pinned at 1e-6 absolute."""
    keys = np.stack([jds.fold_key(s, lane, p) for s, lane, p in
                     ((1, 0, 3), (9, 2, 77), (123456, 0, 1000))])
    vocab = 4099
    idx = np.arange(vocab, dtype=np.uint32)
    h = jds._mix32(idx ^ keys[:, 0:1], np)
    h = jds._mix32(h ^ keys[:, 1:2], np)
    u = np.clip((h >> np.uint32(8)).astype(np.float32)
                * np.float32(1.0 / (1 << 24)),
                np.float32(1e-7), np.float32(1.0 - 1e-7))
    tkeys = torch.from_numpy(keys.astype(np.int64))
    np.testing.assert_array_equal(tds.gumbel_uniform(tkeys, vocab).numpy(),
                                  u)
    # numpy's and torch's f32 logs differ by a few ulp; the outer log
    # turns the inner relative difference into an absolute one of the
    # same size, which is many ulps near noise 0
    np.testing.assert_allclose(tds.gumbel_noise(tkeys, vocab).numpy(),
                               jds.gumbel_noise(keys, vocab, xp=np),
                               rtol=0, atol=1e-6)


def test_sample_rows_matches_jax():
    rng = np.random.default_rng(4)
    s, v = 6, 97
    logits = rng.standard_normal((s, v)).astype(np.float32) * 3
    base = np.array(jax.nn.log_softmax(jnp.asarray(logits)))
    keys = np.stack([jds.fold_key(31, 0, p) for p in range(s)])
    temperature = np.array([1.0, 0.7, 1.3, 0.5, 1.0, 2.0], np.float32)
    top_k = np.array([0, 5, 0, 20, 1, 0], np.int32)
    top_p = np.array([2.0, 2.0, 0.9, 0.5, 2.0, 0.3], np.float32)
    j_ids, j_lp = jengine._sample_rows(
        jnp.asarray(base), jnp.asarray(keys), jnp.asarray(temperature),
        jnp.asarray(top_k), jnp.asarray(top_p))
    t_ids, t_lp = tengine._sample_rows(
        torch.from_numpy(base), torch.from_numpy(keys.astype(np.int64)),
        torch.from_numpy(temperature), torch.from_numpy(top_k),
        torch.from_numpy(top_p))
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(t_lp.numpy(), np.asarray(j_lp), atol=1e-5)
