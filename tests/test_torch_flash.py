"""The port's flash-attention forward against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through JAX's
``flash_attention_with_lse`` (its Pallas kernels run in interpret mode
off the TPU: ``_fwd_kernel`` with ``PT_FLASH_KGRID=0`` and
``_fwd_kernel_kgrid`` with ``PT_FLASH_KGRID=1``, set in the test's own
environment) and the port's ``flash_attention_with_lse``, which takes its
plain version for CPU tensors. Both ``out`` and ``lse`` are compared, f32,
to ``ATOL``/``RTOL`` (the JAX tests' 2e-5: the two differ in summation
order only), on mirrors of ``tests/ops/test_flash_attention.py``: causal
and not, Tq = Tk and Tq != Tk, lengths off the tile grid, key-only,
per-head and full bias, bias under causal, segment ids (self, composed
with a bias, the cross (seg_q, seg_k) pair, tiles skipped whole), and
causal rows with no visible key, which output exactly 0.

JAX takes block sizes; the port does not (its kernel picks its tiles), so
the JAX side is given the blocks its own test uses.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash as jflash
from paddle_tpu_torch.ops import flash as tflash
from paddle_tpu_torch.ops.cuda import flash as cflash
from test_torch_flash_bwd import mm3

ATOL = RTOL = 2e-5


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


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _qkv(b, h, tq, tk, d, seed):
    return (_rand((b, h, tq, d), seed), _rand((b, h, tk, d), seed + 1),
            _rand((b, h, tk, d), seed + 2))


def _seg(segment_ids, wrap):
    if segment_ids is None:
        return None
    if isinstance(segment_ids, tuple):
        return tuple(wrap(s) for s in segment_ids)
    return wrap(segment_ids)


def _both(q, k, v, block, kgrid, monkeypatch, bias=None, causal=False,
          scale=None, segment_ids=None):
    """(JAX out, JAX lse, port out, port lse) as numpy."""
    monkeypatch.setenv("PT_FLASH_KGRID", kgrid)
    jo, jl = jflash.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        bias=None if bias is None else jnp.asarray(bias), scale=scale,
        causal=causal, block_q=block, block_k=block,
        segment_ids=_seg(segment_ids, jnp.asarray))
    to, tl = tflash.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        bias=None if bias is None else torch.from_numpy(bias), scale=scale,
        causal=causal, segment_ids=_seg(segment_ids, torch.from_numpy))
    assert to.dtype == torch.float32 and tl.dtype == torch.float32
    assert tuple(tl.shape) == q.shape[:3]
    return np.asarray(jo), np.asarray(jl), to.numpy(), tl.numpy()


def _close(jo, jl, to, tl):
    np.testing.assert_allclose(to, jo, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tl, jl, atol=ATOL, rtol=RTOL)


def _seg_rows():
    seg = np.zeros((2, 64), np.int32)
    seg[0, :30] = 1
    seg[0, 30:50] = 2          # 14 pad slots, id 0
    seg[1, :7] = 1             # boundaries off the tile grid
    seg[1, 7:] = 2
    return seg


def _case(name):
    """(q, k, v, block, kwargs) of one mirrored case."""
    if name.startswith("plain"):
        _, causal, tq, tk = name.split("_")
        q, k, v = _qkv(2, 3, int(tq), int(tk), 16, 0)
        return q, k, v, 32, dict(causal=causal == "causal")
    if name.startswith("ragged"):
        # lengths off every tile grid (not multiples of 16)
        _, causal = name.split("_")
        q, k, v = _qkv(2, 2, 37, 53, 32, 3)
        return q, k, v, 16, dict(causal=causal == "causal")
    if name == "bias_causal":
        q, k, v = _qkv(2, 2, 32, 32, 16, 1)
        return q, k, v, 16, dict(bias=_rand((2, 1, 1, 32), 3), causal=True)
    if name.startswith("bias"):
        shape = {"keyonly": (2, 1, 1, 64), "perhead": (1, 3, 48, 64),
                 "full": (2, 3, 48, 64)}[name.split("_")[1]]
        q, k, v = _qkv(2, 3, 48, 64, 16, 0)
        bias = np.zeros(shape, np.float32)
        if shape[2] == 1:
            bias[0, :, :, 32:] = -1e9           # padding mask, batch row 0
        else:
            bias = _rand(shape, 7) * 2.0
        return q, k, v, 32, dict(bias=bias)
    if name.startswith("seg_self"):
        q, k, v = _qkv(2, 3, 64, 64, 16, 3)
        return q, k, v, 32, dict(segment_ids=_seg_rows(),
                                 causal=name.endswith("causal"))
    if name == "seg_bias":
        q, k, v = _qkv(1, 2, 48, 48, 8, 6)
        seg = np.repeat([[1, 2, 3]], 16, axis=1).astype(np.int32)
        return q, k, v, 16, dict(segment_ids=seg,
                                 bias=_rand((1, 2, 48, 48), 9) * 0.5)
    if name == "seg_cross":
        q, k, v = _qkv(1, 2, 32, 48, 8, 10)
        sq = np.repeat([[1, 2]], 16, axis=1).astype(np.int32)
        sk = np.repeat([[1, 2, 2]], 16, axis=1).astype(np.int32)
        return q, k, v, 16, dict(segment_ids=(sq, sk))
    if name.startswith("seg_skip"):
        # block-aligned disjoint segments: whole tiles are skipped
        q, k, v = _qkv(1, 2, 32, 32, 8, 12)
        seg = np.repeat([[1, 2]], 16, axis=1).astype(np.int32)
        return q, k, v, 16, dict(segment_ids=seg,
                                 causal=name.endswith("causal"))
    raise KeyError(name)


CASES = ["plain_full_64_64", "plain_causal_64_64", "plain_full_48_80",
         "plain_causal_48_80", "ragged_full", "ragged_causal",
         "bias_keyonly", "bias_perhead", "bias_full", "bias_causal",
         "seg_self_full", "seg_self_causal", "seg_bias", "seg_cross",
         "seg_skip_full", "seg_skip_causal"]


@pytest.mark.parametrize("kgrid", ["0", "1"])
@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax_kernels(name, kgrid, monkeypatch):
    q, k, v, block, kw = _case(name)
    _close(*_both(q, k, v, block, kgrid, monkeypatch,
                  scale=1.0 / math.sqrt(q.shape[-1]), **kw))


@pytest.mark.parametrize("kgrid", ["0", "1"])
def test_causal_no_visible_keys_outputs_zero(kgrid, monkeypatch):
    """Causal with Tq > Tk: rows i < Tq - Tk see no key and output
    exactly 0 (lse at NEG_INF), as the pruned JAX kernels give with the
    dead rows in tiles of their own; the other rows match."""
    b, h, tq, tk, d = 1, 2, 16, 8, 8
    q, k, v = _qkv(b, h, tq, tk, d, 20)
    jo, jl, to, tl = _both(q, k, v, 8, kgrid, monkeypatch, causal=True)
    dead = tq - tk
    assert not to[:, :, :dead].any() and not jo[:, :, :dead].any()
    assert (tl[:, :, :dead] == np.float32(cflash.NEG_INF)).all()
    _close(jo, jl, to, tl)


def _dispatch_case(name):
    rng = np.random.default_rng(4)
    b, h, t, d = 2, 2, 24, 32
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, t, d)).astype(
        np.float32)) for _ in range(3))
    seg = torch.from_numpy(np.repeat([[1, 2, 3]], 8, axis=1).repeat(
        b, axis=0).astype(np.int64))
    fa, fl = tflash.flash_attention, tflash.flash_attention_with_lse
    if name == "out_is_with_lse_out":
        assert torch.equal(fa(q, k, v, causal=True),
                           fl(q, k, v, causal=True)[0])
    elif name == "default_scale":
        assert torch.equal(fa(q, k, v), fa(q, k, v, scale=1 / math.sqrt(d)))
    elif name == "cpu_takes_plain":
        want = cflash.flash_attention_reference(q, k, v, None, None, None,
                                                None, True)
        got = fl(q, k, v, causal=True)
        assert all(torch.equal(a, b_) for a, b_ in zip(got, want))
    elif name == "bias_broadcasts":
        key = torch.from_numpy(rng.standard_normal(t).astype(np.float32))
        full = key.expand(b, h, t, t).contiguous()
        assert torch.equal(fa(q, k, v, bias=key), fa(q, k, v, bias=full))
        one = torch.full((b, 1, 1, 1), 0.5)
        assert torch.equal(fa(q, k, v, bias=one),
                           fa(q, k, v, bias=one.expand(b, h, t, t)))
    elif name == "segments_equal_mask_bias":
        got = fa(q, k, v, segment_ids=seg)
        want = fa(q, k, v, bias=tflash.segment_mask_bias(seg))
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
        assert torch.equal(got, fa(q, k, v, segment_ids=[seg, seg]))
    elif name == "bad_bias_key_dim":
        with pytest.raises(ValueError, match="bias key dim"):
            fa(q, k, v, bias=torch.zeros(b, 1, 1, t + 1))
    elif name == "bad_segment_shape":
        with pytest.raises(ValueError, match="segment_ids shapes"):
            fa(q, k, v, segment_ids=seg[:, :-1])
    elif name == "kernel_takes_prefill_views":
        # (B, T, H, D) projections viewed as (B, H, T, D), as the prefill
        # passes them: the kernel's checks refuse only the CPU device
        x = torch.zeros(b, t, h, d)
        view = x.transpose(1, 2)
        with pytest.raises(ValueError, match="CUDA tensor"):
            cflash.flash_attention_cuda(view, view, view, None, None, None,
                                        None, True)
    elif name == "kernel_refuses_what_it_lacks":
        for args, msg in [((q[..., :24],) * 3, "head_dim"),
                          ((q.half(), k.half(), v.half()), "dtypes"),
                          ((q, k, v.transpose(-1, -2)), "k and v equal")]:
            with pytest.raises(ValueError, match=msg):
                cflash.flash_attention_cuda(*args)
    else:
        raise KeyError(name)


@pytest.mark.parametrize("name", [
    "out_is_with_lse_out", "default_scale", "cpu_takes_plain",
    "bias_broadcasts", "segments_equal_mask_bias", "bad_bias_key_dim",
    "bad_segment_shape", "kernel_takes_prefill_views",
    "kernel_refuses_what_it_lacks"])
def test_dispatcher(name):
    _dispatch_case(name)


def test_segment_mask_bias_matches_jax():
    sq = np.repeat([[1, 2]], 16, axis=1).astype(np.int32)
    sk = np.repeat([[1, 2, 2]], 16, axis=1).astype(np.int32)
    for args in [(sq,), (sq, sk)]:
        want = np.asarray(jflash.segment_mask_bias(
            *[jnp.asarray(a) for a in args]))
        got = tflash.segment_mask_bias(*[torch.from_numpy(a) for a in args])
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# what the bf16 tensor-core kernel adds, held on the CPU
# ---------------------------------------------------------------------------

def _rounded_p_attention(q, k, v, bias, segq, segk, scale, causal):
    """The bf16 tensor-core kernel's arithmetic in f32: the plain
    attention with P rounded to bf16 before the P V product, l summed from
    the unrounded probabilities, the output rounded to bf16."""
    s, vis = cflash._scores(q, k, bias, segq, segk, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(vis, torch.exp(s - m), torch.zeros(()))
    l = p.sum(dim=-1, keepdim=True).clamp_min(cflash.L_FLOOR)
    return (torch.matmul(p.bfloat16().float(), v) / l).bfloat16()


def _row_rel_err(out, ref):
    """Max over rows of the row's max-abs error over its max |ref|."""
    err = (out.float() - ref).abs().amax(dim=-1)
    return (err / ref.abs().amax(dim=-1).clamp_min(1e-30)).max().item()


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("name", CASES + ["long_key"])
def test_bf16_probability_rounding_within_row_tolerance(name, d):
    """The two roundings of the bf16 forward kernel (P to bf16 before
    P V, then the output) against the plain version in f32, row by row,
    on bf16-valued inputs of the feature cases and a 70 x 700 long-key
    case: within BF16_FWD_ROW_REL_TOLERANCE, the bound the kernel is held
    to on the card. Dead rows stay exactly 0."""
    if name == "long_key":
        q, k, v = _qkv(1, 2, 70, 700, d, 30)
        kw = {}
    else:
        q, k, v, _, kw = _case(name)
        q, k, v = _qkv(*q.shape[:3], k.shape[2], d, d + 5)
    q, k, v = (torch.from_numpy(x).bfloat16().float() for x in (q, k, v))
    bias = kw.get("bias")
    bias = None if bias is None else torch.from_numpy(bias)
    segq = segk = None
    if kw.get("segment_ids") is not None:
        seg = kw["segment_ids"]
        segq, segk = (torch.from_numpy(s)
                      for s in (seg if isinstance(seg, tuple) else (seg, seg)))
    causal = kw.get("causal", False)
    scale = 1.0 / math.sqrt(d)
    ref, _ = cflash.flash_attention_reference(q, k, v, bias, segq, segk,
                                              scale, causal)
    out = _rounded_p_attention(q, k, v, bias, segq, segk, scale, causal)
    rel = _row_rel_err(out, ref)
    assert 0 < rel <= cflash.BF16_FWD_ROW_REL_TOLERANCE
    # the output rounding alone stays inside the backward's tighter bound
    assert _row_rel_err(ref.bfloat16(), ref) <= cflash.BF16_ROW_REL_TOLERANCE


def test_tma_alignment_rule():
    """The tensor-core kernel's TMA rule, as the wrapper checks it: the
    prefill's transposed views pass; an odd storage offset or a stride
    that is not a multiple of 16 bytes does not, nor a broadcast (stride
    0) view."""
    b, t, h = 2, 24, 3
    for d in cflash.HEAD_DIMS:
        x = torch.zeros(b, t, h, d, dtype=torch.bfloat16)
        assert cflash.tma_aligned(x.transpose(1, 2))
        assert cflash.tma_aligned(x.permute(0, 2, 1, 3).contiguous())
        flat = torch.zeros(b * t * h * d + 1, dtype=torch.bfloat16)
        odd = flat[1:].view(b, t, h, d).transpose(1, 2)
        assert odd.storage_offset() == 1 and not cflash.tma_aligned(odd)
        padded = torch.zeros(b, h, t, d + 4, dtype=torch.bfloat16)[..., :d]
        assert not cflash.tma_aligned(padded)     # time stride (d + 4) x 2
        assert not cflash.tma_aligned(
            torch.zeros(1, h, t, d, dtype=torch.bfloat16).expand(b, h, t, d))
    # the same byte rule in f32: 16 bytes are 4 elements
    assert cflash.tma_aligned(torch.zeros(b, h, t, 36)[..., :32])


def test_kernel_wrapper_refuses_cpu_operands():
    """flash_attention_cuda still raises ValueError for CPU operands, in
    both dtypes and with views that would need the TMA copy, before it
    copies or builds anything."""
    q = torch.zeros(2, 3, 16, 64, dtype=torch.bfloat16)
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)
    odd = flat[1:].view(q.shape)
    before = cflash.LAUNCHES, cflash.TC_LAUNCHES
    for args in [(q, q, q), (q.float(),) * 3, (odd, odd, odd)]:
        with pytest.raises(ValueError, match="CUDA tensor"):
            cflash.flash_attention_cuda(*args, causal=True)
    assert (cflash.LAUNCHES, cflash.TC_LAUNCHES) == before


# ---------------------------------------------------------------------------
# the numerical design of the f32 forward kernel, emulated on the CPU
# ---------------------------------------------------------------------------
#
# On the card flash_fwd_kernel computes S = Q K^T and each key tile's P V
# on the tensor cores as three TF32 passes, big.big' + big.small' +
# small.big' (``mm3`` of tests/test_torch_flash_bwd.py, with P split too),
# under an online softmax over the key tiles (64 keys, 32 at D 128): each
# tile's P V is summed on its own and folded into the output as
# acc alpha + tile. These tests push the plain forward through the same
# roundings and tiling and hold it to the unchanged f32 tolerance, the
# measure the card uses. Nothing on the path uses this emulation.

def _emulated_fwd(q, k, v, bias, causal, passes=3):
    """(out, lse) of the f32 kernel's arithmetic in f32."""
    d = q.shape[-1]
    tile = 32 if d == 128 else 64
    s = mm3(q, k.transpose(-1, -2), passes) * (1.0 / math.sqrt(d))
    if bias is not None:
        s = s + bias
    vis = cflash._visible_mask(q.shape[2], k.shape[2], causal)
    s = torch.where(vis, s, torch.tensor(cflash.NEG_INF))
    m = torch.full(q.shape[:3], cflash.NEG_INF)
    l = torch.zeros(q.shape[:3])
    acc = torch.zeros(q.shape)
    for k0 in range(0, k.shape[2], tile):
        st, vt = s[..., k0:k0 + tile], vis[..., k0:k0 + tile]
        mx = torch.maximum(m, st.amax(dim=-1))
        alpha = torch.exp(m - mx)
        p = torch.where(vt, torch.exp(st - mx[..., None]), torch.zeros(()))
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + mm3(p, v[..., k0:k0 + tile, :],
                                           passes)
        m = mx
    lf = l.clamp_min(cflash.L_FLOOR)
    return acc / lf[..., None], m + torch.log(lf)


# (B, H, Tq, Tk, causal, bias): a causal square, a cross length under
# causal, a per-query bias, and a long key run (64 and 128 tiles)
FWD_TF32_CASES = {"causal": (1, 2, 256, 256, True, False),
                  "cross_len": (1, 2, 96, 160, True, False),
                  "bias_query": (2, 2, 128, 128, False, True),
                  "long_key": (1, 1, 256, 4096, False, False)}


def _fwd_case(name, d, seed=80):
    b, h, tq, tk, causal, bias = FWD_TF32_CASES[name]
    q, k, v = (torch.from_numpy(a) for a in _qkv(b, h, tq, tk, d, seed))
    bt = torch.from_numpy(_rand((b, 1, tq, tk), seed + 3)) if bias else None
    return q, k, v, bt, causal


def _fwd_err(got, ref):
    """The card's measure on out and lse: max |x - ref| / max(1, |ref|)."""
    return [((x - r).abs() / r.abs().clamp_min(1.0)).max().item()
            for x, r in zip(got, ref)]


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("name", sorted(FWD_TF32_CASES))
def test_forward_three_tf32_passes_hold_the_f32_tolerance(name, d):
    """out and lse through the three-pass products, tile by tile, stay
    within the f32 forward's tolerance of the plain version."""
    q, k, v, bt, causal = _fwd_case(name, d)
    got = _emulated_fwd(q, k, v, bt, causal)
    ref = cflash.flash_attention_reference(q, k, v, bt, None, None, None,
                                           causal)
    err, lerr = _fwd_err(got, ref)
    assert err <= cflash.TOLERANCE[torch.float32]
    assert lerr <= cflash.TOLERANCE[torch.float32]


def test_forward_one_tf32_pass_misses_the_f32_tolerance():
    """Why three passes: one TF32 pass (big.big') of both products is far
    outside the f32 tolerance on out."""
    q, k, v, bt, causal = _fwd_case("causal", 64)
    got = _emulated_fwd(q, k, v, bt, causal, passes=1)
    ref = cflash.flash_attention_reference(q, k, v, bt, None, None, None,
                                           causal)
    err, _ = _fwd_err(got, ref)
    assert err > 10 * cflash.TOLERANCE[torch.float32]


def test_f32_forward_operands_copy_only_views_that_break_the_16_byte_rule():
    """The f32 kernel's cp.async copies take the training step's
    transposed views as they are; a view at an odd element offset is
    copied into a contiguous tensor of the same values. The f32 kernel
    reads a bias at its strides, so a key-strided one is kept."""
    x = torch.from_numpy(_rand((2, 24, 3, 64), 81))
    view = x.transpose(1, 2)
    bias = torch.from_numpy(_rand((2, 3, 24, 24), 82)).transpose(-1, -2)
    assert cflash.tma_aligned(view)
    got = cflash._fwd_operands(view, view, view, bias)
    assert all(t is view for t in got[:3]) and got[3] is bias
    flat = torch.empty(x.numel() + 1)
    odd = flat[1:].view(2, 3, 24, 64)
    odd.copy_(view)
    assert not cflash.tma_aligned(odd)
    for t in cflash._fwd_operands(odd, odd, odd, None)[:3]:
        assert t.is_contiguous() and cflash.tma_aligned(t)
        assert torch.equal(t, view)
