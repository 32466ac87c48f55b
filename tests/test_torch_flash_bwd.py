"""The port's flash-attention backward against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through ``jax.grad`` of JAX's
``flash_attention_with_lse`` (its ``custom_vjp`` backward runs the Pallas
kernels in interpret mode off the TPU: ``_dq_kernel`` / ``_dkv_kernel``
with ``PT_FLASH_KGRID=0`` and ``_dq_kernel_kgrid`` / ``_dkv_kernel_kgrid``
with ``PT_FLASH_KGRID=1``, set in the test's own environment) and through
the port's ``flash_attention_with_lse``, whose ``torch.autograd.Function``
takes the plain backward for CPU tensors. The loss weights out (and, where
the case says so, lse) with seeded numpy weights, so that both cotangents
are dense and the lse's reaches delta. dq, dk, dv and, where the bias
requires grad, dbias are compared in f32 to ``ATOL``/``RTOL`` = 1e-4: the
two differ in summation order only, over sums of up to Tk (dq) or Tq (dk,
dv, dbias) products.

Cases: causal and not, Tq != Tk, lengths off the tile grid, key-only,
per-head and full (per-query) bias with its gradient, bias under causal,
segment ids alone, composed with a bias, the cross (seg_q, seg_k) pair and
tiles skipped whole, the lse cotangent, and causal rows with no visible
key, whose gradients are exactly 0. ``torch.autograd.gradcheck`` holds the
plain backward in float64 at a tiny shape.

JAX takes block sizes; the port does not (its kernels pick their tiles),
so the JAX side is given the blocks its own test uses.
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

ATOL = RTOL = 1e-4


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


def _grads(q, k, v, block, kgrid, monkeypatch, bias=None, causal=False,
           segment_ids=None, with_lse=False):
    """(JAX grads, port grads): lists of numpy dq, dk, dv (and dbias when
    there is a bias) of sum(out * wo) (+ sum(lse * wl))."""
    monkeypatch.setenv("PT_FLASH_KGRID", kgrid)
    scale = 1.0 / math.sqrt(q.shape[-1])
    wo = _rand(q.shape, 90)
    wl = _rand(q.shape[:3], 91) if with_lse else np.zeros(q.shape[:3],
                                                          np.float32)
    seg_j = _seg(segment_ids, jnp.asarray)

    def jloss(q_, k_, v_, b_):
        o, l = jflash.flash_attention_with_lse(
            q_, k_, v_, bias=b_, scale=scale, causal=causal, block_q=block,
            block_k=block, segment_ids=seg_j)
        return jnp.sum(o * wo) + jnp.sum(l * wl)

    args = [jnp.asarray(a) for a in (q, k, v)]
    argnums = (0, 1, 2)
    if bias is not None:
        args.append(jnp.asarray(bias))
        argnums = (0, 1, 2, 3)
    else:
        args.append(None)
    jg = [np.asarray(g) for g in jax.grad(jloss, argnums=argnums)(*args)]

    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    tb = (None if bias is None
          else torch.from_numpy(bias).requires_grad_(True))
    o, l = tflash.flash_attention_with_lse(
        *ts, bias=tb, scale=scale, causal=causal,
        segment_ids=_seg(segment_ids, torch.from_numpy))
    loss = (o * torch.from_numpy(wo)).sum()
    if with_lse:
        loss = loss + (l * torch.from_numpy(wl)).sum()
    loss.backward()
    tg = [t.grad.numpy() for t in ts + ([tb] if tb is not None else [])]
    return jg, tg


def _close(jg, tg):
    assert len(jg) == len(tg)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), jg, tg):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(b, a, atol=ATOL, rtol=RTOL, err_msg=name)


def _seg_rows():
    seg = np.zeros((2, 64), np.int32)
    seg[0, :30] = 1
    seg[0, 30:50] = 2          # 14 pad slots, id 0
    seg[1, :7] = 1             # boundaries off the tile grid
    seg[1, 7:] = 2
    return seg


def _case(name):
    """(q, k, v, block, kwargs) of one case."""
    if name.startswith("plain"):
        _, causal, tq, tk = name.split("_")
        q, k, v = _qkv(1, 2, int(tq), int(tk), 16, 0)
        return q, k, v, 16, dict(causal=causal == "causal")
    if name.startswith("ragged"):
        # lengths off every tile grid (not multiples of 16)
        _, causal = name.split("_")
        q, k, v = _qkv(1, 2, 37, 53, 32, 3)
        return q, k, v, 16, dict(causal=causal == "causal")
    if name == "lse_cotangent":
        q, k, v = _qkv(1, 2, 32, 48, 16, 4)
        return q, k, v, 16, dict(causal=True, with_lse=True)
    if name == "bias_causal":
        q, k, v = _qkv(1, 2, 32, 32, 16, 1)
        return q, k, v, 16, dict(bias=_rand((1, 1, 1, 32), 3), causal=True)
    if name.startswith("bias"):
        shape = {"keyonly": (2, 1, 1, 32), "perhead": (1, 2, 24, 32),
                 "full": (2, 2, 24, 32)}[name.split("_")[1]]
        q, k, v = _qkv(2, 2, 24, 32, 16, 0)
        bias = _rand(shape, 7) * 2.0
        if shape[2] == 1:
            bias[0, :, :, 16:] = -1e9           # padding mask, batch row 0
        return q, k, v, 16, dict(bias=bias)
    if name.startswith("seg_self"):
        q, k, v = _qkv(2, 1, 64, 64, 16, 3)
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


CASES = ["plain_full_32_32", "plain_causal_32_32", "plain_full_24_40",
         "plain_causal_24_40", "ragged_full", "ragged_causal",
         "lse_cotangent", "bias_keyonly", "bias_perhead", "bias_full",
         "bias_causal", "seg_self_full", "seg_self_causal", "seg_bias",
         "seg_cross", "seg_skip_causal"]


@pytest.mark.parametrize("kgrid", ["0", "1"])
@pytest.mark.parametrize("name", CASES)
def test_plain_backward_matches_jax_kernels(name, kgrid, monkeypatch):
    q, k, v, block, kw = _case(name)
    _close(*_grads(q, k, v, block, kgrid, monkeypatch, **kw))


@pytest.mark.parametrize("kgrid", ["0", "1"])
def test_rows_with_no_visible_key_get_zero_gradients(kgrid, monkeypatch):
    """Causal with Tq > Tk: rows i < Tq - Tk see no key. Their dq is
    exactly 0 and they add nothing to dk/dv, on both sides (JAX with the
    dead rows in tiles of their own), even with an lse cotangent on them;
    every other gradient matches."""
    b, h, tq, tk, d = 1, 2, 16, 8, 8
    q, k, v = _qkv(b, h, tq, tk, d, 20)
    jg, tg = _grads(q, k, v, 8, kgrid, monkeypatch, causal=True,
                    with_lse=True)
    dead = tq - tk
    assert not tg[0][:, :, :dead].any() and not jg[0][:, :, :dead].any()
    _close(jg, tg)
    # the dead rows' own inputs change nothing else
    q2 = q.copy()
    q2[:, :, :dead] = _rand(q2[:, :, :dead].shape, 5)
    _, tg2 = _grads(q2, k, v, 8, kgrid, monkeypatch, causal=True,
                    with_lse=True)
    for a, b_ in zip(tg[1:], tg2[1:]):
        np.testing.assert_array_equal(a, b_)


def test_gradcheck_plain_backward_float64():
    """torch.autograd.gradcheck of the Function's plain backward (both
    outputs, so the lse cotangent too) in float64, with a per-query bias,
    causal masking over Tq != Tk and a segment pair."""
    gen = torch.Generator().manual_seed(0)

    def mk(*shape):
        return torch.randn(*shape, generator=gen,
                           dtype=torch.float64).requires_grad_(True)

    b, h, tq, tk, d = 1, 2, 5, 7, 4
    q, k, v, bias = mk(b, h, tq, d), mk(b, h, tk, d), mk(b, h, tk, d), \
        mk(b, 1, tq, tk)
    segs = (torch.tensor([[1, 2, 2, 2, 2]]),
            torch.tensor([[1, 1, 2, 2, 2, 2, 2]]))

    def fn(q_, k_, v_, b_):
        return tflash.flash_attention_with_lse(q_, k_, v_, bias=b_,
                                               causal=True,
                                               segment_ids=segs)

    assert torch.autograd.gradcheck(fn, (q, k, v, bias))


def test_function_backward_equals_plain_backward():
    """The Function's CPU backward is flash_attention_bwd_reference, and
    the segment ids and a bias that does not require grad get none."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _qkv(1, 2, 24, 24, 16, 30))
    bias = torch.from_numpy(_rand((1, 1, 1, 24), 31))
    seg = torch.from_numpy(np.repeat([[1, 2]], 12, axis=1).astype(np.int32))
    do = torch.from_numpy(_rand((1, 2, 24, 16), 32))
    out, lse = tflash.flash_attention_with_lse(q, k, v, bias=bias,
                                               causal=True, segment_ids=seg)
    (out * do).sum().backward()
    segc = seg.contiguous()
    want = cflash.flash_attention_bwd_reference(
        q.detach(), k.detach(), v.detach(), bias.expand(1, 1, 1, 24), segc,
        segc, out.detach(), lse.detach(), do, None, None, True)
    for got, ref in zip((q.grad, k.grad, v.grad), want[:3]):
        assert torch.equal(got, ref)
    assert bias.grad is None


# ---------------------------------------------------------------------------
# the numerical design of the backward kernels, emulated on the CPU
# ---------------------------------------------------------------------------
#
# On the card the f32 kernels compute every product on the tensor cores as
# three TF32 passes, big.big' + big.small' + small.big', with big the
# operand rounded to TF32 (round to nearest, ties away: cvt.rna.tf32.f32)
# and small the remainder rounded the same way; the bf16 kernels carry P
# and dS into their second products as bf16 hi + lo. These tests push the
# plain backward's products through the same roundings (each partial of
# two TF32 values is exact in f32, so an f32 matmul on the CPU computes it
# as the tensor cores do, up to summation order) and hold the results to
# the unchanged tolerances. Nothing on the path uses this emulation.


def tf32_round(x):
    """x (f32) rounded to TF32's 10-bit mantissa, to nearest with ties away
    from zero, by integer operations on its bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm3(a, b, passes=3):
    """a @ b as the kernels' tensor-core products: three TF32 passes (or
    one, big.big', for comparison)."""
    ab, bb = tf32_round(a), tf32_round(b)
    if passes == 1:
        return torch.matmul(ab, bb)
    a_s, b_s = tf32_round(a - ab), tf32_round(b - bb)
    return (torch.matmul(a_s, bb) + torch.matmul(ab, b_s)) \
        + torch.matmul(ab, bb)


def _emulated_bwd(q, k, v, bias, out, lse, do, causal, passes=3):
    """The plain backward with its five products as the f32 kernels compute
    them (S and dP as the dQ and dK/dV kernels both do)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    delta = cflash._delta(out, do, None)
    s = mm3(q, k.transpose(-1, -2), passes) * scale
    if bias is not None:
        s = s + bias
    vis = cflash._visible_mask(q.shape[2], k.shape[2], causal)
    s = torch.where(vis, s, torch.tensor(cflash.NEG_INF))
    p = cflash._probs(s, vis, lse)
    ds = p * (mm3(do, v.transpose(-1, -2), passes) - delta[..., None])
    dq = mm3(ds, k, passes) * scale
    dk = mm3(ds.transpose(-1, -2), q, passes) * scale
    dv = mm3(p.transpose(-1, -2), do, passes)
    return dq, dk, dv


def _bwd_inputs(b, h, tq, tk, d, seed, bias=False, causal=True):
    q, k, v = (torch.from_numpy(a) for a in _qkv(b, h, tq, tk, d, seed))
    bt = torch.from_numpy(_rand((b, 1, tq, tk), seed + 3)) if bias else None
    out, lse = cflash.flash_attention_reference(q, k, v, bt, None, None,
                                                None, causal)
    do = torch.from_numpy(_rand((b, h, tq, d), seed + 4))
    return q, k, v, bt, out, lse, do


def _kernel_err(got, ref):
    """The card's measure: max |x - ref| / max(1, |ref|)."""
    return max(((x - r).abs() / r.abs().clamp_min(1.0)).max().item()
               for x, r in zip(got, ref))


TF32_CASES = {"causal": (1, 2, 128, 128, 64, False),
              "bias_query_causal": (1, 2, 96, 160, 64, True),
              "d128_t1024": (1, 1, 1024, 1024, 128, False)}


def test_tf32_round_is_nearest_ties_away():
    x = torch.from_numpy(_rand((4096,), 40)) * 100
    r = tf32_round(x)
    assert not (r.view(torch.int32) & 0x1FFF).any()
    assert ((x - r).abs() <= x.abs() * 2.0 ** -11).all()
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12])
    assert tf32_round(tie).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10),
                                        1.0]


@pytest.mark.parametrize("name", sorted(TF32_CASES))
def test_three_tf32_passes_hold_the_f32_tolerance(name):
    """dq, dk, dv through the three-pass products stay within the kernels'
    f32 tolerance of the plain backward."""
    b, h, tq, tk, d, bias = TF32_CASES[name]
    q, k, v, bt, out, lse, do = _bwd_inputs(b, h, tq, tk, d, 50, bias)
    got = _emulated_bwd(q, k, v, bt, out, lse, do, True)
    ref = cflash.flash_attention_bwd_reference(q, k, v, bt, None, None, out,
                                               lse, do, None, None, True)
    assert _kernel_err(got, ref[:3]) <= cflash.BWD_TOLERANCE[torch.float32]


def test_one_tf32_pass_misses_the_f32_tolerance():
    """Why three passes: one TF32 pass (big.big') of the same products
    is far outside the f32 tolerance."""
    q, k, v, bt, out, lse, do = _bwd_inputs(1, 2, 128, 128, 64, 50)
    got = _emulated_bwd(q, k, v, bt, out, lse, do, True, passes=1)
    ref = cflash.flash_attention_bwd_reference(q, k, v, bt, None, None, out,
                                               lse, do, None, None, True)
    assert _kernel_err(got, ref[:3]) > 10 * cflash.BWD_TOLERANCE[
        torch.float32]


def _row_rel(x, ref):
    err = (x.float() - ref).abs().amax(dim=-1)
    return (err / ref.abs().amax(dim=-1).clamp_min(1e-30)).max().item()


def test_bf16_hi_lo_probabilities_hold_the_row_bound():
    """The bf16 kernels' second products (dV = P^T dO, dK = dS^T Q,
    dQ = dS K) over bf16 inputs: with P and dS as bf16 hi + lo the outputs
    stay within BF16_ROW_REL_TOLERANCE of the plain version in f32 (only
    their own bf16 rounding is left); P and dS rounded once to bf16 add
    their error on top of it."""
    bf = torch.bfloat16
    q, k, v, _, _, _, do = (t if t is None else t.to(bf).float()
                            for t in _bwd_inputs(1, 4, 512, 512, 64, 60))
    out, lse = cflash.flash_attention_reference(q, k, v, None, None, None,
                                                None, True)
    out = out.to(bf).float()
    ref = cflash.flash_attention_bwd_reference(q, k, v, None, None, None,
                                               out, lse, do, None, None,
                                               True)[:3]
    scale = 1.0 / math.sqrt(64)
    s, vis = cflash._scores(q, k, None, None, None, scale, True)
    p = cflash._probs(s, vis, lse)
    ds = p * (do @ v.transpose(-1, -2) - cflash._delta(out, do, None)[
        ..., None])

    def second(p_, ds_):
        return tuple(x.to(bf) for x in (
            ds_ @ k * scale, ds_.transpose(-1, -2) @ q * scale,
            p_.transpose(-1, -2) @ do))

    def hi_lo(x):
        hi = x.to(bf).float()
        return hi + (x - hi).to(bf).float()

    two = max(_row_rel(x, r) for x, r in zip(second(hi_lo(p), hi_lo(ds)),
                                             ref))
    one = max(_row_rel(x, r) for x, r in zip(
        second(p.to(bf).float(), ds.to(bf).float()), ref))
    assert two <= cflash.BF16_ROW_REL_TOLERANCE
    assert one > two


def test_bwd_wrapper_refuses_cpu_tensors():
    """The kernel wrapper takes CUDA tensors only: CPU operands raise
    before anything is built (the Function sends them to the plain
    version instead)."""
    q, k, v, _, out, lse, do = _bwd_inputs(1, 2, 16, 16, 32, 70)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cflash.flash_attention_bwd_cuda(q, k, v, None, None, None, out, lse,
                                        do, None, None, True)


def test_aligned_copies_only_views_that_break_the_16_byte_rule():
    """The training step's transposed views keep their storage; a view at
    an odd element offset is copied into a contiguous tensor of the same
    values, so the kernels' 16-byte copies may read it."""
    x = torch.from_numpy(_rand((2, 24, 3, 64), 71))
    view = x.transpose(1, 2)
    assert cflash.tma_aligned(view) and cflash._aligned(view) is view
    flat = torch.empty(x.numel() + 1)
    odd = flat[1:].view(2, 3, 24, 64)
    odd.copy_(view)
    assert not cflash.tma_aligned(odd)
    got = cflash._aligned(odd)
    assert got.is_contiguous() and cflash.tma_aligned(got)
    assert torch.equal(got, view)
