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
