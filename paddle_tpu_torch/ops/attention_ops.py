"""Attention ops.

Parity: the reference composes attention from matmul/softmax primitives;
the counterpart of ``paddle_tpu/ops/attention_ops.py``, where attention is
a first-class op so the executor can route it to a fused kernel.
``dot_product_attention`` sends CUDA tensors to the flash kernels
(``ops/flash.py``: the hand-written forward and backward, whose wrappers
launch or raise) and CPU tensors to ``_xla_attention``, the plain dense
path that the JAX package takes off the TPU. Nothing else chooses.

Not ported: the JAX dispatcher's switches ``PADDLE_TPU_FORCE_FLASH``,
``PADDLE_TPU_DISABLE_FLASH`` and ``PADDLE_TPU_STRICT_FLASH``, and its
warn-and-fall-back ``try`` around the flash call; the sequence-parallel
ring branch (``_active_sp_mesh``) waits for the long-context slice, and
without a mesh it never applies.
"""

import torch

from . import register
from .flash import flash_attention, segment_mask_bias


def _xla_attention(q, k, v, bias=None, scale=None, causal=False):
    """Plain dense attention over (B, H, T, D) q/k/v, as the JAX package's
    reference path: scores in q's dtype, the causal mask at -1e9, the
    softmax in f32 and cast back to q's dtype before PV."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias
    if causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((tq, tk), dtype=torch.bool,
                          device=q.device).tril(diagonal=tk - tq)
        logits = torch.where(mask, logits, torch.tensor(
            -1e9, dtype=logits.dtype, device=q.device))
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def dot_product_attention(q, k, v, bias=None, scale=None, causal=False,
                          segment_ids=None):
    """q (B, H, Tq, D), k/v (B, H, Tk, D) -> (B, H, Tq, D). CUDA tensors:
    the flash kernels (segment ids compared blockwise inside them). CPU
    tensors: ``_xla_attention``, with the segment ids as an additive mask
    bias."""
    if q.is_cuda:
        return flash_attention(q, k, v, bias=bias, scale=scale,
                               causal=causal, segment_ids=segment_ids)
    if segment_ids is not None:
        seg_b = (segment_mask_bias(*segment_ids)
                 if isinstance(segment_ids, (tuple, list))
                 else segment_mask_bias(segment_ids))
        bias = seg_b if bias is None else bias + seg_b
    return _xla_attention(q, k, v, bias=bias, scale=scale, causal=causal)


@register("scaled_dot_product_attention")
def scaled_dot_product_attention_op(ctx):
    """Q/K/V: (B, H, T, D). Optional Bias broadcastable to (B, H, Tq, Tk);
    optional SegmentIds (B, T) for packed-sequence attention."""
    out = dot_product_attention(
        ctx.in_("Q"), ctx.in_("K"), ctx.in_("V"), bias=ctx.in_("Bias"),
        scale=ctx.attr("scale"), causal=bool(ctx.attr("causal", False)),
        segment_ids=ctx.in_("SegmentIds"))
    return {"Out": out}


@register("multihead_attention")
def multihead_attention_op(ctx):
    """Fused projections + attention. Inputs: Query (B, Tq, M),
    Key/Value (B, Tk, M), packed weights WQ/WK/WV (M, M), WO (M, M),
    optional biases and attention Bias. num_heads attr splits M; the heads
    reach the attention as (B, H, T, D) views of the projections, whose
    strides the flash kernels take."""
    q_in = ctx.in_("Query")
    k_in = ctx.in_("Key")
    v_in = ctx.in_("Value")
    k_in = q_in if k_in is None else k_in
    v_in = k_in if v_in is None else v_in
    n_heads = ctx.attr("num_heads")

    def proj(x, w, b):
        y = x @ w
        return y if b is None else y + b

    def split_heads(x):
        b_, t, m = x.shape
        return x.reshape(b_, t, n_heads, m // n_heads).transpose(1, 2)

    q = split_heads(proj(q_in, ctx.in_("WQ"), ctx.in_("BQ")))
    k = split_heads(proj(k_in, ctx.in_("WK"), ctx.in_("BK")))
    v = split_heads(proj(v_in, ctx.in_("WV"), ctx.in_("BV")))
    o = dot_product_attention(q, k, v, bias=ctx.in_("Bias"),
                              causal=bool(ctx.attr("causal", False)),
                              segment_ids=ctx.in_("SegmentIds"))
    b_, h, t, d = o.shape
    o = o.transpose(1, 2).reshape(b_, t, h * d)
    return {"Out": proj(o, ctx.in_("WO"), ctx.in_("BO"))}
