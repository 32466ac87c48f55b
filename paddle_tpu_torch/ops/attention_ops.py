"""Attention ops.

Parity: the reference composes attention from matmul/softmax primitives;
the counterpart of ``paddle_tpu/ops/attention_ops.py``, where attention is
a first-class op so the executor can route it to a fused kernel.
``dot_product_attention`` sends the call to ring attention over the
``sp`` axis when a sequence-parallel mesh is active (``with mesh:``,
``_active_sp_mesh``); otherwise CUDA tensors to the flash kernels
(``ops/flash.py``: the hand-written forward and backward, whose wrappers
launch or raise) and CPU tensors to ``_xla_attention``, the plain dense
path that the JAX package takes off the TPU. The ring's steps run the
same flash kernels, or on CPU tensors their plain versions. Nothing else
chooses.

Not ported: the JAX dispatcher's switches ``PADDLE_TPU_FORCE_FLASH``,
``PADDLE_TPU_DISABLE_FLASH``, ``PADDLE_TPU_STRICT_FLASH`` and
``PADDLE_TPU_DISABLE_RING``, and its warn-and-fall-back ``try`` around
the flash call.
"""

import warnings

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


_ring_seg_warned = False


def _active_sp_mesh(q, k, bias):
    """The active mesh (``with mesh:``), when sequence parallelism
    applies: its 'sp' axis > 1, BOTH time axes divide it (cross-attention
    has Tq != Tk), the bias (if any) is a 4-D key-side bias, and dp/tp
    divide the batch and head dims: the shapes ring attention can
    decompose. Anything else returns None, never raises."""
    from ..parallel.mesh import active_mesh
    mesh = active_mesh()
    if mesh is None or mesh.empty:
        return None
    sp = mesh.shape["sp"]
    if sp <= 1 or q.shape[2] % sp != 0 or k.shape[2] % sp != 0:
        return None
    if bias is not None and (bias.ndim != 4 or bias.shape[2] != 1
                             or bias.shape[3] != k.shape[2]):
        return None                      # per-query / odd-rank bias
    for name, dim in (("dp", q.shape[0]), ("tp", q.shape[1])):
        if dim % mesh.shape[name] != 0:
            return None
    return mesh


def dot_product_attention(q, k, v, bias=None, scale=None, causal=False,
                          segment_ids=None):
    """q (B, H, Tq, D), k/v (B, H, Tk, D) -> (B, H, Tq, D). Under an
    active sequence-parallel mesh: ring attention over 'sp' (K/V and the
    key-side bias rotate; O(T/sp) a rank). Else CUDA tensors: the flash
    kernels (segment ids compared blockwise inside them); CPU tensors:
    ``_xla_attention``, with the segment ids as an additive mask bias.
    The ring cannot rotate a per-query mask: packed inputs take the dense
    paths, with a one-time warning."""
    global _ring_seg_warned
    sp_mesh = _active_sp_mesh(q, k, bias)
    if segment_ids is not None and sp_mesh is not None:
        if not _ring_seg_warned:
            warnings.warn(
                "packed (segment_ids) attention cannot ride the 'sp' ring "
                "path — the per-query segment mask does not rotate; taking "
                "the dense flash path, so K/V are full-length per rank. "
                "Unpack or drop the sp axis for long-context training.",
                RuntimeWarning, stacklevel=2)
            _ring_seg_warned = True
        sp_mesh = None
    if sp_mesh is not None:
        from ..parallel.ring_attention import ring_attention_sharded
        return ring_attention_sharded(q, k, v, sp_mesh, causal=causal,
                                      scale=scale, bias=bias)
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
