"""Flash attention: the port of ``paddle_tpu/ops/pallas/flash.py``'s
public functions, differentiable.

``flash_attention`` and ``flash_attention_with_lse`` canonicalize the
bias and segment ids as the JAX functions do, then go through one
``torch.autograd.Function`` (the counterpart of JAX's ``custom_vjp``
``_flash``, ``flash.py:971-1005``). Its forward sends CUDA tensors to the
hand-written forward kernel (``ops/cuda/flash.py``, which raises on
operands it does not take) and CPU tensors to its plain version; it saves
q, k, v, the bias, the segment ids, out and lse. Its backward takes the
cotangents of both out and lse, as ``_flash_vjp_bwd`` does (the lse's
folds into delta), and sends CUDA tensors to the backward kernels (dQ,
then dK/dV) and CPU tensors to their plain version. The bias gets a
gradient only when it requires one (``flash_dbias``, plain torch); the
segment ids get none. Nothing else chooses between kernel and plain
version.

The TPU's tiling knobs are not ported: the kernels pick their own tiles,
so there is no ``block_q``/``block_k`` argument, no ``default_blocks``,
no ``PADDLE_TPU_FLASH_BLOCK_Q/K``, no tuned-blocks file and no
``PT_FLASH_KGRID`` (one kernel pair streams K/V or Q/dO at every
length).
"""

import torch

from .cuda.flash import (NEG_INF, flash_attention_bwd_cuda,
                         flash_attention_bwd_reference, flash_attention_cuda,
                         flash_attention_reference, flash_dbias)

__all__ = ["flash_attention", "flash_attention_with_lse",
           "segment_mask_bias", "NEG_INF"]


def _canonical_bias(bias, b, h, tq, tk):
    """Bias broadcastable to (B, H, Tq, Tk) -> a 4-D view whose dims are
    each 1 or full (B|1, H|1, Tq|1, Tk): a key dim of 1 broadcasts to Tk,
    and any other mismatch broadcasts to the full shape."""
    bias = torch.as_tensor(bias)
    while bias.dim() < 4:
        bias = bias[None]
    bb, hb, tqb, tkb = bias.shape
    if tkb == 1:
        bias = bias.expand(bb, hb, tqb, tk)
    elif tkb != tk:
        raise ValueError(f"bias key dim {tkb} != {tk}")
    if bb not in (1, b) or hb not in (1, h) or tqb not in (1, tq):
        bias = bias.expand(b, h, tq, tk)
    return bias


def segment_mask_bias(segment_ids_q, segment_ids_k=None):
    """Additive attention bias (B, 1, Tq, Tk) f32 that blocks
    cross-segment attention: 0 inside a segment, NEG_INF across."""
    sq = torch.as_tensor(segment_ids_q)
    sk = sq if segment_ids_k is None else torch.as_tensor(segment_ids_k)
    same = sq[:, None, :, None] == sk[:, None, None, :]
    return torch.where(same, 0.0, NEG_INF).to(torch.float32)


def _canonical_seg(segment_ids, b, tq, tk, device):
    """segment_ids -> (segq (B, Tq), segk (B, Tk)) contiguous int32 on
    `device`. Accepts one (B, T) array (self-attention) or a
    (seg_q, seg_k) pair (cross-attention over a packed memory)."""
    if segment_ids is None:
        return None, None
    if isinstance(segment_ids, (tuple, list)):
        sq, sk = segment_ids
    else:
        sq = sk = segment_ids
    sq = torch.as_tensor(sq, device=device).to(torch.int32).contiguous()
    sk = torch.as_tensor(sk, device=device).to(torch.int32).contiguous()
    if tuple(sq.shape) != (b, tq) or tuple(sk.shape) != (b, tk):
        raise ValueError(
            f"segment_ids shapes {tuple(sq.shape)}/{tuple(sk.shape)} do "
            f"not match attention (B={b}, Tq={tq}, Tk={tk})")
    return sq, sk


def flash_attention(q, k, v, bias=None, scale=None, causal=False,
                    segment_ids=None):
    """Fused blockwise attention. q (B, H, Tq, D), k/v (B, H, Tk, D); an
    additive bias broadcastable to (B, H, Tq, Tk) is applied inside the
    kernel; segment_ids (B, T) int (or a (seg_q, seg_k) pair) confine
    attention to equal ids; causal is aligned bottom-right. Returns out
    (B, H, Tq, D) in q's dtype."""
    return flash_attention_with_lse(q, k, v, bias=bias, scale=scale,
                                    causal=causal,
                                    segment_ids=segment_ids)[0]


class _Flash(torch.autograd.Function):
    """Differentiable (out, lse) of the flash kernels or their plain
    versions, chosen by the tensors' device."""

    @staticmethod
    def forward(ctx, q, k, v, bias, segq, segk, scale, causal):
        fwd = flash_attention_cuda if q.is_cuda else flash_attention_reference
        out, lse = fwd(q, k, v, bias, segq, segk, scale, causal)
        ctx.save_for_backward(q, k, v, bias, segq, segk, out, lse)
        ctx.scale, ctx.causal = scale, causal
        # an unused output's cotangent arrives as None, not as zeros
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, bias, segq, segk, out, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(out)
        bwd = (flash_attention_bwd_cuda if q.is_cuda
               else flash_attention_bwd_reference)
        dq, dk, dv, delta = bwd(q, k, v, bias, segq, segk, out, lse, do,
                                dlse, ctx.scale, ctx.causal)
        db = None
        if bias is not None and ctx.needs_input_grad[3]:
            db = flash_dbias(q, k, v, bias, lse, do, delta, ctx.scale,
                             ctx.causal, segq, segk)
        return dq, dk, dv, db, None, None, None, None


def flash_attention_with_lse(q, k, v, bias=None, scale=None, causal=False,
                             segment_ids=None):
    """flash_attention returning (out, logsumexp (B, H, Tq) f32), both
    differentiable (the lse's cotangent enters the backward through
    delta). CUDA tensors launch the kernels, CPU tensors take the plain
    versions."""
    d = q.shape[-1]
    scale = float(scale) if scale is not None else 1.0 / (d ** 0.5)
    b, h, tq = q.shape[:3]
    tk = k.shape[2]
    segq, segk = _canonical_seg(segment_ids, b, tq, tk, q.device)
    if bias is not None:
        bias = _canonical_bias(torch.as_tensor(bias, device=q.device), b, h,
                               tq, tk)
    return _Flash.apply(q, k, v, bias, segq, segk, scale, bool(causal))
