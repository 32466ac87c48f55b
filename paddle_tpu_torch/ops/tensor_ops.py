"""Tensor manipulation ops.

Parity: paddle/fluid/operators/{cast,fill_constant,reshape,transpose,slice,
lookup_table,gather,top_k}_op.cc; the counterpart of
``paddle_tpu/ops/tensor_ops.py`` with the ops the ported slices run.
``transpose2`` is here because the ``scaled_dot_product_attention`` layer
splits heads with it; ``gather`` picks BERT's masked rows (its gradient
is torch's scatter-add, ``index_add``), ``top_k`` feeds ``accuracy``.
"""

import torch
import torch.nn.functional as F

from . import register, torch_dtype


@register("cast")
def cast(ctx):
    return {"Out": ctx.in_("X").to(torch_dtype(ctx.attr("out_dtype")))}


@register("zeros_like", "fill_zeros_like", "fill_zeros_like2")
def zeros_like(ctx):
    return {"Out": torch.zeros_like(ctx.in_("X"))}


@register("fill_constant")
def fill_constant(ctx):
    shape = ctx.attr("shape", [1])
    value = ctx.attr("value", 0.0)
    dtype = torch_dtype(ctx.attr("dtype", "float32"))
    return {"Out": torch.full(tuple(shape), value, dtype=dtype,
                              device=ctx.device)}


@register("reshape", "reshape2")
def reshape(ctx):
    x = ctx.in_("X")
    shape = list(ctx.attr("shape"))
    # fluid: 0 means copy input dim; -1 inferred.
    shape = [x.shape[i] if s == 0 else s
             for i, s in enumerate(shape[:x.dim()])] + shape[x.dim():]
    return {"Out": x.reshape(tuple(shape))}


@register("transpose2")
def transpose(ctx):
    return {"Out": ctx.in_("X").permute(*ctx.attr("axis"))}


@register("slice")
def slice_op(ctx):
    x = ctx.in_("Input")
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(ctx.attr("axes"), ctx.attr("starts"),
                       ctx.attr("ends")):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    return {"Out": x[tuple(idx)]}


@register("lookup_table")
def lookup_table(ctx):
    w = ctx.in_("W")
    ids = ctx.in_("Ids")
    if ids.dim() and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    padding_idx = ctx.attr("padding_idx", -1)
    out = F.embedding(ids.long().clamp(0, w.shape[0] - 1), w)
    if padding_idx is not None and padding_idx >= 0:
        out = out * (ids != padding_idx)[..., None].to(out.dtype)
    return {"Out": out}


@register("gather")
def gather(ctx):
    x, idx = ctx.in_("X"), ctx.in_("Index")
    return {"Out": torch.index_select(x, 0, idx.reshape(-1).long())}


@register("top_k")
def top_k(ctx):
    vals, idx = torch.topk(ctx.in_("X"), ctx.attr("k", 1), dim=-1)
    return {"Out": vals, "Indices": idx}
