"""Tensor manipulation ops.

Parity: paddle/fluid/operators/{cast,fill_constant,reshape,transpose,slice,
lookup_table,gather,top_k}_op.cc; the counterpart of
``paddle_tpu/ops/tensor_ops.py`` with the ops the ported slices run.
``transpose2`` is here because the ``scaled_dot_product_attention`` layer
splits heads with it; ``gather`` picks BERT's masked rows (its gradient
is torch's scatter-add, ``index_add``), ``top_k`` feeds ``accuracy``.

Under data parallelism ``cast``, ``zeros_like``, ``lookup_table`` (ids
sharded, the table replicated) and ``top_k`` run a rank's rows;
``reshape`` does so where its target keeps dim 0 the batch (-1, 0, or
the global size, which becomes the local one), ``transpose2`` where it
keeps dim 0 first, ``slice`` where it does not cut dim 0. ``gather``
from a sharded source with sharded global indices gathers from the
whole source, the ranks' rows concatenated in rank order (in a world,
all-gathered): exact for any in-range global index, as BERT's
``mask_pos`` indexes the global (B*T) token grid. ``fill_constant``
takes no sharded input.
"""

import torch
import torch.nn.functional as F

from . import (Sharded, register, replicated, rows, rows_if,
               torch_dtype)


@register("cast", dp=rows)
def cast(ctx):
    return {"Out": ctx.in_("X").to(torch_dtype(ctx.attr("out_dtype")))}


@register("zeros_like", "fill_zeros_like", "fill_zeros_like2", dp=rows)
def zeros_like(ctx):
    return {"Out": torch.zeros_like(ctx.in_("X"))}


@register("fill_constant", dp=replicated)
def fill_constant(ctx):
    shape = ctx.attr("shape", [1])
    value = ctx.attr("value", 0.0)
    dtype = torch_dtype(ctx.attr("dtype", "float32"))
    return {"Out": torch.full(tuple(shape), value, dtype=dtype,
                              device=ctx.device)}


def _reshape(x, shape):
    # fluid: 0 means copy input dim; -1 inferred.
    shape = [x.shape[i] if s == 0 else s
             for i, s in enumerate(shape[:x.dim()])] + list(shape[x.dim():])
    return x.reshape(tuple(shape))


def _dp_reshape(impl, ctxs, walk):
    """A rank's rows, where the target's dim 0 is -1, 0 or the global
    size (which becomes the local size)."""
    shape = list(ctxs[0].attr("shape"))
    rows_local = ctxs[0].in_("X").shape[0]
    if shape and shape[0] not in (-1, 0):
        if shape[0] != rows_local * walk.size:
            raise NotImplementedError(
                f"op '{ctxs[0].op.type}' under data parallelism: target "
                f"dim 0 {shape[0]} is neither -1, 0 nor the global batch "
                f"{rows_local * walk.size}")
        shape[0] = rows_local
    return {"Out": Sharded([_reshape(c.in_("X"), shape) for c in ctxs])}


@register("reshape", "reshape2", dp=_dp_reshape)
def reshape(ctx):
    return {"Out": _reshape(ctx.in_("X"), ctx.attr("shape"))}


def _keeps_dim0_first(ctx, walk):
    if ctx.attr("axis")[0] != 0:
        return f"perm {list(ctx.attr('axis'))} moves dim 0"
    return None


@register("transpose2", dp=rows_if(_keeps_dim0_first))
def transpose(ctx):
    return {"Out": ctx.in_("X").permute(*ctx.attr("axis"))}


def _keeps_dim0(ctx, walk):
    x = ctx.in_("Input")
    if any(a % x.dim() == 0 for a in ctx.attr("axes")):
        return "it slices dim 0"
    return None


@register("slice", dp=rows_if(_keeps_dim0))
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


def _table_replicated(ctx, walk):
    if ctx.is_sharded("W"):
        return "the table W is dp-sharded"
    return None


@register("lookup_table", dp=rows_if(_table_replicated))
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


def _dp_gather(impl, ctxs, walk):
    """Each rank's global indices into the whole source: the source's
    rows concatenated in rank order (walk.cat). A replicated source runs
    a rank's indices; a sharded source under replicated indices
    refuses."""
    if not ctxs[0].is_sharded("X"):
        return rows(impl, ctxs, walk)
    if not ctxs[0].is_sharded("Index"):
        raise NotImplementedError(
            "op 'gather' under data parallelism: a dp-sharded source "
            "with replicated indices")
    src = walk.cat([c.in_("X") for c in ctxs])
    return {"Out": Sharded([torch.index_select(
        src, 0, c.in_("Index").reshape(-1).long()) for c in ctxs])}


@register("gather", dp=_dp_gather)
def gather(ctx):
    x, idx = ctx.in_("X"), ctx.in_("Index")
    return {"Out": torch.index_select(x, 0, idx.reshape(-1).long())}


@register("top_k", dp=rows)
def top_k(ctx):
    vals, idx = torch.topk(ctx.in_("X"), ctx.attr("k", 1), dim=-1)
    return {"Out": vals, "Indices": idx}
