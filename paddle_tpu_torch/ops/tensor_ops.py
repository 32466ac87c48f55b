"""Tensor manipulation ops.

Parity: paddle/fluid/operators/{cast,fill_constant,reshape,transpose,slice,
lookup_table,gather,top_k}_op.cc; the counterpart of
``paddle_tpu/ops/tensor_ops.py`` with the ops the ported slices run.
``transpose2`` is here because the ``scaled_dot_product_attention`` layer
splits heads with it; ``gather`` picks BERT's masked rows (its gradient
is torch's scatter-add, ``index_add``), ``top_k`` feeds ``accuracy``;
``one_hot`` and ``label_smooth`` build the Transformer's soft labels,
``range`` the Faster R-CNN head's batch indices,
``concat``, ``squeeze``/``unsqueeze``, ``expand`` and ``ones_like`` DIN's
attention unit.

Under data parallelism ``cast``, ``zeros_like``, ``lookup_table`` (ids
sharded, the table replicated) and ``top_k`` run a rank's rows;
``reshape`` does so where its target keeps dim 0 the batch (-1, 0, or
the global size, which becomes the local one), ``transpose2`` where it
keeps dim 0 first, ``slice`` where it does not cut dim 0. ``gather``
from a sharded source with sharded global indices gathers from the
whole source, the ranks' rows concatenated in rank order (in a world,
all-gathered): exact for any in-range global index, as BERT's
``mask_pos`` indexes the global (B*T) token grid. ``fill_constant``
and ``range`` take no sharded input. ``one_hot``, ``label_smooth`` and
``ones_like`` run a rank's rows; ``concat``, ``squeeze``, ``unsqueeze``
and ``expand`` do so where they leave dim 0 the batch: a rank-local
``concat`` on axis 0 or an ``expand`` that tiles dim 0 would interleave
the ranks' rows, so those refuse (at dp 2 and more; one rank's rows
are the batch).
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


@register("assign", dp=rows)
def assign(ctx):
    """A copy of X. JAX returns the array itself, which nothing can change
    later; here the optimizers update their tensors in place, so a
    snapshot taken before an update must own its memory."""
    return {"Out": ctx.in_("X").clone()}


@register("fill_constant", dp=replicated)
def fill_constant(ctx):
    shape = ctx.attr("shape", [1])
    value = ctx.attr("value", 0.0)
    dtype = torch_dtype(ctx.attr("dtype", "float32"))
    return {"Out": torch.full(tuple(shape), value, dtype=dtype,
                              device=ctx.device)}


@register("range", dp=replicated)
def range_op(ctx):
    """arange(start, end, step) in `dtype` on the op's device."""
    return {"Out": torch.arange(ctx.attr("start"), ctx.attr("end"),
                                ctx.attr("step"), device=ctx.device,
                                dtype=torch_dtype(ctx.attr("dtype",
                                                           "float32")))}


@register("fill_constant_batch_size_like", dp=rows)
def fill_constant_batch_size_like(ctx):
    """A constant of `shape` whose dim output_dim_idx is Input's dim
    input_dim_idx (a rank's rows under dp: Input's sharded dim 0)."""
    shape = list(ctx.attr("shape"))
    shape[ctx.attr("output_dim_idx", 0)] = \
        ctx.in_("Input").shape[ctx.attr("input_dim_idx", 0)]
    return {"Out": torch.full(tuple(shape), ctx.attr("value", 0.0),
                              dtype=torch_dtype(ctx.attr("dtype",
                                                         "float32")),
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


def _all_sharded_off_rows(ctx, walk):
    xs = ctx.in_list("X")
    if ctx.attr("axis", 0) % xs[0].dim() == 0 and walk.size > 1:
        return "it concatenates along dim 0 (the ranks' rows would " \
            "interleave)"
    env = ctx.env.env
    if not all(isinstance(env[n], Sharded) for n in ctx.op.input("X")):
        return "a replicated input beside dp-sharded ones"
    return None


@register("concat", dp=rows_if(_all_sharded_off_rows))
def concat(ctx):
    return {"Out": torch.cat(ctx.in_list("X"), dim=ctx.attr("axis", 0))}


def _squeeze_axes(x, axes):
    """The dims squeeze drops: the given axes of size 1 (all size-1 dims
    when `axes` is empty)."""
    if not axes:
        return {i for i, s in enumerate(x.shape) if s == 1}
    return {a % x.dim() for a in axes if x.shape[a % x.dim()] == 1}


def _squeeze_keeps_dim0(ctx, walk):
    if 0 in _squeeze_axes(ctx.in_("X"), ctx.attr("axes", [])):
        return "it squeezes dim 0"
    return None


@register("squeeze", "squeeze2", dp=rows_if(_squeeze_keeps_dim0))
def squeeze(ctx):
    x = ctx.in_("X")
    drop = _squeeze_axes(x, ctx.attr("axes", []))
    return {"Out": x.reshape([s for i, s in enumerate(x.shape)
                              if i not in drop])}


def _unsqueeze(x, axes):
    for a in sorted(axes):
        x = x.unsqueeze(a)
    return x


def _unsqueeze_keeps_dim0(ctx, walk):
    # where the input's dim 0 lands: unsqueeze a tensor whose only
    # non-trivial dim is dim 0
    x = ctx.in_("X")
    probe = torch.zeros((2,) + (1,) * (x.dim() - 1))
    if _unsqueeze(probe, ctx.attr("axes")).shape[0] != 2:
        return "it inserts a dim before dim 0"
    return None


@register("unsqueeze", "unsqueeze2", dp=rows_if(_unsqueeze_keeps_dim0))
def unsqueeze(ctx):
    return {"Out": _unsqueeze(ctx.in_("X"), ctx.attr("axes"))}


def _tile_times(x, times):
    """np.tile's repetitions: fewer than x's dims are padded with leading
    1s."""
    times = list(times)
    return [1] * (x.dim() - len(times)) + times


def _expand_keeps_dim0(ctx, walk):
    x = ctx.in_("X")
    times = _tile_times(x, ctx.attr("expand_times"))
    if walk.size > 1 and (len(times) > x.dim() or times[0] != 1):
        return f"expand_times {times} tiles dim 0 (the ranks' rows would " \
            f"interleave)"
    return None


@register("expand", dp=rows_if(_expand_keeps_dim0))
def expand(ctx):
    """np.tile: each dim repeated expand_times[i] times."""
    x = ctx.in_("X")
    return {"Out": x.repeat(*_tile_times(x, ctx.attr("expand_times")))}


@register("ones_like", "fill_any_like", dp=rows)
def ones_like(ctx):
    return {"Out": torch.full_like(ctx.in_("X"), ctx.attr("value", 1.0))}


@register("one_hot", "one_hot_v2", dp=rows)
def one_hot(ctx):
    """f32 (..., depth) rows, 1 at each id; a trailing 1 in the ids'
    shape is squeezed away, and an id outside [0, depth) gives a row of
    zeros (jax.nn.one_hot's)."""
    x = ctx.in_("X")
    if x.dim() and x.shape[-1] == 1:
        x = x.reshape(x.shape[:-1])
    depth = ctx.attr("depth")
    classes = torch.arange(depth, device=x.device)
    return {"Out": (x.long()[..., None] == classes).to(torch.float32)}


@register("label_smooth", dp=rows)
def label_smooth(ctx):
    """(1 - eps) x + eps / depth, or (1 - eps) x + eps PriorDist."""
    x = ctx.in_("X")
    eps = ctx.attr("epsilon", 0.1)
    prior = ctx.in_("PriorDist")
    if prior is not None:
        return {"Out": (1 - eps) * x + eps * prior}
    return {"Out": (1 - eps) * x + eps / x.shape[-1]}
