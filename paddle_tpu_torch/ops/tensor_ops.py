"""Tensor manipulation ops.

Parity: paddle/fluid/operators/{concat,split,reshape,transpose,slice,
gather,scatter,expand,pad,stack,squeeze,unsqueeze,cast,one_hot,top_k,
arg_min_max,fill_constant,assign,...}_op.cc; the counterpart of
``paddle_tpu/ops/tensor_ops.py``, every op of it. ``gather`` picks
BERT's masked rows (its gradient is torch's scatter-add,
``index_add``), ``top_k`` feeds ``accuracy``, ``one_hot`` and
``label_smooth`` build the Transformer's soft labels.

Where XLA reads an index out of range without error, the port gives
its answer by masking, where a CUDA gather or scatter would raise a
device-side assert: a negative index wraps once (``wrapped``), a gather
clamps it and passes no gradient through it (``clamped``,
``gather_kept``), a scatter drops it into a dump row cut off afterwards
(``dropped``). ``where`` and ``unique`` keep the JAX package's fixed
shapes (n entries, padded with -1 / 0) from sorts, running counts and
scatters, so nothing waits on the host. ``arg_max`` / ``arg_min`` /
``argsort``'s indices, ``where``'s, ``size`` and ``hash`` are int64
where the JAX package's are int32 (C12's policy); ``unique``'s Index
and Count follow its ``dtype`` attr (int32 by default).

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
are the batch). The same holds for ``split``, ``stack``, ``unstack``,
``reverse``, ``strided_slice``, ``arg_max`` / ``arg_min`` / ``argsort``,
``pad``, ``crop``, ``flatten``, ``expand_as`` and ``tile`` along dim 0;
``where``, ``unique`` and the scatters refuse a sharded input at dp 2
and more (the global answer needs every rank's rows); ``shape`` and
``size`` give the global tensor's; ``gather_nd`` runs a rank's index
rows against a replicated X; the channel shuffles, ``hash``,
``shard_index``, ``pad2d`` and the identities run a rank's rows;
``linspace``, ``eye``, ``diag`` and ``assign_value`` take no sharded
input (ROADMAP C18).
"""

import numpy as np
import torch
import torch.nn.functional as F

from . import (Sharded, refuses, register, replicated, rows, rows_if,
               shard_rule, tp_split,
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


@register("transpose", "transpose2", dp=rows_if(_keeps_dim0_first))
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


@register("lookup_table", "lookup_table_v2", "embedding",
          dp=rows_if(_table_replicated))
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


@shard_rule("lookup_table", "lookup_table_v2", "embedding")
def _tp_lookup(impl, ctx, walk):
    """A vocab-sharded table (``P("tp", None)``, rows split over tp): each
    rank looks up the ids in its rows' range (the others at its first
    row, zeroed), and ``reduce_fn("tp")`` sums the ranks' outputs. The
    ids are clamped into the vocabulary first, as the op clamps them."""
    w = tp_split(ctx.env[ctx.op.input("W")[0]], [0])
    ids = ctx.env[ctx.op.input("Ids")[0]]
    if w is None or len(w.shape) != 2 or not isinstance(ids, torch.Tensor):
        return None
    if ids.dim() and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    clamped = ids.long().clamp(0, w.shape[0] - 1)
    partials = []
    for part, index in zip(w.parts, w.blocks()):
        lo, hi = index[0].start, index[0].stop
        mine = (clamped >= lo) & (clamped < hi)
        rows_ = F.embedding(torch.where(mine, clamped - lo, 0),
                            ctx._maybe_amp(part))
        partials.append(torch.where(mine[..., None], rows_, 0))
    out = walk.mesh.reduce_fn("tp")(partials)
    padding_idx = ctx.attr("padding_idx", -1)
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


# ---------------------------------------------------------------------------
# the rest of the JAX module: shapes, splits and joins, pads, sorts, the
# fixed-size scans (where, unique), scatters and gathers by index tuples,
# the channel shuffles, hashing and the LoD / SelectedRows identities
# ---------------------------------------------------------------------------

def host_tensor(values, dtype, device):
    """A tensor of host values on `device`; bound for CUDA, staged in
    pinned memory and copied without waiting for the stream (a pageable
    copy would be a host sync)."""
    t = torch.as_tensor(np.asarray(values), dtype=dtype)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def wrapped(idx, n):
    """Indices as JAX reads them: a negative index counts from the end
    (i + n)."""
    return torch.where(idx < 0, idx + n, idx)


def clamped(idx, n):
    """A gather's indices as XLA reads them: wrapped, then clamped into
    [0, n)."""
    return wrapped(idx, n).clamp(0, n - 1)


def dropped(idx, n):
    """A scatter's indices as XLA reads them: wrapped, and n (a dump slot
    past the end, cut off afterwards) where still out of [0, n), where XLA
    drops the update. A CUDA scatter would raise a device-side assert."""
    idx = wrapped(idx, n)
    return torch.where((idx >= 0) & (idx < n), idx, n)


def gather_kept(rows, idx, kept):
    """rows[idx] (idx clamped in range), with the gradient of the rows
    whose index was out of range dropped: XLA clamps an out-of-range
    gather and drops the same index in its transpose, a scatter-add."""
    out = torch.index_select(rows, 0, idx.reshape(-1)).reshape(
        tuple(idx.shape) + tuple(rows.shape[1:]))
    kept = kept.reshape(tuple(kept.shape) + (1,) * (rows.dim() - 1))
    return torch.where(kept, out, out.detach())


def _dim0_of(slot, attr="axis", default=0):
    """A rows_if check: the op works along `attr` (an int or a list of
    axes), which at dp > 1 must not be dim 0 of the `slot` input (at dp 1
    a rank's rows are the batch)."""
    def check(ctx, walk):
        axes = ctx.attr(attr, default)
        axes = axes if isinstance(axes, (list, tuple)) else [axes]
        nd = ctx.in_(slot).dim()
        if walk.size > 1 and any(a % nd == 0 for a in axes):
            return f"its {attr} {list(axes)} is dim 0 (the ranks' rows)"
        return None
    return check


def _global_shape(impl, ctxs, walk):
    """shape / rank / size of a dp-sharded input: the global tensor's
    (the shards are equal: dim 0 times the dp size)."""
    out = impl(ctxs[0])
    x = ctxs[0].in_("Input")
    if ctxs[0].op.type == "shape" and x.dim():
        out["Out"] = out["Out"].clone()
        out["Out"][0] *= walk.size
    elif ctxs[0].op.type == "size":
        out["Out"] = out["Out"] * walk.size
    return out


@register("shape", dp=_global_shape)
def shape_op(ctx):
    """The input's shape, int32 (n,)."""
    return {"Out": host_tensor(list(ctx.in_("Input").shape), torch.int32,
                               ctx.in_("Input").device)}


@register("rank", dp=_global_shape)
def rank_op(ctx):
    x = ctx.in_("Input")
    return {"Out": torch.full((), x.dim(), dtype=torch.int32,
                              device=x.device)}


@register("size", dp=_global_shape)
def size_op(ctx):
    """The element count, int64 (the JAX package's is int32)."""
    x = ctx.in_("Input")
    return {"Out": torch.full((), x.numel(), dtype=torch.int64,
                              device=x.device)}


@register("split", dp=rows_if(_dim0_of("X")))
def split(ctx):
    x = ctx.in_("X")
    axis = ctx.attr("axis", 0)
    sections = ctx.attr("sections")
    if sections:
        return {"Out": list(torch.split(x, list(sections), dim=axis))}
    return {"Out": list(torch.chunk(x, ctx.attr("num"), dim=axis))}


@register("flatten", "flatten2",
          dp=rows_if(lambda ctx, walk: "axis 0 folds the batch into one "
                     "row" if walk.size > 1 and ctx.attr("axis", 1) == 0
                     else None))
def flatten(ctx):
    """(prod(shape[:axis]), prod(shape[axis:]))."""
    x = ctx.in_("X")
    lead = 1
    for s in x.shape[:ctx.attr("axis", 1)]:
        lead *= s
    return {"Out": x.reshape(lead, -1)}


def _stack_off_rows(ctx, walk):
    xs = ctx.in_list("X")
    if walk.size > 1 and ctx.attr("axis", 0) % (xs[0].dim() + 1) == 0:
        return "it stacks along dim 0 (the ranks' rows would interleave)"
    env = ctx.env.env
    if not all(isinstance(env[n], Sharded) for n in ctx.op.input("X")):
        return "a replicated input beside dp-sharded ones"
    return None


@register("stack", dp=rows_if(_stack_off_rows))
def stack(ctx):
    return {"Y": torch.stack(ctx.in_list("X"), dim=ctx.attr("axis", 0))}


@register("unstack", dp=rows_if(_dim0_of("X")))
def unstack(ctx):
    return {"Y": list(torch.unbind(ctx.in_("X"), dim=ctx.attr("axis", 0)))}


@register("strided_slice", dp=rows_if(_dim0_of("Input", attr="axes")))
def strided_slice(ctx):
    """x[start:end:stride] on each of `axes`, Python's slice rules (a
    negative stride walks back from start): a negative stride is a
    positive one on the flipped axis."""
    x = ctx.in_("Input")
    for a, s, e, st in zip(ctx.attr("axes"), ctx.attr("starts"),
                           ctx.attr("ends"), ctx.attr("strides")):
        dim = x.shape[a]
        s, e, st = slice(s, e, st).indices(dim)
        idx = [slice(None)] * x.dim()
        if st > 0:
            idx[a] = slice(s, max(e, s), st)
        else:
            x = torch.flip(x, (a,))
            idx[a] = slice(dim - 1 - s, max(dim - 1 - e, dim - 1 - s), -st)
        x = x[tuple(idx)]
    return {"Out": x}


def _flat(x, index, fix):
    """Index (..., k), tuples into x's first k dims -> (the row of each
    tuple in x viewed as (prod(shape[:k]), *shape[k:]), that row count,
    k). Each dim's index is fixed by fix(i, n): clamped for a gather;
    dropped for a scatter, where a tuple with a dropped index goes to the
    dump row past the end."""
    idx = index.long()
    k = idx.shape[-1]
    flat = torch.zeros(idx.shape[:-1], dtype=torch.int64, device=idx.device)
    out = torch.zeros(idx.shape[:-1], dtype=torch.bool, device=idx.device)
    total = 1
    for d in range(k):
        n = x.shape[d]
        i = fix(idx[..., d], n)
        flat = flat * n + i
        out = out | (i == n)
        total *= n
    return torch.where(out, total, flat), total, k


def _gather_nd_rows(ctx, walk):
    if ctx.is_sharded("X"):
        return "its X is dp-sharded (an index tuple addresses the whole X)"
    return None


@register("gather_nd", dp=rows_if(_gather_nd_rows))
def gather_nd(ctx):
    """X at the index tuples of Index (..., k): scalars for k == X.dim(),
    trailing slices for fewer; each index wrapped and clamped as XLA's
    gather reads it (an out-of-range tuple passes no gradient)."""
    x = ctx.in_("X")
    flat, total, k = _flat(x, ctx.in_("Index"), clamped)
    kept = _flat(x, ctx.in_("Index"), dropped)[0] < total
    tail = tuple(x.shape[k:])
    return {"Out": gather_kept(x.reshape((total,) + tail), flat, kept)}


def _scatter_rows(x, flat, upd, total, add):
    """x viewed as (total, ...) with upd's rows added at (or copied to)
    `flat`; the dump row `total` takes the dropped ones."""
    rows = x.reshape((total, -1))
    pad = torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])
    upd = upd.reshape(-1, rows.shape[1]).to(rows.dtype)
    flat = flat.reshape(-1)
    out = pad.index_add(0, flat, upd) if add else pad.index_copy(0, flat, upd)
    return out[:total].reshape(x.shape)


_SCATTER_REFUSES = refuses(
    "it writes rows of the whole X by global ids")


@register("scatter", dp=_SCATTER_REFUSES)
def scatter(ctx):
    """X with Updates' rows written (overwrite) or added at Ids; indices
    wrapped, and dropped where out of range, as XLA's scatter does. Among
    duplicate ids with overwrite, which update lands is not fixed (XLA
    leaves it unspecified; torch's CUDA index_copy is nondeterministic)."""
    x, upd = ctx.in_("X"), ctx.in_("Updates")
    ids = dropped(ctx.in_("Ids").reshape(-1).long(), x.shape[0])
    return {"Out": _scatter_rows(x, ids, upd, x.shape[0],
                                 add=not ctx.attr("overwrite", True))}


@register("scatter_nd_add", dp=_SCATTER_REFUSES)
def scatter_nd_add(ctx):
    x = ctx.in_("X")
    flat, total, _ = _flat(x, ctx.in_("Index"), dropped)
    return {"Out": _scatter_rows(x, flat, ctx.in_("Updates"), total,
                                 add=True)}


@register("scatter_nd", dp=_SCATTER_REFUSES)
def scatter_nd(ctx):
    """Zeros of `shape` with Updates added at Index's tuples."""
    upd = ctx.in_("Updates")
    x = upd.new_zeros(tuple(ctx.attr("shape")))
    flat, total, _ = _flat(x, ctx.in_("Index"), dropped)
    return {"Out": _scatter_rows(x, flat, upd, total, add=True)}


def _tiles_dim0(times_of):
    def check(ctx, walk):
        x = ctx.in_("X")
        times = _tile_times(x, times_of(ctx, x))
        if walk.size > 1 and (len(times) > x.dim() or times[0] != 1):
            return f"it tiles dim 0 {times} (the ranks' rows would " \
                f"interleave)"
        return None
    return check


def _expand_as_times(ctx, x):
    y = ctx.in_("target_tensor")
    return [t // s for s, t in zip(x.shape, y.shape)]


@register("expand_as", dp=rows_if(_tiles_dim0(_expand_as_times)))
def expand_as(ctx):
    x = ctx.in_("X")
    return {"Out": x.repeat(*_expand_as_times(ctx, x))}


@register("tile", dp=rows_if(_tiles_dim0(
    lambda ctx, x: ctx.attr("repeat_times"))))
def tile(ctx):
    return {"Out": torch.tile(ctx.in_("X"), tuple(ctx.attr("repeat_times")))}


def _pads_dim0(ctx, walk):
    p = ctx.attr("paddings")
    if walk.size > 1 and (p[0] or p[1]):
        return "it pads dim 0"
    return None


@register("pad", dp=rows_if(_pads_dim0))
def pad(ctx):
    """Constant padding, paddings[2i], paddings[2i + 1] before and after
    dim i."""
    x = ctx.in_("X")
    p = ctx.attr("paddings")
    flat = []
    for i in reversed(range(x.dim())):
        flat += [p[2 * i], p[2 * i + 1]]
    return {"Out": F.pad(x, flat, value=ctx.attr("pad_value", 0.0))}


@register("pad2d", dp=rows)
def pad2d(ctx):
    """[top, bottom, left, right] around H and W of NCHW (or NHWC):
    constant, reflect (the edge not repeated) or edge (repeated)."""
    x = ctx.in_("X")
    p = ctx.attr("paddings", [0, 0, 0, 0])
    mode = ctx.attr("mode", "constant")
    nhwc = ctx.attr("data_format", "NCHW") == "NHWC"
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    flat = [p[2], p[3], p[0], p[1]]
    if mode == "constant":
        out = F.pad(x, flat, value=ctx.attr("pad_value", 0.0))
    else:
        out = F.pad(x, flat, mode={"reflect": "reflect",
                                   "edge": "replicate"}[mode])
    return {"Out": out.permute(0, 2, 3, 1) if nhwc else out}


def _pad_like_rows(ctx, walk):
    if not (ctx.is_sharded("X") and ctx.is_sharded("Y")):
        return "X and Y must both be dp-sharded"
    if walk.size > 1 and ctx.in_("X").shape[0] != ctx.in_("Y").shape[0]:
        return "it pads dim 0"
    return None


@register("pad_constant_like", dp=rows_if(_pad_like_rows))
def pad_constant_like(ctx):
    """Y padded at the end of each dim to X's shape."""
    x, y = ctx.in_("X"), ctx.in_("Y")
    flat = []
    for xs, ys in reversed(list(zip(x.shape, y.shape))):
        flat += [0, xs - ys]
    return {"Out": F.pad(y, flat, value=ctx.attr("pad_value", 0.0))}


@register("arg_max", dp=rows_if(_dim0_of("X", default=-1)))
def arg_max(ctx):
    """The first largest entry's index along `axis`, int64 (the JAX
    package's is int32)."""
    return {"Out": torch.argmax(ctx.in_("X"), dim=ctx.attr("axis", -1))}


@register("arg_min", dp=rows_if(_dim0_of("X", default=-1)))
def arg_min(ctx):
    return {"Out": torch.argmin(ctx.in_("X"), dim=ctx.attr("axis", -1))}


@register("argsort", dp=rows_if(_dim0_of("X", default=-1)))
def argsort(ctx):
    """A stable sort along `axis`, descending by sorting -x as the JAX
    package does: equal entries keep their order, 0.0 and -0.0 are equal
    (lax.sort's order), NaNs last. Indices int64."""
    x = ctx.in_("X")
    axis = ctx.attr("axis", -1)
    key = -x if ctx.attr("descending", False) else x
    idx = torch.sort(key, dim=axis, stable=True).indices
    return {"Out": torch.take_along_dim(x, idx, dim=axis), "Indices": idx}


@register("where", dp=refuses(
    "its indices count positions in the whole flattened condition"))
def where(ctx):
    """The flat positions of Condition's true entries, in order, then -1:
    (n, 1) int64 for n entries (jnp.nonzero(size=n, fill_value=-1)). A
    fixed shape: the positions are scattered to their rank (the running
    count), the others to a dump slot, so nothing waits on the host."""
    c = ctx.in_("Condition").reshape(-1)
    c = c if c.dtype == torch.bool else c != 0
    n = c.numel()
    pos = torch.cumsum(c, 0) - 1
    out = torch.full((n + 1,), -1, dtype=torch.int64, device=c.device)
    out.scatter_(0, torch.where(c, pos, n),
                 torch.arange(n, device=c.device))
    return {"Out": out[:n].reshape(n, 1)}


@register("reverse", dp=rows_if(_dim0_of("X")))
def reverse(ctx):
    x = ctx.in_("X")
    return {"Out": torch.flip(x, tuple(a % x.dim()
                                       for a in ctx.attr("axis")))}


@register("linspace", dp=replicated)
def linspace(ctx):
    """num points from start to stop, computed in float64 and cast (an
    integer dtype floors, as jnp.linspace does)."""
    dtype = torch_dtype(ctx.attr("dtype", "float32"))
    out = torch.linspace(ctx.attr("start"), ctx.attr("stop"),
                         ctx.attr("num"), dtype=torch.float64,
                         device=ctx.device)
    if not dtype.is_floating_point:
        out = torch.floor(out)
    return {"Out": out.to(dtype)}


@register("eye", dp=replicated)
def eye(ctx):
    return {"Out": torch.eye(ctx.attr("num_rows"), ctx.attr("num_columns"),
                             dtype=torch_dtype(ctx.attr("dtype", "float32")),
                             device=ctx.device)}


@register("diag", dp=replicated)
def diag(ctx):
    """A vector -> the square matrix with it on the diagonal (a matrix ->
    its diagonal)."""
    return {"Out": torch.diag(ctx.in_("Diagonal"))}


@register("unique", "unique_with_counts", dp=refuses(
    "it finds the values of the whole tensor"))
def unique(ctx):
    """jnp.unique(x, return_inverse, return_counts, size=n, fill_value=0)
    over the n entries of x: the sorted distinct values padded with 0,
    each entry's position among them (x's shape) and each value's count
    padded with 0; Index and Count in `dtype` (int32 by default; int64
    kept where asked, which the JAX package narrows to int32). A fixed
    shape from a sort, a running count of new values and scatters, so
    nothing waits on the host."""
    x = ctx.in_("X")
    flat = x.reshape(-1)
    n = flat.numel()
    vals, perm = torch.sort(flat, stable=True)
    new = torch.ones(n, dtype=torch.bool, device=x.device)
    new[1:] = vals[1:] != vals[:-1]
    group = torch.cumsum(new, 0) - 1
    out = torch.zeros_like(flat).scatter_(0, group, vals)
    inverse = torch.empty_like(group).scatter_(0, perm, group)
    counts = torch.zeros(n, dtype=torch.int64, device=x.device).scatter_add_(
        0, group, torch.ones_like(group))
    idt = torch_dtype(ctx.attr("dtype", "int32"))
    return {"Out": out, "Index": inverse.reshape(x.shape).to(idt),
            "Count": counts.to(idt)}


@register("shard_index", dp=rows)
def shard_index(ctx):
    """shard_index_op.h:37: floor division; an id whose shard (id //
    (index_num // nshards)) is shard_id becomes id % shard_size, any other
    ignore_value."""
    x = ctx.in_("X")
    nshards = ctx.attr("nshards")
    shard_size = ctx.attr("index_num") // nshards
    if shard_size == 0:
        raise ValueError(
            f"shard_index: nshards ({nshards}) > index_num "
            f"({ctx.attr('index_num')}) gives an empty shard_size (the "
            f"reference divides by zero here)")
    in_shard = torch.div(x, shard_size, rounding_mode="floor") == \
        ctx.attr("shard_id")
    return {"Out": torch.where(in_shard, torch.remainder(x, shard_size),
                               torch.full_like(x, ctx.attr("ignore_value",
                                                           -1)))}


@register("space_to_depth", dp=rows)
def space_to_depth(ctx):
    """NCHW (n, c, h, w) -> (n, c bs^2, h / bs, w / bs), the JAX
    package's channel order: (bs_h, bs_w, c) from slowest."""
    x = ctx.in_("X")
    bs = ctx.attr("blocksize")
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // bs, bs, w // bs, bs).permute(0, 3, 5, 1, 2, 4)
    return {"Out": x.reshape(n, c * bs * bs, h // bs, w // bs)}


@register("pixel_shuffle", dp=rows)
def pixel_shuffle(ctx):
    x = ctx.in_("X")
    r = ctx.attr("upscale_factor")
    n, c, h, w = x.shape
    x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return {"Out": x.reshape(n, c // (r * r), h * r, w * r)}


@register("shuffle_channel", dp=rows)
def shuffle_channel(ctx):
    x = ctx.in_("X")
    g = ctx.attr("group")
    n, c, h, w = x.shape
    return {"Out": x.reshape(n, g, c // g, h, w).transpose(1, 2)
            .reshape(n, c, h, w)}


@register("assign_value", dp=replicated)
def assign_value(ctx):
    """The attr `values` in `dtype`, of `shape`, on the op's device."""
    dtype = torch_dtype(ctx.attr("dtype", "float32"))
    vals = np.asarray(ctx.attr("values"))
    return {"Out": host_tensor(vals, dtype, ctx.device)
            .reshape(tuple(ctx.attr("shape")))}


def _fill_of(dtype):
    """take_along_axis's fill for an out-of-range index: NaN, or the
    smallest signed integer."""
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).min


def _all_sharded(ctx, walk):
    env = ctx.env.env
    if not all(isinstance(env[n], Sharded) for n in ctx.op.input_names):
        return "a replicated input beside dp-sharded ones"
    return None


@register("multiplex", dp=rows_if(_all_sharded))
def multiplex(ctx):
    """Row b of X[Ids[b]]; an id wrapped as JAX does, and out of range
    it gives take_along_axis's fill (NaN for floats)."""
    xs = ctx.in_list("X")
    k = len(xs)
    stacked = torch.stack(xs, 0)
    ids = wrapped(ctx.in_("Ids").reshape(-1).long(), k)
    ok = (ids >= 0) & (ids < k)
    idx = ids.clamp(0, k - 1).reshape((1, -1) + (1,) * (stacked.dim() - 2))
    out = torch.take_along_dim(stacked, idx, dim=0)[0]
    ok = ok.reshape((-1,) + (1,) * (out.dim() - 1))
    return {"Out": torch.where(ok, out, torch.full(
        (), _fill_of(out.dtype), dtype=out.dtype, device=out.device))}


def _crop_keeps_rows(ctx, walk):
    shape = ctx.attr("shape")
    offsets = ctx.attr("offsets") or [0] * len(shape)
    if walk.size > 1 and (ctx.has_in("Offsets") or offsets[0]
                          or shape[0] not in (-1, 0)):
        return "it crops dim 0"
    return None


@register("crop", "crop_tensor", dp=rows_if(_crop_keeps_rows))
def crop_tensor(ctx):
    """A window of `shape` at `offsets` (a -1 or 0 size: the rest of the
    dim), a negative offset wrapped and each clamped so the window fits,
    as lax.dynamic_slice reads its start. Offsets as a tensor are read
    on the device: each dim an index_select of offset + arange(size), no
    host read."""
    x = ctx.in_("X")
    shape = ctx.attr("shape")
    if ctx.has_in("Offsets"):
        if any(s in (-1, 0) for s in shape):
            raise NotImplementedError(
                "crop/crop_tensor: -1/0 entries in `shape` cannot be "
                "combined with a tensor Offsets input (the slice size "
                "would be dynamic); pass explicit sizes")
        off = ctx.in_("Offsets").reshape(-1).long()
        for d, size in enumerate(shape):
            start = wrapped(off[d], x.shape[d]).clamp(0, x.shape[d] - size)
            x = torch.index_select(x, d, start + torch.arange(
                size, device=x.device))
        return {"Out": x}
    offsets = ctx.attr("offsets") or [0] * x.dim()
    idx = []
    for dim, s, o in zip(x.shape, shape, offsets):
        size = dim - o if s in (-1, 0) else s
        start = min(max(o + dim if o < 0 else o, 0), dim - size)
        idx.append(slice(start, start + size))
    return {"Out": x[tuple(idx)]}


_MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B1


@register("hash", dp=rows)
def hash_op(ctx):
    """The JAX package's 32-bit multiplicative hash (not the reference's
    XXH64): each id as uint32 (x mod 2^32, so a negative id and one past
    2^31 wrap as JAX's int32 -> uint32 cast does) times k * 0x9E3779B1 mod
    2^32 for k = 1..num_hash, mod mod_by. torch has no uint32 product, so
    it is taken in int64 in two 16-bit halves of the seed, each product
    below 2^48. Out (..., num_hash * L) int64 (the JAX package's int32)."""
    x = ctx.in_("X")
    num_hash = ctx.attr("num_hash", 1)
    mod_by = ctx.attr("mod_by", 100000007)
    u = x.long() & _MASK32
    hs = []
    for k in range(1, num_hash + 1):
        seed = (k * _GOLDEN) & _MASK32
        lo = u * (seed & 0xFFFF)
        hi = ((u * (seed >> 16)) & 0xFFFF) << 16
        hs.append(((lo + hi) & _MASK32) % mod_by)
    h = torch.stack(hs, -1)
    return {"Out": h.reshape(tuple(x.shape[:-1])
                             + (num_hash * x.shape[-1],))}


@register("lod_reset", "lod_append", "merge_selected_rows",
          "get_tensor_from_selected_rows", dp=rows)
def identity(ctx):
    """The identity on the device: the LoD is host-side metadata (padded
    tensors and lengths), and SelectedRows are dense gradients here, as
    in the JAX package."""
    return {"Out": ctx.in_("X")}
