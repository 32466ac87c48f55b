"""Elementwise / matmul / reduction ops.

Parity: paddle/fluid/operators/elementwise/*, matmul_op.cc, mul_op.cc,
mean_op.cc, reduce_ops/*, scale_op.cc, sum_op.cc, clip_op.cc,
compare_op.cc, isfinite_op.cc, increment_op.cc; the counterpart of
``paddle_tpu/ops/math_ops.py`` with the ops the ported slices run:
``elementwise_add``/``sub``/``mul``/``div``/``max``/``min``/``pow``/
``mod``/``floordiv``, ``scale``, ``mul``, ``matmul``, ``sum``,
``reduce_sum``/``mean``/``max``/``min``/``prod``/``all``/``any``,
``mean``, ``clip``, ``clip_by_norm``, ``isfinite``, ``increment``, the
comparisons ``equal``, ``not_equal``, ``greater_than``,
``greater_equal``, ``less_than`` and ``less_equal``, and
``logical_and``/``or``/``xor``/``not``, ``l2_normalize`` / ``norm``,
``cumsum``, ``has_inf`` / ``has_nan`` (one device bool, no host read),
``dot``, ``minus``, ``l1_norm``, ``squared_l2_norm``, ``fill`` and
``conv_shift``: every op of the JAX module.

Under data parallelism (``ops/__init__.py``'s rules) the elementwise
ops, ``scale``, ``sum``, ``clip``, ``select_finite``, the comparisons
and the logical ops run a rank's rows; ``mul`` and ``matmul`` do so
against a replicated weight (``matmul`` also between two sharded
batches of matrices); ``mean`` and the reductions over dim 0 finish each
rank's partial with the mesh's dp collective (``mean`` and
``reduce_mean`` divide the dp sum by the global count; ``reduce_max``,
``_min``, ``_prod``, ``_all`` and ``_any`` reduce the ranks' partials
once more); ``l2_normalize`` and ``cumsum`` run a rank's rows where
their axis is not dim 0 (``cumsum`` unflattened); ``clip_by_norm``,
``isfinite`` and ``increment`` take replicated inputs only;
``has_inf`` / ``has_nan``, ``l1_norm`` and ``squared_l2_norm`` finish
each rank's partial with one dp sum (the global tensor's); ``dot``,
``minus`` and ``conv_shift`` run a rank's rows.

``select_finite`` is the port's own: the loss scaler's overflow step
(amp/decorator.py) zeroes the gradients with it, where the JAX package
multiplies them by the finite flag (ROADMAP C8).

Shard rules (tensor parallelism, ``ops/__init__.py``): ``mul`` against a
column-parallel Y (``P(None, "tp")``) gives an activation split over tp
along its last dimension, one product a rank; against a row-parallel Y
(``P("tp", None)``) with X split so it gives the ranks' partials, which
the mesh's ``reduce_fn("tp")`` finishes.
``matmul`` against a vocab-sharded table with ``transpose_Y`` (or a
column-parallel Y) splits its output's last dimension. The elementwise
ops take a sharded X with Y replicated (sliced to each block where it
spans a sharded dimension, whole where it broadcasts) or laid out as X,
and ``scale`` runs a part at a time; any other case reads the global
values.
"""

import torch

from . import (blockwise, part_context, register, replicated, rows, rows_if,
               shard_rule, tp_split, torch_dtype)
from ..parallel.sharded import ShardedTensor, same_mesh
from .tensor_ops import host_tensor


def _bcast_y(x, y, axis):
    """Fluid elementwise broadcast: align y's dims to x starting at `axis`."""
    if x.dim() == y.dim() or y.dim() == 0:
        return y
    if axis is None or axis == -1:
        axis = x.dim() - y.dim()
    shape = [1] * axis + list(y.shape) + [1] * (x.dim() - axis - y.dim())
    return y.reshape(shape)


def _ew(fn):
    def impl(ctx):
        x, y = ctx.in_("X"), ctx.in_("Y")
        y = _bcast_y(x, y, ctx.attr("axis", -1))
        return {"Out": fn(x, y)}
    return impl


def _aligned(x_ndim, y, axis):
    """`y` with its dims aligned to an x of `x_ndim` dims, as _bcast_y
    aligns them."""
    if x_ndim == y.dim() or y.dim() == 0:
        return y
    if axis is None or axis == -1:
        axis = x_ndim - y.dim()
    return y.reshape([1] * axis + list(y.shape)
                     + [1] * (x_ndim - axis - y.dim()))


def _ew_blocks(impl, ctx, walk):
    """An elementwise op on a sharded X: once a part, Y laid out as X,
    or replicated and cut to each part's block where it spans a sharded
    dimension (where it broadcasts, whole)."""
    xn, yn = ctx.op.input("X")[0], ctx.op.input("Y")[0]
    x, y = ctx.env[xn], ctx.env[yn]
    if not isinstance(x, ShardedTensor):
        return None
    if isinstance(y, ShardedTensor):
        if y.shape != x.shape or not y.same_layout(x.spec, x.mesh):
            return None
        ys = y.parts
    elif not isinstance(y, torch.Tensor):
        return None
    else:
        y = _aligned(len(x.shape), y, ctx.attr("axis", -1))
        if y.dim() and (y.dim() != len(x.shape) or any(
                y.shape[d] not in (1, x.shape[d])
                for d, e in enumerate(x.spec) if e is not None)):
            return None
        ys = [y[tuple(ix[d] if y.dim() and y.shape[d] != 1 and
                      x.spec[d] is not None else slice(None)
                      for d in range(y.dim()))] for ix in x.blocks()]
    outs = [impl(part_context(ctx, {xn: xp, yn: yp}))["Out"]
            for xp, yp in zip(x.parts, ys)]
    return {"Out": x.like(outs)}


register("elementwise_add", dp=rows)(_ew(torch.add))
register("elementwise_sub", dp=rows)(_ew(torch.sub))
register("elementwise_mul", dp=rows)(_ew(torch.mul))
register("elementwise_div", dp=rows)(_ew(torch.div))
register("elementwise_max", dp=rows)(_ew(torch.maximum))
register("elementwise_min", dp=rows)(_ew(torch.minimum))
register("elementwise_pow", dp=rows)(_ew(torch.pow))
# floor modulo, the sign of the divisor's (jnp.mod): the wrappers' bounded
# step counters
register("elementwise_mod", dp=rows)(_ew(torch.remainder))
# rounded toward minus infinity, as jnp.floor_divide
register("elementwise_floordiv", dp=rows)(_ew(
    lambda x, y: torch.div(x, y, rounding_mode="floor")))


shard_rule("elementwise_add", "elementwise_sub", "elementwise_mul",
           "elementwise_div", "elementwise_max", "elementwise_min",
           "elementwise_pow")(_ew_blocks)


shard_rule("scale")(blockwise)


@register("scale", dp=rows)
def scale(ctx):
    x = ctx.in_("X")
    s = ctx.attr("scale", 1.0)
    b = ctx.attr("bias", 0.0)
    if ctx.attr("bias_after_scale", True):
        return {"Out": x * s + b}
    return {"Out": (x + b) * s}


def _prod(t):
    r = 1
    for v in t:
        r *= int(v)
    return r


def _promoted(x, y):
    """x and y in their common dtype where they differ, as ``jnp``
    promotes mixed operands of a product (f32 x bf16 gives f32: a bf16
    Predictor's weights under f32 feeds); torch's products refuse them."""
    if x.dtype == y.dtype:
        return x, y
    dt = torch.promote_types(x.dtype, y.dtype)
    return x.to(dt), y.to(dt)


def _weight_replicated(ctx, walk):
    if ctx.is_sharded("Y"):
        return "the weight Y is dp-sharded"
    return None


@register("mul", dp=rows_if(_weight_replicated))
def mul(ctx):
    """fluid mul: flatten x to 2-D at x_num_col_dims, matmul."""
    x, y = _promoted(ctx.in_("X"), ctx.in_("Y"))
    xnc = ctx.attr("x_num_col_dims", 1)
    ync = ctx.attr("y_num_col_dims", 1)
    xs, ys = x.shape, y.shape
    x2 = x.reshape((-1, _prod(xs[xnc:])))
    y2 = y.reshape((_prod(ys[:ync]), -1))
    out = x2 @ y2
    return {"Out": out.reshape(tuple(xs[:xnc]) + tuple(ys[ync:]))}


@shard_rule("mul")
def _tp_mul(impl, ctx, walk):
    """Megatron's products: X against a column-parallel Y
    (``P(None, "tp")``) gives Out split over tp along its last dimension;
    X split so against a row-parallel Y (``P("tp", None)``) gives
    partials that ``reduce_fn("tp")`` sums."""
    xn, yn = ctx.op.input("X")[0], ctx.op.input("Y")[0]
    x, y = ctx.env[xn], ctx.env[yn]
    xnc = ctx.attr("x_num_col_dims", 1)
    if len(y.shape) != 2 or ctx.attr("y_num_col_dims", 1) != 1:
        return None
    cols = tp_split(y, [1])
    if cols is not None and isinstance(x, torch.Tensor):
        outs = [impl(part_context(ctx, {yn: p}))["Out"] for p in cols.parts]
        return {"Out": ShardedTensor(
            outs, (None,) * xnc + ("tp",), y.mesh,
            tuple(x.shape[:xnc]) + (y.shape[1],))}
    rows_, xs = tp_split(y, [0]), tp_split(x, [-1])
    if rows_ is None or xs is None or xnc != len(x.shape) - 1 or \
            not same_mesh(xs.mesh, rows_.mesh):
        return None
    partials = [impl(part_context(ctx, {xn: xp, yn: yp}))["Out"]
                for xp, yp in zip(xs.parts, rows_.parts)]
    return {"Out": walk.mesh.reduce_fn("tp")(partials)}


@shard_rule("matmul")
def _tp_matmul(impl, ctx, walk):
    """X against a table split over tp along its output dimension (a
    vocab-sharded ``P("tp", None)`` with ``transpose_Y``, or a
    column-parallel Y): Out split over tp along its last dimension."""
    xn, yn = ctx.op.input("X")[0], ctx.op.input("Y")[0]
    x, y = ctx.env[xn], ctx.env[yn]
    if not isinstance(x, torch.Tensor) or x.dim() < 2 or \
            len(y.shape) != 2:
        return None
    ty = bool(ctx.attr("transpose_Y", False))
    split = tp_split(y, [0] if ty else [1])
    if split is None:
        return None
    outs = [impl(part_context(ctx, {yn: p}))["Out"] for p in split.parts]
    shape = tuple(outs[0].shape[:-1]) + (y.shape[0] if ty else y.shape[1],)
    return {"Out": ShardedTensor(outs, (None,) * (len(shape) - 1) + ("tp",),
                                 y.mesh, shape)}


def _matmul_rows(ctx, walk):
    if not ctx.is_sharded("X"):
        return "a replicated X times a dp-sharded Y"
    if ctx.is_sharded("Y") and min(ctx.in_("X").dim(),
                                   ctx.in_("Y").dim()) < 3:
        return "two dp-sharded 2-D operands (not a batch of matrices)"
    return None


@register("matmul", dp=rows_if(_matmul_rows))
def matmul(ctx):
    x, y = _promoted(ctx.in_("X"), ctx.in_("Y"))
    if ctx.attr("transpose_X", False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if ctx.attr("transpose_Y", False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = ctx.attr("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": out}


@register("sum", dp=rows)
def sum_op(ctx):
    """Elementwise sum of same-shaped inputs: one stacked reduction in
    place of JAX's chain of adds (for the loss scaler's 0/1 flags the
    same exact sum; for the global-norm clip's squared norms another
    summation order)."""
    xs = ctx.in_list("X")
    if len(xs) <= 2:
        return {"Out": xs[0] if len(xs) == 1 else xs[0] + xs[1]}
    return {"Out": torch.stack(xs).sum(0)}


def _dp_mean(impl, ctxs, walk):
    """The global mean: each rank's sum, the dp sum of those, over the
    global element count (the shards are equal)."""
    xs = [c.in_("X") for c in ctxs]
    return {"Out": walk.sum([x.sum() for x in xs])
            / (xs[0].numel() * walk.size)}


@register("mean", dp=_dp_mean)
def mean(ctx):
    return {"Out": ctx.in_("X").mean()}


def _reduces_rows(ctx):
    dims = ctx.attr("dim", [0])
    if ctx.attr("reduce_all", False) or dims is None:
        return True
    dims = dims if isinstance(dims, (list, tuple)) else [dims]
    return 0 in {d % ctx.in_("X").dim() for d in dims}


def _axes(ctx, x):
    """The dims a reduce op collapses, as a sorted tuple."""
    dims = ctx.attr("dim", [0])
    if ctx.attr("reduce_all", False) or dims is None:
        return tuple(range(x.dim()))
    dims = dims if isinstance(dims, (list, tuple)) else [dims]
    return tuple(sorted({d % x.dim() for d in dims}))


def _kept(out, shape, axes):
    """A reduction's result with the collapsed dims kept as 1s."""
    return out.reshape([1 if i in axes else s for i, s in enumerate(shape)])


def _one_dim_at_a_time(fn):
    """fn(x, dim) -> a reduction over a tuple of dims, the last first
    (torch's prod, all and any take one dim)."""
    def run(x, axes):
        for d in reversed(axes):
            x = fn(x, d)
        return x
    return run


def _float(x):
    # jnp.mean of an integer tensor is a float32 one
    return x if x.is_floating_point() else x.float()


_REDUCERS = {
    "reduce_sum": lambda x, axes: x.sum(dim=axes),
    "reduce_mean": lambda x, axes: _float(x).mean(dim=axes),
    "reduce_max": lambda x, axes: x.amax(dim=axes),
    "reduce_min": lambda x, axes: x.amin(dim=axes),
    "reduce_prod": _one_dim_at_a_time(torch.prod),
    "reduce_all": _one_dim_at_a_time(torch.all),
    "reduce_any": _one_dim_at_a_time(torch.any)}


def _reduce(fn):
    """A reduce op of fn(x, axes), with dim (default [0]), keep_dim and
    reduce_all as jnp's axis and keepdims."""
    def impl(ctx):
        x = ctx.in_("X")
        axes = _axes(ctx, x)
        out = fn(x, axes) if axes else x
        if ctx.attr("keep_dim", False):
            out = _kept(out, x.shape, axes)
        return {"Out": out}
    return impl


def _dp_reduce(impl, ctxs, walk):
    """A reduction that collapses dim 0 under dp: each rank's partial
    over its rows (its sum, for the sum and the mean), finished over the
    ranks into a replicated value (the dp sum, over the global count for
    the mean; the others reduce the ranks' partials, concatenated along
    dim 0, once more); one over other dims runs a rank's rows."""
    c = ctxs[0]
    if not _reduces_rows(c):
        return rows(impl, ctxs, walk)
    shape = c.in_("X").shape
    axes = _axes(c, c.in_("X"))
    if c.op.type in ("reduce_sum", "reduce_mean"):
        mean = c.op.type == "reduce_mean"
        out = walk.sum([_kept((_float(cc.in_("X")) if mean else cc.in_("X"))
                              .sum(dim=axes), shape, axes) for cc in ctxs])
        if mean:
            count = walk.size
            for d in axes:
                count *= shape[d]
            out = out / count
    else:
        fn = _REDUCERS[c.op.type]
        out = walk.cat([_kept(fn(cc.in_("X"), axes), shape, axes)
                        for cc in ctxs])
        out = _kept(fn(out, axes), shape, axes)
    if not c.attr("keep_dim", False):
        out = out.reshape([s for i, s in enumerate(shape) if i not in axes])
    return {"Out": out}


for _name, _fn in _REDUCERS.items():
    register(_name, dp=_dp_reduce)(_reduce(_fn))


@register("clip", dp=rows)
def clip(ctx):
    return {"Out": torch.clamp(ctx.in_("X"), ctx.attr("min"),
                               ctx.attr("max"))}


@register("clip_by_norm", dp=replicated)
def clip_by_norm(ctx):
    x = ctx.in_("X")
    norm = (x * x).sum().sqrt()
    scale = (ctx.attr("max_norm") / norm.clamp_min(1e-12)).clamp_max(1.0)
    return {"Out": x * scale}


@register("isfinite", dp=replicated)
def isfinite(ctx):
    """One device bool: every element finite (no host sync)."""
    return {"Out": torch.isfinite(ctx.in_("X")).all()}


@register("select_finite", dp=rows)
def select_finite(ctx):
    """X where the flag Finite is non-zero, else zeros: a NaN or inf X
    becomes 0 on an overflow step, where X * 0 would be NaN."""
    x, fin = ctx.in_("X"), ctx.in_("Finite")
    return {"Out": torch.where(fin != 0, x, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))}


@register("increment", dp=replicated)
def increment(ctx):
    """A new tensor x + step in x's dtype (never in place: a recomputed
    forward replays it from the same input)."""
    x = ctx.in_("X")
    step = ctx.attr("step", 1.0)
    return {"Out": x + (step if x.is_floating_point() else int(step))}


def _cmp(fn):
    def impl(ctx):
        x, y = ctx.in_("X"), ctx.in_("Y")
        y = _bcast_y(x, y, ctx.attr("axis", -1))
        return {"Out": fn(x, y)}
    return impl


register("equal", dp=rows)(_cmp(torch.eq))
register("greater_than", dp=rows)(_cmp(torch.gt))
register("greater_equal", dp=rows)(_cmp(torch.ge))
register("less_than", dp=rows)(_cmp(torch.lt))
register("less_equal", dp=rows)(_cmp(torch.le))
register("not_equal", dp=rows)(_cmp(torch.ne))
register("logical_and", dp=rows)(_cmp(torch.logical_and))
register("logical_or", dp=rows)(_cmp(torch.logical_or))
register("logical_xor", dp=rows)(_cmp(torch.logical_xor))


@register("logical_not", dp=rows)
def logical_not(ctx):
    return {"Out": torch.logical_not(ctx.in_("X"))}


def _axis_not_rows(ctx, walk):
    if ctx.attr("flatten", False):
        return "it flattens the batch"
    if ctx.attr("axis", -1) % ctx.in_("X").dim() == 0:
        return "its axis is dim 0"
    return None


@register("l2_normalize", "norm", dp=rows_if(_axis_not_rows))
def l2_normalize(ctx):
    """norm_op.h:65-71: epsilon inside the square root, norm =
    sqrt(sum(x^2) + eps), Out = x / norm; Norm keeps the reduced axis."""
    x = ctx.in_("X")
    norm = torch.sqrt((x * x).sum(ctx.attr("axis", -1), keepdim=True)
                      + ctx.attr("epsilon", 1e-10))
    return {"Out": x / norm, "Norm": norm}


@register("cumsum", dp=rows_if(_axis_not_rows))
def cumsum(ctx):
    """The running sum along `axis` (of the flattened x with `flatten`);
    `reverse` sums from the end; `exclusive` subtracts x from the
    inclusive sum, as the JAX package does."""
    x = ctx.in_("X")
    axis = ctx.attr("axis", -1)
    if ctx.attr("flatten", False):
        x, axis = x.reshape(-1), 0
    if ctx.attr("reverse", False):
        out = torch.flip(torch.cumsum(torch.flip(x, (axis,)), axis), (axis,))
    else:
        out = torch.cumsum(x, axis)
    if ctx.attr("exclusive", False):
        out = out - x
    return {"Out": out}


def _dp_any(impl, ctxs, walk):
    """A flag over the global tensor: each rank's, summed over dp."""
    flags = walk.sum([impl(c)["Out"].float().reshape(1) for c in ctxs])
    return {"Out": (flags > 0).reshape(())}


@register("has_inf", dp=_dp_any)
def has_inf(ctx):
    """One device bool, shape (): any entry infinite (no host read)."""
    return {"Out": torch.isinf(ctx.in_("X")).any()}


@register("has_nan", dp=_dp_any)
def has_nan(ctx):
    return {"Out": torch.isnan(ctx.in_("X")).any()}


@register("dot", dp=rows)
def dot(ctx):
    """Row-wise dot products over the last dim, kept as (..., 1)."""
    return {"Out": (ctx.in_("X") * ctx.in_("Y")).sum(-1, keepdim=True)}


@register("minus", dp=rows)
def minus(ctx):
    return {"Out": ctx.in_("X") - ctx.in_("Y")}


def _dp_total(impl, ctxs, walk):
    """A sum over the global tensor: each rank's, summed over dp."""
    return {"Out": walk.sum([impl(c)["Out"] for c in ctxs])}


@register("l1_norm", dp=_dp_total)
def l1_norm(ctx):
    """sum(|X|), a scalar."""
    return {"Out": ctx.in_("X").abs().sum()}


@register("squared_l2_norm", dp=_dp_total)
def squared_l2_norm(ctx):
    """sum(X^2), a scalar."""
    x = ctx.in_("X")
    return {"Out": (x * x).sum()}


@register("fill", dp=replicated)
def fill(ctx):
    """The attr `value` (a flat list) of `shape` in `dtype`."""
    return {"Out": host_tensor(
        ctx.attr("value", [0.0]), torch_dtype(ctx.attr("dtype", "float32")),
        ctx.device).reshape(tuple(ctx.attr("shape")))}


@register("conv_shift", dp=rows)
def conv_shift(ctx):
    """conv_shift_op (NTM's circular correlation): out[b, i] = sum_j
    x[b, (i + j - N // 2) mod M] y[b, j]."""
    x, y = ctx.in_("X"), ctx.in_("Y")
    n = y.shape[1]
    rolled = torch.stack([torch.roll(x, -(j - n // 2), 1) for j in range(n)],
                         1)
    return {"Out": torch.einsum("bnm,bn->bm", rolled, y)}
