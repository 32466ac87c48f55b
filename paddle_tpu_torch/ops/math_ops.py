"""Elementwise / matmul / reduction ops.

Parity: paddle/fluid/operators/elementwise/*, matmul_op.cc, mul_op.cc,
mean_op.cc, reduce_ops/*, scale_op.cc, sum_op.cc, clip_op.cc,
compare_op.cc, isfinite_op.cc, increment_op.cc; the counterpart of
``paddle_tpu/ops/math_ops.py`` with the ops the ported slices run:
``elementwise_add``/``sub``/``mul``/``div``/``max``/``min``/``pow``,
``scale``, ``mul``, ``matmul``, ``sum``, ``reduce_sum``, ``mean``,
``clip``, ``clip_by_norm``, ``isfinite``, ``increment``, and the
comparisons ``equal``, ``greater_than``, ``greater_equal``, ``less_than``
and ``logical_and``.

Under data parallelism (``ops/__init__.py``'s rules) the elementwise
ops, ``scale``, ``sum``, ``clip``, ``select_finite`` and the comparisons
run a rank's rows; ``mul`` and ``matmul`` do so against a replicated
weight (``matmul`` also between two sharded batches of matrices);
``mean`` and ``reduce_sum`` over dim 0 finish each rank's partial sum
with the mesh's dp sum (``mean`` divides by the global count);
``clip_by_norm``, ``isfinite`` and ``increment`` take replicated inputs
only.

``select_finite`` is the port's own: the loss scaler's overflow step
(amp/decorator.py) zeroes the gradients with it, where the JAX package
multiplies them by the finite flag (ROADMAP C8).
"""

import torch

from . import register, replicated, rows, rows_if


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


def _weight_replicated(ctx, walk):
    if ctx.is_sharded("Y"):
        return "the weight Y is dp-sharded"
    return None


@register("mul", dp=rows_if(_weight_replicated))
def mul(ctx):
    """fluid mul: flatten x to 2-D at x_num_col_dims, matmul."""
    x, y = ctx.in_("X"), ctx.in_("Y")
    xnc = ctx.attr("x_num_col_dims", 1)
    ync = ctx.attr("y_num_col_dims", 1)
    xs, ys = x.shape, y.shape
    x2 = x.reshape((-1, _prod(xs[xnc:])))
    y2 = y.reshape((_prod(ys[:ync]), -1))
    out = x2 @ y2
    return {"Out": out.reshape(tuple(xs[:xnc]) + tuple(ys[ync:]))}


def _matmul_rows(ctx, walk):
    if not ctx.is_sharded("X"):
        return "a replicated X times a dp-sharded Y"
    if ctx.is_sharded("Y") and min(ctx.in_("X").dim(),
                                   ctx.in_("Y").dim()) < 3:
        return "two dp-sharded 2-D operands (not a batch of matrices)"
    return None


@register("matmul", dp=rows_if(_matmul_rows))
def matmul(ctx):
    x, y = ctx.in_("X"), ctx.in_("Y")
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


def _dp_reduce_sum(impl, ctxs, walk):
    """A sum that collapses dim 0 (or everything) is each rank's partial
    finished by the dp sum; one over other dims runs a rank's rows."""
    if not _reduces_rows(ctxs[0]):
        return rows(impl, ctxs, walk)
    return {"Out": walk.sum([impl(c)["Out"] for c in ctxs])}


@register("reduce_sum", dp=_dp_reduce_sum)
def reduce_sum(ctx):
    x = ctx.in_("X")
    dims = ctx.attr("dim", [0])
    keep = ctx.attr("keep_dim", False)
    if ctx.attr("reduce_all", False) or dims is None:
        out = x.sum()
        return {"Out": out.reshape([1] * x.dim()) if keep else out}
    dims = dims if isinstance(dims, (list, tuple)) else [dims]
    return {"Out": x.sum(dim=tuple(d % x.dim() for d in dims),
                         keepdim=keep)}


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
register("logical_and", dp=rows)(_cmp(torch.logical_and))
