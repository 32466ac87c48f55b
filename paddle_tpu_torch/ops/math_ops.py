"""Elementwise / matmul / reduction ops.

Parity: paddle/fluid/operators/elementwise/*, matmul_op.cc, mul_op.cc,
mean_op.cc, reduce_ops/*, scale_op.cc, compare_op.cc; the counterpart of
``paddle_tpu/ops/math_ops.py`` with the ops the ported slices run:
``elementwise_add``/``mul``/``div``, ``scale``, ``mul``, ``matmul``,
``reduce_sum``, ``mean``, and the comparisons ``equal``, ``greater_than``
and ``logical_and`` (the packed GPT net's pair weights).
"""

import torch

from . import register


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


register("elementwise_add")(_ew(torch.add))
register("elementwise_mul")(_ew(torch.mul))
register("elementwise_div")(_ew(torch.div))


@register("scale")
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


@register("mul")
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


@register("matmul")
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


@register("mean")
def mean(ctx):
    return {"Out": ctx.in_("X").mean()}


@register("reduce_sum")
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


def _cmp(fn):
    def impl(ctx):
        x, y = ctx.in_("X"), ctx.in_("Y")
        y = _bcast_y(x, y, ctx.attr("axis", -1))
        return {"Out": fn(x, y)}
    return impl


register("equal")(_cmp(torch.eq))
register("greater_than")(_cmp(torch.gt))
register("logical_and")(_cmp(torch.logical_and))
