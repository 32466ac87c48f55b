"""Elementwise / matmul / reduction ops.

Parity: paddle/fluid/operators/elementwise/*, matmul_op.cc, mul_op.cc,
mean_op.cc; the counterpart of ``paddle_tpu/ops/math_ops.py`` with the ops
the ported slice runs: ``elementwise_add``, ``mul``, ``matmul``, ``mean``.
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
