"""Activation ops.

Parity: paddle/fluid/operators/activation_op.cc (the full
fluid.layers.ops activation list); the counterpart of
``paddle_tpu/ops/activation_ops.py``, every op of it under the same
names, attributes and defaults. ``gelu`` is the exact erf form (the
reference's gelu op; torch's default, as
``jax.nn.gelu(approximate=False)``); ``round`` rounds half to even, as
``jnp.round`` does; ``softshrink``'s threshold is the attribute
``"lambda"``; ``maxout`` takes out channel c as the max of in channels
[c g, (c + 1) g) (a reshape and a max: torch has no maxout). Under data
parallelism each runs a rank's rows (``softmax`` and ``log_softmax``
where their axis is not dim 0; ``prelu`` with its Alpha replicated in
every mode). On a tp-sharded activation (a ``ShardedTensor``: the
column-parallel product's output) the elementwise ones run once a part
(``blockwise``); the normalizing ones read its global value.
"""

import torch
import torch.nn.functional as F

from . import blockwise, register, rows, rows_if, shard_rule


@register("gelu", dp=rows)
def gelu(ctx):
    return {"Out": F.gelu(ctx.in_("X"))}


@register("tanh", dp=rows)
def tanh(ctx):
    return {"Out": torch.tanh(ctx.in_("X"))}


def _axis_off_rows(ctx, walk):
    if ctx.attr("axis", -1) % ctx.in_("X").dim() == 0:
        return "it normalizes over dim 0"
    return None


@register("softmax", dp=rows_if(_axis_off_rows))
def softmax(ctx):
    return {"Out": torch.softmax(ctx.in_("X"), dim=ctx.attr("axis", -1))}


def _unary(fn):
    def impl(ctx):
        return {"Out": fn(ctx.in_("X"))}
    return impl


for _name, _fn in (("relu", torch.relu), ("sigmoid", torch.sigmoid),
                   ("exp", torch.exp), ("log", torch.log),
                   ("sqrt", torch.sqrt), ("ceil", torch.ceil),
                   ("floor", torch.floor), ("cos", torch.cos),
                   ("square", torch.square), ("sign", torch.sign)):
    register(_name, dp=rows)(_unary(_fn))


for _name, _fn in (("logsigmoid", F.logsigmoid),
                   ("tanh_shrink", lambda x: x - torch.tanh(x)),
                   ("rsqrt", torch.rsqrt), ("abs", torch.abs),
                   ("round", torch.round), ("sin", torch.sin),
                   ("acos", torch.acos), ("asin", torch.asin),
                   ("atan", torch.atan), ("reciprocal", torch.reciprocal),
                   ("softplus", F.softplus), ("softsign", F.softsign),
                   ("erf", torch.erf), ("selu", F.selu),
                   ("mish", lambda x: x * torch.tanh(F.softplus(x)))):
    register(_name, dp=rows)(_unary(_fn))


@register("log_softmax", dp=rows_if(_axis_off_rows))
def log_softmax(ctx):
    return {"Out": torch.log_softmax(ctx.in_("X"), dim=ctx.attr("axis", -1))}


@register("pow", dp=rows)
def pow_op(ctx):
    factor = ctx.in_("FactorTensor", ctx.attr("factor", 1.0))
    return {"Out": torch.pow(ctx.in_("X"), factor)}


def _where_pos(x, neg):
    """x where x > 0, else `neg` (a tensor of x's shape or a scalar)."""
    return torch.where(x > 0, x, neg)


@register("leaky_relu", dp=rows)
def leaky_relu(ctx):
    x = ctx.in_("X")
    return {"Out": _where_pos(x, ctx.attr("alpha", 0.02) * x)}


@register("elu", dp=rows)
def elu(ctx):
    return {"Out": F.elu(ctx.in_("X"), ctx.attr("alpha", 1.0))}


@register("relu6", dp=rows)
def relu6(ctx):
    return {"Out": torch.clamp(ctx.in_("X"), 0.0,
                               ctx.attr("threshold", 6.0))}


@register("brelu", dp=rows)
def brelu(ctx):
    return {"Out": torch.clamp(ctx.in_("X"), ctx.attr("t_min", 0.0),
                               ctx.attr("t_max", 24.0))}


@register("soft_relu", dp=rows)
def soft_relu(ctx):
    t = ctx.attr("threshold", 40.0)
    return {"Out": torch.log1p(torch.exp(torch.clamp(ctx.in_("X"), -t, t)))}


@register("swish", dp=rows)
def swish(ctx):
    x = ctx.in_("X")
    return {"Out": x * torch.sigmoid(ctx.attr("beta", 1.0) * x)}


@register("hard_swish", dp=rows)
def hard_swish(ctx):
    x = ctx.in_("X")
    return {"Out": x * torch.clamp(x + ctx.attr("offset", 3.0), 0.0,
                                   ctx.attr("threshold", 6.0))
            / ctx.attr("scale", 6.0)}


@register("hard_sigmoid", dp=rows)
def hard_sigmoid(ctx):
    return {"Out": torch.clamp(ctx.attr("slope", 0.2) * ctx.in_("X")
                               + ctx.attr("offset", 0.5), 0.0, 1.0)}


def _zeros_where(keep, x):
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


@register("hard_shrink", dp=rows)
def hard_shrink(ctx):
    x = ctx.in_("X")
    return {"Out": _zeros_where(x.abs() > ctx.attr("threshold", 0.5), x)}


@register("softshrink", dp=rows)
def softshrink(ctx):
    lam = ctx.attr("lambda", 0.5)
    x = ctx.in_("X")
    return {"Out": torch.where(x > lam, x - lam,
                               _zeros_where(x < -lam, x + lam))}


@register("thresholded_relu", dp=rows)
def thresholded_relu(ctx):
    x = ctx.in_("X")
    return {"Out": _zeros_where(x > ctx.attr("threshold", 1.0), x)}


@register("stanh", dp=rows)
def stanh(ctx):
    return {"Out": ctx.attr("scale_b", 1.7159) * torch.tanh(
        ctx.attr("scale_a", 0.67) * ctx.in_("X"))}


def _alpha_replicated(ctx, walk):
    if ctx.is_sharded("Alpha"):
        return "its Alpha is dp-sharded"
    return None


@register("prelu", dp=rows_if(_alpha_replicated))
def prelu(ctx):
    """mode "all" (one alpha), "channel" (one a channel, dim 1) or
    "element" (one an element of a sample, broadcast over rows)."""
    x, alpha = ctx.in_("X"), ctx.in_("Alpha")
    if ctx.attr("mode", "all") == "channel" and alpha.numel() > 1:
        alpha = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    return {"Out": _where_pos(x, alpha * x)}


@register("maxout", dp=rows)
def maxout(ctx):
    x = ctx.in_("X")  # NCHW
    g = ctx.attr("groups")
    n, c = x.shape[:2]
    return {"Out": x.reshape((n, c // g, g) + tuple(x.shape[2:])).amax(2)}


# the elementwise activations take a sharded X part by part
shard_rule(
    "gelu", "tanh", "relu", "sigmoid", "exp", "log", "sqrt", "ceil", "floor",
    "cos", "square", "sign", "logsigmoid", "tanh_shrink", "rsqrt", "abs",
    "round", "sin", "acos", "asin", "atan", "reciprocal", "softplus",
    "softsign", "erf", "selu", "mish", "pow", "leaky_relu", "elu", "relu6",
    "brelu", "soft_relu", "swish", "hard_swish", "hard_sigmoid",
    "hard_shrink", "softshrink", "thresholded_relu", "stanh")(blockwise)
