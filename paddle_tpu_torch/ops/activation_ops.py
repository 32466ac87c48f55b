"""Activation ops.

Parity: paddle/fluid/operators/activation_op.cc; the counterpart of
``paddle_tpu/ops/activation_ops.py`` with the activations the ported
slices run: ``gelu``, in the exact erf form (the reference's gelu op;
torch's default, as ``jax.nn.gelu(approximate=False)``), ``tanh``,
``softmax``, ``relu``, and the unary ops of the learning-rate schedules, the
global-norm clip and L1 decay: ``exp``, ``sqrt``, ``ceil``, ``floor``,
``cos``, ``square`` and ``sign``.
"""

import torch
import torch.nn.functional as F

from . import register


@register("gelu")
def gelu(ctx):
    return {"Out": F.gelu(ctx.in_("X"))}


@register("tanh")
def tanh(ctx):
    return {"Out": torch.tanh(ctx.in_("X"))}


@register("softmax")
def softmax(ctx):
    return {"Out": torch.softmax(ctx.in_("X"), dim=ctx.attr("axis", -1))}


def _unary(fn):
    def impl(ctx):
        return {"Out": fn(ctx.in_("X"))}
    return impl


register("relu")(_unary(torch.relu))
register("exp")(_unary(torch.exp))
register("sqrt")(_unary(torch.sqrt))
register("ceil")(_unary(torch.ceil))
register("floor")(_unary(torch.floor))
register("cos")(_unary(torch.cos))
register("square")(_unary(torch.square))
register("sign")(_unary(torch.sign))
