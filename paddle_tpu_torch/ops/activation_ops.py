"""Activation ops.

Parity: paddle/fluid/operators/activation_op.cc; the counterpart of
``paddle_tpu/ops/activation_ops.py`` with the activations the ported
slices run: ``gelu``, in the exact erf form (the reference's gelu op;
torch's default, as ``jax.nn.gelu(approximate=False)``), ``tanh``,
``softmax``, ``relu``, ``sigmoid`` (SE-ResNeXt's excitation), and the
unary ops of the learning-rate schedules, the global-norm clip and L1
decay: ``exp``, ``sqrt``, ``ceil``, ``floor``,
``cos``, ``square`` and ``sign``. Under data parallelism each runs a
rank's rows (``softmax`` where its axis is not dim 0).
"""

import torch
import torch.nn.functional as F

from . import register, rows, rows_if


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
                   ("exp", torch.exp),
                   ("sqrt", torch.sqrt), ("ceil", torch.ceil),
                   ("floor", torch.floor), ("cos", torch.cos),
                   ("square", torch.square), ("sign", torch.sign)):
    register(_name, dp=rows)(_unary(_fn))
