"""Activation ops.

Parity: paddle/fluid/operators/activation_op.cc; the counterpart of
``paddle_tpu/ops/activation_ops.py`` with the activations the ported
slices run: ``gelu``, in the exact erf form (the reference's gelu op;
torch's default, as ``jax.nn.gelu(approximate=False)``), ``tanh`` and
``softmax``.
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
