"""Activation ops.

Parity: paddle/fluid/operators/activation_op.cc; the counterpart of
``paddle_tpu/ops/activation_ops.py`` with the activation the ported slice
runs: ``gelu``, in the exact erf form (the reference's gelu op; torch's
default, as ``jax.nn.gelu(approximate=False)``).
"""

import torch.nn.functional as F

from . import register


@register("gelu")
def gelu(ctx):
    return {"Out": F.gelu(ctx.in_("X"))}
