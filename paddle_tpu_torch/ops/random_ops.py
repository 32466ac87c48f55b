"""Random ops.

Parity: paddle/fluid/operators/{uniform_random,gaussian_random}_op.*; the
counterpart of ``paddle_tpu/ops/random_ops.py`` with the ops the GPT
startup program and the Normal initializer run. Each op draws from its own
``torch.Generator`` on the Executor's device, seeded per (program seed,
step, op seed) (``OpContext.rng``): reproducible, but not JAX's numbers.
"""

import torch

from . import register, replicated, torch_dtype


@register("gaussian_random", dp=replicated)
def gaussian_random(ctx):
    shape = tuple(ctx.attr("shape"))
    dtype = torch_dtype(ctx.attr("dtype", "float32"))
    x = torch.randn(shape, generator=ctx.rng(), dtype=dtype,
                    device=ctx.device)
    return {"Out": ctx.attr("mean", 0.0) + ctx.attr("std", 1.0) * x}


@register("uniform_random", dp=replicated)
def uniform_random(ctx):
    shape = tuple(ctx.attr("shape"))
    dtype = torch_dtype(ctx.attr("dtype", "float32"))
    out = torch.empty(shape, dtype=dtype, device=ctx.device)
    out.uniform_(ctx.attr("min", -1.0), ctx.attr("max", 1.0),
                 generator=ctx.rng())
    return {"Out": out}
