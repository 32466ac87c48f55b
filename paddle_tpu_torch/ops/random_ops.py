"""Random ops.

Parity: paddle/fluid/operators/{gaussian_random,uniform_random,truncated_
gaussian_random,random_crop,sampling_id,...}_op.*; the counterpart of
``paddle_tpu/ops/random_ops.py``, every op of it under the same names and
attributes. Each op draws from its own ``torch.Generator`` on the
Executor's device, seeded per (program seed, step, op seed)
(``OpContext.rng``): reproducible per seed, but not JAX's numbers
(ROADMAP C17). Integer draws are int64 (C12's policy).

Under data parallelism the ops without inputs run once (replicated); the
ops over a sharded X (``sampling_id``, ``multinomial``, ``bernoulli``,
``random_crop`` of trailing dims) draw a rank's rows, a rank r > 0 with r
folded into its seed (C16); the ``*_batch_size_like`` ops read the
global batch (``_dp_batch_size_like``).
"""

import math

import torch

from . import register, replicated, rows, rows_if, torch_dtype, \
    whole_context


def _batch_like_shape(ctx, size=None):
    """The attr shape with dim output_dim_idx set to Input's dim
    input_dim_idx (or to `size`)."""
    shape = list(ctx.attr("shape"))
    if size is None:
        size = ctx.in_("Input").shape[ctx.attr("input_dim_idx", 0)]
    shape[ctx.attr("output_dim_idx", 0)] = int(size)
    return tuple(shape)


def _dp_batch_size_like(impl, ctxs, walk):
    """With Input's rows in the output's rows (both dim indices 0) each
    rank draws its own rows, so the global output has the global batch;
    otherwise the op runs once on rank 0's stream at the global size of
    Input's dim (rows x dp where that dim is the batch) and its output
    is replicated."""
    ctx = ctxs[0]
    in_idx = ctx.attr("input_dim_idx", 0)
    if in_idx == 0 and ctx.attr("output_dim_idx", 0) == 0:
        return rows(impl, ctxs, walk)
    size = ctx.in_("Input").shape[in_idx] * (walk.size if in_idx == 0
                                             else 1)
    return impl(whole_context(ctx, walk), _batch_like_shape(ctx, size))


def _uniform(ctx, shape):
    out = torch.empty(shape, dtype=torch_dtype(ctx.attr("dtype", "float32")),
                      device=ctx.device)
    return {"Out": out.uniform_(ctx.attr("min", -1.0), ctx.attr("max", 1.0),
                                generator=ctx.rng())}


def _gaussian(ctx, shape):
    x = torch.randn(shape, generator=ctx.rng(),
                    dtype=torch_dtype(ctx.attr("dtype", "float32")),
                    device=ctx.device)
    return {"Out": ctx.attr("mean", 0.0) + ctx.attr("std", 1.0) * x}


@register("gaussian_random", dp=replicated)
def gaussian_random(ctx):
    return _gaussian(ctx, tuple(ctx.attr("shape")))


@register("uniform_random", "uniform_random_batch_size_like",
          dp=_dp_batch_size_like)
def uniform_random(ctx, shape=None):
    """U[min, max) of the attr shape, or (with an Input) of the shape
    with dim output_dim_idx set to Input's dim input_dim_idx (the
    uniform_random_batch_size_like layer appends this op so)."""
    if shape is None:
        shape = _batch_like_shape(ctx) if ctx.has_in("Input") \
            else tuple(ctx.attr("shape"))
    return _uniform(ctx, shape)


@register("gaussian_random_batch_size_like", dp=_dp_batch_size_like)
def gaussian_random_batch_size_like(ctx, shape=None):
    return _gaussian(ctx, shape or _batch_like_shape(ctx))


@register("truncated_gaussian_random", dp=replicated)
def truncated_gaussian_random(ctx):
    """mean + std x a standard normal truncated to [-2, 2]: the inverse
    CDF of a uniform draw between Phi(-2) and Phi(2), clamped to the
    bounds (f32 rounding at the ends)."""
    shape = tuple(ctx.attr("shape"))
    dtype = torch_dtype(ctx.attr("dtype", "float32"))
    lo, hi = (0.5 * (1 + math.erf(b / math.sqrt(2))) for b in (-2.0, 2.0))
    u = torch.empty(shape, dtype=torch.float32, device=ctx.device)
    u.uniform_(2 * lo - 1, 2 * hi - 1, generator=ctx.rng())
    z = (math.sqrt(2.0) * torch.erfinv(u)).clamp_(-2.0, 2.0)
    return {"Out": (ctx.attr("mean", 0.0) + ctx.attr("std", 1.0) * z)
            .to(dtype)}


@register("randint", dp=replicated)
def randint(ctx):
    """Integers in [low, high), int64."""
    return {"Out": torch.randint(ctx.attr("low", 0), ctx.attr("high"),
                                 tuple(ctx.attr("shape")),
                                 generator=ctx.rng(), device=ctx.device)}


def _categorical(ctx, x, n):
    """`n` draws (with replacement) a row of the categorical with the
    row's weights x (clamped to 1e-20, as the JAX op's log): (rows, n)
    int64."""
    flat = x.reshape(-1, x.shape[-1]).float().clamp_min(1e-20)
    out = torch.multinomial(flat, n, replacement=True, generator=ctx.rng())
    return out.reshape(tuple(x.shape[:-1]) + (n,))


@register("sampling_id", dp=rows)
def sampling_id(ctx):
    """One id a row of the (N, C) probabilities X: (N,) int64."""
    return {"Out": _categorical(ctx, ctx.in_("X"), 1)[..., 0]}


@register("multinomial", dp=rows)
def multinomial(ctx):
    return {"Out": _categorical(ctx, ctx.in_("X"),
                                ctx.attr("num_samples", 1))}


@register("bernoulli", dp=rows)
def bernoulli(ctx):
    """1 with probability X, else 0, in X's dtype."""
    x = ctx.in_("X")
    return {"Out": torch.bernoulli(x, generator=ctx.rng())}


def _crop_keeps_rows(ctx, walk):
    if len(ctx.attr("shape")) >= ctx.in_("X").dim():
        return "it crops dim 0"
    return None


@register("random_crop", dp=rows_if(_crop_keeps_rows))
def random_crop(ctx):
    """The trailing len(shape) dims cut to `shape` at one start a dim,
    drawn in [0, dim - size] and gathered on the device (no host read
    of the starts)."""
    x = ctx.in_("X")
    shape = ctx.attr("shape")
    lead = x.dim() - len(shape)
    gen = ctx.rng()
    out = x
    for i, s in enumerate(shape):
        dim = lead + i
        start = torch.randint(0, x.shape[dim] - s + 1, (1,), generator=gen,
                              device=x.device)
        idx = start + torch.arange(s, device=x.device)
        out = out.index_select(dim, idx)
    return {"Out": out}
