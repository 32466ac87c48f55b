"""Fake-quantization ops (QAT and PTQ).

Parity: paddle/fluid/operators/fake_quantize_op.* and
fake_dequantize_op.*; the counterpart of ``paddle_tpu/ops/quant_ops.py``,
every op of it: the abs-max, channel-wise, static-scale, moving-average
and range quantize-dequantize ops, the two dequantize ops and the
``moving_average_abs_max_scale`` observer.

Quantize-dequantize rounds with a straight-through estimator
(``_SteRound``: ``torch.round``, half to even as ``jnp.round``, with an
identity backward). The clip is ``minimum(maximum(x, -s), s)``, whose
backward splits a tie at the bound half and half between x and the
scale, as ``jnp.clip``'s does (``torch.clamp`` would pass all of it to
x); the scale keeps its gradient, as in JAX, and the abs-max is an
``amax``, which splits a tie between equal maxima evenly, as ``jnp.max``
does.

The moving-average scale is a persistable variable read as InScale and
written as OutScale under one name, so it accumulates across
``Executor.run`` calls; ``is_test`` reads it without updating it. Under
data parallelism a scale that is an abs-max of a dp-sharded input is the
global batch's: each rank's abs-max, one dp gather, their max (so the
scale and its moving average equal dp 1's); the per-channel ops take a
sharded input along their channel axis only.
"""

import torch

from . import Sharded, register, rows, rows_if


class _SteRound(torch.autograd.Function):
    """round(x), half to even, with the gradient passed straight
    through."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def quant_dequant(x, scale, bits=8):
    """Symmetric fake quant: round(clip(x) / scale * qmax) * scale /
    qmax, the gradient the identity inside the clip range (STE)."""
    qmax = float(2 ** (bits - 1) - 1)
    scale = torch.clamp_min(scale, 1e-8)
    xc = torch.minimum(torch.maximum(x, -scale), scale)
    return _SteRound.apply(xc / scale * qmax) * scale / qmax


def abs_max(x):
    return torch.amax(torch.abs(x))


def channel_abs_max(x, channel_axis=0):
    axes = tuple(i for i in range(x.dim()) if i != channel_axis % x.dim())
    return torch.amax(torch.abs(x), dim=axes)


def _scalar(value, like):
    """A 0-d f32 tensor on `like`'s device, filled there (a tensor made
    from a host value on the card would sync)."""
    return torch.full((), float(value), dtype=torch.float32,
                      device=like.device)


def _dp_global_max(impl, ctxs, walk):
    """The global batch's abs-max of X: each rank's, one dp gather,
    their max; then each rank's Out with that scale (sharded) and the
    other outputs (the scale) replicated."""
    cur = walk.cat([abs_max(c.in_("X")).reshape(1) for c in ctxs]).amax()
    outs = [impl(c, cur=cur) for c in ctxs]
    res = {k: v for k, v in outs[0].items() if k != "Out"}
    res["Out"] = Sharded([o["Out"] for o in outs])
    return res


@register("fake_quantize_dequantize_abs_max", "fake_quantize_abs_max",
          dp=_dp_global_max)
def fake_quantize_abs_max(ctx, cur=None):
    x = ctx.in_("X")
    bits = ctx.attr("bit_length", 8)
    scale = abs_max(x) if cur is None else cur
    return {"Out": quant_dequant(x, scale, bits), "OutScale": scale}


def _channel_rows(ctx, walk):
    if walk.size > 1 and ctx.attr("quant_axis", 0) % ctx.in_("X").dim():
        return "its channel axis is not dim 0 (the ranks' rows)"
    return None


@register("fake_channel_wise_quantize_dequantize_abs_max",
          "fake_channel_wise_quantize_abs_max", dp=rows_if(_channel_rows))
def fake_channel_wise_quantize_abs_max(ctx):
    x = ctx.in_("X")
    bits = ctx.attr("bit_length", 8)
    axis = ctx.attr("quant_axis", 0)
    scale = channel_abs_max(x, axis)
    shape = [1] * x.dim()
    shape[axis] = -1
    return {"Out": quant_dequant(x, scale.reshape(shape), bits),
            "OutScale": scale}


@register("quantize_dequantize_static_scale", dp=rows)
def quantize_dequantize_static_scale(ctx):
    """PTQ: the scale calibrated offline, an attr."""
    x = ctx.in_("X")
    return {"Out": quant_dequant(x, _scalar(ctx.attr("scale", 1.0), x),
                                 ctx.attr("bit_length", 8))}


def _ema(ctx, x, in_scale, cur):
    """rate x InScale + (1 - rate) x the batch's abs-max (`cur`, the
    global batch's under dp)."""
    rate = ctx.attr("moving_rate", 0.9)
    cur = abs_max(x) if cur is None else cur
    return rate * in_scale + (1.0 - rate) * cur, cur


@register("fake_quantize_dequantize_moving_average_abs_max",
          "fake_quantize_moving_average_abs_max", dp=_dp_global_max)
def fake_quantize_moving_average_abs_max(ctx, cur=None):
    """Activation fake quant: the scale an EMA of the batch abs-max,
    InScale / OutScale one persistable; in test mode the stored scale,
    not updated."""
    x = ctx.in_("X")
    in_scale = ctx.in_("InScale")
    scale = in_scale if ctx.is_test else _ema(ctx, x, in_scale, cur)[0]
    return {"Out": quant_dequant(x, scale.reshape(()),
                                 ctx.attr("bit_length", 8)),
            "OutScale": scale}


@register("fake_dequantize_max_abs", dp=rows)
def fake_dequantize_max_abs(ctx):
    """Out = X x Scale / max_range (an int8 tensor back to float)."""
    x = ctx.in_("X").float()
    scale = ctx.in_("Scale").reshape(())
    return {"Out": x * scale / float(ctx.attr("max_range", 127.0))}


def _dequant_channel_rows(ctx, walk):
    if walk.size > 1 and not ctx.attr("quant_axis", 0) % ctx.in_("X").dim():
        return "its per-channel scales run along dim 0 (the ranks' rows)"
    return None


@register("fake_channel_wise_dequantize_max_abs",
          dp=rows_if(_dequant_channel_rows))
def fake_channel_wise_dequantize_max_abs(ctx):
    """Scales[0] per channel along quant_axis over 2^(bits[0] - 1) - 1;
    each further scale (an activation's) divides out over its own bits'
    range. Scales is the slot's every name (the JAX Executor's ``in_``
    hands its op only the first)."""
    x = ctx.in_("X").float()
    scales = ctx.in_list("Scales")
    ch, rest = scales[0], scales[1:]
    bits = ctx.attr("quant_bits", [8])
    axis = ctx.attr("quant_axis", 0)
    qmax = float(2 ** (int(bits[0]) - 1) - 1)
    shape = [1] * x.dim()
    shape[axis] = -1
    out = x * ch.reshape(shape) / qmax
    for i, s in enumerate(rest):
        b = int(bits[i + 1]) if i + 1 < len(bits) else 8
        out = out * s.reshape(()) / float(2 ** (b - 1) - 1)
    return {"Out": out}


@register("fake_quantize_range_abs_max", dp=_dp_global_max)
def fake_quantize_range_abs_max(ctx, cur=None):
    """range_abs_max as the JAX package reduces it: an EMA of the batch
    abs-max, which adopts the batch's outright while the state is still
    0."""
    x = ctx.in_("X")
    in_scale = ctx.in_("InScale").reshape(())
    if ctx.is_test:
        scale = in_scale
    else:
        ema, cur = _ema(ctx, x, in_scale, cur)
        scale = torch.where(in_scale > 0, ema, cur)
    return {"Out": quant_dequant(x, scale, ctx.attr("bit_length", 8)),
            "OutScale": scale}


@register("moving_average_abs_max_scale", dp=_dp_global_max)
def moving_average_abs_max_scale(ctx, cur=None):
    """The scale observer: Out is X; OutScale the EMA of the batch
    abs-max (from 0 without an InScale)."""
    x = ctx.in_("X")
    in_scale = ctx.in_("InScale").reshape(()) if ctx.has_in("InScale") \
        else _scalar(0.0, x)
    scale = in_scale if ctx.is_test else _ema(ctx, x, in_scale, cur)[0]
    return {"Out": x, "OutScale": scale}
