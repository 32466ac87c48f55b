"""Sequence ops: the LoD family with static shapes.

Parity: paddle/fluid/operators/sequence_ops/sequence_mask_op.h; the
counterpart of ``paddle_tpu/ops/sequence_ops.py`` with the op the ported
slices run: ``sequence_mask``, the (B, maxlen) validity mask of (B,)
lengths that the Transformer turns into its padding biases and its
masked loss, and DIN into its history mask. The rest of the file (the
padded ``(batch, max_len, ...)`` + lengths ops: pool, softmax, expand,
reverse, ...) is ROADMAP queue A item 10c.6.

Under data parallelism ``sequence_mask`` runs a rank's rows; where its
width is the data's (``maxlen`` None or negative and no static width),
that is the global batch's longest length, the ranks' maxima taken over
dp, not each rank's own.
"""

import torch

from . import Sharded, register, torch_dtype


def _mask(lengths, maxlen, dtype):
    """(B, maxlen) 1/0: y[i][j] = j < lengths[i]."""
    steps = torch.arange(maxlen, device=lengths.device)
    return (steps[None, :] < lengths.reshape(-1, 1)).to(dtype)


def _width(ctx):
    """The mask's width where the op fixes it (maxlen, or the layer's
    static width), else None: the data's longest length."""
    maxlen = ctx.attr("maxlen", -1)
    if maxlen is None or maxlen < 0:
        return int(ctx.attr("static_maxlen", 0)) or None
    return maxlen


def _dp_sequence_mask(impl, ctxs, walk):
    """A rank's rows; a data-dependent width is the global batch's
    longest length (each rank's maximum, concatenated over dp)."""
    width = _width(ctxs[0])
    if width is None:
        peaks = walk.cat([c.in_("X").reshape(-1).max().reshape(1)
                          for c in ctxs])
        width = int(peaks.max())
    dtype = torch_dtype(ctxs[0].attr("out_dtype", "int64"))
    return {"Y": Sharded([_mask(c.in_("X").reshape(-1), width, dtype)
                          for c in ctxs])}


@register("sequence_mask", dp=_dp_sequence_mask)
def sequence_mask(ctx):
    """Y (B, maxlen) in out_dtype from X's (B,) (or (B, 1)) lengths;
    maxlen None or < 0 means the static width, else the longest
    length. int64 stays int64 (the port keeps 64-bit ints on the
    device; the JAX package narrows them to int32)."""
    x = ctx.in_("X").reshape(-1)
    width = _width(ctx)
    if width is None:
        width = int(x.max())
    return {"Y": _mask(x, width,
                       torch_dtype(ctx.attr("out_dtype", "int64")))}
