"""Sequence ops: the LoD family with static shapes.

Parity: paddle/fluid/operators/sequence_ops/*; the counterpart of
``paddle_tpu/ops/sequence_ops.py``, all of it: ``sequence_mask``, the
(B, maxlen) validity mask of (B,) lengths, and the padded family, each
taking data ``(B, T, ...)`` and an explicit lengths tensor in place of
the reference's LoD offsets: ``sequence_pool``, ``_softmax``,
``_reverse``, ``_expand``, ``_pad``, ``_unpad``, ``_concat``,
``_slice``, ``_conv``, ``_enumerate``, ``_reshape``, ``_expand_as``,
``row_conv`` and ``sequence_erase``.

The JAX package's semantics are copied as they are, among them four
that a reader might take for slips:

- ``sequence_conv`` masks only at the ends of the padded T: inside T its
  context window reads the padding past a row's length;
- ``sequence_pool`` "MAX" turns an empty row (and any non-finite
  maximum) into 0;
- ``sequence_softmax`` fills the padding with -1e9 before the softmax;
- ``sequence_erase`` compacts the kept tokens stably, through an argsort
  of (dropped, position).

Integer outputs (``sequence_erase``'s lengths, ``MaxIndex``) are int64,
where the JAX package narrows them to int32 (ROADMAP C12).

Under data parallelism ``sequence_mask`` runs a rank's rows; where its
width is the data's (``maxlen`` None or negative and no static width),
that is the global batch's longest length, the ranks' maxima taken over
dp, not each rank's own. The per-row ops run a rank's rows where every
row-aligned input (the data, its lengths) is sharded with them; a
replicated lengths tensor beside sharded data (a ``fill_constant`` of
the global batch's size) refuses. ``sequence_expand`` runs a rank's rows
in its ``static_repeat`` form and in its uniform form (X and Y both
sharded); its ragged form takes its output row count from Y and its
segments from a cumsum of ``YLength``, which split over dp do not line
up with X's rows, so it refuses at dp > 1.
"""

import torch

from . import Sharded, register, rows_if, torch_dtype


def _mask(lengths, maxlen, dtype):
    """(B, maxlen) 1/0: y[i][j] = j < lengths[i]."""
    steps = torch.arange(maxlen, device=lengths.device)
    return (steps[None, :] < lengths.reshape(-1, 1)).to(dtype)


def lengths_or_full(lengths, n, full, device):
    """A lengths input as (n,) int64, or `full` for each of n rows where
    the op was given none."""
    if lengths is None:
        return torch.full((n,), full, dtype=torch.int64, device=device)
    return lengths.reshape(-1).long()


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


# -- the padded family --------------------------------------------------------

def unaligned(ctx, walk, slots):
    """Why the op's rows cannot be split over dp: one of `slots` that it
    has is replicated while another input is sharded (None: all are, or
    dp is 1 and one rank's rows are the batch)."""
    if walk.size == 1:
        return None
    for slot in slots:
        if ctx.op.input(slot) and not ctx.is_sharded(slot):
            return (f"its {slot} is replicated while another input is "
                    f"dp-sharded; the rows would not line up")
    return None


def rows_with(*slots):
    """``rows`` where each of `slots` that the op has is sharded (a
    rank's rows of every row-aligned input); a replicated one beside
    sharded data refuses."""
    return rows_if(lambda ctx, walk: unaligned(ctx, walk, slots))


_ROWS = rows_with("X", "Length")


def _trailing(m, x):
    """(B, T) -> (B, T, 1, ...) broadcastable against x (B, T, ...)."""
    return m.reshape(m.shape + (1,) * (x.dim() - 2))


@register("sequence_pool", dp=_ROWS)
def sequence_pool(ctx):
    """X (B, T, D) + Length -> Out (B, D): SUM, AVERAGE, SQRT (over the
    row's length, at least 1), MAX (an empty row gives 0), LAST (the
    row's last valid step; step 0 of an empty row) or FIRST. MaxIndex
    is zeros like Length (int64)."""
    x = ctx.in_("X")
    lengths = ctx.in_("Length")
    ptype = ctx.attr("pooltype", "AVERAGE").upper()
    m = _mask(lengths, x.shape[1], x.dtype)[..., None]
    if ptype == "SUM":
        out = (x * m).sum(1)
    elif ptype == "AVERAGE":
        out = (x * m).sum(1) / m.sum(1).clamp(min=1.0)
    elif ptype == "SQRT":
        out = (x * m).sum(1) / torch.sqrt(m.sum(1).clamp(min=1.0))
    elif ptype == "MAX":
        out = x.masked_fill(m <= 0, float("-inf")).amax(1)
        out = out.masked_fill(~torch.isfinite(out), 0.0)
    elif ptype == "LAST":
        idx = (lengths.reshape(-1) - 1).clamp(min=0)
        out = x[torch.arange(x.shape[0], device=x.device), idx]
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        raise NotImplementedError(f"sequence_pool type {ptype}")
    return {"Out": out, "MaxIndex": torch.zeros_like(lengths)}


@register("sequence_softmax", dp=_ROWS)
def sequence_softmax(ctx):
    """Softmax over each row's valid steps of X (B, T); the padding is
    filled with -1e9 first and comes out 0."""
    x = ctx.in_("X")
    m = _mask(ctx.in_("Length"), x.shape[-1], torch.bool)
    return {"Out": torch.softmax(x.masked_fill(~m, -1e9), dim=-1)
            * m.to(x.dtype)}


@register("sequence_reverse", dp=_ROWS)
def sequence_reverse(ctx):
    """Each row's valid steps reversed in place; the padding stays."""
    x = ctx.in_("X")
    lens = ctx.in_("Length").reshape(-1, 1)
    idx = torch.arange(x.shape[1], device=x.device)[None, :]
    rev = torch.where(idx < lens, lens - 1 - idx, idx)
    return {"Y": torch.gather(x, 1, _trailing(rev, x).expand_as(x))}


def _dp_sequence_expand(impl, ctxs, walk):
    ctx = ctxs[0]
    if ctx.op.input("YLength") and walk.size > 1:
        raise NotImplementedError(
            "op 'sequence_expand' under data parallelism: the ragged form "
            "takes its output rows from Y and its segments from a cumsum of "
            "YLength, which split over dp do not line up with X's rows")
    need = ("X",) if int(ctx.attr("static_repeat", 0)) else ("X", "Y")
    return rows_with(*need)(impl, ctxs, walk)


@register("sequence_expand", dp=_dp_sequence_expand)
def sequence_expand(ctx):
    """Repeat X's rows per Y's sequence lengths. The output row count is
    Y's static row count N; the ragged repeat counts (YLength) only steer
    a gather index (searchsorted over their cumsum), and rows past
    sum(YLength) are 0. ``static_repeat`` repeats every row that many
    times; with neither, rows expand uniformly to N // B each."""
    x = ctx.in_("X")
    reps = int(ctx.attr("static_repeat", 0))
    if reps:
        return {"Out": x.repeat_interleave(reps, dim=0)}
    y = ctx.in_("Y")
    y_len = ctx.in_("YLength")
    if y is None and y_len is None:
        raise ValueError("sequence_expand needs Y (for the static output "
                         "size) or static_repeat")
    n = y.shape[0] if y is not None else None
    if y_len is None:
        if n % x.shape[0]:
            raise ValueError(
                f"uniform sequence_expand: Y rows {n} not divisible by X "
                f"rows {x.shape[0]}; pass y_length for ragged expansion")
        return {"Out": x.repeat_interleave(n // x.shape[0], dim=0)}
    if n is None:
        raise ValueError("ragged sequence_expand needs Y for the static "
                         "output row count")
    starts = torch.cumsum(y_len.reshape(-1).long(), 0)
    pos = torch.arange(n, device=x.device)
    idx = torch.searchsorted(starts, pos, right=True).clamp(
        0, x.shape[0] - 1)
    out = x.index_select(0, idx)
    valid = (pos < starts[-1]).reshape((n,) + (1,) * (x.dim() - 1))
    return {"Out": torch.where(valid, out, torch.zeros_like(out))}


@register("sequence_pad", dp=_ROWS)
def sequence_pad(ctx):
    """The data is padded already: X and its lengths as they are."""
    return {"Out": ctx.in_("X"), "Length": ctx.in_("Length")}


@register("sequence_unpad", dp=_ROWS)
def sequence_unpad(ctx):
    """X with its padding zeroed (the static-shape unpad)."""
    x = ctx.in_("X")
    return {"Out": x * _trailing(_mask(ctx.in_("Length"), x.shape[1],
                                       x.dtype), x)}


@register("sequence_concat", dp=rows_with("X"))
def sequence_concat(ctx):
    """The inputs concatenated along the time axis."""
    return {"Out": torch.cat(ctx.in_list("X"), dim=1)}


@register("sequence_slice", dp=rows_with("X"))
def sequence_slice(ctx):
    """Steps [offset, offset + length) of every row; as
    ``lax.dynamic_slice`` the start is clamped so that the slice fits."""
    x = ctx.in_("X")
    length = ctx.attr("static_length", x.shape[1])
    offset = min(max(int(ctx.attr("static_offset", 0)), 0),
                 x.shape[1] - length)
    return {"Out": x.narrow(1, offset, length)}


@register("sequence_conv", dp=rows_with("X"))
def sequence_conv(ctx):
    """The context-window projection: X (B, T, D) -> (B, T, M) through
    Filter (contextLength * D, M), the window starting at contextStart.
    Only the ends of the padded T are masked: inside T the window reads
    the padding past a row's length (the JAX package's semantics)."""
    x = ctx.in_("X")
    w = ctx.in_("Filter")
    ctx_len = ctx.attr("contextLength", 3)
    ctx_start = ctx.attr("contextStart", -(ctx_len // 2))
    t = x.shape[1]
    steps = torch.arange(t, device=x.device)
    cols = []
    for i in range(ctx_len):
        shift = ctx_start + i
        valid = ((steps + shift >= 0) & (steps + shift < t)).to(x.dtype)
        cols.append(torch.roll(x, -shift, dims=1) * valid[None, :, None])
    return {"Out": torch.cat(cols, dim=-1) @ w}


@register("sequence_enumerate", dp=rows_with("X"))
def sequence_enumerate(ctx):
    """X (B, T) -> (B, T, win_size): the window of ids from each step,
    pad_value past the end of T."""
    x = ctx.in_("X")
    win = ctx.attr("win_size")
    pad = ctx.attr("pad_value", 0)
    t = x.shape[-1]
    steps = torch.arange(t, device=x.device)
    outs = [torch.where(steps + i < t, torch.roll(x, -i, dims=-1),
                        torch.full_like(x, pad)) for i in range(win)]
    return {"Out": torch.stack(outs, dim=-1)}


@register("sequence_reshape", dp=rows_with("X"))
def sequence_reshape(ctx):
    x = ctx.in_("X")
    return {"Out": x.reshape(x.shape[0], -1, ctx.attr("new_dim"))}


@register("sequence_expand_as", dp=rows_with("X"))
def sequence_expand_as(ctx):
    """Each row of X repeated Y.shape[1] times (once for a 1-D Y)."""
    x, y = ctx.in_("X"), ctx.in_("Y")
    reps = y.shape[1] if y.dim() > 1 else 1
    return {"Out": x.repeat_interleave(reps, dim=0)}


@register("row_conv", dp=rows_with("X"))
def row_conv(ctx):
    """The lookahead convolution: out[t] = sum_i Filter[i] * X[t + i],
    zero past the end of T."""
    x = ctx.in_("X")
    w = ctx.in_("Filter")
    t = x.shape[1]
    steps = torch.arange(t, device=x.device)
    out = torch.zeros_like(x)
    for i in range(w.shape[0]):
        valid = (steps + i < t).to(x.dtype)[None, :, None]
        out = out + torch.roll(x, -i, dims=1) * valid * w[i][None, None, :]
    return {"Out": out}


@register("sequence_erase", dp=_ROWS)
def sequence_erase(ctx):
    """Drop every occurrence of the given tokens from X (B, T), each row
    compacted stably to the left (an argsort of (dropped, position)) and
    its tail zeroed; Length gives the new lengths (int64)."""
    x = ctx.in_("X")
    t = x.shape[1]
    keep = _mask(lengths_or_full(ctx.in_("Length"), x.shape[0], t,
                                 x.device), t, torch.bool)
    for tok in ctx.attr("tokens", []):
        keep = keep & (x != tok)
    steps = torch.arange(t, device=x.device)[None, :]
    order = torch.argsort((~keep).long() * (t + 1) + steps, dim=1)
    compacted = torch.gather(x, 1, order)
    new_len = keep.sum(dim=1)
    return {"Out": compacted * _mask(new_len, t, compacted.dtype),
            "Length": new_len}
