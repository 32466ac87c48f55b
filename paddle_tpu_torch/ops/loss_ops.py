"""Loss ops.

Parity: paddle/fluid/operators/{cross_entropy,
softmax_with_cross_entropy,sigmoid_cross_entropy_with_logits}_op.*,
square_error_cost (the reference's squared_l2_distance); the counterpart
of ``paddle_tpu/ops/loss_ops.py`` with the losses the ported slices run.
Under data parallelism each gives a rank's rows their loss rows; where
``sigmoid_cross_entropy_with_logits`` normalizes, it divides by the
global batch's count of unmasked labels (a dp sum), not each rank's.
"""

import torch

from . import Sharded, register, rows, rows_if


def _squeeze_label(label):
    if label.dim() >= 1 and label.shape[-1] == 1:
        return label.reshape(label.shape[:-1])
    return label


def _class_axis_off_rows(ctx, walk):
    if ctx.attr("axis", -1) % ctx.in_("Logits").dim() == 0:
        return "its class axis is dim 0"
    return None


@register("cross_entropy", "cross_entropy2", dp=rows)
def cross_entropy(ctx):
    """X holds probabilities: the log of clip(X, 1e-15, 1), then the hard
    label's negative log-probability (0 where the label is ignore_index)
    or the soft labels' weighted sum."""
    x, label = ctx.in_("X"), ctx.in_("Label")
    logp = torch.log(torch.clamp(x, 1e-15, 1.0))
    if ctx.attr("soft_label", False):
        loss = -(label * logp).sum(dim=-1, keepdim=True)
    else:
        lbl = _squeeze_label(label).long()
        mask = (lbl != ctx.attr("ignore_index", -100))[..., None]
        loss = -torch.gather(logp, -1, (lbl * mask[..., 0])[..., None]) \
            * mask
    return {"Y": loss, "Out": loss}


@register("softmax_with_cross_entropy", dp=rows_if(_class_axis_off_rows))
def softmax_with_cross_entropy(ctx):
    """Log-softmax in f32, then the picked (hard) or weighted (soft)
    label's negative log-probability; labels equal to ignore_index give
    0. The Softmax output, in the logits' dtype, only where something
    reads it: at GPT's vocabulary it is as large as the logits."""
    logits = ctx.in_("Logits")
    label = ctx.in_("Label")
    axis = ctx.attr("axis", -1)
    logp = torch.log_softmax(logits.float(), dim=axis)
    if ctx.attr("soft_label", False):
        loss = -(label * logp).sum(dim=axis, keepdim=True)
    else:
        lbl = _squeeze_label(label).long()
        mask = (lbl != ctx.attr("ignore_index", -100))[..., None]
        picked = torch.gather(logp, axis, (lbl * mask[..., 0])[..., None])
        loss = -picked * mask
    out = {"Loss": loss}
    if ctx.wants("Softmax"):
        out["Softmax"] = torch.exp(logp).to(logits.dtype)
    return out


@register("square_error_cost", dp=rows)
def square_error_cost(ctx):
    x, y = ctx.in_("X"), ctx.in_("Y")
    d = x - y
    return {"Out": d * d, "sub_result": d}


def _sigmoid_ce(ctx):
    """The unnormalized loss max(x, 0) - x label + log1p(exp(-|x|)), 0
    where the label is ignore_index, and the mask of counted labels."""
    x, label = ctx.in_("X"), ctx.in_("Label")
    loss = torch.clamp_min(x, 0) - x * label + torch.log1p(
        torch.exp(-torch.abs(x)))
    mask = (label != ctx.attr("ignore_index", -100)).to(loss.dtype)
    return loss * mask, mask


def _dp_sigmoid_ce(impl, ctxs, walk):
    """A rank's rows; with normalize, every rank's rows over the global
    count of unmasked labels (the ranks' counts summed over dp)."""
    if not ctxs[0].attr("normalize", False):
        return rows(impl, ctxs, walk)
    parts = [_sigmoid_ce(c) for c in ctxs]
    count = walk.sum([m.sum() for _l, m in parts])
    return {"Out": Sharded([loss / torch.clamp_min(count, 1.0)
                            for loss, _m in parts])}


@register("sigmoid_cross_entropy_with_logits", dp=_dp_sigmoid_ce)
def sigmoid_cross_entropy_with_logits(ctx):
    """Element-wise binary cross-entropy of logits X against labels in
    [0, 1]; with normalize, divided by the count of labels that are not
    ignore_index (at least 1)."""
    loss, mask = _sigmoid_ce(ctx)
    if ctx.attr("normalize", False):
        loss = loss / torch.clamp_min(mask.sum(), 1.0)
    return {"Out": loss}


@register("cos_sim", dp=rows)
def cos_sim(ctx):
    """The cosine similarity of X and Y's rows (Y may be one row that
    broadcasts), over max(|x| |y|, 1e-12); XNorm and YNorm beside it."""
    x, y = ctx.in_("X"), ctx.in_("Y")
    xn = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(y * y, dim=-1, keepdim=True))
    out = torch.sum(x * y, dim=-1, keepdim=True) / torch.clamp_min(
        xn * yn, 1e-12)
    return {"Out": out, "XNorm": xn, "YNorm": yn}
