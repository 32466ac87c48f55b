"""Loss ops.

Parity: paddle/fluid/operators/{cross_entropy,
softmax_with_cross_entropy,sigmoid_cross_entropy_with_logits}_op.*,
square_error_cost (the reference's squared_l2_distance), log_loss,
smooth_l1_loss and sigmoid_focal_loss; the counterpart of
``paddle_tpu/ops/loss_ops.py`` with the losses the ported slices run.
Under data parallelism each gives a rank's rows their loss rows; where
``sigmoid_cross_entropy_with_logits`` normalizes, it divides by the
global batch's count of unmasked labels (a dp sum), not each rank's.
``sigmoid_focal_loss``'s FgNum must be replicated (the global count).
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


@register("log_loss", dp=rows)
def log_loss(ctx):
    """-label log(p + eps) - (1 - label) log(1 - p + eps), element-wise."""
    p, label = ctx.in_("Predicted"), ctx.in_("Labels")
    eps = ctx.attr("epsilon", 1e-4)
    return {"Loss": -label * torch.log(p + eps)
            - (1 - label) * torch.log(1 - p + eps)}


@register("smooth_l1_loss", "smooth_l1", dp=rows)
def smooth_l1(ctx):
    """d = (X - Y) x InsideWeight; 0.5 sigma^2 d^2 where |d| < 1/sigma^2,
    else |d| - 0.5/sigma^2; times OutsideWeight, summed over each row:
    Out (N, 1), Diff d."""
    x, y = ctx.in_("X"), ctx.in_("Y")
    s2 = ctx.attr("sigma", 1.0) ** 2
    d = x - y
    if ctx.has_in("InsideWeight"):
        d = d * ctx.in_("InsideWeight")
    ad = torch.abs(d)
    loss = torch.where(ad < 1.0 / s2, 0.5 * s2 * d * d, ad - 0.5 / s2)
    if ctx.has_in("OutsideWeight"):
        loss = loss * ctx.in_("OutsideWeight")
    return {"Out": loss.reshape(loss.shape[0], -1).sum(1, keepdim=True),
            "Diff": d}


def _fg_num_replicated(ctx, walk):
    if ctx.is_sharded("FgNum"):
        return "its FgNum is dp-sharded; each rank's rows need the count"
    return None


@register("sigmoid_focal_loss", dp=rows_if(_fg_num_replicated))
def sigmoid_focal_loss(ctx):
    """RetinaNet's focal loss on logits X (N, C): label 0 is background,
    label l > 0 is channel l - 1; alpha_t (1 - p_t)^gamma x the BCE, over
    max(FgNum, 1) where given."""
    x = ctx.in_("X")
    label = ctx.in_("Label").reshape(-1).long()
    c = x.shape[1]
    t = ((label - 1)[:, None] == torch.arange(c, device=x.device)) \
        .to(x.dtype)
    p = torch.sigmoid(x)
    pt = torch.where(t > 0, p, 1 - p)
    at = torch.where(t > 0, ctx.attr("alpha", 0.25),
                     1 - ctx.attr("alpha", 0.25))
    bce = torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-torch.abs(x)))
    loss = at * (1 - pt) ** ctx.attr("gamma", 2.0) * bce
    if ctx.has_in("FgNum"):
        fg = ctx.in_("FgNum").to(x.dtype).reshape(())
        loss = loss / torch.clamp(fg, min=1.0)
    return {"Out": loss}
