"""Loss ops.

Parity: paddle/fluid/operators/{cross_entropy,
softmax_with_cross_entropy,sigmoid_cross_entropy_with_logits}_op.*,
square_error_cost (the reference's squared_l2_distance), log_loss,
smooth_l1_loss, sigmoid_focal_loss, huber_loss, bpr_loss, kldiv_loss,
rank_loss, margin_rank_loss, dice_loss, npair_loss, center_loss,
teacher_student_sigmoid_loss, mse_loss, hinge_loss, modified_huber_loss
and squared_l2_distance; the counterpart of
``paddle_tpu/ops/loss_ops.py``, every loss of it. Under data
parallelism each gives a rank's rows their loss rows; where
``sigmoid_cross_entropy_with_logits`` normalizes, it divides by the
global batch's count of unmasked labels (a dp sum), not each rank's.
``sigmoid_focal_loss``'s FgNum must be replicated (the global count).
The reducing losses (``kldiv_loss``'s mean / sum / batchmean,
``mse_loss``, ``dice_loss``) finish the ranks' sums with one dp sum over
the global count; ``center_loss`` sums the ranks' counts and diffs
before it moves the centres once; ``npair_loss`` pairs the whole batch
and refuses a sharded input at dp 2 and more.
"""

import torch

from . import Sharded, refuses, register, rows, rows_if
from .tensor_ops import clamped, dropped, gather_kept


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


@register("huber_loss", dp=rows)
def huber_loss(ctx):
    """r = Y - X; 0.5 r^2 where |r| <= delta, else delta (|r| - delta /
    2); Residual r."""
    x, y = ctx.in_("X"), ctx.in_("Y")
    delta = ctx.attr("delta", 1.0)
    d = y - x
    ad = torch.abs(d)
    return {"Out": torch.where(ad <= delta, 0.5 * d * d,
                               delta * (ad - 0.5 * delta)),
            "Residual": d}


def _softplus(x):
    """log(1 + e^x), jax.nn.softplus's form (no linear cut-off)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


@register("bpr_loss", dp=rows)
def bpr_loss(ctx):
    """bpr_loss_op.h:69: the mean over the C - 1 other classes of
    softplus(x_j - x_label) (the label's own class left out)."""
    x = ctx.in_("X")
    label = _squeeze_label(ctx.in_("Label")).long()
    c = x.shape[1]
    pos = torch.gather(x, 1, label[:, None])
    per = _softplus(x - pos)
    others = torch.arange(c, device=x.device)[None, :] != label[:, None]
    return {"Y": torch.where(others, per, torch.zeros_like(per))
            .sum(1, keepdim=True) / (c - 1)}


def _kldiv(ctx):
    x, target = ctx.in_("X"), ctx.in_("Target")
    loss = target * (torch.log(torch.clamp_min(target, 1e-10)) - x)
    return torch.where(target > 0, loss, torch.zeros_like(loss))


def _dp_kldiv(impl, ctxs, walk):
    """Elementwise: a rank's rows; a reduction over the global batch: the
    ranks' sums summed over dp, over the global count ("mean") or the
    global batch ("batchmean")."""
    red = ctxs[0].attr("reduction", "mean")
    if red not in ("mean", "sum", "batchmean"):
        return rows(impl, ctxs, walk)
    parts = [_kldiv(c) for c in ctxs]
    total = walk.sum([p.sum() for p in parts])
    if red == "mean":
        total = total / (parts[0].numel() * walk.size)
    elif red == "batchmean":
        total = total / (parts[0].shape[0] * walk.size)
    return {"Loss": total}


@register("kldiv_loss", dp=_dp_kldiv)
def kldiv_loss(ctx):
    """target (log target - X), 0 where target <= 0; reduction "none",
    "mean", "sum" or "batchmean" (the sum over the batch size)."""
    loss = _kldiv(ctx)
    red = ctx.attr("reduction", "mean")
    if red == "mean":
        loss = loss.mean()
    elif red == "sum":
        loss = loss.sum()
    elif red == "batchmean":
        loss = loss.sum() / ctx.in_("X").shape[0]
    return {"Loss": loss}


@register("rank_loss", dp=rows)
def rank_loss(ctx):
    """RankNet: log(1 + e^d) - label d, d = Left - Right."""
    label = ctx.in_("Label")
    d = ctx.in_("Left") - ctx.in_("Right")
    return {"Out": _softplus(d) - label * d}


@register("margin_rank_loss", dp=rows)
def margin_rank_loss(ctx):
    """max(0, -label (X1 - X2) + margin); Activated where it is > 0."""
    label = ctx.in_("Label")
    x1, x2 = ctx.in_("X1"), ctx.in_("X2")
    out = torch.clamp_min(-label * (x1 - x2) + ctx.attr("margin", 0.1), 0.0)
    return {"Out": out, "Activated": (out > 0).to(x1.dtype)}


def _dice_ratios(ctx):
    """Each row's 2 |x . label| / (|x| + |label| + eps); integer labels
    one-hot to X's class dim first (an id out of range: a zero row)."""
    x, label = ctx.in_("X"), ctx.in_("Label")
    if not label.dtype.is_floating_point and label.dtype != torch.bool:
        label = (_squeeze_label(label).long()[..., None]
                 == torch.arange(x.shape[-1], device=x.device))
    label = label.to(x.dtype)
    dims = tuple(range(1, x.dim()))
    inter = 2.0 * (x * label).sum(dims)
    union = x.sum(dims) + label.sum(dims)
    return inter / (union + ctx.attr("epsilon", 1e-5))


def _dp_dice(impl, ctxs, walk):
    """1 - the mean ratio over the global batch (the ranks' sums of
    their rows' ratios, summed over dp)."""
    parts = [_dice_ratios(c) for c in ctxs]
    total = walk.sum([p.sum() for p in parts])
    return {"Out": 1.0 - total / (parts[0].shape[0] * walk.size)}


@register("dice_loss", dp=_dp_dice)
def dice_loss(ctx):
    """1 - the batch mean of each row's dice ratio, a scalar."""
    return {"Out": 1.0 - _dice_ratios(ctx).mean()}


@register("npair_loss", dp=refuses(
    "it pairs every anchor with every positive of the batch"))
def npair_loss(ctx):
    """The softmax cross-entropy of anchor . positive^T against the
    same-label targets (each row normalized), plus l2_reg x 0.25 (the
    reference's Beta, nn.py:12652) x the mean squared norms of anchor and
    positive."""
    anchor, positive = ctx.in_("Anchor"), ctx.in_("Positive")
    labels = ctx.in_("Labels").reshape(-1)
    sim = anchor @ positive.t()
    same = (labels[:, None] == labels[None, :]).to(sim.dtype)
    same = same / torch.clamp_min(same.sum(1, keepdim=True), 1.0)
    xent = -(same * torch.log_softmax(sim, 1)).sum(1).mean()
    reg = ctx.attr("l2_reg", 0.002) * 0.25 * (
        (anchor * anchor).sum(1).mean() + (positive * positive).sum(1).mean())
    return {"Out": xent + reg}


def _center_terms(ctx):
    """(centers, the loss, the diff, each center's count and summed diff
    in this batch). A label picks its center as XLA gathers (wrapped,
    clamped, no gradient where out of range); the counts and sums drop
    an out-of-range label as XLA's scatter does (a dump row past the
    end)."""
    x = ctx.in_("X")
    label = _squeeze_label(ctx.in_("Label")).long()
    centers = ctx.in_("Centers")
    c = centers.shape[0]
    diff = x - gather_kept(centers, clamped(label, c), dropped(label, c) < c)
    loss = 0.5 * (diff * diff).sum(1, keepdim=True)
    slot = dropped(label, c)
    counts = x.new_zeros(c + 1).index_add(0, slot, x.new_ones(slot.shape))
    sums = x.new_zeros((c + 1, x.shape[1])).index_add(0, slot,
                                                       diff.detach())
    return centers, loss, diff, counts[:c], sums[:c]


def _center_update(ctx, centers, counts, sums):
    alpha = ctx.in_("CenterUpdateRate")
    alpha = 0.1 if alpha is None else alpha.reshape(-1)[0]
    return (centers + (alpha * sums / (counts[:, None] + 1.0)).detach())


def _updates(ctx):
    return ctx.attr("need_update", True) and not ctx.is_test


def _dp_center_loss(impl, ctxs, walk):
    """A rank's rows of Loss and SampleCenterDiff; the centres updated
    once from the global batch's counts and diffs (one dp sum each)."""
    terms = [_center_terms(c) for c in ctxs]
    centers = terms[0][0]
    out = {"Loss": Sharded([t[1] for t in terms]),
           "SampleCenterDiff": Sharded([t[2] for t in terms]),
           "CentersOut": centers}
    if _updates(ctxs[0]):
        out["CentersOut"] = _center_update(
            ctxs[0], centers, walk.sum([t[3] for t in terms]),
            walk.sum([t[4] for t in terms]))
    return out


@register("center_loss", dp=_dp_center_loss)
def center_loss(ctx):
    """0.5 |x - center[label]|^2 a row; in training (need_update) each
    center moves by alpha x its rows' summed diff / (count + 1), outside
    the gradient."""
    centers, loss, diff, counts, sums = _center_terms(ctx)
    out = centers
    if _updates(ctx):
        out = _center_update(ctx, centers, counts, sums)
    return {"Loss": loss, "SampleCenterDiff": diff, "CentersOut": out}


@register("teacher_student_sigmoid_loss", dp=rows)
def teacher_student_sigmoid_loss(ctx):
    """teacher_student_sigmoid_loss_op.h:43, the label encoding click and
    teacher score q: -2 is (click 0, no q), -1 (click 1, no q), q in
    [0, 1) (click 0, q) and 1 + q (click 1, q); the BCE against the
    click plus, with a teacher, the BCE against q. Y (N, 1)."""
    x = ctx.in_("X").reshape(-1)
    label = ctx.in_("Label").reshape(-1).to(x.dtype)
    sp = _softplus(x)
    bce0, bce1 = sp, sp - x
    y = torch.where(label < -1.0, bce0, torch.where(
        label < 0.0, bce1, torch.where(label < 1.0, bce0 + sp - x * label,
                                       bce1 + sp - x * (label - 1.0))))
    return {"Y": y.reshape(-1, 1)}


def _dp_mse(impl, ctxs, walk):
    sums = []
    for c in ctxs:
        d = c.in_("X") - c.in_("Y")
        sums.append((d * d).sum())
    return {"Out": walk.sum(sums) / (ctxs[0].in_("X").numel() * walk.size)}


@register("mse_loss", dp=_dp_mse)
def mse_loss(ctx):
    """mean((X - Y)^2), a scalar (over the global batch under dp)."""
    d = ctx.in_("X") - ctx.in_("Y")
    return {"Out": (d * d).mean()}


@register("hinge_loss", dp=rows)
def hinge_loss(ctx):
    """max(0, 1 - logits (2 label - 1)) with {0, 1} labels."""
    x = ctx.in_("Logits")
    y = ctx.in_("Labels").to(x.dtype)
    return {"Loss": torch.clamp_min(1.0 - x * (2.0 * y - 1.0), 0.0)}


@register("modified_huber_loss", dp=rows)
def modified_huber_loss(ctx):
    """z = x (2y - 1): -4z for z < -1, (1 - z)^2 for z < 1, else 0;
    IntermediateVal z."""
    x = ctx.in_("X")
    z = x * (2.0 * ctx.in_("Y").to(x.dtype) - 1.0)
    loss = torch.where(z < -1.0, -4.0 * z, torch.where(
        z < 1.0, (1.0 - z) ** 2, torch.zeros_like(z)))
    return {"Out": loss, "IntermediateVal": z}


@register("squared_l2_distance", dp=rows)
def squared_l2_distance(ctx):
    """Each row's sum of squared differences over all its trailing dims,
    (N, 1), and sub_result (X - Y) as (N, -1)."""
    x, y = ctx.in_("X"), ctx.in_("Y")
    sub = (x - y).reshape(x.shape[0], -1)
    return {"Out": (sub * sub).sum(1, keepdim=True), "sub_result": sub}
