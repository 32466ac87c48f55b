"""Metric ops.

Parity: paddle/fluid/operators/metrics/{accuracy,auc}_op.*,
mean_iou_op.*, edit_distance_op.*, chunk_eval_op.*, cvm_op.*,
filter_by_instag_op.* and positive_negative_pair_op.*; the counterpart
of ``paddle_tpu/ops/metric_ops.py``, every op of it: ``accuracy`` (the
share of rows whose label is among the top-k indices), ``auc`` (the
streaming ROC AUC over persistable bucket histograms), ``mean_iou``,
``edit_distance`` (the Levenshtein distance over padded lengths),
``chunk_eval`` (IOB chunk precision, recall and F1),
``continuous_value_model``, ``filter_by_instag`` and
``positive_negative_pair``. Under data parallelism each is the global
batch's: ``accuracy``'s correct and total counts, ``chunk_eval``'s
three chunk counts, ``auc``'s histograms and ``mean_iou``'s confusion
matrix are each rank's, summed over dp once; ``edit_distance`` gives a
rank's rows their distances and its ``SequenceNum`` is the global
batch's count; ``filter_by_instag`` numbers its kept rows in the global
batch; ``positive_negative_pair`` pairs the whole batch and refuses a
sharded input at dp 2 and more.
"""

import torch

from . import Sharded, refuses, register, rows
from .tensor_ops import dropped
from .sequence_ops import lengths_or_full, rows_with, unaligned


def _dp_accuracy(impl, ctxs, walk):
    """The global counts: (correct, total) a rank, one dp sum."""
    outs = [impl(c) for c in ctxs]
    counts = walk.sum([torch.cat([o["Correct"], o["Total"]]).float()
                       for o in outs])
    correct, total = counts[0], counts[1]
    return {"Accuracy": (correct / total).reshape(1),
            "Correct": correct.to(torch.int32).reshape(1),
            "Total": total.to(torch.int32).reshape(1)}


@register("accuracy", dp=_dp_accuracy)
def accuracy(ctx):
    pred_idx = ctx.in_("Indices")  # (N, k) top-k indices
    label = ctx.in_("Label")
    if label.dim() > 1 and label.shape[-1] == 1:
        label = label.reshape(-1)
    correct = (pred_idx.long() == label.long()[:, None]).any(dim=1)
    num_correct = correct.sum().float()
    # a fill on the device: torch.tensor(..., device=cuda) copies from
    # pageable memory, a host sync in the middle of the step
    total = torch.full((), float(label.shape[0]), device=label.device)
    return {"Accuracy": (num_correct / total).reshape(1),
            "Correct": num_correct.to(torch.int32).reshape(1),
            "Total": total.to(torch.int32).reshape(1)}


def _dp_edit_distance(impl, ctxs, walk):
    """A rank's rows of Out; SequenceNum the global batch's count."""
    outs = rows_with("Hyps", "Refs", "HypsLength", "RefsLength")(
        impl, ctxs, walk)
    total = walk.sum([p.float() for p in outs["SequenceNum"].parts])
    outs["SequenceNum"] = total.long()
    return outs


@register("edit_distance", dp=_dp_edit_distance)
def edit_distance(ctx):
    """The Levenshtein distance between padded int sequences Hyps (B, Th)
    and Refs (B, Tr), within HypsLength / RefsLength (the whole width
    where absent); normalized divides by the reference's length (at least
    1). Out (B, 1) f32, SequenceNum (1,) int64 (B).

    The JAX package scans the DP table per pair; here one row of the
    table a hypothesis token for the whole batch, its left-to-right
    recursion new[j] = min(new[j - 1] + 1, c[j]) solved in closed form
    as a running minimum, cummin(c - j) + j (exact: the values are small
    integers in f32)."""
    hyp, ref = ctx.in_("Hyps"), ctx.in_("Refs")
    b, th = hyp.shape
    tr = ref.shape[1]
    dev = hyp.device
    hyp_len = lengths_or_full(ctx.in_("HypsLength"), b, th, dev)
    ref_len = lengths_or_full(ctx.in_("RefsLength"), b, tr, dev)
    cols = torch.arange(tr + 1, device=dev, dtype=torch.float32)
    prev = cols.expand(b, tr + 1)
    for i in range(th):
        sub = prev[:, :-1] + (hyp[:, i:i + 1] != ref).float()
        c = torch.cat([prev[:, :1] + 1,
                       torch.minimum(prev[:, 1:] + 1, sub)], dim=1)
        new = torch.cummin(c - cols, dim=1).values + cols
        prev = torch.where((i < hyp_len)[:, None], new, prev)
    d = torch.gather(prev, 1, ref_len.clamp(0, tr)[:, None])[:, 0]
    if ctx.attr("normalized", False):
        d = d / ref_len.float().clamp(min=1.0)
    return {"Out": d.reshape(b, 1),
            "SequenceNum": torch.full((1,), b, dtype=torch.int64,
                                      device=dev)}


def _chunk_counts(ctx):
    """(inferred chunks, label chunks, correct chunks), int64 scalars.

    IOB tags: type * 2 for B, type * 2 + 1 for I, tags >= 2 *
    num_chunk_types outside; the JAX op reads no other scheme and the
    port copies it. A chunk starts at a B tag; an inferred start is
    correct where the label starts a chunk there with the same tag and
    the tags agree at every valid step until the next start in either
    sequence. As in the JAX op, a chunk that runs to the end of a padded
    row (a row shorter than T) is never counted correct: the row's
    padding never agrees."""
    lab = ctx.in_("Label")
    inf = ctx.in_("Inference").reshape(lab.shape)
    b, t = lab.shape
    lens = lengths_or_full(ctx.in_("SeqLength"), b, t, lab.device)
    num_types = ctx.attr("num_chunk_types", 1)
    valid = torch.arange(t, device=lab.device)[None, :] < lens[:, None]

    def starts(tags):
        return (tags % 2 == 0) & (tags < 2 * num_types) & valid

    inf_b, lab_b = starts(inf), starts(lab)
    same = (inf == lab) & valid
    boundary = torch.roll(inf_b | lab_b, -1, dims=1)
    boundary[:, -1] = True
    ok_next = torch.ones(b, dtype=torch.bool, device=lab.device)
    oks = [None] * t
    for s in range(t - 1, -1, -1):
        ok_next = same[:, s] & (boundary[:, s] | ok_next)
        oks[s] = ok_next
    ok = torch.stack(oks, 1)
    correct = (inf_b & lab_b & (inf == lab) & ok).sum()
    return inf_b.sum(), lab_b.sum(), correct


def _chunk_outputs(n_inf, n_lab, correct):
    precision = correct / torch.clamp_min(n_inf, 1)
    recall = correct / torch.clamp_min(n_lab, 1)
    f1 = 2 * precision * recall / torch.clamp_min(precision + recall, 1e-8)
    return {"Precision": precision.float().reshape(1),
            "Recall": recall.float().reshape(1),
            "F1-Score": f1.float().reshape(1),
            "NumInferChunks": n_inf.long().reshape(1),
            "NumLabelChunks": n_lab.long().reshape(1),
            "NumCorrectChunks": correct.long().reshape(1)}


def _dp_chunk_eval(impl, ctxs, walk):
    """The global batch's counts (one dp sum), then the ratios."""
    why = unaligned(ctxs[0], walk, ("Inference", "Label", "SeqLength"))
    if why:
        raise NotImplementedError(
            f"op 'chunk_eval' under data parallelism: {why}")
    counts = walk.sum([torch.stack(_chunk_counts(c)).float() for c in ctxs])
    n_inf, n_lab, correct = counts.long()
    return _chunk_outputs(n_inf, n_lab, correct)


@register("chunk_eval", dp=_dp_chunk_eval)
def chunk_eval(ctx):
    """Chunk precision, recall and F1 of Inference against Label (IOB),
    with the counts (int64)."""
    return _chunk_outputs(*_chunk_counts(ctx))


def _auc_hists(ctx, num_buckets):
    """This batch's (positive, negative) histograms over the buckets:
    bucket = int(p (num_buckets - 1)) clipped into range, f32 counts
    (exact below 2^24) by index_add, a fixed shape with no host read."""
    probs = ctx.in_("Predict")[:, -1]
    label = ctx.in_("Label").reshape(-1).to(torch.float32)
    scaled = torch.nan_to_num(probs.float() * (num_buckets - 1), nan=0.0)
    bucket = scaled.clamp(0, num_buckets - 1).to(torch.int64)
    zeros = torch.zeros(num_buckets, dtype=torch.float32, device=probs.device)
    return (zeros.index_add(0, bucket, label),
            zeros.index_add(0, bucket, 1.0 - label))


def _auc_outputs(ctx, pos_hist, neg_hist):
    """The streaming statistics plus this batch's histograms, and the
    area under their ROC curve: the trapezoids sum(neg (positives at or
    above the bucket - pos / 2)) over (positives x negatives)."""
    stat_pos, stat_neg = ctx.in_("StatPos"), ctx.in_("StatNeg")
    new_pos = stat_pos.reshape(-1) + pos_hist.to(stat_pos.dtype)
    new_neg = stat_neg.reshape(-1) + neg_hist.to(stat_neg.dtype)
    tot_pos = torch.flip(torch.cumsum(torch.flip(new_pos, (0,)), 0), (0,))
    area = (new_neg * (tot_pos - new_pos / 2.0)).sum()
    denom = torch.clamp_min(new_pos.sum() * new_neg.sum(), 1.0)
    return {"AUC": (area / denom).reshape(1),
            "StatPosOut": new_pos.reshape(stat_pos.shape),
            "StatNegOut": new_neg.reshape(stat_neg.shape)}


def _dp_auc(impl, ctxs, walk):
    """The global batch counted once: each rank's histograms, one dp sum
    (of both, stacked), added to the replicated statistics."""
    n = ctxs[0].in_("StatPos").numel()
    hists = walk.sum([torch.stack(_auc_hists(c, n)) for c in ctxs])
    return _auc_outputs(ctxs[0], hists[0], hists[1])


@register("auc", dp=_dp_auc)
def auc(ctx):
    """Streaming ROC AUC over num_thresholds + 1 buckets (the JAX
    package's scheme): Predict's last column is P(positive); StatPos /
    StatNeg accumulate the histograms across runs (persistable, written
    back as StatPosOut / StatNegOut)."""
    return _auc_outputs(ctx, *_auc_hists(ctx, ctx.in_("StatPos").numel()))


def _confusion(ctx):
    """The (num_classes, num_classes) f32 confusion matrix, rows the
    labels: each pixel at label n + pred, read as XLA's scatter reads it
    (a negative index wraps by n^2, one still out of range is dropped:
    VOC's ignore label 255 leaves its pixels out). A dump slot past the
    end takes the dropped ones, so a CUDA scatter never sees them."""
    pred = ctx.in_("Predictions").reshape(-1).long()
    label = ctx.in_("Labels").reshape(-1).long()
    n = ctx.attr("num_classes")
    slot = dropped(label * n + pred, n * n)
    cm = torch.zeros(n * n + 1, dtype=torch.float32, device=pred.device)
    cm.index_add_(0, slot, torch.ones(slot.shape, dtype=torch.float32,
                                      device=pred.device))
    return cm[:n * n].reshape(n, n)


def _iou_outputs(cm):
    """The per-class IoU in f32 as JAX's; their mean summed in float64
    and rounded once to f32. Each nonzero IoU is at least 1 / union, so
    its last bit is at least 2^-24 / union: while classes x the largest
    union stay below 2^29 (VOC at 513², batch 8: 4.4e7), the float64 sum
    is exact in any order, and the card and the CPU give the same bits
    (an f32 sum moves by an ulp with the reduction's order)."""
    inter = torch.diagonal(cm)
    union = cm.sum(0) + cm.sum(1) - inter
    valid = union > 0
    iou = torch.where(valid, inter / torch.clamp_min(union, 1.0),
                      torch.zeros_like(inter))
    miou = iou.double().sum() / torch.clamp_min(valid.sum(), 1)
    return {"OutMeanIou": miou.float().reshape(1),
            "OutWrong": cm.sum(1) - inter, "OutCorrect": inter}


def _dp_mean_iou(impl, ctxs, walk):
    """The global batch's confusion matrix: the ranks' summed over dp."""
    return _iou_outputs(walk.sum([_confusion(c) for c in ctxs]))


@register("mean_iou", dp=_dp_mean_iou)
def mean_iou(ctx):
    """The mean IoU over the classes present in labels or predictions,
    and per class the correct pixels (OutCorrect) and the label's pixels
    predicted otherwise (OutWrong), f32."""
    return _iou_outputs(_confusion(ctx))


@register("continuous_value_model", dp=rows)
def continuous_value_model(ctx):
    """cvm_op: X's leading show and click columns as log(show + 1) and
    log(click + 1) - log(show + 1) (use_cvm), or dropped."""
    x = ctx.in_("X")
    show = torch.log(torch.clamp_min(x[:, 0:1], 0.0) + 1.0)
    ctr = torch.log(torch.clamp_min(x[:, 1:2], 0.0) + 1.0) - show
    if ctx.attr("use_cvm", True):
        return {"Y": torch.cat([show, ctr, x[:, 2:]], -1)}
    return {"Y": x[:, 2:]}


def _dp_instag(impl, ctxs, walk):
    """A rank's rows, with IndexMap's kept rows numbered in the global
    batch (the rank's offset added; the shards are equal)."""
    outs = []
    for c in ctxs:
        o = impl(c)
        off = c.dp_rank * c.in_("Ins").shape[0]
        idx = o["IndexMap"]
        o["IndexMap"] = torch.where(idx >= 0, idx + off, idx)
        outs.append(o)
    return {k: Sharded([o[k] for o in outs]) for k in outs[0]}


@register("filter_by_instag", dp=_dp_instag)
def filter_by_instag(ctx):
    """Rows whose tags meet Filter_tag kept, the others zeroed (a fixed
    shape); LossWeight 1 / 0 a row; IndexMap (B, 2) each kept row's index,
    -1 for the others (int64)."""
    ins, tags = ctx.in_("Ins"), ctx.in_("Ins_tag")
    filt = ctx.in_("Filter_tag").reshape(-1)
    hit = (tags[:, :, None] == filt[None, None, :]).any(2).any(1)
    idx = torch.where(hit, torch.arange(ins.shape[0], device=ins.device),
                      torch.full_like(hit, -1, dtype=torch.int64))
    return {"Out": torch.where(hit[:, None], ins, torch.zeros_like(ins)),
            "LossWeight": hit.to(torch.float32)[:, None],
            "IndexMap": torch.stack([idx, idx], -1)}


@register("positive_negative_pair", dp=refuses(
    "it pairs the items of a query across the whole batch"))
def positive_negative_pair(ctx):
    """Among the item pairs of one QueryID with different labels, those
    whose score order agrees with the label order (PositivePair),
    disagrees (NegativePair) or ties in score (NeutralPair), f32 (1,),
    added to the Accumulate* inputs where given."""
    score = ctx.in_("Score").reshape(-1)
    label = ctx.in_("Label").reshape(-1).to(score.dtype)
    qid = ctx.in_("QueryID").reshape(-1)
    n = score.shape[0]
    upper = torch.ones((n, n), dtype=torch.bool,
                       device=score.device).triu(1)
    pair = (qid[:, None] == qid[None, :]) & upper & \
        (label[:, None] != label[None, :])
    s_diff = score[:, None] - score[None, :]
    agree = torch.sign(s_diff) == torch.sign(label[:, None] - label[None, :])
    tie = s_diff == 0.0
    pos = (pair & agree & ~tie).sum().float()
    neu = (pair & tie).sum().float()
    neg = (pair & ~agree & ~tie).sum().float()
    if ctx.has_in("AccumulatePositivePair"):
        pos = pos + ctx.in_("AccumulatePositivePair").reshape(())
        neg = neg + ctx.in_("AccumulateNegativePair").reshape(())
        neu = neu + ctx.in_("AccumulateNeutralPair").reshape(())
    return {"PositivePair": pos.reshape(1), "NegativePair": neg.reshape(1),
            "NeutralPair": neu.reshape(1)}
