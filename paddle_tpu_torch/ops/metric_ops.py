"""Metric ops.

Parity: paddle/fluid/operators/metrics/accuracy_op.*, edit_distance_op.*
and chunk_eval_op.*; the counterpart of ``paddle_tpu/ops/metric_ops.py``'s
``accuracy`` (the share of rows whose label is among the top-k indices),
``edit_distance`` (the Levenshtein distance over padded lengths) and
``chunk_eval`` (IOB chunk precision, recall and F1). Under data
parallelism each is the global batch's: ``accuracy``'s correct and total
counts and ``chunk_eval``'s three chunk counts are each rank's, summed
over dp; ``edit_distance`` gives a rank's rows their distances and its
``SequenceNum`` is the global batch's count.
"""

import torch

from . import register
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
