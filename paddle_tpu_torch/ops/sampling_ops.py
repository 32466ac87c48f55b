"""Large-vocabulary output approximations: NCE, hierarchical sigmoid,
sampled softmax.

Parity: paddle/fluid/operators/nce_op.*, hierarchical_sigmoid_op.*,
sample_logits_op.*; the counterpart of ``paddle_tpu/ops/sampling_ops.py``,
every op of it. ``nce`` and ``sample_logits`` are each a draw and a
score over given draws (``draw_classes``; ``nce_score``,
``sample_logits_score``): the draw comes from the op's
``OpContext.rng()`` torch generator on the op's device, so no draw equals
``jax.random``'s (ROADMAP C19), and the score half is the JAX op's
arithmetic on whatever classes it is handed. One sampled class set
serves the whole batch, so under data parallelism every rank draws rank
0's set (``rng(shared=True)``) and dp 2's cost equals dp 1's; the
labels (and hsigmoid's path tables) are sharded with the rows. The drawn
ids (SampleLabels, Samples) are int64 (C12's policy).

The rows of the (classes, hidden) weight are gathered with
``index_select`` (``tensor_ops.gather_kept``: an id out of range is
clamped and passes no gradient, as XLA's gather and its transpose
treat it); ``sample_logits`` reads its logits as ``take_along_axis``
does, NaN for an id still out of range after one wrap.
"""

import numpy as np
import torch
import torch.nn.functional as F

from . import register
from .sequence_ops import rows_with
from .tensor_ops import clamped, gather_kept, wrapped


def _log_range(range_max):
    """log(range_max + 1) rounded to f32, as jnp.log of the f32 value."""
    return float(np.log(np.float32(range_max + 1.0)))


def _log_uniform_probs(classes, range_max):
    """P(c) = log(1 + 1 / (c + 1)) / log(range_max + 1): the
    log-uniform (Zipfian) sampler's probabilities."""
    c = classes.float()
    return torch.log1p(1.0 / (c + 1.0)) / _log_range(range_max)


def draw_classes(gen, sampler, num_samples, range_max, custom_probs,
                 device):
    """`num_samples` class ids (int64) from `gen`: with replacement from
    `custom_probs` ("custom_dist"), log-uniform by the inverse CDF
    exp(u log(R + 1)) - 1 truncated toward zero and clipped into [0, R -
    1] ("log_uniform"), or uniform in [0, R)."""
    if sampler == "custom_dist" and custom_probs is not None:
        return torch.multinomial(custom_probs.float(), num_samples,
                                 replacement=True, generator=gen)
    if sampler == "log_uniform":
        u = torch.rand(num_samples, generator=gen, device=device)
        c = torch.exp(u * _log_range(range_max)) - 1.0
        return c.to(torch.int64).clamp(0, range_max - 1)
    return torch.randint(0, range_max, (num_samples,), generator=gen,
                         device=device)


def _rows_of(table, ids):
    """table[ids] along dim 0, XLA's way: wrapped once, clamped, no
    gradient through an id out of range."""
    n = table.shape[0]
    ok = (wrapped(ids, n) >= 0) & (wrapped(ids, n) < n)
    return gather_kept(table, clamped(ids, n), ok)


def nce_score(x, w, b, label, neg, num_total, sampler="uniform",
              custom=None):
    """NCE's Cost (B, 1), SampleLogits (B, T + S) and SampleLabels over
    the given negatives `neg` (S,):

    loss = -log sigma(s_pos - log(k q(pos)))
           - sum_neg log sigma(-(s_neg - log(k q(neg))))."""
    x, w = x.float(), w.float()
    if label.dim() == 1:
        label = label[:, None]
    label, neg = label.long(), neg.long()
    pos_score = torch.einsum("bd,btd->bt", x, _rows_of(w, label))
    neg_score = x @ _rows_of(w, neg).t()
    if b is not None:
        pos_score = pos_score + _rows_of(b, label)
        neg_score = neg_score + _rows_of(b, neg)[None]
    if sampler == "log_uniform":
        q_pos = _log_uniform_probs(label, num_total)
        q_neg = _log_uniform_probs(neg, num_total)
    elif sampler == "custom_dist" and custom is not None:
        n = custom.shape[0]
        q_pos, q_neg = custom[clamped(label, n)], custom[clamped(neg, n)]
    else:
        q_pos = torch.full(label.shape, 1.0 / num_total, device=x.device)
        q_neg = torch.full(neg.shape, 1.0 / num_total, device=x.device)
    k = float(neg.shape[0])
    pos_logit = pos_score - torch.log(k * q_pos)
    neg_logit = neg_score - torch.log(k * q_neg)[None]
    cost = (F.softplus(-pos_logit).sum(-1)
            + F.softplus(neg_logit).sum(-1))[:, None]
    return {"Cost": cost,
            "SampleLogits": torch.cat([pos_logit, neg_logit], -1),
            "SampleLabels": torch.cat(
                [label, neg[None].expand(x.shape[0], -1)], -1)}


@register("nce", dp=rows_with("Input", "Label"))
def nce(ctx):
    """Noise-contrastive estimation: Input (B, D), Weight (C, D), Bias
    (C,), Label (B, num_true); num_neg_samples classes drawn once for the
    batch."""
    x, w = ctx.in_("Input"), ctx.in_("Weight")
    num_total = ctx.attr("num_total_classes", w.shape[0])
    sampler = ctx.attr("sampler", "uniform")
    custom = ctx.in_("CustomDistProbs")
    neg = draw_classes(ctx.rng(shared=True), sampler,
                       ctx.attr("num_neg_samples", 10), num_total, custom,
                       x.device)
    return nce_score(x, w, ctx.in_("Bias"), ctx.in_("Label"), neg,
                     num_total, sampler, custom)


def _default_tree(label, num_classes):
    """The default complete binary tree's (node, bit, valid), (B, L) at
    depth L = bit_length(C - 1): code = label + C, node i = (code >>
    (i + 1)) - 1, bit i = (code >> i) & 1."""
    depth = max(int(num_classes - 1).bit_length(), 1)
    code = label + num_classes
    bits = torch.arange(depth, device=label.device)
    node = torch.bitwise_right_shift(code[:, None], bits[None] + 1) - 1
    bit = torch.bitwise_right_shift(code[:, None], bits[None]) & 1
    return node, bit, node >= 0


@register("hierarchical_sigmoid",
          dp=rows_with("X", "Label", "PathTable", "PathCode"))
def hierarchical_sigmoid(ctx):
    """Hierarchical sigmoid over the default complete binary tree or a
    custom one (PathTable (B, L): the W row of each step, PathCode: its
    target bit; the path is the prefix before the first negative
    entry). Out (B, 1): the sum over the path of softplus(s) - bit s;
    PreOut (B, L) the scores s."""
    x = ctx.in_("X").float()
    w = ctx.in_("W").float()
    bias = ctx.in_("Bias")
    label = ctx.in_("Label").reshape(-1).long()
    if ctx.has_in("PathTable"):
        node = ctx.in_("PathTable").long()
        bit = ctx.in_("PathCode").long()
        if node.dim() == 1:
            node, bit = node[None], bit[None]
        valid = torch.cumprod((node >= 0).long(), dim=1) == 1
        bit = bit.clamp_min(0)
    else:
        node, bit, valid = _default_tree(label, ctx.attr("num_classes"))
    node_safe = node.clamp_min(0)
    s = torch.einsum("bd,bld->bl", x, _rows_of(w, node_safe))
    if bias is not None:
        s = s + _rows_of(bias.reshape(-1), node_safe)
    loss = torch.where(valid, F.softplus(s) - bit * s,
                       torch.zeros((), device=s.device))
    return {"Out": loss.sum(-1)[:, None], "PreOut": s}


def sample_logits_score(logits, label, samples, use_customized=False,
                        remove_accidental_hits=True):
    """The sampled softmax's Loss (B, 1), Samples (B, T + S) and
    SampledLogits over the given class draws `samples` (S,): the logits
    of the true labels and the draws, less log(q S + 1e-20) (logQ), the
    draws that hit a row's first true label at -1e20, a softmax cross
    entropy over the T true columns' mean."""
    logits = logits.float()
    if label.dim() == 1:
        label = label[:, None]
    label = label.long()
    b, c = logits.shape
    num_true, num_samples = label.shape[1], samples.shape[0]
    sampled = samples.long()[None].expand(b, num_samples)
    idx = torch.cat([label, sampled], dim=1)
    ok = (wrapped(idx, c) >= 0) & (wrapped(idx, c) < c)
    picked = torch.gather(logits, 1, clamped(idx, c))
    picked = torch.where(ok, picked, torch.full((), float("nan"),
                                                device=logits.device))
    if not use_customized:
        picked = picked - torch.log(_log_uniform_probs(idx, c) * num_samples
                                    + 1e-20)
    if remove_accidental_hits:
        hit = sampled == label[:, :1]
        picked = torch.cat([picked[:, :num_true], picked[:, num_true:]
                            + torch.where(hit, -1e20, 0.0)], dim=1)
    lp = torch.log_softmax(picked, dim=-1)
    loss = -lp[:, :num_true].mean(-1, keepdim=True)
    return {"Loss": loss, "Samples": idx, "SampledLogits": picked}


@register("sample_logits", dp=rows_with("Logits", "Labels"))
def sample_logits(ctx):
    """sampled_softmax_with_cross_entropy: num_samples log-uniform
    classes drawn once for the batch."""
    logits = ctx.in_("Logits")
    samples = draw_classes(ctx.rng(shared=True), "log_uniform",
                           ctx.attr("num_samples", 100), logits.shape[1],
                           None, logits.device)
    return sample_logits_score(
        logits, ctx.in_("Labels"), samples,
        ctx.attr("use_customized_samples", False),
        ctx.attr("remove_accidental_hits", True))
