"""Linear-chain CRF: the negative log-likelihood and Viterbi decoding.

Parity: paddle/fluid/operators/linear_chain_crf_op.* and
crf_decoding_op.*; the counterpart of ``paddle_tpu/ops/crf_ops.py``. The
JAX package runs both passes as batched ``lax.scan`` over the padded
time axis with per-sequence length masks; here each is a Python loop
over the padded T of batched torch calls, the whole batch advancing one
step at a time, and autograd gives the likelihood's backward.

The transition parameter's layout is the reference's:
    transition[0]  = start scores (added at step 0)
    transition[1]  = end scores (added at each sequence's last step)
    transition[2:] = the (N, N) matrix, [i, j] = the score of tag i ->
                     tag j.

The forward algorithm is a logsumexp over the padded T, a step past a
row's length freezing its alpha. The Viterbi
decode keeps argmax back-pointers (the first maximum, as ``jnp.argmax``)
and backtracks through each row's active steps only; positions past the
length are 0. With a ``Label`` input it returns the mismatch mask
instead. The paths are int64 (the JAX package's are int32, ROADMAP C12).

Under data parallelism both run a rank's rows (the transition
replicated); ``linear_chain_crf``'s ``TransitionExps``, a function of
the transition alone, is computed once and stays replicated.
"""

import torch

from . import register
from .sequence_ops import lengths_or_full, rows_with

_ROWS = rows_with("Emission", "Label", "Length")


def _crf_inputs(ctx):
    em = ctx.in_("Emission").float()                   # (B, T, N)
    w = ctx.in_("Transition").float()                  # (N + 2, N)
    return em, w, lengths_or_full(ctx.in_("Length"), em.shape[0],
                                  em.shape[1], em.device)


def _labels(label):
    return (label[..., 0] if label.dim() == 3 else label).long()


def _dp_crf(impl, ctxs, walk):
    outs = _ROWS(impl, ctxs, walk)
    if "TransitionExps" in outs:
        outs["TransitionExps"] = outs["TransitionExps"].parts[0]
    return outs


@register("linear_chain_crf", dp=_dp_crf)
def linear_chain_crf(ctx):
    """LogLikelihood (B, 1): each sequence's negative log-likelihood (the
    cost the reference's crf layer hands the optimizer), with the Alpha
    table (B, T, N), EmissionExps and TransitionExps."""
    em, w, length = _crf_inputs(ctx)
    label = _labels(ctx.in_("Label"))                  # (B, T)
    t = em.shape[1]
    start, end, trans = w[0], w[1], w[2:]

    # the gold path's score
    t_idx = torch.arange(t, device=em.device)
    valid = t_idx[None, :] < length[:, None]           # (B, T)
    gold = torch.gather(em, 2, label[..., None])[..., 0]
    em_score = torch.where(valid, gold, torch.zeros_like(gold)).sum(-1)
    pair = trans[label[:, :-1], label[:, 1:]]          # (B, T - 1)
    trans_score = torch.where(valid[:, 1:], pair,
                              torch.zeros_like(pair)).sum(-1)
    last = (length - 1).clamp(0, t - 1)
    last_tag = torch.gather(label, 1, last[:, None])[:, 0]
    score = em_score + trans_score + start[label[:, 0]] + end[last_tag]

    # the partition function (the forward algorithm)
    alpha = start[None] + em[:, 0]                     # (B, N)
    alphas = [alpha]
    for s in range(1, t):
        nxt = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) \
            + em[:, s]
        alpha = torch.where(valid[:, s, None], nxt, alpha)
        alphas.append(alpha)
    log_z = torch.logsumexp(alpha + end[None], dim=-1)
    out = {"LogLikelihood": (log_z - score)[:, None],
           "Alpha": torch.stack(alphas, 1)}
    if ctx.wants("EmissionExps"):
        out["EmissionExps"] = torch.exp(em)
    if ctx.wants("TransitionExps"):
        out["TransitionExps"] = torch.exp(w)
    return out


@register("crf_decoding", dp=_ROWS)
def crf_decoding(ctx):
    """ViterbiPath (B, T) int64, 0 past each length; with a Label input,
    the per-position mismatch mask (int64) instead (the reference's
    evaluation mode)."""
    em, w, length = _crf_inputs(ctx)
    t = em.shape[1]
    start, end, trans = w[0], w[1], w[2:]
    t_idx = torch.arange(t, device=em.device)
    valid = t_idx[None, :] < length[:, None]
    delta = start[None] + em[:, 0]
    back = []
    for s in range(1, t):
        cand = delta[:, :, None] + trans[None]         # (B, N, N)
        back.append(torch.argmax(cand, dim=1))
        delta = torch.where(valid[:, s, None], cand.amax(dim=1) + em[:, s],
                            delta)
    # frozen steps keep delta, so delta is each row's own final delta
    tag = torch.argmax(delta + end[None], dim=-1)      # (B,)
    tags = [None] * t
    tags[t - 1] = tag
    for s in range(t - 1, 0, -1):
        prev = torch.gather(back[s - 1], 1, tag[:, None])[:, 0]
        tag = torch.where(s < length, prev, tag)
        tags[s - 1] = tag
    path = torch.stack(tags, 1)
    path = torch.where(valid, path, torch.zeros_like(path))
    label = ctx.in_("Label")
    if label is not None:
        err = (path != _labels(label)) & valid
        return {"ViterbiPath": err.long()}
    return {"ViterbiPath": path}
