"""CTC: the loss (warpctc parity) and greedy decoding.

Parity: paddle/fluid/operators/warpctc_op.* (which wraps the warp-ctc
CUDA library) and ctc_align_op (``ctc_greedy_decoder``); the counterpart
of ``paddle_tpu/ops/ctc_ops.py``. The alpha recursion runs in log space
over the extended-label lattice (2L + 1 states) for the whole batch, a
Python loop over the padded T; per-sequence lengths are masks, and the
backward is autograd's through the recursion, as JAX's is ``jax.grad``
through its scan.

The recursion is the JAX package's own, not ``torch.nn.functional.
ctc_loss``:

- ``NEG_INF`` is -1e30, so an infeasible alignment (a label longer than
  its input can emit) gives a large finite loss (about 1e30) where
  ``F.ctc_loss`` gives inf, and the two differ for empty labels too;
- ``_log_add`` clamps both inputs before the arithmetic where both are
  "-inf" (the double-where): otherwise the untaken branch of the outer
  ``torch.where`` leaks d log(0 + 0) = inf * 0 = NaN into the gradient,
  as it would in JAX.

``ctc_align`` left-compacts the kept ids (a stable argsort of (dropped,
position), where JAX scatters by rank) and pads with -1; ids and lengths
are int64 (the JAX package's are int32, ROADMAP C12).

Under data parallelism both run a rank's rows.
"""

import torch

from . import register
from .sequence_ops import lengths_or_full, rows_with

NEG_INF = -1e30


def _log_add(a, b):
    """log(exp(a) + exp(b)), NEG_INF where both are at or below
    NEG_INF / 2, with both inputs clamped first so that the untaken
    branch stays finite in the backward."""
    both = torch.maximum(a, b) <= NEG_INF / 2
    a2 = a.masked_fill(both, 0.0)
    b2 = b.masked_fill(both, 0.0)
    m = torch.maximum(a2, b2)
    out = m + torch.log(torch.exp(a2 - m) + torch.exp(b2 - m))
    return out.masked_fill(both, NEG_INF)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0):
    """log_probs (B, T, C) log-softmaxed; labels (B, L) padded. Returns
    each sequence's negative log-likelihood (B,)."""
    b, t, _c = log_probs.shape
    s = 2 * labels.shape[1] + 1
    dev = log_probs.device
    # the extended label sequence: blank, y1, blank, y2, ..., blank
    ext = torch.full((b, s), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = labels
    # a skip over a blank is allowed between distinct labels
    skip_ok = torch.cat([torch.zeros((b, 2), dtype=torch.bool, device=dev),
                         ext[:, 2:] != ext[:, :-2]], dim=1)
    valid_state = torch.arange(s, device=dev)[None] < \
        (2 * label_lengths + 1)[:, None]
    neg1 = torch.full((b, 1), NEG_INF, device=dev)
    neg2 = torch.full((b, 2), NEG_INF, device=dev)

    first_lab = torch.gather(log_probs[:, 0], 1, ext[:, 1:2])[:, 0]
    alpha = torch.cat([
        log_probs[:, 0, blank][:, None],
        torch.where(label_lengths > 0, first_lab,
                    torch.full_like(first_lab, NEG_INF))[:, None],
        torch.full((b, s - 2), NEG_INF, device=dev)], dim=1)
    alpha = alpha.masked_fill(~valid_state, NEG_INF)
    for step in range(1, t):
        prev1 = torch.cat([neg1, alpha[:, :-1]], dim=1)
        prev2 = torch.cat([neg2, alpha[:, :-2]], dim=1)
        a = _log_add(alpha, prev1)
        a = torch.where(skip_ok, _log_add(a, prev2), a)
        a = a + torch.gather(log_probs[:, step], 1, ext)
        a = a.masked_fill(~valid_state, NEG_INF)
        alpha = torch.where((step < input_lengths)[:, None], a, alpha)

    # the final states: the last blank (2L) and the last label (2L - 1)
    last_blank = torch.gather(alpha, 1, (2 * label_lengths)[:, None])[:, 0]
    idx = (2 * label_lengths - 1).clamp(0, s - 1)
    last_lab = torch.gather(alpha, 1, idx[:, None])[:, 0]
    last_lab = torch.where(label_lengths > 0, last_lab,
                           torch.full_like(last_lab, NEG_INF))
    return -_log_add(last_blank, last_lab)


@register("warpctc", dp=rows_with("Logits", "Label", "LogitsLength",
                                  "LabelLength"))
def warpctc(ctx):
    """Logits (B, T, C) unnormalized (the op applies the log-softmax, as
    warp-ctc does); Label (B, L) padded. Loss (B, 1); norm_by_times
    divides each by its input length."""
    logits = ctx.in_("Logits").float()
    labels = ctx.in_("Label")
    if labels.dim() == 3:
        labels = labels[..., 0]
    b, t, _c = logits.shape
    in_len = lengths_or_full(ctx.in_("LogitsLength"), b, t, logits.device)
    lab_len = lengths_or_full(ctx.in_("LabelLength"), b, labels.shape[1],
                              logits.device)
    loss = ctc_loss(torch.log_softmax(logits, dim=-1), labels.long(),
                    in_len, lab_len, blank=ctx.attr("blank", 0))
    if ctx.attr("norm_by_times", False):
        loss = loss / in_len.float().clamp(min=1.0)
    return {"Loss": loss[:, None]}


@register("ctc_align", "ctc_greedy_decoder",
          dp=rows_with("Input", "InputLength"))
def ctc_align(ctx):
    """The greedy decode: the argmax at each step, repeats merged and
    blanks dropped. Output (B, T) int64 left-compacted and padded with
    -1, OutputLength (B, 1) int64: the padded form of the reference's
    LoD output."""
    x = ctx.in_("Input")                               # (B, T, C)
    blank = ctx.attr("blank", 0)
    b, t, _c = x.shape
    ids = torch.argmax(x, dim=-1)                      # (B, T)
    in_len = lengths_or_full(ctx.in_("InputLength"), b, t, x.device)
    steps = torch.arange(t, device=x.device)[None]
    prev = torch.cat([torch.full((b, 1), -1, dtype=ids.dtype,
                                 device=x.device), ids[:, :-1]], dim=1)
    keep = (ids != blank) & (ids != prev) & (steps < in_len[:, None])
    order = torch.argsort((~keep).long() * (t + 1) + steps, dim=1)
    count = keep.sum(dim=1)
    out = torch.gather(ids, 1, order)
    out = torch.where(steps < count[:, None], out, torch.full_like(out, -1))
    return {"Output": out, "OutputLength": count[:, None]}
