"""Loss ops.

Parity: paddle/fluid/operators/softmax_with_cross_entropy_op.*; the
counterpart of ``paddle_tpu/ops/loss_ops.py`` with the loss the ported
slice runs.
"""

import torch

from . import register


def _squeeze_label(label):
    if label.dim() >= 1 and label.shape[-1] == 1:
        return label.reshape(label.shape[:-1])
    return label


@register("softmax_with_cross_entropy")
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
