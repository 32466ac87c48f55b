"""Metric ops.

Parity: paddle/fluid/operators/metrics/accuracy_op.*; the counterpart of
``paddle_tpu/ops/metric_ops.py``'s ``accuracy``: the share of rows whose
label is among the top-k indices. Under data parallelism it is the
global share: each rank's correct and total counts, summed over dp.
"""

import torch

from . import register


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
