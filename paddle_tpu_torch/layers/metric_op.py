"""Metric layers.

Parity: python/paddle/fluid/layers/metric_op.py; the counterpart of
``paddle_tpu/layers/metric_op.py``'s ``accuracy`` (``auc`` is not
ported).
"""

from ..core.layer_helper import LayerHelper


def accuracy(input, label, k=1, correct=None, total=None):
    helper = LayerHelper("accuracy")
    topk_out = helper.create_variable_for_type_inference(input.dtype)
    topk_idx = helper.create_variable_for_type_inference("int64")
    helper.append_op("top_k", {"X": input},
                     {"Out": topk_out, "Indices": topk_idx}, {"k": k})
    acc = helper.create_variable_for_type_inference("float32", (1,))
    correct = correct or helper.create_variable_for_type_inference("int32",
                                                                   (1,))
    total = total or helper.create_variable_for_type_inference("int32", (1,))
    helper.append_op("accuracy",
                     {"Out": topk_out, "Indices": topk_idx, "Label": label},
                     {"Accuracy": acc, "Correct": correct, "Total": total})
    return acc
