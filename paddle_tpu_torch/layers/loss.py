"""Loss layers.

Parity: the loss functions of python/paddle/fluid/layers/nn.py; the
counterpart of ``paddle_tpu/layers/loss.py``'s
``softmax_with_cross_entropy``.
"""

from ..core.layer_helper import LayerHelper


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax = helper.create_variable_for_type_inference(logits.dtype, logits.shape)
    loss_shape = tuple(logits.shape[:-1]) + (1,)
    loss = helper.create_variable_for_type_inference(logits.dtype, loss_shape)
    helper.append_op("softmax_with_cross_entropy",
                     {"Logits": logits, "Label": label},
                     {"Softmax": softmax, "Loss": loss},
                     {"soft_label": soft_label, "ignore_index": ignore_index,
                      "axis": axis})
    if return_softmax:
        return loss, softmax
    return loss
