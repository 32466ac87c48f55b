"""Loss layers.

Parity: the loss functions of python/paddle/fluid/layers/nn.py; the
counterpart of ``paddle_tpu/layers/loss.py``'s ``cross_entropy``,
``softmax_with_cross_entropy``, ``square_error_cost``,
``sigmoid_cross_entropy_with_logits``, ``log_loss`` and ``cos_sim``
(``smooth_l1`` is ``nn``'s).
"""

from ..core.layer_helper import LayerHelper


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy")
    shape = tuple(input.shape[:-1]) + (1,)
    out = helper.create_variable_for_type_inference(input.dtype, shape)
    helper.append_op("cross_entropy", {"X": input, "Label": label},
                     {"Y": out},
                     {"soft_label": soft_label, "ignore_index": ignore_index})
    return out


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


def square_error_cost(input, label):
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    sub = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op("square_error_cost", {"X": input, "Y": label},
                     {"Out": out, "sub_result": sub})
    return out


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100, name=None,
                                      normalize=False):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op("sigmoid_cross_entropy_with_logits",
                     {"X": x, "Label": label}, {"Out": out},
                     {"ignore_index": ignore_index, "normalize": normalize})
    return out


def log_loss(input, label, epsilon=1e-4, name=None):
    helper = LayerHelper("log_loss", name=name)
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op("log_loss", {"Predicted": input, "Labels": label},
                     {"Loss": out}, {"epsilon": epsilon})
    return out



def cos_sim(X, Y):
    """Parity: fluid.layers.cos_sim: the cosine similarity of X's and Y's
    rows, (B, 1)."""
    helper = LayerHelper("cos_sim")
    out = helper.create_variable_for_type_inference(X.dtype, (X.shape[0], 1))
    xn = helper.create_variable_for_type_inference(X.dtype)
    yn = helper.create_variable_for_type_inference(X.dtype)
    helper.append_op("cos_sim", {"X": X, "Y": Y},
                     {"Out": out, "XNorm": xn, "YNorm": yn})
    return out
