"""Loss layers.

Parity: the loss functions of python/paddle/fluid/layers/nn.py; the
counterpart of ``paddle_tpu/layers/loss.py``, every name of it:
``cross_entropy``, ``softmax_with_cross_entropy``, ``square_error_cost``,
``sigmoid_cross_entropy_with_logits``, ``huber_loss``, ``log_loss``,
``bpr_loss``, ``kldiv_loss``, ``rank_loss``, ``margin_rank_loss``,
``dice_loss``, ``npair_loss``, ``mse_loss``, ``smooth_l1`` (``nn``'s),
``teacher_student_sigmoid_loss``, ``cos_sim`` and ``center_loss``.
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


def huber_loss(input, label, delta):
    helper = LayerHelper("huber_loss")
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    resid = helper.create_variable_for_type_inference(input.dtype,
                                                      input.shape)
    helper.append_op("huber_loss", {"X": input, "Y": label},
                     {"Out": out, "Residual": resid}, {"delta": float(delta)})
    return out


def bpr_loss(input, label, name=None):
    helper = LayerHelper("bpr_loss", name=name)
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    (input.shape[0], 1))
    helper.append_op("bpr_loss", {"X": input, "Label": label}, {"Y": out})
    return out


def kldiv_loss(x, target, reduction="mean", name=None):
    helper = LayerHelper("kldiv_loss", name=name)
    shape = () if reduction in ("mean", "sum", "batchmean") else x.shape
    out = helper.create_variable_for_type_inference(x.dtype, shape)
    helper.append_op("kldiv_loss", {"X": x, "Target": target},
                     {"Loss": out}, {"reduction": reduction})
    return out


def rank_loss(label, left, right, name=None):
    helper = LayerHelper("rank_loss", name=name)
    out = helper.create_variable_for_type_inference(left.dtype, left.shape)
    helper.append_op("rank_loss",
                     {"Label": label, "Left": left, "Right": right},
                     {"Out": out})
    return out


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    helper = LayerHelper("margin_rank_loss", name=name)
    out = helper.create_variable_for_type_inference(left.dtype, left.shape)
    act = helper.create_variable_for_type_inference(left.dtype, left.shape)
    helper.append_op("margin_rank_loss",
                     {"Label": label, "X1": left, "X2": right},
                     {"Out": out, "Activated": act}, {"margin": margin})
    return out


def dice_loss(input, label, epsilon=1e-5):
    helper = LayerHelper("dice_loss")
    out = helper.create_variable_for_type_inference(input.dtype, ())
    helper.append_op("dice_loss", {"X": input, "Label": label}, {"Out": out},
                     {"epsilon": epsilon})
    return out


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    helper = LayerHelper("npair_loss")
    out = helper.create_variable_for_type_inference(anchor.dtype, ())
    helper.append_op("npair_loss",
                     {"Anchor": anchor, "Positive": positive,
                      "Labels": labels},
                     {"Out": out}, {"l2_reg": l2_reg})
    return out


def mse_loss(input, label):
    helper = LayerHelper("mse_loss")
    out = helper.create_variable_for_type_inference(input.dtype, ())
    helper.append_op("mse_loss", {"X": input, "Y": label}, {"Out": out})
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    from .nn import smooth_l1 as _impl
    return _impl(x, y, inside_weight, outside_weight, sigma)


def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    """Parity: fluid.layers.teacher_student_sigmoid_loss. The bounds
    shape only the reference's hand-written gradient; autograd
    differentiates the forward, so they have no effect (as in the JAX
    package)."""
    helper = LayerHelper("teacher_student_sigmoid_loss")
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    (input.shape[0], 1))
    helper.append_op("teacher_student_sigmoid_loss",
                     {"X": input, "Label": label}, {"Y": out},
                     {"soft_max_up_bound": soft_max_up_bound,
                      "soft_max_lower_bound": soft_max_lower_bound})
    return out


def center_loss(input, label, num_classes, alpha, param_attr=None,
                update_center=True):
    """Parity: fluid.layers.center_loss: 0.5 |x - c_label|^2 a row, with
    the centers a persistable, non-trainable (num_classes, D) parameter
    (zeros) that the op updates in place (CentersOut is Centers) by alpha
    in training."""
    from .. import initializer as init_mod
    from .tensor import fill_constant
    helper = LayerHelper("center_loss", param_attr=param_attr)
    centers = helper.create_parameter(
        attr=helper.param_attr, shape=[num_classes, input.shape[-1]],
        dtype=input.dtype,
        default_initializer=init_mod.ConstantInitializer(0.0))
    centers.trainable = False
    alpha_var = fill_constant([1], "float32", alpha)
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    (input.shape[0], 1))
    diff = helper.create_variable_for_type_inference(input.dtype,
                                                     input.shape)
    helper.append_op("center_loss",
                     {"X": input, "Label": label, "Centers": centers,
                      "CenterUpdateRate": alpha_var},
                     {"Loss": out, "SampleCenterDiff": diff,
                      "CentersOut": centers},
                     {"need_update": update_center})
    return out
