"""Weight-decay regularizers.

Parity: python/paddle/fluid/regularizer.py; a copy of
``paddle_tpu/optimizer/regularizer.py``. Regularization terms are appended
as ops rewriting `param@GRAD` in the env, where fluid appends its
append_regularization_ops: after the gradient clip, before the
optimizer's update ops.
"""

from ..core.layer_helper import LayerHelper


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    """grad += coeff * param."""

    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        helper = LayerHelper("l2_decay")
        decay = helper.create_variable_for_type_inference(param.dtype, param.shape)
        block.append_op("scale", {"X": param}, {"Out": decay},
                        {"scale": self._coeff})
        block.append_op("elementwise_add", {"X": grad, "Y": decay},
                        {"Out": grad}, {"axis": -1})
        return grad


class L1DecayRegularizer(WeightDecayRegularizer):
    """grad += coeff * sign(param)."""

    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        helper = LayerHelper("l1_decay")
        sign = helper.create_variable_for_type_inference(param.dtype, param.shape)
        block.append_op("sign", {"X": param}, {"Out": sign})
        decay = helper.create_variable_for_type_inference(param.dtype, param.shape)
        block.append_op("scale", {"X": sign}, {"Out": decay},
                        {"scale": self._coeff})
        block.append_op("elementwise_add", {"X": grad, "Y": decay},
                        {"Out": grad}, {"axis": -1})
        return grad


# fluid aliases
L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer


def append_regularization_ops(params_grads, regularization=None):
    """The parameter's own regularizer (ParamAttr(regularizer=)) wins
    over the optimizer's."""
    out = []
    for param, grad in params_grads:
        reg = param.regularizer if param.regularizer is not None else regularization
        if reg is not None:
            grad = reg(param, grad, param.block.program.global_block())
        out.append((param, grad))
    return out
