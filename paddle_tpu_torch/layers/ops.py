"""Unary layers.

Parity: python/paddle/fluid/layers/ops.py (layer_function_generator-
produced wrappers around activation_op.cc kernels); the counterpart of
``paddle_tpu/layers/ops.py`` with the unary layers the ported slices
use: ``sigmoid`` (SE-ResNeXt's excitation) and, for the learning-rate
schedules, ``exp``, ``ceil``, ``floor`` and ``cos``. (``relu`` is in
``nn.py``, as in the JAX package.)
"""

from ..core.layer_helper import LayerHelper

_UNARY = ["sigmoid", "exp", "ceil", "floor", "cos"]

__all__ = list(_UNARY)


def _make_unary(op_type):
    def fn(x, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype, x.shape)
        helper.append_op(op_type, {"X": x}, {"Out": out})
        return out
    fn.__name__ = op_type
    fn.__doc__ = f"Parity: fluid.layers.{op_type} (activation_op.cc)."
    return fn


for _name in _UNARY:
    globals()[_name] = _make_unary(_name)
