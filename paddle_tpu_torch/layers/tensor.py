"""Tensor creation layers.

Parity: python/paddle/fluid/layers/tensor.py; the counterpart of
``paddle_tpu/layers/tensor.py``'s ``create_parameter``, ``fill_constant``
and ``zeros_like``.
"""

from ..core.layer_helper import LayerHelper
from .. import initializer as init_mod


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    from ..core.param_attr import ParamAttr
    if attr is None and name is not None:
        attr = ParamAttr(name=name)
    helper = LayerHelper("create_parameter", param_attr=attr, name=name)
    if default_initializer is None:
        default_initializer = (init_mod.ConstantInitializer(0.0) if is_bias
                               else init_mod.XavierInitializer())
    return helper.create_parameter(helper.param_attr, shape, dtype, is_bias,
                                   default_initializer)


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype, tuple(shape))
    helper.append_op("fill_constant", {}, {"Out": out},
                     {"shape": list(shape), "dtype": dtype,
                      "value": float(value)})
    return out


def zeros_like(x, out=None):
    helper = LayerHelper("zeros_like")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op("zeros_like", {"X": x}, {"Out": out})
    return out
