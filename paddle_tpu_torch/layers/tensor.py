"""Tensor creation layers.

Parity: python/paddle/fluid/layers/tensor.py; the counterpart of
``paddle_tpu/layers/tensor.py``'s ``create_parameter``,
``create_global_var``, ``fill_constant``,
``fill_constant_batch_size_like``, ``zeros_like``, ``ones_like``,
``sums``, ``assign`` (of a Variable), ``range`` and
``tensor_array_to_tensor``.
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


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A global-block variable filled with `value` by the startup
    program."""
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(
        persistable=persistable, name=name, shape=shape, dtype=dtype)
    init_mod.ConstantInitializer(value)(var)
    return var


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype, tuple(shape))
    helper.append_op("fill_constant", {}, {"Out": out},
                     {"shape": list(shape), "dtype": dtype,
                      "value": float(value)})
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    """A constant of `shape` whose dim output_dim_idx is input's dim
    input_dim_idx at run time (the batch, where the batch is -1)."""
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype, tuple(shape))
    helper.append_op("fill_constant_batch_size_like", {"Input": input},
                     {"Out": out},
                     {"shape": list(shape), "dtype": dtype,
                      "value": float(value), "input_dim_idx": input_dim_idx,
                      "output_dim_idx": output_dim_idx})
    return out


def zeros_like(x, out=None):
    helper = LayerHelper("zeros_like")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op("zeros_like", {"X": x}, {"Out": out})
    return out


def ones_like(x, out=None):
    helper = LayerHelper("ones_like")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op("ones_like", {"X": x}, {"Out": out}, {"value": 1.0})
    return out


def sums(input, out=None):
    """Parity: fluid.layers.sums: the elementwise sum of same-shaped
    inputs (the ``sum`` op: three or more as one stacked reduction, where
    the JAX package chains adds)."""
    helper = LayerHelper("sums")
    xs = input if isinstance(input, (list, tuple)) else [input]
    if out is None:
        out = helper.create_variable_for_type_inference(xs[0].dtype,
                                                        xs[0].shape)
    helper.append_op("sum", {"X": xs}, {"Out": out})
    return out


def assign(input, output=None):
    """Parity: fluid.layers.assign of a Variable: a copy of `input`, into
    `output` when given. (The JAX package also assigns numpy values, by
    ``assign_value``, which the port does not register.)"""
    from ..core.framework import Variable
    if not isinstance(input, Variable):
        raise NotImplementedError(
            "layers.assign of a numpy value (assign_value) is not ported; "
            "assign a Variable")
    helper = LayerHelper("assign")
    if output is None:
        output = helper.create_variable_for_type_inference(input.dtype,
                                                           input.shape)
    helper.append_op("assign", {"X": input}, {"Out": output})
    return output


def tensor_array_to_tensor(input, axis=1, name=None, use_stack=False):
    """Parity: fluid.layers.tensor_array_to_tensor: concat (or stack) a
    TensorArray along `axis`. Returns (out, index) like the reference,
    index holding each entry's size along `axis` (int64, the port's
    integer policy, where the JAX package's is int32)."""
    helper = LayerHelper("tensor_array_to_tensor", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    index = helper.create_variable_for_type_inference("int64")
    helper.append_op("tensor_array_to_tensor", {"X": input},
                     {"Out": out}, {"axis": axis, "use_stack": use_stack})
    helper.append_op("tensor_array_sizes", {"X": input}, {"Out": index},
                     {"axis": axis})
    return out, index


def range(start, end, step, dtype="float32"):
    """arange(start, end, step): a (ceil((end - start) / step),) tensor."""
    import math
    helper = LayerHelper("range")
    n = int(max(0, math.ceil((end - start) / step)))
    out = helper.create_variable_for_type_inference(dtype, (n,))
    helper.append_op("range", {}, {"Out": out},
                     {"start": start, "end": end, "step": step,
                      "dtype": dtype})
    return out
