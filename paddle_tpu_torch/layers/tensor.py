"""Tensor creation and manipulation layers.

Parity: python/paddle/fluid/layers/tensor.py; the counterpart of
``paddle_tpu/layers/tensor.py``, every name of it: the creators
(``create_tensor``, ``create_parameter``, ``create_global_var``,
``fill_constant``, ``fill_constant_batch_size_like``, ``zeros``,
``ones``, ``zeros_like``, ``ones_like``, ``linspace``, ``range``,
``eye``, ``diag``), ``sums``, ``assign`` of a Variable or of a numpy
value (the ``assign_value`` op), ``reverse``, ``has_inf``, ``has_nan``,
``isfinite``, ``scatter_nd``, ``strided_slice``, ``unique``,
``unique_with_counts``, ``shard_index``, ``pad_constant_like`` and
``tensor_array_to_tensor``, with ``nn``'s ``cast``, ``concat``,
``argmin``, ``argmax`` and ``argsort`` re-exported as there.
"""

import numpy as np

from ..core.layer_helper import LayerHelper
from .. import initializer as init_mod
from .nn import cast, concat, argmin, argmax, argsort  # noqa: F401


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_variable(name=name, dtype=dtype,
                                  persistable=persistable)


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
    """Parity: fluid.layers.assign: a copy of a Variable (``assign``), or
    a numpy value made a constant of its dtype and shape
    (``assign_value``), into `output` when given."""
    from ..core.framework import Variable
    helper = LayerHelper("assign")
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(input.dtype,
                                                               input.shape)
        helper.append_op("assign", {"X": input}, {"Out": output})
        return output
    arr = np.asarray(input)
    if output is None:
        output = helper.create_variable_for_type_inference(str(arr.dtype),
                                                           arr.shape)
    helper.append_op("assign_value", {}, {"Out": output},
                     {"shape": list(arr.shape), "dtype": str(arr.dtype),
                      "values": arr.reshape(-1).tolist()})
    return output


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 0.0)


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 1.0)


def linspace(start, stop, num, dtype="float32"):
    helper = LayerHelper("linspace")
    out = helper.create_variable_for_type_inference(dtype, (num,))
    helper.append_op("linspace", {}, {"Out": out},
                     {"start": float(start), "stop": float(stop),
                      "num": int(num), "dtype": dtype})
    return out


def eye(num_rows, num_columns=None, batch_shape=None, dtype="float32"):
    helper = LayerHelper("eye")
    num_columns = num_columns if num_columns is not None else num_rows
    out = helper.create_variable_for_type_inference(dtype,
                                                    (num_rows, num_columns))
    helper.append_op("eye", {}, {"Out": out},
                     {"num_rows": num_rows, "num_columns": num_columns,
                      "dtype": dtype})
    return out


def diag(diagonal):
    helper = LayerHelper("diag")
    n = diagonal.shape[0] if diagonal.shape else -1
    out = helper.create_variable_for_type_inference(diagonal.dtype, (n, n))
    helper.append_op("diag", {"Diagonal": diagonal}, {"Out": out})
    return out


def reverse(x, axis):
    helper = LayerHelper("reverse")
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    helper.append_op("reverse", {"X": x}, {"Out": out}, {"axis": list(axes)})
    return out


def _flag(op_type, x):
    """One bool of the whole tensor, shape (), on the device."""
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference("bool", ())
    helper.append_op(op_type, {"X": x}, {"Out": out})
    return out


def has_inf(x):
    return _flag("has_inf", x)


def has_nan(x):
    return _flag("has_nan", x)


def isfinite(x):
    return _flag("isfinite", x)


def scatter_nd(index, updates, shape, name=None):
    """Zeros of `shape` with `updates` added at `index`'s tuples."""
    helper = LayerHelper("scatter_nd", name=name)
    out = helper.create_variable_for_type_inference(updates.dtype,
                                                    tuple(shape))
    helper.append_op("scatter_nd", {"Index": index, "Updates": updates},
                     {"Out": out}, {"shape": list(shape)})
    return out


def strided_slice(input, axes, starts, ends, strides, name=None):
    helper = LayerHelper("strided_slice", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("strided_slice", {"Input": input}, {"Out": out},
                     {"axes": list(axes), "starts": list(starts),
                      "ends": list(ends), "strides": list(strides)})
    return out


def unique(x, dtype="int32"):
    """(the sorted distinct values padded with 0 to x's size, each
    entry's index among them): fixed shapes, as the JAX package gives."""
    out, index, _ = _unique("unique", x, dtype)
    return out, index


def unique_with_counts(x, dtype="int32"):
    """unique's two outputs and each value's count, padded with 0."""
    return _unique("unique_with_counts", x, dtype)


def _unique(op_type, x, dtype):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    index = helper.create_variable_for_type_inference(dtype, x.shape)
    count = helper.create_variable_for_type_inference(dtype, x.shape)
    outs = {"Out": out, "Index": index}
    if op_type == "unique_with_counts":
        outs["Count"] = count
    helper.append_op(op_type, {"X": x}, outs, {"dtype": dtype})
    return out, index, count


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    """Parity: fluid.layers.shard_index (the ids of one embedding
    shard)."""
    helper = LayerHelper("shard_index")
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op("shard_index", {"X": input}, {"Out": out},
                     {"index_num": index_num, "nshards": nshards,
                      "shard_id": shard_id, "ignore_value": ignore_value})
    return out


def pad_constant_like(x, y, pad_value=0.0, name=None):
    """y padded at the end of each dim to x's shape."""
    helper = LayerHelper("pad_constant_like", name=name)
    out = helper.create_variable_for_type_inference(y.dtype, x.shape)
    helper.append_op("pad_constant_like", {"X": x, "Y": y}, {"Out": out},
                     {"pad_value": float(pad_value)})
    return out


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
