"""Neural-network layers (declarative API).

Parity: python/paddle/fluid/layers/nn.py; the counterpart of
``paddle_tpu/layers/nn.py`` with the layers the ported slice uses. Each
function appends ops to the default main program; their implementations
live in paddle_tpu_torch/ops/.
"""

from ..core.layer_helper import LayerHelper
from .. import initializer as init_mod


def _prod(xs):
    r = 1
    for x in xs:
        r *= int(x)
    return r


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Parity: fluid.layers.fc: mul, then the bias and the activation.
    One input (the reference's list of inputs needs the sum op, not
    ported)."""
    if isinstance(input, (list, tuple)):
        if len(input) != 1:
            raise NotImplementedError("fc over several inputs needs the sum "
                                      "op, which is not ported")
        input = input[0]
    helper = LayerHelper("fc", param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    dtype = input.dtype
    in_features = _prod(input.shape[num_flatten_dims:])
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[in_features, size], dtype=dtype)
    out_shape = tuple(input.shape[:num_flatten_dims]) + (size,)
    pre_bias = helper.create_variable_for_type_inference(dtype, out_shape)
    helper.append_op("mul", {"X": input, "Y": w}, {"Out": pre_bias},
                     {"x_num_col_dims": num_flatten_dims,
                      "y_num_col_dims": 1})
    pre_act = _append_bias(helper, pre_bias, size, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def _append_bias(helper, pre_bias, size, dim_start=1):
    bias_attr = helper.bias_attr
    if bias_attr is False:
        return pre_bias
    b = helper.create_parameter(attr=bias_attr, shape=[size],
                                dtype=pre_bias.dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(pre_bias.dtype, pre_bias.shape)
    helper.append_op("elementwise_add", {"X": pre_bias, "Y": b}, {"Out": out},
                     {"axis": dim_start})
    return out


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32", name=None):
    """Parity: fluid.layers.embedding. is_sparse is accepted but moot: the
    gradient is a dense (V, hidden) scatter-add."""
    helper = LayerHelper("embedding", param_attr=param_attr, name=name)
    w = helper.create_parameter(attr=helper.param_attr, shape=list(size),
                                dtype=dtype,
                                default_initializer=init_mod.XavierInitializer())
    in_shape = tuple(input.shape)
    if in_shape and in_shape[-1] == 1:
        in_shape = in_shape[:-1]
    out = helper.create_variable_for_type_inference(dtype, in_shape + (size[1],))
    pidx = -1 if padding_idx is None else (
        padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    helper.append_op("lookup_table", {"W": w, "Ids": input}, {"Out": out},
                     {"padding_idx": pidx, "is_sparse": is_sparse})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    xs = list(x.shape)
    ys = list(y.shape)
    if transpose_x and len(xs) >= 2:
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if transpose_y and len(ys) >= 2:
        ys[-1], ys[-2] = ys[-2], ys[-1]
    out_shape = tuple(xs[:-1] + ys[-1:]) if len(ys) >= 2 else tuple(xs[:-1])
    out = helper.create_variable_for_type_inference(x.dtype, out_shape)
    helper.append_op("matmul", {"X": x, "Y": y}, {"Out": out},
                     {"transpose_X": transpose_x, "transpose_Y": transpose_y,
                      "alpha": float(alpha)})
    return out


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1, epsilon=1e-5,
               param_attr=None, bias_attr=None, act=None, name=None):
    helper = LayerHelper("layer_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    norm_size = _prod(input.shape[begin_norm_axis:])
    inputs = {"X": input}
    if scale:
        s = helper.create_parameter(
            attr=helper.param_attr, shape=[norm_size], dtype="float32",
            default_initializer=init_mod.ConstantInitializer(1.0))
        inputs["Scale"] = s
    if shift:
        b = helper.create_parameter(attr=helper.bias_attr, shape=[norm_size],
                                    dtype="float32", is_bias=True)
        inputs["Bias"] = b
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    mean = helper.create_variable_for_type_inference("float32")
    var = helper.create_variable_for_type_inference("float32")
    helper.append_op("layer_norm", inputs,
                     {"Y": out, "Mean": mean, "Variance": var},
                     {"begin_norm_axis": begin_norm_axis, "epsilon": epsilon})
    return helper.append_activation(out)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    mask = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op("dropout", {"X": x}, {"Out": out, "Mask": mask},
                     {"dropout_prob": dropout_prob, "is_test": is_test,
                      "dropout_implementation": dropout_implementation,
                      "op_seed": helper.next_op_seed()})
    return out


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, ())
    helper.append_op("mean", {"X": x}, {"Out": out})
    return out


# ---- reductions ------------------------------------------------------------

def _reduce_shape(shape, dim, keep_dim):
    if dim is None:
        return () if not keep_dim else tuple(1 for _ in shape)
    dims = [d % len(shape) for d in (dim if isinstance(dim, (list, tuple))
                                     else [dim])]
    if keep_dim:
        return tuple(1 if i in dims else s for i, s in enumerate(shape))
    return tuple(s for i, s in enumerate(shape) if i not in dims)


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    helper = LayerHelper("reduce_sum", name=name)
    out = helper.create_variable_for_type_inference(
        input.dtype, _reduce_shape(input.shape, dim, keep_dim))
    attrs = {"keep_dim": keep_dim}
    if dim is None:
        attrs["reduce_all"] = True
        attrs["dim"] = [0]
    else:
        attrs["dim"] = dim if isinstance(dim, (list, tuple)) else [dim]
    helper.append_op("reduce_sum", {"X": input}, {"Out": out}, attrs)
    return out


# ---- elementwise -----------------------------------------------------------

def _make_elementwise(op_type):
    def fn(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, act=act, name=name)
        shape = x.shape if len(x.shape) >= len(y.shape) else y.shape
        out = helper.create_variable_for_type_inference(x.dtype, shape)
        helper.append_op(op_type, {"X": x, "Y": y}, {"Out": out},
                         {"axis": axis})
        return helper.append_activation(out)
    fn.__name__ = op_type
    return fn


elementwise_add = _make_elementwise("elementwise_add")
elementwise_mul = _make_elementwise("elementwise_mul")
elementwise_div = _make_elementwise("elementwise_div")
elementwise_max = _make_elementwise("elementwise_max")
elementwise_min = _make_elementwise("elementwise_min")
elementwise_pow = _make_elementwise("elementwise_pow")


def logical_and(x, y, out=None, name=None):
    helper = LayerHelper("logical_and", name=name)
    out = out or helper.create_variable_for_type_inference("bool", x.shape)
    helper.append_op("logical_and", {"X": x, "Y": y}, {"Out": out})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op("scale", {"X": x}, {"Out": out},
                     {"scale": float(scale), "bias": float(bias),
                      "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape", act=act, name=name)
    out_shape = list(shape)
    known = _prod([s for s in out_shape if s > 0]) or 1
    if -1 in out_shape and all(s >= 0 for s in x.shape):
        total = _prod(x.shape)
        out_shape[out_shape.index(-1)] = total // known
    out = helper.create_variable_for_type_inference(x.dtype, tuple(out_shape))
    xshape = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("reshape2", {"X": x}, {"Out": out, "XShape": xshape},
                     {"shape": list(shape)})
    return helper.append_activation(out)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", name=name)
    out_shape = tuple(x.shape[p] for p in perm) if x.shape else ()
    out = helper.create_variable_for_type_inference(x.dtype, out_shape)
    xshape = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("transpose2", {"X": x}, {"Out": out, "XShape": xshape},
                     {"axis": list(perm)})
    return out


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    shape = list(input.shape)
    for a, s, e in zip(axes, starts, ends):
        dim = shape[a]
        if dim >= 0:
            s2 = max(s + dim, 0) if s < 0 else min(s, dim)
            e2 = max(e + dim, 0) if e < 0 else min(e, dim)
            shape[a] = max(e2 - s2, 0)
    out = helper.create_variable_for_type_inference(input.dtype, tuple(shape))
    helper.append_op("slice", {"Input": input}, {"Out": out},
                     {"axes": list(axes), "starts": list(starts),
                      "ends": list(ends)})
    return out


def gather(input, index, overwrite=True):
    helper = LayerHelper("gather")
    shape = (index.shape[0] if index.shape else -1,) + tuple(input.shape[1:])
    out = helper.create_variable_for_type_inference(input.dtype, shape)
    helper.append_op("gather", {"X": input, "Index": index}, {"Out": out})
    return out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    shape = tuple(input.shape[:-1]) + (k,)
    out = helper.create_variable_for_type_inference(input.dtype, shape)
    idx = helper.create_variable_for_type_inference("int64", shape)
    helper.append_op("top_k", {"X": input}, {"Out": out, "Indices": idx},
                     {"k": k})
    return out, idx


def cast(x, dtype):
    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(dtype, x.shape)
    helper.append_op("cast", {"X": x}, {"Out": out}, {"out_dtype": dtype})
    return out


def softmax(input, use_cudnn=False, name=None, axis=-1):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op("softmax", {"X": input}, {"Out": out}, {"axis": axis})
    return out
