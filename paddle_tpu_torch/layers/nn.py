"""Neural-network layers (declarative API).

Parity: python/paddle/fluid/layers/nn.py; the counterpart of
``paddle_tpu/layers/nn.py`` with the layers the ported slices use. Each
function appends ops to the default main program; their implementations
live in paddle_tpu_torch/ops/.
"""

import builtins

from ..core.layer_helper import LayerHelper
from .. import initializer as init_mod


def _prod(xs):
    r = 1
    for x in xs:
        r *= int(x)
    return r


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        t = [int(x) for x in v]
        return t * n if len(t) == 1 else t
    return [int(v)] * n


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Parity: fluid.layers.fc: a mul for each input (each with its own
    weight), their ``sum`` where there are several, then the bias and the
    activation."""
    helper = LayerHelper("fc", param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    dtype = inputs[0].dtype
    p_attrs = helper.param_attr
    if not isinstance(p_attrs, list):
        p_attrs = [p_attrs] * len(inputs)
    mul_results = []
    for inp, p_attr in zip(inputs, p_attrs):
        in_features = _prod(inp.shape[num_flatten_dims:])
        w = helper.create_parameter(attr=p_attr, shape=[in_features, size],
                                    dtype=dtype)
        out_shape = tuple(inp.shape[:num_flatten_dims]) + (size,)
        tmp = helper.create_variable_for_type_inference(dtype, out_shape)
        helper.append_op("mul", {"X": inp, "Y": w}, {"Out": tmp},
                         {"x_num_col_dims": num_flatten_dims,
                          "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(
            dtype, mul_results[0].shape)
        helper.append_op("sum", {"X": mul_results}, {"Out": pre_bias})
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


def one_hot(input, depth, allow_out_of_range=False):
    """Parity: fluid.layers.one_hot: f32 (..., depth); a trailing 1 in
    the ids' shape is squeezed away."""
    helper = LayerHelper("one_hot")
    shape = tuple(input.shape)
    if shape and shape[-1] == 1:
        shape = shape[:-1]
    out = helper.create_variable_for_type_inference("float32",
                                                    shape + (depth,))
    helper.append_op("one_hot", {"X": input}, {"Out": out}, {"depth": depth})
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    """Parity: fluid.layers.label_smooth: (1 - epsilon) label + epsilon /
    depth, or + epsilon prior_dist."""
    helper = LayerHelper("label_smooth", name=name)
    inputs = {"X": label}
    if prior_dist is not None:
        inputs["PriorDist"] = prior_dist
    out = helper.create_variable_for_type_inference(dtype, label.shape)
    helper.append_op("label_smooth", inputs, {"Out": out},
                     {"epsilon": epsilon})
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


def _conv_out_size(in_size, k, pad, stride, dilation=1):
    if in_size is None or in_size < 0:
        return -1
    return (in_size + 2 * pad - (dilation * (k - 1) + 1)) // stride + 1


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format="NCHW"):
    """Parity: fluid.layers.conv2d. The filter draws from N(0, 2 / fan_in)
    (MSRA); groups == channels (with num_filters a multiple) appends
    depthwise_conv2d; the bias is an elementwise_add on axis 1.
    use_cudnn is accepted: the op is torch's convolution either way."""
    helper = LayerHelper("conv2d", param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    groups = groups or 1
    fsize = _pair(filter_size)
    stride = _pair(stride)
    padding = _pair(padding)
    dilation = _pair(dilation)
    num_channels = input.shape[1]
    filter_shape = [num_filters, num_channels // groups] + fsize
    fan_in = (num_channels // groups) * fsize[0] * fsize[1]
    w = helper.create_parameter(
        attr=helper.param_attr, shape=filter_shape, dtype=input.dtype,
        default_initializer=init_mod.NormalInitializer(
            0.0, (2.0 / fan_in) ** 0.5))
    h = _conv_out_size(input.shape[2], fsize[0], padding[0], stride[0],
                       dilation[0])
    wd = _conv_out_size(input.shape[3], fsize[1], padding[1], stride[1],
                        dilation[1])
    out_shape = (input.shape[0], num_filters, h, wd)
    pre_bias = helper.create_variable_for_type_inference(input.dtype,
                                                         out_shape)
    op_type = "depthwise_conv2d" if (
        groups == num_channels and num_filters % num_channels == 0) \
        else "conv2d"
    helper.append_op(op_type, {"Input": input, "Filter": w},
                     {"Output": pre_bias},
                     {"strides": stride, "paddings": padding,
                      "dilations": dilation, "groups": groups})
    if helper.bias_attr is not False:
        b = helper.create_parameter(attr=helper.bias_attr,
                                    shape=[num_filters], dtype=input.dtype,
                                    is_bias=True)
        pre_act = helper.create_variable_for_type_inference(input.dtype,
                                                            out_shape)
        helper.append_op("elementwise_add", {"X": pre_bias, "Y": b},
                         {"Out": pre_act}, {"axis": 1})
    else:
        pre_act = pre_bias
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, exclusive=True, name=None):
    """Parity: fluid.layers.pool2d (ceil_mode accepted and unused, as in
    the JAX package)."""
    helper = LayerHelper("pool2d", name=name)
    ksize = _pair(pool_size)
    stride = _pair(pool_stride)
    padding = _pair(pool_padding)
    if global_pooling:
        out_shape = tuple(input.shape[:2]) + (1, 1)
    else:
        oh = _conv_out_size(input.shape[2], ksize[0], padding[0], stride[0])
        ow = _conv_out_size(input.shape[3], ksize[1], padding[1], stride[1])
        out_shape = tuple(input.shape[:2]) + (oh, ow)
    out = helper.create_variable_for_type_inference(input.dtype, out_shape)
    helper.append_op("pool2d", {"X": input}, {"Out": out},
                     {"pooling_type": pool_type, "ksize": ksize,
                      "strides": stride, "paddings": padding,
                      "global_pooling": global_pooling,
                      "exclusive": exclusive})
    return out


def adaptive_pool2d(input, pool_size, pool_type="max", require_index=False,
                    name=None):
    """Parity: fluid.layers.adaptive_pool2d: floor/ceil windows;
    require_index also returns the argmax Mask (a flat index into the
    input plane) and is invalid for avg pooling."""
    return _adaptive_pool("adaptive_pool2d", input, _pair(pool_size),
                          pool_type, require_index, name)


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None,
               do_model_average_for_mean_and_var=False,
               use_global_stats=False):
    """Parity: fluid.layers.batch_norm. The running mean and variance are
    persistable variables (initialized to 0 and 1, stop_gradient) that
    the op's MeanOut / VarianceOut overwrite each training step."""
    helper = LayerHelper("batch_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    dtype = "float32"
    scale = helper.create_parameter(
        attr=helper.param_attr, shape=[c], dtype=dtype,
        default_initializer=init_mod.ConstantInitializer(1.0))
    bias = helper.create_parameter(attr=helper.bias_attr, shape=[c],
                                   dtype=dtype, is_bias=True)
    from ..core import unique_name as un
    mean_name = moving_mean_name or un.generate(helper.name + ".mean")
    var_name = moving_variance_name or un.generate(helper.name + ".variance")
    mean = helper.create_or_get_global_variable(
        mean_name, shape=(c,), dtype=dtype, persistable=True)
    variance = helper.create_or_get_global_variable(
        var_name, shape=(c,), dtype=dtype, persistable=True)
    mean.stop_gradient = True
    variance.stop_gradient = True
    init_mod.ConstantInitializer(0.0)(mean)
    init_mod.ConstantInitializer(1.0)(variance)
    saved_mean = helper.create_variable_for_type_inference(dtype)
    saved_var = helper.create_variable_for_type_inference(dtype)
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    input.shape)
    helper.append_op(
        "batch_norm",
        {"X": input, "Scale": scale, "Bias": bias, "Mean": mean,
         "Variance": variance},
        {"Y": out, "MeanOut": mean, "VarianceOut": variance,
         "SavedMean": saved_mean, "SavedVariance": saved_var},
        {"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
         "data_layout": data_layout, "use_global_stats": use_global_stats})
    return helper.append_activation(out)


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


def _make_reduce(op_type):
    def fn(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(
            input.dtype, _reduce_shape(input.shape, dim, keep_dim))
        attrs = {"keep_dim": keep_dim}
        if dim is None:
            attrs["reduce_all"] = True
            attrs["dim"] = [0]
        else:
            attrs["dim"] = dim if isinstance(dim, (list, tuple)) else [dim]
        helper.append_op(op_type, {"X": input}, {"Out": out}, attrs)
        return out
    fn.__name__ = op_type
    return fn


reduce_sum = _make_reduce("reduce_sum")
reduce_mean = _make_reduce("reduce_mean")
reduce_max = _make_reduce("reduce_max")
reduce_min = _make_reduce("reduce_min")
reduce_prod = _make_reduce("reduce_prod")
reduce_all = _make_reduce("reduce_all")
reduce_any = _make_reduce("reduce_any")


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
elementwise_sub = _make_elementwise("elementwise_sub")
elementwise_mul = _make_elementwise("elementwise_mul")
elementwise_div = _make_elementwise("elementwise_div")
elementwise_max = _make_elementwise("elementwise_max")
elementwise_min = _make_elementwise("elementwise_min")
elementwise_pow = _make_elementwise("elementwise_pow")
elementwise_mod = _make_elementwise("elementwise_mod")
elementwise_floordiv = _make_elementwise("elementwise_floordiv")


def _make_logical(op_type, binary=True):
    if binary:
        def fn(x, y, out=None, name=None):
            helper = LayerHelper(op_type, name=name)
            out = out or helper.create_variable_for_type_inference(
                "bool", x.shape)
            helper.append_op(op_type, {"X": x, "Y": y}, {"Out": out})
            return out
    else:
        def fn(x, out=None, name=None):
            helper = LayerHelper(op_type, name=name)
            out = out or helper.create_variable_for_type_inference(
                "bool", x.shape)
            helper.append_op(op_type, {"X": x}, {"Out": out})
            return out
    fn.__name__ = op_type
    return fn


logical_and = _make_logical("logical_and")
logical_or = _make_logical("logical_or")
logical_xor = _make_logical("logical_xor")
logical_not = _make_logical("logical_not", binary=False)


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    """Parity: fluid.layers.smooth_l1: (N, 1) row sums of the smooth-L1
    of (x - y) x inside_weight, times outside_weight."""
    helper = LayerHelper("smooth_l1")
    inputs = {"X": x, "Y": y}
    if inside_weight is not None:
        inputs["InsideWeight"] = inside_weight
    if outside_weight is not None:
        inputs["OutsideWeight"] = outside_weight
    out = helper.create_variable_for_type_inference(x.dtype, (x.shape[0], 1))
    diff = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op("smooth_l1_loss", inputs, {"Out": out, "Diff": diff},
                     {"sigma": sigma or 1.0})
    return out


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """Parity: fluid.layers.py_func: `func` called on numpy copies of `x`
    when the op runs, its result written into `out` (whose shape and
    dtype it must have). The callable is kept in Operator.CALLABLE_TABLE
    under the table's length, as in the JAX package; no gradient flows
    through it."""
    from ..core.framework import Operator
    helper = LayerHelper("py_func")
    func_id = len(Operator.CALLABLE_TABLE)
    Operator.CALLABLE_TABLE[func_id] = func
    xs = x if isinstance(x, (list, tuple)) else [x]
    helper.append_op("py_func", {"X": xs}, {"Out": out},
                     {"func_id": func_id})
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


def squeeze(input, axes, name=None):
    helper = LayerHelper("squeeze", name=name)
    dims = [a % len(input.shape) for a in axes]
    shape = tuple(s for i, s in enumerate(input.shape)
                  if not (i in dims and s == 1))
    out = helper.create_variable_for_type_inference(input.dtype, shape)
    xshape = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("squeeze2", {"X": input}, {"Out": out, "XShape": xshape},
                     {"axes": list(axes)})
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze", name=name)
    shape = list(input.shape)
    for a in sorted(axes):
        shape.insert(a, 1)
    out = helper.create_variable_for_type_inference(input.dtype, tuple(shape))
    xshape = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("unsqueeze2", {"X": input},
                     {"Out": out, "XShape": xshape}, {"axes": list(axes)})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    xs = input if isinstance(input, (list, tuple)) else [input]
    shape = list(xs[0].shape)
    if shape:
        a = axis % len(shape)
        shape[a] = builtins.sum(x.shape[a] for x in xs)
    out = helper.create_variable_for_type_inference(xs[0].dtype, tuple(shape))
    helper.append_op("concat", {"X": xs}, {"Out": out}, {"axis": axis})
    return out


def expand(x, expand_times, name=None):
    """Parity: fluid.layers.expand: np.tile by expand_times."""
    helper = LayerHelper("expand", name=name)
    shape = tuple(s * t if s >= 0 else -1
                  for s, t in zip(x.shape, expand_times))
    out = helper.create_variable_for_type_inference(x.dtype, shape)
    helper.append_op("expand", {"X": x}, {"Out": out},
                     {"expand_times": list(expand_times)})
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


def relu(x, name=None):
    helper = LayerHelper("relu", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op("relu", {"X": x}, {"Out": out})
    return out


# ---- the sequence, CRF and CTC family ---------------------------------------

def row_conv(input, future_context_size, param_attr=None, act=None):
    """Parity: fluid.layers.row_conv (the lookahead convolution of
    DeepSpeech2): Filter (future_context_size + 1, D)."""
    helper = LayerHelper("row_conv", param_attr=param_attr, act=act)
    d = input.shape[-1]
    w = helper.create_parameter(helper.param_attr,
                                shape=[future_context_size + 1, d],
                                dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op("row_conv", {"X": input, "Filter": w}, {"Out": out}, {})
    return helper.append_activation(out)


def im2sequence(input, filter_size=1, stride=1, padding=0,
                input_image_size=None, out_stride=1, name=None):
    """Parity: fluid.layers.im2sequence: the image's windows as rows
    (N * oh * ow, C * kh * kw); the uniform per-image step count is the
    op's Length output (int64)."""
    helper = LayerHelper("im2sequence", name=name)
    ins = {"X": input}
    if input_image_size is not None:
        ins["Y"] = input_image_size        # the op raises: dynamic windows
    out = helper.create_variable_for_type_inference(input.dtype)
    length = helper.create_variable_for_type_inference("int64")
    helper.append_op("im2sequence", ins, {"Out": out, "Length": length},
                     {"kernels": _pair(filter_size),
                      "strides": _pair(stride),
                      "paddings": _pair(padding, 4),
                      "out_stride": _pair(out_stride)})
    return out


def linear_chain_crf(input, label, param_attr=None, length=None):
    """Parity: fluid.layers.linear_chain_crf. Padded form: input (B, T,
    num_tags), label (B, T[, 1]), length (B,). Returns each sequence's
    negative log-likelihood (B, 1). The transition parameter is
    [num_tags + 2, num_tags]: rows 0 and 1 are the start and end
    scores."""
    helper = LayerHelper("linear_chain_crf", param_attr=param_attr)
    num_tags = input.shape[-1]
    transition = helper.create_parameter(
        attr=helper.param_attr, shape=[num_tags + 2, num_tags],
        dtype="float32")
    b = input.shape[0]
    ll = helper.create_variable_for_type_inference("float32", (b, 1))
    alpha = helper.create_variable_for_type_inference("float32", input.shape)
    em_exps = helper.create_variable_for_type_inference("float32",
                                                        input.shape)
    tr_exps = helper.create_variable_for_type_inference(
        "float32", (num_tags + 2, num_tags))
    inputs = {"Emission": input, "Transition": transition, "Label": label}
    if length is not None:
        inputs["Length"] = length
    helper.append_op("linear_chain_crf", inputs,
                     {"LogLikelihood": ll, "Alpha": alpha,
                      "EmissionExps": em_exps, "TransitionExps": tr_exps},
                     {})
    return ll


def crf_decoding(input, param_attr, label=None, length=None):
    """Parity: fluid.layers.crf_decoding: the Viterbi path (B, T) int64
    (or the per-position mismatch flags where label is given). Pass the
    param_attr name linear_chain_crf was given, so that decoding reads
    the trained transition."""
    helper = LayerHelper("crf_decoding", param_attr=param_attr)
    num_tags = input.shape[-1]
    transition = helper.create_parameter(
        attr=helper.param_attr, shape=[num_tags + 2, num_tags],
        dtype="float32")
    out = helper.create_variable_for_type_inference(
        "int64", tuple(input.shape[:2]))
    inputs = {"Emission": input, "Transition": transition}
    if label is not None:
        inputs["Label"] = label
    if length is not None:
        inputs["Length"] = length
    helper.append_op("crf_decoding", inputs, {"ViterbiPath": out}, {})
    return out


def warpctc(input, label, blank=0, norm_by_times=False,
            input_length=None, label_length=None):
    """Parity: fluid.layers.warpctc. Padded form: input (B, T, C) raw
    logits, label (B, L) padded, the lengths in place of the LoD.
    Returns each sequence's CTC loss (B, 1)."""
    helper = LayerHelper("warpctc")
    b = input.shape[0]
    loss = helper.create_variable_for_type_inference("float32", (b, 1))
    inputs = {"Logits": input, "Label": label}
    if input_length is not None:
        inputs["LogitsLength"] = input_length
    if label_length is not None:
        inputs["LabelLength"] = label_length
    helper.append_op("warpctc", inputs, {"Loss": loss},
                     {"blank": blank, "norm_by_times": norm_by_times})
    return loss


def ctc_greedy_decoder(input, blank, input_length=None, name=None):
    """Parity: fluid.layers.ctc_greedy_decoder: argmax, merge repeats,
    drop blanks. Returns (decoded (B, T) int64 padded with -1, lengths
    (B, 1) int64), the padded form of the LoD output."""
    helper = LayerHelper("ctc_greedy_decoder", name=name)
    b, t = input.shape[0], input.shape[1]
    out = helper.create_variable_for_type_inference("int64", (b, t))
    out_len = helper.create_variable_for_type_inference("int64", (b, 1))
    inputs = {"Input": input}
    if input_length is not None:
        inputs["InputLength"] = input_length
    helper.append_op("ctc_greedy_decoder", inputs,
                     {"Output": out, "OutputLength": out_len},
                     {"blank": blank})
    return out, out_len


# -- the vision layers and the activation family ------------------------------


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None):
    helper = LayerHelper("conv3d", param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    groups = groups or 1
    fsize = _pair(filter_size, 3)
    stride = _pair(stride, 3)
    padding = _pair(padding, 3)
    dilation = _pair(dilation, 3)
    num_channels = input.shape[1]
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=[num_filters, num_channels // groups] + fsize, dtype=input.dtype,
        default_initializer=init_mod.NormalInitializer(
            0.0, (2.0 / ((num_channels // groups) * _prod(fsize))) ** 0.5))
    dims = [_conv_out_size(input.shape[2 + i], fsize[i], padding[i], stride[i],
                           dilation[i]) for i in range(3)]
    out_shape = (input.shape[0], num_filters) + tuple(dims)
    pre_bias = helper.create_variable_for_type_inference(input.dtype,
                                                         out_shape)
    helper.append_op("conv3d", {"Input": input, "Filter": w},
                     {"Output": pre_bias},
                     {"strides": stride, "paddings": padding,
                      "dilations": dilation, "groups": groups})
    if helper.bias_attr is not False:
        b = helper.create_parameter(attr=helper.bias_attr, shape=[num_filters],
                                    dtype=input.dtype, is_bias=True)
        pre_act = helper.create_variable_for_type_inference(input.dtype,
                                                            out_shape)
        helper.append_op("elementwise_add", {"X": pre_bias, "Y": b},
                         {"Out": pre_act}, {"axis": 1})
    else:
        pre_act = pre_bias
    return helper.append_activation(pre_act)


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    helper = LayerHelper("conv2d_transpose", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    groups = groups or 1
    stride = _pair(stride)
    padding = _pair(padding)
    dilation = _pair(dilation)
    num_channels = input.shape[1]
    if filter_size is None:
        if output_size is None:
            raise ValueError("output_size or filter_size required")
        output_size = _pair(output_size)
        filter_size = [output_size[i] - (input.shape[2 + i] - 1) * stride[i] +
                       2 * padding[i] for i in range(2)]
    fsize = _pair(filter_size)
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=[num_channels, num_filters // groups] + fsize, dtype=input.dtype,
        default_initializer=init_mod.XavierInitializer())
    oh = (input.shape[2] - 1) * stride[0] - 2 * padding[0] \
        + dilation[0] * (fsize[0] - 1) + 1
    ow = (input.shape[3] - 1) * stride[1] - 2 * padding[1] \
        + dilation[1] * (fsize[1] - 1) + 1
    out_shape = (input.shape[0], num_filters, oh, ow)
    pre_bias = helper.create_variable_for_type_inference(input.dtype,
                                                         out_shape)
    helper.append_op("conv2d_transpose", {"Input": input, "Filter": w},
                     {"Output": pre_bias},
                     {"strides": stride, "paddings": padding,
                      "dilations": dilation, "groups": groups})
    if helper.bias_attr is not False:
        b = helper.create_parameter(attr=helper.bias_attr, shape=[num_filters],
                                    dtype=input.dtype, is_bias=True)
        pre_act = helper.create_variable_for_type_inference(input.dtype,
                                                            out_shape)
        helper.append_op("elementwise_add", {"X": pre_bias, "Y": b},
                         {"Out": pre_act}, {"axis": 1})
    else:
        pre_act = pre_bias
    return helper.append_activation(pre_act)


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, exclusive=True, name=None):
    helper = LayerHelper("pool3d", name=name)
    ksize = _pair(pool_size, 3)
    stride = _pair(pool_stride, 3)
    padding = _pair(pool_padding, 3)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("pool3d", {"X": input}, {"Out": out},
                     {"pooling_type": pool_type, "ksize": ksize,
                      "strides": stride, "paddings": padding,
                      "global_pooling": global_pooling,
                      "exclusive": exclusive})
    return out


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, data_layout="NCHW", name=None):
    helper = LayerHelper("group_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    c = input.shape[1]
    inputs = {"X": input}
    if helper.param_attr is not False:
        inputs["Scale"] = helper.create_parameter(
            attr=helper.param_attr, shape=[c], dtype="float32",
            default_initializer=init_mod.ConstantInitializer(1.0))
    if helper.bias_attr is not False:
        inputs["Bias"] = helper.create_parameter(
            attr=helper.bias_attr, shape=[c], dtype="float32", is_bias=True)
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    mean = helper.create_variable_for_type_inference("float32")
    var = helper.create_variable_for_type_inference("float32")
    helper.append_op("group_norm", inputs,
                     {"Y": out, "Mean": mean, "Variance": var},
                     {"groups": groups, "epsilon": epsilon})
    return helper.append_activation(out)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None):
    helper = LayerHelper("instance_norm", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    c = input.shape[1]
    inputs = {"X": input}
    if helper.param_attr is not False:
        inputs["Scale"] = helper.create_parameter(
            attr=helper.param_attr, shape=[c], dtype="float32",
            default_initializer=init_mod.ConstantInitializer(1.0))
    if helper.bias_attr is not False:
        inputs["Bias"] = helper.create_parameter(
            attr=helper.bias_attr, shape=[c], dtype="float32", is_bias=True)
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op("instance_norm", inputs, {"Y": out}, {"epsilon": epsilon})
    return out


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    helper = LayerHelper("spectral_norm", name=name)
    h = weight.shape[dim]
    w = _prod(weight.shape) // h
    u = helper.create_parameter(attr=None, shape=[h], dtype="float32",
                                default_initializer=init_mod
                                .NormalInitializer(0, 1))
    v = helper.create_parameter(attr=None, shape=[w], dtype="float32",
                                default_initializer=init_mod
                                .NormalInitializer(0, 1))
    u.trainable = False
    v.trainable = False
    out = helper.create_variable_for_type_inference(weight.dtype, weight.shape)
    # U/V update in place each step (the reference kernel mutates its
    # U/V inputs), so the power iteration converges across steps
    helper.append_op("spectral_norm", {"Weight": weight, "U": u, "V": v},
                     {"Out": out, "UOut": u, "VOut": v},
                     {"dim": dim, "power_iters": power_iters, "eps": eps})
    return out


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    norm = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("l2_normalize", {"X": x}, {"Out": out, "Norm": norm},
                     {"axis": axis, "epsilon": epsilon})
    return out


def cumsum(x, axis=None, exclusive=None, reverse=None, name=None):
    helper = LayerHelper("cumsum", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    attrs = {"exclusive": exclusive, "reverse": reverse}
    if axis is None:
        attrs["flatten"] = True
        attrs["axis"] = 0
    else:
        attrs["axis"] = axis
    helper.append_op("cumsum", {"X": x}, {"Out": out}, attrs)
    return out


def leaky_relu(x, alpha=0.02, name=None):
    helper = LayerHelper("leaky_relu", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op("leaky_relu", {"X": x}, {"Out": out}, {"alpha": alpha})
    return out


def prelu(x, mode, param_attr=None, name=None):
    helper = LayerHelper("prelu", param_attr=param_attr, name=name)
    if mode == "all":
        alpha_shape = [1]
    elif mode == "channel":
        alpha_shape = [x.shape[1]]
    else:
        alpha_shape = list(x.shape[1:])
    alpha = helper.create_parameter(
        attr=helper.param_attr, shape=alpha_shape, dtype="float32",
        default_initializer=init_mod.ConstantInitializer(0.25))
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op("prelu", {"X": x, "Alpha": alpha}, {"Out": out},
                     {"mode": mode})
    return out


def maxout(x, groups, name=None):
    helper = LayerHelper("maxout", name=name)
    shape = (x.shape[0], x.shape[1] // groups) + tuple(x.shape[2:])
    out = helper.create_variable_for_type_inference(x.dtype, shape)
    helper.append_op("maxout", {"X": x}, {"Out": out}, {"groups": groups})
    return out


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    helper = LayerHelper("lrn", name=name)
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    mid = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op("lrn", {"X": input}, {"Out": out, "MidOut": mid},
                     {"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out


def resize_bilinear(input, out_shape=None, scale=None, name=None,
                    align_corners=True, align_mode=1):
    return _resize(input, out_shape, scale, "bilinear_interp", name,
                   align_corners=align_corners, align_mode=align_mode)


def resize_nearest(input, out_shape=None, scale=None, name=None,
                   align_corners=True):
    return _resize(input, out_shape, scale, "nearest_interp", name,
                   align_corners=align_corners)


def _resize(input, out_shape, scale, op_type, name, align_corners=True,
            align_mode=1):
    helper = LayerHelper(op_type, name=name)
    # the reference DEFAULTS to align_corners=True (nn.py:7861)
    attrs = {"align_corners": align_corners, "align_mode": align_mode}
    if out_shape is not None:
        attrs["out_h"], attrs["out_w"] = int(out_shape[0]), int(out_shape[1])
        shape = tuple(input.shape[:2]) + (attrs["out_h"], attrs["out_w"])
    else:
        attrs["scale"] = float(scale)
        shape = tuple(input.shape[:2]) + tuple(
            int(s * scale) if s and s > 0 else -1 for s in input.shape[2:])
    out = helper.create_variable_for_type_inference(input.dtype, shape)
    helper.append_op(op_type, {"X": input}, {"Out": out}, attrs)
    return out


def image_resize(input, out_shape=None, scale=None, name=None,
                 resample="BILINEAR", actual_shape=None,
                 align_corners=True, align_mode=1):
    """Parity: fluid.layers.image_resize (ref nn.py:7852): dispatch on
    resample; actual_shape (a runtime shape tensor) is unsupported, as in
    the JAX package: pass out_shape."""
    if actual_shape is not None:
        raise NotImplementedError(
            "image_resize(actual_shape=...) needs runtime output shapes; "
            "pass a static out_shape")
    resample = resample.upper()
    if resample == "BILINEAR":
        return resize_bilinear(input, out_shape, scale, name,
                               align_corners, align_mode)
    if resample == "NEAREST":
        return resize_nearest(input, out_shape, scale, name, align_corners)
    if resample == "TRILINEAR":
        return resize_trilinear(input, out_shape, scale, name,
                                align_corners, align_mode)
    raise ValueError(
        "The 'resample' of image_resize can only be 'BILINEAR', "
        "'TRILINEAR' or 'NEAREST' currently.")


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    """Parity: fluid.layers.conv3d_transpose (conv_transpose_op.cc 3-D)."""
    helper = LayerHelper("conv3d_transpose", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    stride = _pair(stride, 3)
    padding = _pair(padding, 3)
    dilation = _pair(dilation, 3)
    num_channels = input.shape[1]
    fsize = _pair(filter_size, 3)
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=[num_channels, num_filters // (groups or 1)] + list(fsize),
        dtype=input.dtype,
        default_initializer=init_mod.XavierInitializer())
    spatial = [(input.shape[2 + i] - 1) * stride[i] - 2 * padding[i] +
               dilation[i] * (fsize[i] - 1) + 1 for i in range(3)]
    out_shape = (input.shape[0], num_filters) + tuple(spatial)
    pre_bias = helper.create_variable_for_type_inference(input.dtype,
                                                         out_shape)
    helper.append_op("conv3d_transpose", {"Input": input, "Filter": w},
                     {"Output": pre_bias},
                     {"strides": stride, "paddings": padding,
                      "dilations": dilation, "groups": groups or 1})
    if helper.bias_attr is not False:
        b = helper.create_parameter(attr=helper.bias_attr,
                                    shape=[num_filters],
                                    dtype=input.dtype, is_bias=True)
        pre_act = helper.create_variable_for_type_inference(input.dtype,
                                                            out_shape)
        helper.append_op("elementwise_add", {"X": pre_bias, "Y": b},
                         {"Out": pre_act}, {"axis": 1})
    else:
        pre_act = pre_bias
    return helper.append_activation(pre_act)


def data_norm(input, act=None, epsilon=1e-5, param_attr=None,
              data_layout="NCHW", in_place=False, name=None,
              moving_mean_name=None, moving_variance_name=None,
              do_model_average_for_mean_and_var=False, slot_dim=-1,
              summary_decay_rate=0.9999999):
    """Parity: fluid.layers.data_norm (data_norm_op: CTR normalization by
    accumulated batch statistics, no learned scale)."""
    helper = LayerHelper("data_norm", name=name)
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    from ..core import unique_name as un
    size_name = un.generate(helper.name + ".batch_size")
    sum_name = un.generate(helper.name + ".batch_sum")
    sqs_name = un.generate(helper.name + ".batch_square_sum")
    bsize = helper.create_or_get_global_variable(size_name, shape=(c,),
                                                 dtype="float32",
                                                 persistable=True)
    bsum = helper.create_or_get_global_variable(sum_name, shape=(c,),
                                                dtype="float32",
                                                persistable=True)
    bsqs = helper.create_or_get_global_variable(sqs_name, shape=(c,),
                                                dtype="float32",
                                                persistable=True)
    init_mod.ConstantInitializer(1e4)(bsize)
    init_mod.ConstantInitializer(0.0)(bsum)
    init_mod.ConstantInitializer(1e4)(bsqs)
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op(
        "data_norm",
        {"X": input, "BatchSize": bsize, "BatchSum": bsum,
         "BatchSquareSum": bsqs},
        {"Y": out, "BatchSizeOut": bsize, "BatchSumOut": bsum,
         "BatchSquareSumOut": bsqs},
        {"epsilon": epsilon, "summary_decay_rate": summary_decay_rate})
    return helper.append_activation(out) if act else out


def _simple_layer(op_type, ins, attrs, helper_name=None, out_slot="Out",
                  dtype=None, shape=None):
    helper = LayerHelper(helper_name or op_type)
    ref = next(iter(ins.values()))
    ref = ref[0] if isinstance(ref, (list, tuple)) else ref
    out = helper.create_variable_for_type_inference(
        dtype or ref.dtype, shape or getattr(ref, "shape", None))
    helper.append_op(op_type, ins, {out_slot: out}, attrs)
    return out


def moe(input, d_ff, num_experts, capacity_factor=1.25, param_attr=None,
        name=None):
    """Mixture-of-Experts FFN layer (expert parallelism over the mesh's
    'ep' axis), as the JAX package's ``layers.moe``: top-1 (Switch)
    gated expert FFN over the last dim of `input`. Three parameters, the
    ParamAttr's name suffixed ``_gate_w`` / ``_w_up`` / ``_w_down``; the
    expert weights carry ``dist_attr ("ep", None, None)``, so a
    ``CompiledProgram`` over an ep mesh lays them out E / ep a position
    and the op dispatches its tokens over ep (``parallel/moe.py``).
    Returns (out, aux_loss): add `aux_loss` (the load-balance term) into
    the training loss."""
    import copy as _copy

    from ..core.param_attr import ParamAttr as _PA

    def _sub_attr(suffix):
        # one ParamAttr names three parameters: suffix the name
        a = _PA._to_attr(param_attr)
        if a is None or a is False:
            return a
        a = _copy.copy(a)
        if a.name:
            a.name = a.name + suffix
        return a

    helper = LayerHelper("moe", name=name)
    d = int(input.shape[-1])
    gate_w = helper.create_parameter(
        attr=_sub_attr("_gate_w"), shape=[d, num_experts],
        dtype=input.dtype,
        default_initializer=init_mod.NormalInitializer(0.0, 0.02))
    w_up = helper.create_parameter(
        attr=_sub_attr("_w_up"), shape=[num_experts, d, d_ff],
        dtype=input.dtype,
        default_initializer=init_mod.NormalInitializer(
            0.0, (2.0 / d) ** 0.5))
    w_down = helper.create_parameter(
        attr=_sub_attr("_w_down"), shape=[num_experts, d_ff, d],
        dtype=input.dtype,
        default_initializer=init_mod.NormalInitializer(
            0.0, (2.0 / d_ff) ** 0.5))
    w_up.dist_attr = ("ep", None, None)
    w_down.dist_attr = ("ep", None, None)
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    input.shape)
    aux = helper.create_variable_for_type_inference(input.dtype, (1,))
    helper.append_op("moe", {"X": input, "GateW": gate_w, "WUp": w_up,
                             "WDown": w_down},
                     {"Out": out, "AuxLoss": aux},
                     {"capacity_factor": capacity_factor})
    return out, aux


def grid_sampler(x, grid, name=None):
    """Parity: fluid.layers.grid_sampler (bilinear spatial sampling)."""
    return _simple_layer("grid_sampler", {"X": x, "Grid": grid}, {},
                         out_slot="Output")


def affine_grid(theta, out_shape, name=None):
    """Parity: fluid.layers.affine_grid."""
    helper = LayerHelper("affine_grid")
    if isinstance(out_shape, (list, tuple)):
        attrs = {"output_shape": [int(s) for s in out_shape]}
        ins = {"Theta": theta}
        shape = (out_shape[0], out_shape[2], out_shape[3], 2)
    else:
        attrs = {}
        ins = {"Theta": theta, "OutputShape": out_shape}
        shape = None
    out = helper.create_variable_for_type_inference(theta.dtype, shape)
    helper.append_op("affine_grid", ins, {"Output": out}, attrs)
    return out


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None):
    """Parity: fluid.layers.temporal_shift (TSM video models)."""
    return _simple_layer("temporal_shift", {"X": x},
                         {"seg_num": seg_num, "shift_ratio": shift_ratio})


def affine_channel(x, scale=None, bias=None, data_layout="NCHW", name=None,
                   act=None):
    helper = LayerHelper("affine_channel", act=act)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op("affine_channel",
                     {"X": x, "Scale": scale, "Bias": bias},
                     {"Out": out}, {"data_layout": data_layout})
    return helper.append_activation(out)


def similarity_focus(input, axis, indexes, name=None):
    return _simple_layer("similarity_focus", {"X": input},
                         {"axis": axis, "indexes": list(indexes)})


def fsp_matrix(x, y):
    """Parity: fluid.layers.fsp_matrix (distillation FSP Gram matrix)."""
    helper = LayerHelper("fsp")
    out = helper.create_variable_for_type_inference(
        x.dtype, (x.shape[0], x.shape[1], y.shape[1]))
    helper.append_op("fsp", {"X": x, "Y": y}, {"Out": out}, {})
    return out


def deformable_conv(input, offset, mask, num_filters, filter_size, stride=1,
                    padding=0, dilation=1, groups=None, deformable_groups=None,
                    im2col_step=None, param_attr=None, bias_attr=None,
                    modulated=True, name=None):
    """Parity: fluid.layers.deformable_conv (v1/v2)."""
    helper = LayerHelper("deformable_conv", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    c = input.shape[1]
    fsize = _pair(filter_size)
    w = helper.create_parameter(
        helper.param_attr, shape=[num_filters, c] + list(fsize),
        dtype=input.dtype, default_initializer=init_mod.XavierInitializer())
    ins = {"Input": input, "Offset": offset, "Filter": w}
    if modulated and mask is not None:
        ins["Mask"] = mask
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("deformable_conv", ins, {"Output": out},
                     {"strides": _pair(stride), "paddings": _pair(padding),
                      "dilations": _pair(dilation),
                      "deformable_groups": deformable_groups})
    if helper.bias_attr is not False:
        b = helper.create_parameter(helper.bias_attr, shape=[num_filters],
                                    dtype=input.dtype, is_bias=True)
        out2 = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op("elementwise_add", {"X": out, "Y": b},
                         {"Out": out2}, {"axis": 1})
        return out2
    return out


def adaptive_pool3d(input, pool_size, pool_type="max", require_index=False,
                    name=None):
    """Parity: fluid.layers.adaptive_pool3d (NCDHW); require_index as in
    adaptive_pool2d (invalid with avg, returns (out, mask))."""
    ps = list(pool_size) if isinstance(pool_size, (list, tuple)) \
        else [pool_size] * 3
    return _adaptive_pool("adaptive_pool3d", input, ps, pool_type,
                          require_index, name)


def resize_trilinear(input, out_shape=None, scale=None, name=None,
                     align_corners=True, align_mode=1):
    """Parity: fluid.layers.resize_trilinear (NCDHW)."""
    helper = LayerHelper("trilinear_interp", name=name)
    if out_shape is not None:
        od, oh, ow = (int(s) for s in out_shape)
    else:
        od, oh, ow = (int(s * scale) for s in input.shape[2:])
    out = helper.create_variable_for_type_inference(
        input.dtype, tuple(input.shape[:2]) + (od, oh, ow))
    helper.append_op("trilinear_interp", {"X": input}, {"Out": out},
                     {"out_d": od, "out_h": oh, "out_w": ow,
                      "align_corners": align_corners,
                      "align_mode": align_mode})
    return out


def image_resize_short(input, out_short_len, resample="BILINEAR"):
    """Parity: fluid.layers.image_resize_short: resize so the SHORT side
    equals out_short_len, keeping aspect ratio."""
    h, w = input.shape[2], input.shape[3]
    short = min(h, w)
    oh = int(round(h * out_short_len / float(short)))
    ow = int(round(w * out_short_len / float(short)))
    if resample.upper() == "NEAREST":
        return resize_nearest(input, out_shape=[oh, ow])
    return resize_bilinear(input, out_shape=[oh, ow])


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """Parity: fluid.layers.unfold (im2col): (N,C,H,W) -> (N, C*kh*kw, L).
    paddings may be 1, 2, or 4 ints ([top, left, bottom, right])."""
    helper = LayerHelper("unfold", name=name)
    ks = _pair(kernel_sizes)
    st = _pair(strides)
    pd = list(paddings) if isinstance(paddings, (list, tuple)) \
        else [paddings, paddings]
    if len(pd) == 2:
        pd = [pd[0], pd[1], pd[0], pd[1]]
    dl = _pair(dilations)
    n, c, h, w = x.shape
    oh = (h + pd[0] + pd[2] - dl[0] * (ks[0] - 1) - 1) // st[0] + 1
    ow = (w + pd[1] + pd[3] - dl[1] * (ks[1] - 1) - 1) // st[1] + 1
    out = helper.create_variable_for_type_inference(
        x.dtype, (n, c * ks[0] * ks[1], oh * ow))
    helper.append_op("unfold", {"X": x}, {"Y": out},
                     {"kernel_sizes": ks, "strides": st, "paddings": pd,
                      "dilations": dl})
    return out


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    """Parity: fluid.layers.bilinear_tensor_product:
    out[:, i] = x . W_i . y^T + b (one einsum)."""
    helper = LayerHelper("bilinear_tensor_product", name=name,
                         param_attr=param_attr, bias_attr=bias_attr, act=act)
    dx, dy = x.shape[-1], y.shape[-1]
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[size, dx, dy], dtype=x.dtype)
    inputs = {"X": x, "Y": y, "Weight": w}
    b = helper.create_parameter(attr=helper.bias_attr, shape=[size],
                                dtype=x.dtype, is_bias=True)
    if b is not None:
        inputs["Bias"] = b
    out = helper.create_variable_for_type_inference(
        x.dtype, (x.shape[0], size))
    helper.append_op("bilinear_tensor_product", inputs, {"Out": out}, {})
    return helper.append_activation(out)


def _adaptive_pool(op_type, input, psize, pool_type, require_index, name):
    """Shared adaptive_pool2d/3d body: validation per the reference
    contract (ref nn.py:3140-3148) + optional argmax Mask output."""
    if pool_type not in ("max", "avg"):
        raise ValueError(
            "Unknown pool_type: '%s'. It can only be 'max' or 'avg'."
            % str(pool_type))
    if pool_type == "avg" and require_index:
        raise ValueError(
            "invalid setting 'require_index' true when 'pool_type' is "
            "'avg'.")
    helper = LayerHelper(op_type, name=name)
    shape = tuple(input.shape[:2]) + tuple(psize)
    out = helper.create_variable_for_type_inference(input.dtype, shape)
    outs = {"Out": out}
    if require_index:
        mask = helper.create_variable_for_type_inference("int32", shape)
        outs["Mask"] = mask
    helper.append_op(op_type, {"X": input}, outs,
                     {"pool_size": list(psize), "pooling_type": pool_type,
                      "require_index": require_index})
    return (out, outs["Mask"]) if require_index else out


# ---------------------------------------------------------------------------
# the tensor, math and metric layers over ops/tensor_ops.py, math_ops.py
# and metric_ops.py (the JAX module's names)
# ---------------------------------------------------------------------------

from .attention import add_position_encoding  # noqa: E402,F401


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    """Parity: fluid.layers.mul: x flattened to 2-D at x_num_col_dims
    times y flattened at y_num_col_dims."""
    helper = LayerHelper("mul", name=name)
    out_shape = tuple(x.shape[:x_num_col_dims]) + tuple(
        y.shape[y_num_col_dims:])
    out = helper.create_variable_for_type_inference(x.dtype, out_shape)
    helper.append_op("mul", {"X": x, "Y": y}, {"Out": out},
                     {"x_num_col_dims": x_num_col_dims,
                      "y_num_col_dims": y_num_col_dims})
    return out


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op("clip", {"X": x}, {"Out": out},
                     {"min": float(min), "max": float(max)})
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op("clip_by_norm", {"X": x}, {"Out": out},
                     {"max_norm": float(max_norm)})
    return out


def sum(x, name=None):
    """Parity: fluid.layers.sum: the elementwise sum of the inputs."""
    helper = LayerHelper("sum", name=name)
    xs = x if isinstance(x, (list, tuple)) else [x]
    out = helper.create_variable_for_type_inference(xs[0].dtype, xs[0].shape)
    helper.append_op("sum", {"X": xs}, {"Out": out})
    return out


def flatten(x, axis=1, name=None):
    """(prod(shape[:axis]), prod(shape[axis:])); -1 where a dim is
    unknown at build time."""
    helper = LayerHelper("flatten", name=name)

    def known(dims):
        return _prod(dims) if all(s >= 0 for s in dims) else -1

    out = helper.create_variable_for_type_inference(
        x.dtype, (known(x.shape[:axis]), known(x.shape[axis:])))
    xshape = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("flatten2", {"X": x}, {"Out": out, "XShape": xshape},
                     {"axis": axis})
    return out


def stack(x, axis=0):
    helper = LayerHelper("stack")
    xs = x if isinstance(x, (list, tuple)) else [x]
    shape = list(xs[0].shape)
    shape.insert(axis % (len(shape) + 1), len(xs))
    out = helper.create_variable_for_type_inference(xs[0].dtype, tuple(shape))
    helper.append_op("stack", {"X": xs}, {"Y": out}, {"axis": axis})
    return out


def unstack(x, axis=0, num=None):
    helper = LayerHelper("unstack")
    n = num or x.shape[axis]
    shape = tuple(s for i, s in enumerate(x.shape) if i != axis % len(x.shape))
    outs = [helper.create_variable_for_type_inference(x.dtype, shape)
            for _ in range(n)]
    helper.append_op("unstack", {"X": x}, {"Y": outs}, {"axis": axis})
    return outs


def split(input, num_or_sections, dim=-1, name=None):
    """num_or_sections equal parts (an int) or parts of the given sizes
    along `dim`."""
    helper = LayerHelper("split", name=name)
    dim = dim % len(input.shape)
    if isinstance(num_or_sections, int):
        sizes = [input.shape[dim] // num_or_sections] * num_or_sections
        attrs = {"axis": dim, "num": num_or_sections}
    else:
        sizes = list(num_or_sections)
        attrs = {"axis": dim, "sections": sizes}
    outs = []
    for s in sizes:
        shape = list(input.shape)
        shape[dim] = s
        outs.append(helper.create_variable_for_type_inference(input.dtype,
                                                              tuple(shape)))
    helper.append_op("split", {"X": input}, {"Out": outs}, attrs)
    return outs


def gather_nd(input, index, name=None):
    helper = LayerHelper("gather_nd", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("gather_nd", {"X": input, "Index": index}, {"Out": out})
    return out


def scatter(input, index, updates, name=None, overwrite=True):
    helper = LayerHelper("scatter", name=name)
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op("scatter", {"X": input, "Ids": index,
                                 "Updates": updates},
                     {"Out": out}, {"overwrite": overwrite})
    return out


def scatter_nd_add(ref, index, updates, name=None):
    helper = LayerHelper("scatter_nd_add", name=name)
    out = helper.create_variable_for_type_inference(ref.dtype, ref.shape)
    helper.append_op("scatter_nd_add",
                     {"X": ref, "Index": index, "Updates": updates},
                     {"Out": out})
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", name=name)
    shape = tuple(s + paddings[2 * i] + paddings[2 * i + 1] if s >= 0 else -1
                  for i, s in enumerate(x.shape))
    out = helper.create_variable_for_type_inference(x.dtype, shape)
    helper.append_op("pad", {"X": x}, {"Out": out},
                     {"paddings": list(paddings),
                      "pad_value": float(pad_value)})
    return out


def pad2d(input, paddings=(0, 0, 0, 0), mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    helper = LayerHelper("pad2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("pad2d", {"X": input}, {"Out": out},
                     {"paddings": list(paddings), "mode": mode,
                      "pad_value": float(pad_value),
                      "data_format": data_format})
    return out


def _arg_layer(op_type, x, axis, name):
    helper = LayerHelper(op_type, name=name)
    shape = tuple(s for i, s in enumerate(x.shape) if i != axis % len(x.shape))
    out = helper.create_variable_for_type_inference("int64", shape)
    helper.append_op(op_type, {"X": x}, {"Out": out}, {"axis": axis})
    return out


def argmax(x, axis=0, name=None):
    return _arg_layer("arg_max", x, axis, name)


def argmin(x, axis=0, name=None):
    return _arg_layer("arg_min", x, axis, name)


def argsort(input, axis=-1, descending=False, name=None):
    """(the sorted values, their indices, int64): a stable sort."""
    helper = LayerHelper("argsort", name=name)
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    idx = helper.create_variable_for_type_inference("int64", input.shape)
    helper.append_op("argsort", {"X": input}, {"Out": out, "Indices": idx},
                     {"axis": axis, "descending": descending})
    return out, idx


def where(condition):
    """The flat positions of the true entries, padded with -1: (n, 1)
    int64 for n entries (a fixed shape)."""
    helper = LayerHelper("where")
    n = _prod(condition.shape) if all(s >= 0 for s in condition.shape) \
        else -1
    out = helper.create_variable_for_type_inference("int64", (n, 1))
    helper.append_op("where", {"Condition": condition}, {"Out": out})
    return out


def sign(x):
    return _simple_layer("sign", {"X": x}, {})


def shape(input):
    helper = LayerHelper("shape")
    out = helper.create_variable_for_type_inference("int32",
                                                    (len(input.shape),))
    helper.append_op("shape", {"Input": input}, {"Out": out})
    return out


def rank(input):
    helper = LayerHelper("rank")
    out = helper.create_variable_for_type_inference("int32", ())
    helper.append_op("rank", {"Input": input}, {"Out": out})
    return out


def size(input):
    helper = LayerHelper("size")
    out = helper.create_variable_for_type_inference("int64", ())
    helper.append_op("size", {"Input": input}, {"Out": out})
    return out


def pixel_shuffle(x, upscale_factor):
    r = upscale_factor
    n, c, h, w = x.shape
    return _simple_layer("pixel_shuffle", {"X": x}, {"upscale_factor": r},
                         shape=(n, c // (r * r), h * r, w * r))


def multiplex(inputs, index):
    """Row b of inputs[index[b]]."""
    return _simple_layer("multiplex", {"X": list(inputs), "Ids": index}, {})


def crop(x, shape=None, offsets=None, name=None):
    """Parity: fluid.layers.crop / crop_tensor: a window of the static
    `shape` (-1 or 0: the rest of the dim from the offset) at `offsets`,
    a list or a Variable (read on the device)."""
    from ..core.framework import Variable
    if isinstance(shape, Variable) or any(isinstance(s, Variable)
                                          for s in (shape or [])):
        raise TypeError(
            "crop_tensor: tensor-valued `shape` (or shape element) is "
            "dynamic-shape; pass a python list of ints (use -1 to keep "
            "a dim)")
    ins = {"X": x}
    attrs = {"shape": list(shape), "offsets": offsets}
    dynamic = isinstance(offsets, Variable)
    if dynamic:
        ins["Offsets"] = offsets
        attrs["offsets"] = None
        if any(int(s) <= 0 for s in shape):
            raise NotImplementedError(
                "crop_tensor: -1/0 shape entries need static offsets "
                "(runtime offsets can't give a static slice size); pass "
                "explicit sizes in `shape`, or make `offsets` a python list")
    off = [0] * len(shape) if dynamic or offsets is None else list(offsets)
    out_shape = tuple(
        int(s) if int(s) > 0 else (int(x.shape[i]) - int(off[i])
                                   if int(x.shape[i]) >= 0 else -1)
        for i, s in enumerate(shape))
    return _simple_layer("crop_tensor", ins, attrs, helper_name="crop",
                         shape=out_shape)


crop_tensor = crop


def space_to_depth(x, blocksize, name=None):
    return _simple_layer("space_to_depth", {"X": x}, {"blocksize": blocksize})


def deformable_roi_pooling(input, rois, trans, no_trans=False,
                           spatial_scale=1.0, group_size=(1, 1),
                           pooled_height=1, pooled_width=1, part_size=None,
                           sample_per_part=1, trans_std=0.1,
                           position_sensitive=False, name=None):
    """Parity: fluid.layers.deformable_roi_pooling over the
    deformable_psroi_pooling op; in position-sensitive mode the output
    has C / (pooled_height x pooled_width) channels (nn.py:13400)."""
    helper = LayerHelper("deformable_roi_pooling", name=name)
    ins = {"Input": input, "ROIs": rois}
    if not no_trans and trans is not None:
        ins["Trans"] = trans
    channels = input.shape[1]
    output_dim = channels // (pooled_height * pooled_width) \
        if position_sensitive else channels
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("deformable_psroi_pooling", ins, {"Output": out},
                     {"no_trans": no_trans, "spatial_scale": spatial_scale,
                      "output_dim": output_dim,
                      "group_size": list(group_size),
                      "pooled_height": pooled_height,
                      "pooled_width": pooled_width,
                      "part_size": list(part_size or [pooled_height,
                                                      pooled_width]),
                      "sample_per_part": sample_per_part,
                      "trans_std": trans_std})
    return out


def hash(input, hash_size, num_hash=1, name=None):
    """Parity: fluid.layers.hash: num_hash buckets in [0, hash_size) an
    id (the JAX package's multiplicative hash), int64."""
    return _simple_layer("hash", {"X": input},
                         {"num_hash": num_hash, "mod_by": hash_size},
                         dtype="int64")


def continuous_value_model(input, cvm, use_cvm=True):
    return _simple_layer("continuous_value_model", {"X": input, "CVM": cvm},
                         {"use_cvm": use_cvm}, helper_name="cvm",
                         out_slot="Y")


def filter_by_instag(ins, ins_tag, filter_tag, is_lod=True,
                     out_val_if_empty=0):
    """(rows kept or zeroed, their 1 / 0 loss weights, the index map)."""
    helper = LayerHelper("filter_by_instag")
    out = helper.create_variable_for_type_inference(ins.dtype, ins.shape)
    loss_weight = helper.create_variable_for_type_inference("float32")
    index_map = helper.create_variable_for_type_inference("int64")
    helper.append_op("filter_by_instag",
                     {"Ins": ins, "Ins_tag": ins_tag,
                      "Filter_tag": filter_tag},
                     {"Out": out, "LossWeight": loss_weight,
                      "IndexMap": index_map}, {})
    return out, loss_weight, index_map


def shuffle_channel(x, group, name=None):
    return _simple_layer("shuffle_channel", {"X": x}, {"group": group})


def _identity_layer(op_type, x, ins=None, attrs=None, name=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(op_type, dict({"X": x}, **(ins or {})), {"Out": out},
                     attrs or {})
    return out


def merge_selected_rows(x, name=None):
    """The identity: gradients are dense here (no SelectedRows)."""
    return _identity_layer("merge_selected_rows", x, name=name)


def get_tensor_from_selected_rows(x, name=None):
    return _identity_layer("get_tensor_from_selected_rows", x, name=name)


def lod_reset(x, y=None, target_lod=None):
    """The identity on the device: the LoD is host-side (padded tensors
    and lengths); the new LoD rides the output as metadata."""
    out = _identity_layer("lod_reset", x,
                          {"Y": y} if y is not None else None,
                          {"target_lod": list(target_lod) if target_lod
                           else []})
    out._lod_source = y if y is not None else target_lod
    return out


def lod_append(x, level):
    return _identity_layer("lod_append", x,
                           None if isinstance(level, (list, tuple))
                           else {"Y": level})


# -- the large-vocabulary heads and the matching layers -----------------------

def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=10, name=None,
        sampler="uniform", custom_dist=None, seed=0, is_sparse=False):
    """Parity: fluid.layers.nce. The per-row NCE cost (B, 1);
    num_neg_samples classes drawn once for the batch from `sampler`
    ("uniform", "log_uniform", or `custom_dist`'s probabilities, set
    through ``assign``). is_sparse is accepted: the gradient into the
    weight is a dense scatter-add."""
    import numpy as np
    helper = LayerHelper("nce", param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    dim = input.shape[-1]
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[num_total_classes, dim],
                                dtype=input.dtype)
    b = helper.create_parameter(attr=helper.bias_attr,
                                shape=[num_total_classes], dtype=input.dtype,
                                is_bias=True)
    batch = input.shape[0]
    num_true = label.shape[1] if len(label.shape) > 1 else 1
    cost = helper.create_variable_for_type_inference("float32", (batch, 1))
    s_logits = helper.create_variable_for_type_inference(
        "float32", (batch, num_true + num_neg_samples))
    s_labels = helper.create_variable_for_type_inference(
        "int64", (batch, num_true + num_neg_samples))
    inputs = {"Input": input, "Label": label, "Weight": w}
    if b is not None:
        inputs["Bias"] = b
    if custom_dist is not None:
        from . import tensor as tensor_layers
        inputs["CustomDistProbs"] = tensor_layers.assign(
            np.asarray(custom_dist, np.float32))
        sampler = "custom_dist"
    helper.append_op("nce", inputs,
                     {"Cost": cost, "SampleLogits": s_logits,
                      "SampleLabels": s_labels},
                     {"num_total_classes": num_total_classes,
                      "num_neg_samples": num_neg_samples,
                      "sampler": sampler, "op_seed": seed})
    return cost


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None, path_table=None, path_code=None, is_custom=False,
             is_sparse=False):
    """Parity: fluid.layers.hsigmoid: the default complete binary tree
    (W [num_classes - 1, dim]) or a custom tree through path_table /
    path_code with is_custom (W [num_classes, dim]). Out (B, 1)."""
    if is_custom and (path_table is None or path_code is None
                      or num_classes is None):
        raise ValueError(
            "hsigmoid custom tree needs path_table, path_code and "
            "num_classes (ref layers/nn.py hsigmoid checks)")
    if not is_custom and (path_table is not None or path_code is not None):
        raise ValueError(
            "hsigmoid: path_table/path_code given without is_custom=True; "
            "pass is_custom=True to use the custom tree (W becomes "
            "[num_classes, dim])")
    helper = LayerHelper("hsigmoid", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    dim = input.shape[-1]
    rows = num_classes if is_custom else num_classes - 1
    w = helper.create_parameter(attr=helper.param_attr, shape=[rows, dim],
                                dtype=input.dtype)
    b = helper.create_parameter(attr=helper.bias_attr, shape=[rows],
                                dtype=input.dtype, is_bias=True)
    batch = input.shape[0]
    depth = path_table.shape[-1] if is_custom \
        else max(int(num_classes - 1).bit_length(), 1)
    out = helper.create_variable_for_type_inference("float32", (batch, 1))
    pre = helper.create_variable_for_type_inference("float32",
                                                    (batch, depth))
    inputs = {"X": input, "W": w, "Label": label}
    if is_custom:
        inputs["PathTable"] = path_table
        inputs["PathCode"] = path_code
    if b is not None:
        inputs["Bias"] = b
    helper.append_op("hierarchical_sigmoid", inputs,
                     {"Out": out, "PreOut": pre},
                     {"num_classes": num_classes})
    return out


def sampled_softmax_with_cross_entropy(logits, label, num_samples,
                                       num_true=1,
                                       remove_accidental_hits=True,
                                       use_customized_samples=False,
                                       customized_samples=None,
                                       customized_probabilities=None,
                                       seed=0):
    """Parity: fluid.layers.sampled_softmax_with_cross_entropy: a
    softmax cross entropy over the true labels and num_samples
    log-uniform classes with the logQ correction. Loss (B, 1)."""
    if use_customized_samples:
        raise NotImplementedError(
            "sampled_softmax_with_cross_entropy: customized samples are "
            "not supported; the op draws its own log-uniform samples")
    helper = LayerHelper("sampled_softmax_with_cross_entropy")
    batch = logits.shape[0]
    loss = helper.create_variable_for_type_inference("float32", (batch, 1))
    samples = helper.create_variable_for_type_inference(
        "int64", (batch, num_true + num_samples))
    s_logits = helper.create_variable_for_type_inference(
        "float32", (batch, num_true + num_samples))
    helper.append_op("sample_logits", {"Logits": logits, "Labels": label},
                     {"Loss": loss, "Samples": samples,
                      "SampledLogits": s_logits},
                     {"num_samples": num_samples,
                      "remove_accidental_hits": remove_accidental_hits,
                      "use_customized_samples": use_customized_samples,
                      "op_seed": seed})
    return loss


def match_matrix_tensor(x, y, channel_num, act=None, param_attr=None,
                        dtype="float32", name=None, x_length=None,
                        y_length=None):
    """Parity: fluid.layers.match_matrix_tensor: out[b, c, i, j] = x_bi
    . W_c . y_bj over x (B, Lx, D), y (B, Ly, Dy) and optional lengths.
    Returns (out (B, C, Lx, Ly), tmp (B, Lx, C, Dy))."""
    helper = LayerHelper("match_matrix_tensor", param_attr=param_attr,
                         act=act, name=name)
    d, dy = x.shape[-1], y.shape[-1]
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[d, channel_num, dy], dtype=dtype)
    b, lx, ly = x.shape[0], x.shape[1], y.shape[1]
    out = helper.create_variable_for_type_inference(
        dtype, (b, channel_num, lx, ly))
    tmp = helper.create_variable_for_type_inference(
        dtype, (b, lx, channel_num, dy))
    inputs = {"X": x, "Y": y, "W": w}
    if x_length is not None:
        inputs["XLength"] = x_length
    if y_length is not None:
        inputs["YLength"] = y_length
    helper.append_op("match_matrix_tensor", inputs,
                     {"Out": out, "Tmp": tmp}, {})
    return helper.append_activation(out), tmp


def var_conv_2d(input, row, col, input_channel, output_channel, filter_size,
                stride=1, param_attr=None, act=None, dtype="float32",
                name=None):
    """Parity: fluid.layers.var_conv_2d: a "SAME" convolution over the
    padded batch, the outputs past each row's (row, col) extent
    zeroed."""
    helper = LayerHelper("var_conv_2d", param_attr=param_attr, act=act,
                         name=name)
    ks, st = _pair(filter_size), _pair(stride)
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=[output_channel, input_channel, ks[0], ks[1]], dtype=dtype)
    b, _, h, wd = input.shape
    out = helper.create_variable_for_type_inference(
        dtype, (b, output_channel, (h + st[0] - 1) // st[0],
                (wd + st[1] - 1) // st[1]))
    inputs = {"X": input, "W": w}
    if row is not None:
        inputs["Row"] = row
    if col is not None:
        inputs["Col"] = col
    helper.append_op("var_conv_2d", inputs, {"Out": out},
                     {"strides": list(st)})
    return helper.append_activation(out)


def tree_conv(nodes_vector, edge_set, output_size, num_filters=1,
              max_depth=2, act="tanh", param_attr=None, bias_attr=None,
              name=None):
    """Parity: fluid.layers.tree_conv (TBCNN, any max_depth):
    nodes_vector (B, N, D), node ids 1-based; edge_set (B, E, 2)
    (parent, child) pairs padded with 0. Returns (B, N, output_size,
    num_filters)."""
    helper = LayerHelper("tree_conv", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    d = nodes_vector.shape[-1]
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[d, 3, output_size, num_filters],
                                dtype=nodes_vector.dtype)
    bias = helper.create_parameter(attr=helper.bias_attr,
                                   shape=[output_size, num_filters],
                                   dtype=nodes_vector.dtype, is_bias=True)
    b, n = nodes_vector.shape[0], nodes_vector.shape[1]
    out = helper.create_variable_for_type_inference(
        nodes_vector.dtype, (b, n, output_size, num_filters))
    inputs = {"NodesVector": nodes_vector, "EdgeSet": edge_set,
              "Filter": w}
    if bias is not None:
        inputs["Bias"] = bias
    helper.append_op("tree_conv", inputs, {"Out": out},
                     {"max_depth": max_depth})
    return helper.append_activation(out)
