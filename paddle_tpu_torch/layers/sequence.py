"""Sequence layers: the LoD family with static shapes.

Parity: python/paddle/fluid/layers/sequence_lod.py / nn.py's sequence_*
APIs; the counterpart of ``paddle_tpu/layers/sequence.py``:
``sequence_mask``, ``sequence_pad``, ``_unpad``, ``_pool``,
``_first_step``, ``_last_step``, ``_softmax``, ``_expand``,
``_expand_as``, ``_reverse``, ``_conv``, ``_concat``, ``_slice``,
``_enumerate``, ``_reshape``, ``_scatter`` and ``_topk_avg_pooling``
(over ``ops/match_ops.py``). The convention is the JAX package's: data
``(batch, max_len, ...)`` padded, raggedness as an explicit lengths
tensor.
"""

from ..core.layer_helper import LayerHelper

__all__ = [
    "sequence_mask", "sequence_pad", "sequence_unpad", "sequence_pool",
    "sequence_first_step", "sequence_last_step", "sequence_softmax",
    "sequence_expand", "sequence_expand_as", "sequence_reverse",
    "sequence_conv", "sequence_concat", "sequence_slice",
    "sequence_enumerate", "sequence_reshape", "sequence_scatter",
    "sequence_topk_avg_pooling",
]


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """Parity: fluid.layers.sequence_mask. x: (B,) lengths -> (B, maxlen)
    in `dtype`; an int `maxlen` is static, else the width is the longest
    length."""
    helper = LayerHelper("sequence_mask", name=name)
    static_maxlen = maxlen if isinstance(maxlen, int) else 0
    n = x.shape[0] if x.shape else 0
    out = helper.create_variable_for_type_inference(dtype,
                                                    (n, static_maxlen))
    helper.append_op("sequence_mask", {"X": x}, {"Y": out},
                     {"maxlen": static_maxlen or -1,
                      "static_maxlen": static_maxlen, "out_dtype": dtype})
    return out


def _seq_op(op_type, x, length, attrs=None, n_outs=1, out_shape=None,
            out_dtype=None, out_slots=("Out",)):
    helper = LayerHelper(op_type)
    inputs = {"X": x}
    if length is not None:
        inputs["Length"] = length
    dtype = out_dtype or (x[0] if isinstance(x, (list, tuple)) else x).dtype
    outs = [helper.create_variable_for_type_inference(dtype, out_shape)
            for _ in range(n_outs)]
    helper.append_op(op_type, inputs,
                     {slot: o for slot, o in zip(out_slots, outs)},
                     attrs or {})
    return outs[0] if n_outs == 1 else outs


def _full_length(helper, x):
    """Default lengths = max_len for every row (un-ragged batch): a
    constant of the static batch size, or one as long as x's runtime
    batch where the batch is -1."""
    from . import tensor as tensor_layers
    b = x.shape[0] if x.shape else -1
    if isinstance(b, int) and b > 0:
        return tensor_layers.fill_constant((b,), "int32", x.shape[1])
    # dynamic batch (-1): take the runtime batch size from x itself
    return tensor_layers.fill_constant_batch_size_like(
        x, [-1], "int32", x.shape[1])


def sequence_pool(input, pool_type, length=None, is_test=False, pad_value=0.0):
    """Parity: fluid.layers.sequence_pool. input (B, T, D) + lengths ->
    (B, D)."""
    helper = LayerHelper("sequence_pool")
    if length is None:
        length = _full_length(helper, input)
    out, _ = _seq_op("sequence_pool", input, length,
                     attrs={"pooltype": pool_type.upper()}, n_outs=2,
                     out_shape=(input.shape[0],) + tuple(input.shape[2:]),
                     out_slots=("Out", "MaxIndex"))
    return out


def sequence_first_step(input, length=None):
    return sequence_pool(input, "first", length)


def sequence_last_step(input, length=None):
    return sequence_pool(input, "last", length)


def sequence_softmax(input, length=None, use_cudnn=False, name=None):
    helper = LayerHelper("sequence_softmax", name=name)
    if length is None:
        length = _full_length(helper, input)
    return _seq_op("sequence_softmax", input, length,
                   out_shape=tuple(input.shape))


def sequence_reverse(x, length=None, name=None):
    helper = LayerHelper("sequence_reverse", name=name)
    if length is None:
        length = _full_length(helper, x)
    return _seq_op("sequence_reverse", x, length, out_shape=tuple(x.shape),
                   out_slots=("Y",))


def sequence_pad(x, pad_value=None, maxlen=None, length=None, name=None):
    """Parity: fluid.layers.sequence_pad. The data is padded already in
    this convention; returns (x, length)."""
    helper = LayerHelper("sequence_pad", name=name)
    if length is None:
        length = _full_length(helper, x)
    out, _len = _seq_op("sequence_pad", x, length, n_outs=2,
                           out_shape=tuple(x.shape),
                           out_slots=("Out", "Length"))
    return out, length


def sequence_unpad(x, length, name=None):
    """Zeroes padding positions (static-shape 'unpad')."""
    return _seq_op("sequence_unpad", x, length, out_shape=tuple(x.shape))


def sequence_expand(x, y, ref_level=-1, static_repeat=0, y_length=None,
                    name=None):
    """Parity: fluid.layers.sequence_expand: repeat each sequence of x
    per y's lod at ref_level. In the padded convention y gives the static
    output row count; the ragged per-sequence counts come in `y_length`
    (a (B,) int var, e.g. a lengths feed) and steer a fixed-shape gather.
    `static_repeat` repeats every row that many times; with neither, rows
    expand uniformly to y's size. Under data parallelism the ragged form
    refuses (ops/sequence_ops.py)."""
    helper = LayerHelper("sequence_expand", name=name)
    if static_repeat:
        n = x.shape[0] * static_repeat if x.shape[0] != -1 else -1
    else:
        n = y.shape[0]
    out = helper.create_variable_for_type_inference(
        x.dtype, (n,) + tuple(x.shape[1:]))
    inputs = {"X": x, "Y": y}
    if y_length is not None:
        inputs["YLength"] = y_length
    helper.append_op("sequence_expand", inputs, {"Out": out},
                     {"ref_level": ref_level, "static_repeat": static_repeat})
    return out


def sequence_expand_as(x, y, name=None):
    helper = LayerHelper("sequence_expand_as", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("sequence_expand_as", {"X": x, "Y": y}, {"Out": out})
    return out


def sequence_concat(input, name=None):
    """Concat along the time axis."""
    helper = LayerHelper("sequence_concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op("sequence_concat", {"X": list(input)}, {"Out": out})
    return out


def sequence_slice(input, offset, length, name=None):
    helper = LayerHelper("sequence_slice", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("sequence_slice", {"X": input}, {"Out": out},
                     {"static_offset": int(offset),
                      "static_length": int(length)})
    return out


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=True, padding_start=None, param_attr=None,
                  bias_attr=None, act=None, name=None):
    """Parity: fluid.layers.sequence_conv — context-window projection."""
    if filter_stride != 1:
        # reference sequence_conv enforces contextStride == 1 too
        raise NotImplementedError(
            "sequence_conv only supports filter_stride=1 (as the "
            "reference: sequence_conv_op.cc currently only supports "
            "contextStride=1)")
    helper = LayerHelper("sequence_conv", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    d = input.shape[-1]
    w = helper.create_parameter(helper.param_attr,
                                [filter_size * d, num_filters], input.dtype)
    out = helper.create_variable_for_type_inference(
        input.dtype, tuple(input.shape[:2]) + (num_filters,))
    start = padding_start if padding_start is not None else -(filter_size // 2)
    helper.append_op("sequence_conv", {"X": input, "Filter": w}, {"Out": out},
                     {"contextLength": filter_size, "contextStart": start,
                      "contextStride": filter_stride})
    pre_act = out
    bias_attr = helper.bias_attr
    if bias_attr is not False:
        from .nn import _append_bias
        pre_act = _append_bias(helper, out, num_filters, dim_start=2)
    return helper.append_activation(pre_act)


def sequence_enumerate(input, win_size, pad_value=0, name=None):
    helper = LayerHelper("sequence_enumerate", name=name)
    out = helper.create_variable_for_type_inference(
        input.dtype, tuple(input.shape) + (win_size,))
    helper.append_op("sequence_enumerate", {"X": input}, {"Out": out},
                     {"win_size": win_size, "pad_value": pad_value})
    return out


def sequence_reshape(input, new_dim, name=None):
    helper = LayerHelper("sequence_reshape", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("sequence_reshape", {"X": input}, {"Out": out},
                     {"new_dim": new_dim})
    return out


def sequence_scatter(input, index, updates, length=None, name=None):
    """Parity: fluid.layers.sequence_scatter. Padded form: input (B, D),
    index (B, L) (or (B, L, 1)), updates (B, L), an optional length a
    row."""
    helper = LayerHelper("sequence_scatter", name=name)
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    inputs = {"X": input, "Ids": index, "Updates": updates}
    if length is not None:
        inputs["Length"] = length
    helper.append_op("sequence_scatter", inputs, {"Out": out}, {})
    return out


def sequence_topk_avg_pooling(input, row=None, col=None, topks=(1,),
                              channel_num=1, name=None):
    """Parity: fluid.layers.sequence_topk_avg_pooling. Padded form:
    input (B, C, L1, L2), optional row / col valid lengths. Returns (B,
    L1, C x len(topks))."""
    helper = LayerHelper("sequence_topk_avg_pooling", name=name)
    b, c, l1, _ = input.shape
    out = helper.create_variable_for_type_inference(
        input.dtype, (b, l1, c * len(topks)))
    inputs = {"X": input}
    if row is not None:
        inputs["Row"] = row
    if col is not None:
        inputs["Col"] = col
    helper.append_op("sequence_topk_avg_pooling", inputs, {"Out": out},
                     {"topks": list(topks), "channel_num": channel_num})
    return out
