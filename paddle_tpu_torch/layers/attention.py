"""Attention layers.

Parity: python/paddle/fluid/layers/nn.py scaled_dot_product_attention and
the transformer recipes (book machine-translation / models transformer);
the counterpart of ``paddle_tpu/layers/attention.py``'s two attention
layers and ``add_position_encoding``. Attention is a first-class op, routed on the card to the
hand-written flash-attention kernels (ops/attention_ops.py, ops/flash.py).
"""

from ..core.layer_helper import LayerHelper

__all__ = ["scaled_dot_product_attention", "multi_head_attention",
           "add_position_encoding"]


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0, attn_bias=None,
                                 causal=False, segment_ids=None, name=None):
    """Parity: fluid.nets.scaled_dot_product_attention.

    queries/keys/values: (B, T, d_model). Splits into num_heads, attends
    (the flash kernels on the card), merges. Returns (B, Tq, d_model_v)."""
    from . import nn as nn_layers
    helper = LayerHelper("scaled_dot_product_attention", name=name)
    b, tq, dm = queries.shape

    def split_heads(x):
        b_, t, m = x.shape
        r = nn_layers.reshape(x, [b_, t, num_heads, m // num_heads])
        return nn_layers.transpose(r, [0, 2, 1, 3])

    q, k, v = split_heads(queries), split_heads(keys), split_heads(values)
    out = helper.create_variable_for_type_inference(queries.dtype,
                                                    tuple(q.shape))
    inputs = {"Q": q, "K": k, "V": v}
    if attn_bias is not None:
        inputs["Bias"] = attn_bias
    if segment_ids is not None:
        inputs["SegmentIds"] = segment_ids
    helper.append_op("scaled_dot_product_attention", inputs, {"Out": out},
                     {"causal": causal})
    merged = nn_layers.transpose(out, [0, 2, 1, 3])
    merged = nn_layers.reshape(merged, [b, tq, values.shape[-1]])
    if dropout_rate:
        merged = nn_layers.dropout(merged, dropout_rate)
    return merged


def multi_head_attention(queries, keys=None, values=None, num_heads=8,
                         d_model=None, attn_bias=None, causal=False,
                         param_attr=None, bias_attr=None, dropout_rate=0.0,
                         segment_ids=None, name=None):
    """Full multi-head block: QKV + output projections fused into one op
    (one flash attention + 4 matmuls)."""
    from . import nn as nn_layers
    helper = LayerHelper("multihead_attention", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    d_model = d_model or queries.shape[-1]
    dtype = queries.dtype

    def _suffixed(attr, nm):
        # A named ParamAttr must not collapse the four projections into one
        # shared parameter: suffix the name per projection.
        if attr is False or attr is None or getattr(attr, "name", None) is None:
            return attr
        import copy
        a = copy.copy(attr)
        a.name = f"{attr.name}_{nm}"
        return a

    def w(nm):
        return helper.create_parameter(_suffixed(helper.param_attr, nm),
                                       [d_model, d_model], dtype)

    def b(nm):
        if helper.bias_attr is False:
            return None
        return helper.create_parameter(_suffixed(helper.bias_attr, nm + "_b"),
                                       [d_model], dtype, is_bias=True)

    wq, wk, wv, wo = w("q"), w("k"), w("v"), w("o")
    bq, bk, bv, bo = b("q"), b("k"), b("v"), b("o")
    out = helper.create_variable_for_type_inference(
        dtype, tuple(queries.shape[:2]) + (d_model,))
    inputs = {"Query": queries, "WQ": wq, "WK": wk, "WV": wv, "WO": wo}
    if keys is not None:
        inputs["Key"] = keys
    if values is not None:
        inputs["Value"] = values
    for nm, v_ in (("BQ", bq), ("BK", bk), ("BV", bv), ("BO", bo)):
        if v_ is not None:
            inputs[nm] = v_
    if attn_bias is not None:
        inputs["Bias"] = attn_bias
    if segment_ids is not None:
        inputs["SegmentIds"] = segment_ids
    helper.append_op("multihead_attention", inputs, {"Out": out},
                     {"num_heads": num_heads, "causal": causal})
    if dropout_rate:
        out = nn_layers.dropout(out, dropout_rate)
    return out


def add_position_encoding(input, alpha=1.0, beta=1.0, name=None):
    """Parity: fluid.layers.add_position_encoding (sinusoidal): alpha x +
    beta enc over (B, T, D)."""
    helper = LayerHelper("add_position_encoding", name=name)
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    tuple(input.shape))
    helper.append_op("add_position_encoding", {"X": input}, {"Out": out},
                     {"alpha": float(alpha), "beta": float(beta)})
    return out
