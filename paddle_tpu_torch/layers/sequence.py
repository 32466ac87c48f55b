"""Sequence layers: the LoD family with static shapes.

Parity: python/paddle/fluid/layers/sequence_lod.py / nn.py's sequence_*
APIs; the counterpart of ``paddle_tpu/layers/sequence.py`` with
``sequence_mask`` only (the Transformer's padding biases and masked loss,
DIN's history mask). Its other layers (``sequence_pad``, ``_unpad``,
``_pool``, ``_softmax``, ``_expand``, ``_reverse``, ``_conv``, ...) wait
for ROADMAP queue A item 10c.6. The convention is the JAX package's:
data ``(batch, max_len, ...)`` padded, raggedness as an explicit
lengths tensor.
"""

from ..core.layer_helper import LayerHelper

__all__ = ["sequence_mask"]


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
