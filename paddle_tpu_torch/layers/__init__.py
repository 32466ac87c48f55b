"""fluid.layers-compatible API surface: the layers the ported slices use.

Parity: python/paddle/fluid/layers/__init__.py; the counterpart of
``paddle_tpu/layers/`` with, in files of the same names, ``io.data``,
``tensor``'s ``create_parameter``, ``fill_constant`` and ``zeros_like``,
``nn``'s ``fc``, ``embedding``, ``matmul``, ``layer_norm``, ``dropout``,
``mean``, ``reduce_sum``, ``elementwise_add``/``mul``/``div``,
``logical_and``, ``scale``, ``reshape``, ``transpose`` (for the attention
layer), ``slice``, ``gather``, ``topk``, ``cast`` and ``softmax``,
``control_flow``'s ``equal`` and ``greater_than``,
``loss.softmax_with_cross_entropy``, ``metric_op.accuracy``, and
``attention``'s ``multi_head_attention`` and
``scaled_dot_product_attention``.
"""

from .io import data
from .nn import (fc, embedding, matmul, layer_norm, dropout, mean,
                 reduce_sum, elementwise_add, elementwise_mul,
                 elementwise_div, logical_and, scale, reshape, transpose,
                 slice, gather, topk, cast, softmax)
from .tensor import create_parameter, fill_constant, zeros_like
from .control_flow import equal, greater_than
from .loss import softmax_with_cross_entropy
from .metric_op import accuracy
from . import attention
from .attention import scaled_dot_product_attention, multi_head_attention
