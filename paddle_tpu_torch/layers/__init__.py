"""fluid.layers-compatible API surface: the layers the ported slice uses.

Parity: python/paddle/fluid/layers/__init__.py; the counterpart of
``paddle_tpu/layers/`` with, in files of the same names, ``io.data``,
``tensor.create_parameter``, ``nn``'s ``fc``, ``embedding``, ``matmul``,
``layer_norm``, ``dropout``, ``mean``, ``elementwise_add``, ``reshape``,
``transpose`` (for the attention layer) and ``slice``,
``loss.softmax_with_cross_entropy``, and ``attention``'s
``multi_head_attention`` and ``scaled_dot_product_attention``.
"""

from .io import data
from .nn import (fc, embedding, matmul, layer_norm, dropout, mean,
                 elementwise_add, reshape, transpose, slice)
from .tensor import create_parameter
from .loss import softmax_with_cross_entropy
from . import attention
from .attention import scaled_dot_product_attention, multi_head_attention
