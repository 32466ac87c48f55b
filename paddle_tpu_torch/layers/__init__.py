"""fluid.layers-compatible API surface: the layers the ported slices use.

Parity: python/paddle/fluid/layers/__init__.py; the counterpart of
``paddle_tpu/layers/`` with, in files of the same names, ``io.data``,
``tensor``'s ``create_parameter``, ``fill_constant``, ``zeros_like``,
``ones_like`` and ``sums``, ``nn``'s ``fc``, ``conv2d``, ``pool2d``,
``adaptive_pool2d``, ``batch_norm``, ``relu``, ``embedding``,
``one_hot``, ``matmul``, ``layer_norm``, ``dropout``, ``label_smooth``,
``mean``, ``reduce_sum``, ``elementwise_add``/``sub``/``mul``/``div``/
``max``/``min``/``pow``, ``logical_and``, ``scale``, ``reshape``,
``transpose`` (for the attention layer), ``squeeze``, ``unsqueeze``,
``concat``, ``slice``, ``gather``, ``expand``, ``topk``, ``cast`` and
``softmax``, ``ops``' ``sigmoid``, ``exp``, ``ceil``, ``floor`` and
``cos``, ``control_flow``'s ``equal``, ``greater_than``, ``less_than``
and ``autoincreased_step_counter``,
``learning_rate_scheduler``'s eight schedules,
``loss``'s ``cross_entropy``, ``softmax_with_cross_entropy``,
``square_error_cost`` and ``sigmoid_cross_entropy_with_logits``,
``metric_op.accuracy``, ``attention``'s ``multi_head_attention``,
``scaled_dot_product_attention`` and ``add_position_encoding``,
``sequence.sequence_mask`` and ``beam_search``'s ``beam_search`` and
``beam_search_decode``.
"""

from .io import data
from .nn import (fc, conv2d, pool2d, adaptive_pool2d, batch_norm, relu,
                 embedding, one_hot, matmul, layer_norm, dropout,
                 label_smooth, mean, reduce_sum, elementwise_add,
                 elementwise_sub, elementwise_mul, elementwise_div,
                 elementwise_max, elementwise_min, elementwise_pow,
                 logical_and, scale, reshape, transpose, squeeze,
                 unsqueeze, concat, slice, gather, expand, topk, cast,
                 softmax)
from .tensor import (create_parameter, fill_constant, zeros_like, ones_like,
                     sums)
from .ops import sigmoid, exp, ceil, floor, cos, log
from .control_flow import (equal, greater_than, less_than,
                           autoincreased_step_counter)
from .loss import (cross_entropy, softmax_with_cross_entropy,
                   square_error_cost, sigmoid_cross_entropy_with_logits)
from .metric_op import accuracy
from . import attention
from .attention import (scaled_dot_product_attention, multi_head_attention,
                        add_position_encoding)
from .sequence import sequence_mask
from . import beam_search as beam_search_mod
from .beam_search import beam_search, beam_search_decode
from . import learning_rate_scheduler
from .learning_rate_scheduler import (noam_decay, exponential_decay,
                                      natural_exp_decay, inverse_time_decay,
                                      polynomial_decay, piecewise_decay,
                                      cosine_decay, linear_lr_warmup)
