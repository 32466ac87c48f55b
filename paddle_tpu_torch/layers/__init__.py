"""fluid.layers-compatible API surface: the layers the ported slices use.

Parity: python/paddle/fluid/layers/__init__.py; the counterpart of
``paddle_tpu/layers/`` with, in files of the same names, ``io.data``
and ``fluid_data``, every name of ``tensor``, ``loss``, ``metric_op``
and ``distributions`` (``Uniform``, ``Normal``, ``Categorical``,
``MultivariateNormalDiag``), ``tile`` and ``top_k``, ``nn``'s tensor,
math and CTR layers (``mul``, ``clip``, ``clip_by_norm``, ``sum``,
``flatten``, ``stack``, ``unstack``, ``split``, ``gather_nd``,
``scatter``, ``scatter_nd_add``, ``pad``, ``pad2d``, ``argmax``,
``argmin``, ``argsort``, ``where``, ``sign``, ``shape``, ``rank``,
``size``, ``pixel_shuffle``, ``multiplex``, ``crop`` / ``crop_tensor``,
``space_to_depth``, ``deformable_roi_pooling``, ``hash``,
``continuous_value_model``, ``filter_by_instag``, ``shuffle_channel``,
``merge_selected_rows``, ``get_tensor_from_selected_rows``,
``lod_reset``, ``lod_append``), ``nn``'s ``fc``, ``conv2d``,
``pool2d``, ``adaptive_pool2d``, ``batch_norm``, ``relu``, ``embedding``,
``one_hot``, ``matmul``, ``layer_norm``, ``dropout``, ``label_smooth``,
``mean``, ``reduce_sum``/``mean``/``max``/``min``/``prod``/``all``/
``any``, ``elementwise_add``/``sub``/``mul``/``div``/``max``/``min``/
``pow``/``mod``/``floordiv``, ``logical_and``/``or``/``xor``/``not``,
``scale``, ``reshape``, ``transpose`` (for the attention layer),
``squeeze``, ``unsqueeze``, ``concat``, ``slice``, ``gather``,
``expand``, ``topk``, ``cast``, ``softmax``, ``row_conv``,
``im2sequence``, ``linear_chain_crf``, ``crf_decoding``, ``warpctc``,
``ctc_greedy_decoder``, ``smooth_l1`` and ``py_func``, and the vision
and activation layers (``conv3d``, ``conv2d_transpose``,
``conv3d_transpose``, ``pool3d``, ``adaptive_pool3d``, ``group_norm``,
``instance_norm``, ``data_norm``, ``spectral_norm``, ``l2_normalize``,
``cumsum``, ``leaky_relu``, ``prelu``, ``maxout``, ``lrn``, the resizes
``resize_bilinear`` / ``resize_nearest`` / ``resize_trilinear`` /
``image_resize`` / ``image_resize_short``, ``grid_sampler``,
``affine_grid``, ``temporal_shift``, ``affine_channel``,
``similarity_focus``, ``fsp_matrix``, ``deformable_conv``, ``unfold``
and ``bilinear_tensor_product``), ``tensor``'s ``range``, every layer
of ``ops`` (the activations, the random layers and ``cumsum``),
``layer_function_generator``'s five helpers, ``control_flow``'s every name (``While``,
``cond``, ``case``, ``switch_case``, ``Switch``, ``IfElse``,
``StaticRNN``, ``DynamicRNN``, ``while_loop``, ``Print``, the tensor
arrays, ``increment``, the comparisons, ``is_empty``,
``reorder_lod_tensor_by_rank`` and ``autoincreased_step_counter``),
``learning_rate_scheduler``'s eight schedules, ``loss``'s
``cross_entropy``, ``softmax_with_cross_entropy``,
``square_error_cost``, ``sigmoid_cross_entropy_with_logits``,
``log_loss`` and ``cos_sim``, ``detection``'s every name (the JAX
module's ``__all__`` and the others it exports: ``yolov3_loss``,
``anchor_generator``, ``bipartite_match``, ``target_assign``,
``box_clip``, ``polygon_box_transform``, ``retinanet_detection_output``,
``sigmoid_focal_loss``, ``distribute_fpn_proposals`` and
``collect_fpn_proposals``), ``metric_op``'s ``accuracy``, ``edit_distance`` and
``chunk_eval``, ``attention``'s ``multi_head_attention``,
``scaled_dot_product_attention`` and ``add_position_encoding``,
``sequence``'s seventeen sequence layers (all of the JAX module's),
the large-vocabulary heads ``nce``, ``hsigmoid`` and
``sampled_softmax_with_cross_entropy`` and the matching layers
``match_matrix_tensor``, ``var_conv_2d`` and ``tree_conv``, ``rnn``'s
``dynamic_lstm``, ``dynamic_lstmp``, ``dynamic_gru``, ``lstm``, ``gru``,
``lstm_unit`` and ``gru_unit``, and ``beam_search``'s ``beam_search``
and ``beam_search_decode``. ``math_op_patch`` gives ``Variable`` the JAX
package's arithmetic and comparison operators.
"""

from .io import data, fluid_data
from .nn import (fc, conv2d, pool2d, adaptive_pool2d, batch_norm, relu,
                 embedding, one_hot, matmul, layer_norm, dropout,
                 label_smooth, mean, reduce_sum, reduce_mean, reduce_max,
                 reduce_min, reduce_prod, reduce_all, reduce_any,
                 elementwise_add, elementwise_sub, elementwise_mul,
                 elementwise_div, elementwise_max, elementwise_min,
                 elementwise_pow, elementwise_mod, elementwise_floordiv,
                 logical_and, logical_or, logical_xor, logical_not, scale,
                 reshape, transpose, squeeze, unsqueeze, concat, slice,
                 gather, expand, topk, cast, softmax, row_conv, im2sequence,
                 linear_chain_crf, crf_decoding, warpctc, ctc_greedy_decoder,
                 smooth_l1, py_func, conv3d, conv2d_transpose, pool3d,
                 group_norm, instance_norm, spectral_norm, l2_normalize,
                 cumsum, leaky_relu, prelu, maxout, lrn, resize_bilinear,
                 resize_nearest, image_resize, conv3d_transpose, data_norm,
                 grid_sampler, affine_grid, temporal_shift, affine_channel,
                 similarity_focus, fsp_matrix, deformable_conv,
                 adaptive_pool3d, resize_trilinear, image_resize_short,
                 unfold, bilinear_tensor_product, mul, clip, clip_by_norm,
                 sum, flatten, stack, unstack, split, gather_nd, scatter,
                 scatter_nd_add, pad, pad2d, argmax, argmin, argsort, where,
                 sign, shape, rank, size, pixel_shuffle, multiplex, crop,
                 crop_tensor, space_to_depth, deformable_roi_pooling, hash,
                 continuous_value_model, filter_by_instag, shuffle_channel,
                 merge_selected_rows, get_tensor_from_selected_rows,
                 lod_reset, lod_append, nce, hsigmoid,
                 sampled_softmax_with_cross_entropy, match_matrix_tensor,
                 var_conv_2d, tree_conv, moe)
from .tensor import (create_tensor, create_parameter, create_global_var,
                     fill_constant, fill_constant_batch_size_like, zeros,
                     ones, zeros_like, ones_like, sums, assign, linspace,
                     eye, diag, reverse, has_inf, has_nan, isfinite,
                     scatter_nd, strided_slice, unique, unique_with_counts,
                     shard_index, pad_constant_like, tensor_array_to_tensor,
                     range)
from .ops import *         # noqa: F401,F403
from . import layer_function_generator
from .layer_function_generator import (deprecated, generate_layer_fn,
                                       generate_activation_fn, autodoc,
                                       templatedoc)
from . import control_flow
from .control_flow import (Print, DynamicRNN,
                           reorder_lod_tensor_by_rank,
                           While, Switch, IfElse, StaticRNN, cond, case,
                           switch_case, increment, array_write, array_read,
                           array_length, create_array, less_than, less_equal,
                           greater_than, greater_equal, equal, not_equal,
                           is_empty, autoincreased_step_counter, while_loop)
from .loss import (cross_entropy, softmax_with_cross_entropy,
                   square_error_cost, sigmoid_cross_entropy_with_logits,
                   huber_loss, log_loss, bpr_loss, kldiv_loss, rank_loss,
                   margin_rank_loss, dice_loss, npair_loss, mse_loss,
                   teacher_student_sigmoid_loss, cos_sim, center_loss)
from .metric_op import accuracy, auc, mean_iou, edit_distance, chunk_eval
from . import distributions
from .distributions import (Uniform, Normal, Categorical,
                            MultivariateNormalDiag)
from . import attention
from .attention import (scaled_dot_product_attention, multi_head_attention,
                        add_position_encoding)
from . import sequence
from .sequence import (sequence_mask, sequence_pad, sequence_unpad,
                       sequence_pool, sequence_first_step,
                       sequence_last_step, sequence_softmax,
                       sequence_expand, sequence_expand_as,
                       sequence_reverse, sequence_conv, sequence_concat,
                       sequence_slice, sequence_enumerate, sequence_reshape,
                       sequence_scatter, sequence_topk_avg_pooling)
from . import rnn
from .rnn import (dynamic_lstm, dynamic_lstmp, dynamic_gru, lstm, gru,
                  lstm_unit, gru_unit)
from . import beam_search as beam_search_mod
from .beam_search import beam_search, beam_search_decode
from . import learning_rate_scheduler
from . import detection
from .detection import (prior_box, density_prior_box, box_coder,
                        iou_similarity, multiclass_nms, yolo_box, roi_pool,
                        roi_align, psroi_pool, ssd_loss, multi_box_head,
                        detection_output, yolov3_loss, anchor_generator,
                        bipartite_match, target_assign, box_clip,
                        polygon_box_transform, retinanet_detection_output,
                        sigmoid_focal_loss, distribute_fpn_proposals,
                        collect_fpn_proposals, generate_proposals,
                        rpn_target_assign, retinanet_target_assign,
                        generate_proposal_labels, box_decoder_and_assign,
                        multiclass_nms2, roi_perspective_transform,
                        generate_mask_labels, detection_map)
from .learning_rate_scheduler import (noam_decay, exponential_decay,
                                      natural_exp_decay, inverse_time_decay,
                                      polynomial_decay, piecewise_decay,
                                      cosine_decay, linear_lr_warmup)
from .nn import topk as top_k  # fluid exposes both spellings
from .math_op_patch import monkey_patch_variable

monkey_patch_variable()


def tile(x, repeat_times, name=None):
    """Parity: paddle.tile: x repeated repeat_times[i] times along dim
    i (np.tile)."""
    from ..core.layer_helper import LayerHelper
    helper = LayerHelper("tile", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("tile", {"X": x}, {"Out": out},
                     {"repeat_times": list(repeat_times)})
    return out
