"""Beam-search layers.

Parity: fluid.layers.beam_search / beam_search_decode
(python/paddle/fluid/layers/nn.py + operators/beam_search_op.cc); the
counterpart of ``paddle_tpu/layers/beam_search.py``: dense (batch, beam)
lanes, finished beams frozen (ops/beam_search_ops.py).
"""

from ..core.layer_helper import LayerHelper

__all__ = ["beam_search", "beam_search_decode"]


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, name=None,
                return_parent_idx=False):
    """One expansion step (the reference's argument order: name before
    return_parent_idx). scores: (B*K, V) probabilities. Returns
    (selected_ids (B*K, 1), selected_scores (B*K, 1)), and parent_idx
    (B*K,) with return_parent_idx."""
    helper = LayerHelper("beam_search", name=name)
    sel_ids = helper.create_variable_for_type_inference(
        "int64", (scores.shape[0], 1))
    sel_scores = helper.create_variable_for_type_inference(
        scores.dtype, (scores.shape[0], 1))
    parent = helper.create_variable_for_type_inference(
        "int32", (scores.shape[0],))
    helper.append_op(
        "beam_search",
        {"PreIds": pre_ids, "PreScores": pre_scores, "Ids": ids,
         "Scores": scores},
        {"SelectedIds": sel_ids, "SelectedScores": sel_scores,
         "ParentIdx": parent},
        {"beam_size": beam_size, "end_id": end_id})
    if return_parent_idx:
        return sel_ids, sel_scores, parent
    return sel_ids, sel_scores


def beam_search_decode(ids, parent_idx, scores, beam_size, end_id, name=None):
    """Backtrack stacked step outputs. ids/parent_idx: (T, B, K);
    scores: (B, K). Returns (sentence_ids (B, K, T), sentence_scores)."""
    helper = LayerHelper("beam_search_decode", name=name)
    t, b, k = ids.shape
    sent_ids = helper.create_variable_for_type_inference("int64", (b, k, t))
    sent_scores = helper.create_variable_for_type_inference(
        scores.dtype, (b, k))
    helper.append_op(
        "beam_search_decode",
        {"Ids": ids, "ParentIdx": parent_idx, "Scores": scores},
        {"SentenceIds": sent_ids, "SentenceScores": sent_scores},
        {"beam_size": beam_size, "end_id": end_id})
    return sent_ids, sent_scores
