"""Metric layers.

Parity: python/paddle/fluid/layers/metric_op.py; the counterpart of
``paddle_tpu/layers/metric_op.py``, every name of it: ``accuracy``,
``auc`` (the streaming ROC AUC over persistable bucket statistics),
``mean_iou``, ``edit_distance`` and ``chunk_eval``. The stateful
evaluators that accumulate these over batches, ``ChunkEvaluator`` and
``EditDistance`` (the JAX package's ``evaluator.py`` and ``metrics.py``),
are ROADMAP item 11, not here.
"""

from ..core.layer_helper import LayerHelper
from .. import initializer as init_mod


def accuracy(input, label, k=1, correct=None, total=None):
    helper = LayerHelper("accuracy")
    topk_out = helper.create_variable_for_type_inference(input.dtype)
    topk_idx = helper.create_variable_for_type_inference("int64")
    helper.append_op("top_k", {"X": input},
                     {"Out": topk_out, "Indices": topk_idx}, {"k": k})
    acc = helper.create_variable_for_type_inference("float32", (1,))
    correct = correct or helper.create_variable_for_type_inference("int32",
                                                                   (1,))
    total = total or helper.create_variable_for_type_inference("int32", (1,))
    helper.append_op("accuracy",
                     {"Out": topk_out, "Indices": topk_idx, "Label": label},
                     {"Accuracy": acc, "Correct": correct, "Total": total})
    return acc


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1):
    """Parity: fluid.layers.auc: the streaming ROC AUC of input's last
    column (P(positive)) against 0/1 labels, over persistable stat_pos /
    stat_neg histograms of num_thresholds + 1 buckets, zeros from the
    startup program, that each run adds its batch to. Returns (auc,
    batch_auc, [stat_pos, stat_neg]); batch_auc is auc, as in the JAX
    package."""
    if str(curve).upper() != "ROC":
        raise NotImplementedError(
            "auc: only curve='ROC' is implemented (the exact rank-"
            "statistic form); the reference's 'PR' curve is not ported")
    helper = LayerHelper("auc")
    n = num_thresholds + 1
    stats = []
    for kind in ("stat_pos", "stat_neg"):
        var = helper.create_or_get_global_variable(
            helper.name + "." + kind, shape=(n,), dtype="float32",
            persistable=True)
        var.stop_gradient = True
        init_mod.ConstantInitializer(0.0)(var)
        stats.append(var)
    auc_out = helper.create_variable_for_type_inference("float32", (1,))
    helper.append_op("auc",
                     {"Predict": input, "Label": label, "StatPos": stats[0],
                      "StatNeg": stats[1]},
                     {"AUC": auc_out, "StatPosOut": stats[0],
                      "StatNegOut": stats[1]},
                     {"curve": curve, "num_thresholds": num_thresholds})
    return auc_out, auc_out, stats


def mean_iou(input, label, num_classes):
    """Parity: fluid.layers.mean_iou: (the mean IoU, each class's wrong
    and correct pixel counts), f32."""
    helper = LayerHelper("mean_iou")
    miou = helper.create_variable_for_type_inference("float32", (1,))
    wrong = helper.create_variable_for_type_inference("float32",
                                                      (num_classes,))
    correct = helper.create_variable_for_type_inference("float32",
                                                        (num_classes,))
    helper.append_op("mean_iou", {"Predictions": input, "Labels": label},
                     {"OutMeanIou": miou, "OutWrong": wrong,
                      "OutCorrect": correct},
                     {"num_classes": num_classes})
    return miou, wrong, correct


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None):
    """Parity: fluid.layers.edit_distance: the Levenshtein distance of
    padded sequences (B, 1) and the sequence count; ignored_tokens are
    erased from both sides first (the sequence_erase op). Returns
    (distance, sequence_num)."""
    helper = LayerHelper("edit_distance")
    if ignored_tokens:
        def _erase(seq, length):
            erased = helper.create_variable_for_type_inference(seq.dtype,
                                                               seq.shape)
            new_len = helper.create_variable_for_type_inference("int64")
            ins_e = {"X": seq}
            if length is not None:
                ins_e["Length"] = length
            helper.append_op("sequence_erase", ins_e,
                             {"Out": erased, "Length": new_len},
                             {"tokens": list(ignored_tokens)})
            return erased, new_len
        input, input_length = _erase(input, input_length)
        label, label_length = _erase(label, label_length)
    out = helper.create_variable_for_type_inference("float32",
                                                    (input.shape[0], 1))
    seq_num = helper.create_variable_for_type_inference("int64", (1,))
    ins = {"Hyps": input, "Refs": label}
    if input_length is not None:
        ins["HypsLength"] = input_length
    if label_length is not None:
        ins["RefsLength"] = label_length
    helper.append_op("edit_distance", ins,
                     {"Out": out, "SequenceNum": seq_num},
                     {"normalized": normalized})
    return out, seq_num


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, seq_length=None):
    """Parity: fluid.layers.chunk_eval: chunk precision, recall and F1
    (IOB: the op reads that scheme, as the JAX op does) and the three
    counts (int64)."""
    helper = LayerHelper("chunk_eval")

    def mk(dtype):
        return helper.create_variable_for_type_inference(dtype, (1,))

    precision, recall, f1 = mk("float32"), mk("float32"), mk("float32")
    n_infer, n_label, n_correct = mk("int64"), mk("int64"), mk("int64")
    ins = {"Inference": input, "Label": label}
    if seq_length is not None:
        ins["SeqLength"] = seq_length
    helper.append_op("chunk_eval", ins,
                     {"Precision": precision, "Recall": recall,
                      "F1-Score": f1, "NumInferChunks": n_infer,
                      "NumLabelChunks": n_label,
                      "NumCorrectChunks": n_correct},
                     {"chunk_scheme": chunk_scheme,
                      "num_chunk_types": num_chunk_types})
    return precision, recall, f1, n_infer, n_label, n_correct
