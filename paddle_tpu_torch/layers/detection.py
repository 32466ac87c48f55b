"""Detection layers.

Parity: python/paddle/fluid/layers/detection.py; the counterpart of
``paddle_tpu/layers/detection.py``, name for name and with its
signatures: the priors and anchors, box_coder, the NMS layers
(multiclass_nms, multiclass_nms2, detection_output,
retinanet_detection_output), the ROI pools, the SSD, YOLOv3, RPN and
Fast R-CNN target and loss layers, the FPN routing and detection_map.
The ops are in ``ops/detection_ops.py`` and ``ops/rcnn_ops.py``.
Variable-length outputs (the NMS keeps, the sampled rois) are
static-shape, padded with -1 rows or zero weights, as in the JAX package.
The layers declare the port's int64 for every integer output.
"""

from ..core.layer_helper import LayerHelper

__all__ = ["roi_perspective_transform", "generate_mask_labels",
           "generate_proposals", "rpn_target_assign",
           "retinanet_target_assign", "generate_proposal_labels",
           "box_decoder_and_assign", "multiclass_nms2",
           "prior_box", "density_prior_box", "box_coder", "iou_similarity",
           "multiclass_nms", "yolo_box", "roi_pool", "roi_align",
           "psroi_pool", "ssd_loss", "multi_box_head", "detection_output",
           "detection_map"]


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=[1.0],
              variance=[0.1, 0.1, 0.2, 0.2], flip=False, clip=False,
              steps=[0.0, 0.0], offset=0.5, name=None,
              min_max_aspect_ratios_order=False):
    helper = LayerHelper("prior_box", name=name)
    boxes = helper.create_variable_for_type_inference(input.dtype)
    variances = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("prior_box", {"Input": input, "Image": image},
                     {"Boxes": boxes, "Variances": variances},
                     {"min_sizes": list(min_sizes),
                      "max_sizes": list(max_sizes or []),
                      "aspect_ratios": list(aspect_ratios),
                      "variances": list(variance), "flip": flip,
                      "clip": clip, "step_w": steps[0], "step_h": steps[1],
                      "offset": offset,
                      "min_max_aspect_ratios_order":
                          min_max_aspect_ratios_order})
    return boxes, variances


def density_prior_box(input, image, densities=None, fixed_sizes=None,
                      fixed_ratios=None, variance=[0.1, 0.1, 0.2, 0.2],
                      clip=False, steps=[0.0, 0.0], offset=0.5,
                      flatten_to_2d=False, name=None):
    helper = LayerHelper("density_prior_box", name=name)
    boxes = helper.create_variable_for_type_inference(input.dtype)
    variances = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("density_prior_box", {"Input": input, "Image": image},
                     {"Boxes": boxes, "Variances": variances},
                     {"densities": list(densities or [1]),
                      "fixed_sizes": list(fixed_sizes or []),
                      "fixed_ratios": list(fixed_ratios or [1.0]),
                      "variances": list(variance), "clip": clip,
                      "step_w": steps[0], "step_h": steps[1],
                      "offset": offset, "flatten_to_2d": flatten_to_2d})
    return boxes, variances


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              axis=0, name=None):
    helper = LayerHelper("box_coder", name=name)
    out = helper.create_variable_for_type_inference(target_box.dtype)
    inputs = {"PriorBox": prior_box, "TargetBox": target_box}
    attrs = {"code_type": code_type.lower(),
             "box_normalized": box_normalized, "axis": axis}
    if prior_box_var is not None:
        if isinstance(prior_box_var, (list, tuple)):
            # reference contract: a python list rides the variance attr
            attrs["variance"] = [float(v) for v in prior_box_var]
        else:
            inputs["PriorBoxVar"] = prior_box_var
    # reference output slot name (box_coder_op.cc): OutputBox
    helper.append_op("box_coder", inputs, {"OutputBox": out}, attrs)
    return out


def iou_similarity(x, y, box_normalized=True, name=None):
    helper = LayerHelper("iou_similarity", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("iou_similarity", {"X": x, "Y": y}, {"Out": out},
                     {"box_normalized": box_normalized})
    return out


def multiclass_nms(bboxes, scores, score_threshold=0.01, nms_top_k=64,
                   keep_top_k=100, nms_threshold=0.3, normalized=True,
                   nms_eta=1.0, background_label=0, name=None):
    """Static-shape NMS: returns (N, keep_top_k, 6) padded with -1."""
    helper = LayerHelper("multiclass_nms", name=name)
    out = helper.create_variable_for_type_inference(bboxes.dtype)
    helper.append_op("multiclass_nms", {"BBoxes": bboxes, "Scores": scores},
                     {"Out": out},
                     {"score_threshold": score_threshold,
                      "nms_top_k": nms_top_k, "keep_top_k": keep_top_k,
                      "nms_threshold": nms_threshold,
                      "background_label": background_label})
    return out


def yolo_box(x, img_size, anchors, class_num, conf_thresh=0.01,
             downsample_ratio=32, clip_bbox=True, name=None):
    helper = LayerHelper("yolo_box", name=name)
    boxes = helper.create_variable_for_type_inference(x.dtype)
    scores = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("yolo_box", {"X": x, "ImgSize": img_size},
                     {"Boxes": boxes, "Scores": scores},
                     {"anchors": list(anchors), "class_num": class_num,
                      "conf_thresh": conf_thresh,
                      "downsample_ratio": downsample_ratio,
                      "clip_bbox": clip_bbox})
    return boxes, scores


def roi_pool(input, rois, pooled_height=1, pooled_width=1, spatial_scale=1.0,
             name=None):
    helper = LayerHelper("roi_pool", name=name)
    out = helper.create_variable_for_type_inference(
        input.dtype, (rois.shape[0], input.shape[1],
                      pooled_height, pooled_width))
    helper.append_op("roi_pool", {"X": input, "ROIs": rois}, {"Out": out},
                     {"pooled_height": pooled_height,
                      "pooled_width": pooled_width,
                      "spatial_scale": spatial_scale})
    return out


def roi_align(input, rois, pooled_height=1, pooled_width=1,
              spatial_scale=1.0, sampling_ratio=-1, name=None):
    helper = LayerHelper("roi_align", name=name)
    out = helper.create_variable_for_type_inference(
        input.dtype, (rois.shape[0], input.shape[1],
                      pooled_height, pooled_width))
    helper.append_op("roi_align", {"X": input, "ROIs": rois}, {"Out": out},
                     {"pooled_height": pooled_height,
                      "pooled_width": pooled_width,
                      "spatial_scale": spatial_scale,
                      "sampling_ratio": sampling_ratio})
    return out


def psroi_pool(input, rois, output_channels, spatial_scale, pooled_height,
               pooled_width, name=None):
    helper = LayerHelper("psroi_pool", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("psroi_pool", {"X": input, "ROIs": rois}, {"Out": out},
                     {"output_channels": output_channels,
                      "spatial_scale": spatial_scale,
                      "pooled_height": pooled_height,
                      "pooled_width": pooled_width})
    return out


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type="per_prediction",
             mining_type="max_negative", normalize=True, sample_size=None,
             name=None):
    helper = LayerHelper("ssd_loss", name=name)
    out = helper.create_variable_for_type_inference(location.dtype)
    helper.append_op("ssd_loss",
                     {"Location": location, "Confidence": confidence,
                      "GtBox": gt_box, "GtLabel": gt_label,
                      "PriorBox": prior_box},
                     {"Out": out},
                     {"overlap_threshold": overlap_threshold,
                      "neg_pos_ratio": neg_pos_ratio,
                      "background_label": background_label})
    return out


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=[0.1, 0.1, 0.2, 0.2], flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """Parity: fluid.layers.multi_box_head — SSD heads over multiple
    feature maps: per-map 3x3 convs predicting loc (4A) + conf (CA), plus
    the matching prior boxes, all flattened and concatenated."""
    from . import nn as nn_layers
    from ..ops.detection_ops import expand_aspect_ratios
    if min_sizes is None:
        # reference formula: evenly spaced ratios between min_ratio/max_ratio
        num_layer = len(inputs)
        min_sizes, max_sizes = [], []
        step = int((max_ratio - min_ratio) / (num_layer - 2))
        min_sizes = [base_size * 0.1]
        max_sizes = [base_size * 0.2]
        for ratio in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
    locs, confs, boxes_all, vars_all = [], [], [], []
    for i, feat in enumerate(inputs):
        ms = min_sizes[i]
        ms = ms if isinstance(ms, (list, tuple)) else [ms]
        Ms = max_sizes[i] if max_sizes else []
        Ms = Ms if isinstance(Ms, (list, tuple)) else [Ms]
        ar = aspect_ratios[i]
        ar = ar if isinstance(ar, (list, tuple)) else [ar]
        box, var = prior_box(feat, image, ms, Ms, ar, variance, flip, clip,
                             steps=[step_w[i] if step_w else 0.0,
                                    step_h[i] if step_h else 0.0],
                             offset=offset, min_max_aspect_ratios_order=(
                                 min_max_aspect_ratios_order))
        # prior_box_op.h:94-97: priors per cell = expanded ratios (1.0
        # leads, dedup, flip) x min sizes + ONE sqrt box per max size.
        num_priors = len(ms) * len(expand_aspect_ratios(ar, flip)) + len(Ms)
        loc = nn_layers.conv2d(feat, num_priors * 4, kernel_size,
                               padding=pad, stride=stride)
        conf = nn_layers.conv2d(feat, num_priors * num_classes, kernel_size,
                                padding=pad, stride=stride)
        # Batch dim is symbolic (-1) at graph-build time; the prior count
        # per map is static (H*W*A), so put -1 only on the batch axis.
        n_boxes = feat.shape[2] * feat.shape[3] * num_priors
        loc = nn_layers.reshape(nn_layers.transpose(loc, [0, 2, 3, 1]),
                                [-1, n_boxes, 4])
        conf = nn_layers.reshape(nn_layers.transpose(conf, [0, 2, 3, 1]),
                                 [-1, n_boxes, num_classes])
        locs.append(loc)
        confs.append(conf)
        boxes_all.append(nn_layers.reshape(box, [-1, 4]))
        vars_all.append(nn_layers.reshape(var, [-1, 4]))
    mbox_locs = nn_layers.concat(locs, axis=1)
    mbox_confs = nn_layers.concat(confs, axis=1)
    boxes = nn_layers.concat(boxes_all, axis=0)
    variances = nn_layers.concat(vars_all, axis=0)
    return mbox_locs, mbox_confs, boxes, variances


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0):
    """Parity: fluid.layers.detection_output — decode + softmax + NMS."""
    from . import nn as nn_layers
    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size")
    probs = nn_layers.softmax(scores, axis=-1)
    probs_t = nn_layers.transpose(probs, [0, 2, 1])  # (N, C, M)
    return multiclass_nms(decoded, probs_t, score_threshold, nms_top_k,
                          keep_top_k, nms_threshold,
                          background_label=background_label)


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, gt_score=None,
                use_label_smooth=True, name=None):
    """Parity: fluid.layers.yolov3_loss."""
    helper = LayerHelper("yolov3_loss", name=name)
    loss = helper.create_variable_for_type_inference(x.dtype,
                                                     (x.shape[0],))
    ins = {"X": x, "GTBox": gt_box, "GTLabel": gt_label}
    if gt_score is not None:
        ins["GTScore"] = gt_score
    helper.append_op("yolov3_loss", ins, {"Loss": loss},
                     {"anchors": list(anchors),
                      "anchor_mask": list(anchor_mask),
                      "class_num": class_num,
                      "ignore_thresh": ignore_thresh,
                      "downsample_ratio": downsample_ratio,
                      "use_label_smooth": use_label_smooth})
    return loss


def anchor_generator(input, anchor_sizes=None, aspect_ratios=None,
                     variance=[0.1, 0.1, 0.2, 0.2], stride=None, offset=0.5,
                     name=None):
    """Parity: fluid.layers.anchor_generator."""
    helper = LayerHelper("anchor_generator", name=name)
    anchor_sizes = list(anchor_sizes or [64.0, 128.0, 256.0, 512.0])
    aspect_ratios = list(aspect_ratios or [0.5, 1.0, 2.0])
    a = len(anchor_sizes) * len(aspect_ratios)
    shape = (input.shape[2], input.shape[3], a, 4)
    anchors = helper.create_variable_for_type_inference("float32", shape)
    variances = helper.create_variable_for_type_inference("float32", shape)
    helper.append_op("anchor_generator", {"Input": input},
                     {"Anchors": anchors, "Variances": variances},
                     {"anchor_sizes": anchor_sizes,
                      "aspect_ratios": aspect_ratios,
                      "variances": list(variance),
                      "stride": list(stride or [16.0, 16.0]),
                      "offset": offset})
    return anchors, variances


def bipartite_match(dist_matrix, match_type=None, dist_threshold=None,
                    name=None):
    """Parity: fluid.layers.bipartite_match."""
    helper = LayerHelper("bipartite_match", name=name)
    idx = helper.create_variable_for_type_inference("int64")
    dist = helper.create_variable_for_type_inference(dist_matrix.dtype)
    helper.append_op("bipartite_match", {"DistMat": dist_matrix},
                     {"ColToRowMatchIndices": idx,
                      "ColToRowMatchDist": dist},
                     {"match_type": match_type or "bipartite",
                      "dist_threshold": (0.5 if dist_threshold is None
                                         else float(dist_threshold))})
    return idx, dist


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=None, name=None):
    """Parity: fluid.layers.target_assign."""
    helper = LayerHelper("target_assign", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    out_wt = helper.create_variable_for_type_inference("float32")
    helper.append_op("target_assign",
                     {"X": input, "MatchIndices": matched_indices},
                     {"Out": out, "OutWeight": out_wt},
                     {"mismatch_value": mismatch_value})
    return out, out_wt


def box_clip(input, im_info, name=None):
    """Parity: fluid.layers.box_clip."""
    helper = LayerHelper("box_clip", name=name)
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op("box_clip", {"Input": input, "ImInfo": im_info},
                     {"Output": out}, {})
    return out


def polygon_box_transform(input, name=None):
    helper = LayerHelper("polygon_box_transform", name=name)
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op("polygon_box_transform", {"Input": input},
                     {"Output": out}, {})
    return out


def retinanet_detection_output(bboxes, scores, im_info=None,
                               score_threshold=0.05, nms_top_k=1000,
                               keep_top_k=100, nms_threshold=0.3,
                               nms_eta=1.0):
    """Parity: fluid.layers.retinanet_detection_output: the levels'
    sigmoid scores through the same in-graph NMS as multiclass_nms."""
    helper = LayerHelper("retinanet_detection_output")
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op("retinanet_detection_output",
                     {"BBoxes": list(bboxes), "Scores": list(scores)},
                     {"Out": out},
                     {"score_threshold": score_threshold,
                      "nms_top_k": nms_top_k, "keep_top_k": keep_top_k,
                      "nms_threshold": nms_threshold})
    return out


def sigmoid_focal_loss(x, label, fg_num=None, gamma=2.0, alpha=0.25):
    """Parity: fluid.layers.sigmoid_focal_loss."""
    helper = LayerHelper("sigmoid_focal_loss")
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    ins = {"X": x, "Label": label}
    if fg_num is not None:
        ins["FgNum"] = fg_num
    helper.append_op("sigmoid_focal_loss", ins, {"Out": out},
                     {"gamma": gamma, "alpha": alpha})
    return out


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, name=None):
    helper = LayerHelper("distribute_fpn_proposals")
    n_lvl = max_level - min_level + 1
    outs = [helper.create_variable_for_type_inference(fpn_rois.dtype)
            for _ in range(n_lvl)]
    idx = helper.create_variable_for_type_inference("int64")
    helper.append_op("distribute_fpn_proposals", {"FpnRois": fpn_rois},
                     {"MultiFpnRois": outs, "RestoreIndex": idx},
                     {"min_level": min_level, "max_level": max_level,
                      "refer_level": refer_level, "refer_scale": refer_scale})
    return outs, idx


def collect_fpn_proposals(multi_rois, multi_scores, min_level, max_level,
                          post_nms_top_n, name=None):
    helper = LayerHelper("collect_fpn_proposals")
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op("collect_fpn_proposals",
                     {"MultiLevelRois": list(multi_rois),
                      "MultiLevelScores": list(multi_scores)},
                     {"FpnRois": out}, {"post_nms_topN": post_nms_top_n})
    return out


def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0, name=None):
    """Parity: fluid.layers.generate_proposals. Static outputs:
    rois (N, post_nms_top_n, 4) padded with -1 rows + probs."""
    helper = LayerHelper("generate_proposals", name=name)
    n = scores.shape[0]
    rois = helper.create_variable_for_type_inference(
        "float32", (n, post_nms_top_n, 4))
    probs = helper.create_variable_for_type_inference(
        "float32", (n, post_nms_top_n, 1))
    helper.append_op("generate_proposals",
                     {"Scores": scores, "BboxDeltas": bbox_deltas,
                      "ImInfo": im_info, "Anchors": anchors,
                      "Variances": variances},
                     {"RpnRois": rois, "RpnRoiProbs": probs},
                     {"pre_nms_topN": pre_nms_top_n,
                      "post_nms_topN": post_nms_top_n,
                      "nms_thresh": nms_thresh, "min_size": min_size})
    return rois, probs


def rpn_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                      gt_boxes, is_crowd=None, im_info=None,
                      rpn_batch_size_per_im=256, rpn_straddle_thresh=0.0,
                      rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, use_random=True):
    """Parity: fluid.layers.rpn_target_assign. Static outputs per image:
    rpn_batch_size_per_im sampled rows; padding rows carry zero weight
    (the LoD-free replacement for the reference's index outputs)."""
    helper = LayerHelper("rpn_target_assign")
    n = gt_boxes.shape[0]
    r = rpn_batch_size_per_im
    c = cls_logits.shape[-1]
    sp = helper.create_variable_for_type_inference("float32", (n, r, c))
    lp = helper.create_variable_for_type_inference("float32", (n, r, 4))
    tl = helper.create_variable_for_type_inference("int64", (n, r, 1))
    tb = helper.create_variable_for_type_inference("float32", (n, r, 4))
    iw = helper.create_variable_for_type_inference("float32", (n, r, 4))
    sw = helper.create_variable_for_type_inference("float32", (n, r, 1))
    helper.append_op("rpn_target_assign",
                     {"BboxPred": bbox_pred, "ClsLogits": cls_logits,
                      "Anchor": anchor_box, "GtBoxes": gt_boxes},
                     {"PredictedScores": sp, "PredictedLocation": lp,
                      "TargetLabel": tl, "TargetBBox": tb,
                      "BBoxInsideWeight": iw, "ScoreWeight": sw},
                     {"rpn_batch_size_per_im": rpn_batch_size_per_im,
                      "rpn_fg_fraction": rpn_fg_fraction,
                      "rpn_positive_overlap": rpn_positive_overlap,
                      "rpn_negative_overlap": rpn_negative_overlap})
    # extension over the reference 5-tuple: `sw` masks padded sample rows
    # (weight 0) — the LoD-free replacement for shrinking index outputs;
    # weight the objectness CE with it.
    return sp, lp, tl, tb, iw, sw


def retinanet_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                            gt_boxes, gt_labels=None, is_crowd=None,
                            im_info=None, num_classes=1,
                            positive_overlap=0.5, negative_overlap=0.4):
    """Parity: fluid.layers.retinanet_target_assign — every anchor is
    labeled (focal loss consumes all); weights carry the fg/valid masks."""
    helper = LayerHelper("retinanet_target_assign")
    n = gt_boxes.shape[0]
    a = anchor_box.shape[0]
    c = cls_logits.shape[-1]
    sp = helper.create_variable_for_type_inference("float32", (n, a, c))
    lp = helper.create_variable_for_type_inference("float32", (n, a, 4))
    tl = helper.create_variable_for_type_inference("int64", (n, a, 1))
    tb = helper.create_variable_for_type_inference("float32", (n, a, 4))
    iw = helper.create_variable_for_type_inference("float32", (n, a, 4))
    sw = helper.create_variable_for_type_inference("float32", (n, a, 1))
    inputs = {"BboxPred": bbox_pred, "ClsLogits": cls_logits,
              "Anchor": anchor_box, "GtBoxes": gt_boxes}
    if gt_labels is not None:
        inputs["GtLabels"] = gt_labels
    helper.append_op("retinanet_target_assign", inputs,
                     {"PredictedScores": sp, "PredictedLocation": lp,
                      "TargetLabel": tl, "TargetBBox": tb,
                      "BBoxInsideWeight": iw, "ScoreWeight": sw},
                     {"retinanet": True,
                      "rpn_positive_overlap": positive_overlap,
                      "rpn_negative_overlap": negative_overlap})
    return sp, lp, tl, tb, iw, sw


def generate_proposal_labels(rpn_rois, gt_classes, is_crowd=None,
                             gt_boxes=None, im_info=None,
                             batch_size_per_im=256, fg_fraction=0.25,
                             fg_thresh=0.25, bg_thresh_hi=0.5,
                             bg_thresh_lo=0.0,
                             bbox_reg_weights=[0.1, 0.1, 0.2, 0.2],
                             class_nums=None, use_random=True,
                             is_cls_agnostic=False, is_cascade_rcnn=False):
    """Parity: fluid.layers.generate_proposal_labels. Static outputs
    (N, batch_size_per_im, ...); label -1 marks padding rows.
    Reference-default knobs: fg_thresh 0.25, bbox_reg_weights
    [0.1, 0.1, 0.2, 0.2]; class_nums has no default (required)."""
    if class_nums is None:
        raise ValueError(
            "generate_proposal_labels: class_nums is required (the "
            "reference default of None fails the same way)")
    helper = LayerHelper("generate_proposal_labels")
    n = rpn_rois.shape[0]
    r = batch_size_per_im
    rois = helper.create_variable_for_type_inference("float32", (n, r, 4))
    labels = helper.create_variable_for_type_inference("int64", (n, r, 1))
    tgts = helper.create_variable_for_type_inference(
        "float32", (n, r, 4 * class_nums))
    iw = helper.create_variable_for_type_inference(
        "float32", (n, r, 4 * class_nums))
    ow = helper.create_variable_for_type_inference(
        "float32", (n, r, 4 * class_nums))
    helper.append_op("generate_proposal_labels",
                     {"RpnRois": rpn_rois, "GtClasses": gt_classes,
                      "GtBoxes": gt_boxes},
                     {"Rois": rois, "LabelsInt32": labels,
                      "BboxTargets": tgts, "BboxInsideWeights": iw,
                      "BboxOutsideWeights": ow},
                     {"batch_size_per_im": batch_size_per_im,
                      "fg_fraction": fg_fraction, "fg_thresh": fg_thresh,
                      "bg_thresh_hi": bg_thresh_hi,
                      "bg_thresh_lo": bg_thresh_lo,
                      "bbox_reg_weights": list(bbox_reg_weights)
                      if bbox_reg_weights else None,
                      "class_nums": class_nums})
    return rois, labels, tgts, iw, ow


def box_decoder_and_assign(prior_box, prior_box_var, target_box, box_score,
                           box_clip=None, name=None):
    """Parity: fluid.layers.box_decoder_and_assign."""
    helper = LayerHelper("box_decoder_and_assign", name=name)
    r, c4 = target_box.shape
    decoded = helper.create_variable_for_type_inference("float32", (r, c4))
    assigned = helper.create_variable_for_type_inference("float32", (r, 4))
    inputs = {"PriorBox": prior_box, "TargetBox": target_box,
              "BoxScore": box_score}
    if prior_box_var is not None:
        inputs["PriorBoxVar"] = prior_box_var
    helper.append_op("box_decoder_and_assign", inputs,
                     {"DecodeBox": decoded, "OutputAssignBox": assigned},
                     {"box_clip": box_clip})
    return decoded, assigned


def multiclass_nms2(bboxes, scores, score_threshold=0.01, nms_top_k=64,
                    keep_top_k=100, nms_threshold=0.3, normalized=True,
                    nms_eta=1.0, background_label=0, return_index=False,
                    name=None):
    """Parity: fluid.layers.multiclass_nms2 — multiclass_nms plus the
    kept-row index channel."""
    helper = LayerHelper("multiclass_nms2", name=name)
    out = helper.create_variable_for_type_inference(bboxes.dtype)
    index = helper.create_variable_for_type_inference("int64")
    helper.append_op("multiclass_nms2",
                     {"BBoxes": bboxes, "Scores": scores},
                     {"Out": out, "Index": index},
                     {"score_threshold": score_threshold,
                      "nms_top_k": nms_top_k, "keep_top_k": keep_top_k,
                      "nms_threshold": nms_threshold,
                      "background_label": background_label})
    if return_index:
        return out, index
    return out


def roi_perspective_transform(input, rois, transformed_height,
                              transformed_width, spatial_scale=1.0):
    """Parity: fluid.layers.roi_perspective_transform. rois (N, R, 8)
    quadrilaterals; returns (N, R, C, th, tw)."""
    helper = LayerHelper("roi_perspective_transform")
    n, c = input.shape[0], input.shape[1]
    r = rois.shape[1]
    out = helper.create_variable_for_type_inference(
        input.dtype, (n, r, c, transformed_height, transformed_width))
    helper.append_op("roi_perspective_transform",
                     {"X": input, "ROIs": rois}, {"Out": out},
                     {"transformed_height": transformed_height,
                      "transformed_width": transformed_width,
                      "spatial_scale": spatial_scale})
    return out


def generate_mask_labels(im_info, gt_classes, is_crowd, gt_segms, rois,
                         labels_int32, num_classes, resolution,
                         poly_lengths=None):
    """Parity: fluid.layers.generate_mask_labels (Mask R-CNN targets).
    Padded form: gt_segms (N, G, P, 2) one polygon per instance +
    poly_lengths (N, G). MaskInt32 is (N, R, num_classes*res*res) with
    -1 = ignore."""
    helper = LayerHelper("generate_mask_labels")
    n, r = rois.shape[0], rois.shape[1]
    mask_rois = helper.create_variable_for_type_inference(
        "float32", (n, r, 4))
    has_mask = helper.create_variable_for_type_inference("int64", (n, r, 1))
    masks = helper.create_variable_for_type_inference(
        "int64", (n, r, num_classes * resolution * resolution))
    inputs = {"ImInfo": im_info, "GtClasses": gt_classes,
              "GtSegms": gt_segms, "Rois": rois,
              "LabelsInt32": labels_int32}
    if is_crowd is not None:
        inputs["IsCrowd"] = is_crowd
    if poly_lengths is not None:
        inputs["PolyLengths"] = poly_lengths
    helper.append_op("generate_mask_labels", inputs,
                     {"MaskRois": mask_rois, "RoiHasMaskInt32": has_mask,
                      "MaskInt32": masks},
                     {"num_classes": num_classes, "resolution": resolution})
    return mask_rois, has_mask, masks


def detection_map(detect_res, label, class_num, background_label=0,
                  overlap_threshold=0.3, evaluate_difficult=True,
                  has_state=None, input_states=None, out_states=None,
                  ap_version="integral"):
    """Parity: fluid.layers.detection_map (ref detection.py:1002): the
    current batch's VOC mAP by the host op detection_map. The reference's
    in-graph accumulator states (PosCount/TruePos/FalsePos) are not
    ported, as in the JAX package."""
    if input_states is not None or out_states is not None:
        raise NotImplementedError(
            "detection_map in-graph accumulator states are not ported: "
            "evaluate each batch, or accumulate the detections on the host "
            "and evaluate them together")
    helper = LayerHelper("detection_map")
    out = helper.create_variable_for_type_inference("float32", (1,))
    helper.append_op("detection_map",
                     {"DetectRes": detect_res, "Label": label},
                     {"MAP": out},
                     {"overlap_threshold": overlap_threshold,
                      "ap_version": ap_version,
                      "class_num": class_num,
                      "background_label": background_label,
                      "evaluate_difficult": evaluate_difficult})
    return out
