"""SSD-style detection demo and a Faster R-CNN training program.

Parity: the reference's fluid SSD recipe (layers.multi_box_head + ssd_loss
+ detection_output, as exercised by fluid/tests/unittests/test_ssd_loss
and the book's high-level-api detection sample) and its rpn_heads /
fast_rcnn_heads composition; the counterpart of
``paddle_tpu/models/detection_demo.py``, with its signatures and
defaults. A small conv backbone feeds two feature maps into
multi_box_head; training uses ssd_loss over padded ground-truth boxes,
inference detection_output, whose NMS runs on the device in static shape
(``inference.postprocess.multiclass_nms_host`` is the host's
variable-length form).
"""

from .. import layers


def _conv_bn(x, filters, stride=1):
    x = layers.conv2d(x, num_filters=filters, filter_size=3, stride=stride,
                      padding=1, bias_attr=False)
    return layers.batch_norm(x, act="relu")


def backbone(img):
    """Returns two feature maps at 1/8 and 1/16 scale."""
    x = _conv_bn(img, 32, stride=2)
    x = _conv_bn(x, 64, stride=2)
    f1 = _conv_bn(x, 128, stride=2)     # 1/8
    f2 = _conv_bn(f1, 256, stride=2)    # 1/16
    return f1, f2


def build_ssd_net(num_classes=21, image_size=128, max_boxes=8):
    """Returns (img, gt_box, gt_label, loss, locs, confs, box, box_var).

    gt_box (B, max_boxes, 4) normalized xyxy, gt_label (B, max_boxes, 1)
    int64, zero-padded (label 0 = background acts as padding class).
    """
    img = layers.data("img", shape=[3, image_size, image_size],
                      dtype="float32")
    gt_box = layers.data("gt_box", shape=[max_boxes, 4], dtype="float32")
    gt_label = layers.data("gt_label", shape=[max_boxes, 1], dtype="int64")

    f1, f2 = backbone(img)
    locs, confs, box, box_var = layers.multi_box_head(
        inputs=[f1, f2], image=img, base_size=image_size,
        num_classes=num_classes,
        aspect_ratios=[[2.0], [2.0, 3.0]],
        min_sizes=[image_size * 0.2, image_size * 0.4],
        max_sizes=[image_size * 0.4, image_size * 0.7],
        offset=0.5, flip=True)

    loss = layers.ssd_loss(locs, confs, gt_box, gt_label, box, box_var)
    loss = layers.mean(loss)
    return img, gt_box, gt_label, loss, locs, confs, box, box_var


def build_infer_net(num_classes=21, image_size=128):
    """Detection inference graph: decoded boxes and scores, then
    detection_output's multiclass NMS, (N, keep_top_k, 6)."""
    img = layers.data("img", shape=[3, image_size, image_size],
                      dtype="float32")
    f1, f2 = backbone(img)
    locs, confs, box, box_var = layers.multi_box_head(
        inputs=[f1, f2], image=img, base_size=image_size,
        num_classes=num_classes,
        aspect_ratios=[[2.0], [2.0, 3.0]],
        min_sizes=[image_size * 0.2, image_size * 0.4],
        max_sizes=[image_size * 0.4, image_size * 0.7],
        offset=0.5, flip=True)
    nmsed = layers.detection_output(locs, confs, box, box_var)
    return img, nmsed


ANCHOR_SIZES = (16, 32, 48)   # one size per anchor, square (ar 1.0)


def build_faster_rcnn_train(batch=2, num_classes=5, image_size=64,
                            max_gt=4, rpn_samples=32,
                            rcnn_samples=16, post_nms=24):
    """Two-stage Faster-RCNN training head (parity: the reference's
    rpn_heads/fast_rcnn_heads composition over generate_proposals /
    rpn_target_assign / generate_proposal_labels / roi_align).

    The whole pipeline (backbone, RPN losses, the proposals' NMS,
    second-stage sampling, roi_align, cls/reg losses) is one program.
    Returns (img, gt_box, gt_label, im_info, total_loss).
    """
    img = layers.data("img", shape=[batch, 3, image_size, image_size],
                      dtype="float32", append_batch_size=False)
    gt_box = layers.data("gt_box", shape=[batch, max_gt, 4],
                         dtype="float32", append_batch_size=False)
    gt_label = layers.data("gt_label", shape=[batch, max_gt], dtype="int64",
                           append_batch_size=False)
    im_info = layers.data("im_info", shape=[batch, 3], dtype="float32",
                          append_batch_size=False)

    f1, _ = backbone(img)                       # (N, C, H/8, W/8)
    stride = 8
    fh = fw = image_size // stride
    a = len(ANCHOR_SIZES)

    # --- RPN head --------------------------------------------------------
    rpn_feat = _conv_bn(f1, 64)
    rpn_scores = layers.conv2d(rpn_feat, num_filters=a, filter_size=1,
                               act="sigmoid")              # (N, A, H, W)
    rpn_deltas = layers.conv2d(rpn_feat, num_filters=4 * a, filter_size=1)

    # variance=1: rpn_target_assign encodes unnormalized targets, so the
    # proposal decode must not rescale deltas (fluid's Faster-RCNN configs
    # pass exactly this)
    anchor, anchor_var = layers.anchor_generator(
        f1, anchor_sizes=list(ANCHOR_SIZES), aspect_ratios=[1.0],
        variance=[1.0, 1.0, 1.0, 1.0],
        stride=[stride, stride])                            # (H, W, A, 4)

    n = batch
    anchor_flat = layers.reshape(anchor, shape=[-1, 4])
    scores_flat = layers.reshape(
        layers.transpose(rpn_scores, perm=[0, 2, 3, 1]), shape=[n, -1, 1])
    deltas_flat = layers.reshape(
        layers.transpose(
            layers.reshape(rpn_deltas, shape=[n, a, 4, fh, fw]),
            perm=[0, 3, 4, 1, 2]),
        shape=[n, -1, 4])

    sp, lp, tl, tb, iw, sw = layers.rpn_target_assign(
        deltas_flat, scores_flat, anchor_flat, anchor_var,
        gt_box, rpn_batch_size_per_im=rpn_samples)
    rpn_cls_loss = layers.reduce_sum(
        layers.log_loss(sp, layers.cast(tl, "float32"), epsilon=1e-6) * sw
    ) / float(rpn_samples)
    rpn_reg_loss = layers.reduce_sum(
        layers.smooth_l1(layers.reshape(lp * iw, shape=[-1, 4]),
                         layers.reshape(tb * iw, shape=[-1, 4]))
    ) / float(rpn_samples)

    # --- proposals + second stage ---------------------------------------
    rois, _probs = layers.generate_proposals(
        rpn_scores, rpn_deltas, im_info, anchor, anchor_var,
        pre_nms_top_n=64, post_nms_top_n=post_nms,
        nms_thresh=0.7, min_size=4.0)
    s_rois, s_labels, s_tgts, s_iw, s_ow = layers.generate_proposal_labels(
        rois, gt_label, gt_boxes=gt_box,
        batch_size_per_im=rcnn_samples, fg_fraction=0.25, fg_thresh=0.5,
        class_nums=num_classes)

    # roi_align's rois carry a batch-index column: [b, x1, y1, x2, y2]
    bidx = layers.reshape(
        layers.expand(layers.reshape(
            layers.range(0, n, 1, "float32"), shape=[n, 1]),
            expand_times=[1, rcnn_samples]), shape=[-1, 1])
    rois5 = layers.concat(
        [bidx, layers.reshape(s_rois, shape=[-1, 4])], axis=1)
    roi_feat = layers.roi_align(
        f1, rois5, pooled_height=4,
        pooled_width=4, spatial_scale=1.0 / stride)
    flat = layers.reshape(roi_feat, shape=[n * rcnn_samples, -1])
    head = layers.fc(flat, size=128, act="relu")
    cls_logits = layers.fc(head, size=num_classes)
    reg_deltas = layers.fc(head, size=4 * num_classes)

    labels_flat = layers.reshape(s_labels, shape=[-1, 1])
    valid = layers.cast(
        layers.greater_equal(labels_flat,
                             layers.fill_constant([1, 1], "int64", 0)),
        "float32")
    safe_labels = layers.elementwise_max(
        labels_flat, layers.fill_constant([1, 1], "int64", 0))
    cls_loss = layers.reduce_sum(
        layers.softmax_with_cross_entropy(cls_logits, safe_labels) * valid
    ) / float(rcnn_samples)
    reg_w = layers.reshape(s_iw, shape=[-1, 4 * num_classes])
    reg_loss = layers.reduce_sum(layers.smooth_l1(
        reg_deltas * reg_w,
        layers.reshape(s_tgts, shape=[-1, 4 * num_classes]) * reg_w)
    ) / float(rcnn_samples)

    total = rpn_cls_loss + rpn_reg_loss + cls_loss + reg_loss
    return img, gt_box, gt_label, im_info, total
