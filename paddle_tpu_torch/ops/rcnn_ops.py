"""Two-stage detection (RPN / Faster R-CNN) training and proposal ops.

Parity: paddle/fluid/operators/detection/{generate_proposals,
rpn_target_assign,generate_proposal_labels,box_decoder_and_assign,
roi_perspective_transform,generate_mask_labels}_op.* and
fluid.layers.multiclass_nms2; the counterpart of
``paddle_tpu/ops/rcnn_ops.py``, batched over the image axis where JAX
vmaps.

As in the JAX package every output is static-shape, padded with an
explicit validity channel (weights, -1 rows, label -1), the proposal NMS
is ``detection_ops._suppress_sorted``, and sampling without replacement
is a top-k over random priorities. The priorities are drawn from the op's
``OpContext.rng()`` generator, not JAX's ``fold_in`` keys: the streams
differ, so a draw that must choose among more candidates than it has
slots picks another set than JAX's; where every candidate fits, the pick
is the whole set in another order. Nothing is detached: the gradient
reaches the RPN deltas through the proposals' decoded boxes, the sampled
rois and their encoded targets, and ``roi_align``'s sampling points.

Labels (``rpn_target_assign``'s, ``generate_proposal_labels``'),
``multiclass_nms2``'s Index and the mask targets are int64.

Under data parallelism each op runs a rank's images; the anchors must be
replicated.
"""

import torch

from . import register, rows
from .detection_ops import (_needs_replicated, _suppress_sorted,
                            gather_rows, iou_matrix, stable_topk, vec)
from .detection_ops import multiclass_nms as _multiclass_nms


def _decode(anchors, deltas, variances=None):
    """anchors (..., 4) corners, deltas (..., 4) -> boxes (..., 4), pixel
    inclusive (+1 widths, -1 on the far corners); the w/h deltas clamped
    to [-10, 10] before exp."""
    aw = anchors[..., 2] - anchors[..., 0] + 1.0
    ah = anchors[..., 3] - anchors[..., 1] + 1.0
    acx = anchors[..., 0] + 0.5 * aw
    acy = anchors[..., 1] + 0.5 * ah
    if variances is not None:
        deltas = deltas * variances
    cx = acx + deltas[..., 0] * aw
    cy = acy + deltas[..., 1] * ah
    w = aw * torch.exp(torch.clamp(deltas[..., 2], -10.0, 10.0))
    h = ah * torch.exp(torch.clamp(deltas[..., 3], -10.0, 10.0))
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h,
                        cx + 0.5 * w - 1.0, cy + 0.5 * h - 1.0], dim=-1)


def _encode(anchors, gt):
    aw = anchors[..., 2] - anchors[..., 0] + 1.0
    ah = anchors[..., 3] - anchors[..., 1] + 1.0
    acx = anchors[..., 0] + 0.5 * aw
    acy = anchors[..., 1] + 0.5 * ah
    gw = gt[..., 2] - gt[..., 0] + 1.0
    gh = gt[..., 3] - gt[..., 1] + 1.0
    gcx = gt[..., 0] + 0.5 * gw
    gcy = gt[..., 1] + 0.5 * gh
    return torch.stack([(gcx - acx) / aw, (gcy - acy) / ah,
                        torch.log(gw / aw), torch.log(gh / ah)], dim=-1)


def _pad_rows(x, n, value):
    """x (B, K, ...) padded with `value` to (B, n, ...)."""
    k = x.shape[1]
    if k >= n:
        return x
    pad = x.new_full((x.shape[0], n - k) + tuple(x.shape[2:]), value)
    return torch.cat([x, pad], dim=1)


@register("generate_proposals", dp=_needs_replicated("Anchors", "Variances"))
def generate_proposals(ctx):
    """Scores (N, A, H, W), BboxDeltas (N, 4A, H, W), Anchors (H, W, A, 4)
    or (A_total, 4), ImInfo (N, 3): each image's anchors decoded and
    clipped to the image, boxes under min_size x scale dropped, the
    pre_nms_topN best swept by NMS at nms_thresh, the post_nms_topN best
    kept. RpnRois (N, post_nms_topN, 4) padded with -1 rows, RpnRoiProbs
    (N, post_nms_topN, 1) 0 there."""
    scores = ctx.in_("Scores")
    deltas = ctx.in_("BboxDeltas")
    im_info = ctx.in_("ImInfo")
    anchors = ctx.in_("Anchors").reshape(-1, 4)
    variances = ctx.in_("Variances")
    if variances is not None:
        variances = variances.reshape(-1, 4)
    post_n = ctx.attr("post_nms_topN", 1000)
    n, a, h, w = scores.shape
    sc = scores.permute(0, 2, 3, 1).reshape(n, -1)                 # (N, K)
    dl = deltas.reshape(n, a, 4, h, w).permute(0, 3, 4, 1, 2) \
        .reshape(n, -1, 4)
    boxes = _decode(anchors, dl, variances)
    hh, ww = im_info[:, 0:1], im_info[:, 1:2]
    boxes = torch.stack([
        torch.minimum(torch.clamp(boxes[..., 0], min=0), ww - 1),
        torch.minimum(torch.clamp(boxes[..., 1], min=0), hh - 1),
        torch.minimum(torch.clamp(boxes[..., 2], min=0), ww - 1),
        torch.minimum(torch.clamp(boxes[..., 3], min=0), hh - 1)], dim=-1)
    bw = boxes[..., 2] - boxes[..., 0] + 1.0
    bh = boxes[..., 3] - boxes[..., 1] + 1.0
    ms = ctx.attr("min_size", 0.1) * im_info[:, 2:3]
    sc = torch.where((bw >= ms) & (bh >= ms), sc, -1e30)
    k = min(ctx.attr("pre_nms_topN", 6000), sc.shape[1])
    top_sc, order = stable_topk(sc, k)
    cand = gather_rows(boxes, order)                   # already best-first
    keep = _suppress_sorted(cand, top_sc, -1e29,
                            ctx.attr("nms_thresh", 0.5))
    kk = min(post_n, k)
    fin_sc, fin_idx = stable_topk(torch.where(keep, top_sc, -1e30), kk)
    valid = fin_sc > -1e29
    fin_boxes = torch.where(valid[..., None], gather_rows(cand, fin_idx),
                            -1.0)
    probs = torch.where(valid, fin_sc, 0.0)
    return {"RpnRois": _pad_rows(fin_boxes, post_n, -1.0),
            "RpnRoiProbs": _pad_rows(probs, post_n, 0.0)[..., None]}


def _subsample(gen, mask, num):
    """Pick `num` of mask's True entries (B, T) a row uniformly at random:
    the top num of random priorities, -1 off the mask. (idx (B, num),
    picked (B, num)); rows past the mask's count are padding (picked
    False, idx the lowest off-mask entries)."""
    pri = torch.rand(mask.shape, generator=gen, device=mask.device)
    pri = torch.where(mask, pri, -1.0)
    k = min(num, mask.shape[1])
    top, idx = stable_topk(pri, k)
    picked = top > 0.0
    return _pad_rows(idx, num, 0), _pad_rows(picked, num, False)


def _gt_valid(gt):
    return (gt[..., 2] > gt[..., 0]) & (gt[..., 3] > gt[..., 1])


@register("rpn_target_assign", "retinanet_target_assign",
          dp=_needs_replicated("Anchor"))
def rpn_target_assign(ctx):
    """Anchor (A, 4), GtBoxes (N, G, 4), BboxPred (N, A, 4), ClsLogits
    (N, A, C): anchors positive at IoU >= rpn_positive_overlap or as a
    gt's best (within 1e-6), negative under rpn_negative_overlap. Per
    image rpn_batch_size_per_im rows: the fg samples (label 1) then the
    bg (label 0), each row's predictions, encoded target, LocWeight
    (fg rows) and ScoreWeight (real rows; padding 0).

    retinanet (attr): every anchor labeled, no sampling; positives carry
    their gt's class (GtLabels, default 1), ScoreWeight the labeled
    anchors."""
    anchors = ctx.in_("Anchor").reshape(-1, 4)
    gt = ctx.in_("GtBoxes")
    gt_labels = ctx.in_("GtLabels")
    bbox_pred = ctx.in_("BboxPred")
    cls_logits = ctx.in_("ClsLogits")
    rpn_batch = ctx.attr("rpn_batch_size_per_im", 256)
    iou = iou_matrix(anchors, gt)                          # (N, A, G)
    gt_valid = _gt_valid(gt)
    iou = torch.where(gt_valid[:, None, :], iou, 0.0)
    best_iou, best_gt = iou.amax(-1), iou.argmax(-1)
    per_gt_best = torch.where(gt_valid, iou.amax(1), 2.0)
    is_gt_best = (iou >= per_gt_best[:, None, :] - 1e-6) & \
        gt_valid[:, None, :]
    pos = (best_iou >= ctx.attr("rpn_positive_overlap", 0.7)) | \
        is_gt_best.any(-1)
    neg = (best_iou < ctx.attr("rpn_negative_overlap", 0.3)) & ~pos
    tgt = _encode(anchors, gather_rows(gt, best_gt))
    if bool(ctx.attr("retinanet", False)):
        if gt_labels is None:
            labels = torch.ones_like(best_gt)
        else:
            if gt_labels.dim() == 3:
                gt_labels = gt_labels[..., 0]
            labels = torch.gather(gt_labels.long(), 1, best_gt)
        labels = torch.where(pos, labels, 0)
        lw = pos.to(tgt.dtype)
        return {"PredictedScores": cls_logits, "PredictedLocation": bbox_pred,
                "TargetLabel": labels[..., None], "TargetBBox": tgt,
                "BBoxInsideWeight": lw[..., None].expand_as(tgt).contiguous(),
                "ScoreWeight": (pos | neg).to(tgt.dtype)[..., None]}
    num_fg = int(rpn_batch * ctx.attr("rpn_fg_fraction", 0.5))
    gen = ctx.rng()
    fg_idx, fg_ok = _subsample(gen, pos, num_fg)
    bg_idx, bg_ok = _subsample(gen, neg, rpn_batch - num_fg)
    idx = torch.cat([fg_idx, bg_idx], 1)
    ok = torch.cat([fg_ok, bg_ok], 1)
    n = gt.shape[0]
    labels = (torch.arange(rpn_batch, device=idx.device) < num_fg) \
        .long().expand(n, rpn_batch)
    lw = torch.cat([fg_ok, torch.zeros_like(bg_ok)], 1).to(tgt.dtype)
    return {"PredictedScores": gather_rows(cls_logits, idx),
            "PredictedLocation": gather_rows(bbox_pred, idx),
            "TargetLabel": labels[..., None],
            "TargetBBox": gather_rows(tgt, idx),
            "BBoxInsideWeight": lw[..., None].expand(n, rpn_batch, 4)
            .contiguous(),
            "ScoreWeight": ok.to(tgt.dtype)[..., None]}


@register("generate_proposal_labels", dp=rows)
def generate_proposal_labels(ctx):
    """Second-stage sampling. RpnRois (N, R, 4) joined by the gt boxes,
    matched to GtBoxes (N, G, 4) by IoU: fg at >= fg_thresh, bg in
    [bg_thresh_lo, bg_thresh_hi). Per image batch_size_per_im rows, the fg
    samples then the bg: Rois, LabelsInt32 (N, R', 1) (the gt class, 0
    for bg, -1 padding), BboxTargets (the encoded gt over
    bbox_reg_weights, in the label's 4 columns of 4 x class_nums),
    BboxInside/OutsideWeights (1 there on fg rows)."""
    rois = ctx.in_("RpnRois")
    gt_cls = ctx.in_("GtClasses")
    gt = ctx.in_("GtBoxes")
    per_im = ctx.attr("batch_size_per_im", 256)
    fg_thresh = ctx.attr("fg_thresh", 0.5)
    num_classes = ctx.attr("class_nums", 81)
    reg_w = vec(ctx.attr("bbox_reg_weights") or [0.1, 0.1, 0.2, 0.2], rois)
    cand = torch.cat([rois, gt], dim=1)
    valid = _gt_valid(cand)
    iou = torch.where(_gt_valid(gt)[:, None, :], iou_matrix(cand, gt), 0.0)
    best, best_gt = iou.amax(-1), iou.argmax(-1)
    fg = (best >= fg_thresh) & valid
    bg = (best < ctx.attr("bg_thresh_hi", 0.5)) & \
        (best >= ctx.attr("bg_thresh_lo", 0.0)) & valid & ~fg
    num_fg = int(per_im * ctx.attr("fg_fraction", 0.25))
    gen = ctx.rng()
    fg_idx, fg_ok = _subsample(gen, fg, num_fg)
    bg_idx, bg_ok = _subsample(gen, bg, per_im - num_fg)
    idx = torch.cat([fg_idx, bg_idx], 1)
    ok = torch.cat([fg_ok, bg_ok], 1)
    matched = torch.gather(best_gt, 1, idx)
    lab = torch.where(torch.arange(per_im, device=idx.device) < num_fg,
                      torch.gather(gt_cls.long(), 1, matched), 0)
    lab = torch.where(ok, lab, -1)
    sampled = gather_rows(cand, idx)
    tgt = _encode(sampled, gather_rows(gt, matched)) / reg_w
    n = rois.shape[0]
    onehot = (torch.clamp(lab, min=0)[..., None] == torch.arange(
        num_classes, device=lab.device)).to(tgt.dtype)       # (N, R', C)
    expanded = (onehot[..., None] * tgt[:, :, None, :]).reshape(
        n, per_im, 4 * num_classes)
    fg_mask = (lab > 0).to(tgt.dtype)
    wts = (onehot * fg_mask[..., None])[..., None].expand(
        n, per_im, num_classes, 4).reshape(n, per_im, 4 * num_classes)
    return {"Rois": sampled, "LabelsInt32": lab[..., None],
            "BboxTargets": expanded, "BboxInsideWeights": wts,
            "BboxOutsideWeights": wts}


@register("box_decoder_and_assign", dp=_needs_replicated("PriorBoxVar"))
def box_decoder_and_assign(ctx):
    """PriorBox (R, 4), TargetBox (R, 4C) per-class deltas, BoxScore
    (R, C): every class's box decoded (the w/h deltas clamped at box_clip),
    DecodeBox (R, 4C), and OutputAssignBox (R, 4) the best class's."""
    prior = ctx.in_("PriorBox")
    prior_var = ctx.in_("PriorBoxVar")
    deltas = ctx.in_("TargetBox")
    r, c4 = deltas.shape
    d = deltas.reshape(r, c4 // 4, 4)
    if prior_var is not None:
        d = d * prior_var.reshape(1, 1, 4)
    clip = ctx.attr("box_clip")
    if clip is not None and clip > 0:
        d = torch.cat([d[..., :2], torch.clamp(d[..., 2:], max=clip)], -1)
    decoded = _decode(prior[:, None, :], d)                 # (R, C, 4)
    best = torch.argmax(ctx.in_("BoxScore"), dim=1)
    assigned = torch.gather(decoded, 1, best[:, None, None].expand(r, 1, 4))
    return {"DecodeBox": decoded.reshape(r, c4),
            "OutputAssignBox": assigned[:, 0]}


@register("multiclass_nms2", dp=rows)
def multiclass_nms2(ctx):
    """multiclass_nms and the Index channel (N, K, 1): the JAX package's
    per-image rank of each kept row, -1 on padding (int64)."""
    out = _multiclass_nms(ctx)["Out"]
    k = out.shape[1]
    rank = torch.where(out[:, :, 0] >= 0,
                       torch.arange(k, device=out.device), -1)
    return {"Out": out, "Index": rank[..., None]}


@register("roi_perspective_transform", dp=rows)
def roi_perspective_transform(ctx):
    """X (N, C, H, W), ROIs (N, R, 8) quads (x1 y1 .. x4 y4, clockwise from
    the top-left) -> (N, R, C, transformed_height, transformed_width):
    each quad warped by the rect->quad homography (all of them one batched
    8 x 8 solve), bilinear samples, 0 outside the map."""
    x = ctx.in_("X").to(torch.float32)
    rois = ctx.in_("ROIs").to(torch.float32)
    th = ctx.attr("transformed_height")
    tw = ctx.attr("transformed_width")
    n, c, h, w = x.shape
    r = rois.shape[1]
    dst = rois.reshape(n, r, 4, 2) * ctx.attr("spatial_scale", 1.0)
    src = ((0.0, 0.0), (tw - 1.0, 0.0), (tw - 1.0, th - 1.0),
           (0.0, th - 1.0))
    zero = torch.zeros_like(dst[..., 0, 0])
    one = torch.ones_like(zero)
    rows_ = []
    for i, (sx, sy) in enumerate(src):
        dx, dy = dst[..., i, 0], dst[..., i, 1]
        rows_.append(torch.stack([zero + sx, zero + sy, one, zero, zero,
                                  zero, -dx * sx, -dx * sy], -1))
        rows_.append(torch.stack([zero, zero, zero, zero + sx, zero + sy,
                                  one, -dy * sx, -dy * sy], -1))
    a = torch.stack(rows_, -2)                              # (N, R, 8, 8)
    bvec = dst.reshape(n, r, 8)
    eye = torch.eye(8, dtype=a.dtype, device=a.device)
    # solve_ex: no check of the result on the host (solve would sync)
    hvec = torch.linalg.solve_ex(a + 1e-8 * eye, bvec)[0]
    hm = torch.cat([hvec, one[..., None]], -1).reshape(n, r, 3, 3)
    ys, xs = torch.meshgrid(
        torch.arange(th, dtype=torch.float32, device=x.device),
        torch.arange(tw, dtype=torch.float32, device=x.device),
        indexing="ij")
    grid = torch.stack([xs.reshape(-1), ys.reshape(-1),
                        torch.ones(th * tw, device=x.device)])  # (3, P)
    pts = hm @ grid                                          # (N, R, 3, P)
    za = torch.clamp(torch.abs(pts[:, :, 2]), min=1e-8)
    zs = torch.sign(pts[:, :, 2])
    px = pts[:, :, 0] / za * zs
    py = pts[:, :, 1] / za * zs
    x0, y0 = torch.floor(px), torch.floor(py)
    fx, fy = (px - x0)[:, :, None], (py - y0)[:, :, None]
    x0i = torch.clamp(x0.long(), 0, w - 1)
    y0i = torch.clamp(y0.long(), 0, h - 1)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    flat = x.reshape(n, 1, c, h * w).expand(n, r, c, h * w)

    def at(yi, xi):
        return torch.gather(flat, 3, (yi * w + xi)[:, :, None].expand(
            n, r, c, th * tw))

    v = (at(y0i, x0i) * (1 - fx) * (1 - fy) + at(y0i, x1i) * fx * (1 - fy)
         + at(y1i, x0i) * (1 - fx) * fy + at(y1i, x1i) * fx * fy)
    inb = (px >= 0) & (px <= w - 1) & (py >= 0) & (py <= h - 1)
    v = v * inb[:, :, None]
    return {"Out": v.reshape(n, r, c, th, tw)}


@register("generate_mask_labels", dp=rows)
def generate_mask_labels(ctx):
    """Mask R-CNN mask targets in the JAX package's padded form: GtSegms
    (N, G, P, 2) one polygon an instance (PolyLengths (N, G) valid points),
    Rois (N, R, 4) in the resized image, LabelsInt32 (N, R, 1). Each fg
    roi's best same-class instance (IoU of the polygon's box; crowd
    instances and polygons under 3 points never) is rasterized on the
    roi's resolution^2 grid by even-odd ray casting. MaskRois (the rois
    over im_scale), RoiHasMaskInt32 (N, R, 1), MaskInt32 (N, R,
    num_classes res^2): {0, 1} in the roi's class slice, -1 elsewhere
    (int64)."""
    im_info = ctx.in_("ImInfo")
    gt_classes = ctx.in_("GtClasses")
    segs = ctx.in_("GtSegms").to(torch.float32)
    plen = ctx.in_("PolyLengths")
    rois = ctx.in_("Rois")
    labels = ctx.in_("LabelsInt32")
    if labels.dim() == 3:
        labels = labels[..., 0]
    labels = labels.long()
    num_classes = ctx.attr("num_classes", 81)
    res = ctx.attr("resolution", 14)
    n, g, p, _ = segs.shape
    dev = segs.device
    if plen is None:
        plen = torch.full((n, g), p, dtype=torch.int64, device=dev)
    is_crowd = ctx.in_("IsCrowd")
    if is_crowd is None:
        is_crowd = torch.zeros((n, g), dtype=torch.int64, device=dev)
    elif is_crowd.dim() == 3:
        is_crowd = is_crowd[..., 0]
    rois = rois / torch.clamp(im_info[:, 2], min=1e-8)[:, None, None]
    pvalid = torch.arange(p, device=dev)[None, None, :] < plen[..., None]
    inf = float("inf")
    gt_boxes = torch.stack([
        torch.where(pvalid, segs[..., 0], inf).amin(-1),
        torch.where(pvalid, segs[..., 1], inf).amin(-1),
        torch.where(pvalid, segs[..., 0], -inf).amax(-1),
        torch.where(pvalid, segs[..., 1], -inf).amax(-1)], dim=-1)
    iou = iou_matrix(rois, gt_boxes)                            # (N, R, G)
    ok_gt = (labels[:, :, None] == gt_classes.long()[:, None, :]) & \
        (plen[:, None, :] >= 3) & (is_crowd[:, None, :] == 0)
    iou = torch.where(ok_gt, iou, -1.0)
    best = iou.argmax(-1)                                       # (N, R)
    has_mask = (labels > 0) & (iou.amax(-1) > 0)
    # the matched polygon of every roi, rasterized
    poly = gather_rows(segs, best)                              # (N,R,P,2)
    m = torch.gather(plen.long(), 1, best)                      # (N, R)
    x0, y0, x1, y1 = rois.unbind(-1)
    cells = (torch.arange(res, dtype=torch.float32, device=dev) + 0.5) / res
    xs = x0[..., None] + cells * torch.clamp(x1 - x0, min=1e-3)[..., None]
    ys = y0[..., None] + cells * torch.clamp(y1 - y0, min=1e-3)[..., None]
    r = rois.shape[1]
    px = xs[..., None, :].expand(n, r, res, res).reshape(n, r, res * res)
    py = ys[..., :, None].expand(n, r, res, res).reshape(n, r, res * res)
    idx = torch.arange(p, device=dev)
    nxt = torch.where(idx + 1 < m[..., None], idx + 1, 0)       # (N, R, P)
    ax, ay = poly[..., 0], poly[..., 1]
    bx, by = torch.gather(ax, -1, nxt), torch.gather(ay, -1, nxt)
    evalid = (idx < m[..., None])[..., None]
    qy = py[..., None, :]
    cond = (ay[..., None] > qy) != (by[..., None] > qy)
    den = by - ay
    den = torch.where(torch.abs(den) < 1e-12, 1e-12, den)
    t = (qy - ay[..., None]) / den[..., None]
    xint = ax[..., None] + t * (bx - ax)[..., None]
    cross = cond & (px[..., None, :] < xint) & evalid
    inside = cross.sum(-2) % 2                                  # (N, R, res2)
    cls = torch.clamp(labels, 0, num_classes - 1)
    slot = torch.arange(num_classes, device=dev) == cls[..., None]
    full = torch.where(slot[..., None], inside[..., None, :], -1)
    masks = torch.where(has_mask[..., None],
                        full.reshape(n, r, num_classes * res * res), -1)
    return {"MaskRois": rois, "RoiHasMaskInt32": has_mask.long()[..., None],
            "MaskInt32": masks}
