"""Detection ops.

Parity: paddle/fluid/operators/detection/{iou_similarity,box_coder,
box_clip,prior_box,density_prior_box,anchor_generator,
polygon_box_transform,multiclass_nms,retinanet_detection_output,yolo_box,
bipartite_match,target_assign,yolov3_loss,roi_align,roi_pool,psroi_pool,
deformable_psroi_pooling,distribute_fpn_proposals,collect_fpn_proposals,
detection_map}_op.* and fluid.layers.ssd_loss; the counterpart of
``paddle_tpu/ops/detection_ops.py``, op for op, batched over the image
axis where JAX vmaps.

Every output is static-shape: the NMS keeps (N, keep_top_k, 6) rows
[class, score, x1, y1, x2, y2] padded with -1, as the JAX package does in
place of the reference's LoD output. Selection ranks with
``stable_topk``, a stable descending sort and a slice, so that equal
values (the -1 padding, masked priorities) come out lowest index first,
as ``lax.top_k`` gives them; ``torch.topk`` fixes no tie order on CUDA.
The NMS sweep (``_suppress_sorted``) is one loop over the K candidates on
the device, batched over every (image, class) pair: two launches a
candidate, no host read. ``detection_map`` is the one host op: the VOC
mAP in numpy on the host copies, one sync a call, counted in
``HOST_SYNCS``.

Integer outputs (``bipartite_match``'s indices, the ROI pool's Argmax,
``distribute_fpn_proposals``' restore index and counts) are int64.

Under data parallelism the per-image ops run a rank's rows. The priors
and anchors depend on the shapes of their inputs alone and come out
replicated. An op that reads across the batch refuses a sharded input
and names itself: ``detection_map``, ``distribute_fpn_proposals`` and
``collect_fpn_proposals`` (global orders over the rois), and the ROI
pools while their feature map is sharded (a roi's batch index addresses
the global batch).
"""

import math
import warnings

import numpy as np
import torch

from . import refuses, register, rows, rows_if
from .nn_ops import _pair

# host syncs made by the ops of this module (detection_map's copies)
HOST_SYNCS = 0


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def stable_topk(x, k):
    """The k largest entries of x along its last dim, largest first, and
    their indices; equal values in index order (``lax.top_k``'s)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def vec(values, like):
    """A 1-D tensor of python numbers on like's device and dtype, made
    there (a copy from the host would be a sync on CUDA)."""
    return torch.stack([like.new_full((), float(v)) for v in values])


def gather_rows(x, idx):
    """x (B, T, ...) at idx (B, K) along dim 1: (B, K, ...)."""
    shape = idx.shape + x.shape[2:]
    full = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(shape)
    return torch.gather(x, 1, full)


def iou_matrix(a, b):
    """(..., M, 4) x (..., G, 4) xyxy -> (..., M, G) IoU (no +1)."""
    ix1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    iy1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    ix2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    iy2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    aa = torch.clamp(a[..., 2] - a[..., 0], min=0) * \
        torch.clamp(a[..., 3] - a[..., 1], min=0)
    ab = torch.clamp(b[..., 2] - b[..., 0], min=0) * \
        torch.clamp(b[..., 3] - b[..., 1], min=0)
    return inter / torch.clamp(aa[..., :, None] + ab[..., None, :] - inter,
                               min=1e-10)


def _to_int(v):
    if isinstance(v, (list, tuple)):
        return int(v[0])
    return int(v)


def _round_away(x):
    """std::round: half away from zero (torch.round is half to even)."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def _replicated_by_shape(impl, ctxs, walk):
    """The dp rule of the priors and anchors: they depend on their
    inputs' shapes alone, which every rank shares, so the op runs once
    and its outputs are replicated."""
    return impl(ctxs[0])


def _needs_replicated(*slots):
    """``rows`` behind a check that each of `slots` is replicated (the
    priors a rank's rows are matched against, a feature map indexed by a
    global batch index)."""
    def check(ctx, walk):
        for slot in slots:
            if ctx.is_sharded(slot):
                return (f"its {slot} is dp-sharded; each rank's rows need "
                        f"all of it")
        return None
    return rows_if(check)


def _rank3(slot):
    def check(ctx, walk):
        if ctx.in_(slot).dim() < 3:
            return f"its {slot} has no batch axis (rank 2)"
        return None
    return rows_if(check)


# ---------------------------------------------------------------------------
# box geometry
# ---------------------------------------------------------------------------

@register("iou_similarity", dp=_needs_replicated("Y"))
def iou_similarity(ctx):
    """X (N, 4) against Y (M, 4): (N, M) IoU. box_normalized=False means
    inclusive pixel corners, +1 on every width and height."""
    x, y = ctx.in_("X"), ctx.in_("Y")
    one = 0.0 if ctx.attr("box_normalized", True) else 1.0
    area_x = (x[:, 2] - x[:, 0] + one) * (x[:, 3] - x[:, 1] + one)
    area_y = (y[:, 2] - y[:, 0] + one) * (y[:, 3] - y[:, 1] + one)
    lt = torch.maximum(x[:, None, :2], y[None, :, :2])
    rb = torch.minimum(x[:, None, 2:], y[None, :, 2:])
    wh = torch.clamp(rb - lt + one, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return {"Out": inter / torch.clamp(area_x[:, None] + area_y[None, :]
                                       - inter, min=1e-10)}


@register("box_coder", dp=_needs_replicated("PriorBox", "PriorBoxVar"))
def box_coder(ctx):
    """Encode: every target (N) against every prior (M), center-size
    offsets over the prior's size, scaled by 1/variance: (N, M, 4).
    Decode: cx = var d pw + pcx, w = pw exp(var d), the priors along the
    target's dim 1 (axis 0) or dim 0 (axis 1); a 2-D target pairs row i
    with prior i. box_normalized=False adds +1 to widths and takes it off
    the decoded far corners. Variances come from PriorBoxVar or the
    `variance` attr (both optional)."""
    prior = ctx.in_("PriorBox")
    target = ctx.in_("TargetBox")
    code_type = ctx.attr("code_type", "encode_center_size")
    one = 0.0 if bool(ctx.attr("box_normalized", True)) else 1.0
    axis = ctx.attr("axis", 0)
    var = None
    if ctx.has_in("PriorBoxVar"):
        var = ctx.in_("PriorBoxVar")
    elif ctx.attr("variance", None):
        var = vec(ctx.attr("variance"), prior).reshape(1, 4)
    pw = prior[:, 2] - prior[:, 0] + one
    ph = prior[:, 3] - prior[:, 1] + one
    pcx = prior[:, 0] + 0.5 * pw
    pcy = prior[:, 1] + 0.5 * ph
    if code_type == "encode_center_size":
        tw = target[:, 2] - target[:, 0] + one
        th = target[:, 3] - target[:, 1] + one
        tcx = target[:, 0] + 0.5 * tw
        tcy = target[:, 1] + 0.5 * th
        out = torch.stack(
            [(tcx[:, None] - pcx[None, :]) / pw[None, :],
             (tcy[:, None] - pcy[None, :]) / ph[None, :],
             torch.log(torch.abs(tw[:, None] / pw[None, :])),
             torch.log(torch.abs(th[:, None] / ph[None, :]))], dim=-1)
        if var is not None:
            out = out / var[None, :, :]
        return {"OutputBox": out}
    d = target
    squeeze_2d = d.dim() == 2
    if squeeze_2d:
        d = d[None]
        axis = 0
    pshape = [1, 1]
    pshape[1 - axis] = -1
    pw_b, ph_b = pw.reshape(pshape), ph.reshape(pshape)
    pcx_b, pcy_b = pcx.reshape(pshape), pcy.reshape(pshape)
    if var is not None:
        v = var.reshape(1, 1, 4) if var.shape[0] == 1 else \
            var.reshape(pshape + [4])
        d = d * v
    cx = pcx_b + d[..., 0] * pw_b
    cy = pcy_b + d[..., 1] * ph_b
    w = pw_b * torch.exp(d[..., 2])
    h = ph_b * torch.exp(d[..., 3])
    out = torch.stack([cx - 0.5 * w, cy - 0.5 * h,
                       cx + 0.5 * w - one, cy + 0.5 * h - one], dim=-1)
    return {"OutputBox": out[0] if squeeze_2d else out}


@register("box_clip", dp=_rank3("Input"))
def box_clip(ctx):
    """Boxes (B, M, 4) clamped to each image's [0, w-1] x [0, h-1]
    (ImInfo rows h, w, scale); a 2-D (M, 4) input takes image 0's."""
    boxes = ctx.in_("Input")
    im_info = ctx.in_("ImInfo")
    h = im_info[:, 0] - 1.0
    w = im_info[:, 1] - 1.0
    if boxes.dim() == 3:
        h, w = h[:, None], w[:, None]
    else:
        h, w = h[0], w[0]
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    out = torch.stack([
        torch.minimum(torch.maximum(boxes[..., 0], zero), w),
        torch.minimum(torch.maximum(boxes[..., 1], zero), h),
        torch.minimum(torch.maximum(boxes[..., 2], zero), w),
        torch.minimum(torch.maximum(boxes[..., 3], zero), h)], dim=-1)
    return {"Output": out, "Out": out}


@register("polygon_box_transform", dp=rows)
def polygon_box_transform(ctx):
    """Quad offsets (N, 8, H, W) -> absolute coords: 4 x the cell's x (even
    channels) or y (odd) minus the offset (OCR EAST)."""
    x = ctx.in_("Input")
    n, c, h, w = x.shape
    gx = torch.arange(w, dtype=x.dtype, device=x.device)[None, :] \
        .expand(h, w) * 4.0
    gy = torch.arange(h, dtype=x.dtype, device=x.device)[:, None] \
        .expand(h, w) * 4.0
    base = torch.stack([gx, gy] * (c // 2))
    out = base[None] - x
    return {"Output": out, "Out": out}


def expand_aspect_ratios(ars, flip):
    """prior_box_op.h:28 ExpandAspectRatios: 1.0 always leads,
    near-duplicates (eps 1e-6) are dropped, flip appends 1/ar."""
    out = [1.0]
    for ar in ars:
        if any(abs(ar - e) < 1e-6 for e in out):
            continue
        out.append(ar)
        if flip:
            out.append(1.0 / ar)
    return out


def _cell_centers(h, w, sh, sw, offset, like):
    """(H, W) grids of the cells' centers, (i + offset) x step."""
    cx = (torch.arange(w, dtype=torch.float32, device=like.device)
          + offset) * sw
    cy = (torch.arange(h, dtype=torch.float32, device=like.device)
          + offset) * sh
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    return cxg, cyg


def _steps(ctx, h, w, img_h, img_w):
    """prior_box_op.h:85: either step being zero discards both and falls
    back to the image / feature ratio."""
    step_w, step_h = ctx.attr("step_w", 0.0), ctx.attr("step_h", 0.0)
    if step_w == 0 or step_h == 0:
        return img_w / w, img_h / h
    return step_w, step_h


def _with_variances(priors, variances):
    return priors, vec(variances, priors).expand(priors.shape).contiguous()


@register("prior_box", dp=_replicated_by_shape)
def prior_box(ctx):
    """prior_box_op.h:53-170: per cell, per min_sizes[s], every expanded
    aspect ratio then ONE sqrt(min_sizes[s] max_sizes[s]) square (paired by
    index); min_max_aspect_ratios_order puts min, max, then the non-1
    ratios. Boxes and Variances (H, W, num_priors, 4), normalized."""
    inp, image = ctx.in_("Input"), ctx.in_("Image")
    min_sizes = ctx.attr("min_sizes")
    max_sizes = ctx.attr("max_sizes", []) or []
    full_ars = expand_aspect_ratios(ctx.attr("aspect_ratios", [1.0]),
                                    ctx.attr("flip", False))
    h, w = inp.shape[2], inp.shape[3]
    img_h, img_w = image.shape[2], image.shape[3]
    sw, sh = _steps(ctx, h, w, img_h, img_w)
    if max_sizes and len(max_sizes) != len(min_sizes):
        raise ValueError(
            "prior_box: max_sizes pairs with min_sizes by index "
            f"(got {len(min_sizes)} min_sizes, {len(max_sizes)} max_sizes)")
    boxes = []
    for s, ms in enumerate(min_sizes):
        ratio_boxes = [(ms * ar ** 0.5 / 2.0, ms / ar ** 0.5 / 2.0)
                       for ar in full_ars]
        if ctx.attr("min_max_aspect_ratios_order", False):
            boxes.append((ms / 2.0, ms / 2.0))
            if max_sizes:
                sq = (ms * max_sizes[s]) ** 0.5 / 2.0
                boxes.append((sq, sq))
            boxes += [b for ar, b in zip(full_ars, ratio_boxes)
                      if abs(ar - 1.0) >= 1e-6]
        else:
            boxes += ratio_boxes
            if max_sizes:
                sq = (ms * max_sizes[s]) ** 0.5 / 2.0
                boxes.append((sq, sq))
    cxg, cyg = _cell_centers(h, w, sh, sw, ctx.attr("offset", 0.5), inp)
    priors = torch.stack([torch.stack(
        [(cxg - bw) / img_w, (cyg - bh) / img_h,
         (cxg + bw) / img_w, (cyg + bh) / img_h], dim=-1)
        for bw, bh in boxes], dim=2)
    if ctx.attr("clip", False):
        priors = torch.clamp(priors, 0.0, 1.0)
    priors, var = _with_variances(
        priors, ctx.attr("variances", [0.1, 0.1, 0.2, 0.2]))
    return {"Boxes": priors, "Variances": var}


@register("density_prior_box", dp=_replicated_by_shape)
def density_prior_box(ctx):
    """density_prior_box_op.h:69-109: dense grids of fixed-size priors a
    cell (PyramidBox). One integer step_average drives both axes, the
    shift is step_average // density, and every coordinate is clamped to
    [0, 1] (`clip` adds a second, redundant clamp)."""
    inp, image = ctx.in_("Input"), ctx.in_("Image")
    fixed_sizes = ctx.attr("fixed_sizes", [])
    fixed_ratios = ctx.attr("fixed_ratios", [1.0])
    densities = ctx.attr("densities", [1])
    h, w = inp.shape[2], inp.shape[3]
    img_h, img_w = image.shape[2], image.shape[3]
    sw, sh = _steps(ctx, h, w, img_h, img_w)
    if len(densities) != len(fixed_sizes):
        raise ValueError(
            "density_prior_box: densities pairs with fixed_sizes by index "
            f"(got {len(fixed_sizes)} fixed_sizes, {len(densities)} "
            f"densities)")
    step_average = int((sw + sh) * 0.5)
    cxg, cyg = _cell_centers(h, w, sh, sw, ctx.attr("offset", 0.5), inp)
    out = []
    for size, density in zip(fixed_sizes, densities):
        shift = step_average // density
        for ratio in fixed_ratios:
            bw, bh = size * (ratio ** 0.5), size / (ratio ** 0.5)
            for di in range(density):
                for dj in range(density):
                    ccx = cxg - step_average / 2.0 + shift / 2.0 + dj * shift
                    ccy = cyg - step_average / 2.0 + shift / 2.0 + di * shift
                    out.append(torch.stack(
                        [torch.clamp((ccx - bw / 2.0) / img_w, min=0.0),
                         torch.clamp((ccy - bh / 2.0) / img_h, min=0.0),
                         torch.clamp((ccx + bw / 2.0) / img_w, max=1.0),
                         torch.clamp((ccy + bh / 2.0) / img_h, max=1.0)],
                        dim=-1))
    priors = torch.stack(out, dim=2)
    if ctx.attr("clip", False):
        priors = torch.clamp(priors, 0.0, 1.0)
    priors, var = _with_variances(
        priors, ctx.attr("variances", [0.1, 0.1, 0.2, 0.2]))
    if ctx.attr("flatten_to_2d", False):
        priors, var = priors.reshape(-1, 4), var.reshape(-1, 4)
    return {"Boxes": priors, "Variances": var}


@register("anchor_generator", dp=_replicated_by_shape)
def anchor_generator(ctx):
    """anchor_generator_op.h: centers at i stride + offset (stride - 1);
    each anchor's w/h from the rounded stride-area base (area / ar, ar =
    h / w) scaled by size / stride; corners pixel-inclusive (+-(wh-1)/2);
    channels iterate ratios outer, sizes inner. (H, W, A, 4)."""
    feat = ctx.in_("Input")
    sizes = ctx.attr("anchor_sizes", [64.0, 128.0, 256.0, 512.0])
    ratios = ctx.attr("aspect_ratios", [0.5, 1.0, 2.0])
    stride = ctx.attr("stride", [16.0, 16.0])
    offset = ctx.attr("offset", 0.5)
    h, w = feat.shape[2], feat.shape[3]
    sw, sh = float(stride[0]), float(stride[1])
    whs = []
    for r in ratios:
        base_w = round(math.sqrt(sw * sh / r))
        base_h = round(base_w * r)
        for s in sizes:
            whs.append((s / sw * base_w, s / sh * base_h))
    dev = feat.device
    cx = torch.arange(w, dtype=torch.float32, device=dev) * sw \
        + offset * (sw - 1.0)
    cy = torch.arange(h, dtype=torch.float32, device=dev) * sh \
        + offset * (sh - 1.0)
    gy, gx = torch.meshgrid(cy, cx, indexing="ij")
    half = torch.stack([vec([(a - 1.0) / 2 for a, _ in whs], cx),
                        vec([(b - 1.0) / 2 for _, b in whs], cx)], dim=-1)
    centers = torch.stack([gx, gy], -1)[:, :, None, :]
    boxes = torch.cat([centers - half, centers + half], -1)
    boxes, var = _with_variances(
        boxes, ctx.attr("variances", [0.1, 0.1, 0.2, 0.2]))
    return {"Anchors": boxes, "Variances": var}


@register("yolo_box", dp=rows)
def yolo_box(ctx):
    """X (N, A (5 + C), H, W), ImgSize (N, 2) [h, w] -> Boxes (N, A H W, 4)
    in image pixels (clamped to the image with clip_bbox) and Scores
    (N, A H W, C) = sigmoid(class) x sigmoid(objectness); rows whose
    objectness is at most conf_thresh are zero."""
    x = ctx.in_("X")
    img_size = ctx.in_("ImgSize")
    anchors = ctx.attr("anchors")
    class_num = ctx.attr("class_num")
    downsample = ctx.attr("downsample_ratio", 32)
    n, _, h, w = x.shape
    na = len(anchors) // 2
    x = x.reshape(n, na, 5 + class_num, h, w)
    grid_x = torch.arange(w, device=x.device).reshape(1, 1, 1, w)
    grid_y = torch.arange(h, device=x.device).reshape(1, 1, h, 1)
    bx = (torch.sigmoid(x[:, :, 0]) + grid_x) / w
    by = (torch.sigmoid(x[:, :, 1]) + grid_y) / h
    aw = vec(anchors[0::2], x).reshape(1, na, 1, 1)
    ah = vec(anchors[1::2], x).reshape(1, na, 1, 1)
    bw = torch.exp(x[:, :, 2]) * aw / (w * downsample)
    bh = torch.exp(x[:, :, 3]) * ah / (h * downsample)
    conf = torch.sigmoid(x[:, :, 4])
    probs = torch.sigmoid(x[:, :, 5:]) * conf[:, :, None]
    imgh = img_size[:, 0].reshape(n, 1, 1, 1).to(torch.float32)
    imgw = img_size[:, 1].reshape(n, 1, 1, 1).to(torch.float32)
    boxes = torch.stack([(bx - bw / 2) * imgw, (by - bh / 2) * imgh,
                         (bx + bw / 2) * imgw, (by + bh / 2) * imgh], dim=-1)
    if ctx.attr("clip_bbox", True):
        lim = torch.stack([imgw, imgh, imgw, imgh], dim=-1) \
            .reshape(n, 1, 1, 1, 4) - 1.0
        boxes = torch.minimum(torch.clamp(boxes, min=0.0), lim)
    boxes = boxes.reshape(n, -1, 4)
    probs = torch.movedim(probs, 2, -1).reshape(n, -1, class_num)
    mask = (conf.reshape(n, -1, 1) > ctx.attr("conf_thresh", 0.01)) \
        .to(boxes.dtype)
    return {"Boxes": boxes * mask, "Scores": probs * mask}


# ---------------------------------------------------------------------------
# NMS
# ---------------------------------------------------------------------------

def _suppress_sorted(cand, top_scores, score_thresh, nms_thresh):
    """Greedy IoU suppression over score-descending candidates cand
    (B, K, 4), top_scores (B, K): the (B, K) keep mask. The IoU matrix
    once, then one sweep over the K candidates on the device (candidate i,
    if kept, drops the later ones it overlaps above nms_thresh), batched
    over B. The mask is discrete: nothing differentiates through it."""
    with torch.no_grad():
        c = cand.detach()
        area = torch.clamp(c[..., 2] - c[..., 0], min=0) * \
            torch.clamp(c[..., 3] - c[..., 1], min=0)
        ix1 = torch.maximum(c[..., :, None, 0], c[..., None, :, 0])
        iy1 = torch.maximum(c[..., :, None, 1], c[..., None, :, 1])
        ix2 = torch.minimum(c[..., :, None, 2], c[..., None, :, 2])
        iy2 = torch.minimum(c[..., :, None, 3], c[..., None, :, 3])
        inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
        iou = inter / torch.clamp(area[..., :, None] + area[..., None, :]
                                  - inter, min=1e-10)
        k = c.shape[-2]
        later = torch.ones(k, k, dtype=torch.bool, device=c.device).triu(1)
        # 1.0 where candidate i would drop a later candidate j
        sup = ((iou > nms_thresh) & later).to(c.dtype)
        del ix1, iy1, ix2, iy2, inter, iou
        keep = (top_scores.detach() > score_thresh).to(c.dtype)
        for i in range(k):
            # keep_j -= sup_ij keep_i, floored at 0: keep_j & ~(sup_ij &
            # keep_i) on 0/1 values
            keep = torch.addcmul(keep, sup[:, i], keep[:, i:i + 1],
                                 value=-1).clamp_(min=0)
        return keep > 0.5


def _multiclass_nms_arrays(bboxes, scores, score_thresh, nms_thresh,
                           nms_top_k, keep_top_k, background):
    """bboxes (N, M, 4), scores (N, C, M) -> (N, keep_top_k, 6) [class,
    score, x1, y1, x2, y2] padded -1: each non-background class's top
    nms_top_k candidates swept by _suppress_sorted (every image and class
    in one batch), then the best keep_top_k kept scores of the image."""
    n, c, m = scores.shape
    if 0 <= background < c:
        sc = torch.cat([scores[:, :background], scores[:, background + 1:]],
                       dim=1)
    else:
        sc = scores
    cc = sc.shape[1]
    k = min(nms_top_k, m)
    top_scores, order = stable_topk(sc, k)                     # (N, C', K)
    cand = gather_rows(bboxes, order.reshape(n, cc * k)) \
        .reshape(n, cc, k, 4)
    keep = _suppress_sorted(cand.reshape(n * cc, k, 4),
                            top_scores.reshape(n * cc, k), score_thresh,
                            nms_thresh).reshape(n, cc, k)
    cat_scores = torch.where(keep, top_scores, -1.0).reshape(n, cc * k)
    cls = torch.arange(cc, device=scores.device, dtype=scores.dtype)
    if 0 <= background < c:
        cls = cls + (cls >= background).to(cls.dtype)
    cat_cls = cls[:, None].expand(cc, k).reshape(1, cc * k).expand(n, -1)
    kk = min(keep_top_k, cc * k)
    final_scores, idx = stable_topk(cat_scores, kk)
    out = torch.cat([torch.gather(cat_cls, 1, idx)[..., None],
                     final_scores[..., None],
                     gather_rows(cand.reshape(n, cc * k, 4), idx)], dim=-1)
    out = torch.where(final_scores[..., None] > 0, out, -1.0)
    if kk < keep_top_k:
        out = torch.cat([out, out.new_full((n, keep_top_k - kk, 6), -1.0)],
                        dim=1)
    return out


@register("multiclass_nms", dp=rows)
def multiclass_nms(ctx):
    """multiclass_nms_op.cc in static shape: (N, keep_top_k, 6) [class,
    score, x1, y1, x2, y2], -1 rows past the image's detections."""
    return {"Out": _multiclass_nms_arrays(
        ctx.in_("BBoxes"), ctx.in_("Scores"),
        ctx.attr("score_threshold", 0.01), ctx.attr("nms_threshold", 0.3),
        ctx.attr("nms_top_k", 64), ctx.attr("keep_top_k", 100),
        ctx.attr("background_label", 0))}


@register("retinanet_detection_output", dp=rows)
def retinanet_detection_output(ctx):
    """RetinaNet's post-process: the levels concatenated, sigmoid class
    scores, the same per-class NMS as multiclass_nms with no background
    class."""
    allb = torch.cat(ctx.in_list("BBoxes"), dim=1)
    alls = torch.sigmoid(torch.cat(ctx.in_list("Scores"), dim=1))
    return {"Out": _multiclass_nms_arrays(
        allb, alls.transpose(1, 2), ctx.attr("score_threshold", 0.05),
        ctx.attr("nms_threshold", 0.3), ctx.attr("nms_top_k", 1000),
        ctx.attr("keep_top_k", 100), background=-1)}


# ---------------------------------------------------------------------------
# matching and losses
# ---------------------------------------------------------------------------

@register("ssd_loss", dp=_needs_replicated("PriorBox"))
def ssd_loss(ctx):
    """fluid.layers.ssd_loss in the JAX package's static form, batched
    over images: each prior matched to its best gt by IoU (positive above
    overlap_threshold); loc smooth-L1 against the center-size encoding of
    the matched gt on the positives; softmax CE of every prior's target
    class; hard negatives the neg_pos_ratio x num_pos highest-CE
    negatives (ranked by a stable sort, ties lowest index first). (N,)
    losses over max(num_pos, 1)."""
    loc = ctx.in_("Location")                    # (N, M, 4)
    conf = ctx.in_("Confidence")                 # (N, M, C) logits
    gt_box = ctx.in_("GtBox")                    # (N, G, 4)
    gt_label = ctx.in_("GtLabel")
    if gt_label.dim() == 3:
        gt_label = gt_label[..., 0]
    prior = ctx.in_("PriorBox")                  # (M, 4)
    background = int(ctx.attr("background_label", 0))
    iou = iou_matrix(prior, gt_box)              # (N, M, G)
    best_iou = iou.amax(-1)
    best_gt = iou.argmax(-1)
    pos = best_iou > ctx.attr("overlap_threshold", 0.5)
    target_label = torch.where(pos, torch.gather(gt_label.long(), 1, best_gt),
                               background)
    pw = prior[:, 2] - prior[:, 0]
    ph = prior[:, 3] - prior[:, 1]
    pcx = (prior[:, 0] + prior[:, 2]) / 2
    pcy = (prior[:, 1] + prior[:, 3]) / 2
    g = gather_rows(gt_box, best_gt)             # (N, M, 4)
    gw = torch.clamp(g[..., 2] - g[..., 0], min=1e-10)
    gh = torch.clamp(g[..., 3] - g[..., 1], min=1e-10)
    gcx = (g[..., 0] + g[..., 2]) / 2
    gcy = (g[..., 1] + g[..., 3]) / 2
    t = torch.stack([(gcx - pcx) / pw, (gcy - pcy) / ph,
                     torch.log(gw / pw), torch.log(gh / ph)], dim=-1)
    diff = torch.abs(loc - t)
    loc_l = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5).sum(-1)
    logp = torch.log_softmax(conf, dim=-1)
    conf_l = -torch.gather(logp, -1, target_label[..., None])[..., 0]
    num_pos = torch.clamp(pos.sum(-1), min=1)
    with torch.no_grad():
        neg_loss = torch.where(pos, -math.inf, conf_l)
        order = torch.argsort(-neg_loss, dim=-1, stable=True)
        # each prior's place in that order (the inverse permutation)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(order.shape[1], device=order.device)
            .expand_as(order))
        neg = rank < ctx.attr("neg_pos_ratio", 3.0) * num_pos[:, None]
    total = torch.where(pos, loc_l + conf_l, 0.0).sum(-1) + \
        torch.where(neg, conf_l, 0.0).sum(-1)
    return {"Out": total / num_pos}


@register("bipartite_match", dp=_rank3("DistMat"))
def bipartite_match(ctx):
    """DistMat (B, G, M) or (G, M): greedy bipartite matching, the largest
    remaining similarity first, min(G, M) rounds. Column outputs (B, M):
    the matched row per column (-1 none, int64) and its similarity.
    match_type per_prediction also binds each unmatched column to its
    argmax row where that similarity reaches dist_threshold (SSD)."""
    sim = ctx.in_("DistMat")
    squeeze = sim.dim() == 2
    if squeeze:
        sim = sim[None]
    b, g, m = sim.shape
    dev = sim.device
    with torch.no_grad():
        s_cur = sim.detach().clone()
        match_idx = torch.full((b, g), -1, dtype=torch.int64, device=dev)
        for _ in range(min(g, m)):
            flat = s_cur.reshape(b, -1).argmax(-1)
            gi, mi = flat // m, flat % m
            best = torch.gather(s_cur.reshape(b, -1), 1, flat[:, None])[:, 0]
            cur = torch.gather(match_idx, 1, gi[:, None])[:, 0]
            match_idx.scatter_(1, gi[:, None],
                               torch.where(best > -1e9, mi, cur)[:, None])
            s_cur.scatter_(1, gi[:, None, None].expand(b, 1, m), -1e10)
            s_cur.scatter_(2, mi[:, None, None].expand(b, g, 1), -1e10)
        # columns: unmatched rows scatter into a dummy column m, dropped
        valid = match_idx >= 0
        tgt = torch.where(valid, match_idx, m)
        rows_ = torch.arange(g, device=dev).expand(b, g)
        col_idx = torch.full((b, m + 1), -1, dtype=torch.int64, device=dev) \
            .scatter_(1, tgt, torch.where(valid, rows_, -1))[:, :m]
    matched = col_idx >= 0
    col_dist = torch.where(
        matched, torch.gather(sim, 1, col_idx.clamp(min=0)[:, None])[:, 0],
        0.0)
    if ctx.attr("match_type", "bipartite") == "per_prediction":
        best_val, best_row = sim.amax(dim=1), sim.argmax(dim=1)
        extra = ~matched & (best_val >= ctx.attr("dist_threshold", 0.5))
        col_idx = torch.where(extra, best_row, col_idx)
        col_dist = torch.where(extra, best_val, col_dist)
    if squeeze:
        col_idx, col_dist = col_idx[0], col_dist[0]
    return {"ColToRowMatchIndices": col_idx, "ColToRowMatchDist": col_dist}


@register("target_assign", dp=rows)
def target_assign(ctx):
    """X (B, G, K) gt attributes, MatchIndices (B, M) gt row per prior
    (-1 none): Out (B, M, K) the matched rows (mismatch_value where
    none), OutWeight (B, M, 1) 1/0."""
    x = ctx.in_("X")
    match = ctx.in_("MatchIndices").long()
    mismatch_value = ctx.attr("mismatch_value", 0)
    if mismatch_value is None:
        mismatch_value = 0
    g = gather_rows(x, torch.clamp(match, min=0))
    neg = match < 0
    out = torch.where(neg[..., None], mismatch_value, g)
    wt = torch.where(neg, 0.0, 1.0)[..., None]
    return {"Out": out, "OutWeight": wt}


def _one_hot(label, n, dtype):
    """One-hot rows of `label` over n classes; a label outside [0, n) is
    all zeros (jax.nn.one_hot's)."""
    return (label[..., None] == torch.arange(n, device=label.device)) \
        .to(dtype)


@register("yolov3_loss", dp=rows)
def yolov3_loss(ctx):
    """yolov3_loss_op in the JAX package's static form: each valid gt's
    cell and best anchor over the full set (responsible where the anchor is
    in this level's mask); coord loss (sigmoid xy, raw wh against the
    anchor-encoded gt, scaled 2 - w h), objectness BCE with the
    ignore_thresh rule over the decoded predictions, class BCE (label
    smoothing by default). (N,) losses. GTScore is not supported."""
    x = ctx.in_("X")
    gt_box = ctx.in_("GTBox")
    gt_label = ctx.in_("GTLabel")
    anchors = ctx.attr("anchors")
    mask = ctx.attr("anchor_mask")
    num_classes = ctx.attr("class_num")
    downsample = ctx.attr("downsample_ratio", 32)
    if ctx.in_("GTScore") is not None:
        warnings.warn(
            "yolov3_loss: gt_score weighting is not supported and will "
            "be ignored", RuntimeWarning, stacklevel=2)
    n, _, h, w = x.shape
    na = len(mask)
    all_anchors = vec(anchors, x).reshape(-1, 2)
    anc = torch.stack([all_anchors[i] for i in mask])       # (na, 2)
    in_h, in_w = h * downsample, w * downsample
    x = x.reshape(n, na, 5 + num_classes, h, w)
    px = torch.sigmoid(x[:, :, 0])
    py = torch.sigmoid(x[:, :, 1])
    pw, ph = x[:, :, 2], x[:, :, 3]
    pobj = x[:, :, 4]
    pcls = x[:, :, 5:]
    if gt_label.dim() == 3:
        gt_label = gt_label[..., 0]
    valid = gt_box[..., 2] > 1e-6
    cx = gt_box[..., 0] * w
    cy = gt_box[..., 1] * h
    ci = torch.clamp(cx.long(), 0, w - 1)
    cj = torch.clamp(cy.long(), 0, h - 1)
    bw = gt_box[..., 2] * in_w
    bh = gt_box[..., 3] * in_h
    inter = torch.minimum(bw[..., None], all_anchors[:, 0]) * \
        torch.minimum(bh[..., None], all_anchors[:, 1])
    union = bw[..., None] * bh[..., None] + \
        all_anchors[:, 0] * all_anchors[:, 1] - inter
    best_a = torch.argmax(inter / torch.clamp(union, min=1e-10), -1)
    in_mask = torch.stack([best_a == i for i in mask], -1)  # (N, G, na)
    a_idx = torch.argmax(in_mask.to(x.dtype), -1)
    resp = valid & in_mask.any(-1)
    tx = cx - ci
    ty = cy - cj
    tw = torch.log(torch.clamp(bw / torch.clamp(anc[a_idx, 0], min=1e-6),
                               min=1e-9))
    th = torch.log(torch.clamp(bh / torch.clamp(anc[a_idx, 1], min=1e-6),
                               min=1e-9))
    scale = 2.0 - gt_box[..., 2] * gt_box[..., 3]
    idx = (a_idx * h + cj) * w + ci                          # (N, G)

    def gather_pred(p):
        return torch.gather(p.reshape(n, -1), 1, idx)

    l_x = (gather_pred(px) - tx) ** 2 * scale
    l_y = (gather_pred(py) - ty) ** 2 * scale
    l_w = (gather_pred(pw) - tw) ** 2 * scale * 0.5
    l_h = (gather_pred(ph) - th) ** 2 * scale * 0.5
    coord = torch.where(resp, l_x + l_y + l_w + l_h, 0.0).sum(-1)
    obj_t = torch.zeros((n, na * h * w), dtype=x.dtype, device=x.device)
    obj_t = obj_t.scatter_reduce(1, torch.where(resp, idx, 0),
                                 torch.where(resp, 1.0, 0.0).to(x.dtype),
                                 reduce="amax", include_self=True)
    obj_t = obj_t.reshape(n, na, h, w)
    gx = torch.arange(w, dtype=x.dtype, device=x.device)
    gy = torch.arange(h, dtype=x.dtype, device=x.device)
    bx_p = (px + gx[None, None, None, :]) / w
    by_p = (py + gy[None, None, :, None]) / h
    bw_p = torch.exp(torch.clamp(pw, -10, 10)) * anc[None, :, 0, None, None] \
        / in_w
    bh_p = torch.exp(torch.clamp(ph, -10, 10)) * anc[None, :, 1, None, None] \
        / in_h
    pred = torch.stack([bx_p, by_p, bw_p, bh_p], -1).reshape(n, -1, 4)

    def corners(p):
        half = p[..., 2:] / 2
        return torch.cat([p[..., :2] - half, p[..., :2] + half], -1)

    pc, gc = corners(pred), corners(gt_box)
    ix = torch.clamp(torch.minimum(pc[..., :, None, 2], gc[..., None, :, 2])
                     - torch.maximum(pc[..., :, None, 0],
                                     gc[..., None, :, 0]), min=0)
    iy = torch.clamp(torch.minimum(pc[..., :, None, 3], gc[..., None, :, 3])
                     - torch.maximum(pc[..., :, None, 1],
                                     gc[..., None, :, 1]), min=0)
    inter_pg = ix * iy
    ap = torch.clamp(pred[..., 2] * pred[..., 3], min=0)
    ag = torch.clamp(gt_box[..., 2] * gt_box[..., 3], min=0)
    iou_pg = inter_pg / torch.clamp(ap[..., :, None] + ag[..., None, :]
                                    - inter_pg, min=1e-10)
    iou_pg = torch.where(valid[:, None, :], iou_pg, 0.0)
    best_iou = iou_pg.amax(-1).reshape(n, na, h, w)
    ignore = (best_iou > ctx.attr("ignore_thresh", 0.7)) & (obj_t < 0.5)
    bce_obj = torch.clamp(pobj, min=0) - pobj * obj_t + \
        torch.log1p(torch.exp(-torch.abs(pobj)))
    obj_loss = torch.where(ignore, 0.0, bce_obj).reshape(n, -1).sum(-1)
    tcls = _one_hot(gt_label.long(), num_classes, x.dtype)
    if bool(ctx.attr("use_label_smooth", True)):
        sw = min(1.0 / num_classes, 1.0 / 40.0)
        tcls = tcls * (1.0 - sw) + (1.0 - tcls) * sw
    pcls_flat = pcls.permute(0, 1, 3, 4, 2).reshape(n, na * h * w,
                                                    num_classes)
    pcls_g = gather_rows(pcls_flat, idx)
    bce_cls = torch.clamp(pcls_g, min=0) - pcls_g * tcls + \
        torch.log1p(torch.exp(-torch.abs(pcls_g)))
    cls_loss = torch.where(resp[..., None], bce_cls, 0.0).sum((-1, -2))
    return {"Loss": coord + obj_loss + cls_loss}


# ---------------------------------------------------------------------------
# the ROI family
# ---------------------------------------------------------------------------

def _bilinear_nhwc(xt, bidx, yy, xx, h, w):
    """xt (N, H, W, C) sampled at the grid yy (R, P) x xx (R, Q) of image
    bidx (R,): (R, P, Q, C). The JAX package's corners: floor clipped to
    the map, the weights from the unclipped point. Each corner is one
    index_select of (N H W, C) rows, whose backward is an index_add (the
    sort-based backward of advanced indexing took 44 % of a Faster R-CNN
    step's device time)."""
    c = xt.shape[-1]
    flat = xt.reshape(-1, c)
    y0 = torch.clamp(torch.floor(yy).long(), 0, h - 1)
    x0 = torch.clamp(torch.floor(xx).long(), 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = (yy - y0)[:, :, None, None]
    wx = (xx - x0)[:, None, :, None]
    base = (bidx * (h * w))[:, None, None]

    def at(yi, xi):
        idx = base + yi[:, :, None] * w + xi[:, None, :]
        return flat.index_select(0, idx.reshape(-1)).reshape(
            idx.shape + (c,))

    return (at(y0, x0) * ((1 - wy) * (1 - wx)) +
            at(y0, x1) * ((1 - wy) * wx) +
            at(y1, x0) * (wy * (1 - wx)) +
            at(y1, x1) * (wy * wx))


def _roi_grid(x, rois, ph, pw, scale, sampling=2):
    """Fluid's ROI align (roi_align_op.h:186-192: corners scale with no
    half-pixel offset, widths clamped to >= 1, sampling x sampling
    points a bin, averaged): x (N, C, H, W), rois (R, 5) [batch index,
    x1, y1, x2, y2] -> (R, C, ph, pw). Gradients reach x and the rois'
    corners (through the bilinear weights)."""
    n, c, h, w = x.shape
    bidx = rois[:, 0].long()
    boxes = rois[:, 1:] * scale
    x1, y1, x2, y2 = boxes.unbind(1)
    bw = torch.clamp(x2 - x1, min=1.0) / pw
    bh = torch.clamp(y2 - y1, min=1.0) / ph
    dt = dict(dtype=x.dtype, device=x.device)
    ys = y1[:, None] + bh[:, None] * (torch.arange(ph * sampling, **dt)
                                      + 0.5) / sampling
    xs = x1[:, None] + bw[:, None] * (torch.arange(pw * sampling, **dt)
                                      + 0.5) / sampling
    vals = _bilinear_nhwc(x.permute(0, 2, 3, 1), bidx, ys, xs, h, w)
    r = rois.shape[0]
    vals = vals.reshape(r, ph, sampling, pw, sampling, c).mean(dim=(2, 4))
    return vals.permute(0, 3, 1, 2)


def _map_replicated(ctx, walk):
    if ctx.is_sharded("X") or ctx.is_sharded("Input"):
        return ("its feature map is dp-sharded while each roi's batch "
                "index addresses the global batch")
    return None


@register("roi_align", dp=rows_if(_map_replicated))
def roi_align(ctx):
    sr = ctx.attr("sampling_ratio", 2)
    sr = 2 if sr is None or sr <= 0 else sr
    return {"Out": _roi_grid(ctx.in_("X"), ctx.in_("ROIs"),
                             ctx.attr("pooled_height", 1),
                             ctx.attr("pooled_width", 1),
                             ctx.attr("spatial_scale", 1.0), sr)}


@register("roi_pool", dp=rows_if(_map_replicated))
def roi_pool(ctx):
    """The JAX package's roi_pool: the bilinear mean of roi_align's 2 x 2
    samples a bin (not a max), and an all-zero Argmax (int64)."""
    out = _roi_grid(ctx.in_("X"), ctx.in_("ROIs"),
                    ctx.attr("pooled_height", 1), ctx.attr("pooled_width", 1),
                    ctx.attr("spatial_scale", 1.0), sampling=2)
    return {"Out": out, "Argmax": torch.zeros(out.shape, dtype=torch.int64,
                                              device=out.device)}


@register("psroi_pool", dp=rows_if(_map_replicated))
def psroi_pool(ctx):
    """psroi_pool_op.h:84-135: position-sensitive RoI average pooling over
    integer bins (corners rounded half away from zero, +1 on the far edge,
    then scaled; widths >= 0.1); bin (i, j) of category c averages input
    channel (c ph + i) pw + j over [floor(start), ceil(end)) cells, 0 for
    an empty bin. The bins as row / column interval masks in one
    einsum."""
    x = ctx.in_("X")
    rois = ctx.in_("ROIs")
    out_c = _to_int(ctx.attr("output_channels"))
    ph = _to_int(ctx.attr("pooled_height"))
    pw = _to_int(ctx.attr("pooled_width"))
    scale = ctx.attr("spatial_scale", 1.0)
    n, c, h, w = x.shape
    bidx = rois[:, 0].long()
    xs = _round_away(rois[:, 1]) * scale
    ys = _round_away(rois[:, 2]) * scale
    xe = (_round_away(rois[:, 3]) + 1.0) * scale
    ye = (_round_away(rois[:, 4]) + 1.0) * scale
    bh = torch.clamp(ye - ys, min=0.1) / ph
    bw = torch.clamp(xe - xs, min=0.1) / pw

    def interval_mask(start, bsize, bins, size):
        i = torch.arange(bins, dtype=x.dtype, device=x.device)
        lo = torch.clamp(torch.floor(i[None] * bsize[:, None]
                                     + start[:, None]), 0, size)
        hi = torch.clamp(torch.ceil((i[None] + 1) * bsize[:, None]
                                    + start[:, None]), 0, size)
        cells = torch.arange(size, dtype=x.dtype, device=x.device)
        return ((cells[None, None] >= lo[..., None])
                & (cells[None, None] < hi[..., None])).to(x.dtype)

    rmask = interval_mask(ys, bh, ph, h)
    cmask = interval_mask(xs, bw, pw, w)
    xg = x[bidx].reshape(-1, out_c, ph, pw, h, w)
    sums = torch.einsum("rcijhw,rih,rjw->rcij", xg, rmask, cmask)
    area = torch.einsum("rih,rjw->rij", rmask, cmask)[:, None]
    return {"Out": torch.where(area > 0, sums / torch.clamp(area, min=1.0),
                               0.0)}


@register("deformable_psroi_pooling", "deformable_roi_pooling",
          dp=rows_if(_map_replicated))
def deformable_roi_pooling(ctx):
    """deformable_psroi_pooling_op.h:57-153: position-sensitive RoI bins
    with learned per-part offsets. Bin (i, j) of output channel ctop
    averages sample_per_part^2 bilinear samples of input channel
    (ctop group_h + gh) group_w + gw; samples outside [-0.5, dim - 0.5]
    are skipped (count-normalized); corners round, the far edge gets +1,
    and both shift by -0.5 after scaling. ROIs (R, 5) with a batch index
    leading, or (R, 4), all of image 0."""
    x = ctx.in_("Input")
    rois = ctx.in_("ROIs")
    trans = ctx.in_("Trans") if ctx.has_in("Trans") else None
    no_trans = bool(ctx.attr("no_trans", trans is None)) or trans is None
    scale = ctx.attr("spatial_scale", 1.0)
    gh_, gw_ = _pair(ctx.attr("group_size", [1, 1]))
    ph = _to_int(ctx.attr("pooled_height", 1))
    pw = _to_int(ctx.attr("pooled_width", 1))
    part_h, part_w = _pair(ctx.attr("part_size") or [ph, pw])
    spp = _to_int(ctx.attr("sample_per_part", 1))
    trans_std = ctx.attr("trans_std", 0.1)
    n, c, h, w = x.shape
    out_dim = _to_int(ctx.attr("output_dim", c // (gh_ * gw_)))
    if out_dim * gh_ * gw_ > c:
        raise ValueError(
            "deformable_psroi_pooling: the PS channel map needs "
            f"output_dim*group_h*group_w <= C (got {out_dim}*{gh_}*{gw_} "
            f"> {c}); a clipped gather would silently read channel {c - 1}")
    dev = x.device
    if rois.shape[1] == 5:
        bidx, boxes = rois[:, 0].long(), rois[:, 1:]
    else:
        bidx = torch.zeros(rois.shape[0], dtype=torch.int64, device=dev)
        boxes = rois
    r = boxes.shape[0]
    start_w = _round_away(boxes[:, 0]) * scale - 0.5
    start_h = _round_away(boxes[:, 1]) * scale - 0.5
    roi_w = torch.clamp((_round_away(boxes[:, 2]) + 1.0) * scale - 0.5
                        - start_w, min=0.1)
    roi_h = torch.clamp((_round_away(boxes[:, 3]) + 1.0) * scale - 0.5
                        - start_h, min=0.1)
    bin_w, bin_h = roi_w / pw, roi_h / ph
    sub_w, sub_h = bin_w / spp, bin_h / spp
    # the static per-bin tables (pooled dims are fixed)
    part_hi = np.floor(np.arange(ph) / ph * part_h).astype(np.int64)
    part_wi = np.floor(np.arange(pw) / pw * part_w).astype(np.int64)
    ghi = np.clip(np.floor(np.arange(ph) * gh_ / ph), 0, gh_ - 1) \
        .astype(np.int64)
    gwi = np.clip(np.floor(np.arange(pw) * gw_ / pw), 0, gw_ - 1) \
        .astype(np.int64)
    num_classes = 1 if no_trans else max(int(trans.shape[1]) // 2, 1)
    ch_each = max(out_dim // num_classes, 1)
    ctops = np.arange(out_dim)
    class_ids = np.minimum(ctops // ch_each, num_classes - 1)
    cmap = torch.as_tensor((ctops[:, None, None] * gh_ + ghi[None, :, None])
                           * gw_ + gwi[None, None, :], device=dev)
    if no_trans:
        tx = ty = torch.zeros((r, num_classes, ph, pw), dtype=x.dtype,
                              device=dev)
    else:
        tgrid = trans[:, :, torch.as_tensor(part_hi, device=dev)][
            :, :, :, torch.as_tensor(part_wi, device=dev)]
        tv = tgrid.reshape(r, num_classes, 2, ph, pw) * trans_std
        tx, ty = tv[:, :, 0], tv[:, :, 1]
    jj = torch.arange(pw, dtype=x.dtype, device=dev)
    ii = torch.arange(ph, dtype=x.dtype, device=dev)
    cls_ids = torch.as_tensor(class_ids, device=dev)
    wstart = (jj[None, None, None, :] * bin_w[:, None, None, None]
              + start_w[:, None, None, None]
              + tx * roi_w[:, None, None, None])[:, cls_ids]
    hstart = (ii[None, None, :, None] * bin_h[:, None, None, None]
              + start_h[:, None, None, None]
              + ty * roi_h[:, None, None, None])[:, cls_ids]
    img = x[bidx]                                  # (R, C, H, W)
    ri = torch.arange(r, device=dev)[:, None, None, None]
    ch = cmap[None]
    acc = torch.zeros((r, out_dim, ph, pw), dtype=x.dtype, device=dev)
    cnt = torch.zeros_like(acc)
    for ihs in range(spp):
        for iws in range(spp):
            wc = wstart + iws * sub_w[:, None, None, None]
            hc = hstart + ihs * sub_h[:, None, None, None]
            ok = (wc >= -0.5) & (wc <= w - 0.5) & (hc >= -0.5) & \
                (hc <= h - 0.5)
            wcl = torch.clamp(wc, 0.0, w - 1.0)
            hcl = torch.clamp(hc, 0.0, h - 1.0)
            x1i, x2i = torch.floor(wcl).long(), torch.ceil(wcl).long()
            y1i, y2i = torch.floor(hcl).long(), torch.ceil(hcl).long()
            dx_, dy_ = wcl - x1i, hcl - y1i
            v = (img[ri, ch, y1i, x1i] * (1 - dx_) * (1 - dy_)
                 + img[ri, ch, y2i, x1i] * (1 - dx_) * dy_
                 + img[ri, ch, y1i, x2i] * dx_ * (1 - dy_)
                 + img[ri, ch, y2i, x2i] * dx_ * dy_)
            acc = acc + torch.where(ok, v, 0.0)
            cnt = cnt + ok.to(x.dtype)
    out = torch.where(cnt > 0, acc / torch.clamp(cnt, min=1.0), 0.0)
    return {"Output": out, "Out": out, "TopCount": cnt}


_GLOBAL_ORDER = ("it orders the rois of the whole batch, which no rank "
                 "holds")


@register("distribute_fpn_proposals", dp=refuses(_GLOBAL_ORDER))
def distribute_fpn_proposals(ctx):
    """distribute_fpn_proposals_op.h: each roi's level floor(log2(sqrt(
    area) / refer_scale + 1e-6)) + refer_level, clamped to [min_level,
    max_level], the area pixel-inclusive ((w+1)(h+1), 0 for a degenerate
    box). Static shapes: each level's output holds every roi, zero where
    it is another level's; RestoreIndex the stable sort by level (int64);
    MultiLevelRoIsNum each level's count (int64)."""
    rois = ctx.in_("FpnRois")
    min_level = ctx.attr("min_level", 2)
    max_level = ctx.attr("max_level", 5)
    w = rois[:, 2] - rois[:, 0]
    h = rois[:, 3] - rois[:, 1]
    area = torch.where((w < 0) | (h < 0), 0.0, (w + 1.0) * (h + 1.0))
    lvl = torch.floor(torch.log2(torch.sqrt(area) / ctx.attr(
        "refer_scale", 224) + 1e-6)) + ctx.attr("refer_level", 4)
    lvl = torch.clamp(lvl, min_level, max_level).long()
    outs, nums = [], []
    for level in range(min_level, max_level + 1):
        m = lvl == level
        outs.append(torch.where(m[:, None], rois, 0.0))
        nums.append(m.sum()[None])
    order = torch.argsort(lvl, stable=True)
    return {"MultiFpnRois": outs, "RestoreIndex": order[:, None],
            "MultiLevelRoIsNum": nums}


@register("collect_fpn_proposals", dp=refuses(_GLOBAL_ORDER))
def collect_fpn_proposals(ctx):
    """The levels' rois merged, the post_nms_topN best by score (ties
    lowest index first); RoisNum that count (int64)."""
    allr = torch.cat(ctx.in_list("MultiLevelRois"), 0)
    alls = torch.cat([s.reshape(-1) for s in ctx.in_list(
        "MultiLevelScores")], 0)
    k = min(ctx.attr("post_nms_topN", 100), alls.shape[0])
    _, idx = stable_topk(alls, k)
    return {"FpnRois": allr[idx],
            "RoisNum": torch.full((1,), k, dtype=torch.int64,
                                  device=allr.device)}


# ---------------------------------------------------------------------------
# detection_map: the host op
# ---------------------------------------------------------------------------

def _iou_np(box, boxes):
    x1 = np.maximum(box[0], boxes[:, 0])
    y1 = np.maximum(box[1], boxes[:, 1])
    x2 = np.minimum(box[2], boxes[:, 2])
    y2 = np.minimum(box[3], boxes[:, 3])
    inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    a1 = (box[2] - box[0]) * (box[3] - box[1])
    a2 = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / np.maximum(a1 + a2 - inter, 1e-9)


def voc_map(det, gt, thr, ap_version, background, eval_difficult):
    """VOC mAP of detections det (rows [label, score, x1, y1, x2, y2])
    against gt (rows [label, x1, y1, x2, y2(, difficult)]), one image
    set: per class, detections best first, each a true positive where its
    best-IoU gt reaches thr and is not yet matched; AP by the integral or
    the 11-point rule; the mean over the gt classes but background."""
    det = np.asarray(det, np.float32).reshape(-1, 6)
    gt = np.asarray(gt, np.float32)
    gt = gt.reshape(-1, gt.shape[-1])
    if not eval_difficult and gt.shape[-1] >= 6:
        gt = gt[gt[:, 5] < 0.5]
    aps = []
    for cls in np.unique(gt[:, 0]):
        if background is not None and int(cls) == int(background):
            continue
        g = gt[gt[:, 0] == cls][:, 1:5]
        d = det[det[:, 0] == cls]
        if not len(g):
            continue
        order = np.argsort(-d[:, 1])
        matched = np.zeros(len(g), bool)
        tp = np.zeros(len(order))
        fp = np.zeros(len(order))
        for r, i in enumerate(order):
            ious = _iou_np(d[i, 2:6], g)
            j = int(np.argmax(ious)) if len(ious) else -1
            if j >= 0 and ious[j] >= thr and not matched[j]:
                tp[r] = 1
                matched[j] = True
            else:
                fp[r] = 1
        ctp, cfp = np.cumsum(tp), np.cumsum(fp)
        rec = ctp / max(len(g), 1)
        prec = ctp / np.maximum(ctp + cfp, 1e-9)
        if ap_version == "11point":
            ap = np.mean([prec[rec >= t].max() if (rec >= t).any()
                          else 0.0 for t in np.linspace(0, 1, 11)])
        else:
            mrec = np.concatenate([[0.0], rec, [1.0]])
            mpre = np.concatenate([[0.0], prec, [0.0]])
            for i in range(len(mpre) - 2, -1, -1):
                mpre[i] = max(mpre[i], mpre[i + 1])
            idx = np.where(mrec[1:] != mrec[:-1])[0]
            ap = np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1])
        aps.append(ap)
    return np.float32(np.mean(aps) if aps else 0.0)


@register("detection_map", dp=refuses(
    "the mAP is over the whole batch's detections, which no rank holds"))
def detection_map(ctx):
    """detection_map_op (VOC mAP) on the host, as the JAX package's
    pure_callback: DetectRes and Label copied to numpy (one sync, counted
    in HOST_SYNCS), the batch's rows one image set; the (1,) mAP back on
    the op's device. A monitoring metric, off the gradient path."""
    global HOST_SYNCS
    det = ctx.in_("DetectRes").detach()
    gt = ctx.in_("Label").detach()
    HOST_SYNCS += 1
    m = voc_map(det.cpu().numpy(), gt.cpu().numpy(),
                ctx.attr("overlap_threshold", 0.3),
                ctx.attr("ap_version", "integral"),
                ctx.attr("background_label", 0),
                ctx.attr("evaluate_difficult", True))
    out = torch.full((1,), float(m), dtype=torch.float32, device=det.device)
    return {"MAP": out, "Out": out}
