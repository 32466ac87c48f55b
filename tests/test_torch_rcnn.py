"""The port's two-stage detection ops (``ops/rcnn_ops.py``) against the JAX
package, on the CPU: twins of the seven tests of
``tests/ops/test_rcnn_ops.py``, run through both packages' layers and
Executors on the same numpy inputs, and op twins of
``generate_proposals`` (its gradients to the scores and the deltas),
``roi_perspective_transform`` and ``generate_mask_labels``.

The samplers (``rpn_target_assign``, ``generate_proposal_labels``) draw
their priorities from the op's torch generator where JAX folds its keys:
the streams differ by design. Where every candidate fits in its slots the
pick is a set, so the twins hold each section (the fg rows, the bg rows)
as a set of rows against JAX's; padding rows are equal in place (both
take the lowest off-mask entries). A separate test holds a real draw:
the same seed gives the same rows, another seed other rows, every
picked row lies inside its mask, and the counts are min(slots, mask).
Tolerances are ``test_torch_detection_ops``'.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.core import unique_name as tun

from test_torch_detection_ops import close, same, twin_grads
from test_torch_seq2seq import op_twin, run_layers

CPU = fluid.CPUPlace()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_bert.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sections_as_sets(outs, n_fg):
    """Each image's rows (the outputs side by side on their last axis)
    in two sections, [0, n_fg) and [n_fg, R), each sorted: the sampled
    set of rows, whatever order the draw gave."""
    rows = np.concatenate([np.asarray(o, np.float64).reshape(
        o.shape[0], o.shape[1], -1) for o in outs], -1)
    res = []
    for img in rows:
        for sec in (img[:n_fg], img[n_fg:]):
            res.append(sec[np.lexsort(sec.T[::-1])])
    return res


def _same_sets(jouts, touts, n_fg):
    for a, b in zip(_sections_as_sets(jouts, n_fg),
                    _sections_as_sets(touts, n_fg)):
        close(b, a)


def test_generate_proposals_basic():
    """test_rcnn_ops.py:22: rois inside the image, well formed, best
    first; equal to JAX's; and the gradients of the rois and probs to
    the deltas and of the probs to the scores (the decoded boxes are not
    detached)."""
    rng = np.random.default_rng(0)
    n, a, h, w = 1, 3, 4, 4
    scores = rng.uniform(0.1, 1, (n, a, h, w)).astype(np.float32)
    deltas = (rng.standard_normal((n, 4 * a, h, w)) * 0.1).astype(
        np.float32)
    base = rng.uniform(0, 40, (h, w, a, 2)).astype(np.float32)
    anchors = np.concatenate([base, base + 16], axis=-1)
    feeds = {"s": scores, "d": deltas, "i": np.array([[64, 64, 1.0]],
                                                       np.float32),
             "a": anchors, "v": np.ones_like(anchors)}
    (jr, jp), (tr, tp) = run_layers(
        lambda L, s, d, i, an, v: L.generate_proposals(
            s, d, i, an, v, pre_nms_top_n=40, post_nms_top_n=10,
            nms_thresh=0.6, min_size=1.0), feeds)
    close(tr, jr)
    close(tp, jp)
    valid = tr[0, :, 0] >= 0
    vr = tr[0][valid]
    assert valid.any() and (vr[:, 0] <= vr[:, 2]).all()
    assert (vr >= -1e-3).all() and (vr[:, 2] < 64).all()
    assert (np.diff(tp[0, valid, 0]) <= 1e-6).all()
    ins = {"Scores": scores, "BboxDeltas": deltas, "ImInfo": feeds["i"],
           "Anchors": anchors, "Variances": feeds["v"]}
    attrs = {"pre_nms_topN": 40, "post_nms_topN": 10, "nms_thresh": 0.6,
             "min_size": 1.0}
    twin_grads("generate_proposals", ins, attrs, "RpnRois",
               ("BboxDeltas",))
    twin_grads("generate_proposals", ins, attrs, "RpnRoiProbs", ("Scores",))


def _rpn_feeds():
    anchors = np.array([[0, 0, 10, 10], [40, 40, 50, 50], [18, 18, 30, 30]],
                       np.float32)
    gt = np.array([[[0, 0, 10, 10], [20, 20, 30, 30]]], np.float32)
    return {"b": np.arange(12, dtype=np.float32).reshape(1, 3, 4),
            "c": np.array([[[0.1], [0.2], [0.3]]], np.float32),
            "a": anchors, "g": gt}


def test_rpn_target_assign_iou_rule():
    """test_rcnn_ops.py:59: both real positives in the 2 fg slots, the
    one negative in the bg slots; every row of each section as JAX's."""
    def build(L, b, c, a, g):
        return L.rpn_target_assign(b, c, a, None, g,
                                   rpn_batch_size_per_im=4,
                                   rpn_fg_fraction=0.5)

    jo, to = run_layers(build, _rpn_feeds())
    _same_sets(jo, to, 2)
    sp, lp, tl, tb, iw, sw = to
    assert tl.dtype == np.int64 and tl.shape == (1, 4, 1)
    assert (tl[0, :2, 0] == 1).all() and iw[0, :2].sum() == 8.0
    assert sw[0, :2, 0].sum() == 2.0 and sw[0, 2:, 0].sum() == 1.0


def test_retinanet_target_assign_labels_every_anchor():
    """test_rcnn_ops.py:85: no sampling; every output as JAX's."""
    feeds = {"b": np.zeros((1, 2, 4), np.float32),
             "c": np.zeros((1, 2, 1), np.float32),
             "a": np.array([[0, 0, 10, 10], [40, 40, 50, 50]], np.float32),
             "g": np.array([[[0, 0, 10, 10]]], np.float32)}
    jo, to = run_layers(
        lambda L, b, c, a, g: L.retinanet_target_assign(b, c, a, None, g),
        feeds)
    for j, t in zip(jo, to):
        close(t, j)
    np.testing.assert_array_equal(to[2][0, :, 0], [1, 0])
    assert (to[5][0, :, 0] == 1).all()


def _proposal_feeds():
    rng = np.random.default_rng(1)
    gt = np.array([[[0, 0, 20, 20], [40, 40, 60, 60]]], np.float32)
    near = gt[0, 0] + rng.uniform(-2, 2, (10, 4)).astype(np.float32)
    far = np.abs(rng.uniform(70, 90, (10, 4))).astype(np.float32)
    far[:, 2:] = far[:, :2] + 8
    return {"r": np.concatenate([near, far])[None],
            "c": np.array([[1, 3]], np.int64), "g": gt}


def _proposal_labels(per_im):
    def build(L, r, c, g):
        return L.generate_proposal_labels(
            r, c, gt_boxes=g, batch_size_per_im=per_im, fg_fraction=0.25,
            fg_thresh=0.5, class_nums=5)
    return run_layers(build, _proposal_feeds())


def test_generate_proposal_labels_sampling():
    """test_rcnn_ops.py:104's properties on the port (8 rows: 2 fg slots
    for 12 fg candidates, a real draw); at 64 rows every candidate fits
    and each section is JAX's set of rows."""
    _, (srois, labels, tgts, iw, _ow) = _proposal_labels(8)
    assert srois.shape == (1, 8, 4) and labels.shape == (1, 8, 1)
    lab = labels[0, :, 0]
    assert labels.dtype == np.int64
    assert set(lab[:2]) <= {1, 3} and set(lab[2:]) <= {0, -1}
    for i in range(2):
        cols = iw[0, i].reshape(5, 4)
        assert cols[lab[i]].sum() == 4.0 and cols.sum() == 4.0
    jo, to = _proposal_labels(64)
    _same_sets(jo, to, 16)
    assert (to[1][0, :16, 0] > 0).sum() == 12


def test_box_decoder_and_assign():
    """test_rcnn_ops.py:139, and a random case with box_clip: both
    outputs and the gradients to the priors and deltas as JAX's."""
    feeds = {"p": np.array([[0, 0, 10, 10]], np.float32),
             "v": np.array([1.0, 1.0, 1.0, 1.0], np.float32),
             "d": np.array([[0, 0, 0, 0, 1.0, 0, 0, 0]], np.float32),
             "s": np.array([[0.2, 0.8]], np.float32)}
    jo, (dec, asg) = run_layers(
        lambda L, p, v, d, s: L.box_decoder_and_assign(p, v, d, s), feeds)
    close(dec, jo[0])
    close(asg, jo[1])
    np.testing.assert_allclose(dec[0, :4], feeds["p"][0], atol=1e-5)
    np.testing.assert_allclose(asg[0], dec[0, 4:], atol=1e-5)
    rng = np.random.RandomState(4)
    prior = rng.uniform(0, 30, (6, 2)).astype(np.float32)
    ins = {"PriorBox": np.concatenate([prior, prior + 12], 1),
           "PriorBoxVar": np.array([0.1, 0.1, 0.2, 0.2], np.float32),
           "TargetBox": (rng.randn(6, 12) * 3).astype(np.float32),
           "BoxScore": rng.rand(6, 3).astype(np.float32)}
    for slot in ("DecodeBox", "OutputAssignBox"):
        twin_grads("box_decoder_and_assign", ins, {"box_clip": 4.135},
                   slot, ("PriorBox", "TargetBox"))


def test_multiclass_nms2_index_channel():
    """test_rcnn_ops.py:160: the Index channel (int64) as JAX's, -1 on the
    padding."""
    rng = np.random.default_rng(2)
    boxes = rng.uniform(0, 50, (1, 8, 2)).astype(np.float32)
    feeds = {"b": np.concatenate([boxes, boxes + 10], -1),
             "s": rng.uniform(0, 1, (1, 3, 8)).astype(np.float32)}
    (jout, jidx), (out, index) = run_layers(
        lambda L, b, s: L.multiclass_nms2(b, s, score_threshold=0.3,
                                          keep_top_k=6, return_index=True),
        feeds)
    close(out, jout)
    close(index, jidx.astype(np.int64))
    valid = out[0, :, 0] >= 0
    assert (index[0, valid, 0] >= 0).all()
    assert (index[0, ~valid, 0] == -1).all()


def test_retinanet_target_assign_multiclass_labels():
    """test_rcnn_ops.py:178: positives carry their gt's class."""
    feeds = {"b": np.zeros((1, 3, 4), np.float32),
             "c": np.zeros((1, 3, 1), np.float32),
             "a": np.array([[0, 0, 10, 10], [20, 20, 30, 30],
                            [40, 40, 50, 50]], np.float32),
             "g": np.array([[[0, 0, 10, 10], [20, 20, 30, 30]]], np.float32),
             "gl": np.array([[7, 3]], np.int64)}
    jo, to = run_layers(
        lambda L, b, c, a, g, gl: L.retinanet_target_assign(
            b, c, a, None, g, gt_labels=gl), feeds)
    for j, t in zip(jo, to):
        close(t, j)
    np.testing.assert_array_equal(to[2][0, :, 0], [7, 3, 0])


def _draw(seed, feed):
    """One rpn_target_assign draw in the port (a fresh Program seeded
    with `seed`): its six outputs."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = seed
    with tun.guard(), fluid.program_guard(main, startup):
        xs = [tlayers.data(n, shape=list(a.shape), dtype=str(a.dtype),
                           append_batch_size=False)
              for n, a in feed.items()]
        outs = tlayers.rpn_target_assign(xs[0], xs[1], xs[2], None, xs[3],
                                         rpn_batch_size_per_im=16,
                                         rpn_fg_fraction=0.25)
    exe = fluid.Executor(CPU)
    exe.run(startup)
    return [np.asarray(o) for o in exe.run(main, feed=feed,
                                           fetch_list=list(outs))]


def test_rpn_sampling_real_draw():
    """More candidates than slots (2 images, 60 anchors on a grid, 4 fg
    and 12 bg slots): the same seed gives the same rows, another seed
    other rows; every picked fg row is a positive anchor and every bg row
    a negative one (the rows carry their anchor's index in
    PredictedLocation); the counts are min(slots, candidates)."""
    g = np.arange(10, dtype=np.float32) * 6
    xy = np.stack(np.meshgrid(g, g[:6]), -1).reshape(-1, 2)
    anchors = np.concatenate([xy, xy + 12], 1)              # (60, 4)
    gt = np.array([[[0, 0, 14, 14], [30, 12, 44, 26]],
                   [[6, 6, 20, 20], [0, 0, 0, 0]]], np.float32)
    feed = {"b": np.broadcast_to(np.arange(60, dtype=np.float32)[None, :,
                                                                  None],
                                 (2, 60, 4)).copy(),
            "c": np.zeros((2, 60, 1), np.float32), "a": anchors, "g": gt}
    first, again, other = _draw(7, feed), _draw(7, feed), _draw(8, feed)
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    assert any((a != b).any() for a, b in zip(first, other))
    iou = _iou(anchors, gt)                                  # (2, 60, G)
    valid = (gt[..., 2] > gt[..., 0])[:, None, :]
    iou = np.where(valid, iou, 0.0)
    best = iou.max(-1)
    gt_best = (iou >= np.where(valid[:, 0], iou.max(1), 2.0)[:, None, :]
               - 1e-6) & valid
    pos = (best >= 0.7) | gt_best.any(-1)
    neg = (best < 0.3) & ~pos
    for draw in (first, other):
        _sp, lp, tl, _tb, iw, sw = draw
        for i in range(2):
            picked = sw[i, :, 0] > 0
            anchor = lp[i, :, 0].astype(int)
            fg, bg = picked[:4], picked[4:]
            assert pos[i, anchor[:4][fg]].all()
            assert neg[i, anchor[4:][bg]].all()
            assert len(set(anchor[picked])) == picked.sum()
            assert fg.sum() == min(4, pos[i].sum())
            assert bg.sum() == min(12, neg[i].sum())
            assert (iw[i, :4, 0] == fg).all() and not iw[i, 4:].any()
        assert (tl[:, :4, 0] == 1).all() and (tl[:, 4:, 0] == 0).all()


def _iou(a, b):
    ix1 = np.maximum(a[None, :, None, 0], b[:, None, :, 0])
    iy1 = np.maximum(a[None, :, None, 1], b[:, None, :, 1])
    ix2 = np.minimum(a[None, :, None, 2], b[:, None, :, 2])
    iy2 = np.minimum(a[None, :, None, 3], b[:, None, :, 3])
    inter = np.maximum(ix2 - ix1, 0) * np.maximum(iy2 - iy1, 0)
    aa = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    ab = np.maximum(b[..., 2] - b[..., 0], 0) * np.maximum(
        b[..., 3] - b[..., 1], 0)
    return inter / np.maximum(aa[None, :, None] + ab[:, None, :] - inter,
                              1e-10)


def test_roi_perspective_transform_twin():
    """Quads warped to 4 x 5 (one a rectangle, one skewed, one partly off
    the map): the output and its gradient to X as JAX's."""
    rng = np.random.RandomState(6)
    x = rng.randn(2, 3, 12, 14).astype(np.float32)
    quads = np.array([[[1, 1, 9, 1, 9, 7, 1, 7], [2, 3, 11, 1, 12, 9, 3, 10]],
                      [[0, 0, 6, 0, 6, 6, 0, 6],
                       [8, 6, 16, 5, 15, 14, 9, 13]]], np.float32)
    jout, tout, grads = op_twin(
        "roi_perspective_transform", {"X": x, "ROIs": quads},
        {"transformed_height": 4, "transformed_width": 5,
         "spatial_scale": 1.0}, "Out", grad=("X",))
    close(tout, jout, rtol=1e-4)
    for jg, tg in grads.values():
        close(tg, jg, rtol=1e-4)


def test_generate_mask_labels_twin():
    """Two images, three instances a polygon each (one crowd, one of two
    points), six rois with labels (fg, bg, padding): every output as
    JAX's; the second image's crowd match and padding roi get no mask."""
    segs = np.zeros((2, 3, 5, 2), np.float32)
    segs[0, 0, :4] = [[2, 2], [18, 3], [16, 17], [3, 15]]
    segs[0, 1, :3] = [[20, 20], [30, 22], [24, 34]]
    segs[0, 2, :2] = [[0, 0], [5, 5]]
    segs[1, 0, :5] = [[5, 5], [25, 5], [28, 18], [15, 28], [4, 20]]
    segs[1, 1, :4] = [[30, 30], [40, 30], [40, 40], [30, 40]]
    segs[1, 2, :3] = [[1, 30], [12, 30], [6, 40]]
    ins = {"ImInfo": np.array([[64, 64, 2.0], [64, 64, 1.0]], np.float32),
           "GtClasses": np.array([[1, 2, 1], [3, 1, 2]], np.int64),
           "IsCrowd": np.array([[0, 0, 0], [0, 1, 0]], np.int64),
           "GtSegms": segs,
           "PolyLengths": np.array([[4, 3, 2], [5, 4, 3]], np.int64),
           "Rois": np.array([[[4, 4, 36, 34], [40, 40, 70, 70],
                              [0, 0, 10, 10]],
                             [[4, 4, 30, 30], [29, 29, 41, 41],
                              [0, 28, 14, 42]]], np.float32),
           "LabelsInt32": np.array([[[1], [2], [1]], [[3], [1], [-1]]],
                                   np.int64)}
    out = same("generate_mask_labels", ins,
               {"num_classes": 4, "resolution": 6},
               ("MaskRois", "RoiHasMaskInt32", "MaskInt32"))
    assert out["MaskInt32"].dtype == np.int64
    assert out["RoiHasMaskInt32"][:, :, 0].tolist() == [[1, 1, 1], [1, 0, 0]]
