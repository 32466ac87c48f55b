"""The port's detection ops against the JAX package, on the CPU:
``ops/detection_ops.py`` (the box geometry, the priors and anchors, the
NMS core, matching and the SSD / YOLOv3 losses, the ROI family, the FPN
routing, detection_map), the detection losses of ``ops/loss_ops.py``
(``log_loss``, ``smooth_l1_loss``, ``sigmoid_focal_loss``) and ``range``.

Op twins feed the same seeded numpy inputs to the JAX op and the port's
and hold the outputs and, where the op is differentiable, the gradients
of one seeded cotangent (``test_torch_seq2seq.op_twin``). They are twins
of ``tests/ops/test_uncovered_ops_r4.py``'s and ``_r4b.py``'s detection
cases (roi_align, box_clip, polygon_box_transform, anchor_generator,
target_assign, prior_box x2, density_prior_box x2, the deformable
PS-RoI pool x2, psroi_pool, retinanet_detection_output, the FPN pair),
``tests/ops/test_extended_ops.py``'s yolov3_loss, sigmoid_focal_loss and
bipartite_match, ``tests/api/test_semantic_parity2.py:353-471``
(box_coder x3 and its decode variants, detection_output, the attr audit)
and the detection_map cases of ``tests/ops/test_audit_gap_ops.py:209``
and ``tests/api/test_metrics_behavior.py:86`` (its first image, through
the op). The layer twins run both packages' Programs (``multi_box_head``
from JAX's startup scope). A tie case holds ``stable_topk`` to
``lax.top_k``'s order on equal scores and -1 padding.
The dp cases hold the priors replicated and the refusals by name.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import _REGISTRY as JREG

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.core import unique_name as tun
from paddle_tpu_torch.ops import _REGISTRY as TREG
from paddle_tpu_torch.ops import detection_ops as tdet

from test_torch_seq2seq import _JCtx, _TCtx, _as, op_twin, run_layers
from test_torch_sequence_ops import twin

CPU = fluid.CPUPlace()
# f32 op twins: each output within 1e-5 relative, with an absolute floor
# of 1e-5 of the output's largest entry (an entry near 0 beside large
# ones); integer outputs equal. The two packages compute the same
# formulas (measured at most a few 1e-7 of the scale)
RTOL = 1e-5
# the gradients of a seeded cotangent: within 1e-4 of the gradient's
# largest entry
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_bert.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(got, want, rtol=RTOL, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=name)


def grads_close(grads):
    for k, (jg, tg) in grads.items():
        scale = max(float(np.abs(jg).max()), 1e-12)
        err = float(np.abs(np.asarray(tg) - np.asarray(jg)).max())
        assert err <= GRAD_TOL * scale, (k, err, scale)


def both(op, ins, attrs):
    """The JAX op's and the port's outputs (dicts) on `ins`."""
    j = JREG[op](_JCtx({k: _as(v, jnp.asarray) for k, v in ins.items()},
                       attrs))
    t = TREG[op](_TCtx({k: _as(v, torch.from_numpy) for k, v in
                        ins.items()}, attrs))
    return j, t


def same(op, ins, attrs, slots):
    """Run `op` in both packages and hold each of `slots`; the port's
    outputs as numpy."""
    j, t = both(op, ins, attrs)
    out = {}
    for s in slots:
        jv, tv = j[s], t[s]
        if isinstance(jv, list):
            for a, b in zip(jv, tv):
                close(b.detach().numpy(), a, name=s)
            out[s] = [b.detach().numpy() for b in tv]
        else:
            close(tv.detach().numpy(), jv, name=s)
            out[s] = tv.detach().numpy()
    return out


def twin_grads(op, ins, attrs, slot, grad):
    jout, tout, grads = op_twin(op, ins, attrs, slot, grad=grad)
    close(tout, jout, name=slot)
    grads_close(grads)
    return tout


RS = np.random.RandomState(22)


# ---------------------------------------------------------------------------
# box geometry
# ---------------------------------------------------------------------------

def _np_bilinear(img, y, x_):
    c, h, w = img.shape
    if y < -1.0 or y > h or x_ < -1.0 or x_ > w:
        return np.zeros(c, np.float32)
    y, x_ = max(y, 0.0), max(x_, 0.0)
    y_lo, x_lo = int(y), int(x_)
    y_hi, x_hi = min(y_lo + 1, h - 1), min(x_lo + 1, w - 1)
    if y_lo >= h - 1:
        y_lo = y_hi = h - 1
        y = float(y_lo)
    if x_lo >= w - 1:
        x_lo = x_hi = w - 1
        x_ = float(x_lo)
    ly, lx = y - y_lo, x_ - x_lo
    return ((1 - ly) * (1 - lx) * img[:, y_lo, x_lo]
            + (1 - ly) * lx * img[:, y_lo, x_hi]
            + ly * (1 - lx) * img[:, y_hi, x_lo]
            + ly * lx * img[:, y_hi, x_hi])


def test_roi_align_matches_reference_loop_and_jax():
    """test_uncovered_ops_r4.py:102: roi_align_op.h:186-212 transcribed
    (no half-pixel offset, widths >= 1, (iy + 0.5) / sr samples); the
    output and the gradients to X and to the rois' corners as JAX's."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 3, 16, 16).astype("float32")
    rois = np.array([[0, 1.2, 2.3, 11.7, 13.1],
                     [1, 0.0, 0.0, 15.0, 15.0],
                     [0, 4.0, 4.0, 8.0, 9.5]], np.float32)
    ph, pw, scale, sr = 4, 4, 0.5, 2
    attrs = {"pooled_height": ph, "pooled_width": pw,
             "spatial_scale": scale, "sampling_ratio": sr}
    got = twin_grads("roi_align", {"X": x, "ROIs": rois}, attrs, "Out",
                     ("X", "ROIs"))
    want = np.zeros((3, 3, ph, pw), np.float32)
    for r in range(3):
        b = int(rois[r, 0])
        x1, y1, x2, y2 = rois[r, 1:] * scale
        bw, bh = max(x2 - x1, 1.0) / pw, max(y2 - y1, 1.0) / ph
        for i in range(ph):
            for j in range(pw):
                acc = np.zeros(3, np.float32)
                for iy in range(sr):
                    for ix in range(sr):
                        acc += _np_bilinear(
                            x[b], y1 + i * bh + (iy + 0.5) * bh / sr,
                            x1 + j * bw + (ix + 0.5) * bw / sr)
                want[r, :, i, j] = acc / (sr * sr)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_roi_pool_is_the_bilinear_mean_with_zero_argmax():
    """The JAX package's roi_pool: roi_align's 2 x 2 bilinear mean a bin,
    an all-zero Argmax (int64 in the port)."""
    x = RS.randn(2, 4, 12, 12).astype(np.float32)
    rois = np.array([[0, 1.0, 2.0, 9.0, 10.0], [1, 3.5, 0.5, 11.0, 7.0]],
                    np.float32)
    attrs = {"pooled_height": 3, "pooled_width": 2, "spatial_scale": 1.0}
    out = same("roi_pool", {"X": x, "ROIs": rois}, attrs, ("Out", "Argmax"))
    assert out["Argmax"].dtype == np.int64 and not out["Argmax"].any()
    twin_grads("roi_pool", {"X": x, "ROIs": rois}, attrs, "Out", ("X",))


def test_psroi_pool_twin():
    """test_uncovered_ops_r4.py:425's case: the interval-mask average
    pool and its gradient to X as JAX's."""
    rng = np.random.RandomState(12)
    out_c, ph, pw = 2, 3, 3
    x = rng.randn(2, out_c * ph * pw, 10, 10).astype("float32")
    rois = np.array([[0, 1.2, 0.7, 8.6, 9.1], [1, 0.0, 0.0, 9.0, 9.0],
                     [0, 3.0, 3.0, 3.4, 3.4]], np.float32)
    twin_grads("psroi_pool", {"X": x, "ROIs": rois},
               {"output_channels": out_c, "pooled_height": ph,
                "pooled_width": pw, "spatial_scale": 0.8}, "Out", ("X",))


def test_box_clip_clamps_to_image():
    """test_uncovered_ops_r4.py:195."""
    boxes = np.array([[[-3.0, -2.0, 30.0, 40.0], [5.0, 6.0, 7.0, 8.0]]],
                     np.float32)
    im_info = np.array([[20.0, 25.0, 1.0]], np.float32)
    out = same("box_clip", {"Input": boxes, "ImInfo": im_info}, {},
               ("Output",))
    np.testing.assert_allclose(out["Output"], [[[0.0, 0.0, 24.0, 19.0],
                                                [5.0, 6.0, 7.0, 8.0]]])
    same("box_clip", {"Input": boxes[0], "ImInfo": im_info}, {},
         ("Output",))


def test_polygon_box_transform_formula():
    """test_uncovered_ops_r4.py:206: 4 x the grid coordinate minus the
    input on alternating x / y channels."""
    x = np.random.RandomState(5).randn(1, 8, 2, 3).astype("float32")
    got = same("polygon_box_transform", {"Input": x}, {},
               ("Output",))["Output"]
    want = np.empty_like(x)
    for c in range(8):
        for i in range(2):
            for j in range(3):
                want[0, c, i, j] = 4 * (j if c % 2 == 0 else i) - x[0, c, i, j]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_anchor_generator_spot_values():
    """test_uncovered_ops_r4.py:222, and a case of several sizes and
    ratios against JAX."""
    feat = np.zeros((1, 8, 2, 2), np.float32)
    out = same("anchor_generator", {"Input": feat},
               {"anchor_sizes": [32.0], "aspect_ratios": [1.0],
                "stride": [16.0, 16.0], "offset": 0.5,
                "variances": [0.1, 0.1, 0.2, 0.2]},
               ("Anchors", "Variances"))
    anchors = out["Anchors"]
    assert anchors.shape == (2, 2, 1, 4)
    np.testing.assert_allclose(anchors[0, 0, 0], [-8.0, -8.0, 23.0, 23.0],
                               rtol=1e-5)
    np.testing.assert_allclose(anchors[1, 1, 0] - anchors[0, 0, 0],
                               [16.0] * 4, rtol=1e-5)
    np.testing.assert_allclose(out["Variances"][0, 0, 0],
                               [0.1, 0.1, 0.2, 0.2])
    same("anchor_generator", {"Input": np.zeros((1, 4, 3, 5), np.float32)},
         {"anchor_sizes": [16.0, 40.0], "aspect_ratios": [0.5, 1.0, 2.0],
          "stride": [8.0, 8.0], "offset": 0.5,
          "variances": [1.0, 1.0, 1.0, 1.0]}, ("Anchors", "Variances"))


def test_target_assign_gather_and_weights():
    """test_uncovered_ops_r4.py:274."""
    x = np.arange(2 * 3 * 2, dtype=np.float32).reshape(2, 3, 2)
    match = np.array([[1, -1, 2, 0], [-1, 0, -1, 1]], np.int64)
    out = same("target_assign", {"X": x, "MatchIndices": match},
               {"mismatch_value": 7.0}, ("Out", "OutWeight"))
    np.testing.assert_allclose(out["Out"][0, 1], [7.0, 7.0])
    np.testing.assert_allclose(out["Out"][1, 3], x[1, 1])
    np.testing.assert_allclose(out["OutWeight"].reshape(2, 4),
                               (match >= 0).astype(np.float32))


@pytest.mark.parametrize("mm_order", [False, True])
def test_prior_box_twin(mm_order):
    """test_uncovered_ops_r4b.py:81's attrs: min / max sizes paired by
    index, flipped ratios deduplicated, clip."""
    attrs = dict(min_sizes=[20.0, 30.0], max_sizes=[40.0, 60.0],
                 aspect_ratios=[1.0, 2.0, 0.5],
                 variances=[0.1, 0.1, 0.2, 0.2], flip=True, clip=True,
                 step_w=0.0, step_h=0.0, offset=0.5,
                 min_max_aspect_ratios_order=mm_order)
    out = same("prior_box", {"Input": np.zeros((1, 8, 3, 4), np.float32),
                             "Image": np.zeros((1, 3, 48, 64), np.float32)},
               attrs, ("Boxes", "Variances"))
    assert out["Boxes"].shape == (3, 4, 8, 4)


def test_prior_box_expand_dedupes_and_leads_with_one():
    """test_uncovered_ops_r4b.py:100: 3 priors a cell."""
    out = same("prior_box", {"Input": np.zeros((1, 4, 2, 2), np.float32),
                             "Image": np.zeros((1, 3, 32, 32), np.float32)},
               dict(min_sizes=[16.0], max_sizes=[], flip=True,
                    aspect_ratios=[2.0, 2.0000001, 1.0],
                    variances=[0.1, 0.1, 0.2, 0.2], clip=False,
                    step_w=0.0, step_h=0.0, offset=0.5), ("Boxes",))
    assert out["Boxes"].shape == (2, 2, 3, 4)


def test_density_prior_box_twin():
    """test_uncovered_ops_r4b.py:152's case; every coordinate in [0, 1]
    with clip off."""
    out = same("density_prior_box",
               {"Input": np.zeros((1, 8, 2, 3), np.float32),
                "Image": np.zeros((1, 3, 30, 45), np.float32)},
               dict(fixed_sizes=[8.0, 16.0], fixed_ratios=[1.0, 4.0],
                    densities=[2, 1], variances=[0.1, 0.1, 0.2, 0.2],
                    clip=False, step_w=0.0, step_h=0.0, offset=0.5),
               ("Boxes", "Variances"))
    assert out["Boxes"].min() >= 0.0 and out["Boxes"].max() <= 1.0


def test_density_prior_box_flatten_to_2d():
    """test_uncovered_ops_r4b.py:171."""
    out = same("density_prior_box",
               {"Input": np.zeros((1, 8, 2, 2), np.float32),
                "Image": np.zeros((1, 3, 16, 16), np.float32)},
               dict(fixed_sizes=[4.0], fixed_ratios=[1.0], densities=[2],
                    variances=[0.1, 0.1, 0.2, 0.2], clip=False, step_w=0.0,
                    step_h=0.0, offset=0.5, flatten_to_2d=True),
               ("Boxes", "Variances"))
    assert out["Boxes"].shape == (16, 4) and out["Variances"].shape == (16, 4)


@pytest.mark.parametrize("no_trans", [True, False])
def test_deformable_psroi_twin(no_trans):
    """test_uncovered_ops_r4b.py:410's case (.5 corners, a roi partly
    outside): Output and TopCount as JAX's, and the gradients to the
    input and the offsets."""
    rng = np.random.RandomState(7)
    x = rng.randn(1, 12, 9, 11).astype(np.float32)
    rois = np.array([[2.5, 1.5, 8, 7], [-3, -2, 4.5, 5]], np.float32)
    ins = {"Input": x, "ROIs": rois}
    if not no_trans:
        ins["Trans"] = rng.rand(2, 2, 2, 2).astype(np.float32) - 0.5
    attrs = dict(no_trans=no_trans, spatial_scale=0.5, output_dim=3,
                 group_size=[2, 2], pooled_height=2, pooled_width=2,
                 part_size=[2, 2], sample_per_part=2, trans_std=0.2)
    same("deformable_psroi_pooling", ins, attrs, ("Output", "TopCount"))
    twin_grads("deformable_psroi_pooling", ins, attrs, "Output",
               ("Input",) if no_trans else ("Input", "Trans"))


def _box_coder_layers(prior, target, var, code_type, normalized=True,
                      axis=0):
    """box_coder through both packages' layers (test_semantic_parity2's
    _box_coder_run): (JAX's output, the port's)."""
    feeds = {"p": prior, "t": target}
    if isinstance(var, np.ndarray):
        feeds["pvar"] = var

    def build(L, p, t, *pv):
        v = pv[0] if pv else var
        return L.box_coder(p, v, t, code_type=code_type,
                           box_normalized=normalized, axis=axis)

    (j,), (t,) = run_layers(build, feeds)
    close(t, j)
    return t


def test_box_coder_encode_with_variance():
    """test_semantic_parity2.py:353: all-pairs offsets over 1/variance
    (the variance as a python list, the attr path)."""
    prior = np.array([[0., 0., 4., 4.], [2., 2., 8., 10.]], np.float32)
    target = np.array([[1., 1., 3., 3.], [0., 0., 8., 8.]], np.float32)
    got = _box_coder_layers(prior, target, [0.1, 0.1, 0.2, 0.2],
                            "encode_center_size")
    assert got.shape == (2, 2, 4)
    np.testing.assert_allclose(got[0, 0], [0, 0, np.log(0.5) / 0.2,
                                           np.log(0.5) / 0.2], atol=1e-5)


def test_box_coder_decode_roundtrip():
    """test_semantic_parity2.py:377: decode(encode(x)) == x."""
    rng = np.random.RandomState(3)
    prior = np.abs(rng.rand(3, 4).astype(np.float32))
    prior[:, 2:] = prior[:, :2] + 1.0 + rng.rand(3, 2).astype(np.float32)
    boxes = np.abs(rng.rand(3, 4).astype(np.float32))
    boxes[:, 2:] = boxes[:, :2] + 0.5 + rng.rand(3, 2).astype(np.float32)
    var = np.array([[0.1, 0.1, 0.2, 0.2]] * 3, np.float32)
    enc = _box_coder_layers(prior, boxes, var, "encode_center_size")
    matched = np.stack([enc[i, i] for i in range(3)])[None]
    dec = _box_coder_layers(prior, matched, var, "decode_center_size")
    np.testing.assert_allclose(dec.reshape(3, 4), boxes, rtol=1e-4,
                               atol=1e-5)


def test_box_coder_unnormalized_plus_one():
    """test_semantic_parity2.py:393: +1 widths, -1 on decoded corners."""
    prior = np.array([[0., 0., 3., 3.]], np.float32)
    enc = _box_coder_layers(prior, prior.copy(), None, "encode_center_size",
                            normalized=False)
    np.testing.assert_allclose(enc.reshape(4), [0, 0, 0, 0], atol=1e-6)
    dec = _box_coder_layers(prior, np.zeros((1, 1, 4), np.float32), None,
                            "decode_center_size", normalized=False)
    np.testing.assert_allclose(dec.reshape(4), prior[0], atol=1e-5)


def test_box_coder_decode_axis1_tensor_var_and_grads():
    """The decode variants of test_semantic_parity2.py:553 (axis 1, +1
    widths, PriorBoxVar a tensor) and a 2-D target, with the gradients
    to the priors and the offsets."""
    prior = np.abs(RS.rand(3, 4)).astype(np.float32)
    prior[:, 2:] += prior[:, :2] + 2.0
    var = (RS.rand(3, 4) * 0.2 + 0.1).astype(np.float32)
    target = (RS.randn(3, 5, 4) * 0.3).astype(np.float32)
    for attrs, tgt in (
            ({"code_type": "decode_center_size", "axis": 1,
              "box_normalized": False}, target),
            ({"code_type": "decode_center_size", "axis": 0},
             (RS.randn(2, 3, 4) * 0.3).astype(np.float32)),
            ({"code_type": "decode_center_size"}, target[:, 0])):
        twin_grads("box_coder", {"PriorBox": prior, "PriorBoxVar": var,
                                 "TargetBox": tgt}, attrs, "OutputBox",
                   ("PriorBox", "TargetBox"))


def test_iou_similarity_twin():
    a = np.abs(RS.rand(5, 4)).astype(np.float32)
    a[:, 2:] += a[:, :2]
    b = np.abs(RS.rand(3, 4)).astype(np.float32)
    b[:, 2:] += b[:, :2]
    for normalized in (True, False):
        twin_grads("iou_similarity", {"X": a * 10, "Y": b * 10},
                   {"box_normalized": normalized}, "Out", ("X", "Y"))


def test_attr_audit_iou_bipartite_yolo_box():
    """test_semantic_parity2.py:471-540: iou_similarity box_normalized
    (identical 1-pixel boxes: 0 normalized, 1 inclusive), bipartite_match
    per_prediction, yolo_box clip_bbox."""
    b = np.array([[2., 2., 2., 2.]], np.float32)
    for norm, want in ((True, 0.0), (False, 1.0)):
        out = same("iou_similarity", {"X": b, "Y": b},
                   {"box_normalized": norm}, ("Out",))
        assert abs(float(out["Out"].ravel()[0]) - want) < 1e-6
    sim = np.array([[[0.9, 0.2, 0.1], [0.3, 0.8, 0.6]]], np.float32)
    for mt, want in (("bipartite", [0, 1, -1]),
                     ("per_prediction", [0, 1, 1])):
        out = same("bipartite_match", {"DistMat": sim},
                   {"match_type": mt, "dist_threshold": 0.5},
                   ("ColToRowMatchIndices", "ColToRowMatchDist"))
        np.testing.assert_array_equal(out["ColToRowMatchIndices"][0], want)
        assert out["ColToRowMatchIndices"].dtype == np.int64
    x = (np.random.RandomState(1).randn(1, 14, 2, 2) * 3).astype(np.float32)
    img = np.array([[20, 20]], np.int32)
    attrs = {"anchors": [10, 10, 16, 30], "class_num": 2,
             "conf_thresh": 0.0, "downsample_ratio": 10}
    clipped = same("yolo_box", {"X": x, "ImgSize": img},
                   dict(attrs, clip_bbox=True), ("Boxes", "Scores"))
    free = same("yolo_box", {"X": x, "ImgSize": img},
                dict(attrs, clip_bbox=False), ("Boxes", "Scores"))
    assert clipped["Boxes"].min() >= 0.0 and clipped["Boxes"].max() <= 19.0
    assert free["Boxes"].min() < 0.0 or free["Boxes"].max() > 19.0


def test_bipartite_match_and_target_assign():
    """test_extended_ops.py:164: gt0 -> prior1, gt1 -> prior0; a larger
    random (B, G, M) case and target_assign over its match."""
    dv = np.array([[[0.1, 0.9, 0.3, 0.2], [0.8, 0.2, 0.1, 0.7]]],
                  np.float32)
    out = same("bipartite_match", {"DistMat": dv}, {},
               ("ColToRowMatchIndices", "ColToRowMatchDist"))
    np.testing.assert_array_equal(out["ColToRowMatchIndices"][0],
                                  [1, 0, -1, -1])
    sim = RS.rand(3, 4, 9).astype(np.float32)
    out = same("bipartite_match", {"DistMat": sim},
               {"match_type": "per_prediction", "dist_threshold": 0.6},
               ("ColToRowMatchIndices", "ColToRowMatchDist"))
    same("target_assign", {"X": RS.randn(3, 4, 5).astype(np.float32),
                           "MatchIndices": out["ColToRowMatchIndices"]},
         {"mismatch_value": 0.0}, ("Out", "OutWeight"))


def test_yolov3_loss_twin():
    """test_extended_ops.py:146's case (2 anchors, 4 classes, a padded gt
    row): the (N,) loss and its gradient to X as JAX's."""
    rng = np.random.RandomState(3)
    ins = {"X": rng.randn(2, 18, 4, 4).astype(np.float32),
           "GTBox": np.array([[[0.5, 0.5, 0.2, 0.3], [0.2, 0.3, 0.1, 0.1],
                               [0, 0, 0, 0]]] * 2, np.float32),
           "GTLabel": np.array([[1, 2, 0]] * 2, np.int64)}
    for smooth in (True, False):
        got = twin_grads("yolov3_loss", ins,
                         {"anchors": [10, 13, 16, 30], "anchor_mask": [0, 1],
                          "class_num": 4, "ignore_thresh": 0.7,
                          "downsample_ratio": 32,
                          "use_label_smooth": smooth}, "Loss", ("X",))
        assert got.shape == (2,) and np.isfinite(got).all()


def test_yolo_box_twin():
    x = RS.randn(2, 3 * 8, 3, 3).astype(np.float32)
    img = np.array([[64, 48], [32, 32]], np.int32)
    twin_grads("yolo_box", {"X": x, "ImgSize": img},
               {"anchors": [4, 6, 10, 12, 20, 14], "class_num": 3,
                "conf_thresh": 0.3, "downsample_ratio": 16}, "Boxes", ("X",))


# ---------------------------------------------------------------------------
# NMS
# ---------------------------------------------------------------------------

def _boxes(n, m, scale=50.0, seed=0):
    rng = np.random.RandomState(seed)
    base = rng.uniform(0, scale, (n, m, 2)).astype(np.float32)
    wh = rng.uniform(4, 20, (n, m, 2)).astype(np.float32)
    return np.concatenate([base, base + wh], -1)


def test_stable_topk_is_lax_top_k_on_ties():
    """Equal values and -1 / -1e30 padding: the same order as lax.top_k
    (lowest index first among equals)."""
    x = np.array([[0.5, -1, 0.5, 0.7, -1, 0.5, -1, 0.7],
                  [-1e30, -1e30, 0.2, -1e30, 0.2, 0.2, -1e30, 0.1]],
                 np.float32)
    for k in (3, 6, 8):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = tdet.stable_topk(torch.from_numpy(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_multiclass_nms_ties_and_padding_order():
    """Equal scores across candidates and classes, duplicate boxes and
    scores under the threshold (the -1 rows): the same (N, keep_top_k, 6)
    rows as JAX's, in the same order."""
    boxes = np.array([[[0, 0, 10, 10], [0, 0, 10, 10], [20, 20, 30, 30],
                       [40, 40, 50, 50], [1, 1, 11, 11], [60, 60, 70, 70]]],
                     np.float32)
    scores = np.array([[[0.0] * 6,
                        [0.6, 0.6, 0.6, 0.005, 0.6, 0.3],
                        [0.3, 0.6, 0.6, 0.6, 0.001, 0.3]]], np.float32)
    for top_k, keep in ((6, 12), (4, 5), (3, 20)):
        out = same("multiclass_nms", {"BBoxes": boxes, "Scores": scores},
                   {"score_threshold": 0.01, "nms_threshold": 0.5,
                    "nms_top_k": top_k, "keep_top_k": keep,
                    "background_label": 0}, ("Out",))["Out"]
        assert out.shape == (1, keep, 6)
        assert (out[0, :, 0] >= 0).sum() >= 3


def test_multiclass_nms_random_twin_and_grads():
    """A random problem (3 images, 4 classes, 30 boxes) at nms_top_k 12:
    the same rows as JAX's, and the gradients to the boxes and scores
    through the kept rows."""
    boxes = _boxes(3, 30)
    scores = RS.rand(3, 4, 30).astype(np.float32)
    attrs = {"score_threshold": 0.2, "nms_threshold": 0.4, "nms_top_k": 12,
             "keep_top_k": 20, "background_label": 0}
    twin_grads("multiclass_nms", {"BBoxes": boxes, "Scores": scores}, attrs,
               "Out", ("BBoxes", "Scores"))
    same("multiclass_nms", {"BBoxes": boxes, "Scores": scores},
         dict(attrs, background_label=-1), ("Out",))


def test_retinanet_detection_output_twin():
    """test_uncovered_ops_r4.py:477's case, and two random levels."""
    b1 = np.array([[[0., 0., 10., 10.], [20., 20., 30., 30.]]], np.float32)
    logits = np.full((1, 2, 3), -6.0, np.float32)
    logits[0, 0, 1], logits[0, 1, 2] = 3.0, 2.0
    out = same("retinanet_detection_output",
               {"BBoxes": [b1], "Scores": [logits]},
               {"score_threshold": 0.05, "nms_threshold": 0.3,
                "nms_top_k": 10, "keep_top_k": 5}, ("Out",))["Out"]
    assert (out[..., 0] >= 0).sum() == 2
    same("retinanet_detection_output",
         {"BBoxes": [_boxes(2, 10, seed=1), _boxes(2, 6, seed=2)],
          "Scores": [RS.randn(2, 10, 3).astype(np.float32),
                     RS.randn(2, 6, 3).astype(np.float32)]},
         {"nms_top_k": 8, "keep_top_k": 10}, ("Out",))


def test_detection_output_layers_twin():
    """test_semantic_parity2.py:407: detection_output end to end (decode,
    softmax, NMS) through both packages' Programs."""
    rng = np.random.RandomState(4)
    m, c = 6, 3
    prior = np.abs(rng.rand(m, 4).astype(np.float32))
    prior[:, 2:] = prior[:, :2] + 0.5
    feeds = {"loc": rng.randn(1, m, 4).astype(np.float32) * 0.1,
             "sc": rng.randn(1, m, c).astype(np.float32), "pr": prior,
             "pv": np.full((m, 4), 0.1, np.float32)}
    (j,), (t,) = run_layers(
        lambda L, lo, s, p, v: L.detection_output(
            lo, s, p, v, score_threshold=0.0, nms_threshold=0.5), feeds)
    close(t, j)
    assert t.shape == (1, 200, 6) and np.isfinite(t).all()


def test_multi_box_head_ratio_sizes_twin():
    """multi_box_head with the sizes from min_ratio / max_ratio (the
    reference formula's branch), three maps, a 3 x 3 head with padding:
    the locations, confidences, priors and variances as JAX's from one
    scope (the heads' weights carried over)."""
    rng = np.random.RandomState(2)
    feed = {"f1": rng.randn(2, 4, 8, 8).astype(np.float32),
            "f2": rng.randn(2, 6, 4, 4).astype(np.float32),
            "f3": rng.randn(2, 6, 2, 2).astype(np.float32),
            "im": rng.randn(2, 3, 64, 64).astype(np.float32)}

    def build(pkg, L):
        xs = [L.data(n, shape=list(a.shape), dtype="float32",
                     append_batch_size=False) for n, a in feed.items()]
        return L.multi_box_head(xs[:3], xs[3], base_size=64, num_classes=3,
                                aspect_ratios=[[2.0], [2.0, 3.0], [2.0]],
                                min_ratio=20, max_ratio=90, kernel_size=3,
                                pad=1)

    jo, to, _ = twin(build, feed)
    for a, b in zip(jo, to):
        close(b, a)
    assert to[0].shape == (2, 8 * 8 * 4 + 4 * 4 * 6 + 2 * 2 * 4, 4)


# ---------------------------------------------------------------------------
# SSD, the FPN pair, detection_map, the losses
# ---------------------------------------------------------------------------

def test_ssd_loss_twin_with_mining_ties():
    """The SSD loss over 2 images, 12 priors, 3 gt: the (N,) loss and its
    gradients to the locations and confidences as JAX's. Equal logits
    rows make hard-negative mining rank equal losses (a stable sort, the
    lowest index first on both sides)."""
    rng = np.random.RandomState(9)
    prior = _boxes(1, 12, scale=1.0, seed=3)[0] / 25.0
    gt = np.stack([prior[[0, 4, 7]] + 0.01, prior[[2, 5, 9]] - 0.01])
    conf = rng.randn(2, 12, 4).astype(np.float32)
    conf[:, 6:] = conf[:, 6:7]               # ties among the negatives
    ins = {"Location": (rng.randn(2, 12, 4) * 0.1).astype(np.float32),
           "Confidence": conf, "GtBox": gt.astype(np.float32),
           "GtLabel": np.array([[[1], [2], [3]], [[3], [1], [0]]], np.int64),
           "PriorBox": prior}
    for ratio in (3.0, 1.0):
        twin_grads("ssd_loss", ins, {"overlap_threshold": 0.5,
                                     "neg_pos_ratio": ratio},
                   "Out", ("Location", "Confidence"))


def test_distribute_fpn_proposals_levels():
    """test_uncovered_ops_r4.py:360's boundary boxes: the level counts,
    the level rois and the stable restore order (int64) as JAX's."""
    def box(side):
        return [0.0, 0.0, side - 1.0, side - 1.0]

    rois = np.array([box(111.5), box(112.5), box(223.5), box(224.5),
                     box(448.5), box(4000.0), [5.0, 5.0, 2.0, 2.0]],
                    np.float32)
    out = same("distribute_fpn_proposals", {"FpnRois": rois},
               {"min_level": 2, "max_level": 5, "refer_level": 4,
                "refer_scale": 224},
               ("MultiFpnRois", "RestoreIndex", "MultiLevelRoIsNum"))
    assert out["RestoreIndex"].dtype == np.int64
    assert sum(int(n[0]) for n in out["MultiLevelRoIsNum"]) == 7


def test_collect_fpn_proposals_topk():
    """test_uncovered_ops_r4.py:391, with a tie."""
    r2 = np.array([[0, 0, 10, 10], [1, 1, 5, 5]], np.float32)
    r3 = np.array([[2, 2, 8, 8], [3, 3, 9, 9]], np.float32)
    out = same("collect_fpn_proposals",
               {"MultiLevelRois": [r2, r3],
                "MultiLevelScores": [np.array([0.9, 0.5], np.float32),
                                     np.array([0.5, 0.1], np.float32)]},
               {"post_nms_topN": 3}, ("FpnRois", "RoisNum"))
    np.testing.assert_allclose(out["FpnRois"], [r2[0], r2[1], r3[0]])


def _map_layers(det, gt, **kw):
    (j,), (t,) = run_layers(
        lambda L, d, g: L.detection_map(d, g, class_num=3, **kw),
        {"d": det, "g": gt})
    close(t, j)
    return float(t.ravel()[0])


def test_detection_map_layer():
    """test_audit_gap_ops.py:209: class 1 found (AP 1), class 2 missed:
    mAP 0.5; the op counts its one host sync."""
    det = np.array([[1, 0.9, 0, 0, 10, 10], [2, 0.8, 50, 50, 60, 60]],
                   np.float32)
    gt = np.array([[1, 0, 0, 10, 10], [2, 80, 80, 90, 90]], np.float32)
    before = tdet.HOST_SYNCS
    assert abs(_map_layers(det, gt, overlap_threshold=0.5) - 0.5) < 1e-6
    assert tdet.HOST_SYNCS == before + 1


def test_detection_map_11point_hand_case():
    """test_metrics_behavior.py:86's first image through the op: one
    match, one miss, one duplicate; the 11-point AP 6/11."""
    gt = np.array([[1, 0, 0, 10, 10], [1, 20, 20, 30, 30]], np.float32)
    det = np.array([[1, 0.9, 0, 0, 10, 10], [1, 0.8, 50, 50, 60, 60],
                    [1, 0.7, 0, 0, 10, 10]], np.float32)
    got = _map_layers(det, gt, overlap_threshold=0.5, ap_version="11point")
    assert got == pytest.approx(6 / 11, abs=1e-6)


def test_losses_twin():
    """log_loss, smooth_l1_loss (with inside and outside weights, sigma)
    and sigmoid_focal_loss (with FgNum; test_extended_ops.py:69's easy /
    hard rows) as JAX's, with their gradients."""
    p = RS.uniform(0.05, 0.95, (6, 1)).astype(np.float32)
    lab = (RS.rand(6, 1) > 0.5).astype(np.float32)
    twin_grads("log_loss", {"Predicted": p, "Labels": lab},
               {"epsilon": 1e-6}, "Loss", ("Predicted",))
    x, y = RS.randn(5, 8).astype(np.float32), RS.randn(5, 8).astype(
        np.float32)
    iw = (RS.rand(5, 8) > 0.3).astype(np.float32)
    ow = RS.rand(5, 8).astype(np.float32)
    for sigma in (1.0, 3.0):
        twin_grads("smooth_l1_loss", {"X": x, "Y": y, "InsideWeight": iw,
                                      "OutsideWeight": ow},
                   {"sigma": sigma}, "Out", ("X", "Y"))
    twin_grads("smooth_l1", {"X": x, "Y": y}, {}, "Out", ("X",))
    logits = np.array([[5.0, -5.0, -5.0], [5.0, -5.0, -5.0]], np.float32)
    labels = np.array([[1], [2]], np.int64)
    got = same("sigmoid_focal_loss", {"X": logits, "Label": labels},
               {"gamma": 2.0, "alpha": 0.25}, ("Out",))["Out"]
    assert got[0, 0] < got[1, 0]
    twin_grads("sigmoid_focal_loss",
               {"X": RS.randn(6, 4).astype(np.float32),
                "Label": RS.randint(0, 5, (6, 1)).astype(np.int64),
                "FgNum": np.array([3], np.int32)},
               {"gamma": 1.5, "alpha": 0.3}, "Out", ("X",))


def test_range_layer():
    (j,), (t,) = run_layers(lambda L, x: [L.range(0, 5, 1, "float32")],
                            {"x": np.zeros(1, np.float32)})
    close(t, j)
    np.testing.assert_array_equal(t, np.arange(5, dtype=np.float32))
    (j,), (t,) = run_layers(lambda L, x: [L.range(1, 10, 3, "int64")],
                            {"x": np.zeros(1, np.float32)})
    np.testing.assert_array_equal(t, j)


# ---------------------------------------------------------------------------
# data parallelism
# ---------------------------------------------------------------------------

def _port_dp(build, feed, places):
    main, startup = fluid.Program(), fluid.Program()
    with tun.guard(), fluid.program_guard(main, startup):
        xs = [tlayers.data(n, shape=list(a.shape), dtype=str(a.dtype),
                           append_batch_size=False)
              for n, a in feed.items()]
        res = build(tlayers, *xs)
    res = list(res) if isinstance(res, (list, tuple)) else [res]
    comp = fluid.CompiledProgram(main).with_data_parallel(places=places)
    exe = fluid.Executor(CPU)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    return [np.asarray(v) for v in exe.run(comp, feed=feed, fetch_list=res,
                                           scope=scope)]


def test_priors_replicated_and_nms_rows_under_dp():
    """dp 2 against dp 1: prior_box over a sharded feature map comes out
    whole (replicated), and detection_output's per-image NMS on sharded
    scores gives the same rows."""
    rng = np.random.RandomState(5)
    feed = {"feat": rng.randn(4, 2, 3, 3).astype(np.float32),
            "img": rng.randn(4, 3, 24, 24).astype(np.float32),
            "loc": (rng.randn(4, 36, 4) * 0.1).astype(np.float32),
            "conf": rng.randn(4, 36, 3).astype(np.float32)}

    def build(L, feat, img, loc, conf):
        box, var = L.prior_box(feat, img, [8.0], [12.0], [2.0], flip=True)
        box = L.reshape(box, [-1, 4])
        var = L.reshape(var, [-1, 4])
        return [box, L.detection_output(loc, conf, box, var, nms_top_k=20,
                                         keep_top_k=10)]

    one = _port_dp(build, feed, [CPU])
    two = _port_dp(build, feed, [CPU] * 2)
    assert two[0].shape == (36, 4) and two[1].shape == (4, 10, 6)
    for a, b in zip(two, one):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which", ["detection_map", "roi_align"])
def test_global_batch_ops_refuse_under_dp(which):
    """detection_map reads the global batch, roi_align's batch index
    addresses it: at dp 2 each refuses a sharded input and names
    itself."""
    feed = {"a": np.zeros((4, 6), np.float32),
            "b": np.zeros((4, 5), np.float32),
            "x": np.zeros((4, 2, 6, 6), np.float32)}

    def build(L, a, b, x):
        if which == "detection_map":
            return L.detection_map(a, b, class_num=3)
        return L.roi_align(x, b, 2, 2)

    with pytest.raises(NotImplementedError, match=which):
        _port_dp(build, feed, [CPU] * 2)
