"""The port's vision ops against the JAX package, on the CPU: the 28 ops
of ``ops/nn_ops.py`` this slice adds (the 3-D and transposed
convolutions, the 3-D, adaptive, indexed and pyramid pools and unpool,
the resizes, the group / instance / data / spectral / local response
normalizations, affine_channel, temporal_shift, the grid sampler and
affine grid, unfold, the deformable convolution, fsp,
similarity_focus, bilinear_tensor_product), ``l2_normalize`` / ``norm``
and ``cumsum``, each forward and with the gradient of one seeded
cotangent (``test_torch_seq2seq.op_twin``).

Cases mirror ``tests/ops/test_pool_index_ops.py`` (the flat in-plane
argmax, ties to the window's first cell, the finfo.min / 2 padding,
unpool's round trip), ``test_uncovered_ops.py`` / ``_r4.py``,
``test_extended_ops.py``, ``test_op_numerics.py`` (group_norm, lrn,
interpolation) and ``tests/api/test_semantic_parity2.py`` (Fluid's
align_corners default, the legacy align_mode 1, the size-1 output):
every (align_corners, align_mode) pair, lrn's undivided alpha against
``F.local_response_norm``, out-of-range grid points, data_norm in
training and in test mode, spectral_norm at power_iters 1 and 3, the
deformable convolution with and without a mask. The dp cases run small
Programs through ``with_data_parallel`` on two CPU ranks against the
plain Executor, and the refusals.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu import layers as jlayers
from paddle_tpu.core import unique_name as jun
from paddle_tpu.core.executor import Scope as JScope, scope_guard as jguard
from paddle_tpu.ops import _REGISTRY as JREG

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.core import unique_name as tun
from paddle_tpu_torch.ops import _REGISTRY as TREG, _DP_RULES

from test_torch_detection_ops import both, close, grads_close
from test_torch_seq2seq import _JCtx, _TCtx, op_twin, run_layers

CPU = fluid.CPUPlace()
# f32 op twins: each output within 1e-5 relative, with an absolute floor
# of 1e-5 of the output's largest entry (XLA's convolutions and torch's
# sum in other orders; measured at most 1.3e-6 of the scale); integer
# outputs (the pools' indices) equal. The gradients of a seeded
# cotangent within 1e-4 of the gradient's largest entry (measured at
# most 2.1e-6: the transposed convolutions' filter gradients)
RTOL = 1e-5
# dp 2 against dp 1 (the same numbers but for each rank's summation
# order): outputs within 1e-5 of their scale, measured at most 4.8e-7
DP_TOL = 1e-5

RS = np.random.RandomState(31)
THE_SLICE = [
    "adaptive_pool3d", "affine_channel", "affine_grid", "bilinear_interp",
    "bilinear_tensor_product", "conv2d_transpose", "conv3d",
    "conv3d_transpose", "data_norm", "deformable_conv", "deformable_conv_v1",
    "depthwise_conv2d_transpose", "fsp", "grid_sampler", "group_norm",
    "instance_norm", "lrn", "max_pool2d_with_index", "max_pool3d_with_index",
    "nearest_interp", "pool3d", "similarity_focus", "spectral_norm", "spp",
    "temporal_shift", "trilinear_interp", "unfold", "unpool",
    "l2_normalize", "norm", "cumsum"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_bert.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _r(*shape, lo=-1.0, hi=1.0):
    return RS.uniform(lo, hi, shape).astype(np.float32)


def check(op, ins, attrs, slot, grad=(), rtol=RTOL):
    """The op's `slot` and its gradients against JAX's; the port's value."""
    jout, tout, grads = op_twin(op, ins, attrs, slot, grad=grad)
    close(tout, jout, rtol=rtol, name=f"{op}.{slot}")
    grads_close(grads)
    return tout


def test_the_slice_registers_every_op_with_a_dp_rule():
    """Every name of the JAX nn_ops this slice ports, and l2_normalize,
    norm and cumsum, is registered with a dp rule; 374 ops in all, now
    that the tensor, math, loss, metric, quant, sampling, match,
    collective and moe ops are registered too (test_torch_tensor_ops.py
    lists none missing)."""
    assert len(THE_SLICE) == 31
    for name in THE_SLICE:
        assert name in TREG and _DP_RULES[name] is not None, name
    assert len(TREG) == 374


# ---------------------------------------------------------------------------
# convolutions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups,stride,pad,dil", [
    (1, 2, 1, 1), (2, 1, 0, 2), (1, 3, 2, 1)])
def test_conv2d_transpose(groups, stride, pad, dil):
    """(C_in, C_out / g, kh, kw) filters, out = (in - 1) s - 2 p + d (k -
    1) + 1, with a Bias; gradients of input, filter and bias."""
    x = _r(2, 4, 5, 6)
    w = _r(4, 6 // groups, 3, 4)
    out = check("conv2d_transpose",
                {"Input": x, "Filter": w, "Bias": _r(6)},
                {"strides": [stride] * 2, "paddings": [pad] * 2,
                 "dilations": [dil] * 2, "groups": groups},
                "Output", grad=("Input", "Filter", "Bias"))
    assert out.shape[2] == (5 - 1) * stride - 2 * pad + dil * 2 + 1


def test_depthwise_conv2d_transpose():
    """groups == C_in, the depthwise transposed path."""
    check("depthwise_conv2d_transpose",
          {"Input": _r(2, 4, 5, 5), "Filter": _r(4, 1, 3, 3)},
          {"strides": [2, 2], "paddings": [1, 1], "groups": 4}, "Output",
          grad=("Input", "Filter"))


def test_conv3d():
    check("conv3d", {"Input": _r(2, 3, 5, 6, 6), "Filter": _r(4, 3, 3, 3, 2)},
          {"strides": [1, 2, 1], "paddings": [1, 0, 1],
           "dilations": [1, 1, 2]}, "Output", grad=("Input", "Filter"))


def test_conv3d_grouped():
    check("conv3d", {"Input": _r(1, 4, 4, 4, 4), "Filter": _r(6, 2, 3, 3, 3)},
          {"paddings": [1, 1, 1], "groups": 2}, "Output",
          grad=("Input", "Filter"))


@pytest.mark.parametrize("groups", [1, 2])
def test_conv3d_transpose(groups):
    check("conv3d_transpose",
          {"Input": _r(1, 4, 3, 4, 3), "Filter": _r(4, 4 // groups, 2, 3, 3),
           "Bias": _r(4 // groups * groups)},
          {"strides": [2, 1, 2], "paddings": [0, 1, 1], "groups": groups},
          "Output", grad=("Input", "Filter", "Bias"))


def test_conv_transposes_keep_the_cudnn_f32_flag(monkeypatch):
    """The transposed and 3-D convolutions run with cuDNN's TF32 off in
    the forward and the backward, the caller's flag restored."""
    seen = []
    cudnn = torch.backends.cudnn
    real = torch.ops.aten.convolution_backward

    def spy(*a, **k):
        seen.append(cudnn.allow_tf32)
        return real(*a, **k)

    monkeypatch.setattr(cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.ops.aten, "convolution_backward", spy)
    for op, ins in (("conv2d_transpose", {"Input": _r(1, 2, 3, 3),
                                          "Filter": _r(2, 2, 2, 2)}),
                    ("conv3d", {"Input": _r(1, 2, 3, 3, 3),
                                "Filter": _r(2, 2, 2, 2, 2)})):
        x = torch.tensor(ins["Input"], requires_grad=True)
        ctx = _TCtx({"Input": x, "Filter": torch.tensor(ins["Filter"])}, {})
        TREG[op](ctx)["Output"].sum().backward()
        assert cudnn.allow_tf32 is True
    assert seen == [False, False]


# ---------------------------------------------------------------------------
# pools
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ptype,pads,exclusive,glob", [
    ("max", [0, 0, 0], True, False), ("avg", [1, 1, 1], True, False),
    ("avg", [1, 0, 1], False, False), ("max", [1, 1, 1], True, False),
    ("avg", [0, 0, 0], True, True), ("max", [2, 2, 2], True, False)])
def test_pool3d(ptype, pads, exclusive, glob):
    """pool3d max / avg, exclusive and not, with padding (2 over a
    window of 3: past torch's own limit, padded by hand), global."""
    check("pool3d", {"X": _r(2, 3, 5, 6, 4)},
          {"pooling_type": ptype, "ksize": [3, 3, 3], "strides": [2, 2, 1],
           "paddings": pads, "exclusive": exclusive, "global_pooling": glob},
          "Out", grad=("X",))


@pytest.mark.parametrize("ptype", ["avg", "max"])
def test_adaptive_pool3d(ptype):
    """Floor/ceil windows over 5 x 7 x 6 into 2 x 3 x 4 (overlapping),
    max with its flat D H W argmax Mask."""
    attrs = {"pool_size": [2, 3, 4], "pooling_type": ptype,
             "require_index": ptype == "max"}
    ins = {"X": _r(2, 3, 5, 7, 6)}
    check("adaptive_pool3d", ins, attrs, "Out", grad=("X",))
    if ptype == "max":
        j, t = both("adaptive_pool3d", ins, attrs)
        np.testing.assert_array_equal(t["Mask"].numpy(), np.asarray(j["Mask"]))


def _ties(shape):
    """Integer-valued inputs in [0, 3]: most windows hold a tied max."""
    return RS.randint(0, 4, shape).astype(np.float32)


@pytest.mark.parametrize("ks,st,pd,glob", [
    (2, 2, 0, False), (3, 2, 1, False), (3, 1, 1, False), (2, 2, 0, True)])
def test_max_pool2d_with_index(ks, st, pd, glob):
    """Out and the int64 flat in-plane argmax Mask: ties go to the
    window's first cell (the values are small integers), padding never
    wins; the gradient of Out on tie-free inputs."""
    attrs = {"ksize": [ks, ks], "strides": [st, st], "paddings": [pd, pd],
             "global_pooling": glob}
    ins = {"X": _ties((2, 3, 7, 6))}
    j, t = both("max_pool2d_with_index", ins, attrs)
    close(t["Out"].numpy(), j["Out"])
    assert t["Mask"].dtype == torch.int64
    np.testing.assert_array_equal(t["Mask"].numpy(), np.asarray(j["Mask"]))
    x = ins["X"]
    # every index addresses a real cell holding the window's max
    flat = x.reshape(2, 3, -1)
    np.testing.assert_array_equal(
        np.take_along_axis(flat, t["Mask"].numpy().reshape(2, 3, -1), 2),
        t["Out"].numpy().reshape(2, 3, -1))
    check("max_pool2d_with_index", {"X": _r(2, 3, 7, 6)}, attrs, "Out",
          grad=("X",))


def test_max_pool_with_index_pads_with_half_finfo_min():
    """A cell below finfo.min / 2 loses to the padding, as in the JAX op
    (-inf padding would make it win): the Mask then points at the pad
    cell's (out-of-plane) position in both packages."""
    x = np.full((1, 1, 2, 2), np.finfo(np.float32).min, np.float32)
    attrs = {"ksize": [2, 2], "strides": [2, 2], "paddings": [1, 1]}
    j, t = both("max_pool2d_with_index", {"X": x}, attrs)
    close(t["Out"].numpy(), j["Out"])
    np.testing.assert_array_equal(t["Mask"].numpy(), np.asarray(j["Mask"]))
    assert (t["Out"].numpy() == np.finfo(np.float32).min / 2).all()


@pytest.mark.parametrize("adaptive", [False, True])
def test_max_pool3d_with_index(adaptive):
    attrs = {"ksize": [2, 2, 2], "strides": [2, 2, 2], "paddings": [1, 0, 1],
             "adaptive": adaptive}
    ins = {"X": _ties((2, 2, 5, 4, 5))}
    j, t = both("max_pool3d_with_index", ins, attrs)
    close(t["Out"].numpy(), j["Out"])
    np.testing.assert_array_equal(t["Mask"].numpy(), np.asarray(j["Mask"]))
    check("max_pool3d_with_index", {"X": _r(2, 2, 5, 4, 5)}, attrs, "Out",
          grad=("X",))


def test_max_pool2d_with_index_adaptive():
    ins = {"X": _r(2, 3, 7, 5)}
    attrs = {"ksize": [3, 2], "adaptive": True}
    j, t = both("max_pool2d_with_index", ins, attrs)
    close(t["Out"].numpy(), j["Out"])
    np.testing.assert_array_equal(t["Mask"].numpy(), np.asarray(j["Mask"]))


def test_unpool_round_trip():
    """test_pool_index_ops.py's pair: max_pool2d_with_index then unpool
    puts each max back at its argmax and zeros elsewhere; its gradient
    gathers from there."""
    x = _r(2, 3, 6, 8)
    pooled = TREG["max_pool2d_with_index"](_TCtx(
        {"X": torch.tensor(x)}, {"ksize": [2, 2], "strides": [2, 2]}))
    ins = {"X": pooled["Out"].numpy(), "Indices": pooled["Mask"].numpy()}
    out = check("unpool", ins, {"ksize": [2, 2], "strides": [2, 2]}, "Out",
                grad=("X",))
    kept = out != 0
    np.testing.assert_array_equal(out[kept], x[kept])
    assert kept.sum() == ins["X"].size
    check("unpool", ins, {"ksize": [2, 2], "output_size": [7, 9]}, "Out")


@pytest.mark.parametrize("ptype", ["max", "avg"])
def test_spp(ptype):
    """Three pyramid levels (1, 4, 16 bins) over 7 x 9."""
    out = check("spp", {"X": _r(2, 3, 7, 9)},
                {"pyramid_height": 3, "pooling_type": ptype}, "Out",
                grad=("X",))
    assert out.shape == (2, 3 * 21)


# ---------------------------------------------------------------------------
# resizes
# ---------------------------------------------------------------------------

INTERP_MODES = [(True, 0), (True, 1), (False, 0), (False, 1)]


@pytest.mark.parametrize("ac,am", INTERP_MODES)
@pytest.mark.parametrize("size", [(9, 13), (3, 2), (1, 1), (1, 5)])
def test_bilinear_interp(ac, am, size):
    """Every (align_corners, align_mode) pair, up and down, and size-1
    outputs (pixel 0 in every mode); the gradient of X."""
    check("bilinear_interp", {"X": _r(2, 3, 5, 6)},
          {"out_h": size[0], "out_w": size[1], "align_corners": ac,
           "align_mode": am}, "Out", grad=("X",))


def test_bilinear_interp_defaults_and_scale():
    """Fluid's defaults (align_corners True, align_mode 1) and the scale
    attr; an integer input interpolates in f32 and rounds back."""
    x = _r(1, 2, 4, 5)
    out = check("bilinear_interp", {"X": x}, {"scale": 1.5}, "Out")
    assert out.shape == (1, 2, 6, 7)
    ref = F.interpolate(torch.tensor(x), size=(6, 7), mode="bilinear",
                        align_corners=True)
    close(out, ref.numpy())
    xi = RS.randint(0, 100, (1, 2, 4, 5)).astype(np.int32)
    j, t = both("bilinear_interp", {"X": xi}, {"out_h": 7, "out_w": 3})
    assert t["Out"].dtype == torch.int32
    np.testing.assert_array_equal(t["Out"].numpy(), np.asarray(j["Out"]))


def test_legacy_align_mode_is_not_torch_half_pixel():
    """align_corners False with align_mode 1 samples d in / out, which
    F.interpolate's half-pixel mode does not: the two differ, and the
    port equals JAX's (align_mode 0 equals F.interpolate)."""
    x = _r(1, 1, 4, 4)
    legacy = check("bilinear_interp", {"X": x},
                   {"out_h": 7, "out_w": 7, "align_corners": False,
                    "align_mode": 1}, "Out")
    half = check("bilinear_interp", {"X": x},
                 {"out_h": 7, "out_w": 7, "align_corners": False,
                  "align_mode": 0}, "Out")
    ref = F.interpolate(torch.tensor(x), size=(7, 7), mode="bilinear",
                        align_corners=False).numpy()
    close(half, ref)
    assert np.abs(legacy - ref).max() > 1e-2


@pytest.mark.parametrize("ac", [True, False])
@pytest.mark.parametrize("size", [(9, 4), (1, 1), (2, 11)])
def test_nearest_interp(ac, size):
    """align_corners rounds floor(src + 0.5); otherwise it floors."""
    check("nearest_interp", {"X": _r(2, 3, 5, 6)},
          {"out_h": size[0], "out_w": size[1], "align_corners": ac}, "Out",
          grad=("X",))


@pytest.mark.parametrize("ac,am", INTERP_MODES)
def test_trilinear_interp(ac, am):
    check("trilinear_interp", {"X": _r(1, 2, 3, 4, 5)},
          {"out_d": 5, "out_h": 3, "out_w": 7, "align_corners": ac,
           "align_mode": am}, "Out", grad=("X",))


# ---------------------------------------------------------------------------
# normalizations
# ---------------------------------------------------------------------------

def test_group_norm():
    ins = {"X": _r(2, 6, 4, 5) * 3 + 1, "Scale": _r(6), "Bias": _r(6)}
    for slot in ("Y", "Mean", "Variance"):
        check("group_norm", ins, {"groups": 3, "epsilon": 1e-5}, slot,
              grad=("X", "Scale", "Bias") if slot == "Y" else ())


def test_instance_norm():
    check("instance_norm",
          {"X": _r(2, 3, 4, 5) * 2, "Scale": _r(3), "Bias": _r(3)},
          {"epsilon": 1e-5}, "Y", grad=("X", "Scale", "Bias"))


def _data_norm_ins(c=5):
    return {"X": _r(8, c) * 2 + 0.5,
            "BatchSize": RS.uniform(50, 100, c).astype(np.float32),
            "BatchSum": _r(c) * 10,
            "BatchSquareSum": RS.uniform(50, 100, c).astype(np.float32)}


def test_data_norm_training():
    """Y, Means and Scales from the summaries, and the updated summaries
    (decay, the batch's size, sum and centered squares + N eps)."""
    ins = _data_norm_ins()
    attrs = {"epsilon": 1e-4, "summary_decay_rate": 0.9}
    check("data_norm", ins, attrs, "Y", grad=("X",))
    j, t = both("data_norm", ins, attrs)
    for slot in ("Means", "Scales", "BatchSizeOut", "BatchSumOut",
                 "BatchSquareSumOut"):
        close(t[slot].numpy(), j[slot], name=slot)


def test_data_norm_test_mode_skips_the_update():
    """In an is_test context (a for_test clone's) both ops give Y, Means
    and Scales and leave the summaries."""
    ins = _data_norm_ins()
    jctx = _JCtx({k: jnp.asarray(v) for k, v in ins.items()}, {})
    jctx.is_test = True
    j = JREG["data_norm"](jctx)
    t = TREG["data_norm"](_TestCtx({k: torch.tensor(v)
                                    for k, v in ins.items()}, {}))
    assert sorted(t) == sorted(j) == ["Means", "Scales", "Y"]
    for slot in t:
        close(t[slot].numpy(), j[slot], name=slot)


class _TestCtx(_TCtx):
    is_test = True

    def __init__(self, ins, attrs):
        super().__init__(ins, attrs)
        self.is_test = True


@pytest.mark.parametrize("power_iters,dim", [(1, 0), (3, 1), (0, 0)])
def test_spectral_norm(power_iters, dim):
    """power_iters 1 and 3 (and 0: the given U and V), dim 0 and 1;
    UOut / VOut and the gradient of the weight (U and V constants)."""
    w = _r(4, 3, 2, 2)
    h = w.shape[dim]
    ins = {"Weight": w, "U": _r(h), "V": _r(w.size // h)}
    attrs = {"dim": dim, "power_iters": power_iters, "eps": 1e-12}
    check("spectral_norm", ins, attrs, "Out", grad=("Weight",))
    for slot in ("UOut", "VOut"):
        check("spectral_norm", ins, attrs, slot)


def test_lrn_alpha_is_not_divided_by_n():
    """lrn's Out and MidOut as JAX's, with its gradient; torch's
    F.local_response_norm divides alpha by n and so differs, and agrees
    with alpha x n passed to it."""
    x = _r(2, 7, 3, 3) * 3
    attrs = {"n": 5, "k": 2.0, "alpha": 1e-2, "beta": 0.75}
    out = check("lrn", {"X": x}, attrs, "Out", grad=("X",))
    check("lrn", {"X": x}, attrs, "MidOut")
    xt = torch.tensor(x)
    torch_lrn = F.local_response_norm(xt, 5, alpha=1e-2, beta=0.75, k=2.0)
    assert np.abs(torch_lrn.numpy() - out).max() > 1e-4
    scaled = F.local_response_norm(xt, 5, alpha=5e-2, beta=0.75, k=2.0)
    close(out, scaled.numpy())


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_affine_channel(layout):
    x = _r(2, 3, 4, 5) if layout == "NCHW" else _r(2, 4, 5, 3)
    check("affine_channel", {"X": x, "Scale": _r(3), "Bias": _r(3)},
          {"data_layout": layout}, "Out", grad=("X", "Scale", "Bias"))


# ---------------------------------------------------------------------------
# the rest
# ---------------------------------------------------------------------------

def _shift_ref(x, seg_num, ratio):
    """tests/models/test_tsm.py's numpy transcription of
    temporal_shift_op.h:52-72."""
    nt, c, h, w = x.shape
    c1 = int(c * ratio)
    x5 = x.reshape(nt // seg_num, seg_num, c, h, w)
    out = np.zeros_like(x5)
    out[:, 1:, :c1] = x5[:, :-1, :c1]
    out[:, :-1, c1:2 * c1] = x5[:, 1:, c1:2 * c1]
    out[:, :, 2 * c1:] = x5[:, :, 2 * c1:]
    return out.reshape(nt, c, h, w)


@pytest.mark.parametrize("ratio", [0.25, 0.125])
def test_temporal_shift(ratio):
    x = _r(8, 16, 3, 3)
    out = check("temporal_shift", {"X": x},
                {"seg_num": 4, "shift_ratio": ratio}, "Out", grad=("X",))
    np.testing.assert_array_equal(out, _shift_ref(x, 4, ratio))


def test_grid_sampler_with_points_off_the_image():
    """Grid points inside, on the border and well outside [-1, 1]: the
    corners clamp into the image and keep the unclamped weights (not
    F.grid_sample's zero padding, which differs there)."""
    grid = RS.uniform(-1.6, 1.6, (2, 3, 4, 2)).astype(np.float32)
    grid[0, 0, 0] = [1.0, -1.0]
    grid[1, 2, 3] = [2.5, -3.0]
    x = _r(2, 3, 5, 6)
    out = check("grid_sampler", {"X": x, "Grid": grid}, {}, "Output",
                grad=("X", "Grid"))
    inside = (np.abs(grid) <= 1).all(-1)
    ref = F.grid_sample(torch.tensor(x), torch.tensor(grid),
                        align_corners=True).numpy()
    close(out.transpose(0, 2, 3, 1)[inside], ref.transpose(0, 2, 3, 1)[inside])
    assert np.abs(out - ref).max() > 1e-2


def test_affine_grid():
    theta = _r(2, 2, 3)
    check("affine_grid", {"Theta": theta}, {"output_shape": [2, 3, 4, 5]},
          "Output", grad=("Theta",))
    ref = F.affine_grid(torch.tensor(theta), [2, 3, 4, 5],
                        align_corners=True)
    j, t = both("affine_grid", {"Theta": theta},
                {"output_shape": [2, 3, 4, 5]})
    close(t["Output"].numpy(), ref.numpy())


def test_affine_grid_from_a_shape_tensor():
    theta = _r(2, 2, 3)
    out = TREG["affine_grid"](_TCtx({"Theta": torch.tensor(theta),
                                     "OutputShape": torch.tensor(
                                         [2, 3, 4, 5])}, {}))
    assert tuple(out["Output"].shape) == (2, 4, 5, 2)


@pytest.mark.parametrize("pads,dil,stride", [
    ([0, 0, 0, 0], [1, 1], [1, 1]), ([1, 2, 0, 1], [1, 2], [2, 1]),
    ([1, 1], [2, 1], [1, 2])])
def test_unfold(pads, dil, stride):
    check("unfold", {"X": _r(2, 3, 6, 7)},
          {"kernel_sizes": [2, 3], "strides": stride, "paddings": pads,
           "dilations": dil}, "Y", grad=("X",))


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("op", ["deformable_conv", "deformable_conv_v1"])
def test_deformable_conv(op, with_mask):
    """Offsets that move taps off the image (zero there) and between
    pixels, a mask (v2) and none (v1); gradients of the input, offsets,
    mask and filter."""
    ho = wo = 4
    ins = {"Input": _r(2, 3, 6, 6),
           "Offset": _r(2, 2 * 3 * 3, ho, wo, lo=-2.0, hi=2.0),
           "Filter": _r(4, 3, 3, 3)}
    if with_mask:
        ins["Mask"] = _r(2, 9, ho, wo, lo=0.0, hi=1.0)
    check(op, ins, {"strides": [1, 1], "paddings": [0, 0],
                    "dilations": [1, 1]}, "Output", grad=tuple(ins))


def test_fsp():
    check("fsp", {"X": _r(2, 3, 4, 5), "Y": _r(2, 6, 4, 5)}, {}, "Out",
          grad=("X", "Y"))


@pytest.mark.parametrize("axis,indexes", [(1, [0, 2]), (2, [1]), (3, [0])])
def test_similarity_focus(axis, indexes):
    check("similarity_focus", {"X": _r(2, 3, 4, 5)},
          {"axis": axis, "indexes": indexes}, "Out")


def test_bilinear_tensor_product():
    check("bilinear_tensor_product",
          {"X": _r(4, 3), "Y": _r(4, 5), "Weight": _r(6, 3, 5),
           "Bias": _r(6)}, {}, "Out", grad=("X", "Y", "Weight", "Bias"))


@pytest.mark.parametrize("op", ["l2_normalize", "norm"])
@pytest.mark.parametrize("axis", [1, -1, 0])
def test_l2_normalize(op, axis):
    """epsilon inside the square root (norm_op.h:65-71); Norm keeps the
    axis; a near-zero row."""
    x = _r(4, 5, 3)
    x[1] *= 1e-6
    attrs = {"axis": axis, "epsilon": 1e-10}
    check(op, {"X": x}, attrs, "Out", grad=("X",))
    check(op, {"X": x}, attrs, "Norm")


@pytest.mark.parametrize("attrs", [
    {"axis": 1}, {"axis": -1, "exclusive": True}, {"axis": 0, "reverse": True},
    {"axis": 1, "exclusive": True, "reverse": True},
    {"flatten": True, "axis": 0}])
def test_cumsum(attrs):
    check("cumsum", {"X": _r(3, 4, 5)}, attrs, "Out", grad=("X",))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_resize_layers_as_jax():
    """resize_bilinear / resize_nearest / image_resize (each resample) /
    resize_trilinear / image_resize_short through both Programs."""
    x = _r(2, 3, 4, 6)
    v3 = _r(1, 2, 3, 4, 5)

    def build(L, a, b):
        return [L.resize_bilinear(a, out_shape=[7, 5]),
                L.resize_nearest(a, scale=2.0, align_corners=False),
                L.image_resize(a, out_shape=[3, 3], resample="NEAREST"),
                L.image_resize(b, out_shape=[2, 5, 6], resample="TRILINEAR"),
                L.resize_trilinear(b, scale=2.0, align_mode=0,
                                   align_corners=False),
                L.image_resize_short(a, 6)]

    j, t = run_layers(build, {"x": x, "v": v3})
    for a, b in zip(t, j):
        close(a, b)
    with pytest.raises(NotImplementedError):
        tlayers.image_resize(None, actual_shape=object())


def test_pool_layers_as_jax():
    """pool3d and adaptive_pool3d (with its Mask) through both Programs."""
    x = _r(2, 3, 4, 6, 5)

    def build(L, a):
        out, mask = L.adaptive_pool3d(a, [2, 3, 2], require_index=True)
        return [L.pool3d(a, pool_size=2, pool_type="avg", pool_stride=2),
                out, mask, L.adaptive_pool3d(a, 2, pool_type="avg")]

    j, t = run_layers(build, {"x": x})
    for a, b in zip(t, j):
        close(a, b)


def test_spectral_norm_converges_to_the_largest_singular_value():
    """test_uncovered_ops_r4.py:321: 30 power iterations give W / sigma
    of numpy's SVD (rtol 1e-4, atol 1e-5 as there)."""
    rng = np.random.RandomState(8)
    w = rng.randn(6, 4).astype(np.float32)
    out = TREG["spectral_norm"](_TCtx(
        {"Weight": torch.tensor(w), "U": torch.tensor(rng.randn(6)).float(),
         "V": torch.tensor(rng.randn(4)).float()},
        {"dim": 0, "power_iters": 30, "eps": 1e-12}))["Out"]
    sigma = np.linalg.svd(w, compute_uv=False)[0]
    np.testing.assert_allclose(out.numpy(), w / sigma, rtol=1e-4, atol=1e-5)


def test_spectral_norm_layer_state_persists_across_steps():
    """test_uncovered_ops_r4.py:334 through both Programs from JAX's
    startup: one iteration a step, U / V written back (UOut / VOut), so
    25 steps converge to W / sigma; each step's output equals JAX's."""
    rng = np.random.RandomState(9)
    w = rng.randn(6, 4).astype(np.float32)
    outs = []
    for pkg, L, un, guard, scope in (
            (jfluid, jlayers, jun, jguard, JScope()),
            (fluid, tlayers, tun, fluid.scope_guard, fluid.Scope())):
        main, startup = pkg.Program(), pkg.Program()
        with un.guard(), pkg.program_guard(main, startup):
            wv = L.data("w", [6, 4], append_batch_size=False)
            out = L.spectral_norm(wv, dim=0, power_iters=1)
        exe = pkg.Executor(CPU) if pkg is fluid else pkg.Executor()
        with guard(scope):
            if pkg is jfluid:
                exe.run(startup)
                init = {n: np.array(scope.get(n)) for n in scope.names()}
            else:
                fluid.scope_from_numpy(init, "cpu", scope)
            outs.append([np.asarray(exe.run(main, feed={"w": w},
                                            fetch_list=[out])[0])
                         for _ in range(25)])
    for a, b in zip(outs[1], outs[0]):
        close(a, b)
    sigma = np.linalg.svd(w, compute_uv=False)[0]
    np.testing.assert_allclose(outs[1][-1], w / sigma, rtol=1e-3, atol=1e-4)
    assert np.abs(outs[1][0] - outs[1][-1]).max() > 0


def test_data_norm_layer_updates_its_summaries():
    """test_semantic_parity2.py:429 through both Programs: three training
    steps move the persistable summaries as JAX's do (size 1e4 -> +32 a
    step, the mean estimate positive); the for_test clone leaves them."""
    rng = np.random.RandomState(6)
    x = (rng.randn(32, 3) * 2.0 + 5.0).astype(np.float32)
    got = []
    for pkg, L, un, guard, scope in (
            (jfluid, jlayers, jun, jguard, JScope()),
            (fluid, tlayers, tun, fluid.scope_guard, fluid.Scope())):
        main, startup = pkg.Program(), pkg.Program()
        with un.guard(), pkg.program_guard(main, startup):
            xv = L.data("x", shape=[3], dtype="float32")
            out = L.data_norm(xv, name="dn")
        names = sorted(v.name for v in main.list_vars() if v.persistable)
        exe = pkg.Executor(CPU) if pkg is fluid else pkg.Executor()
        with guard(scope):
            exe.run(startup)
            ys = [np.asarray(exe.run(main, feed={"x": x},
                                     fetch_list=[out])[0]) for _ in range(3)]
            stats = [np.array(scope.get(n)) for n in names]
            exe.run(main.clone(for_test=True), feed={"x": x},
                    fetch_list=[out])
            after = [np.array(scope.get(n)) for n in names]
        got.append((names, ys, stats, after))
    (jn, jy, js, ja), (tn, ty, ts, ta) = got
    assert tn == jn and len(tn) == 3
    for a, b in zip(ty + ts + ta, jy + js + ja):
        close(a, b)
    size = ts[tn.index(next(n for n in tn if "batch_size" in n))]
    assert (size > 1e4).all()
    for a, b in zip(ta, ts):
        np.testing.assert_array_equal(a, b)


def test_deformable_conv_with_zero_offsets_is_a_convolution():
    """test_uncovered_ops_r4.py:405: zero offsets (and a mask of ones)
    sample the plain convolution's taps."""
    x, w = _r(2, 3, 6, 7), _r(4, 3, 3, 3)
    ref = F.conv2d(torch.tensor(x), torch.tensor(w), padding=1).numpy()
    for mask in (None, np.ones((2, 9, 6, 7), np.float32)):
        ins = {"Input": torch.tensor(x), "Filter": torch.tensor(w),
               "Offset": torch.zeros(2, 18, 6, 7)}
        if mask is not None:
            ins["Mask"] = torch.tensor(mask)
        out = TREG["deformable_conv"](_TCtx(ins, {"paddings": [1, 1]}))
        close(out["Output"].numpy(), ref)


def test_grid_sampler_of_the_identity_grid_is_the_input():
    """test_extended_ops.py:134: affine_grid of the identity theta, then
    grid_sampler, returns the input, in both packages."""
    xs = RS.rand(2, 1, 5, 5).astype(np.float32)
    theta = np.tile(np.array([[[1, 0, 0], [0, 1, 0]]], np.float32),
                    (2, 1, 1))
    j, t = run_layers(lambda L, x, th: L.grid_sampler(
        x, L.affine_grid(th, out_shape=[2, 1, 5, 5])),
        {"x": xs, "theta": theta})
    close(t[0], j[0])
    np.testing.assert_allclose(t[0], xs, rtol=1e-4, atol=1e-4)


def test_layer_argument_errors_as_jax():
    """image_resize refuses an unknown resample and an actual_shape;
    adaptive_pool3d refuses avg with require_index; conv2d_transpose
    needs output_size or filter_size: the same exceptions as JAX's."""
    for pkg, L, un in ((jfluid, jlayers, jun), (fluid, tlayers, tun)):
        with un.guard(), pkg.program_guard(pkg.Program(), pkg.Program()):
            x = L.data("x", shape=[2, 4, 4], dtype="float32")
            v = L.data("v", shape=[2, 4, 4, 4], dtype="float32")
            with pytest.raises(ValueError, match="resample"):
                L.image_resize(x, out_shape=(8, 8), resample="CUBIC")
            with pytest.raises(NotImplementedError):
                L.image_resize(x, out_shape=(8, 8), actual_shape=x)
            with pytest.raises(ValueError, match="require_index"):
                L.adaptive_pool3d(v, 2, pool_type="avg", require_index=True)
            with pytest.raises(ValueError):
                L.conv2d_transpose(x, 3)


def test_conv2d_transpose_layer_from_output_size():
    """conv2d_transpose(output_size=) picks the filter size that gives
    that size (stride 2, padding 1: 4 -> 9 needs k 3), as JAX's."""
    x = _r(2, 3, 4, 4)
    j, t = run_layers(lambda L, v: L.conv2d_transpose(
        v, 5, output_size=9, stride=2, padding=1, act="relu"), {"x": x})
    assert t[0].shape == j[0].shape == (2, 5, 9, 9)


# ---------------------------------------------------------------------------
# data parallelism
# ---------------------------------------------------------------------------

def _dp_program(build):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with tun.guard(), fluid.program_guard(main, startup):
        outs = build(tlayers)
    return main, startup, outs


def _run(main, startup, outs, feed, places):
    scope, exe = fluid.Scope(), fluid.Executor(CPU)
    exe.run(startup, scope=scope)
    prog = main if places is None else fluid.CompiledProgram(
        main).with_data_parallel(loss_name=outs[0].name, places=places)
    res = exe.run(prog, feed=feed, fetch_list=outs, scope=scope)
    return res, scope


def _vision_net(L):
    x = L.data("x", shape=[4, 6, 6], dtype="float32")
    h = L.conv2d_transpose(x, 6, filter_size=3, stride=2, padding=1)
    h = L.group_norm(h, groups=3)
    h = L.resize_bilinear(h, out_shape=[5, 5])
    h = L.lrn(L.relu(h), n=3)
    h = L.temporal_shift(h, seg_num=2)
    h = L.maxout(L.prelu(h, "channel"), groups=2)
    h = L.instance_norm(h)
    h = L.conv3d(L.unsqueeze(h, [2]), 2, filter_size=[1, 3, 3], padding=1)
    h = L.pool3d(h, pool_size=2, pool_type="max", pool_stride=2)
    d = L.data_norm(L.reshape(h, [-1, 2 * 1 * 2 * 2]))
    n = L.l2_normalize(d, axis=1)
    loss = L.mean(L.elementwise_mul(n, L.cumsum(n, axis=1)))
    fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
    return [loss, n, "conv2d_transpose_0.w_0@GRAD",
            "data_norm_0.batch_size_0", "data_norm_0.batch_sum_0",
            "data_norm_0.batch_square_sum_0"]


def test_vision_ops_at_dp2_equal_dp1():
    """A Program of the slice's per-sample ops (conv2d_transpose,
    group_norm, resize_bilinear, lrn, temporal_shift over whole videos,
    prelu, maxout, instance_norm, conv3d, pool3d, data_norm,
    l2_normalize, cumsum) at dp 2 on a local CPU mesh against the plain
    Executor: the loss, the rows, a filter's gradient and data_norm's
    summaries (the global batch's: its dp rule) within DP_TOL."""
    main, startup, outs = _dp_program(_vision_net)
    feed = {"x": _r(8, 4, 6, 6)}
    want, _ = _run(main, startup, outs, feed, None)
    got, _ = _run(main, startup, outs, feed, [CPU] * 2)
    for a, b in zip(got, want):
        close(np.asarray(a), np.asarray(b), rtol=DP_TOL)


def test_temporal_shift_refuses_to_split_a_video():
    """Four rows of seg_num 4 over dp 2: each rank would hold half a
    video, so the op refuses; at seg_num 2 it runs."""
    def net(seg):
        def build(L):
            x = L.data("x", shape=[3, 2, 2], dtype="float32")
            return [L.mean(L.temporal_shift(x, seg_num=seg))]
        return build

    feed = {"x": _r(4, 3, 2, 2)}
    main, startup, outs = _dp_program(net(4))
    with pytest.raises(NotImplementedError, match="whole videos"):
        _run(main, startup, outs, feed, [CPU] * 2)
    main, startup, outs = _dp_program(net(2))
    want, _ = _run(main, startup, outs, feed, None)
    got, _ = _run(main, startup, outs, feed, [CPU] * 2)
    close(np.asarray(got[0]), np.asarray(want[0]), rtol=DP_TOL)


@pytest.mark.parametrize("layer,why", [
    (lambda L, x: L.l2_normalize(x, axis=0), "dim 0"),
    (lambda L, x: L.cumsum(x), "flattens"),
    (lambda L, x: L.cumsum(x, axis=0), "dim 0")])
def test_dim0_reductions_refuse_sharded_rows(layer, why):
    """l2_normalize over axis 0 and cumsum over axis 0 or flattened read
    every rank's rows: they refuse a dp-sharded input."""
    def build(L):
        x = L.data("x", shape=[3], dtype="float32")
        return [L.mean(layer(L, x))]

    main, startup, outs = _dp_program(build)
    with pytest.raises(NotImplementedError, match=why):
        _run(main, startup, outs, {"x": _r(4, 3)}, [CPU] * 2)
