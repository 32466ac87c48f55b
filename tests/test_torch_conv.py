"""The port's convolution, pooling, batch-norm and cross-entropy ops
(``paddle_tpu_torch/ops/nn_ops.py``, ``loss_ops.py``) and their layers,
against the JAX package, on the CPU.

Twins of ``tests/ops/test_op_numerics.py``'s conv2d (:136, the numpy
golden), pool2d max/avg (:156), global pooling (:172) and batch_norm's
training statistics (:191, x * 3 + 5), with more cases: depthwise and
grouped convolution, dilation, a bias, padded pools (exclusive or not,
and padding wider than half the window), adaptive pooling with and
without the argmax mask, batch_norm in test mode and under
use_global_stats, the running statistics, cross_entropy with
ignore_index and with soft labels, and sigmoid.

Each case builds the same one-layer Program in both packages: the input
is a parameter (so its gradient is computed), the loss is
mean(out * rw) with a fixed random rw of out's shape, and an SGD step at
rate 0 makes the backward. Both start from the same numpy values, so
the forward, the loss and every parameter's @GRAD (the JAX side's from
``jax.value_and_grad``) are compared. Tolerances: outputs and losses
1e-5 relative + 1e-6 absolute, @GRADs 1e-4 relative + 1e-6 absolute,
unless a test states otherwise (f32 on both sides; the port's
convolution is a full f32 product).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import layers as jlayers
from paddle_tpu.core import unique_name as jun
from paddle_tpu.core.executor import Scope as JScope, scope_guard as jguard

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.core import unique_name as tun
from paddle_tpu_torch.ops import nn_ops

OUT_RTOL, OUT_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
CPU = fluid.CPUPlace()
RS = np.random.RandomState(0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_bert.py: concurrent pytest workers oversubscribe the
    CPU otherwise)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _twin(net, inputs, values=None, feed=None, extra=(), is_test=False):
    """Run net(pkg, L, v) in both packages, `v` the parameters made from
    `inputs` ({name: array}); `values` sets the layers' own parameters
    and persistables by name after JAX's startup, whose scope then
    carries over to the port (``scope_from_numpy``); `feed` feeds data
    variables that net declares. Returns ({name: array} JAX, port) with
    "out", "loss", every parameter's @GRAD and the `extra` names read
    from the scope after the step."""
    results = []
    start = None
    for pkg, L, un in ((jfluid, jlayers, jun), (fluid, tlayers, tun)):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 3
        with un.guard(), pkg.program_guard(main, startup):
            v = {n: L.create_parameter(list(a.shape), "float32", name=n)
                 for n, a in inputs.items()}
            out = net(pkg, L, v)
            w = L.create_parameter(list(out.shape), "float32", name="rw")
            loss = L.mean(L.elementwise_mul(out, w))
            if is_test:
                main = main.clone(for_test=True)
            else:
                pkg.optimizer.SGDOptimizer(0.0).minimize(loss)
        names = [] if is_test else sorted(
            p.name for p in main.all_parameters())
        fetch = [out, loss] + [n + "@GRAD" for n in names]
        if pkg is jfluid:
            scope, exe = JScope(), jfluid.Executor()
            rw = np.random.RandomState(9).randn(*out.shape)
            with jguard(scope):
                exe.run(startup)
                for n, a in dict(inputs, rw=rw, **(values or {})).items():
                    scope.set(n, np.array(a, np.float32))
                start = {n: np.array(scope.get(n)) for n in scope.names()}
                got = exe.run(main, feed=feed or {}, fetch_list=fetch)
            after = {n: np.asarray(scope.get(n)) for n in extra}
        else:
            scope = fluid.scope_from_numpy(start, "cpu")
            got = fluid.Executor(CPU).run(main, feed=feed or {},
                                          fetch_list=fetch, scope=scope)
            after = {n: scope.get(n).numpy() for n in extra}
        res = dict(zip(["out", "loss"] + [n + "@GRAD" for n in names], got))
        res.update(after)
        results.append(res)
    return results


def _assert_twin(jax_res, port_res):
    assert set(jax_res) == set(port_res)
    for name, want in jax_res.items():
        got = port_res[name]
        assert np.shape(got) == np.shape(want), name
        grad = name.endswith("@GRAD")
        np.testing.assert_allclose(
            got, want, rtol=GRAD_RTOL if grad else OUT_RTOL,
            atol=GRAD_ATOL if grad else OUT_ATOL, err_msg=name)


# ---------------------------------------------------------------- conv2d

def _conv2d_np(x, w, stride=1, pad=0):
    n, c, h, wd = x.shape
    o, _, kh, kw = w.shape
    xp = np.pad(x, ((0, 0), (0, 0), (pad, pad), (pad, pad)))
    oh = (h + 2 * pad - kh) // stride + 1
    ow = (wd + 2 * pad - kw) // stride + 1
    out = np.zeros((n, o, oh, ow), np.float32)
    for i in range(oh):
        for j in range(ow):
            patch = xp[:, :, i * stride:i * stride + kh,
                       j * stride:j * stride + kw]
            out[:, :, i, j] = np.einsum("nchw,ochw->no", patch, w)
    return out


def test_conv2d_matches_numpy_and_jax():
    """test_op_numerics.py:136: a 3x3 stride-2 pad-1 convolution equals
    the numpy golden (at the reference test's rtol 1e-3, atol 1e-4) and
    JAX's forward and gradients at this file's tolerances."""
    x = RS.randn(2, 3, 8, 8).astype(np.float32)
    w = RS.randn(4, 3, 3, 3).astype(np.float32)

    def net(pkg, L, v):
        return L.conv2d(v["x"], num_filters=4, filter_size=3, stride=2,
                        padding=1, bias_attr=False,
                        param_attr=pkg.ParamAttr(name="cw"))

    want, got = _twin(net, {"x": x}, {"cw": w})
    np.testing.assert_allclose(got["out"], _conv2d_np(x, w, 2, 1),
                               rtol=1e-3, atol=1e-4)
    _assert_twin(want, got)


@pytest.mark.parametrize("case", ["depthwise", "grouped", "dilated",
                                  "bias_relu"])
def test_conv2d_variants_match_jax(case):
    """Depthwise (groups == channels, two filters a channel: the layer
    appends depthwise_conv2d in both packages), grouped (groups 2),
    dilation 2 with stride 1, and a bias with relu: forward and
    gradients."""
    x = RS.randn(2, 4, 9, 9).astype(np.float32)
    kw = {"depthwise": dict(num_filters=8, groups=4, padding=1),
          "grouped": dict(num_filters=6, groups=2, stride=2),
          "dilated": dict(num_filters=5, dilation=2, padding=2),
          "bias_relu": dict(num_filters=3, padding=1, act="relu")}[case]

    def net(pkg, L, v):
        out = L.conv2d(v["x"], filter_size=3,
                       bias_attr=None if case == "bias_relu" else False,
                       **kw)
        types = [op.type for op in
                 pkg.default_main_program().global_block().ops]
        assert ("depthwise_conv2d" in types) == (case == "depthwise")
        return out

    want, got = _twin(net, {"x": x})
    _assert_twin(want, got)


def test_conv2d_filter_init_is_msra_normal():
    """The layer's filter draws from N(0, 2 / fan_in): the startup's
    values have that mean and std (the streams are torch's, not JAX's;
    1 % of a large draw)."""
    main, startup = fluid.Program(), fluid.Program()
    with tun.guard(), fluid.program_guard(main, startup):
        x = tlayers.data("x", shape=[64, 8, 8], dtype="float32")
        tlayers.conv2d(x, num_filters=256, filter_size=3,
                       param_attr=fluid.ParamAttr(name="cw"))
    scope = fluid.Scope()
    fluid.Executor(CPU).run(startup, scope=scope)
    w = scope.get("cw").numpy()
    assert w.shape == (256, 64, 3, 3)
    std = (2.0 / (64 * 9)) ** 0.5
    assert abs(w.mean()) < 0.01 * std
    assert abs(w.std() / std - 1.0) < 0.01


def test_conv2d_precision_is_f32_whatever_the_process_flag(monkeypatch):
    """The op's convolution runs with cuDNN's TF32 off and restores the
    caller's flag, in the forward and in the backward (autograd runs it
    after the forward's context closed)."""
    seen = []
    cudnn = torch.backends.cudnn
    real_fwd = torch.nn.functional.conv2d
    real_bwd = torch.ops.aten.convolution_backward

    def spy(real, tag):
        def call(*a, **k):
            seen.append((tag, cudnn.allow_tf32))
            return real(*a, **k)
        return call

    monkeypatch.setattr(cudnn, "allow_tf32", True)
    monkeypatch.setattr(nn_ops.F, "conv2d", spy(real_fwd, "fwd"))
    monkeypatch.setattr(torch.ops.aten, "convolution_backward",
                        spy(real_bwd, "bwd"))
    x = torch.randn(2, 3, 6, 6, requires_grad=True)
    w = torch.randn(4, 3, 3, 3, requires_grad=True)
    out = nn_ops._Conv2d.apply(x, w, (1, 1), (1, 1), (1, 1), 1)
    assert cudnn.allow_tf32 is True
    out.sum().backward()
    assert cudnn.allow_tf32 is True
    assert seen == [("fwd", False), ("bwd", False)]
    ref = real_fwd(x.detach().double(), w.detach().double(), padding=1)
    np.testing.assert_allclose(out.detach().double(), ref, rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------- pools

def test_pool2d_max_and_avg_match_numpy_and_jax():
    """test_op_numerics.py:156: 2x2 stride-2 max and average pooling
    equal the reshaped max / mean (rtol 1e-6 / 1e-5 as there) and
    JAX's."""
    x = RS.randn(2, 3, 6, 6).astype(np.float32)
    golden = {"max": x.reshape(2, 3, 3, 2, 3, 2).max((3, 5)),
              "avg": x.reshape(2, 3, 3, 2, 3, 2).mean((3, 5))}
    for ptype in ("max", "avg"):
        want, got = _twin(lambda pkg, L, v: L.pool2d(
            v["x"], pool_size=2, pool_stride=2, pool_type=ptype),
            {"x": x})
        np.testing.assert_allclose(got["out"], golden[ptype], rtol=1e-5)
        _assert_twin(want, got)


@pytest.mark.parametrize("ptype", ["max", "avg"])
def test_global_pooling_matches_numpy_and_jax(ptype):
    """test_op_numerics.py:172: global pooling over 7 x 7 is the plane's
    mean (or max), and JAX's."""
    x = RS.randn(2, 3, 7, 7).astype(np.float32)
    want, got = _twin(lambda pkg, L, v: L.pool2d(
        v["x"], global_pooling=True, pool_type=ptype), {"x": x})
    golden = x.mean((2, 3)) if ptype == "avg" else x.max((2, 3))
    np.testing.assert_allclose(got["out"][:, :, 0, 0], golden, rtol=1e-5)
    _assert_twin(want, got)


@pytest.mark.parametrize("ptype,k,s,p,exclusive", [
    ("max", 3, 2, 1, True),       # ResNet's stem pool
    ("avg", 3, 2, 1, True),       # exclusive: divide by the real cells
    ("avg", 3, 2, 1, False),      # divide by the window's 9
    ("max", 3, 1, 2, True),       # padding wider than half the window
    ("avg", 3, 1, 2, True),
    ("avg", 2, 2, 2, False)])
def test_padded_pools_match_jax(ptype, k, s, p, exclusive):
    x = RS.randn(2, 3, 7, 7).astype(np.float32)
    want, got = _twin(lambda pkg, L, v: L.pool2d(
        v["x"], pool_size=k, pool_stride=s, pool_padding=p,
        pool_type=ptype, exclusive=exclusive), {"x": x})
    _assert_twin(want, got)


@pytest.mark.parametrize("ptype,size,index", [
    ("avg", 3, False), ("max", 3, False), ("max", (3, 2), True),
    ("avg", 4, False)])
def test_adaptive_pool2d_matches_jax(ptype, size, index):
    """adaptive_pool2d over 7 x 8 (floor/ceil windows, overlapping where
    the size does not divide) and 8 x 8 into 4 (uniform windows); with
    require_index the argmax Mask equals JAX's (int32, a flat index into
    the input plane)."""
    hw = (8, 8) if size == 4 else (7, 8)
    x = RS.randn(2, 3, *hw).astype(np.float32)

    def net(pkg, L, v):
        res = L.adaptive_pool2d(v["x"], size, pool_type=ptype,
                                require_index=index)
        return res[0] if index else res

    want, got = _twin(net, {"x": x})
    _assert_twin(want, got)
    if index:
        jm, tm = _mask_pair(x, size)
        assert tm.dtype == np.int32
        np.testing.assert_array_equal(tm, jm)


def _mask_pair(x, size):
    """(JAX, port) argmax masks of adaptive max pooling of `x`, forward
    only."""
    out = []
    for pkg, L, un in ((jfluid, jlayers, jun), (fluid, tlayers, tun)):
        main, startup = pkg.Program(), pkg.Program()
        with un.guard(), pkg.program_guard(main, startup):
            xv = L.data("x", shape=list(x.shape[1:]), dtype="float32")
            _o, mask = L.adaptive_pool2d(xv, size, pool_type="max",
                                         require_index=True)
        if pkg is jfluid:
            with jguard(JScope()):
                m, = jfluid.Executor().run(main, feed={"x": x},
                                           fetch_list=[mask])
        else:
            m, = fluid.Executor(CPU).run(main, feed={"x": x},
                                         fetch_list=[mask],
                                         scope=fluid.Scope())
        out.append(np.asarray(m))
    return out


def test_adaptive_pool2d_layer_refusals_equal_jax():
    for L in (jlayers, tlayers):
        with pytest.raises(ValueError, match="Unknown pool_type"):
            L.adaptive_pool2d(None, 2, pool_type="min")
        with pytest.raises(ValueError, match="require_index"):
            L.adaptive_pool2d(None, 2, pool_type="avg", require_index=True)


# ---------------------------------------------------------------- batch_norm

BN_STATS = ("bn_mean", "bn_var")


def _bn_net(**kw):
    def net(pkg, L, v):
        return L.batch_norm(v["x"], moving_mean_name="bn_mean",
                            moving_variance_name="bn_var",
                            param_attr=pkg.ParamAttr(name="bn_scale"),
                            bias_attr=pkg.ParamAttr(name="bn_bias"), **kw)
    return net


def _bn_values(c, rs):
    return {"bn_scale": rs.rand(c).astype(np.float32) + 0.5,
            "bn_bias": rs.randn(c).astype(np.float32),
            "bn_mean": rs.randn(c).astype(np.float32),
            "bn_var": rs.rand(c).astype(np.float32) + 0.5}


def test_batch_norm_training_stats_match_numpy_and_jax():
    """test_op_numerics.py:191 on x * 3 + 5: with the default scale 1
    and bias 0 the output has mean 0 and std 1 per channel (atol 1e-4 /
    1e-3 as there). With a random scale, bias and running statistics,
    Y, the gradients and the running mean and variance after the step
    (momentum 0.9 x old + 0.1 x the batch's, the biased variance) equal
    JAX's and numpy's."""
    x = (RS.randn(8, 3, 4, 4) * 3 + 5).astype(np.float32)
    want, got = _twin(_bn_net(), {"x": x})
    np.testing.assert_allclose(got["out"].mean((0, 2, 3)), np.zeros(3),
                               atol=1e-4)
    np.testing.assert_allclose(got["out"].std((0, 2, 3)), np.ones(3),
                               atol=1e-3)
    vals = _bn_values(3, np.random.RandomState(4))
    want, got = _twin(_bn_net(momentum=0.8), {"x": x}, vals,
                      extra=BN_STATS)
    _assert_twin(want, got)
    np.testing.assert_allclose(
        got["bn_mean"], 0.8 * vals["bn_mean"] + 0.2 * x.mean((0, 2, 3)),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        got["bn_var"], 0.8 * vals["bn_var"] + 0.2 * x.var((0, 2, 3)),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["is_test", "use_global_stats",
                                  "clone_for_test"])
def test_batch_norm_with_running_stats_matches_jax(mode):
    """is_test=True, use_global_stats=True, or the program cloned for
    test: Y normalizes with the running statistics, which stay as they
    were; forward (and, where the program trains, gradients) equal
    JAX's."""
    x = RS.randn(4, 3, 5, 5).astype(np.float32)
    vals = _bn_values(3, np.random.RandomState(5))
    kw = {"is_test": dict(is_test=True),
          "use_global_stats": dict(use_global_stats=True),
          "clone_for_test": {}}[mode]
    want, got = _twin(_bn_net(**kw), {"x": x}, vals, extra=BN_STATS,
                      is_test=mode == "clone_for_test")
    _assert_twin(want, got)
    golden = (x - vals["bn_mean"][:, None, None]) / np.sqrt(
        vals["bn_var"][:, None, None] + 1e-5) * \
        vals["bn_scale"][:, None, None] + vals["bn_bias"][:, None, None]
    np.testing.assert_allclose(got["out"], golden, rtol=1e-5, atol=1e-5)
    for n in BN_STATS:
        np.testing.assert_array_equal(got[n], vals[n])


def test_batch_norm_nhwc_matches_jax():
    x = RS.randn(4, 5, 5, 3).astype(np.float32)
    want, got = _twin(_bn_net(data_layout="NHWC"), {"x": x},
                      _bn_values(3, np.random.RandomState(6)),
                      extra=BN_STATS)
    _assert_twin(want, got)


def test_batch_norm_saved_stats_are_the_batch_stats():
    """SavedMean / SavedVariance: the batch's statistics in training,
    zeros with the running ones, as the JAX op returns them."""
    x = torch.from_numpy(RS.randn(4, 3, 2, 2).astype(np.float32))

    class Op:
        type = "batch_norm"

        def __init__(self, attrs):
            self.attrs = attrs

        def input(self, slot):
            return [slot] if slot in env else []

        def output(self, slot):
            return [slot]

    env = {"X": x, "Scale": torch.ones(3), "Bias": torch.zeros(3),
           "Mean": torch.zeros(3), "Variance": torch.ones(3)}
    out = nn_ops.batch_norm(tops.OpContext(Op({}), env, None))
    var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
    torch.testing.assert_close(out["SavedMean"], mean)
    torch.testing.assert_close(out["SavedVariance"], var)
    test = nn_ops.batch_norm(tops.OpContext(Op({"is_test": True}), env,
                                            None))
    assert not test["SavedMean"].any() and not test["SavedVariance"].any()


# ---------------------------------------------------------------- losses

def test_cross_entropy_hard_labels_with_ignore_index_match_jax():
    """Probabilities from a softmax, hard labels with two rows at the
    ignore_index: their loss rows are 0 and take no gradient; the others
    equal -log p[label] and JAX's."""
    logits = RS.randn(6, 5).astype(np.float32)
    label = RS.randint(0, 3, (6, 1)).astype(np.int64)
    label[[1, 4]] = 3
    feed = {"label": label}

    def net(pkg, L, v):
        lbl = L.data("label", shape=[1], dtype="int64")
        return L.cross_entropy(L.softmax(v["logits"]), lbl, ignore_index=3)

    want, got = _twin(net, {"logits": logits}, feed=feed)
    _assert_twin(want, got)
    p = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    golden = -np.log(p[np.arange(6), label[:, 0]])[:, None]
    golden[[1, 4]] = 0.0
    np.testing.assert_allclose(got["out"], golden, rtol=1e-5, atol=1e-6)
    assert not got["logits@GRAD"][[1, 4]].any()


def test_cross_entropy_soft_labels_match_jax():
    probs = RS.dirichlet(np.ones(4), 5).astype(np.float32)
    soft = RS.dirichlet(np.ones(4), 5).astype(np.float32)
    probs[0, 1] = 0.0        # clipped to 1e-15 before the log

    def net(pkg, L, v):
        lbl = L.data("soft", shape=[4], dtype="float32")
        return L.cross_entropy(v["probs"], lbl, soft_label=True)

    want, got = _twin(net, {"probs": probs}, feed={"soft": soft})
    np.testing.assert_allclose(got["out"], -(soft * np.log(
        np.clip(probs, 1e-15, 1.0))).sum(1, keepdims=True), rtol=1e-5)
    _assert_twin(want, got)


def test_sigmoid_matches_jax():
    x = RS.randn(4, 6).astype(np.float32)
    want, got = _twin(lambda pkg, L, v: L.sigmoid(v["x"]), {"x": x})
    _assert_twin(want, got)


def test_new_ops_are_registered_with_dp_rules():
    for name in ("conv2d", "depthwise_conv2d", "pool2d", "adaptive_pool2d",
                 "batch_norm", "sync_batch_norm", "cross_entropy",
                 "cross_entropy2", "sigmoid"):
        assert name in tops._REGISTRY and tops._DP_RULES[name] is not None
    assert tops._REGISTRY["batch_norm"] is tops._REGISTRY["sync_batch_norm"]
    assert tops._DP_RULES["batch_norm"] is nn_ops._dp_batch_norm
