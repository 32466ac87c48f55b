"""The port's ``models/detection_demo.py`` against the JAX package, on the
CPU: SSD training (``build_ssd_net``), SSD inference through
``detection_output`` (``build_infer_net``) and Faster R-CNN training
(``build_faster_rcnn_train``).

Each program has the JAX program's op types and parameters. The SSD
twin (``tests/models/test_model_zoo.py:256``'s net and feed) holds the
losses of two Adam steps and every @GRAD of each against JAX's from one
carried-over scope, and at dp 2 on a local mesh against dp 1. The
inference net gives JAX's (N, keep_top_k, 6) rows. Faster R-CNN at image
64 with rpn_samples 384 and rcnn_samples 112 takes every anchor and every
roi into its samples (192 anchors fill at most 192 fg and 192 bg slots;
24 proposals and 4 gt boxes at most 28 fg and 84 bg slots), so the
draws are sets and the first step's loss and @GRADs match JAX's, and
the second step's loss (the inputs keep every IoU at least 1e-4 from
its threshold: asserted).
At the JAX test's own sizes (``:315``) the port's loss halves in 20 Adam
steps, the bar that test sets, with no JAX run as its oracle.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu.core import unique_name as jun
from paddle_tpu.core.executor import Scope as JScope, scope_guard as jguard
from paddle_tpu.models import detection_demo as jdd

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import unique_name as tun
from paddle_tpu_torch.models import detection_demo as tdd

from test_torch_detection_ops import close

CPU = fluid.CPUPlace()
# losses against JAX's from one scope: 1e-5 relative (measured at most
# 2e-7 on the first step of each net)
LOSS_RTOL = 1e-5
# each @GRAD within 1e-4 of its own largest entry (measured at most
# 1.4e-6 for SSD, 1.3e-5 for Faster R-CNN's first step: the sampled rows
# sum in another order)
GRAD_TOL = 1e-4
# dp 2 against dp 1 in the port: the same f32 step split over two
# ranks (the batch statistics and the loss mean sum in another order)
DP_LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_bert.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _build(pkg, un, fn, lr=None, seed=5):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with un.guard(), pkg.program_guard(main, startup):
        out = fn()
        if lr is not None:
            pkg.optimizer.AdamOptimizer(learning_rate=lr).minimize(out)
    return main, startup, out


class Twin:
    """A detection program built in both packages (fn(dd) with each
    package's detection_demo), run from JAX's startup values."""

    def __init__(self, fn, lr=None):
        self.j = _build(jfluid, jun, lambda: fn(jdd), lr)
        self.t = _build(fluid, tun, lambda: fn(tdd), lr)
        scope = JScope()
        with jguard(scope):
            jfluid.Executor().run(self.j[1])
            self.init = {n: np.array(scope.get(n)) for n in scope.names()}

    def assert_graph(self):
        jm, tm = self.j[0], self.t[0]
        assert [o.type for o in tm.global_block().ops] == \
            [o.type for o in jm.global_block().ops]
        assert [(p.name, tuple(p.shape)) for p in tm.all_parameters()] == \
            [(p.name, tuple(p.shape)) for p in jm.all_parameters()]

    def grads(self):
        return [p.name + "@GRAD" for p in self.t[0].all_parameters()]

    def jax_runs(self, feeds, fetch):
        out = []
        scope = JScope()
        for n, v in self.init.items():
            scope.set(n, jnp.asarray(v))
        with jguard(scope):
            exe = jfluid.Executor()
            for f in feeds:
                out.append([np.asarray(v) for v in exe.run(
                    self.j[0], feed=f, fetch_list=[self.j[2]] + fetch)])
        return out

    def port_runs(self, feeds, fetch, program=None):
        scope = fluid.scope_from_numpy(self.init, "cpu")
        exe = fluid.Executor(CPU)
        return [[np.asarray(v) for v in exe.run(
            program or self.t[0], feed=f, fetch_list=[self.t[2]] + fetch,
            scope=scope)] for f in feeds]

    def assert_steps(self, feeds, grad_steps=None):
        """Each step's loss, and the @GRADs of the first `grad_steps`
        (all), against JAX's."""
        names = self.grads()
        want = self.jax_runs(feeds, names)
        got = self.port_runs(feeds, names)
        for step, (w, g) in enumerate(zip(want, got)):
            np.testing.assert_allclose(g[0], w[0], rtol=LOSS_RTOL)
            if grad_steps is not None and step >= grad_steps:
                continue
            for name, a, b in zip(names, g[1:], w[1:]):
                scale = max(float(np.abs(b).max()), 1e-12)
                err = float(np.abs(a - b).max())
                assert err <= GRAD_TOL * scale, (name, err, scale)
        return [float(np.asarray(g[0]).reshape(-1)[0]) for g in got]


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------

def _ssd(dd):
    return dd.build_ssd_net(num_classes=4, image_size=64, max_boxes=4)[3]


def _ssd_feeds(n=2, b=2, seed=0):
    """test_model_zoo.py:262's feed, n batches."""
    rng = np.random.RandomState(seed)
    feeds = []
    for _ in range(n):
        boxes = np.sort(rng.rand(b, 4, 4).astype(np.float32), axis=-1)
        feeds.append({
            "img": rng.randn(b, 3, 64, 64).astype(np.float32),
            "gt_box": boxes,
            "gt_label": rng.randint(1, 4, (b, 4, 1)).astype(np.int64)})
    return feeds


def test_ssd_two_steps_match_jax():
    """test_model_zoo.py:256 (two Adam(1e-4) steps): each step's loss and
    every @GRAD as JAX's from one scope, finite."""
    twin = Twin(_ssd, lr=1e-4)
    twin.assert_graph()
    losses = twin.assert_steps(_ssd_feeds())
    assert np.isfinite(losses).all()


def test_ssd_dp2_matches_dp1():
    """The SSD step at dp 2 on a local mesh (two CPU ranks, 2 images
    each) against dp 1: the loss and every @GRAD; the priors stay
    replicated, ssd_loss runs a rank's images, the batch norms and the
    mean take the global batch."""
    twin = Twin(_ssd, lr=1e-4)
    feed = _ssd_feeds(1, b=4, seed=3)[0]
    names = twin.grads()
    runs = []
    for places in ([CPU], [CPU] * 2):
        comp = fluid.CompiledProgram(twin.t[0]).with_data_parallel(
            loss_name=twin.t[2].name, places=places)
        runs.append(twin.port_runs([feed], names, program=comp)[0])
    one, two = runs
    np.testing.assert_allclose(two[0], one[0], rtol=DP_LOSS_RTOL)
    for name, a, b in zip(names, two[1:], one[1:]):
        scale = max(float(np.abs(b).max()), 1e-12)
        assert float(np.abs(a - b).max()) <= GRAD_TOL * scale, name


def test_ssd_infer_net_matches_jax():
    """build_infer_net at image 128 (1408 priors, detection_output's
    defaults: nms_top_k 400, keep_top_k 200): JAX's (2, 200, 6) rows."""
    twin = Twin(lambda dd: dd.build_infer_net(num_classes=4,
                                              image_size=128)[1])
    twin.assert_graph()
    feed = {"img": np.random.RandomState(8).randn(2, 3, 128, 128)
            .astype(np.float32)}
    want = twin.jax_runs([feed], [])[0][0]
    got = twin.port_runs([feed], [])[0][0]
    assert got.shape == (2, 200, 6)
    close(got, want)
    assert (got[..., 0] >= 1).sum() > 0


# ---------------------------------------------------------------------------
# Faster R-CNN
# ---------------------------------------------------------------------------

def _rcnn_feed(seed=11, b=2, s=64, g=4):
    """test_model_zoo.py:316's batch."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(4, 30, (b, g, 2)).astype(np.float32)
    return {"img": rng.standard_normal((b, 3, s, s)).astype(np.float32),
            "gt_box": np.concatenate(
                [base, base + rng.uniform(10, 24, (b, g, 2))
                 .astype(np.float32)], -1),
            "gt_label": rng.integers(1, 5, (b, g)).astype(np.int64),
            "im_info": np.tile(np.array([s, s, 1.0], np.float32), (b, 1))}


def _iou(a, b):
    """(..., M, 4) x (..., G, 4) -> (..., M, G), no +1 (the ops')."""
    ix1 = np.maximum(a[..., :, None, 0], b[..., None, :, 0])
    iy1 = np.maximum(a[..., :, None, 1], b[..., None, :, 1])
    ix2 = np.minimum(a[..., :, None, 2], b[..., None, :, 2])
    iy2 = np.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = np.maximum(ix2 - ix1, 0) * np.maximum(iy2 - iy1, 0)
    area = lambda x: np.maximum(x[..., 2] - x[..., 0], 0) * np.maximum(
        x[..., 3] - x[..., 1], 0)
    return inter / np.maximum(area(a)[..., :, None] + area(b)[..., None, :]
                              - inter, 1e-10)


def _margin(iou, thresholds):
    return min(float(np.abs(iou - t).min()) for t in thresholds)


def _var_of(program, op_type, slot):
    op = next(o for o in program.global_block().ops if o.type == op_type)
    return op.output(slot)[0]


def test_faster_rcnn_first_step_matches_jax():
    """Every anchor and roi sampled (image 64, rpn_samples 384,
    rcnn_samples 112): the first step's loss and every @GRAD, and the
    second step's loss, as JAX's (the second step's @GRADs are not held:
    Adam's first update is about lr x sign(g), which a gradient near 0
    flips between the two packages); the anchors' IoUs with the gt boxes keep
    1e-4 from 0.3 and 0.7, the proposals' (and the gt boxes') from 0.5."""
    twin = Twin(lambda dd: dd.build_faster_rcnn_train(
        rpn_samples=384, rcnn_samples=112)[-1], lr=1e-3)
    twin.assert_graph()
    feed = _rcnn_feed()
    rois = _var_of(twin.j[0], "generate_proposals", "RpnRois")
    anchors = _var_of(twin.j[0], "anchor_generator", "Anchors")
    r, a = twin.jax_runs([feed], [rois, anchors])[0][1:]
    gt = feed["gt_box"]
    assert _margin(_iou(a.reshape(-1, 4), gt), (0.3, 0.7)) > 1e-4
    cand = np.concatenate([r, gt], 1)
    ok = (cand[..., 2] > cand[..., 0]) & (cand[..., 3] > cand[..., 1])
    assert _margin(_iou(cand, gt)[ok], (0.5,)) > 1e-4
    twin.assert_steps([feed, feed], grad_steps=1)


def test_faster_rcnn_loss_halves_in_20_steps():
    """test_model_zoo.py:315 on the port alone: at the JAX test's sizes
    (rpn_samples 32, rcnn_samples 16: real draws) 20 Adam(1e-3) steps on
    the fixed batch bring the loss under half its first value."""
    main, startup, loss = _build(
        fluid, tun, lambda: tdd.build_faster_rcnn_train(
            num_classes=5, image_size=64, max_gt=4)[-1], lr=1e-3)
    exe = fluid.Executor(CPU)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = _rcnn_feed()
    losses = [float(np.asarray(exe.run(main, feed=feed, fetch_list=[loss],
                                       scope=scope)[0]).reshape(-1)[0])
              for _ in range(20)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.5, losses
