"""The slice's two metric paths through the port's Fluid entry points,
against the JAX package on the CPU, from JAX's startup values carried
over by ``fluid.scope_from_numpy``:

- DeepFM (``models/deepfm.py``) at 3 fields x 1,000 features with the
  streaming ``layers.auc`` in the training Program, as Fluid 1.5's CTR
  recipe trains: three Adam steps over a new batch each, each step's
  loss and AUC and the persistable statistics after it equal to JAX's;
  and the same Program at dp 2 against dp 1 (the global batch counted
  once: the statistics sum to the examples seen).
- DeepLabv3+ (``models/deeplab.py``) at ``tests/models/test_deeplab.py``'s
  size (16 x 16, 4 classes, base 8) with ``layers.argmax`` of the
  transposed logits and ``layers.mean_iou`` in the Program
  (``test_deeplab.py:26-28``): the mean IoU, OutWrong and OutCorrect of
  a training step equal to JAX's on the same weights and batch.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import layers as jlayers
from paddle_tpu.core import unique_name as jun
from paddle_tpu.core.executor import Scope as JScope, scope_guard as jguard
from paddle_tpu.models import deeplab as jdeeplab
from paddle_tpu.models import deepfm as jdeepfm

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.core import unique_name as tun
from paddle_tpu_torch.models import deeplab as tdeeplab
from paddle_tpu_torch.models import deepfm as tdeepfm

from test_torch_tensor_ops import close

CPU = fluid.CPUPlace()
# losses within 1e-6 relative of JAX's (Adam's steps from one scope;
# the CTR twins of test_torch_ctr.py measured at most 8.7e-8), each AUC
# within 1e-6; the histograms and the confusion matrix are counts, equal
LOSS_RTOL = 1e-6
# dp 2 against dp 1: the same numbers but each rank's summation order
DP_TOL = 1e-6
AUC_THRESHOLDS = 4095


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_bert.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _build(pkg, un, net, seed=11):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with un.guard(), pkg.program_guard(main, startup):
        fetch = net(pkg)
    return main, startup, fetch


def _jax_init(jstart):
    scope = JScope()
    with jguard(scope):
        jfluid.Executor().run(jstart)
    return {n: np.asarray(scope.get(n)) for n in scope.names()}


def _jscope(init):
    import jax.numpy as jnp
    scope = JScope()
    for n, v in init.items():
        scope.set(n, jnp.asarray(v))
    return scope


def _deepfm_auc(pkg):
    """DeepFM at 1,000 features, 3 fields, embed 8, Adam(1e-2), with
    layers.auc(prob, label) in the Program: [loss, auc, stat_pos,
    stat_neg]."""
    m, L = (jdeepfm, jlayers) if pkg is jfluid else (tdeepfm, tlayers)
    _i, _v, label, loss, prob = m.build_train_net(
        num_features=1000, num_fields=3, embed_dim=8)
    auc, _batch, stats = L.auc(prob, label, num_thresholds=AUC_THRESHOLDS)
    pkg.optimizer.AdamOptimizer(learning_rate=1e-2).minimize(loss)
    return [loss, auc] + stats


def _deepfm_feeds(steps, batch=64, seed=3):
    rs = np.random.RandomState(seed)
    return [{"feat_ids": rs.randint(0, 1000, (batch, 3)).astype(np.int64),
             "feat_vals": rs.rand(batch, 3).astype(np.float32),
             "label": rs.randint(0, 2, (batch, 1)).astype(np.float32)}
            for _ in range(steps)]


def test_deepfm_streaming_auc_equals_jax():
    """Three steps, one new batch of 64 each: each step's loss, AUC and
    statistics (which add up the batches seen: 64, 128, 192 examples)
    equal to the JAX Executor's from the same startup values."""
    jmain, jstart, jf = _build(jfluid, jun, _deepfm_auc)
    tmain, _ts, tf = _build(fluid, tun, _deepfm_auc)
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    init = _jax_init(jstart)
    assert {tf[2].name, tf[3].name} <= set(init)
    feeds = _deepfm_feeds(3)
    jscope, tscope = _jscope(init), fluid.scope_from_numpy(init, "cpu")
    jexe, texe = jfluid.Executor(), fluid.Executor(CPU)
    for i, feed in enumerate(feeds):
        with jguard(jscope):
            want = [np.asarray(v) for v in jexe.run(jmain, feed=feed,
                                                    fetch_list=jf)]
        got = texe.run(tmain, feed=feed, fetch_list=tf, scope=tscope)
        close(got[0], want[0], rtol=LOSS_RTOL, name="loss")
        close(got[1], want[1], rtol=LOSS_RTOL, name="auc")
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(got[3], want[3])
        assert got[2].sum() + got[3].sum() == 64 * (i + 1)


def test_deepfm_streaming_auc_at_dp2_counts_the_global_batch():
    """The same Program through with_data_parallel at dp 2 against dp 1
    over three steps: the statistics equal (each rank's histograms
    summed once: they count 192 examples, not half or twice that), the
    AUCs and losses within DP_TOL."""
    main, startup, f = _build(fluid, tun, _deepfm_auc)
    feeds = _deepfm_feeds(3, seed=4)
    runs = {}
    for dp in (1, 2):
        scope, exe = fluid.Scope(), fluid.Executor(CPU)
        exe.run(startup, scope=scope)
        comp = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=f[0].name, places=[CPU] * dp)
        runs[dp] = [exe.run(comp, feed=feed, fetch_list=f, scope=scope)
                    for feed in feeds]
    for one, two in zip(runs[1], runs[2]):
        close(two[0], one[0], rtol=DP_TOL)
        close(two[1], one[1], rtol=DP_TOL)
        np.testing.assert_array_equal(two[2], one[2])
        np.testing.assert_array_equal(two[3], one[3])
    assert runs[2][-1][2].sum() + runs[2][-1][3].sum() == 192


def _deeplab_miou(pkg, h=16, nc=4):
    m, L = (jdeeplab, jlayers) if pkg is jfluid else (tdeeplab, tlayers)
    _img, label, loss, logits = m.build_train_net(
        img_shape=(3, h, h), num_classes=nc, base_filters=8)
    pred = L.transpose(logits, [0, 2, 3, 1])
    miou, wrong, correct = L.mean_iou(
        L.reshape(L.argmax(pred, axis=-1), [-1, h, h]), label, nc)
    pkg.optimizer.AdamOptimizer(learning_rate=3e-3).minimize(loss)
    return [loss, miou, wrong, correct, logits]


def test_deeplab_mean_iou_in_the_program_equals_jax():
    """test_deeplab.py's net and quadrant masks: a training step's loss,
    and the mean IoU, OutWrong and OutCorrect that argmax + mean_iou give
    in the Program, equal to JAX's on the same weights; the IoU agrees
    with numpy's of the fetched logits' argmax."""
    rng = np.random.RandomState(1)
    b, nc, h = 2, 4, 16
    imgs = rng.rand(b, 3, h, h).astype(np.float32)
    yy, xx = np.meshgrid(np.arange(h), np.arange(h), indexing="ij")
    base = (yy // (h // 2)) * 2 + (xx // (h // 2))
    masks = np.stack([base % nc, (base + 1) % nc]).astype(np.int64)
    feed = {"pixels": imgs, "label": masks}
    jmain, jstart, jf = _build(jfluid, jun, _deeplab_miou)
    tmain, _ts, tf = _build(fluid, tun, _deeplab_miou)
    init = _jax_init(jstart)
    with jguard(_jscope(init)):
        want = [np.asarray(v) for v in jfluid.Executor().run(
            jmain, feed=feed, fetch_list=jf)]
    got = fluid.Executor(CPU).run(tmain, feed=feed, fetch_list=tf,
                                  scope=fluid.scope_from_numpy(init, "cpu"))
    close(got[0], want[0], rtol=LOSS_RTOL, name="loss")
    close(got[1], want[1], rtol=LOSS_RTOL, name="miou")
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    pred = got[4].argmax(1)
    cm = np.zeros((nc, nc))
    np.add.at(cm, (masks.reshape(-1), pred.reshape(-1)), 1)
    inter = np.diag(cm)
    union = cm.sum(0) + cm.sum(1) - inter
    np.testing.assert_allclose(
        float(got[1][0]), (inter / np.maximum(union, 1))[union > 0].mean(),
        rtol=1e-6)
