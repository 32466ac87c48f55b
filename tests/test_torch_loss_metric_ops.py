"""The port's loss and metric ops against the JAX package, on the CPU:
the 13 losses of ``ops/loss_ops.py`` and the 5 metrics of
``metric_ops.py`` that ROADMAP item 10c.6e ports, each forward and,
for the losses, with the gradient of one seeded cotangent; the layers
over them (``layers.loss``'s ten, ``layers.metric_op.auc`` and
``mean_iou``) through both Executors; ``center_loss`` over three steps
(its centres updated in place); the streaming ``auc`` across runs; and
each dp rule at dp 2 on a local CPU mesh against dp 1, with each
refusal.

Cases mirror ``tests/ops/test_uncovered_ops.py``, ``_r4*.py``,
``test_op_numerics.py``, ``test_audit_gap_ops.py`` and
``tests/api/test_semantic_parity*.py``, with the slice's trouble
points: every ``kldiv_loss`` reduction, ``npair_loss``'s Beta 0.25,
``teacher_student_sigmoid_loss``'s label encoding, the auxiliary outputs
of ``huber_loss``, ``modified_huber_loss``, ``margin_rank_loss`` and
``squared_l2_distance``, ``dice_loss``'s epsilon and one-hot labels,
``center_loss``'s update (skipped in test mode) and out-of-range labels,
``auc``'s bucket edges, and ``mean_iou`` with VOC's ignore label 255
and a negative label (XLA's scatter drops the first and wraps the
second; the port masks both to give the same matrix).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu import layers as jlayers
from paddle_tpu.core import unique_name as jun
from paddle_tpu.core.executor import Scope as JScope, scope_guard as jguard
from paddle_tpu.ops import _REGISTRY as JREG

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.core import unique_name as tun
from paddle_tpu_torch.ops import _REGISTRY as TREG

from test_torch_seq2seq import _JCtx, _TCtx, run_layers
from test_torch_tensor_ops import both, check, close, same

CPU = fluid.CPUPlace()
# dp 2 against dp 1: the same numbers but each rank's summation order,
# within 1e-6 of their scale (the op twins' tolerances are
# test_torch_tensor_ops.RTOL and GRAD_TOL: 1e-6 forward, 1e-5 for
# gradients, integers equal)
DP_TOL = 1e-6

RS = np.random.RandomState(124)


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


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("delta", [0.3, 1.0])
def test_huber_loss_and_residual(delta):
    x, y = _r(6, 1, lo=-2, hi=2), _r(6, 1, lo=-2, hi=2)
    check("huber_loss", {"X": x, "Y": y}, {"delta": delta}, "Out",
          grad=("X", "Y"))
    same("huber_loss", {"X": x, "Y": y}, {"delta": delta}, ["Residual"])


def test_bpr_loss_leaves_the_label_out():
    check("bpr_loss", {"X": _r(5, 4), "Label": np.array(
        [[0], [3], [1], [3], [2]], np.int64)}, {}, "Y", grad=("X",))


@pytest.mark.parametrize("reduction", ["none", "mean", "sum", "batchmean"])
def test_kldiv_loss_every_reduction(reduction):
    """Target zeros contribute 0 (the where), in every reduction."""
    t = _r(4, 5, lo=0, hi=1)
    t[0, 1] = t[2, 3] = 0.0
    check("kldiv_loss", {"X": _r(4, 5, lo=-3, hi=0), "Target": t},
          {"reduction": reduction}, "Loss", grad=("X", "Target"))


def test_rank_and_margin_rank_loss():
    lab = RS.randint(0, 2, (6, 1)).astype(np.float32)
    check("rank_loss", {"Label": lab, "Left": _r(6, 1), "Right": _r(6, 1)},
          {}, "Out", grad=("Left", "Right"))
    sign = (lab * 2 - 1).astype(np.float32)
    ins = {"Label": sign, "X1": _r(6, 1), "X2": _r(6, 1)}
    check("margin_rank_loss", ins, {"margin": 0.2}, "Out",
          grad=("X1", "X2"))
    same("margin_rank_loss", ins, {"margin": 0.2}, ["Activated"])


@pytest.mark.parametrize("eps", [1e-5, 0.5])
def test_dice_loss_int_labels_one_hot_and_float_labels(eps):
    """Integer labels one-hot to the class dim (an id out of range is a
    zero row, jax.nn.one_hot's); float labels are used as they are."""
    x = _r(3, 4, 5, lo=0, hi=1)
    lab = RS.randint(0, 5, (3, 4, 1)).astype(np.int64)
    lab[1, 2, 0] = 9
    check("dice_loss", {"X": x, "Label": lab}, {"epsilon": eps}, "Out",
          grad=("X",))
    check("dice_loss", {"X": x, "Label": _r(3, 4, 5, lo=0, hi=1)},
          {"epsilon": eps}, "Out", grad=("X", "Label"))


def test_npair_loss_beta_quarter():
    """npair_loss's regularizer carries the reference's Beta 0.25."""
    labels = np.array([1, 2, 1, 3, 2], np.int64)
    check("npair_loss", {"Anchor": _r(5, 4), "Positive": _r(5, 4),
                         "Labels": labels}, {"l2_reg": 0.05}, "Out",
          grad=("Anchor", "Positive"))


def test_teacher_student_sigmoid_loss_label_encoding():
    """-2 (click 0), -1 (click 1), q in [0, 1) (click 0 + teacher q),
    1 + q (click 1 + teacher q)."""
    lab = np.array([[-2.0], [-1.0], [0.0], [0.3], [0.99], [1.0], [1.6],
                    [1.999]], np.float32)
    check("teacher_student_sigmoid_loss", {"X": _r(8, 1, lo=-4, hi=4),
                                           "Label": lab}, {}, "Y",
          grad=("X",))


def test_mse_hinge_modified_huber_squared_l2_distance():
    x, y = _r(4, 3), _r(4, 3)
    check("mse_loss", {"X": x, "Y": y}, {}, "Out", grad=("X", "Y"))
    labels = RS.randint(0, 2, (6, 1)).astype(np.float32)
    check("hinge_loss", {"Logits": _r(6, 1, lo=-2, hi=2),
                         "Labels": labels}, {}, "Loss", grad=("Logits",))
    z = np.array([[-3.0], [-1.5], [-0.5], [0.2], [0.9], [2.0]], np.float32)
    ins = {"X": z, "Y": np.array([[1], [1], [0], [1], [0], [1]],
                                 np.float32)}
    check("modified_huber_loss", ins, {}, "Out", grad=("X",))
    same("modified_huber_loss", ins, {}, ["IntermediateVal"])
    ins = {"X": _r(4, 2, 3), "Y": _r(4, 2, 3)}
    check("squared_l2_distance", ins, {}, "Out", grad=("X", "Y"))
    same("squared_l2_distance", ins, {}, ["sub_result"])


@pytest.mark.parametrize("is_test", [False, True])
def test_center_loss_update_and_out_of_range_labels(is_test):
    """The loss and diff against the centres before the update; in
    training each centre moves by alpha x its rows' summed diff /
    (count + 1); in test mode (or need_update False) the centres stay.
    A label past the classes picks the last centre (clamped) and adds
    to no count (dropped), -1 wraps to the last class, as XLA reads
    them."""
    label = np.array([[0], [2], [2], [5], [-1], [1]], np.int64)
    ins = {"X": _r(6, 3), "Label": label, "Centers": _r(4, 3),
           "CenterUpdateRate": np.array([0.3], np.float32)}
    jc = _JCtx({k: jnp.asarray(v) for k, v in ins.items()},
               {"need_update": True})
    tc = _TCtx({k: torch.from_numpy(v) for k, v in ins.items()},
               {"need_update": True})
    jc.is_test = tc.is_test = is_test
    j, t = JREG["center_loss"](jc), TREG["center_loss"](tc)
    for slot in ("Loss", "SampleCenterDiff", "CentersOut"):
        close(t[slot].detach().numpy(), j[slot], name=slot)
    moved = not np.array_equal(t["CentersOut"].numpy(), ins["Centers"])
    assert moved != is_test
    check("center_loss", ins, {"need_update": True}, "Loss",
          grad=("X", "Centers"))


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _auc_ins(n, buckets, seed):
    rs = np.random.RandomState(seed)
    p = rs.rand(n).astype(np.float32)
    p[:4] = [0.0, 1.0, 0.5, 1.0 / (buckets - 1)]
    return {"Predict": np.stack([1 - p, p], 1),
            "Label": rs.randint(0, 2, (n, 1)).astype(np.int64),
            "StatPos": rs.randint(0, 5, buckets).astype(np.float32),
            "StatNeg": rs.randint(0, 5, buckets).astype(np.float32)}


@pytest.mark.parametrize("buckets", [2, 11, 4096])
def test_auc_histograms_and_area(buckets):
    """The bucket int(p (buckets - 1)) clipped, the histograms added to
    the streaming statistics exactly, the area within 1e-6."""
    same("auc", _auc_ins(300, buckets, buckets), {},
         ["AUC", "StatPosOut", "StatNegOut"])


def test_auc_clips_out_of_range_probabilities():
    ins = _auc_ins(8, 11, 3)
    ins["Predict"][:4, 1] = [-0.5, 1.7, 1e9, -3.0]
    same("auc", ins, {}, ["AUC", "StatPosOut", "StatNegOut"])


def test_mean_iou_leaves_ignore_labels_out_and_wraps_negative():
    """VOC's ignore label 255 (label n + pred past n^2): XLA drops the
    pixel; a label of -1 makes a negative index that XLA wraps by n^2 and
    counts; the port masks both to give the same matrix."""
    n = 5
    pred = RS.randint(0, n, (2, 6, 7)).astype(np.int64)
    label = RS.randint(0, n, (2, 6, 7)).astype(np.int64)
    label[0, :2] = 255
    label[1, 3, :3] = -1
    out = same("mean_iou", {"Predictions": pred, "Labels": label},
               {"num_classes": n}, ["OutMeanIou", "OutWrong", "OutCorrect"])
    assert out["OutWrong"].sum() + out["OutCorrect"].sum() == \
        pred.size - 14 - 0   # the 255 pixels left out, the -1 ones kept


def test_mean_iou_mean_is_the_same_bits_in_any_class_order():
    """OutMeanIou's sum over the classes is exact (float64 over f32
    IoUs, rounded once), so relabelling the classes, which reorders that
    sum, leaves its bits as they were; a card and a CPU whose reductions
    take other orders agree the same way. Each relabelling also against
    JAX (RTOL)."""
    n = 21
    pred = RS.randint(0, n, (2, 33, 35)).astype(np.int64)
    label = np.where(RS.rand(2, 33, 35) < 0.7, pred,
                     RS.randint(0, n, (2, 33, 35))).astype(np.int64)
    label[0, :3] = 255
    means = []
    for seed in range(8):
        perm = np.random.RandomState(seed).permutation(n)
        relabel = np.where(label < n, perm[np.minimum(label, n - 1)], label)
        out = same("mean_iou", {"Predictions": perm[pred],
                                "Labels": relabel},
                   {"num_classes": n}, ["OutMeanIou"])
        means.append(out["OutMeanIou"])
    assert all(np.array_equal(m, means[0]) for m in means), means


def test_mean_iou_absent_class_is_left_out_of_the_mean():
    pred = np.array([[0, 0, 1, 1]], np.int64)
    label = np.array([[0, 1, 1, 1]], np.int64)
    same("mean_iou", {"Predictions": pred, "Labels": label},
         {"num_classes": 4}, ["OutMeanIou", "OutWrong", "OutCorrect"])


@pytest.mark.parametrize("use_cvm", [True, False])
def test_continuous_value_model(use_cvm):
    x = _r(4, 6, lo=-1, hi=5)
    check("continuous_value_model", {"X": x, "CVM": x[:, :2]},
          {"use_cvm": use_cvm}, "Y", grad=("X",))


def test_filter_by_instag():
    ins = {"Ins": _r(5, 3), "Ins_tag": np.array(
        [[1, 0], [2, 3], [0, 0], [4, 4], [3, 1]], np.int64),
        "Filter_tag": np.array([3, 4], np.int64)}
    same("filter_by_instag", ins, {}, ["Out", "LossWeight", "IndexMap"])


@pytest.mark.parametrize("accumulate", [False, True])
def test_positive_negative_pair(accumulate):
    """Pairs within a query with different labels: score order agreeing
    (positive), disagreeing (negative) or tied (neutral)."""
    ins = {"Score": np.array([[0.5], [0.2], [0.5], [0.9], [0.1], [0.1]],
                             np.float32),
           "Label": np.array([[1], [0], [2], [1], [0], [1]], np.float32),
           "QueryID": np.array([[7], [7], [7], [9], [9], [9]], np.int64)}
    if accumulate:
        ins.update({"AccumulatePositivePair": np.array([3.0], np.float32),
                    "AccumulateNegativePair": np.array([1.0], np.float32),
                    "AccumulateNeutralPair": np.array([2.0], np.float32)})
    same("positive_negative_pair", ins, {},
         ["PositivePair", "NegativePair", "NeutralPair"])


# ---------------------------------------------------------------------------
# the layers through both Executors
# ---------------------------------------------------------------------------

def test_loss_layers_through_both_executors():
    def build(L, x, y, p, lab, soft):
        return [L.huber_loss(x, y, 0.5), L.bpr_loss(p, lab),
                L.kldiv_loss(L.log(soft), soft, "batchmean"),
                L.rank_loss(L.cast(L.greater_than(x, y), "float32"), x, y),
                L.margin_rank_loss(L.sign(y), x, y, 0.1),
                L.dice_loss(L.softmax(p), lab), L.npair_loss(p, p, lab),
                L.mse_loss(x, y), L.teacher_student_sigmoid_loss(x, y),
                L.smooth_l1(x, y)]

    j, t = run_layers(build, {
        "x": _r(6, 1), "y": _r(6, 1), "p": _r(6, 4),
        "lab": RS.randint(0, 4, (6, 1)).astype(np.int64),
        "soft": _r(6, 4, lo=0.1, hi=1)})
    for k, (a, b) in enumerate(zip(t, j)):
        close(a, b, name=str(k))


def _both_programs(build, feeds, steps, fetch_names=()):
    """build(pkg, layers) -> fetch vars in both packages; `steps` runs of
    each on feeds(i), the fetches of every run and the named scope
    values after the last: (JAX's, the port's)."""
    res = []
    for pkg, lay, un, guard, scope in (
            (jfluid, jlayers, jun, jguard, JScope()),
            (fluid, tlayers, tun, fluid.scope_guard, fluid.Scope())):
        main, startup = pkg.Program(), pkg.Program()
        with un.guard(), pkg.program_guard(main, startup):
            outs = build(pkg, lay)
        exe = pkg.Executor(CPU) if pkg is fluid else pkg.Executor()
        with guard(scope):
            exe.run(startup)
            runs = [[np.asarray(v) for v in exe.run(
                main, feed=feeds(i), fetch_list=outs)]
                for i in range(steps)]
            state = [np.asarray(scope.get(n)) for n in fetch_names]
        res.append((runs, state))
    return res


def test_center_loss_over_three_steps_equals_jax():
    """The layer's centres (a persistable parameter updated in place by
    the op) after each of three SGD steps over one fc: the losses and
    the centres equal JAX's."""
    def build(pkg, L):
        x = L.data("x", shape=[4], dtype="float32")
        lab = L.data("lab", shape=[1], dtype="int64")
        h = L.fc(x, 3, param_attr=pkg.ParamAttr(
            name="w", initializer=pkg.initializer.ConstantInitializer(0.1)))
        loss = L.mean(L.center_loss(h, lab, 5, 0.4,
                                    param_attr=pkg.ParamAttr(name="ctr")))
        pkg.optimizer.SGDOptimizer(0.5).minimize(loss)
        return [loss]

    rs = np.random.RandomState(9)
    feeds = [{"x": rs.rand(6, 4).astype(np.float32),
              "lab": rs.randint(0, 5, (6, 1)).astype(np.int64)}
             for _ in range(3)]
    (jr, js), (tr, ts) = _both_programs(build, lambda i: feeds[i], 3,
                                        ["ctr"])
    for a, b in zip(tr, jr):
        close(a[0], b[0])
    close(ts[0], js[0])
    assert np.abs(ts[0]).max() > 0


def test_streaming_auc_layer_accumulates_across_runs():
    """layers.auc's stat_pos / stat_neg start at 0 in the startup and add
    each run's batch: after three runs they count every example, and
    the AUC of each run equals JAX's."""
    def build(pkg, L):
        p = L.data("p", shape=[1], dtype="float32")
        lab = L.data("lab", shape=[1], dtype="int64")
        prob = L.concat([1.0 - p, p], axis=1) if pkg is fluid else \
            L.concat([L.scale(p, -1.0, 1.0), p], axis=1)
        a, batch_a, stats = L.auc(prob, lab, num_thresholds=63)
        assert batch_a is a and len(stats) == 2
        return [a] + stats

    rs = np.random.RandomState(11)
    feeds = [{"p": rs.rand(50, 1).astype(np.float32),
              "lab": rs.randint(0, 2, (50, 1)).astype(np.int64)}
             for _ in range(3)]
    (jr, _), (tr, _) = _both_programs(build, lambda i: feeds[i], 3)
    for a, b in zip(tr, jr):
        for x, y in zip(a, b):
            close(x, y)
    assert tr[-1][1].sum() + tr[-1][2].sum() == 150


def test_auc_refuses_the_pr_curve():
    with tun.guard(), fluid.program_guard(fluid.Program(), fluid.Program()):
        p = tlayers.data("p", shape=[2], dtype="float32")
        lab = tlayers.data("lab", shape=[1], dtype="int64")
        with pytest.raises(NotImplementedError, match="ROC"):
            tlayers.auc(p, lab, curve="PR")


# ---------------------------------------------------------------------------
# data parallelism
# ---------------------------------------------------------------------------

def _dp_program(build):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with tun.guard(), fluid.program_guard(main, startup):
        outs = build(tlayers)
    return main, startup, outs


def _run(main, startup, outs, feeds, places, names=()):
    scope, exe = fluid.Scope(), fluid.Executor(CPU)
    exe.run(startup, scope=scope)
    prog = main if places is None else fluid.CompiledProgram(
        main).with_data_parallel(loss_name=outs[0].name, places=places)
    runs = [exe.run(prog, feed=f, fetch_list=outs, scope=scope)
            for f in feeds]
    return runs, [scope.get(n).numpy() for n in names]


def test_metrics_and_reducing_losses_count_the_global_batch():
    """At dp 2 against the plain Executor, over two runs: auc's
    statistics and AUC (the ranks' histograms summed once), mean_iou's
    matrix, center_loss's centres (the ranks' counts and diffs summed
    before the update), kldiv_loss's mean / sum / batchmean, mse_loss,
    dice_loss, filter_by_instag's global row numbers."""
    def build(L):
        x = L.data("x", shape=[4], dtype="float32")
        lab = L.data("lab", shape=[1], dtype="int64")
        pred = L.data("pred", shape=[3, 3], dtype="int64")
        seg = L.data("seg", shape=[3, 3], dtype="int64")
        tags = L.data("tags", shape=[2], dtype="int64")
        prob = L.softmax(x)
        a, _, stats = L.auc(L.slice(prob, [1], [2], [4]), lab,
                            num_thresholds=31)
        miou, wrong, correct = L.mean_iou(pred, seg, 4)
        closs = L.center_loss(x, lab, 4, 0.5,
                              param_attr=fluid.ParamAttr(name="ctr"))
        outs = [L.mean(closs), a, miou, wrong, correct,
                L.kldiv_loss(L.log(prob), prob, "mean"),
                L.kldiv_loss(L.log(prob), prob, "sum"),
                L.kldiv_loss(L.log(prob), prob, "batchmean"),
                L.kldiv_loss(L.log(prob), prob, "none"),
                L.mse_loss(x, prob), L.dice_loss(prob, lab),
                L.filter_by_instag(x, tags, L.assign(
                    np.array([2], np.int64)))[2]]
        return outs + stats

    rs = np.random.RandomState(3)

    def feed():
        seg = rs.randint(0, 4, (8, 3, 3)).astype(np.int64)
        seg[0, 0] = 255
        return {"x": rs.randn(8, 4).astype(np.float32),
                "lab": rs.randint(0, 4, (8, 1)).astype(np.int64),
                "pred": rs.randint(0, 4, (8, 3, 3)).astype(np.int64),
                "seg": seg,
                "tags": rs.randint(0, 4, (8, 2)).astype(np.int64)}

    feeds = [feed(), feed()]
    main, startup, outs = _dp_program(build)
    want, wc = _run(main, startup, outs, feeds, None, ["ctr"])
    got, gc = _run(main, startup, outs, feeds, [CPU] * 2, ["ctr"])
    for g, w in zip(got, want):
        for k, (a, b) in enumerate(zip(g, w)):
            close(np.asarray(a), np.asarray(b), rtol=DP_TOL, name=str(k))
    close(gc[0], wc[0], rtol=DP_TOL)
    assert got[-1][-2].sum() + got[-1][-1].sum() == 16


@pytest.mark.parametrize("layer,why", [
    (lambda L, x, lab: L.npair_loss(x, x, lab), "every anchor"),
    (lambda L, x, lab: L.cast(L.unique(lab)[0], "float32"),
     "whole tensor")])
def test_batch_pairing_ops_refuse_sharded_rows(layer, why):
    def build(L):
        x = L.data("x", shape=[3], dtype="float32")
        lab = L.data("lab", shape=[1], dtype="int64")
        return [L.mean(layer(L, x, lab))]

    main, startup, outs = _dp_program(build)
    feeds = [{"x": _r(4, 3), "lab": RS.randint(0, 3, (4, 1))
              .astype(np.int64)}]
    with pytest.raises(NotImplementedError, match=why):
        _run(main, startup, outs, feeds, [CPU] * 2)
    close(_run(main, startup, outs, feeds, [CPU])[0][0][0],
          _run(main, startup, outs, feeds, None)[0][0][0])


def test_positive_negative_pair_refuses_sharded_rows():
    from paddle_tpu_torch.core.layer_helper import LayerHelper

    def build(L):
        s = L.data("s", shape=[1], dtype="float32")
        q = L.data("q", shape=[1], dtype="int64")
        helper = LayerHelper("positive_negative_pair")
        outs = [helper.create_variable_for_type_inference("float32", (1,))
                for _ in range(3)]
        helper.append_op("positive_negative_pair",
                         {"Score": s, "Label": s, "QueryID": q},
                         {"PositivePair": outs[0], "NegativePair": outs[1],
                          "NeutralPair": outs[2]})
        return [L.mean(s)] + outs

    main, startup, outs = _dp_program(build)
    feeds = [{"s": _r(4, 1), "q": np.array([[1], [1], [2], [2]])}]
    with pytest.raises(NotImplementedError, match="query"):
        _run(main, startup, outs, feeds, [CPU] * 2)
