"""The CTR slice of the port against the JAX package, on the CPU: its ops
(``sigmoid_cross_entropy_with_logits``, ``elementwise_sub``, ``sum``
through ``layers.sums``, ``concat``, ``squeeze``, ``unsqueeze``,
``expand``, ``ones_like``) and ``models/deepfm.py`` and
``models/ctr_models.py`` (Wide&Deep, DIN).

Op twins (``test_torch_seq2seq.op_twin``) feed the same numpy inputs to
the JAX op and the port's and hold outputs and gradients, among them
twins of ``tests/ops/test_op_numerics.py:234`` (sigmoid CE), ``:264``
(its concat part) and ``:305`` (its expand part). The model twins:
DeepFM trains (``tests/models/test_model_zoo.py:214``), two Adam steps
of DeepFM at 1000 features, 13 fields, embed 8 against the JAX
Executor's losses and @GRADs, Wide&Deep and DIN overfit a fixed batch
and DIN ignores its padding (``tests/models/test_ctr_models.py:24,43,
66``), and DeepFM under ``with_data_parallel`` at dp 2 against dp 1 and
against JAX's ``with_data_parallel`` over two CPU devices: the
embeddings' @GRADs are the ranks' dense scatter-adds summed over dp
(BASELINE.json's "all-reduce of sparse grads"). The dp traps: a
rank-local concat on axis 0 or an expand that tiles dim 0 refuses, and a
normalized sigmoid CE divides by the global batch's count. Tolerances
are stated beside each constant, with what this file's runs measured.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu.core import unique_name as jun
from paddle_tpu.core.executor import Scope as JScope, scope_guard as jguard
from paddle_tpu.models import ctr_models as jctr
from paddle_tpu.models import deepfm as jdeepfm

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import unique_name as tun
from paddle_tpu_torch.models import ctr_models as tctr
from paddle_tpu_torch.models import deepfm as tdeepfm

from test_torch_seq2seq import (_port_dp, assert_twin, op_twin,
                                run_layers)

CPU = fluid.CPUPlace()
# f32 op twins: sigmoid CE's log1p and exp are XLA's and torch's
# (measured 6.0e-8 forward, gradients 1.5e-8); the others are exact
# (measured 0; `sum` of three inputs, one stacked reduction where JAX
# chains adds, also came out exact on the CPU)
OP_RTOL, OP_ATOL = 1e-6, 1e-6
# DeepFM at 1000 features, 13 fields, embed 8, batch 16, Adam(1e-3), two
# steps from one scope: losses within 1e-6 relative (measured 0 and
# 8.7e-8), each @GRAD within 1e-5 of the step's largest in absolute
# terms (measured 3.4e-8 and 6.1e-8 of it)
DEEPFM_LOSS_RTOL, DEEPFM_GRAD_TOL = 1e-6, 1e-5
# The overfit twins' first three losses against JAX's from one scope
# (measured 8.6e-8 Wide&Deep, 8.8e-8 DIN; their last losses come to
# 2.8e-16x and 3.1e-8x the first)
CTR_LOSS_RTOL = 1e-6
# test_ctr_models.py's bar: the last loss below 0.1x the first
OVERFIT_MARGIN = 0.1
# DeepFM at dp 2 against dp 1 and against JAX's dp 2: the first loss
# within 1e-6, the second within 1e-5 (after the update; measured 0 for
# both, against either), @GRADs within 1e-5 of the step's largest
# (measured 6.0e-8 and 6.9e-8 of it against dp 1, 6.0e-8 and 5.7e-8
# against JAX)
DP_LOSS_RTOL, DP_GRAD_TOL = (1e-6, 1e-5), 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_bert.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RS = np.random.RandomState(7)


# ---------------------------------------------------------------------------
# op twins
# ---------------------------------------------------------------------------

def test_sigmoid_ce_with_logits_through_both_executors():
    """test_op_numerics.py:234: max(x, 0) - x label + log1p(exp(-|x|))
    against the golden and JAX, through both Programs."""
    x = RS.randn(4, 3).astype(np.float32)
    lbl = RS.rand(4, 3).astype(np.float32)
    golden = np.maximum(x, 0) - x * lbl + np.log1p(np.exp(-np.abs(x)))
    (j,), (t,) = run_layers(
        lambda L, v, l: L.sigmoid_cross_entropy_with_logits(v, l),
        {"x": x, "lbl": lbl})
    np.testing.assert_allclose(t, golden, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t, j, rtol=OP_RTOL, atol=OP_ATOL)


@pytest.mark.parametrize("normalize", [False, True])
def test_sigmoid_ce_ignore_index_and_normalize(normalize):
    """Labels equal to ignore_index give 0; normalize divides by the
    count of the others; output and dX against JAX."""
    x = RS.randn(6, 2).astype(np.float32)
    lbl = RS.randint(0, 2, (6, 2)).astype(np.float32)
    lbl[1, 0] = lbl[4, 1] = lbl[5, 0] = -1.0
    j, t, g = op_twin("sigmoid_cross_entropy_with_logits",
                      {"X": x, "Label": lbl},
                      {"ignore_index": -1, "normalize": normalize}, "Out",
                      grad=("X",))
    assert t[1, 0] == t[4, 1] == t[5, 0] == 0.0
    plain = np.maximum(x, 0) - x * lbl + np.log1p(np.exp(-np.abs(x)))
    want = np.where(lbl != -1, plain, 0.0) / (9.0 if normalize else 1.0)
    np.testing.assert_allclose(t, want, rtol=1e-5, atol=1e-6)
    assert_twin(j, t, g, OP_RTOL, OP_ATOL)


def test_elementwise_sub_broadcast_on_axis():
    """Y (3,) aligned to X (2, 3, 4) at axis 1, and Y (4,) trailing:
    output, dX and dY (summed over the broadcast dims) against JAX."""
    x = RS.randn(2, 3, 4).astype(np.float32)
    for y, axis in ((RS.randn(3).astype(np.float32), 1),
                    (RS.randn(4).astype(np.float32), -1)):
        j, t, g = op_twin("elementwise_sub", {"X": x, "Y": y},
                          {"axis": axis}, "Out", grad=("X", "Y"))
        yb = y.reshape(1, 3, 1) if axis == 1 else y
        np.testing.assert_array_equal(t, x - yb)
        assert_twin(j, t, g, OP_RTOL, OP_ATOL)


def test_sums_of_three():
    """layers.sums of three inputs (the sum op: one stacked reduction
    where JAX chains adds): the output and each input's gradient against
    JAX within OP_RTOL, the op alone and through both Programs."""
    xs = [RS.randn(5, 1).astype(np.float32) for _ in range(3)]
    j, t, g = op_twin("sum", {"X": xs}, {}, "Out", grad=("X",))
    assert_twin(j, t, g, OP_RTOL, OP_ATOL)
    (jl,), (tl,) = run_layers(lambda L, a, b, c: L.sums([a, b, c]),
                              {"a": xs[0], "b": xs[1], "c": xs[2]})
    np.testing.assert_allclose(tl, jl, rtol=OP_RTOL, atol=OP_ATOL)


def test_concat_and_expand_through_both_executors():
    """test_op_numerics.py:264 (concat on axis 1) and :305 (expand by
    [2, 1], np.tile), exact; their gradients against JAX."""
    a = RS.randn(2, 3).astype(np.float32)
    b = RS.randn(2, 5).astype(np.float32)
    (j,), (t,) = run_layers(lambda L, x, y: L.concat([x, y], axis=1),
                            {"a": a, "b": b})
    np.testing.assert_array_equal(t, np.concatenate([a, b], 1))
    np.testing.assert_array_equal(t, j)
    assert_twin(*op_twin("concat", {"X": [a, b]}, {"axis": 1}, "Out",
                         grad=("X",)))
    x = np.ones((2, 3), np.float32)
    (j,), (t,) = run_layers(lambda L, v: L.expand(v, expand_times=[2, 1]),
                            {"x": x})
    np.testing.assert_array_equal(t, np.tile(x, (2, 1)))
    np.testing.assert_array_equal(t, j)
    x = RS.randn(2, 1, 3).astype(np.float32)
    assert_twin(*op_twin("expand", {"X": x}, {"expand_times": [1, 4, 2]},
                         "Out", grad=("X",)))


@pytest.mark.parametrize("op,attrs,shape", [
    ("squeeze2", {"axes": [2]}, (2, 3, 1)),
    ("squeeze2", {"axes": [1, -1]}, (2, 1, 4, 1)),
    ("squeeze2", {"axes": []}, (2, 1, 3, 1)),
    ("unsqueeze2", {"axes": [1]}, (2, 3)),
    ("unsqueeze2", {"axes": [3, 1]}, (2, 3)),
    ("ones_like", {"value": 1.0}, (2, 3)),
])
def test_squeeze_unsqueeze_ones_like(op, attrs, shape):
    """DIN's reshaping ops against JAX: shapes and values, and the
    gradient through squeeze and unsqueeze."""
    x = RS.randn(*shape).astype(np.float32)
    grad = () if op == "ones_like" else ("X",)
    j, t, g = op_twin(op, {"X": x}, attrs, "Out", grad=grad)
    assert t.shape == j.shape
    assert_twin(j, t, g, 0.0, 0.0)


# ---------------------------------------------------------------------------
# dp traps
# ---------------------------------------------------------------------------

def test_concat_on_rows_and_expand_of_dim0_refuse_under_dp():
    """A rank-local concat along dim 0, or an expand whose first factor
    is not 1, would interleave the ranks' rows: both refuse at dp 2 and
    run at dp 1; off dim 0 they run at dp 2 and equal dp 1."""
    a = RS.randn(4, 3).astype(np.float32)
    b = RS.randn(4, 3).astype(np.float32)
    for build in (lambda L, x, y: L.concat([x, y], axis=0),
                  lambda L, x, y: L.expand(x, expand_times=[2, 1])):
        _port_dp(build, {"a": a, "b": b}, [CPU])
        with pytest.raises(NotImplementedError, match="dim 0"):
            _port_dp(build, {"a": a, "b": b}, [CPU] * 2)
    for build in (lambda L, x, y: L.concat([x, y], axis=1),
                  lambda L, x, y: L.expand(x, expand_times=[1, 2])):
        one = _port_dp(build, {"a": a, "b": b}, [CPU])
        two = _port_dp(build, {"a": a, "b": b}, [CPU] * 2)
        np.testing.assert_array_equal(two[0], one[0])


def test_sigmoid_ce_normalize_under_dp_takes_the_global_count():
    """normalize divides by the global batch's count of counted labels:
    at dp 2, with rank 0 holding 1 ignored label and rank 1 none, every
    rank divides by 7 (not 3 and 4); the rows equal dp 1's and JAX's."""
    x = RS.randn(4, 2).astype(np.float32)
    lbl = RS.randint(0, 2, (4, 2)).astype(np.float32)
    lbl[0, 1] = -1.0

    def build(L, v, l):
        return L.sigmoid_cross_entropy_with_logits(v, l, ignore_index=-1,
                                                   normalize=True)

    one = _port_dp(build, {"x": x, "lbl": lbl}, [CPU])
    two = _port_dp(build, {"x": x, "lbl": lbl}, [CPU] * 2)
    (j,), _t = run_layers(build, {"x": x, "lbl": lbl})
    np.testing.assert_allclose(two[0], one[0], rtol=1e-7)
    np.testing.assert_allclose(two[0], j, rtol=OP_RTOL, atol=OP_ATOL)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def _build(pkg, un, net, seed=11):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with un.guard(), pkg.program_guard(main, startup):
        loss, extra = net(pkg)
    return main, startup, loss, extra


def _jax_init(jstart):
    scope = JScope()
    with jguard(scope):
        jfluid.Executor().run(jstart)
    return {n: np.asarray(scope.get(n)) for n in scope.names()}


def _jscope(init):
    scope = JScope()
    for n, v in init.items():
        scope.set(n, jnp.asarray(v))
    return scope


def _deepfm_net(lr=1e-3, nf=1000, fields=13, embed=8):
    def net(pkg):
        m = jdeepfm if pkg is jfluid else tdeepfm
        _i, _v, _l, loss, prob = m.build_train_net(
            num_features=nf, num_fields=fields, embed_dim=embed)
        pkg.optimizer.AdamOptimizer(learning_rate=lr).minimize(loss)
        return loss, prob
    return net


def _deepfm_feed(rs, b=16, nf=1000, fields=13):
    return {"feat_ids": rs.randint(0, nf, (b, fields)).astype(np.int64),
            "feat_vals": rs.rand(b, fields).astype(np.float32),
            "label": rs.randint(0, 2, (b, 1)).astype(np.float32)}


@pytest.fixture(scope="module")
def deepfm():
    """Both packages' DeepFM (1000 features, 13 fields, embed 8,
    Adam(1e-3)) and JAX's startup values."""
    jmain, jstart, jloss, _jp = _build(jfluid, jun, _deepfm_net())
    tmain, _ts, tloss, _tp = _build(fluid, tun, _deepfm_net())
    return (jmain, jloss), (tmain, tloss), _jax_init(jstart)


def test_deepfm_builds_jax_graph(deepfm):
    (jmain, _jl), (tmain, _tl), _init = deepfm
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    assert [(p.name, tuple(p.shape)) for p in tmain.all_parameters()] == \
        [(p.name, tuple(p.shape)) for p in jmain.all_parameters()]


def test_deepfm_trains(deepfm):
    """test_model_zoo.py:214: five Adam steps on fresh random batches of
    16, every loss finite."""
    _j, (tmain, tloss), init = deepfm
    rs = np.random.RandomState(0)
    scope = fluid.scope_from_numpy(init, "cpu")
    exe = fluid.Executor(CPU)
    losses = [float(exe.run(tmain, feed=_deepfm_feed(rs), fetch_list=[tloss],
                            scope=scope)[0]) for _ in range(5)]
    assert np.isfinite(losses).all()


def _steps_grads(exe, program, scope, feed, loss, names, steps, guard=None):
    outs = []
    for _ in range(steps):
        if guard is None:
            outs.append([np.asarray(v) for v in exe.run(
                program, feed=feed, fetch_list=[loss] + names, scope=scope)])
        else:
            with guard(scope):
                outs.append([np.asarray(v) for v in exe.run(
                    program, feed=feed, fetch_list=[loss] + names)])
    return outs


def _assert_steps(got, want, loss_rtol, grad_tol, names):
    for step, (a, b) in enumerate(zip(got, want)):
        rtol = loss_rtol[step] if isinstance(loss_rtol, tuple) \
            else loss_rtol
        np.testing.assert_allclose(a[0], b[0], rtol=rtol)
        gmax = max(float(np.abs(g).max()) for g in b[1:])
        for name, x, y in zip(names, a[1:], b[1:]):
            err = float(np.abs(x - y).max())
            assert err <= grad_tol * gmax, (step, name, err, gmax)


def test_deepfm_steps_match_jax(deepfm):
    """Two Adam steps on one batch of 16: each step's loss and every
    @GRAD (the embeddings' dense scatter-adds among them) against the
    JAX Executor's from the same scope."""
    (jmain, jloss), (tmain, tloss), init = deepfm
    feed = _deepfm_feed(np.random.RandomState(1))
    names = [p.name + "@GRAD" for p in tmain.all_parameters()]
    want = _steps_grads(jfluid.Executor(), jmain, _jscope(init), feed,
                        jloss, names, 2, guard=jguard)
    got = _steps_grads(fluid.Executor(CPU), tmain,
                       fluid.scope_from_numpy(init, "cpu"), feed, tloss,
                       names, 2)
    _assert_steps(got, want, DEEPFM_LOSS_RTOL, DEEPFM_GRAD_TOL, names)


def test_deepfm_at_dp2_matches_dp1_and_jax(deepfm):
    """DeepFM through with_data_parallel on [CPUPlace()] * 2 against dp 1
    and against JAX's with_data_parallel over two CPU devices, two steps
    from one scope: losses and @GRADs; the embeddings' @GRADs are each
    rank's scatter-add of its rows summed over dp, nonzero on rows only
    rank 1's ids touch."""
    (jmain, jloss), (tmain, tloss), init = deepfm
    feed = _deepfm_feed(np.random.RandomState(2))
    names = [p.name + "@GRAD" for p in tmain.all_parameters()]
    texe = fluid.Executor(CPU)
    runs = {}
    for dp in (1, 2):
        comp = fluid.CompiledProgram(tmain).with_data_parallel(
            loss_name=tloss.name, places=[CPU] * dp)
        runs[dp] = _steps_grads(texe, comp, fluid.scope_from_numpy(
            init, "cpu"), feed, tloss, names, 2)
    jcomp = jfluid.CompiledProgram(jmain).with_data_parallel(
        loss_name=jloss.name,
        places=[jfluid.CUDAPlace(0), jfluid.CUDAPlace(1)])
    want = _steps_grads(jfluid.Executor(), jcomp, _jscope(init), feed,
                        jloss, names, 2, guard=jguard)
    _assert_steps(runs[2], runs[1], DP_LOSS_RTOL, DP_GRAD_TOL, names)
    _assert_steps(runs[2], want, DP_LOSS_RTOL, DP_GRAD_TOL, names)
    emb = [i for i, n in enumerate(names)
           if runs[2][0][1 + i].shape[0] == 1000]
    assert len(emb) == 2
    only_rank1 = sorted(set(feed["feat_ids"][8:].ravel())
                        - set(feed["feat_ids"][:8].ravel()))
    for i in emb:
        assert np.abs(runs[2][0][1 + i][only_rank1]).max() > 0


def _overfit(net, feed, steps):
    """The port's losses over `steps` steps from JAX's startup, and JAX's
    first three."""
    jmain, jstart, jloss, _jp = _build(jfluid, jun, net)
    tmain, _ts, tloss, tprob = _build(fluid, tun, net)
    init = _jax_init(jstart)
    scope = fluid.scope_from_numpy(init, "cpu")
    exe = fluid.Executor(CPU)
    losses = [float(exe.run(tmain, feed=feed, fetch_list=[tloss],
                            scope=scope)[0]) for _ in range(steps)]
    want = [float(v[0]) for v in _steps_grads(
        jfluid.Executor(), jmain, _jscope(init), feed, jloss, [], 3,
        guard=jguard)]
    return losses, want


def test_wide_deep_overfits_fixed_batch():
    """test_ctr_models.py:24: 120 Adam(1e-2) steps on a batch of 32, the
    last loss below 0.1x the first; the first three equal JAX's."""
    rng = np.random.RandomState(0)
    b, fw, fd = 32, 8, 8

    def net(pkg):
        m = jctr if pkg is jfluid else tctr
        _w, _d, _l, loss, prob = m.build_wide_deep_net(
            num_features=500, num_wide_fields=fw, num_deep_fields=fd)
        pkg.optimizer.AdamOptimizer(learning_rate=1e-2).minimize(loss)
        return loss, prob

    feed = {"wide_ids": rng.randint(0, 500, (b, fw)).astype(np.int64),
            "deep_ids": rng.randint(0, 500, (b, fd)).astype(np.int64),
            "label": rng.randint(0, 2, (b, 1)).astype(np.float32)}
    losses, want = _overfit(net, feed, 120)
    assert losses[-1] < losses[0] * OVERFIT_MARGIN, (losses[0], losses[-1])
    np.testing.assert_allclose(losses[:3], want, rtol=CTR_LOSS_RTOL)


def _din_net(num_items, t, lr=1e-2):
    def net(pkg):
        m = jctr if pkg is jfluid else tctr
        _h, _c, _l, _lb, loss, prob = m.build_din_net(num_items=num_items,
                                                      max_hist=t)
        pkg.optimizer.AdamOptimizer(learning_rate=lr).minimize(loss)
        return loss, prob
    return net


def test_din_overfits_fixed_batch():
    """test_ctr_models.py:43: 150 Adam(1e-2) steps on a batch of 32 with
    padded histories, the last loss below 0.1x the first; the first three
    equal JAX's."""
    rng = np.random.RandomState(1)
    b, t = 32, 16
    lens = rng.randint(1, t + 1, (b, 1)).astype(np.int64)
    hist = rng.randint(1, 200, (b, t)).astype(np.int64)
    for i in range(b):
        hist[i, lens[i, 0]:] = 0
    feed = {"hist_ids": hist,
            "cand_id": rng.randint(1, 200, (b, 1)).astype(np.int64),
            "hist_len": lens,
            "label": rng.randint(0, 2, (b, 1)).astype(np.float32)}
    losses, want = _overfit(_din_net(200, t), feed, 150)
    assert losses[-1] < losses[0] * OVERFIT_MARGIN, (losses[0], losses[-1])
    np.testing.assert_allclose(losses[:3], want, rtol=CTR_LOSS_RTOL)


def test_din_attention_ignores_padding():
    """test_ctr_models.py:66: scrambling the ids in padded history
    positions leaves the probability unchanged (their -1e9 scores get no
    weight); both equal JAX's."""
    b, t = 4, 8
    rng = np.random.RandomState(2)
    lens = np.full((b, 1), 3, np.int64)
    hist_a = rng.randint(1, 100, (b, t)).astype(np.int64)
    hist_b = hist_a.copy()
    hist_b[:, 3:] = rng.randint(1, 100, (b, t - 3))
    cand = rng.randint(1, 100, (b, 1)).astype(np.int64)
    lbl = np.ones((b, 1), np.float32)
    jmain, jstart, _jl, jprob = _build(jfluid, jun, _din_net(100, t))
    tmain, _ts, _tl, tprob = _build(fluid, tun, _din_net(100, t))
    init = _jax_init(jstart)
    scope = fluid.scope_from_numpy(init, "cpu")
    exe = fluid.Executor(CPU)
    probs = []
    for hist in (hist_a, hist_b):
        feed = {"hist_ids": hist, "cand_id": cand, "hist_len": lens,
                "label": lbl}
        p, = exe.run(tmain.clone(for_test=True), feed=feed,
                     fetch_list=[tprob], scope=scope)
        with jguard(_jscope(init)):
            jp, = jfluid.Executor().run(jmain.clone(for_test=True),
                                        feed=feed, fetch_list=[jprob])
        np.testing.assert_allclose(p, np.asarray(jp), rtol=1e-6)
        probs.append(p)
    np.testing.assert_allclose(probs[0], probs[1], rtol=1e-6, atol=1e-7)
