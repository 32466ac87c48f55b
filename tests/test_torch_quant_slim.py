"""The port's ``quant/`` and ``slim/`` against the JAX package, on the
CPU: every rewrite of ``quant/`` (``QuantizationTransform`` /
``quantize_program``, ``apply_ptq`` at both weight granularities, the
passes of ``quant/passes.py``, ``QuantizeTranspiler``) held op for op
against the JAX package's rewrite of the same Program (type, inputs,
outputs and attrs), and the program-level twins on weights carried over
from JAX's startup by ``fluid.scope_from_numpy``: QAT on a small conv
net over three steps (losses and the moving-average scales), PTQ's
scales and outputs, the freeze and the int8 conversion, pruning that
sticks through Momentum with L2 decay, and distillation through
``merge_programs`` over two steps.

Besides, the port alone runs the twins of ``tests/api/test_quant_slim.py``
(all 9) and ``tests/api/test_slim_pipeline.py`` (all 7: the yaml
``Compressor``, the strategies, the non-ports raising).

Tolerances are stated beside each constant, with what this file's runs
measured.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import quant as jquant, slim as jslim
from paddle_tpu.core import unique_name as jun
from paddle_tpu.core.executor import Scope as JScope, scope_guard as jguard

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers as tlayers, quant, slim
from paddle_tpu_torch.core import unique_name as tun
from paddle_tpu_torch.ops import quant_ops as tq

CPU = fluid.CPUPlace()
# a step's loss against JAX's, relative: the fake quant rounds both
# packages' activations on the same grid, so a twin differs only where
# a product summed in another order crosses a rounding boundary (none
# did here: measured at most 2.2e-7 over three steps); the
# moving-average scales, the calibrated scales and the frozen static
# scales within 1e-6 relative (measured 0: each is an abs-max of values
# both packages computed alike, or of the feed)
LOSS_RTOL = 1e-5
SCALE_RTOL = 1e-6
# PTQ / frozen outputs against JAX's, relative to the output's largest
# entry (measured at most 3.5e-7)
OUT_RTOL = 1e-5
# the pruned and the distilled nets' losses against JAX's, relative
# (measured at most 1.9e-7)
SLIM_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_bert.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _conv_net(pkg):
    """A small conv net (conv2d, depthwise conv, fc) at 3 x 8 x 8, 5
    classes: (img, label, logits, loss)."""
    L = pkg.layers
    img = L.data("img", shape=[3, 8, 8], dtype="float32")
    label = L.data("label", shape=[1], dtype="int64")
    h = L.conv2d(img, num_filters=4, filter_size=3, padding=1, act="relu")
    h = L.conv2d(h, num_filters=4, filter_size=3, padding=1, groups=4,
                 act="relu")
    h = L.pool2d(h, pool_size=2, pool_stride=2)
    logits = L.fc(h, size=5)
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    return img, label, logits, loss


def _both(build, seed=5):
    """build(pkg, main, startup) built in each package under its own
    unique_name guard: [(main, startup, build's result)] for JAX, then
    the port."""
    out = []
    for pkg, un in ((jfluid, jun), (fluid, tun)):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = seed
        with un.guard(), pkg.program_guard(main, startup):
            res = build(pkg, main, startup)
        out.append((main, startup, res))
    return out


def _ops(program):
    return [(op.type, op.inputs, op.outputs, op.attrs)
            for op in program.global_block().ops]


def _vars(program):
    return sorted((n, tuple(v.shape or ()), str(v.dtype),
                   type(v).__name__, bool(v.persistable))
                  for n, v in program.global_block().vars.items())


def _same_rewrite(jm, tm):
    assert _ops(tm) == _ops(jm)
    assert _vars(tm) == _vars(jm)


def _jax_start(jstart):
    scope = JScope()
    with jguard(scope):
        jfluid.Executor().run(jstart)
    return scope, {n: np.array(scope.get(n)) for n in scope.names()}


def _feed(seed=0, n=8):
    rs = np.random.RandomState(seed)
    return {"img": rs.randn(n, 3, 8, 8).astype(np.float32),
            "label": rs.randint(0, 5, (n, 1)).astype(np.int64)}


def _host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


# ---------------------------------------------------------------------------
# the rewrites, op for op
# ---------------------------------------------------------------------------

_TRANSFORMS = {
    "quantize_program_channel_wise": lambda q, m, s: q.quantize_program(m, s),
    "quantize_program_abs_max": lambda q, m, s: q.quantize_program(
        m, s, weight_quantize_type="abs_max", activation_bits=6),
    "transform_pass": lambda q, m, s: q.QuantizationTransformPass(
        scope=None).apply(m, s),
    "transform_pass_skip": lambda q, m, s: q.QuantizationTransformPass(
        quantizable_op_type=["conv2d"]).apply(m, s),
    "add_quant_dequant_pass": lambda q, m, s: q.AddQuantDequantPass(
        quantizable_op_type=("elementwise_add", "pool2d")).apply(m, s),
    "scale_for_training_pass": lambda q, m, s: q.ScaleForTrainingPass(
    ).apply(m, s),
    "transpiler": lambda q, m, s: q.QuantizeTranspiler().training_transpile(
        m, s),
    "ptq_tensor": lambda q, m, s: q.apply_ptq(m, {"img": 3.0}),
    "ptq_channel": lambda q, m, s: q.apply_ptq(
        m, {"img": 3.0}, weight_granularity="channel", weight_bits=4),
}


@pytest.mark.parametrize("name", sorted(_TRANSFORMS))
def test_rewrite_is_the_jax_rewrite_op_for_op(name):
    """Each transform over the same conv net in both packages (before
    minimize): the same ops (type, inputs, outputs, attrs) in order and
    the same variables (name, shape, dtype, kind, persistable); then the
    optimizer's ops over the rewritten net, the same again."""
    def build(pkg, main, startup):
        loss = _conv_net(pkg)[3]
        q = jquant if pkg is jfluid else quant
        with (jguard(JScope()) if pkg is jfluid
              else fluid.scope_guard(fluid.Scope())):
            _TRANSFORMS[name](q, main, startup)
        pkg.optimizer.MomentumOptimizer(0.1, 0.9).minimize(loss)
        return loss

    (jm, js, _), (tm, ts, _) = _both(build)
    _same_rewrite(jm, tm)
    _same_rewrite(js, ts)


def test_ptq_rejects_an_unknown_granularity():
    with tun.guard(), fluid.program_guard(fluid.Program(), fluid.Program()):
        _conv_net(fluid)
        with pytest.raises(ValueError, match="granularity"):
            quant.apply_ptq(fluid.default_main_program(), {},
                            weight_granularity="row")


# ---------------------------------------------------------------------------
# program-level twins on carried weights
# ---------------------------------------------------------------------------

def _qat_build(pkg, main, startup):
    img, label, logits, loss = _conv_net(pkg)
    q = jquant if pkg is jfluid else quant
    q.quantize_program(main, startup)
    pkg.optimizer.MomentumOptimizer(0.05, 0.9).minimize(loss)
    return loss


def _scale_names(program):
    return sorted(op.input("InScale")[0] for op in
                  program.global_block().ops if op.has_attr("moving_rate")
                  or op.input("InScale"))


def test_qat_three_steps_match_jax():
    """QAT (channel-wise conv weights, moving-average activations, 8/8
    bits) before minimize, three Momentum steps on new batches from JAX's
    startup: each step's loss and every moving-average scale against
    JAX's; the image's scale follows s <- 0.9 s + 0.1 max|img| from 1."""
    (jm, js, jloss), (tm, ts, tloss) = _both(_qat_build)
    jscope, init = _jax_start(js)
    tscope = fluid.scope_from_numpy(init, "cpu")
    scales = _scale_names(tm)
    assert "img.quant_scale" in scales and len(scales) == 3
    texe, jexe = fluid.Executor(CPU), jfluid.Executor()
    s = 1.0
    for step in range(3):
        feed = _feed(step)
        with jguard(jscope):
            jl = jexe.run(jm, feed=feed, fetch_list=[jloss])[0]
        tl = texe.run(tm, feed=feed, fetch_list=[tloss], scope=tscope)[0]
        np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL,
                                   err_msg=str(step))
        for n in scales:
            np.testing.assert_allclose(_host(tscope.get(n)),
                                       np.asarray(jscope.get(n)),
                                       rtol=SCALE_RTOL, err_msg=n)
        s = np.float32(0.9) * np.float32(s) + np.float32(0.1) * \
            np.abs(feed["img"]).max()
        np.testing.assert_allclose(_host(tscope.get("img.quant_scale")),
                                   [s], rtol=1e-6)


def test_ptq_scales_and_outputs_match_jax():
    """calibrate_program over four batches on the inference clone: the
    same activation names and scales (the largest |activation|) as JAX's
    on the same weights; apply_ptq at each granularity: the same ops, and
    the quantized logits within OUT_RTOL of JAX's."""
    def build(pkg, main, startup):
        return _conv_net(pkg)[2]

    (jm, js, jlog), (tm, ts, tlog) = _both(build)
    jscope, init = _jax_start(js)
    tscope = fluid.scope_from_numpy(init, "cpu")
    feeds = [{"img": _feed(k)["img"]} for k in range(4)]
    for gran in ("tensor", "channel"):
        ji, ti = jm.clone(for_test=True), tm.clone(for_test=True)
        with jguard(jscope):
            jsc = jquant.calibrate_program(jfluid.Executor(), ji, feeds)
        with fluid.scope_guard(tscope):
            tsc = quant.calibrate_program(fluid.Executor(CPU), ti, feeds)
        assert list(tsc) == list(jsc)
        for n in jsc:
            np.testing.assert_allclose(tsc[n], jsc[n], rtol=SCALE_RTOL,
                                       err_msg=n)
        jquant.apply_ptq(ji, jsc, weight_granularity=gran)
        quant.apply_ptq(ti, jsc, weight_granularity=gran)
        _same_rewrite(ji, ti)
        with jguard(jscope):
            want = np.asarray(jfluid.Executor().run(
                ji, feed=feeds[0], fetch_list=[jlog])[0])
        got = fluid.Executor(CPU).run(ti, feed=feeds[0], fetch_list=[tlog],
                                      scope=tscope)[0]
        np.testing.assert_allclose(got, want, rtol=OUT_RTOL,
                                   atol=OUT_RTOL * np.abs(want).max())


def test_freeze_and_int8_conversion_match_jax():
    """Two QAT steps, then QuantizationFreezePass (static scales from the
    learned moving averages and the weights) and ConvertToInt8Pass in
    both packages: the same frozen ops (the scale attrs within
    SCALE_RTOL), the frozen logits within OUT_RTOL of JAX's, and every
    `{name}.int8` equal to JAX's (an int8 tensor in the port's scope, on
    the weight's device), its scale JAX's."""
    def build(pkg, main, startup):
        img, label, logits, loss = _conv_net(pkg)
        (jquant if pkg is jfluid else quant).quantize_program(main, startup)
        test = main.clone(for_test=True)
        pkg.optimizer.MomentumOptimizer(0.05, 0.9).minimize(loss)
        return loss, logits, test

    (jm, js, (jloss, jlog, jt)), (tm, ts, (tloss, tlog, tt)) = _both(build)
    jscope, init = _jax_start(js)
    tscope = fluid.scope_from_numpy(init, "cpu")
    for step in range(2):
        with jguard(jscope):
            jfluid.Executor().run(jm, feed=_feed(step), fetch_list=[jloss])
        fluid.Executor(CPU).run(tm, feed=_feed(step), fetch_list=[tloss],
                                scope=tscope)
    jslim.QuantizationFreezePass(jscope).apply(jt)
    slim.QuantizationFreezePass(tscope).apply(tt)
    jo, to = _ops(jt), _ops(tt)
    assert len(jo) == len(to)
    for (jty, ji, jout, ja), (tty, ti, tout, ta) in zip(jo, to):
        assert (tty, ti, tout) == (jty, ji, jout)
        assert set(ta) == set(ja)
        for k in ja:
            if isinstance(ja[k], float):
                np.testing.assert_allclose(ta[k], ja[k], rtol=SCALE_RTOL,
                                           err_msg=k)
            else:
                assert ta[k] == ja[k], k
    assert not any("moving_average" in op[0] for op in to)
    feed = {"img": _feed(5)["img"]}
    with jguard(jscope):
        want = np.asarray(jfluid.Executor().run(jt, feed=feed,
                                                fetch_list=[jlog])[0])
    got = fluid.Executor(CPU).run(tt, feed=feed, fetch_list=[tlog],
                                  scope=tscope)[0]
    np.testing.assert_allclose(got, want, rtol=OUT_RTOL,
                               atol=OUT_RTOL * np.abs(want).max())
    jslim.ConvertToInt8Pass(jscope).apply(jt)
    slim.ConvertToInt8Pass(tscope).apply(tt)
    weights = [p.name for p in tt.all_parameters()
               if tscope.get(p.name + ".int8") is not None]
    assert len(weights) == 3
    for n in weights:
        q = tscope.get(n + ".int8")
        assert isinstance(q, torch.Tensor) and q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(),
                                      np.asarray(jscope.get(n + ".int8")))
        np.testing.assert_array_equal(
            tscope.get(n + ".int8_scale").numpy(),
            np.asarray(jscope.get(n + ".int8_scale")))
        w = tscope.get(n).numpy()
        np.testing.assert_array_equal(
            q.numpy(), np.clip(np.round(w / np.abs(w).max() * 127.0),
                               -128, 127))


def test_pruning_sticks_and_matches_jax():
    """Pruner at 50 % on both conv filters after minimize, three
    Momentum(0.05, 0.9) steps with L2Decay(1e-3): the masks equal JAX's
    (np.partition on the same weights), every pruned entry exactly 0
    after each step, the kept ones moving, the losses JAX's."""
    def build(pkg, main, startup):
        loss = _conv_net(pkg)[3]
        pkg.optimizer.MomentumOptimizer(
            0.05, 0.9, regularization=pkg.regularizer.L2Decay(1e-3)
        ).minimize(loss)
        return loss

    (jm, js, jloss), (tm, ts, tloss) = _both(build)
    jscope, init = _jax_start(js)
    tscope = fluid.scope_from_numpy(init, "cpu")
    names = [p.name for p in tm.all_parameters()
             if len(p.shape) == 4]
    assert len(names) == 2
    ratios = {n: 0.5 for n in names}
    jp, tp = jslim.Pruner(), slim.Pruner()
    jp.prune(jm, jscope, ratios, startup_program=js)
    tp.prune(tm, tscope, ratios, startup_program=ts)
    _same_rewrite(jm, tm)
    before = {n: tscope.get(n).clone() for n in names}
    for step in range(3):
        feed = _feed(step)
        with jguard(jscope):
            jl = jfluid.Executor().run(jm, feed=feed, fetch_list=[jloss])[0]
        tl = fluid.Executor(CPU).run(tm, feed=feed, fetch_list=[tloss],
                                     scope=tscope)[0]
        np.testing.assert_allclose(float(tl), float(jl), rtol=SLIM_RTOL,
                                   err_msg=str(step))
        for n in names:
            w, m = tscope.get(n).numpy(), tp.masks[n]
            np.testing.assert_array_equal(m, jp.masks[n])
            assert (w[m == 0] == 0).all(), (step, n)
    for n in names:
        m = tp.masks[n]
        assert (tscope.get(n).numpy()[m == 1]
                != before[n].numpy()[m == 1]).all()
        assert tp.sparsity(tscope)[n] >= 0.5


def _teacher_student(pkg, un):
    """A teacher (one fc) and a student (two fc) over the same data
    names, and the student's task loss: (t_main, t_startup, t_logits,
    s_main, s_startup, s_logits, s_loss)."""
    L = pkg.layers
    t_main, t_start = pkg.Program(), pkg.Program()
    t_main.random_seed = t_start.random_seed = 11
    s_main, s_start = pkg.Program(), pkg.Program()
    s_main.random_seed = s_start.random_seed = 3
    with un.guard():
        with pkg.program_guard(t_main, t_start):
            tx = L.data("x", [8, 4], append_batch_size=False)
            t_logits = L.fc(tx, size=3, param_attr=pkg.ParamAttr(
                name="t_weights"))
        return (t_main, t_start, t_logits) + _student(pkg, s_main, s_start)


def _student(pkg, s_main, s_start):
    L = pkg.layers
    with pkg.program_guard(s_main, s_start):
        x = L.data("x", [8, 4], append_batch_size=False)
        y = L.data("y", [8, 1], dtype="int64", append_batch_size=False)
        h = L.fc(x, size=16, act="relu")
        s_logits = L.fc(h, size=3)
        s_loss = L.mean(L.softmax_with_cross_entropy(s_logits, y))
    return s_main, s_start, s_logits, s_loss


def _slim_data(n=4):
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((n, 8, 4)).astype("float32")
    ys = rng.integers(0, 3, (n, 8, 1)).astype("int64")
    return [{"x": xs[i], "y": ys[i]} for i in range(n)]


def test_distillation_two_steps_match_jax():
    """DistillationStrategy (SoftLabelDistiller at temperatures 2 / 2
    onto the task loss, merge_programs with the teacher under
    'teacher_') through a Compressor of one epoch over two batches, from
    JAX's startups: the merged Program's ops are JAX's, each step's
    combined loss JAX's, the teacher's weights unchanged bitwise and its
    scope entry under the prefixed name, the student's moved."""
    runs = []
    for pkg, un, sl, guard, scope, place in (
            (jfluid, jun, jslim, jguard, JScope(), None),
            (fluid, tun, slim, fluid.scope_guard, fluid.Scope(), CPU)):
        t_main, t_start, t_logits, s_main, s_start, s_logits, s_loss = \
            _teacher_student(pkg, un)
        if pkg is jfluid:
            with guard(scope):
                exe = jfluid.Executor()
                exe.run(t_start)
                exe.run(s_start)
            init = {n: np.array(scope.get(n)) for n in scope.names()}
        else:
            scope = fluid.scope_from_numpy(init, "cpu")
        strategy = sl.DistillationStrategy(
            distillers=[sl.SoftLabelDistiller(
                student_feature_map=s_logits.name,
                teacher_feature_map="teacher_" + t_logits.name,
                student_temperature=2.0, teacher_temperature=2.0,
                distillation_loss_weight=0.5)],
            task_loss=s_loss.name, share_vars=("x",))
        losses = []

        class Record(sl.Strategy):
            def on_batch_end(self, context):
                prog = context.train_graph.program
                exe = (pkg.Executor(place) if place else pkg.Executor())
                with guard(scope):
                    losses.append(float(np.asarray(exe.run(
                        prog.clone(for_test=True), feed=_slim_data()[
                            context.batch_id], fetch_list=[
                            context.train_graph.out_nodes["distill_loss"]]
                    )[0]).reshape(-1)[0]))

        with un.guard():
            comp = sl.Compressor(
                place, scope, s_main, train_reader=lambda: iter(
                    _slim_data(2)),
                train_feed_list=["x", "y"], train_fetch_list=[s_loss],
                teacher_programs=[t_main],
                distiller_optimizer=pkg.optimizer.SGDOptimizer(0.1),
                epoch=1, strategies=[strategy, Record()])
            comp.run()
        runs.append((comp.train_graph.program, scope, losses))
    (jprog, jscope, jl), (tprog, tscope, tl) = runs
    _same_rewrite(jprog, tprog)
    assert len(tl) == 2
    np.testing.assert_allclose(tl, jl, rtol=SLIM_RTOL)
    assert not tprog.global_block().vars["teacher_t_weights"].trainable
    np.testing.assert_array_equal(tscope.get("teacher_t_weights").numpy(),
                                  init["t_weights"])
    w = [p.name for p in tprog.all_parameters() if p.trainable][0]
    assert not np.array_equal(tscope.get(w).numpy(), init[w])


# ---------------------------------------------------------------------------
# tests/api/test_quant_slim.py's twins
# ---------------------------------------------------------------------------

@pytest.fixture
def programs():
    """A fresh default main / startup program, scope and names."""
    main, startup = fluid.Program(), fluid.Program()
    with tun.guard(), fluid.program_guard(main, startup), \
            fluid.scope_guard(fluid.Scope()):
        yield main, startup


def _build_mlp():
    x = tlayers.data("x", shape=[8], dtype="float32")
    y = tlayers.data("y", shape=[1], dtype="float32")
    h = tlayers.fc(x, size=16, act="relu")
    pred = tlayers.fc(h, size=1)
    return pred, tlayers.mean(tlayers.square_error_cost(pred, y))


def test_quant_dequant_error_bound():
    x = torch.linspace(-2, 2, 101)
    got = tq.quant_dequant(x, torch.tensor(2.0), bits=8)
    assert float((got - x).abs().max()) <= 2.0 / 127 + 1e-6
    got4 = tq.quant_dequant(x, torch.tensor(2.0), bits=4)
    assert float((got4 - x).abs().max()) <= 2.0 / 7 + 1e-6


def test_ste_gradient_is_identity_inside_range():
    for v, want in (([0.3, -0.9, 0.5], 1.0), ([1.7, -3.0], 0.0)):
        t = torch.tensor(v, requires_grad=True)
        tq.quant_dequant(t, torch.tensor(1.0)).sum().backward()
        np.testing.assert_allclose(t.grad.numpy(), want, atol=1e-6)


def test_channel_wise_scales():
    w = torch.stack([torch.full((3, 3), 0.1), torch.full((3, 3), 5.0)])
    np.testing.assert_allclose(tq.channel_abs_max(w, 0), [0.1, 5.0],
                               rtol=1e-6)


def test_qat_program_inserts_fake_quant_and_trains(programs):
    main, startup = programs
    pred, loss = _build_mlp()
    n_before = len(main.global_block().ops)
    quant.quantize_program(main, startup)
    types = [op.type for op in main.global_block().ops]
    assert "fake_quantize_dequantize_abs_max" in types
    assert "fake_channel_wise_quantize_dequantize_abs_max" not in types
    assert "fake_quantize_dequantize_moving_average_abs_max" in types
    assert len(types) > n_before
    fluid.optimizer.AdamOptimizer(1e-2).minimize(loss)
    exe = fluid.Executor(CPU)
    exe.run(startup)
    rs = np.random.RandomState(0)
    xs = rs.rand(32, 8).astype(np.float32)
    ys = xs.sum(1, keepdims=True).astype(np.float32)
    losses = [float(exe.run(main, feed={"x": xs, "y": ys},
                            fetch_list=[loss])[0]) for _ in range(25)]
    assert losses[-1] < losses[0] * 0.3, losses[::6]
    scale = float(fluid.global_scope().get("x.quant_scale").reshape(-1)[0])
    assert scale != pytest.approx(1.0)


def test_qat_output_close_to_fp32(programs):
    main, startup = programs
    pred, loss = _build_mlp()
    exe = fluid.Executor(CPU)
    exe.run(startup)
    rs = np.random.RandomState(1)
    feed = {"x": rs.rand(4, 8).astype(np.float32),
            "y": np.zeros((4, 1), np.float32)}
    fp32, = exe.run(main, feed=feed, fetch_list=[pred])
    # the scope holds the weights: the transform sets the new scales
    # there, without a second startup
    quant.QuantizationTransform().apply(main, startup,
                                        scope=fluid.global_scope())
    for p in main.all_parameters():
        if p.name.endswith(".quant_scale"):
            assert float(fluid.global_scope().get(p.name)) == 1.0
    for _ in range(40):
        exe.run(main, feed=feed, fetch_list=[pred])
    q, = exe.run(main, feed=feed, fetch_list=[pred])
    assert np.abs(q - fp32).max() < 0.1


def test_ptq_calibrate_and_apply(programs):
    main, startup = programs
    pred, loss = _build_mlp()
    exe = fluid.Executor(CPU)
    exe.run(startup)
    rs = np.random.RandomState(2)
    feeds = [{"x": rs.rand(8, 8).astype(np.float32),
              "y": np.zeros((8, 1), np.float32)} for _ in range(4)]
    infer = main.clone(for_test=True)
    scales = quant.calibrate_program(exe, infer, feeds)
    assert scales and all(v > 0 for v in scales.values())
    ref, = exe.run(infer, feed=feeds[0], fetch_list=[pred])
    quant.apply_ptq(infer, scales)
    assert "quantize_dequantize_static_scale" in [
        op.type for op in infer.global_block().ops]
    got, = exe.run(infer, feed=feeds[0], fetch_list=[pred])
    assert np.abs(got - ref).max() < 0.1


def test_pruner_masks_stick_through_training(programs):
    main, startup = programs
    pred, loss = _build_mlp()
    w_name = main.all_parameters()[0].name
    fluid.optimizer.SGDOptimizer(learning_rate=0.05).minimize(loss)
    exe = fluid.Executor(CPU)
    exe.run(startup)
    pruner = slim.Pruner()
    pruner.prune(main, fluid.global_scope(), {w_name: 0.5},
                 startup_program=startup)
    mask = pruner.masks[w_name]
    assert 0.4 <= (mask == 0).mean() <= 0.6
    rs = np.random.RandomState(3)
    xs = rs.rand(16, 8).astype(np.float32)
    ys = xs.sum(1, keepdims=True).astype(np.float32)
    for _ in range(5):
        exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss])
    w = fluid.global_scope().get(w_name).numpy()
    assert np.all(w[mask == 0] == 0.0)
    assert np.abs(w[mask == 1]).sum() > 0


def test_soft_label_loss_zero_when_equal(programs):
    main, startup = programs
    s = tlayers.data("s", shape=[10], dtype="float32")
    t = tlayers.data("t", shape=[10], dtype="float32")
    kd = slim.soft_label_loss(s, t, temperature=2.0)
    exe = fluid.Executor(CPU)
    exe.run(startup)
    logits = np.random.RandomState(0).randn(4, 10).astype(np.float32)
    out, = exe.run(main, feed={"s": logits, "t": logits}, fetch_list=[kd])
    np.testing.assert_allclose(float(out), 0.0, atol=1e-6)
    out2, = exe.run(main, feed={"s": logits, "t": -logits}, fetch_list=[kd])
    assert float(out2) > 0.1


def test_fsp_and_hint_losses_build(programs):
    main, startup = programs
    a = tlayers.data("a", shape=[4, 5, 5], dtype="float32")
    b = tlayers.data("b", shape=[8, 5, 5], dtype="float32")
    ta = tlayers.data("ta", shape=[4, 5, 5], dtype="float32")
    tb = tlayers.data("tb", shape=[8, 5, 5], dtype="float32")
    floss = slim.fsp_loss(a, b, ta, tb)
    hloss = slim.l2_hint_loss(a, ta)
    exe = fluid.Executor(CPU)
    exe.run(startup)
    rs = np.random.RandomState(1)
    feed = {"a": rs.rand(2, 4, 5, 5).astype(np.float32),
            "b": rs.rand(2, 8, 5, 5).astype(np.float32)}
    feed["ta"], feed["tb"] = feed["a"], feed["b"]
    f, h = exe.run(main, feed=feed, fetch_list=[floss, hloss])
    np.testing.assert_allclose(float(f), 0.0, atol=1e-6)
    np.testing.assert_allclose(float(h), 0.0, atol=1e-6)


def test_qat_conv_uses_channel_wise(programs):
    main, startup = programs
    img = tlayers.data("img", shape=[3, 8, 8], dtype="float32")
    conv = tlayers.conv2d(img, num_filters=4, filter_size=3)
    tlayers.mean(tlayers.fc(tlayers.flatten(conv, axis=1), size=1))
    quant.quantize_program(main, startup)
    block = main.global_block()
    types = [op.type for op in block.ops]
    assert "fake_channel_wise_quantize_dequantize_abs_max" in types
    assert "fake_quantize_dequantize_abs_max" in types
    for op in block.ops:
        if op.type == "fake_channel_wise_quantize_dequantize_abs_max":
            assert list(block.vars[op.output("OutScale")[0]].shape) == [4]
        if op.type == "fake_quantize_dequantize_abs_max":
            assert list(block.vars[op.output("OutScale")[0]].shape) == [1]


# ---------------------------------------------------------------------------
# tests/api/test_slim_pipeline.py's twins
# ---------------------------------------------------------------------------

def _mlp_programs(seed=3):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with tun.guard(), fluid.program_guard(main, startup):
        x = tlayers.data("x", [8, 4], append_batch_size=False)
        y = tlayers.data("y", [8, 1], dtype="int64", append_batch_size=False)
        h = tlayers.fc(x, size=16, act="relu",
                       param_attr=fluid.ParamAttr(name="fc0_weights"))
        logits = tlayers.fc(h, size=2,
                            param_attr=fluid.ParamAttr(name="fc1_weights"))
        loss = tlayers.mean(tlayers.softmax_with_cross_entropy(logits, y))
        acc = tlayers.accuracy(tlayers.softmax(logits), y)
        test_prog = main.clone(for_test=True)
        fluid.optimizer.SGDOptimizer(0.5).minimize(loss)
    return main, startup, test_prog, loss, acc


def _data(n=4):
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((n, 8, 4)).astype("float32")
    ys = rng.integers(0, 2, (n, 8, 1)).astype("int64")
    return [{"x": xs[i], "y": ys[i]} for i in range(n)]


def test_graph_wrapper_traversal():
    main, _, _, loss, _ = _mlp_programs()
    g = slim.GraphWrapper(main, out_nodes={"loss": loss.name})
    assert {"fc0_weights", "fc1_weights"} <= {p.name()
                                              for p in g.all_parameters()}
    assert g.numel_params() >= 4 * 16 + 16 * 2
    mm = [op for op in g.ops() if op.type() in ("mul", "matmul")][0]
    nxt = g.next_ops(mm)
    assert nxt and all(isinstance(o, slim.OpWrapper) for o in nxt)
    assert mm in g.pre_ops(nxt[0])
    assert g.var("fc0_weights").is_parameter()
    assert g.clone(for_test=True).program is not main


@pytest.mark.parametrize("from_file", [False, True])
def test_compressor_with_uniform_prune_yaml(tmp_path, from_file):
    """The yaml pipeline (ConfigFactory from a dict, or from a file read
    with PyYAML) installs the masks and half-zeroes both weights over two
    epochs; eval runs each epoch."""
    main, startup, test_prog, loss, acc = _mlp_programs()
    scope = fluid.Scope()
    fluid.Executor(CPU).run(startup, scope=scope)
    cfg = {"version": 1.0,
           "pruners": {"pruner_1": {"class": "Pruner"}},
           "strategies": {"prune_s": {"class": "UniformPruneStrategy",
                                      "pruner": "pruner_1",
                                      "start_epoch": 0,
                                      "target_ratio": 0.5,
                                      "pruned_params": "fc.*weights"}},
           "compressor": {"epoch": 2, "strategies": ["prune_s"]}}
    if from_file:
        import yaml
        path = tmp_path / "compress.yaml"
        path.write_text(yaml.safe_dump(cfg))
        cfg = str(path)
    comp = slim.Compressor(
        CPU, scope, main, train_reader=lambda: iter(_data()),
        train_feed_list=["x", "y"], train_fetch_list=[loss],
        eval_program=test_prog, eval_reader=lambda: iter(_data(2)),
        eval_feed_list=["x", "y"], eval_fetch_list=[acc])
    comp.config(cfg)
    assert comp.epoch == 2 and len(comp.strategies) == 1
    ctx = comp.run()
    for name in ("fc0_weights", "fc1_weights"):
        assert (scope.get(name).numpy() == 0).mean() >= 0.45
        assert scope.get(name + ".prune_mask") is not None
    assert ctx.eval_results


def test_sensitive_prune_ranks_by_sensitivity():
    main, startup, test_prog, loss, acc = _mlp_programs()
    scope = fluid.Scope()
    fluid.Executor(CPU).run(startup, scope=scope)
    s = slim.SensitivePruneStrategy(target_ratio=0.4,
                                    pruned_params="fc.*weights")
    ctx = slim.Context(place=CPU, scope=scope,
                       train_graph=slim.GraphWrapper(main),
                       eval_graph=slim.GraphWrapper(
                           test_prog, out_nodes={0: acc.name}),
                       eval_reader=lambda: iter(_data(2)))
    before = {n: scope.get(n).clone() for n in ("fc0_weights",
                                                "fc1_weights")}
    ratios = s._ratios(ctx)
    assert set(ratios) == {"fc0_weights", "fc1_weights"}
    assert all(0.0 <= r <= 0.9 for r in ratios.values())
    for n, v in before.items():      # the probes put the weights back
        assert torch.equal(scope.get(n), v)


def test_distillation_strategy_merges_and_trains():
    t_main, t_start, t_logits, s_main, s_start, s_logits, s_loss = \
        _teacher_student(fluid, tun)
    scope = fluid.Scope()
    exe = fluid.Executor(CPU)
    exe.run(t_start, scope=scope)
    exe.run(s_start, scope=scope)
    strategy = slim.DistillationStrategy(
        distillers=[slim.SoftLabelDistiller(
            student_feature_map=s_logits.name,
            teacher_feature_map="teacher_" + t_logits.name,
            distillation_loss_weight=0.5)],
        task_loss=s_loss.name, share_vars=("x",))
    with tun.guard():
        comp = slim.Compressor(
            CPU, scope, s_main, train_reader=lambda: iter(_slim_data()),
            train_feed_list=["x", "y"], train_fetch_list=[s_loss],
            teacher_programs=[t_main],
            distiller_optimizer=fluid.optimizer.SGDOptimizer(0.1),
            epoch=1, strategies=[strategy])
        comp.run()
    names = set(comp.train_graph.program.global_block().vars)
    assert "teacher_t_weights" in names and "x" in names
    assert comp.train_graph.out_nodes.get("distill_loss")


def test_merge_programs_refuses_a_second_teacher_under_one_prefix():
    t_main, _ts, _tl, s_main, _ss, _sl, _sloss = _teacher_student(fluid, tun)
    slim.merge_programs(s_main, t_main, share=("x",))
    with pytest.raises(ValueError, match="distinct"):
        slim.merge_programs(s_main, t_main, share=("x",))


def test_qat_freeze_and_int8_roundtrip():
    main, startup = fluid.Program(), fluid.Program()
    with tun.guard(), fluid.program_guard(main, startup):
        x = tlayers.data("x", [4, 6], append_batch_size=False)
        out = tlayers.fc(x, size=3, param_attr=fluid.ParamAttr(name="qw"))
    scope = fluid.Scope()
    exe = fluid.Executor(CPU)
    exe.run(startup, scope=scope)
    xs = (np.random.default_rng(1).standard_normal((4, 6))
          .astype("float32") * 0.3)
    base = exe.run(main, feed={"x": xs}, fetch_list=[out], scope=scope)[0]
    slim.QuantizationTransformPass(scope=scope).apply(main, startup)
    assert any(op.type.startswith("fake_quantize_dequantize")
               for op in main.global_block().ops)
    qat_out = exe.run(main, feed={"x": xs}, fetch_list=[out],
                      scope=scope)[0]
    assert np.abs(qat_out - base).max() < 0.2
    slim.QuantizationFreezePass(scope).apply(main)
    types = [op.type for op in main.global_block().ops]
    assert not any("moving_average" in t for t in types)
    assert "quantize_dequantize_static_scale" in types
    frozen = exe.run(main, feed={"x": xs}, fetch_list=[out], scope=scope)[0]
    np.testing.assert_allclose(frozen, qat_out, atol=0.1)
    slim.ConvertToInt8Pass(scope).apply(main)
    q = scope.get("qw.int8")
    assert q is not None and q.dtype == torch.int8
    scale = float(scope.get("qw.int8_scale")[0])
    np.testing.assert_allclose(q.numpy().astype(np.float32) * scale / 127.0,
                               scope.get("qw").numpy(), atol=scale / 127.0)


def test_quantize_transpiler_api():
    main, startup = fluid.Program(), fluid.Program()
    with tun.guard(), fluid.program_guard(main, startup):
        x = tlayers.data("x", [2, 5], append_batch_size=False)
        tlayers.fc(x, size=2)
    from paddle_tpu_torch.contrib.quantize import QuantizeTranspiler
    with fluid.scope_guard(fluid.Scope()):
        QuantizeTranspiler().training_transpile(main, startup)
    assert any(op.type.startswith("fake_quantize")
               for op in main.global_block().ops)
    assert fluid.contrib.slim.Compressor is slim.Compressor


def test_non_ports_raise_with_guidance():
    with pytest.raises(NotImplementedError, match="MKLDNN|x86"):
        slim.MKLDNNPostTrainingQuantStrategy()
    with pytest.raises(NotImplementedError, match="MKLDNN|x86"):
        slim.TransformForMkldnnPass()
    with pytest.raises(NotImplementedError, match="paddle-mobile"):
        slim.TransformForMobilePass()
    with pytest.raises(NotImplementedError, match="item 11"):
        slim.AutoPruneStrategy()
    for name in ("SearchSpace", "SAController", "LightNASStrategy"):
        assert hasattr(jslim, name) and not hasattr(slim, name)


def test_slim_exports_the_jax_names_but_nas():
    """paddle_tpu_torch.slim has every public name of paddle_tpu.slim but
    nas.py's; quant every name of paddle_tpu.quant; contrib.quantize and
    contrib.slim the JAX package's."""
    from paddle_tpu.slim import nas
    nas_names = {n for n in dir(nas) if not n.startswith("_")}
    lack = {n for n in dir(jslim) if not n.startswith("_")} - set(dir(slim))
    assert lack <= nas_names | {"nas"}, lack
    assert lack >= {"SearchSpace", "EvolutionaryController", "SAController",
                    "ControllerServer", "SearchAgent", "LightNASStrategy"}
    assert not {n for n in dir(jquant) if not n.startswith("_")} \
        - set(dir(quant))
    assert fluid.contrib.quantize.__all__ == \
        jfluid.contrib.quantize.__all__
    assert fluid.contrib.slim.__all__ == jfluid.contrib.slim.__all__
