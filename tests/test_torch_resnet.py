"""Convolutional training through the port's Fluid entry points
(``paddle_tpu_torch.models.resnet`` / ``mnist``), against the JAX
package, on the CPU.

Twins of ``tests/models/test_model_zoo.py``: the MNIST conv net trains
(:32), ResNet-18 builds and steps (:54), the ResNet-50 graph builds
(:68), SE-ResNeXt overfits a fixed batch (:397); a ResNet-18 at 32 x 32
whose two Momentum steps' losses, @GRADs and running statistics are held
against the JAX Executor's; and the data-parallel twins:
``tests/parallel/test_sync_batch_norm.py:56`` at dp 8 on a local CPU mesh
against JAX's full batch on one device, plain ``batch_norm`` under
``with_data_parallel`` (the same global statistics), the strategy rewrite
(:79), and ResNet-18 at dp 2 against dp 1.

Both packages build the same Program under fresh unique-name generators;
JAX runs the startup and ``scope_from_numpy`` carries its scope into the
port. Tolerances are stated beside each constant, with what this file's
runs measured.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import layers as jlayers
from paddle_tpu.core import unique_name as jun
from paddle_tpu.core.executor import Scope as JScope, scope_guard as jguard
from paddle_tpu.models import mnist as jmnist
from paddle_tpu.models import resnet as jresnet

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.core import unique_name as tun
from paddle_tpu_torch.models import mnist as tmnist
from paddle_tpu_torch.models import resnet as tresnet

CPU = fluid.CPUPlace()
# ResNet-18 at 32 x 32, batch 8, Momentum(0.01, 0.9), port against JAX:
# the first step's loss within 1e-5 (measured 1.7e-6), the second's,
# after the update, within 1e-4 (1.2e-5); each @GRAD within 1e-3 of its
# largest magnitude plus 1e-3 of the step's largest (2.3e-5, then 9.0e-5
# at the second step); the running statistics within 1e-4 of their
# largest magnitude (1.9e-6, 4.5e-6). A larger rate (0.1) overshoots on
# this batch (the loss rises), which magnifies f32 rounding to several
# percent of a gradient by the second step, in either package against
# itself run in another summation order.
RESNET_LOSS_RTOL = (1e-5, 1e-4)
RESNET_GRAD_TOL = 1e-3
RESNET_STAT_TOL = 1e-4
# test_sync_batch_norm.py's tolerances
SYNC_RTOL, SYNC_ATOL = 2e-5, 2e-6
# ResNet-18 at dp 2 against dp 1 (the same numbers but for each rank's
# summation order in the statistics and the products): the first step's
# loss within 1e-5 (measured 3.7e-7), the second's within 1e-4
# (1.6e-5, after the update, as against JAX); @GRADs within 1e-4 of
# their largest magnitude (1.3e-5, then 4.4e-5); the running statistics
# within 1e-5 of theirs (2.9e-6).
DP_LOSS_RTOL, DP_GRAD_TOL, DP_STAT_TOL = (1e-5, 1e-4), 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_bert.py: concurrent pytest workers oversubscribe the
    CPU otherwise)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _build(pkg, un, net, seed=7):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with un.guard(), pkg.program_guard(main, startup):
        out = net(pkg)
    return main, startup, out


def _jax_start(jstart):
    scope = JScope()
    with jguard(scope):
        jfluid.Executor().run(jstart)
    return scope, {n: np.asarray(scope.get(n)) for n in scope.names()}


def _stats(program):
    return sorted(v.name for v in program.list_vars()
                  if v.persistable and (v.name.endswith(".mean_0")
                                        or ".variance" in v.name))


def _scale_err(got, want, floor=0.0):
    return float(np.abs(got - want).max()) / (
        float(np.abs(want).max()) + floor)


# ---------------------------------------------------------------------------
# the model zoo's twins
# ---------------------------------------------------------------------------

def test_mnist_conv_trains():
    """test_model_zoo.py:32: LeNet (conv-pool-bn-conv-pool-fc) trains on
    a fixed batch of 8, ten Adam(1e-3) steps from JAX's startup: the
    loss falls below half the first, and the first three losses equal
    JAX's within 1e-4 relative."""
    rs = np.random.RandomState(0)
    feed = {"img": rs.randn(8, 1, 28, 28).astype(np.float32),
            "label": rs.randint(0, 10, (8, 1)).astype(np.int64)}

    def net(pkg):
        mnist = jmnist if pkg is jfluid else tmnist
        _i, _l, _p, loss, _acc = mnist.build_train_net("conv")
        pkg.optimizer.AdamOptimizer(learning_rate=1e-3).minimize(loss)
        return loss

    jmain, jstart, jloss = _build(jfluid, jun, net)
    tmain, _ts, tloss = _build(fluid, tun, net)
    jscope, init = _jax_start(jstart)
    tscope = fluid.scope_from_numpy(init, "cpu")
    texe, jexe = fluid.Executor(CPU), jfluid.Executor()
    losses, jl = [], []
    for i in range(10):
        losses.append(float(texe.run(tmain, feed=feed, fetch_list=[tloss],
                                     scope=tscope)[0]))
        if i < 3:
            with jguard(jscope):
                jl.append(float(jexe.run(jmain, feed=feed,
                                         fetch_list=[jloss])[0]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.5, losses
    np.testing.assert_allclose(losses[:3], jl, rtol=1e-4)


@pytest.mark.parametrize("net", ["softmax", "mlp"])
def test_mnist_builders_equal_jax(net):
    """softmax_regression and multilayer_perceptron build JAX's op list
    and parameter shapes, and their first loss equals JAX's."""
    rs = np.random.RandomState(1)
    feed = {"img": rs.randn(4, 1, 28, 28).astype(np.float32),
            "label": rs.randint(0, 10, (4, 1)).astype(np.int64)}

    def build(pkg):
        mnist = jmnist if pkg is jfluid else tmnist
        return mnist.build_train_net(net)[3]

    jmain, jstart, jloss = _build(jfluid, jun, build)
    tmain, _ts, tloss = _build(fluid, tun, build)
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    jscope, init = _jax_start(jstart)
    with jguard(jscope):
        jl, = jfluid.Executor().run(jmain, feed=feed, fetch_list=[jloss])
    tl, = fluid.Executor(CPU).run(tmain, feed=feed, fetch_list=[tloss],
                                  scope=fluid.scope_from_numpy(init, "cpu"))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


def test_resnet18_builds_and_steps():
    """test_model_zoo.py:54: ResNet-18 (10 classes, 32 x 32) takes three
    Adam(1e-3) steps on random batches of 4 from the port's own startup;
    every loss is finite."""
    rs = np.random.RandomState(0)

    def net(pkg):
        loss = tresnet.build_train_net(depth=18, class_dim=10,
                                       image_shape=(3, 32, 32))[3]
        pkg.optimizer.AdamOptimizer(learning_rate=1e-3).minimize(loss)
        return loss

    main, startup, loss = _build(fluid, tun, net)
    scope, exe = fluid.Scope(), fluid.Executor(CPU)
    exe.run(startup, scope=scope)
    losses = [float(exe.run(main, feed={
        "img": rs.randn(4, 3, 32, 32).astype(np.float32),
        "label": rs.randint(0, 10, (4, 1)).astype(np.int64)},
        fetch_list=[loss], scope=scope)[0]) for _ in range(3)]
    assert np.isfinite(losses).all()


def test_resnet50_graph_builds_as_jax():
    """test_model_zoo.py:68: the ResNet-50 graph (100 classes, 64 x 64)
    has more than 150 parameters: 53 convolutions, 53 batch norms' scale
    and shift, the fc's weight and bias; the port's parameters, their
    shapes, the op list and the running statistics equal JAX's."""
    def net(pkg):
        L = jlayers if pkg is jfluid else tlayers
        res = jresnet if pkg is jfluid else tresnet
        return res.resnet(L.data("img", shape=[3, 64, 64], dtype="float32"),
                          class_dim=100, depth=50)

    jmain, _js, _j = _build(jfluid, jun, net)
    tmain, _ts, _t = _build(fluid, tun, net)
    params = [(p.name, tuple(p.shape)) for p in tmain.all_parameters()]
    assert len(params) > 150
    assert params == [(p.name, tuple(p.shape))
                      for p in jmain.all_parameters()]
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    assert _stats(tmain) == _stats(jmain) and len(_stats(tmain)) == 2 * 53


def test_se_resnext_overfits_fixed_batch():
    """test_model_zoo.py:397: the compact SE-ResNeXt (grouped 3x3
    convolutions, sigmoid excitation) on a fixed batch of 16 at 16 x 16,
    80 Adam(2e-3) steps from the port's own startup: the last loss is
    below a tenth of the first."""
    rs = np.random.RandomState(5)
    xs = rs.randn(16, 3, 16, 16).astype(np.float32)
    ys = rs.randint(0, 4, (16, 1)).astype(np.int64)

    def net(pkg):
        _img, _lbl, loss, _pred = tresnet.build_se_resnext_train_net(
            class_dim=4, image_shape=(3, 16, 16))
        pkg.optimizer.AdamOptimizer(learning_rate=2e-3).minimize(loss)
        return loss

    main, startup, loss = _build(fluid, tun, net)
    types = {op.type for op in main.global_block().ops}
    assert {"conv2d", "sigmoid", "batch_norm", "pool2d"} <= types
    scope, exe = fluid.Scope(), fluid.Executor(CPU)
    exe.run(startup, scope=scope)
    losses = [float(exe.run(main, feed={"image": xs, "label": ys},
                            fetch_list=[loss], scope=scope)[0])
              for _ in range(80)]
    assert losses[-1] < losses[0] * 0.1, (losses[0], losses[-1])


# ---------------------------------------------------------------------------
# ResNet-18 against the JAX Executor; at dp 2 against dp 1
# ---------------------------------------------------------------------------

def _resnet18(pkg):
    res = jresnet if pkg is jfluid else tresnet
    loss = res.build_train_net(depth=18, class_dim=10,
                               image_shape=(3, 32, 32))[3]
    pkg.optimizer.MomentumOptimizer(0.01, 0.9).minimize(loss)
    return loss


def _resnet_feed(batch=8):
    rs = np.random.RandomState(0)
    return {"img": rs.randn(batch, 3, 32, 32).astype(np.float32),
            "label": rs.randint(0, 10, (batch, 1)).astype(np.int64)}


@pytest.fixture(scope="module")
def resnet18():
    """(JAX main, JAX startup's arrays, port main, port loss, JAX loss)."""
    jmain, jstart, jloss = _build(jfluid, jun, _resnet18)
    tmain, _ts, tloss = _build(fluid, tun, _resnet18)
    _scope, init = _jax_start(jstart)
    return jmain, init, tmain, tloss, jloss


def _port_steps(program, tmain, tloss, init, feed, steps=2):
    """[(loss, @GRADs...)] a step, and the scope after."""
    names = [p.name + "@GRAD" for p in tmain.all_parameters()]
    scope = fluid.scope_from_numpy(init, "cpu")
    exe = fluid.Executor(CPU)
    outs = [exe.run(program, feed=feed, fetch_list=[tloss] + names,
                    scope=scope) for _ in range(steps)]
    return outs, scope


def test_resnet18_momentum_steps_match_jax(resnet18):
    """Two Momentum(0.01, 0.9) steps of ResNet-18 on one batch of 8:
    each step's loss and @GRADs, and every batch norm's running mean and
    variance after the steps, against the JAX Executor's (tolerances at
    the top of the file)."""
    jmain, init, tmain, tloss, jloss = resnet18
    feed = _resnet_feed()
    names = [p.name + "@GRAD" for p in tmain.all_parameters()]
    jscope = JScope()
    for n, v in init.items():
        jscope.set(n, np.array(v))
    jexe = jfluid.Executor()
    with jguard(jscope):
        want = [[np.asarray(v) for v in jexe.run(
            jmain, feed=feed, fetch_list=[jloss] + names)]
            for _ in range(2)]
    got, tscope = _port_steps(tmain, tmain, tloss, init, feed)
    for step, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g[0], w[0], rtol=RESNET_LOSS_RTOL[step])
        gmax = max(float(np.abs(a).max()) for a in w[1:])
        for name, a, b in zip(names, g[1:], w[1:]):
            assert _scale_err(a, b, 1e-3 * gmax) <= RESNET_GRAD_TOL, \
                (step, name)
    stats = _stats(tmain)
    assert len(stats) == 2 * 20
    for n in stats:
        assert _scale_err(tscope.get(n).numpy(),
                          np.asarray(jscope.get(n))) <= RESNET_STAT_TOL, n


def test_resnet18_at_dp2_matches_dp1(resnet18):
    """ResNet-18 through with_data_parallel on [CPUPlace()] * 2 against
    the plain Executor: each batch norm takes the global batch's
    statistics (its dp rule), so two Momentum steps' losses, @GRADs and
    running statistics agree at the dp tolerances."""
    _jm, init, tmain, tloss, _jl = resnet18
    feed = _resnet_feed()
    comp = fluid.CompiledProgram(tmain).with_data_parallel(
        loss_name=tloss.name, places=[CPU] * 2)
    want, wscope = _port_steps(tmain, tmain, tloss, init, feed)
    got, gscope = _port_steps(comp, tmain, tloss, init, feed)
    for step, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g[0], w[0], rtol=DP_LOSS_RTOL[step])
        for a, b in zip(g[1:], w[1:]):
            assert _scale_err(a, b) <= DP_GRAD_TOL
    for n in _stats(tmain):
        assert _scale_err(gscope.get(n).numpy(),
                          wscope.get(n).numpy()) <= DP_STAT_TOL, n


# ---------------------------------------------------------------------------
# batch norm's global statistics under dp (test_sync_batch_norm.py)
# ---------------------------------------------------------------------------

def _bn_program(pkg, L, un, sync):
    """test_sync_batch_norm.py's _build: batch_norm (momentum 0.9) then
    mean(y * y) under SGD(0.1); `sync` renames the op."""
    main, startup = pkg.Program(), pkg.Program()
    with un.guard(), pkg.program_guard(main, startup):
        x = L.data("x", shape=[3, 4, 4], dtype="float32")
        y = L.batch_norm(x, momentum=0.9, moving_mean_name="bn_mean",
                         moving_variance_name="bn_var")
        loss = L.mean(L.elementwise_mul(y, y))
        pkg.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    if sync:
        for op in main.global_block().ops:
            if op.type == "batch_norm":
                op.type = "sync_batch_norm"
    return main, startup, loss


def _sync_feed():
    """test_sync_batch_norm.py:59: per-device sub-batches deliberately
    non-identical in distribution (scaled per sample), so per-shard
    statistics differ from the global ones."""
    rng = np.random.RandomState(0)
    return (rng.randn(8, 3, 4, 4) *
            np.linspace(0.5, 2.0, 8)[:, None, None, None]).astype(np.float32)


def _port_bn(sync, places, steps=3):
    """(losses, (running mean, running variance)) of three steps."""
    main, startup, loss = _bn_program(fluid, tlayers, tun, sync)
    prog = main if places is None else fluid.CompiledProgram(
        main).with_data_parallel(loss_name=loss.name, places=places)
    scope, exe = fluid.Scope(), fluid.Executor(CPU)
    exe.run(startup, scope=scope)
    losses = [float(exe.run(prog, feed={"x": _sync_feed()},
                            fetch_list=[loss], scope=scope)[0])
              for _ in range(steps)]
    return losses, (scope.get("bn_mean").numpy(),
                    scope.get("bn_var").numpy())


def test_sync_bn_dp8_matches_jax_full_batch_single_device():
    """test_sync_batch_norm.py:56: sync_batch_norm at dp 8 on a local CPU
    mesh (one row a rank) gives JAX's full-batch single-device losses,
    running mean and running variance at the reference's rtol 2e-5, atol
    2e-6; per-rank statistics would differ (the sub-batches are scaled
    apart), and the running variance after three steps differs from a
    per-rank one's by far more than that."""
    jmain, jstart, jloss = _bn_program(jfluid, jlayers, jun, False)
    jscope = JScope()
    jl = []
    with jguard(jscope):
        exe = jfluid.Executor()
        exe.run(jstart)
        for _ in range(3):
            out, = exe.run(jmain, feed={"x": _sync_feed()},
                           fetch_list=[jloss])
            jl.append(float(np.asarray(out).reshape(-1)[0]))
    jmean = np.asarray(jscope.get("bn_mean"))
    jvar = np.asarray(jscope.get("bn_var"))
    tl, (tmean, tvar) = _port_bn(True, [CPU] * 8)
    np.testing.assert_allclose(tl, jl, rtol=SYNC_RTOL, atol=SYNC_ATOL)
    np.testing.assert_allclose(tmean, jmean, rtol=SYNC_RTOL, atol=SYNC_ATOL)
    np.testing.assert_allclose(tvar, jvar, rtol=SYNC_RTOL, atol=SYNC_ATOL)
    x = _sync_feed()
    per_rank_var = np.mean([x[i:i + 1].var((0, 2, 3)) for i in range(8)], 0)
    assert np.abs(per_rank_var - x.var((0, 2, 3))).max() > 0.1


@pytest.mark.parametrize("places", [2, 8])
def test_plain_batch_norm_under_dp_takes_the_global_statistics(places):
    """Plain batch_norm through with_data_parallel (no rewrite) gives
    sync_batch_norm's losses and running statistics at dp 2 and dp 8,
    and the plain Executor's full-batch ones, at the reference's
    tolerances: the two op names share one dp rule."""
    plain = _port_bn(False, [CPU] * places)
    sync = _port_bn(True, [CPU] * places)
    single = _port_bn(False, None)
    for got in (plain, sync):
        np.testing.assert_allclose(got[0], single[0], rtol=SYNC_RTOL,
                                   atol=SYNC_ATOL)
        for a, b in zip(got[1], single[1]):
            np.testing.assert_allclose(a, b, rtol=SYNC_RTOL, atol=SYNC_ATOL)


def test_build_strategy_sync_batch_norm_rewrites_ops_as_jax():
    """test_sync_batch_norm.py:79 with the batch_norm layer: with
    BuildStrategy.sync_batch_norm, with_data_parallel renames the
    program's batch_norm ops as JAX's does, and the rewritten program
    runs at dp 2."""
    types = []
    for pkg, L, un in ((jfluid, jlayers, jun), (fluid, tlayers, tun)):
        main, startup = pkg.Program(), pkg.Program()
        with un.guard(), pkg.program_guard(main, startup):
            x = L.data("x", shape=[3, 4, 4], dtype="float32")
            loss = L.mean(L.batch_norm(x))
        bs = pkg.BuildStrategy()
        bs.sync_batch_norm = True
        kw = {} if pkg is jfluid else {"places": [CPU] * 2}
        comp = pkg.CompiledProgram(main).with_data_parallel(
            build_strategy=bs, **kw)
        types.append([op.type for op in main.global_block().ops])
    assert types[0] == types[1]
    assert "sync_batch_norm" in types[1] and "batch_norm" not in types[1]
    scope = fluid.Scope()
    exe = fluid.Executor(CPU)
    exe.run(startup, scope=scope)
    out, = exe.run(comp, feed={"x": _sync_feed()}, fetch_list=[loss],
                   scope=scope)
    assert np.isfinite(out).all()

