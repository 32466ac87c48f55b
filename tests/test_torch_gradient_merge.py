"""GradientMergeOptimizer in the port against the JAX package, on the CPU.

Twins of the 5 tests of ``tests/api/test_gradient_merge.py`` and of
``tests/parallel/test_gradient_merge_dp.py:39`` on a local dp 2 mesh: k
merged sub-batch steps equal one big-batch step of the unwrapped optimizer
(Adam, Momentum, SGD; rtol 1e-5, atol 1e-7, the JAX test's) and a numpy
big-batch Adam (rtol 1e-4, atol 1e-6); off-steps leave the parameters and
Adam's moments and beta pows bitwise as they were (the port's optimizers
update in place: the snapshot must be a copy); the counter is wired with
``increment`` and ``elementwise_mod`` (the JAX test reaches the wrapper
through the fleet strategy, which the port does not have: the twin builds
it directly and compares the op lists); minimize outside a program_guard
lands in loss's programs. Every run also goes through the JAX Executor
from the same startup scope, the port held to it at TWIN_RTOL /
TWIN_ATOL.
"""

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as jfluid
from paddle_tpu.core import unique_name as jun
from paddle_tpu.core.executor import Scope as JScope, scope_guard as jguard
from paddle_tpu.parallel.mesh import make_mesh as jmake_mesh

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import unique_name as tun

K, B, D = 3, 4, 6
CPU = fluid.CPUPlace()
TWIN_RTOL, TWIN_ATOL = 1e-5, 1e-7
PKG = {"jax": (jfluid, jun), "port": (fluid, tun)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (the suite runs
    several pytest workers at once; see tests/test_torch_bert.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _build(pkg, un, opt_factory, merge, batch=B, seed=11, k=K):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with un.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [batch, D], append_batch_size=False)
        y = pkg.layers.data("y", [batch, 1], append_batch_size=False)
        pred = pkg.layers.fc(x, size=1, param_attr=pkg.ParamAttr(name="w"),
                             bias_attr=pkg.ParamAttr(name="b"))
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        opt = opt_factory(pkg)
        if merge:
            opt = pkg.optimizer.GradientMergeOptimizer(opt, k)
        opt.minimize(loss)
    return main, startup, loss


def _data(n_steps, b=B, seed=0, bias=0.1):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((n_steps, b, D)).astype("float32")
    w = rng.standard_normal((D, 1)).astype("float32")
    return xs, (xs @ w + bias).astype("float32")


def _jax_start(startup):
    scope = JScope()
    with jguard(scope):
        jfluid.Executor().run(startup)
    return {n: np.asarray(scope.get(n)).copy() for n in scope.names()}


def _train(name, main, loss, weights, feeds, compiled=None, check=None):
    """Run `feeds` from the startup `weights` in one package; returns
    {var: numpy} of the final scope. `check(i, scope_values)` runs after
    each step."""
    pkg = PKG[name][0]
    if name == "jax":
        scope, exe = JScope(), jfluid.Executor()
        for n, v in weights.items():
            scope.set(n, jax.numpy.asarray(v))
        read = lambda n: np.asarray(scope.get(n)).copy()  # noqa: E731
        guard = jguard(scope)
    else:
        scope, exe = fluid.scope_from_numpy(weights, "cpu"), fluid.Executor(
            CPU)
        read = lambda n: scope.get(n).to("cpu", copy=True).numpy()  # noqa
        guard = fluid.scope_guard(scope)
    with guard:
        for i, feed in enumerate(feeds):
            exe.run(compiled or main, feed=feed, fetch_list=[loss])
            if check is not None:
                check(i, read)
        return {n: read(n) for n in scope.names()}


def _both(opt_factory, feeds, merge=True, batch=B, compiled=None,
          check=None):
    """The same program in both packages from JAX's startup weights:
    (JAX's final values, the port's)."""
    progs = {n: _build(pkg, un, opt_factory, merge, batch)
             for n, (pkg, un) in PKG.items()}
    weights = _jax_start(progs["jax"][1])
    out = {}
    for n in PKG:
        main, _s, loss = progs[n]
        out[n] = _train(n, main, loss, weights, feeds,
                        compiled(n, main, loss) if compiled else None,
                        check)
    for v in ("w", "b"):
        np.testing.assert_allclose(out["port"][v], out["jax"][v],
                                   rtol=TWIN_RTOL, atol=TWIN_ATOL,
                                   err_msg=v)
    return out["jax"], out["port"], weights


OPTS = {"adam": lambda pkg: pkg.optimizer.AdamOptimizer(1e-2),
        "momentum": lambda pkg: pkg.optimizer.MomentumOptimizer(0.1, 0.9),
        "sgd": lambda pkg: pkg.optimizer.SGDOptimizer(0.1)}


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_merge_k_equals_big_batch(opt):
    """2K sub-batch steps at merge k = K equal 2 big-batch (B K) steps of
    the unwrapped optimizer from the same weights."""
    xs, ys = _data(2 * K)
    feeds = [{"x": xs[i], "y": ys[i]} for i in range(2 * K)]
    _j, merged, weights = _both(OPTS[opt], feeds)
    big_feeds = [{"x": xs[j * K:(j + 1) * K].reshape(-1, D),
                  "y": ys[j * K:(j + 1) * K].reshape(-1, 1)}
                 for j in range(2)]
    main, _s, loss = _build(fluid, tun, OPTS[opt], False, batch=B * K)
    big = _train("port", main, loss, weights, big_feeds)
    for v in ("w", "b"):
        np.testing.assert_allclose(merged[v], big[v], rtol=1e-5, atol=1e-7,
                                   err_msg=v)


def _manual_adam_reference(xs, ys, w0, b0, lr=1e-2, beta1=0.9,
                           beta2=0.999, eps=1e-8):
    """Big-batch Adam over the concatenated sub-batches, in numpy."""
    w, b = w0.astype(np.float64), b0.astype(np.float64)
    mw, vw, mb, vb = (np.zeros_like(w), np.zeros_like(w), np.zeros_like(b),
                      np.zeros_like(b))
    for t, j in enumerate(range(xs.shape[0] // K), 1):
        xcat = xs[j * K:(j + 1) * K].reshape(-1, xs.shape[-1])
        ycat = ys[j * K:(j + 1) * K].reshape(-1, 1)
        diff = xcat @ w + b - ycat
        n = xcat.shape[0]
        gw = (2.0 / n) * (xcat.T @ diff)
        gb = np.full_like(b, (2.0 / n) * diff.sum())
        for g, m_, v_, key in ((gw, mw, vw, "w"), (gb, mb, vb, "b")):
            m_[...] = beta1 * m_ + (1 - beta1) * g
            v_[...] = beta2 * v_ + (1 - beta2) * g * g
            upd = lr * (m_ / (1 - beta1 ** t)) / (
                np.sqrt(v_ / (1 - beta2 ** t)) + eps)
            if key == "w":
                w = w - upd
            else:
                b = b - upd
    return w, b


def test_merge_adam_matches_manual_big_batch():
    xs, ys = _data(2 * K)
    feeds = [{"x": xs[i], "y": ys[i]} for i in range(2 * K)]
    _j, port, weights = _both(OPTS["adam"], feeds)
    w_ref, b_ref = _manual_adam_reference(xs, ys, weights["w"],
                                          weights["b"])
    np.testing.assert_allclose(port["w"], w_ref, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(port["b"], b_ref, rtol=1e-4, atol=1e-6)


def test_off_steps_leave_params_and_state_untouched():
    xs, ys = _data(K)
    feeds = [{"x": xs[i], "y": ys[i]} for i in range(K)]
    main, startup, loss = _build(fluid, tun, OPTS["adam"], True)
    scope = fluid.Scope()
    fluid.Executor(CPU).run(startup, scope=scope)
    names = ["w"] + [n for n in scope.names()
                     if "moment" in n or "beta" in n]
    assert len(names) > 1, "Adam state not found in scope"

    def snap():
        return {n: scope.get(n).to("cpu", copy=True).numpy() for n in names}

    exe = fluid.Executor(CPU)
    before = snap()
    for i in range(K - 1):
        exe.run(main, feed=feeds[i], fetch_list=[loss], scope=scope)
        now = snap()
        for n in names:
            np.testing.assert_array_equal(now[n], before[n], err_msg=n)
    exe.run(main, feed=feeds[K - 1], fetch_list=[loss], scope=scope)
    assert not np.array_equal(snap()["w"], before["w"])


def test_merge_counter_wired_with_increment_and_mod():
    """The op list of GradientMergeOptimizer(SGD, 2) equals the JAX
    package's and carries the bounded counter (the JAX test reaches the
    wrapper through DistributedStrategy.gradient_merge_steps)."""
    types = {}
    for n, (pkg, un) in PKG.items():
        main, _s, _l = _build(pkg, un, OPTS["sgd"], True, k=2)
        types[n] = [op.type for op in main.global_block().ops]
    assert types["port"] == types["jax"]
    assert "increment" in types["port"] and \
        "elementwise_mod" in types["port"]


def test_minimize_outside_program_guard():
    """minimize(loss, startup_program=...) outside a program_guard puts its
    counter and accumulators in loss's programs."""
    main, startup = fluid.Program(), fluid.Program()
    with tun.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [B, D], append_batch_size=False)
        y = fluid.layers.data("y", [B, 1], append_batch_size=False)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(
            fluid.layers.fc(x, size=1), y))
    opt = fluid.optimizer.GradientMergeOptimizer(
        fluid.optimizer.SGDOptimizer(0.1), K)
    opt.minimize(loss, startup_program=startup)     # no guard active
    assert any("grad_merge_step" in n for n in main.global_block().vars)
    xs, ys = _data(1)
    scope = fluid.Scope()
    exe = fluid.Executor(CPU)
    exe.run(startup, scope=scope)
    out = exe.run(main, feed={"x": xs[0], "y": ys[0]}, fetch_list=[loss],
                  scope=scope)
    assert np.isfinite(np.asarray(out[0])).all()


def test_gradient_merge_on_dp_mesh_matches_single_device():
    """test_gradient_merge_dp.py:39 on a local dp 2 mesh (JAX: its dp 2
    CPU mesh): Momentum merged over K, batch 8 split over two ranks;
    the first (off-)step leaves w bitwise as it was, and the merged run
    equals the single-device one (rtol 1e-5, atol 1e-6)."""
    xs, ys = _data(2 * K, b=8, seed=3, bias=0.3)
    feeds = [{"x": xs[i], "y": ys[i]} for i in range(2 * K)]
    opt = OPTS["momentum"]
    progs = {n: _build(pkg, un, opt, True, batch=8, seed=21)
             for n, (pkg, un) in PKG.items()}
    weights = _jax_start(progs["jax"][1])

    def compiled(n, main, loss):
        if n == "jax":
            return jfluid.CompiledProgram(main).with_mesh(
                jmake_mesh(dp=2, devices=jax.devices()[:2]))
        return fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, places=[CPU] * 2)

    def off_step(i, read):
        if i == 0:
            np.testing.assert_array_equal(read("w"), weights["w"])

    out = {}
    for n in PKG:
        main, _s, loss = progs[n]
        out[n] = _train(n, main, loss, weights, feeds,
                        compiled(n, main, loss), off_step)
    single = _train("port", progs["port"][0], progs["port"][2], weights,
                    feeds)
    for v in ("w", "b"):
        np.testing.assert_allclose(out["port"][v], single[v], rtol=1e-5,
                                   atol=1e-6, err_msg=v)
        np.testing.assert_allclose(out["port"][v], out["jax"][v],
                                   rtol=1e-5, atol=1e-6, err_msg=v)
