"""The port's optimizer wrappers against the JAX package, on the CPU.

Twins of the 9 tests of ``tests/api/test_optimizer_wrappers.py``: EMA
(bias-corrected apply, fluid's bare apply / restore, repeated and nested
applies, thres_steps' decay schedule), ModelAverage (bare apply, context
apply), Lookahead (slow starts at the parameter and syncs every k) and
LARS. Each test body runs in both packages from the same constant
initializers and feeds: the port is held to the reference formula at the
JAX test's own tolerance (rtol 1e-5; 1e-6 for restored weights), and to
the JAX package's values at TWIN_RTOL (f32 in another order). The port's
optimizers update in place, so every value is copied to numpy as it is
read, and ``restore()`` must bring back the training weights bitwise.
"""

import types

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core import framework as jframework
from paddle_tpu.core.executor import (Scope as JScope, global_scope as jgs,
                                      scope_guard as jguard)

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import framework as tframework

TWIN_RTOL, TWIN_ATOL = 1e-6, 1e-7
CPU = fluid.CPUPlace()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (the suite runs
    several pytest workers at once; see tests/test_torch_bert.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


PKGS = {
    "jax": types.SimpleNamespace(
        fluid=jfluid, layers=jfluid.layers, framework=jframework,
        Scope=JScope, scope_guard=jguard, global_scope=jgs,
        executor=lambda: jfluid.Executor(),
        value=lambda v: np.array(np.asarray(v), copy=True)),
    "port": types.SimpleNamespace(
        fluid=fluid, layers=fluid.layers, framework=tframework,
        Scope=fluid.Scope, scope_guard=fluid.scope_guard,
        global_scope=fluid.global_scope,
        executor=lambda: fluid.Executor(CPU),
        value=lambda v: v.detach().to("cpu", copy=True).numpy()),
}


def both(body):
    """body(pkg) in both packages -> (JAX's record, the port's record),
    the port's held to JAX's value by value."""
    rec = {name: body(pkg) for name, pkg in PKGS.items()}
    for k, want in rec["jax"].items():
        np.testing.assert_allclose(rec["port"][k], want, rtol=TWIN_RTOL,
                                   atol=TWIN_ATOL, err_msg=k)
    return rec["jax"], rec["port"]


def _build_sgd_net(P, lr=0.1):
    x = P.layers.data("x", [2], append_batch_size=False)
    w = P.layers.create_parameter(
        [2], "float32", name="w",
        default_initializer=P.fluid.initializer.ConstantInitializer(1.0))
    loss = P.layers.mean(P.layers.elementwise_mul(w, x))
    opt = P.fluid.optimizer.SGDOptimizer(learning_rate=lr)
    return x, w, loss, opt


def _w(P):
    return P.value(P.global_scope().get("w"))


def _ema_program(P, decay, thres=False):
    main, startup = P.framework.Program(), P.framework.Program()
    with P.framework.program_guard(main, startup):
        x, w, loss, opt = _build_sgd_net(P, lr=0.1)
        opt.minimize(loss)
        t = (P.layers.autoincreased_step_counter(begin=0, step=1)
             if thres else None)
        ema = P.fluid.optimizer.ExponentialMovingAverage(decay,
                                                         thres_steps=t)
        ema.update()
    return main, startup, loss, ema


def test_ema_bias_corrected_apply_and_restore():
    decay = 0.5
    xv = np.array([1.0, 2.0], np.float32)

    def body(P):
        main, startup, loss, ema = _ema_program(P, decay)
        exe, rec = P.executor(), {}
        with P.scope_guard(P.Scope()):
            exe.run(startup)
            ema_ref = np.zeros(2)
            for _ in range(3):
                exe.run(main, feed={"x": xv}, fetch_list=[loss])
                ema_ref = decay * ema_ref + (1 - decay) * _w(P)
            w_before = _w(P)
            with ema.apply():
                rec["applied"] = _w(P)
                np.testing.assert_allclose(
                    rec["applied"], ema_ref / (1 - decay ** 3), rtol=1e-5)
            rec["restored"] = _w(P)
            np.testing.assert_array_equal(rec["restored"], w_before)
        return rec

    both(body)


def test_ema_fluid_style_restore_method():
    xv = np.array([1.0, 2.0], np.float32)

    def body(P):
        main, startup, loss, ema = _ema_program(P, 0.5)
        exe, rec = P.executor(), {}
        with P.scope_guard(P.Scope()):
            exe.run(startup)
            for _ in range(2):
                exe.run(main, feed={"x": xv}, fetch_list=[loss])
            w_train = _w(P)
            ema.apply(exe, need_restore=False)
            rec["applied"] = _w(P)
            assert not np.allclose(rec["applied"], w_train)
            ema.restore(exe)
            np.testing.assert_array_equal(_w(P), w_train)
            ema.restore(exe)            # a second restore changes nothing
            np.testing.assert_array_equal(_w(P), w_train)
            ema.apply(exe, need_restore=False)
            assert str(P.global_scope().get("w").dtype).endswith("float32")
            ema.restore(exe)
            rec["train"] = _w(P)
        return rec

    both(body)


def test_ema_repeated_apply_never_loses_training_weights():
    xv = np.array([1.0, 2.0], np.float32)

    def body(P):
        main, startup, loss, ema = _ema_program(P, 0.5)
        exe = P.executor()
        with P.scope_guard(P.Scope()):
            exe.run(startup)
            for _ in range(2):
                exe.run(main, feed={"x": xv}, fetch_list=[loss])
            w_train = _w(P)
            ema.apply(exe, need_restore=False)
            ema.apply(exe, need_restore=False)
            ema.restore(exe)
            np.testing.assert_array_equal(_w(P), w_train)
            return {"w": _w(P)}

    both(body)


def test_ema_nested_apply_contexts_unwind_one_level_each():
    xv = np.array([1.0, 2.0], np.float32)

    def body(P):
        main, startup, loss, ema = _ema_program(P, 0.5)
        exe, rec = P.executor(), {}
        with P.scope_guard(P.Scope()):
            exe.run(startup)
            for _ in range(2):
                exe.run(main, feed={"x": xv}, fetch_list=[loss])
            w_train = _w(P)
            with ema.apply(exe):
                rec["outer"] = _w(P)
                with ema.apply(exe):
                    rec["inner"] = _w(P)
                np.testing.assert_array_equal(_w(P), rec["outer"])
            np.testing.assert_array_equal(_w(P), w_train)
        return rec

    both(body)


def _ma_program(P):
    main, startup = P.framework.Program(), P.framework.Program()
    with P.framework.program_guard(main, startup):
        x, w, loss, opt = _build_sgd_net(P, lr=0.1)
        opt.minimize(loss)
        ma = P.fluid.optimizer.ModelAverage(0.15)
    return main, startup, loss, ma


def test_model_average_bare_apply_and_restore():
    xv = np.array([1.0, 2.0], np.float32)

    def body(P):
        main, startup, loss, ma = _ma_program(P)
        exe, rec = P.executor(), {}
        with P.scope_guard(P.Scope()):
            exe.run(startup)
            ws = []
            for _ in range(3):
                exe.run(main, feed={"x": xv}, fetch_list=[loss])
                ws.append(_w(P))
            ma.apply(exe, need_restore=False)
            rec["avg"] = _w(P)
            np.testing.assert_allclose(rec["avg"], np.mean(ws, axis=0),
                                       rtol=1e-5)
            ma.restore(exe)
            np.testing.assert_array_equal(_w(P), ws[-1])
        return rec

    both(body)


def test_model_average_applies_mean():
    xv = np.array([2.0, 4.0], np.float32)

    def body(P):
        main, startup, loss, ma = _ma_program(P)
        exe, rec = P.executor(), {}
        with P.scope_guard(P.Scope()):
            exe.run(startup)
            seen = []
            for _ in range(4):
                exe.run(main, feed={"x": xv}, fetch_list=[loss])
                seen.append(_w(P))
            with ma.apply():
                rec["avg"] = _w(P)
                np.testing.assert_allclose(rec["avg"], np.mean(seen, axis=0),
                                           rtol=1e-5)
        return rec

    both(body)


def test_lookahead_slow_starts_at_param_and_syncs():
    alpha, k, lr = 0.5, 2, 0.1
    xv = np.array([1.0, 1.0], np.float32)

    def body(P):
        main, startup = P.framework.Program(), P.framework.Program()
        with P.framework.program_guard(main, startup):
            x, w, loss, opt = _build_sgd_net(P, lr=lr)
            P.fluid.optimizer.LookaheadOptimizer(opt, alpha=alpha,
                                                 k=k).minimize(loss)
        exe, rec = P.executor(), {}
        with P.scope_guard(P.Scope()):
            exe.run(startup)
            fast = np.ones(2)
            slow = fast.copy()          # the startup assign, not zero
            for step in range(1, 5):
                exe.run(main, feed={"x": xv}, fetch_list=[loss])
                fast = fast - lr * xv / 2.0
                if step % k == 0:
                    slow = slow + alpha * (fast - slow)
                    fast = slow.copy()
                rec[f"w{step}"] = _w(P)
                np.testing.assert_allclose(rec[f"w{step}"], fast, rtol=1e-5,
                                           err_msg=f"step {step}")
        return rec

    both(body)


def test_lars_momentum_matches_formula():
    lr, mu, coeff, wd = 0.1, 0.9, 0.001, 0.0005
    xv = np.array([1.0, 3.0], np.float32)

    def body(P):
        main, startup = P.framework.Program(), P.framework.Program()
        with P.framework.program_guard(main, startup):
            x = P.layers.data("x", [2], append_batch_size=False)
            w = P.layers.create_parameter(
                [2], "float32", name="w",
                default_initializer=P.fluid.initializer.ConstantInitializer(
                    2.0))
            loss = P.layers.mean(P.layers.elementwise_mul(w, x))
            P.fluid.optimizer.LarsMomentumOptimizer(
                learning_rate=lr, momentum=mu, lars_coeff=coeff,
                lars_weight_decay=wd).minimize(loss)
        exe, rec = P.executor(), {}
        with P.scope_guard(P.Scope()):
            exe.run(startup)
            p, v = np.full(2, 2.0), np.zeros(2)
            for step in range(2):
                exe.run(main, feed={"x": xv}, fetch_list=[loss])
                g = xv / 2.0
                local_lr = lr * coeff * np.linalg.norm(p) / (
                    np.linalg.norm(g) + wd * np.linalg.norm(p))
                v = mu * v + local_lr * (g + wd * p)
                p = p - v
                rec[f"w{step}"] = _w(P)
                np.testing.assert_allclose(rec[f"w{step}"], p, rtol=1e-5,
                                           err_msg=f"step {step}")
        return rec

    both(body)


def test_ema_thres_steps_schedules_decay():
    xv = np.array([1.0, 2.0], np.float32)

    def body(P):
        main, startup, loss, ema = _ema_program(P, 0.999, thres=True)
        exe, rec = P.executor(), {}
        with P.scope_guard(P.Scope()):
            exe.run(startup)
            for t in range(3):
                exe.run(main, feed={"x": xv}, fetch_list=[loss])
                got = float(np.ravel(P.value(
                    P.global_scope().get(ema._decay_name)))[0])
                want = min(0.999, (t + 1.0) / (t + 10.0))
                assert got == pytest.approx(want, rel=1e-6), (t, got, want)
                rec[f"decay{t}"] = np.float32(got)
        return rec

    both(body)
