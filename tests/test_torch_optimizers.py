"""The port's optimizers, regularizers, gradient clips and learning-rate
schedules against the JAX package and the reference formulas, on the CPU.

Twins of ``tests/api/test_optimizer_parity.py`` (every update rule on
loss = sum(w * x), so dL/dw = x, replayed in numpy over three steps),
``tests/api/test_semantic_parity.py``'s momentum, Nesterov, L2 and L1
cases, and ``tests/api/test_lr_scheduler_parity.py`` (the schedules and
the global-norm clip). Each optimizer also runs in the JAX Executor from
the same startup scope (carried over with ``scope_from_numpy``). All f32:
the formulas at the JAX tests' own tolerances (rtol 1e-5, atol 1e-6;
LAMB 1e-4 / 1e-5); port against JAX at rtol 1e-5 + atol 1e-7 (the same
f32 arithmetic in another order); the schedules' rates at rtol 1e-6.
"""

import math

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core import unique_name as jun
from paddle_tpu.core.executor import Scope as JScope, scope_guard as jguard

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import unique_name as tun

D = 4
LR = 0.1
CPU = fluid.CPUPlace()
TWIN_RTOL, TWIN_ATOL = 1e-5, 1e-7
LR_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (the suite runs
    several pytest workers at once; see tests/test_torch_bert.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _carry(jscope):
    return fluid.scope_from_numpy(
        {n: np.asarray(jscope.get(n)) for n in jscope.names()}, "cpu")


def _twin_steps(net, make_opt, feeds, watch, seed=9):
    """Build `net` + make_opt(pkg).minimize in both packages, start in
    JAX, carry the scope over, run the feeds in both. Returns (start
    values, JAX values, port values) of the `watch` vars."""
    progs = {}
    for pkg, un in ((jfluid, jun), (fluid, tun)):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = seed
        with un.guard(), pkg.program_guard(main, startup):
            loss = net(pkg)
            make_opt(pkg).minimize(loss)
        progs[pkg] = (main, startup, loss)
    jmain, jstart, jloss = progs[jfluid]
    tmain, _ts, tloss = progs[fluid]
    jscope, jexe = JScope(), jfluid.Executor()
    with jguard(jscope):
        jexe.run(jstart)
    start = {n: np.asarray(jscope.get(n)).copy() for n in watch}
    tscope, texe = _carry(jscope), fluid.Executor(CPU)
    for feed in feeds:
        with jguard(jscope):
            jexe.run(jmain, feed=feed, fetch_list=[jloss])
        with fluid.scope_guard(tscope):
            texe.run(tmain, feed=feed, fetch_list=[tloss])
    return (start, {n: np.asarray(jscope.get(n)) for n in watch},
            {n: tscope.get(n).numpy() for n in watch})


def _linear(pkg):
    """loss = sum(w * x): dL/dw = x (test_optimizer_parity.py)."""
    lay = pkg.layers
    x = lay.data("x", shape=[D], dtype="float32")
    w = lay.create_parameter([D], "float32", name="w",
                             default_initializer=pkg.initializer
                             .NormalInitializer(0.0, 1.0))
    return lay.reduce_sum(lay.elementwise_mul(w, x))


def _adam(w, grads, b1=0.9, b2=0.999, eps=1e-8):
    m = np.zeros(D); v = np.zeros(D); b1p = b2p = 1.0
    for g in grads:
        b1p *= b1; b2p *= b2
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        w = w - LR * np.sqrt(1 - b2p) / (1 - b1p) * m / (np.sqrt(v) + eps)
    return w


def _adamax(w, grads, b1=0.9, b2=0.999, eps=1e-8):
    m = np.zeros(D); inf = np.zeros(D); b1p = 1.0
    for g in grads:
        b1p *= b1
        m = b1 * m + (1 - b1) * g
        inf = np.maximum(b2 * inf, np.abs(g))
        w = w - (LR / (1 - b1p)) * m / (inf + eps)
    return w


def _adagrad(w, grads, eps=1e-6):
    acc = np.zeros(D)
    for g in grads:
        acc = acc + g * g
        w = w - LR * g / (np.sqrt(acc) + eps)
    return w


def _decayed_adagrad(w, grads, decay=0.95, eps=1e-6):
    acc = np.zeros(D)
    for g in grads:
        acc = decay * acc + (1 - decay) * g * g
        w = w - LR * g / (np.sqrt(acc) + eps)
    return w


def _adadelta(w, grads, rho=0.95, eps=1e-6):
    ag = np.zeros(D); au = np.zeros(D)
    for g in grads:
        ag = rho * ag + (1 - rho) * g * g
        upd = -np.sqrt((au + eps) / (ag + eps)) * g
        au = rho * au + (1 - rho) * upd * upd
        w = w + upd
    return w


def _rmsprop(w, grads, centered, rho=0.95, eps=1e-6, mom=0.9):
    ms = np.zeros(D); mo = np.zeros(D); mg = np.zeros(D)
    for g in grads:
        ms = rho * ms + (1 - rho) * g * g
        if centered:
            mg = rho * mg + (1 - rho) * g
            mo = mom * mo + LR * g / np.sqrt(ms - mg * mg + eps)
        else:
            mo = mom * mo + LR * g / np.sqrt(ms + eps)
        w = w - mo
    return w


def _ftrl(w, grads, l1=0.1, l2=0.05, lrp=-0.5):
    sq = np.zeros(D); lin = np.zeros(D)
    for g in grads:
        new_sq = sq + g * g
        sigma = (new_sq ** -lrp - sq ** -lrp) / LR
        lin = lin + g - sigma * w
        pre = np.clip(lin, -l1, l1) - lin
        w = pre / (new_sq ** -lrp / LR + 2 * l2)
        sq = new_sq
    return w


def _lamb(w, grads, b1=0.9, b2=0.999, eps=1e-6, wd=0.01):
    m = np.zeros(D); v = np.zeros(D); b1p = b2p = 1.0
    for g in grads:
        b1p *= b1; b2p *= b2
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        r = m / (1 - b1p) / (np.sqrt(v / (1 - b2p)) + eps) + wd * w
        pn, rn = np.linalg.norm(w), np.linalg.norm(r)
        w = w - LR * (pn / rn if pn > 0 and rn > 0 else 1.0) * r
    return w


def _momentum(w, grads, mu=0.9, nesterov=False):
    v = np.zeros(D)
    for g in grads:
        v = mu * v + g
        w = w - LR * ((g + mu * v) if nesterov else v)
    return w


def _lars(w, grads, mu=0.9, coeff=0.001, wd=0.0005):
    v = np.zeros(D)
    for g in grads:
        pn, gn = np.linalg.norm(w), np.linalg.norm(g)
        v = mu * v + LR * coeff * pn / (gn + wd * pn + 1e-12) * (g + wd * w)
        w = w - v
    return w


# name -> (make the optimizer from a package, the formula, rtol, atol)
OPTIMIZERS = {
    "sgd": (lambda o: o.SGDOptimizer(LR),
            lambda w, gs: w - LR * np.sum(gs, axis=0), 1e-5, 1e-6),
    "adam": (lambda o: o.AdamOptimizer(LR, beta1=0.9, beta2=0.999,
                                       epsilon=1e-8), _adam, 1e-5, 1e-6),
    "adamax": (lambda o: o.AdamaxOptimizer(LR, beta1=0.9, beta2=0.999,
                                           epsilon=1e-8), _adamax, 1e-5,
               1e-6),
    "adagrad": (lambda o: o.AdagradOptimizer(LR, epsilon=1e-6), _adagrad,
                1e-5, 1e-6),
    "decayed_adagrad": (lambda o: o.DecayedAdagradOptimizer(
        LR, decay=0.95, epsilon=1e-6), _decayed_adagrad, 1e-5, 1e-6),
    "adadelta": (lambda o: o.AdadeltaOptimizer(LR, epsilon=1e-6, rho=0.95),
                 _adadelta, 1e-5, 1e-6),
    "rmsprop": (lambda o: o.RMSPropOptimizer(LR, rho=0.95, epsilon=1e-6,
                                             momentum=0.9),
                lambda w, gs: _rmsprop(w, gs, False), 1e-5, 1e-6),
    "rmsprop_centered": (lambda o: o.RMSPropOptimizer(
        LR, rho=0.95, epsilon=1e-6, momentum=0.9, centered=True),
        lambda w, gs: _rmsprop(w, gs, True), 1e-5, 1e-6),
    "ftrl": (lambda o: o.FtrlOptimizer(LR, l1=0.1, l2=0.05, lr_power=-0.5),
             _ftrl, 1e-5, 1e-6),
    "lamb": (lambda o: o.LambOptimizer(LR, lamb_weight_decay=0.01,
                                       beta1=0.9, beta2=0.999, epsilon=1e-6),
             _lamb, 1e-4, 1e-5),
    "momentum": (lambda o: o.MomentumOptimizer(LR, momentum=0.9),
                 _momentum, 1e-5, 1e-6),
    "nesterov": (lambda o: o.MomentumOptimizer(LR, momentum=0.9,
                                               use_nesterov=True),
                 lambda w, gs: _momentum(w, gs, nesterov=True), 1e-5, 1e-6),
    "lars_momentum": (lambda o: o.LarsMomentumOptimizer(
        LR, momentum=0.9, lars_coeff=0.001, lars_weight_decay=0.0005),
        _lars, 1e-5, 1e-6),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_formula_and_jax_twin(name):
    """Three steps on a known gradient: the port's w against the
    reference formula (test_optimizer_parity.py:45-165) and against the
    JAX Executor's."""
    make, formula, rtol, atol = OPTIMIZERS[name]
    rs = np.random.RandomState(5)
    grads = [rs.randn(D).astype(np.float32) for _ in range(3)]
    start, jax_w, port_w = _twin_steps(
        _linear, lambda pkg: make(pkg.optimizer),
        [{"x": g.reshape(1, D)} for g in grads], ["w"])
    want = formula(start["w"].astype(np.float64),
                   [g.astype(np.float64) for g in grads])
    np.testing.assert_allclose(port_w["w"], want, rtol=rtol, atol=atol)
    np.testing.assert_allclose(port_w["w"], jax_w["w"], rtol=TWIN_RTOL,
                               atol=TWIN_ATOL)


def test_optimizer_aliases_are_the_jax_names():
    """The short names paddle_tpu.optimizer exports for these classes."""
    for alias in ("SGD", "Momentum", "Adagrad", "Adam", "Adamax", "RMSProp",
                  "Ftrl", "Lamb", "DecayedAdagrad", "Adadelta",
                  "LarsMomentum"):
        jcls = getattr(jfluid.optimizer, alias)
        assert getattr(fluid.optimizer, alias).__name__ == jcls.__name__


XS = np.ones((2, 4), np.float32) * 1.5     # dL/dw rows: 3.0 each


def _fc_net(name, param_attr_kw=None):
    def net(pkg):
        lay = pkg.layers
        x = lay.data("x", shape=[4], dtype="float32")
        y = lay.fc(x, size=2, param_attr=pkg.ParamAttr(
            name=name, **(param_attr_kw(pkg) if param_attr_kw else {})),
            bias_attr=False)
        return lay.reduce_sum(y)
    return net


@pytest.mark.parametrize("steps,nesterov", [(2, False), (1, True)])
def test_momentum_and_nesterov_match_reference(steps, nesterov):
    """test_semantic_parity.py:43 (momentum_op.h:122, two steps) and :57
    (Nesterov, momentum_op.h:124, one step)."""
    start, jw, tw = _twin_steps(
        _fc_net("pw"), lambda pkg: pkg.optimizer.MomentumOptimizer(
            learning_rate=0.1, momentum=0.9, use_nesterov=nesterov),
        [{"x": XS}] * steps, ["pw"])
    g = np.full((4, 2), 3.0, np.float32)
    p, v = start["pw"], np.zeros_like(g)
    for _ in range(steps):
        v = 0.9 * v + g
        p = p - 0.1 * ((g + 0.9 * v) if nesterov else v)
    np.testing.assert_allclose(tw["pw"], p, rtol=1e-5)
    np.testing.assert_allclose(tw["pw"], jw["pw"], rtol=TWIN_RTOL,
                               atol=TWIN_ATOL)


@pytest.mark.parametrize("kind", ["l2", "l1"])
def test_param_regularizer_adds_decay_to_grad(kind):
    """test_semantic_parity.py:69 (L2: grad += coeff p) and :89 (L1:
    grad += coeff sign(p)), set through ParamAttr(regularizer=), with
    SGD; against the formula and the JAX Executor."""
    coeff = 0.5 if kind == "l2" else 0.2

    def reg(pkg):
        cls = pkg.regularizer.L2Decay if kind == "l2" \
            else pkg.regularizer.L1Decay
        return {"regularizer": cls(coeff)}

    start, jw, tw = _twin_steps(
        _fc_net("rw", reg), lambda pkg: pkg.optimizer.SGDOptimizer(0.1),
        [{"x": XS}], ["rw"])
    p = start["rw"]
    decay = coeff * (p if kind == "l2" else np.sign(p))
    np.testing.assert_allclose(
        tw["rw"], p - 0.1 * (np.full((4, 2), 3.0, np.float32) + decay),
        rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tw["rw"], jw["rw"], rtol=TWIN_RTOL,
                               atol=TWIN_ATOL)


def _two_fc(pkg):
    """Two fc layers, the first with its own learning-rate scale and an
    L1 regularizer, the second under the optimizer's L2Decay."""
    lay = pkg.layers
    x = lay.data("x", shape=[4], dtype="float32")
    h = lay.fc(x, size=3, param_attr=pkg.ParamAttr(
        name="a_w", learning_rate=0.5,
        regularizer=pkg.regularizer.L1Decay(0.1)), bias_attr=False)
    y = lay.fc(h, size=2, param_attr=pkg.ParamAttr(name="b_w"),
               bias_attr=pkg.ParamAttr(name="b_b", learning_rate=2.0))
    return lay.reduce_sum(lay.elementwise_mul(y, y))


def test_optimizer_regularization_and_per_param_lr_match_jax():
    """Adam(regularization=L2Decay(1e-2)) where a parameter's own
    L1Decay wins, and ParamAttr learning-rate scales 0.5 and 2.0 (a scale
    op of the global rate), three steps against the JAX Executor."""
    rs = np.random.RandomState(3)
    feeds = [{"x": rs.randn(5, 4).astype(np.float32)} for _ in range(3)]
    _start, jw, tw = _twin_steps(
        _two_fc, lambda pkg: pkg.optimizer.AdamOptimizer(
            0.05, regularization=pkg.regularizer.L2Decay(1e-2)),
        feeds, ["a_w", "b_w", "b_b"])
    for n in ("a_w", "b_w", "b_b"):
        np.testing.assert_allclose(tw[n], jw[n], rtol=TWIN_RTOL,
                                   atol=TWIN_ATOL, err_msg=n)


def test_lamb_exclude_from_weight_decay_fn():
    """A parameter that exclude_from_weight_decay_fn names updates with
    weight decay 0, as in JAX."""
    rs = np.random.RandomState(4)
    feeds = [{"x": rs.randn(5, 4).astype(np.float32)} for _ in range(2)]
    _s, jw, tw = _twin_steps(
        _two_fc, lambda pkg: pkg.optimizer.LambOptimizer(
            0.05, lamb_weight_decay=0.1,
            exclude_from_weight_decay_fn=lambda p: p.name.endswith("_b")),
        feeds, ["a_w", "b_w", "b_b"])
    for n in ("a_w", "b_w", "b_b"):
        np.testing.assert_allclose(tw[n], jw[n], rtol=1e-5, atol=1e-6,
                                   err_msg=n)


# ---------------------------------------------------------------------------
# learning-rate schedules
# ---------------------------------------------------------------------------

def _run_lr(pkg, un, make_lr, steps, scope, exe):
    main, startup = pkg.Program(), pkg.Program()
    with un.guard(), pkg.program_guard(main, startup):
        lr = make_lr(pkg.layers)
    out = []
    exe.run(startup, scope=scope)
    for _ in range(steps):
        v, = exe.run(main, fetch_list=[lr], scope=scope)
        out.append(float(np.asarray(v).reshape(-1)[0]))
    return out


# name -> (schedule, closed form of step s), test_lr_scheduler_parity.py
SCHEDULES = {
    "exponential": (lambda L: L.exponential_decay(0.5, 3, 0.7),
                    lambda s: 0.5 * 0.7 ** (s / 3.0)),
    "exponential_staircase": (
        lambda L: L.exponential_decay(0.5, 3, 0.7, staircase=True),
        lambda s: 0.5 * 0.7 ** (s // 3)),
    "natural_exp": (lambda L: L.natural_exp_decay(1.0, 2, 0.5),
                    lambda s: math.exp(-0.5 * (s / 2.0))),
    "inverse_time": (lambda L: L.inverse_time_decay(1.0, 2, 0.5),
                     lambda s: 1.0 / (1 + 0.5 * s / 2.0)),
    "polynomial": (lambda L: L.polynomial_decay(0.1, 4, 0.01, power=2.0),
                   lambda s: (0.1 - 0.01) * (1 - min(s, 4) / 4.0) ** 2
                   + 0.01),
    "polynomial_cycle": (
        lambda L: L.polynomial_decay(0.1, 4, 0.01, power=1.0, cycle=True),
        lambda s: (0.1 - 0.01) * (1 - s / (4.0 * max(math.ceil(s / 4.0),
                                                     1.0))) + 0.01),
    "piecewise": (lambda L: L.piecewise_decay([2, 4], [0.1, 0.01, 0.001]),
                  lambda s: 0.1 if s < 2 else (0.01 if s < 4 else 0.001)),
    "cosine": (lambda L: L.cosine_decay(0.1, 2, 4),
               lambda s: 0.1 * 0.5 * (math.cos((s // 2) * math.pi / 4)
                                      + 1)),
    "noam": (lambda L: L.noam_decay(64, 4),
             lambda s: 64 ** -0.5 * min((s + 1) ** -0.5,
                                        (s + 1) * 4 ** -1.5)),
    "linear_warmup": (lambda L: L.linear_lr_warmup(0.1, 4, 0.02, 0.1),
                      lambda s: 0.02 + 0.08 * s / 4.0 if s < 4 else 0.1),
    "warmup_then_polynomial": (
        lambda L: L.linear_lr_warmup(L.polynomial_decay(
            1e-4, decay_steps=1000, end_learning_rate=0.0), 4, 0.0, 1e-4),
        lambda s: 1e-4 * s / 4.0 if s < 4 else 1e-4 * (1 - s / 1000.0)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax_and_formula(name):
    """Each schedule's rate over 12 steps: the port's against the JAX
    Executor's and the reference formula (test_lr_scheduler_parity.py:
    33-96; noam's counter starts at 1)."""
    make, formula = SCHEDULES[name]
    steps = 12
    got = _run_lr(fluid, tun, make, steps, fluid.Scope(),
                  fluid.Executor(CPU))
    jgot = _run_lr(jfluid, jun, make, steps, JScope(), jfluid.Executor())
    np.testing.assert_allclose(got, jgot, rtol=LR_RTOL, atol=1e-12)
    np.testing.assert_allclose(got, [formula(s) for s in range(steps)],
                               rtol=1e-5, atol=1e-12)


def test_first_schedule_sets_the_shared_counter():
    """The counter is shared by a program's schedules, and `begin` is the
    first one built's (the reference's caveat): noam_decay (begin 1)
    after exponential_decay (begin 0) reads step 0 first, in both
    packages."""
    def make(L):
        L.exponential_decay(0.5, 3, 0.7)
        return L.noam_decay(64, 4)

    got = _run_lr(fluid, tun, make, 3, fluid.Scope(), fluid.Executor(CPU))
    jgot = _run_lr(jfluid, jun, make, 3, JScope(), jfluid.Executor())
    np.testing.assert_allclose(got, jgot, rtol=LR_RTOL)
    assert got[0] == 0.0        # step 0: min(0^-0.5, 0) = 0


# ---------------------------------------------------------------------------
# gradient clipping
# ---------------------------------------------------------------------------

def _clip_run(pkg, un, clip, xs):
    main, startup = pkg.Program(), pkg.Program()
    with un.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[4], dtype="float32")
        y = pkg.layers.fc(x, size=1, param_attr=pkg.ParamAttr(name="cw"),
                          bias_attr=False)
        loss = pkg.layers.reduce_sum(y)
        pkg.clip.set_gradient_clip(clip(pkg.clip))
        try:
            pkg.optimizer.SGDOptimizer(learning_rate=1.0).minimize(loss)
        finally:
            # process-global (reference semantics): leaking it would clip
            # every later program's grads
            pkg.clip.set_gradient_clip(None)
    return main, startup, loss


CLIPS = {
    # test_lr_scheduler_parity.py:109: scale = c / max(|g|, c)
    "global_norm": (lambda C: C.GradientClipByGlobalNorm(clip_norm=1.0),
                    lambda g: g / max(np.sqrt((g ** 2).sum()), 1.0)),
    "norm": (lambda C: C.GradientClipByNorm(clip_norm=2.0),
             lambda g: g * min(2.0 / np.sqrt((g ** 2).sum()), 1.0)),
    "value": (lambda C: C.GradientClipByValue(max=2.5, min=-1.0),
              lambda g: np.clip(g, -1.0, 2.5)),
}


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_gradient_clip_math(name):
    """SGD(1.0) after a clip moves w by exactly the clipped gradient
    (d sum(x w) / dw = the column sums of x): the port against the
    formula and the JAX Executor."""
    clip, formula = CLIPS[name]
    xs = np.array([[3.0, -2.0, 0.5, 4.0], [3.0, 1.0, 0.5, -1.0]],
                  np.float32)
    raw = xs.sum(0).reshape(4, 1)
    tmain, tstart, tloss = _clip_run(fluid, tun, clip, xs)
    jmain, jstart, jloss = _clip_run(jfluid, jun, clip, xs)
    jscope = JScope()
    with jguard(jscope):
        jexe = jfluid.Executor()
        jexe.run(jstart)
        w0 = np.asarray(jscope.get("cw")).copy()
        tscope = _carry(jscope)
        jexe.run(jmain, feed={"x": xs}, fetch_list=[jloss])
    with fluid.scope_guard(tscope):
        fluid.Executor(CPU).run(tmain, feed={"x": xs}, fetch_list=[tloss])
    moved = w0 - tscope.get("cw").numpy()
    np.testing.assert_allclose(moved, formula(raw), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tscope.get("cw").numpy(),
                               np.asarray(jscope.get("cw")), rtol=TWIN_RTOL,
                               atol=TWIN_ATOL)


def test_per_param_clip_attr_wins_over_the_global_clip():
    """set_gradient_clip(clip, param_list=[...]) clips those parameters
    by their own attr; the rest take the global clip (none here)."""
    main, startup = fluid.Program(), fluid.Program()
    with tun.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4], dtype="float32")
        h = fluid.layers.fc(x, size=1, param_attr=fluid.ParamAttr(name="p1"),
                            bias_attr=False)
        y = fluid.layers.fc(x, size=1, param_attr=fluid.ParamAttr(name="p2"),
                            bias_attr=False)
        loss = fluid.layers.reduce_sum(fluid.layers.elementwise_add(h, y))
        fluid.clip.set_gradient_clip(fluid.clip.GradientClipByValue(0.5),
                                     param_list=["p1"], program=main)
        fluid.clip.set_gradient_clip(None)
        fluid.optimizer.SGDOptimizer(1.0).minimize(loss)
    xs = np.full((2, 4), 3.0, np.float32)
    scope = fluid.Scope()
    exe = fluid.Executor(CPU)
    exe.run(startup, scope=scope)
    w1, w2 = scope.get("p1").clone(), scope.get("p2").clone()
    exe.run(main, feed={"x": xs}, fetch_list=[loss], scope=scope)
    # f32: w - (w - step) recovers the step to an ulp of w
    np.testing.assert_allclose((w1 - scope.get("p1")).numpy(), 0.5,
                               rtol=1e-6)
    np.testing.assert_allclose((w2 - scope.get("p2")).numpy(), 6.0,
                               rtol=1e-6)


def test_minimize_refuses_grad_clip():
    """minimize(grad_clip=) is refused with a pointer to
    set_gradient_clip: Fluid 1.5 applies it in dygraph mode only and the
    JAX package drops it, so a static program would train unclipped."""
    main, startup = fluid.Program(), fluid.Program()
    with tun.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4], dtype="float32")
        loss = fluid.layers.reduce_sum(fluid.layers.fc(x, size=1))
        with pytest.raises(ValueError, match="set_gradient_clip"):
            fluid.optimizer.SGDOptimizer(1.0).minimize(
                loss, grad_clip=fluid.clip.GradientClipByGlobalNorm(1.0))
