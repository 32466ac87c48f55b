"""The port's newer optimizer ops and knobs against the JAX package, on
the CPU.

Op twins of ``tests/ops/test_audit_gap_ops.py::test_proximal_rules``,
``tests/ops/test_uncovered_ops_r4b.py::test_adamw_matches_torch_step``,
``tests/ops/test_uncovered_ops_r4.py::test_dpsgd_clips_and_steps`` and
``tests/api/test_contrib_shims.py::
test_extend_with_decoupled_weight_decay_matches_manual``, each op run on
the same numpy inputs in both registries (the JAX test's formula and
tolerance, the port against JAX's op at OP_RTOL); then ``elementwise_mod``
and ``assign`` (a copy), and ``Optimizer.set_lr`` / ``current_step_lr``.

dpsgd's noise is torch's, not JAX's: no stream of torch's matches
``jax.random.normal``'s. With sigma 0 the op equals JAX's exactly; with
sigma > 0 it is deterministic per seed and its noise has mean 0 and
spread sigma (ROADMAP C, deliberate differences).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu import ops as jops
from paddle_tpu.core import unique_name as jun
from paddle_tpu.core.executor import Scope as JScope, scope_guard as jguard

import paddle_tpu_torch as fluid
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.core import unique_name as tun

OP_RTOL, OP_ATOL = 1e-6, 1e-7
CPU = fluid.CPUPlace()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (the suite runs
    several pytest workers at once; see tests/test_torch_bert.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Ctx:
    """An op's inputs, attrs and generator, for either registry: JAX
    arrays or torch tensors (fresh copies: the port's ops update theirs in
    place)."""

    def __init__(self, port, ins, attrs=None, seed=0):
        self.port, self.attrs, self.seed = port, dict(attrs or {}), seed
        self.ins = {k: torch.tensor(np.array(v)) if port
                    else jnp.asarray(v) for k, v in ins.items()}
        self.is_test = False

    def in_(self, slot, default=None):
        return self.ins.get(slot, default)

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def has_in(self, slot):
        return slot in self.ins

    def rng(self):
        if self.port:
            return torch.Generator().manual_seed(self.seed)
        return jax.random.PRNGKey(self.seed)


def _op(name, ins, attrs=None, seed=0):
    """(JAX's outputs, the port's) of op `name` as numpy."""
    j = jops._REGISTRY[name](_Ctx(False, ins, attrs, seed))
    t = tops._REGISTRY[name](_Ctx(True, ins, attrs, seed))
    return ({k: np.asarray(v) for k, v in j.items()},
            {k: v.numpy().copy() for k, v in t.items()})


def _twin(name, ins, attrs=None, seed=0):
    j, t = _op(name, ins, attrs, seed)
    assert set(t) == set(j)
    for k in j:
        np.testing.assert_allclose(t[k], j[k], rtol=OP_RTOL, atol=OP_ATOL,
                                   err_msg=f"{name}: {k}")
    return t


def test_proximal_rules():
    rs = np.random.RandomState(0)
    p = rs.randn(5).astype(np.float32)
    g = rs.randn(5).astype(np.float32)
    lr, l1, l2 = 0.1, 0.05, 0.02
    ins = {"Param": p, "Grad": g, "Moment": np.zeros(5, np.float32),
           "LearningRate": np.float32(lr)}
    out = _twin("proximal_gd", ins, {"l1": l1, "l2": l2})
    z = p - lr * g
    want = np.sign(z) * np.maximum(np.abs(z) - lr * l1, 0) / (1 + lr * l2)
    np.testing.assert_allclose(out["ParamOut"], want, rtol=1e-5)
    out = _twin("proximal_adagrad", ins, {"l1": l1, "l2": l2})
    m = g * g
    eff = lr / np.sqrt(m + 1e-10)
    z = p - eff * g
    want = np.sign(z) * np.maximum(np.abs(z) - eff * l1, 0) / (1 + eff * l2)
    np.testing.assert_allclose(out["ParamOut"], want, rtol=1e-4)
    np.testing.assert_allclose(out["MomentOut"], m, rtol=1e-6)


def test_adamw_matches_torch_step():
    rng = np.random.RandomState(0)
    p0 = rng.randn(4, 3).astype(np.float32)
    g = rng.randn(4, 3).astype(np.float32)
    lr, wd, b1, b2, eps = 0.01, 0.1, 0.9, 0.999, 1e-12
    got = _twin(
        "adamw",
        {"Param": p0, "Grad": g, "Moment1": np.zeros_like(p0),
         "Moment2": np.zeros_like(p0), "Beta1Pow": np.float32(b1),
         "Beta2Pow": np.float32(b2), "LearningRate": np.float32(lr)},
        dict(beta1=b1, beta2=b2, epsilon=eps, weight_decay=wd))
    tp = torch.nn.Parameter(torch.tensor(p0))
    opt = torch.optim.AdamW([tp], lr=lr, betas=(b1, b2), eps=eps,
                            weight_decay=wd)
    tp.grad = torch.tensor(g)
    opt.step()
    np.testing.assert_allclose(got["ParamOut"], tp.detach().numpy(),
                               rtol=2e-4, atol=2e-6)


def test_dpsgd_clips_and_steps():
    """Clip to `clip` by the norm, noise of `sigma`, an SGD step: with
    sigma 0 and |g| 50 the update is lr clip along g, as JAX's. With sigma
    > 0 the port's noise is its own: the same seed gives the same step,
    another seed another, and over 200k entries the noise has mean 0 and
    standard deviation sigma (5 standard errors)."""
    p = np.zeros(4, np.float32)
    g = np.array([30.0, 40.0, 0.0, 0.0], np.float32)
    ins = {"Param": p, "Grad": g,
           "LearningRate": np.asarray([0.1], np.float32)}
    got = _twin("dpsgd", ins, {"clip": 10.0, "sigma": 0.0}, seed=1)
    np.testing.assert_allclose(got["ParamOut"], [-0.6, -0.8, 0.0, 0.0],
                               rtol=1e-5)
    j, t1 = _op("dpsgd", ins, {"clip": 10.0, "sigma": 1.0}, seed=1)
    _j, t2 = _op("dpsgd", ins, {"clip": 10.0, "sigma": 1.0}, seed=1)
    _j, t3 = _op("dpsgd", ins, {"clip": 10.0, "sigma": 1.0}, seed=2)
    assert not np.allclose(t1["ParamOut"], got["ParamOut"])
    assert not np.allclose(j["ParamOut"], got["ParamOut"])
    np.testing.assert_array_equal(t1["ParamOut"], t2["ParamOut"])
    assert not np.array_equal(t1["ParamOut"], t3["ParamOut"])
    n, sigma, lr = 200_000, 0.5, 0.1
    zero = {"Param": np.zeros(n, np.float32), "Grad": np.zeros(n, np.float32),
            "LearningRate": np.asarray([lr], np.float32)}
    _j, t = _op("dpsgd", zero, {"clip": 10.0, "sigma": sigma}, seed=3)
    noise = -t["ParamOut"].astype(np.float64) / lr
    assert abs(noise.mean()) < 5 * sigma / np.sqrt(n)
    assert abs(noise.std() - sigma) < 5 * sigma / np.sqrt(2 * n)


def test_decoupled_weight_decay_op():
    rs = np.random.RandomState(2)
    p, pre = rs.randn(6).astype(np.float32), rs.randn(6).astype(np.float32)
    out = _twin("decoupled_weight_decay", {"Param": p, "PrevParam": pre},
                {"coeff": 0.01})
    np.testing.assert_allclose(out["ParamOut"], p - 0.01 * pre, rtol=1e-6)


def test_elementwise_mod_and_assign():
    x = np.array([-7.0, -1.0, 0.0, 3.0, 7.5], np.float32)
    y = np.float32(3.0)
    out = _twin("elementwise_mod", {"X": x, "Y": y})
    np.testing.assert_array_equal(out["Out"], np.mod(x, y))
    ctx = _Ctx(True, {"X": x})
    got = tops._REGISTRY["assign"](ctx)["Out"]
    assert torch.equal(got, ctx.ins["X"])
    assert got.data_ptr() != ctx.ins["X"].data_ptr()


def _decay_build(pkg, un, use_decay, coeff=0.1, lr=0.5):
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = main.random_seed = 3
    with un.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[4], dtype="float32")
        y = pkg.layers.fc(x, size=1, bias_attr=False,
                          param_attr=pkg.ParamAttr(name="w"))
        loss = pkg.layers.mean(y)
        if use_decay:
            cls = pkg.contrib.extend_with_decoupled_weight_decay(
                pkg.optimizer.SGDOptimizer)
            cls(coeff, learning_rate=lr).minimize(loss)
        else:
            pkg.optimizer.SGDOptimizer(learning_rate=lr).minimize(loss)
    return main, startup, loss


def test_extend_with_decoupled_weight_decay_matches_manual():
    coeff = 0.1
    feed = {"x": np.ones((2, 4), np.float32)}
    jmain, jstart, jloss = _decay_build(jfluid, jun, True)
    jscope = JScope()
    with jguard(jscope):
        jfluid.Executor().run(jstart)
        w0 = np.asarray(jscope.get("w")).copy()
        jfluid.Executor().run(jmain, feed=feed, fetch_list=[jloss])
        jw = np.asarray(jscope.get("w")).copy()
    got = {}
    for use_decay in (False, True):
        main, startup, loss = _decay_build(fluid, tun, use_decay)
        types = [op.type for op in main.global_block().ops]
        if use_decay:
            # the snapshot before the SGD op, the decay after it
            assert types.index("assign") < types.index("sgd") < \
                types.index("decoupled_weight_decay")
        scope = fluid.Scope()
        exe = fluid.Executor(CPU)
        exe.run(startup, scope=scope)
        fluid.scope_from_numpy({"w": w0}, "cpu", scope)
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        got[use_decay] = scope.get("w").numpy().copy()
    np.testing.assert_allclose(got[True], got[False] - coeff * w0,
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got[True], jw, rtol=OP_RTOL, atol=OP_ATOL)
    with pytest.raises(TypeError):
        fluid.contrib.extend_with_decoupled_weight_decay(object)


def test_set_lr_changes_the_next_step_only():
    """set_lr between steps: the LR var is filled in place (the same
    tensor object, on its device), the next SGD step moves w by the new
    rate, the step before by the old, as in the JAX package;
    current_step_lr is the LR var."""
    feed = {"x": np.full((2, 3), 2.0, np.float32)}
    res = {}
    for name, pkg, un in (("jax", jfluid, jun), ("port", fluid, tun)):
        main, startup = pkg.Program(), pkg.Program()
        with un.guard(), pkg.program_guard(main, startup):
            x = pkg.layers.data("x", shape=[3], dtype="float32")
            w = pkg.layers.create_parameter(
                [3], "float32", name="w",
                default_initializer=pkg.initializer.ConstantInitializer(
                    1.0))
            loss = pkg.layers.mean(pkg.layers.elementwise_mul(x, w))
            opt = pkg.optimizer.SGDOptimizer(0.1)
            opt.minimize(loss)
        assert opt.current_step_lr() is opt._lr_var
        scope = JScope() if name == "jax" else fluid.Scope()
        guard = jguard(scope) if name == "jax" else fluid.scope_guard(scope)
        exe = jfluid.Executor() if name == "jax" else fluid.Executor(CPU)
        ws = []
        with guard:
            exe.run(startup)
            lr_before = scope.get(opt._lr_var.name)
            for i in range(3):
                if i == 2:
                    opt.set_lr(0.5)
                exe.run(main, feed=feed, fetch_list=[loss])
                ws.append(np.array(np.asarray(scope.get("w"))))
            if name == "port":
                assert scope.get(opt._lr_var.name) is lr_before
                assert float(lr_before) == 0.5
        res[name] = ws
    steps = np.diff(np.stack([np.ones(3)] + res["port"]), axis=0)
    # dL/dw = mean over the feed's columns: 2 / 3 a weight
    np.testing.assert_allclose(steps[:2], -0.1 * 2.0 / 3.0, rtol=1e-6)
    np.testing.assert_allclose(steps[2], -0.5 * 2.0 / 3.0, rtol=1e-6)
    np.testing.assert_allclose(res["port"], res["jax"], rtol=1e-6)


SLICE_MODULES = ("paddle_tpu_torch", "paddle_tpu_torch.optimizer.wrappers",
                 "paddle_tpu_torch.optimizer.dgc",
                 "paddle_tpu_torch.optimizer.recompute",
                 "paddle_tpu_torch.contrib",
                 "paddle_tpu_torch.contrib.extend_optimizer",
                 "paddle_tpu_torch.parallel.data_parallel", "chip_smoke")


def test_slice_modules_import_neither_jax_nor_paddle_tpu():
    """A fresh interpreter imports this slice's modules and chip_smoke.py
    (which builds nothing at import): no jax module and no module of the
    JAX package is loaded afterwards."""
    import os
    import subprocess
    import sys
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'jaxlib' or m == 'paddle_tpu' "
            "or m.startswith('paddle_tpu.'))\n"
            "print(bad)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
