"""DGCMomentumOptimizer in the port against the JAX package, on the CPU.

Twins of the 3 tests of ``tests/api/test_dgc.py``: before
rampup_begin_step DGC is Momentum (losses rtol 1e-5, weights rtol 1e-5 +
atol 1e-7, the JAX test's; here also bitwise the port's own Momentum);
with 75 % of the entries dropped a step, training still converges; at
0.93 sparsity one step moves at most 2 of 8 weights and the residual V
holds exactly the masked-out velocity. Each runs in both packages from
the same weights, the port held to JAX at TWIN_RTOL / TWIN_ATOL (the
60-step run at LONG_RTOL / LONG_ATOL). Then the
threshold: ``_quantile_linear`` against ``numpy.quantile`` (its "linear"
method, as ``jnp.quantile``'s default) on a tensor above 2**24 elements,
where ``torch.quantile`` raises, and the ramp's levels against JAX's op.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu.core import unique_name as jun
from paddle_tpu.core.executor import Scope as JScope, scope_guard as jguard
from paddle_tpu.optimizer import dgc as jdgc

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import unique_name as tun
from paddle_tpu_torch.optimizer import dgc as tdgc

CPU = fluid.CPUPlace()
TWIN_RTOL, TWIN_ATOL = 1e-5, 1e-7
# 60 sparse steps: last-ulp differences of the two packages' arithmetic
# move entries across the threshold now and then, and the residual
# carries them on
LONG_RTOL, LONG_ATOL = 1e-3, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (the suite runs
    several pytest workers at once; see tests/test_torch_bert.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _net(pkg):
    x = pkg.layers.data("x", shape=[8], dtype="float32")
    y = pkg.layers.data("y", shape=[1], dtype="float32")
    pred = pkg.layers.fc(x, size=1, param_attr=pkg.ParamAttr(name="w"),
                         bias_attr=pkg.ParamAttr(name="b"))
    return pkg.layers.mean(pkg.layers.square_error_cost(pred, y))


def _data(seed=0, n=32):
    rs = np.random.RandomState(seed)
    xs = rs.rand(n, 8).astype(np.float32)
    return xs, xs.sum(1, keepdims=True).astype(np.float32)


def _run(pkg, un, make_opt, feed, steps, w0, watch=("w",)):
    """(losses, {var: value} after the steps, scope names) in `pkg`, from
    the weights w0 and a zero bias."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with un.guard(), pkg.program_guard(main, startup):
        loss = _net(pkg)
        make_opt(pkg).minimize(loss)
    if pkg is jfluid:
        scope, exe = JScope(), jfluid.Executor()
        guard = jguard(scope)
        read = lambda n: np.asarray(scope.get(n)).copy()  # noqa: E731
        put = lambda n, v: scope.set(n, jnp.asarray(v))  # noqa: E731
    else:
        scope, exe = fluid.Scope(), fluid.Executor(CPU)
        guard = fluid.scope_guard(scope)
        read = lambda n: scope.get(n).to("cpu", copy=True).numpy()  # noqa
        put = lambda n, v: scope.set(n, torch.from_numpy(v.copy()))  # noqa
    with guard:
        exe.run(startup)
        put("w", w0)
        put("b", np.zeros((1,), np.float32))
        losses = [float(np.asarray(exe.run(main, feed=feed,
                                           fetch_list=[loss])[0]))
                  for _ in range(steps)]
        names = list(scope.names())
        return losses, {n: read(n) for n in names
                        if n in watch or "dgc_v" in n or "dgc_u" in n}, names


def _twin(make_opt, feed, steps, w0, rtol=TWIN_RTOL, atol=TWIN_ATOL):
    (jl, jv, _), (tl, tv, names) = (
        _run(jfluid, jun, make_opt, feed, steps, w0),
        _run(fluid, tun, make_opt, feed, steps, w0))
    np.testing.assert_allclose(tl, jl, rtol=rtol)
    assert set(tv) == set(jv)
    for n in jv:
        np.testing.assert_allclose(tv[n], jv[n], rtol=rtol, atol=atol,
                                   err_msg=n)
    return tl, tv, names


def test_dgc_dense_phase_matches_momentum():
    xs, ys = _data()
    feed = {"x": xs, "y": ys}
    w0 = np.zeros((8, 1), np.float32)
    l_dgc, v_dgc, _ = _twin(
        lambda pkg: pkg.optimizer.DGCMomentumOptimizer(
            learning_rate=0.05, momentum=0.9, rampup_begin_step=100),
        feed, 4, w0)
    l_mom, v_mom, _ = _run(
        fluid, tun, lambda pkg: pkg.optimizer.MomentumOptimizer(
            learning_rate=0.05, momentum=0.9), feed, 4, w0)
    np.testing.assert_allclose(l_dgc, l_mom, rtol=1e-5)
    np.testing.assert_allclose(v_dgc["w"], v_mom["w"], rtol=1e-5,
                               atol=1e-7)
    assert l_dgc == l_mom
    np.testing.assert_array_equal(v_dgc["w"], v_mom["w"])


def test_dgc_sparse_phase_converges():
    xs, ys = _data(1)
    losses, _v, _n = _twin(
        lambda pkg: pkg.optimizer.DGCMomentumOptimizer(
            learning_rate=0.05, momentum=0.9, rampup_begin_step=0,
            sparsity=(0.75,)),
        {"x": xs, "y": ys}, 60,
        np.random.RandomState(11).randn(8, 1).astype(np.float32),
        rtol=LONG_RTOL, atol=LONG_ATOL)
    assert losses[-1] < losses[0] * 0.05, losses[::15]


def test_dgc_residual_carries_dropped_mass():
    xs, ys = _data(2)
    w0 = np.zeros((8, 1), np.float32)
    _l, vals, _n = _twin(
        lambda pkg: pkg.optimizer.DGCMomentumOptimizer(
            learning_rate=0.1, momentum=0.0, rampup_begin_step=0,
            sparsity=(0.93,)),
        {"x": xs, "y": ys}, 1, w0)
    moved = np.abs(vals["w"] - w0) > 1e-12
    assert moved.sum() <= 2, f"{moved.sum()} entries moved at 0.93"
    resid = [v for n, v in vals.items() if "dgc_v" in n and n.startswith("w")]
    vel = [v for n, v in vals.items() if "dgc_u" in n and n.startswith("w")]
    assert resid and np.abs(resid[0]).sum() > 0
    # the residual is the velocity of the entries that did not move,
    # exactly, and 0 where they moved (mu 0: u = g, v = u + 0)
    np.testing.assert_array_equal(resid[0][moved], 0.0)
    np.testing.assert_array_equal(vel[0][moved], 0.0)
    np.testing.assert_array_equal(resid[0][~moved], vel[0][~moved])


def test_threshold_above_two_to_the_24_matches_numpy():
    """23.4 M entries (BERT-base's word embedding, 30522 x 768): the
    threshold at the 0.999 quantile, as the op takes it, equals
    numpy.quantile's "linear" one to float32 rounding, and the mask keeps
    the entries above it; torch.quantile refuses this size."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(30522 * 768, generator=gen).abs()
    with pytest.raises(RuntimeError):
        torch.quantile(x, 0.5)
    for q in (0.999, 0.75, 0.0):
        got = tdgc._quantile_linear(x, torch.tensor(q)).item()
        want = np.quantile(x.numpy().astype(np.float64), q)
        assert got == pytest.approx(want, rel=1e-6, abs=0.0), q
        keep = int((x > got).sum())
        assert abs(keep - (1 - q) * x.numel()) <= 2, (q, keep)


def test_small_threshold_matches_jnp_quantile():
    rs = np.random.RandomState(7)
    x = np.abs(rs.randn(1000)).astype(np.float32)
    for q in (0.999, 0.93, 0.5, 1.0 - 1e-6):
        want = float(jnp.quantile(jnp.asarray(x), jnp.float32(q)))
        got = tdgc._quantile_linear(torch.from_numpy(x),
                                    torch.tensor(q, dtype=torch.float32))
        assert float(got) == pytest.approx(want, rel=1e-6), q


@pytest.mark.parametrize("begin,ramp,levels", [
    (2.0, 1, [0.999]), (0.0, 8, [0.75, 0.9375, 0.984375, 0.996, 0.999]),
    (3.0, 3, [0.5, 0.9])])
def test_sparsity_ramp_matches_jax(begin, ramp, levels):
    class Ctx:
        def __init__(self, step, tensor):
            self.step, self.tensor = step, tensor

        def in_(self, slot):
            return self.tensor(self.step)

        def attr(self, name, default=None):
            return {"rampup_begin": begin, "rampup_step": ramp,
                    "sparsity": levels}.get(name, default)

    for step in range(12):
        s = np.float32(step)
        want = float(jdgc.dgc_sparsity_ramp(Ctx(s, jnp.asarray))["Out"])
        got = float(tdgc.dgc_sparsity_ramp(
            Ctx(s, lambda v: torch.tensor(v)))["Out"])
        assert got == want, (step, got, want)
