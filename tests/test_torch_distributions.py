"""``layers.distributions`` and the initializers of the port against the
JAX package, on the CPU: Uniform, Normal, Categorical and
MultivariateNormalDiag built into a Program in each package
(``tests/api/test_distributions_parity.py`` and the distributions half
of ``test_distributions_nets.py``), their entropy, log_prob and
kl_divergence within 1e-6 relative of JAX's (the reference docstring's
MVN values too); MSRA, TruncatedNormal, Bilinear and NumpyArray
initializers through a startup Program, with ``force_init_on_cpu`` and
``init_on_cpu``.

Samples and the random initializers draw from the op's
``OpContext.rng()`` torch generator (ROADMAP C17), so no value equals
``jax.random``'s: they are held to what a seed fixes (the same numbers
from the same program seed, others from another), their bounds and
their moments, as ``test_torch_random_ops.py`` holds the random ops.
"""

import math

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import layers as jlayers
from paddle_tpu.core import unique_name as jun
from paddle_tpu.core.executor import Scope as JScope, scope_guard as jguard

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.core import unique_name as tun

from test_torch_tensor_ops import close

CPU = fluid.CPUPlace()
# the moments of N draws: a mean within 5 standard errors, a standard
# deviation within 1 % (the uniform's (b - a) / sqrt(12), the truncated
# normal's on [-2, 2] sigma)
N = 200_000
MEAN_SE = 5.0
STD_RTOL = 1e-2
TRUNC_STD = math.sqrt(1 - 4 * math.exp(-2) / math.sqrt(2 * math.pi)
                      / math.erf(2 / math.sqrt(2)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_bert.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _both(build):
    """build(layers) -> fetch vars, in a fresh Program of each package,
    run once: (JAX's fetches, the port's)."""
    res = []
    for pkg, lay, un, guard, scope in (
            (jfluid, jlayers, jun, jguard, JScope()),
            (fluid, tlayers, tun, fluid.scope_guard, fluid.Scope())):
        main, startup = pkg.Program(), pkg.Program()
        with un.guard(), pkg.program_guard(main, startup):
            outs = build(lay)
        exe = pkg.Executor(CPU) if pkg is fluid else pkg.Executor()
        with guard(scope):
            exe.run(startup)
            res.append([np.asarray(v) for v in exe.run(main,
                                                       fetch_list=outs)])
    return res


def _port(build, seed=5, runs=1):
    """build(layers) -> fetch vars in the port alone; each of `runs`
    runs' fetches."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with tun.guard(), fluid.program_guard(main, startup):
        outs = build(tlayers)
    scope, exe = fluid.Scope(), fluid.Executor(CPU)
    exe.run(startup, scope=scope)
    return [exe.run(main, fetch_list=outs, scope=scope) for _ in range(runs)]


def _twin(build):
    j, t = _both(build)
    for k, (a, b) in enumerate(zip(t, j)):
        close(a, b, name=str(k))
    return t


def test_normal_entropy_log_prob_kl():
    loc = np.array([0.3, -1.2], np.float32)
    scale = np.array([0.7, 2.1], np.float32)
    value = np.array([0.9, 0.1], np.float32)

    def build(L):
        n = L.Normal(loc, scale)
        other = L.Normal(np.float32(-0.4), np.float32(1.3))
        return [n.entropy(), n.log_prob(L.assign(value)),
                n.kl_divergence(other), L.Normal(0.5, 2.0).entropy()]

    _twin(build)


def test_uniform_entropy_log_prob_and_outside_support():
    low = np.array([0.0, -2.0], np.float32)
    high = np.array([1.5, 3.0], np.float32)

    def build(L):
        u = L.Uniform(low, high)
        return [u.entropy(), u.log_prob(L.assign(np.array([0.7, 2.9],
                                                          np.float32))),
                L.Uniform(0.0, 1.0).log_prob(L.assign(
                    np.array([1.5, -0.1, 0.5], np.float32)))]

    out = _twin(build)
    assert np.isneginf(out[2][:2]).all() and np.isfinite(out[2][2])


def test_categorical_entropy_kl_log_prob():
    logits = np.array([[0.2, 1.3, -0.5], [2.0, 0.0, 0.1]], np.float32)
    other = np.array([[1.0, 0.0, 0.0], [0.3, 0.3, 0.4]], np.float32)

    def build(L):
        c = L.Categorical(logits)
        return [c.entropy(), c.kl_divergence(L.Categorical(other)),
                c.log_prob(L.assign(np.array([[2], [0]], np.int64)))]

    _twin(build)


def test_mvn_diag_matches_jax_and_the_reference_docstring():
    """distributions.py:531-537 pins entropy(a) 2.033158, entropy(b)
    1.7777451, kl(a, b) 0.06542051 (`scale` is the diagonal
    covariance)."""
    def build(L):
        a = L.MultivariateNormalDiag(
            np.array([0.3, 0.5], np.float32),
            np.array([[0.4, 0], [0, 0.5]], np.float32))
        b = L.MultivariateNormalDiag(
            np.array([0.2, 0.4], np.float32),
            np.array([[0.3, 0], [0, 0.4]], np.float32))
        return [a.entropy(), b.entropy(), a.kl_divergence(b)]

    ea, eb, kl = _twin(build)
    np.testing.assert_allclose(float(np.ravel(ea)[0]), 2.033158, rtol=1e-6)
    np.testing.assert_allclose(float(np.ravel(eb)[0]), 1.7777451, rtol=1e-6)
    np.testing.assert_allclose(float(np.ravel(kl)[0]), 0.06542051,
                               rtol=1e-5)


def test_samples_shapes_seeds_bounds_and_moments():
    """Normal(1, 2) and Uniform(-1, 3) from number parameters sample
    `shape` alone, from arrays `shape` + the batch shape (JAX's shapes);
    the same draws from one program seed and step, others from another;
    the uniform in [-1, 3); both means within MEAN_SE standard errors,
    their spreads within STD_RTOL."""
    def build(L):
        return [L.Normal(1.0, 2.0).sample([N]),
                L.Uniform(-1.0, 3.0).sample([N]),
                L.Normal(np.array([0.0, 5.0], np.float32),
                         np.array([1.0, 0.1], np.float32)).sample([7, 3])]

    j, _ = _both(build)
    a, b = _port(build, seed=5), _port(build, seed=5)
    c = _port(build, seed=6)
    for k in range(3):
        assert a[0][k].shape == j[k].shape
        np.testing.assert_array_equal(a[0][k], b[0][k])
        assert not np.array_equal(a[0][k], c[0][k])
    ns, us, _ = a[0]
    assert abs(ns.mean() - 1.0) < MEAN_SE * 2.0 / math.sqrt(N)
    assert abs(ns.std() / 2.0 - 1) < STD_RTOL
    assert us.min() >= -1.0 and us.max() < 3.0
    assert abs(us.mean() - 1.0) < MEAN_SE * (4 / math.sqrt(12)) / \
        math.sqrt(N)
    assert abs(us.std() / (4 / math.sqrt(12)) - 1) < STD_RTOL


def test_categorical_sample_frequencies():
    """Gumbel-max draws (int64 class indices of JAX's shape) at the
    softmax's frequencies, within 5 standard errors."""
    logits = np.log(np.array([[0.1, 0.6, 0.3]], np.float32))

    def build(L):
        return [L.Categorical(logits).sample([N])]

    j, _ = _both(build)
    s, = _port(build)[0]
    assert s.shape == j[0].shape and s.dtype == np.int64
    freq = np.bincount(s.reshape(-1), minlength=3) / s.size
    p = np.array([0.1, 0.6, 0.3])
    assert (np.abs(freq - p) < 5 * np.sqrt(p * (1 - p) / s.size)).all()


def _init_program(init, shape, dtype="float32"):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with tun.guard(), fluid.program_guard(main, startup):
        w = tlayers.create_parameter(shape, dtype, name="w",
                                     default_initializer=init)
    scope = fluid.Scope()
    fluid.Executor(CPU).run(startup, scope=scope)
    return scope.get(w.name).numpy()


@pytest.mark.parametrize("uniform", [True, False])
def test_msra(uniform):
    """He initialization at a ResNet-50 conv's fan-in (512 x 3 x 3): U(+-
    sqrt(6 / fan_in)) or N(0, sqrt(2 / fan_in)), its spread within
    STD_RTOL."""
    from paddle_tpu_torch import initializer as I
    w = _init_program(I.MSRA(uniform=uniform), [64, 512, 3, 3])
    fan_in = 512 * 9
    std = math.sqrt(2.0 / fan_in)
    if uniform:
        assert np.abs(w).max() <= math.sqrt(6.0 / fan_in)
    assert abs(w.std() / std - 1) < STD_RTOL
    assert abs(w.mean()) < MEAN_SE * std / math.sqrt(w.size)
    assert I.MSRAInitializer is I.MSRA


def test_truncated_normal():
    from paddle_tpu_torch import initializer as I
    w = _init_program(I.TruncatedNormal(0.5, 2.0), [N])
    assert np.abs(w - 0.5).max() <= 4.0 + 1e-5
    assert abs(w.std() / (2.0 * TRUNC_STD) - 1) < STD_RTOL
    assert I.TruncatedNormalInitializer is I.TruncatedNormal


def test_bilinear_and_numpy_array_equal_jax():
    """Bilinear's kernel and a NumpyArray initializer's value equal the
    JAX package's, through each package's startup Program."""
    val = np.arange(12, dtype=np.float32).reshape(3, 4) / 7

    def build(L):
        from paddle_tpu import initializer as JI
        from paddle_tpu_torch import initializer as TI
        I = TI if L is tlayers else JI
        return [L.create_parameter([4, 2, 5, 5], "float32", name="bl",
                                   default_initializer=I.Bilinear()),
                L.create_parameter([3, 4], "float32", name="np",
                                   default_initializer=I.
                                   NumpyArrayInitializer(val))]

    out = _twin(build)
    np.testing.assert_array_equal(out[1], val)
    with pytest.raises(ValueError, match="4-D"):
        from paddle_tpu_torch import initializer as I
        _init_program(I.Bilinear(), [3, 3])


def test_init_on_cpu():
    from paddle_tpu_torch import initializer as I
    assert I.force_init_on_cpu() is False
    with I.init_on_cpu():
        w = _init_program(I.Constant(2.0), [2])
    np.testing.assert_array_equal(w, [2.0, 2.0])
