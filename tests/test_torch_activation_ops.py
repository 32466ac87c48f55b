"""The port's activation family against the JAX package, on the CPU:
the 31 activations of ``ops/activation_ops.py`` this slice adds (one
parametrized case each, forward and the gradient of a seeded
cotangent), ``round``'s half-to-even ties, ``prelu``'s three modes and
``maxout``'s channel groups, ``layers/layer_function_generator.py`` and
the ``layers/ops.py`` wrappers (the attribute unaries, the random
layers' op lists, ``cumsum``), each run through both packages' Programs.
Twins of ``tests/ops/test_op_numerics.py``'s activation cases and of
``tests/api/test_semantic_parity2.py``'s attribute audit.

Tolerances are stated beside each constant, with what this file's runs
measured.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import layers as jlayers
from paddle_tpu.core import unique_name as jun

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.core import unique_name as tun
from paddle_tpu_torch.ops import _REGISTRY as TREG, _DP_RULES

from test_torch_seq2seq import op_twin, run_layers
from test_torch_sequence_ops import twin

# f32 forward: within 1e-5 relative plus 1e-6 absolute (XLA's and
# torch's transcendental functions differ in the last bits: measured at
# most 2.4e-7 relative, softplus / mish / selu / erf); the gradients of
# one seeded cotangent within 1e-5 of the gradient's largest entry
# (measured at most 4.8e-7)
RTOL, ATOL = 1e-5, 1e-6
GRAD_TOL = 1e-5

RS = np.random.RandomState(23)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_bert.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x(shape=(4, 6, 3, 3), lo=-3.0, hi=3.0, avoid=()):
    """Seeded uniform inputs kept 0.05 away from the points in `avoid`
    (a kink or a threshold, where the two packages' subgradients may
    differ)."""
    x = RS.uniform(lo, hi, shape).astype(np.float32)
    for a in avoid:
        near = np.abs(x - a) < 0.05
        x[near] = a + 0.1
    return x


# op -> (inputs, attrs); the inputs stay off each op's kinks
CASES = {
    "abs": ({"X": _x(avoid=(0,))}, {}),
    "acos": ({"X": _x(lo=-0.95, hi=0.95)}, {}),
    "asin": ({"X": _x(lo=-0.95, hi=0.95)}, {}),
    "atan": ({"X": _x()}, {}),
    "brelu": ({"X": _x(lo=-5, hi=30, avoid=(1.0, 20.0))},
              {"t_min": 1.0, "t_max": 20.0}),
    "elu": ({"X": _x(avoid=(0,))}, {"alpha": 0.7}),
    "erf": ({"X": _x()}, {}),
    "hard_shrink": ({"X": _x(avoid=(-0.4, 0.4))}, {"threshold": 0.4}),
    "hard_sigmoid": ({"X": _x(lo=-5, hi=5, avoid=(-2.5, 2.5))}, {}),
    "hard_swish": ({"X": _x(lo=-5, hi=5, avoid=(-3.0, 3.0))}, {}),
    "leaky_relu": ({"X": _x(avoid=(0,))}, {"alpha": 0.1}),
    "log_softmax": ({"X": _x()}, {"axis": 1}),
    "logsigmoid": ({"X": _x()}, {}),
    "maxout": ({"X": _x((2, 6, 3, 3))}, {"groups": 3}),
    "mish": ({"X": _x()}, {}),
    "pow": ({"X": _x(lo=0.2, hi=3)}, {"factor": 2.5}),
    "prelu": ({"X": _x(avoid=(0,)),
               "Alpha": RS.uniform(0, 0.5, (6,)).astype(np.float32)},
              {"mode": "channel"}),
    "reciprocal": ({"X": _x(lo=0.3, hi=3)}, {}),
    "relu6": ({"X": _x(lo=-3, hi=9, avoid=(0, 6))}, {}),
    "round": ({"X": _x()}, {}),
    "rsqrt": ({"X": _x(lo=0.2, hi=3)}, {}),
    "selu": ({"X": _x(avoid=(0,))}, {}),
    "sin": ({"X": _x()}, {}),
    "soft_relu": ({"X": _x(lo=-50, hi=50, avoid=(-40, 40))}, {}),
    "softplus": ({"X": _x()}, {}),
    "softshrink": ({"X": _x(avoid=(-0.5, 0.5))}, {"lambda": 0.5}),
    "softsign": ({"X": _x()}, {}),
    "stanh": ({"X": _x()}, {"scale_a": 0.5, "scale_b": 1.5}),
    "swish": ({"X": _x()}, {"beta": 1.3}),
    "tanh_shrink": ({"X": _x()}, {}),
    "thresholded_relu": ({"X": _x(avoid=(0.8,))}, {"threshold": 0.8}),
}


def test_the_slice_registers_every_activation_with_a_dp_rule():
    """The 31 names (every activation of the JAX module) are registered,
    each with its data-parallel rule."""
    assert len(CASES) == 31
    for name in CASES:
        assert name in TREG and _DP_RULES[name] is not None, name


@pytest.mark.parametrize("op", sorted(CASES))
def test_activation_twin(op):
    """Forward and the gradient of a seeded cotangent with respect to
    every float input against the JAX op (``round``'s gradient is 0 in
    both)."""
    ins, attrs = CASES[op]
    jout, tout, grads = op_twin(op, ins, attrs, "Out", grad=tuple(ins))
    assert tout.shape == jout.shape and tout.dtype == jout.dtype
    np.testing.assert_allclose(tout, jout, rtol=RTOL, atol=ATOL)
    for k, (jg, tg) in grads.items():
        scale = max(float(np.abs(jg).max()), 1e-12)
        assert float(np.abs(tg - jg).max()) <= GRAD_TOL * scale, (k, scale)


def test_round_ties_go_to_even():
    """jnp.round and torch.round both round half to even: -2.5 -> -2,
    -1.5 -> -2, 0.5 -> 0, 1.5 -> 2, 2.5 -> 2."""
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5], np.float32)
    jout, tout, _ = op_twin("round", {"X": x}, {}, "Out")
    np.testing.assert_array_equal(tout, jout)
    np.testing.assert_array_equal(tout, [-2, -2, -0, 0, 2, 2, 4])


@pytest.mark.parametrize("mode,alpha_shape", [
    ("all", (1,)), ("channel", (6,)), ("element", (6, 3, 3))])
def test_prelu_modes(mode, alpha_shape):
    """prelu's Alpha of one value, one a channel, one an element of a
    sample, against JAX's, with its gradient (x and Alpha)."""
    x = _x(avoid=(0,))
    alpha = RS.uniform(0, 0.5, alpha_shape).astype(np.float32)
    jout, tout, grads = op_twin("prelu", {"X": x, "Alpha": alpha},
                                {"mode": mode}, "Out", grad=("X", "Alpha"))
    np.testing.assert_allclose(tout, jout, rtol=RTOL, atol=ATOL)
    for k, (jg, tg) in grads.items():
        np.testing.assert_allclose(tg, jg, rtol=RTOL, atol=ATOL, err_msg=k)


def test_maxout_groups_consecutive_channels():
    """Out channel c is the max of in channels [c g, (c + 1) g)."""
    x = _x((2, 6, 2, 2))
    _j, tout, _ = op_twin("maxout", {"X": x}, {"groups": 2}, "Out")
    np.testing.assert_array_equal(tout, x.reshape(2, 3, 2, 2, 2).max(2))


# ---------------------------------------------------------------------------
# layer_function_generator and layers/ops.py
# ---------------------------------------------------------------------------

def test_generated_layers_run_as_jax():
    """generate_layer_fn / generate_activation_fn build a one-X, one-Out
    layer from the registry (kwargs become attrs; an unknown op raises),
    and the generated softshrink and swish run as JAX's."""
    for L in (jlayers, tlayers):
        with pytest.raises(ValueError):
            L.generate_layer_fn("no_such_op")
    x = _x((3, 5))

    def build(L, v):
        shrink = L.generate_layer_fn("softshrink")
        swish = L.generate_activation_fn("swish")
        assert swish.__name__ == "swish" and "swish" in swish.__doc__
        return [shrink(v, **{"lambda": 0.3}), swish(v, beta=2.0)]

    (j1, j2), (t1, t2) = run_layers(build, {"x": x})
    np.testing.assert_allclose(t1, j1, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t2, j2, rtol=RTOL, atol=ATOL)


def test_doc_helpers_as_jax():
    """deprecated warns and calls through; autodoc prepends; templatedoc
    fills each ${...} placeholder with the op's name: the same docstring
    in both packages."""
    docs = []
    for L in (jlayers, tlayers):
        @L.deprecated
        def old(a):
            return a + 1

        with pytest.warns(DeprecationWarning):
            assert old(1) == 2

        @L.autodoc("Note. ")
        @L.templatedoc("relu6")
        def f():
            """${comment} of ${x_type}."""

        docs.append(f.__doc__)
    assert docs[0] == docs[1] == "Note. relu6 of relu6."


# (layer, positional attr values), each appending its op with those attrs
ATTR_UNARIES = [
    ("elu", (0.5,)), ("relu6", (4.0,)), ("pow", (3.0,)),
    ("stanh", (0.6, 1.2)), ("hard_sigmoid", (0.3, 0.4)), ("swish", (1.5,)),
    ("hard_swish", (5.0, 5.0, 2.0)), ("thresholded_relu", (0.2,)),
    ("hard_shrink", (0.3,)), ("softshrink", (0.2,)), ("soft_relu", (3.0,)),
    ("brelu", (-1.0, 2.0))]


@pytest.mark.parametrize("name,args", ATTR_UNARIES)
def test_attribute_unary_layers(name, args):
    """Each attribute layer of layers/ops.py takes its attrs positionally
    (and its defaults), appends the same op and attrs as JAX's, and
    gives JAX's values."""
    x = _x((3, 4), lo=0.1, hi=3.0) if name == "pow" else _x((3, 4))

    def build(L, v):
        fn = getattr(L, name)
        return [fn(v, *args), fn(v)]

    (j1, j2), (t1, t2) = run_layers(build, {"x": x})
    np.testing.assert_allclose(t1, j1, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t2, j2, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", [
    "sigmoid", "logsigmoid", "tanh", "tanh_shrink", "softplus", "softsign",
    "rsqrt", "abs", "sin", "round", "reciprocal", "acos", "asin", "atan",
    "gelu", "erf", "log_softmax", "selu", "mish", "sqrt", "square"])
def test_unary_layers(name):
    """layers/ops.py's _UNARY layers through both Executors."""
    x = _x((3, 4), lo=0.1, hi=0.9)
    j, t = run_layers(lambda L, v: getattr(L, name)(v), {"x": x})
    np.testing.assert_allclose(t[0], j[0], rtol=RTOL, atol=ATOL)


def _ops_of(build):
    out = []
    for pkg, L, un in ((jfluid, jlayers, jun), (fluid, tlayers, tun)):
        main, startup = pkg.Program(), pkg.Program()
        with un.guard(), pkg.program_guard(main, startup):
            build(L)
        out.append([(op.type, sorted(k for k in op.attrs if k != "op_seed"))
                    for op in main.global_block().ops])
    return out


def test_random_layers_append_jax_ops():
    """uniform_random, gaussian_random, their *_batch_size_like forms
    (the uniform one appends uniform_random with an Input, as JAX's),
    sampling_id and random_crop append the JAX layers' ops and attrs."""
    def build(L):
        x = L.data("x", shape=[5], dtype="float32")
        img = L.data("img", shape=[3, 8, 8], dtype="float32")
        L.uniform_random([2, 3], min=-2.0, max=2.0)
        L.gaussian_random([2, 3], mean=1.0, std=2.0)
        L.uniform_random_batch_size_like(x, [-1, 4])
        L.gaussian_random_batch_size_like(x, [-1, 4])
        L.sampling_id(L.softmax(x))
        L.random_crop(img, [6, 6])

    jops, tops = _ops_of(build)
    assert tops == jops
    assert [t for t, _ in tops] == [
        "uniform_random", "gaussian_random", "uniform_random",
        "gaussian_random_batch_size_like", "softmax", "sampling_id",
        "random_crop"]


@pytest.mark.parametrize("kw", [
    {}, {"axis": 1}, {"axis": 1, "exclusive": True},
    {"axis": 0, "reverse": True}, {"axis": 1, "exclusive": True,
                                   "reverse": True}])
def test_cumsum_layer(kw):
    """layers.cumsum (ops.py's and nn.py's): axis None flattens."""
    x = _x((3, 5))
    j, t = run_layers(lambda L, v: L.cumsum(v, **kw), {"x": x})
    np.testing.assert_allclose(t[0], j[0], rtol=RTOL, atol=ATOL)


def test_prelu_and_leaky_relu_layers_from_jax_scope():
    """layers.prelu (its Alpha parameter, 0.25 from the startup) and
    leaky_relu through both Programs, the port on JAX's scope."""
    x = _x((2, 4, 3, 3), avoid=(0,))

    def build(pkg, L):
        v = L.data("x", shape=[4, 3, 3], dtype="float32")
        return [L.prelu(v, "channel"), L.prelu(v, "all"),
                L.leaky_relu(v, alpha=0.3)]

    jo, to, init = twin(build, {"x": x})
    assert sum(1 for n in init if "prelu" in n) == 2
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
