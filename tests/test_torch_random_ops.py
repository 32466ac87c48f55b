"""The port's random ops (``ops/random_ops.py``) under ROADMAP C17, on the
CPU: the 8 ops this slice adds (``uniform_random_batch_size_like``,
``gaussian_random_batch_size_like``, ``truncated_gaussian_random``,
``randint``, ``sampling_id``, ``random_crop``, ``multinomial``,
``bernoulli``) beside the two ported before.

They draw from the op's ``OpContext.rng()`` torch generator, so their
values cannot match ``jax.random``'s. Each is held, as dropout and the
R-CNN samplers are (C13, C16), to what a seed fixes: the JAX op's shape
(and dtype, int64 where JAX's is int32 under C12), the same numbers for
the same (program seed, step, op seed) and others for another step or
seed, its bounds (the truncated normal within 2 std, randint in [low,
high), the crop a window of the input), and its moments within stated
limits. The dp cases: each ``*_batch_size_like`` op reads the global
batch, its rows drawn a rank at a time (a rank r > 0 with r folded into
its seed).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import _REGISTRY as JREG

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.core import unique_name as tun
from paddle_tpu_torch.core.layer_helper import LayerHelper
from paddle_tpu_torch.ops import _DP_RULES

from test_torch_seq2seq import _JCtx

CPU = fluid.CPUPlace()
# moments of N draws: a mean within 5 standard errors (sigma / sqrt(N));
# at N = 200,000 a standard normal's mean within 0.011, its standard
# deviation within 1 % (measured at most 0.3 %)
N = 200_000
MEAN_SE = 5.0
STD_RTOL = 1e-2
# the truncated standard normal on [-2, 2]: variance 1 - 4 phi(2) /
# (Phi(2) - Phi(-2))
TRUNC_STD = math.sqrt(1 - 4 * math.exp(-2) / math.sqrt(2 * math.pi)
                      / math.erf(2 / math.sqrt(2)))
# category frequencies of N draws within 5 standard errors
# sqrt(p (1 - p) / N)
FREQ_SE = 5.0

OPS = ["uniform_random_batch_size_like", "gaussian_random_batch_size_like",
       "truncated_gaussian_random", "randint", "sampling_id", "random_crop",
       "multinomial", "bernoulli"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_bert.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _program(op, attrs, inputs=None, out_dtype="float32", seed=11):
    """A Program that appends `op` over data vars (name -> (shape,
    dtype), no batch dim added) and returns (main, its Out var)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with tun.guard(), fluid.program_guard(main, startup):
        ins = {slot: tlayers.data(slot.lower(), shape=list(shape),
                                  dtype=dtype, append_batch_size=False)
               for slot, (shape, dtype) in (inputs or {}).items()}
        helper = LayerHelper(op)
        out = helper.create_variable_for_type_inference(out_dtype)
        helper.append_op(op, ins, {"Out": out},
                         dict(attrs, op_seed=helper.next_op_seed()))
    return main, out


def _draw(op, attrs, feed=None, seed=11, steps=1, places=None):
    """The op's Out at each of `steps` runs of one Executor."""
    inputs = {k: (v.shape, str(v.dtype)) for k, v in (feed or {}).items()}
    main, out = _program(op, attrs, inputs, seed=seed)
    prog = main if places is None else fluid.CompiledProgram(
        main).with_data_parallel(places=places)
    exe = fluid.Executor(CPU)
    feed = {k.lower(): v for k, v in (feed or {}).items()}
    return [exe.run(prog, feed=feed, fetch_list=[out],
                    scope=fluid.Scope())[0] if places is not None else
            exe.run(prog, feed=feed, fetch_list=[out])[0]
            for _ in range(steps)]


def _jax_shape(op, ins, attrs):
    """The JAX op's output shape and dtype on the same inputs."""
    import jax
    ctx = _JCtx({k: jnp.asarray(v) for k, v in ins.items()}, attrs)
    ctx.rng = lambda: jax.random.PRNGKey(0)
    out = JREG[op](ctx)["Out"]
    return tuple(out.shape), np.dtype(out.dtype)


PROBS = np.array([[0.1, 0.2, 0.3, 0.4], [0.7, 0.0, 0.2, 0.1]], np.float32)

# op -> (inputs, attrs, the port's dtype)
CASES = {
    "uniform_random_batch_size_like": (
        {"Input": np.zeros((6, 3), np.float32)},
        {"shape": [-1, 5], "min": -2.0, "max": 3.0}, np.float32),
    "gaussian_random_batch_size_like": (
        {"Input": np.zeros((2, 7), np.float32)},
        {"shape": [4, -1], "input_dim_idx": 1, "output_dim_idx": 1,
         "mean": 1.0, "std": 2.0}, np.float32),
    "truncated_gaussian_random": (
        {}, {"shape": [3, 4], "mean": 0.5, "std": 2.0}, np.float32),
    "randint": ({}, {"shape": [5, 2], "low": -3, "high": 4}, np.int64),
    "sampling_id": ({"X": PROBS}, {}, np.int64),
    "random_crop": ({"X": np.arange(2 * 3 * 6 * 7, dtype=np.float32)
                     .reshape(2, 3, 6, 7)}, {"shape": [4, 5]}, np.float32),
    "multinomial": ({"X": PROBS}, {"num_samples": 3}, np.int64),
    "bernoulli": ({"X": np.full((3, 5), 0.3, np.float32)}, {}, np.float32),
}


def test_the_slice_registers_every_random_op_with_a_dp_rule():
    assert sorted(CASES) == sorted(OPS)
    for name in OPS:
        assert _DP_RULES[name] is not None, name


@pytest.mark.parametrize("op", OPS)
def test_shape_dtype_and_determinism(op):
    """The JAX op's shape (int64 for JAX's int32 draws), the same values
    from the same program seed on a new Executor, other values at the
    next step and from another seed."""
    ins, attrs, dtype = CASES[op]
    first = _draw(op, attrs, ins, steps=2)
    again = _draw(op, attrs, ins)[0]
    other = _draw(op, attrs, ins, seed=12)[0]
    shape, jdtype = _jax_shape(op, ins, attrs)
    assert first[0].shape == shape and first[0].dtype == dtype
    assert jdtype == (np.int32 if dtype == np.int64 else dtype)
    np.testing.assert_array_equal(again, first[0])
    if first[0].size >= 10:    # small draws may repeat by chance
        assert not np.array_equal(first[1], first[0])
        assert not np.array_equal(other, first[0])


def _big(op, attrs, ins=None):
    return _draw(op, attrs, ins)[0].astype(np.float64)


def test_uniform_batch_size_like_bounds_and_moments():
    x = _big("uniform_random_batch_size_like",
             {"shape": [-1, 1000], "min": -2.0, "max": 3.0},
             {"Input": np.zeros((N // 1000, 1), np.float32)})
    assert x.shape == (N // 1000, 1000)
    assert x.min() >= -2.0 and x.max() < 3.0
    sigma = 5.0 / math.sqrt(12)
    assert abs(x.mean() - 0.5) < MEAN_SE * sigma / math.sqrt(N)
    assert abs(x.std() / sigma - 1) < STD_RTOL


def test_gaussian_batch_size_like_moments():
    x = _big("gaussian_random_batch_size_like",
             {"shape": [-1, 1000], "mean": 1.0, "std": 2.0},
             {"Input": np.zeros((N // 1000, 2), np.float32)})
    assert abs(x.mean() - 1.0) < MEAN_SE * 2.0 / math.sqrt(N)
    assert abs(x.std() / 2.0 - 1) < STD_RTOL


def test_truncated_gaussian_within_two_std():
    """mean + std x a normal truncated to [-2, 2]: every draw within 2
    std of the mean, the standard deviation the truncated one's."""
    x = _big("truncated_gaussian_random",
             {"shape": [N], "mean": 0.5, "std": 2.0})
    z = (x - 0.5) / 2.0
    assert np.abs(z).max() <= 2.0 + 1e-6
    assert np.abs(z).max() > 1.99
    assert abs(z.mean()) < MEAN_SE * TRUNC_STD / math.sqrt(N)
    assert abs(z.std() / TRUNC_STD - 1) < STD_RTOL


def test_randint_in_low_high():
    x = _draw("randint", {"shape": [N], "low": -3, "high": 4})[0]
    assert x.dtype == np.int64 and x.min() == -3 and x.max() == 3
    counts = np.bincount(x + 3, minlength=7) / N
    p = 1 / 7
    assert np.abs(counts - p).max() < FREQ_SE * math.sqrt(p * (1 - p) / N)


@pytest.mark.parametrize("op,attrs", [("sampling_id", {}),
                                      ("multinomial", {"num_samples": 4})])
def test_categorical_frequencies(op, attrs):
    """sampling_id's and multinomial's ids follow each row's weights; a
    zero weight is never drawn."""
    probs = np.tile(PROBS, (N // 8, 1))
    ids = _draw(op, attrs, {"X": probs})[0].reshape(probs.shape[0], -1)
    for row in range(2):
        got = np.bincount(ids[row::2].ravel(), minlength=4) / ids[row::2].size
        n = ids[row::2].size
        se = np.sqrt(PROBS[row] * (1 - PROBS[row]) / n)
        assert (np.abs(got - PROBS[row]) <= FREQ_SE * se + 1e-12).all(), got
    assert not (ids[1::2] == 1).any()


def test_bernoulli_mean_per_element():
    p = np.tile(np.array([0.0, 0.25, 0.9, 1.0], np.float32), (N // 4, 1))
    x = _draw("bernoulli", {}, {"X": p})[0]
    assert set(np.unique(x)) <= {0.0, 1.0}
    got = x.mean(0)
    se = np.sqrt(p[0] * (1 - p[0]) * 4 / N)
    assert (np.abs(got - p[0]) <= FREQ_SE * se + 1e-12).all(), got


def test_random_crop_is_a_window_of_the_input():
    """The trailing dims cut to the crop shape at one start a dim: the
    output is x[..., i:i + 4, j:j + 5] for some (i, j), and other
    steps find other windows."""
    x = CASES["random_crop"][0]["X"]
    starts = set()
    for out in _draw("random_crop", {"shape": [4, 5]}, {"X": x}, steps=8):
        i = int(out[0, 0, 0, 0]) // 7 % 6
        j = int(out[0, 0, 0, 0]) % 7
        np.testing.assert_array_equal(out, x[:, :, i:i + 4, j:j + 5])
        starts.add((i, j))
    assert len(starts) > 1


def test_random_layers_run():
    """layers.uniform_random / gaussian_random / the batch-size-like
    layers / sampling_id / random_crop build and run, with their
    shapes."""
    main, startup = fluid.Program(), fluid.Program()
    with tun.guard(), fluid.program_guard(main, startup):
        x = tlayers.data("x", shape=[4], dtype="float32")
        img = tlayers.data("img", shape=[2, 6, 6], dtype="float32")
        outs = [tlayers.uniform_random([2, 3], min=0.0, max=1.0),
                tlayers.gaussian_random([3, 2]),
                tlayers.uniform_random_batch_size_like(x, [-1, 7]),
                tlayers.gaussian_random_batch_size_like(x, [-1, 2]),
                tlayers.sampling_id(tlayers.softmax(x)),
                tlayers.random_crop(img, [3, 3])]
    exe = fluid.Executor(CPU)
    exe.run(startup)
    got = exe.run(main, feed={"x": np.ones((5, 4), np.float32),
                              "img": np.ones((5, 2, 6, 6), np.float32)},
                  fetch_list=outs)
    assert [g.shape for g in got] == [(2, 3), (3, 2), (5, 7), (5, 2), (5,),
                                      (5, 2, 3, 3)]


# ---------------------------------------------------------------------------
# data parallelism
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["uniform_random_batch_size_like",
                                "gaussian_random_batch_size_like"])
def test_batch_size_like_under_dp_reads_the_global_batch(op):
    """With the rows in dim 0 each of two ranks draws its own rows: the
    output holds the global batch, the halves differ; with Input's
    batch in another output dim the op runs once and its output has
    the global batch there."""
    feed = {"Input": np.zeros((8, 3), np.float32)}
    got = _draw(op, {"shape": [-1, 50]}, feed, places=[CPU] * 2)[0]
    assert got.shape == (8, 50)
    assert not np.array_equal(got[:4], got[4:])
    got = _draw(op, {"shape": [2, -1], "output_dim_idx": 1}, feed,
                places=[CPU] * 2)[0]
    assert got.shape == (2, 8)


def test_per_row_draws_under_dp():
    """sampling_id and bernoulli draw a rank's rows (shapes of the global
    batch); random_crop refuses to crop dim 0 of a sharded input."""
    probs = np.tile(PROBS, (4, 1))
    ids = _draw("sampling_id", {}, {"X": probs}, places=[CPU] * 2)[0]
    assert ids.shape == (8,) and not (ids[1::2] == 1).any()
    bern = _draw("bernoulli", {}, {"X": np.full((8, 6), 0.5, np.float32)},
                 places=[CPU] * 2)[0]
    assert bern.shape == (8, 6)
    with pytest.raises(NotImplementedError, match="crops dim 0"):
        _draw("random_crop", {"shape": [2, 3]},
              {"X": np.zeros((4, 5), np.float32)}, places=[CPU] * 2)
