"""The port's sampling and matching ops against the JAX package, on the
CPU: the 3 names of ``ops/sampling_ops.py`` (``nce``,
``hierarchical_sigmoid``, ``sample_logits``) and the 5 of
``ops/match_ops.py`` that ROADMAP item 10c.6f ports, and the eight
layers over them (``nce``, ``hsigmoid``,
``sampled_softmax_with_cross_entropy``, ``match_matrix_tensor``,
``var_conv_2d``, ``tree_conv``, ``sequence_scatter``,
``sequence_topk_avg_pooling``).

The samplers draw from torch generators, so no draw equals
``jax.random``'s (ROADMAP C19): each sampler op is held through its
score half on JAX's own draws, read back from the JAX op's SampleLabels
/ Samples, and its draw half by its distribution (a Kolmogorov-Smirnov
distance for the log-uniform and uniform samplers, frequencies for
``custom_dist``), by seed and by the dp rule (one set for the whole
batch: every rank draws rank 0's).

Cases mirror ``tests/ops/test_sampling_ops.py:26-170``,
``tests/ops/test_match_ops.py:24-189`` (with its reference tree_conv
algorithm, parametrised) and ``tests/api/test_documented_limits.py:26,48``,
with each trouble point of the slice: labels and ids out of range (a
gather clamps and passes no gradient, ``take_along_axis`` fills NaN, a
scatter drops), duplicate ``sequence_scatter`` ids, ``var_conv_2d`` at
stride 2 with an even kernel ("SAME" padded explicitly), ``topks`` past
L2, interior zero edges in ``tree_conv``, a NaN through
``match_matrix_tensor``'s masks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu.core import unique_name as jun
from paddle_tpu.ops import _REGISTRY as JREG

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.core import unique_name as tun
from paddle_tpu_torch.ops import _DP_RULES, _REGISTRY as TREG
from paddle_tpu_torch.ops import sampling_ops as ts

from test_torch_seq2seq import _JCtx, op_twin, run_layers

CPU = fluid.CPUPlace()
# f32 outputs within 1e-6 relative of the output's largest entry (the
# products sum in another order than XLA's: measured at most 2.7e-7);
# gradients of a seeded cotangent within 1e-5 of the gradient's largest
# entry (measured at most 4.1e-7); integer outputs equal
RTOL = 1e-6
GRAD_TOL = 1e-5
# dp 2 against dp 1: each rank's rows in another summation order
DP_TOL = 1e-6
# a sampler's empirical CDF against the exact one: within KS_SIGMAS /
# sqrt(n) at every drawn id (a correct sampler passes with near
# certainty; the 1 % critical value of the KS statistic is 1.63 / sqrt(n))
KS_SIGMAS = 4.0

RS = np.random.RandomState(250)

SLICE_OPS = ["hierarchical_sigmoid", "nce", "sample_logits",
             "match_matrix_tensor", "sequence_scatter",
             "sequence_topk_avg_pooling", "tree_conv", "var_conv_2d"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_bert.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _r(*shape, lo=-1.0, hi=1.0):
    return RS.uniform(lo, hi, shape).astype(np.float32)


def close(got, want, rtol=RTOL, name=""):
    """Shapes equal, NaN where the reference has NaN, the rest within
    rtol of the largest finite entry (integers equal)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                  err_msg=name)
    fin = np.isfinite(want)
    scale = float(np.abs(want[fin]).max()) if fin.any() else 0.0
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol,
                               atol=rtol * scale, err_msg=name)


def grads_close(grads, tol=GRAD_TOL):
    for k, (jg, tg) in grads.items():
        for a, b in zip(tg if isinstance(tg, list) else [tg],
                        jg if isinstance(jg, list) else [jg]):
            a, b = np.asarray(a), np.asarray(b)
            scale = max(float(np.abs(b).max()), 1e-12)
            np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale,
                                       err_msg=k)


def test_the_slice_registers_every_op_with_a_dp_rule():
    for name in SLICE_OPS:
        assert name in JREG and name in TREG, name
        assert _DP_RULES[name] is not None, name


# ---------------------------------------------------------------------------
# the samplers: the score half on JAX's draws
# ---------------------------------------------------------------------------

class _JRngCtx(_JCtx):
    """The JAX op's context with its key."""

    def __init__(self, ins, attrs, key=3):
        super().__init__(ins, attrs)
        self._key = key

    def rng(self):
        return jax.random.PRNGKey(self._key)


def _jax_run(op, ins, attrs, key=3):
    jins = {k: jnp.asarray(v) for k, v in ins.items()}
    return {k: np.asarray(v) for k, v in
            JREG[op](_JRngCtx(jins, attrs, key)).items()}


def _jax_grads(op, ins, attrs, slot, wrt, cot, key=3):
    jins = {k: jnp.asarray(v) for k, v in ins.items()}

    def f(*xs):
        j2 = dict(jins, **dict(zip(wrt, xs)))
        return jnp.sum(JREG[op](_JRngCtx(j2, attrs, key))[slot] * cot)

    return [np.asarray(g) for g in jax.grad(
        f, argnums=tuple(range(len(wrt))))(*[jins[k] for k in wrt])]


def _torch_leaves(ins, wrt):
    return {k: torch.tensor(v, requires_grad=k in wrt) for k, v in
            ins.items()}


def _nce_case(sampler, b=6, d=5, c=40, t=2, out_of_range=False):
    label = RS.randint(0, c, (b, t)).astype(np.int64)
    if out_of_range:
        label[1, 0], label[3, 1] = c + 3, -1
    ins = {"Input": _r(b, d), "Weight": _r(c, d), "Bias": _r(c),
           "Label": label}
    if sampler == "custom_dist":
        p = RS.rand(c).astype(np.float32) + 0.05
        ins["CustomDistProbs"] = (p / p.sum()).astype(np.float32)
    return ins, {"num_total_classes": c, "num_neg_samples": 12,
                 "sampler": sampler}


@pytest.mark.parametrize("sampler", ["uniform", "log_uniform",
                                     "custom_dist"])
@pytest.mark.parametrize("out_of_range", [False, True])
def test_nce_score_on_jax_draws(sampler, out_of_range):
    """JAX's nce draws its negatives; the port's score half on those
    negatives gives JAX's Cost, SampleLogits and SampleLabels, and the
    gradients of the Cost into Input, Weight and Bias (a label out of
    range: w[label] clamped, no gradient through it)."""
    ins, attrs = _nce_case(sampler, out_of_range=out_of_range)
    j = _jax_run("nce", ins, attrs)
    t_num = ins["Label"].shape[1]
    neg = j["SampleLabels"][0, t_num:]
    wrt = ("Input", "Weight", "Bias")
    t = _torch_leaves(ins, wrt)
    got = ts.nce_score(t["Input"], t["Weight"], t["Bias"], t["Label"],
                       torch.from_numpy(neg.astype(np.int64)),
                       attrs["num_total_classes"], sampler,
                       t.get("CustomDistProbs"))
    for slot in ("Cost", "SampleLogits", "SampleLabels"):
        close(got[slot].detach().numpy(), j[slot].astype(
            np.int64 if slot == "SampleLabels" else np.float32), name=slot)
    assert got["SampleLabels"].dtype == torch.int64
    cot = RS.randn(*j["Cost"].shape).astype(np.float32)
    jg = _jax_grads("nce", ins, attrs, "Cost", wrt, cot)
    tg = torch.autograd.grad((got["Cost"] * torch.from_numpy(cot)).sum(),
                             [t[k] for k in wrt])
    grads_close({k: (a, b.numpy()) for k, a, b in zip(wrt, jg, tg)})


@pytest.mark.parametrize("hits", [True, False])
@pytest.mark.parametrize("out_of_range", [False, True])
def test_sample_logits_score_on_jax_draws(hits, out_of_range):
    """JAX's sample_logits draws its classes; the port's score half on
    them gives JAX's Loss, Samples and SampledLogits (logQ correction,
    accidental hits of the first true label at -1e20; a label past the
    logits a NaN row, take_along_axis's fill) and the gradient of the
    Loss into the logits."""
    b, c = 6, 50
    label = RS.randint(0, 3 if hits else c, (b, 2)).astype(np.int64)
    if out_of_range:
        label[2, 0] = c + 4
    ins = {"Logits": _r(b, c, lo=-2, hi=2), "Labels": label}
    attrs = {"num_samples": 20, "remove_accidental_hits": True}
    j = _jax_run("sample_logits", ins, attrs)
    samples = j["Samples"][0, 2:].astype(np.int64)
    if hits:
        assert (samples[None] == label[:, :1]).any()
    t = _torch_leaves(ins, ("Logits",))
    got = ts.sample_logits_score(t["Logits"], t["Labels"],
                                 torch.from_numpy(samples))
    for slot in ("Loss", "SampledLogits", "Samples"):
        close(got[slot].detach().numpy(), j[slot].astype(
            np.int64 if slot == "Samples" else np.float32), name=slot)
    if out_of_range:
        assert np.isnan(got["Loss"].detach().numpy()[2, 0])
        return
    cot = RS.randn(b, 1).astype(np.float32)
    jg = _jax_grads("sample_logits", ins, attrs, "Loss", ("Logits",), cot)
    tg = torch.autograd.grad((got["Loss"] * torch.from_numpy(cot)).sum(),
                             [t["Logits"]])
    grads_close({"Logits": (jg[0], tg[0].numpy())})


@pytest.mark.parametrize("case", ["default", "default_out_of_range",
                                  "custom", "custom_past_w"])
def test_hierarchical_sigmoid_against_jax(case):
    """Both tree forms, Out and PreOut and the gradients into X, W and
    Bias: the default tree at depth bit_length(C - 1) (labels >=
    num_classes walk nodes past W: clamped, no gradient), a custom tree
    whose interior negative ends the path, and one whose PathTable names
    a row past W."""
    b, d = 5, 6
    label = RS.randint(0, 10, (b, 1)).astype(np.int64)
    ins = {"X": _r(b, d), "Label": label}
    if case.startswith("default"):
        if case.endswith("range"):
            label[1, 0], label[4, 0] = 10, 17
        ins.update(W=_r(9, d), Bias=_r(9))
    else:
        table = np.array([[0, 1, -1], [0, 2, 4], [3, -1, 4], [0, 1, 2],
                          [4, 3, 1]], np.int64)
        if case == "custom_past_w":
            table[3, 2] = 9
        ins.update(W=_r(5, d), Bias=_r(5), PathTable=table,
                   PathCode=RS.randint(0, 2, (b, 3)).astype(np.int64))
    for slot in ("Out", "PreOut"):
        j, t, grads = op_twin("hierarchical_sigmoid", ins,
                              {"num_classes": 10}, slot,
                              grad=("X", "W", "Bias"))
        close(t, j, name=slot)
        grads_close(grads)


def test_hsigmoid_default_depth_at_the_billion_word_vocabulary():
    """The default tree's depth at LM1B's 793,471 words is 20; its nodes
    and bits are the JAX op's on the largest ids (PreOut on a small W
    reads clamped rows: compare the walk through node ids directly)."""
    c = 793_471
    label = torch.tensor([0, 1, c - 2, c - 1, 524_288])
    node, bit, valid = ts._default_tree(label, c)
    assert node.shape == (5, 20)
    code = label.numpy() + c
    for i in range(20):
        np.testing.assert_array_equal(node[:, i].numpy(),
                                      (code >> (i + 1)) - 1)
        np.testing.assert_array_equal(bit[:, i].numpy(), (code >> i) & 1)
    np.testing.assert_array_equal(valid.numpy(), node.numpy() >= 0)
    assert int(node.max()) == c - 2          # the last internal node


# ---------------------------------------------------------------------------
# the samplers' draws
# ---------------------------------------------------------------------------

def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _ks(draws, cdf):
    """The largest distance between the empirical CDF of `draws` and
    cdf(ids), over every drawn id."""
    ids, counts = np.unique(draws, return_counts=True)
    emp = np.cumsum(counts) / draws.size
    return float(np.abs(emp - cdf(ids)).max())


@pytest.mark.parametrize("r", [50, 793_471])
def test_log_uniform_draws_follow_the_zipf_cdf(r):
    """2^16 log-uniform draws: int64 in [0, R), empirical CDF within
    KS_SIGMAS / sqrt(n) of log(c + 2) / log(R + 1) at every drawn id."""
    n = 1 << 16
    d = ts.draw_classes(_gen(1), "log_uniform", n, r, None, "cpu")
    assert d.dtype == torch.int64 and d.shape == (n,)
    d = d.numpy()
    assert d.min() >= 0 and d.max() < r
    ks = _ks(d, lambda c: np.log(c + 2.0) / np.log(r + 1.0))
    assert ks <= KS_SIGMAS / np.sqrt(n), ks


def test_uniform_and_custom_draws():
    """Uniform draws: a KS distance from (c + 1) / R; custom_dist draws
    (with replacement from the probabilities): never a class of
    probability 0, frequencies within 4 standard errors."""
    n, r = 1 << 16, 37
    d = ts.draw_classes(_gen(2), "uniform", n, r, None, "cpu").numpy()
    assert d.min() >= 0 and d.max() < r
    assert _ks(d, lambda c: (c + 1.0) / r) <= KS_SIGMAS / np.sqrt(n)
    p = np.array([0.5, 0.0, 0.2, 0.3, 0.0], np.float32)
    d = ts.draw_classes(_gen(3), "custom_dist", n, 5, torch.from_numpy(p),
                        "cpu").numpy()
    freq = np.bincount(d, minlength=5) / n
    assert freq[1] == 0 and freq[4] == 0
    se = np.sqrt(p * (1 - p) / n)
    assert (np.abs(freq - p) <= 4 * se + 1e-12).all(), freq


def _sampler_program(layer):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 9
    with tun.guard(), fluid.program_guard(main, startup):
        x = tlayers.data("x", shape=[6], dtype="float32")
        y = tlayers.data("y", shape=[1], dtype="int64")
        out = layer(x, y)
    return main, startup, out


def _op_out(main, op_type, slot):
    return next(op for op in main.global_block().ops
                if op.type == op_type).output(slot)[0]


@pytest.mark.parametrize("op,layer,slot", [
    ("nce", lambda x, y: tlayers.nce(x, y, num_total_classes=30,
                                     num_neg_samples=7, sampler="log_uniform",
                                     seed=5), "SampleLabels"),
    ("sample_logits", lambda x, y: tlayers.sampled_softmax_with_cross_entropy(
        tlayers.fc(x, size=40), y, num_samples=9, seed=5), "Samples")])
def test_draws_repeat_by_seed_and_step(op, layer, slot):
    """Two Executors from one startup draw the same classes at each step
    (program seed, step, op seed); the next step draws others; every row
    of the batch gets the same set."""
    main, startup, out = _sampler_program(layer)
    name = _op_out(main, op, slot)
    feed = {"x": _r(8, 6), "y": RS.randint(0, 30, (8, 1)).astype(np.int64)}
    runs = []
    for _ in range(2):
        scope, exe = fluid.Scope(), fluid.Executor(CPU)
        exe.run(startup, scope=scope)
        runs.append([exe.run(main, feed=feed, fetch_list=[name],
                             scope=scope)[0] for _ in range(2)])
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    assert not np.array_equal(runs[0][0], runs[0][1])
    assert runs[0][0].dtype == np.int64
    assert (runs[0][0][:, 1:] == runs[0][0][:1, 1:]).all()


# ---------------------------------------------------------------------------
# the match ops
# ---------------------------------------------------------------------------

def _edges():
    e = np.zeros((2, 8, 2), np.int64)
    e[0, :6] = [[1, 2], [1, 3], [2, 4], [2, 5], [2, 6], [4, 7]]
    e[1, :4] = [[1, 2], [1, 3], [0, 0], [3, 4]]     # an interior zero
    return e


def _match_cases():
    x = _r(2, 3, 5)
    x_nan = x.copy()
    x_nan[1, 2, 0] = np.nan                          # past row 1's length
    ids = np.array([[0, 2, 2, 9], [5, 1, -1, 0]], np.int64)
    return {
        "mmt_lengths": ("match_matrix_tensor",
                        {"X": x, "Y": _r(2, 4, 6), "W": _r(5, 2, 6),
                         "XLength": np.array([3, 2]),
                         "YLength": np.array([4, 1])}, {}, "Out",
                        ("X", "Y", "W")),
        "mmt_tmp": ("match_matrix_tensor",
                    {"X": x, "Y": _r(2, 4, 6), "W": _r(5, 2, 6)}, {}, "Tmp",
                    ("X", "W")),
        "mmt_nan_stays": ("match_matrix_tensor",
                          {"X": x_nan, "Y": _r(2, 4, 6), "W": _r(5, 2, 6),
                           "XLength": np.array([3, 2])}, {}, "Out", ()),
        "var_conv_s1_k3": ("var_conv_2d",
                           {"X": _r(2, 3, 9, 8), "W": _r(4, 3, 3, 3),
                            "Row": np.array([9, 5]),
                            "Col": np.array([7, 8])},
                           {"strides": [1, 1]}, "Out", ("X", "W")),
        "var_conv_s2_k4": ("var_conv_2d",
                           {"X": _r(2, 3, 9, 8), "W": _r(4, 3, 4, 4),
                            "Row": np.array([9, 5]),
                            "Col": np.array([7, 3])},
                           {"strides": [2, 2]}, "Out", ("X", "W")),
        "var_conv_s21_k2x3": ("var_conv_2d",
                              {"X": _r(2, 3, 7, 6), "W": _r(4, 3, 2, 3)},
                              {"strides": [2, 1]}, "Out", ("X", "W")),
        "scatter_dups_dropped": ("sequence_scatter",
                                 {"X": _r(2, 6), "Ids": ids,
                                  "Updates": _r(2, 4),
                                  "Length": np.array([4, 3])}, {}, "Out",
                                 ("X", "Updates")),
        "scatter_ids_b_l_1": ("sequence_scatter",
                              {"X": _r(2, 6), "Ids": ids[..., None],
                               "Updates": _r(2, 4)}, {}, "Out",
                              ("X", "Updates")),
        "topk_past_l2": ("sequence_topk_avg_pooling",
                         {"X": _r(2, 3, 4, 6), "Row": np.array([4, 2]),
                          "Col": np.array([6, 3])},
                         {"topks": [1, 3, 5, 10]}, "Out", ("X",)),
        "topk_no_lengths": ("sequence_topk_avg_pooling",
                            {"X": _r(2, 2, 3, 5)}, {"topks": [2, 1]},
                            "Out", ("X",)),
        **{f"tree_conv_depth{d}": ("tree_conv",
                                   {"NodesVector": _r(2, 8, 3),
                                    "EdgeSet": _edges(),
                                    "Filter": _r(3, 3, 4, 2),
                                    "Bias": _r(4, 2)},
                                   {"max_depth": d}, "Out",
                                   ("NodesVector", "Filter", "Bias"))
           for d in (2, 3, 4)},
        "tree_conv_bias_1d": ("tree_conv",
                              {"NodesVector": _r(2, 8, 3),
                               "EdgeSet": _edges().astype(np.int32),
                               "Filter": _r(3, 3, 4, 2), "Bias": _r(4)},
                              {"max_depth": 2}, "Out", ("Bias",)),
    }


@pytest.mark.parametrize("case", sorted(_match_cases()))
def test_match_op_against_jax(case):
    op, ins, attrs, slot, grad = _match_cases()[case]
    j, t, grads = op_twin(op, ins, attrs, slot, grad=grad)
    close(t, j, name=case)
    grads_close(grads)
    if case == "mmt_nan_stays":
        assert np.isnan(t[1, :, 2]).all()


# ---------------------------------------------------------------------------
# the layers through both Executors (tests/ops/test_match_ops.py)
# ---------------------------------------------------------------------------

def _param(lay, name):
    pkg = jfluid if lay is jfluid.layers else fluid
    return pkg.ParamAttr(name=name)


def _init(lay, value):
    pkg = jfluid if lay is jfluid.layers else fluid
    return pkg.ParamAttr(
        initializer=pkg.initializer.NumpyArrayInitializer(value))


def test_match_matrix_tensor_layer():
    """test_match_ops.py:24: out = einsum(bid, dce, bje -> bcij) with W
    set; both Executors, and the act on the output."""
    x, y = _r(2, 3, 5), _r(2, 4, 5)
    w = _r(5, 2, 5)
    (j, jt), (t, tt) = run_layers(
        lambda L, xv, yv: L.match_matrix_tensor(
            xv, yv, channel_num=2, act="tanh", param_attr=_init(L, w)),
        {"x": x, "y": y})
    ref = np.tanh(np.einsum("bid,dce,bje->bcij", x, w, y))
    np.testing.assert_allclose(t, ref, rtol=1e-5, atol=1e-6)
    close(t, j)
    close(tt, jt)


def test_sequence_scatter_layer():
    """test_match_ops.py:50: duplicates accumulate, a row's length masks
    its tail."""
    feeds = {"x": np.zeros((2, 6), np.float32),
             "i": np.array([[0, 2, 2], [5, 1, 0]], np.int64),
             "u": np.array([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]], np.float32),
             "l": np.array([3, 2], np.int64)}
    (j,), (t,) = run_layers(
        lambda L, x, i, u, le: L.sequence_scatter(x, i, u, length=le), feeds)
    ref = np.zeros((2, 6), np.float32)
    ref[0, 0] = 1.0
    ref[0, 2] = 5.0
    ref[1, 5], ref[1, 1] = 4.0, 5.0
    np.testing.assert_array_equal(t, ref)
    np.testing.assert_array_equal(t, j)


def test_sequence_topk_avg_pooling_layer():
    """test_match_ops.py:74: only the first 3 columns valid; top-1 and
    the mean of the top 2."""
    x = np.arange(20, dtype=np.float32).reshape(1, 2, 2, 5)
    (j,), (t,) = run_layers(
        lambda L, xv, cv: L.sequence_topk_avg_pooling(
            xv, col=cv, topks=[1, 2], channel_num=2),
        {"x": x, "c": np.array([3], np.int64)})
    assert t.shape == (1, 2, 4)
    np.testing.assert_allclose(t[0, 0], [2.0, 1.5, 12.0, 11.5])
    np.testing.assert_array_equal(t, j)


def test_var_conv_2d_layer_masks_the_invalid_region():
    """test_match_ops.py:97: row 1's rows >= 4 and columns >= 5 are 0;
    the same values as JAX's from one filter."""
    x = _r(2, 3, 8, 8)
    w = _r(4, 3, 3, 3)
    (j,), (t,) = run_layers(
        lambda L, xv, rv, cv: L.var_conv_2d(
            xv, rv, cv, input_channel=3, output_channel=4, filter_size=3,
            param_attr=_init(L, w)),
        {"x": x, "r": np.array([8, 4], np.int64),
         "c": np.array([8, 5], np.int64)})
    assert t.shape == (2, 4, 8, 8)
    assert np.abs(t[1, :, 4:, :]).sum() == 0
    assert np.abs(t[1, :, :, 5:]).sum() == 0
    assert np.abs(t[1, :, :4, :5]).sum() > 0
    close(t, j)


def _tree_conv_golden(nodes, edges, filt, max_depth):
    """tests/ops/test_match_ops.py:120's independent numpy port of the
    reference algorithm (construct_tree stops at the first 0 pair; the
    window is the descendants at depth < max_depth; eta_t = (d - k) / d,
    eta_l = (1 - eta_t) temp, eta_r = (1 - eta_t)(1 - eta_l); rows past
    node_count zero)."""
    n = nodes.shape[0]
    tr, ecount = {}, 0
    for u, v in edges:
        if u == 0 or v == 0:
            break
        tr.setdefault(int(u), []).append(int(v))
        ecount += 1
    dd = float(max_depth)
    wl, wr, wt = filt[:, 0], filt[:, 1], filt[:, 2]
    out = np.zeros((n,) + wl.shape[1:], np.float32)
    for root in range(1, ecount + 2):
        patch = [(root, 1, 1, 0)]
        frontier = [(root, 0)]
        while frontier:
            nxt = []
            for u, dep in frontier:
                if dep + 1 < max_depth:
                    kids = tr.get(u, [])
                    for i, v in enumerate(kids):
                        patch.append((v, i + 1, len(kids), dep + 1))
                        nxt.append((v, dep + 1))
            frontier = nxt
        acc = np.zeros(wl.shape[1:], np.float32)
        for v, index, pclen, dep in patch:
            eta_t = (dd - dep) / dd
            temp = 0.5 if pclen == 1 else (index - 1.0) / (pclen - 1.0)
            eta_l = (1.0 - eta_t) * temp
            eta_r = (1.0 - eta_t) * (1.0 - eta_l)
            acc += np.einsum("d,dhf->hf", nodes[v - 1],
                             eta_l * wl + eta_r * wr + eta_t * wt)
        out[root - 1] = acc
    return out


@pytest.mark.parametrize("max_depth", [2, 3, 4])
def test_tree_conv_matches_the_reference_algorithm(max_depth):
    """test_match_ops.py:155: a depth-3 chain and an interior zero edge
    (the reference breaks there: node_count 3), against the numpy port of
    the reference algorithm and JAX's, through both Executors."""
    b, n, d, h, f = 2, 8, 3, 4, 2
    rng = np.random.default_rng(3 + max_depth)
    nodes = rng.standard_normal((b, n, d)).astype(np.float32)
    filt = rng.standard_normal((d, 3, h, f)).astype(np.float32)
    edges = _edges()
    (j,), (t,) = run_layers(
        lambda L, nv, ev: L.tree_conv(
            nv, ev, output_size=h, num_filters=f, max_depth=max_depth,
            act=None, bias_attr=False, param_attr=_init(L, filt)),
        {"n": nodes, "e": edges})
    want = np.stack([_tree_conv_golden(nodes[i], edges[i], filt, max_depth)
                     for i in range(b)])
    np.testing.assert_allclose(t, want, rtol=1e-5, atol=1e-5)
    close(t, j)
    assert np.abs(t[1, 3:]).sum() == 0


def test_tree_conv_deep_window_runs():
    """test_documented_limits.py:48: a depth-4 window over int32 edges
    runs; the rows of the chain are nonzero."""
    feeds = {"nodes": RS.standard_normal((2, 5, 4)).astype(np.float32),
             "edges": np.array([[[1, 2], [2, 3], [3, 4], [0, 0]]] * 2,
                               np.int32)}
    filt = _r(4, 3, 3, 1)
    (j,), (t,) = run_layers(
        lambda L, nv, ev: L.tree_conv(nv, ev, output_size=3, max_depth=4,
                                      param_attr=_init(L, filt)),
        feeds)
    assert t.shape == (2, 5, 3, 1)
    assert np.abs(t[:, :4]).sum() > 0
    close(t, j)


def test_hsigmoid_argument_checks():
    """test_documented_limits.py:26: is_custom without the tables, and
    tables without is_custom, raise ValueError."""
    with tun.guard(), fluid.program_guard(fluid.Program(), fluid.Program()):
        x = tlayers.data("x", [4, 8], append_batch_size=False)
        y = tlayers.data("y", [4, 1], dtype="int64",
                         append_batch_size=False)
        with pytest.raises(ValueError, match="path_table"):
            tlayers.hsigmoid(x, y, num_classes=6, is_custom=True)
        tv = tlayers.data("t", [4, 3], dtype="int64",
                          append_batch_size=False)
        cv = tlayers.data("c", [4, 3], dtype="int64",
                          append_batch_size=False)
        with pytest.raises(ValueError, match="is_custom"):
            tlayers.hsigmoid(x, y, num_classes=6, path_table=tv,
                             path_code=cv)


def test_sampled_softmax_refuses_customized_samples():
    with tun.guard(), fluid.program_guard(fluid.Program(), fluid.Program()):
        lg = tlayers.data("lg", [4, 20], append_batch_size=False)
        y = tlayers.data("y", [4, 1], dtype="int64", append_batch_size=False)
        with pytest.raises(NotImplementedError, match="customized"):
            tlayers.sampled_softmax_with_cross_entropy(
                lg, y, 5, use_customized_samples=True)


def _layer_nets():
    return {
        "nce": lambda L, x, y: L.nce(x, y, num_total_classes=30,
                                     num_neg_samples=5),
        "nce_custom_dist": lambda L, x, y: L.nce(
            x, y, num_total_classes=4, num_neg_samples=3,
            custom_dist=[0.1, 0.2, 0.3, 0.4]),
        "hsigmoid": lambda L, x, y: L.hsigmoid(x, y, num_classes=10),
        "sampled_softmax": lambda L, x, y: L.sampled_softmax_with_cross_entropy(
            L.fc(x, size=20), y, num_samples=6),
    }


@pytest.mark.parametrize("name", sorted(_layer_nets()))
def test_layer_builds_the_jax_graph(name):
    """The same op types, inputs, outputs and attrs in order, and the
    same parameters (names and shapes), as the JAX layer's Program."""
    progs = []
    for pkg, un in ((jfluid, jun), (fluid, tun)):
        main = pkg.Program()
        with un.guard(), pkg.program_guard(main, pkg.Program()):
            x = pkg.layers.data("x", shape=[6], dtype="float32")
            y = pkg.layers.data("y", shape=[1], dtype="int64")
            _layer_nets()[name](pkg.layers, x, y)
        progs.append(main)
    jm, tm = progs
    assert [(op.type, op.inputs, op.outputs, op.attrs)
            for op in tm.global_block().ops] == \
        [(op.type, op.inputs, op.outputs, op.attrs)
         for op in jm.global_block().ops]
    assert [(p.name, tuple(p.shape)) for p in tm.all_parameters()] == \
        [(p.name, tuple(p.shape)) for p in jm.all_parameters()]


# ---------------------------------------------------------------------------
# the heads train (tests/ops/test_sampling_ops.py)
# ---------------------------------------------------------------------------

def _train(build, feed, steps, lr=0.1):
    main, startup = fluid.Program(), fluid.Program()
    with tun.guard(), fluid.program_guard(main, startup):
        loss = build()
        fluid.optimizer.AdamOptimizer(learning_rate=lr).minimize(loss)
    scope, exe = fluid.Scope(), fluid.Executor(CPU)
    exe.run(startup, scope=scope)
    return [float(np.asarray(exe.run(main, feed=feed, fetch_list=[loss],
                                     scope=scope)[0]).reshape(()))
            for _ in range(steps)]


def _xy(seed, b, d, c, labels=None):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((b, d)).astype(np.float32),
            "y": rng.integers(0, labels or c, (b, 1)).astype(np.int64)}


def _data_xy(b, d):
    return (tlayers.data("x", shape=[b, d], dtype="float32",
                         append_batch_size=False),
            tlayers.data("y", shape=[b, 1], dtype="int64",
                         append_batch_size=False))


def test_nce_trains_down():
    """test_sampling_ops.py:26: 40 Adam steps take the NCE loss below
    0.6 of the first."""
    def build():
        x, y = _data_xy(16, 8)
        return tlayers.mean(tlayers.nce(x, y, num_total_classes=50,
                                        num_neg_samples=8))
    losses = _train(build, _xy(0, 16, 8, 50), 40)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.6, (losses[0], losses[-1])


def test_nce_log_uniform_sampler_runs():
    """test_sampling_ops.py:44."""
    def build():
        x, y = _data_xy(8, 4)
        return tlayers.mean(tlayers.nce(x, y, num_total_classes=30,
                                        num_neg_samples=5,
                                        sampler="log_uniform"))
    assert np.isfinite(_train(build, _xy(1, 8, 4, 30), 5)).all()


def test_hsigmoid_trains_and_beats_chance():
    """test_sampling_ops.py:61: 120 Adam steps take -log P(path) below
    0.3 of the first."""
    def build():
        x, y = _data_xy(32, 16)
        return tlayers.mean(tlayers.hsigmoid(x, y, num_classes=10))
    losses = _train(build, _xy(2, 32, 16, 10), 120)
    assert losses[-1] < 0.3 * losses[0], (losses[0], losses[-1])


def test_hsigmoid_custom_tree_matches_formula():
    """test_sampling_ops.py:77: the per-step sigmoid cross entropy over
    the prefix before the first negative table entry, in both
    packages."""
    b, d, c = 4, 6, 5
    rng = np.random.default_rng(7)
    x = rng.standard_normal((b, d)).astype(np.float32)
    y = rng.integers(0, 4, (b, 1)).astype(np.int64)
    w = rng.standard_normal((c, d)).astype(np.float32)
    bias = rng.standard_normal((c,)).astype(np.float32)
    table = np.array([[0, 1, -1], [0, 2, 4], [3, -1, 4], [0, 1, 2]],
                     np.int64)
    code = np.array([[1, 0, 0], [0, 1, 1], [1, 0, 1], [0, 0, 1]], np.int64)
    (j,), (t,) = run_layers(
        lambda L, xv, yv, tv, cv: L.hsigmoid(
            xv, yv, num_classes=c, path_table=tv, path_code=cv,
            is_custom=True, param_attr=_init(L, w),
            bias_attr=_init(L, bias)),
        {"x": x, "y": y, "t": table, "c": code})
    want = np.zeros((b, 1), np.float32)
    for i in range(b):
        for k in range(3):
            if table[i, k] < 0:
                break
            s = x[i] @ w[table[i, k]] + bias[table[i, k]]
            want[i, 0] += np.logaddexp(0.0, s) - code[i, k] * s
    np.testing.assert_allclose(t, want, rtol=1e-5, atol=1e-5)
    close(t, j)


def test_hsigmoid_custom_tree_trains_down():
    """test_sampling_ops.py:117: ragged custom paths, 80 steps."""
    rng = np.random.default_rng(8)
    table = rng.integers(0, 7, (16, 3)).astype(np.int64)
    table[:, -1] = -1
    feed = dict(_xy(8, 16, 8, 7, labels=4), t=table,
                c=rng.integers(0, 2, (16, 3)).astype(np.int64))

    def build():
        x, y = _data_xy(16, 8)
        tv = tlayers.data("t", shape=[16, 3], dtype="int64",
                          append_batch_size=False)
        cv = tlayers.data("c", shape=[16, 3], dtype="int64",
                          append_batch_size=False)
        return tlayers.mean(tlayers.hsigmoid(
            x, y, num_classes=7, path_table=tv, path_code=cv,
            is_custom=True))
    losses = _train(build, feed, 80)
    assert losses[-1] < 0.3 * losses[0], (losses[0], losses[-1])


def test_sampled_softmax_approximates_full():
    """test_sampling_ops.py:140: with near-uniform logits and 150
    samples of 200 classes the estimate lands near the full softmax
    cross entropy (both about log 200)."""
    rng = np.random.default_rng(3)
    feed = {"lg": (rng.standard_normal((8, 200)) * 0.1).astype(np.float32),
            "y": rng.integers(0, 200, (8, 1)).astype(np.int64)}
    main, startup = fluid.Program(), fluid.Program()
    with tun.guard(), fluid.program_guard(main, startup):
        lv = tlayers.data("lg", shape=[8, 200], dtype="float32",
                          append_batch_size=False)
        yv = tlayers.data("y", shape=[8, 1], dtype="int64",
                          append_batch_size=False)
        s_loss = tlayers.sampled_softmax_with_cross_entropy(
            lv, yv, num_samples=150)
        full = tlayers.mean(tlayers.softmax_with_cross_entropy(lv, yv))
    exe = fluid.Executor(CPU)
    s, f = exe.run(main, feed=feed, fetch_list=[s_loss, full],
                   scope=fluid.Scope())
    assert abs(float(s.mean()) - float(f)) < 1.5


def test_nce_custom_dist_through_assign():
    """custom_dist goes into the Program through assign (an assign_value
    op in both packages); the port's negatives never draw a class of
    probability 0."""
    main, startup = fluid.Program(), fluid.Program()
    with tun.guard(), fluid.program_guard(main, startup):
        x, y = _data_xy(8, 4)
        cost = tlayers.nce(x, y, num_total_classes=6, num_neg_samples=50,
                           custom_dist=[0.5, 0.0, 0.25, 0.25, 0.0, 0.0])
    types = [op.type for op in main.global_block().ops]
    assert types == ["assign_value", "nce"]
    labels = _op_out(main, "nce", "SampleLabels")
    exe = fluid.Executor(CPU)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    c, lab = exe.run(main, feed=_xy(4, 8, 4, 6), fetch_list=[cost, labels],
                     scope=scope)
    assert np.isfinite(c).all()
    assert set(np.unique(lab[:, 1:])) <= {0, 2, 3}


# ---------------------------------------------------------------------------
# data parallelism
# ---------------------------------------------------------------------------

def _dp_run(build, feed, places, steps=2):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 11
    with tun.guard(), fluid.program_guard(main, startup):
        outs = build()
    scope, exe = fluid.Scope(), fluid.Executor(CPU)
    exe.run(startup, scope=scope)
    prog = main if places is None else fluid.CompiledProgram(
        main).with_data_parallel(loss_name=outs[0].name, places=places)
    return [exe.run(prog, feed=feed, fetch_list=outs, scope=scope)
            for _ in range(steps)]


def test_dp_samplers_share_one_draw_and_rows_match():
    """At dp 2 against the plain Executor over two Adam steps: NCE
    (log-uniform), hsigmoid and the sampled softmax give dp 1's costs (one
    sampled set for the whole batch: every rank draws rank 0's), and the
    match ops their rows."""
    def build():
        x = tlayers.data("x", shape=[6], dtype="float32")
        y = tlayers.data("y", shape=[1], dtype="int64")
        q = tlayers.data("q", shape=[3, 4], dtype="float32")
        t = tlayers.data("t", shape=[5, 4], dtype="float32")
        ql = tlayers.data("ql", shape=[1], dtype="int64")
        img = tlayers.data("img", shape=[2, 6, 5], dtype="float32")
        ids = tlayers.data("ids", shape=[3], dtype="int64")
        nodes = tlayers.data("nodes", shape=[6, 4], dtype="float32")
        edges = tlayers.data("edges", shape=[5, 2], dtype="int64")
        costs = [tlayers.mean(tlayers.nce(x, y, num_total_classes=40,
                                          num_neg_samples=9,
                                          sampler="log_uniform")),
                 tlayers.mean(tlayers.hsigmoid(x, y, num_classes=40)),
                 tlayers.mean(tlayers.sampled_softmax_with_cross_entropy(
                     tlayers.fc(x, size=40), y, num_samples=11))]
        mm, _ = tlayers.match_matrix_tensor(q, t, channel_num=2,
                                            x_length=ql)
        pooled = tlayers.sequence_topk_avg_pooling(mm, topks=[1, 2],
                                                   channel_num=2)
        vc = tlayers.var_conv_2d(img, None, None, input_channel=2,
                                 output_channel=3, filter_size=3, stride=2)
        sc = tlayers.sequence_scatter(x, ids, tlayers.slice(
            x, [1], [0], [3]))
        tc = tlayers.tree_conv(nodes, edges, output_size=3, max_depth=2)
        total = costs[0] + costs[1] + costs[2] + tlayers.mean(pooled) + \
            tlayers.mean(vc) + tlayers.mean(sc) + tlayers.mean(tc)
        fluid.optimizer.AdamOptimizer(1e-2).minimize(total)
        return [total] + costs + [pooled, vc, sc, tc]

    edges = np.zeros((8, 5, 2), np.int64)
    edges[:, :3] = [[1, 2], [1, 3], [2, 4]]
    edges[5, 1] = 0
    feed = {"x": _r(8, 6), "y": RS.randint(0, 40, (8, 1)).astype(np.int64),
            "q": _r(8, 3, 4), "t": _r(8, 5, 4),
            "ql": RS.randint(1, 4, (8, 1)).astype(np.int64),
            "img": _r(8, 2, 6, 5),
            "ids": RS.randint(0, 6, (8, 3)).astype(np.int64),
            "nodes": _r(8, 6, 4), "edges": edges}
    want = _dp_run(build, feed, None)
    got = _dp_run(build, feed, [CPU] * 2)
    for g, w in zip(got, want):
        for k, (a, b) in enumerate(zip(g, w)):
            close(a, b, rtol=DP_TOL, name=str(k))


@pytest.mark.parametrize("layer", [
    lambda L, x, n: L.match_matrix_tensor(x, x, channel_num=2,
                                          x_length=n)[0],
    lambda L, x, n: L.sequence_topk_avg_pooling(
        L.reshape(x, [-1, 1, 3, 4]), col=n, topks=[1])])
def test_dp_replicated_lengths_beside_sharded_rows_refuse(layer):
    """A lengths tensor that stays replicated (a constant of the
    Program) while the data is dp-sharded would not line up with a
    rank's rows: at dp 2 the op refuses, naming itself; at dp 1 it
    runs."""
    def build():
        x = tlayers.data("x", shape=[3, 4], dtype="float32")
        n = tlayers.assign(np.full(8, 2, np.int64))
        return [tlayers.mean(layer(tlayers, x, n))]
    feed = {"x": _r(8, 3, 4)}
    with pytest.raises(NotImplementedError, match="replicated"):
        _dp_run(build, feed, [CPU] * 2, steps=1)
    _dp_run(build, feed, [CPU], steps=1)
