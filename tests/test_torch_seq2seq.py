"""The Transformer's slice of the port against the JAX package, on the CPU:
its ops (``one_hot``, ``label_smooth``, ``add_position_encoding``,
``sequence_mask``), beam search, and ``models/transformer.py``.

Op twins feed the same numpy inputs to the JAX op and the port's, and
hold the outputs and, where the op is differentiable, the gradients of
one seeded cotangent (``jax.grad`` against ``torch.autograd.grad``).
They include twins of ``tests/ops/test_op_numerics.py:317`` (one_hot),
``tests/ops/test_uncovered_ops_r4.py:58`` (position encoding against the
reference loop) and ``:183`` (label smooth),
``tests/ops/test_uncovered_ops_r4b.py:203,214`` (sequence_mask), and of
the four tests of ``tests/api/test_beam_search_golden.py``, each run
through both packages' Programs and Executors. The model twins: the
tiny Transformer of ``tests/models/test_model_zoo.py:147`` trains (the
twin of ``:157``), and two Adam steps on a batch whose lengths fall
short of max_len (so that the padding biases and the masked loss bite)
match the JAX Executor's losses, token counts and @GRADs from one
carried-over scope. The dp twins hold ``sequence_mask``'s data-max width
and ``beam_search``'s ParentIdx under ``with_data_parallel`` against dp
1. Tolerances are stated beside each constant, with what this file's
runs measured.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu import layers as jlayers
from paddle_tpu.core import unique_name as jun
from paddle_tpu.core.executor import Scope as JScope, scope_guard as jguard
from paddle_tpu.models import transformer as jtf
from paddle_tpu.ops import _REGISTRY as JREG

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.core import unique_name as tun
from paddle_tpu_torch.models import transformer as ttf
from paddle_tpu_torch.ops import _REGISTRY as TREG
from paddle_tpu_torch.ops.cuda import flash as cflash

CPU = fluid.CPUPlace()
# f32 op twins: the same formula in both packages, apart from XLA's and
# torch's transcendental functions (measured: label_smooth exact,
# add_position_encoding 6.0e-8 at T 5 and 2.4e-7 at D 2 and T 64, its
# gradient exact)
OP_RTOL, OP_ATOL = 1e-6, 2e-6
# The tiny Transformer, two Adam(1e-3) steps from one scope: losses
# within 1e-6 relative (measured 1.1e-7, then 3.6e-7), token counts
# exact, each @GRAD within 1e-5 of the step's largest @GRAD in absolute
# terms (measured 3.7e-7 and 5.7e-7 of it: 6.0e-8 against 0.159, 5.6e-8
# against 0.098). Its 12 steps on the full-length batch end at 0.717x
# the first loss. Relative to a
# tensor's own scale the key projection's bias is no test: its exact
# gradient is 0 (a per-query constant added to every score), so both
# packages give rounding noise there.
TF_LOSS_RTOL = 1e-6
TF_GRAD_TOL = 1e-5
# test_model_zoo.py:157's bar: the last of 12 losses below 0.8x the first
TRAIN_MARGIN = 0.8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_bert.py: concurrent pytest workers oversubscribe the
    CPU otherwise)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the op harness: one op of each package on the same numpy inputs
# ---------------------------------------------------------------------------

class _JCtx:
    """The JAX op's context: inputs by slot, attrs."""

    def __init__(self, ins, attrs):
        self._ins, self._attrs = ins, attrs
        self.is_test = False

    def in_(self, slot, default=None):
        return self._ins.get(slot, default)

    def in_list(self, slot):
        v = self._ins.get(slot, [])
        return v if isinstance(v, list) else [v]

    def has_in(self, slot):
        return slot in self._ins

    def attr(self, name, default=None):
        return self._attrs.get(name, default)


class _TCtx(_JCtx):
    """The port op's context on the CPU, outside the dp walk."""
    device = torch.device("cpu")
    dp_rank = None

    def wants(self, slot):
        return True


def _as(v, conv):
    return [conv(e) for e in v] if isinstance(v, list) else conv(v)


def op_twin(op, ins, attrs, slot, grad=(), seed=0):
    """Run `op` of both packages on `ins` ({slot: array or list of
    arrays}) and return (JAX's output, the port's, {input slot: (JAX's
    gradient, the port's)}) as numpy, the gradients of the sum of the
    output times a seeded cotangent with respect to the slots in
    `grad`."""
    jins = {k: _as(v, jnp.asarray) for k, v in ins.items()}
    jout = JREG[op](_JCtx(jins, attrs))[slot]
    tins = {k: _as(v, lambda a, g=(k in grad): torch.tensor(
        a, requires_grad=g and np.issubdtype(a.dtype, np.floating)))
        for k, v in ins.items()}
    tout = TREG[op](_TCtx(tins, attrs))[slot]
    grads = {}
    if grad:
        cot = np.asarray(np.random.RandomState(seed).randn(
            *np.shape(jout)), np.float32)

        def f(*xs):
            j2 = dict(jins, **dict(zip(grad, xs)))
            return jnp.sum(JREG[op](_JCtx(j2, attrs))[slot] * cot)

        jg = jax.grad(f, argnums=tuple(range(len(grad))))(
            *[jins[k] for k in grad])
        leaves = [t for k in grad for t in _as_list(tins[k])]
        tg = torch.autograd.grad((tout * torch.from_numpy(cot)).sum(),
                                 leaves)
        it = iter(tg)
        for k, g in zip(grad, jg):
            n = len(_as_list(tins[k]))
            mine = [next(it).numpy() for _ in range(n)]
            grads[k] = (_as(list(g) if isinstance(g, (list, tuple))
                            else g, np.asarray),
                        mine if isinstance(tins[k], list) else mine[0])
    return np.asarray(jout), tout.detach().numpy(), grads


def _as_list(v):
    return v if isinstance(v, list) else [v]


def assert_twin(jout, tout, grads, rtol=OP_RTOL, atol=OP_ATOL):
    assert tout.shape == jout.shape, (tout.shape, jout.shape)
    np.testing.assert_allclose(tout, jout, rtol=rtol, atol=atol)
    for k, (jg, tg) in grads.items():
        for a, b in zip(_as_list(tg), _as_list(jg)):
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=k)


def run_layers(build, feeds):
    """build(pkg layers, data vars) -> output var(s), built and run in
    both packages on `feeds`: (JAX's fetches, the port's) as numpy."""
    outs = []
    for pkg, lay, un, guard, scope in (
            (jfluid, jlayers, jun, jguard, JScope()),
            (fluid, tlayers, tun, fluid.scope_guard, fluid.Scope())):
        main, startup = pkg.Program(), pkg.Program()
        with un.guard(), pkg.program_guard(main, startup):
            xs = [lay.data(n, shape=list(a.shape), dtype=str(a.dtype),
                           append_batch_size=False)
                  for n, a in feeds.items()]
            res = build(lay, *xs)
        res = list(res) if isinstance(res, (list, tuple)) else [res]
        exe = pkg.Executor(CPU) if pkg is fluid else pkg.Executor()
        with guard(scope):
            exe.run(startup)
            outs.append([np.asarray(v) for v in
                         exe.run(main, feed=dict(feeds), fetch_list=res)])
    return outs


# ---------------------------------------------------------------------------
# op twins
# ---------------------------------------------------------------------------

def test_one_hot_through_both_executors():
    """test_op_numerics.py:317: ids (2, 1) -> f32 (2, 5), the trailing 1
    squeezed away; equal to JAX's and to the golden."""
    idx = np.array([[1], [3]], np.int64)
    (j,), (t,) = run_layers(lambda L, v: L.one_hot(v, depth=5),
                            {"idx": idx})
    golden = np.zeros((2, 5), np.float32)
    golden[0, 1] = golden[1, 3] = 1
    assert t.dtype == np.float32
    np.testing.assert_array_equal(t, golden)
    np.testing.assert_array_equal(t, j)


def test_one_hot_out_of_range_row_is_zero():
    """An id outside [0, depth) gives a row of zeros in both packages
    (jax.nn.one_hot's; F.one_hot would raise)."""
    x = np.array([[0, 4, -1], [7, 2, 3]], np.int64)
    j, t, _ = op_twin("one_hot", {"X": x}, {"depth": 5}, "Out")
    assert t.shape == (2, 3, 5)
    np.testing.assert_array_equal(t, j)
    assert t[0, 2].sum() == 0 and t[1, 0].sum() == 0


@pytest.mark.parametrize("prior", [False, True])
def test_label_smooth_formula_and_grad(prior):
    """test_uncovered_ops_r4.py:183: 0.8 x + 0.2 / 4, and with PriorDist
    0.8 x + 0.2 prior; the gradient with respect to X and PriorDist."""
    x = np.eye(4, dtype="float32")[None].repeat(2, 0)
    ins = {"X": x}
    pd = np.array([0.4, 0.3, 0.2, 0.1], np.float32)
    if prior:
        ins["PriorDist"] = pd
    j, t, g = op_twin("label_smooth", ins, {"epsilon": 0.2}, "Out",
                      grad=tuple(ins))
    want = 0.8 * x + 0.2 * (pd if prior else 1 / 4)
    np.testing.assert_allclose(t, want, rtol=1e-6)
    assert_twin(j, t, g)


def _position_loop(x, alpha, beta):
    """add_position_encoding_op.h:63-76's triple loop (the JAX test's
    golden)."""
    b, t, d = x.shape
    half = d // 2
    want = np.zeros_like(x)
    for i in range(b):
        for j in range(t):
            for k in range(half):
                val = j / np.power(10000.0, k / (half - 1)) \
                    if half > 1 else j
                want[i, j, k] = x[i, j, k] * alpha + np.sin(val) * beta
                want[i, j, half + k] = (x[i, j, half + k] * alpha
                                        + np.cos(val) * beta)
            if d % 2:
                want[i, j, d - 1] = x[i, j, d - 1] * alpha
    return want


@pytest.mark.parametrize("t,d", [(5, 8), (6, 7), (4, 2), (64, 16)],
                         ids=["loop", "odd_d", "d2", "t64"])
def test_add_position_encoding(t, d):
    """test_uncovered_ops_r4.py:58 at (5, 8), then an odd D (the last
    column zero-padded), D 2 (half 1: the encoding is the position) and
    T 64: the reference loop, JAX's output and gradient."""
    x = np.random.RandomState(0).randn(2, t, d).astype("float32")
    alpha, beta = 0.7, 1.3
    j, tt, g = op_twin("add_position_encoding", {"X": x},
                       {"alpha": alpha, "beta": beta}, "Out", grad=("X",))
    np.testing.assert_allclose(tt, _position_loop(x, alpha, beta),
                               rtol=1e-5, atol=1e-5)
    assert_twin(j, tt, g)


def test_sequence_mask_values_and_dtype():
    """test_uncovered_ops_r4b.py:203: y[i][j] = j < x[i]; out_dtype int64
    stays int64 in the port (the JAX package narrows it to int32 on the
    device)."""
    x = np.array([0, 2, 3, 5], np.int64)
    j, t, _ = op_twin("sequence_mask", {"X": x},
                      {"maxlen": 6, "out_dtype": "int64"}, "Y")
    ref = (np.arange(6)[None, :] < x[:, None]).astype(np.int64)
    np.testing.assert_array_equal(t, ref)
    np.testing.assert_array_equal(t, j)
    assert t.dtype == np.int64 and j.dtype == np.int32


def test_sequence_mask_maxlen_defaults_to_data_max():
    """test_uncovered_ops_r4b.py:214: maxlen -1 takes the longest length,
    and so does the layer without maxlen through the port's Executor
    (the JAX Executor cannot: it traces the step under jit, where the
    width may not depend on the data; its op runs eagerly here)."""
    x = np.array([1, 4, 2], np.int64)
    j, t, _ = op_twin("sequence_mask", {"X": x},
                      {"maxlen": -1, "out_dtype": "float32"}, "Y")
    assert t.shape == (3, 4)
    np.testing.assert_allclose(t.sum(axis=1), [1, 4, 2])
    np.testing.assert_array_equal(t, j)
    (layer,) = _port_dp(lambda L, v: L.sequence_mask(v, dtype="float32"),
                        {"x": x}, None)
    np.testing.assert_array_equal(layer, j)


def test_attention_bias_is_exactly_zero_where_kept():
    """The Transformer's bias, scale(mask, 1e9, -1e9), is exactly 0 at
    kept positions and -1e9 at padded ones."""
    lens = np.array([[3], [5]], np.int64)

    def build(L, v):
        mask = L.sequence_mask(v, maxlen=5, dtype="float32")
        return L.scale(L.reshape(mask, shape=[-1, 1, 1, 5]), scale=1e9,
                       bias=-1e9)

    (j,), (t,) = run_layers(build, {"lens": lens})
    want = np.where(np.arange(5)[None, :] < lens, 0.0, -1e9)
    np.testing.assert_array_equal(t.reshape(2, 5), want)
    np.testing.assert_array_equal(t, j)


# ---------------------------------------------------------------------------
# beam search: twins of tests/api/test_beam_search_golden.py
# ---------------------------------------------------------------------------

def _step(probs, pre_scores, pre_ids, k, end_id):
    def build(L, s, ps, pi):
        return L.beam_search(pi, ps, None, s, beam_size=k, end_id=end_id,
                             return_parent_idx=True)

    return run_layers(build, {"s": probs, "ps": pre_scores, "pi": pre_ids})


def _same(jax_outs, port_outs):
    for a, b in zip(jax_outs, port_outs):
        np.testing.assert_allclose(b, a, rtol=1e-6)


def test_beam1_equals_greedy():
    """test_beam_search_golden.py:44."""
    rng = np.random.RandomState(0)
    b, v = 3, 7
    probs = rng.dirichlet(np.ones(v), size=b).astype(np.float32)
    jo, (ids, scores, parent) = _step(
        probs, np.zeros((b, 1), np.float32), np.full((b, 1), -1, np.int64),
        k=1, end_id=0)
    np.testing.assert_array_equal(ids.reshape(b), probs.argmax(-1))
    np.testing.assert_allclose(scores.reshape(b), np.log(probs.max(-1)),
                               rtol=1e-5)
    _same(jo, (ids, scores, parent))


def test_topk_over_all_continuations():
    """test_beam_search_golden.py:56: top 2 of the 2 x 3 accumulated
    candidates, parents in flat (batch x K + beam) form."""
    probs = np.array([[0.7, 0.2, 0.1], [0.1, 0.1, 0.8]], np.float32)
    pre = np.array([[np.log(0.6)], [np.log(0.4)]], np.float32)
    jo, (ids, scores, parent) = _step(probs, pre,
                                      np.full((2, 1), -1, np.int64),
                                      k=2, end_id=9)
    np.testing.assert_array_equal(ids.reshape(-1), [0, 2])
    np.testing.assert_allclose(scores.reshape(-1), np.log([0.42, 0.32]),
                               rtol=1e-5)
    np.testing.assert_array_equal(parent.reshape(-1), [0, 1])
    assert ids.dtype == np.int64 and parent.dtype == np.int32
    _same(jo, (ids, scores, parent))


def test_finished_beam_freezes_score_and_slot():
    """test_beam_search_golden.py:72: a beam whose pre_id is <end>
    proposes only (<end>, its score)."""
    end_id = 2
    probs = np.array([[0.5, 0.3, 0.2], [0.9, 0.05, 0.05]], np.float32)
    pre = np.array([[np.log(0.9)], [np.log(0.8)]], np.float32)
    pre_ids = np.array([[end_id], [1]], np.int64)
    jo, (ids, scores, parent) = _step(probs, pre, pre_ids, k=2,
                                      end_id=end_id)
    np.testing.assert_allclose(scores.reshape(-1), np.log([0.9, 0.72]),
                               rtol=1e-5)
    np.testing.assert_array_equal(ids.reshape(-1), [end_id, 0])
    np.testing.assert_array_equal(parent.reshape(-1), [0, 1])
    _same(jo, (ids, scores, parent))


def test_decode_backtracks_parents():
    """test_beam_search_golden.py:89: (T 3, B 1, K 2) with a beam switch
    at t 2; lane 0 follows its parent chain."""
    ids = np.array([[[5, 6]], [[7, 8]], [[9, 4]]], np.int64)
    parents = np.array([[[0, 1]], [[0, 1]], [[1, 0]]], np.int64)
    scores = np.array([[1.0, 0.5]], np.float32)

    def build(L, i, p, s):
        return L.beam_search_decode(i, p, s, beam_size=2, end_id=0)

    (jseq, jsc), (seq, sc) = run_layers(build, {"i": ids, "p": parents,
                                                "sc": scores})
    np.testing.assert_array_equal(seq[0, 0], [6, 8, 9])
    np.testing.assert_array_equal(seq[0, 1], [5, 7, 4])
    np.testing.assert_array_equal(seq, jseq)
    np.testing.assert_array_equal(sc, jsc)


def test_ties_keep_lax_top_k_order():
    """Equal candidates are selected lower index first, as lax.top_k
    orders them (torch.topk does not): uniform probabilities over 6
    tokens, K 3, from equal scores, in both packages."""
    probs = np.full((6, 6), 1 / 6, np.float32)
    pre = np.zeros((6, 1), np.float32)
    jo, to = _step(probs, pre, np.full((6, 1), -1, np.int64), k=3,
                   end_id=9)
    np.testing.assert_array_equal(to[0].reshape(2, 3), [[0, 1, 2]] * 2)
    np.testing.assert_array_equal(to[2].reshape(2, 3), [[0, 0, 0],
                                                        [3, 3, 3]])
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(b, a)


# ---------------------------------------------------------------------------
# dp: the width of a data-max sequence_mask, beam_search's ParentIdx
# ---------------------------------------------------------------------------

def _port_dp(build, feed, places):
    """build(layers, *data vars) in the port, run on `feed` at dp
    len(places) (the plain Executor where `places` is None); the fetches
    as numpy."""
    main, startup = fluid.Program(), fluid.Program()
    with tun.guard(), fluid.program_guard(main, startup):
        xs = [tlayers.data(n, shape=list(a.shape), dtype=str(a.dtype),
                           append_batch_size=False)
              for n, a in feed.items()]
        res = build(tlayers, *xs)
    res = list(res) if isinstance(res, (list, tuple)) else [res]
    comp = main if places is None else fluid.CompiledProgram(
        main).with_data_parallel(places=places)
    exe = fluid.Executor(CPU)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    return [np.asarray(v) for v in exe.run(comp, feed=feed, fetch_list=res,
                                           scope=scope)]


def test_sequence_mask_data_max_under_dp_is_the_global_max():
    """maxlen None: under dp 2 the width is the global batch's longest
    length (4, on rank 0), not rank 1's own (2); the fetched mask
    equals dp 1's."""
    x = np.array([1, 4, 2, 2], np.int64)

    def build(L, v):
        return L.sequence_mask(v, dtype="float32")

    one = _port_dp(build, {"x": x}, [CPU])
    two = _port_dp(build, {"x": x}, [CPU] * 2)
    assert two[0].shape == (4, 4)
    np.testing.assert_array_equal(two[0], one[0])


def test_beam_search_parent_idx_under_dp_adds_the_rank_offset():
    """ParentIdx indexes the flattened global batch: at dp 2 rank 1's
    rows add its row offset, so the fetched ids, scores and parents
    equal dp 1's (and JAX's); a rank whose rows split a beam group
    refuses."""
    rng = np.random.RandomState(3)
    b, k, v = 4, 2, 5
    probs = rng.dirichlet(np.ones(v), size=b * k).astype(np.float32)
    pre = np.log(rng.dirichlet(np.ones(k), size=b)).reshape(b * k, 1) \
        .astype(np.float32)
    feed = {"s": probs, "ps": pre, "pi": np.full((b * k, 1), -1, np.int64)}

    def build(L, s, ps, pi):
        return L.beam_search(pi, ps, None, s, beam_size=k, end_id=9,
                             return_parent_idx=True)

    one = _port_dp(build, feed, [CPU])
    two = _port_dp(build, feed, [CPU] * 2)
    jo, _to = run_layers(build, feed)
    assert two[2].reshape(-1)[b * k // 2:].min() >= b * k // 2
    for a, c, j in zip(two, one, jo):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_allclose(a, j, rtol=1e-6)
    with pytest.raises(NotImplementedError, match="whole groups"):
        _port_dp(lambda L, s, ps, pi: L.beam_search(
            pi, ps, None, s, beam_size=4, end_id=9),
            {"s": probs[:4], "ps": pre[:4],
             "pi": np.full((4, 1), -1, np.int64)}, [CPU] * 2)


def test_beam_search_decode_under_dp_decodes_the_whole_batch():
    """Ids (T, B, K) split over T by the dp walk are concatenated back
    before the backtrack: the result is dp 1's."""
    rng = np.random.RandomState(4)
    t, b, k = 4, 3, 2
    feed = {"i": rng.randint(0, 9, (t, b, k)).astype(np.int64),
            "p": rng.randint(0, k, (t, b, k)).astype(np.int64),
            "sc": rng.randn(b, k).astype(np.float32)}

    def build(L, i, p, s):
        return L.beam_search_decode(i, p, s, beam_size=k, end_id=0)

    one = _port_dp(build, feed, [CPU])
    two = _port_dp(build, feed, [CPU] * 2)
    for a, c in zip(two, one):
        np.testing.assert_array_equal(a, c)


# ---------------------------------------------------------------------------
# the model: twins of tests/models/test_model_zoo.py:147,157
# ---------------------------------------------------------------------------

class _TinyCfg(ttf.ModelHyperParams):
    """test_model_zoo.py:147's tiny Transformer."""
    src_vocab_size = 64
    trg_vocab_size = 64
    d_model = 32
    d_inner_hid = 64
    n_head = 2
    n_layer = 2
    dropout = 0.0


MAX_LEN = 12


def _tf_program(pkg, un, tf):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with un.guard(), pkg.program_guard(main, startup):
        _feeds, loss, token_num = tf.build_train_net(cfg=_TinyCfg,
                                                     max_len=MAX_LEN)
        pkg.optimizer.AdamOptimizer(learning_rate=1e-3).minimize(loss)
    return main, startup, loss, token_num


def _tf_feed(padded):
    rs = np.random.RandomState(0)
    b = 4
    feed = {n: rs.randint(2, 64, (b, MAX_LEN)).astype(np.int64)
            for n in ("src_ids", "tgt_ids", "lbl_ids")}
    if padded:
        feed["src_len"] = np.array([[12], [7], [9], [3]], np.int64)
        feed["tgt_len"] = np.array([[10], [12], [5], [8]], np.int64)
    else:
        feed["src_len"] = np.full((b, 1), MAX_LEN, np.int64)
        feed["tgt_len"] = np.full((b, 1), MAX_LEN, np.int64)
    return feed


@pytest.fixture(scope="module")
def tiny_tf():
    """Both packages' tiny Transformer programs and JAX's startup values
    ({name: array})."""
    jmain, jstart, jloss, jtok = _tf_program(jfluid, jun, jtf)
    tmain, _ts, tloss, ttok = _tf_program(fluid, tun, ttf)
    scope = JScope()
    with jguard(scope):
        jfluid.Executor().run(jstart)
    init = {n: np.asarray(scope.get(n)) for n in scope.names()}
    return (jmain, jloss, jtok), (tmain, tloss, ttok), init


def _jscope(init):
    scope = JScope()
    for n, v in init.items():
        scope.set(n, jnp.asarray(v))
    return scope


def test_transformer_builds_jax_graph(tiny_tf):
    """The same op list (by type) and parameter names and shapes."""
    (jmain, _jl, _jt), (tmain, _tl, _tt), _init = tiny_tf
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    assert [(p.name, tuple(p.shape)) for p in tmain.all_parameters()] == \
        [(p.name, tuple(p.shape)) for p in jmain.all_parameters()]


def test_transformer_trains(tiny_tf):
    """test_model_zoo.py:157: 12 Adam(1e-3) steps on a fixed full-length
    batch; every loss finite, the last below 0.8x the first; the first
    loss equals JAX's from the same scope."""
    (jmain, jloss, _jt), (tmain, tloss, _tt), init = tiny_tf
    feed = _tf_feed(padded=False)
    scope = fluid.scope_from_numpy(init, "cpu")
    exe = fluid.Executor(CPU)
    losses = [float(exe.run(tmain, feed=feed, fetch_list=[tloss],
                            scope=scope)[0]) for _ in range(12)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * TRAIN_MARGIN, losses
    with jguard(_jscope(init)):
        first = float(np.asarray(jfluid.Executor().run(
            jmain, feed=feed, fetch_list=[jloss])[0]))
    np.testing.assert_allclose(losses[0], first, rtol=TF_LOSS_RTOL)


def test_transformer_steps_match_jax_under_padding(tiny_tf):
    """Two Adam steps on a batch with src/tgt lengths below max_len (the
    padding biases reach every attention, the loss masks the padded
    targets): each step's loss and token_num, and every @GRAD of both
    steps, against the JAX Executor's; the backward never takes the
    bias's gradient (flash_dbias is not called)."""
    (jmain, jloss, jtok), (tmain, tloss, ttok), init = tiny_tf
    feed = _tf_feed(padded=True)
    names = [p.name + "@GRAD" for p in tmain.all_parameters()]
    jscope, tscope = _jscope(init), fluid.scope_from_numpy(init, "cpu")
    jexe, texe = jfluid.Executor(), fluid.Executor(CPU)
    calls = cflash.DBIAS_CALLS
    for step in range(2):
        with jguard(jscope):
            want = [np.asarray(v) for v in jexe.run(
                jmain, feed=feed, fetch_list=[jloss, jtok] + names)]
        got = texe.run(tmain, feed=feed, fetch_list=[tloss, ttok] + names,
                       scope=tscope)
        np.testing.assert_allclose(got[0], want[0], rtol=TF_LOSS_RTOL)
        assert float(got[1]) == float(want[1]) == 35.0
        gmax = max(float(np.abs(g).max()) for g in want[2:])
        for name, a, b in zip(names, got[2:], want[2:]):
            err = float(np.abs(a - b).max())
            assert err <= TF_GRAD_TOL * gmax, (step, name, err, gmax)
    assert cflash.DBIAS_CALLS == calls


def test_transformer_bias_gradient_runs_only_when_asked():
    """The counter moves when a bias does require a gradient (the
    attention through ops/flash.py with a learnable bias) and not for
    one built from lengths."""
    from paddle_tpu_torch.ops.flash import flash_attention
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 2, 5, 8, generator=g, requires_grad=True)
               for _ in range(3))
    bias = torch.zeros(2, 1, 1, 5)
    calls = cflash.DBIAS_CALLS
    flash_attention(q, k, v, bias=bias, causal=True).sum().backward()
    assert cflash.DBIAS_CALLS == calls
    bias.requires_grad_(True)
    flash_attention(q, k, v, bias=bias, causal=True).sum().backward()
    assert cflash.DBIAS_CALLS == calls + 1 and bias.grad is not None
