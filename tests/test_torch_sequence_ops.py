"""The port's sequence ops against the JAX package, on the CPU: the
padded family of ``ops/sequence_ops.py`` (``sequence_pool``, ``_softmax``,
``_reverse``, ``_expand``, ``_pad``, ``_unpad``, ``_concat``, ``_slice``,
``_conv``, ``_enumerate``, ``_reshape``, ``_expand_as``, ``row_conv``,
``sequence_erase``), ``cos_sim``, ``im2sequence`` and
``fill_constant_batch_size_like``, with their layers.

Twins of the JAX package's own tests run the same layers through both
packages' Programs and Executors on the same numpy inputs and
parameters, and hold the port to the reference test's golden and to
JAX's output: ``tests/ops/test_uncovered_ops.py::
test_sequence_pool_softmax_reverse_with_lengths``,
``::test_sequence_family_batch4``, ``::test_row_conv_lookahead_formula``
and ``::test_cos_sim_formula``; ``tests/api/test_semantic_parity.py``'s
three ``sequence_expand`` tests; ``tests/api/test_layer_gaps_r4.py::
test_sequence_first_last_step``; ``tests/ops/test_audit_gap_ops.py::
test_sequence_erase_and_edit_distance_ignored_tokens``; and
``tests/ops/test_pool_index_ops.py``'s two ``im2sequence`` tests. Op
twins (``test_torch_seq2seq.op_twin``) hold each op's output and the
gradients of one seeded cotangent. The dp twins run the per-row ops at
dp 2 against dp 1 and check the refusals: a ragged ``sequence_expand``
and a replicated lengths tensor beside sharded data.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu import layers as jlayers
from paddle_tpu.core import unique_name as jun
from paddle_tpu.core.executor import Scope as JScope, scope_guard as jguard

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.core import unique_name as tun

from test_torch_seq2seq import _port_dp, assert_twin, op_twin

CPU = fluid.CPUPlace()
# f32 op twins: the same formula in both packages; the sums, the
# softmax's exp and the products are XLA's and torch's (measured at most
# 2.0e-7 of the compared value's largest entry, outputs and gradients;
# the integer ops and the copies exact)
OP_RTOL, OP_ATOL = 1e-6, 1e-6
# the reference tests' own bars against their numpy goldens
GOLD_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_bert.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RS = np.random.RandomState(33)


def twin(build, feed, sets=None, fetch=()):
    """build(pkg, layers) -> fetch var(s), built in each package's Program
    (under its unique_name guard) and run on `feed`: JAX's from its
    startup with `sets` ({name: array}) set over it, the port's from that
    scope carried over (``scope_from_numpy``) after its own startup.
    `fetch` adds names (e.g. 'x@GRAD'). Returns (JAX's fetches, the
    port's, the carried scope) as numpy."""
    progs = []
    for pkg, lay, un in ((jfluid, jlayers, jun), (fluid, tlayers, tun)):
        main, startup = pkg.Program(), pkg.Program()
        with un.guard(), pkg.program_guard(main, startup):
            res = build(pkg, lay)
        res = list(res) if isinstance(res, (list, tuple)) else [res]
        progs.append((main, startup, res + list(fetch)))
    (jmain, jstart, jres), (tmain, tstart, tres) = progs
    scope = JScope()
    with jguard(scope):
        exe = jfluid.Executor()
        exe.run(jstart)
        for n, v in (sets or {}).items():
            scope.set(n, jnp.asarray(v))
        init = {n: np.array(scope.get(n)) for n in scope.names()}
        jo = [np.asarray(v) for v in exe.run(jmain, feed=dict(feed),
                                             fetch_list=jres)]
    tscope = fluid.Scope()
    exe = fluid.Executor(CPU)
    exe.run(tstart, scope=tscope)
    fluid.scope_from_numpy(init, "cpu", tscope)
    to = [np.asarray(v) for v in exe.run(tmain, feed=dict(feed),
                                         fetch_list=tres, scope=tscope)]
    return jo, to, init


def both(build, feed, sets=None, fetch=()):
    """twin() without the scope: (JAX's fetches, the port's)."""
    return twin(build, feed, sets, fetch)[:2]


def grad_close(got, want, tol, name="", scale=None):
    """|got - want| within `tol` of `scale` (by default want's largest
    entry): a gradient's check, relative to its own scale."""
    scale = float(np.abs(want).max()) if scale is None else scale
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= tol * scale, (name, err, scale)


def _same(jo, to, rtol=OP_RTOL, atol=OP_ATOL):
    for a, b in zip(jo, to):
        assert b.shape == a.shape, (b.shape, a.shape)
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)


def _x(shape):
    return RS.randn(*shape).astype(np.float32)


# ---------------------------------------------------------------------------
# twins of the JAX package's tests
# ---------------------------------------------------------------------------

def test_sequence_pool_softmax_reverse_with_lengths():
    """test_uncovered_ops.py: AVERAGE pool, reverse and softmax within
    the lengths, 0 past them."""
    x, x1 = _x((2, 4, 3)), _x((2, 4))
    lens = np.array([3, 2], np.int32)

    def build(pkg, L):
        xv = L.data("x", shape=[4, 3], dtype="float32")
        lv = L.data("len", shape=[], dtype="int32")
        x1v = L.data("x1", shape=[4], dtype="float32")
        return [L.sequence_pool(xv, "average", length=lv),
                L.sequence_reverse(xv, length=lv),
                L.sequence_softmax(x1v, length=lv)]

    jo, to = both(build, {"x": x, "len": lens, "x1": x1})
    got_p, got_r, got_s = to
    for b, n in enumerate(lens):
        np.testing.assert_allclose(got_p[b], x[b, :n].mean(0),
                                   rtol=GOLD_RTOL)
        np.testing.assert_allclose(got_r[b, :n], x[b, :n][::-1], rtol=1e-6)
        e = np.exp(x1[b, :n] - x1[b, :n].max())
        np.testing.assert_allclose(got_s[b, :n], e / e.sum(), rtol=GOLD_RTOL)
        np.testing.assert_allclose(got_s[b, n:], 0.0, atol=1e-6)
    _same(jo, to)


def test_sequence_family_batch4():
    """test_uncovered_ops.py: concat / slice / unpad / enumerate /
    reshape formulas."""
    x, y = _x((2, 4, 3)), _x((2, 2, 3))
    lens = np.array([3, 2], np.int32)

    def build(pkg, L):
        xv = L.data("x", shape=[4, 3], dtype="float32")
        yv = L.data("y2", shape=[2, 3], dtype="float32")
        lv = L.data("len", shape=[], dtype="int32")
        return [L.sequence_concat([xv, yv]),
                L.sequence_slice(xv, offset=1, length=2),
                L.sequence_unpad(xv, length=lv),
                L.sequence_reshape(xv, new_dim=6)]

    jo, to = both(build, {"x": x, "y2": y, "len": lens})
    gc_, gs, gu, gr = to
    np.testing.assert_allclose(gc_, np.concatenate([x, y], axis=1),
                               rtol=1e-6)
    np.testing.assert_allclose(gs, x[:, 1:3], rtol=1e-6)
    want_unp = x.copy()
    want_unp[0, 3:] = 0
    want_unp[1, 2:] = 0
    np.testing.assert_allclose(gu, want_unp, rtol=1e-6)
    np.testing.assert_allclose(gr, x.reshape(2, 2, 6), rtol=1e-6)
    _same(jo, to)

    ids = np.array([[1, 2, 3, 4]], np.int64)
    jo, to = both(lambda pkg, L: L.sequence_enumerate(
        L.data("ids", shape=[4], dtype="int64"), win_size=2, pad_value=0),
        {"ids": ids})
    np.testing.assert_array_equal(to[0][0], [[1, 2], [2, 3], [3, 4],
                                             [4, 0]])
    np.testing.assert_array_equal(to[0], jo[0])


def test_row_conv_lookahead_formula():
    """test_uncovered_ops.py: out[t] = sum_i w[i] x[t + i], zero past the
    end; and x's and w's gradients against JAX."""
    b, t, d, fut = 2, 5, 3, 3
    x = _x((b, t, d))
    w = _x((fut, d)) * 0.5

    def build(pkg, L):
        xv = L.data("x", shape=[t, d], dtype="float32")
        out = L.row_conv(xv, future_context_size=fut - 1,
                         param_attr=pkg.ParamAttr(name="rc_w"))
        pkg.append_backward(L.reduce_sum(L.elementwise_mul(out, out)))
        return out

    jo, to = both(build, {"x": x}, sets={"rc_w": w},
                  fetch=("rc_w@GRAD",))
    want = np.zeros_like(x)
    for i in range(fut):
        for tt in range(t):
            if tt + i < t:
                want[:, tt] += x[:, tt + i] * w[i]
    np.testing.assert_allclose(to[0], want, rtol=GOLD_RTOL, atol=1e-6)
    _same(jo, to)


def test_cos_sim_formula():
    """test_uncovered_ops.py: the cosine of each pair of rows."""
    a, b = _x((4, 6)), _x((4, 6))
    jo, to = both(lambda pkg, L: L.cos_sim(
        L.data("a", shape=[6], dtype="float32"),
        L.data("b", shape=[6], dtype="float32")), {"a": a, "b": b})
    want = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))
    np.testing.assert_allclose(to[0].ravel(), want, rtol=GOLD_RTOL)
    assert to[0].shape == (4, 1)
    _same(jo, to)


def _expand_param(pkg, L, name):
    """A (2, 1) parameter, set to [[1], [2]] through both()'s `sets`."""
    return L.create_parameter([2, 1], "float32",
                              attr=pkg.ParamAttr(name=name))


def _data(L, name, shape, dtype="float32"):
    return L.data(name, shape=shape, dtype=dtype, append_batch_size=False)


X12 = np.array([[1.0], [2.0]], np.float32)


def test_sequence_expand_ragged_counts():
    """test_semantic_parity.py: out row j copies x[i] where j falls in
    y's i-th segment; d sum / d x counts the copies."""
    def build(pkg, L):
        p = _expand_param(pkg, L, "sx")
        y = _data(L, "y", [5, 1])
        ylen = _data(L, "ylen", [2], "int32")
        out = L.sequence_expand(p, y, y_length=ylen)
        pkg.append_backward(L.reduce_sum(out))
        return out

    jo, to = both(build, {"y": np.zeros((5, 1), np.float32),
                          "ylen": np.array([2, 3], np.int32)},
                  sets={"sx": X12}, fetch=("sx@GRAD",))
    np.testing.assert_allclose(to[0].reshape(-1), [1, 1, 2, 2, 2])
    np.testing.assert_allclose(to[1].reshape(-1), [2, 3])
    _same(jo, to, 0.0, 0.0)


def test_sequence_expand_uniform_and_static():
    """test_semantic_parity.py: uniform 6 // 2 and static_repeat 2."""
    def build(pkg, L):
        x = _data(L, "x", [2, 1])
        y = _data(L, "y", [6, 1])
        return [L.sequence_expand(x, y),
                L.sequence_expand(x, y, static_repeat=2)]

    jo, to = both(build, {"x": np.array([[1.0], [2.0]], np.float32),
                          "y": np.zeros((6, 1), np.float32)})
    np.testing.assert_allclose(to[0].reshape(-1), [1, 1, 1, 2, 2, 2])
    np.testing.assert_allclose(to[1].reshape(-1), [1, 1, 2, 2])
    _same(jo, to, 0.0, 0.0)


def test_sequence_expand_pads_tail_and_rejects_nondivisible():
    """test_semantic_parity.py: rows past sum(y_length) are 0 (and take
    no gradient); a uniform expand of 5 rows over 2 raises."""
    def build(pkg, L):
        p = _expand_param(pkg, L, "sx2")
        y = _data(L, "y", [5, 1])
        ylen = _data(L, "ylen", [2], "int32")
        out = L.sequence_expand(p, y, y_length=ylen)
        pkg.append_backward(L.reduce_sum(out))
        return out

    jo, to = both(build, {"y": np.zeros((5, 1), np.float32),
                          "ylen": np.array([2, 1], np.int32)},
                  sets={"sx2": X12}, fetch=("sx2@GRAD",))
    np.testing.assert_allclose(to[0].reshape(-1), [1, 1, 2, 0, 0])
    np.testing.assert_allclose(to[1].reshape(-1), [2, 1])
    _same(jo, to, 0.0, 0.0)
    main, startup = fluid.Program(), fluid.Program()
    with tun.guard(), fluid.program_guard(main, startup):
        x2 = _data(tlayers, "x2", [2, 1])
        y2 = _data(tlayers, "y2", [5, 1])
        out2 = tlayers.sequence_expand(x2, y2)
    exe = fluid.Executor(CPU)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(Exception, match="not divisible"):
        exe.run(main, feed={"x2": np.ones((2, 1), np.float32),
                            "y2": np.zeros((5, 1), np.float32)},
                fetch_list=[out2], scope=scope)


def test_sequence_first_last_step():
    """test_layer_gaps_r4.py: the first step, and the last step within
    each row's length."""
    xv = np.arange(24, dtype=np.float32).reshape(2, 4, 3)
    lens = np.array([[2], [4]], np.int64)

    def build(pkg, L):
        x = L.data("x", [4, 3], append_batch_size=True)
        ln = L.data("len", [1], dtype="int64", append_batch_size=True)
        return [L.sequence_first_step(x, length=ln),
                L.sequence_last_step(x, length=ln)]

    jo, to = both(build, {"x": xv, "len": lens})
    f, last = to
    np.testing.assert_allclose(f, xv[:, 0])
    np.testing.assert_allclose(last[0], xv[0, 1])
    np.testing.assert_allclose(last[1], xv[1, 3])
    _same(jo, to, 0.0, 0.0)


def _op_layer(helper_cls, op_type, ins, outs_spec, attrs):
    helper = helper_cls(op_type)
    outs = {slot: helper.create_variable_for_type_inference(dtype)
            for slot, dtype in outs_spec.items()}
    helper.append_op(op_type, ins, outs, attrs)
    return outs


def test_sequence_erase_and_edit_distance_ignored_tokens():
    """test_audit_gap_ops.py: erasing token 5 compacts each row (new
    lengths 3 and 1), and through edit_distance's ignored_tokens it makes
    hyp equal ref."""
    from paddle_tpu.core.layer_helper import LayerHelper as JHelper
    from paddle_tpu_torch.core.layer_helper import LayerHelper as THelper
    x = np.array([[1, 5, 2, 5, 3, 0], [5, 5, 4, 0, 0, 0]], np.int64)
    lens = np.array([[5], [3]], np.int32)

    def build(pkg, L):
        helper = JHelper if pkg is jfluid else THelper
        xv = L.data("x", shape=[6], dtype="int64")
        lv = L.data("len", shape=[1], dtype="int32")
        res = _op_layer(helper, "sequence_erase", {"X": xv, "Length": lv},
                        {"Out": "int64", "Length": "int64"},
                        {"tokens": [5]})
        return [res["Out"], res["Length"]]

    jo, to = both(build, {"x": x, "len": lens})
    np.testing.assert_array_equal(to[0], [[1, 2, 3, 0, 0, 0],
                                          [4, 0, 0, 0, 0, 0]])
    np.testing.assert_array_equal(to[1].ravel(), [3, 1])
    assert to[1].dtype == np.int64
    _same(jo, to, 0.0, 0.0)

    def build_ed(pkg, L):
        hv = L.data("h", shape=[4], dtype="int64")
        rv = L.data("r", shape=[4], dtype="int64")
        hl = L.data("hl", shape=[1], dtype="int32")
        rl = L.data("rl", shape=[1], dtype="int32")
        return L.edit_distance(hv, rv, normalized=False, ignored_tokens=[5],
                               input_length=hl, label_length=rl)[0]

    jo, to = both(build_ed, {"h": np.array([[1, 5, 2, 3]], np.int64),
                             "r": np.array([[1, 2, 3, 0]], np.int64),
                             "hl": np.array([[4]], np.int32),
                             "rl": np.array([[3]], np.int32)})
    assert float(to[0].ravel()[0]) == 0.0
    _same(jo, to, 0.0, 0.0)


def test_im2sequence_reference_example():
    """test_pool_index_ops.py: the reference docstring's worked example
    (2x2x3x3 input, 2x2 filter, stride 1)."""
    x = np.array(
        [[[[6., 2., 1.], [8., 3., 5.], [0., 2., 6.]],
          [[2., 4., 4.], [6., 3., 0.], [6., 4., 7.]]],
         [[[6., 7., 1.], [5., 7., 9.], [2., 4., 8.]],
          [[1., 2., 1.], [1., 3., 5.], [9., 0., 8.]]]], np.float32)
    jo, to = both(lambda pkg, L: L.im2sequence(
        L.data("x", shape=[2, 3, 3], dtype="float32"), filter_size=[2, 2],
        stride=[1, 1], padding=[0, 0, 0, 0]), {"x": x})
    want = np.array(
        [[6., 2., 8., 3., 2., 4., 6., 3.],
         [2., 1., 3., 5., 4., 4., 3., 0.],
         [8., 3., 0., 2., 6., 3., 6., 4.],
         [3., 5., 2., 6., 3., 0., 4., 7.],
         [6., 7., 5., 7., 1., 2., 1., 3.],
         [7., 1., 7., 9., 2., 1., 3., 5.],
         [5., 7., 2., 4., 1., 3., 9., 0.],
         [7., 9., 4., 8., 3., 5., 0., 8.]], np.float32)
    np.testing.assert_allclose(to[0], want, rtol=1e-6)
    _same(jo, to, 0.0, 0.0)


def test_im2sequence_padded_strided():
    """test_pool_index_ops.py: stride (2, 2), padding (1, 0, 1, 0)
    against a numpy sliding-window golden."""
    n, c, h, w = 2, 3, 5, 6
    k, s, p = (2, 3), (2, 2), (1, 0, 1, 0)
    x = _x((n, c, h, w))
    jo, to = both(lambda pkg, L: L.im2sequence(
        L.data("x", shape=[c, h, w], dtype="float32"), filter_size=list(k),
        stride=list(s), padding=list(p)), {"x": x})
    xp = np.pad(x, ((0, 0), (0, 0), (p[0], p[2]), (p[1], p[3])))
    oh = (xp.shape[2] - k[0]) // s[0] + 1
    ow = (xp.shape[3] - k[1]) // s[1] + 1
    rows = [xp[b, :, i * s[0]:i * s[0] + k[0], j * s[1]:j * s[1] + k[1]]
            .ravel() for b in range(n) for i in range(oh) for j in range(ow)]
    np.testing.assert_allclose(to[0], np.stack(rows), rtol=1e-6)
    _same(jo, to, 0.0, 0.0)


# ---------------------------------------------------------------------------
# op twins: outputs and gradients
# ---------------------------------------------------------------------------

LENS = np.array([5, 2, 0, 3], np.int64)


@pytest.mark.parametrize("pooltype", ["SUM", "AVERAGE", "SQRT", "MAX",
                                      "LAST", "FIRST"])
def test_sequence_pool_op(pooltype):
    """Each pool type over rows of lengths 5, 2, 0 and 3 (the empty row:
    MAX 0, LAST step 0), its output and dX against JAX; MaxIndex int64
    zeros."""
    x = _x((4, 5, 3))
    j, t, g = op_twin("sequence_pool", {"X": x, "Length": LENS},
                      {"pooltype": pooltype}, "Out", grad=("X",))
    assert_twin(j, t, g, OP_RTOL, OP_ATOL)
    if pooltype == "MAX":
        np.testing.assert_array_equal(t[2], 0.0)
    _j, idx, _g = op_twin("sequence_pool", {"X": x, "Length": LENS},
                          {"pooltype": pooltype}, "MaxIndex")
    assert idx.dtype == np.int64 and not idx.any()


@pytest.mark.parametrize("op,slot,attrs,data", [
    ("sequence_softmax", "Out", {}, (4, 5)),
    ("sequence_reverse", "Y", {}, (4, 5, 3)),
    ("sequence_unpad", "Out", {}, (4, 5, 3)),
    ("sequence_pad", "Out", {}, (4, 5, 3)),
])
def test_length_ops(op, slot, attrs, data):
    """The per-row ops over the lengths: outputs and dX against JAX."""
    assert_twin(*op_twin(op, {"X": _x(data), "Length": LENS}, attrs, slot,
                         grad=("X",)), OP_RTOL, OP_ATOL)


@pytest.mark.parametrize("ctx_len,start", [(3, None), (5, -1), (2, 0)])
def test_sequence_conv_op(ctx_len, start):
    """The context window, dX and dFilter against JAX; inside T the
    window reads the padding (the JAX semantics): with a row's padding
    changed, its outputs at the last valid step change too."""
    x = _x((2, 6, 4))
    w = _x((ctx_len * 4, 5))
    attrs = {"contextLength": ctx_len}
    if start is not None:
        attrs["contextStart"] = start
    j, t, g = op_twin("sequence_conv", {"X": x, "Filter": w}, attrs, "Out",
                      grad=("X", "Filter"))
    assert_twin(j, t, g, OP_RTOL, OP_ATOL)
    if ctx_len == 3:
        x2 = x.copy()
        x2[0, 4:] = 0.0                 # "padding" past a length of 4
        _j, t2, _g = op_twin("sequence_conv", {"X": x2, "Filter": w}, attrs,
                             "Out")
        assert np.abs(t2[0, 3] - t[0, 3]).max() > 0


def test_row_conv_enumerate_reshape_expand_as_ops():
    x = _x((3, 5, 4))
    assert_twin(*op_twin("row_conv", {"X": x, "Filter": _x((3, 4))}, {},
                         "Out", grad=("X", "Filter")), OP_RTOL, OP_ATOL)
    ids = RS.randint(0, 9, (3, 5)).astype(np.int64)
    j, t, _g = op_twin("sequence_enumerate", {"X": ids},
                       {"win_size": 3, "pad_value": -2}, "Out")
    np.testing.assert_array_equal(t, j)
    assert_twin(*op_twin("sequence_reshape", {"X": x}, {"new_dim": 2},
                         "Out", grad=("X",)), 0.0, 0.0)
    assert_twin(*op_twin("sequence_expand_as",
                         {"X": x[:, 0], "Y": np.zeros((3, 2), np.float32)},
                         {}, "Out", grad=("X",)), 0.0, 0.0)
    assert_twin(*op_twin("sequence_concat", {"X": [x, x[:, :2]]}, {}, "Out",
                         grad=("X",)), 0.0, 0.0)
    # a slice past the end clamps its start, as lax.dynamic_slice does
    j, t, _g = op_twin("sequence_slice", {"X": x},
                       {"static_offset": 4, "static_length": 3}, "Out")
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, x[:, 2:5])


def test_sequence_erase_op_without_lengths():
    ids = RS.randint(0, 4, (4, 7)).astype(np.int64)
    for slot in ("Out", "Length"):
        j, t, _g = op_twin("sequence_erase", {"X": ids},
                           {"tokens": [0, 3]}, slot)
        np.testing.assert_array_equal(t.reshape(j.shape), j)


def test_cos_sim_and_im2sequence_grads():
    x, y = _x((5, 4)), _x((5, 4))
    for ys in (y, y[:1]):
        for slot, grad in (("Out", ("X", "Y")), ("XNorm", ("X",)),
                           ("YNorm", ("Y",))):
            assert_twin(*op_twin("cos_sim", {"X": x, "Y": ys}, {}, slot,
                                 grad=grad), OP_RTOL, OP_ATOL)
    img = _x((2, 3, 5, 6))
    j, t, g = op_twin("im2sequence", {"X": img},
                      {"kernels": [2, 3], "strides": [2, 1],
                       "paddings": [1, 0, 0, 2]}, "Out", grad=("X",))
    assert_twin(j, t, g, OP_RTOL, OP_ATOL)
    _j, ln, _g = op_twin("im2sequence", {"X": img},
                         {"kernels": [2, 3], "strides": [2, 1],
                          "paddings": [1, 0, 0, 2]}, "Length")
    assert ln.dtype == np.int64 and (ln == t.shape[0] // 2).all()


def test_sequence_layers_default_full_length():
    """Without a length the layers use the whole width (a fill_constant
    of the static batch, or fill_constant_batch_size_like of a -1
    batch): both equal JAX's."""
    x = _x((3, 4, 2))

    def build(pkg, L):
        xs = L.data("xs", shape=[3, 4, 2], dtype="float32",
                    append_batch_size=False)
        xd = L.data("xd", shape=[4, 2], dtype="float32")
        return [L.sequence_pool(xs, "max"), L.sequence_last_step(xd),
                L.sequence_reverse(xd)]

    jo, to = both(build, {"xs": x, "xd": x})
    np.testing.assert_allclose(to[1], x[:, -1])
    np.testing.assert_allclose(to[2], x[:, ::-1])
    _same(jo, to)


# ---------------------------------------------------------------------------
# data parallelism
# ---------------------------------------------------------------------------

def test_sequence_ops_at_dp2_equal_dp1():
    """A rank's rows with its lengths: pool, softmax, reverse, conv,
    erase and a static_repeat / uniform expand at dp 2 equal dp 1."""
    x = _x((4, 5, 3))
    ids = RS.randint(0, 4, (4, 5)).astype(np.int64)
    feed = {"x": x, "len": LENS, "ids": ids}

    def build(L, xv, lv, iv):
        hid = L.sequence_conv(xv, num_filters=2, filter_size=3,
                              param_attr=fluid.ParamAttr(
                                  initializer=fluid.initializer.Constant(
                                      0.1)))
        return [L.sequence_pool(xv, "max", length=lv),
                L.sequence_pool(hid, "average", length=lv),
                L.sequence_softmax(L.reduce_sum(xv, dim=2), length=lv),
                L.sequence_reverse(xv, length=lv),
                L.sequence_expand(xv, xv, static_repeat=2),
                L.sequence_expand(lv, L.sequence_expand(
                    lv, lv, static_repeat=3)),
                L.edit_distance(iv, iv, input_length=lv,
                                label_length=lv)[0]]

    one = _port_dp(build, feed, [CPU])
    two = _port_dp(build, feed, [CPU] * 2)
    for a, b in zip(two, one):
        np.testing.assert_array_equal(a, b)


def test_ragged_expand_and_replicated_lengths_refuse_under_dp():
    """The ragged sequence_expand's segments do not line up with X's rows
    once split: it refuses at dp 2 (and runs at dp 1); so does a pool
    whose lengths are replicated beside sharded data."""
    x = _x((4, 3))
    feed = {"x": x, "y": np.zeros((6, 3), np.float32),
            "ylen": np.array([1, 2, 2, 1], np.int64)}

    def ragged(L, xv, yv, ylen):
        return L.sequence_expand(xv, yv, y_length=ylen)

    one = _port_dp(ragged, feed, [CPU])
    np.testing.assert_array_equal(one[0], np.repeat(x, [1, 2, 2, 1], 0))
    with pytest.raises(NotImplementedError, match="ragged form"):
        _port_dp(ragged, feed, [CPU] * 2)

    def replicated(L, xv, yv, ylen):
        lens = L.fill_constant([4], "int64", 2)
        return L.sequence_pool(L.unsqueeze(xv, [2]), "sum", length=lens)

    _port_dp(replicated, feed, [CPU])
    with pytest.raises(NotImplementedError, match="Length is replicated"):
        _port_dp(replicated, feed, [CPU] * 2)
