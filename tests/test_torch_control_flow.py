"""The port's control flow against the JAX package, on the CPU:
``ops/control_flow_ops.py`` (all 21 names), the comparison, logical and
reduce ops the constructs and the operators use, ``layers/
control_flow.py`` (``While``, ``cond``, ``case``, ``switch_case``,
``Switch``, ``IfElse``, ``StaticRNN``, ``while_loop``, ``Print``, the
tensor arrays), ``layers.py_func``, ``tensor_array_to_tensor`` and the
``Variable`` operators of ``layers/math_op_patch.py``.

Twins of the JAX package's tests build the same Program in both packages
(under each one's unique_name guard) and run it through both Executors
on the same numpy inputs, holding the port to the reference test's
closed-form answer and to JAX's output: the six tests of
``tests/api/test_control_flow.py``, the five of
``tests/ops/test_uncovered_ops_r4c.py`` on the arrays, the dense rule,
``py_func``, ``conditional_select`` / ``is_empty`` and
``tensor_array_sizes``, ``tests/ops/test_extended_ops.py::
test_while_loop``, and ``tests/api/test_surface_gap_ops.py::
test_tensor_array_to_tensor`` and ``::test_print_passthrough`` (the
printed text against JAX's, captured the same way). Cases of this
file's own: each patched operator (outputs and op types against JAX's),
a ``While`` inside a ``cond`` branch, a ``Print`` whose result is
dropped (it still prints), a sub-block op whose output only a later op
of the same sub-block reads, a ``Switch`` learning-rate schedule over
12 steps of the step counter, and op twins of the twelve comparison,
logical, reduce and floor-division ops. The dp twins run a ``While`` and
a ``cond`` whose bodies touch sharded rows under a replicated condition,
the ``Switch`` schedule and the reductions at dp 2 against dp 1, and
check the refusals: a sharded predicate, condition or ``Switch``
target, a ``StaticRNN`` fed a sharded time-major input.
"""

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

from test_torch_seq2seq import _port_dp, assert_twin, op_twin
from test_torch_sequence_ops import both, grad_close

CPU = fluid.CPUPlace()
# the ops and the constructs over them in f32: the same arithmetic in
# both packages (measured: the constructs' and the operators' outputs
# exact against JAX's, as is the w@GRAD of test_while_grad_flows); the
# reductions' mean and product XLA's and torch's (measured at most 3.8e-7
# of an output's largest entry, 1.3e-7 of a gradient's)
OP_RTOL, OP_ATOL = 1e-6, 1e-6
GRAD_TOL = 1e-4

PKGS = ((jfluid, jlayers, jun), (fluid, tlayers, tun))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_bert.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RS = np.random.RandomState(21)


def _build(pkg, L, un, build):
    main, startup = pkg.Program(), pkg.Program()
    with un.guard(), pkg.program_guard(main, startup):
        res = build(pkg, L)
    res = list(res) if isinstance(res, (list, tuple)) else [res]
    return main, startup, res


def _run_one(pkg, L, un, build, feed=None, steps=1):
    """build in `pkg`'s Program, run `steps` times from its own startup:
    the fetches of every run as numpy (one list a run)."""
    main, startup, res = _build(pkg, L, un, build)
    if pkg is fluid:
        exe, scope = fluid.Executor(CPU), fluid.Scope()
        exe.run(startup, scope=scope)
        return [[np.asarray(v) for v in exe.run(
            main, feed=dict(feed or {}), fetch_list=res, scope=scope)]
            for _ in range(steps)]
    exe, scope = jfluid.Executor(), JScope()
    with jguard(scope):
        exe.run(startup)
        return [[np.asarray(v) for v in exe.run(
            main, feed=dict(feed or {}), fetch_list=res)]
            for _ in range(steps)]


def _same(jo, to, rtol=OP_RTOL, atol=OP_ATOL):
    for a, b in zip(jo, to):
        assert b.shape == a.shape, (b.shape, a.shape)
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# twins of tests/api/test_control_flow.py
# ---------------------------------------------------------------------------

def _while_sum(pkg, L):
    T = L.tensor
    i = L.fill_constant((1,), "int64", 0)
    limit = L.fill_constant((1,), "int64", 10)
    acc = L.fill_constant((1,), "float32", 0.0)
    c = L.less_than(i, limit)
    w = L.While(c)
    with w.block():
        T.assign(acc + L.cast(i, "float32"), acc)
        L.increment(i, 1)
        L.less_than(i, limit, cond=c)
    return acc, i


def test_while_accumulate():
    jo, to = both(_while_sum, {})
    assert to[0][0] == 45.0 and to[1][0] == 10
    assert to[1].dtype == np.int64
    _same(jo, to)


@pytest.mark.parametrize("a_val,expect", [(3.0, 6.0), (7.0, 10.0)])
def test_cond_branches(a_val, expect):
    def build(pkg, L):
        a = L.fill_constant((1,), "float32", a_val)
        five = L.fill_constant((1,), "float32", 5.0)
        pred = L.less_than(a, five)
        return L.cond(pred, lambda: a * 2, lambda: five * 2)

    jo, to = both(build, {})
    assert to[0][0] == expect
    _same(jo, to)


def test_case_and_switch_case():
    def build(pkg, L):
        idx = L.fill_constant((), "int64", 1)
        return L.switch_case(idx, {
            0: lambda: L.fill_constant((1,), "float32", 10.0),
            1: lambda: L.fill_constant((1,), "float32", 20.0),
            2: lambda: L.fill_constant((1,), "float32", 30.0)})

    jo, to = both(build, {})
    assert to[0][0] == 20.0
    _same(jo, to)


def _cumsum_rnn(pkg, L):
    x = L.data("x", [4, 2, 3], append_batch_size=False)
    rnn = L.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        mem = rnn.memory(shape=[2, 3], value=0.0)
        new = mem + x_t
        rnn.update_memory(mem, new)
        rnn.step_output(new)
    return rnn()


def test_static_rnn_cumsum():
    x = np.arange(24).reshape(4, 2, 3).astype("float32")
    jo, to = both(_cumsum_rnn, {"x": x})
    np.testing.assert_allclose(to[0], np.cumsum(x, axis=0), rtol=1e-6)
    _same(jo, to)


def test_switch_lr_style():
    def build(pkg, L):
        T = L.tensor
        step = L.fill_constant((1,), "float32", 7.0)
        lr = T.create_global_var((1,), 0.0, "float32", persistable=True,
                                 name="lr")
        boundary = L.fill_constant((1,), "float32", 5.0)
        sw = L.Switch()
        with sw.block():
            with sw.case(L.less_than(step, boundary)):
                T.assign(L.fill_constant((1,), "float32", 1.0), lr)
            with sw.default():
                T.assign(L.fill_constant((1,), "float32", 0.1), lr)
        return lr

    jo, to = both(build, {})
    np.testing.assert_allclose(to[0], [0.1], rtol=1e-6)
    _same(jo, to)


def test_while_grad_flows():
    """The JAX test's program (no While on the loss path): w@GRAD of
    mean((x @ w)^2) against JAX's from one scope."""
    def build(pkg, L):
        x = L.data("x", [2, 2], append_batch_size=False)
        w = L.tensor.create_parameter(
            [2, 2], "float32", name="w_cf",
            default_initializer=pkg.initializer.ConstantInitializer(0.5))
        y = L.matmul(x, w)
        loss = L.reduce_mean(y * y)
        pkg.append_backward(loss)
        return loss

    jo, to = both(build, {"x": np.eye(2, dtype="float32")},
                  fetch=["w_cf@GRAD"])
    assert to[1].shape == (2, 2) and np.abs(to[1]).sum() > 0
    _same(jo[:1], to[:1])
    grad_close(to[1], jo[1], GRAD_TOL, "w_cf@GRAD")


# ---------------------------------------------------------------------------
# twins of tests/ops/test_uncovered_ops_r4c.py, test_extended_ops.py and
# test_surface_gap_ops.py
# ---------------------------------------------------------------------------

def test_array_write_read_length():
    def build(pkg, L):
        x = L.data("x", [2, 3], append_batch_size=False)
        arr = L.array_write(x, 0)
        arr = L.array_write(x * 2.0, 1, array=arr)
        return (L.array_read(arr, 0), L.array_read(arr, 1),
                L.array_length(arr))

    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    jo, to = both(build, {"x": x})
    np.testing.assert_allclose(to[0], x)
    np.testing.assert_allclose(to[1], 2.0 * x)
    assert int(to[2]) == 2 and to[2].dtype == np.int64
    _same(jo[:2], to[:2])
    assert int(jo[2]) == int(to[2])


def test_array_write_overwrite_and_dense_rule():
    def build(pkg, L):
        x = L.data("x", [3], append_batch_size=False)
        arr = L.array_write(x, 0)
        arr = L.array_write(x + 1.0, 0, array=arr)   # overwrite
        return L.array_read(arr, 0), L.array_length(arr)

    x = np.zeros(3, np.float32)
    jo, to = both(build, {"x": x})
    np.testing.assert_allclose(to[0], x + 1.0)
    assert int(to[1]) == 1 == int(jo[1])

    def sparse(pkg, L):
        return L.array_read(L.array_write(
            L.fill_constant([1], "float32", 1.0), 5), 5)

    # a write that skips an index fails in both packages
    for pkg, L, un in PKGS:
        with pytest.raises(ValueError, match="dense"):
            _run_one(pkg, L, un, sparse)


def test_py_func_host_callback_roundtrip():
    seen = []

    def host_fn(a):
        seen.append(type(a))
        return np.sort(np.asarray(a), axis=-1).astype(np.float32)

    def build(pkg, L):
        x = L.data("x", [2, 4], append_batch_size=False)
        out = L.create_global_var([2, 4], 0.0, "float32", name="pyout")
        return L.py_func(host_fn, x, out)

    x = np.array([[3, 1, 2, 0], [9, 7, 8, 6]], np.float32)
    jo, to = both(build, {"x": x})
    np.testing.assert_allclose(to[0], np.sort(x, axis=-1))
    _same(jo, to)
    assert seen[-1] is np.ndarray     # the port hands numpy copies


def test_conditional_select_and_is_empty():
    x = np.array([1.0, 2.0], np.float32)
    y = np.array([9.0, 8.0], np.float32)
    for cond in (np.array([True]), np.array([False])):
        jo, to, _ = op_twin("conditional_select",
                            {"Cond": cond, "X": x, "Y": y}, {}, "Out")
        assert_twin(jo, to, {})
    np.testing.assert_allclose(op_twin("conditional_select", {
        "Cond": np.array([True]), "X": x, "Y": y}, {}, "Out")[1], x)
    for v, want in ((np.zeros((0, 3), np.float32), True), (x, False)):
        jo, to, _ = op_twin("is_empty", {"X": v}, {}, "Out")
        assert bool(to) is want and bool(jo) is want


def test_tensor_array_sizes():
    xs = [np.zeros((2, 3), np.float32), np.zeros((5, 3), np.float32),
          np.zeros((1, 3), np.float32)]
    jo, to, _ = op_twin("tensor_array_sizes", {"X": xs}, {"axis": 0},
                        "Out")
    np.testing.assert_array_equal(to, [2, 5, 1])
    np.testing.assert_array_equal(to, jo)
    assert to.dtype == np.int64


def test_while_loop():
    def build(pkg, L):
        i = L.fill_constant(shape=[1], dtype="float32", value=0.0)
        s = L.fill_constant(shape=[1], dtype="float32", value=0.0)
        return L.while_loop(
            cond=lambda i, s: (i < 5.0).reshape(()) if hasattr(
                i, "reshape") else i < 5.0,
            body=lambda i, s: [i + 1.0, s + i], loop_vars=[i, s])

    jo, to = both(build, {})
    assert all(v.size == 1 for v in to)
    assert float(to[0].reshape(())) == 5.0
    assert float(to[1].reshape(())) == 10.0
    _same(jo, to)


def test_tensor_array_to_tensor():
    def build(pkg, L):
        a = L.fill_constant([2, 3], "float32", 1.0)
        b = L.fill_constant([2, 3], "float32", 2.0)
        arr = L.array_write(a, 0)
        L.array_write(b, 1, array=arr)
        out, index = L.tensor_array_to_tensor(arr, axis=1)
        stacked, _ = L.tensor_array_to_tensor(arr, axis=0, use_stack=True)
        return out, index, stacked

    jo, to = both(build, {})
    assert to[0].shape == (2, 6) and to[2].shape == (2, 2, 3)
    np.testing.assert_array_equal(to[1], [3, 3])
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(b, a)


def _printed(capfd, build, feed=None):
    """Each package's run of build, and the text it printed."""
    out = []
    for pkg, L, un in PKGS:
        capfd.readouterr()
        res = _run_one(pkg, L, un, build, feed)[0]
        out.append((res, capfd.readouterr().out))
    return out


def test_print_passthrough(capfd):
    def build(pkg, L):
        x = L.fill_constant([2], "float32", 5.0)
        return L.Print(x, message="dbg:")

    (jres, jtext), (tres, ttext) = _printed(capfd, build)
    np.testing.assert_allclose(tres[0], [5.0, 5.0])
    assert ttext == jtext and "dbg:" in ttext and "value= [5. 5.]" in ttext


# ---------------------------------------------------------------------------
# cases of this file's own
# ---------------------------------------------------------------------------

_OPERATORS = {
    "add": lambda a, b: a + b, "add_scalar": lambda a, b: a + 2.0,
    "radd": lambda a, b: 2.0 + a, "sub": lambda a, b: a - b,
    "sub_scalar": lambda a, b: a - 2.0, "rsub": lambda a, b: 2.0 - a,
    "mul": lambda a, b: a * b, "mul_scalar": lambda a, b: a * 3.0,
    "rmul": lambda a, b: 3.0 * a, "div": lambda a, b: a / b,
    "div_scalar": lambda a, b: a / 4.0, "rdiv": lambda a, b: 4.0 / a,
    "pow": lambda a, b: a ** b, "pow_scalar": lambda a, b: a ** 2.0,
    "mod": lambda a, b: a % b, "mod_scalar": lambda a, b: a % 0.7,
    "floordiv": lambda a, b: a // b, "floordiv_scalar": lambda a, b: a // 0.3,
    "lt": lambda a, b: a < b, "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b, "ge": lambda a, b: a >= b,
    "lt_scalar": lambda a, b: a < 1.0, "neg": lambda a, b: -a}


@pytest.mark.parametrize("name", sorted(_OPERATORS))
def test_variable_operator(name):
    """Each patched operator appends JAX's ops (the scalar fast path
    through scale, a scalar operand otherwise as fill_constant) and
    computes JAX's values."""
    a = (RS.rand(2, 3) + 0.5).astype(np.float32)
    b = (RS.rand(2, 3) + 0.5).astype(np.float32)
    b[0, 0] = a[0, 0]          # ties for the comparisons

    def build(pkg, L):
        av = L.data("a", [2, 3], append_batch_size=False)
        bv = L.data("b", [2, 3], append_batch_size=False)
        return _OPERATORS[name](av, bv)

    types = [[op.type for op in _build(pkg, L, un, build)[0]
              .global_block().ops] for pkg, L, un in PKGS]
    assert types[1] == types[0]
    jo, to = both(build, {"a": a, "b": b})
    assert to[0].dtype == jo[0].dtype
    _same(jo, to)


def test_while_inside_cond_branch():
    """A While built inside cond's taken branch: the branch's loop sums
    0..n-1, the other branch gives -1."""
    def build(pkg, L):
        T = L.tensor
        x = L.data("x", [1], append_batch_size=False)

        def loop():
            i = L.fill_constant((1,), "int64", 0)
            n = L.fill_constant((1,), "int64", 6)
            acc = L.fill_constant((1,), "float32", 0.0)
            c = L.less_than(i, n)
            w = L.While(c)
            with w.block():
                T.assign(acc + L.cast(i, "float32") * x, acc)
                L.increment(i, 1)
                L.less_than(i, n, cond=c)
            return acc

        pred = L.greater_than(x, L.fill_constant((1,), "float32", 0.0))
        return L.cond(pred, loop, lambda: L.fill_constant(
            (1,), "float32", -1.0))

    for xv, want in ((2.0, 30.0), (-1.0, -1.0)):
        jo, to = both(build, {"x": np.array([xv], np.float32)})
        assert to[0][0] == want
        _same(jo, to)


def test_dropped_print_still_prints(capfd):
    """Print's result unused and not fetched: the Executor keeps the op
    (a side-effect root) and it prints, in both packages."""
    def build(pkg, L):
        x = L.data("x", [3], append_batch_size=False)
        L.Print(x * 2.0, message="dropped:")
        return L.scale(x, 3.0)

    x = np.array([1.0, 2.0, 3.0], np.float32)
    (jres, jtext), (tres, ttext) = _printed(capfd, build, {"x": x})
    np.testing.assert_allclose(tres[0], 3 * x)
    assert "dropped:" in ttext and "value= [2. 4. 6.]" in ttext
    assert ttext == jtext


def test_sub_block_side_output_read_by_a_later_sub_block_op():
    """Inside a StaticRNN step, softmax_with_cross_entropy's Softmax is
    read only by the next op of the step block: the op must compute it
    (the names the sub-blocks read are live)."""
    def build(pkg, L):
        x = L.data("x", [3, 2, 5], append_batch_size=False)
        lbl = L.data("lbl", [2, 1], dtype="int64", append_batch_size=False)
        rnn = L.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)
            mem = rnn.memory(shape=[2, 5], value=0.0)
            _, sm = L.softmax_with_cross_entropy(x_t, lbl,
                                                 return_softmax=True)
            new = mem + sm
            rnn.update_memory(mem, new)
            rnn.step_output(new)
        return rnn()

    x = RS.randn(3, 2, 5).astype(np.float32)
    lbl = np.array([[1], [3]], np.int64)
    jo, to = both(build, {"x": x, "lbl": lbl})
    e = np.exp(x - x.max(-1, keepdims=True))
    np.testing.assert_allclose(
        to[0], np.cumsum(e / e.sum(-1, keepdims=True), 0), rtol=1e-5,
        atol=1e-6)
    _same(jo, to)


# the schedule: 1.0 while the counter is below 4, 0.5 below 8, else 0.1
SCHEDULE = ((4, 1.0), (8, 0.5), (None, 0.1))
SCHEDULE_STEPS = 12


def _schedule(pkg, L, x=None):
    T = L.tensor
    step = L.autoincreased_step_counter(begin=1)
    lr = T.create_global_var((1,), 0.0, "float32", persistable=True,
                             name="sched_lr")
    sw = L.Switch()
    with sw.block():
        for bound, value in SCHEDULE:
            case = sw.default() if bound is None else sw.case(
                L.less_than(step, L.fill_constant((1,), "int64", bound)))
            with case:
                T.assign(L.fill_constant((1,), "float32", value), lr)
    out = [lr, step]
    if x is not None:
        out.append(L.reduce_mean(x) * lr)
    return out


def _schedule_want(step):
    for bound, value in SCHEDULE:
        if bound is None or step < bound:
            return value


def test_switch_schedule_on_the_step_counter():
    """A piecewise Switch on autoincreased_step_counter over 12 runs:
    each run's LR is its step's boundary value, in both packages."""
    runs = [_run_one(pkg, L, un, lambda p, L: _schedule(p, L),
                     steps=SCHEDULE_STEPS) for pkg, L, un in PKGS]
    for k, (jr, tr) in enumerate(zip(*runs)):
        step = k + 1
        assert int(tr[1][0]) == step
        np.testing.assert_allclose(tr[0], [_schedule_want(step)])
        _same(jr, tr)


# -- op twins of the comparison, logical, reduce and floordiv ops ----------

_CMP_X = np.array([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]], np.float32)
_CMP_Y = np.array([[1.0, 0.0, 3.5], [4.0, 9.0, 6.0]], np.float32)
_BOOL_X = np.array([[True, False, True], [False, False, True]])
_BOOL_Y = np.array([[True, True, False], [False, True, True]])


@pytest.mark.parametrize("op,ins", [
    ("less_equal", {"X": _CMP_X, "Y": _CMP_Y}),
    ("not_equal", {"X": _CMP_X, "Y": _CMP_Y}),
    ("logical_or", {"X": _BOOL_X, "Y": _BOOL_Y}),
    ("logical_xor", {"X": _BOOL_X, "Y": _BOOL_Y}),
    ("logical_not", {"X": _BOOL_X}),
])
def test_comparison_and_logical_ops(op, ins):
    jo, to, _ = op_twin(op, ins, {}, "Out")
    assert to.dtype == np.bool_
    np.testing.assert_array_equal(to, jo)


def test_elementwise_floordiv_op():
    x = np.array([[7.0, -7.0, 5.5], [-0.5, 9.0, 2.0]], np.float32)
    y = np.array([[2.0, 2.0, -1.5], [2.0, 4.0, 0.5]], np.float32)
    jo, to, _ = op_twin("elementwise_floordiv", {"X": x, "Y": y},
                        {"axis": -1}, "Out")
    np.testing.assert_array_equal(to, jo)
    xi = np.array([[7, -7], [5, -1]], np.int64)
    yi = np.array([[2, 2], [-3, 4]], np.int64)
    jo, to, _ = op_twin("elementwise_floordiv", {"X": xi, "Y": yi},
                        {"axis": -1}, "Out")
    np.testing.assert_array_equal(to, np.floor_divide(xi, yi))
    np.testing.assert_array_equal(to, jo)


_REDUCE_ATTRS = [{"dim": [0]}, {"dim": [1], "keep_dim": True},
                 {"dim": [0, 2]}, {"dim": [-1]},
                 {"reduce_all": True, "dim": [0]},
                 {"reduce_all": True, "dim": [0], "keep_dim": True}]


@pytest.mark.parametrize("op", ["reduce_mean", "reduce_max", "reduce_min",
                                "reduce_prod"])
@pytest.mark.parametrize("k", range(len(_REDUCE_ATTRS)))
def test_reduce_ops(op, k):
    x = (RS.rand(2, 3, 4) + 0.5).astype(np.float32)
    attrs = _REDUCE_ATTRS[k]
    # the harness seeds a cotangent of the output's shape: none for a
    # scalar (its gradient is checked through the keep_dim case)
    scalar = attrs.get("reduce_all") and not attrs.get("keep_dim")
    jo, to, grads = op_twin(op, {"X": x}, attrs, "Out",
                            grad=() if scalar else ("X",))
    assert_twin(jo, to, grads)


@pytest.mark.parametrize("op", ["reduce_all", "reduce_any"])
@pytest.mark.parametrize("k", range(len(_REDUCE_ATTRS)))
def test_reduce_bool_ops(op, k):
    x = RS.rand(2, 3, 4) > 0.3
    jo, to, _ = op_twin(op, {"X": x}, _REDUCE_ATTRS[k], "Out")
    assert to.dtype == np.bool_ and to.shape == jo.shape
    np.testing.assert_array_equal(to, jo)


def test_reduce_mean_of_integers_is_float():
    x = np.array([[1, 2], [4, 4]], np.int64)
    jo, to, _ = op_twin("reduce_mean", {"X": x}, {"dim": [0]}, "Out")
    np.testing.assert_allclose(to, jo)
    assert to.dtype == np.float32


# ---------------------------------------------------------------------------
# data parallelism
# ---------------------------------------------------------------------------

DP2 = [CPU] * 2


def test_reductions_at_dp2_equal_dp1():
    """The reductions over dim 0 finish over the ranks (replicated);
    those over other dims run a rank's rows."""
    x = (RS.rand(4, 3) + 0.5).astype(np.float32)

    def build(L, xv):
        b = L.greater_than(xv, L.fill_constant([1], "float32", 1.0))
        return [L.reduce_mean(xv, dim=0), L.reduce_max(xv),
                L.reduce_min(xv, dim=[0], keep_dim=True),
                L.reduce_prod(xv, dim=0), L.reduce_all(b, dim=0),
                L.reduce_any(b), L.reduce_mean(xv, dim=1),
                L.reduce_max(xv, dim=1, keep_dim=True)]

    one = _port_dp(build, {"x": x}, [CPU])
    two = _port_dp(build, {"x": x}, DP2)
    for a, b in zip(two, one):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-6)


def _while_rows(L, xv):
    """A While whose carry is x's rows: acc += 2x, three times, under a
    replicated counter; and a cond on a replicated predicate whose
    branches are row ops."""
    T = L.tensor
    i = L.fill_constant((1,), "int64", 0)
    n = L.fill_constant((1,), "int64", 3)
    acc = L.scale(xv, 0.0)
    c = L.less_than(i, n)
    w = L.While(c)
    with w.block():
        T.assign(acc + xv * 2.0, acc)
        L.increment(i, 1)
        L.less_than(i, n, cond=c)
    pred = L.less_than(i, L.fill_constant((1,), "int64", 5))
    picked = L.cond(pred, lambda: xv * 10.0, lambda: xv - 1.0)
    return [acc, picked, i]


def test_while_and_cond_on_rows_at_dp2_equal_dp1():
    x = RS.randn(4, 3).astype(np.float32)
    one = _port_dp(_while_rows, {"x": x}, [CPU])
    two = _port_dp(_while_rows, {"x": x}, DP2)
    np.testing.assert_allclose(one[0], 6.0 * x, rtol=1e-6)
    np.testing.assert_allclose(one[1], 10.0 * x, rtol=1e-6)
    for a, b in zip(two, one):
        np.testing.assert_array_equal(a, b)


def test_switch_schedule_at_dp2_equal_dp1():
    x = RS.randn(4, 3).astype(np.float32)
    runs = []
    for places in ([CPU], DP2):
        main, startup = fluid.Program(), fluid.Program()
        with tun.guard(), fluid.program_guard(main, startup):
            xv = tlayers.data("x", shape=[4, 3], append_batch_size=False)
            res = _schedule(fluid, tlayers, xv)
        comp = fluid.CompiledProgram(main).with_data_parallel(places=places)
        exe, scope = fluid.Executor(CPU), fluid.Scope()
        exe.run(startup, scope=scope)
        runs.append([exe.run(comp, feed={"x": x}, fetch_list=res,
                             scope=scope) for _ in range(SCHEDULE_STEPS)])
    for k, (one, two) in enumerate(zip(*runs)):
        want = _schedule_want(k + 1)
        np.testing.assert_allclose(one[0], [want])
        np.testing.assert_allclose(one[2], x.mean() * want, rtol=1e-6)
        for a, b in zip(two, one):
            np.testing.assert_allclose(a, b, rtol=1e-6)


def test_sharded_condition_and_predicate_refuse_under_dp():
    """A predicate or While condition computed from sharded rows has no
    single host value, and a Switch selects whole values: each refuses
    at dp 2 (the Switch on sharded rows runs at dp 1)."""
    p = np.array([[0.2], [0.9]], np.float32)

    def cond_of_rows(L, pv):
        pred = L.less_than(pv, L.fill_constant([1], "float32", 0.5))
        return L.cond(pred, lambda: pv * 2.0, lambda: pv)

    def while_of_rows(L, pv):
        c = L.less_than(pv, L.fill_constant([1], "float32", 0.5))
        w = L.While(c)
        with w.block():
            L.tensor.assign(pv + 1.0, pv)
            L.less_than(pv, L.fill_constant([1], "float32", 0.5), cond=c)
        return pv

    def switch_of_rows(L, pv):
        out = L.scale(pv, 0.0)
        sw = L.Switch()
        with sw.block():
            with sw.case(L.less_than(L.fill_constant([1], "float32", 0.0),
                                     L.fill_constant([1], "float32", 1.0))):
                L.tensor.assign(pv * 2.0, out)
            with sw.default():
                L.tensor.assign(pv, out)
        return out

    np.testing.assert_allclose(_port_dp(switch_of_rows, {"p": p}, [CPU])[0],
                               2.0 * p)
    for build in (cond_of_rows, while_of_rows, switch_of_rows):
        with pytest.raises(NotImplementedError, match="dp-sharded"):
            _port_dp(build, {"p": p}, DP2)


def test_static_rnn_refuses_a_sharded_time_major_input():
    """dp 2 splits the time-major step input along T: the StaticRNN
    refuses (it runs at dp 1)."""
    x = np.arange(24).reshape(4, 2, 3).astype("float32")

    def build(L, xv):
        rnn = L.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(xv)
            mem = rnn.memory(shape=[2, 3], value=0.0)
            new = mem + x_t
            rnn.update_memory(mem, new)
            rnn.step_output(new)
        return rnn()

    np.testing.assert_allclose(_port_dp(build, {"x": x}, [CPU])[0],
                               np.cumsum(x, 0))
    with pytest.raises(NotImplementedError, match="time"):
        _port_dp(build, {"x": x}, DP2)


def test_arrays_and_print_at_dp2(capfd):
    """A sharded entry is stored and read back as it is; the array's
    sizes count the whole; Print prints the global value."""
    x = np.arange(8, dtype=np.float32).reshape(4, 2)

    def build(L, xv):
        arr = L.array_write(xv, 0)
        L.array_write(xv * 2.0, 1, array=arr)
        out, sizes = L.tensor_array_to_tensor(arr, axis=1)
        L.Print(L.array_read(arr, 1), message="rows:",
                print_tensor_name=False)
        return [L.array_read(arr, 0), out, sizes, L.array_length(arr)]

    capfd.readouterr()
    one = _port_dp(build, {"x": x}, [CPU])
    text_one = capfd.readouterr().out
    two = _port_dp(build, {"x": x}, DP2)
    text_two = capfd.readouterr().out
    np.testing.assert_array_equal(one[1], np.concatenate([x, 2 * x], 1))
    for a, b in zip(two, one):
        np.testing.assert_array_equal(a, b)
    assert text_two == text_one and "rows:" in text_one
