"""The port's DynamicRNN and StaticRNN against the JAX package, on the
CPU: the twins of the three tests of ``tests/api/test_dynamic_rnn.py``
(the accumulator frozen at each row's length against its numpy oracle
and JAX's output; the sequence-sum regression trained 60 Adam steps in
both packages from one scope; ``reorder_lod_tensor_by_rank``'s
identity), and the @GRADs through a ``StaticRNN`` with an ``fc`` in its
step and through a ``DynamicRNN`` against JAX's ``jax.grad`` through
``lax.scan``, from one scope. The port's recurrences are eager loops
over axis 0 and autograd gives their backward.
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

from test_torch_sequence_ops import both, grad_close

CPU = fluid.CPUPlace()
# the recurrences in f32, outputs and losses: the same arithmetic in
# both packages, the products XLA's and torch's (measured: the frozen
# accumulator exact, the fc recurrences' losses within 2.5e-7 relative)
RNN_RTOL, RNN_ATOL = 1e-5, 1e-6
# @GRADs within 1e-4 of each gradient's largest entry (measured 5.5e-7)
GRAD_TOL = 1e-4
# 60 Adam(0.1) steps of the regression: every loss within 1e-4 relative
# of JAX's (measured 4.1e-6 at most)
TRAIN_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_bert.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _accumulator(pkg, L, B, T, D):
    xv = pkg.data(name="x", shape=[B, T, D], dtype="float32")
    lv = pkg.data(name="len", shape=[B], dtype="int64")
    drnn = L.DynamicRNN()
    with drnn.block():
        cur = drnn.step_input(xv, length=lv)
        mem = drnn.memory(shape=[B, D], value=0.0)
        acc = L.elementwise_add(mem, cur)
        drnn.update_memory(mem, acc)
        drnn.output(acc)
    return drnn()


def test_dynamic_rnn_accumulator_freezes_at_length():
    B, T, D = 3, 5, 2
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    lengths = np.array([5, 2, 4], np.int64)
    jo, to = both(lambda pkg, L: _accumulator(pkg, L, B, T, D),
                  {"x": x, "len": lengths})
    # the oracle: a running prefix sum, zeros past each row's length
    ref = np.zeros_like(x)
    for b in range(B):
        s = np.zeros(D, np.float32)
        for t in range(lengths[b]):
            s = s + x[b, t]
            ref[b, t] = s
    np.testing.assert_allclose(to[0], ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(to[0], jo[0], rtol=RNN_RTOL, atol=RNN_ATOL)


def _regression(pkg, L, B, T, D):
    xv = pkg.data(name="x", shape=[B, T, D], dtype="float32")
    lv = pkg.data(name="len", shape=[B], dtype="int64")
    yv = pkg.data(name="y", shape=[B, 1], dtype="float32")
    drnn = L.DynamicRNN()
    with drnn.block():
        cur = drnn.step_input(xv, length=lv)
        mem = drnn.memory(shape=[B, 1], value=0.0)
        step_val = L.fc(cur, size=1, bias_attr=False,
                        param_attr=pkg.ParamAttr(name="drnn_w"))
        acc = L.elementwise_add(mem, step_val)
        drnn.update_memory(mem, acc)
        drnn.output(acc)
    seq = drnn()                           # (B, T, 1)
    total = L.reduce_sum(
        L.elementwise_mul(
            seq, L.unsqueeze(L.cast(
                L.one_hot(L.unsqueeze(L.cast(lv, "int64") - 1, axes=[-1]),
                          T), "float32"), axes=[-1])), dim=1)
    loss = L.mean(L.square_error_cost(total, yv))
    pkg.optimizer.AdamOptimizer(learning_rate=0.1).minimize(loss)
    return loss


def test_dynamic_rnn_trains_sequence_sum_regression():
    """The JAX test's regression, 60 Adam steps in each package from
    JAX's startup scope: the losses agree step by step and fall below
    0.05x the first."""
    B, T, D = 8, 6, 4
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    lengths = rng.integers(2, T + 1, (B,)).astype(np.int64)
    w_true = rng.standard_normal((D, 1)).astype(np.float32)
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    y = ((x @ w_true)[..., 0] * mask).sum(1, keepdims=True).astype(
        np.float32)
    feed = {"x": x, "len": lengths, "y": y}
    progs = []
    for pkg, L, un in ((jfluid, jlayers, jun), (fluid, tlayers, tun)):
        main, startup = pkg.Program(), pkg.Program()
        with un.guard(), pkg.program_guard(main, startup):
            loss = _regression(pkg, L, B, T, D)
        progs.append((main, startup, loss))
    (jmain, jstart, jloss), (tmain, tstart, tloss) = progs
    scope = JScope()
    with jguard(scope):
        exe = jfluid.Executor()
        exe.run(jstart)
        init = {n: np.array(scope.get(n)) for n in scope.names()}
        jl = [float(np.asarray(exe.run(jmain, feed=feed,
                                       fetch_list=[jloss])[0]).reshape(()))
              for _ in range(60)]
    tscope = fluid.Scope()
    exe = fluid.Executor(CPU)
    exe.run(tstart, scope=tscope)
    fluid.scope_from_numpy(init, "cpu", tscope)
    tl = [float(np.asarray(exe.run(tmain, feed=feed, fetch_list=[tloss],
                                   scope=tscope)[0]).reshape(()))
          for _ in range(60)]
    assert tl[-1] < tl[0] * 0.05, (tl[0], tl[-1])
    np.testing.assert_allclose(tl, jl, rtol=TRAIN_RTOL)


def test_reorder_lod_tensor_by_rank_is_identity():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        xv = fluid.data(name="x", shape=[4, 3], dtype="float32")
        out = tlayers.reorder_lod_tensor_by_rank(xv, rank_table=None)
        assert out is xv


# ---------------------------------------------------------------------------
# gradients through the recurrences, from one scope
# ---------------------------------------------------------------------------

def _grads(build, feed, params):
    """build(pkg, L) -> loss; append_backward in each package; (JAX's
    [loss] + @GRADs, the port's) from JAX's startup scope."""
    def with_backward(pkg, L):
        loss = build(pkg, L)
        pkg.append_backward(loss)
        return loss

    return both(with_backward, feed, fetch=[p + "@GRAD" for p in params])


def test_static_rnn_fc_step_grads():
    """An Elman cell h_t = tanh(fc([x_t, h_{t-1}])) over 5 steps and a
    score fc on every step's h: the loss and the @GRADs of the cell's
    weight and bias and of the score weight match JAX's jax.grad through
    lax.scan."""
    T, B, D, H = 5, 3, 4, 6
    rs = np.random.RandomState(7)
    x = rs.randn(T, B, D).astype(np.float32)
    h0 = rs.randn(B, H).astype(np.float32) * 0.1

    def build(pkg, L):
        xv = L.data("x", [T, B, D], append_batch_size=False)
        hv = L.data("h0", [B, H], append_batch_size=False)
        rnn = L.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(xv)
            h = rnn.memory(init=hv)
            nh = L.fc(L.concat([x_t, h], axis=-1), size=H, act="tanh",
                      param_attr=pkg.ParamAttr(name="cell_w"),
                      bias_attr=pkg.ParamAttr(name="cell_b"))
            rnn.update_memory(h, nh)
            score = L.fc(nh, size=1, param_attr=pkg.ParamAttr(name="out_w"),
                         bias_attr=False)
            rnn.step_output(score)
        return L.mean(L.elementwise_mul(rnn(), rnn()))

    params = ["cell_w", "cell_b", "out_w"]
    jo, to = _grads(build, {"x": x, "h0": h0}, params)
    np.testing.assert_allclose(to[0], jo[0], rtol=RNN_RTOL, atol=RNN_ATOL)
    for name, a, b in zip(params, jo[1:], to[1:]):
        assert b.shape == a.shape
        grad_close(b, a, GRAD_TOL, name)


def test_dynamic_rnn_grads():
    """The regression's DynamicRNN (frozen accumulator of fc steps,
    outputs masked past each length): the @GRAD of its weight and of a
    second fc on the outputs against JAX's."""
    B, T, D = 4, 5, 3
    rs = np.random.RandomState(8)
    x = rs.randn(B, T, D).astype(np.float32)
    lengths = np.array([5, 1, 3, 4], np.int64)

    def build(pkg, L):
        xv = pkg.data(name="x", shape=[B, T, D], dtype="float32")
        lv = pkg.data(name="len", shape=[B], dtype="int64")
        drnn = L.DynamicRNN()
        with drnn.block():
            cur = drnn.step_input(xv, length=lv)
            mem = drnn.memory(shape=[B, 2], value=0.0)
            step_val = L.fc(cur, size=2, act="tanh",
                            param_attr=pkg.ParamAttr(name="d_w"),
                            bias_attr=pkg.ParamAttr(name="d_b"))
            acc = L.elementwise_add(mem, step_val)
            drnn.update_memory(mem, acc)
            drnn.output(acc)
        seq = drnn()                        # (B, T, 2)
        head = L.fc(seq, size=1, num_flatten_dims=2,
                    param_attr=pkg.ParamAttr(name="h_w"), bias_attr=False)
        return L.mean(L.elementwise_mul(head, head))

    params = ["d_w", "d_b", "h_w"]
    jo, to = _grads(build, {"x": x, "len": lengths}, params)
    np.testing.assert_allclose(to[0], jo[0], rtol=RNN_RTOL, atol=RNN_ATOL)
    for name, a, b in zip(params, jo[1:], to[1:]):
        grad_close(b, a, GRAD_TOL, name)
