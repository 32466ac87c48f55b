"""The port's recurrent ops and layers against the JAX package, on the CPU:
``ops/rnn_ops.py`` (``lstm``, ``gru``, ``lstm_unit``, ``gru_unit``,
``lstmp``, ``basic_gru``, ``basic_lstm``), ``layers/rnn.py``
(``dynamic_lstm``, ``lstm``, ``dynamic_gru``, ``lstm_unit``,
``gru_unit``, ``dynamic_lstmp``) and ``contrib.layers``' static
``basic_gru`` / ``basic_lstm``.

Twins of the JAX package's tests build the same layers in both
packages, carry JAX's startup scope over to the port
(``test_torch_sequence_ops.twin``) and hold the port to the reference
test's golden (numpy, or torch's ``nn.LSTM``) and to JAX's output:
``tests/api/test_rnn_attention.py``'s LSTM and GRU tests,
``tests/api/test_semantic_parity2.py``'s ``dynamic_gru`` origin mode,
``gru_unit`` blend, ``dynamic_lstm`` cell and peephole tests,
``tests/ops/test_sampling_ops.py::test_dynamic_lstmp_shapes_and_training``
and the static ``basic_gru`` / ``basic_lstm`` tests of
``tests/api/test_contrib_layers.py``. Two cases of this file's own: a
ragged batch under ``is_reverse`` with the padded positions' outputs
compared (they hold the carried state, not 0), and the gradients through
every recurrence. Op twins hold the single-step ops and ``lstmp`` with
each input's gradient; a dp twin runs a ragged LSTM stack at dp 2
against dp 1.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.contrib import layers as jcontrib

import paddle_tpu_torch as fluid
from paddle_tpu_torch.contrib import layers as tcontrib

from test_torch_seq2seq import _port_dp, assert_twin, op_twin
from test_torch_sequence_ops import _data, both, grad_close, twin

CPU = fluid.CPUPlace()
# the recurrences in f32: the same gate arithmetic in both packages, the
# products and transcendental functions XLA's and torch's (measured at
# most 8.5e-7 of an output's largest entry over 4-6 steps, against JAX
# and the goldens; gradients within 3.9e-7 of their largest entry)
RNN_RTOL, RNN_ATOL = 1e-5, 1e-6
GRAD_TOL = 1e-4
# the reference tests' bars against their goldens
GOLD_RTOL, GOLD_ATOL = 2e-5, 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_bert.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RS = np.random.RandomState(5)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _same(jo, to, rtol=RNN_RTOL, atol=RNN_ATOL):
    for a, b in zip(jo, to):
        assert b.shape == a.shape, (b.shape, a.shape)
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)


def _contrib(pkg):
    return jcontrib if pkg is jfluid else tcontrib


# ---------------------------------------------------------------------------
# twins of the JAX package's tests
# ---------------------------------------------------------------------------

def test_lstm_matches_numpy():
    """test_rnn_attention.py: dynamic_lstm without peepholes against the
    i, f, c, o numpy recurrence."""
    b, t, d, h = 2, 4, 3, 5
    x = RS.randn(b, t, d).astype("float32")

    def build(pkg, L):
        xv = _data(L, "x", [b, t, d])
        return L.dynamic_lstm(xv, 4 * h, use_peepholes=False,
                              param_attr=pkg.ParamAttr(name="l"),
                              bias_attr=pkg.ParamAttr(name="l_b"))

    jo, to, p = twin(build, {"x": x})
    h_prev = np.zeros((b, h), "float32")
    c_prev = np.zeros((b, h), "float32")
    want = []
    for step in range(t):
        g = x[:, step] @ p["l_wx"] + h_prev @ p["l_wh"] + p["l_b"]
        i, f, ch, o = np.split(g, 4, axis=-1)
        c_prev = _sigmoid(f) * c_prev + _sigmoid(i) * np.tanh(ch)
        h_prev = _sigmoid(o) * np.tanh(c_prev)
        want.append(h_prev.copy())
    np.testing.assert_allclose(to[0], np.stack(want, 1), rtol=GOLD_RTOL,
                               atol=GOLD_ATOL)
    _same(jo, to)


def _gru_ref(x3, h0, wh, origin_mode):
    h = h0.shape[-1]
    hs, ht = [], h0
    for t in range(x3.shape[1]):
        g = x3[:, t, :2 * h] + ht @ wh[:, :2 * h]
        u = _sigmoid(g[:, :h])
        r = _sigmoid(g[:, h:])
        c = np.tanh(x3[:, t, 2 * h:] + (r * ht) @ wh[:, 2 * h:])
        ht = u * ht + (1 - u) * c if origin_mode else (1 - u) * ht + u * c
        hs.append(ht)
    return np.stack(hs, axis=1)


def test_gru_matches_numpy():
    """test_rnn_attention.py: dynamic_gru (origin_mode False, the fluid
    default blend) against the numpy recurrence."""
    b, t, d, h = 2, 3, 4, 6
    x = RS.randn(b, t, d).astype("float32")

    def build(pkg, L):
        return L.dynamic_gru(_data(L, "x", [b, t, d]), h,
                             param_attr=pkg.ParamAttr(name="g"),
                             bias_attr=pkg.ParamAttr(name="g_b"))

    jo, to, p = twin(build, {"x": x})
    want = _gru_ref(x @ p["g_wx"] + p["g_b"], np.zeros((b, h), "float32"),
                    p["g_wh"], origin_mode=False)
    np.testing.assert_allclose(to[0], want, rtol=GOLD_RTOL, atol=GOLD_ATOL)
    _same(jo, to)


@pytest.mark.parametrize("origin_mode", [False, True])
def test_dynamic_gru_origin_mode(origin_mode):
    """test_semantic_parity2.py: the two blends, no bias."""
    b, t, d, h = 2, 4, 3, 5
    x = RS.randn(b, t, d).astype(np.float32)
    wx = RS.randn(d, 3 * h).astype(np.float32) * 0.5
    wh = RS.randn(h, 3 * h).astype(np.float32) * 0.5

    def build(pkg, L):
        return L.dynamic_gru(L.data("x", shape=[t, d], dtype="float32"),
                             size=h, origin_mode=origin_mode,
                             param_attr=pkg.ParamAttr(name="g"),
                             bias_attr=False)

    jo, to = both(build, {"x": x}, sets={"g_wx": wx, "g_wh": wh})
    want = _gru_ref(x @ wx, np.zeros((b, h), np.float32), wh, origin_mode)
    np.testing.assert_allclose(to[0], want, rtol=1e-4, atol=1e-5)
    _same(jo, to)


def test_gru_unit_default_matches_reference_blend():
    """test_semantic_parity2.py: gru_unit's default (1 - u) h + u c."""
    b, h = 3, 4
    xg = RS.randn(b, 3 * h).astype(np.float32)
    hp = RS.randn(b, h).astype(np.float32)
    w = RS.randn(h, 3 * h).astype(np.float32) * 0.5

    def build(pkg, L):
        out, _rhp, _gate = L.gru_unit(
            L.data("xg", shape=[3 * h], dtype="float32"),
            L.data("hp", shape=[h], dtype="float32"), size=3 * h,
            param_attr=pkg.ParamAttr(name="guw"), bias_attr=False)
        return out

    jo, to = both(build, {"xg": xg, "hp": hp}, sets={"guw": w})
    want = _gru_ref(xg[:, None, :], hp, w, origin_mode=False)[:, 0]
    np.testing.assert_allclose(to[0], want, rtol=1e-4, atol=1e-5)
    _same(jo, to)


def test_dynamic_lstm_matches_torch_cell():
    """test_semantic_parity2.py: without peepholes the i, f, c, o
    recurrence equals torch's nn.LSTM (gate order i, f, g, o)."""
    b, t, d, h = 2, 5, 3, 4
    x = RS.randn(b, t, d).astype(np.float32)
    wx = (RS.randn(d, 4 * h) * 0.5).astype(np.float32)
    wh = (RS.randn(h, 4 * h) * 0.5).astype(np.float32)
    bias = RS.randn(4 * h).astype(np.float32)

    def build(pkg, L):
        return L.dynamic_lstm(L.data("x", shape=[t, d], dtype="float32"),
                              size=4 * h, use_peepholes=False,
                              param_attr=pkg.ParamAttr(name="l"),
                              bias_attr=pkg.ParamAttr(name="l_b"))

    jo, to = both(build, {"x": x},
                  sets={"l_wx": wx, "l_wh": wh, "l_b": bias})
    cell = torch.nn.LSTM(d, h, batch_first=True)
    with torch.no_grad():
        cell.weight_ih_l0.copy_(torch.from_numpy(wx.T))
        cell.weight_hh_l0.copy_(torch.from_numpy(wh.T))
        cell.bias_ih_l0.copy_(torch.from_numpy(bias))
        cell.bias_hh_l0.zero_()
        want, (_hn, cn) = cell(torch.from_numpy(x))
    np.testing.assert_allclose(to[0], want.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to[1][:, -1], cn[0].numpy(), rtol=1e-4,
                               atol=1e-5)
    _same(jo, to)


def test_dynamic_lstm_peephole_formula():
    """test_semantic_parity2.py: use_peepholes (the default): i and f
    peek at c_prev, o at c_new, through the 3H bias tail."""
    b, t, d, h = 2, 4, 3, 2
    x = RS.randn(b, t, d).astype(np.float32)
    wx = (RS.randn(d, 4 * h) * 0.5).astype(np.float32)
    wh = (RS.randn(h, 4 * h) * 0.5).astype(np.float32)
    bias = (RS.randn(7 * h) * 0.5).astype(np.float32)

    def build(pkg, L):
        return L.dynamic_lstm(L.data("x", shape=[t, d], dtype="float32"),
                              size=4 * h, use_peepholes=True,
                              param_attr=pkg.ParamAttr(name="p"),
                              bias_attr=pkg.ParamAttr(name="p_b"))[0]

    jo, to = both(build, {"x": x},
                  sets={"p_wx": wx, "p_wh": wh, "p_b": bias})
    wi, wf, wo = np.split(bias[4 * h:], 3)
    hp = np.zeros((b, h), np.float32)
    cp = np.zeros((b, h), np.float32)
    want = []
    for s in range(t):
        g = x[:, s] @ wx + bias[:4 * h] + hp @ wh
        i, f, ch, o = np.split(g, 4, axis=-1)
        i = _sigmoid(i + cp * wi)
        f = _sigmoid(f + cp * wf)
        cn = f * cp + i * np.tanh(ch)
        o = _sigmoid(o + cn * wo)
        hp, cp = o * np.tanh(cn), cn
        want.append(hp.copy())
    np.testing.assert_allclose(to[0], np.stack(want, 1), rtol=1e-4,
                               atol=1e-5)
    _same(jo, to)


def test_dynamic_lstmp_shapes_and_training():
    """test_sampling_ops.py: dynamic_lstmp's shapes, and 40 Adam(0.05)
    steps bring the loss below half the first; the port's losses follow
    JAX's from one scope (the first five within LSTMP_LOSS_RTOL). The
    reference averages the projections over time; the port has no
    reduce_mean layer yet, so both packages sum them here."""
    rng = np.random.default_rng(4)
    B, T, D, H, P = 4, 6, 5, 8, 3
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    tgt = rng.standard_normal((B, P)).astype(np.float32)
    feed = {"x": x, "y": tgt}

    def build(pkg, L):
        xv = _data(L, "x", [B, T, D])
        yv = _data(L, "y", [B, P])
        proj, cell = L.dynamic_lstmp(xv, size=4 * H, proj_size=P)
        loss = L.mean(L.square_error_cost(L.reduce_sum(proj, dim=1), yv))
        pkg.optimizer.AdamOptimizer(learning_rate=0.05).minimize(loss)
        return [proj, cell, loss]

    progs = {}
    for pkg, L in ((jfluid, jfluid.layers), (fluid, fluid.layers)):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.core.unique_name.guard(), \
                pkg.program_guard(main, startup):
            progs[pkg] = (main, startup, build(pkg, L))
    from paddle_tpu.core.executor import Scope as JScope, scope_guard
    jmain, jstart, jres = progs[jfluid]
    tmain, tstart, tres = progs[fluid]
    jscope = JScope()
    jl = []
    with scope_guard(jscope):
        jexe = jfluid.Executor()
        jexe.run(jstart)
        init = {n: np.array(jscope.get(n)) for n in jscope.names()}
        for _ in range(5):
            jl.append(float(np.asarray(jexe.run(
                jmain, feed=feed, fetch_list=[jres[2]])[0]).reshape(())))
    scope = fluid.Scope()
    exe = fluid.Executor(CPU)
    exe.run(tstart, scope=scope)
    fluid.scope_from_numpy(init, "cpu", scope)
    losses = []
    for _ in range(40):
        p, c, loss = exe.run(tmain, feed=feed, fetch_list=tres, scope=scope)
        losses.append(float(np.asarray(loss).reshape(())))
    assert p.shape == (B, T, P) and c.shape == (B, T, H)
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
    np.testing.assert_allclose(losses[:5], jl, rtol=LSTMP_LOSS_RTOL)


# the lstmp training twin's first five Adam losses against JAX's
# (measured 1.3e-7 relative)
LSTMP_LOSS_RTOL = 1e-5


def _golden_basic_gru(x, gate_w, gate_b, cand_w, cand_b, h0, lengths=None):
    h = cand_w.shape[1]
    hp = h0.copy()
    outs = []
    for step in range(x.shape[1]):
        xh = np.concatenate([x[:, step], hp], 1)
        g = _sigmoid(xh @ gate_w + gate_b)
        r, u = g[:, :h], g[:, h:]
        c = np.tanh(np.concatenate([x[:, step], r * hp], 1) @ cand_w
                    + cand_b)
        hn = u * hp + (1 - u) * c
        if lengths is not None:
            m = (step < lengths).astype("float32")[:, None]
            hn = m * hn + (1 - m) * hp
        hp = hn
        outs.append(hp.copy())
    return np.stack(outs, 1), hp


def _golden_basic_lstm(x, w, bias, h0, c0, forget_bias=1.0, lengths=None):
    hp, cp = h0.copy(), c0.copy()
    outs = []
    for step in range(x.shape[1]):
        g = np.concatenate([x[:, step], hp], 1) @ w + bias
        i, j, f, o = np.split(g, 4, axis=-1)
        cn = cp * _sigmoid(f + forget_bias) + _sigmoid(i) * np.tanh(j)
        hn = np.tanh(cn) * _sigmoid(o)
        if lengths is not None:
            m = (step < lengths).astype("float32")[:, None]
            hn = m * hn + (1 - m) * hp
            cn = m * cn + (1 - m) * cp
        hp, cp = hn, cn
        outs.append(hp.copy())
    return np.stack(outs, 1), hp, cp


def test_basic_gru_matches_golden():
    """test_contrib_layers.py: one ragged basic_gru layer with an initial
    state against the documented math."""
    b, t, d, h = 3, 5, 4, 6
    x = RS.randn(b, t, d).astype("float32")
    h0 = RS.randn(1, b, h).astype("float32")
    lengths = np.array([5, 3, 1], "int32")

    def build(pkg, L):
        return _contrib(pkg).basic_gru(
            _data(L, "x", [b, t, d]), _data(L, "h0", [1, b, h]), h,
            sequence_length=_data(L, "len", [b], "int32"),
            param_attr=pkg.ParamAttr(name="gp"),
            bias_attr=pkg.ParamAttr(name="gb"))

    jo, to, p = twin(build, {"x": x, "h0": h0, "len": lengths})
    want, want_last = _golden_basic_gru(
        x, p["gp_gate_w_layers_0"], p["gb_gate_b_layers_0"],
        p["gp_cand_w_layers_0"], p["gb_cand_b_layers_0"], h0[0], lengths)
    np.testing.assert_allclose(to[0], want, rtol=GOLD_RTOL, atol=GOLD_ATOL)
    np.testing.assert_allclose(to[1][0], want_last, rtol=GOLD_RTOL,
                               atol=GOLD_ATOL)
    _same(jo, to)


def test_basic_gru_bidirectional_matches_golden():
    """test_contrib_layers.py: the backward direction over the reversed
    sequence; last_hidden interleaves (fw, bw) per layer."""
    b, t, d, h = 2, 4, 3, 5
    x = RS.randn(b, t, d).astype("float32")

    def build(pkg, L):
        return _contrib(pkg).basic_gru(
            _data(L, "x", [b, t, d]), None, h, bidirectional=True,
            param_attr=pkg.ParamAttr(name="p"),
            bias_attr=pkg.ParamAttr(name="q"))

    jo, to, p = twin(build, {"x": x})
    z = np.zeros((b, h), "float32")
    fw, fw_last = _golden_basic_gru(
        x, p["p_gate_w_layers_0"], p["q_gate_b_layers_0"],
        p["p_cand_w_layers_0"], p["q_cand_b_layers_0"], z)
    bw_rev, bw_last = _golden_basic_gru(
        x[:, ::-1], p["p_gate_w_reverse_layers_0"],
        p["q_gate_b_reverse_layers_0"], p["p_cand_w_reverse_layers_0"],
        p["q_cand_b_reverse_layers_0"], z)
    np.testing.assert_allclose(to[0], np.concatenate(
        [fw, bw_rev[:, ::-1]], axis=2), rtol=GOLD_RTOL, atol=GOLD_ATOL)
    assert to[1].shape == (2, b, h)
    np.testing.assert_allclose(to[1][0], fw_last, rtol=GOLD_RTOL,
                               atol=GOLD_ATOL)
    np.testing.assert_allclose(to[1][1], bw_last, rtol=GOLD_RTOL,
                               atol=GOLD_ATOL)
    _same(jo, to)


def test_basic_gru_multilayer_shapes():
    b, t, d, h, n = 2, 3, 4, 5, 3
    x = RS.randn(b, t, d).astype("float32")
    jo, to = both(lambda pkg, L: _contrib(pkg).basic_gru(
        _data(L, "x", [b, t, d]), None, h, num_layers=n), {"x": x})
    assert to[0].shape == (b, t, h) and to[1].shape == (n, b, h)
    _same(jo, to)


def test_basic_lstm_matches_golden():
    """test_contrib_layers.py: one ragged basic_lstm layer, forget_bias
    1.0, initial states, against the (i, j, f, o) golden."""
    b, t, d, h = 3, 4, 5, 6
    x = RS.randn(b, t, d).astype("float32")
    h0 = RS.randn(1, b, h).astype("float32")
    c0 = RS.randn(1, b, h).astype("float32")
    lengths = np.array([4, 2, 3], "int32")

    def build(pkg, L):
        return _contrib(pkg).basic_lstm(
            _data(L, "x", [b, t, d]), _data(L, "h0", [1, b, h]),
            _data(L, "c0", [1, b, h]), h,
            sequence_length=_data(L, "len", [b], "int32"), forget_bias=1.0,
            param_attr=pkg.ParamAttr(name="lp"),
            bias_attr=pkg.ParamAttr(name="lb"))

    jo, to, p = twin(build, {"x": x, "h0": h0, "c0": c0, "len": lengths})
    want, want_lh, want_lc = _golden_basic_lstm(
        x, p["lp_w_layers_0"], p["lb_b_layers_0"], h0[0], c0[0], 1.0,
        lengths)
    np.testing.assert_allclose(to[0], want, rtol=GOLD_RTOL, atol=GOLD_ATOL)
    np.testing.assert_allclose(to[1][0], want_lh, rtol=GOLD_RTOL,
                               atol=GOLD_ATOL)
    np.testing.assert_allclose(to[2][0], want_lc, rtol=GOLD_RTOL,
                               atol=GOLD_ATOL)
    _same(jo, to)


def test_basic_lstm_time_major_roundtrip():
    b, t, d, h = 2, 3, 4, 5
    x = RS.randn(t, b, d).astype("float32")
    jo, to = both(lambda pkg, L: _contrib(pkg).basic_lstm(
        _data(L, "x", [t, b, d]), None, None, h, batch_first=False)[0],
        {"x": x})
    assert to[0].shape == (t, b, h)
    _same(jo, to)


# ---------------------------------------------------------------------------
# this file's own: ragged batches under is_reverse, and the gradients
# ---------------------------------------------------------------------------

B, T, D, H = 3, 6, 4, 5
LENS = np.array([6, 3, 1], np.int64)


def _ragged_x():
    return np.random.RandomState(9).randn(B, T, D).astype(np.float32)


RECURRENCES = {
    "dynamic_lstm": lambda pkg, L, x, n, rev: list(L.dynamic_lstm(
        x, 4 * H, length=n, is_reverse=rev)),
    "dynamic_lstm_nopeep": lambda pkg, L, x, n, rev: list(L.dynamic_lstm(
        x, 4 * H, length=n, is_reverse=rev, use_peepholes=False)),
    "dynamic_gru": lambda pkg, L, x, n, rev: [L.dynamic_gru(
        x, H, length=n, is_reverse=rev)],
    "dynamic_gru_origin": lambda pkg, L, x, n, rev: [L.dynamic_gru(
        x, H, length=n, is_reverse=rev, origin_mode=True)],
    "dynamic_lstmp": lambda pkg, L, x, n, rev: list(L.dynamic_lstmp(
        x, 4 * H, 2, length=n, is_reverse=rev)),
}


@pytest.mark.parametrize("rev", [False, True])
@pytest.mark.parametrize("name", sorted(RECURRENCES))
def test_ragged_recurrence_and_grads(name, rev):
    """A ragged batch (lengths 6, 3, 1): every output, padded positions
    included (the carried state there, not 0), and each parameter's and
    the input's gradient of a loss over all positions, against JAX from
    one scope."""
    x = _ragged_x()
    grads = []

    def build(pkg, L):
        xv = _data(L, "x", [B, T, D])
        xv.stop_gradient = False
        outs = RECURRENCES[name](pkg, L, xv, _data(L, "n", [B], "int64"),
                                 rev)
        loss = L.reduce_sum(L.elementwise_mul(outs[0], outs[0]))
        pgs = pkg.append_backward(loss)
        grads[:] = [g.name for _p, g in pgs]
        return outs

    jo, to = both(build, {"x": x, "n": LENS})
    k = len(jo) - len(grads)
    _same(jo[:k], to[:k])
    hid = to[0]
    # padded positions hold the carried state: forward, the state at the
    # row's end; reversed, the initial (zero) state
    for row, n in enumerate(LENS):
        if n < T:
            want = np.zeros_like(hid[row, n]) if rev else hid[row, n - 1]
            np.testing.assert_allclose(hid[row, n:], np.broadcast_to(
                want, hid[row, n:].shape), rtol=0, atol=0)
    for g_name, a, b in zip(grads, jo[k:], to[k:]):
        grad_close(b, a, GRAD_TOL, g_name)


def _ragged_grads(build, feed):
    """Like both(), with each parameter's gradient appended."""
    names = []

    def b2(pkg, L):
        outs = build(pkg, L)
        pgs = pkg.append_backward(L.reduce_sum(outs[0]))
        names[:] = [g.name for _p, g in pgs]
        return outs
    jo, to = both(b2, feed)
    return jo, to, len(names)


def test_lstm_layer_stacked_bidirectional():
    """fluid.layers.lstm: two layers, bidirectional, ragged: the
    sequence output and the final states against JAX, with the
    gradients."""
    x = _ragged_x()
    jo, to, ng = _ragged_grads(lambda pkg, L: list(L.lstm(
        _data(L, "x", [B, T, D]), None, None, T, hidden_size=H,
        num_layers=2, length=_data(L, "n", [B], "int64"), is_bidirec=True)),
        {"x": x, "n": LENS})
    assert to[0].shape == (B, T, 2 * H) and to[1].shape == (B, 2 * H)
    _same(jo[:3], to[:3])
    for a, b in zip(jo[3:], to[3:]):
        grad_close(b, a, GRAD_TOL)


def test_basic_rnn_layers_ragged_bidirectional_grads():
    """basic_gru and basic_lstm, two bidirectional layers over the ragged
    batch: outputs, last states and the gradients against JAX."""
    x = _ragged_x()
    for fn in ("basic_gru", "basic_lstm"):
        def build(pkg, L):
            f = getattr(_contrib(pkg), fn)
            args = (None,) if fn == "basic_gru" else (None, None)
            return list(f(_data(L, "x", [B, T, D]), *args, H, num_layers=2,
                          bidirectional=True,
                          sequence_length=_data(L, "n", [B], "int64")))
        jo, to, ng = _ragged_grads(build, {"x": x, "n": LENS})
        k = len(jo) - ng
        _same(jo[:k], to[:k])
        for a, b in zip(jo[k:], to[k:]):
            grad_close(b, a, GRAD_TOL, fn)


# ---------------------------------------------------------------------------
# op twins
# ---------------------------------------------------------------------------

def test_lstm_unit_and_gru_unit_ops():
    b, h = 4, 3
    gates = RS.randn(b, 4 * h).astype(np.float32)
    c_prev = RS.randn(b, h).astype(np.float32)
    for slot in ("Hidden", "Cell"):
        assert_twin(*op_twin("lstm_unit", {"X": gates, "C_prev": c_prev},
                             {"forget_bias": 0.5}, slot,
                             grad=("X", "C_prev")), RNN_RTOL, RNN_ATOL)
    ins = {"Input": RS.randn(b, 3 * h).astype(np.float32),
           "HiddenPrev": RS.randn(b, h).astype(np.float32),
           "Weight": RS.randn(h, 3 * h).astype(np.float32),
           "Bias": RS.randn(3 * h).astype(np.float32)}
    for om in (False, True):
        for slot in ("Hidden", "Gate", "ResetHiddenPrev"):
            assert_twin(*op_twin("gru_unit", ins, {"origin_mode": om}, slot,
                                 grad=tuple(ins)), RNN_RTOL, RNN_ATOL)


@pytest.mark.parametrize("h0", [None, "proj", "cell"])
def test_lstmp_op_initial_states(h0):
    """lstmp with no H0, an H0 in projection space, and one in cell
    space (projected first), ragged and reversed, peepholes on: outputs
    and every input's gradient."""
    b, t, d, h, p = 3, 5, 4, 6, 2
    ins = {"Input": RS.randn(b, t, d).astype(np.float32),
           "WeightX": (RS.randn(d, 4 * h) * .5).astype(np.float32),
           "WeightH": (RS.randn(p, 4 * h) * .5).astype(np.float32),
           "ProjWeight": (RS.randn(h, p) * .5).astype(np.float32),
           "Bias": RS.randn(7 * h).astype(np.float32),
           "Length": np.array([5, 2, 4], np.int64),
           "C0": RS.randn(b, h).astype(np.float32)}
    if h0 is not None:
        ins["H0"] = RS.randn(b, p if h0 == "proj" else h).astype(np.float32)
    grad = tuple(k for k in ins if k != "Length")
    for slot in ("Projection", "Cell", "LastH"):
        assert_twin(*op_twin("lstmp", ins, {"use_peepholes": True,
                                            "is_reverse": True,
                                            "proj_activation": "relu"},
                             slot, grad=grad), RNN_RTOL, RNN_ATOL)


def test_ragged_lstm_stack_at_dp2_equals_dp1():
    """Two dynamic_lstm layers over ragged rows at dp 2 (a rank's rows
    with its lengths) against dp 1: outputs equal."""
    x = _ragged_x()
    feed = {"x": np.concatenate([x, x[::-1]]),
            "n": np.concatenate([LENS, LENS[::-1]])}

    def build(L, xv, nv):
        hid, _c = L.dynamic_lstm(xv, 4 * H, length=nv)
        hid2, _c2 = L.dynamic_lstm(hid, 4 * H, length=nv, is_reverse=True)
        return [hid2, L.sequence_pool(hid2, "last", length=nv)]

    one = _port_dp(build, feed, [CPU])
    two = _port_dp(build, feed, [CPU] * 2)
    for a, b in zip(two, one):
        np.testing.assert_array_equal(a, b)
