"""The port's CRF, CTC and sequence-metric ops against the JAX package, on
the CPU: ``ops/crf_ops.py`` (``linear_chain_crf``, ``crf_decoding``),
``ops/ctc_ops.py`` (``warpctc``, ``ctc_align`` / ``ctc_greedy_decoder``)
and ``ops/metric_ops.py``'s ``edit_distance`` and ``chunk_eval``, with
their layers.

Twins of the JAX package's tests run the same layers through both
packages' Programs from one carried scope
(``test_torch_sequence_ops.twin``) and hold the port to the reference
test's golden (a brute-force enumeration, torch's ``F.ctc_loss``, a
Python oracle) and to JAX's output: ``tests/ops/test_crf.py`` (2),
``tests/ops/test_ctc.py`` (3), ``tests/ops/test_uncovered_ops_r4.py::
test_ctc_align_merges_and_drops``, ``tests/ops/test_uncovered_ops.py::
test_ctc_align_greedy_decode`` and ``::test_chunk_eval_iob_counts``, and
``tests/ops/test_extended_ops.py::test_edit_distance``. Three CTC cases
of this file's own: an infeasible alignment (the finite loss of
NEG_INF = -1e30, where ``F.ctc_loss`` gives inf), an empty label, and a
gradient through states at NEG_INF that stays finite (the
double-where). Viterbi paths are compared exactly, with the positions
whose top two scores lie within NEAR_TIE listed and excused (none in
these draws). The dp twins hold the CRF's loss and gradients,
``chunk_eval``'s counts and ``edit_distance``'s SequenceNum at dp 2
against dp 1.
"""

import itertools

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid

import paddle_tpu_torch as fluid

from test_torch_seq2seq import _port_dp, assert_twin, op_twin
from test_torch_sequence_ops import _data, both, grad_close

CPU = fluid.CPUPlace()
# the CRF's and CTC's losses and alpha tables in f32 (logsumexp chains of
# T steps in each package; measured at most 9.2e-8 of the largest entry
# against JAX, 7.5e-7 against F.ctc_loss's gradient), their gradients
# within 1e-4 of the largest entry (measured at most 8.5e-7)
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
GRAD_TOL = 1e-4
# a Viterbi position whose two best scores lie this close may break
# either way once the sums run in another order
NEAR_TIE = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_bert.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _brute(em, w, lengths):
    """All tag sequences: (logZ, best path, best score) a row."""
    start, end, trans = w[0], w[1], w[2:]
    b, t, n = em.shape
    logzs, paths = [], []
    for row in range(b):
        ln = lengths[row]
        best, best_p, total = -np.inf, None, []
        for tags in itertools.product(range(n), repeat=ln):
            s = start[tags[0]] + end[tags[ln - 1]]
            s += sum(em[row, i, tags[i]] for i in range(ln))
            s += sum(trans[tags[i - 1], tags[i]] for i in range(1, ln))
            total.append(s)
            if s > best:
                best, best_p = s, tags
        m = np.max(total)
        logzs.append(m + np.log(np.sum(np.exp(np.array(total) - m))))
        paths.append(list(best_p) + [0] * (t - ln))
    return np.array(logzs), np.array(paths)


def near_ties(em, w, lengths, tol=NEAR_TIE):
    """The (row, step) positions whose Viterbi step has its two best
    candidate scores within `tol` (float64 recomputation)."""
    em, w = em.astype(np.float64), w.astype(np.float64)
    start, end, trans = w[0], w[1], w[2:]
    ties = []
    for row in range(em.shape[0]):
        delta = start + em[row, 0]
        for s in range(1, lengths[row]):
            cand = delta[:, None] + trans
            top = np.sort(cand, axis=0)[-2:]
            if (top[1] - top[0]).min() <= tol:
                ties.append((row, s))
            delta = cand.max(0) + em[row, s]
        last = np.sort(delta + end)[-2:]
        if last[1] - last[0] <= tol:
            ties.append((row, int(lengths[row]) - 1))
    return ties


def assert_paths(got, want, ties):
    bad = [(r, s) for r, s in zip(*np.nonzero(got != want))
           if (r, s) not in ties]
    assert not bad, (bad, ties)


# ---------------------------------------------------------------------------
# twins of the JAX package's tests
# ---------------------------------------------------------------------------

def _crf_net(b, t, n):
    def build(pkg, L):
        ev = _data(L, "em", [b, t, n])
        lv = _data(L, "lb", [b, t], "int64")
        lnv = _data(L, "ln", [b], "int64")
        nll = L.linear_chain_crf(ev, lv, param_attr=pkg.ParamAttr(
            name="crf_w"), length=lnv)
        path = L.crf_decoding(ev, param_attr=pkg.ParamAttr(name="crf_w"),
                              length=lnv)
        return [nll, path]
    return build


def test_crf_nll_and_viterbi_match_brute_force():
    """test_crf.py: the NLL of the fed labels and the Viterbi path
    against an enumeration of every tag sequence, lengths 5, 3, 4."""
    rng = np.random.default_rng(0)
    b, t, n = 3, 5, 4
    em = rng.standard_normal((b, t, n)).astype(np.float32)
    labels = rng.integers(0, n, (b, t)).astype(np.int64)
    lengths = np.array([5, 3, 4], np.int64)
    w = np.random.default_rng(7).standard_normal((n + 2, n)).astype(
        np.float32)
    jo, to = both(_crf_net(b, t, n), {"em": em, "lb": labels, "ln": lengths},
                  sets={"crf_w": w})
    nll, path = to
    logz, best_path = _brute(em, w, lengths)
    start, end, trans = w[0], w[1], w[2:]
    for row in range(b):
        ln = lengths[row]
        tags = labels[row, :ln]
        s = start[tags[0]] + end[tags[-1]] + em[row, np.arange(ln), tags] \
            .sum() + trans[tags[:-1], tags[1:]].sum()
        np.testing.assert_allclose(nll[row, 0], logz[row] - s, rtol=1e-4,
                                   atol=1e-4)
    ties = near_ties(em, w, lengths)
    assert_paths(path, best_path, ties)
    assert path.dtype == np.int64
    np.testing.assert_allclose(nll, jo[0], rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert_paths(path, jo[1], ties)


def test_crf_trains_to_memorize_tags():
    """test_crf.py: an fc + CRF memorizes 8 tag sequences: 150 Adam(0.1)
    steps take the loss below 0.2x the first, and the decoded tags match
    the labels at > 95 % of positions; the first five losses follow
    JAX's from one scope."""
    rng = np.random.default_rng(1)
    b, t, n = 8, 6, 3
    x = rng.standard_normal((b, t, 5)).astype(np.float32)
    labels = rng.integers(0, n, (b, t)).astype(np.int64)
    feed = {"x": x, "lb": labels, "ln": np.full((b,), t, np.int64)}

    def build(pkg, L):
        xv = _data(L, "x", [b, t, 5])
        lv = _data(L, "lb", [b, t], "int64")
        lnv = _data(L, "ln", [b], "int64")
        h = L.fc(xv, size=64, act="relu", num_flatten_dims=2)
        em = L.fc(h, size=n, num_flatten_dims=2)
        loss = L.mean(L.linear_chain_crf(
            em, lv, param_attr=pkg.ParamAttr(name="crf_w2"), length=lnv))
        pkg.optimizer.AdamOptimizer(learning_rate=0.1).minimize(loss)
        path = L.crf_decoding(em, param_attr=pkg.ParamAttr(name="crf_w2"),
                              length=lnv)
        return [loss, path]

    progs = {}
    for pkg in (jfluid, fluid):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.core.unique_name.guard(), pkg.program_guard(main, startup):
            progs[pkg] = (main, startup, build(pkg, pkg.layers))
    from paddle_tpu.core.executor import Scope as JScope, scope_guard
    jmain, jstart, jres = progs[jfluid]
    tmain, tstart, tres = progs[fluid]
    jl = []
    with scope_guard(JScope()) as _s:
        jexe = jfluid.Executor()
        jexe.run(jstart)
        init = {nm: np.array(jfluid.global_scope().get(nm))
                for nm in jfluid.global_scope().names()}
        for _ in range(5):
            jl.append(float(np.asarray(jexe.run(
                jmain, feed=feed, fetch_list=[jres[0]])[0]).reshape(())))
    scope = fluid.Scope()
    exe = fluid.Executor(CPU)
    exe.run(tstart, scope=scope)
    fluid.scope_from_numpy(init, "cpu", scope)
    losses = [float(np.asarray(exe.run(tmain, feed=feed, fetch_list=[
        tres[0]], scope=scope)[0]).reshape(())) for _ in range(150)]
    np.testing.assert_allclose(losses[:5], jl, rtol=1e-5)
    assert losses[-1] < losses[0] * 0.2, (losses[0], losses[-1])
    decoded = exe.run(tmain, feed=feed, fetch_list=[tres[1]], scope=scope)[0]
    assert (decoded == labels).mean() > 0.95


def _torch_ctc(logits, labels, in_len, lab_len, blank=0):
    lp = torch.from_numpy(logits).log_softmax(-1).transpose(0, 1)
    return torch.nn.functional.ctc_loss(
        lp, torch.from_numpy(labels), torch.from_numpy(in_len),
        torch.from_numpy(lab_len), blank=blank, reduction="none",
        zero_infinity=False).numpy()


def _ctc_net(b, t, c, ln):
    def build(pkg, L):
        xv = _data(L, "x", [b, t, c])
        xv.stop_gradient = False
        loss = L.warpctc(xv, _data(L, "l", [b, ln], "int32"),
                         input_length=_data(L, "il", [b], "int64"),
                         label_length=_data(L, "ll", [b], "int64"))
        grad, = pkg.gradients([L.reduce_sum(loss)], [xv])
        return [loss, grad]
    return build


def test_warpctc_matches_torch():
    """test_ctc.py: the loss of feasible rows against F.ctc_loss."""
    rng = np.random.default_rng(0)
    b, t, c, ln = 4, 12, 6, 5
    feed = {"x": rng.standard_normal((b, t, c)).astype(np.float32),
            "l": rng.integers(1, c, (b, ln)).astype(np.int32),
            "il": np.array([12, 10, 12, 8], np.int64),
            "ll": np.array([5, 3, 4, 2], np.int64)}
    jo, to = both(_ctc_net(b, t, c, ln), feed)
    ref = _torch_ctc(feed["x"], feed["l"], feed["il"], feed["ll"])
    np.testing.assert_allclose(to[0].reshape(-1), ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(to[0], jo[0], rtol=LOSS_RTOL, atol=LOSS_ATOL)


def test_warpctc_grad_matches_torch():
    """test_ctc.py: d sum(loss) / d logits through the framework's
    backward against torch's."""
    rng = np.random.default_rng(1)
    b, t, c, ln = 2, 8, 5, 3
    feed = {"x": rng.standard_normal((b, t, c)).astype(np.float32),
            "l": rng.integers(1, c, (b, ln)).astype(np.int32),
            "il": np.array([8, 6], np.int64),
            "ll": np.array([3, 2], np.int64)}
    lt = torch.from_numpy(feed["x"]).clone().requires_grad_(True)
    torch.nn.functional.ctc_loss(
        lt.log_softmax(-1).transpose(0, 1), torch.from_numpy(feed["l"]),
        torch.from_numpy(feed["il"]), torch.from_numpy(feed["ll"]),
        blank=0, reduction="sum").backward()
    jo, to = both(_ctc_net(b, t, c, ln), feed)
    np.testing.assert_allclose(to[1], lt.grad.numpy(), rtol=2e-3, atol=2e-3)
    grad_close(to[1], jo[1], GRAD_TOL)


def test_ctc_greedy_decoder():
    """test_ctc.py: argmax path [1, 1, 0, 2, 2, 0, 1] -> [1, 2, 1], the
    rest -1."""
    path = [1, 1, 0, 2, 2, 0, 1]
    probs = np.full((1, len(path), 4), 0.1, np.float32)
    for t, c in enumerate(path):
        probs[0, t, c] = 0.9
    jo, to = both(lambda pkg, L: list(L.ctc_greedy_decoder(
        _data(L, "x", [1, len(path), 4]), blank=0)), {"x": probs})
    o, n = to
    assert n[0, 0] == 3 and n.dtype == np.int64
    np.testing.assert_array_equal(o[0, :3], [1, 2, 1])
    assert (o[0, 3:] == -1).all()
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(b, a)


def test_ctc_align_merges_and_drops():
    """test_uncovered_ops_r4.py: [a a blank b b] -> [a b], the op
    alone."""
    probs = np.zeros((1, 5, 4), np.float32)
    for step, cls in enumerate([2, 2, 0, 3, 3]):
        probs[0, step, cls] = 1.0
    j, t, _g = op_twin("ctc_align", {"Input": probs}, {"blank": 0}, "Output")
    assert list(t[0, :2]) == [2, 3] and (t[0, 2:] == -1).all()
    np.testing.assert_array_equal(t, j)
    j, t, _g = op_twin("ctc_align", {"Input": probs}, {"blank": 0},
                       "OutputLength")
    assert int(t.reshape(-1)[0]) == 2
    np.testing.assert_array_equal(t, j)


def test_ctc_align_greedy_decode():
    """test_uncovered_ops.py: (B, T, C) one-hot probabilities through the
    public wrapper: merge repeats, then drop blanks."""
    toks = np.array([[1, 1, 0, 2, 2, 0, 3], [0, 4, 4, 4, 0, 0, 0]], np.int32)
    probs = np.eye(5, dtype=np.float32)[toks]
    jo, to = both(lambda pkg, L: list(L.ctc_greedy_decoder(
        L.data("t", shape=[7, 5], dtype="float32"), blank=0)),
        {"t": probs})
    got, gl = to
    gl = gl.ravel()
    assert list(got[0][:gl[0]]) == [1, 2, 3]
    assert list(got[1][:gl[1]]) == [4]
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(b, a)


def test_chunk_eval_iob_counts():
    """test_uncovered_ops.py: label [B0 I0 O B1], prediction [B0 I0 B1
    O]: one exact span, one predicted-only, one label-only."""
    lab = np.array([[0, 1, 4, 2]], np.int64)
    inf = np.array([[0, 1, 2, 4]], np.int64)
    jo, to = both(lambda pkg, L: list(L.chunk_eval(
        L.data("inf", shape=[4], dtype="int64"),
        L.data("lab", shape=[4], dtype="int64"), chunk_scheme="IOB",
        num_chunk_types=2)), {"lab": lab, "inf": inf})
    gp, gr_, _gf, gi, gl, gcor = to
    assert int(gi.ravel()[0]) == 2 and int(gl.ravel()[0]) == 2
    assert int(gcor.ravel()[0]) == 1
    np.testing.assert_allclose(gp.ravel()[0], 0.5, rtol=1e-6)
    np.testing.assert_allclose(gr_.ravel()[0], 0.5, rtol=1e-6)
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(b, a)


def test_edit_distance():
    """test_extended_ops.py: [1, 2, 3] vs [1, 3, 3] is 1 substitution,
    [1] * 4 vs [2] * 3 is 4."""
    feed = {"hyp": np.array([[1, 2, 3, 0], [1, 1, 1, 1]], np.int64),
            "ref": np.array([[1, 3, 3, 0], [2, 2, 2, 0]], np.int64),
            "hl": np.array([[3], [4]], np.int64),
            "rl": np.array([[3], [3]], np.int64)}
    jo, to = both(lambda pkg, L: list(L.edit_distance(
        L.data("hyp", shape=[4], dtype="int64"),
        L.data("ref", shape=[4], dtype="int64"), normalized=False,
        input_length=L.data("hl", shape=[1], dtype="int64"),
        label_length=L.data("rl", shape=[1], dtype="int64"))), feed)
    np.testing.assert_allclose(to[0].ravel(), [1.0, 4.0])
    assert int(to[1].ravel()[0]) == 2
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(b, a)


# ---------------------------------------------------------------------------
# CTC: this file's own cases
# ---------------------------------------------------------------------------

def _ctc_op(logits, labels, in_len, lab_len, attrs=None):
    return op_twin("warpctc", {"Logits": logits, "Label": labels,
                               "LogitsLength": in_len,
                               "LabelLength": lab_len}, attrs or {}, "Loss",
                   grad=("Logits",))


def test_ctc_infeasible_alignment_is_finite():
    """A label of 3 distinct ids over 2 steps (and one of 2 equal ids,
    which need a blank between them, over 2 steps) cannot align: the loss
    is about 1e30, finite, where F.ctc_loss gives inf; the feasible row
    beside them equals F.ctc_loss; the gradient is finite."""
    rng = np.random.RandomState(3)
    logits = rng.randn(3, 4, 5).astype(np.float32)
    labels = np.array([[1, 2, 3], [2, 2, 0], [1, 2, 0]], np.int64)
    in_len = np.array([2, 2, 4], np.int64)
    lab_len = np.array([3, 2, 2], np.int64)
    j, t, g = _ctc_op(logits, labels, in_len, lab_len)
    assert np.isfinite(t).all() and (t[:2] > 1e29).all()
    ref = _torch_ctc(logits, labels, in_len, lab_len)
    assert np.isinf(ref[:2]).all()
    np.testing.assert_allclose(t[2, 0], ref[2], rtol=2e-5)
    assert np.isfinite(g["Logits"][1]).all()
    assert_twin(j, t, g, LOSS_RTOL, LOSS_ATOL)


def test_ctc_empty_label():
    """A label of length 0: the loss is -log of the all-blank path,
    sum_t -log p(blank), as F.ctc_loss gives it; JAX's gradient."""
    rng = np.random.RandomState(4)
    logits = rng.randn(2, 5, 4).astype(np.float32)
    labels = np.array([[2, 3], [1, 1]], np.int64)
    in_len = np.array([5, 3], np.int64)
    lab_len = np.array([0, 0], np.int64)
    j, t, g = _ctc_op(logits, labels, in_len, lab_len)
    lp = torch.from_numpy(logits).log_softmax(-1).numpy()
    want = [-lp[r, :in_len[r], 0].sum() for r in range(2)]
    np.testing.assert_allclose(t.ravel(), want, rtol=1e-6)
    assert_twin(j, t, g, LOSS_RTOL, LOSS_ATOL)


def test_ctc_gradient_at_neg_inf_states_is_finite():
    """Rows whose lattices hold states at NEG_INF for many steps (a
    label as long as the input, repeated ids, an input of one step): the
    double-where keeps every gradient entry finite, and equal to JAX's;
    norm_by_times divides by the input lengths."""
    rng = np.random.RandomState(5)
    logits = (rng.randn(3, 6, 4) * 4).astype(np.float32)
    labels = np.array([[1, 2, 1, 3, 2, 1], [3, 3, 3, 0, 0, 0],
                       [2, 0, 0, 0, 0, 0]], np.int64)
    in_len = np.array([6, 6, 1], np.int64)
    lab_len = np.array([6, 3, 1], np.int64)
    for attrs in ({}, {"norm_by_times": True}):
        j, t, g = _ctc_op(logits, labels, in_len, lab_len, attrs)
        assert np.isfinite(g["Logits"][1]).all()
        assert np.isfinite(t).all()
        assert_twin(j, t, g, LOSS_RTOL, LOSS_ATOL)


# ---------------------------------------------------------------------------
# op twins
# ---------------------------------------------------------------------------

def _crf_inputs(seed, b=4, t=7, n=5):
    rng = np.random.RandomState(seed)
    return {"Emission": rng.randn(b, t, n).astype(np.float32),
            "Transition": rng.randn(n + 2, n).astype(np.float32),
            "Label": rng.randint(0, n, (b, t)).astype(np.int64),
            "Length": np.array([7, 1, 4, 6][:b], np.int64)}


@pytest.mark.parametrize("slot", ["LogLikelihood", "Alpha",
                                  "EmissionExps", "TransitionExps"])
def test_linear_chain_crf_op(slot):
    """Each output against JAX's, and the gradients of the loss and the
    alpha table with respect to the emissions and the transition."""
    ins = _crf_inputs(0)
    grad = ("Emission", "Transition") if slot in ("LogLikelihood",
                                                  "Alpha") else ()
    j, t, g = op_twin("linear_chain_crf", ins, {}, slot, grad=grad)
    np.testing.assert_allclose(t, j, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    for k, (jg, tg) in g.items():
        grad_close(tg, jg, GRAD_TOL, k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crf_decoding_op(seed):
    """The Viterbi path against JAX's, exactly (near ties listed), 0 past
    the lengths; with a Label, the mismatch mask; a 3-D (B, T, 1) label
    is read as (B, T)."""
    ins = _crf_inputs(seed)
    ties = near_ties(ins["Emission"], ins["Transition"], ins["Length"])
    dec = {k: v for k, v in ins.items() if k != "Label"}
    j, t, _g = op_twin("crf_decoding", dec, {}, "ViterbiPath")
    assert_paths(t, j, ties)
    for row, n in enumerate(ins["Length"]):
        assert not t[row, n:].any()
    j, t, _g = op_twin("crf_decoding", dict(
        ins, Label=ins["Label"][..., None]), {}, "ViterbiPath")
    assert_paths(t, j, ties)
    assert t.dtype == np.int64


def test_edit_distance_and_chunk_eval_ops():
    rng = np.random.RandomState(6)
    hyp, ref = rng.randint(0, 3, (5, 7)), rng.randint(0, 3, (5, 6))
    ins = {"Hyps": hyp, "Refs": ref,
           "HypsLength": np.array([7, 3, 0, 2, 5]),
           "RefsLength": np.array([6, 6, 2, 0, 3])}
    for normalized in (False, True):
        j, t, _g = op_twin("edit_distance", ins,
                           {"normalized": normalized}, "Out")
        np.testing.assert_allclose(t, j, rtol=1e-7)
    j, t, _g = op_twin("edit_distance", {"Hyps": hyp, "Refs": ref}, {},
                       "Out")
    np.testing.assert_array_equal(t, j)
    labs = rng.randint(0, 7, (6, 9))
    inf = labs.copy()
    flip = rng.rand(6, 9) < 0.3
    inf[flip] = rng.randint(0, 7, flip.sum())
    for lens in (None, np.array([9, 5, 7, 3, 9, 1])):
        ins = {"Inference": inf, "Label": labs}
        if lens is not None:
            ins["SeqLength"] = lens
        for slot in ("Precision", "Recall", "F1-Score", "NumInferChunks",
                     "NumLabelChunks", "NumCorrectChunks"):
            j, t, _g = op_twin("chunk_eval", ins, {"num_chunk_types": 3},
                               slot)
            np.testing.assert_array_equal(t, j)


# ---------------------------------------------------------------------------
# data parallelism
# ---------------------------------------------------------------------------

def test_crf_chunk_eval_and_edit_distance_at_dp2_equal_dp1():
    """The CRF's per-row loss and decode, the mean loss's gradients
    (through a replicated transition), chunk_eval's global counts and
    edit_distance's SequenceNum at dp 2 against dp 1."""
    ins = _crf_inputs(3)
    feed = {"em": ins["Emission"], "lb": ins["Label"],
            "ln": ins["Length"]}

    def build(L, ev, lv, lnv):
        nll = L.linear_chain_crf(ev, lv, param_attr=fluid.ParamAttr(
            name="crf_dp"), length=lnv)
        loss = L.mean(nll)
        fluid.append_backward(loss)
        path = L.crf_decoding(ev, param_attr=fluid.ParamAttr(name="crf_dp"),
                              length=lnv)
        chunks = L.chunk_eval(path, lv, "IOB", 2, seq_length=lnv)
        dist, num = L.edit_distance(path, lv, input_length=lnv,
                                    label_length=lnv)
        return [nll, loss, "crf_dp@GRAD", path, dist, num] + list(chunks)

    one = _port_dp(build, feed, [CPU])
    two = _port_dp(build, feed, [CPU] * 2)
    assert int(two[5].reshape(-1)[0]) == 4
    for i, (a, b) in enumerate(zip(two, one)):
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7,
                                       err_msg=str(i))
        else:
            np.testing.assert_array_equal(a, b, err_msg=str(i))
