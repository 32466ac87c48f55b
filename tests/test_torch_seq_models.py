"""The four sequence models of the port against the JAX package, on the
CPU: ``models/label_semantic_roles.py`` (db_lstm + linear-chain CRF),
``models/lstm_text.py`` (stacked-LSTM sentiment),
``models/ocr_recognition.py`` (CRNN-CTC) and ``models/recommender.py``.

Each model builds the JAX package's graph (the same op types, the same
parameters by name and shape). Twins of the JAX package's tests train
the port's model from JAX's startup scope carried over
(``scope_from_numpy``) and hold the reference test's bar:
``tests/models/test_model_zoo.py``'s ``test_lstm_sentiment_trains``,
``test_label_semantic_roles_trains_and_decodes`` and
``test_recommender_trains``, and ``tests/models/test_ocr.py::
test_crnn_ctc_overfits_and_transcribes``. Each model's first loss and
every @GRAD of its first step match JAX's from one scope, and its first
steps' losses follow JAX's. SRL at dp 2 through ``with_data_parallel``
matches dp 1 and JAX's ``with_data_parallel`` over two CPU devices.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu.core import unique_name as jun
from paddle_tpu.core.executor import Scope as JScope, scope_guard as jguard
from paddle_tpu.models import label_semantic_roles as jsrl
from paddle_tpu.models import lstm_text as jlstm
from paddle_tpu.models import ocr_recognition as jocr
from paddle_tpu.models import recommender as jrec

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import unique_name as tun
from paddle_tpu_torch.models import label_semantic_roles as tsrl
from paddle_tpu_torch.models import lstm_text as tlstm
from paddle_tpu_torch.models import ocr_recognition as tocr
from paddle_tpu_torch.models import recommender as trec

from test_torch_sequence_ops import grad_close

CPU = fluid.CPUPlace()
# each model's losses against JAX's from one scope, over its first steps
# (measured at most 4.6e-6 relative, the sentiment net's fourth Adam
# step; the others at most 2.3e-7)
LOSS_RTOL = 1e-5
# each first-step @GRAD within this share of the step's largest @GRAD
# (measured at most 1.0e-6 of it)
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_bert.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _build(pkg, un, net, seed=11):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with un.guard(), pkg.program_guard(main, startup):
        loss, extra = net(pkg)
    return main, startup, loss, extra


def _jax_init(jstart):
    scope = JScope()
    with jguard(scope):
        jfluid.Executor().run(jstart)
    return {n: np.asarray(scope.get(n)) for n in scope.names()}


def _jscope(init):
    scope = JScope()
    for n, v in init.items():
        scope.set(n, jnp.asarray(v))
    return scope


class Twin:
    """A model built in both packages, with JAX's startup values."""

    def __init__(self, net):
        self.jmain, jstart, self.jloss, self.jextra = _build(jfluid, jun, net)
        self.tmain, _ts, self.tloss, self.textra = _build(fluid, tun, net)
        self.init = _jax_init(jstart)
        self.grads = [p.name + "@GRAD" for p in self.tmain.all_parameters()]

    def port_scope(self):
        return fluid.scope_from_numpy(self.init, "cpu")

    def port_steps(self, feeds, fetch=()):
        scope, exe = self.port_scope(), fluid.Executor(CPU)
        return [[np.asarray(v) for v in exe.run(
            self.tmain, feed=f, fetch_list=[self.tloss, *fetch],
            scope=scope)] for f in feeds], scope, exe

    def jax_steps(self, feeds, fetch=()):
        out = []
        with jguard(_jscope(self.init)):
            exe = jfluid.Executor()
            for f in feeds:
                out.append([np.asarray(v) for v in exe.run(
                    self.jmain, feed=f, fetch_list=[self.jloss, *fetch])])
        return out

    def assert_graph(self):
        assert [op.type for op in self.tmain.global_block().ops] == \
            [op.type for op in self.jmain.global_block().ops]
        assert [(p.name, tuple(p.shape)) for p in
                self.tmain.all_parameters()] == \
            [(p.name, tuple(p.shape)) for p in self.jmain.all_parameters()]

    def assert_first_steps(self, feeds):
        """The losses of len(feeds) steps and the first step's @GRADs
        against JAX's."""
        got, _s, _e = self.port_steps(feeds[:1], self.grads)
        want = self.jax_steps(feeds[:1], self.grads)
        gmax = max(float(np.abs(g).max()) for g in want[0][1:])
        for name, a, b in zip(self.grads, got[0][1:], want[0][1:]):
            grad_close(a, b, GRAD_TOL, name, gmax)
        got = [float(v[0]) for v in self.port_steps(feeds)[0]]
        want = [float(v[0]) for v in self.jax_steps(feeds)]
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
        return got


# ---------------------------------------------------------------------------
# semantic role labeling
# ---------------------------------------------------------------------------

SRL_B, SRL_T = 4, 8


def _srl_net(pkg):
    m = jsrl if pkg is jfluid else tsrl
    _f, _t, _l, cost, decode = m.build_train_net(SRL_B, SRL_T, hidden_dim=32)
    pkg.optimizer.AdamOptimizer(learning_rate=0.02).minimize(cost)
    return cost, decode


def _srl_feed(seed=9, lengths=(8, 6, 8, 5)):
    rng = np.random.default_rng(seed)
    feed = {name: rng.integers(0, 40, (SRL_B, SRL_T)).astype(np.int64)
            for name in tsrl.FEATURE_NAMES}
    feed["predicate"] %= tsrl.PRED_DICT_LEN
    feed["mark"] %= tsrl.MARK_DICT_LEN
    feed["target"] = rng.integers(0, tsrl.LABEL_DICT_LEN,
                                  (SRL_B, SRL_T)).astype(np.int64)
    feed["length"] = np.array(lengths, np.int64)
    return feed


@pytest.fixture(scope="module")
def srl():
    twin = Twin(_srl_net)
    return twin


def test_srl_builds_jax_graph(srl):
    srl.assert_graph()


def test_label_semantic_roles_trains_and_decodes(srl):
    """test_model_zoo.py: 40 Adam(0.02) steps on one batch of ragged
    sentences, the last loss below half the first, and the decoded tags
    equal the targets at > 50 % of the valid positions."""
    feed = _srl_feed()
    out, scope, exe = srl.port_steps([feed] * 40)
    losses = [float(v[0]) for v in out]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
    dec = exe.run(srl.tmain, feed=feed, fetch_list=[srl.textra],
                  scope=scope)[0]
    assert dec.shape == (SRL_B, SRL_T)
    mask = np.arange(SRL_T)[None] < feed["length"][:, None]
    assert (dec == feed["target"])[mask].mean() > 0.5
    assert not dec[~mask].any()


def test_srl_first_steps_match_jax(srl):
    srl.assert_first_steps([_srl_feed(seed=s) for s in (1, 2, 3)])


def test_srl_at_dp2_matches_dp1_and_jax(srl):
    """SRL through with_data_parallel at dp 2 (a rank's sentences, its
    lengths; the CRF's transition replicated) against dp 1 and JAX's dp
    2 over two CPU devices, two steps: losses and @GRADs."""
    feed = _srl_feed(seed=4, lengths=(8, 3, 6, 8))
    runs = {}
    for dp in (1, 2):
        comp = fluid.CompiledProgram(srl.tmain).with_data_parallel(
            loss_name=srl.tloss.name, places=[CPU] * dp)
        scope, exe = srl.port_scope(), fluid.Executor(CPU)
        runs[dp] = [[np.asarray(v) for v in exe.run(
            comp, feed=feed, fetch_list=[srl.tloss] + srl.grads,
            scope=scope)] for _ in range(2)]
    jcomp = jfluid.CompiledProgram(srl.jmain).with_data_parallel(
        loss_name=srl.jloss.name,
        places=[jfluid.CUDAPlace(0), jfluid.CUDAPlace(1)])
    with jguard(_jscope(srl.init)):
        exe = jfluid.Executor()
        want = [[np.asarray(v) for v in exe.run(
            jcomp, feed=feed, fetch_list=[srl.jloss] + srl.grads)]
            for _ in range(2)]
    for other, rtol in ((runs[1], 1e-6), (want, LOSS_RTOL)):
        for a, b in zip(runs[2], other):
            np.testing.assert_allclose(a[0], b[0], rtol=rtol)
            gmax = max(float(np.abs(g).max()) for g in b[1:])
            for name, x, y in zip(srl.grads, a[1:], b[1:]):
                grad_close(x, y, GRAD_TOL, name, gmax)


# ---------------------------------------------------------------------------
# stacked-LSTM sentiment
# ---------------------------------------------------------------------------

DICT_DIM, MAX_LEN = 200, 24


def _lstm_net(pkg):
    m = jlstm if pkg is jfluid else tlstm
    _d, _s, _l, pred, loss, acc = m.build_train_net(DICT_DIM,
                                                    max_len=MAX_LEN)
    pkg.optimizer.AdamOptimizer(learning_rate=0.01).minimize(loss)
    return loss, acc


def _lstm_feed(rng, b=4):
    return {"words": rng.randint(0, DICT_DIM, (b, MAX_LEN)).astype(np.int64),
            "seq_len": rng.randint(5, MAX_LEN, (b, 1)).astype(np.int64),
            "label": rng.randint(0, 2, (b, 1)).astype(np.int64)}


def test_lstm_sentiment_trains():
    """test_model_zoo.py: four Adam(0.01) steps on fresh batches of 4,
    every loss finite; the graph is JAX's, and the first steps' losses
    and @GRADs match JAX's."""
    twin = Twin(_lstm_net)
    twin.assert_graph()
    rng = np.random.RandomState(0)
    feeds = [_lstm_feed(rng) for _ in range(4)]
    losses = twin.assert_first_steps(feeds)
    assert np.isfinite(losses).all()


# ---------------------------------------------------------------------------
# the recommender
# ---------------------------------------------------------------------------

def _rec_net(pkg):
    m = jrec if pkg is jfluid else trec
    _v, infer, loss = m.build_train_net(user_vocab=50, movie_vocab=40)
    pkg.optimizer.AdamOptimizer(learning_rate=0.01).minimize(loss)
    return loss, infer


def _rec_feed(rng, b=8):
    return {
        "user_id": rng.randint(0, 50, (b, 1)).astype(np.int64),
        "gender_id": rng.randint(0, 2, (b, 1)).astype(np.int64),
        "age_id": rng.randint(0, 7, (b, 1)).astype(np.int64),
        "job_id": rng.randint(0, 21, (b, 1)).astype(np.int64),
        "movie_id": rng.randint(0, 40, (b, 1)).astype(np.int64),
        "category_ids": rng.randint(0, 19, (b, trec.MAX_CAT_LEN)).astype(
            np.int64),
        "category_len": rng.randint(1, trec.MAX_CAT_LEN, (b, 1)).astype(
            np.int64),
        "title_ids": rng.randint(0, 100, (b, trec.MAX_TITLE_LEN)).astype(
            np.int64),
        "title_len": rng.randint(3, trec.MAX_TITLE_LEN, (b, 1)).astype(
            np.int64),
        "score": rng.uniform(1, 5, (b, 1)).astype(np.float32)}


def test_recommender_trains():
    """test_model_zoo.py: five Adam steps on fresh batches of 8, every
    loss finite; the graph is JAX's, and the first steps' losses and
    @GRADs match JAX's."""
    twin = Twin(_rec_net)
    twin.assert_graph()
    rng = np.random.RandomState(0)
    feeds = [_rec_feed(rng) for _ in range(5)]
    losses = twin.assert_first_steps(feeds)
    assert np.isfinite(losses).all()


# ---------------------------------------------------------------------------
# CRNN-CTC OCR
# ---------------------------------------------------------------------------

OCR_B, OCR_L, OCR_NC = 4, 4, 8


def _ocr_net(pkg):
    m = jocr if pkg is jfluid else tocr
    _i, _l, loss, logits = m.build_train_net(
        img_shape=(1, 16, 64), label_len=OCR_L, num_classes=OCR_NC,
        hidden=24, base_filters=8)
    decoded = m.greedy_transcribe(logits)
    pkg.optimizer.AdamOptimizer(learning_rate=5e-3).minimize(loss)
    return loss, decoded


@pytest.fixture(scope="module")
def ocr():
    return Twin(_ocr_net)


def _ocr_feed():
    rng = np.random.RandomState(0)
    return {"pixels": rng.rand(OCR_B, 1, 16, 64).astype(np.float32),
            "label": rng.randint(1, OCR_NC + 1, size=(OCR_B, OCR_L)).astype(
                np.int64)}


def test_ocr_builds_jax_graph(ocr):
    ocr.assert_graph()


def test_crnn_ctc_overfits_and_transcribes(ocr):
    """test_ocr.py: 120 Adam(5e-3) steps on a fixed batch of 4 take the
    loss below 0.05x the first, and the clone(for_test=True) Program
    transcribes the batch exactly."""
    feed = _ocr_feed()
    out, scope, exe = ocr.port_steps([feed] * 120)
    losses = [float(v[0]) for v in out]
    assert losses[-1] < 0.05 * losses[0], (losses[0], losses[-1])
    test_prog = ocr.tmain.clone(for_test=True)
    dec, dlen = exe.run(test_prog, feed=feed, fetch_list=list(ocr.textra),
                        scope=scope)
    for b in range(OCR_B):
        n = int(dlen[b, 0])
        assert n == OCR_L, (b, n, dec[b])
        np.testing.assert_array_equal(dec[b, :n], feed["label"][b])
        assert (dec[b, n:] == -1).all()


def test_ocr_first_steps_match_jax(ocr):
    ocr.assert_first_steps([_ocr_feed()] * 3)


SLICE_MODULES = ("paddle_tpu_torch", "paddle_tpu_torch.ops.sequence_ops",
                 "paddle_tpu_torch.ops.rnn_ops",
                 "paddle_tpu_torch.ops.crf_ops",
                 "paddle_tpu_torch.ops.ctc_ops",
                 "paddle_tpu_torch.layers.sequence",
                 "paddle_tpu_torch.layers.rnn",
                 "paddle_tpu_torch.contrib.layers",
                 "paddle_tpu_torch.models.label_semantic_roles",
                 "paddle_tpu_torch.models.lstm_text",
                 "paddle_tpu_torch.models.ocr_recognition",
                 "paddle_tpu_torch.models.recommender", "chip_smoke")


def test_slice_modules_import_neither_jax_nor_paddle_tpu():
    """A fresh interpreter imports this slice's modules and chip_smoke.py
    (which builds nothing at import): no jax module and no module of the
    JAX package is loaded afterwards."""
    import os
    import subprocess
    import sys
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'jaxlib' or m == 'paddle_tpu' "
            "or m.startswith('paddle_tpu.'))\n"
            "print(bad)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
