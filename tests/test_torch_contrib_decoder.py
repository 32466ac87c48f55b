"""The port's ``contrib.decoder`` against the JAX package, on the CPU:
``InitState``, ``StateCell``, ``TrainingDecoder`` (a ``StaticRNN``) and
``BeamSearchDecoder`` (the ``contrib_beam_search_decoder`` op over
``inference.decoding.beam_decode``).

The twin of ``tests/api/test_contrib_shims.py::
test_training_decoder_then_beam_search_recovers_sequence`` trains the
memorizing decoder 60 Adam steps in both packages from one scope (the
losses agree step by step) and beam-decodes the memorized sequence with
the shared parameters. Then the seq2seq of the card's phase 29 at a
small width (vocabulary 50, 16 wide): an embedding, an ``fc`` to 3 x 16
and a ``dynamic_gru`` over the padded source with lengths, its last step
through an ``fc`` with tanh to the decoder's ``InitState``, a
``StateCell`` whose updater is ``fc(concat([x, h]), 16, tanh)``, a
``TrainingDecoder`` over the time-major teacher-forced ids, the softmax
head, ``cross_entropy`` and ``mean``: its loss and @GRADs against JAX's
from one scope, then its beam ids and scores against JAX's
``BeamSearchDecoder`` on the same scope. The dp twin checks that a
``TrainingDecoder`` fed a sharded time-major input refuses.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import layers as jlayers
from paddle_tpu.contrib import decoder as jdec
from paddle_tpu.core import unique_name as jun
from paddle_tpu.core.executor import Scope as JScope, scope_guard as jguard

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.contrib import decoder as tdec
from paddle_tpu_torch.core import unique_name as tun

from test_torch_sequence_ops import grad_close

CPU = fluid.CPUPlace()
PKGS = ((jfluid, jlayers, jdec, jun), (fluid, tlayers, tdec, tun))
# the decoder's loss from one scope: within 1e-5 relative (measured
# 6.1e-8 for the small seq2seq's first loss, 2.8e-7 for its softmax);
# the memorizing decoder's 60 Adam(0.05) steps: every loss within 1e-5
# relative of JAX's (measured 6.4e-7 at most)
LOSS_RTOL = 1e-5
TRAIN_RTOL = 1e-5
# @GRADs within 1e-4 of each gradient's largest entry (measured 4.2e-7)
GRAD_TOL = 1e-4
# beam scores: sums of log-probabilities over the decoded steps, within
# 1e-5 relative of JAX's (measured 5.8e-8); the ids equal; the top beam's
# float64 replay within 1e-4 relative (measured 1.0e-8)
SCORE_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_bert.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cell(pkg, L, dec, encoded, hidden):
    cell = dec.StateCell(inputs={"x": None},
                         states={"h": dec.InitState(init=encoded)},
                         out_state="h")

    @cell.state_updater
    def updater(state_cell):
        x = state_cell.get_input("x")
        h = state_cell.get_state("h")
        nh = L.fc(L.concat([x, h], axis=-1), size=hidden, act="tanh",
                  param_attr=pkg.ParamAttr(name="dec_step.w"),
                  bias_attr=pkg.ParamAttr(name="dec_step.b"))
        state_cell.set_state("h", nh)

    return cell


def _training_decoder(pkg, L, dec, encoded, in_ids, vocab, word_dim,
                      hidden):
    """The teacher-forced decoder over time-major ids: (T, B, vocab)
    softmax scores."""
    cell = _cell(pkg, L, dec, encoded, hidden)
    decoder = dec.TrainingDecoder(cell)
    with decoder.block():
        cur_ids = decoder.step_input(in_ids)
        emb = L.embedding(cur_ids, size=[vocab, word_dim],
                          param_attr=pkg.ParamAttr(name="dec_emb.w"))
        cell.compute_state(inputs={"x": emb})
        score = L.fc(cell.get_state("h"), size=vocab, act="softmax",
                     param_attr=pkg.ParamAttr(name="dec_out.w"),
                     bias_attr=pkg.ParamAttr(name="dec_out.b"))
        decoder.output(score)
    return decoder()


def _beam_decoder(pkg, L, dec, encoded, batch, vocab, word_dim, hidden,
                  max_len, beam, end_id):
    init_ids = pkg.data(name="init_ids", shape=[batch], dtype="int64")
    init_scores = pkg.data(name="init_scores", shape=[batch, 1],
                           dtype="float32")
    cell = _cell(pkg, L, dec, encoded, hidden)
    bsd = dec.BeamSearchDecoder(
        cell, init_ids, init_scores, target_dict_dim=vocab,
        word_dim=word_dim, max_len=max_len, beam_size=beam, end_id=end_id,
        length_penalty=0.0,
        emb_param_attr=pkg.ParamAttr(name="dec_emb.w"),
        score_param_attr=pkg.ParamAttr(name="dec_out.w"),
        score_bias_attr=pkg.ParamAttr(name="dec_out.b"), name="bsd")
    bsd.decode()
    return bsd()


class _Runner:
    """One package's Executor and scope: the JAX package's under its
    scope_guard, the port's on the CPU."""

    def __init__(self, pkg, scope):
        self.pkg, self.scope = pkg, scope
        self.exe = pkg.Executor(CPU) if pkg is fluid else pkg.Executor()

    def run(self, program, feed, fetch):
        if self.pkg is fluid:
            out = self.exe.run(program, feed=feed, fetch_list=fetch,
                               scope=self.scope)
        else:
            with jguard(self.scope):
                out = self.exe.run(program, feed=feed, fetch_list=fetch)
        return [np.asarray(v) for v in out]


def _runners(jstart, tstart):
    """JAX's startup scope, and the port's carried over from it."""
    jscope = JScope()
    j = _Runner(jfluid, jscope)
    j.run(jstart, {}, [])
    init = {n: np.array(jscope.get(n)) for n in jscope.names()}
    t = _Runner(fluid, fluid.Scope())
    t.run(tstart, {}, [])
    fluid.scope_from_numpy(init, "cpu", t.scope)
    return j, t


def _programs(build):
    """build(pkg, L, dec) in each package: [(main, startup, fetches)]."""
    out = []
    for pkg, L, dec, un in PKGS:
        main, startup = pkg.Program(), pkg.Program()
        with un.guard(), pkg.program_guard(main, startup):
            res = build(pkg, L, dec)
        out.append((main, startup, list(res)))
    return out


# ---------------------------------------------------------------------------
# the twin of test_contrib_shims.py's decoder test
# ---------------------------------------------------------------------------

VOCAB, WORD_DIM, HIDDEN = 12, 8, 16
BOS, EOS = 0, 1
TARGET = [5, 7, 3, EOS]


def test_training_decoder_then_beam_search_recovers_sequence():
    np.random.seed(0)
    B, T = 4, len(TARGET)
    enc = np.random.randn(B, HIDDEN).astype(np.float32) * 0.1
    tf_ids = np.tile(np.array([BOS] + TARGET[:-1], np.int64)[:, None],
                     (1, B))
    tgt = np.tile(np.array(TARGET, np.int64)[:, None], (1, B))

    def train(pkg, L, dec):
        encoded = pkg.data(name="enc", shape=[-1, HIDDEN], dtype="float32")
        in_ids = pkg.data(name="tf_ids", shape=[T, -1], dtype="int64")
        labels = pkg.data(name="tgt", shape=[T, -1], dtype="int64")
        probs = _training_decoder(pkg, L, dec, encoded, in_ids, VOCAB,
                                  WORD_DIM, HIDDEN)
        loss = L.mean(L.cross_entropy(L.reshape(probs, shape=[-1, VOCAB]),
                                      L.reshape(labels, shape=[-1, 1])))
        pkg.optimizer.AdamOptimizer(learning_rate=0.05).minimize(loss)
        return [loss]

    def infer(pkg, L, dec):
        encoded = pkg.data(name="enc", shape=[B, HIDDEN], dtype="float32")
        return _beam_decoder(pkg, L, dec, encoded, B, VOCAB, WORD_DIM,
                             HIDDEN, T, 3, EOS)

    (jm, js, jf), (tm, ts, tf) = _programs(train)
    j, t = _runners(js, ts)
    feed = {"enc": enc, "tf_ids": tf_ids, "tgt": tgt}
    jl = [float(j.run(jm, feed, jf)[0].reshape(())) for _ in range(60)]
    tl = [float(t.run(tm, feed, tf)[0].reshape(())) for _ in range(60)]
    assert tl[-1] < 0.05, tl[-1]
    np.testing.assert_allclose(tl, jl, rtol=TRAIN_RTOL)

    (jim, _, jif), (tim, _, tif) = _programs(infer)
    feed = {"enc": enc, "init_ids": np.full(B, BOS, np.int64),
            "init_scores": np.zeros((B, 1), np.float32)}
    ids, scores = t.run(tim, feed, tif)
    assert ids.shape == (B, 3, T) and ids.dtype == np.int64
    assert (np.diff(scores, axis=1) <= 1e-5).all()
    np.testing.assert_array_equal(ids[:, 0, :], np.tile(TARGET, (B, 1)))
    jids, jscores = j.run(jim, feed, jif)
    np.testing.assert_array_equal(ids, jids)


# ---------------------------------------------------------------------------
# the seq2seq of phase 29 at a small width
# ---------------------------------------------------------------------------

S2S = dict(vocab=50, width=16, batch=4, src_len=7, trg_len=6, beam=3)
S2S_PARAMS = ["src_emb.w", "enc_proj.w", "enc_proj.b", "enc_gru_wx",
              "enc_gru_wh", "enc_gru.b", "enc_out.w", "enc_out.b",
              "dec_emb.w", "dec_step.w", "dec_step.b", "dec_out.w",
              "dec_out.b"]


def _encoder(pkg, L, c):
    src = pkg.data(name="src", shape=[c["batch"], c["src_len"]],
                   dtype="int64")
    src_len = pkg.data(name="src_len", shape=[c["batch"]], dtype="int64")
    w = c["width"]
    emb = L.embedding(src, size=[c["vocab"], w],
                      param_attr=pkg.ParamAttr(name="src_emb.w"))
    proj = L.fc(emb, size=3 * w, num_flatten_dims=2,
                param_attr=pkg.ParamAttr(name="enc_proj.w"),
                bias_attr=pkg.ParamAttr(name="enc_proj.b"))
    hid = L.dynamic_gru(proj, w, length=src_len,
                        param_attr=pkg.ParamAttr(name="enc_gru"),
                        bias_attr=pkg.ParamAttr(name="enc_gru.b"))
    last = L.sequence_last_step(hid, length=src_len)
    return L.fc(last, size=w, act="tanh",
                param_attr=pkg.ParamAttr(name="enc_out.w"),
                bias_attr=pkg.ParamAttr(name="enc_out.b"))


def _s2s_train(pkg, L, dec, c=S2S):
    encoded = _encoder(pkg, L, c)
    in_ids = pkg.data(name="tf_ids", shape=[c["trg_len"], c["batch"]],
                      dtype="int64")
    labels = pkg.data(name="labels", shape=[c["trg_len"], c["batch"]],
                      dtype="int64")
    probs = _training_decoder(pkg, L, dec, encoded, in_ids, c["vocab"],
                              c["width"], c["width"])
    loss = L.mean(L.cross_entropy(L.reshape(probs, shape=[-1, c["vocab"]]),
                                  L.reshape(labels, shape=[-1, 1])))
    pkg.append_backward(loss)
    return [loss, probs]


def _s2s_beam(pkg, L, dec, c=S2S):
    encoded = _encoder(pkg, L, c)
    return _beam_decoder(pkg, L, dec, encoded, c["batch"], c["vocab"],
                         c["width"], c["width"], c["trg_len"], c["beam"],
                         EOS)


def _s2s_feed(c=S2S, seed=29):
    rs = np.random.RandomState(seed)
    b, s, t, v = c["batch"], c["src_len"], c["trg_len"], c["vocab"]
    lens = rs.randint(2, s + 1, b).astype(np.int64)
    src = rs.randint(2, v, (b, s)).astype(np.int64)
    src[np.arange(s)[None] >= lens[:, None]] = 0
    trg = rs.randint(2, v, (t, b)).astype(np.int64)
    labels = np.concatenate([trg[1:], np.full((1, b), EOS)], 0)
    tf_ids = np.concatenate([np.full((1, b), BOS), trg[:-1]], 0)
    return {"src": src, "src_len": lens, "tf_ids": tf_ids,
            "labels": labels.astype(np.int64)}


def test_seq2seq_loss_and_grads_match_jax():
    (jm, js, jf), (tm, ts, tf) = _programs(_s2s_train)
    j, t = _runners(js, ts)
    feed = _s2s_feed()
    fetch = [p + "@GRAD" for p in S2S_PARAMS]
    jo = j.run(jm, feed, jf + fetch)
    to = t.run(tm, feed, tf + fetch)
    np.testing.assert_allclose(to[0], jo[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(to[1], jo[1], rtol=1e-5, atol=1e-7)
    for name, a, b in zip(S2S_PARAMS, jo[2:], to[2:]):
        assert b.shape == a.shape, name
        grad_close(b, a, GRAD_TOL, name)


def test_seq2seq_beam_search_matches_jax():
    """The beam decoder on the carried scope: ids equal JAX's, scores
    within SCORE_RTOL, best first; the top beam's score is the sum of
    its steps' log-probabilities replayed through the training
    Program's softmax (up to and including the first end id)."""
    c = S2S
    (jm, js, jf), (tm, ts, tf) = _programs(_s2s_beam)
    j, t = _runners(js, ts)
    feed = _s2s_feed()
    feed = {"src": feed["src"], "src_len": feed["src_len"],
            "init_ids": np.full(c["batch"], BOS, np.int64),
            "init_scores": np.zeros((c["batch"], 1), np.float32)}
    jids, jscores = j.run(jm, feed, jf)
    ids, scores = t.run(tm, feed, tf)
    assert ids.shape == (c["batch"], c["beam"], c["trg_len"])
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(scores, jscores, rtol=SCORE_RTOL)
    assert (np.diff(scores, axis=1) <= 1e-6).all()
    # the replay, on the port's training Program (same parameter names)
    (_, _, _), (tm2, ts2, tf2) = _programs(_s2s_train)
    top = ids[:, 0, :].T                       # (T, B)
    replay = {"src": feed["src"], "src_len": feed["src_len"],
              "tf_ids": np.concatenate([np.full((1, c["batch"]), BOS),
                                        top[:-1]], 0),
              "labels": top}
    probs = t.run(tm2.clone(for_test=True), replay, [tf2[1]])[0]
    logp = np.log(probs.astype(np.float64) + 1e-9)
    logp -= np.log(np.exp(logp).sum(-1, keepdims=True))
    for b in range(c["batch"]):
        row = top[:, b]
        n = int(np.argmax(row == EOS)) + 1 if (row == EOS).any() \
            else len(row)
        want = sum(logp[s, b, row[s]] for s in range(n))
        np.testing.assert_allclose(scores[b, 0], want, rtol=1e-4)


def test_training_decoder_refuses_a_sharded_time_major_input():
    """dp 2 splits the time-major teacher-forced ids along T: the
    TrainingDecoder's StaticRNN refuses; at dp 1 it runs."""
    def run(places):
        main, startup = fluid.Program(), fluid.Program()
        with tun.guard(), fluid.program_guard(main, startup):
            loss, _ = _s2s_train(fluid, tlayers, tdec)
        comp = fluid.CompiledProgram(main).with_data_parallel(places=places)
        exe, scope = fluid.Executor(CPU), fluid.Scope()
        exe.run(startup, scope=scope)
        return exe.run(comp, feed=_s2s_feed(), fetch_list=[loss],
                       scope=scope)

    assert np.isfinite(run([CPU])[0]).all()
    with pytest.raises(NotImplementedError, match="time"):
        run([CPU] * 2)
