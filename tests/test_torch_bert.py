"""BERT/ERNIE pretraining and sequence packing through the port's Fluid
entry points, against the JAX package, on the CPU.

Twins of ``tests/models/test_ernie.py`` (all four), the two BERT cases of
``tests/models/test_model_zoo.py`` and ``tests/models/test_packed_pretrain.py``
(all seven, ``gpt.build_packed_lm_net`` included). Where both packages
train, they build the same Program (under fresh unique-name generators),
JAX runs the startup and ``scope_from_numpy`` carries its scope into the
port, as ``tests/test_torch_train.py`` does; the port runs on the CPU,
where attention takes the plain dense path (with the padding mask as an
additive key-side bias, the segment ids as an additive mask), as JAX's
does off the TPU. Tolerances are ``test_torch_train.py``'s: losses within
1e-5 relative a step (dropout 0), the first step's gradients within 1e-4
relative plus 1e-6 absolute. One case sets ``PADDLE_TPU_FORCE_FLASH=1``
(test-local) so that the JAX side runs its Pallas flash kernels in
interpret mode, the key-side bias inside them. The gates of the
reference's trainability tests (memorization, packed losses falling) run
on the port alone from its own startup: its random numbers are torch's,
not JAX's keys.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core import unique_name as jun
from paddle_tpu.core.executor import Scope as JScope, scope_guard as jguard
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import ernie as jernie
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.reader import packing as jpacking

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import unique_name as tun
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import ernie as ternie
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops import attention_ops as tattn
from paddle_tpu_torch.reader.packing import pack_sequences, packing_efficiency

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
CPU = fluid.CPUPlace()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module: the suite runs
    several pytest workers at once, and torch's default of one thread a
    core in each worker oversubscribes the CPU, where the small eager ops
    of these tests then wait on each other's threads (six concurrent
    80-step tiny-BERT runs took 1448 s each at 8 threads, 4 s at one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _no_dropout(cfg, layers=None):
    cfg.hidden_dropout_prob = 0.0
    cfg.attention_probs_dropout_prob = 0.0
    if layers is not None:
        cfg.num_hidden_layers = layers
    return cfg


def _tiny(layers=None):
    return _no_dropout(tbert.bert_tiny(), layers)


def _pretrain_net(pkg, bert, cfg, seq_len, lr):
    _feeds, total, _mlm, _acc = bert.build_pretrain_net(cfg, seq_len=seq_len)
    pkg.optimizer.AdamOptimizer(lr).minimize(total)
    return total


def _build(pkg, bert, un, net, cfg, seq_len, lr=1e-3, seed=7):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with un.guard(), pkg.program_guard(main, startup):
        out = net(pkg, bert, cfg, seq_len, lr)
    return main, startup, out


def _carry(jscope):
    return fluid.scope_from_numpy(
        {n: np.asarray(jscope.get(n)) for n in jscope.names()}, "cpu")


def _twins(net, cfg, feed, seq_len, steps, monkeypatch=None, flash=False):
    """Build the net in both packages, start it in JAX, carry the scope
    over, run `steps` steps in both. Returns (jax losses, port losses, jax
    first-step grads, port first-step grads, grad names)."""
    if flash:
        monkeypatch.setenv("PADDLE_TPU_FORCE_FLASH", "1")
    jmain, jstart, jloss = _build(jfluid, jbert, jun, net, cfg, seq_len)
    tmain, _tstart, tloss = _build(fluid, tbert, tun, net, cfg, seq_len)
    jscope, jexe = JScope(), jfluid.Executor()
    with jguard(jscope):
        jexe.run(jstart)
    tscope = _carry(jscope)
    assert sorted(tscope.names()) == sorted(
        v.name for v in tmain.list_vars() if v.persistable)
    gnames = [p.name + "@GRAD" for p in tmain.all_parameters()]
    texe = fluid.Executor(CPU)
    jl, tl = [], []
    for i in range(steps):
        fetch = [jloss.name] + (gnames if i == 0 else [])
        with jguard(jscope):
            jo = jexe.run(jmain, feed=feed, fetch_list=fetch)
        with fluid.scope_guard(tscope):
            to = texe.run(tmain, feed=feed, fetch_list=fetch)
        jl.append(float(np.asarray(jo[0]).reshape(())))
        tl.append(float(np.asarray(to[0]).reshape(())))
        if i == 0:
            jg, tg = jo[1:], to[1:]
    return np.array(jl), np.array(tl), jg, tg, gnames


def _check_twins(jl, tl, jg, tg, gnames):
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=0)
    assert len(jg) == len(tg) == len(gnames)
    for name, a, b in zip(gnames, jg, tg):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(b, a, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def _padded_feed(cfg, seq_len, batch, seed=0):
    """make_pretrain_feed with the tails of two rows masked out, so the
    key-side padding bias is not all zeros."""
    feed = tbert.make_pretrain_feed(cfg, seq_len, batch, seed=seed)
    feed["input_mask"][1, seq_len - 7:] = 0.0
    feed["input_mask"][3, seq_len // 2:] = 0.0
    return feed


# ---------------------------------------------------------------------------
# BERT pretraining and the classifier against the JAX Executor
# ---------------------------------------------------------------------------

def test_bert_pretrain_adam_steps_match_jax_executor():
    cfg = _tiny()
    jl, tl, jg, tg, gnames = _twins(_pretrain_net, cfg,
                                    _padded_feed(cfg, 32, 4), 32, 4)
    assert jl[-1] < jl[0]
    assert len(gnames) == 16 * cfg.num_hidden_layers + 14
    _check_twins(jl, tl, jg, tg, gnames)


def test_bert_pretrain_steps_match_jax_pallas_flash(monkeypatch):
    """The JAX side through its Pallas flash forward and backward
    (interpret mode) with the key-side padding bias inside the kernels,
    the port through its plain attention."""
    cfg = _tiny(layers=2)
    _check_twins(*_twins(_pretrain_net, cfg, _padded_feed(cfg, 32, 4), 32,
                         2, monkeypatch, flash=True))


def test_ernie_feed_pretrain_matches_jax_executor():
    """The knowledge-masked ERNIE feed (int32, as the chip script feeds
    it) through both Executors."""
    cfg = _tiny(layers=2)
    feed = ternie.make_pretrain_feed(cfg, 32, 4, seed=3, dtype=np.int32)
    _check_twins(*_twins(_pretrain_net, cfg, feed, 32, 3))


def _classifier(pkg, bert, un, cfg, seq_len, num_labels):
    main, startup = pkg.Program(), pkg.Program()
    with un.guard(), pkg.program_guard(main, startup):
        _f, loss, acc, probs = bert.build_classifier_net(
            cfg, seq_len=seq_len, num_labels=num_labels)
    return main, startup, loss, acc, probs


def test_bert_classifier_builds():
    """test_model_zoo.py:197: the classifier's probabilities are (B, 3)
    rows that sum to 1, and equal JAX's on the carried-over scope (the
    test program: dropout is off)."""
    cfg = tbert.bert_tiny()
    b, t = 2, 16
    rng = np.random.RandomState(4)
    feed = {"src_ids": rng.randint(0, cfg.vocab_size, (b, t)),
            "sent_ids": np.zeros((b, t), np.int64),
            "input_mask": np.ones((b, t), np.float32),
            "label": rng.randint(0, 3, (b, 1))}
    feed["input_mask"][1, 11:] = 0.0
    jm, js, jloss, jacc, jprobs = _classifier(jfluid, jbert, jun, cfg, t, 3)
    tm, _ts, tloss, tacc, tprobs = _classifier(fluid, tbert, tun, cfg, t, 3)
    jscope = JScope()
    with jguard(jscope):
        jfluid.Executor().run(js)
        jo = jfluid.Executor().run(jm.clone(for_test=True), feed=feed,
                                   fetch_list=[jloss, jacc, jprobs])
    with fluid.scope_guard(_carry(jscope)):
        to = fluid.Executor(CPU).run(tm.clone(for_test=True), feed=feed,
                                     fetch_list=[tloss, tacc, tprobs])
    assert to[2].shape == (b, 3)
    np.testing.assert_allclose(to[2].sum(-1), np.ones(b), rtol=1e-5)
    np.testing.assert_allclose(to[2], jo[2], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(to[0], jo[0], rtol=1e-5)
    np.testing.assert_array_equal(to[1], jo[1])


def _port_train(net_fn, feed, steps, lr):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup):
        loss = net_fn()
        fluid.optimizer.AdamOptimizer(lr).minimize(loss)
    exe = fluid.Executor(CPU)
    losses = []
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        for _ in range(steps):
            out, = exe.run(main, feed=feed, fetch_list=[loss])
            losses.append(float(np.asarray(out).reshape(-1)[0]))
    return losses


def test_bert_pretrain_memorizes_fixed_batch():
    """test_model_zoo.py:181 on the port: tiny-BERT (dropout as
    configured) overfits a fixed pretrain batch to < 5 % of the initial
    loss in 80 Adam steps at 1e-3."""
    cfg = tbert.bert_tiny()
    feed = tbert.make_pretrain_feed(cfg, 32, 4, seed=0)
    losses = _port_train(
        lambda: tbert.build_pretrain_net(cfg, seq_len=32)[1], feed, 80,
        1e-3)
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.05 * losses[0], (losses[0], losses[-1])


# ---------------------------------------------------------------------------
# ERNIE knowledge masking (tests/models/test_ernie.py)
# ---------------------------------------------------------------------------

def test_sample_mask_spans_whole_spans():
    rs, jrs = np.random.RandomState(0), np.random.RandomState(0)
    spans = [(2, 5), (8, 10)]
    for _ in range(5):
        got = ternie.sample_mask_spans(16, spans, max_predictions=8, rs=rs)
        assert got == jernie.sample_mask_spans(16, spans, max_predictions=8,
                                               rs=jrs)
        picked = set(got)
        # a knowledge span is masked entirely or not at all
        for s, e in spans:
            span = set(range(s, e))
            assert span <= picked or not (span & picked)
    assert len(picked) <= 8


def test_overlapping_spans_never_duplicate_positions():
    rs, jrs = np.random.RandomState(3), np.random.RandomState(3)
    spans = [(0, 3), (2, 5), (4, 6)]
    for _ in range(10):
        picked = ternie.sample_mask_spans(12, spans, max_predictions=12,
                                          rs=rs, basic_rate=0.9)
        assert picked == jernie.sample_mask_spans(
            12, spans, max_predictions=12, rs=jrs, basic_rate=0.9)
        assert len(picked) == len(set(picked))


def test_apply_knowledge_mask_contract():
    cfg = ternie.ernie_tiny()
    b, t = 4, 32
    rs = np.random.RandomState(1)
    src = rs.randint(0, cfg.vocab_size - 1, (b, t))
    spans = [[(0, 3), (10, 12)] for _ in range(b)]
    out = ternie.apply_knowledge_mask(src, spans, cfg, seed=2)
    ref = jernie.apply_knowledge_mask(src, spans, jernie.ernie_tiny(),
                                      seed=2)
    assert sorted(out) == sorted(ref)
    for key in out:
        np.testing.assert_array_equal(out[key], ref[key], err_msg=key)
    P = cfg.max_predictions_per_seq
    assert out["mask_pos"].shape == (b, P)
    assert out["src_ids"].shape == (b, t)
    for i in range(b):
        n = int(out["mask_weight"][i].sum())
        assert 0 < n <= P
        for j in range(n):
            flat = out["mask_pos"][i, j]
            assert flat // t == i              # flat index stays in-row
            # the label is the ORIGINAL token at that position
            assert out["mask_label"][i, j] == src[i, flat % t]
    # some positions actually replaced with the mask token
    assert (out["src_ids"] == cfg.vocab_size - 1).sum() > 0


def test_ernie_pretrain_memorizes_fixed_batch():
    """The port's tiny-ERNIE overfits the knowledge-masked batch (< 5 %
    of the initial loss in 80 steps at 1e-3); its feed equals JAX's."""
    cfg = ternie.ernie_tiny()
    feed = ternie.make_pretrain_feed(cfg, 32, batch=4, seed=0)
    ref = jernie.make_pretrain_feed(jernie.ernie_tiny(), 32, batch=4, seed=0)
    for key in ref:
        np.testing.assert_array_equal(feed[key], ref[key], err_msg=key)
    losses = _port_train(
        lambda: ternie.build_pretrain_net(cfg, seq_len=32)[1], feed, 80,
        1e-3)
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.05 * losses[0], (losses[0], losses[-1])


# ---------------------------------------------------------------------------
# packing (tests/models/test_packed_pretrain.py)
# ---------------------------------------------------------------------------

def test_pack_sequences_layout():
    samples = [(np.arange(5),), (np.arange(3),), (np.arange(4),),
               (np.arange(2),)]
    packed = pack_sequences(samples, max_len=8)
    ref = jpacking.pack_sequences(samples, max_len=8)
    assert sorted(packed) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(packed[key], ref[key], err_msg=key)
    toks, seg, pos = (packed["field_0"], packed["segment_ids"],
                      packed["positions"])
    # FFD: 5+3 fill row 0 exactly; 4+2 share row 1 with 2 pad slots
    assert toks.shape == (2, 8)
    assert abs(packing_efficiency(packed) - 14 / 16) < 1e-9
    assert seg[0].tolist() == [1] * 5 + [2] * 3
    assert pos[0].tolist() == [0, 1, 2, 3, 4, 0, 1, 2]
    np.testing.assert_array_equal(toks[0, :5], np.arange(5))
    np.testing.assert_array_equal(toks[0, 5:], np.arange(3))


def test_pack_sequences_padding_and_errors():
    packed = pack_sequences([(np.arange(5),), (np.arange(5),)], max_len=8)
    assert packed["field_0"].shape == (2, 8)
    assert packed["segment_ids"][0].tolist() == [1] * 5 + [0] * 3
    assert abs(packing_efficiency(packed) - 10 / 16) < 1e-9
    with pytest.raises(ValueError, match="max_len"):
        pack_sequences([(np.arange(9),)], max_len=8)
    with pytest.raises(ValueError, match="unequal"):
        pack_sequences([(np.arange(3), np.arange(2))], max_len=8)


def test_segment_mask_attention_equals_per_segment():
    """One packed row [seg1 | seg2 | pad] attends through the port's op
    path as the two segments run alone, and as JAX's dense and Pallas
    (interpret mode) paths do on the same row."""
    import os
    import jax.numpy as jnp
    from paddle_tpu.ops.attention_ops import dot_product_attention as jdpa
    rng = np.random.default_rng(0)
    H, D, n1, n2, T = 2, 8, 5, 4, 12
    q, k, v = (rng.standard_normal((1, H, T, D)).astype(np.float32)
               for _ in range(3))
    seg = np.array([[1] * n1 + [2] * n2 + [0] * (T - n1 - n2)])
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out = tattn.dot_product_attention(tq, tk, tv,
                                      segment_ids=torch.from_numpy(seg))
    for lo, hi in ((0, n1), (n1, n1 + n2)):
        ref = tattn.dot_product_attention(tq[:, :, lo:hi], tk[:, :, lo:hi],
                                          tv[:, :, lo:hi])
        np.testing.assert_allclose(out[:, :, lo:hi].numpy(), ref.numpy(),
                                   rtol=2e-5, atol=2e-5)
    for force in ("0", "1"):
        os.environ["PADDLE_TPU_FORCE_FLASH"] = force
        try:
            jout = np.asarray(jdpa(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v),
                                   segment_ids=jnp.asarray(seg)))
        finally:
            os.environ.pop("PADDLE_TPU_FORCE_FLASH", None)
        np.testing.assert_allclose(out[:, :, :n1 + n2].numpy(),
                                   jout[:, :, :n1 + n2], rtol=2e-5,
                                   atol=2e-5, err_msg=f"force={force}")


def _unpack(feed, cfg, T, n_rows):
    """The packed documents one a row, for the unpacked net (the
    reference test's construction)."""
    seg = feed["segment_ids"]
    rows = []
    for r in range(n_rows):
        for s in np.unique(seg[r]):
            if s == 0:
                continue
            rows.append((r, np.nonzero(seg[r] == s)[0]))
    B = len(rows)
    P = cfg.max_predictions_per_seq
    u = {"src_ids": np.zeros((B, T), np.int64),
         "sent_ids": np.zeros((B, T), np.int64),
         "input_mask": np.zeros((B, T), np.float32),
         "mask_pos": np.zeros((B, P), np.int64),
         "mask_label": np.zeros((B, P), np.int64),
         "mask_weight": np.zeros((B, P), np.float32),
         "nsp_label": np.zeros((B, 1), np.int64)}
    flat_pos = feed["mask_pos"].reshape(-1)
    flat_label = feed["mask_label"].reshape(-1)
    flat_w = feed["mask_weight"].reshape(-1)
    n_used = 0
    for b, (r, idx) in enumerate(rows):
        n = len(idx)
        u["src_ids"][b, :n] = feed["src_ids"][r, idx]
        u["sent_ids"][b, :n] = feed["sent_ids"][r, idx]
        u["input_mask"][b, :n] = 1.0
        sel = [j for j in range(len(flat_pos))
               if flat_w[j] > 0 and flat_pos[j] // T == r
               and (flat_pos[j] % T) in idx]
        local = {g: l for l, g in enumerate(idx)}
        for m, j in enumerate(sel):
            u["mask_pos"][b, m] = b * T + local[flat_pos[j] % T]
            u["mask_label"][b, m] = flat_label[j]
            u["mask_weight"][b, m] = 1.0
        n_used += len(sel)
    return u, B, n_used


def _packed_and_unpacked(pkg, bert, un, cfg, T, width):
    packed_prog, startup = pkg.Program(), pkg.Program()
    unpacked_prog, startup2 = pkg.Program(), pkg.Program()
    with un.guard():
        with pkg.program_guard(packed_prog, startup):
            _f, packed_loss = bert.build_packed_pretrain_net(
                cfg, seq_len=T, max_predictions=width)
        with pkg.program_guard(unpacked_prog, startup2):
            _f2, _total, unpacked_mlm, _acc = bert.build_pretrain_net(
                cfg, seq_len=T)
    return packed_prog, startup, packed_loss, unpacked_prog, startup2, \
        unpacked_mlm


def test_packed_mlm_loss_matches_unpacked():
    """The packed net's MLM loss over N documents equals the unpacked
    net's on the same documents padded one a row (one parameter set,
    shared by name), in the port, and both equal JAX's on the carried-over
    scope. The feed equals JAX's make_packed_pretrain_feed."""
    cfg = _tiny(layers=2)
    T = 64
    feed, n_rows = tbert.make_packed_pretrain_feed(cfg, T, n_docs=6, seed=3)
    jfeed, jn = jbert.make_packed_pretrain_feed(cfg, T, n_docs=6, seed=3)
    assert n_rows == jn
    for key in jfeed:
        np.testing.assert_array_equal(feed[key], jfeed[key], err_msg=key)
    assert n_rows < 6, "packing should shrink 6 short docs below 6 rows"
    u, B, n_used = _unpack(feed, cfg, T, n_rows)
    assert B == 6
    # every packed prediction is accounted for; nothing was truncated
    assert n_used == int(feed["mask_weight"].sum())
    width = feed["mask_pos"].shape[1]
    jp, js, jpl, ju, js2, jul = _packed_and_unpacked(
        jfluid, jbert, jun, cfg, T, width)
    tp, _ts, tpl, tu, _ts2, tul = _packed_and_unpacked(
        fluid, tbert, tun, cfg, T, width)
    jscope = JScope()
    with jguard(jscope):
        jexe = jfluid.Executor()
        jexe.run(js)
        jexe.run(js2)
        j_packed, = jexe.run(jp, feed=feed, fetch_list=[jpl])
        j_unpacked, = jexe.run(ju, feed=u, fetch_list=[jul])
    texe = fluid.Executor(CPU)
    with fluid.scope_guard(_carry(jscope)):
        got_packed, = texe.run(tp, feed=feed, fetch_list=[tpl])
        got_unpacked, = texe.run(tu, feed=u, fetch_list=[tul])
    np.testing.assert_allclose(got_packed, got_unpacked, rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(got_packed, j_packed, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got_unpacked, j_unpacked, rtol=LOSS_RTOL)


def test_packed_pretrain_trains_down():
    """Overfit gate on the packed path: loss < 0.1x initial on a fixed
    batch (60 Adam steps at 1e-3)."""
    cfg = _tiny(layers=2)
    T = 64
    feed, _n_rows = tbert.make_packed_pretrain_feed(cfg, T, n_docs=4, seed=1)
    losses = _port_train(
        lambda: tbert.build_packed_pretrain_net(
            cfg, seq_len=T, max_predictions=feed["mask_pos"].shape[1])[1],
        feed, 60, 1e-3)
    assert losses[-1] < 0.1 * losses[0], (losses[0], losses[-1])


def _gpt_docs(cfg, T, lens, seed):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, cfg.vocab_size, n) for n in lens]
    packed = pack_sequences([(d,) for d in docs], T)
    feed = {"tokens": packed["field_0"],
            "segment_ids": packed["segment_ids"],
            "positions": packed["positions"]}
    return docs, feed


def _packed_lm(pkg, gpt, un, cfg, T, lens):
    progs = {}
    with un.guard():
        prog, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(prog, startup):
            _f, loss = gpt.build_packed_lm_net(cfg, seq_len=T)
        progs["packed"] = (prog, startup, loss)
        for n in sorted(set(lens)):
            p, s = pkg.Program(), pkg.Program()
            with pkg.program_guard(p, s):
                _tok, l, _lg = gpt.build_lm_net(cfg, seq_len=n)
            progs[n] = (p, s, l)
    return progs


def test_packed_causal_lm_matches_per_document():
    """Packed GPT: the document-masked next-token loss over packed rows
    equals the pair-count-weighted mean of each document's own causal LM
    loss (parameters shared by name), and JAX's packed loss on the
    carried-over scope."""
    cfg = tgpt.gpt_tiny()
    cfg.num_layers = 2
    T = 24
    lens = [12, 9, 7, 5]
    docs, feed = _gpt_docs(cfg, T, lens, 5)
    jprogs = _packed_lm(jfluid, jgpt, jun, cfg, T, lens)
    tprogs = _packed_lm(fluid, tgpt, tun, cfg, T, lens)
    jscope = JScope()
    with jguard(jscope):
        jexe = jfluid.Executor()
        jexe.run(jprogs["packed"][1])
        j_packed, = jexe.run(jprogs["packed"][0], feed=feed,
                             fetch_list=[jprogs["packed"][2]])
    texe = fluid.Executor(CPU)
    with fluid.scope_guard(_carry(jscope)):
        got, = texe.run(tprogs["packed"][0], feed=feed,
                        fetch_list=[tprogs["packed"][2]])
        num = den = 0.0
        for d in docs:
            n = len(d)
            prog, _st, loss = tprogs[n]
            out, = texe.run(prog, feed={"tokens": d[None, :]},
                            fetch_list=[loss])
            num += float(np.asarray(out).reshape(())) * (n - 1)
            den += n - 1
    got = float(np.asarray(got).reshape(()))
    np.testing.assert_allclose(got, num / den, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, float(np.asarray(j_packed).reshape(())),
                               rtol=LOSS_RTOL)


def _packed_lm_net(pkg, gpt, cfg, seq_len, lr):
    _feeds, loss = gpt.build_packed_lm_net(cfg, seq_len=seq_len)
    pkg.optimizer.AdamOptimizer(lr).minimize(loss)
    return loss


def test_packed_causal_lm_trains_down():
    """The packed GPT's loss falls below 0.1x the initial in 80 Adam steps
    at 2e-3 on the port; its first two steps equal the JAX Executor's
    (losses and first-step gradients)."""
    cfg = tgpt.gpt_tiny()
    cfg.num_layers = 2
    T = 32
    rng = np.random.default_rng(6)
    lens = [int(n) for n in rng.integers(6, 16, 6)]
    _docs, feed = _gpt_docs(cfg, T, lens, 6)
    jmain, jstart, jloss = _build(jfluid, jgpt, jun, _packed_lm_net, cfg, T,
                                  lr=2e-3)
    tmain, _ts, tloss = _build(fluid, tgpt, tun, _packed_lm_net, cfg, T,
                               lr=2e-3)
    jscope, jexe = JScope(), jfluid.Executor()
    with jguard(jscope):
        jexe.run(jstart)
    tscope, texe = _carry(jscope), fluid.Executor(CPU)
    gnames = [p.name + "@GRAD" for p in tmain.all_parameters()]
    jl, tl = [], []
    for i in range(80):
        fetch = [tloss.name] + (gnames if i == 0 else [])
        if i < 2:
            with jguard(jscope):
                jo = jexe.run(jmain, feed=feed, fetch_list=fetch)
            jl.append(float(np.asarray(jo[0]).reshape(())))
        with fluid.scope_guard(tscope):
            to = texe.run(tmain, feed=feed, fetch_list=fetch)
        tl.append(float(np.asarray(to[0]).reshape(())))
        if i == 0:
            _check_twins(np.array(jl), np.array(tl), jo[1:], to[1:], gnames)
    np.testing.assert_allclose(tl[:2], jl, rtol=LOSS_RTOL)
    assert tl[-1] < 0.1 * tl[0], (tl[0], tl[-1])


def test_padding_bias_reaches_attention_as_a_broadcast_view(monkeypatch):
    """The layer path hands the attention the (B, 1, 1, T) key-side bias
    of bert.py (reshape, then scale(1e9, -1e9)) as is, and
    ``_canonical_bias`` keeps it (B, 1, 1, T): no (B, H, T, T) copy is
    made. On the card the kernel wrapper's ``expand`` then makes it a
    stride-0 view over heads and queries (``ops/cuda/flash.py`` ``_check``;
    the chip script's phase 16 sees the strides the kernel gets)."""
    from paddle_tpu_torch.ops import flash as tflash
    seen = []
    real = tflash._canonical_bias

    def spy(bias, b, h, tq, tk):
        out = real(bias, b, h, tq, tk)
        seen.append((tuple(bias.shape), tuple(out.shape), out.stride()))
        return out

    monkeypatch.setattr(tflash, "_canonical_bias", spy)
    cfg = _tiny(layers=2)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        _f, total, _m, _a = tbert.build_pretrain_net(cfg, seq_len=32)
    feed = _padded_feed(cfg, 32, 4)
    # the flash path as the card takes it, on CPU tensors (plain version)
    monkeypatch.setattr(tattn, "_xla_attention",
                        lambda q, k, v, bias=None, scale=None, causal=False:
                        tflash.flash_attention(q, k, v, bias=bias,
                                               scale=scale, causal=causal))
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(CPU)
        exe.run(startup)
        exe.run(main, feed=feed, fetch_list=[total])
    assert len(seen) == cfg.num_hidden_layers
    for shape, canon, stride in seen:
        assert shape == canon == (4, 1, 1, 32)
        assert stride == (32, 32, 32, 1)
