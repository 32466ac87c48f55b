"""BERT-tiny trained under gradient merge, Lookahead and EMA in both
packages, on the CPU.

``bert.bert_tiny()`` (4 layers, width 256, dropout 0), seq 32 x batch 4,
built in both packages under one ``unique_name.guard()`` with
``LookaheadOptimizer(GradientMergeOptimizer(AdamOptimizer(1e-3), 2),
alpha=0.5, k=2)`` and an ``ExponentialMovingAverage(0.9)`` of the
weights; the port starts from the JAX startup's scope and both run the
same 8 feeds. Held: every step's loss (LOSS_RTOL), every parameter and its
EMA-applied value after the 8 steps (PARAM_RTOL + PARAM_ATOL: Adam's
per-element normalization lets a last-ulp gradient difference of the two
packages' f32 arithmetic move a near-zero gradient's entry by up to the
rate), the gradient-merge
off-steps (1, 3, 5, 7: the parameters bitwise as before the step in the
port), and ``restore()`` bitwise.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core import unique_name as jun
from paddle_tpu.core.executor import Scope as JScope, scope_guard as jguard
from paddle_tpu.models import bert as jbert

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import unique_name as tun
from paddle_tpu_torch.models import bert as tbert

SEQ, BATCH, STEPS = 32, 4, 8
LOSS_RTOL = 1e-5
# a tenth of Adam's rate: an entry whose gradient sits at the f32 rounding
# noise moves by up to the rate a step, in either direction
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-4
CPU = fluid.CPUPlace()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (the suite runs
    several pytest workers at once; see tests/test_torch_bert.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _build(pkg, bert, un):
    cfg = bert.bert_tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with un.guard(), pkg.program_guard(main, startup):
        _f, loss, _m, _a = bert.build_pretrain_net(cfg, seq_len=SEQ)
        inner = pkg.optimizer.GradientMergeOptimizer(
            pkg.optimizer.AdamOptimizer(1e-3), 2)
        pkg.optimizer.LookaheadOptimizer(inner, alpha=0.5, k=2).minimize(
            loss, startup)
        ema = pkg.optimizer.ExponentialMovingAverage(0.9)
        ema.update()
    return cfg, main, startup, loss, ema


def test_bert_tiny_under_merge_lookahead_ema_matches_jax():
    jcfg, jmain, jstart, jloss, jema = _build(jfluid, jbert, jun)
    _tcfg, tmain, _ts, tloss, tema = _build(fluid, tbert, tun)
    feeds = [tbert.make_pretrain_feed(jcfg, SEQ, BATCH, seed=i)
             for i in range(STEPS)]
    params = [p.name for p in tmain.all_parameters()]
    jscope, jexe = JScope(), jfluid.Executor()
    with jguard(jscope):
        jexe.run(jstart)
    tscope = fluid.scope_from_numpy(
        {n: np.asarray(jscope.get(n)) for n in jscope.names()}, "cpu")
    texe = fluid.Executor(CPU)
    texe._step_counter = 1              # as after the startup
    jl, tl = [], []
    with jguard(jscope), fluid.scope_guard(tscope):
        for i, feed in enumerate(feeds):
            before = {n: tscope.get(n).clone() for n in params}
            jl.append(float(np.asarray(jexe.run(
                jmain, feed=feed, fetch_list=[jloss])[0]).reshape(())))
            tl.append(float(np.asarray(texe.run(
                tmain, feed=feed, fetch_list=[tloss])[0]).reshape(())))
            if i % 2 == 0:              # the merge's off-steps
                for n in params:
                    assert torch.equal(tscope.get(n), before[n]), (i, n)
        np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
        trained = {n: tscope.get(n).clone() for n in params}
        for n in params:
            np.testing.assert_allclose(
                trained[n].numpy(), np.asarray(jscope.get(n)),
                rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=n)
        with jema.apply(), tema.apply():
            for n in params:
                np.testing.assert_allclose(
                    tscope.get(n).numpy(), np.asarray(jscope.get(n)),
                    rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg="ema " + n)
        for n in params:
            assert torch.equal(tscope.get(n), trained[n]), n
