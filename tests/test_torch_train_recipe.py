"""The whole training recipe on BERT-tiny pretraining, the port against the
JAX Executor, on the CPU.

The recipe of the card's phase 20 (PaddlePaddle's LARK BERT recipe's
shape) at a small size: ``amp.decorate(AdamOptimizer(learning_rate=
linear_lr_warmup(polynomial_decay(...)), regularization=L2Decay(1e-2)),
init_loss_scaling=2**15, use_dynamic_loss_scaling=True)`` under
``set_gradient_clip(GradientClipByGlobalNorm(1.0))``: bf16 products, loss
scaling, warmup then linear decay, the global-norm clip and weight
decay. Both packages build the same Program under fresh unique-name
generators, JAX runs the startup and its scope is carried into the port.
Tolerances are tests/test_torch_amp.py's (bf16 products on both sides):
losses 1e-3 relative, the first step's gradients 2**-5 of their max +
1e-3 of the step's largest; the learning rate and the loss scale
exactly as JAX's (f32 scalar ops) and the rate within 1e-6 of the
schedule's closed form.
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

AMP_LOSS_RTOL = 1e-3
AMP_GRAD_TOL = 2.0 ** -5
CPU = fluid.CPUPlace()
SEQ, BATCH = 32, 4
PEAK_LR, DECAY_STEPS, WARMUP = 1e-3, 10, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (the suite runs
    several pytest workers at once; see tests/test_torch_bert.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scalar(x):
    return float(np.asarray(x).reshape(-1)[0])


def recipe_lr(step):
    """The schedule's closed form at step `step` (0-based)."""
    if step < WARMUP:
        return PEAK_LR * step / WARMUP
    return PEAK_LR * (1 - min(step, DECAY_STEPS) / DECAY_STEPS)


def _build(pkg, bert, un, policy=None, seed=7):
    cfg = bert.bert_tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    cfg.num_hidden_layers = 2
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with un.guard(), pkg.program_guard(main, startup):
        _f, loss, _mlm, _acc = bert.build_pretrain_net(cfg, seq_len=SEQ)
        lay = pkg.layers
        lr = lay.linear_lr_warmup(
            lay.polynomial_decay(PEAK_LR, decay_steps=DECAY_STEPS,
                                 end_learning_rate=0.0),
            warmup_steps=WARMUP, start_lr=0.0, end_lr=PEAK_LR)
        opt = pkg.amp.decorate(
            pkg.optimizer.AdamOptimizer(
                learning_rate=lr,
                regularization=pkg.regularizer.L2Decay(1e-2)),
            init_loss_scaling=2.0 ** 15, use_dynamic_loss_scaling=True)
        outer = opt if policy is None else \
            pkg.optimizer.RecomputeOptimizer(opt, policy=policy)
        pkg.clip.set_gradient_clip(
            pkg.clip.GradientClipByGlobalNorm(1.0))
        try:
            outer.minimize(loss)
        finally:
            pkg.clip.set_gradient_clip(None)
    return cfg, main, startup, loss, lr, opt


def test_recipe_matches_jax_executor():
    """Three steps: each loss, learning rate and loss scale, and the
    first step's gradients as the update reads them (unscaled, clipped,
    decayed) against JAX's."""
    cfg, jmain, jstart, jloss, jlr, _jopt = _build(jfluid, jbert, jun)
    _c, tmain, _ts, tloss, tlr, topt = _build(fluid, tbert, tun)
    ops = [op.type for op in tmain.global_block().ops]
    assert ops[0] == "increment"
    for t in ("select_finite", "square", "sqrt", "elementwise_max", "adam",
              "less_than", "elementwise_pow"):
        assert t in ops, t
    feed = tbert.make_pretrain_feed(cfg, SEQ, BATCH, seed=0)
    jscope, jexe = JScope(), jfluid.Executor()
    with jguard(jscope):
        jexe.run(jstart)
    tscope = fluid.scope_from_numpy(
        {n: np.asarray(jscope.get(n)) for n in jscope.names()}, "cpu")
    texe = fluid.Executor(CPU)
    gnames = [p.name + "@GRAD" for p in tmain.all_parameters()]
    scale = topt.get_loss_scaling().name
    for i in range(3):
        fetch = [jloss.name, jlr.name, scale] + (gnames if i == 0 else [])
        with jguard(jscope):
            jo = jexe.run(jmain, feed=feed, fetch_list=fetch)
        with fluid.scope_guard(tscope):
            to = texe.run(tmain, feed=feed, fetch_list=fetch)
        np.testing.assert_allclose(to[0], jo[0], rtol=AMP_LOSS_RTOL)
        assert _scalar(to[1]) == _scalar(jo[1])
        assert _scalar(to[1]) == pytest.approx(recipe_lr(i), rel=1e-6,
                                               abs=1e-12)
        assert _scalar(to[2]) == _scalar(jo[2]) == 2.0 ** 15
        if i == 0:
            gmax = max(float(np.abs(a).max()) for a in jo[3:])
            for n, a, b in zip(gnames, jo[3:], to[3:]):
                err = float(np.abs(a - b).max())
                assert err <= AMP_GRAD_TOL * float(np.abs(a).max()) \
                    + 1e-3 * gmax, (n, err)


def test_recipe_under_recompute_is_bitwise_the_plain_recipe():
    """The recipe's amp casts, loss scaling, clip and decay under
    RecomputeOptimizer(policy="dots"): three steps' losses exactly the
    plain recipe's, from copies of one startup scope."""
    cfg, pmain, pstart, ploss, _pl, _po = _build(fluid, tbert, tun)
    _c, rmain, _rs, rloss, _rl, _ro = _build(fluid, tbert, tun, "dots")
    feed = tbert.make_pretrain_feed(cfg, SEQ, BATCH, seed=2)
    base = fluid.Scope()
    exe = fluid.Executor(CPU)
    exe.run(pstart, scope=base)
    out = []
    for main, loss in ((pmain, ploss), (rmain, rloss)):
        scope = fluid.Scope()
        for n in base.names():
            scope.set(n, base.get(n).clone())
        out.append([_scalar(exe.run(main, feed=feed, fetch_list=[loss],
                                    scope=scope)[0]) for _ in range(3)])
    assert out[1] == out[0]
