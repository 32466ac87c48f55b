"""RecomputeOptimizer in the port (``paddle_tpu_torch.optimizer.recompute``
and the Executor's checkpointed forward), on the CPU.

Twins of ``tests/api/test_recompute.py``: recompute is numerically
invisible (the JAX test holds remat's losses to the plain run's), the
backward re-runs the forward (there: rematted instructions in the
compiled step; here: the flash forward's calls counted), and an unknown
policy is rejected when the optimizer is built. On BERT-tiny (4 layers,
width 256):

- against the port's own plain run, with dropout 0.1: three steps' losses
  and the first step's gradients bitwise equal (tolerance 0: the same CPU
  ops on the same inputs, dropout's masks redrawn from the same
  (program seed, step, op seed) generators);
- against the JAX Executor without recompute, dropout 0, from its startup
  scope: test_torch_train.py's tolerances (losses 1e-5 relative, first
  step gradients 1e-4 relative + 1e-6 absolute).

"dots" is shown to save the 2-D products: the backward of a "dots" step
dispatches as many ``aten.mm`` / ``aten.addmm`` as the plain step's (none
recomputed), a "nothing" step's more. "offload" has its own file,
``tests/test_torch_offload.py``.
"""

import collections

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as jfluid
from paddle_tpu.core import unique_name as jun
from paddle_tpu.core.executor import Scope as JScope, scope_guard as jguard
from paddle_tpu.models import bert as jbert

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import unique_name as tun
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops import attention_ops
from paddle_tpu_torch.ops import flash as tflash

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
CPU = fluid.CPUPlace()
SEQ, BATCH, STEPS = 32, 4, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (the suite runs
    several pytest workers at once; see tests/test_torch_bert.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(bert, dropout):
    cfg = bert.bert_tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = dropout
    return cfg


def _build(pkg, bert, un, cfg, policy=None, seed=7):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with un.guard(), pkg.program_guard(main, startup):
        _f, loss, _mlm, _acc = bert.build_pretrain_net(cfg, seq_len=SEQ)
        opt = pkg.optimizer.AdamOptimizer(1e-3)
        if policy is not None:
            opt = pkg.optimizer.RecomputeOptimizer(opt, policy=policy)
        opt.minimize(loss)
    return main, startup, loss


def _run(main, loss, scope, feed, steps=STEPS):
    """(losses, the first step's @GRADs, their names)."""
    names = [p.name + "@GRAD" for p in main.all_parameters()]
    exe = fluid.Executor(CPU)
    losses = []
    with fluid.scope_guard(scope):
        for i in range(steps):
            out = exe.run(main, feed=feed,
                          fetch_list=[loss] + (names if i == 0 else []))
            losses.append(float(np.asarray(out[0]).reshape(())))
            if i == 0:
                grads = out[1:]
    return losses, grads, names


def _copy(scope):
    new = fluid.Scope()
    for n in scope.names():
        new.set(n, scope.get(n).clone())
    return new


@pytest.mark.parametrize("policy", ["dots", "nothing", "everything"])
def test_recompute_is_bitwise_the_plain_run(policy):
    """Each policy, from a copy of one startup scope, with dropout on:
    the plain run's losses and first-step gradients exactly."""
    cfg = _cfg(tbert, 0.1)
    feed = tbert.make_pretrain_feed(cfg, SEQ, BATCH, seed=0)
    pmain, pstart, ploss = _build(fluid, tbert, tun, cfg)
    rmain, _rs, rloss = _build(fluid, tbert, tun, cfg, policy)
    assert rmain._recompute == {"policy": policy}
    base = fluid.Scope()
    fluid.Executor(CPU).run(pstart, scope=base)
    pl, pg, names = _run(pmain, ploss, _copy(base), feed)
    rl, rg, _ = _run(rmain, rloss, _copy(base), feed)
    assert rl == pl
    for n, a, b in zip(names, pg, rg):
        np.testing.assert_array_equal(b, a, err_msg=n)


@pytest.mark.parametrize("policy", ["dots", "nothing"])
def test_recompute_matches_jax_executor(policy):
    """The port under recompute against the JAX Executor without it
    (test_recompute.py:60 holds JAX's remat to its plain run), dropout 0,
    from JAX's startup scope."""
    jcfg, tcfg = _cfg(jbert, 0.0), _cfg(tbert, 0.0)
    feed = tbert.make_pretrain_feed(tcfg, SEQ, BATCH, seed=1)
    jmain, jstart, jloss = _build(jfluid, jbert, jun, jcfg)
    tmain, _ts, tloss = _build(fluid, tbert, tun, tcfg, policy)
    jscope, jexe = JScope(), jfluid.Executor()
    with jguard(jscope):
        jexe.run(jstart)
    tscope = fluid.scope_from_numpy(
        {n: np.asarray(jscope.get(n)) for n in jscope.names()}, "cpu")
    tl, tg, names = _run(tmain, tloss, tscope, feed)
    jl = []
    with jguard(jscope):
        for i in range(STEPS):
            out = jexe.run(jmain, feed=feed, fetch_list=[jloss.name] + (
                names if i == 0 else []))
            jl.append(float(np.asarray(out[0]).reshape(())))
            if i == 0:
                jg = out[1:]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=0)
    for n, a, b in zip(names, jg, tg):
        np.testing.assert_allclose(b, a, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=n)


@pytest.mark.parametrize("policy,forwards", [(None, 1), ("everything", 1),
                                             ("dots", 2), ("nothing", 2)])
def test_recompute_reruns_the_flash_forward(monkeypatch, policy, forwards):
    """The attention through the port's differentiable flash function
    (its plain version on the CPU, as dry runs of the card's path take
    it): a step runs its forward `forwards` x layers times (twice under
    a recomputing policy, where the checkpoint re-runs _Flash.forward)
    and its backward once a layer (the counterpart of
    test_recompute.py:68)."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tflash.flash_attention_reference, \
        tflash.flash_attention_bwd_reference

    def count_fwd(*a):
        calls["fwd"] += 1
        return fwd(*a)

    def count_bwd(*a):
        calls["bwd"] += 1
        return bwd(*a)

    monkeypatch.setattr(tflash, "flash_attention_reference", count_fwd)
    monkeypatch.setattr(tflash, "flash_attention_bwd_reference", count_bwd)
    monkeypatch.setattr(attention_ops, "dot_product_attention",
                        tflash.flash_attention)
    cfg = _cfg(tbert, 0.0)
    main, startup, loss = _build(fluid, tbert, tun, cfg, policy)
    feed = tbert.make_pretrain_feed(cfg, SEQ, BATCH, seed=0)
    scope = fluid.Scope()
    exe = fluid.Executor(CPU)
    exe.run(startup, scope=scope)
    for step in range(2):
        before = dict(calls)
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        n = cfg.num_hidden_layers
        assert calls["fwd"] - before["fwd"] == forwards * n, (step, calls)
        assert calls["bwd"] - before["bwd"] == n, (step, calls)


class _BackwardProducts(TorchDispatchMode):
    """Counts the aten.mm / aten.addmm dispatched once the backward has
    started (torch.autograd.grad entered): the backward's own products
    plus those its recompute re-runs."""

    PRODUCTS = ("aten.mm.default", "aten.addmm.default")

    def __init__(self):
        super().__init__()
        self.backward = False
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.backward and str(func) in self.PRODUCTS:
            self.counts[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _backward_products(monkeypatch, policy):
    cfg = _cfg(tbert, 0.0)
    main, startup, loss = _build(fluid, tbert, tun, cfg, policy)
    feed = tbert.make_pretrain_feed(cfg, SEQ, BATCH, seed=0)
    scope = fluid.Scope()
    exe = fluid.Executor(CPU)
    exe.run(startup, scope=scope)
    mode, grad = _BackwardProducts(), torch.autograd.grad

    def backward(*a, **k):
        mode.backward = True
        return grad(*a, **k)

    monkeypatch.setattr(torch.autograd, "grad", backward)
    with mode:
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert mode.backward
    return sum(mode.counts.values())


@pytest.mark.parametrize("policy,recomputed", [("dots", False),
                                               ("nothing", True)])
def test_dots_saves_the_products(monkeypatch, policy, recomputed):
    """The 2-D products the backward's recompute re-runs: none under
    "dots" (its selective policy must-saves the outputs of aten.mm /
    aten.addmm, JAX's dots_with_no_batch_dims_saveable), some under
    "nothing" (a plain checkpoint saves only a segment's inputs). Counted
    against the plain step's backward, which recomputes nothing."""
    plain = _backward_products(monkeypatch, None)
    extra = _backward_products(monkeypatch, policy) - plain
    assert plain > 0
    if recomputed:
        assert extra > 0
    else:
        assert extra == 0


def test_unknown_policy_rejected_when_built():
    """test_recompute.py:83."""
    with pytest.raises(ValueError):
        fluid.optimizer.RecomputeOptimizer(
            fluid.optimizer.SGDOptimizer(learning_rate=0.1), policy="bogus")
