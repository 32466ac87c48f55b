"""The "offload" recompute policy in the port, on the CPU.

``RecomputeOptimizer(opt, policy="offload")`` (JAX's
``offload_dot_with_no_batch_dims``): "dots" with the saved products in
host memory. On the card the forward copies each ``aten.mm`` /
``aten.addmm`` output into pinned host memory and the backward's
recompute brings it back; on the CPU there is nothing to pin, and the
policy keeps the outputs as they are, so these tests hold its contract:
the step is bitwise the plain run's (dropout on), matches the JAX
Executor without recompute at test_torch_recompute.py's tolerances, the
backward re-runs the flash forward once a layer and no product (the
saved ones come back instead), and the policy is accepted by name. The
refusal test it replaces (``test_offload_policy_raises_by_name``) went
with the refusal.
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
from paddle_tpu_torch.optimizer import recompute
from test_torch_recompute import (BATCH, CPU, GRAD_ATOL, GRAD_RTOL,
                                  LOSS_RTOL, SEQ, STEPS, _backward_products,
                                  _build, _cfg, _copy, _run,
                                  test_recompute_reruns_the_flash_forward
                                  as _reruns_the_flash_forward)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (the suite runs
    several pytest workers at once; see tests/test_torch_bert.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_offload_policy_accepted_by_name():
    opt = fluid.optimizer.RecomputeOptimizer(
        fluid.optimizer.SGDOptimizer(learning_rate=0.1), policy="offload")
    assert opt._policy == "offload"
    with pytest.raises(ValueError):
        recompute.resolve_policy("offload_everything")


def test_offload_is_bitwise_the_plain_run():
    """From a copy of one startup scope, dropout 0.1: three steps' losses
    and the first step's gradients exactly the plain run's."""
    cfg = _cfg(tbert, 0.1)
    feed = tbert.make_pretrain_feed(cfg, SEQ, BATCH, seed=0)
    pmain, pstart, ploss = _build(fluid, tbert, tun, cfg)
    rmain, _rs, rloss = _build(fluid, tbert, tun, cfg, "offload")
    assert rmain._recompute == {"policy": "offload"}
    base = fluid.Scope()
    fluid.Executor(CPU).run(pstart, scope=base)
    pl, pg, names = _run(pmain, ploss, _copy(base), feed)
    rl, rg, _ = _run(rmain, rloss, _copy(base), feed)
    assert rl == pl
    for n, a, b in zip(names, pg, rg):
        np.testing.assert_array_equal(b, a, err_msg=n)


def test_offload_matches_jax_executor():
    """Against the JAX Executor without recompute, dropout 0, from its
    startup scope (losses 1e-5 relative, first-step gradients 1e-4 +
    1e-6)."""
    jcfg, tcfg = _cfg(jbert, 0.0), _cfg(tbert, 0.0)
    feed = tbert.make_pretrain_feed(tcfg, SEQ, BATCH, seed=1)
    jmain, jstart, jloss = _build(jfluid, jbert, jun, jcfg)
    tmain, _ts, tloss = _build(fluid, tbert, tun, tcfg, "offload")
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


def test_offload_recomputes_no_product(monkeypatch):
    """The backward of an "offload" step dispatches no more aten.mm /
    aten.addmm than the plain step's: the recompute takes the saved
    outputs back instead of running the products."""
    plain = _backward_products(monkeypatch, None)
    assert plain > 0
    assert _backward_products(monkeypatch, "offload") == plain


def test_offload_reruns_the_flash_forward(monkeypatch):
    """The recompute re-runs everything but the products: the flash
    forward twice a layer a step, its backward once."""
    _reruns_the_flash_forward(monkeypatch, "offload", 2)


def test_offload_modes_replay_in_order():
    """The two dispatch modes alone: the forward keeps each product's
    output, the recompute returns them in order without running the
    products (a product of other inputs still gets the kept value)."""
    save, load = recompute._offload_contexts()
    a, b = torch.randn(3, 4), torch.randn(4, 5)
    with save:
        first = a @ b
        second = torch.addmm(torch.ones(5), a, b)
        other = a.sum()
    assert len(save.store) == 2
    with load:
        again = torch.zeros(3, 4) @ b
        again2 = torch.addmm(torch.zeros(5), a, b)
        other2 = a.sum()
    assert torch.equal(again, first) and torch.equal(again2, second)
    assert torch.equal(other2, other) and load.i == 2
