"""The training recipe under data parallelism, with recompute, on the
CPU: ``amp.decorate`` with dynamic loss scaling, ``GradientClipByGlobalNorm``,
``L2Decay``, a ``linear_lr_warmup(polynomial_decay(...))`` schedule and
``RecomputeOptimizer`` ("dots", "nothing") through
``CompiledProgram.with_data_parallel``.

The JAX package runs the recipe (recompute included,
``paddle_tpu/core/compiler.py:242`` -> ``core/executor.py:1214``) under
its dp mesh with the single-device numbers; the port runs it through
the dp walk, each recomputed segment re-running every rank's ops. Both
build the same Program under fresh unique-name generators, JAX runs the
startup and ``scope_from_numpy`` carries its scope into the port.

Tolerances, each measured on this file's MLP (16 -> 32 -> 4, batch 16,
three steps) and stated beside the constant:

- the port at dp 2 against the port at dp 1: losses within
  DP_LOSS_RTOL (measured 0 in f32, 9.0e-8 under amp); f32 @GRADs within
  DP_F32_GRAD of their largest magnitude (measured up to 1.7e-7); under
  amp within DP_AMP_GRAD of it (measured 5.4e-3 and 3.3e-3 for the two
  weights: each rank's bf16 product of its rows rounds on its own,
  about half a bf16 ulp; 0 and 1.2e-7 for the biases, whose gradients
  take no bf16 product);
- the port against the JAX package: test_torch_train.py's tolerances in
  f32, test_torch_amp.py's under amp;
- recompute against the same run without it, at dp 2: bitwise (the
  same CPU ops on the same inputs; dropout's masks redrawn from the same
  (program seed, step, op seed, rank) generators, asserted by a spy).

A gloo world of two processes runs recompute too: its losses and
@GRADs equal the local mesh's and, where no dropout draws, the plain
single-device Executor's.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core import unique_name as jun
from paddle_tpu.core.executor import Scope as JScope, scope_guard as jguard

import paddle_tpu_torch as fluid
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.core import unique_name as tun
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops import attention_ops
from paddle_tpu_torch.ops import flash as tflash

DP_LOSS_RTOL = 1e-6
DP_F32_GRAD = 1e-6
DP_AMP_GRAD = 1e-2
LOSS_RTOL = 1e-5                    # port vs JAX, f32
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
AMP_LOSS_RTOL = 1e-3                # port vs JAX, bf16 products
AMP_GRAD_TOL = 2.0 ** -5
CPU = fluid.CPUPlace()
DP, STEPS = 2, 3
LR, WARMUP, DECAY_STEPS = 1e-2, 2, 100
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_bert.py: concurrent pytest workers oversubscribe the
    CPU otherwise)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _recipe(pkg, loss, amp, policy):
    """minimize(loss) under the recipe: Adam on the warmup-then-decay
    schedule with L2Decay, the global-norm clip, amp.decorate(2**10,
    dynamic) where `amp`, RecomputeOptimizer(policy) where given.
    Returns the decorated optimizer (None without amp)."""
    L = pkg.layers
    lr = L.linear_lr_warmup(
        L.polynomial_decay(LR, decay_steps=DECAY_STEPS,
                           end_learning_rate=0.0),
        warmup_steps=WARMUP, start_lr=0.0, end_lr=LR)
    opt = pkg.optimizer.AdamOptimizer(
        learning_rate=lr, regularization=pkg.regularizer.L2Decay(1e-2))
    decorated = None
    if amp:
        opt = decorated = pkg.amp.decorate(opt, init_loss_scaling=2.0 ** 10,
                                           use_dynamic_loss_scaling=True)
    if policy is not None:
        opt = pkg.optimizer.RecomputeOptimizer(opt, policy=policy)
    pkg.clip.set_gradient_clip(pkg.clip.GradientClipByGlobalNorm(1.0))
    try:
        opt.minimize(loss)
    finally:
        pkg.clip.set_gradient_clip(None)
    return decorated


def _mlp(pkg, un, amp, policy):
    """(main, startup, loss, decorated optimizer) of the MLP under the
    recipe."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with un.guard(), pkg.program_guard(main, startup):
        L = pkg.layers
        x = L.data("x", shape=[16], dtype="float32")
        y = L.data("y", shape=[1], dtype="int64")
        h = L.fc(x, size=32, act="relu")
        loss = L.mean(L.softmax_with_cross_entropy(L.fc(h, size=4), y))
        opt = _recipe(pkg, loss, amp, policy)
    return main, startup, loss, opt


def _feed():
    rs = np.random.RandomState(0)
    return {"x": rs.rand(16, 16).astype(np.float32),
            "y": rs.randint(0, 4, (16, 1)).astype(np.int64)}


def _steps(exe, program, scope, guard, feed, fetch_first, fetch):
    outs = []
    with guard(scope):
        for i in range(STEPS):
            outs.append([np.asarray(v) for v in exe.run(
                program, feed=feed,
                fetch_list=fetch_first if i == 0 else fetch)])
    return outs


def _scale_err(got, want):
    """The largest absolute difference over the largest magnitude."""
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


@pytest.fixture(scope="module")
def mlp_runs():
    """{(amp, policy): (JAX steps, port dp 1 steps, port dp 2 steps,
    @GRAD names)}: each step's [loss, loss scale where amp] and the first
    step's @GRADs after them."""
    runs = {}
    feed = _feed()
    for amp in (False, True):
        for policy in (None, "dots", "nothing"):
            jmain, jstart, jloss, jopt = _mlp(jfluid, jun, amp, policy)
            tmain, _ts, tloss, topt = _mlp(fluid, tun, amp, policy)
            gnames = [p.name + "@GRAD" for p in tmain.all_parameters()]
            extra = [topt.get_loss_scaling().name] if amp else []
            fetch = [tloss.name] + extra
            jscope = JScope()
            with jguard(jscope):
                jfluid.Executor().run(jstart)
            init = {n: np.asarray(jscope.get(n)) for n in jscope.names()}
            jcomp = jfluid.CompiledProgram(jmain).with_data_parallel(
                loss_name=jloss.name,
                places=[jfluid.CUDAPlace(0), jfluid.CUDAPlace(1)])
            want = _steps(jfluid.Executor(), jcomp, jscope, jguard, feed,
                          fetch + gnames, fetch)
            texe = fluid.Executor(CPU)
            got = []
            for prog in (tmain, fluid.CompiledProgram(tmain)
                         .with_data_parallel(loss_name=tloss.name,
                                             places=[CPU] * DP)):
                got.append(_steps(texe, prog,
                                  fluid.scope_from_numpy(init, "cpu"),
                                  fluid.scope_guard, feed, fetch + gnames,
                                  fetch))
            runs[amp, policy] = (want, got[0], got[1], gnames,
                                 1 + len(extra))
    return runs


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "amp"])
@pytest.mark.parametrize("policy", [None, "dots", "nothing"])
def test_recipe_at_dp2_matches_dp1(mlp_runs, amp, policy):
    """The port at dp 2 against dp 1: losses (and the loss scale, exact),
    the first step's @GRADs at this file's dp tolerances."""
    _want, dp1, dp2, gnames, k = mlp_runs[amp, policy]
    for a, b in zip(dp2, dp1):
        np.testing.assert_allclose(a[0], b[0], rtol=DP_LOSS_RTOL)
        if amp:
            assert float(a[1]) == float(b[1])
    tol = DP_AMP_GRAD if amp else DP_F32_GRAD
    for name, a, b in zip(gnames, dp2[0][k:], dp1[0][k:]):
        assert _scale_err(a, b) <= tol, (name, _scale_err(a, b))


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "amp"])
@pytest.mark.parametrize("policy", [None, "dots", "nothing"])
def test_recipe_at_dp2_matches_jax(mlp_runs, amp, policy):
    """The port at dp 2 against JAX's with_data_parallel over two
    devices: losses, the loss scale (exact) and the first step's
    @GRADs."""
    want, _dp1, got, gnames, k = mlp_runs[amp, policy]
    gmax = max(float(np.abs(g).max()) for g in want[0][k:])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a[0], b[0],
                                   rtol=AMP_LOSS_RTOL if amp else LOSS_RTOL)
        if amp:
            assert float(a[1]) == float(b[1])
    for name, a, b in zip(gnames, got[0][k:], want[0][k:]):
        if amp:
            bound = AMP_GRAD_TOL * float(np.abs(b).max()) + 1e-3 * gmax
            assert float(np.abs(a - b).max()) <= bound, name
        else:
            np.testing.assert_allclose(a, b, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "amp"])
@pytest.mark.parametrize("policy", ["dots", "nothing"])
def test_recompute_at_dp2_is_bitwise_the_run_without(mlp_runs, amp,
                                                     policy):
    _w, _d, plain, _g, _k = mlp_runs[amp, None]
    _w, _d, got, _g, _k = mlp_runs[amp, policy]
    for a, b in zip(got, plain):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# BERT-tiny with dropout: recompute's masks and the flash forward, per rank
# ---------------------------------------------------------------------------

BERT_SEQ, BERT_BATCH = 32, 4


def _bert(policy):
    cfg = tbert.bert_tiny()
    cfg.num_hidden_layers = 2
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.1
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with tun.guard(), fluid.program_guard(main, startup):
        _f, loss, _mlm, _acc = tbert.build_pretrain_net(cfg, seq_len=BERT_SEQ)
        _recipe(fluid, loss, True, policy)
    return cfg, main, startup, loss


def test_bert_recipe_recompute_at_dp2_redraws_each_ranks_masks(
        monkeypatch):
    """BERT-tiny (2 layers, dropout 0.1) under the recipe at dp 2, two
    steps, without recompute and under "dots" and "nothing": losses and
    the first step's @GRADs bitwise equal. Under recompute a dropout op
    runs again a rank and step where the checkpoint's re-run reaches it
    (torch's non-reentrant checkpoint stops a segment's re-run once the
    backward has what it needs), and every re-run draws the forward's
    mask for that rank; the two ranks' masks differ (rank-folded
    streams). The attention's
    forward runs 2 x layers x dp times a step under recompute, layers x
    dp without, its backward layers x dp."""
    masks = {}
    calls = {"fwd": 0, "bwd": 0}
    real = tops._REGISTRY["dropout"]
    fwd, bwd = tflash.flash_attention_reference, \
        tflash.flash_attention_bwd_reference

    def spy(ctx):
        out = real(ctx)
        key = (policy, step, ctx.op.output("Out")[0], ctx.dp_rank)
        masks.setdefault(key, []).append(out["Out"].detach() != 0)
        return out

    def count_fwd(*a):
        calls["fwd"] += 1
        return fwd(*a)

    def count_bwd(*a):
        calls["bwd"] += 1
        return bwd(*a)

    monkeypatch.setitem(tops._REGISTRY, "dropout", spy)
    monkeypatch.setattr(tflash, "flash_attention_reference", count_fwd)
    monkeypatch.setattr(tflash, "flash_attention_bwd_reference", count_bwd)
    monkeypatch.setattr(attention_ops, "dot_product_attention",
                        tflash.flash_attention)
    base = None
    results = {}
    for policy in (None, "dots", "nothing"):
        cfg, main, startup, loss = _bert(policy)
        if base is None:
            base = fluid.Scope()
            fluid.Executor(CPU).run(startup, scope=base)
        scope = fluid.Scope()
        for n in base.names():
            scope.set(n, base.get(n).clone())
        feed = tbert.make_pretrain_feed(cfg, BERT_SEQ, BERT_BATCH, seed=0)
        comp = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, places=[CPU] * DP)
        gnames = [p.name + "@GRAD" for p in main.all_parameters()]
        exe = fluid.Executor(CPU)
        outs = []
        for step in range(2):
            before = dict(calls)
            outs.append(exe.run(comp, feed=feed, scope=scope,
                                fetch_list=[loss] + (gnames if step == 0
                                                     else [])))
            n = cfg.num_hidden_layers * DP
            assert calls["fwd"] - before["fwd"] == (1 if policy is None
                                                    else 2) * n
            assert calls["bwd"] - before["bwd"] == n
        results[policy] = outs
    for policy in ("dots", "nothing"):
        for a, b in zip(results[policy], results[None]):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    drops = {k[2] for k in masks}
    assert drops
    for policy in (None, "dots", "nothing"):
        redrawn = 0
        for step in range(2):
            for name in drops:
                per_rank = [masks[policy, step, name, r] for r in range(DP)]
                assert not torch.equal(per_rank[0][0], per_rank[1][0])
                for r, drawn in enumerate(per_rank):
                    assert len(drawn) <= (1 if policy is None else 2)
                    redrawn += len(drawn) - 1
                    assert all(torch.equal(m, masks[None, step, name, r][0])
                               for m in drawn)
        assert (redrawn > 0) == (policy is not None), (policy, redrawn)


# ---------------------------------------------------------------------------
# recompute in a gloo world: two processes
# ---------------------------------------------------------------------------

WORKER = r'''
import datetime
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def nets(fluid):
    """{case: (net, draws dropout)}: a penalty beside the rows, a
    reduction read back by the rows, an MLP with dropout."""
    L = fluid.layers

    def penalty():
        x = L.data("x", shape=[3], dtype="float32")
        h = L.fc(x, size=2, bias_attr=False)
        (w,) = fluid.default_main_program().all_parameters()
        decay = L.scale(L.reduce_sum(L.elementwise_mul(w, w)), 0.5)
        return L.elementwise_add(L.mean(h), decay)

    def reduced_into_rows():
        x = L.data("x", shape=[3], dtype="float32")
        h = L.fc(x, size=2)
        d = L.elementwise_add(h, L.scale(L.mean(h), -1.0))
        return L.mean(L.elementwise_mul(d, d))

    def dropout_mlp():
        x = L.data("x", shape=[3], dtype="float32")
        h = L.dropout(L.fc(x, size=8, act="relu"), 0.3)
        return L.mean(L.fc(h, size=2))

    return {"penalty": (penalty, False),
            "reduced_into_rows": (reduced_into_rows, False),
            "dropout_mlp": (dropout_mlp, True)}


def rank_main(rank, init, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    try:
        import paddle_tpu_torch as fluid
        from paddle_tpu_torch.core import unique_name as tun
        x = np.random.RandomState(3).rand(4, 3).astype(np.float32)
        res = {}
        for case, (net, _drops) in nets(fluid).items():
            for policy in (None, "nothing", "dots"):
                main, startup = fluid.Program(), fluid.Program()
                main.random_seed = startup.random_seed = 5
                with tun.guard(), fluid.program_guard(main, startup):
                    loss = net()
                    opt = fluid.optimizer.SGDOptimizer(0.1)
                    if policy is not None:
                        opt = fluid.optimizer.RecomputeOptimizer(
                            opt, policy=policy)
                    opt.minimize(loss)
                fetch = [loss] + [p.name + "@GRAD"
                                  for p in main.all_parameters()]
                # a new Executor a run: its step counter seeds the
                # random ops
                init_scope = fluid.Scope()
                fluid.Executor(fluid.CPUPlace()).run(startup,
                                                     scope=init_scope)
                forms = {
                    "world": fluid.CompiledProgram(main).with_data_parallel(
                        loss_name=loss.name),
                    "local": fluid.CompiledProgram(main).with_data_parallel(
                        loss_name=loss.name,
                        places=[fluid.CPUPlace()] * 2),
                    "plain": main}
                for form, prog in forms.items():
                    scope = fluid.Scope()
                    for n in init_scope.names():
                        scope.set(n, init_scope.get(n).clone())
                    exe = fluid.Executor(fluid.CPUPlace())
                    for step in range(2):
                        got = exe.run(prog, feed={"x": x}, fetch_list=fetch,
                                      scope=scope)
                        for k, v in enumerate(got):
                            res[f"{case}/{policy}/{form}/{step}/{k}"] = v
        np.savez(out + "/rank%d.npz" % rank, **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    init, out = sys.argv[1], sys.argv[2]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, init, out))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(150)
    codes = [p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    sys.exit(0 if codes == [0, 0] else 1)
'''


def test_recompute_in_a_gloo_world_counts_every_path_once(tmp_path):
    """Two gloo processes (``file://`` rendezvous; every wait bounded)
    run SGD steps under recompute "nothing" and "dots" and without: a
    penalty beside the batch, a reduction read back by the rows (whose
    dp all-reduce the checkpoint replays in the backward, in the same
    order on both ranks), an MLP with dropout 0.3. On both ranks each
    step's loss and @GRADs equal the local mesh's and the run without
    recompute (bitwise where the ops are the same: the replayed
    all-reduce sums two partials in rank order either way), and, where
    no dropout draws, the plain Executor's single-device numbers at the
    dp tolerances (test_torch_data_parallel.py's 1e-4 + 1e-6)."""
    script = tmp_path / "recompute_worker.py"
    script.write_text(WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run(
        [sys.executable, str(script), "file://" + str(tmp_path / "rdv"),
         str(tmp_path)], env=env, cwd=str(tmp_path), capture_output=True,
        text=True, timeout=200)
    assert res.returncode == 0, res.stderr[-4000:]
    drops = {"penalty": False, "reduced_into_rows": False,
             "dropout_mlp": True}
    for rank in range(DP):
        got = np.load(tmp_path / f"rank{rank}.npz")
        for case, dropout in drops.items():
            keys = [k for k in got.files
                    if k.startswith(f"{case}/None/plain/0/")]
            assert len(keys) >= 2
            for policy in ("None", "nothing", "dots"):
                for step in range(2):
                    for k in range(len(keys)):
                        world = got[f"{case}/{policy}/world/{step}/{k}"]
                        local = got[f"{case}/{policy}/local/{step}/{k}"]
                        plain_dp = got[f"{case}/None/world/{step}/{k}"]
                        assert np.abs(world).max() > 0, (case, k)
                        np.testing.assert_allclose(
                            world, local, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                            err_msg=f"{case} {policy} {step} {k}")
                        np.testing.assert_array_equal(world, plain_dp)
                        if not dropout:
                            np.testing.assert_allclose(
                                world, got[f"{case}/None/plain/{step}/{k}"],
                                rtol=GRAD_RTOL, atol=GRAD_ATOL)
