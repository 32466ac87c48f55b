"""Data-parallel training through the port's ``CompiledProgram`` /
``ParallelExecutor``, against the JAX package, on the CPU.

The JAX package runs its dp programs on the 8 virtual CPU devices of
``tests/conftest.py`` under GSPMD, whose results are the global batch's:
the loss over every rank's rows, its gradient, the global fetches. The
port splits the batch over a local mesh (every rank in this process, in
turn; ``places=[CPUPlace()] * n``) or a gloo world of two processes, and
must give the same numbers. Where both packages train, both build the
same Program under fresh unique-name generators, JAX runs the startup and
``scope_from_numpy`` carries its scope into the port. Inputs come from
numpy seeds; dropout is 0 wherever the two are compared (the port's
random streams are torch's, folded with the dp rank). Tolerances:
losses within 1e-5 relative, @GRADs and parameters within 1e-4 relative
plus 1e-6 absolute, unless a test states otherwise.

Twins of ``tests/parallel/test_parallel_modes.py`` (dp and the shard
rules), ``test_gpt_sp.py``, ``test_sp_framework.py::
test_sp_framework_program_matches_single_device`` and
``test_sync_batch_norm.py``'s op rewrite; BERT's weighted masked-LM mean
with unequal masks per rank, ``mask_pos`` across ranks, the global
``accuracy`` and sharded fetches, the gloo world, the reductions a step,
the dp rules and the refusals are the port's own checks against JAX's
global-batch results.
"""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu import layers as jlayers
from paddle_tpu.core import unique_name as jun
from paddle_tpu.core.executor import Scope as JScope, scope_guard as jguard
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.parallel import data_parallel as jdp
from paddle_tpu.parallel import tensor_parallel as jtp
from paddle_tpu.parallel.mesh import make_mesh as jmake_mesh

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.core import unique_name as tun
from paddle_tpu_torch.core.compiler import DataParallelWalk
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.parallel import (PartitionSpec, ShardRules,
                                       apply_shard_rules, data_parallel_step,
                                       make_mesh, shard_state)

tra = importlib.import_module("paddle_tpu_torch.parallel.ring_attention")

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
CPU = fluid.CPUPlace()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, BATCH, DP = 32, 4, 2
# BERT-tiny's reductions a step: the NSP mean, accuracy, the MLM gather
# and its two sums over dim 0 (each one dp collective)
BERT_REDUCTIONS = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_bert.py: concurrent pytest workers oversubscribe the
    CPU otherwise)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _local(dp=1, sp=1, tp=1):
    return make_mesh(dp=dp, sp=sp, tp=tp, devices=["cpu"] * (dp * sp * tp))


def _build(pkg, un, net, seed=7):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with un.guard(), pkg.program_guard(main, startup):
        out = net()
    return main, startup, out


def _numpy(jscope):
    return {n: np.asarray(jscope.get(n)) for n in jscope.names()}


def _carry(jscope):
    return fluid.scope_from_numpy(_numpy(jscope), "cpu")


def _copy(scope):
    new = fluid.Scope()
    for n in scope.names():
        new.set(n, scope.get(n).clone())
    return new


def _jscope(arrays):
    """A JAX scope of new arrays (a JAX step donates its state's)."""
    new = JScope()
    for n, v in arrays.items():
        new.set(n, jnp.asarray(v))
    return new


def _scalar(v):
    return float(np.asarray(v).reshape(-1)[0])


def _assert_grads(got, want, names):
    assert len(got) == len(want) == len(names)
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# (a) the MLP of test_parallel_modes.py at dp 8
# ---------------------------------------------------------------------------

def _mlp(pkg, layers):
    def net():
        img = layers.data("x", shape=[16], dtype="float32")
        label = layers.data("y", shape=[1], dtype="int64")
        h = layers.fc(img, size=32, act="relu")
        logits = layers.fc(h, size=4)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        pkg.optimizer.SGDOptimizer(0.1).minimize(loss)
        return loss
    return net


def _mlp_programs():
    """(JAX main, JAX startup, JAX loss, port main, port loss)."""
    jmain, jstart, jloss = _build(jfluid, jun, _mlp(jfluid, jlayers))
    tmain, _tstart, tloss = _build(fluid, tun, _mlp(fluid, tlayers))
    return jmain, jstart, jloss, tmain, tloss


def _mlp_feed():
    rs = np.random.RandomState(0)
    return {"x": rs.rand(16, 16).astype(np.float32),
            "y": rs.randint(0, 4, (16, 1)).astype(np.int64)}


def test_mlp_dp8_matches_jax_with_data_parallel(monkeypatch):
    """test_parallel_modes.py:35: three SGD steps of the MLP at dp 8,
    JAX's with_data_parallel on its 8 devices and the port's on
    [CPUPlace()] * 8: losses and the parameters after, and every rank's
    `mul` sees its (16 / 8, ...) rows."""
    feed = _mlp_feed()
    jmain, jstart, jloss, tmain, tloss = _mlp_programs()
    jscope, jexe = JScope(), jfluid.Executor()
    with jguard(jscope):
        jexe.run(jstart)
    tscope = _carry(jscope)
    jcomp = jfluid.CompiledProgram(jmain).with_data_parallel(
        loss_name=jloss.name)
    tcomp = fluid.CompiledProgram(tmain).with_data_parallel(
        loss_name=tloss.name, places=[CPU] * 8)
    assert tcomp.mesh.shape["dp"] == 8 and not tcomp.mesh.world
    seen = []
    real = tops._REGISTRY["mul"]

    def spy(ctx):
        seen.append(tuple(ctx.in_("X").shape))
        return real(ctx)

    monkeypatch.setitem(tops._REGISTRY, "mul", spy)
    texe = fluid.Executor(CPU)
    jl, tl = [], []
    for _ in range(3):
        with jguard(jscope):
            jl.append(_scalar(jexe.run(jcomp, feed=feed,
                                       fetch_list=[jloss])[0]))
        with fluid.scope_guard(tscope):
            tl.append(_scalar(texe.run(tcomp, feed=feed,
                                       fetch_list=[tloss])[0]))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert set(seen) == {(2, 16), (2, 32)} and len(seen) == 3 * 2 * 8
    for p in tmain.all_parameters():
        np.testing.assert_allclose(tscope.get(p.name).numpy(),
                                   np.asarray(jscope.get(p.name)),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=p.name)


# ---------------------------------------------------------------------------
# BERT-tiny at dp 2: the weighted MLM mean, mask_pos, accuracy, fetches
# ---------------------------------------------------------------------------

def _bert_cfg(layers=2):
    cfg = tbert.bert_tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    cfg.num_hidden_layers = layers
    return cfg


def _bert_net(pkg, bert, cfg, lr=1e-3):
    def net():
        _f, total, _mlm, acc = bert.build_pretrain_net(cfg, seq_len=SEQ)
        pkg.optimizer.AdamOptimizer(lr).minimize(total)
        return total, acc
    return net


def _gather_out(main):
    """The name of the MLM gather's output (the masked rows, sharded)."""
    (op,) = [op for op in main.global_block().ops if op.type == "gather"]
    return op.output("Out")[0]


def _unequal_feed(cfg, cross=False):
    """make_pretrain_feed at batch 4 with rank 0's rows (0, 1) keeping one
    prediction each and rank 1's all of theirs; `cross` points rank 0's
    mask_pos at rank 1's rows of the global (B*T) grid."""
    feed = tbert.make_pretrain_feed(cfg, SEQ, BATCH, seed=5)
    feed["mask_weight"][:BATCH // DP, 1:] = 0.0
    feed["input_mask"][3, SEQ - 9:] = 0.0
    if cross:
        feed["mask_pos"][0] = feed["mask_pos"][3][::-1]
        feed["mask_pos"][1] = feed["mask_pos"][2] + 1
    return feed


class _BertTwin:
    """BERT-tiny (2 layers, dropout 0, Adam 1e-3) built in both packages;
    JAX's startup scope; JAX's with_data_parallel over 2 devices."""

    def __init__(self):
        cfg = self.cfg = _bert_cfg()
        self.jmain, jstart, (self.jloss, self.jacc) = _build(
            jfluid, jun, _bert_net(jfluid, jbert, cfg))
        self.tmain, _ts, (self.tloss, self.tacc) = _build(
            fluid, tun, _bert_net(fluid, tbert, cfg))
        jscope = JScope()
        with jguard(jscope):
            jfluid.Executor().run(jstart)
        self.init = _numpy(jscope)
        # the JAX package maps CUDAPlace(i) onto its i-th device (here
        # the virtual CPUs); its CPUPlace takes no id
        self.jcomp = jfluid.CompiledProgram(self.jmain).with_data_parallel(
            loss_name=self.jloss.name,
            places=[jfluid.CUDAPlace(0), jfluid.CUDAPlace(1)])
        assert self.jcomp.mesh.devices.size == DP
        self.gnames = [p.name + "@GRAD" for p in self.tmain.all_parameters()]
        self.gathered = _gather_out(self.tmain)
        assert self.gathered == _gather_out(self.jmain)

    def fetches(self, i):
        return [self.tloss.name, self.tacc.name, self.gathered] + (
            self.gnames if i == 0 else [])

    def jax(self, feed, steps):
        scope, exe, outs = _jscope(self.init), jfluid.Executor(), []
        with jguard(scope):
            for i in range(steps):
                outs.append([np.asarray(v) for v in exe.run(
                    self.jcomp, feed=feed, fetch_list=self.fetches(i))])
        return outs, scope

    def port(self, feed, steps, program):
        scope = fluid.scope_from_numpy(self.init, "cpu")
        exe, outs = fluid.Executor(CPU), []
        with fluid.scope_guard(scope):
            for i in range(steps):
                outs.append(exe.run(program, feed=feed,
                                    fetch_list=self.fetches(i)))
        return outs, scope

    def compiled(self, **kw):
        return fluid.CompiledProgram(self.tmain).with_data_parallel(
            loss_name=self.tloss.name, places=[CPU] * DP, **kw)


@pytest.fixture(scope="module")
def bert_twin():
    return _BertTwin()


def _check_rows(got, want, step, what):
    """Activations: 1e-4 relative plus 1e-6 absolute at the first step
    (the same weights); after an Adam step, whose per-element
    normalization magnifies the gradients' last-ulp differences in the
    weights, within 1e-4 of the tensor's largest magnitude."""
    atol = GRAD_ATOL if step == 0 else GRAD_RTOL * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=atol,
                               err_msg=f"{what} {step}")


def _check_bert(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(_scalar(g[0]), _scalar(w[0]),
                                   rtol=LOSS_RTOL, err_msg=f"loss {i}")
        assert _scalar(g[1]) == _scalar(w[1]), f"accuracy {i}"
        _check_rows(g[2], w[2], i, "gathered")
    _assert_grads(got[0][3:], want[0][3:], [f"{i}" for i in
                                            range(len(got[0]) - 3)])


def test_bert_unequal_masks_give_jax_global_weighted_mean(bert_twin):
    """Rank 0's rows keep one masked prediction each, rank 1's all 8: two
    Adam steps at dp 2 give JAX's global loss sum(l w) / sum(w) and its
    first-step @GRADs. (Parameters after Adam steps are no check here:
    Adam's update divides each gradient element by its own magnitude, so
    it does not see a gradient's scale, and an element whose gradient is
    near 0 turns last-ulp differences into a share of its update; the
    plain port's land up to 2.5e-5 from JAX's after two steps.) The mean of the ranks' own ratios (each rank
    trained on its rows alone, Fluid's per-card loss) misses that loss by
    more than the tolerance, so the check tells the two apart."""
    tw = bert_twin
    feed = _unequal_feed(tw.cfg)
    want, _ = tw.jax(feed, 2)
    got, _ = tw.port(feed, 2, tw.compiled())
    _check_bert(got, want)
    rows = BATCH // DP
    per_rank = []
    for r in range(DP):
        part = {k: v[r * rows:(r + 1) * rows].copy() for k, v in
                feed.items()}
        part["mask_pos"] -= r * rows * SEQ
        out, _ = tw.port(part, 1, tw.tmain)
        per_rank.append(_scalar(out[0][0]))
    jax_loss = _scalar(want[0][0])
    miss = abs(np.mean(per_rank) - jax_loss) / abs(jax_loss)
    assert miss > 100 * LOSS_RTOL, (per_rank, jax_loss)


def test_bert_mask_pos_across_ranks_matches_jax(bert_twin):
    """Rank 0's rows' mask_pos index rank 1's rows of the global (B*T)
    grid (JAX's feed contract: flat global indices): the gather reads
    the rank-order concatenation of the ranks' rows, so loss, @GRADs and
    the gathered rows equal JAX's."""
    tw = bert_twin
    feed = _unequal_feed(tw.cfg, cross=True)
    assert feed["mask_pos"][0].min() >= BATCH // DP * SEQ
    _check_bert(tw.port(feed, 1, tw.compiled())[0], tw.jax(feed, 1)[0])


def test_bert_fetches_are_jax_global_values(bert_twin):
    """The accuracy fetch is the global share (global counts), a sharded
    activation's fetch (the gathered masked rows, (B*P, H)) the global
    tensor; the same fetches through the plain Executor agree too."""
    tw = bert_twin
    feed = _unequal_feed(tw.cfg)
    feed["nsp_label"][:] = np.array([[0], [1], [1], [1]])
    want = tw.jax(feed, 1)[0][0]
    got = tw.port(feed, 1, tw.compiled())[0][0]
    plain = tw.port(feed, 1, tw.tmain)[0][0]
    assert got[2].shape == (BATCH * tw.cfg.max_predictions_per_seq,
                            tw.cfg.hidden_size)
    for g in (got, plain):
        assert _scalar(g[1]) == _scalar(want[1])
        np.testing.assert_allclose(g[2], want[2], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


def test_bert_reductions_a_step_pinned_from_the_op_list(bert_twin):
    """Mesh.reductions a step equals the program's global reductions: the
    mean, accuracy and gather ops and the reduce_sums over dim 0 (5 for
    BERT-tiny); the feeds reach the ops as (B / dp, ...) shards."""
    tw = bert_twin
    ops = tw.tmain.global_block().ops
    pinned = sum(op.type in ("mean", "accuracy", "gather") or (
        op.type == "reduce_sum" and (op.attrs.get("reduce_all") or
                                     0 in op.attrs.get("dim", [0])))
        for op in ops)
    assert pinned == BERT_REDUCTIONS
    comp = tw.compiled()
    tw.port(_unequal_feed(tw.cfg), 3, comp)
    assert comp.mesh.reductions == 3 * BERT_REDUCTIONS
    walk = DataParallelWalk(comp.mesh, torch.device("cpu"))
    feeds = walk.split_feeds({k: torch.from_numpy(np.asarray(v)) for k, v
                              in _unequal_feed(tw.cfg).items()})
    for name, v in feeds.items():
        assert isinstance(v, tops.Sharded), name
        assert [tuple(p.shape)[0] for p in v.parts] == [BATCH // DP] * DP


# ---------------------------------------------------------------------------
# (g) the world form: two gloo processes
# ---------------------------------------------------------------------------

WORKER = r'''
import datetime
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def replicated_paths(fluid):
    """{case: (net, batch rows)}: programs whose loss reaches a parameter
    by a path beside the rows of the batch."""
    L = fluid.layers

    def after_reduction():
        x = L.data("x", shape=[3], dtype="float32")
        w = L.create_parameter([1], "float32")
        return L.elementwise_mul(L.mean(x), w)

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

    return {"after_reduction": (after_reduction, 4),
            "penalty": (penalty, 4),
            "unsplit_batch": (penalty, 3),
            "reduced_into_rows": (reduced_into_rows, 4)}


def rank_main(rank, init, out, inputs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    try:
        import paddle_tpu_torch as fluid
        from paddle_tpu_torch.core import unique_name as tun
        from paddle_tpu_torch.models import bert as tbert
        data = np.load(inputs)
        cfg = tbert.bert_tiny()
        cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
        cfg.num_hidden_layers = 2
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 7
        with tun.guard(), fluid.program_guard(main, startup):
            _f, total, _m, acc = tbert.build_pretrain_net(cfg,
                                                          seq_len=int(data["seq"]))
            fluid.optimizer.AdamOptimizer(1e-3).minimize(total)
        scope = fluid.scope_from_numpy(
            {k[6:]: data[k] for k in data.files if k.startswith("scope/")},
            "cpu")
        feed = {k[5:]: data[k] for k in data.files if k.startswith("feed/")}
        gather = [op for op in main.global_block().ops
                  if op.type == "gather"][0].output("Out")[0]
        gnames = [p.name + "@GRAD" for p in main.all_parameters()]
        exe = fluid.Executor(fluid.CPUPlace())
        fused = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=total.name)
        bs = fluid.BuildStrategy()
        bs.fuse_all_reduce_ops = False
        unfused = fluid.CompiledProgram(main, bs).with_data_parallel(
            loss_name=total.name)
        assert fused.mesh.world and fused.mesh.held("dp") == [rank]
        res, reductions = {}, []
        with fluid.scope_guard(scope):
            for i, comp in enumerate((fused, fused, unfused)):
                before = comp.mesh.reductions
                got = exe.run(comp, feed=feed, fetch_list=[
                    total, acc, gather] + (gnames if i == 0 else []))
                reductions.append(comp.mesh.reductions - before)
                res[f"loss{i}"], res[f"acc{i}"], res[f"gathered{i}"] = \
                    got[:3]
                if i == 0:
                    for n, g in zip(gnames, got[3:]):
                        res["grad/" + n] = g
        res["reductions"] = np.array(reductions)
        res["n_params"] = np.array(len(gnames))
        # the paths from a parameter to the loss that do not run through
        # this rank's rows: each rank's gradient partial must sum to the
        # single-device gradient (the plain Executor's), as the local
        # mesh's does
        for case, (net, rows) in replicated_paths(fluid).items():
            main2, startup2 = fluid.Program(), fluid.Program()
            with tun.guard(), fluid.program_guard(main2, startup2):
                loss2 = net()
                fluid.optimizer.SGDOptimizer(0.1).minimize(loss2)
            fetch = [loss2] + [p.name + "@GRAD"
                               for p in main2.all_parameters()]
            init = fluid.Scope()
            with fluid.scope_guard(init):
                exe.run(startup2)
            x = np.random.RandomState(3).rand(rows, 3).astype(np.float32)
            forms = {
                "world": fluid.CompiledProgram(main2).with_data_parallel(
                    loss_name=loss2.name),
                "local": fluid.CompiledProgram(main2).with_data_parallel(
                    loss_name=loss2.name, places=[fluid.CPUPlace()] * 2),
                "plain": main2}
            for form, prog in forms.items():
                scope2 = fluid.Scope()
                for n in init.names():
                    scope2.set(n, init.get(n).clone())
                with fluid.scope_guard(scope2):
                    got2 = exe.run(prog, feed={"x": x}, fetch_list=fetch)
                for k, v in enumerate(got2):
                    res[f"{case}/{form}/{k}"] = v
        np.savez(out + "/rank%d.npz" % rank, **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    init, out, inputs = sys.argv[1], sys.argv[2], sys.argv[3]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, init, out, inputs))
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


@pytest.fixture(scope="module")
def gloo_world(bert_twin, tmp_path_factory):
    """Two gloo processes (``file://`` rendezvous under a temporary
    directory), one dp rank each, run the worker once: (the directory of
    the ranks' records, (b)'s cross-rank feed). Every wait is bounded:
    the process group's 60 s, the launcher's joins and the run's 200 s."""
    tw = bert_twin
    base = tmp_path_factory.mktemp("gloo_world")
    feed = _unequal_feed(tw.cfg, cross=True)
    inputs = base / "inputs.npz"
    np.savez(inputs, seq=np.array(SEQ),
             **{"scope/" + n: v for n, v in tw.init.items()},
             **{"feed/" + k: v for k, v in feed.items()})
    script = base / "dp_worker.py"
    script.write_text(WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run(
        [sys.executable, str(script), "file://" + str(base / "rdv"),
         str(base), str(inputs)], env=env, cwd=str(base),
        capture_output=True, text=True, timeout=200)
    assert res.returncode == 0, res.stderr[-4000:]
    return base, feed


def test_bert_gloo_world_matches_local_and_jax(bert_twin, gloo_world):
    """The world trains (b)'s program from JAX's scope: three steps (the
    last with fuse_all_reduce_ops off) equal the local mesh's and JAX's
    losses, accuracy, gathered rows and first-step @GRADs on both ranks.
    A step makes the 5 op reductions and one fused gradient all-reduce
    (one a gradient unfused)."""
    tw = bert_twin
    base, feed = gloo_world
    want, _ = tw.jax(feed, 3)
    local, _ = tw.port(feed, 3, tw.compiled())
    for rank in range(DP):
        got = np.load(base / f"rank{rank}.npz")
        n = int(got["n_params"])
        assert list(got["reductions"]) == [BERT_REDUCTIONS + 1] * 2 + [
            BERT_REDUCTIONS + n]
        for i in range(3):
            for ref in (want[i], local[i]):
                np.testing.assert_allclose(_scalar(got[f"loss{i}"]),
                                           _scalar(ref[0]), rtol=LOSS_RTOL)
                assert _scalar(got[f"acc{i}"]) == _scalar(ref[1])
                _check_rows(got[f"gathered{i}"], ref[2], i, "gathered")
        for ref in (want[0], local[0]):
            _assert_grads([got["grad/" + g] for g in tw.gnames], ref[3:],
                          tw.gnames)


@pytest.mark.parametrize("case", ["after_reduction", "penalty",
                                  "unsplit_batch", "reduced_into_rows"])
def test_gloo_world_counts_every_gradient_path_once(gloo_world, case):
    """A parameter that reaches the loss beside the batch's rows: read
    after a dp reduction (``mean(x) * w``), a penalty on a weight
    (``mean(fc(x)) + 0.5 * reduce_sum(w * w)``), a step left whole on
    every rank (3 rows, which dp 2 does not divide), a reduction read
    back by the rows (``mean((h - mean(h))**2)``). On both ranks the
    world's loss and @GRADs equal the plain Executor's single-device
    ones, as the local mesh's do: the all-reduce counts no path dp
    times."""
    base, _feed = gloo_world
    for rank in range(DP):
        got = np.load(base / f"rank{rank}.npz")
        n = len([k for k in got.files if k.startswith(f"{case}/plain/")])
        assert n >= 2
        for k in range(n):
            want = got[f"{case}/plain/{k}"]
            assert np.abs(want).max() > 0, (case, k)
            for form in ("world", "local"):
                np.testing.assert_allclose(
                    got[f"{case}/{form}/{k}"], want, rtol=GRAD_RTOL,
                    atol=GRAD_ATOL, err_msg=f"{case} {form} fetch {k}")


# ---------------------------------------------------------------------------
# dp x sp: GPT and BERT against JAX's with_mesh
# ---------------------------------------------------------------------------

def test_gpt_dp2_sp2_matches_jax_with_mesh(monkeypatch):
    """test_gpt_sp.py:17: gpt_tiny at seq 64 x batch 4, three SGD steps on
    a dp 2 x sp 2 mesh, JAX's with_mesh against the port's: losses and
    gpt0_attn_q after. Each rank's attention takes the causal ring over
    its own rows: 3 flash steps a layer a dp rank (sp(sp+1)/2)."""
    cfg = jgpt.gpt_tiny()
    rng = np.random.RandomState(0)
    toks = rng.randint(3, cfg.vocab_size, (4, 64)).astype("int64")

    def net(pkg, gpt):
        def build():
            _t, loss, _ = gpt.build_lm_net(gpt.gpt_tiny(), seq_len=64)
            pkg.optimizer.SGDOptimizer(0.1).minimize(loss)
            return loss
        return build

    jmain, jstart, jloss = _build(jfluid, jun, net(jfluid, jgpt), seed=13)
    tmain, _ts, tloss = _build(fluid, tun, net(fluid, tgpt), seed=13)
    jscope, jexe = JScope(), jfluid.Executor()
    with jguard(jscope):
        jexe.run(jstart)
    tscope = _carry(jscope)
    jcomp = jfluid.CompiledProgram(jmain).with_mesh(
        jmake_mesh(dp=2, sp=2, devices=jax.devices()[:4]))
    tcomp = fluid.CompiledProgram(tmain).with_mesh(_local(dp=2, sp=2))
    steps = []
    real = tra.flash_attention_with_lse

    def counted(*a, **kw):
        steps.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tra, "flash_attention_with_lse", counted)
    texe = fluid.Executor(CPU)
    jl, tl = [], []
    for _ in range(3):
        with jguard(jscope):
            jl.append(_scalar(jexe.run(jcomp, feed={"tokens": toks},
                                       fetch_list=[jloss])[0]))
        with fluid.scope_guard(tscope):
            tl.append(_scalar(texe.run(tcomp, feed={"tokens": toks},
                                       fetch_list=[tloss])[0]))
    assert len(steps) == 3 * cfg.num_layers * 2 * 3
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tscope.get("gpt0_attn_q").numpy(),
                               np.asarray(jscope.get("gpt0_attn_q")),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_bert_dp2_sp2_program_matches_jax_with_mesh():
    """test_sp_framework.py:81: BERT-tiny (dropout 0) at seq 32 x batch 4,
    two Adam steps on a dp 2 x sp 2 mesh, JAX's with_mesh against the
    port's, a padded row so the ring rotates a non-zero key bias."""
    cfg = _bert_cfg(layers=4)
    feed = tbert.make_pretrain_feed(cfg, SEQ, BATCH)
    feed["input_mask"][2, 23:] = 0.0
    jmain, jstart, (jloss, _ja) = _build(jfluid, jun,
                                         _bert_net(jfluid, jbert, cfg), 3)
    tmain, _ts, (tloss, _ta) = _build(fluid, tun,
                                      _bert_net(fluid, tbert, cfg), 3)
    jscope, jexe = JScope(), jfluid.Executor()
    with jguard(jscope):
        jexe.run(jstart)
    tscope = _carry(jscope)
    jcomp = jfluid.CompiledProgram(jmain).with_mesh(
        jmake_mesh(dp=2, sp=2, devices=jax.devices()[:4]))
    tcomp = fluid.CompiledProgram(tmain).with_mesh(_local(dp=2, sp=2))
    texe = fluid.Executor(CPU)
    jl, tl = [], []
    for _ in range(2):
        with jguard(jscope):
            jl.append(_scalar(jexe.run(jcomp, feed=feed,
                                       fetch_list=[jloss])[0]))
        with fluid.scope_guard(tscope):
            tl.append(_scalar(texe.run(tcomp, feed=feed,
                                       fetch_list=[tloss])[0]))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tcomp.mesh.reductions == 2 * BERT_REDUCTIONS


# ---------------------------------------------------------------------------
# (i) the dp rules, (j) dropout, (k) facades, (l) strategies, (m) rewrite
# ---------------------------------------------------------------------------

def test_every_registered_op_has_a_dp_rule():
    assert len(tops._REGISTRY) >= 60
    missing = [n for n in tops._REGISTRY if tops._DP_RULES.get(n) is None]
    assert missing == []


def _one_op_program(op_type, attrs, x_shape=(8, 4, 6), extra=None):
    """A program: data x -> one `op_type` op -> out, fetched."""
    main, startup = fluid.Program(), fluid.Program()
    with tun.guard(), fluid.program_guard(main, startup):
        x = tlayers.data("x", shape=list(x_shape[1:]), dtype="float32")
        block = main.global_block()
        out = block.create_var(name="out", dtype="float32")
        inputs = {"X": x} if op_type != "slice" else {"Input": x}
        inputs.update(extra or {})
        block.append_op(type=op_type, inputs=inputs, outputs={"Out": out},
                        attrs=attrs)
    return main, out


@pytest.mark.parametrize("op_type,attrs,match", [
    ("dp_rule_less_op", {}, "no data-parallel rule"),
    ("reshape2", {"shape": [4, -1]}, "neither -1, 0 nor the global batch"),
    ("transpose2", {"axis": [1, 0, 2]}, "moves dim 0"),
    ("slice", {"axes": [0], "starts": [0], "ends": [2]}, "slices dim 0"),
    ("softmax", {"axis": 0}, "over dim 0"),
    ("isfinite", {}, "replicated inputs only"),
])
def test_an_op_without_a_row_rule_refuses_a_sharded_input(
        op_type, attrs, match, monkeypatch):
    """An op with no rule, and a row rule's failed check, raise
    NotImplementedError naming the op on a dp-sharded input; never a
    silently local answer."""
    monkeypatch.setitem(tops._REGISTRY, "dp_rule_less_op",
                        lambda ctx: {"Out": ctx.in_("X")})
    monkeypatch.setitem(tops._DP_RULES, "dp_rule_less_op", None)
    main, out = _one_op_program(op_type, attrs)
    comp = fluid.CompiledProgram(main).with_data_parallel(places=[CPU] * 2)
    feed = {"x": np.ones((8, 4, 6), np.float32)}
    with pytest.raises(NotImplementedError, match=match) as err:
        fluid.Executor(CPU).run(comp, feed=feed, fetch_list=[out])
    assert op_type in str(err.value)
    if op_type != "dp_rule_less_op":   # the same op runs replicated
        fluid.Executor(CPU).run(main, feed=feed, fetch_list=[out])


@pytest.mark.parametrize("shape", [[-1, 24], [0, 24], [8, 24]])
def test_reshape_keeps_the_batch_rows(shape):
    """reshape's dim 0 of -1, 0 or the global batch runs a rank's rows
    (the global size becomes the local one); the fetch is the global
    reshape."""
    main, out = _one_op_program("reshape2", {"shape": shape})
    x = np.arange(8 * 24, dtype=np.float32).reshape(8, 4, 6)
    comp = fluid.CompiledProgram(main).with_data_parallel(places=[CPU] * 4)
    got, = fluid.Executor(CPU).run(comp, feed={"x": x}, fetch_list=[out])
    np.testing.assert_array_equal(got, x.reshape(8, 24))


def test_rank_folded_dropout_draws_a_mask_per_rank():
    """Each dp rank draws its own mask for its rows (the rank folded into
    the op's seed); rank 0 keeps the single-device stream, so its rows'
    mask is the plain run's first rows'; a dp 1 run is the plain run."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 11
    with tun.guard(), fluid.program_guard(main, startup):
        x = tlayers.data("x", shape=[64], dtype="float32")
        out = tlayers.dropout(x, 0.5)
    feed = {"x": np.ones((8, 64), np.float32)}

    def run(prog):
        return fluid.Executor(CPU).run(prog, feed=feed, fetch_list=[out])[0]

    plain = run(main)
    dp2 = run(fluid.CompiledProgram(main).with_data_parallel(
        places=[CPU] * 2))
    dp1 = run(fluid.CompiledProgram(main).with_data_parallel(places=[CPU]))
    assert not np.array_equal(dp2[:4] != 0, dp2[4:] != 0)
    np.testing.assert_array_equal(dp2[:4], plain[:4])
    np.testing.assert_array_equal(dp1, plain)
    assert 0.3 < (dp2 != 0).mean() < 0.7


def test_compiled_program_without_dp_and_parallel_executor(monkeypatch):
    """A CompiledProgram without with_data_parallel runs the plain path;
    ParallelExecutor (use_cuda=False over CPU_NUM ranks) trains as the
    CompiledProgram does, equal to the plain run."""
    feed = _mlp_feed()
    _jm, jstart, _jl, tmain, tloss = _mlp_programs()
    jscope = JScope()
    with jguard(jscope):
        jfluid.Executor().run(jstart)
    base = _carry(jscope)

    def train(run):
        scope = _copy(base)
        with fluid.scope_guard(scope):
            return [_scalar(run()[0]) for _ in range(3)]

    exe = fluid.Executor(CPU)
    plain = train(lambda: exe.run(tmain, feed=feed, fetch_list=[tloss]))
    bare = fluid.CompiledProgram(tmain)
    assert train(lambda: exe.run(bare, feed=feed,
                                 fetch_list=[tloss])) == plain
    for n, kw in ((4, "feed"), (2, "feed_dict")):
        monkeypatch.setenv("CPU_NUM", str(n))
        pe = fluid.ParallelExecutor(use_cuda=False, loss_name=tloss.name,
                                    main_program=tmain)
        assert pe.compiled.mesh.shape["dp"] == n
        np.testing.assert_allclose(
            train(lambda: pe.run([tloss], **{kw: feed})), plain,
            rtol=LOSS_RTOL)


def test_build_and_execution_strategy_defaults_equal_jax():
    for cls in ("BuildStrategy", "ExecutionStrategy"):
        assert vars(getattr(fluid, cls)()) == vars(getattr(jfluid, cls)())
    for enum in ("ReduceStrategy", "GradientScaleStrategy"):
        a = getattr(fluid.BuildStrategy, enum)
        b = getattr(jfluid.BuildStrategy, enum)
        assert {k: v for k, v in vars(a).items() if not k.startswith("_")} \
            == {k: v for k, v in vars(b).items() if not k.startswith("_")}


def test_sync_batch_norm_rewrites_ops_as_jax():
    """test_sync_batch_norm.py:79: with BuildStrategy.sync_batch_norm,
    with_data_parallel renames the program's batch_norm ops, as JAX's
    does (here a bare op; tests/test_torch_resnet.py runs the layer's)."""
    jmain, jstart = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(jmain, jstart):
        x = jlayers.data("x", shape=[3, 4, 4], dtype="float32")
        jlayers.mean(jlayers.batch_norm(x))
    bs = jfluid.BuildStrategy()
    bs.sync_batch_norm = True
    jfluid.CompiledProgram(jmain).with_data_parallel(build_strategy=bs)
    tmain, tstart = fluid.Program(), fluid.Program()
    with tun.guard(), fluid.program_guard(tmain, tstart):
        x = tlayers.data("x", shape=[3, 4, 4], dtype="float32")
        block = tmain.global_block()
        y = block.create_var(name="bn_out", dtype="float32")
        block.append_op(type="batch_norm", inputs={"X": x},
                        outputs={"Y": y}, attrs={})
        tlayers.mean(y)
    tbs = fluid.BuildStrategy()
    tbs.sync_batch_norm = True
    fluid.CompiledProgram(tmain).with_data_parallel(build_strategy=tbs,
                                                    places=[CPU] * 2)
    types_ = [op.type for op in tmain.global_block().ops]
    assert types_ == [op.type for op in jmain.global_block().ops]
    assert "sync_batch_norm" in types_ and "batch_norm" not in types_


# ---------------------------------------------------------------------------
# (n) shard rules, (o) shard_state, (p) refusals, data_parallel_step
# ---------------------------------------------------------------------------

def test_shard_rules_specs_equal_jax():
    """test_parallel_modes.py:92, and every BERT-tiny parameter's spec
    after apply_shard_rules, as tuples, equal to JAX's."""
    rules = ShardRules()
    assert rules.spec_for("word_embedding_w", (100, 64)) == \
        PartitionSpec("tp", None)
    assert rules.spec_for("enc0_attn_qkv.w_0", (64, 192)) == \
        PartitionSpec(None, "tp")
    assert rules.spec_for("enc0_ffn1_w.w_0", (64, 256)) == \
        PartitionSpec(None, "tp")
    assert rules.spec_for("layer_norm_0.scale", (64,)) == PartitionSpec()
    assert PartitionSpec("tp", None) != PartitionSpec("tp")
    assert PartitionSpec("tp", None).normalized() == PartitionSpec("tp")
    assert PartitionSpec(("tp",)) == PartitionSpec("tp")
    cfg = _bert_cfg()
    jmain, _js, _jo = _build(jfluid, jun, _bert_net(jfluid, jbert, cfg))
    tmain, _ts, _to = _build(fluid, tun, _bert_net(fluid, tbert, cfg))
    jtp.apply_shard_rules(jmain)
    apply_shard_rules(tmain)
    want = {p.name: tuple(p.dist_attr) for p in jmain.all_parameters()}
    got = {p.name: tuple(p.dist_attr) for p in tmain.all_parameters()}
    assert got == want
    assert {"tp"} <= {a for spec in got.values() for a in spec}


def test_shard_state_slices_equal_jax_addressable_shards():
    """shard_state over a local tp 2 mesh gives each position the slice
    JAX's shard_state puts on the matching device of its tp 2 mesh; a
    replicated value (or one the axis does not divide) is the one object
    in both positions' dicts."""
    rs = np.random.RandomState(2)
    state = {"word_embedding": rs.randn(10, 6).astype(np.float32),
             "enc0_attn_q": rs.randn(6, 6).astype(np.float32),
             "enc0_ffn0_w": rs.randn(6, 12).astype(np.float32),
             "enc0_ffn1_w": rs.randn(12, 6).astype(np.float32),
             "enc0_ln0_w": rs.randn(6).astype(np.float32),
             "odd_embedding": rs.randn(7, 6).astype(np.float32)}
    jmesh = jmake_mesh(tp=2, devices=jax.devices()[:2])
    jstate = jtp.shard_state(state, jmesh)
    tstate = {k: torch.from_numpy(v) for k, v in state.items()}
    trees = shard_state(tstate, _local(tp=2))
    assert len(trees) == 2
    devices = list(jmesh.devices.flat)
    for name, arr in jstate.items():
        for shard in arr.addressable_shards:
            pos = devices.index(shard.device)
            np.testing.assert_array_equal(trees[pos][name].numpy(),
                                          np.asarray(shard.data),
                                          err_msg=name)
    for name in ("enc0_ln0_w", "odd_embedding"):
        assert trees[0][name] is trees[1][name] is tstate[name]
    assert trees[0]["word_embedding"].shape == (5, 6)
    assert trees[1]["enc0_ffn0_w"].is_contiguous()


def test_sharded_state_and_tp_meshes_are_refused(bert_twin):
    """The meshes the walk once refused now run. A pp 2 or ep 2 mesh
    (item 11a, pipeline and expert parallelism) gives the plain run's
    loss within 1e-5 relative: BERT carries no pipeline tag and no moe
    op, so every pp and ep position runs the whole step
    (tests/test_torch_pipeline.py and tests/test_torch_moe.py hold the
    pipelined and expert-parallel forms against JAX). tp beside dp or sp
    (10d.2) runs: dp 2 x tp 2 and sp 2 x tp 2 give the plain run's loss
    within 1e-5 relative (tests/test_torch_mixed_mesh.py holds them
    against JAX and dp 1, and tests/test_torch_fleet_world.py the world
    forms), and a walk names the axes a replicated value is replicated
    along. A tp 2 mesh gives the plain run's loss (the tp partial sums
    add in rank order: within 1e-5 relative), a persistable
    whose dist_attr lays it out over dp 2 gives plain dp 2's losses and
    @GRADs bitwise, and apply_shard_rules' 'tp' annotations under a
    dp-only mesh lay nothing out. Recompute under dp runs and gives the
    plain dp run's losses, accuracy, gathered rows and first step @GRADs
    bitwise (tests/test_torch_dp_recipe.py holds the recipe and both
    policies against dp 1 and JAX)."""
    tw = bert_twin
    feed = _unequal_feed(tw.cfg)
    want, _ = tw.port(feed, 1, tw.tmain)
    for kw in (dict(pp=2), dict(ep=2)):
        mesh = make_mesh(**kw, devices=["cpu"] * 2)
        walk = DataParallelWalk(mesh, torch.device("cpu"), program=tw.tmain)
        assert walk.axes == tuple(kw) and not walk.pipelined
        got, _ = tw.port(feed, 1, fluid.CompiledProgram(tw.tmain)
                         .with_mesh(mesh))
        assert _scalar(got[0][0]) == pytest.approx(_scalar(want[0][0]),
                                                   rel=LOSS_RTOL)
    for kw in (dict(dp=1, tp=2), dict(dp=1, sp=2)):
        walk = DataParallelWalk(_local(**kw), torch.device("cpu"))
        assert walk.axes == tuple(kw)[1:]
    apply_shard_rules(tw.tmain)
    try:
        for kw in (dict(dp=2, tp=2), dict(sp=2, tp=2)):
            mesh = make_mesh(**kw, devices=["cpu"] * 4)
            got, _ = tw.port(feed, 1, fluid.CompiledProgram(tw.tmain)
                             .with_mesh(mesh))
            assert _scalar(got[0][0]) == pytest.approx(
                _scalar(want[0][0]), rel=LOSS_RTOL)
        got, _ = tw.port(feed, 1, fluid.CompiledProgram(tw.tmain)
                         .with_mesh(_local(tp=2)))
        assert _scalar(got[0][0]) == pytest.approx(_scalar(want[0][0]),
                                                   rel=LOSS_RTOL)
        got, _ = tw.port(feed, 1, tw.compiled())
        plain_dp, _ = tw.port(feed, 2, tw.compiled())
        assert _scalar(got[0][0]) == pytest.approx(_scalar(want[0][0]),
                                                   rel=LOSS_RTOL)
        tw.tmain.global_block().var("enc0_attn_q").dist_attr = \
            PartitionSpec("dp", None)
        laid, scope = tw.port(feed, 2, tw.compiled())
        assert scope.get("enc0_attn_q").spec == PartitionSpec("dp", None)
        for g, p in zip(laid, plain_dp):
            for a, b in zip(g, p):
                np.testing.assert_array_equal(a, b)
    finally:
        for p in tw.tmain.all_parameters():
            p.dist_attr = None
    plain, _ = tw.port(feed, 2, tw.compiled())
    tw.tmain._recompute = {"policy": "nothing"}
    try:
        got, _ = tw.port(feed, 2, tw.compiled())
    finally:
        del tw.tmain._recompute
    for g, p in zip(got, plain):
        for a, b in zip(g, p):
            np.testing.assert_array_equal(a, b)


def test_with_data_parallel_without_places_needs_cuda():
    """places=None means every visible CUDA device (or a world): without
    CUDA and without a world it raises and never falls to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this checks the CPU-only refusal")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fluid.CompiledProgram(fluid.Program()).with_data_parallel()


def test_data_parallel_step_matches_jax():
    """data_parallel_step on a local dp 2 mesh runs step_fn on the whole
    batch: two SGD steps of a linear least-squares model equal JAX's
    data_parallel_step on its dp 2 mesh; an axis the mesh lacks raises
    (the world form: tests/test_torch_dp_extras.py)."""
    rs = np.random.RandomState(3)
    x = rs.randn(8, 5).astype(np.float32)
    y = rs.randn(8, 1).astype(np.float32)
    w0 = rs.randn(5, 1).astype(np.float32)

    def jstep(state, batch):
        def loss(w):
            return jnp.mean((batch["x"] @ w - batch["y"]) ** 2)
        val, g = jax.value_and_grad(loss)(state["w"])
        return {"w": state["w"] - 0.1 * g}, val

    def tstep(state, batch):
        w = state["w"].clone().requires_grad_(True)
        val = ((batch["x"] @ w - batch["y"]) ** 2).mean()
        (g,) = torch.autograd.grad(val, w)
        return {"w": (w - 0.1 * g).detach()}, val.detach()

    jrun = jdp.data_parallel_step(
        jstep, jmake_mesh(dp=2, devices=jax.devices()[:2]),
        donate_state=False)
    trun = data_parallel_step(tstep, _local(dp=2))
    jstate, tstate = {"w": jnp.asarray(w0)}, {"w": torch.from_numpy(w0)}
    batch = {"x": x, "y": y}
    for _ in range(2):
        jstate, jl = jrun(jstate, batch)
        tstate, tl = trun(tstate, batch)
        np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(tstate["w"].numpy(), np.asarray(jstate["w"]),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    with pytest.raises(ValueError, match="no axis"):
        data_parallel_step(tstep, _local(dp=2), batch_axis="batch")
