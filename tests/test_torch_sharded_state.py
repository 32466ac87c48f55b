"""Sharded state under the port's ``CompiledProgram``, against the JAX
package, on the CPU.

The JAX package lays a persistable out by its ``dist_attr`` under GSPMD
(``core/compiler.py``'s ``_var_sharding``) and keeps the single-device
numbers. The port cuts it into a ``parallel.sharded.ShardedTensor`` (one
part a held mesh position) and must give the same numbers: tensor
parallelism through the Megatron rules at tp 2, ZeRO-1 and FSDP at dp 2
and dp 4 on local meshes, FSDP + ZeRO-1 in a gloo world of two
processes. Both packages build the same Program under fresh unique-name
generators; the port's startup state is carried into JAX's scope as
numpy (JAX's twins run on the virtual CPU devices of
``tests/conftest.py``). Dropout is 0 where the two are compared.

Tolerances: losses against JAX within 2e-4 relative plus 2e-5 (the JAX
twins' own, ``tests/parallel/test_dist_attr_executor.py``); a part
bitwise JAX's addressable shard of the same global value, and within
1e-3 of the tensor's scale of JAX's own after two Adam steps (Adam's
per-element normalization magnifies last-ulp gradient differences, an
element whose gradient is near 0 most; a tensor below 1e-6, a key
bias's moments, is rounding noise and held within 1e-9); port tp 2
against port tp 1 within 1e-6 relative on the losses (the tp partial
sums add in rank order, a different f32 summation order, not bitwise)
and 1e-5 of each @GRAD's scale plus 1e-3 of the largest @GRAD (a key
bias's gradient is rounding noise); ZeRO-1 / FSDP / both against plain
dp bitwise (a gather concatenates the same values and every optimizer
op is elementwise), the norm optimizers (``lamb``, ``lars_momentum``,
``dpsgd``) within 1e-6 relative (their whole-parameter norms sum the
blocks' squares in another order).

Twins of ``tests/parallel/test_dist_attr_executor.py:50,83,110``; the
placement rule at a dimension dp does not divide, every optimizer under
FSDP / ZeRO-1 / both, the tied embedding, recompute under tp, the NaN
guard on a sharded @GRAD, ``save_persistables``, a plain run between two
walks, the transpiler surface and the gloo world are the port's own
checks against the unsharded run (and JAX's where it has the same).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu.core import unique_name as jun
from paddle_tpu.core.executor import Scope as JScope, scope_guard as jguard
from paddle_tpu.models import bert as jbert
from paddle_tpu.parallel import transpiler as jtr
from paddle_tpu.parallel.mesh import make_mesh as jmake_mesh

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import unique_name as tun
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.parallel import (PartitionSpec, ShardedTensor,
                                       apply_shard_rules, make_mesh,
                                       shard_optimizer_state,
                                       shard_params_fsdp)
from paddle_tpu_torch.parallel import transpiler as ttr
from paddle_tpu_torch.parallel.sharded import placement_spec

CPU = fluid.CPUPlace()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, BATCH = 32, 8
JAX_RTOL, JAX_ATOL = 2e-4, 2e-5
PART_TOL = 1e-3
# below this scale a tensor is rounding noise (a key bias's gradient and
# its Adam moments)
NOISE_SCALE = 1e-6
TP_LOSS_RTOL, TP_GRAD_TOL, GRAD_FLOOR = 1e-6, 1e-5, 1e-3
NORM_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_bert.py: concurrent pytest workers oversubscribe the
    CPU otherwise)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _local(dp=1, tp=1):
    return make_mesh(dp=dp, tp=tp, devices=["cpu"] * (dp * tp))


def _cfg(pkg_bert, layers=2):
    cfg = pkg_bert.bert_tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    cfg.num_hidden_layers = layers
    return cfg


def _build(pkg, un, bert, opt=None, seed=7, layers=2):
    cfg = _cfg(bert, layers)
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with un.guard(), pkg.program_guard(main, startup):
        _f, loss, _m, _a = bert.build_pretrain_net(cfg, seq_len=SEQ)
        (opt or (lambda: pkg.optimizer.AdamOptimizer(1e-3)))().minimize(loss)
    return cfg, main, startup, loss


class _Twin:
    """BERT-tiny (2 layers, dropout 0, Adam 1e-3) in both packages; the
    port's startup state as numpy."""

    def __init__(self):
        self.cfg, self.tmain, tstart, self.tloss = _build(fluid, tun, tbert)
        _c, self.jmain, _js, self.jloss = _build(jfluid, jun, jbert)
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            fluid.Executor(CPU).run(tstart)
        self.init = {n: scope.get(n).numpy().copy() for n in scope.names()}
        self.feed = tbert.make_pretrain_feed(self.cfg, SEQ, BATCH, seed=5)
        self.names = [p.name for p in self.tmain.all_parameters()]

    def clear(self):
        for main in (self.tmain, self.jmain):
            for v in main.list_vars():
                v.dist_attr = None

    def port(self, program, steps=2, grads=True, scope=None):
        scope = scope or fluid.scope_from_numpy(self.init, "cpu")
        exe, outs = fluid.Executor(CPU), []
        with fluid.scope_guard(scope):
            for i in range(steps):
                outs.append(exe.run(program, feed=self.feed, fetch_list=[
                    self.tloss] + ([n + "@GRAD" for n in self.names]
                                   if i == 0 and grads else [])))
        return outs, scope

    def jax(self, mesh, steps=2):
        scope = JScope()
        for n, v in self.init.items():
            scope.set(n, jnp.asarray(v))
        prog = jfluid.CompiledProgram(self.jmain).with_mesh(mesh)
        exe, losses = jfluid.Executor(), []
        with jguard(scope):
            for _ in range(steps):
                (out,) = exe.run(prog, feed=self.feed,
                                 fetch_list=[self.jloss])
                losses.append(float(np.asarray(out).reshape(-1)[0]))
        return losses, scope


@pytest.fixture(scope="module")
def twin():
    tw = _Twin()
    yield tw
    tw.clear()


@pytest.fixture
def fresh(twin):
    twin.clear()
    yield twin
    twin.clear()


def _strip(spec):
    """A spec's entries with the trailing Nones stripped (as the JAX
    twins compare NamedSharding specs)."""
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def _loss(out):
    return float(np.asarray(out[0]).reshape(-1)[0])


def _parts_match_jax(tscope, jscope, jmesh, names):
    """Every port part is JAX's addressable shard at its mesh position:
    bitwise the shard ``jax.device_put`` cuts from the port's global value
    with the sharding JAX's scope holds, and within PART_TOL of the scale
    of JAX's own trained shard."""
    devices = list(jmesh.devices.flat)
    for name in names:
        tv, jv = tscope.get(name), jscope.get(name)
        assert isinstance(tv, ShardedTensor), name
        positions = tv.positions()
        put = jax.device_put(tv.full().numpy(), jv.sharding)
        for shard, trained in zip(put.addressable_shards,
                                  jv.addressable_shards):
            assert shard.device == trained.device
            idx = np.unravel_index(devices.index(shard.device),
                                   jmesh.devices.shape)
            coords = dict(zip(jmesh.axis_names, (int(c) for c in idx)))
            j = [all(p[a] == coords[a] for a in tv.axes)
                 for p in positions].index(True)
            got = tv.parts[j].numpy()
            np.testing.assert_array_equal(got, np.asarray(shard.data),
                                          err_msg=name)
            want = np.asarray(trained.data)
            np.testing.assert_allclose(
                got, want, rtol=0,
                atol=PART_TOL * max(np.abs(want).max(), NOISE_SCALE),
                err_msg=name)


def _grads_close(got, want, names, tol):
    floor = GRAD_FLOOR * max(np.abs(w).max() for w in want)
    for n, a, b in zip(names, got, want):
        assert a.shape == b.shape, n
        assert np.abs(a - b).max() <= tol * np.abs(b).max() + floor, n


# ---------------------------------------------------------------------------
# (a) the JAX twins: tp 2, ZeRO-1 at dp 4, FSDP at dp 4
# ---------------------------------------------------------------------------

def test_tp_program_matches_jax_and_shards_state(fresh):
    """test_dist_attr_executor.py:50: apply_shard_rules + with_mesh over
    tp 2: two Adam steps give JAX's losses, the scope holds the Megatron
    layouts (JAX's specs, trailing Nones stripped) over the mesh, and each
    part is JAX's addressable shard."""
    tw = fresh
    apply_shard_rules(tw.tmain)
    apply_shard_rules(tw.jmain)
    mesh = _local(tp=2)
    jmesh = jmake_mesh(tp=2, devices=jax.devices()[:2])
    got, scope = tw.port(fluid.CompiledProgram(tw.tmain).with_mesh(mesh),
                         grads=False)
    want, jscope = tw.jax(jmesh)
    np.testing.assert_allclose([_loss(o) for o in got], want,
                               rtol=JAX_RTOL, atol=JAX_ATOL)

    def spec_of(name):
        v = scope.get(name)
        return _strip(v.spec) if isinstance(v, ShardedTensor) else ()

    assert spec_of("enc0_attn_q") == (None, "tp")
    assert spec_of("enc0_attn_o") == ("tp",)
    assert spec_of("enc0_ffn0_w") == (None, "tp")
    assert spec_of("enc0_ffn1_w") == ("tp",)
    assert spec_of("word_embedding") == ("tp",)
    assert spec_of("pos_embedding") == ()
    assert scope.get("enc0_attn_q").mesh is mesh
    sharded = [n for n in scope.names()
               if isinstance(scope.get(n), ShardedTensor)]
    for n in sharded:
        assert _strip(jscope.get(n).sharding.spec) == \
            _strip(scope.get(n).spec), n
    _parts_match_jax(scope, jscope, jmesh, sharded)
    assert [list(p.shape) for p in scope.get("word_embedding").parts] == \
        [[512, 256]] * 2


@pytest.mark.parametrize("form", ["zero1", "fsdp"])
def test_dp4_sharded_state_matches_jax(fresh, form):
    """test_dist_attr_executor.py:83 and :110: shard_optimizer_state
    (ZeRO-1: the accumulators over dp) or shard_params_fsdp (the
    parameters over dp, min_size 1024) at dp 4: two Adam steps give JAX's
    losses, word_embedding's moments (ZeRO-1) or word_embedding itself
    (FSDP) are laid out as P('dp'), and the parts are JAX's shards."""
    tw = fresh
    annotate = shard_optimizer_state if form == "zero1" else \
        (lambda p: shard_params_fsdp(p, min_size=1024))
    jannotate = jtr.shard_optimizer_state if form == "zero1" else \
        (lambda p: jtr.shard_params_fsdp(p, min_size=1024))
    annotate(tw.tmain)
    jannotate(tw.jmain)
    mesh = _local(dp=4)
    jmesh = jmake_mesh(dp=4, devices=jax.devices()[:4])
    got, scope = tw.port(fluid.CompiledProgram(tw.tmain).with_mesh(mesh),
                         grads=False)
    want, jscope = tw.jax(jmesh)
    np.testing.assert_allclose([_loss(o) for o in got], want,
                               rtol=JAX_RTOL, atol=JAX_ATOL)
    if form == "zero1":
        names = [n for n in scope.names()
                 if "moment" in n and "word_embedding" in n]
        assert names and all(scope.get(n).spec.normalized() == ("dp",)
                             for n in names)
    else:
        names = ["word_embedding"]
        assert scope.get("word_embedding").spec.normalized() == ("dp",)
    sharded = [n for n in scope.names()
               if isinstance(scope.get(n), ShardedTensor)]
    assert set(names) <= set(sharded)
    for n in sharded:
        assert _strip(jscope.get(n).sharding.spec) == \
            _strip(scope.get(n).spec), n
    _parts_match_jax(scope, jscope, jmesh, sharded)


# ---------------------------------------------------------------------------
# (b) the port against its unsharded runs
# ---------------------------------------------------------------------------

def test_tp2_matches_tp1_losses_grads_and_tied_embedding(fresh):
    """tp 2 against tp 1 (the same Program, nothing laid out): the losses
    within 1e-6 relative, every @GRAD within 1e-5 of its scale (the tied
    word_embedding's, which the lookup and the MLM product both reach,
    lands in the same parts and equals tp 1's), the gradients come out
    laid out as their parameters, and the reductions a step are the
    rules': the lookup, each layer's attention and FFN sums, and the
    gather of the vocab-split logits."""
    tw = fresh
    apply_shard_rules(tw.tmain)
    one, _ = tw.port(fluid.CompiledProgram(tw.tmain).with_mesh(_local()))
    mesh = _local(tp=2)
    comp = fluid.CompiledProgram(tw.tmain).with_mesh(mesh)
    scope = fluid.scope_from_numpy(tw.init, "cpu")
    exe = fluid.Executor(CPU)
    with fluid.scope_guard(scope):
        exe.run(comp, feed=tw.feed, fetch_list=[tw.tloss])
        red0 = mesh.reductions
        out = exe.run(comp, feed=tw.feed, fetch_list=[tw.tloss],
                      return_numpy=False)
        assert mesh.reductions - red0 == 2 * tw.cfg.num_hidden_layers + 2
        del out
    two, _ = tw.port(comp)
    for a, b in zip(two, one):
        assert abs(_loss(a) - _loss(b)) <= TP_LOSS_RTOL * abs(_loss(b))
    _grads_close(two[0][1:], one[0][1:], tw.names, TP_GRAD_TOL)
    emb = tw.names.index("word_embedding")
    np.testing.assert_allclose(two[0][1 + emb], one[0][1 + emb],
                               rtol=0, atol=TP_GRAD_TOL * np.abs(
                                   one[0][1 + emb]).max())
    # the gradient of a laid-out parameter is laid out as it
    with fluid.scope_guard(fluid.scope_from_numpy(tw.init, "cpu")):
        got = exe.run(comp, feed=tw.feed,
                      fetch_list=["word_embedding@GRAD"],
                      return_numpy=False)
    assert tuple(got[0].shape) == (tw.cfg.vocab_size, tw.cfg.hidden_size)


def test_recompute_dots_under_tp2(fresh):
    """RecomputeOptimizer's "dots" policy at tp 2 re-runs the tp rules
    inside the checkpointed segments: losses and first-step @GRADs equal
    the plain tp 2 run's within the tp tolerances."""
    tw = fresh
    apply_shard_rules(tw.tmain)
    comp = fluid.CompiledProgram(tw.tmain).with_mesh(_local(tp=2))
    plain, _ = tw.port(comp)
    tw.tmain._recompute = {"policy": "dots"}
    try:
        got, _ = tw.port(fluid.CompiledProgram(tw.tmain).with_mesh(
            _local(tp=2)))
    finally:
        del tw.tmain._recompute
    for a, b in zip(got, plain):
        assert abs(_loss(a) - _loss(b)) <= TP_LOSS_RTOL * abs(_loss(b))
    _grads_close(got[0][1:], plain[0][1:], tw.names, TP_GRAD_TOL)


@pytest.mark.parametrize("form", ["zero1", "fsdp", "both"])
def test_zero1_fsdp_bitwise_against_plain_dp2(fresh, form):
    """ZeRO-1, FSDP (min_size 1024) and both (the fleet's use_fsdp) at a
    local dp 2 against plain dp 2: three steps' losses and the first
    step's @GRADs bitwise; each position holds only its parts; a step's
    reductions are plain dp's plus one gather a sharded parameter."""
    tw = fresh
    plain_comp = fluid.CompiledProgram(tw.tmain).with_data_parallel(
        loss_name=tw.tloss.name, places=[CPU] * 2)
    plain, _ = tw.port(plain_comp, steps=3)
    plain_red = plain_comp.mesh.reductions
    if form in ("zero1", "both"):
        shard_optimizer_state(tw.tmain)
    if form in ("fsdp", "both"):
        shard_params_fsdp(tw.tmain, min_size=1024)
    comp = fluid.CompiledProgram(tw.tmain).with_data_parallel(
        loss_name=tw.tloss.name, places=[CPU] * 2)
    got, scope = tw.port(comp, steps=3)
    for g, p in zip(got, plain):
        for a, b in zip(g, p):
            np.testing.assert_array_equal(a, b)
    laid = {n: scope.get(n) for n in scope.names()
            if isinstance(scope.get(n), ShardedTensor)}
    assert laid
    for n, v in laid.items():
        assert len(v.parts) == 2 and v.numel() == v.global_numel(), n
        assert all(p.shape[0] * 2 == v.shape[0] for p in v.parts), n
    params = sum(isinstance(scope.get(n), ShardedTensor) for n in tw.names)
    assert (form == "zero1") == (params == 0)
    assert comp.mesh.reductions == plain_red + 3 * params


def test_placement_rule_leaves_a_non_dividing_dim_replicated(fresh):
    """_var_sharding's rule: at dp 4 a (6, 256) parameter annotated
    P('dp') stays whole (4 does not divide 6) and a (1024, 256) one is cut;
    an axis the mesh lacks is dropped; both runs equal plain dp 4's
    losses bitwise."""
    tw = fresh
    mesh = _local(dp=4)
    assert placement_spec(PartitionSpec("dp"), (6, 256), mesh) == \
        PartitionSpec(None, None)
    assert placement_spec(PartitionSpec("dp"), (1024, 256), mesh) == \
        PartitionSpec("dp", None)
    assert placement_spec(PartitionSpec("tp", None), (1024, 256), mesh) \
        == PartitionSpec(None, None)
    plain, _ = tw.port(fluid.CompiledProgram(tw.tmain).with_mesh(
        _local(dp=4)), grads=False)
    block = tw.tmain.global_block()
    block.var("sent_embedding").dist_attr = PartitionSpec("dp")
    block.var("word_embedding").dist_attr = PartitionSpec("dp")
    block.var("enc0_attn_q").dist_attr = PartitionSpec("tp", None)
    got, scope = tw.port(fluid.CompiledProgram(tw.tmain).with_mesh(mesh),
                         grads=False)
    assert isinstance(scope.get("sent_embedding"), torch.Tensor)
    assert isinstance(scope.get("enc0_attn_q"), torch.Tensor)
    assert scope.get("word_embedding").spec == PartitionSpec("dp", None)
    assert [_loss(o) for o in got] == [_loss(o) for o in plain]


def _mlp(pkg, un, make_opt, seed=3):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    L = pkg.layers
    with un.guard(), pkg.program_guard(main, startup):
        x = L.data("x", shape=[16], dtype="float32")
        y = L.data("y", shape=[1], dtype="int64")
        h = L.fc(x, size=32, act="tanh")
        logits = L.fc(h, size=4)
        loss = L.mean(L.softmax_with_cross_entropy(logits, y))
        make_opt(pkg).minimize(loss)
    return main, startup, loss


def _retype(new_type, **attrs):
    """A program rewrite: each optimizer op becomes `new_type` (the
    extra optimizer ops share their base optimizer's slots)."""
    def rewrite(main):
        for op in main.global_block().ops:
            if op.type in ("sgd", "adam", "adagrad"):
                op.type = new_type
                op.attrs.update(attrs)
    return rewrite


OPTIMIZERS = {
    "sgd": (lambda f: f.optimizer.SGDOptimizer(0.1), None),
    "momentum": (lambda f: f.optimizer.MomentumOptimizer(0.1, 0.9), None),
    "nesterov": (lambda f: f.optimizer.MomentumOptimizer(
        0.1, 0.9, use_nesterov=True), None),
    "lars_momentum": (lambda f: f.optimizer.LarsMomentumOptimizer(
        0.1, 0.9), None),
    "adagrad": (lambda f: f.optimizer.AdagradOptimizer(0.1), None),
    "decayed_adagrad": (lambda f: f.optimizer.DecayedAdagradOptimizer(
        0.1), None),
    "adadelta": (lambda f: f.optimizer.AdadeltaOptimizer(0.1), None),
    "adam": (lambda f: f.optimizer.AdamOptimizer(0.01), None),
    "adamax": (lambda f: f.optimizer.AdamaxOptimizer(0.01), None),
    "rmsprop": (lambda f: f.optimizer.RMSPropOptimizer(0.01), None),
    "rmsprop_centered": (lambda f: f.optimizer.RMSPropOptimizer(
        0.01, centered=True, momentum=0.5), None),
    "ftrl": (lambda f: f.optimizer.FtrlOptimizer(0.1, l1=0.01, l2=0.01),
             None),
    "lamb": (lambda f: f.optimizer.LambOptimizer(0.01), None),
    "adamw": (lambda f: f.optimizer.AdamOptimizer(0.01),
              _retype("adamw", weight_decay=0.01)),
    "dpsgd": (lambda f: f.optimizer.SGDOptimizer(0.1),
              _retype("dpsgd", clip=1.0, sigma=0.0)),
    "proximal_gd": (lambda f: f.optimizer.SGDOptimizer(0.1),
                    _retype("proximal_gd", l1=0.01, l2=0.01)),
    "proximal_adagrad": (lambda f: f.optimizer.AdagradOptimizer(0.1),
                         _retype("proximal_adagrad", l1=0.01, l2=0.01)),
    "decoupled_weight_decay": (
        lambda f: f.contrib.extend_with_decoupled_weight_decay(
            f.optimizer.AdamOptimizer)(0.01, learning_rate=0.01), None),
}
NORM_OPS = ("lars_momentum", "lamb", "dpsgd")
NO_ACCUMULATORS = ("sgd", "dpsgd", "proximal_gd")


@pytest.mark.parametrize("form", ["fsdp", "zero1", "both"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_every_optimizer_on_sharded_state(name, form):
    """Every optimizer op the port registers, one step at a local dp 2
    with FSDP alone (the parameters and gradients laid out, the
    accumulators whole), ZeRO-1 alone (the accumulators laid out) and
    both, against the same step unsharded: every persistable after it
    bitwise (within 1e-6 relative for the whole-parameter norms of
    lars_momentum, lamb and dpsgd at sigma 0), and the blockwise update
    ran (the optimizer op's inputs were laid out)."""
    make_opt, rewrite = OPTIMIZERS[name]
    main, startup, loss = _mlp(fluid, tun, make_opt)
    if rewrite is not None:
        rewrite(main)
    rs = np.random.RandomState(0)
    feed = {"x": rs.randn(8, 16).astype(np.float32),
            "y": rs.randint(0, 4, (8, 1)).astype(np.int64)}
    init = fluid.Scope()
    with fluid.scope_guard(init):
        fluid.Executor(CPU).run(startup)

    def step(program):
        scope = fluid.Scope()
        for n in init.names():
            scope.set(n, init.get(n).clone())
        with fluid.scope_guard(scope):
            fluid.Executor(CPU).run(program, feed=feed, fetch_list=[loss])
        return scope

    want = step(fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, places=[CPU] * 2))
    if form in ("zero1", "both"):
        shard_optimizer_state(main)
    if form in ("fsdp", "both"):
        shard_params_fsdp(main, min_size=64)
    annotated = [v.name for v in main.list_vars()
                 if getattr(v, "dist_attr", None) is not None]
    # ZeRO-1 alone lays out nothing of an optimizer without accumulators
    assert bool(annotated) != (form == "zero1" and name in NO_ACCUMULATORS)
    got = step(fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, places=[CPU] * 2))
    assert all(isinstance(got.get(n), ShardedTensor) for n in annotated)
    for n in want.names():
        g = got.get(n)
        g = g.full() if isinstance(g, ShardedTensor) else g
        w = want.get(n)
        if name in NORM_OPS:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=NORM_RTOL,
                                       atol=NORM_RTOL * np.abs(
                                           w.numpy()).max(), err_msg=n)
        else:
            np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=n)


def test_accumulator_names_and_zero1_annotations_equal_jax():
    """The port names its optimizers' accumulators as the JAX package
    does, so shard_optimizer_state's name heuristic annotates the same
    variables with the same spec in both packages (for every optimizer
    with accumulators), and DistributeTranspiler().transpile(0) is that
    annotation."""
    for name in ("momentum", "lars_momentum", "adagrad", "decayed_adagrad",
                 "adadelta", "adam", "adamax", "rmsprop_centered", "ftrl",
                 "lamb"):
        make_opt, _ = OPTIMIZERS[name]
        tmain, _ts, _tl = _mlp(fluid, tun, make_opt)
        jmain, _js, _jl = _mlp(jfluid, jun, make_opt)
        assert sorted(v.name for v in tmain.list_vars() if v.persistable) \
            == sorted(v.name for v in jmain.list_vars() if v.persistable)
        fluid.DistributeTranspiler().transpile(0, program=tmain)
        jfluid.DistributeTranspiler().transpile(0, program=jmain)
        got = {v.name: tuple(v.dist_attr) for v in tmain.list_vars()
               if getattr(v, "dist_attr", None) is not None}
        want = {v.name: tuple(v.dist_attr) for v in jmain.list_vars()
                if getattr(v, "dist_attr", None) is not None}
        assert got == want and got, name


def test_transpiler_surface_matches_jax():
    """Async mode and the pserver getters raise, as JAX's; the dispatchers
    place as JAX's; memory_optimize / release_memory warn and change
    nothing; GradAllReduce and LocalSGD construct and raise at
    transpile; the top-level names exist."""
    main, _s, _l = _mlp(fluid, tun, OPTIMIZERS["adam"][0])
    with pytest.raises(NotImplementedError, match="async"):
        fluid.DistributeTranspiler().transpile(0, program=main,
                                               sync_mode=False)
    t = fluid.DistributeTranspiler(fluid.DistributeTranspilerConfig())
    t.transpile(0, program=main)
    assert t.get_trainer_program() is main
    with pytest.raises(NotImplementedError):
        t.get_pserver_program("127.0.0.1:6174")

    class V:
        def __init__(self, name):
            self.name = name

    eps = ["a:1", "b:2", "c:3"]
    vs = [V(f"w{i}") for i in range(7)]
    assert ttr.RoundRobin(eps).dispatch(vs) == \
        jtr.RoundRobin(eps).dispatch(vs)
    assert ttr.HashName(eps).dispatch(vs) == jtr.HashName(eps).dispatch(vs)
    before = [(op.type, dict(op.attrs)) for op in main.global_block().ops]
    for fn in (fluid.memory_optimize, fluid.release_memory):
        with pytest.warns(UserWarning, match="no-op"):
            fn(main)
    assert before == [(op.type, dict(op.attrs))
                      for op in main.global_block().ops]
    for cls in (ttr.GradAllReduce, ttr.LocalSGD):
        with pytest.raises(NotImplementedError):
            cls(nrings=2).transpile()
    import paddle_tpu_torch.transpiler as top
    assert sorted(top.__all__) == sorted(jfluid.transpiler.__all__)


def test_guard_trips_on_nan_in_a_sharded_grad(fresh):
    """The NaN guard reads a sharded @GRAD over its parts: a NaN planted
    in one part of an FSDP parameter's gradient trips it, naming the
    gradient."""
    from paddle_tpu_torch.core import executor as texecutor
    from paddle_tpu_torch.robustness import NonFiniteError
    tw = fresh
    shard_params_fsdp(tw.tmain, min_size=1024)
    comp = fluid.CompiledProgram(tw.tmain).with_data_parallel(
        loss_name=tw.tloss.name, places=[CPU] * 2)
    scope = fluid.scope_from_numpy(tw.init, "cpu")
    exe = fluid.Executor(CPU, guard=True)
    with fluid.scope_guard(scope):
        exe.run(comp, feed=tw.feed, fetch_list=[tw.tloss])
        w = scope.get("enc0_ffn0_w")
        assert isinstance(w, ShardedTensor)
        real = texecutor.Executor._backward

        def poisoned(marker, env, *a, **k):
            real(marker, env, *a, **k)
            env["enc0_ffn0_w@GRAD"].parts[1][0, 0] = float("nan")

        texecutor.Executor._backward = staticmethod(poisoned)
        try:
            with pytest.raises(NonFiniteError, match="enc0_ffn0_w@GRAD"):
                exe.run(comp, feed=tw.feed, fetch_list=[tw.tloss])
        finally:
            texecutor.Executor._backward = staticmethod(real)


def test_save_persistables_and_plain_run_between_walks(fresh, tmp_path):
    """save_persistables of a sharded scope writes the global arrays, the
    unsharded scope's files byte for byte; a plain Executor.run of the
    Program on the sharded scope reads the global values (its loss is
    the walk's), the next walk cuts again what it wrote, and the three
    steps equal three plain dp 2 steps bitwise."""
    tw = fresh
    plain_comp = fluid.CompiledProgram(tw.tmain).with_data_parallel(
        loss_name=tw.tloss.name, places=[CPU] * 2)
    want, wscope = tw.port(plain_comp, steps=1, grads=False)
    shard_optimizer_state(tw.tmain)
    shard_params_fsdp(tw.tmain, min_size=1024)
    comp = fluid.CompiledProgram(tw.tmain).with_data_parallel(
        loss_name=tw.tloss.name, places=[CPU] * 2)
    got, scope = tw.port(comp, steps=1, grads=False)
    assert isinstance(scope.get("word_embedding"), ShardedTensor)
    for sc, d in ((scope, "sharded"), (wscope, "plain")):
        with fluid.scope_guard(sc):
            fluid.io.save_persistables(fluid.Executor(CPU),
                                       str(tmp_path / d), tw.tmain)
    files = sorted(os.listdir(tmp_path / "plain"))
    assert files == sorted(os.listdir(tmp_path / "sharded"))
    for f in files:
        assert (tmp_path / "plain" / f).read_bytes() == \
            (tmp_path / "sharded" / f).read_bytes(), f
    with fluid.scope_guard(scope):
        w = fluid.io.get_parameter_value_by_name("word_embedding")
    assert w.shape == (tw.cfg.vocab_size, tw.cfg.hidden_size)
    exe = fluid.Executor(CPU)
    with fluid.scope_guard(scope):
        (plain_loss,) = exe.run(tw.tmain, feed=tw.feed,
                                fetch_list=[tw.tloss])
        assert isinstance(scope.get("word_embedding"), torch.Tensor)
        (walk_loss,) = exe.run(comp, feed=tw.feed, fetch_list=[tw.tloss])
        assert isinstance(scope.get("word_embedding"), ShardedTensor)
    with fluid.scope_guard(wscope):
        ref = [exe.run(plain_comp, feed=tw.feed, fetch_list=[tw.tloss])[0]
               for _ in range(2)]
    np.testing.assert_allclose(plain_loss, ref[0], rtol=1e-6)
    np.testing.assert_allclose(walk_loss, ref[1], rtol=1e-5)


# ---------------------------------------------------------------------------
# (c) the world: FSDP + ZeRO-1 over two gloo processes
# ---------------------------------------------------------------------------

WORKER = r'''
import datetime
import sys

import numpy as np
import torch
import torch.distributed as dist

rank, init, out, inputs = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                           sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=60))
try:
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import unique_name as tun
    from paddle_tpu_torch.models import bert as tbert
    from paddle_tpu_torch.parallel import (ShardedTensor,
                                           shard_optimizer_state,
                                           shard_params_fsdp)
    data = np.load(inputs)
    cfg = tbert.bert_tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    cfg.num_hidden_layers = 2
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with tun.guard(), fluid.program_guard(main, startup):
        _f, loss, _m, _a = tbert.build_pretrain_net(cfg,
                                                    seq_len=int(data["seq"]))
        fluid.optimizer.AdamOptimizer(1e-3).minimize(loss)
    shard_optimizer_state(main)
    shard_params_fsdp(main, min_size=1024)
    scope = fluid.scope_from_numpy(
        {k[6:]: data[k] for k in data.files if k.startswith("scope/")},
        "cpu")
    feed = {k[5:]: data[k] for k in data.files if k.startswith("feed/")}
    names = [p.name for p in main.all_parameters()]
    comp = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name)
    assert comp.mesh.world and comp.mesh.held("dp") == [rank]
    exe = fluid.Executor(fluid.CPUPlace())
    res, reductions = {}, []
    with fluid.scope_guard(scope):
        for i in range(2):
            red0 = comp.mesh.reductions
            got = exe.run(comp, feed=feed, fetch_list=[loss] + (
                [n + "@GRAD" for n in names] if i == 0 else []))
            reductions.append(comp.mesh.reductions - red0)
            res[f"loss{i}"] = got[0]
            if i == 0:
                for n, g in zip(names, got[1:]):
                    res["grad/" + n] = g
        held = {n: (scope.get(n).numel(), scope.get(n).global_numel())
                for n in scope.names()
                if isinstance(scope.get(n), ShardedTensor)}
        res["held"] = np.array(list(held.values()))
        res["sharded_params"] = np.array(sum(
            isinstance(scope.get(n), ShardedTensor) for n in names))
        # the parameters ZeRO-1 updates blockwise while they stay whole
        res["cut_params"] = np.array(sum(
            not isinstance(scope.get(op.input("Param")[0]), ShardedTensor)
            and isinstance(scope.get(op.input("Moment1")[0]), ShardedTensor)
            for op in main.global_block().ops if op.type == "adam"))
        fluid.io.save_checkpoint_sharded(exe, out + "/ckpt",
                                         main_program=main, step=2).wait()
        for n in scope.names():
            v = scope.get(n)
            res["state/" + n] = (v.full() if isinstance(v, ShardedTensor)
                                 else v).numpy().copy()
        # the elements the scope holds (a sharded value's part, any other
        # whole) against the dist_attrs' shares: no whole copy of a
        # sharded variable stays behind
        from paddle_tpu_torch.parallel.sharded import (is_replicated,
                                                       placement_spec)
        dist_attr = {v.name: getattr(v, "dist_attr", None)
                     for v in main.list_vars()}
        vals = {n: scope.get(n) for n in scope.names()}
        res["scope_elements"] = np.array([
            sum(v.numel() for v in vals.values()),
            sum(int(np.prod(v.shape)) // (1 if is_replicated(placement_spec(
                dist_attr.get(n), tuple(v.shape), comp.mesh)) else 2)
                for n, v in vals.items())])
        whole = fluid.Scope()
        fluid.io.load_checkpoint_sharded(exe, out + "/ckpt",
                                         main_program=main, scope=whole)
        res["restored_equal"] = np.array(all(
            np.array_equal(fluid.io.state.host_array(whole.get(n)),
                           res["state/" + n]) for n in scope.names()))
        # a host copy of a world-sharded value raises at once: one
        # trainer's save_persistables cannot wait for the other
        if rank == 0:
            try:
                fluid.io.save_persistables(exe, out + "/solo", main)
            except RuntimeError as e:
                res["solo_save_error"] = np.array(str(e))
        dist.barrier()
        # a NaN in rank 1's block of a sharded @GRAD trips both ranks
        from paddle_tpu_torch.core import executor as texecutor
        from paddle_tpu_torch.robustness import NonFiniteError
        real = texecutor.Executor._backward

        def poisoned(marker, env, *a, **k):
            real(marker, env, *a, **k)
            if rank == 1:
                env["enc0_ffn0_w@GRAD"].parts[0][0, 0] = float("nan")

        texecutor.Executor._backward = staticmethod(poisoned)
        try:
            fluid.Executor(fluid.CPUPlace(), guard=True).run(
                comp, feed=feed, fetch_list=[loss])
        except NonFiniteError as e:
            res["tripped"] = np.array(e.bad_vars)
        finally:
            texecutor.Executor._backward = staticmethod(real)
    res["reductions"] = np.array(reductions)
    np.savez(out + "/rank%d.npz" % rank, **res)
finally:
    dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def world(twin, tmp_path_factory):
    """Two gloo processes (``file://`` rendezvous under a temporary
    directory), one dp rank each, run FSDP + ZeRO-1 BERT-tiny from the
    twin's state for two steps and save a sharded checkpoint: (the
    directory of the ranks' records). Every wait is bounded: the process
    group's 60 s and the run's 200 s."""
    base = tmp_path_factory.mktemp("sharded_world")
    inputs = base / "inputs.npz"
    np.savez(inputs, seq=np.array(SEQ),
             **{"scope/" + n: v for n, v in twin.init.items()},
             **{"feed/" + k: v for k, v in twin.feed.items()})
    script = base / "sharded_worker.py"
    script.write_text(WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, os.path.join(REPO, "tests"), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    init = "file://" + str(base / "rdv")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), init, str(base),
         str(inputs)], env=env, cwd=str(base), stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    errs = [p.communicate(timeout=200)[1] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], errs
    return base


def test_world_fsdp_zero1_matches_dp1_and_holds_half(fresh, world):
    """In the gloo world, FSDP + ZeRO-1: both ranks' losses and first-step
    @GRADs equal the unsharded single-process run's (a sharded gradient
    is whole for its rows after its gather's backward and is not
    all-reduced again: a second reduction would double it), each rank
    holds exactly half of every sharded variable's elements, a step
    makes the 5 dp reductions, one gather a sharded parameter, one fused
    all-reduce of the replicated gradients and one all-gather a
    parameter ZeRO-1 updates blockwise while it stays whole; the sharded
    checkpoint both ranks wrote has one index.json and restores (on each
    rank, and here into a local dp 2 mesh) every variable bitwise."""
    tw = fresh
    shard_optimizer_state(tw.tmain)
    shard_params_fsdp(tw.tmain, min_size=1024)
    one, _ = tw.port(tw.tmain, steps=2)
    loc = fluid.CompiledProgram(tw.tmain).with_data_parallel(
        loss_name=tw.tloss.name, places=[CPU] * 2)
    local, lscope = tw.port(loc, steps=2)
    ranks = [np.load(world / f"rank{r}.npz") for r in range(2)]
    for got in ranks:
        for i in range(2):
            for ref in (one, local):
                np.testing.assert_allclose(_scalar(got[f"loss{i}"]),
                                           _loss(ref[i]), rtol=1e-5)
        _grads_close([got["grad/" + n] for n in tw.names], one[0][1:],
                     tw.names, 1e-4)
        held = got["held"]
        assert (held[:, 0] * 2 == held[:, 1]).all()
        assert bool(got["restored_equal"])
        n, cut = int(got["sharded_params"]), int(got["cut_params"])
        assert n > 0 and cut > 0
        assert list(got["reductions"]) == [5 + n + 1 + cut] * 2
    assert os.listdir(world / "ckpt").count("index.json") == 1
    mesh = _local(dp=2)
    scope = fluid.Scope()
    meta = fluid.io.load_checkpoint_sharded(
        fluid.Executor(CPU), str(world / "ckpt"), main_program=tw.tmain,
        mesh=mesh, scope=scope)
    assert meta["step"] == 2
    for name in [k[6:] for k in ranks[0].files if k.startswith("state/")]:
        v = scope.get(name)
        if name in ("word_embedding",):
            assert isinstance(v, ShardedTensor) and v.mesh is mesh
        got = v.full() if isinstance(v, ShardedTensor) else v
        np.testing.assert_array_equal(got.numpy(),
                                      ranks[0]["state/" + name], name)
    np.testing.assert_array_equal(ranks[0]["state/word_embedding"],
                                  ranks[1]["state/word_embedding"])


def test_world_scope_holds_no_whole_copy(world):
    """Summed over every value in each rank's scope (a sharded value's
    part, any other tensor whole), the elements held equal the
    dist_attrs' shares: half of every variable a dist_attr lays out over
    dp 2, the rest whole. A sharded variable left whole would add its
    other half."""
    for r in range(2):
        held, want = np.load(world / f"rank{r}.npz")["scope_elements"]
        assert held == want, (r, held, want)


def test_world_host_copy_raises_and_guard_trips_every_rank(world):
    """In the world, rank 0's save_persistables alone raises at once (a
    host copy of a sharded value would gather from a rank that never
    calls; JAX's np.asarray raises there too) and does not hang rank 1;
    a NaN planted in rank 1's block of a sharded @GRAD trips the guard
    on both ranks, as JAX's guard reads the global array."""
    ranks = [np.load(world / f"rank{r}.npz") for r in range(2)]
    assert "save_checkpoint_sharded" in str(ranks[0]["solo_save_error"])
    assert "solo_save_error" not in ranks[1].files
    assert not os.listdir(world / "solo")
    for got in ranks:
        assert "enc0_ffn0_w@GRAD" in list(got["tripped"])


def _scalar(v):
    return float(np.asarray(v).reshape(-1)[0])


SLICE_MODULES = ("paddle_tpu_torch.parallel.sharded",
                 "paddle_tpu_torch.parallel.pipeline",
                 "paddle_tpu_torch.parallel.moe",
                 "paddle_tpu_torch.optimizer",
                 "paddle_tpu_torch.layers.nn",
                 "paddle_tpu_torch.parallel.transpiler",
                 "paddle_tpu_torch.parallel.mesh",
                 "paddle_tpu_torch.transpiler",
                 "paddle_tpu_torch.io.checkpoint",
                 "paddle_tpu_torch.core.compiler",
                 "paddle_tpu_torch.parallel.collective",
                 "paddle_tpu_torch.parallel.fleet",
                 "paddle_tpu_torch.ops.collective_ops",
                 "paddle_tpu_torch.distributed.launch",
                 "paddle_tpu_torch.distributed.launch_ps",
                 "paddle_tpu_torch.distributed.downpour",
                 "paddle_tpu_torch.incubate.fleet",
                 "paddle_tpu_torch.incubate.fleet.utils.fleet_util",
                 "paddle_tpu_torch.communicator")


def test_slice_modules_import_neither_jax_nor_paddle_tpu():
    """A fresh interpreter imports every module of the slice: no jax
    module and no module of the JAX package is loaded afterwards."""
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'jaxlib' or m == 'paddle_tpu' "
            "or m.startswith('paddle_tpu.'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_slice_names_under_the_jax_packages_places():
    """The names the JAX package exports for this slice sit under the
    same places in the port: the top-level transpiler names, the
    sharded checkpoint in io, the mesh helpers and the transpiler's
    functions in parallel."""
    import paddle_tpu.io as jio
    import paddle_tpu.parallel.mesh as jmesh
    from paddle_tpu_torch import io as tio
    from paddle_tpu_torch.parallel import mesh as tmesh
    for name in ("DistributeTranspiler", "DistributeTranspilerConfig",
                 "memory_optimize", "release_memory"):
        assert hasattr(jfluid, name) and hasattr(fluid, name), name
    for name in ("save_checkpoint_sharded", "load_checkpoint_sharded"):
        assert hasattr(jio, name) and hasattr(tio, name), name
    for name in ("make_hybrid_mesh", "host_domains",
                 "multihost_initialize", "named_sharding", "replicated"):
        assert hasattr(jmesh, name) and hasattr(tmesh, name), name
    for name in jtr.__dict__:
        if not name.startswith("_") and callable(getattr(jtr, name)) \
                and name != "P":
            assert hasattr(ttr, name), name
