"""Pipeline parallelism (item 11a) in the port, against the JAX package,
on the CPU.

Twins of ``tests/parallel/test_pipeline_framework.py`` (the 2-stage MLP
under ``PipelineOptimizer`` against the sequential Executor, the chain
check, 1F1B against plain gradients), ``test_pipeline_tp_hybrid.py`` (pp
2 x tp 2, the weight keeping its tp layout),
``test_parallel_modes.py::test_pipeline_matches_sequential``
(``pipeline_apply`` at pp 8) and ``tests/perf/test_pipeline_schedule.py``
(the 1F1B schedule's ticks, carry and bubble, equal to JAX's
``schedule_stats``), and GPT (``gpt_tiny``) at pp 2 and pp 4 against
JAX's pipelined Program, the tied word embedding's gradient included.
Both packages build each Program under fresh unique-name generators; the
port's startup state is carried into JAX's scope as numpy, and JAX runs
its meshes over the 8 virtual CPU devices of ``tests/conftest.py``.

Tolerances: the port's pipelined losses within 1e-6 relative of its
sequential run's (the microbatches' means add in another order), and
within 1e-5 relative of JAX's; parameters after the steps and @GRADs
within 1e-5 of each tensor's scale against the port's sequential run and
1e-4 (+ 1e-6) against JAX (the train twins' tolerances:
tests/test_torch_train.py); the functional forms' outputs and gradients
within 1e-5 (+ 1e-6) of the reference's scale.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu import layers as jlayers
from paddle_tpu.core import unique_name as jun
from paddle_tpu.core.executor import Scope as JScope, scope_guard as jguard
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.parallel import pipeline as jpp
from paddle_tpu.parallel.mesh import make_mesh as jmake_mesh

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.core import unique_name as tun
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.parallel import make_mesh, pipeline as tpp
from paddle_tpu_torch.parallel.sharded import ShardedTensor
from paddle_tpu_torch.parallel.tensor_parallel import PartitionSpec

CPU = fluid.CPUPlace()
SEQ_RTOL = 1e-6         # pipelined vs sequential, the port's losses
JAX_RTOL = 1e-5         # the port against JAX, losses
SEQ_GRAD_TOL = 1e-5     # of each tensor's scale, against the sequential run
JAX_GRAD_TOL, JAX_GRAD_ATOL = 1e-4, 1e-6
FN_TOL, FN_ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_bert.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def scalar(v):
    return float(np.asarray(v).reshape(-1)[0])


def scale_close(got, want, tol, atol=0.0, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max() + atol, (name, err)


def local(**kw):
    return make_mesh(**kw, devices=["cpu"] * int(np.prod(list(kw.values()))))


# ---------------------------------------------------------------------------
# the framework path: an MLP of two stages
# ---------------------------------------------------------------------------

def _mlp(pkg, layers, prefix="pipe"):
    """2-stage MLP: stage 0 = fc1 + tanh (cut at an assign), stage 1 =
    fc2 + a mean loss (microbatching keeps its numbers)."""
    x = layers.data("x", shape=[8], dtype="float32")
    label = layers.data("label", shape=[4], dtype="float32")
    h = layers.fc(x, size=16, act="tanh",
                  param_attr=pkg.ParamAttr(name=f"{prefix}_fc1_w"))
    cut = layers.assign(h)
    y = layers.fc(cut, size=4,
                  param_attr=pkg.ParamAttr(name=f"{prefix}_fc2_w"))
    loss = layers.mean(layers.square_error_cost(y, label))
    return cut, loss


def _mlp_feed(batch=8, seed=0):
    rs = np.random.RandomState(seed)
    return {"x": rs.randn(batch, 8).astype(np.float32),
            "label": rs.randn(batch, 4).astype(np.float32)}


def _build_mlp(pkg, un, layers, pipelined, prefix="pipe", m=4):
    main, startup = pkg.Program(), pkg.Program()
    with un.guard(), pkg.program_guard(main, startup):
        cut, loss = _mlp(pkg, layers, prefix)
        sgd = pkg.optimizer.SGDOptimizer(learning_rate=0.1)
        if pipelined:
            pkg.optimizer.PipelineOptimizer(
                sgd, cut_list=[[cut]], num_microbatches=m).minimize(loss)
        else:
            sgd.minimize(loss)
    return main, startup, loss


def _start(startup):
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor(CPU).run(startup)
    return {n: scope.get(n).numpy().copy() for n in scope.names()}


def _port_run(main, loss, init, feed, mesh=None, steps=3, fetch=()):
    scope = fluid.scope_from_numpy(init, "cpu")
    prog = main if mesh is None else \
        fluid.CompiledProgram(main).with_mesh(mesh)
    exe, losses, first = fluid.Executor(CPU), [], None
    with fluid.scope_guard(scope):
        for i in range(steps):
            out = exe.run(prog, feed=feed, fetch_list=[loss] + list(
                fetch if i == 0 else ()))
            losses.append(scalar(out[0]))
            if i == 0:
                first = out[1:]
    return losses, scope, first


def _jax_run(main, loss, init, feed, mesh=None, steps=3, fetch=()):
    scope = JScope()
    for n, v in init.items():
        scope.set(n, jnp.asarray(v))
    prog = main if mesh is None else \
        jfluid.CompiledProgram(main).with_mesh(mesh)
    exe, losses, first = jfluid.Executor(), [], None
    with jguard(scope):
        for i in range(steps):
            out = exe.run(prog, feed=feed, fetch_list=[loss] + list(
                fetch if i == 0 else ()))
            losses.append(scalar(out[0]))
            if i == 0:
                first = out[1:]
    return losses, scope, first


def _host(v):
    return (v.full() if isinstance(v, ShardedTensor) else v).numpy()


def test_pipeline_optimizer_matches_sequential_and_jax():
    """PipelineOptimizer over pp 2 (M 4), three SGD steps: the losses and
    fc1's weight equal the sequential Executor's and JAX's pipelined
    run's."""
    feed = _mlp_feed()
    seq_main, seq_start, seq_loss = _build_mlp(fluid, tun, tlayers, False)
    init = _start(seq_start)
    seq, seq_scope, _ = _port_run(seq_main, seq_loss, init, feed)
    main, _s, loss = _build_mlp(fluid, tun, tlayers, True)
    got, scope, _ = _port_run(main, loss, init, feed, local(pp=2))
    jmain, _js, jloss = _build_mlp(jfluid, jun, jlayers, True)
    want, jscope, _ = _jax_run(jmain, jloss, init, feed,
                               jmake_mesh(pp=2, devices=jax.devices()[:2]))
    np.testing.assert_allclose(got, seq, rtol=SEQ_RTOL)
    np.testing.assert_allclose(got, want, rtol=JAX_RTOL)
    w = _host(scope.get("pipe_fc1_w"))
    scale_close(w, seq_scope.get("pipe_fc1_w").numpy(), SEQ_GRAD_TOL)
    scale_close(w, np.asarray(jscope.get("pipe_fc1_w")), JAX_GRAD_TOL,
                JAX_GRAD_ATOL)


def test_pipeline_optimizer_bad_cut_raises():
    """A value of stage 0 read after the cut: the chain check's
    ValueError, in both packages."""
    for pkg, un, layers in ((fluid, tun, tlayers), (jfluid, jun, jlayers)):
        main, startup = pkg.Program(), pkg.Program()
        with un.guard(), pkg.program_guard(main, startup):
            x = layers.data("x", shape=[8], dtype="float32")
            label = layers.data("label", shape=[4], dtype="float32")
            h = layers.fc(x, size=16, act="tanh")
            cut = layers.assign(h)
            y = layers.fc(layers.elementwise_add(cut, h), size=4)
            loss = layers.mean(layers.square_error_cost(y, label))
            pkg.optimizer.PipelineOptimizer(
                pkg.optimizer.SGDOptimizer(learning_rate=0.1),
                cut_list=[[cut]], num_microbatches=2).minimize(loss)
        if pkg is fluid:
            init = _start(startup)
            with pytest.raises(ValueError, match="chain|separate"):
                _port_run(main, loss, init, _mlp_feed(batch=4), local(pp=2),
                          steps=1)
        else:
            with pytest.raises(ValueError, match="chain|separate"):
                _jax_run(main, loss, init, _mlp_feed(batch=4),
                         jmake_mesh(pp=2, devices=jax.devices()[:2]),
                         steps=1)


def test_pipeline_with_tp_sharded_weights_matches_sequential():
    """pp 2 x tp 2 with fc1 column-split and fc2 row-split over tp: the
    stages compute whole (every parameter replicated into them, as JAX's
    shard_map), the weights keep their tp layout, and the losses and fc1
    equal the sequential run's and JAX's hybrid run's."""
    feed = _mlp_feed(seed=3)
    seq_main, seq_start, seq_loss = _build_mlp(fluid, tun, tlayers, False,
                                               "hyb")
    init = _start(seq_start)
    seq, seq_scope, _ = _port_run(seq_main, seq_loss, init, feed)
    specs = {"hyb_fc1_w": (None, "tp"), "hyb_fc2_w": ("tp", None)}
    main, _s, loss = _build_mlp(fluid, tun, tlayers, True, "hyb")
    jmain, _js, jloss = _build_mlp(jfluid, jun, jlayers, True, "hyb")
    from jax.sharding import PartitionSpec as JP
    for p in main.all_parameters():
        if p.name in specs:
            p.dist_attr = PartitionSpec(*specs[p.name])
    for p in jmain.all_parameters():
        if p.name in specs:
            p.dist_attr = JP(*specs[p.name])
    got, scope, _ = _port_run(main, loss, init, feed, local(pp=2, tp=2))
    want, jscope, _ = _jax_run(jmain, jloss, init, feed, jmake_mesh(
        pp=2, tp=2, devices=jax.devices()[:4]))
    w1 = scope.get("hyb_fc1_w")
    assert isinstance(w1, ShardedTensor)
    assert tuple(w1.spec) == (None, "tp")
    np.testing.assert_allclose(got, seq, rtol=SEQ_RTOL)
    np.testing.assert_allclose(got, want, rtol=JAX_RTOL)
    scale_close(w1.full().numpy(), seq_scope.get("hyb_fc1_w").numpy(),
                SEQ_GRAD_TOL)
    scale_close(w1.full().numpy(), np.asarray(jscope.get("hyb_fc1_w")),
                JAX_GRAD_TOL, JAX_GRAD_ATOL)


# ---------------------------------------------------------------------------
# the functional forms
# ---------------------------------------------------------------------------

def _stage_np(w, x):
    return np.tanh(x @ w)


def test_pipeline_apply_matches_sequential_and_jax():
    """pipeline_apply over 8 stages, 4 microbatches of 4 rows: the
    sequential product's numbers and JAX's pipeline_apply's."""
    rs = np.random.RandomState(0)
    nstage, d = 8, 6
    ws = rs.rand(nstage, d, d).astype(np.float32) * 0.5
    x = rs.rand(16, d).astype(np.float32)
    ref = x
    for s in range(nstage):
        ref = _stage_np(ws[s], ref)
    got = tpp.pipeline_apply(lambda w, h: torch.tanh(h @ w),
                             torch.tensor(ws), torch.tensor(x),
                             local(pp=nstage), microbatches=4)
    want = jpp.pipeline_apply(lambda w, h: jnp.tanh(h @ w), jnp.asarray(ws),
                              jnp.asarray(x), jmake_mesh(pp=nstage),
                              microbatches=4)
    scale_close(got.numpy(), ref, FN_TOL, FN_ATOL)
    scale_close(got.numpy(), np.asarray(want), FN_TOL, FN_ATOL)


def _1f1b_inputs(s=4, m=8, mb=2, d=8, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(s, d, d).astype(np.float32) * 0.5,
            rs.randn(m, mb, d).astype(np.float32),
            rs.randn(m, mb, d).astype(np.float32))


def _t_stage(w, x):
    return torch.tanh(x @ w)


def _t_loss(y, a):
    return torch.mean((y - a) ** 2)


def _j_stage(w, x):
    return jnp.tanh(x @ w)


def _j_loss(y, a):
    return jnp.mean((y - a) ** 2)


def reference_1f1b(ws, xm, aux):
    """The loss and stacked gradients of the stages run in sequence,
    microbatch by microbatch (autograd)."""
    w = torch.tensor(ws, requires_grad=True)
    total = 0.0
    for k in range(xm.shape[0]):
        h = torch.tensor(xm[k])
        for s in range(ws.shape[0]):
            h = _t_stage(w[s], h)
        total = total + _t_loss(h, torch.tensor(aux[k]))
    loss = total / xm.shape[0]
    (g,) = torch.autograd.grad(loss, [w])
    return float(loss.detach()), g.numpy()


def test_pipeline_1f1b_matches_plain_grads_and_jax():
    """1F1B over 4 stages at M 8: the loss and gradients of the sequential
    autograd reference and of JAX's pipeline_1f1b."""
    ws, xm, aux = _1f1b_inputs()
    loss, grads = tpp.pipeline_1f1b(_t_stage, _t_loss, torch.tensor(ws),
                                    torch.tensor(xm), torch.tensor(aux),
                                    local(pp=4))
    ref_loss, ref_grads = reference_1f1b(ws, xm, aux)
    jloss, jgrads = jax.jit(lambda w: jpp.pipeline_1f1b(
        _j_stage, _j_loss, w, jnp.asarray(xm), jnp.asarray(aux),
        jmake_mesh(pp=4, devices=jax.devices()[:4])))(jnp.asarray(ws))
    assert float(loss) == pytest.approx(ref_loss, rel=FN_TOL)
    assert float(loss) == pytest.approx(float(jloss), rel=FN_TOL)
    scale_close(grads.numpy(), ref_grads, FN_TOL, FN_ATOL)
    scale_close(grads.numpy(), np.asarray(jgrads), FN_TOL, FN_ATOL)


def _stats(pkg, m, s=4, mb=2, d=8):
    if pkg == "jax":
        return jpp.schedule_stats(
            _j_stage, _j_loss, jnp.zeros((s, d, d)), jnp.zeros((m, mb, d)),
            jnp.zeros((m, mb, d)), jmake_mesh(pp=s, devices=jax.devices()[:s]))
    return tpp.schedule_stats(
        _t_stage, _t_loss, torch.zeros((s, d, d)), torch.zeros((m, mb, d)),
        torch.zeros((m, mb, d)), local(pp=s))


@pytest.mark.parametrize("m", [4, 8, 16])
def test_schedule_stats_equal_jax(m):
    """The port's schedule_stats (its tick table and carry) give JAX's
    three numbers (read off the traced scan) exactly."""
    assert _stats("torch", m) == _stats("jax", m)


def test_1f1b_live_state_independent_of_microbatch_count():
    assert _stats("torch", 4)["carry_bytes"] == \
        _stats("torch", 16)["carry_bytes"]


def test_1f1b_tick_count_is_interleaved_schedule():
    s = 4
    for m in (4, 16):
        assert _stats("torch", m, s)["ticks"] == 2 * m + 2 * s - 2
        table = tpp.tick_table(m, s)
        for stage in range(s):
            events = [row[stage] for row in table if row[stage]]
            assert sorted(events) == sorted(
                [(tpp.FWD, k) for k in range(m)]
                + [(tpp.BWD, k) for k in range(m)])


def test_1f1b_bubble_fraction_bounds_pp4():
    s, fracs = 4, {}
    for m in (8, 16):
        st = _stats("torch", m, s)
        frac = (st["ticks"] - 2 * m) / st["ticks"]
        assert frac == st["bubble_fraction"] == tpp.bubble_fraction(m, s) \
            == jpp.bubble_fraction(m, s)
        fracs[m] = frac
    assert fracs[16] < fracs[8]
    assert fracs[8] <= 6 / 22 + 1e-9
    assert fracs[16] <= 6 / 38 + 1e-9


def test_1f1b_inflight_activation_bound_pp4():
    """S residual slots + two ring slots + the gradient accumulator + the
    loss, the same at M 8 and M 16."""
    s, mb, d, f32 = 4, 2, 8, 4
    for m in (8, 16):
        per_slot = mb * d * f32
        assert _stats("torch", m, s, mb, d)["carry_bytes"] == \
            (s + 2) * per_slot + d * d * f32 + f32


def test_1f1b_residual_buffer_is_stage_bounded():
    """The carry's buffer holds exactly S slots of (mb, d)."""
    s, mb, d = 4, 2, 8
    carry = tpp._new_carry(torch.zeros(d, d), (mb, d), torch.float32, s,
                           "meta")
    assert tuple(carry["buf"].shape) == (s, mb, d)
    assert tpp._carry_bytes(carry) == \
        _stats("torch", 16, s, mb, d)["carry_bytes"]


def test_bubble_fraction_rejects_nonpositive():
    for m, s in ((0, 4), (4, 0)):
        with pytest.raises(ValueError):
            tpp.bubble_fraction(m, s)


# ---------------------------------------------------------------------------
# GPT at pp 2 and pp 4
# ---------------------------------------------------------------------------

GPT_SEQ, GPT_BATCH = 16, 8


def block_outputs(program, layers_n):
    """The residual sum that ends each GPT block (the add reading the
    second FFN product's biased output)."""
    ops = program.global_block().ops
    outs = []
    for i in range(layers_n):
        bias = next(op for op in ops if op.type == "elementwise_add"
                    and f"gpt{i}_ffn1_b" in op.input_names)
        biased = bias.output_names[0]
        res = next(op for op in ops if op.type == "elementwise_add"
                   and biased in op.input_names)
        outs.append(res.output_names[0])
    return outs


def _gpt_cuts(cfg, pp):
    per = cfg.num_layers // pp
    return [per * (i + 1) - 1 for i in range(pp - 1)]


def build_gpt(pkg, un, gpt, pp=None, m=4):
    cfg = gpt.gpt_tiny()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with un.guard(), pkg.program_guard(main, startup):
        _t, loss, _l = gpt.build_lm_net(cfg, seq_len=GPT_SEQ)
        opt = pkg.optimizer.AdamOptimizer(1e-3)
        if pp is None:
            opt.minimize(loss)
        else:
            names = block_outputs(main, cfg.num_layers)
            cuts = [[names[i]] for i in _gpt_cuts(cfg, pp)]
            pkg.optimizer.PipelineOptimizer(
                opt, cut_list=cuts, num_microbatches=m).minimize(loss)
    return cfg, main, startup, loss


@pytest.fixture(scope="module")
def gpt_plain():
    cfg, main, startup, loss = build_gpt(fluid, tun, tgpt)
    init = _start(startup)
    feed = {"tokens": np.random.RandomState(9).randint(
        0, cfg.vocab_size, (GPT_BATCH, GPT_SEQ)).astype(np.int64)}
    names = [p.name for p in main.all_parameters()]
    fetch = [n + "@GRAD" for n in names]
    losses, _s, grads = _port_run(main, loss, init, feed, steps=2,
                                  fetch=fetch)
    return init, feed, names, fetch, losses, grads


@pytest.mark.parametrize("pp", [2, 4])
def test_gpt_pipelined_matches_plain_and_jax(gpt_plain, pp):
    """gpt_tiny cut at block boundaries into pp stages, M 4, two Adam
    steps: the losses and first @GRADs (the tied gpt_word_emb's, read in
    the first and the last stage, included) equal the port's plain step
    and JAX's pipelined Program."""
    init, feed, names, fetch, seq, seq_grads = gpt_plain
    _c, main, _s, loss = build_gpt(fluid, tun, tgpt, pp)
    got, _scope, grads = _port_run(main, loss, init, feed, local(pp=pp),
                                   steps=2, fetch=fetch)
    _c, jmain, _js, jloss = build_gpt(jfluid, jun, jgpt, pp)
    want, _j, jgrads = _jax_run(jmain, jloss, init, feed, jmake_mesh(
        pp=pp, devices=jax.devices()[:pp]), steps=2, fetch=fetch)
    np.testing.assert_allclose(got, seq, rtol=SEQ_RTOL)
    np.testing.assert_allclose(got, want, rtol=JAX_RTOL)
    assert "gpt_word_emb" in names
    for n, a, b, c in zip(names, grads, seq_grads, jgrads):
        scale_close(a, b, SEQ_GRAD_TOL, name=n)
        scale_close(a, c, JAX_GRAD_TOL, JAX_GRAD_ATOL, name=n)


# ---------------------------------------------------------------------------
# what the pipelined walk refuses
# ---------------------------------------------------------------------------

def _raises(main, loss, init, feed, mesh, exc, match, fetch=()):
    with pytest.raises(exc, match=match):
        _port_run(main, loss, init, feed, mesh, steps=1, fetch=fetch)


def test_stage_count_must_equal_pp():
    main, startup, loss = _build_mlp(fluid, tun, tlayers, True)
    _raises(main, loss, _start(startup), _mlp_feed(), local(pp=4),
            ValueError, "2 pipeline stages but mesh has pp=4")


def _two_cut_program(second_size, second_dtype="float32"):
    main, startup = fluid.Program(), fluid.Program()
    with tun.guard(), fluid.program_guard(main, startup):
        x = tlayers.data("x", shape=[8], dtype="float32")
        label = tlayers.data("label", shape=[4], dtype="float32")
        c0 = tlayers.assign(tlayers.fc(x, size=16, act="tanh"))
        c1 = tlayers.fc(c0, size=second_size, act="tanh")
        if second_dtype != "float32":
            c1 = tlayers.cast(c1, second_dtype)
        c1 = tlayers.assign(c1)
        y = tlayers.fc(tlayers.cast(c1, "float32"), size=4)
        loss = tlayers.mean(tlayers.square_error_cost(y, label))
        fluid.optimizer.PipelineOptimizer(
            fluid.optimizer.SGDOptimizer(0.1), cut_list=[[c0], [c1]],
            num_microbatches=2).minimize(loss)
    return main, startup, loss


def test_cut_tensors_of_other_shapes_or_dtypes_raise():
    for size, dtype, match in ((12, "float32", "one shape"),
                               (16, "float64", "one dtype")):
        main, startup, loss = _two_cut_program(size, dtype)
        _raises(main, loss, _start(startup), _mlp_feed(), local(pp=3),
                ValueError, match)


def test_batch_the_microbatches_do_not_divide_raises():
    main, startup, loss = _build_mlp(fluid, tun, tlayers, True, m=3)
    _raises(main, loss, _start(startup), _mlp_feed(batch=8), local(pp=2),
            ValueError, "not divisible by num_microbatches=3")


def test_persistable_write_in_the_forward_raises():
    """A batch norm's running statistics, written in the forward, would
    be computed per microbatch: NotImplementedError, as JAX's."""
    main, startup = fluid.Program(), fluid.Program()
    with tun.guard(), fluid.program_guard(main, startup):
        x = tlayers.data("x", shape=[8], dtype="float32")
        label = tlayers.data("label", shape=[4], dtype="float32")
        h = tlayers.batch_norm(tlayers.fc(x, size=16))
        cut = tlayers.assign(h)
        loss = tlayers.mean(tlayers.square_error_cost(
            tlayers.fc(cut, size=4), label))
        fluid.optimizer.PipelineOptimizer(
            fluid.optimizer.SGDOptimizer(0.1), cut_list=[[cut]],
            num_microbatches=2).minimize(loss)
    _raises(main, loss, _start(startup), _mlp_feed(), local(pp=2),
            NotImplementedError, "writes persistable")


def test_sum_loss_warns():
    """A loss that is not a batch mean: microbatch averaging scales it,
    RuntimeWarning, and the run goes on."""
    main, startup = fluid.Program(), fluid.Program()
    with tun.guard(), fluid.program_guard(main, startup):
        x = tlayers.data("x", shape=[8], dtype="float32")
        label = tlayers.data("label", shape=[4], dtype="float32")
        cut = tlayers.assign(tlayers.fc(x, size=16, act="tanh"))
        loss = tlayers.reduce_sum(tlayers.square_error_cost(
            tlayers.fc(cut, size=4), label))
        fluid.optimizer.PipelineOptimizer(
            fluid.optimizer.SGDOptimizer(0.01), cut_list=[[cut]],
            num_microbatches=2).minimize(loss)
    with pytest.warns(RuntimeWarning, match="not a batch mean"):
        losses, _s, _f = _port_run(main, loss, _start(startup), _mlp_feed(),
                                   local(pp=2), steps=1)
    assert np.isfinite(losses).all()


def test_fetching_a_forward_intermediate_raises():
    main, startup, loss = _build_mlp(fluid, tun, tlayers, True)
    cut = main.global_block().ops[3].output_names[0]
    _raises(main, loss, _start(startup), _mlp_feed(), local(pp=2),
            ValueError, "cannot fetch forward intermediates", fetch=[cut])


def test_unported_combinations_raise_naming_their_item():
    """pp beside dp, under recompute or under amp: NotImplementedError
    naming the queued item (no JAX test holds them)."""
    main, startup, loss = _build_mlp(fluid, tun, tlayers, True)
    init = _start(startup)
    _raises(main, loss, init, _mlp_feed(), local(dp=2, pp=2),
            NotImplementedError, "ROADMAP queue A: pipeline parallelism "
            "beside dp")
    main._recompute = {"policy": "dots"}
    _raises(main, loss, init, _mlp_feed(), local(pp=2),
            NotImplementedError, "under recompute")
    del main._recompute
    for op in main.global_block().ops:
        if op.type == "mul":
            op.attrs["__amp_dtype__"] = "bfloat16"
    _raises(main, loss, init, _mlp_feed(), local(pp=2),
            NotImplementedError, "under amp")


def test_program_without_the_tag_runs_plain_on_a_pp_mesh():
    """A Program PipelineOptimizer did not tag runs its whole step on a pp
    mesh (every position the same), as JAX's GSPMD step does: the plain
    run's losses."""
    feed = _mlp_feed()
    main, startup, loss = _build_mlp(fluid, tun, tlayers, False)
    init = _start(startup)
    seq, _s, _f = _port_run(main, loss, init, feed)
    got, _s, _f = _port_run(main, loss, init, feed, local(pp=2))
    assert got == seq


def test_microbatch_streams_differ():
    """Each microbatch's random ops draw their own stream (JAX folds the
    microbatch into its key): the seeds of one step differ."""
    seeds = {tpp._microbatch_seed(7, k) for k in range(8)}
    assert len(seeds) == 8 and 7 not in seeds
