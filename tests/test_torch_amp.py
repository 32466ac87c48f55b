"""bf16 mixed precision and loss scaling in the port (``paddle_tpu_torch.amp``)
against the JAX package (``paddle_tpu.amp``), on the CPU.

Twins of ``tests/api/test_amp_fleet_utils.py``'s AMP tests (the MLP of its
``_net``), plus the op sequence ``decorate`` appends, BERT-tiny pretraining
under ``decorate(Adam)`` with dynamic loss scaling against the JAX
Executor, the overflow step, and ``rollback_hook``. Both packages build
the same Program under fresh unique-name generators; JAX runs the startup
and ``scope_from_numpy`` carries its scope into the port.

Tolerances (bf16 products on both sides, rounded by XLA's and torch's CPU
GEMMs, whose f32 sums may round to neighbouring bf16 values where the
order of summation differs, 2**-8 relative apart):

- losses: AMP_LOSS_RTOL = 1e-3 relative, a quarter of one bf16 step: the
  loss is a mean over many rows whose logits differ by single bf16
  roundings of either sign;
- gradients: AMP_GRAD_TOL = 2**-5 of max(|grad|) + 1e-3 of the largest
  gradient of the step, eight bf16 steps: each gradient is a chain of
  bf16 products (forward and backward, two layers), each rounded once;
  the floor covers gradients that are 0 up to rounding (the attention's
  key bias);
- the loss scale and the good-step counter: equal (0/1 flags and exact
  f32 scalars).

The deliberate difference (ROADMAP C8): on an overflow step the JAX
decorator multiplies the gradients by the finite flag, so an inf gradient
becomes NaN and so do the parameters; the port selects zeros
(``select_finite``) and its parameters stay finite. The op sequences
differ only there.
"""

import jax.numpy as jnp
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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (the suite runs
    several pytest workers at once; see tests/test_torch_bert.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mlp(pkg):
    """tests/api/test_amp_fleet_utils.py's _net."""
    lay = pkg.layers
    x = lay.data("x", shape=[8], dtype="float32")
    y = lay.data("y", shape=[1], dtype="float32")
    h = lay.fc(x, size=16, act="relu")
    pred = lay.fc(h, size=1)
    return lay.mean(lay.square_error_cost(pred, y))


def _mlp_feed(seed=0):
    rs = np.random.RandomState(seed)
    xs = rs.rand(16, 8).astype(np.float32)
    return {"x": xs, "y": xs.sum(1, keepdims=True).astype(np.float32)}


def _amp_adam(pkg, lr=1e-2, scale=2.0 ** 10):
    return pkg.amp.decorate(pkg.optimizer.AdamOptimizer(lr),
                            init_loss_scaling=scale,
                            use_dynamic_loss_scaling=True)


def _build(pkg, un, net, make_opt=None, seed=7):
    """(main, startup, loss, the decorated optimizer or None)."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    opt = None
    with un.guard(), pkg.program_guard(main, startup):
        loss = net(pkg)
        if make_opt is not None:
            opt = make_opt(pkg)
            opt.minimize(loss)
    return main, startup, loss, opt


def _start_both(jstart):
    jscope = JScope()
    with jguard(jscope):
        jfluid.Executor().run(jstart)
    tscope = fluid.scope_from_numpy(
        {n: np.asarray(jscope.get(n)) for n in jscope.names()}, "cpu")
    return jscope, tscope


def _tagged(program):
    return [(i, op.type) for i, op in enumerate(program.global_block().ops)
            if op.attrs.get("__amp_dtype__") == "bfloat16"]


def test_cast_model_to_bf16_tags_the_same_ops_as_jax():
    """test_amp_fleet_utils.py:41: the white-listed ops (here both fc's
    mul) are tagged at the same places in both packages, and the tagged
    program still gives a finite loss, the same as JAX's."""
    jmain, jstart, jloss, _ = _build(jfluid, jun, _mlp)
    tmain, _tstart, tloss, _ = _build(fluid, tun, _mlp)
    jfluid.amp.cast_model_to_bf16(jmain)
    fluid.amp.cast_model_to_bf16(tmain)
    assert _tagged(tmain) == _tagged(jmain)
    assert [t for _, t in _tagged(tmain)] == ["mul", "mul"]
    jscope, tscope = _start_both(jstart)
    with jguard(jscope):
        jout, = jfluid.Executor().run(jmain, feed=_mlp_feed(),
                                      fetch_list=[jloss])
    with fluid.scope_guard(tscope):
        tout, = fluid.Executor(CPU).run(tmain, feed=_mlp_feed(),
                                        fetch_list=[tloss])
    assert np.isfinite(tout).all()
    np.testing.assert_allclose(tout, jout, rtol=AMP_LOSS_RTOL)


def test_bf16_product_meets_f32_bias_as_f32():
    """A tagged mul's product is bf16 and the bias add promotes it back
    to f32, as in jnp: the fc output the loss reads is f32."""
    main, startup, _loss, _ = _build(fluid, tun, _mlp)
    fluid.amp.cast_model_to_bf16(main)
    ops = main.global_block().ops
    mul = next(op for op in ops if op.type == "mul")
    add = next(op for op in ops if op.type == "elementwise_add")
    exe = fluid.Executor(CPU)
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        prod, biased = exe.run(main, feed=_mlp_feed(),
                               fetch_list=[mul.output("Out")[0],
                                           add.output("Out")[0]],
                               return_numpy=False)
    assert prod.dtype == torch.bfloat16
    assert biased.dtype == torch.float32


def test_decorate_appends_the_jax_op_sequence_with_a_select():
    """decorate(Adam, dynamic scaling) appends JAX's ops op for op, with
    the same inputs and outputs, except that each gradient's
    elementwise_mul by the finite flag is a select_finite (C8)."""
    jmain, _js, _jl, _ = _build(jfluid, jun, _mlp, _amp_adam)
    tmain, _ts, _tl, _ = _build(fluid, tun, _mlp, _amp_adam)
    jops, tops = jmain.global_block().ops, tmain.global_block().ops
    assert len(jops) == len(tops)
    selects = 0
    for j, t in zip(jops, tops):
        if t.type == "select_finite":
            selects += 1
            assert j.type == "elementwise_mul"
            assert t.input("X") == j.input("X") == j.output("Out") \
                == t.output("Out")
            assert t.input("Finite") == j.input("Y")
            continue
        assert (t.type, t.inputs, t.outputs) == (j.type, j.inputs,
                                                 j.outputs)
        assert t.attrs.get("__amp_dtype__") == j.attrs.get("__amp_dtype__")
    assert selects == len(tmain.all_parameters()) == 4


def _bert_net(pkg, bert):
    cfg = bert.bert_tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    cfg.num_hidden_layers = 2

    def net(p):
        _f, loss, _mlm, _acc = bert.build_pretrain_net(cfg, seq_len=32)
        return loss
    return cfg, net


def _grads_close(jg, tg, names):
    gmax = max(float(np.abs(a).max()) for a in jg)
    for name, a, b in zip(names, jg, tg):
        assert a.shape == b.shape, name
        err = float(np.abs(a - b).max())
        bound = AMP_GRAD_TOL * float(np.abs(a).max()) + 1e-3 * gmax
        assert err <= bound, (name, err, bound)


def test_bert_tiny_amp_adam_matches_jax_executor():
    """Three steps of decorate(Adam(1e-3), 2**15, dynamic) on BERT-tiny
    (2 layers, dropout 0): losses, the first step's gradients, the loss
    scale and the good-step counter against the JAX Executor."""
    cfg, jnet = _bert_net(jfluid, jbert)
    _cfg, tnet = _bert_net(fluid, tbert)

    def opt(pkg):
        return _amp_adam(pkg, lr=1e-3, scale=2.0 ** 15)

    jmain, jstart, jloss, jopt = _build(jfluid, jun, jnet, opt)
    tmain, _ts, tloss, topt = _build(fluid, tun, tnet, opt)
    feed = tbert.make_pretrain_feed(cfg, 32, 4, seed=0)
    jscope, tscope = _start_both(jstart)
    gnames = [p.name + "@GRAD" for p in tmain.all_parameters()]
    scale = topt.get_loss_scaling().name
    good = topt._good_steps.name
    jexe, texe = jfluid.Executor(), fluid.Executor(CPU)
    for i in range(3):
        fetch = [jloss.name, scale, good] + (gnames if i == 0 else [])
        with jguard(jscope):
            jo = jexe.run(jmain, feed=feed, fetch_list=fetch)
        with fluid.scope_guard(tscope):
            to = texe.run(tmain, feed=feed, fetch_list=fetch)
        np.testing.assert_allclose(to[0], jo[0], rtol=AMP_LOSS_RTOL)
        assert float(to[1]) == float(jo[1]) == 2.0 ** 15
        assert float(to[2]) == float(jo[2]) == i + 1
        if i == 0:
            _grads_close(jo[3:], to[3:], gnames)


def test_mlp_trains_down_with_loss_scaling():
    """test_amp_fleet_utils.py:28 on the port from JAX's startup: 25
    steps of decorate(Adam(1e-2), 2**10, dynamic) take the loss below
    0.1 x the first; the first five losses within AMP_LOSS_RTOL of
    JAX's."""
    jmain, jstart, jloss, _ = _build(jfluid, jun, _mlp, _amp_adam)
    tmain, _ts, tloss, _ = _build(fluid, tun, _mlp, _amp_adam)
    jscope, tscope = _start_both(jstart)
    jl, tl = [], []
    jexe, texe = jfluid.Executor(), fluid.Executor(CPU)
    for i in range(25):
        if i < 5:
            with jguard(jscope):
                jl.append(float(jexe.run(jmain, feed=_mlp_feed(),
                                         fetch_list=[jloss])[0]))
        with fluid.scope_guard(tscope):
            tl.append(float(texe.run(tmain, feed=_mlp_feed(),
                                     fetch_list=[tloss])[0]))
    np.testing.assert_allclose(tl[:5], jl, rtol=AMP_LOSS_RTOL)
    assert tl[-1] < tl[0] * 0.1, tl[::6]


def _finite(scope, program):
    return {p.name: bool(np.isfinite(np.asarray(scope.get(p.name))).all())
            for p in program.all_parameters()}


def test_overflow_step_keeps_the_port_finite_where_jax_poisons():
    """One good step, then the loss-scaling var set to 3e38 for one step
    (the scaled loss overflows to inf). JAX's parameters turn non-finite
    (its multiply by the finite flag makes inf gradients NaN: a
    reference-side fact, pinned); the port's stay finite. Both decay the
    scale to 0.8 x 3e38 in f32 and reset the good-step counter to 0, and
    the port then trains on with finite losses."""
    jmain, jstart, jloss, jopt = _build(jfluid, jun, _mlp, _amp_adam)
    tmain, _ts, tloss, topt = _build(fluid, tun, _mlp, _amp_adam)
    jscope, tscope = _start_both(jstart)
    scale, good = topt.get_loss_scaling().name, topt._good_steps.name
    assert scale == jopt.get_loss_scaling().name
    jexe, texe = jfluid.Executor(), fluid.Executor(CPU)
    with jguard(jscope):
        jexe.run(jmain, feed=_mlp_feed(), fetch_list=[jloss])
        jscope.set(scale, jnp.asarray(np.float32(3e38)))
        jexe.run(jmain, feed=_mlp_feed(), fetch_list=[jloss])
    with fluid.scope_guard(tscope):
        texe.run(tmain, feed=_mlp_feed(), fetch_list=[tloss])
        tscope.set(scale, torch.tensor(3e38, dtype=torch.float32))
        texe.run(tmain, feed=_mlp_feed(), fetch_list=[tloss])
    want = np.float32(np.float32(3e38) * np.float32(0.8))
    assert float(np.asarray(jscope.get(scale))) == float(want)
    assert float(tscope.get(scale)) == float(want)
    assert float(np.asarray(jscope.get(good))) == 0.0
    assert float(tscope.get(good)) == 0.0
    assert not all(_finite(jscope, jmain).values())
    assert all(_finite(tscope, tmain).values())
    with fluid.scope_guard(tscope):
        after = [float(texe.run(tmain, feed=_mlp_feed(),
                                fetch_list=[tloss])[0]) for _ in range(3)]
    assert np.isfinite(after).all(), after


def test_rollback_hook_multiplies_the_scope_scale():
    """rollback_hook() scales the live loss-scaling var by decr_ratio
    (0.8), or by the factor given, as JAX's hook does."""
    tmain, tstart, _tl, topt = _build(fluid, tun, _mlp, _amp_adam)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor(CPU).run(tstart)
    name = topt.get_loss_scaling().name
    topt.rollback_hook()(scope, None)
    assert float(scope.get(name)) == pytest.approx(2.0 ** 10 * 0.8)
    topt.rollback_hook(0.5)(scope, None)
    assert float(scope.get(name)) == pytest.approx(2.0 ** 10 * 0.4)
    jmain, jstart, _jl, jopt = _build(jfluid, jun, _mlp, _amp_adam)
    jscope = JScope()
    with jguard(jscope):
        jfluid.Executor().run(jstart)
    jopt.rollback_hook(0.5)(jscope, None)
    assert float(np.asarray(jscope.get(name))) == pytest.approx(
        2.0 ** 10 * 0.5)
