"""GPT training through the port's Fluid entry points, against the JAX
package, on the CPU.

Twins of ``tests/models/test_gpt.py`` and ``tests/api/test_executor_basic.py``
on ``gpt_tiny`` (seq 16, batch 4) and an MLP recipe. Both packages build the
same Program (under fresh unique-name generators, so every variable has the
same name in both); JAX runs the startup, ``scope_from_numpy`` carries its
scope into the port, and both run the same Adam steps on the same feed. The
JAX Executor traces each step into one jitted XLA program; the port's
Executor runs the ops eagerly with torch autograd, on the CPU
(``Executor(CPUPlace())``), where attention takes the plain dense path as
JAX's does off the TPU. Tolerances: losses within 1e-5 relative per step
(f32, the same math in another summation order, compounded over 5 Adam
steps); the first step's gradients within 1e-4 relative plus 1e-6
absolute (the floor for gradients that are 0 in exact arithmetic, such as
the key projection's bias, where both sides hold ~1e-9 of rounding noise).

One case sets ``PADDLE_TPU_FORCE_FLASH=1`` (test-local, monkeypatch) so
that the JAX side runs its Pallas flash forward and backward in interpret
mode. The port alone: the memorization gate, ``clone(for_test=True)``
logits against ``build_kv_step``, ``gpt.generate(scope, ...)`` regenerating
a memorized sequence, fetching ``w@GRAD``, the test program's pruning, and
Adam against the reference formula of ``test_optimizer_parity.py``. The
port's startup draws its own random numbers (torch generators, not JAX's
keys), so its runs are held to the reference's gates, not to its values.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core import unique_name as jun
from paddle_tpu.core.executor import Scope as JScope, scope_guard as jguard
from paddle_tpu.models import gpt as jgpt

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers
from paddle_tpu_torch.core import unique_name as tun
from paddle_tpu_torch.inference import decoding as dec
from paddle_tpu_torch.models import gpt as tgpt

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


def _gpt_net(pkg, gpt, cfg, seq_len, lr):
    tokens, loss, logits = gpt.build_lm_net(cfg, seq_len=seq_len)
    pkg.optimizer.AdamOptimizer(lr).minimize(loss)
    return loss, logits


def _mlp_net(pkg, _gpt, _cfg, _seq_len, lr):
    lay = pkg.layers
    x = lay.data("x", shape=[12], dtype="float32")
    label = lay.data("label", shape=[1], dtype="int64")
    h = lay.fc(x, size=16, act="gelu")
    logits = lay.fc(h, size=5)
    loss = lay.mean(lay.softmax_with_cross_entropy(logits, label))
    pkg.optimizer.AdamOptimizer(lr).minimize(loss)
    return loss, logits


def _build(pkg, gpt, un, net, cfg=None, seq_len=16, lr=2e-3, seed=7):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with un.guard(), pkg.program_guard(main, startup):
        loss, logits = net(pkg, gpt, cfg, seq_len, lr)
    return main, startup, loss, logits


def _twins(net, cfg, feed, steps, monkeypatch=None, flash=False):
    """Build the net in both packages, start it in JAX, carry the scope
    over, run `steps` steps in both. Returns (jax losses, port losses, jax
    first-step grads, port first-step grads, grad names)."""
    if flash:
        monkeypatch.setenv("PADDLE_TPU_FORCE_FLASH", "1")
    jmain, jstart, jloss, _ = _build(jfluid, jgpt, jun, net, cfg)
    tmain, _tstart, tloss, _ = _build(fluid, tgpt, tun, net, cfg)
    jscope, jexe = JScope(), jfluid.Executor()
    with jguard(jscope):
        jexe.run(jstart)
    tscope = fluid.scope_from_numpy(
        {n: np.asarray(jscope.get(n)) for n in jscope.names()}, "cpu")
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
        jl.append(float(jo[0]))
        tl.append(float(to[0]))
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


def _tokens(cfg, batch=4, seq_len=16, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(3, cfg.vocab_size, (batch, seq_len)).astype("int64")


def test_gpt_adam_steps_match_jax_executor():
    cfg = tgpt.gpt_tiny()
    jl, tl, jg, tg, gnames = _twins(_gpt_net, cfg,
                                    {"tokens": _tokens(cfg)}, 5)
    assert jl[-1] < jl[0]
    _check_twins(jl, tl, jg, tg, gnames)


def test_gpt_steps_match_jax_pallas_flash(monkeypatch):
    """The JAX side through its Pallas flash forward and backward
    (interpret mode), the port through its plain attention."""
    cfg = tgpt.gpt_tiny()
    _check_twins(*_twins(_gpt_net, cfg, {"tokens": _tokens(cfg)}, 2,
                         monkeypatch, flash=True))


def test_mlp_recipe_matches_jax_executor():
    rng = np.random.RandomState(3)
    feed = {"x": rng.randn(8, 12).astype(np.float32),
            "label": rng.randint(0, 5, (8, 1)).astype("int64")}
    jl, tl, jg, tg, gnames = _twins(_mlp_net, None, feed, 5)
    assert len(gnames) == 4
    _check_twins(jl, tl, jg, tg, gnames)


def test_startup_program_matches_jax_op_for_op():
    """The same init ops (26 uniform_random, 315 fill_constant at gpt_tiny
    with Adam) with the same attributes, outputs and seeds."""
    cfg = tgpt.gpt_tiny()
    _, jstart, _, _ = _build(jfluid, jgpt, jun, _gpt_net, cfg)
    _, tstart, _, _ = _build(fluid, tgpt, tun, _gpt_net, cfg)
    jops, tops = jstart.global_block().ops, tstart.global_block().ops
    assert [o.to_desc() for o in tops] == [o.to_desc() for o in jops]
    kinds = [o.type for o in tops]
    assert kinds.count("uniform_random") == 26
    assert kinds.count("fill_constant") == 315


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------

def _train(steps=80, seq_len=16, batch=4, lr=2e-3, seed=0):
    """tests/models/test_gpt.py's _train on the port, on the CPU."""
    cfg = tgpt.gpt_tiny()
    toks = _tokens(cfg, batch, seq_len, seed)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup):
        _tokens_var, loss, logits = tgpt.build_lm_net(cfg, seq_len=seq_len)
        fluid.optimizer.AdamOptimizer(lr).minimize(loss)
    scope = fluid.Scope()
    exe = fluid.Executor(CPU)
    losses = []
    with fluid.scope_guard(scope):
        exe.run(startup)
        for _ in range(steps):
            out = exe.run(main, feed={"tokens": toks}, fetch_list=[loss])
            losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
    return cfg, scope, main, toks, losses, logits


def test_gpt_memorizes_fixed_batch():
    _cfg, _scope, _main, _toks, losses, _l = _train()
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.05 * losses[0], (losses[0], losses[-1])


def test_cached_decode_matches_training_forward():
    """build_kv_step over the scope's parameters reproduces the test
    program's logits position by position (teacher forcing)."""
    cfg, scope, main, toks, _losses, logits_var = _train(steps=3)
    seq_len = toks.shape[1]
    test_prog = main.clone(for_test=True)
    with fluid.scope_guard(scope):
        full = fluid.Executor(CPU).run(test_prog, feed={"tokens": toks},
                                       fetch_list=[logits_var])[0]
    step = tgpt.build_kv_step(tgpt.load_params(scope, cfg), cfg, seq_len)
    d = cfg.hidden_size // cfg.num_heads
    cache = dec.init_kv_cache(toks.shape[0], cfg.num_layers, cfg.num_heads,
                              seq_len, d, device="cpu")
    with torch.no_grad():
        for t in range(seq_len):
            out, cache = step(torch.from_numpy(toks[:, t]), cache, t)
            np.testing.assert_allclose(out.numpy(), full[:, t], rtol=2e-4,
                                       atol=2e-4, err_msg=f"position {t}")


@pytest.fixture(scope="module")
def memorized():
    """tests/models/test_gpt.py's overfit of one 12-token sequence."""
    cfg, scope, _main, toks, losses, _l = _train(
        steps=120, batch=1, seq_len=12, lr=3e-3, seed=2)
    assert losses[-1] < 0.02, losses[-1]
    return cfg, scope, toks


def test_greedy_generation_reproduces_memorized_sequence(memorized):
    """Greedy decode from the first token through gpt.generate(scope, ...)
    regenerates the rest; with a 4-token prompt (the parallel prefill) the
    continuation after it."""
    cfg, scope, toks = memorized
    ids, _scores = tgpt.generate(scope, cfg, toks[:1, 0], max_len=11)
    np.testing.assert_array_equal(ids.numpy()[0], toks[0, 1:])
    ids, _scores = tgpt.generate(scope, cfg, prompt_ids=toks[:1, :4],
                                 max_len=12)
    np.testing.assert_array_equal(ids.numpy()[0], toks[0, 4:])


def test_beam_generation_top_beam_matches_greedy(memorized):
    cfg, scope, toks = memorized
    ids_g, _ = tgpt.generate(scope, cfg, toks[:1, 0], max_len=11)
    ids_b, scores = tgpt.generate(scope, cfg, toks[:1, 0], max_len=11,
                                  beam_size=2)
    assert tuple(ids_b.shape) == (1, 2, 11)
    np.testing.assert_array_equal(ids_b.numpy()[0, 0], ids_g.numpy()[0])
    assert float(scores[0, 0]) >= float(scores[0, 1])


def _fresh():
    return fluid.Program(), fluid.Program(), fluid.Scope()


def test_fetch_gradient():
    """tests/api/test_executor_basic.py::test_fetch_gradient: d mean(x w)
    / dw[i, j] = mean over the batch of x[:, i] / 3."""
    main, startup, scope = _fresh()
    with fluid.program_guard(main, startup):
        x = layers.data("x", shape=[3], dtype="float32")
        w = layers.create_parameter([3, 3], "float32", name="w_fetchgrad")
        out = layers.mean(layers.matmul(x, w))
        fluid.append_backward(out)
    exe = fluid.Executor(CPU)
    xs = np.random.RandomState(4).randn(2, 3).astype(np.float32)
    with fluid.scope_guard(scope):
        exe.run(startup)
        g, = exe.run(main, feed={"x": xs}, fetch_list=["w_fetchgrad@GRAD"])
    expect = np.repeat(xs.mean(0)[:, None], 3, axis=1) / (2 * 3) * 2
    np.testing.assert_allclose(g, expect, rtol=1e-5)


def test_clone_for_test_prunes_backward_and_optimizer():
    """The test program drops the marker and the optimizer ops, needs only
    the feeds of what it fetches, and leaves the parameters as they were;
    a forward-only program runs the fetch's slice alone."""
    main, startup, scope = _fresh()
    with fluid.program_guard(main, startup):
        x = layers.data("x", shape=[4], dtype="float32")
        y = layers.data("y", shape=[4], dtype="float32")
        hidden = layers.fc(x, size=2)
        unused = layers.fc(y, size=2)
        loss = layers.mean(layers.elementwise_add(hidden, unused))
        test_prog = main.clone(for_test=True)
        fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
    assert test_prog.backward_marker() is None
    assert main.backward_marker() is not None
    assert not any(op.type == "sgd" for op in test_prog.global_block().ops)
    exe = fluid.Executor(CPU)
    xs = np.ones((3, 4), np.float32)
    with fluid.scope_guard(scope):
        exe.run(startup)
        before = {n: np.array(scope.get(n)) for n in scope.names()}
        h, = exe.run(test_prog, feed={"x": xs}, fetch_list=[hidden])
        assert h.shape == (3, 2)
        for n, v in before.items():
            np.testing.assert_array_equal(np.array(scope.get(n)), v)
        with pytest.raises(ValueError, match="'y'"):
            exe.run(test_prog, feed={"x": xs}, fetch_list=[loss])
        exe.run(main, feed={"x": xs, "y": xs}, fetch_list=[loss])
        assert any(not np.array_equal(np.array(scope.get(n)), v)
                   for n, v in before.items())


def test_adam_reference_formula():
    """tests/api/test_optimizer_parity.py::test_adam_reference_formula on
    the port: a loss whose gradient is the feed (x . w), three steps of
    fluid's adam formula in numpy."""
    lr, b1, b2, eps, dim = 0.1, 0.9, 0.999, 1e-8, 4
    main, startup, scope = _fresh()
    startup.random_seed = 9
    with fluid.program_guard(main, startup):
        x = layers.data("x", shape=[dim], dtype="float32")
        w = layers.create_parameter(
            [dim, 1], "float32", name="w",
            default_initializer=fluid.initializer.NormalInitializer(0, 1))
        loss = layers.mean(layers.matmul(x, w))
        fluid.optimizer.AdamOptimizer(lr, beta1=b1, beta2=b2,
                                      epsilon=eps).minimize(loss)
    exe = fluid.Executor(CPU)
    rs = np.random.RandomState(5)
    grads = [rs.randn(dim).astype(np.float32) for _ in range(3)]
    with fluid.scope_guard(scope):
        exe.run(startup)
        w0 = np.array(scope.get("w"))[:, 0]
        for g in grads:
            exe.run(main, feed={"x": g.reshape(1, dim)}, fetch_list=[loss])
        got = np.array(scope.get("w"))[:, 0]
    want = w0.astype(np.float64)
    m = np.zeros(dim)
    v = np.zeros(dim)
    b1p = b2p = 1.0
    for g in grads:
        b1p *= b1
        b2p *= b2
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        want = want - lr * np.sqrt(1 - b2p) / (1 - b1p) * m / (np.sqrt(v)
                                                             + eps)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_random_ops_draw_per_seed_and_step():
    """The startup's random inits are a function of (program seed, op
    seed): the same seed gives the same parameters, another seed others;
    a dropout mask changes with the step."""
    def start(seed):
        main, startup, scope = _fresh()
        startup.random_seed = seed
        with tun.guard(), fluid.program_guard(main, startup):
            layers.fc(layers.data("x", shape=[8], dtype="float32"), size=8)
        with fluid.scope_guard(scope):
            fluid.Executor(CPU).run(startup)
        return {n: np.array(scope.get(n)) for n in scope.names()}

    a, b, c = start(3), start(3), start(4)
    w = [n for n in a if n.endswith(".w_0")][0]
    np.testing.assert_array_equal(a[w], b[w])
    assert not np.array_equal(a[w], c[w])

    main, startup, scope = _fresh()
    with fluid.program_guard(main, startup):
        x = layers.data("x", shape=[64], dtype="float32")
        out = layers.dropout(x, 0.5)
    exe = fluid.Executor(CPU)
    feed = {"x": np.ones((4, 64), np.float32)}
    with fluid.scope_guard(scope):
        m1, = exe.run(main, feed=feed, fetch_list=[out])
        m2, = exe.run(main, feed=feed, fetch_list=[out])
    assert set(np.unique(m1)) <= {0.0, 1.0} and 0 < m1.mean() < 1
    assert not np.array_equal(m1, m2)


def test_executor_defaults_to_the_card():
    if torch.cuda.is_available():
        assert fluid.Executor().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        fluid.Executor()
    with pytest.raises(RuntimeError, match="CUDA"):
        fluid.Executor(fluid.CUDAPlace(0))
    assert fluid.Executor(CPU).device.type == "cpu"
