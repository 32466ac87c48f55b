"""The port's static cost report (``observability/compile_insight.py``
``analyze_step`` / ``analyze_program`` / ``explain_entry``,
``Executor.explain`` and ``static_cost_analysis``) against the JAX
package, on the CPU.

Twins of ``tests/api/test_compile_insight.py:142,163,202`` (the Program
attribution, the static explain, the ledger and read-free check) on its
tiny GPT training Program (Adam, so optimizer moments exist), built in
both packages under ``unique_name.guard()`` with JAX's initialised scope
carried over. The port compiles nothing: ``backend=None`` and ``False``
give the static report, ``backend=True`` raises (JAX's behaviour on a
backend that reports nothing), ``compile_ms`` is None. The walk's column
is ``static["aten"]`` (JAX's ``static["jaxpr"]``); its products are held
to JAX's ``dot_general`` FLOPs exactly.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core import framework as jframework
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.observability import compile_insight as jci
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.observability import compile_insight as ci

SEQ = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _programs(fluid, framework, gpt):
    cfg = gpt.GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                        num_heads=2, inner_size=128, max_position=64,
                        dropout=0.0)
    main, startup = framework.Program(), framework.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.unique_name.guard(), framework.program_guard(main, startup):
        _tokens, loss, _logits = gpt.build_lm_net(cfg, seq_len=SEQ)
        fluid.optimizer.AdamOptimizer(learning_rate=1e-3).minimize(loss)
    return cfg, main, startup, loss


@pytest.fixture
def gpt_train():
    """test_compile_insight.py's gpt_train in both packages: the JAX
    startup's values carried into the port's scope. Returns (JAX main,
    JAX loss, JAX scope, port main, port loss, port executor, port scope,
    feed(b))."""
    _cfg, jmain, jstart, jloss = _programs(jfluid, jframework, jgpt)
    cfg, tmain, _tstart, tloss = _programs(tfluid, tframework, tgpt)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jfluid.Executor().run(jstart)
    tscope = tfluid.scope_from_numpy(
        {n: np.asarray(jscope.get(n)) for n in jscope.names()}, "cpu")
    rng = np.random.default_rng(0)

    def feed(b=4):
        return {"tokens": rng.integers(0, cfg.vocab_size, (b, SEQ),
                                       dtype=np.int64)}

    exe = tfluid.Executor(tfluid.CPUPlace())
    yield jmain, jloss, jscope, tmain, tloss, exe, tscope, feed
    exe.close()


def test_analyze_program_attribution(gpt_train):
    jmain, _jl, jscope, tmain, _tl, _exe, tscope, feed = gpt_train
    f = feed(4)
    state = {n: tscope.get(n) for n in tscope.names()}
    feeds = {k: torch.from_numpy(v) for k, v in f.items()}
    rep = ci.analyze_program(tmain, feeds=feeds, state=state)
    assert rep["train"] and rep["batch_size"] == 4
    assert rep["flops"] == 3 * rep["fwd_flops"] > 0
    assert rep["per_op_type"]           # mul/matmul attribution exists
    # Adam: two moment tensors per param -> optimizer ~2x param bytes
    assert rep["param_bytes"] > 0
    assert rep["optimizer_bytes"] > 1.5 * rep["param_bytes"]
    # the port keeps int64 ids on the device (JAX feeds int32)
    assert rep["feed_bytes"] == 4 * 16 * 8
    assert rep["activation_bytes"] > 0
    jstate = {n: jscope.get(n) for n in jscope.names()}
    jrep = jci.analyze_program(
        jmain, feeds={k: np.asarray(v, np.int32) for k, v in f.items()},
        state=jstate)
    for key in ("fwd_flops", "flops", "per_op_type", "param_bytes",
                "optimizer_bytes", "activation_bytes", "num_ops"):
        assert rep[key] == jrep[key], key


def test_explain_gpt_static(gpt_train):
    """explain() returns flops / bytes / peak memory for a GPT Program
    from the static walk; its products are JAX's exactly."""
    jmain, jloss, jscope, tmain, tloss, exe, tscope, feed = gpt_train
    f = feed()
    rep = exe.explain(tmain, feed=f, fetch_list=[tloss], scope=tscope,
                      backend=False)
    assert rep["source"] == {"flops": "static", "bytes": "static",
                             "peak_hbm": "static"}
    assert rep["backend"] == "cpu"
    assert rep["flops"] > 0
    assert rep["bytes_accessed"] > 0
    assert rep["peak_hbm_bytes"] > 0
    assert rep["xla"] == {"cost": None, "memory": None}
    assert rep["memory"]["param_bytes"] > 0
    assert rep["memory"]["optimizer_bytes"] > rep["memory"]["param_bytes"]
    # peak must at least hold the resident state it closes over
    assert rep["peak_hbm_bytes"] >= (rep["memory"]["param_bytes"]
                                     + rep["memory"]["optimizer_bytes"])
    walk = rep["static"]["aten"]
    assert walk["per_primitive"].get("aten.mm", 0) > 0
    # FlopCounterMode counts the products; they are the whole count
    assert sum(walk["per_primitive"].values()) == rep["flops"]
    assert rep["static"]["program"]["per_op_type"] == \
        ci.analyze_program(tmain, state=dict(
            (n, tscope.get(n)) for n in tscope.names()),
            feeds=f)["per_op_type"]
    jexe = jfluid.Executor()
    with jfluid.scope_guard(jscope):
        jrep = jexe.explain(jmain, feed={k: np.asarray(v, np.int32)
                                         for k, v in f.items()},
                            fetch_list=[jloss], backend=False)
    assert rep["flops"] == jrep["static"]["jaxpr"]["per_primitive"][
        "dot_general"]
    assert set(rep) >= set(jrep) - {"recompiles"}
    assert set(rep["static"]) == (set(jrep["static"]) - {"jaxpr"}) | {
        "aten"}


def test_explain_backend_auto_and_true(gpt_train):
    _jm, _jl, _js, tmain, tloss, exe, tscope, feed = gpt_train
    rep = exe.explain(tmain, feed=feed(), fetch_list=[tloss], scope=tscope)
    assert rep["flops"] > 0 and rep["peak_hbm_bytes"] > 0
    assert rep["source"]["flops"] == "static"
    assert rep["fetches"] == [tloss.name]
    with pytest.raises(RuntimeError, match="backend=None"):
        exe.explain(tmain, feed=feed(), fetch_list=[tloss], scope=tscope,
                    backend=True)


def test_explain_registers_peak_in_ledger_and_reads_nothing(gpt_train):
    _jm, _jl, _js, tmain, tloss, exe, tscope, feed = gpt_train
    exe.run(tmain, feed=feed(6), fetch_list=[tloss], scope=tscope)
    steps_before = exe.get_stats()["steps"]
    counter = exe._step_counter
    versions = {n: tscope.get(n)._version for n in tscope.names()}
    values = {n: tscope.get(n).clone() for n in tscope.names()}
    rep = exe.explain(tmain, feed=feed(6), fetch_list=[tloss],
                      scope=tscope, backend=False)
    # read-free: no step ran, nothing in the scope was written
    assert exe.get_stats()["steps"] == steps_before
    assert exe._step_counter == counter
    assert {n: tscope.get(n)._version for n in tscope.names()} == versions
    assert all(torch.equal(values[n], tscope.get(n)) for n in values)
    # the port compiles no step
    assert rep["compile_ms"] is None and rep["recompiles"] == []
    own = ci.hbm_ledger().component_bytes(exe._exe_id)
    assert own.get("peak_hbm") == rep["peak_hbm_bytes"]
    # the same static walk of the step that just ran
    cost = exe.static_cost_analysis()
    assert cost["flops"] == rep["flops"]
    assert cost["per_primitive"] == rep["static"]["aten"]["per_primitive"]


def test_analyze_step_counts_products_and_fresh_bytes():
    """analyze_step on a function of its own: an (8, 16) x (16, 4)
    product is 2 * 8 * 4 * 16 FLOPs; the sum allocates its f32 scalar
    output; in-place results and views allocate nothing."""

    def f(a, b):
        c = a @ b
        c.add_(1.0)
        return c.t().sum()

    rep = ci.analyze_step(f, torch.ones(8, 16), torch.ones(16, 4))
    assert rep["per_primitive"] == {"aten.mm": 1024}
    assert rep["flops"] == 1024
    assert rep["out_bytes"] == 4
    # only the product's (8, 4) f32 is an intermediate
    assert rep["intermediate_bytes"] == 8 * 4 * 4



def _recompute_program(policy):
    """The port's tiny GPT training Program of ``_programs`` with Adam
    under ``RecomputeOptimizer(policy)``: the same parameter names."""
    cfg = tgpt.GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                         num_heads=2, inner_size=128, max_position=64,
                         dropout=0.0)
    main, startup = tframework.Program(), tframework.Program()
    main.random_seed = startup.random_seed = 7
    with tfluid.unique_name.guard(), tframework.program_guard(main,
                                                              startup):
        _tokens, loss, _logits = tgpt.build_lm_net(cfg, seq_len=SEQ)
        tfluid.optimizer.RecomputeOptimizer(
            tfluid.optimizer.AdamOptimizer(learning_rate=1e-3),
            policy=policy).minimize(loss)
    return main, loss


@pytest.mark.parametrize("policy", ["dots", "nothing"])
def test_explain_walks_the_recompute_policy(gpt_train, policy):
    """explain() walks the step the Executor runs: under a recompute
    policy the backward re-runs the checkpointed forward. A product's
    backward costs twice its forward, so the plain step counts 3 x the
    forward's FLOPs of each aten product. "dots" saves ``mm`` /
    ``addmm`` and recomputes the attention's ``bmm`` (4 x); "nothing"
    saves no product: the ``bmm`` run 4 x, and the ``mm`` more than 3 x
    (torch's checkpoint stops a segment's recompute once its saved
    tensors are back, so not every ``mm`` runs again). Read-free under
    the policy too."""
    _jm, _jl, _js, tmain, tloss, exe, tscope, feed = gpt_train
    f = feed()
    plain = exe.explain(tmain, feed=f, fetch_list=[tloss], scope=tscope)
    rmain, rloss = _recompute_program(policy)
    assert rmain._recompute == {"policy": policy}
    counter = exe._step_counter
    versions = {n: tscope.get(n)._version for n in tscope.names()}
    rep = exe.explain(rmain, feed=f, fetch_list=[rloss], scope=tscope)
    assert exe._step_counter == counter
    assert {n: tscope.get(n)._version for n in tscope.names()} == versions
    base = plain["static"]["aten"]["per_primitive"]
    assert set(base) == {"aten.mm", "aten.bmm"}
    assert all(v % 3 == 0 for v in base.values())
    got = rep["static"]["aten"]["per_primitive"]
    assert got["aten.bmm"] == base["aten.bmm"] // 3 * 4
    if policy == "dots":
        assert got["aten.mm"] == base["aten.mm"]
    else:
        assert base["aten.mm"] < got["aten.mm"] < base["aten.mm"] // 3 * 4


def test_the_last_step_keeps_no_tensor_and_no_scope(gpt_train):
    """run() keeps for static_cost_analysis() only the feeds' shapes and
    dtypes and a weak reference to the scope: no feed tensor and no
    scope stays alive past the step for it."""
    import gc
    _jm, _jl, _js, tmain, tloss, exe, tscope, feed = gpt_train
    scope = tfluid.scope_from_numpy(
        {n: tscope.get(n).numpy() for n in tscope.names()}, "cpu")
    exe.run(tmain, feed=feed(6), fetch_list=[tloss], scope=scope)
    program, feeds, fetches, _ref = exe._last_step
    assert feeds == {"tokens": ((6, SEQ), torch.int64)}
    assert fetches == [tloss.name]
    assert exe.static_cost_analysis()["flops"] > 0
    del scope
    gc.collect()
    with pytest.raises(RuntimeError, match="scope of the last step"):
        exe.static_cost_analysis()
