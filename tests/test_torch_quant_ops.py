"""The port's fake-quantization ops against the JAX package, on the CPU:
the 11 names of ``ops/quant_ops.py`` that ROADMAP item 10c.6f ports,
each forward and, where it is differentiable, with the gradient of one
seeded cotangent (``test_torch_seq2seq.op_twin``), and through both
Executors.

Cases mirror ``tests/api/test_quant_slim.py``'s op-level tests,
``tests/ops/test_uncovered_ops_r4c.py:88,119`` and
``tests/ops/test_audit_gap_ops.py:199``, with each trouble point of the
slice: the gradient at the clip bound (the abs-max element sits on it:
``jnp.clip``'s backward splits the tie half and half between x and the
scale, ``torch.clamp``'s would not), ties of two maxima (``amax`` splits
them evenly, as ``jnp.max``), rounding half to even, the moving-average
scale accumulating across ``Executor.run`` calls and frozen under
``is_test``, ``range_abs_max`` adopting the batch's abs-max while its
state is 0, and the channel-wise dequantization over a list of scales.
The dp cases run small Programs at dp 2 on a local CPU mesh against the
plain Executor (the global batch's abs-max: one dp max), and each
refusal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu.core import unique_name as jun
from paddle_tpu.core.executor import Scope as JScope, scope_guard as jguard
from paddle_tpu.ops import quant_ops as jq

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.core import unique_name as tun
from paddle_tpu_torch.core.layer_helper import LayerHelper
from paddle_tpu_torch.ops import _DP_RULES, _REGISTRY as TREG
from paddle_tpu_torch.ops import quant_ops as tq

from test_torch_seq2seq import op_twin

CPU = fluid.CPUPlace()
# f32 outputs within 1e-6 relative of the output's largest entry (the
# fake quant is a handful of elementwise f32 operations in the same order
# in both packages; a Program's fc in another summation order: measured
# at most 2.1e-7); gradients of a seeded cotangent within 1e-5 of the
# gradient's largest entry (the scale's gradient through the abs-max sums
# in another order: measured at most 2.8e-7); integer outputs equal
RTOL = 1e-6
GRAD_TOL = 1e-5
# dp 2 against dp 1: each rank's rows in another summation order
DP_TOL = 1e-6

RS = np.random.RandomState(25)

QUANT_OPS = [
    "fake_channel_wise_dequantize_max_abs",
    "fake_channel_wise_quantize_abs_max",
    "fake_channel_wise_quantize_dequantize_abs_max",
    "fake_dequantize_max_abs", "fake_quantize_abs_max",
    "fake_quantize_dequantize_abs_max",
    "fake_quantize_dequantize_moving_average_abs_max",
    "fake_quantize_moving_average_abs_max", "fake_quantize_range_abs_max",
    "moving_average_abs_max_scale", "quantize_dequantize_static_scale"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_bert.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _r(*shape, lo=-1.0, hi=1.0):
    return RS.uniform(lo, hi, shape).astype(np.float32)


def close(got, want, rtol=RTOL, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=name)


def grads_close(grads, tol=GRAD_TOL):
    for k, (jg, tg) in grads.items():
        for a, b in zip(tg if isinstance(tg, list) else [tg],
                        jg if isinstance(jg, list) else [jg]):
            a, b = np.asarray(a), np.asarray(b)
            scale = max(float(np.abs(b).max()), 1e-12)
            np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale,
                                       err_msg=k)


def test_the_slice_registers_every_quant_op_with_a_dp_rule():
    assert len(QUANT_OPS) == 11
    assert sorted(n for n in jfluid.ops._REGISTRY
                  if n in QUANT_OPS) == QUANT_OPS
    for name in QUANT_OPS:
        assert name in TREG and _DP_RULES[name] is not None, name


# ---------------------------------------------------------------------------
# op twins
# ---------------------------------------------------------------------------

def _cases():
    x = _r(6, 7, lo=-3, hi=3)
    w = _r(5, 3, 3, 3)
    ema_in = {"X": x, "InScale": np.array([1.5], np.float32)}
    return {
        "fake_quantize_abs_max": ({"X": x}, {"bit_length": 8}, "Out",
                                  ("X",)),
        "fake_quantize_dequantize_abs_max": ({"X": x}, {"bit_length": 4},
                                             "Out", ("X",)),
        "fake_channel_wise_quantize_abs_max": (
            {"X": w}, {"bit_length": 8, "quant_axis": 0}, "Out", ("X",)),
        "fake_channel_wise_quantize_dequantize_abs_max": (
            {"X": _r(4, 6)}, {"bit_length": 8, "quant_axis": 1}, "Out",
            ("X",)),
        "quantize_dequantize_static_scale": (
            {"X": x}, {"bit_length": 8, "scale": 2.2}, "Out", ("X",)),
        "fake_quantize_moving_average_abs_max": (
            ema_in, {"moving_rate": 0.9}, "Out", ("X", "InScale")),
        "fake_quantize_dequantize_moving_average_abs_max": (
            ema_in, {"moving_rate": 0.8, "bit_length": 6}, "Out",
            ("X", "InScale")),
        "fake_quantize_range_abs_max": (
            {"X": x, "InScale": np.array([0.0], np.float32)},
            {"moving_rate": 0.9}, "Out", ("X",)),
        "moving_average_abs_max_scale": (
            {"X": x, "InScale": np.array([2.0], np.float32)},
            {"moving_rate": 0.5}, "OutScale", ("X", "InScale")),
        "fake_dequantize_max_abs": (
            {"X": np.round(x * 40), "Scale": np.array([0.5], np.float32)},
            {"max_range": 127.0}, "Out", ()),
        "fake_channel_wise_dequantize_max_abs": (
            {"X": np.round(w * 100),
             "Scales": [np.abs(_r(5)) + 0.1, np.float32(3.0)]},
            {"quant_bits": [8, 8], "quant_axis": 0}, "Out", ()),
    }


@pytest.mark.parametrize("op", QUANT_OPS)
def test_op_against_jax(op):
    ins, attrs, slot, grad = _cases()[op]
    j, t, grads = op_twin(op, ins, attrs, slot, grad=grad)
    close(t, j, name=op)
    grads_close(grads)


@pytest.mark.parametrize("op", [
    "fake_quantize_abs_max", "fake_channel_wise_quantize_abs_max",
    "fake_quantize_moving_average_abs_max", "fake_quantize_range_abs_max"])
def test_scales_against_jax(op):
    """OutScale of each scale-producing op (and its gradient: the scale
    keeps its gradient through the abs-max, as in JAX)."""
    ins, attrs, _slot, grad = _cases()[op]
    j, t, grads = op_twin(op, ins, attrs, "OutScale", grad=("X",))
    close(t, j, name=op)
    grads_close(grads)


def test_gradient_at_the_clip_tie():
    """x = [0.3, -1.7, 0.9, 1.7, 0.05] weighted 1..5: the abs-max 1.7
    sits on both clip bounds. JAX's gradient splits each tie half and half
    between x and the scale: [1, 0.4992, 3, 2.5008, 5]; torch.clamp would
    pass the whole of it to x ([1, 1.9992, 3, 4.0008, 5])."""
    x = np.array([0.3, -1.7, 0.9, 1.7, 0.05], np.float32)
    wts = np.arange(1, 6, dtype=np.float32)

    def jf(v):
        return jnp.sum(jq.quant_dequant(v, jq.abs_max(v), 8) * wts)

    want = np.asarray(jax.grad(jf)(jnp.asarray(x)))
    np.testing.assert_allclose(want, [1, 0.4992, 3, 2.5008, 5], atol=1e-4)
    tx = torch.tensor(x, requires_grad=True)
    (tq.quant_dequant(tx, tq.abs_max(tx), 8) * torch.from_numpy(wts)).sum()\
        .backward()
    np.testing.assert_allclose(tx.grad.numpy(), want, rtol=1e-6, atol=1e-6)
    clamp = torch.tensor(x, requires_grad=True)
    s = tq.abs_max(clamp)
    out = tq._SteRound.apply(torch.clamp(clamp, -s.item(), s.item()) / s
                             * 127) * s / 127
    (out * torch.from_numpy(wts)).sum().backward()
    assert abs(float(clamp.grad[1]) - 1.9992) < 1e-3


@pytest.mark.parametrize("op,ins,attrs", [
    ("fake_quantize_dequantize_abs_max",
     {"X": np.array([[2.0, -0.5, -2.0], [1.0, 2.0, 0.25]], np.float32)}, {}),
    ("fake_channel_wise_quantize_dequantize_abs_max",
     {"X": np.array([[3.0, -3.0, 1.0], [0.5, -2.0, 2.0]], np.float32)},
     {"quant_axis": 0}),
    ("fake_quantize_dequantize_moving_average_abs_max",
     {"X": np.array([[2.0, -2.0], [1.0, 0.5]], np.float32),
      "InScale": np.array([2.0], np.float32)}, {"moving_rate": 0.5})])
def test_ties_of_two_maxima(op, ins, attrs):
    """Several entries at the abs-max (of the tensor or of a channel):
    amax splits the scale's gradient evenly among them, as jnp.max does,
    so each tied entry's gradient equals JAX's."""
    j, t, grads = op_twin(op, ins, attrs, "Out", grad=tuple(ins))
    close(t, j, name=op)
    grads_close(grads)


def test_round_half_to_even():
    """x / s x qmax exactly on .5: torch.round and jnp.round both go to
    the even neighbour (floor(x + 0.5) would not)."""
    qmax = 127.0
    x = (np.array([0.5, 1.5, 2.5, -0.5, -2.5, 3.5], np.float32)
         / qmax).astype(np.float32)
    j, t, _ = op_twin("quantize_dequantize_static_scale", {"X": x},
                      {"scale": 1.0}, "Out")
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(np.round(t * qmax), [0, 2, 2, -0, -2, 4])


def test_quant_dequant_error_bound_and_ste():
    """tests/api/test_quant_slim.py:21,32,42: the error within one step at
    8 and 4 bits; the gradient 1 inside the range, 0 outside it; the
    channel-wise scales."""
    x = torch.linspace(-2, 2, 101)
    for bits, qmax in ((8, 127), (4, 7)):
        got = tq.quant_dequant(x, torch.tensor(2.0), bits)
        assert float((got - x).abs().max()) <= 2.0 / qmax + 1e-6
    for v, want in (([0.3, -0.9, 0.5], 1.0), ([1.7, -3.0], 0.0)):
        t = torch.tensor(v, requires_grad=True)
        tq.quant_dequant(t, torch.tensor(1.0)).sum().backward()
        np.testing.assert_allclose(t.grad.numpy(), want)
    w = np.stack([np.full((3, 3), 0.1, np.float32),
                  np.full((3, 3), 5.0, np.float32)])
    np.testing.assert_allclose(tq.channel_abs_max(torch.from_numpy(w), 0),
                               [0.1, 5.0])


class _Ctx:
    """A direct op call's context (the JAX tests' _run_kernel)."""

    def __init__(self, ins, attrs, is_test=False):
        self._ins, self._attrs, self.is_test = ins, attrs, is_test

    def in_(self, slot, default=None):
        return self._ins.get(slot, default)

    def in_list(self, slot):
        v = self._ins.get(slot, [])
        return v if isinstance(v, list) else [v]

    def has_in(self, slot):
        return slot in self._ins

    def attr(self, name, default=None):
        return self._attrs.get(name, default)


def _run_kernel(op, ins, attrs, is_test=False):
    t = {k: [torch.tensor(np.asarray(e, np.float32)) for e in v]
         if isinstance(v, list) else torch.tensor(np.asarray(v, np.float32))
         for k, v in ins.items()}
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in TREG[op](_Ctx(t, attrs, is_test)).items()}


def test_range_abs_max_train_and_test():
    """test_uncovered_ops_r4c.py:88: a zero InScale adopts the batch's
    abs-max; later an EMA; is_test keeps InScale."""
    x = np.array([-3.0, 0.5, 2.0], np.float32)
    got = _run_kernel("fake_quantize_range_abs_max",
                      {"X": x, "InScale": np.float32(0.0)},
                      dict(bit_length=8, moving_rate=0.9))
    assert got["OutScale"] == pytest.approx(3.0)
    np.testing.assert_allclose(got["Out"],
                               np.round(x / 3.0 * 127.0) / 127.0 * 3.0,
                               rtol=1e-5)
    got2 = _run_kernel("fake_quantize_range_abs_max",
                       {"X": x, "InScale": np.float32(4.0)},
                       dict(bit_length=8, moving_rate=0.9))
    assert got2["OutScale"] == pytest.approx(0.9 * 4.0 + 0.1 * 3.0)
    got3 = _run_kernel("fake_quantize_range_abs_max",
                       {"X": x, "InScale": np.float32(4.0)},
                       dict(bit_length=8, moving_rate=0.9), is_test=True)
    assert got3["OutScale"] == pytest.approx(4.0)


def test_moving_average_abs_max_scale_passthrough():
    """test_uncovered_ops_r4c.py:110: Out is X; the EMA scale; without
    an InScale the EMA starts from 0."""
    x = np.array([[-6.0, 1.0], [2.0, 3.0]], np.float32)
    got = _run_kernel("moving_average_abs_max_scale",
                      {"X": x, "InScale": np.float32(2.0)},
                      dict(moving_rate=0.5))
    np.testing.assert_allclose(got["Out"], x)
    assert got["OutScale"] == pytest.approx(0.5 * 2.0 + 0.5 * 6.0)
    got = _run_kernel("moving_average_abs_max_scale", {"X": x},
                      dict(moving_rate=0.5))
    assert got["OutScale"] == pytest.approx(3.0)


def test_channel_wise_dequantize_takes_a_list_of_scales():
    """test_uncovered_ops_r4c.py:119: the per-channel weight scale, then
    the activation scale over its bits' range."""
    x = np.array([[127, -127], [64, 0]], np.float32)
    ch = np.array([2.0, 4.0], np.float32)
    got = _run_kernel("fake_channel_wise_dequantize_max_abs",
                      {"X": x, "Scales": [ch]},
                      dict(quant_bits=[8], quant_axis=0))
    ref = x * ch[:, None] / 127.0
    np.testing.assert_allclose(got["Out"], ref, rtol=1e-6)
    got = _run_kernel("fake_channel_wise_dequantize_max_abs",
                      {"X": x, "Scales": [ch, np.float32(3.0)]},
                      dict(quant_bits=[8, 8], quant_axis=0))
    np.testing.assert_allclose(got["Out"], ref * 3.0 / 127.0, rtol=1e-6)


def _op_layer(pkg_helper, op, ins, outs, attrs):
    helper = pkg_helper(op)
    res = {k: helper.create_variable_for_type_inference(dt)
           for k, dt in outs.items()}
    helper.append_op(op, ins, res, attrs)
    return res


def _both_programs(build, feeds, runs=1, test_clone=False):
    """build(L, helper_cls, vars) -> [fetch vars] built in both packages
    and run `runs` times on `feeds` (one dict a run) from one startup:
    (JAX's fetches a run, the port's, and each side's scope)."""
    from paddle_tpu.core.layer_helper import LayerHelper as JHelper
    out = []
    for pkg, L, un, helper, guard, scope in (
            (jfluid, jfluid.layers, jun, JHelper, jguard, JScope()),
            (fluid, tlayers, tun, LayerHelper, fluid.scope_guard,
             fluid.Scope())):
        main, startup = pkg.Program(), pkg.Program()
        with un.guard(), pkg.program_guard(main, startup):
            xs = {n: L.data(n, shape=list(a.shape), dtype=str(a.dtype),
                            append_batch_size=False)
                  for n, a in feeds[0].items()}
            fetch = build(L, helper, xs)
        prog = main.clone(for_test=True) if test_clone else main
        exe = pkg.Executor(CPU) if pkg is fluid else pkg.Executor()
        with guard(scope):
            exe.run(startup)
            res = [[np.asarray(v) for v in exe.run(prog, feed=f,
                                                   fetch_list=fetch)]
                   for f in feeds[:runs]]
        out.append((res, scope))
    return out


def test_fake_dequantize_max_abs_through_both_executors():
    """test_audit_gap_ops.py:199: Out = X x 0.5 / 127."""
    x = (RS.randn(4, 4) * 100).astype(np.float32)

    def build(L, H, v):
        return [_op_layer(H, "fake_dequantize_max_abs",
                          {"X": v["x"], "Scale": v["s"]},
                          {"Out": "float32"}, {"max_range": 127.0})["Out"]]

    (jr, _), (tr, _) = _both_programs(
        build, [{"x": x, "s": np.array([0.5], np.float32)}])
    np.testing.assert_allclose(tr[0][0], x * 0.5 / 127.0, rtol=1e-6)
    close(tr[0][0], jr[0][0])


def _ema_build(op):
    def build(L, H, v):
        scale = L.create_global_var([1], 1.0, "float32", persistable=True,
                                    name="act.scale")
        helper = H(op)
        out = helper.create_variable_for_type_inference("float32")
        helper.append_op(op, {"X": v["x"], "InScale": scale},
                         {"Out": out, "OutScale": scale},
                         {"moving_rate": 0.9, "bit_length": 8})
        return [out, scale]
    return build


@pytest.mark.parametrize("op", [
    "fake_quantize_dequantize_moving_average_abs_max",
    "fake_quantize_range_abs_max", "moving_average_abs_max_scale"])
def test_the_scale_state_accumulates_across_runs(op):
    """The scale is one persistable, read as InScale and written as
    OutScale: over four runs on new batches it follows the recurrence
    s <- 0.9 s + 0.1 max|x| from 1.0, in both packages, and each run's
    Out is JAX's; a clone(for_test=True) reads the stored scale and
    leaves it as it is."""
    feeds = [{"x": _r(6, 5, lo=-k, hi=k)} for k in (1.0, 4.0, 2.0, 0.5)]
    (jr, jscope), (tr, tscope) = _both_programs(_ema_build(op), feeds,
                                                runs=4)
    s = 1.0
    for k, (j, t) in enumerate(zip(jr, tr)):
        s = np.float32(0.9) * np.float32(s) + np.float32(0.1) * \
            np.abs(feeds[k]["x"]).max()
        np.testing.assert_allclose(t[1].reshape(-1), [s], rtol=1e-6)
        close(t[0], j[0], name=str(k))
        close(t[1].reshape(-1), np.asarray(j[1]).reshape(-1))
    (jr, jscope), (tr, tscope) = _both_programs(_ema_build(op), feeds,
                                                runs=2, test_clone=True)
    for j, t in zip(jr, tr):
        np.testing.assert_array_equal(t[1].reshape(-1), [1.0])
        close(t[0], j[0])


# ---------------------------------------------------------------------------
# data parallelism
# ---------------------------------------------------------------------------

def _dp_run(build, feed, places):
    main, startup = fluid.Program(), fluid.Program()
    with tun.guard(), fluid.program_guard(main, startup):
        outs = build()
    scope, exe = fluid.Scope(), fluid.Executor(CPU)
    exe.run(startup, scope=scope)
    prog = main if places is None else fluid.CompiledProgram(
        main).with_data_parallel(loss_name=outs[0].name, places=places)
    return [exe.run(prog, feed=feed, fetch_list=outs, scope=scope)
            for _ in range(2)]


def _quant_net(ops):
    def build():
        x = tlayers.data("x", shape=[6], dtype="float32")
        h = tlayers.fc(x, size=5, param_attr=fluid.ParamAttr(name="w"))
        outs = []
        for op, attrs in ops:
            helper = LayerHelper(op)
            res = {k: helper.create_variable_for_type_inference("float32")
                   for k in ("Out", "OutScale")}
            ins = {"X": h}
            if "moving" in op or "range" in op:
                scale = tlayers.create_global_var(
                    [1], 1.0 if "range" not in op else 0.0, "float32",
                    persistable=True, name=op + ".s")
                ins["InScale"] = scale
                res["OutScale"] = scale
            if "static" in op:
                del res["OutScale"]
            helper.append_op(op, ins, res, attrs)
            outs += [tlayers.mean(res["Out"])] + (
                [res["OutScale"]] if "OutScale" in res else [])
        w = fluid.default_main_program().global_block().var("w")
        helper = LayerHelper("q")
        qw = helper.create_variable_for_type_inference("float32")
        sw = helper.create_variable_for_type_inference("float32")
        helper.append_op("fake_channel_wise_quantize_dequantize_abs_max",
                         {"X": w}, {"Out": qw, "OutScale": sw},
                         {"quant_axis": 1})
        return [tlayers.mean(outs[0])] + outs + [qw, sw]
    return build


def test_dp_scales_are_the_global_batchs():
    """At dp 2 against the plain Executor, over two runs: the abs-max,
    moving-average, range and observer scales are the global batch's
    abs-max (one dp max) and their state equals dp 1's; Out the rows'
    quantize-dequantize at that scale; a replicated weight's channel-wise
    quantization is dp 1's."""
    ops = [("fake_quantize_dequantize_abs_max", {}),
           ("fake_quantize_dequantize_moving_average_abs_max",
            {"moving_rate": 0.9}),
           ("fake_quantize_range_abs_max", {"moving_rate": 0.9}),
           ("moving_average_abs_max_scale", {"moving_rate": 0.9}),
           ("quantize_dequantize_static_scale", {"scale": 0.7})]
    feed = {"x": _r(8, 6, lo=-2, hi=2)}
    feed["x"][5, 2] = 7.0            # the global max on rank 1's rows
    want = _dp_run(_quant_net(ops), feed, None)
    got = _dp_run(_quant_net(ops), feed, [CPU] * 2)
    for g, w in zip(got, want):
        for k, (a, b) in enumerate(zip(g, w)):
            close(np.asarray(a).reshape(-1), np.asarray(b).reshape(-1),
                  rtol=DP_TOL, name=str(k))


@pytest.mark.parametrize("op,attrs", [
    ("fake_channel_wise_quantize_dequantize_abs_max", {"quant_axis": 1}),
    ("fake_channel_wise_dequantize_max_abs", {"quant_axis": 0})])
def test_dp_channel_ops_refuse_a_sharded_channel_split(op, attrs):
    def build():
        x = tlayers.data("x", shape=[4], dtype="float32")
        helper = LayerHelper(op)
        out = helper.create_variable_for_type_inference("float32")
        ins = {"X": x}
        outs = {"Out": out}
        if "dequantize_max_abs" in op:
            ins["Scales"] = [tlayers.assign(np.ones(8, np.float32))]
        else:
            outs["OutScale"] = helper.create_variable_for_type_inference(
                "float32")
        helper.append_op(op, ins, outs, attrs)
        return [tlayers.mean(out)]
    feed = {"x": _r(8, 4)}
    with pytest.raises(NotImplementedError, match=op):
        _dp_run(build, feed, [CPU] * 2)
    _dp_run(build, feed, [CPU])
