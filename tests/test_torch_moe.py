"""Expert parallelism (item 11a) in the port, against the JAX package, on
the CPU.

Twins of ``tests/parallel/test_moe_framework.py`` (``layers.moe`` + the
``moe`` op through Program -> Executor: ep 2 under ``CompiledProgram.
with_mesh`` against the dense run, and the expert weights' ``ep``
dist_attr) and ``test_parallel_modes.py::test_moe_ep_matches_dense``
(``MoELayer`` dispatched over ep 8 against its dense form), plus the
gating, the per-shard capacity with dropped tokens, the gradients, and
the explicit dense pick where ep does not divide the tokens or experts.
Inputs and weights are numpy draws from fixed seeds; JAX runs its ep
meshes over the 8 virtual CPU devices of ``tests/conftest.py``.

Tolerances: outputs within 1e-5 of their scale (+ 1e-6) against JAX and
between the port's dense and ep forms where nothing drops; the aux loss
within 1e-6 relative; expert picks equal. The framework twin holds the
losses within 5e-4 relative and the expert weights within 5e-4 (+ 1e-6)
as the JAX test holds ep against dense, and the port against JAX at
1e-5 relative (losses) and 1e-4 (+ 1e-6) of scale (first @GRADs, the
weights after the steps): the train twins' tolerances.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as JP

import paddle_tpu as jfluid
from paddle_tpu import layers as jlayers
from paddle_tpu.core import unique_name as jun
from paddle_tpu.core.executor import Scope as JScope, scope_guard as jguard
from paddle_tpu.parallel import moe as jmoe
from paddle_tpu.parallel.mesh import make_mesh as jmake_mesh

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.core import unique_name as tun
from paddle_tpu_torch.parallel import ShardedTensor, make_mesh, moe as tmoe

CPU = fluid.CPUPlace()
OUT_TOL, OUT_ATOL = 1e-5, 1e-6
AUX_RTOL = 1e-6
EP_RTOL, EP_ATOL = 5e-4, 1e-6     # the JAX test's ep-vs-dense tolerances
JAX_RTOL = 1e-5
JAX_GRAD_TOL, JAX_GRAD_ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_bert.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def scale_close(got, want, tol=OUT_TOL, atol=OUT_ATOL, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max() + atol, (name, err)


def local(**kw):
    return make_mesh(**kw, devices=["cpu"] * int(np.prod(list(kw.values()))))


def _params(d=8, f=16, e=8, seed=0):
    rs = np.random.RandomState(seed)
    return {"gate_w": rs.randn(d, e).astype(np.float32) * 0.5,
            "w_up": rs.randn(e, d, f).astype(np.float32) * (2.0 / d) ** 0.5,
            "w_down": rs.randn(e, f, d).astype(np.float32) * (2.0 / f) ** 0.5}


def _tokens(t=64, d=8, seed=1):
    return np.random.RandomState(seed).randn(t, d).astype(np.float32)


def _jax_ep(params, x, cf, ep):
    layer = jmoe.MoELayer(x.shape[1], params["w_up"].shape[2],
                          params["w_up"].shape[0], capacity_factor=cf)

    def body(p, xx):
        out, aux = layer(p, xx)
        return out, aux[None]

    fn = shard_map(body, mesh=jmake_mesh(ep=ep, devices=jax.devices()[:ep]),
                   in_specs=({"gate_w": JP(), "w_up": JP("ep"),
                              "w_down": JP("ep")}, JP("ep", None)),
                   out_specs=(JP("ep", None), JP("ep")), check_vma=False)
    out, aux = fn({k: jnp.asarray(v) for k, v in params.items()},
                  jnp.asarray(x))
    return np.asarray(out), float(np.mean(np.asarray(aux)))


def _jax_dense(params, x, cf):
    layer = jmoe.MoELayer(x.shape[1], params["w_up"].shape[2],
                          params["w_up"].shape[0], capacity_factor=cf)
    out, aux = layer({k: jnp.asarray(v) for k, v in params.items()},
                     jnp.asarray(x))
    return np.asarray(out), float(aux)


def _torch(params):
    return {k: torch.tensor(v) for k, v in params.items()}


def test_moe_layer_ep_matches_dense_and_jax():
    """MoELayer over ep 8 (capacity factor 8: nothing drops) equals its
    dense form, and both equal JAX's (shard_map over ep 8, and dense)."""
    params, x = _params(), _tokens()
    layer = tmoe.MoELayer(8, 16, 8, capacity_factor=8.0)
    dense, daux = layer(_torch(params), torch.tensor(x))
    ep, eaux = tmoe.moe_apply(torch.tensor(x), *_torch(params).values(),
                              capacity_factor=8.0, mesh=local(ep=8))
    jd, jdaux = _jax_dense(params, x, 8.0)
    je, jeaux = _jax_ep(params, x, 8.0, 8)
    scale_close(ep.numpy(), dense.numpy())
    scale_close(dense.numpy(), jd)
    scale_close(ep.numpy(), je)
    assert float(daux) == pytest.approx(jdaux, rel=AUX_RTOL)
    assert float(eaux) == pytest.approx(jeaux, rel=AUX_RTOL)


@pytest.mark.parametrize("ep", [2, 4, 8])
def test_capacity_per_shard_drops_as_jax(ep):
    """At capacity factor 1.25 each shard keeps int(1.25 t_local / E) + 1
    tokens an expert (0-based slot < capacity); the dropped ones give
    zeros: the outputs and aux equal JAX's ep run, and some token
    drops."""
    params, x = _params(seed=2), _tokens(seed=3)
    got, aux = tmoe.moe_apply(torch.tensor(x), *_torch(params).values(),
                              capacity_factor=1.25, mesh=local(ep=ep))
    want, jaux = _jax_ep(params, x, 1.25, ep)
    scale_close(got.numpy(), want)
    assert float(aux) == pytest.approx(jaux, rel=AUX_RTOL)
    assert (np.abs(got.numpy()).sum(-1) == 0).any()


def test_top1_gating_matches_jax():
    logits = np.random.RandomState(4).randn(32, 8).astype(np.float32)
    e, g, a = tmoe.top1_gating(torch.tensor(logits), 5)
    je, jg, ja = jmoe.top1_gating(jnp.asarray(logits), 5)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    scale_close(g.numpy(), np.asarray(jg))
    assert float(a) == pytest.approx(float(ja), rel=AUX_RTOL)


def test_dispatch_and_combine_match_jax_on_one_shard():
    """The slot buffer of one shard (ep 1: the all-to-all keeps it) and
    the combine's read-back equal JAX's on the same tokens: kept tokens
    in their slots, dropped ones zero."""
    x = _tokens(t=16, seed=5)
    expert = np.random.RandomState(6).randint(0, 4, 16)
    mesh = local(ep=1)
    disp, info = tmoe.expert_parallel_dispatch(
        [torch.tensor(x)], [torch.tensor(expert)], 4, 3, mesh=mesh)
    jfn = shard_map(lambda xx, ee: jmoe.expert_parallel_dispatch(
        xx, ee, 4, 3)[0], mesh=jmake_mesh(ep=1, devices=jax.devices()[:1]),
        in_specs=(JP(), JP()), out_specs=JP(), check_vma=False)
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(expert)))
    np.testing.assert_array_equal(disp[0].numpy(), want)
    gate = torch.ones(16)
    out = tmoe.expert_parallel_combine(disp, info, [gate], 4, 3, 16,
                                       mesh=mesh)[0]
    _e, slot, ok = info[0]
    np.testing.assert_array_equal(out.numpy()[ok.numpy()],
                                  x[ok.numpy()])
    assert (out.numpy()[~ok.numpy()] == 0).all()


def test_gradients_match_jax():
    """The gradients of a squared-output loss through ep 4 (drops at
    1.25) equal JAX's through its shard_map."""
    params, x = _params(seed=7), _tokens(seed=8)
    tp = {k: v.clone().requires_grad_(True) for k, v in
          _torch(params).items()}
    tx = torch.tensor(x, requires_grad=True)
    out, aux = tmoe.moe_apply(tx, tp["gate_w"], tp["w_up"], tp["w_down"],
                              capacity_factor=1.25, mesh=local(ep=4))
    loss = (out ** 2).sum() + 0.01 * aux
    grads = torch.autograd.grad(loss, [tx] + list(tp.values()))
    layer = jmoe.MoELayer(8, 16, 8, capacity_factor=1.25)
    mesh = jmake_mesh(ep=4, devices=jax.devices()[:4])

    def jloss(xx, p):
        fn = shard_map(lambda pp, xs: (lambda o, a: (o, a[None]))(
            *layer(pp, xs)), mesh=mesh,
            in_specs=({"gate_w": JP(), "w_up": JP("ep"), "w_down": JP("ep")},
                      JP("ep", None)), out_specs=(JP("ep", None), JP("ep")),
            check_vma=False)
        o, a = fn(p, xx)
        return (o ** 2).sum() + 0.01 * jnp.mean(a)

    jx, jp = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()})
    scale_close(grads[0].numpy(), np.asarray(jx), name="x")
    for (k, v), g in zip(tp.items(), grads[1:]):
        scale_close(g.numpy(), np.asarray(jp[k]), name=k)


def test_ep_that_does_not_divide_runs_dense():
    """An ep axis that divides neither the tokens (60 over 8) nor the
    experts (6 over 4) picks the dense path explicitly, as JAX's
    _active_ep_mesh: the dense numbers, drops and all."""
    x = _tokens(t=60)
    params = _params()
    dense, _ = tmoe.MoELayer(8, 16, 8, 1.25)(_torch(params), torch.tensor(x))
    got, _ = tmoe.moe_apply(torch.tensor(x), *_torch(params).values(),
                            capacity_factor=1.25, mesh=local(ep=8))
    np.testing.assert_array_equal(got.numpy(), dense.numpy())
    p6 = _params(e=6)
    assert tmoe._active_ep_mesh(64, 6, local(ep=4)) is None
    d6, _ = tmoe.MoELayer(8, 16, 6, 1.25)(_torch(p6), torch.tensor(_tokens()))
    g6, _ = tmoe.moe_apply(torch.tensor(_tokens()), *_torch(p6).values(),
                           capacity_factor=1.25, mesh=local(ep=4))
    np.testing.assert_array_equal(g6.numpy(), d6.numpy())
    assert tmoe._active_ep_mesh(64, 8, None) is None


# ---------------------------------------------------------------------------
# the framework path
# ---------------------------------------------------------------------------

def _moe_program(pkg, layers, d=8, d_ff=16, experts=4, cf=8.0):
    x = layers.data("x", shape=[16, d], dtype="float32")
    out, aux = layers.moe(x, d_ff=d_ff, num_experts=experts,
                          capacity_factor=cf,
                          param_attr=pkg.ParamAttr(name="moe"))
    loss = layers.mean(layers.reduce_sum(layers.square(out), dim=-1)) \
        + layers.reduce_sum(aux) * 0.01
    return x, out, aux, loss


def _feed(batch=2, t=16, d=8, seed=0):
    return {"x": np.random.RandomState(seed).randn(batch, t, d).astype(
        np.float32)}


def _build(pkg, un, layers, cf=8.0):
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 11
    with un.guard(), pkg.program_guard(main, startup):
        _x, _o, aux, loss = _moe_program(pkg, layers, cf=cf)
        pkg.optimizer.SGDOptimizer(learning_rate=0.05).minimize(loss)
    return main, startup, aux, loss


GRADS = ["moe_gate_w@GRAD", "moe_w_up@GRAD", "moe_w_down@GRAD"]


@pytest.fixture(scope="module")
def moe_init():
    _m, startup, _a, _l = _build(fluid, tun, tlayers)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor(CPU).run(startup)
    return {n: scope.get(n).numpy().copy() for n in scope.names()}


def _port(init, mesh=None, steps=5, cf=8.0):
    main, _s, aux, loss = _build(fluid, tun, tlayers, cf)
    scope = fluid.scope_from_numpy(init, "cpu")
    prog = main if mesh is None else \
        fluid.CompiledProgram(main).with_mesh(mesh)
    exe, losses, grads = fluid.Executor(CPU), [], None
    with fluid.scope_guard(scope):
        for i in range(steps):
            out = exe.run(prog, feed=_feed(), fetch_list=[loss, aux] + (
                GRADS if i == 0 else []))
            losses.append(float(out[0].ravel()[0]))
            assert np.isfinite(out[1]).all()
            if i == 0:
                grads = out[2:]
    w = scope.get("moe_w_up")
    return losses, grads, w


def _jax(init, mesh=None, steps=5):
    main, _s, aux, loss = _build(jfluid, jun, jlayers)
    scope = JScope()
    for n, v in init.items():
        scope.set(n, jnp.asarray(v))
    prog = main if mesh is None else \
        jfluid.CompiledProgram(main).with_mesh(mesh)
    exe, losses, grads = jfluid.Executor(), [], None
    with jguard(scope):
        for i in range(steps):
            out = exe.run(prog, feed=_feed(), fetch_list=[loss, aux] + (
                GRADS if i == 0 else []))
            losses.append(float(np.asarray(out[0]).ravel()[0]))
            if i == 0:
                grads = out[2:]
        w = np.asarray(scope.get("moe_w_up"))
    return losses, grads, w


def test_moe_ep_matches_dense(moe_init):
    """ep 2 under CompiledProgram (the expert weights laid out over ep,
    two experts a position, the tokens split over ep) against the dense
    Executor run over 5 SGD steps, as the JAX test holds them, and both
    against JAX's runs."""
    dense_l, dense_g, dense_w = _port(moe_init)
    ep_l, ep_g, ep_w = _port(moe_init, local(ep=2))
    assert min(dense_l) < dense_l[0]
    np.testing.assert_allclose(dense_l, ep_l, rtol=EP_RTOL, atol=EP_ATOL)
    assert isinstance(ep_w, ShardedTensor) and ep_w.axes == ["ep"]
    assert [tuple(p.shape) for p in ep_w.parts] == [(2, 8, 16)] * 2
    np.testing.assert_allclose(ep_w.full().numpy(), dense_w.numpy(),
                               rtol=EP_RTOL, atol=EP_ATOL)
    jd_l, jd_g, jd_w = _jax(moe_init)
    je_l, je_g, je_w = _jax(moe_init, jmake_mesh(
        ep=2, devices=jax.devices()[:2]))
    np.testing.assert_allclose(dense_l, jd_l, rtol=JAX_RTOL)
    np.testing.assert_allclose(ep_l, je_l, rtol=JAX_RTOL)
    for n, a, b, c, e in zip(GRADS, dense_g, jd_g, ep_g, je_g):
        scale_close(a, b, JAX_GRAD_TOL, JAX_GRAD_ATOL, name=n)
        scale_close(c, e, JAX_GRAD_TOL, JAX_GRAD_ATOL, name=n)
    scale_close(dense_w.numpy(), jd_w, JAX_GRAD_TOL, JAX_GRAD_ATOL)
    scale_close(ep_w.full().numpy(), je_w, JAX_GRAD_TOL, JAX_GRAD_ATOL)


def test_moe_framework_drops_as_jax_at_ep_2(moe_init):
    """At capacity factor 1.25 each ep shard drops tokens past its own
    capacity: the port's ep 2 Program run equals JAX's ep 2 run."""
    got, grads, _w = _port(moe_init, local(ep=2), steps=2, cf=1.25)
    main, _s, aux, loss = _build(jfluid, jun, jlayers, cf=1.25)
    scope = JScope()
    for n, v in moe_init.items():
        scope.set(n, jnp.asarray(v))
    prog = jfluid.CompiledProgram(main).with_mesh(jmake_mesh(
        ep=2, devices=jax.devices()[:2]))
    want = []
    with jguard(scope):
        exe = jfluid.Executor()
        for i in range(2):
            out = exe.run(prog, feed=_feed(), fetch_list=[loss] + (
                GRADS if i == 0 else []))
            want.append(float(np.asarray(out[0]).ravel()[0]))
            if i == 0:
                jgrads = out[1:]
    np.testing.assert_allclose(got, want, rtol=JAX_RTOL)
    for n, a, b in zip(GRADS, grads, jgrads):
        scale_close(a, b, JAX_GRAD_TOL, JAX_GRAD_ATOL, name=n)


def test_moe_expert_weights_carry_ep_dist_attr():
    for pkg, un, layers in ((fluid, tun, tlayers), (jfluid, jun, jlayers)):
        main, startup = pkg.Program(), pkg.Program()
        with un.guard(), pkg.program_guard(main, startup):
            _moe_program(pkg, layers)
        gb = main.global_block()
        assert tuple(gb.var("moe_w_up").dist_attr)[0] == "ep"
        assert tuple(gb.var("moe_w_down").dist_attr)[0] == "ep"
        assert getattr(gb.var("moe_gate_w"), "dist_attr", None) is None
        assert [p.name for p in main.all_parameters()] == \
            ["moe_gate_w", "moe_w_up", "moe_w_down"]


def test_moe_under_dp_raises_naming_its_item(moe_init):
    """The op's capacity counts the global batch's tokens: under dp 2 the
    rows would count their own, so the op refuses, naming the queued
    item; at dp 1 it runs."""
    with pytest.raises(NotImplementedError, match="MoE under dp"):
        _port(moe_init, local(dp=2), steps=1)
    dense, _g, _w = _port(moe_init, steps=1)
    got, _g, _w = _port(moe_init, local(dp=1), steps=1)
    assert got == dense
