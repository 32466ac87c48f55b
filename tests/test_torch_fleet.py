"""Fleet, its role makers and DistributedStrategy, against the JAX
package, on the CPU.

Twins of ``tests/parallel/test_fleet_strategy.py`` (3), the fleet tests
of ``tests/api/test_fleet_surface.py`` (3),
``test_amp_fleet_utils.py::test_fleet_facade_dp_training``,
``test_gradient_merge.py::test_fleet_strategy_routes_gradient_merge`` and
``test_recompute.py::test_fleet_strategy_recompute_flag``. Both packages
build the same Program under fresh unique-name generators; the port's
startup state is carried into JAX's scope as numpy, and JAX's fleet runs
on the 8 virtual CPU devices of ``tests/conftest.py`` while the port's
runs a local mesh of 8 CPU positions (``DistributedStrategy.
local_devices``: without it a one-process fleet means every visible
card, and raises without CUDA). Tolerances: the losses of dp 4 x tp 2 +
ZeRO-1 within JAX's own test's rtol 2e-4 + atol 1e-5 of JAX's run and of
the plain run, with JAX's asserts on the mesh, the emulated host domains
and the dist_attrs held on both.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

import paddle_tpu as jfluid
import paddle_tpu.core.unique_name  # noqa: F401
from paddle_tpu.core import framework as jframework
from paddle_tpu.core.executor import Scope as JScope, scope_guard as jguard
from paddle_tpu.parallel import fleet as jfleet_mod
from paddle_tpu.parallel import mesh as jmesh_mod

import paddle_tpu_torch as fluid
import paddle_tpu_torch.core.unique_name  # noqa: F401
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.parallel import PartitionSpec, ShardedTensor
from paddle_tpu_torch.parallel import fleet as tfleet_mod
from paddle_tpu_torch.parallel import mesh as tmesh_mod

CPU = fluid.CPUPlace()
RTOL, ATOL = 2e-4, 1e-5
EIGHT = ["cpu"] * 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_bert.py: concurrent pytest workers oversubscribe the
    CPU otherwise)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _restore_meshes():
    """Fleet sets each package's global mesh: put both back."""
    j, t = jmesh_mod._current_mesh, tmesh_mod._current_mesh
    yield
    jmesh_mod._current_mesh, tmesh_mod._current_mesh = j, t


def _net(pkg):
    layers = pkg.layers
    x = pkg.data(name="x", shape=[-1, 16], dtype="float32")
    y = pkg.data(name="y", shape=[-1, 1], dtype="float32")
    h = layers.fc(x, size=64, act="relu", name="mlp_up")
    p = layers.fc(h, size=1, name="head")
    return layers.mean(layers.square_error_cost(p, y))


def _feed():
    rng = np.random.default_rng(0)
    return {"x": rng.standard_normal((8, 16)).astype(np.float32),
            "y": rng.standard_normal((8, 1)).astype(np.float32)}


def _build(pkg, framework, fleet_mod, strategy):
    main, startup = framework.Program(), framework.Program()
    main.random_seed = startup.random_seed = 11
    with pkg.core.unique_name.guard(), \
            framework.program_guard(main, startup):
        loss = _net(pkg)
        opt = pkg.optimizer.AdamOptimizer(learning_rate=1e-2)
        if strategy is None:
            opt.minimize(loss)
        else:
            flt = fleet_mod.Fleet()
            flt.init(strategy=strategy)
            flt.distributed_optimizer(opt).minimize(loss)
    return main, startup, loss


def _port_train(strategy=None, steps=3, init=None):
    """test_fleet_strategy.py's _train in the port: (losses, program,
    startup state, final scope)."""
    main, startup, loss = _build(fluid, tframework, tfleet_mod, strategy)
    prog = main if strategy is None else \
        fluid.CompiledProgram(main).with_mesh(tmesh_mod.get_mesh())
    if init is None:
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            fluid.Executor(CPU).run(startup)
        init = {n: scope.get(n).numpy().copy() for n in scope.names()}
    scope = fluid.scope_from_numpy(init, "cpu")
    losses = []
    with fluid.scope_guard(scope):
        exe = fluid.Executor(CPU)
        for _ in range(steps):
            out, = exe.run(prog, feed=_feed(), fetch_list=[loss])
            losses.append(float(np.asarray(out).reshape(-1)[0]))
    return losses, main, init, scope


def _jax_train(strategy, init, steps=3):
    """The same in the JAX package from the port's startup state."""
    main, _startup, loss = _build(jfluid, jframework, jfleet_mod, strategy)
    prog = main if strategy is None else \
        jfluid.CompiledProgram(main).with_mesh(jmesh_mod.get_mesh())
    scope = JScope()
    for n, v in init.items():
        scope.set(n, jnp.asarray(v))
    losses = []
    with jguard(scope):
        exe = jfluid.Executor()
        for _ in range(steps):
            out, = exe.run(prog, feed=_feed(), fetch_list=[loss])
            losses.append(float(np.asarray(out).reshape(-1)[0]))
    return losses, main


# ---------------------------------------------------------------------------
# test_fleet_strategy.py
# ---------------------------------------------------------------------------

def test_paddlecloud_role_maker_env(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "2")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS",
                       "h0:7164,h1:7164,h2:7164,h3:7164")
    for mod in (jfleet_mod, tfleet_mod):
        rm = mod.PaddleCloudRoleMaker()
        assert rm.worker_index() == 2
        assert rm.worker_num() == 4
        assert rm.current_endpoint == "h2:7164"
        assert not rm.is_first_worker()


def _strategy(mod, **kw):
    s = mod.DistributedStrategy()
    for k, v in kw.items():
        setattr(s, k, v)
    return s


def test_fleet_strategy_builds_hybrid_mesh_and_matches_numerics():
    """tp 2 + ZeRO-1 over 2 emulated hosts of 4 positions: dp 4 x tp 2,
    the tp pairs inside one host domain, the Megatron rule on mlp_up's
    weight and an accumulator laid out over dp; three Adam steps give the
    plain run's and JAX's losses."""
    ref, _m, init, _s = _port_train(None)
    s = _strategy(tfleet_mod, tp_degree=2, zero_stage=1, emulated_hosts=2,
                  local_devices=EIGHT)
    losses, main, _i, scope = _port_train(s, init=init)
    jlosses, jmain = _jax_train(
        _strategy(jfleet_mod, tp_degree=2, zero_stage=1, emulated_hosts=2),
        init)
    for mod, m in ((tmesh_mod, tmesh_mod.get_mesh()),
                   (jmesh_mod, jmesh_mod.get_mesh())):
        shape = dict(zip(m.axis_names, m.devices.shape))
        assert shape["tp"] == 2 and shape["dp"] == 4
        doms = mod.host_domains(m, per_host=4)
        assert len(np.unique(doms[0, 0, 0, 0, :])) == 1
        assert len(np.unique(doms)) == 2
    np.testing.assert_allclose(losses, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL, atol=ATOL)
    for prog, P in ((main, PartitionSpec), (jmain, JP)):
        up_w = [p for p in prog.all_parameters()
                if p.name.startswith("mlp_up.w")]
        assert up_w and up_w[0].dist_attr is not None
        accs = [v for v in prog.list_vars()
                if v.persistable and "moment" in v.name
                and getattr(v, "dist_attr", None) == P("dp")]
        assert accs, "ZeRO-1 left no accumulator sharded over dp"
    # the port's scope holds them laid out so
    w = scope.get(up_w[0].name)
    assert isinstance(w, ShardedTensor) and w.axes == ["tp"]
    m1 = scope.get(accs[0].name)
    assert isinstance(m1, ShardedTensor) and m1.axes == ["dp"]
    assert len(m1.parts) == 4


def test_fleet_zero3_shards_params():
    s = _strategy(tfleet_mod, zero_stage=3, local_devices=EIGHT)
    losses, main, _i, scope = _port_train(s)
    assert np.isfinite(losses).all()
    emb = [p for p in main.all_parameters()
           if p.dist_attr == PartitionSpec("dp")]
    assert emb, "fsdp left no parameter sharded over dp"
    assert isinstance(scope.get(emb[0].name), ShardedTensor)
    jlosses, jmain = _jax_train(_strategy(jfleet_mod, zero_stage=3),
                                _port_train(None)[2])
    assert [p.name for p in jmain.all_parameters()
            if p.dist_attr == JP("dp")] == [p.name for p in emb]


def test_fleet_zero3_matches_jax():
    """The ZeRO-3 run of both packages from one state: JAX's losses."""
    _r, _m, init, _s = _port_train(None)
    losses = _port_train(_strategy(tfleet_mod, zero_stage=3,
                                   local_devices=EIGHT), init=init)[0]
    jlosses = _jax_train(_strategy(jfleet_mod, zero_stage=3), init)[0]
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# tests/api/test_fleet_surface.py
# ---------------------------------------------------------------------------

def test_collective_optimizer_reference_ctor_shape():
    """The reference calls CollectiveOptimizer(optimizer, strategy), both
    positional, no fleet object (collective/__init__.py:139)."""
    from paddle_tpu_torch.incubate.fleet.collective import (
        CollectiveOpBasedOptimizer, CollectiveOptimizer,
        DistributedStrategy)
    main, startup = tframework.Program(), tframework.Program()
    with tframework.program_guard(main, startup):
        x = fluid.layers.data("x", [4, 3], append_batch_size=False)
        y = fluid.layers.data("y", [4, 1], append_batch_size=False)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(
            fluid.layers.fc(x, size=1), y))
        opt = CollectiveOptimizer(fluid.optimizer.SGDOptimizer(0.1),
                                  DistributedStrategy())
        opt.minimize(loss)
    exe = fluid.Executor(CPU)
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        out = exe.run(main, feed={
            "x": np.ones((4, 3), np.float32),
            "y": np.zeros((4, 1), np.float32)}, fetch_list=[loss])
    assert np.isfinite(np.asarray(out[0])).all()
    CollectiveOptimizer(fluid.optimizer.SGDOptimizer(0.1))
    assert isinstance(CollectiveOpBasedOptimizer(
        fluid.optimizer.SGDOptimizer(0.1), DistributedStrategy()),
        CollectiveOptimizer)


def test_fleet_surface_names():
    from paddle_tpu.incubate.fleet import collective as jcoll
    from paddle_tpu_torch.incubate.fleet.base import role_maker
    from paddle_tpu_torch.incubate.fleet.collective import (
        Collective, DistFCConfig, LambConfig, fleet)
    from paddle_tpu_torch.incubate.fleet import collective as tcoll
    assert isinstance(fleet, Collective)
    assert role_maker.Role.WORKER == 1 and role_maker.Role.SERVER == 2
    rm = role_maker.UserDefinedCollectiveRoleMaker(
        current_id=1, worker_endpoints=["a:1", "b:2"])
    assert rm.worker_num() == 2 and rm.worker_index() == 1
    with pytest.raises(ValueError):
        role_maker.UserDefinedCollectiveRoleMaker(current_id=5,
                                                  worker_endpoints=["a:1"])
    assert role_maker.MPISymetricRoleMaker().worker_num() >= 1
    LambConfig()
    DistFCConfig()
    assert sorted(jcoll.__all__) == sorted(tcoll.__all__)


def test_fleet_util_portable_methods():
    from paddle_tpu_torch.incubate.fleet.utils import FleetUtil
    fu = FleetUtil()
    scope = fluid.Scope()
    pos = np.zeros(10)
    pos[9] = 100
    neg = np.zeros(10)
    neg[0] = 100
    scope.set("stat_pos", torch.from_numpy(pos))
    scope.set("stat_neg", torch.from_numpy(neg))
    assert fu.get_global_auc(scope) == pytest.approx(1.0, abs=1e-6)
    scope.set("stat_pos", torch.ones(10))
    scope.set("stat_neg", torch.ones(10))
    assert fu.get_global_auc(scope) == pytest.approx(0.5, abs=1e-6)
    assert fu.get_global_auc(scope, stat_pos="missing") is None

    scope.set("v", torch.arange(6))
    fu.set_zero("v", scope)
    assert (np.asarray(scope.get("v")) == 0).all()

    intervals = fu.get_online_pass_interval(
        "{20190720..20190722}", "{0..23}", 60, 2, False)
    assert len(intervals) == 12 and intervals[0] == ["0000", "0100"]
    from paddle_tpu.incubate.fleet.utils import FleetUtil as JFleetUtil
    assert intervals == JFleetUtil().get_online_pass_interval(
        "{20190720..20190722}", "{0..23}", 60, 2, False)

    with pytest.raises(NotImplementedError, match="checkpoint"):
        fu.save_fleet_model("/tmp/x")


def test_pserver_shims_raise_with_guidance():
    """The parameter-server names import and raise when constructed, as
    the JAX package's do; launch_ps raises; the Communicator warns."""
    from paddle_tpu_torch.distributed import downpour, launch_ps
    from paddle_tpu_torch.incubate.fleet.parameter_server import (
        distribute_transpiler, pslib)
    for cls in (distribute_transpiler.DistributedTranspiler,
                distribute_transpiler.TranspilerOptimizer,
                pslib.PSLib, pslib.DownpourOptimizer,
                downpour.DownpourSGD):
        with pytest.raises(NotImplementedError):
            cls()
    with pytest.raises(RuntimeError, match="parameter-server"):
        launch_ps.launch()
    with pytest.warns(UserWarning, match="no-op"):
        c = fluid.Communicator()
    c.start()
    assert c.is_running()
    c.stop()
    assert not c.is_running()
    assert fluid.communicator.Communicator is fluid.Communicator


# ---------------------------------------------------------------------------
# test_amp_fleet_utils.py, test_gradient_merge.py, test_recompute.py
# ---------------------------------------------------------------------------

def test_fleet_facade_dp_training():
    """fleet.init(is_collective=True) then distributed_optimizer's
    minimize: a plain run trains (finite loss). A one-process fleet's
    mesh is every visible card: without CUDA it raises, never falling to
    the CPU; local_devices asks for it."""
    fleet = tfleet_mod.fleet
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="local_devices"):
            fleet.init(is_collective=True)
    fleet.init(is_collective=True,
               strategy=_strategy(tfleet_mod, local_devices=EIGHT))
    assert fleet.worker_num() >= 1
    main, startup = tframework.Program(), tframework.Program()
    with tframework.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[8], dtype="float32")
        y = fluid.layers.data("y", shape=[1], dtype="float32")
        h = fluid.layers.fc(x, size=16, act="relu")
        pred = fluid.layers.fc(h, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fleet.distributed_optimizer(
            fluid.optimizer.SGDOptimizer(learning_rate=0.1)).minimize(loss)
    rs = np.random.RandomState(0)
    xs = rs.rand(16, 8).astype(np.float32)
    feed = {"x": xs, "y": xs.sum(1, keepdims=True).astype(np.float32)}
    exe = fluid.Executor(CPU)
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        out, = exe.run(main, feed=feed, fetch_list=[loss])
        assert np.isfinite(out).all()
        out, = exe.run(fleet.compiled_program(main), feed=feed,
                       fetch_list=[loss])
        assert np.isfinite(out).all()
    assert fleet.mesh().shape["dp"] == 8


def test_fleet_strategy_routes_gradient_merge():
    s = tfleet_mod.DistributedStrategy()
    s.gradient_merge_steps = 2
    f = tfleet_mod.Fleet()
    f._strategy = s
    main, startup = tframework.Program(), tframework.Program()
    with tframework.program_guard(main, startup):
        x = fluid.layers.data("x", [4, 3], append_batch_size=False)
        y = fluid.layers.data("y", [4, 1], append_batch_size=False)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(
            fluid.layers.fc(x, size=1), y))
        tfleet_mod.DistributedOptimizer(fluid.optimizer.SGDOptimizer(0.1),
                                        f).minimize(loss)
    types = [op.type for op in main.global_block().ops]
    assert "increment" in types and "elementwise_mod" in types, (
        "gradient_merge_steps did not wire the merge counter in")
    s.amp = True
    with pytest.raises(NotImplementedError, match="gradient_merge"):
        with tframework.program_guard(tframework.Program(),
                                      tframework.Program()):
            x = fluid.layers.data("x", [4, 3], append_batch_size=False)
            tfleet_mod.DistributedOptimizer(
                fluid.optimizer.SGDOptimizer(0.1), f).minimize(
                fluid.layers.mean(fluid.layers.fc(x, size=1)))


def test_fleet_strategy_recompute_flag():
    main, startup = tframework.Program(), tframework.Program()
    with tframework.program_guard(main, startup):
        x = fluid.data(name="x", shape=[-1, 8], dtype="float32")
        loss = fluid.layers.mean(fluid.layers.fc(x, size=1))
        flt = tfleet_mod.Fleet()
        s = tfleet_mod.DistributedStrategy()
        s.recompute = True
        s.local_devices = EIGHT
        flt.init(strategy=s)
        flt.distributed_optimizer(
            fluid.optimizer.SGDOptimizer(learning_rate=0.1)).minimize(loss)
    assert main._recompute == {"policy": "dots"}


def test_backend_follows_the_layout():
    """Ranks that share a selected device take gloo, ranks with a card
    each NCCL (with CUDA); without CUDA gloo whatever the layout."""
    want = "nccl" if torch.cuda.is_available() else "gloo"
    assert tfleet_mod.backend_for_layout(["0", "1"]) == want
    assert tfleet_mod.backend_for_layout(["0", "0"]) == "gloo"


@pytest.mark.parametrize("node, selected, backend", [
    ("0,0,1,1", "1", "gloo"), ("0,1", "1", "nccl")])
def test_a_rank_trains_on_its_selected_device(monkeypatch, node, selected,
                                              backend):
    """Fleet.init sets the launcher's PADDLE_SELECTED_DEVICES as the
    rank's card whatever the backend: a repeated layout (gloo) puts ranks
    2 and 3 of 0,0,1,1 on card 1, not on the current device. CUDA and the
    join are stood in for: this checks the choice, not a world."""
    calls, joined = [], []
    monkeypatch.setattr(tfleet_mod.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tfleet_mod.torch.cuda, "set_device", calls.append)
    monkeypatch.setattr(tfleet_mod, "multihost_initialize",
                        lambda **kw: joined.append(kw["backend"]))
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS", "h0:7164,h0:7165")
    monkeypatch.setenv("PADDLE_NODE_DEVICES", node)
    monkeypatch.setenv("PADDLE_SELECTED_DEVICES", selected)
    flt = tfleet_mod.Fleet().init(strategy=_strategy(
        tfleet_mod, local_devices=["cpu"]))
    assert flt.backend == backend and joined == [backend]
    assert calls == [int(selected)]


def test_pp_and_ep_meshes_build_and_the_walk_names_the_next_item():
    """pp_degree or ep_degree > 1 builds fleet's mesh (dp 4 x pp 2, dp 4
    x ep 2 over eight positions), and the walk runs it: the net carries
    no pipeline tag and no moe op, so every pp and ep position runs the
    dp step, and three Adam steps give the plain run's losses. What the
    walk still refuses names its queued item: a pipelined Program beside
    dp (pipeline parallelism beside dp, which no JAX test holds)."""
    ref, _m, init, _s = _port_train(None)
    for kw in (dict(pp_degree=2), dict(ep_degree=2)):
        s = _strategy(tfleet_mod, local_devices=EIGHT, **kw)
        losses, main, _i, _scope = _port_train(s, init=init)
        mesh = tmesh_mod.get_mesh()
        assert mesh.shape[next(iter(kw))[:2]] == 2 and mesh.size == 8
        np.testing.assert_allclose(losses, ref, rtol=RTOL, atol=ATOL)
    s = _strategy(tfleet_mod, local_devices=EIGHT, pp_degree=2)
    main, startup = tframework.Program(), tframework.Program()
    with fluid.core.unique_name.guard(), \
            tframework.program_guard(main, startup):
        loss = _net(fluid)
        cut = main.global_block().ops[3].output_names[0]
        flt = tfleet_mod.Fleet()
        flt.init(strategy=s)
        flt.distributed_optimizer(fluid.optimizer.PipelineOptimizer(
            fluid.optimizer.AdamOptimizer(learning_rate=1e-2),
            cut_list=[[cut]], num_microbatches=2)).minimize(loss)
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(CPU)
        exe.run(startup)
        with pytest.raises(NotImplementedError,
                           match="pipeline parallelism beside dp"):
            exe.run(fluid.CompiledProgram(main).with_mesh(
                tmesh_mod.get_mesh()), feed=_feed(), fetch_list=[loss])


