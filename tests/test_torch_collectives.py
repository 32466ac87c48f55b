"""The collectives over a named mesh axis and the collective ops, against
the JAX package, on the CPU.

The JAX package runs ``parallel/collective.py``'s functions and the
``c_*`` op kernels as ``lax`` collectives inside ``shard_map`` over the
virtual 8-device CPU mesh of ``tests/conftest.py``
(``tests/parallel/test_collectives.py``,
``tests/parallel/test_collective_op_kernels.py``). The port takes the
held positions' parts instead: a list in rank order on a local mesh of 8
CPU positions, this process's one part in a ``torch.distributed`` world.
Each twin feeds both the same numpy shards and holds the port's result
against JAX's and against numpy: sum, mean and prod within 1e-5 relative
(prod over mixed signs and a zero; 1e-6 absolute), max, min, broadcast,
allgather, alltoall and the permutations exactly. Outside a mapped
context the ops are the identity in both packages, and under
``CompiledProgram.with_mesh`` (where JAX's pjit binds no named axis) a
Program's collective ops are the identity in both.

The world forms run in a 2-process gloo world started through the port's
launcher (``python -m paddle_tpu_torch.distributed.launch``): every
collective and op there against numpy, gloo's missing reduce-scatter and
all-to-all composed by ``Mesh`` (all-reduce then a block; all-gather then
a block).
"""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh as JMesh, PartitionSpec as JP

import paddle_tpu as jfluid
import paddle_tpu.core.unique_name  # noqa: F401
from paddle_tpu.core import framework as jframework
from paddle_tpu.ops import _REGISTRY as JREG
from paddle_tpu.parallel import collective as jcol
from paddle_tpu.parallel.mesh import make_mesh as jmake_mesh

import paddle_tpu_torch as fluid
import paddle_tpu_torch.core.unique_name  # noqa: F401
from paddle_tpu_torch.core import framework as tframework
from paddle_tpu_torch.ops import _REGISTRY as TREG
from paddle_tpu_torch.parallel import collective as tcol
from paddle_tpu_torch.parallel import make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6
N = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_bert.py: concurrent pytest workers oversubscribe the
    CPU otherwise)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jmesh():
    return JMesh(np.array(jax.devices()), ("dp",))


@pytest.fixture(scope="module")
def tmesh():
    return make_mesh(dp=N, devices=["cpu"] * N)


def _smap(fn, mesh, in_spec, out_spec):
    return shard_map(fn, mesh=mesh, in_specs=in_spec, out_specs=out_spec,
                     check_vma=False)


def _parts(x):
    """A (N, ...) array -> the N positions' parts, each (1, ...)."""
    return [torch.from_numpy(np.ascontiguousarray(x[r:r + 1]))
            for r in range(x.shape[0])]


def _stack(parts):
    return np.concatenate([p.numpy() for p in parts])


# ---------------------------------------------------------------------------
# parallel/collective.py (test_collectives.py)
# ---------------------------------------------------------------------------

MIXED = np.arange(16, dtype=np.float32).reshape(8, 2) - 5.0


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min", "prod"])
def test_allreduce_ops(jmesh, tmesh, op):
    """test_collectives.py::test_allreduce_ops: mixed signs and a zero
    (prod's zero and negative handling); every position holds the
    reduction."""
    golden = getattr(MIXED, op)(0)
    fn = _smap(lambda s: jcol.allreduce(s, op), jmesh, (JP("dp", None),),
               JP("dp", None))
    want = np.asarray(fn(MIXED))
    got = _stack(tcol.allreduce(_parts(MIXED), op, "dp", mesh=tmesh))
    for r in range(N):
        np.testing.assert_allclose(got[r], golden, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got[r], want[r], rtol=RTOL, atol=ATOL)
    if op in ("max", "min"):
        np.testing.assert_array_equal(got, want)


def test_broadcast(jmesh, tmesh):
    x = np.arange(8, dtype=np.float32).reshape(8, 1)
    fn = _smap(lambda s: jcol.broadcast(s, root=3), jmesh,
               (JP("dp", None),), JP("dp", None))
    got = _stack(tcol.broadcast(_parts(x), root=3, mesh=tmesh))
    np.testing.assert_array_equal(got, np.asarray(fn(x)))
    np.testing.assert_array_equal(got, np.full((8, 1), 3.0))


def test_allgather(jmesh, tmesh):
    x = np.arange(8, dtype=np.float32).reshape(8, 1)
    fn = _smap(lambda s: jcol.allgather(s, axis=0), jmesh,
               (JP("dp", None),), JP("dp", None))
    want = np.asarray(fn(x))
    got = _stack(tcol.allgather(_parts(x), axis=0, mesh=tmesh))
    assert got.shape == want.shape == (64, 1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:8], x)


def test_reducescatter(jmesh, tmesh):
    """Each position contributes arange(8); position r keeps 8 r."""
    x = np.tile(np.arange(8, dtype=np.float32), (8, 1))
    fn = _smap(lambda s: jcol.reducescatter(s[0], scatter_axis=0), jmesh,
               (JP("dp", None),), JP("dp"))
    want = np.asarray(fn(x))
    got = np.concatenate([p.numpy() for p in tcol.reducescatter(
        [torch.from_numpy(x[r].copy()) for r in range(N)],
        scatter_axis=0, mesh=tmesh)])
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(got, np.arange(8) * 8.0)


def test_alltoall(jmesh, tmesh):
    """Position i sends row j of its (8, 1) slab to position j."""
    x = np.arange(64, dtype=np.float32).reshape(8, 8, 1)
    fn = _smap(lambda s: jcol.alltoall(s[0], axis_name="dp", split_axis=0,
                                       concat_axis=0),
               jmesh, (JP("dp", None, None),), JP("dp", None))
    want = np.asarray(fn(x)).reshape(8, 8)
    got = np.stack([p.numpy().reshape(-1) for p in tcol.alltoall(
        [torch.from_numpy(x[r].copy()) for r in range(N)], axis_name="dp",
        split_axis=0, concat_axis=0, mesh=tmesh)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x.reshape(8, 8).T)


def test_ring_shift(jmesh, tmesh):
    x = np.arange(8, dtype=np.float32).reshape(8, 1)
    fn = _smap(lambda s: jcol.ring_shift(s, axis_name="dp", shift=1),
               jmesh, (JP("dp", None),), JP("dp", None))
    got = _stack(tcol.ring_shift(_parts(x), axis_name="dp", shift=1,
                                 mesh=tmesh)).ravel()
    np.testing.assert_array_equal(got, np.asarray(fn(x)).ravel())
    np.testing.assert_array_equal(got, np.roll(np.arange(8), 1))


def test_make_mesh_axes():
    """test_collectives.py::test_make_mesh_axes: tp 2 x sp 2 over 8
    positions leaves dp 2; tp 3 does not divide 8."""
    jm = jmake_mesh(tp=2, sp=2)
    tm = make_mesh(tp=2, sp=2, devices=["cpu"] * 8)
    for m in (jm, tm):
        shape = dict(zip(m.axis_names, m.devices.shape))
        assert shape["tp"] == 2 and shape["sp"] == 2 and shape["dp"] == 2
    with pytest.raises(ValueError):
        jmake_mesh(tp=3)
    with pytest.raises(ValueError):
        make_mesh(tp=3, devices=["cpu"] * 8)


def test_send_recv_zero_fills_and_barrier(tmesh):
    """JAX's ppermute fills a position no pair sends to with zeros; the
    port's send_recv does too. A local barrier returns JAX's zero."""
    x = np.arange(8, dtype=np.float32).reshape(8, 1) + 1
    got = _stack(tcol.send_recv(_parts(x), [(0, 3), (5, 1)],
                                axis_name="dp", mesh=tmesh))
    want = np.zeros_like(x)
    want[3], want[1] = x[0], x[5]
    np.testing.assert_array_equal(got, want)
    assert float(tcol.barrier(mesh=tmesh)) == 0.0


# ---------------------------------------------------------------------------
# the op registry's kernels (test_collective_op_kernels.py)
# ---------------------------------------------------------------------------

class _Ctx:
    def __init__(self, ins, attrs=None):
        self._ins = ins
        self._attrs = attrs or {}
        self.is_test = False

    def in_(self, slot, default=None):
        return self._ins.get(slot, default)

    def has_in(self, slot):
        return slot in self._ins

    def attr(self, name, default=None):
        return self._attrs.get(name, default)


def _jkernel(op, attrs=None):
    def fn(x):
        return JREG[op](_Ctx({"X": x}, attrs))["Out"]
    return fn


def _tkernel(op, parts, mesh, attrs=None):
    """The port's op inside a mapped context over `mesh`: X is the held
    positions' parts."""
    with tcol.mapped(mesh):
        return TREG[op](_Ctx({"X": parts}, attrs))["Out"]


@pytest.mark.parametrize("op", ["c_allreduce_sum", "c_allreduce_max",
                                "c_allreduce_min", "c_allreduce_prod"])
def test_c_allreduce_family(jmesh, tmesh, op):
    golden = {"c_allreduce_sum": MIXED.sum(0), "c_allreduce_max":
              MIXED.max(0), "c_allreduce_min": MIXED.min(0),
              "c_allreduce_prod": MIXED.prod(0)}[op]
    fn = _smap(_jkernel(op, {"axis_name": "dp"}), jmesh,
               (JP("dp", None),), JP("dp", None))
    want = np.asarray(fn(MIXED))
    got = _stack(_tkernel(op, _parts(MIXED), tmesh, {"axis_name": "dp"}))
    for r in range(N):
        np.testing.assert_allclose(got[r], golden, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got[r], want[r], rtol=RTOL, atol=ATOL)


def test_c_broadcast_root(jmesh, tmesh):
    x = np.arange(8, dtype=np.float32).reshape(8, 1)
    attrs = {"axis_name": "dp", "root": 5}
    fn = _smap(_jkernel("c_broadcast", attrs), jmesh, (JP("dp", None),),
               JP("dp", None))
    got = _stack(_tkernel("c_broadcast", _parts(x), tmesh, attrs))
    np.testing.assert_array_equal(got, np.asarray(fn(x)))
    assert (got == 5.0).all()


def test_c_allgather_tiles(jmesh, tmesh):
    x = np.arange(16, dtype=np.float32).reshape(8, 2)
    fn = _smap(_jkernel("c_allgather", {"axis_name": "dp"}), jmesh,
               (JP("dp", None),), JP(None, None))
    want = np.asarray(fn(x))
    got = _tkernel("c_allgather", _parts(x), tmesh, {"axis_name": "dp"})
    for part in got:
        np.testing.assert_array_equal(part.numpy(), want)
    np.testing.assert_array_equal(want, x)


def test_c_reducescatter(jmesh, tmesh):
    full = np.broadcast_to(np.arange(8, dtype=np.float32), (8, 8)).copy()

    def body(s):
        return JREG["c_reducescatter"](
            _Ctx({"X": s[0]}, {"axis_name": "dp"}))["Out"]

    fn = _smap(body, jmesh, (JP("dp", None),), JP("dp",))
    want = np.asarray(fn(full))
    got = np.concatenate([p.numpy() for p in _tkernel(
        "c_reducescatter", [torch.from_numpy(full[r].copy())
                            for r in range(N)], tmesh, {"axis_name": "dp"})])
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(got, 8.0 * np.arange(8, dtype=np.float32))


def test_c_sync_is_identity():
    x = np.arange(8, dtype=np.float32)
    for op in ("c_sync_calc_stream", "c_sync_comm_stream"):
        want = JREG[op](_Ctx({"X": jnp.asarray(x)}))["Out"]
        got = TREG[op](_Ctx({"X": torch.from_numpy(x)}))["Out"]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_c_allreduce_outside_mesh_is_identity():
    """No named axis bound (JAX) / no mapped context (the port): the
    ring is a one-card NCCL ring, the identity."""
    x = np.array([1.0, -2.0, 0.0], np.float32)
    for op in ("c_allreduce_sum", "c_allreduce_prod", "c_allreduce_max",
               "c_broadcast", "c_allgather", "c_reducescatter", "alltoall"):
        want = JREG[op](_Ctx({"X": jnp.asarray(x)},
                             {"axis_name": "dp"}))["Out"]
        got = TREG[op](_Ctx({"X": torch.from_numpy(x)},
                            {"axis_name": "dp"}))["Out"]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=op)
        np.testing.assert_array_equal(got.numpy(), x, err_msg=op)


COLLECTIVE_OPS = ("c_allreduce_sum", "c_allreduce", "allreduce",
                  "c_allreduce_max", "c_allreduce_min", "c_allreduce_prod",
                  "c_broadcast", "broadcast", "c_allgather",
                  "c_reducescatter", "alltoall", "c_sync_calc_stream",
                  "c_sync_comm_stream")


def _op_program(pkg, framework, ops, train):
    """x -> fc(3) -> each op of `ops`; with `train` the loss is the mean
    of c_allreduce_sum's output, SGD 0.1. Built under a fresh unique-name
    generator, so both packages name every variable alike."""
    main, startup = framework.Program(), framework.Program()
    main.random_seed = startup.random_seed = 3
    with pkg.core.unique_name.guard(), \
            framework.program_guard(main, startup):
        x = pkg.data(name="x", shape=[-1, 4], dtype="float32")
        h = pkg.layers.fc(x, size=3, name="coll_fc")
        blk = main.global_block()
        outs = {}
        for t in ops:
            o = blk.create_var(name="o_" + t, shape=h.shape,
                               dtype="float32")
            blk.append_op(type=t, inputs={"X": [h]}, outputs={"Out": [o]},
                          attrs={"axis_name": "dp", "root": 1})
            outs[t] = o
        loss = pkg.layers.mean(outs[ops[0]])
        if train:
            pkg.optimizer.SGDOptimizer(0.1).minimize(loss)
    return main, startup, h, outs, loss


# JAX's pmax / pmin have no differentiation rule, so those two run in a
# forward-only Program in both packages
TRAINED = [n for n in COLLECTIVE_OPS
           if n not in ("c_allreduce_max", "c_allreduce_min")]


@pytest.mark.parametrize("ops,train", [
    (TRAINED, True), (("c_allreduce_max", "c_allreduce_min"), False)])
def test_the_thirteen_ops_under_with_mesh_are_the_identity(ops, train):
    """The JAX Executor binds no named axis under CompiledProgram.
    with_mesh (pjit lays values out, it maps nothing), so every
    collective op of a Program is the identity there, and so it is under
    the port's walk at dp 4 x tp 2: each op's output equals its input,
    the fc's output equals JAX's within 1e-5, and the loss too; the 13
    op names are registered in both packages."""
    assert all(n in JREG and n in TREG for n in COLLECTIVE_OPS)
    feed = {"x": (np.arange(32, dtype=np.float32).reshape(8, 4) / 10 - 1)}
    tmain, tstart, th, touts, tloss = _op_program(fluid, tframework, ops,
                                                  train)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor(fluid.CPUPlace()).run(tstart)
    init = {n: scope.get(n).numpy().copy() for n in scope.names()}
    fetch = [th] + list(touts.values()) + [tloss]
    with fluid.scope_guard(scope):
        got = fluid.Executor(fluid.CPUPlace()).run(
            fluid.CompiledProgram(tmain).with_mesh(
                make_mesh(dp=4, tp=2, devices=["cpu"] * 8)),
            feed=feed, fetch_list=fetch)
    jmain, jstart, jh, jouts, jloss = _op_program(jfluid, jframework, ops,
                                                  train)
    from paddle_tpu.core.executor import Scope as JScope, scope_guard
    jscope = JScope()
    for n, v in init.items():
        jscope.set(n, jnp.asarray(v))
    with scope_guard(jscope):
        want = jfluid.Executor().run(
            jfluid.CompiledProgram(jmain).with_mesh(jmake_mesh(dp=4, tp=2)),
            feed=feed, fetch_list=[jh] + list(jouts.values()) + [jloss])
    for out in got[1:-1]:
        np.testing.assert_array_equal(np.asarray(out), np.asarray(got[0]))
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# the world forms: two gloo processes through the launcher
# ---------------------------------------------------------------------------

WORKER = r'''
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)
from paddle_tpu_torch.ops import _REGISTRY as TREG
from paddle_tpu_torch.parallel import collective as tcol, make_mesh
from paddle_tpu_torch.parallel import fleet as fleet_mod

out = sys.argv[1]
flt = fleet_mod.Fleet().init(strategy=fleet_mod.DistributedStrategy())
rank, n = flt.worker_index(), flt.worker_num()
mesh = make_mesh(dp=n)
assert mesh.world and mesh.coords()["dp"] == rank
mixed = np.arange(2 * n, dtype=np.float32).reshape(n, 2) - 2.0
mixed[0, 1] = 0.0
mine = torch.from_numpy(mixed[rank].copy())
res = {"backend": np.array(flt.backend)}
for op in ("sum", "mean", "max", "min", "prod"):
    res["allreduce_" + op] = tcol.allreduce(mine, op, "dp", mesh=mesh).numpy()
res["broadcast"] = tcol.broadcast(mine, root=1, mesh=mesh).numpy()
res["allgather"] = tcol.allgather(mine[None], axis=0, mesh=mesh).numpy()
row = torch.arange(2 * n, dtype=torch.float32) + 10 * rank
res["reducescatter"] = tcol.reducescatter(row, mesh=mesh).numpy()
res["alltoall"] = tcol.alltoall(row, axis_name="dp", mesh=mesh).numpy()
res["ring_shift"] = tcol.ring_shift(mine, axis_name="dp", mesh=mesh).numpy()
res["send_recv"] = tcol.send_recv(mine, [(1, 0)], axis_name="dp",
                                  mesh=mesh).numpy()
res["barrier"] = tcol.barrier(mesh=mesh).numpy()
with tcol.mapped(mesh):
    for op in ("c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
               "c_allreduce_prod", "c_broadcast", "c_allgather",
               "c_reducescatter", "alltoall"):
        class C:
            def in_(self, slot, default=None):
                return mine[None] if op in ("c_allgather",) else (
                    row if op in ("c_reducescatter", "alltoall") else mine)

            def attr(self, name, default=None):
                return {"axis_name": "dp", "root": 1}.get(name, default)
        res["op_" + op] = TREG[op](C())["Out"].numpy()
res["reductions"] = np.array(mesh.reductions)
flt.barrier_worker()
np.savez(os.path.join(out, "rank%d.npz" % rank), **res)
print("COLL_OK", rank)
'''


def run_launcher(script, args, base, nproc, port, timeout=180,
                 selected=None, extra=(), pythonpath=None):
    """`script` under ``python -m paddle_tpu_torch.distributed.launch``
    with `nproc` ranks (gloo on the CPU), in its own session: on a
    timeout the whole group is killed. Returns the launcher's exit code;
    the ranks' logs are under base/log. `pythonpath` goes before the
    repository on the ranks' path."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        ([pythonpath] if pythonpath else []) + [REPO,
                                                env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           f"--nproc_per_node={nproc}", f"--started_port={port}",
           f"--log_dir={base / 'log'}", *extra]
    if selected:
        cmd.append(f"--selected_gpus={selected}")
    proc = subprocess.Popen(cmd + [str(script)] + list(args), env=env,
                            cwd=str(base), start_new_session=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return proc.returncode


def logs(base, nproc):
    return "\n".join(open(base / "log" / f"workerlog.{r}").read()[-2000:]
                     for r in range(nproc)
                     if (base / "log" / f"workerlog.{r}").exists())


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    base = tmp_path_factory.mktemp("coll_world")
    script = base / "coll_worker.py"
    script.write_text(WORKER)
    rc = run_launcher(script, [str(base)], base, 2, free_port())
    assert rc == 0, logs(base, 2)
    return [np.load(base / f"rank{r}.npz") for r in range(2)]


def test_world_collectives_match_numpy(world):
    """Each collective over the 2-rank dp line of a gloo world: the
    reductions (prod over a zero and negatives), broadcast from root 1,
    allgather, the composed reduce-scatter and all-to-all, the ring
    shift, a one-pair send_recv (rank 0 receives, rank 1 gets zeros) and
    the barrier, against numpy; the backend gloo by the layout (no
    card)."""
    n = 2
    mixed = np.arange(2 * n, dtype=np.float32).reshape(n, 2) - 2.0
    mixed[0, 1] = 0.0
    rows = np.stack([np.arange(2 * n, dtype=np.float32) + 10 * r
                     for r in range(n)])
    for r, got in enumerate(world):
        assert str(got["backend"]) == "gloo"
        for op in ("sum", "mean", "max", "min", "prod"):
            np.testing.assert_allclose(got["allreduce_" + op],
                                       getattr(mixed, op)(0), rtol=RTOL,
                                       atol=ATOL, err_msg=op)
        for op in ("max", "min"):
            np.testing.assert_array_equal(got["allreduce_" + op],
                                          getattr(mixed, op)(0))
        np.testing.assert_array_equal(got["broadcast"], mixed[1])
        np.testing.assert_array_equal(got["allgather"], mixed)
        np.testing.assert_allclose(got["reducescatter"],
                                   rows.sum(0).reshape(n, -1)[r], rtol=RTOL)
        np.testing.assert_array_equal(
            got["alltoall"], np.concatenate([rows[s].reshape(n, -1)[r]
                                             for s in range(n)]))
        np.testing.assert_array_equal(got["ring_shift"], mixed[(r - 1) % n])
        np.testing.assert_array_equal(
            got["send_recv"], mixed[1] if r == 0 else np.zeros(2))
        assert float(got["barrier"]) == 0.0


def test_world_ops_in_a_mapped_context_match_numpy(world):
    """The c_* ops inside ``mapped(mesh)`` over the world take this
    process's part and run the collective: their results equal the
    functions' and numpy's."""
    n = 2
    mixed = np.arange(2 * n, dtype=np.float32).reshape(n, 2) - 2.0
    mixed[0, 1] = 0.0
    for got in world:
        for op, fn in (("c_allreduce_sum", "sum"), ("c_allreduce_max",
                                                    "max"),
                       ("c_allreduce_min", "min"),
                       ("c_allreduce_prod", "prod")):
            np.testing.assert_allclose(got["op_" + op],
                                       getattr(mixed, fn)(0), rtol=RTOL,
                                       atol=ATOL, err_msg=op)
        np.testing.assert_array_equal(got["op_c_broadcast"], mixed[1])
        np.testing.assert_array_equal(got["op_c_allgather"], mixed)
        np.testing.assert_array_equal(got["op_c_reducescatter"],
                                      got["reducescatter"])
        np.testing.assert_array_equal(got["op_alltoall"], got["alltoall"])
        # one reduction a collective: the 5 reductions, 7 other
        # functions' (the barrier's included) and the 8 ops'
        assert int(got["reductions"]) == 5 + 7 + 8
