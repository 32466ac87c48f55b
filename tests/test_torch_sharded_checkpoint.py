"""The sharded checkpoint of the port (``io/checkpoint.py``'s
``save_checkpoint_sharded`` / ``load_checkpoint_sharded``), against the
JAX package, on the CPU.

Twins of ``tests/io/test_sharded_checkpoint.py:39,93,114`` (the bitwise
round trip with one file a shard, each smaller than the array; the
partial restore; the elastic reshard from dp 4 onto dp 8 and dp 2 with
the continuation's losses) and ``tests/io/test_checkpoint_faults.py:
212,241`` (a writer killed between shard files leaves no index.json and
the load raises while the good checkpoint restores; a CRC mismatch is
caught before any scope write). The JAX package runs the same Programs
on its virtual CPU devices from the port's startup state; both packages'
checkpoint directories hold the same files with the same CRCs, and each
restores the other's. The two placement rules get a case each: a load
onto a mesh lays a value out as ``jax.device_put`` would and raises
where the mesh does not divide it, where the data-parallel walk leaves
that value replicated. Tolerances: the continuation's losses within
2e-5 relative plus 1e-6 (the JAX twin's), the port's against JAX's
within 2e-4 relative plus 2e-5.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu.core import unique_name as jun
from paddle_tpu.core.executor import Scope as JScope, scope_guard as jguard
from paddle_tpu.io import checkpoint as jckpt
from paddle_tpu.parallel.mesh import make_mesh as jmake_mesh
from paddle_tpu.parallel.transpiler import shard_params_fsdp as jfsdp

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import unique_name as tun
from paddle_tpu_torch.io import checkpoint as ckpt
from paddle_tpu_torch.parallel import (PartitionSpec, ShardedTensor,
                                       make_mesh, shard_params_fsdp)
from paddle_tpu_torch.robustness import ChaosInjector, CheckpointWriteFault

CPU = fluid.CPUPlace()
RESUME_RTOL, RESUME_ATOL = 2e-5, 1e-6
JAX_RTOL, JAX_ATOL = 2e-4, 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _local(dp):
    return make_mesh(dp=dp, devices=["cpu"] * dp)


def _net(pkg):
    L = pkg.layers
    x = L.data("x", shape=[64], dtype="float32")
    label = L.data("label", shape=[8], dtype="float32")
    h = L.fc(x, size=256, act="tanh",
             param_attr=pkg.ParamAttr(name="ck_w1"))
    y = L.fc(h, size=8, param_attr=pkg.ParamAttr(name="ck_w2"))
    loss = L.mean(L.square_error_cost(y, label))
    pkg.optimizer.AdamOptimizer(learning_rate=1e-2).minimize(loss)
    return loss


def _programs(pkg, un, fsdp=True):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    with un.guard(), pkg.program_guard(main, startup):
        loss = _net(pkg)
    if fsdp:
        (shard_params_fsdp if pkg is fluid else jfsdp)(main, min_size=512)
    return main, startup, loss


def _feed(seed=0):
    rs = np.random.RandomState(seed)
    return {"x": rs.randn(8, 64).astype(np.float32),
            "label": rs.randn(8, 8).astype(np.float32)}


def _state(scope):
    out = {}
    for n in scope.names():
        v = scope.get(n)
        v = v.full() if isinstance(v, ShardedTensor) else v
        out[n] = v.numpy().copy()
    return out


def _loss(out):
    return float(np.asarray(out[0]).reshape(-1)[0])


def _trained(steps=3, dp=4):
    """(main, startup, loss, scope, executor, mesh) after `steps` FSDP
    steps at a local dp `dp`."""
    main, startup, loss = _programs(fluid, tun)
    scope, exe = fluid.Scope(), fluid.Executor(CPU)
    mesh = _local(dp)
    with fluid.scope_guard(scope):
        exe.run(startup)
        prog = fluid.CompiledProgram(main).with_mesh(mesh)
        for _ in range(steps):
            exe.run(prog, feed=_feed(), fetch_list=[loss])
    return main, startup, loss, scope, exe, mesh


def test_sharded_roundtrip_bitwise_and_jax_files(tmp_path):
    """test_sharded_checkpoint.py:39: FSDP at dp 4, three steps, an async
    save behind its handle: ck_w1 is written as 4 shard files, each
    smaller than the array; two diverging steps, then a load onto the
    mesh restores every persistable bitwise with its spec; training goes
    on. The JAX package's checkpoint of the same state holds the same
    files and CRCs, and each package restores the other's bitwise."""
    main, startup, loss, scope, exe, mesh = _trained()
    ck = str(tmp_path / "ckpt")
    with fluid.scope_guard(scope):
        handle = fluid.io.save_checkpoint_sharded(
            exe, ck, main_program=main, step=3, async_save=True)
        assert handle.wait()
    w1 = scope.get("ck_w1")
    assert isinstance(w1, ShardedTensor) and w1.spec == PartitionSpec(
        "dp", None)
    files = [f for f in os.listdir(os.path.join(ck, "shards"))
             if f.startswith("ck_w1--")]
    assert sorted(files) == [f"ck_w1--{k}.npy" for k in range(4)]
    nbytes = w1.full().numpy().nbytes
    for f in files:
        assert os.path.getsize(os.path.join(ck, "shards", f)) < nbytes
    saved = _state(scope)
    prog = fluid.CompiledProgram(main).with_mesh(mesh)
    with fluid.scope_guard(scope):
        for _ in range(2):
            exe.run(prog, feed=_feed(1), fetch_list=[loss])
    assert not np.array_equal(_state(scope)["ck_w1"], saved["ck_w1"])
    with fluid.scope_guard(scope):
        meta = fluid.io.load_checkpoint_sharded(exe, ck, main_program=main,
                                                mesh=mesh)
    assert meta["step"] == 3
    for n, want in saved.items():
        np.testing.assert_array_equal(_state(scope)[n], want, err_msg=n)
    assert scope.get("ck_w1").spec == PartitionSpec("dp", None)
    assert scope.get("ck_w1").mesh is mesh
    with fluid.scope_guard(scope):
        out = exe.run(prog, feed=_feed(1), fetch_list=[loss])
    assert np.isfinite(out[0]).all()

    # the JAX package's save of the same state: the same files, CRCs and
    # specs; each package restores the other's checkpoint bitwise
    jmain, _js, _jl = _programs(jfluid, jun)
    jmesh = jmake_mesh(dp=4, devices=jax.devices()[:4])
    jscope = JScope()
    for n, v in saved.items():
        spec = scope.get(n).spec if isinstance(scope.get(n),
                                               ShardedTensor) else ()
        jscope.set(n, jax.device_put(jnp.asarray(v), jax.sharding.
                                     NamedSharding(jmesh, jax.sharding.
                                                   PartitionSpec(*spec))))
    jck = str(tmp_path / "jax_ckpt")
    jckpt.save_checkpoint_sharded(None, jck, main_program=jmain, step=3,
                                  scope=jscope).wait()
    with open(os.path.join(ck, "index.json")) as f:
        mine = json.load(f)["vars"]
    with open(os.path.join(jck, "index.json")) as f:
        theirs = json.load(f)["vars"]
    assert mine.keys() == theirs.keys()
    for n in mine:
        assert mine[n]["shards"] == theirs[n]["shards"], n
        assert mine[n].get("spec") == theirs[n].get("spec"), n
    cross = fluid.Scope()
    fluid.io.load_checkpoint_sharded(exe, jck, main_program=main,
                                     mesh=mesh, scope=cross)
    jback = JScope()
    jckpt.load_checkpoint_sharded(None, ck, main_program=jmain,
                                  mesh=jmesh, scope=jback)
    for n, want in saved.items():
        np.testing.assert_array_equal(_state(cross)[n], want, err_msg=n)
        np.testing.assert_array_equal(np.asarray(jback.get(n)), want,
                                      err_msg=n)


def test_partial_restore(tmp_path):
    """test_sharded_checkpoint.py:93: a plain Executor's state saved
    sharded (every value whole, --full files); after another step a
    var_names restore brings back ck_w1 alone."""
    main, startup, loss = _programs(fluid, tun, fsdp=False)
    scope, exe = fluid.Scope(), fluid.Executor(CPU)
    ck = str(tmp_path / "ckpt2")
    with fluid.scope_guard(scope):
        exe.run(startup)
        exe.run(main, feed=_feed(), fetch_list=[loss])
        fluid.io.save_checkpoint_sharded(exe, ck, main_program=main,
                                         step=1).wait()
        w1, w2 = (scope.get(n).numpy().copy() for n in ("ck_w1", "ck_w2"))
        exe.run(main, feed=_feed(2), fetch_list=[loss])
        fluid.io.load_checkpoint_sharded(exe, ck, main_program=main,
                                         var_names=["ck_w1"])
        np.testing.assert_array_equal(scope.get("ck_w1").numpy(), w1)
        assert not np.array_equal(scope.get("ck_w2").numpy(), w2)
    assert all(f.endswith("--full.npy")
               for f in os.listdir(os.path.join(ck, "shards")))


def test_elastic_reshard_across_mesh_sizes(tmp_path):
    """test_sharded_checkpoint.py:114: a checkpoint saved on dp 4 restores
    onto dp 8 (up) and dp 2 (down) - the recorded specs name axes, so the
    same files lay out over any mesh with that axis - bitwise, and three
    continuation steps match the dp 4 continuation's losses (and JAX's)."""
    main, startup, loss, scope, exe, mesh4 = _trained()
    ck = str(tmp_path / "ckpt")
    with fluid.scope_guard(scope):
        fluid.io.save_checkpoint_sharded(exe, ck, main_program=main,
                                         step=3).wait()
        at_ckpt = _state(scope)
        prog4 = fluid.CompiledProgram(main).with_mesh(mesh4)
        ref = [_loss(exe.run(prog4, feed=_feed(i), fetch_list=[loss]))
               for i in range(3)]
    jmain, _js, jloss = _programs(jfluid, jun)
    jscope = JScope()
    for n, v in at_ckpt.items():
        jscope.set(n, jnp.asarray(v))
    with jguard(jscope):
        jprog = jfluid.CompiledProgram(jmain).with_mesh(
            jmake_mesh(dp=4, devices=jax.devices()[:4]))
        jref = [float(np.asarray(jfluid.Executor().run(
            jprog, feed=_feed(i), fetch_list=[jloss])[0]).reshape(()))
            for i in range(3)]
    np.testing.assert_allclose(ref, jref, rtol=JAX_RTOL, atol=JAX_ATOL)
    for ndev in (8, 2):
        mesh = _local(ndev)
        scope_n, exe_n = fluid.Scope(), fluid.Executor(CPU)
        with fluid.scope_guard(scope_n):
            exe_n.run(startup)
            meta = fluid.io.load_checkpoint_sharded(
                exe_n, ck, main_program=main, mesh=mesh)
            assert meta["step"] == 3
            w1 = scope_n.get("ck_w1")
            assert w1.mesh.shape["dp"] == ndev and len(w1.parts) == ndev
            for n, want in at_ckpt.items():
                np.testing.assert_array_equal(_state(scope_n)[n], want,
                                              err_msg=n)
            prog = fluid.CompiledProgram(main).with_mesh(mesh)
            got = [_loss(exe_n.run(prog, feed=_feed(i), fetch_list=[loss]))
                   for i in range(3)]
        np.testing.assert_allclose(got, ref, rtol=RESUME_RTOL,
                                   atol=RESUME_ATOL)


def test_the_two_placement_rules_at_a_non_dividing_dp(tmp_path):
    """A (256, 8) ck_w2 saved laid out over dp 4 (min_size 256): a load
    onto dp 3 follows jax.device_put and raises, as JAX's load does; a
    load onto no mesh gives whole tensors, and the dp 3 walk then leaves
    ck_w2 (and ck_w1) replicated, as _var_sharding does, and trains."""
    main, startup, loss = _programs(fluid, tun)
    shard_params_fsdp(main, min_size=256)
    scope, exe = fluid.Scope(), fluid.Executor(CPU)
    mesh4 = _local(4)
    ck = str(tmp_path / "ckpt")
    with fluid.scope_guard(scope):
        exe.run(startup)
        exe.run(fluid.CompiledProgram(main).with_mesh(mesh4), feed=_feed(),
                fetch_list=[loss])
        assert isinstance(scope.get("ck_w2"), ShardedTensor)
        fluid.io.save_checkpoint_sharded(exe, ck, main_program=main,
                                         step=1).wait()
    with pytest.raises(ValueError, match="divisible by 3"):
        fluid.io.load_checkpoint_sharded(exe, ck, main_program=main,
                                         mesh=_local(3),
                                         scope=fluid.Scope())
    jmain, _js, _jl = _programs(jfluid, jun)
    with pytest.raises(ValueError):
        jckpt.load_checkpoint_sharded(
            None, ck, main_program=jmain,
            mesh=jmake_mesh(dp=3, devices=jax.devices()[:3]),
            scope=JScope())
    whole = fluid.Scope()
    fluid.io.load_checkpoint_sharded(exe, ck, main_program=main,
                                     scope=whole)
    assert all(isinstance(whole.get(n), torch.Tensor) for n in whole.names())
    with fluid.scope_guard(whole):
        out = exe.run(fluid.CompiledProgram(main).with_mesh(_local(3)),
                      feed=_feed(), fetch_list=[loss])
    assert np.isfinite(out[0]).all()
    for n in ("ck_w1", "ck_w2"):
        assert isinstance(whole.get(n), torch.Tensor), n


def _plain_trained(steps=2):
    main, startup = fluid.Program(), fluid.Program()
    with tun.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        x = L.data("x", shape=[4], dtype="float32")
        y = L.data("y", shape=[1], dtype="float32")
        loss = L.mean(L.square_error_cost(L.fc(x, size=8), y))
        fluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    scope, exe = fluid.Scope(), fluid.Executor(CPU)
    r = np.random.default_rng(0)
    feed = {"x": r.standard_normal((8, 4)).astype(np.float32),
            "y": r.standard_normal((8, 1)).astype(np.float32)}
    with fluid.scope_guard(scope):
        exe.run(startup)
        for _ in range(steps):
            exe.run(main, feed=feed, fetch_list=[loss])
    return exe, main, scope, feed


def test_sharded_crash_between_shards_is_not_loadable(tmp_path):
    """test_checkpoint_faults.py:212: the third file write fails (between
    shard files): no index.json lands, the load raises FileNotFoundError,
    and the previous good checkpoint still restores bitwise."""
    exe, main, scope, feed = _plain_trained()
    d1 = str(tmp_path / "good")
    ckpt.save_checkpoint_sharded(exe, d1, main_program=main, step=1,
                                 scope=scope).wait()
    w_good = scope.get("fc_0.w_0").numpy().copy()
    with fluid.scope_guard(scope):
        exe.run(main, feed=feed, fetch_list=[])
    d2 = str(tmp_path / "torn")
    with ChaosInjector().fail_checkpoint_write(nth=3):
        h = ckpt.save_checkpoint_sharded(exe, d2, main_program=main,
                                         step=2, async_save=True,
                                         scope=scope)
        with pytest.raises(CheckpointWriteFault):
            h.wait()
    assert not os.path.exists(os.path.join(d2, "index.json"))
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint_sharded(exe, d2, main_program=main,
                                     scope=scope)
    meta = ckpt.load_checkpoint_sharded(exe, d1, main_program=main,
                                        scope=scope)
    assert meta["step"] == 1
    np.testing.assert_array_equal(scope.get("fc_0.w_0").numpy(), w_good)


def test_sharded_crc_validation(tmp_path):
    """test_checkpoint_faults.py:241: a shard file's last bytes flipped:
    the load raises CheckpointCorruptError before any scope write;
    validate=False loads it."""
    exe, main, scope, _feed_ = _plain_trained()
    d = str(tmp_path / "ck")
    ckpt.save_checkpoint_sharded(exe, d, main_program=main, step=1,
                                 scope=scope).wait()
    shard = sorted(os.listdir(os.path.join(d, "shards")))[0]
    with open(os.path.join(d, "shards", shard), "r+b") as f:
        f.seek(-4, os.SEEK_END)
        f.write(b"\x13\x37\x13\x37")
    before = scope.get("fc_0.w_0").numpy().copy()
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.load_checkpoint_sharded(exe, d, main_program=main,
                                     scope=scope)
    np.testing.assert_array_equal(scope.get("fc_0.w_0").numpy(), before)
    assert ckpt.load_checkpoint_sharded(
        exe, d, main_program=main, scope=scope,
        validate=False)["step"] == 1
