"""The port's I/O against the JAX package's, on the CPU: parameters,
persistables, inference models, checkpoints (with their faults and the
async writer), and Fluid 1.5's LoDTensor files and ``__model__`` protobuf.

Twins, case for case, of ``tests/io/test_io_roundtrip.py`` (6),
``tests/io/test_checkpoint_faults.py`` (its 9 unsharded cases; the two
sharded ones go with the sharded checkpoints to ROADMAP item 10d),
``tests/io/test_fluid_format.py`` (10) and ``tests/io/test_fluid_proto.py``
(9). Each runs its scenario through both packages from the same weights
(the JAX startup's, carried into the port). Where files are written, the
twin also loads each package's files with the other, and compares them:

- byte-identical: ``save_params`` / ``save_persistables`` per-var .npy
  files, ``__model__.json``, the Fluid LoDTensor files, the Fluid
  ``__model__`` protobuf, and a checkpoint's ``meta.json``;
- equal but for zip timestamps: the .npz files (``save_vars`` with a
  filename, the inference model's ``__params__.npz``, a checkpoint's
  ``state.npz``, async or not): np.savez stamps each zip entry with the
  time of writing, so the twins compare every array and its dtype
  bitwise instead.
"""

import io as _io
import json
import os
import struct
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.io as jio
from paddle_tpu.io import checkpoint as jckpt
from paddle_tpu.io import fluid_format as jff
from paddle_tpu.io import fluid_proto as jfp
from paddle_tpu.robustness import (ChaosInjector as JChaos,
                                   CheckpointWriteFault as JFault)

import paddle_tpu_torch as fluid
import paddle_tpu_torch.io as tio
from paddle_tpu_torch.io import checkpoint as tckpt
from paddle_tpu_torch.io import fluid_format as tff
from paddle_tpu_torch.io import fluid_proto as tfp
from paddle_tpu_torch.robustness import (ChaosInjector as TChaos,
                                         CheckpointWriteFault as TFault)

from test_torch_async_executor import train_net

CPU = fluid.CPUPlace()
# forward outputs of the small nets, port against JAX, from one set of
# weights (f32; the same products in other kernels)
OUT_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_train.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Side:
    def __init__(self, name, pkg, io, ckpt, ff, fp, chaos, fault):
        self.name, self.pkg, self.io, self.ckpt = name, pkg, io, ckpt
        self.ff, self.fp, self.Chaos, self.Fault = ff, fp, chaos, fault
        self.place = pkg.CPUPlace()

    def Scope(self):
        return self.pkg.Scope()

    def exe(self):
        return self.pkg.Executor(self.place)

    def host(self, value):
        return value.detach().cpu().numpy().copy() \
            if isinstance(value, torch.Tensor) else np.array(value)

    def device(self, arr):
        if self.name == "port":
            return torch.from_numpy(np.array(arr, copy=True))
        import jax.numpy as jnp
        return jnp.asarray(arr)


JAX = Side("jax", jfluid, jio, jckpt, jff, jfp, JChaos, JFault)
PORT = Side("port", fluid, tio, tckpt, tff, tfp, TChaos, TFault)
SIDES = (JAX, PORT)


def small_net(pkg, optimizer=None):
    """test_io_roundtrip's net: fc 8 -> 16 relu -> 1, square error."""
    layers = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = layers.data("x", shape=[8], dtype="float32")
        y = layers.data("y", shape=[1], dtype="float32")
        h = layers.fc(x, size=16, act="relu")
        pred = layers.fc(h, size=1)
        loss = layers.mean(layers.square_error_cost(pred, y))
        if optimizer == "adam":
            pkg.optimizer.AdamOptimizer(learning_rate=1e-2).minimize(loss)
        elif optimizer == "sgd":
            pkg.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return main, startup, pred, loss


def io_feed(seed=0, b=8):
    rs = np.random.RandomState(seed)
    xs = rs.rand(b, 8).astype(np.float32)
    return {"x": xs, "y": xs.sum(1, keepdims=True).astype(np.float32)}


def started(build, *args):
    """Both packages' (exe, main, startup, outs..., scope) from the JAX
    startup's weights: {side name: tuple}."""
    out, weights = {}, None
    for side in SIDES:
        main, startup, *rest = build(side.pkg, *args)
        scope, exe = side.Scope(), side.exe()
        exe.run(startup, scope=scope)
        if weights is None:
            weights = {n: np.asarray(scope.get(n)) for n in scope.names()}
        else:
            for n, v in weights.items():
                scope.set(n, side.device(v))
        out[side.name] = (exe, main, startup, *rest, scope)
    return out


def files_of(d):
    return {p: open(os.path.join(d, p), "rb").read()
            for p in sorted(os.listdir(d))
            if os.path.isfile(os.path.join(d, p))}


def assert_npz_equal(a, b):
    """Two .npz files hold the same arrays, bitwise, with one dtype each
    (their zip entries' timestamps may differ)."""
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for n in za.files:
            assert za[n].dtype == zb[n].dtype, n
            np.testing.assert_array_equal(za[n], zb[n], err_msg=n)


# ---------------------------------------------------------------------------
# test_io_roundtrip.py
# ---------------------------------------------------------------------------

def test_save_load_params_roundtrip(tmp_path):
    sides = started(small_net)
    for side in SIDES:
        exe, main, _, pred, loss, scope = sides[side.name]
        before = {p.name: side.host(scope.get(p.name))
                  for p in main.all_parameters()}
        side.io.save_params(exe, str(tmp_path / side.name), main,
                            scope=scope)
        for p in main.all_parameters():            # clobber, load back
            scope.set(p.name, side.device(np.zeros(p.shape, np.float32)))
        side.io.load_params(exe, str(tmp_path / side.name), main,
                            scope=scope)
        for name, val in before.items():
            np.testing.assert_array_equal(side.host(scope.get(name)), val,
                                          err_msg=name)
    # the per-var .npy files are byte-identical, and each package loads
    # the other's
    assert files_of(tmp_path / "jax") == files_of(tmp_path / "port")
    for side, other in ((PORT, "jax"), (JAX, "port")):
        exe, main, _, _, _, scope = sides[side.name]
        s2 = side.Scope()
        side.io.load_params(exe, str(tmp_path / other), main, scope=s2)
        for p in main.all_parameters():
            np.testing.assert_array_equal(side.host(s2.get(p.name)),
                                          side.host(scope.get(p.name)))


def test_inference_model_roundtrip(tmp_path):
    sides = started(small_net)
    feed = io_feed()
    ref = {}
    for side in SIDES:
        exe, main, _, pred, loss, scope = sides[side.name]
        ref[side.name], = exe.run(main, feed=feed, fetch_list=[pred],
                                  scope=scope)
        with side.pkg.scope_guard(scope):
            side.io.save_inference_model(str(tmp_path / side.name), ["x"],
                                         [pred], exe, main_program=main)
        scope2 = side.Scope()
        with side.pkg.scope_guard(scope2):
            prog, feed_names, fetch_vars = side.io.load_inference_model(
                str(tmp_path / side.name), exe)
            got, = exe.run(prog, feed={feed_names[0]: feed["x"]},
                           fetch_list=fetch_vars)
        np.testing.assert_array_equal(got, ref[side.name])
    np.testing.assert_allclose(ref["port"], ref["jax"], rtol=OUT_RTOL)
    a, b = files_of(tmp_path / "jax"), files_of(tmp_path / "port")
    assert a["__model__.json"] == b["__model__.json"]
    assert_npz_equal(tmp_path / "jax" / "__params__.npz",
                     tmp_path / "port" / "__params__.npz")
    # each package serves the other's export
    for side, other in ((PORT, "jax"), (JAX, "port")):
        exe = side.exe()
        with side.pkg.scope_guard(side.Scope()):
            prog, feed_names, fetch_vars = side.io.load_inference_model(
                str(tmp_path / other), exe)
            got, = exe.run(prog, feed={feed_names[0]: feed["x"]},
                           fetch_list=fetch_vars)
        np.testing.assert_array_equal(got, ref[side.name])


def test_checkpoint_resume_exact(tmp_path):
    sides = started(small_net, "adam")
    conts = {}
    for side in SIDES:
        exe, main, _, pred, loss, scope = sides[side.name]
        for i in range(3):
            exe.run(main, feed=io_feed(i), fetch_list=[loss], scope=scope)
        side.io.save_checkpoint(exe, str(tmp_path / side.name), main,
                                step=3, scope=scope)
        cont = [float(exe.run(main, feed=io_feed(3 + i), fetch_list=[loss],
                              scope=scope)[0]) for i in range(3)]
        scope2 = side.Scope()
        meta = side.io.load_checkpoint(exe, str(tmp_path / side.name),
                                       main, scope=scope2)
        assert meta["step"] == 3
        resumed = [float(exe.run(main, feed=io_feed(3 + i),
                                 fetch_list=[loss], scope=scope2)[0])
                   for i in range(3)]
        np.testing.assert_allclose(resumed, cont, rtol=0, atol=0)
        conts[side.name] = cont
    np.testing.assert_allclose(conts["port"], conts["jax"], rtol=1e-5)
    a, b = files_of(tmp_path / "jax"), files_of(tmp_path / "port")
    assert sorted(json.loads(a["meta.json"])["manifest"]) == \
        sorted(json.loads(b["meta.json"])["manifest"])


def test_save_persistables_includes_opt_state(tmp_path):
    sides = started(small_net, "adam")
    for side in SIDES:
        exe, main, _, pred, loss, scope = sides[side.name]
        exe.run(main, feed=io_feed(), fetch_list=[loss], scope=scope)
        side.io.save_persistables(exe, str(tmp_path / side.name), main,
                                  filename="all.npz", scope=scope)
        blob = np.load(str(tmp_path / side.name / "all.npz"))
        assert [k for k in blob.files if "moment" in k.lower()]
    with np.load(tmp_path / "jax" / "all.npz") as za, \
            np.load(tmp_path / "port" / "all.npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        for n in za.files:
            assert za[n].dtype == zb[n].dtype
            np.testing.assert_allclose(zb[n], za[n], rtol=1e-5,
                                       atol=1e-7, err_msg=n)


def test_program_desc_json_roundtrip():
    descs = {}
    for side in SIDES:
        main, _, pred, loss = small_net(side.pkg)
        desc = main.to_json()
        prog2 = type(main).from_json(desc)
        assert [op.type for op in prog2.global_block().ops] == \
            [op.type for op in main.global_block().ops]
        assert sorted(p.name for p in prog2.all_parameters()) == \
            sorted(p.name for p in main.all_parameters())
        descs[side.name] = desc
    assert descs["port"] == descs["jax"]
    # each package reads the other's JSON
    assert fluid.Program.from_json(descs["jax"]).to_json() == descs["jax"]


def test_clone_for_test_drops_nothing_needed():
    for side in SIDES:
        main, _, pred, loss = small_net(side.pkg, "sgd")
        types = [op.type for op in main.clone(
            for_test=True).global_block().ops]
        assert "sgd" not in types
        assert any(t in types for t in ("mul", "matmul", "fc")), types


# ---------------------------------------------------------------------------
# test_checkpoint_faults.py (unsharded)
# ---------------------------------------------------------------------------

def trained(steps=2):
    """Both packages' (exe, main, scope) after `steps` SGD steps of the
    tiny train net from one set of weights."""
    sides = started(train_net)
    out = {}
    for side in SIDES:
        exe, main, _, loss, scope = sides[side.name]
        for i in range(steps):
            r = np.random.default_rng(i)
            exe.run(main, feed={
                "x": r.standard_normal((8, 4)).astype(np.float32),
                "y": r.standard_normal((8, 1)).astype(np.float32)},
                fetch_list=[loss], scope=scope)
        out[side.name] = (exe, main, loss, scope)
    return out


def mutate(exe, main, loss, scope, seed=9):
    r = np.random.default_rng(seed)
    exe.run(main, feed={"x": r.standard_normal((8, 4)).astype(np.float32),
                        "y": r.standard_normal((8, 1)).astype(np.float32)},
            fetch_list=[], scope=scope)


def test_save_checkpoint_round_trip_with_manifest(tmp_path):
    runs = trained()
    metas = {}
    for side in SIDES:
        exe, main, loss, scope = runs[side.name]
        d = str(tmp_path / side.name)
        side.ckpt.save_checkpoint(exe, d, main, step=2, extra={"tag": "t"},
                                  scope=scope)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        assert meta["format"] == side.ckpt.CHECKPOINT_FORMAT == 2
        assert meta["manifest"]
        for entry in meta["manifest"].values():
            assert set(entry) == {"crc32", "shape", "dtype"}
        w_before = side.host(scope.get("fc_0.w_0"))
        mutate(exe, main, loss, scope)
        meta2 = side.ckpt.load_checkpoint(exe, d, main, scope=scope)
        assert meta2["step"] == 2 and meta2["extra"]["tag"] == "t"
        np.testing.assert_array_equal(side.host(scope.get("fc_0.w_0")),
                                      w_before)
        metas[side.name] = meta
    assert sorted(metas["port"]["manifest"]) == \
        sorted(metas["jax"]["manifest"])
    # each package restores the other's checkpoint
    for side, other in ((PORT, "jax"), (JAX, "port")):
        exe, main, loss, scope = runs[side.name]
        s2 = side.Scope()
        assert side.ckpt.load_checkpoint(exe, str(tmp_path / other), main,
                                         scope=s2)["step"] == 2
        np.testing.assert_allclose(side.host(s2.get("fc_0.w_0")),
                                   side.host(scope.get("fc_0.w_0")),
                                   rtol=1e-5, atol=1e-7)


def test_torn_state_write_leaves_previous_checkpoint_intact(tmp_path):
    runs = trained()
    for side in SIDES:
        exe, main, loss, scope = runs[side.name]
        d = str(tmp_path / side.name)
        side.ckpt.save_checkpoint(exe, d, main, step=1, scope=scope)
        with open(os.path.join(d, "state.npz"), "rb") as f:
            good_bytes = f.read()
        with side.Chaos().fail_checkpoint_write(nth=1):
            with pytest.raises(side.Fault):
                side.ckpt.save_checkpoint(exe, d, main, step=2, scope=scope)
        with open(os.path.join(d, "state.npz"), "rb") as f:
            assert f.read() == good_bytes
        assert side.ckpt.load_checkpoint(exe, d, main,
                                         scope=scope)["step"] == 1
        assert not [p for p in os.listdir(d) if ".tmp." in p]


def test_torn_meta_write_keeps_old_commit(tmp_path):
    runs = trained()
    for side in SIDES:
        exe, main, loss, scope = runs[side.name]
        d = str(tmp_path / side.name)
        side.ckpt.save_checkpoint(exe, d, main, step=1, scope=scope)
        with side.Chaos().fail_checkpoint_write(nth=2):
            with pytest.raises(side.Fault):
                side.ckpt.save_checkpoint(exe, d, main, step=2, scope=scope)
        with open(os.path.join(d, "meta.json")) as f:
            assert json.load(f)["step"] == 1


def test_crc_mismatch_raises_corrupt_error(tmp_path):
    runs = trained()
    for side in SIDES:
        exe, main, loss, scope = runs[side.name]
        d = str(tmp_path / side.name)
        side.ckpt.save_checkpoint(exe, d, main, step=1, scope=scope)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        first = sorted(meta["manifest"])[0]
        meta["manifest"][first]["crc32"] ^= 0xDEADBEEF
        with open(os.path.join(d, "meta.json"), "w") as f:
            json.dump(meta, f)
        with pytest.raises(side.ckpt.CheckpointCorruptError):
            side.ckpt.load_checkpoint(exe, d, main, scope=scope)
        assert side.ckpt.load_checkpoint(exe, d, main, scope=scope,
                                         validate=False)["step"] == 1


def test_load_from_retention_root_falls_back_past_corrupt(tmp_path):
    runs = trained()
    for side in SIDES:
        exe, main, loss, scope = runs[side.name]
        root = tmp_path / side.name
        side.ckpt.save_checkpoint(exe, str(root / "ckpt-00000001"), main,
                                  step=1, scope=scope)
        w1 = side.host(scope.get("fc_0.w_0"))
        mutate(exe, main, loss, scope, seed=5)
        side.ckpt.save_checkpoint(exe, str(root / "ckpt-00000002"), main,
                                  step=2, scope=scope)
        with open(root / "ckpt-00000002" / "state.npz", "r+b") as f:
            f.seek(128)
            f.write(b"\xff\xff\xff\xff")
        with pytest.warns(UserWarning, match="falling back"):
            meta = side.ckpt.load_checkpoint(exe, str(root), main,
                                             scope=scope)
        assert meta["step"] == 1
        np.testing.assert_array_equal(side.host(scope.get("fc_0.w_0")), w1)


def test_load_from_retention_root_skips_uncommitted_dir(tmp_path):
    runs = trained()
    for side in SIDES:
        exe, main, loss, scope = runs[side.name]
        root = tmp_path / side.name
        side.ckpt.save_checkpoint(exe, str(root / "ckpt-00000001"), main,
                                  step=1, scope=scope)
        side.ckpt.save_checkpoint(exe, str(root / "ckpt-00000002"), main,
                                  step=2, scope=scope)
        os.unlink(root / "ckpt-00000002" / "meta.json")
        with pytest.warns(UserWarning, match="no commit marker"):
            meta = side.ckpt.load_checkpoint(exe, str(root), main,
                                             scope=scope)
        assert meta["step"] == 1


def test_async_save_round_trip_and_thread_discipline(tmp_path):
    runs = trained()
    for side in SIDES:
        exe, main, loss, scope = runs[side.name]
        d = str(tmp_path / side.name)
        h = side.ckpt.save_checkpoint_async(exe, d, main, step=3,
                                            scope=scope)
        assert isinstance(h, side.ckpt.CheckpointHandle)
        assert h._thread.daemon is False
        assert h.wait() is True
        assert h not in side.ckpt._LIVE_WRITERS
        assert side.ckpt.load_checkpoint(exe, d, main,
                                         scope=side.Scope())["step"] == 3
    # the async checkpoints: meta.json byte-identical but for the arrays'
    # last bits (the twins trained on other kernels), so compare the
    # manifests' layout and each package's restore of the other's
    a, b = files_of(tmp_path / "jax"), files_of(tmp_path / "port")
    ma, mb = json.loads(a["meta.json"]), json.loads(b["meta.json"])
    assert {k: (v["shape"], v["dtype"]) for k, v in ma["manifest"].items()} \
        == {k: (v["shape"], v["dtype"]) for k, v in mb["manifest"].items()}
    for side, other in ((PORT, "jax"), (JAX, "port")):
        exe, main, loss, scope = runs[side.name]
        assert side.ckpt.load_checkpoint(exe, str(tmp_path / other), main,
                                         scope=side.Scope())["step"] == 3


def test_async_checkpoint_files_match_across_packages(tmp_path):
    """One scope's values through both packages' async writers: the same
    meta.json bytes and the same state.npz arrays (the zip timestamps
    aside)."""
    runs = trained()
    exe, main, loss, scope = runs["port"]
    values = {n: scope.get(n).numpy().copy() for n in scope.names()}
    jexe, jmain, _, jscope = runs["jax"]
    for n, v in values.items():
        jscope.set(n, JAX.device(v))
    hj = jckpt.save_checkpoint_async(jexe, str(tmp_path / "jax"), jmain,
                                     step=5, extra={"k": 1}, scope=jscope)
    ht = tckpt.save_checkpoint_async(exe, str(tmp_path / "port"), main,
                                     step=5, extra={"k": 1}, scope=scope)
    assert hj.wait() and ht.wait()
    a, b = files_of(tmp_path / "jax"), files_of(tmp_path / "port")
    assert a["meta.json"] == b["meta.json"]
    assert_npz_equal(tmp_path / "jax" / "state.npz",
                     tmp_path / "port" / "state.npz")


def test_async_save_error_reraises_at_wait(tmp_path):
    runs = trained()
    for side in SIDES:
        exe, main, loss, scope = runs[side.name]
        d = str(tmp_path / side.name)
        with side.Chaos().fail_checkpoint_write(nth=1):
            h = side.ckpt.save_checkpoint_async(exe, d, main, step=1,
                                                scope=scope)
            with pytest.raises(side.Fault):
                h.wait()
        with pytest.raises(side.Fault):
            h.wait()
        assert not os.path.exists(os.path.join(d, "meta.json"))


def test_async_writers_tracked_for_atexit_join(tmp_path):
    runs = trained()
    for side in SIDES:
        exe, main, loss, scope = runs[side.name]
        gate = threading.Event()
        side.ckpt.set_write_fault_hook(lambda kind, path: gate.wait(5))
        try:
            h = side.ckpt.save_checkpoint_async(
                exe, str(tmp_path / side.name), main, step=1, scope=scope)
            assert h in side.ckpt._LIVE_WRITERS
            gate.set()
            assert h.wait() is True
        finally:
            side.ckpt.set_write_fault_hook(None)
            gate.set()
        assert h not in side.ckpt._LIVE_WRITERS


def test_async_snapshot_taken_before_return(tmp_path):
    """The async writer never reads the scope: the host snapshot is taken
    on the calling thread before save_checkpoint_async returns, so a step
    that updates the tensors in place right after cannot reach the
    file."""
    runs = trained()
    exe, main, loss, scope = runs["port"]
    gate = threading.Event()
    tckpt.set_write_fault_hook(lambda kind, path: gate.wait(5))
    try:
        want = scope.get("fc_0.w_0").clone()
        h = tckpt.save_checkpoint_async(exe, str(tmp_path / "ck"), main,
                                        step=1, scope=scope)
        mutate(exe, main, loss, scope)      # in place, while it writes
        assert not torch.equal(scope.get("fc_0.w_0"), want)
        gate.set()
        h.wait()
    finally:
        tckpt.set_write_fault_hook(None)
        gate.set()
    s2 = fluid.Scope()
    tckpt.load_checkpoint(exe, str(tmp_path / "ck"), main, scope=s2)
    torch.testing.assert_close(s2.get("fc_0.w_0"), want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# test_fluid_format.py
# ---------------------------------------------------------------------------

def reference_bytes(arr, lod=(), packed_dims=False):
    """The byte stream exactly as the reference C++ writes it
    (test_fluid_format.py's fixture)."""
    out = bytearray()
    out += struct.pack("<I", 0)
    out += struct.pack("<Q", len(lod))
    for level in lod:
        lv = np.asarray(level, np.uint64)
        out += struct.pack("<Q", lv.nbytes) + lv.tobytes()
    out += struct.pack("<I", 0)
    desc = bytearray()
    enum = {np.dtype(np.float32): 5, np.dtype(np.int64): 3,
            np.dtype(np.float16): 4}[arr.dtype]
    desc += bytes([0x08, enum])
    dims = bytearray()
    for d in arr.shape:
        if not packed_dims:
            dims.append(0x10)
        while True:
            b = d & 0x7F
            d >>= 7
            dims.append(b | 0x80 if d else b)
            if not d:
                break
    desc += (bytes([0x12, len(dims)]) + bytes(dims)) if packed_dims \
        else bytes(dims)
    out += struct.pack("<i", len(desc)) + bytes(desc)
    out += np.ascontiguousarray(arr).tobytes()
    return bytes(out)


@pytest.mark.parametrize("ff", [jff, tff], ids=["jax", "port"])
def test_decodes_reference_layout_fp32_and_int64(ff):
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    got, lod = ff.read_lod_tensor(_io.BytesIO(reference_bytes(a)))
    np.testing.assert_array_equal(got, a)
    assert lod == []
    b = np.array([[1], [2], [300]], np.int64)
    got, _ = ff.read_lod_tensor(_io.BytesIO(reference_bytes(b)))
    np.testing.assert_array_equal(got, b)
    assert got.dtype == np.int64


@pytest.mark.parametrize("ff", [jff, tff], ids=["jax", "port"])
def test_decodes_lod_and_packed_dims(ff):
    raw = reference_bytes(np.zeros((5, 2), np.float32), lod=[[0, 2, 5]],
                          packed_dims=True)
    got, lod = ff.read_lod_tensor(_io.BytesIO(raw))
    assert got.shape == (5, 2)
    assert lod == [[0, 2, 5]]


def test_writer_reader_roundtrip_all_dtypes():
    for dtype in [np.float32, np.float64, np.float16, np.int64, np.int32,
                  np.int16, np.int8, np.uint8, np.bool_]:
        a = (np.arange(24) % 2).astype(dtype).reshape(2, 3, 4)
        bufs = {}
        for name, ff in (("jax", jff), ("port", tff)):
            buf = _io.BytesIO()
            ff.write_lod_tensor(buf, a, lod=[[0, 1, 2]])
            bufs[name] = buf.getvalue()
            buf.seek(0)
            got, lod = ff.read_lod_tensor(buf)
            np.testing.assert_array_equal(got, a)
            assert got.dtype == a.dtype and lod == [[0, 1, 2]]
        assert bufs["jax"] == bufs["port"], dtype
        got, _ = tff.read_lod_tensor(_io.BytesIO(bufs["jax"]))
        np.testing.assert_array_equal(got, a)


def test_per_var_dir_and_combined_file(tmp_path):
    vars_ = {"w": np.random.RandomState(0).rand(4, 2).astype(np.float32),
             "b": np.zeros((2,), np.float32)}
    for name, ff in (("jax", jff), ("port", tff)):
        ff.save_fluid_vars(str(tmp_path / name / "pervar"), vars_)
        got = ff.load_fluid_vars(str(tmp_path / name / "pervar"))
        assert set(got) == {"w", "b"}
        np.testing.assert_array_equal(got["w"], vars_["w"])
        ff.save_fluid_vars(str(tmp_path / name / "comb"), vars_,
                           filename="all", var_order=["w", "b"])
        got = ff.load_fluid_vars(str(tmp_path / name / "comb"),
                                 var_names=["w", "b"], filename="all")
        np.testing.assert_array_equal(got["b"], vars_["b"])
        with pytest.raises(ValueError):
            ff.load_fluid_vars(str(tmp_path / name / "comb"),
                               var_names=["w"], filename="all")
    for sub in ("pervar", "comb"):
        assert files_of(tmp_path / "jax" / sub) == \
            files_of(tmp_path / "port" / sub)
    # tensors (the port's scope values) write the same bytes as arrays
    tff.save_fluid_vars(str(tmp_path / "tensors"),
                        {k: torch.from_numpy(v) for k, v in vars_.items()})
    assert files_of(tmp_path / "tensors") == \
        files_of(tmp_path / "jax" / "pervar")


def fc_program(pkg, w_name, b_name=None, in_dim=4, size=3):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[in_dim], dtype="float32")
        y = pkg.layers.fc(x, size=size, param_attr=pkg.ParamAttr(
            name=w_name), bias_attr=pkg.ParamAttr(name=b_name)
            if b_name else None)
    return main, startup, y


def test_load_fluid_persistables_into_program(tmp_path):
    w = np.random.RandomState(1).rand(4, 3).astype(np.float32)
    b = np.random.RandomState(2).rand(3).astype(np.float32)
    jff.save_fluid_vars(str(tmp_path), {"fc_w": w, "fc_b": b})
    outs = {}
    for side in SIDES:
        main, startup, y = fc_program(side.pkg, "fc_w", "fc_b")
        scope, exe = side.Scope(), side.exe()
        exe.run(startup, scope=scope)
        kw = {"executor": exe} if side is PORT else {}
        with side.pkg.scope_guard(scope):
            n, missing = side.ff.load_fluid_persistables(
                str(tmp_path), main_program=main, **kw)
        assert n == 2 and missing == []
        np.testing.assert_allclose(side.host(scope.get("fc_w")), w,
                                   rtol=1e-6)
        outs[side.name], = exe.run(main, feed={
            "x": np.ones((2, 4), np.float32)}, fetch_list=[y], scope=scope)
        np.testing.assert_allclose(outs[side.name],
                                   np.ones((2, 4)) @ w + b, rtol=1e-5)
    np.testing.assert_allclose(outs["port"], outs["jax"], rtol=1e-6)


def test_combined_default_order_is_insertion_not_sorted(tmp_path):
    wb = np.full((2, 2), 1.0, np.float32)
    wa = np.full((2, 2), 2.0, np.float32)
    for name, ff in (("jax", jff), ("port", tff)):
        ff.save_fluid_vars(str(tmp_path / name), {"w_b": wb, "w_a": wa},
                           filename="all")
        got = ff.load_fluid_vars(str(tmp_path / name),
                                 var_names=["w_b", "w_a"], filename="all")
        np.testing.assert_array_equal(got["w_b"], wb)
        np.testing.assert_array_equal(got["w_a"], wa)
    assert files_of(tmp_path / "jax") == files_of(tmp_path / "port")


def scalar_program(pkg, name, shape):
    main = pkg.Program()
    with pkg.program_guard(main, pkg.Program()):
        main.global_block().create_var(name=name, shape=shape,
                                       dtype="float32", persistable=True)
    return main


def test_scalar_var_rejects_tensor_checkpoint(tmp_path):
    tff.save_fluid_vars(str(tmp_path), {"step": np.zeros((4, 3),
                                                         np.float32)})
    for side in SIDES:
        main = scalar_program(side.pkg, "step", [])
        kw = {"executor": side.exe()} if side is PORT else {}
        with side.pkg.scope_guard(side.Scope()):
            with pytest.raises(ValueError, match="shape mismatch"):
                side.ff.load_fluid_persistables(str(tmp_path),
                                                main_program=main, **kw)


def test_corrupt_file_skipped_in_scan_raised_when_explicit(tmp_path):
    tff.save_fluid_vars(str(tmp_path), {"good": np.ones((2, 2),
                                                        np.float32)})
    (tmp_path / "bad").write_bytes(
        struct.pack("<I", 0) + struct.pack("<Q", 0) + struct.pack("<I", 0)
        + struct.pack("<i", 1) + b"\x80")
    for ff in (jff, tff):
        assert set(ff.load_fluid_vars(str(tmp_path))) == {"good"}
        with pytest.raises((ValueError, IndexError)):
            ff.load_fluid_vars(str(tmp_path), var_names=["bad"])
        with pytest.raises(FileNotFoundError):
            ff.load_fluid_vars(str(tmp_path), var_names=["nope"])


def test_minus_one_dims_accept_any_extent(tmp_path):
    jff.save_fluid_vars(str(tmp_path), {"dyn": np.zeros((7, 3),
                                                        np.float32)})
    for side in SIDES:
        main = scalar_program(side.pkg, "dyn", [-1, 3])
        kw = {"executor": side.exe()} if side is PORT else {}
        scope = side.Scope()
        with side.pkg.scope_guard(scope):
            n, missing = side.ff.load_fluid_persistables(
                str(tmp_path), main_program=main, **kw)
        assert n == 1 and missing == []
        assert tuple(scope.get("dyn").shape) == (7, 3)


def test_shape_mismatch_raises(tmp_path):
    tff.save_fluid_vars(str(tmp_path), {"w2": np.zeros((5, 3), np.float32)})
    for side in SIDES:
        main, startup, _ = fc_program(side.pkg, "w2")
        scope, exe = side.Scope(), side.exe()
        exe.run(startup, scope=scope)
        kw = {"executor": exe} if side is PORT else {}
        with side.pkg.scope_guard(scope):
            with pytest.raises(ValueError, match="shape mismatch"):
                side.ff.load_fluid_persistables(str(tmp_path),
                                                main_program=main, **kw)


# ---------------------------------------------------------------------------
# test_fluid_proto.py
# ---------------------------------------------------------------------------

def _vint(v):
    out = bytearray()
    if v < 0:
        v += 1 << 64
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field, wire):
    return _vint((field << 3) | wire)


def _len_field(field, payload):
    return _tag(field, 2) + _vint(len(payload)) + payload


def _varint_field(field, v):
    return _tag(field, 0) + _vint(v)


def _str_field(field, s):
    return _len_field(field, s.encode())


def _var_desc(name, dtype_enum, dims, persistable, kind=7):
    tensor = _varint_field(1, dtype_enum)
    for d in dims:
        tensor += _varint_field(2, d)
    vtype = _varint_field(1, kind) + _len_field(3, _len_field(1, tensor))
    out = _str_field(1, name) + _len_field(2, vtype)
    if persistable:
        out += _varint_field(3, 1)
    return out


def _op_var(slot, args):
    out = _str_field(1, slot)
    for a in args:
        out += _str_field(2, a)
    return out


def _attr_float(name, v):
    return (_str_field(1, name) + _varint_field(2, 1) + _tag(4, 5)
            + struct.pack("<f", v))


def _attr_int(name, v):
    return _str_field(1, name) + _varint_field(2, 0) + _varint_field(3, v)


def _attr_bool(name, v):
    return (_str_field(1, name) + _varint_field(2, 6)
            + _varint_field(10, int(v)))


def _op(op_type, inputs, outputs, attrs=()):
    out = b""
    for slot, args in inputs:
        out += _len_field(1, _op_var(slot, args))
    for slot, args in outputs:
        out += _len_field(2, _op_var(slot, args))
    out += _str_field(3, op_type)
    for a in attrs:
        out += _len_field(4, a)
    return out


def fixture_program():
    """test_fluid_proto.py's fixture: y = scale(x @ W + b, 2.0) with
    feed/fetch plumbing, byte for byte what the reference C++ writes."""
    FP32 = 5
    vars_ = [_var_desc("feed", FP32, [], False, kind=9),
             _var_desc("fetch", FP32, [], False, kind=10),
             _var_desc("x", FP32, [-1, 4], False),
             _var_desc("W", FP32, [4, 3], True),
             _var_desc("b", FP32, [3], True),
             _var_desc("xw", FP32, [-1, 3], False),
             _var_desc("pre", FP32, [-1, 3], False),
             _var_desc("y", FP32, [-1, 3], False)]
    ops = [_op("feed", [("X", ["feed"])], [("Out", ["x"])],
               [_attr_int("col", 0)]),
           _op("mul", [("X", ["x"]), ("Y", ["W"])], [("Out", ["xw"])],
               [_attr_int("x_num_col_dims", 1),
                _attr_int("y_num_col_dims", 1)]),
           _op("elementwise_add", [("X", ["xw"]), ("Y", ["b"])],
               [("Out", ["pre"])], [_attr_int("axis", -1)]),
           _op("scale", [("X", ["pre"])], [("Out", ["y"])],
               [_attr_float("scale", 2.0), _attr_float("bias", 0.0),
                _attr_bool("bias_after_scale", True)]),
           _op("fetch", [("X", ["y"])], [("Out", ["fetch"])],
               [_attr_int("col", 0)])]
    block = _varint_field(1, 0) + _varint_field(2, -1)
    for v in vars_:
        block += _len_field(3, v)
    for o in ops:
        block += _len_field(4, o)
    return _len_field(1, block)


def test_parse_program_desc_structure():
    progs = {}
    for side in SIDES:
        prog = side.fp.parse_program_desc(fixture_program())
        gb = prog.global_block()
        assert [op.type for op in gb.ops] == [
            "feed", "mul", "elementwise_add", "scale", "fetch"]
        assert gb.vars["W"].persistable and not gb.vars["x"].persistable
        assert tuple(gb.vars["W"].shape) == (4, 3)
        assert gb.vars["W"].dtype == "float32"
        assert gb.ops[3].attr("scale") == pytest.approx(2.0)
        assert gb.ops[3].attr("bias_after_scale") is True
        assert "feed" not in gb.vars and "fetch" not in gb.vars
        progs[side.name] = prog.to_json()
    assert progs["port"] == progs["jax"]


def test_load_and_execute_reference_model(tmp_path):
    (tmp_path / "__model__").write_bytes(fixture_program())
    rs = np.random.RandomState(0)
    W = rs.rand(4, 3).astype(np.float32)
    b = rs.rand(3).astype(np.float32)
    tff.save_fluid_vars(str(tmp_path), {"W": W, "b": b})
    x = rs.rand(5, 4).astype(np.float32)
    outs = {}
    for side in SIDES:
        exe, scope = side.exe(), side.Scope()
        with side.pkg.scope_guard(scope):
            prog, feeds, fetches = side.fp.load_fluid_inference_model(
                str(tmp_path), exe)
            assert feeds == ["x"] and fetches == ["y"]
            outs[side.name], = exe.run(prog, feed={"x": x},
                                       fetch_list=fetches)
        np.testing.assert_allclose(outs[side.name], (x @ W + b) * 2.0,
                                   rtol=1e-5)
    np.testing.assert_allclose(outs["port"], outs["jax"], rtol=1e-6)


def test_missing_params_raise(tmp_path):
    (tmp_path / "__model__").write_bytes(fixture_program())
    for side in SIDES:
        with pytest.raises(ValueError, match="missing"):
            with side.pkg.scope_guard(side.Scope()):
                side.fp.load_fluid_inference_model(str(tmp_path),
                                                   side.exe())


def mlp_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[6], dtype="float32")
        h = pkg.layers.fc(x, size=4, act="relu",
                          param_attr=pkg.ParamAttr(name="w1"),
                          bias_attr=pkg.ParamAttr(name="b1"))
        out_v = pkg.layers.fc(h, size=2, param_attr=pkg.ParamAttr(name="w2"),
                              bias_attr=pkg.ParamAttr(name="b2"))
    return main, startup, out_v


def test_export_roundtrip_through_reference_format(tmp_path):
    """Each package's trained program -> reference __model__ + params ->
    loaded back by BOTH packages -> the same outputs; the two exports
    are byte-identical."""
    sides = started(mlp_program)
    xs = np.random.RandomState(3).rand(5, 6).astype(np.float32)
    want = {}
    for side in SIDES:
        exe, main, _, out_v, scope = sides[side.name]
        with side.pkg.scope_guard(scope):
            want[side.name], = exe.run(main.clone(for_test=True),
                                       feed={"x": xs}, fetch_list=[out_v])
            names = side.fp.save_fluid_inference_model(
                str(tmp_path / side.name), ["x"], [out_v], exe,
                main_program=main)
        assert set(names) == {"w1", "b1", "w2", "b2"}
    assert files_of(tmp_path / "jax") == files_of(tmp_path / "port")
    np.testing.assert_allclose(want["port"], want["jax"], rtol=OUT_RTOL)
    for side in SIDES:
        for src in ("jax", "port"):
            exe = side.exe()
            with side.pkg.scope_guard(side.Scope()):
                prog, feeds, fetches = side.fp.load_fluid_inference_model(
                    str(tmp_path / src), exe)
                assert feeds == ["x"]
                got, = exe.run(prog, feed={"x": xs}, fetch_list=fetches)
            np.testing.assert_allclose(got, want[side.name], rtol=1e-5)


def adam_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[4], dtype="float32")
        y = pkg.layers.data("y", shape=[1], dtype="float32")
        pred = pkg.layers.fc(x, size=1, param_attr=pkg.ParamAttr(name="w"),
                             bias_attr=pkg.ParamAttr(name="b"))
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        pkg.optimizer.AdamOptimizer(1e-3).minimize(loss)
    return main, startup, pred, loss


def test_export_excludes_optimizer_state(tmp_path):
    sides = started(adam_program)
    for side in SIDES:
        exe, main, _, pred, loss, scope = sides[side.name]
        with side.pkg.scope_guard(scope):
            exe.run(main, feed={"x": np.ones((2, 4), np.float32),
                                "y": np.ones((2, 1), np.float32)},
                    fetch_list=[loss])
            names = side.fp.save_fluid_inference_model(
                str(tmp_path / side.name), ["x"], [pred], exe,
                main_program=main)
        assert set(names) == {"w", "b"}
        prog = side.fp.parse_program_desc(
            (tmp_path / side.name / "__model__").read_bytes())
        assert not [n for n in prog.global_block().vars
                    if "moment" in n or "beta" in n
                    or "learning_rate" in n or "@GRAD" in n]
    assert (tmp_path / "jax" / "__model__").read_bytes() == \
        (tmp_path / "port" / "__model__").read_bytes()


def test_export_missing_scope_value_raises(tmp_path):
    for side in SIDES:
        main, startup, pred = fc_program(side.pkg, "w3", in_dim=4, size=1)
        with side.pkg.scope_guard(side.Scope()):    # startup never ran
            with pytest.raises(ValueError, match="no value in the scope"):
                side.fp.save_fluid_inference_model(
                    str(tmp_path / side.name), ["x"], [pred], side.exe(),
                    main_program=main)


def test_encode_sub_block_and_mixed_list_attrs():
    ops = {}
    for side in SIDES:
        op = side.fp._encode_op("while", {"X": ["a"]}, {"Out": ["o"]},
                                {"sub_block": 3, "ratios": [1, 2, 0.5]})
        _t, _ins, _outs, got = side.fp._parse_op(op)
        assert got["sub_block"] == 3
        assert got["ratios"] == pytest.approx([1.0, 2.0, 0.5])
        with pytest.warns(RuntimeWarning, match="unencodable"):
            side.fp._encode_op("x", {}, {}, {"cb": lambda: None})
        ops[side.name] = op
    assert ops["port"] == ops["jax"]


def test_encode_attr_types_roundtrip():
    attrs = {"i": 7, "neg": -3, "big": 1 << 40, "f": 0.5, "s": "hi",
             "flag": True, "ints": [1, -2], "floats": [1.0, 2.5],
             "strs": ["a", "b"], "longs": [1 << 40, 2]}
    ops = {}
    for side in SIDES:
        op = side.fp._encode_op("dummy", {"X": ["a"]}, {"Out": ["o"]},
                                attrs)
        op_type, ins, outs, got = side.fp._parse_op(op)
        assert op_type == "dummy"
        assert got["i"] == 7 and got["neg"] == -3 and got["big"] == 1 << 40
        assert got["f"] == pytest.approx(0.5) and got["s"] == "hi"
        assert got["flag"] is True
        assert got["ints"] == [1, -2] and got["strs"] == ["a", "b"]
        assert got["longs"] == [1 << 40, 2]
        assert got["floats"] == pytest.approx([1.0, 2.5])
        ops[side.name] = op
    assert ops["port"] == ops["jax"]


def test_attr_negative_and_packed_decoding():
    op = _op("concat", [("X", ["a", "b"])], [("Out", ["o"])],
             [_attr_int("axis", -1)])
    for side in SIDES:
        op_type, ins, outs, attrs = side.fp._parse_op(op)
        assert op_type == "concat" and attrs["axis"] == -1
        assert ins["X"] == ["a", "b"]


def test_encode_program_desc_matches_across_packages():
    """The same Program, built in each package, encodes to the same
    ProgramDesc bytes."""
    raws = {}
    for side in SIDES:
        main, _, out_v = mlp_program(side.pkg)
        raws[side.name] = side.fp.encode_program_desc(
            main, ["x"], [out_v.name])
    assert raws["port"] == raws["jax"]


# ---------------------------------------------------------------------------
# the slice's names, and what importing them pulls in
# ---------------------------------------------------------------------------

SLICE_MODULES = (
    "paddle_tpu_torch", "paddle_tpu_torch.core.executor",
    "paddle_tpu_torch.core.lod", "paddle_tpu_torch.core.data_feeder",
    "paddle_tpu_torch.core.bucketing", "paddle_tpu_torch.reader",
    "paddle_tpu_torch.reader.decorator", "paddle_tpu_torch.reader.native",
    "paddle_tpu_torch.reader.dataloader", "paddle_tpu_torch.io",
    "paddle_tpu_torch.io.state", "paddle_tpu_torch.io.inference_io",
    "paddle_tpu_torch.io.fluid_format", "paddle_tpu_torch.io.fluid_proto",
    "paddle_tpu_torch.io.checkpoint", "paddle_tpu_torch.io.dataset",
    "paddle_tpu_torch.robustness", "paddle_tpu_torch.robustness.guard",
    "paddle_tpu_torch.robustness.chaos",
    "paddle_tpu_torch.robustness.trainer", "paddle_tpu_torch.dataset",
    "paddle_tpu_torch.incubate.data_generator",
    "paddle_tpu_torch.utils.native")


def test_slice_modules_import_neither_jax_nor_paddle_tpu():
    """A fresh interpreter imports every module of the slice, builds
    nothing and touches no card: no jax module and no module of the JAX
    package is loaded afterwards."""
    import subprocess
    import sys
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'jaxlib' or m == 'paddle_tpu' "
            "or m.startswith('paddle_tpu.'))\n"
            "print(bad)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_slice_names_under_the_jax_packages_places():
    import paddle_tpu.robustness as jrob_mod
    import paddle_tpu.reader as jreader_mod
    import paddle_tpu_torch.reader as treader_mod
    import paddle_tpu_torch.robustness as trob_mod
    for name in ("GuardConfig", "GuardedTrainer", "RecoveryPolicy",
                 "TrainResult", "lr_backoff", "CheckpointWriteFault",
                 "NonFiniteError", "ChaosInjector", "CheckpointManager",
                 "PreemptionHandler"):
        assert hasattr(jrob_mod, name) and hasattr(trob_mod, name), name
    for name in ("save_vars", "save_params", "save_persistables",
                 "load_vars", "load_params", "load_persistables",
                 "save_inference_model", "load_inference_model",
                 "save_checkpoint", "load_checkpoint",
                 "save_checkpoint_async", "CheckpointHandle",
                 "load_fluid_vars", "save_fluid_vars",
                 "load_fluid_persistables", "parse_program_desc",
                 "encode_program_desc", "load_fluid_inference_model",
                 "save_fluid_inference_model", "get_parameter_value",
                 "get_parameter_value_by_name"):
        assert hasattr(jio, name) and hasattr(tio, name), name
    for name in ("batch", "shuffle", "buffered", "cache", "chain",
                 "compose", "map_readers", "firstn", "xmap_readers",
                 "multiprocess_reader", "ComposeNotAligned", "Fake",
                 "PipeReader", "DataLoader", "device_prefetch",
                 "pack_sequences", "packing_efficiency"):
        assert hasattr(jreader_mod, name) and hasattr(treader_mod, name), \
            name
    for name in ("Executor", "FetchHandle", "FeedBucketer", "DataFeeder",
                 "LoDTensor", "create_lod_tensor",
                 "create_random_int_lodtensor", "save_params",
                 "save_persistables", "save_vars", "load_params",
                 "load_persistables", "load_vars", "save_inference_model",
                 "load_inference_model", "DatasetFactory",
                 "InMemoryDataset", "QueueDataset", "FileInstantDataset",
                 "BoxPSDataset", "DataFeedDesc", "io", "reader",
                 "robustness", "dataset"):
        assert hasattr(jfluid, name) and hasattr(fluid, name), name


def test_bert_inference_models_reload_bitwise_and_across_packages(tmp_path):
    """Phase 26b's path at a small size: a trained BERT's pooled output
    and MLM logits through save_inference_model and the Fluid format,
    reloaded in a fresh scope and executor: bitwise the trained
    program's clone(for_test=True) in the port; the JAX package serves
    the port's two exports within OUT_RTOL (dropout 0, one set of
    weights)."""
    from paddle_tpu.models import bert as jbert
    from paddle_tpu_torch.models import bert as tbert
    cfg = tbert.BertConfig(vocab_size=256, hidden_size=64,
                           num_hidden_layers=2, num_attention_heads=2,
                           intermediate_size=128, max_position_embeddings=32,
                           max_predictions_per_seq=4, hidden_dropout_prob=0.0,
                           attention_probs_dropout_prob=0.0)

    def net(pkg, bert):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 7
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            _f, loss, _m, _a = bert.build_pretrain_net(cfg, seq_len=16)
            pkg.optimizer.AdamOptimizer(1e-3).minimize(loss)
        return main, startup, loss

    sides = started(lambda pkg: net(pkg, tbert if pkg is fluid else jbert))
    exe, main, _, loss, scope = sides["port"]
    feed = tbert.make_pretrain_feed(cfg, 16, 4, seed=3)
    for _ in range(2):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    gb = main.global_block()
    pooled = next(op.input("X")[0] for op in gb.ops
                  if "nsp_fc_w" in op.input_names)
    logits = next(op.output_names[0] for op in gb.ops
                  if op.type == "elementwise_add"
                  and "mlm_out_b" in op.input_names)
    names = ["src_ids", "sent_ids", "input_mask", "mask_pos"]
    infeed = {k: feed[k] for k in names}
    want = exe.run(main.clone(for_test=True), feed=infeed,
                   fetch_list=[pooled, logits], scope=scope)
    with fluid.scope_guard(scope):
        tio.save_inference_model(str(tmp_path / "inf"), names,
                                 [pooled, logits], exe, main_program=main)
        tio.save_fluid_inference_model(str(tmp_path / "fl"), names,
                                       [pooled, logits], exe,
                                       main_program=main)
    for side in SIDES:
        for sub, loader in (("inf", side.io.load_inference_model),
                            ("fl", side.fp.load_fluid_inference_model)):
            exe2, s2 = side.exe(), side.Scope()
            with side.pkg.scope_guard(s2):
                prog, feeds, fetches = loader(str(tmp_path / sub), exe2)
                got = exe2.run(prog, feed={k: infeed[k] for k in feeds},
                               fetch_list=fetches)
            for a, b in zip(got, want):
                if side is PORT:
                    np.testing.assert_array_equal(a, b)
                else:
                    np.testing.assert_allclose(a, b, rtol=OUT_RTOL,
                                               atol=1e-6)
