"""The port's input pipeline against the JAX package's, on the CPU: the
reader decorators, the native prefetch ring and loader pool (the repo's
``csrc/prefetch.cc`` and ``csrc/loader_pool.cc``, built by the port's own
``utils/native.py`` into ``paddle_tpu_torch/csrc/build/``), ``DataLoader`` and
``device_prefetch``, ``FeedBucketer`` and ``LoDTensor``.

Twins, case for case, of ``tests/io/test_reader_decorators.py`` (11),
``tests/io/test_native_prefetch.py`` (9), ``tests/io/test_loader_pool.py``
(7), ``tests/core/test_bucketing.py`` (15) and
``tests/api/test_lod_tensor.py`` (5): the same inputs through both
packages, the outputs equal (these are host modules: bitwise). Two cases
change form: the JAX package's device_prefetch places a batch with a
``jax.sharding``, the port's on a torch device (its twin hands it a
``CPUPlace``); and a bucketer refuses a device array in the JAX package,
a tensor in the port. The reference's waits on a blocked producer use
``time.sleep``; the twins wait on the thread itself (a bounded
``join``), and the abandoned-iterator case relies on the reader joining
its producer, not on a sleep.
"""

import gzip
import os
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import reader as jreader
from paddle_tpu.core import bucketing as jbucketing
from paddle_tpu.core.data_feeder import DataFeeder as JFeeder
from paddle_tpu.core.executor import Scope as JScope
from paddle_tpu.reader import native as jnative

import paddle_tpu_torch as fluid
from paddle_tpu_torch import reader as treader
from paddle_tpu_torch.core import bucketing as tbucketing
from paddle_tpu_torch.core.data_feeder import DataFeeder as TFeeder
from paddle_tpu_torch.reader import native as tnative
from paddle_tpu_torch.utils.native import BUILD_DIR, library_path

from test_torch_async_executor import train_net

READERS = pytest.mark.parametrize("reader", [jreader, treader],
                                  ids=["jax", "port"])
NATIVE = pytest.mark.parametrize("native", [jnative, tnative],
                                 ids=["jax", "port"])
BUCKETING = pytest.mark.parametrize("bk", [jbucketing, tbucketing],
                                    ids=["jax", "port"])


def _r(items):
    def rd():
        yield from items
    return rd


def test_port_builds_native_sources_into_its_own_directory():
    """The port's ring and pool come from the repo's csrc/ sources, built
    by utils/native.py under paddle_tpu_torch/csrc/build/ (not the JAX
    package's csrc/build/)."""
    assert tnative.available()
    tnative.load_pool_library()
    for src in ("prefetch.cc", "loader_pool.cc"):
        path, so = library_path(src)
        assert path.endswith(f"csrc/{src}") and so.startswith(BUILD_DIR)
        assert "paddle_tpu_torch" in so and os.path.exists(so)


# ---------------------------------------------------------------------------
# test_reader_decorators.py
# ---------------------------------------------------------------------------

@READERS
def test_compose_aligned_and_not(reader):
    c = reader.compose(_r([1, 2]), _r([(10, 11), (20, 21)]))
    assert list(c()) == [(1, 10, 11), (2, 20, 21)]
    with pytest.raises(reader.ComposeNotAligned):
        list(reader.compose(_r([1, 2, 3]), _r([1]))())
    ok = reader.compose(_r([1, 2, 3]), _r([1]), check_alignment=False)
    assert list(ok()) == [(1, 1)]


@READERS
def test_fake_replays_first_sample(reader):
    fake = reader.Fake()
    src = _r([("a", 1), ("b", 2)])
    assert list(fake(src, max_num=4)()) == [("a", 1)] * 4
    assert list(fake(src, max_num=2)()) == [("a", 1)] * 2


@READERS
def test_fake_abandoned_generator_does_not_shorten_next(reader):
    fake = reader.Fake()
    g = fake(_r(["x", "y"]), max_num=5)()
    next(g), next(g)
    assert len(list(fake(_r(["x"]), max_num=5)())) == 5


@READERS
def test_compose_unaligned_stops_at_shortest(reader):
    out = list(reader.compose(_r([(1, 2), (3, 4), (5, 6)]), _r([9]),
                              check_alignment=False)())
    assert out == [(1, 2, 9)]


@READERS
def test_compose_handles_numpy_samples(reader):
    a = _r([np.arange(4), np.arange(4) + 1])
    b = _r([np.zeros(3), np.ones(3)])
    out = list(reader.compose(a, b)())
    assert len(out) == 2 and len(out[0]) == 2
    np.testing.assert_array_equal(out[1][0], np.arange(4) + 1)


def test_device_prefetch_dict_and_list():
    batches = [{"x": np.full((4, 2), i, np.float32)} for i in range(5)]
    got = list(treader.device_prefetch(iter(batches), depth=2,
                                       device="cpu"))
    jgot = list(jreader.device_prefetch(iter(batches), depth=2))
    assert len(got) == len(jgot) == 5
    for i, (b, jb) in enumerate(zip(got, jgot)):
        assert isinstance(b["x"], torch.Tensor)
        np.testing.assert_array_equal(b["x"].numpy(), batches[i]["x"])
        np.testing.assert_array_equal(b["x"].numpy(), np.asarray(jb["x"]))
    lists = [[np.ones(3), np.zeros(2)] for _ in range(3)]
    got = list(treader.device_prefetch(lists, depth=4, device="cpu"))
    assert len(got) == 3 and isinstance(got[0], list)


def test_device_prefetch_with_sharding():
    """The JAX twin places batches with a NamedSharding; the port's
    places them on a torch device, given as a Place: the batches land
    there, and without a device it means the card (which raises
    without CUDA)."""
    batches = [np.arange(4, dtype=np.float32) for _ in range(3)]
    got = list(treader.device_prefetch(iter(batches),
                                       device=fluid.CPUPlace()))
    assert all(g.device == torch.device("cpu") for g in got)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            list(treader.device_prefetch(iter(batches)))


@READERS
def test_pipereader_plain(reader, tmp_path):
    p = tmp_path / "lines.txt"
    p.write_text("alpha\nbeta\ngamma\n")
    assert list(reader.PipeReader(f"cat {p}").get_line()) == \
        ["alpha", "beta", "gamma"]


@READERS
def test_pipereader_gzip(reader, tmp_path):
    p = tmp_path / "lines.gz"
    with gzip.open(p, "wb") as f:
        f.write(b"one\ntwo\n")
    pr = reader.PipeReader(f"cat {p}", file_type="gzip")
    assert list(pr.get_line()) == ["one", "two"]


def _rng10():
    def gen():
        yield from range(10)
    return gen


def test_batch_shuffle_buffered_cache_chain():
    outs = {}
    for name, reader in (("jax", jreader), ("port", treader)):
        out = [list(reader.batch(_rng10(), 3)()),
               list(reader.batch(_rng10(), 3, drop_last=True)()),
               sorted(reader.shuffle(_rng10(), buf_size=4)()),
               list(reader.buffered(_rng10(), 3)())]
        c = reader.cache(_rng10())
        out += [list(c()), list(c()),
                list(reader.chain(_rng10(), _rng10())()),
                list(reader.firstn(_rng10(), 4)()),
                list(reader.map_readers(lambda a, b: a * b, _rng10(),
                                        _rng10())())]
        assert [len(b) for b in out[0]] == [3, 3, 3, 1]
        assert [len(b) for b in out[1]] == [3, 3, 3]
        assert out[2] == out[3] == out[4] == out[5] == list(range(10))
        assert out[6] == list(range(10)) * 2
        assert out[7] == [0, 1, 2, 3]
        assert out[8] == [i * i for i in range(10)]
        outs[name] = out
    assert outs["port"] == outs["jax"]


def test_xmap_and_multiprocess_readers():
    def rng12():
        def gen():
            yield from range(12)
        return gen

    for reader in (jreader, treader):
        assert list(reader.xmap_readers(lambda x: x * 10, rng12(),
                                        process_num=3, buffer_size=4,
                                        order=True)()) == \
            [i * 10 for i in range(12)]
        assert sorted(reader.xmap_readers(lambda x: x + 1, rng12(),
                                          process_num=3, buffer_size=4,
                                          order=False)()) == \
            [i + 1 for i in range(12)]
        assert sorted(reader.multiprocess_reader([rng12(), rng12()])()) == \
            sorted(list(range(12)) * 2)


# ---------------------------------------------------------------------------
# test_native_prefetch.py
# ---------------------------------------------------------------------------

def test_serialize_roundtrip_positional():
    batch = [np.arange(12, dtype=np.float32).reshape(3, 4),
             np.array([1, 2, 3], np.int64)]
    raw = tnative.serialize_batch(batch)
    assert raw == jnative.serialize_batch(batch)
    for native in (jnative, tnative):
        out = native.deserialize_batch(raw)
        assert isinstance(out, list)
        np.testing.assert_array_equal(out[0], batch[0])
        np.testing.assert_array_equal(out[1], batch[1])
        assert out[0].dtype == np.float32 and out[1].dtype == np.int64


def test_serialize_roundtrip_dict_and_scalar():
    batch = {"x": np.float32(3.5) * np.ones((2, 2), np.float32),
             "step": np.array(7, np.int32)}
    raw = tnative.serialize_batch(batch)
    assert raw == jnative.serialize_batch(batch)
    out = tnative.deserialize_batch(raw)
    assert set(out) == {"x", "step"}
    np.testing.assert_array_equal(out["x"], batch["x"])
    assert out["step"] == 7


@NATIVE
def test_ring_order_and_eof(native):
    ring = native.NativeRing(slots=4)
    for i in range(3):
        assert ring.push(bytes([i]) * (i + 1))
    ring.close()
    got = []
    while True:
        b = ring.pop()
        if b is None:
            break
        got.append(b)
    assert got == [b"\x00", b"\x01\x01", b"\x02\x02\x02"]
    assert ring.pop() is None
    assert not ring.push(b"x")


@NATIVE
def test_ring_backpressure(native):
    """Producer blocks when the ring is full until the consumer drains."""
    ring = native.NativeRing(slots=2)
    assert ring.push(b"a") and ring.push(b"b")
    state = {"pushed": False}

    def produce():
        ring.push(b"c")  # must block: ring full
        state["pushed"] = True

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    t.join(timeout=0.05)
    assert t.is_alive() and not state["pushed"]
    assert ring.pop() == b"a"
    t.join(timeout=5)
    assert state["pushed"]
    ring.close()


@NATIVE
def test_batches_are_writable(native):
    def src():
        yield [np.zeros((2, 2), np.float32)]

    batch, = list(native.native_buffered(src, size=2)())
    batch[0] += 1.0
    np.testing.assert_array_equal(batch[0], np.ones((2, 2), np.float32))


@NATIVE
def test_abandoned_iterator_unblocks_producer(native):
    """Closing the iterator closes the ring, so the producer blocked in
    push exits; the reader joins it before close() returns."""
    n_before = threading.active_count()

    def src():
        for i in range(100):
            yield [np.full((64,), i, np.float32)]

    it = native.native_buffered(src, size=2)()
    next(it)
    it.close()
    assert threading.active_count() <= n_before + 1


@NATIVE
def test_native_buffered_reader(native):
    def src():
        for i in range(10):
            yield [np.full((4, 4), i, np.float32)]

    out = list(native.native_buffered(src, size=3)())
    assert len(out) == 10
    for i, batch in enumerate(out):
        np.testing.assert_array_equal(batch[0],
                                      np.full((4, 4), i, np.float32))


@NATIVE
def test_native_buffered_propagates_producer_error(native):
    def src():
        yield [np.zeros(2, np.float32)]
        raise RuntimeError("boom")

    it = native.native_buffered(src, size=2)()
    next(it)
    with pytest.raises(RuntimeError, match="boom"):
        list(it)


def test_dataloader_uses_native_ring():
    def batches():
        for i in range(5):
            yield {"x": np.full((2, 3), i, np.float32)}

    seen = {}
    for name, reader in (("jax", jreader), ("port", treader)):
        loader = reader.DataLoader.from_generator(capacity=4)
        loader.set_batch_generator(batches)
        seen[name] = [b["x"][0, 0] for b in loader]
    assert seen["port"] == seen["jax"] == [0.0, 1.0, 2.0, 3.0, 4.0]
    assert loader.ring == "native"


# ---------------------------------------------------------------------------
# test_loader_pool.py
# ---------------------------------------------------------------------------

def _data(n=23, feat=5):
    rng = np.random.default_rng(0)
    return {"x": rng.standard_normal((n, feat)).astype(np.float32),
            "y": np.arange(n, dtype=np.int64)}


def _both(fn):
    """fn(native) for both packages; the batches must be equal."""
    a, b = fn(jnative), fn(tnative)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, dict):
            assert sorted(x) == sorted(y)
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])
        else:
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v)
    return b


def test_ordered_no_shuffle_matches_slices():
    d = _data()
    pools = {}

    def run(native):
        pools[native] = native.NativeLoaderPool(d, batch_size=4,
                                                n_workers=3)
        return list(pools[native])
    got = _both(run)
    assert pools[tnative].total_batches == 6
    for i, b in enumerate(got):
        np.testing.assert_array_equal(b["x"], d["x"][i * 4:(i + 1) * 4])
    assert got[-1]["x"].shape[0] == 3


def test_drop_last_and_positional():
    xs = np.arange(22, dtype=np.int32).reshape(11, 2)
    got = _both(lambda native: list(native.NativeLoaderPool(
        [xs], batch_size=4, drop_last=True, n_workers=2)))
    assert len(got) == 2
    for b in got:
        assert isinstance(b, list) and b[0].shape == (4, 2)
    np.testing.assert_array_equal(np.concatenate([b[0] for b in got]),
                                  xs[:8])


def test_seeded_shuffle_deterministic_and_complete():
    d = _data(n=31)
    got = _both(lambda native: list(native.NativeLoaderPool(
        d, batch_size=8, shuffle_seed=7, n_workers=4)))
    seen = np.concatenate([b["y"] for b in got])
    assert sorted(seen.tolist()) == list(range(31))
    assert not np.array_equal(seen, np.arange(31))
    for b in got:
        np.testing.assert_array_equal(b["x"], d["x"][b["y"]])


def test_epochs_reshuffle_per_epoch():
    d = _data(n=16)
    got = _both(lambda native: list(native.NativeLoaderPool(
        d, batch_size=16, epochs=3, shuffle_seed=3, n_workers=2)))
    assert len(got) == 3
    e0, e1 = got[0]["y"], got[1]["y"]
    assert sorted(e0.tolist()) == sorted(e1.tolist()) == list(range(16))
    assert not np.array_equal(e0, e1)


def test_many_workers_stress():
    n, feat = 257, 3
    d = {"x": np.arange(n * feat, dtype=np.float32).reshape(n, feat)}
    got = _both(lambda native: list(native.NativeLoaderPool(
        d, batch_size=2, n_workers=8, slots=4)))
    np.testing.assert_array_equal(np.concatenate([b["x"] for b in got]),
                                  d["x"])


@NATIVE
def test_pool_reader_facade_and_early_abandon(native):
    it = native.pool_reader(_data(n=64), batch_size=4, n_workers=2)()
    assert next(it)["x"].shape == (4, 5)
    it.close()


def test_scalar_per_sample_sources():
    y = np.arange(9, dtype=np.float64)
    got = _both(lambda native: list(native.NativeLoaderPool(
        {"y": y}, batch_size=3, n_workers=2)))
    assert [b["y"].shape for b in got] == [(3,)] * 3
    np.testing.assert_array_equal(np.concatenate([b["y"] for b in got]), y)


# ---------------------------------------------------------------------------
# test_bucketing.py
# ---------------------------------------------------------------------------

@BUCKETING
def test_bucket_size_power_of_two(bk):
    assert [bk.bucket_size(n) for n in (0, 1, 2, 3, 5, 8, 9, 33, 1000)] \
        == [1, 1, 2, 4, 8, 8, 16, 64, 1024]


@BUCKETING
def test_bucket_size_min_floor_and_max_cap(bk):
    assert bk.bucket_size(3, min_size=16) == 16
    assert bk.bucket_size(20, min_size=16) == 32
    assert bk.bucket_size(20, max_size=24) == 24
    with pytest.raises(ValueError, match="exceeds the bucket cap"):
        bk.bucket_size(33, max_size=32)
    with pytest.raises(ValueError):
        bk.bucket_size(-1)


def _both_bucketed(feed, **kw):
    """The same feed through both packages' FeedBucketer: equal keys,
    arrays and dtypes; returns the port's."""
    a = jbucketing.FeedBucketer(**kw).bucket(feed)
    b = tbucketing.FeedBucketer(**kw).bucket(feed)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
    return b


def test_bucket_pads_batch_and_emits_mask():
    out = _both_bucketed({"x": np.ones((5, 4), np.float32),
                          "y": np.full((5, 1), 7, np.int32)},
                         mask_name="batch_mask")
    assert out["x"].shape == (8, 4) and out["y"].shape == (8, 1)
    np.testing.assert_array_equal(out["x"][5:], 0)
    np.testing.assert_array_equal(out["y"][:5], 7)
    mask = out["batch_mask"]
    assert mask.shape == (8, 1) and mask.dtype == np.float32
    np.testing.assert_array_equal(mask.ravel(), [1, 1, 1, 1, 1, 0, 0, 0])


def test_mask_present_even_without_padding():
    out = _both_bucketed({"x": np.ones((8, 4), np.float32)},
                         mask_name="batch_mask")
    assert out["batch_mask"].shape == (8, 1) and out["batch_mask"].all()


@BUCKETING
def test_custom_pad_values_and_disagreeing_batch_raises(bk):
    b = bk.FeedBucketer(pad_values={"ids": -1})
    out = b.bucket({"ids": np.zeros((3, 2), np.int32)})
    np.testing.assert_array_equal(out["ids"][3:], -1)
    with pytest.raises(ValueError, match="disagrees"):
        b.bucket({"a": np.ones((3, 2)), "b": np.ones((5, 2))})


def test_dynamic_axes_sequence_padding_and_passthrough():
    out = _both_bucketed({"tok": np.ones((3, 10), np.int32),
                          "aux": np.ones((3, 9), np.float32)},
                         dynamic_axes={"tok": (0, 1)}, mask_name=None)
    assert out["tok"].shape == (4, 16)
    assert out["aux"].shape == (3, 9)
    assert "batch_mask" not in out


def test_device_array_rejected_with_guidance():
    """The JAX package refuses a device array; the port refuses a tensor
    (padding it would pull it back to the host)."""
    with pytest.raises(TypeError, match="before the upload"):
        tbucketing.FeedBucketer().bucket({"x": torch.ones(3, 2)})
    import jax
    with pytest.raises(TypeError, match="before device_put"):
        jbucketing.FeedBucketer().bucket(
            {"x": jax.device_put(np.ones((3, 2), np.float32))})


@BUCKETING
def test_user_supplied_mask_preserved_not_overwritten(bk):
    b = bk.FeedBucketer(mask_name="batch_mask")
    user_mask = np.array([[1], [1], [1], [1], [0], [0]], np.float32)
    out = b.bucket({"x": np.ones((6, 4), np.float32),
                    "batch_mask": user_mask})
    np.testing.assert_array_equal(out["batch_mask"].ravel(),
                                  [1, 1, 1, 1, 0, 0, 0, 0])
    with pytest.raises(ValueError, match="batch dim"):
        b.bucket({"x": np.ones((6, 4), np.float32),
                  "batch_mask": np.ones((4, 1), np.float32)})


def test_sequence_only_axes_emit_no_mask():
    out = _both_bucketed({"tok": np.ones((3, 10), np.int32)},
                         dynamic_axes={"tok": (1,)}, mask_name="batch_mask")
    assert out["tok"].shape == (3, 16)
    assert "batch_mask" not in out


@BUCKETING
def test_scalar_feeds_pass_through(bk):
    out = bk.FeedBucketer(mask_name="batch_mask").bucket(
        {"x": np.ones((3, 2), np.float32), "lr": 0.1})
    assert out["lr"] == 0.1
    assert out["x"].shape == (4, 2)


def test_32_distinct_batches_at_most_6_signatures():
    stats = {}
    for bk in (jbucketing, tbucketing):
        b = bk.FeedBucketer(mask_name="batch_mask")
        for n in range(1, 33):
            b.bucket({"x": np.ones((n, 4), np.float32)})
        stats[bk] = b.get_stats()
    s = stats[tbucketing]
    assert s == stats[jbucketing]
    assert s["batches"] == 32 and s["shapes"] <= 6
    assert s["pad_waste_elems"] > 0


@BUCKETING
def test_pad_waste_counter_exact(bk):
    b = bk.FeedBucketer(mask_name=None)
    b.bucket({"x": np.ones((5, 4), np.float32)})
    b.bucket({"x": np.ones((8, 4), np.float32)})
    assert b.get_stats()["pad_waste_elems"] == 12


def test_bucketed_loss_and_update_match_unpadded():
    """Padded rows are exact no-ops for the loss and the update, in the
    port (against its unpadded run) and against the JAX package."""
    r = np.random.default_rng(3)
    feed = {"x": r.standard_normal((5, 4)).astype(np.float32),
            "y": r.standard_normal((5, 1)).astype(np.float32)}
    jmain, jstart, jloss = train_net(jfluid, masked=True)
    jscope = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    weights = {n: np.asarray(jscope.get(n)) for n in jscope.names()}
    w = jmain.all_parameters()[0].name
    got = {}
    for tag, f in (("plain", dict(feed, batch_mask=np.ones((5, 1),
                                                           np.float32))),
                   ("bucketed", tbucketing.FeedBucketer(
                       mask_name="batch_mask").bucket(feed))):
        main, start, loss = train_net(fluid, masked=True)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(start, scope=scope)
        fluid.scope_from_numpy(weights, "cpu", scope)
        got[tag] = (exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0], scope.get(w).numpy().copy())
    jl = jexe.run(jmain, feed=jbucketing.FeedBucketer(
        mask_name="batch_mask").bucket(feed), fetch_list=[jloss],
        scope=jscope)[0]
    np.testing.assert_allclose(got["bucketed"][0], got["plain"][0],
                               rtol=1e-6)
    np.testing.assert_allclose(got["bucketed"][1], got["plain"][1],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got["bucketed"][0], jl, rtol=1e-6)
    np.testing.assert_allclose(got["bucketed"][1],
                               np.asarray(jscope.get(w)), rtol=1e-5,
                               atol=1e-7)


def test_data_feeder_bucketer_integration():
    rows = [(np.ones(4, np.float32), np.zeros(1, np.float32))] * 5
    outs = {}
    for name, pkg, feeder_cls, bk in (
            ("jax", jfluid, JFeeder, jbucketing),
            ("port", fluid, TFeeder, tbucketing)):
        main, _, _ = train_net(pkg)
        feeder = feeder_cls(feed_list=["x", "y"], program=main,
                            bucketer=bk.FeedBucketer(mask_name="batch_mask"))
        outs[name] = feeder.feed(rows)
        assert outs[name]["x"].shape == (8, 4)
        assert outs[name]["batch_mask"].shape == (8, 1)
    for k in outs["jax"]:
        np.testing.assert_array_equal(outs["port"][k], outs["jax"][k])


def test_device_prefetch_transform_applies_bucketing_before_upload():
    b = tbucketing.FeedBucketer(mask_name="batch_mask")
    batches = [{"x": np.ones((n, 4), np.float32)} for n in (3, 5, 9)]
    out = list(treader.device_prefetch(batches, depth=2, device="cpu",
                                       transform=b.bucket))
    assert [o["x"].shape[0] for o in out] == [4, 8, 16]
    assert all(isinstance(o["x"], torch.Tensor) for o in out)
    assert all(tuple(o["batch_mask"].shape) == (o["x"].shape[0], 1)
               for o in out)
    jout = list(jreader.device_prefetch(batches, depth=2,
                                        transform=jbucketing.FeedBucketer(
                                            mask_name="batch_mask").bucket))
    for o, j in zip(out, jout):
        np.testing.assert_array_equal(o["batch_mask"].numpy(),
                                      np.asarray(j["batch_mask"]))


# ---------------------------------------------------------------------------
# test_lod_tensor.py
# ---------------------------------------------------------------------------

PKGS = pytest.mark.parametrize("pkg", [jfluid, fluid], ids=["jax", "port"])


@PKGS
def test_create_and_roundtrip_lengths(pkg):
    t = pkg.create_lod_tensor(np.arange(10).reshape(10, 1), [[3, 2, 5]])
    assert t.recursive_sequence_lengths() == [[3, 2, 5]]
    assert t.lod() == [[0, 3, 5, 10]]
    assert t.has_valid_recursive_sequence_lengths()
    assert t.shape() == (10, 1)


@PKGS
def test_create_from_list_of_sequences(pkg):
    t = pkg.create_lod_tensor([[1, 2], [3, 4, 5]], None)
    assert t.recursive_sequence_lengths() == [[2, 3]]
    np.testing.assert_array_equal(np.asarray(t).ravel(), [1, 2, 3, 4, 5])


def test_to_padded():
    outs = []
    for pkg in (jfluid, fluid):
        t = pkg.create_lod_tensor(
            np.arange(5).reshape(5, 1).astype(np.float32), [[2, 3]])
        padded, lengths = t.to_padded(max_len=4, pad_value=-1)
        assert padded.shape == (2, 4, 1)
        np.testing.assert_array_equal(lengths, [2, 3])
        np.testing.assert_array_equal(padded[0, :, 0], [0, 1, -1, -1])
        np.testing.assert_array_equal(padded[1, :, 0], [2, 3, 4, -1])
        outs.append((padded, lengths))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])


@PKGS
def test_random_int_lod_tensor(pkg):
    t = pkg.create_random_int_lodtensor([[2, 4]], base_shape=[1], low=0,
                                        high=9)
    assert len(t) == 6
    assert t.recursive_sequence_lengths() == [[2, 4]]
    assert np.asarray(t).max() <= 9


@PKGS
def test_invalid_lod_detected(pkg):
    t = pkg.LoDTensor(np.zeros((4, 1)))
    t.set_lod([[0, 3, 2]])
    assert not t.has_valid_recursive_sequence_lengths()
