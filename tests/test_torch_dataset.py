"""The port's dataset plane against the JAX package's, on the CPU:
``io/dataset.py`` (DatasetFactory, InMemoryDataset, QueueDataset,
FileInstantDataset, BoxPSDataset, DataFeedDesc) over the repo's native
parser (``csrc/dataset_feed.cc``, built by the port's ``utils/native.py``), the
Executor's ``train_from_dataset`` / ``infer_from_dataset``, the MultiSlot
data generator (``incubate/data_generator``) and the ``paddle.dataset``
readers and decoders (``dataset/``).

Twins, case for case, of ``tests/io/test_dataset_ingestion.py`` (17),
``tests/io/test_dataset_extras.py`` (9) and
``tests/io/test_dataset_decoding.py`` (5): the same generated files
(seeded numpy, written under the test's temporary directory) through both
packages. Batches, parsed columns and decoded samples are equal across
packages (host code: bitwise); DeepFM trained from the files matches the
port's own feed-dict run within the reference's bar, and the JAX
package's run within PARAM_RTOL, from the same weights.
"""

import gzip
import io as _io
import os
import pickle
import struct
import tarfile

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.dataset as jdatasets
from paddle_tpu.incubate import data_generator as jgen
from paddle_tpu.io import dataset as jds
from paddle_tpu.models import deepfm as jdeepfm

import paddle_tpu_torch as fluid
import paddle_tpu_torch.dataset as tdatasets
from paddle_tpu_torch.incubate import data_generator as tgen
from paddle_tpu_torch.io import dataset as tds
from paddle_tpu_torch.models import deepfm as tdeepfm

FIELDS = 5
NFEAT = 1000
CPU = fluid.CPUPlace()
# DeepFM's parameters after 4 SGD steps from one set of weights: the
# reference's bar between train_from_dataset and the feed-dict run, and
# the same bar port against JAX (f32, other kernels)
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_train.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


DS = pytest.mark.parametrize("ds", [jds, tds], ids=["jax", "port"])


def deepfm_lines(rng, n):
    """MultiSlot lines for the DeepFM slots (ids, vals, label)."""
    ids = rng.integers(0, NFEAT, (n, FIELDS))
    vals = rng.random((n, FIELDS)).round(4)
    lab = rng.integers(0, 2, (n,))
    lines = []
    for i in range(n):
        toks = ([str(FIELDS)] + [str(x) for x in ids[i]]
                + [str(FIELDS)] + [f"{x:.4f}" for x in vals[i]]
                + ["1", str(lab[i])])
        lines.append(" ".join(toks))
    return lines, ids, vals.astype(np.float32), lab.astype(np.float32)


def write_files(tmp_path, lines, n_files=2, suffix=""):
    files = []
    per = (len(lines) + n_files - 1) // n_files
    for f in range(n_files):
        p = str(tmp_path / f"part-{f}{suffix}")
        chunk = "\n".join(lines[f * per:(f + 1) * per]) + "\n"
        if suffix == ".gz":
            with gzip.open(p, "wt") as fh:
                fh.write(chunk)
        else:
            with open(p, "w") as fh:
                fh.write(chunk)
        files.append(p)
    return files


def deepfm_program(pkg, deepfm, seed=7):
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = main.random_seed = seed
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        _i, _v, _l, avg_loss, _p = deepfm.build_train_net(
            num_features=NFEAT, num_fields=FIELDS, embed_dim=4)
        pkg.optimizer.SGDOptimizer(learning_rate=0.1).minimize(avg_loss)
    return main, startup, avg_loss


def data_vars(pkg, sparse=False):
    """The slots' data vars in `pkg` (a throwaway program)."""
    main = pkg.Program()
    with pkg.program_guard(main, pkg.Program()):
        if sparse:
            return [pkg.layers.data("q", shape=[1], dtype="int64",
                                    lod_level=1),
                    pkg.layers.data("y", shape=[1], dtype="float32")]
        return [pkg.layers.data("feat_ids", shape=[FIELDS], dtype="int64"),
                pkg.layers.data("feat_vals", shape=[FIELDS],
                                dtype="float32"),
                pkg.layers.data("label", shape=[1], dtype="float32")]


def PKG(ds):
    return jfluid if ds is jds else fluid


def batches_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def both(fn):
    """fn(ds) for both packages' io.dataset: equal batch lists."""
    a, b = fn(jds), fn(tds)
    batches_equal(a, b)
    return b


# ---------------------------------------------------------------------------
# train_from_dataset against the feed-dict path, and against JAX
# ---------------------------------------------------------------------------

def _train_from_files(tmp_path, files, ids, vals, lab):
    """DeepFM from the JAX startup's weights, in both packages: the
    parameters after train_from_dataset over `files`, and (port) after the
    same batches through run()."""
    params = {}
    weights = None
    for name, pkg, deepfm, ds in (("jax", jfluid, jdeepfm, jds),
                                  ("port", fluid, tdeepfm, tds)):
        main, startup, loss = deepfm_program(pkg, deepfm)
        gb = main.global_block()
        use_vars = [gb.var("feat_ids"), gb.var("feat_vals"),
                    gb.var("label")]
        scope = pkg.Scope()
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup, scope=scope)
        if weights is None:
            weights = {n: np.asarray(scope.get(n)) for n in scope.names()}
        else:
            fluid.scope_from_numpy(weights, "cpu", scope)
        d = ds.DatasetFactory().create_dataset("QueueDataset")
        d.set_batch_size(8)
        d.set_use_var(use_vars)
        d.set_filelist(files)
        d.set_thread(2)
        exe.train_from_dataset(program=main, dataset=d, scope=scope)
        params[name] = {n: np.array(scope.get(n)) for n in scope.names()}
        if name == "port":
            assert d.parser == "native"
            scope = fluid.scope_from_numpy(weights, "cpu")
            exe2 = fluid.Executor(CPU)
            exe2._step_counter = 1          # as after the startup
            for b0 in range(0, 32, 8):
                sl = slice(b0, b0 + 8)
                exe2.run(main, feed={"feat_ids": ids[sl].astype(np.int64),
                                     "feat_vals": vals[sl],
                                     "label": lab[sl].reshape(-1, 1)},
                         fetch_list=[loss], scope=scope)
            params["feed"] = {n: np.array(scope.get(n))
                              for n in scope.names()}
    for other in ("feed", "jax"):
        assert set(params["port"]) == set(params[other])
        for k in params["port"]:
            np.testing.assert_allclose(params["port"][k], params[other][k],
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=f"{other}: {k}")


def test_deepfm_train_from_dataset_matches_feed_dict(tmp_path):
    lines, ids, vals, lab = deepfm_lines(np.random.default_rng(0), 32)
    _train_from_files(tmp_path, write_files(tmp_path, lines), ids, vals,
                      lab)


def test_inmemory_shuffles_and_sizes(tmp_path):
    lines, ids, _, _ = deepfm_lines(np.random.default_rng(1), 24)
    files = write_files(tmp_path, lines, n_files=3)

    def loaded(ds):
        d = ds.DatasetFactory().create_dataset("InMemoryDataset")
        d.set_batch_size(6)
        d.set_use_var(data_vars(PKG(ds)))
        d.set_filelist(files)
        d.set_thread(4)          # clamped to len(filelist)
        d.load_into_memory()
        return d

    def run(ds):
        d = loaded(ds)
        assert d.thread_num == 3
        assert d.get_memory_data_size() == 24
        first = next(iter(d._iter_batches()))
        np.testing.assert_array_equal(first["feat_ids"], ids[:6])
        d.set_shuffle_seed(123)
        d.local_shuffle()
        shuf = [dict(b) for b in d._iter_batches()]
        seen = np.sort(np.concatenate([b["feat_ids"].ravel()
                                       for b in shuf]))
        np.testing.assert_array_equal(seen, np.sort(ids.ravel()))
        d2 = loaded(ds)
        d2.set_shuffle_seed(123)
        d2.local_shuffle()
        batches_equal(shuf, list(d2._iter_batches()))
        d.release_memory()
        with pytest.raises(RuntimeError):
            d.get_memory_data_size()
        return shuf
    both(run)


class FakeFleet:
    def __init__(self, n, i):
        self._n, self._i = n, i

    def worker_num(self):
        return self._n

    def worker_index(self):
        return self._i

    def barrier_worker(self):
        pass


def test_global_shuffle_partitions_disjoint(tmp_path):
    lines, ids, _, _ = deepfm_lines(np.random.default_rng(2), 30)
    files = write_files(tmp_path, lines, n_files=1)

    def run(ds):
        rows = []
        for w in range(3):
            d = ds.InMemoryDataset()
            d.set_batch_size(4)
            d.set_use_var(data_vars(PKG(ds)))
            d.set_filelist(files)
            d.set_shuffle_seed(5)
            d.load_into_memory()
            d.global_shuffle(fleet=FakeFleet(3, w))
            rows.extend(dict(b) for b in d._iter_batches())
        union = np.concatenate([b["feat_ids"] for b in rows], axis=0)
        assert union.shape[0] == 30
        assert {tuple(r) for r in union} == {tuple(r) for r in ids}
        return rows
    both(run)


def test_sparse_slot_pads_and_emits_seq_len(tmp_path):
    files = write_files(tmp_path, ["3 11 12 13 1 1.0", "1 7 1 0.0",
                                   "2 5 6 1 1.0", "4 1 2 3 4 1 0.0"],
                        n_files=1)

    def run(ds):
        d = ds.InMemoryDataset()
        d.set_batch_size(2)
        d.set_use_var(data_vars(PKG(ds), sparse=True))
        d.set_filelist(files)
        d.load_into_memory()
        batches = list(d._iter_batches())
        assert len(batches) == 2
        b0, b1 = batches
        assert b0["q"].shape == (2, 4)
        np.testing.assert_array_equal(b0["q"][0], [11, 12, 13, 0])
        np.testing.assert_array_equal(b0["q_seq_len"].ravel(), [3, 1])
        np.testing.assert_array_equal(b1["q_seq_len"].ravel(), [2, 4])
        np.testing.assert_array_equal(b1["y"].ravel(), [1.0, 0.0])
        return batches
    both(run)


def test_pipe_command_decompresses(tmp_path):
    lines, ids, _, _ = deepfm_lines(np.random.default_rng(3), 8)
    files = write_files(tmp_path, lines, n_files=2, suffix=".gz")

    def run(ds):
        d = ds.InMemoryDataset()
        d.set_batch_size(4)
        d.set_use_var(data_vars(PKG(ds)))
        d.set_filelist(files)
        d.set_pipe_command("gzip -dc")
        d.load_into_memory()
        batches = list(d._iter_batches())
        np.testing.assert_array_equal(
            np.concatenate([b["feat_ids"] for b in batches]), ids)
        return batches
    both(run)


def test_queue_dataset_carries_across_files(tmp_path):
    lines, ids, _, _ = deepfm_lines(np.random.default_rng(4), 10)
    files = [write_files(tmp_path, lines[:7], n_files=1)[0]]
    p2 = str(tmp_path / "part-b")
    with open(p2, "w") as fh:
        fh.write("\n".join(lines[7:]) + "\n")
    files.append(p2)

    def run(ds):
        d = ds.QueueDataset()
        d.set_batch_size(4)
        d.set_use_var(data_vars(PKG(ds)))
        d.set_filelist(files)
        batches = list(d._iter_batches())
        assert [b["feat_ids"].shape[0] for b in batches] == [4, 4, 2]
        np.testing.assert_array_equal(
            np.concatenate([b["feat_ids"] for b in batches]), ids)
        with pytest.raises(NotImplementedError):
            d.local_shuffle()
        with pytest.raises(NotImplementedError):
            d.global_shuffle()
        return batches
    both(run)


def test_merge_by_lineid(tmp_path):
    files = write_files(tmp_path, ["1 idA 2 1 2 1 1.0", "1 idB 1 9 1 0.0",
                                   "1 idA 2 2 3 1 0.5"], n_files=1)

    def run(ds):
        q, y = data_vars(PKG(ds), sparse=True)
        d = ds.InMemoryDataset()
        d.set_batch_size(2)
        d.set_use_var([q, y])
        d.set_filelist(files)
        d.set_merge_by_lineid([q])
        d.load_into_memory()
        d.set_shuffle_seed(0)
        d.global_shuffle()
        assert d.get_memory_data_size() == 2
        batches = list(d._iter_batches())
        rows = {}
        for b in batches:
            for r in range(b["q"].shape[0]):
                n = int(b["q_seq_len"].ravel()[r])
                rows[frozenset(b["q"][r, :n].tolist())] = float(
                    b["y"].ravel()[r])
        assert frozenset({1, 2, 3}) in rows
        assert rows[frozenset({1, 2, 3})] in (1.0, 0.5)
        assert rows[frozenset({9})] == 0.0
        return batches
    both(run)


def test_native_and_python_parsers_agree(tmp_path):
    assert tds._load_df_lib() is not None, tds.NATIVE_BUILD_ERROR
    lines, *_ = deepfm_lines(np.random.default_rng(5), 12)
    files = write_files(tmp_path, lines, n_files=2)
    slots = [{"name": "feat_ids", "type": "uint64", "is_dense": True},
             {"name": "feat_vals", "type": "float", "is_dense": True},
             {"name": "label", "type": "float", "is_dense": True}]
    nat, _ = tds._parse_files_native(slots, files, "cat", False, False, 2)
    py, _ = tds._parse_files_python(slots, files, "cat", False, False)
    jnat, _ = jds._parse_files_native(slots, files, "cat", False, False, 2)
    for (nv, nl), (pv, pl), (jv, jl) in zip(nat, py, jnat):
        np.testing.assert_array_equal(nl, pl)
        np.testing.assert_allclose(nv, pv, rtol=1e-6)
        np.testing.assert_array_equal(nv, jv)
        np.testing.assert_array_equal(nl, jl)


@DS
def test_bad_data_raises(ds, tmp_path):
    p = str(tmp_path / "bad.txt")
    with open(p, "w") as fh:
        fh.write("0 5 1.0\n")
    pkg = PKG(ds)
    main = pkg.Program()
    with pkg.program_guard(main, pkg.Program()):
        v = pkg.layers.data("x", shape=[1], dtype="float32")
    d = ds.InMemoryDataset()
    d.set_use_var([v])
    d.set_filelist([p])
    with pytest.raises(Exception, match="zero|positive"):
        d.load_into_memory()


def test_datafeed_desc_roundtrip():
    texts = {}
    for ds in (jds, tds):
        pkg = PKG(ds)
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            x = pkg.layers.data("x", shape=[3], dtype="float32")
            y = pkg.layers.data("y", shape=[1], dtype="int64")
        d = ds.QueueDataset()
        d.set_batch_size(16)
        d.set_use_var([x, y])
        text = d.desc()
        assert 'name: "MultiSlotDataFeed"' in text
        assert "batch_size: 16" in text
        parsed = ds.DataFeedDesc(text)
        parsed.set_batch_size(64)
        assert "batch_size: 64" in parsed.desc()
        assert 'name: "x"' in parsed.desc() and \
            'type: "uint64"' in parsed.desc()
        texts[ds] = (text, parsed.desc())
    assert texts[jds] == texts[tds]


@pytest.mark.parametrize("pkg", [jfluid, fluid], ids=["jax", "port"])
def test_factory_and_exports(pkg):
    assert isinstance(pkg.DatasetFactory().create_dataset(),
                      pkg.QueueDataset)
    assert isinstance(pkg.DatasetFactory().create_dataset(
        "InMemoryDataset"), pkg.InMemoryDataset)
    assert isinstance(pkg.DatasetFactory().create_dataset(
        "BoxPSDataset"), pkg.BoxPSDataset)
    assert isinstance(pkg.DatasetFactory().create_dataset(
        "FileInstantDataset"), pkg.FileInstantDataset)
    with pytest.raises(ValueError):
        pkg.DatasetFactory().create_dataset("NoSuchDataset")


def test_infer_from_dataset_runs(tmp_path):
    lines, *_ = deepfm_lines(np.random.default_rng(6), 8)
    files = write_files(tmp_path, lines, n_files=1)
    main, startup, loss = deepfm_program(fluid, tdeepfm)
    infer_prog = main.clone(for_test=True)
    gb = main.global_block()
    d = tds.QueueDataset()
    d.set_batch_size(4)
    d.set_use_var([gb.var("feat_ids"), gb.var("feat_vals"),
                   gb.var("label")])
    d.set_filelist(files)
    scope = fluid.Scope()
    exe = fluid.Executor(CPU)
    exe.run(startup, scope=scope)
    before = {k: scope.get(k).clone() for k in scope.names()}
    exe.infer_from_dataset(program=infer_prog, dataset=d, scope=scope)
    for k in before:       # the infer program must not touch params
        torch.testing.assert_close(scope.get(k), before[k], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# incubate.data_generator
# ---------------------------------------------------------------------------

def _deepfm_generator(gen):
    class DeepFMGenerator(gen.MultiSlotDataGenerator):
        """ETL: raw 'id,...,val,...,label' csv -> DeepFM MultiSlot."""

        def generate_sample(self, line):
            def local_iter():
                if line is None:
                    return
                toks = line.strip().split(",")
                yield [("feat_ids", [int(t) for t in toks[:FIELDS]]),
                       ("feat_vals",
                        [float(t) for t in toks[FIELDS:2 * FIELDS]]),
                       ("label", [int(toks[-1])])]
            return local_iter
    return DeepFMGenerator()


def _raw_csv(ids, vals, lab):
    return [",".join([str(x) for x in ids[i]]
                     + [f"{v:.4f}" for v in vals[i]] + [str(lab[i])])
            for i in range(len(lab))]


def test_multislot_generator_emits_dataset_feed_format():
    want_lines, ids, vals, lab = deepfm_lines(np.random.default_rng(3), 8)
    outs = []
    for gen in (jgen, tgen):
        buf = _io.StringIO()
        _deepfm_generator(gen).run_from_stdin(
            lines=_raw_csv(ids, vals, lab.astype(int)), out=buf)
        got = buf.getvalue().splitlines()
        assert len(got) == len(want_lines)
        for g, w in zip(got, want_lines):
            gt, wt = g.split(), w.split()
            assert len(gt) == len(wt)
            assert all(float(a) == float(b) for a, b in zip(gt, wt))
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]


def test_deepfm_trains_from_generator_written_files(tmp_path):
    _, ids, vals, lab = deepfm_lines(np.random.default_rng(0), 32)
    gen = _deepfm_generator(tgen)
    raw = _raw_csv(ids, vals, lab.astype(int))
    files = []
    for f in range(2):
        p = str(tmp_path / f"gen-part-{f}")
        with open(p, "w") as fh:
            gen.run_from_stdin(lines=raw[f * 16:(f + 1) * 16], out=fh)
        files.append(p)
    _train_from_files(tmp_path, files, ids, vals, lab)


def test_generator_batch_and_memory_paths():
    for gen in (jgen, tgen):
        class Words(gen.MultiSlotStringDataGenerator):
            def generate_sample(self, line):
                def local_iter():
                    yield [("words", ["11", "22", "33"]), ("label", ["1"])]
                return local_iter

            def generate_batch(self, samples):
                def local_iter():
                    for s in samples:
                        yield [(s[0][0], s[0][1] + ["99"]), s[1]]
                return local_iter

        g = Words()
        g.set_batch(2)
        buf = _io.StringIO()
        g.run_from_stdin(lines=["a", "b", "c"], out=buf)
        assert buf.getvalue().splitlines() == ["4 11 22 33 99 1 1"] * 3

        class Mem(gen.MultiSlotDataGenerator):
            def generate_sample(self, line):
                def local_iter():
                    for i in range(3):
                        yield [("ids", [i, i + 1])]
                return local_iter

        buf2 = _io.StringIO()
        Mem().run_from_memory(out=buf2)
        assert buf2.getvalue().splitlines() == ["2 0 1", "2 1 2", "2 2 3"]


@pytest.mark.parametrize("gen", [jgen, tgen], ids=["jax", "port"])
def test_multislot_generator_validates(gen):
    g = gen.MultiSlotDataGenerator()
    with pytest.raises(ValueError, match="list or tuple"):
        g._gen_str("not-a-sample")
    assert g._gen_str([("a", [1]), ("b", [2.5])]) == "1 1 1 2.5\n"
    assert g._proto_info == [("a", "uint64"), ("b", "float")]
    with pytest.raises(ValueError, match="inconsistent"):
        g._gen_str([("a", [1])])
    with pytest.raises(ValueError, match="name mismatch"):
        g._gen_str([("a", [1]), ("c", [2])])
    with pytest.raises(ValueError, match="can not be empty"):
        g._gen_str([("a", []), ("b", [1])])
    with pytest.raises(ValueError, match="int or float"):
        g._gen_str([("a", ["str"]), ("b", [1])])
    with pytest.raises(NotImplementedError):
        gen.DataGenerator()._gen_str([("a", [1])])
    with pytest.raises(NotImplementedError):
        gen.DataGenerator().generate_sample("x")


@pytest.mark.parametrize("gen", [jgen, tgen], ids=["jax", "port"])
def test_generator_line_limit_bool_and_numpy(gen):
    class Ids(gen.MultiSlotDataGenerator):
        def generate_sample(self, line):
            def it():
                yield [("ids", [int(line)])]
            return it

    g = Ids()
    g._set_line_limit(2)
    buf = _io.StringIO()
    g.run_from_stdin(lines=["1", "2", "3", "4"], out=buf)
    assert buf.getvalue().splitlines() == ["1 1", "1 2"]
    g2 = gen.MultiSlotDataGenerator()
    with pytest.raises(ValueError, match="bool"):
        g2._gen_str([("a", [True])])
    assert g2._gen_str([("a", [np.int64(3)]),
                        ("b", [np.float32(0.5)])]) == "1 3 1 0.5\n"


# ---------------------------------------------------------------------------
# paddle.dataset readers: test_dataset_decoding.py, test_dataset_extras.py
# ---------------------------------------------------------------------------

@pytest.fixture()
def data_home(tmp_path, monkeypatch):
    for pkg in (jdatasets, tdatasets):
        monkeypatch.setattr(pkg.common, "DATA_HOME", str(tmp_path))
        monkeypatch.setattr(pkg.uci_housing, "_cache", None)
    yield tmp_path


def same(a, b):
    """Recursive equality of two readers' samples (arrays bitwise)."""
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_mnist_idx_decoding(data_home):
    rs = np.random.RandomState(0)
    imgs = rs.randint(0, 256, (5, 28, 28), dtype=np.uint8)
    labels = np.arange(5, dtype=np.uint8)
    with gzip.open(data_home / "train-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 5, 28, 28) + imgs.tobytes())
    with gzip.open(data_home / "train-labels-idx1-ubyte.gz", "wb") as f:
        f.write(struct.pack(">II", 2049, 5) + labels.tobytes())
    rows = list(tdatasets.mnist.train()())
    same(rows, list(jdatasets.mnist.train()()))
    assert len(rows) == 5
    img0, _ = rows[0]
    assert img0.shape == (784,) and img0.dtype == np.float32
    np.testing.assert_allclose(img0, imgs[0].reshape(-1) / 255.0 * 2.0
                               - 1.0, rtol=1e-4, atol=1e-6)
    assert [lab for _, lab in rows] == [0, 1, 2, 3, 4]
    assert len(list(tdatasets.mnist.test()())) == 1024


def test_uci_housing_decoding(data_home):
    data = np.random.RandomState(1).rand(10, 14) * 10
    with open(data_home / "housing.data", "w") as f:
        for row in data:
            f.write(" ".join(f"{v:.6f}" for v in row) + "\n")
    train_rows = list(tdatasets.uci_housing.train()())
    same(train_rows, list(jdatasets.uci_housing.train()()))
    test_rows = list(tdatasets.uci_housing.test()())
    assert len(train_rows) == 8 and len(test_rows) == 2
    x, y = train_rows[0]
    assert x.shape == (13,) and y.shape == (1,)
    col0 = data[:, 0]
    np.testing.assert_allclose(
        x[0], (col0[0] - col0.mean()) / (col0.max() - col0.min()),
        rtol=1e-5)
    np.testing.assert_allclose(y[0], data[0, -1], rtol=1e-5)


def test_cifar_tar_decoding(data_home):
    rs = np.random.RandomState(2)
    batch = {b"data": rs.randint(0, 256, (4, 3072), dtype=np.uint8),
             b"labels": [0, 1, 2, 3]}
    with tarfile.open(data_home / "cifar-10-python.tar.gz", "w:gz") as tf:
        payload = pickle.dumps(batch)
        info = tarfile.TarInfo("cifar-10-batches-py/data_batch_1")
        info.size = len(payload)
        tf.addfile(info, _io.BytesIO(payload))
    rows = list(tdatasets.cifar.train10()())
    same(rows, list(jdatasets.cifar.train10()()))
    assert len(rows) == 4
    img, lab = rows[2]
    assert img.shape == (3, 32, 32) and lab == 2
    np.testing.assert_allclose(img.reshape(-1), batch[b"data"][2] / 255.0,
                               rtol=1e-6)


def test_imikolov_ptb_decoding(data_home):
    with open(data_home / "ptb.train.txt", "w") as f:
        f.write("the cat sat\nthe dog sat on the mat\n")
    with open(data_home / "ptb.valid.txt", "w") as f:
        f.write("the cat ran\n")
    wd = tdatasets.imikolov.build_dict(min_word_freq=1)
    assert wd == jdatasets.imikolov.build_dict(min_word_freq=1)
    assert "<unk>" in wd and "<e>" in wd and wd["the"] == 0
    grams = list(tdatasets.imikolov.train(wd, 3)())
    same(grams, list(jdatasets.imikolov.train(wd, 3)()))
    assert len(grams[0]) == 3 and grams[2][2] == wd["sat"]
    assert max(int(x) for g in grams for x in g) < len(wd) + 1


def test_synthetic_fallback_without_files(data_home):
    for ds in (jdatasets, tdatasets):
        img, _ = next(iter(ds.mnist.train()()))
        assert img.shape == (784,)
        img, _ = next(iter(ds.cifar.train10()()))
        assert img.shape == (3, 32, 32)
    same(next(iter(tdatasets.mnist.train()())),
         next(iter(jdatasets.mnist.train()())))


def _png_bytes(arr):
    from PIL import Image
    buf = _io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def test_image_transforms_roundtrip(tmp_path):
    arr = np.arange(40 * 60 * 3, dtype=np.uint8).reshape(40, 60, 3) % 255
    p = tmp_path / "img.png"
    p.write_bytes(_png_bytes(arr))
    out = {}
    for ds in (jdatasets, tdatasets):
        image = ds.image
        im = image.load_image(str(p))
        np.testing.assert_array_equal(im, arr)
        short = image.resize_short(im, 20)
        assert min(short.shape[:2]) == 20 and short.shape[1] == 30
        crop = image.center_crop(short, 16)
        assert crop.shape[:2] == (16, 16)
        assert image.random_crop(short, 16).shape[:2] == (16, 16)
        np.testing.assert_array_equal(image.left_right_flip(im),
                                      im[:, ::-1])
        chw = image.simple_transform(im, 24, 16, is_train=False,
                                     mean=[1.0, 2.0, 3.0])
        assert chw.shape == (3, 16, 16) and chw.dtype == np.float32
        assert image.load_and_transform(str(p), 24, 16,
                                        is_train=True).shape == (3, 16, 16)
        out[ds] = [short, crop, chw]
    same(out[jdatasets], out[tdatasets])


def test_image_resize_preserves_float_values():
    im = np.linspace(0.0, 1.0, 16 * 24 * 3, dtype=np.float32)
    im = im.reshape(16, 24, 3)
    outs = [ds.image.resize_short(im, 8) for ds in (jdatasets, tdatasets)]
    same(outs[0], outs[1])
    assert outs[1].dtype == np.float32
    assert 0.3 < float(outs[1].mean()) < 0.7
    np.testing.assert_allclose(outs[1].mean(), im.mean(), atol=0.05)


def test_batch_images_from_tar_equal_length_buffers(tmp_path):
    tar_path = tmp_path / "imgs.tar"
    with tarfile.open(tar_path, "w") as tf:
        for name, payload in [("a.jpg", b"12345678"),
                              ("b.jpg", b"abcdefgh"), ("c.jpg", b"x")]:
            info = tarfile.TarInfo(name)
            info.size = len(payload)
            tf.addfile(info, _io.BytesIO(payload))
    for ds in (jdatasets, tdatasets):
        meta = ds.image.batch_images_from_tar(
            str(tar_path), f"t_{ds.__name__.split('.')[0]}",
            {"a.jpg": 0, "b.jpg": 1, "c.jpg": 2}, num_per_batch=2)
        batches = open(meta).read().splitlines()
        assert len(batches) == 2
        data = np.load(batches[0], allow_pickle=True)["data"]
        assert data.shape == (2,) and data.dtype == object
        assert bytes(data[0]) == b"12345678"
        assert np.load(batches[1], allow_pickle=True)["data"].shape == (1,)


def test_image_grayscale():
    rgb = np.zeros((10, 10, 3), np.uint8)
    rgb[:, :, 0] = 200
    outs = [ds.image.load_image_bytes(_png_bytes(rgb), is_color=False)
            for ds in (jdatasets, tdatasets)]
    same(outs[0], outs[1])
    assert outs[1].shape == (10, 10, 1)
    assert 40 < int(outs[1].mean()) < 90


LETOR_TEXT = """2 qid:10 1:0.5 2:0.25 3:0.1 #docid=A
0 qid:10 1:0.1 2:0.9 3:0.3 #docid=B
1 qid:10 1:0.4 2:0.4 3:0.2 #docid=C
1 qid:20 1:0.9 2:0.0 3:0.5 #docid=D
0 qid:20 1:0.2 2:0.1 #docid=E
"""


def test_mq2007_letor_parsing(data_home):
    (data_home / "mq2007" / "Fold1").mkdir(parents=True)
    path = data_home / "mq2007" / "Fold1" / "train.txt"
    path.write_text(LETOR_TEXT)
    mq = tdatasets.mq2007
    lists = mq.load_from_text(str(path))
    jlists = jdatasets.mq2007.load_from_text(str(path))
    assert [ql.query_id for ql in lists] == [10, 20] == \
        [ql.query_id for ql in jlists]
    assert len(lists[0]) == 3 and len(lists[1]) == 2
    q = lists[0][0]
    assert q.relevance_score == 2
    assert len(q.feature_vector) == mq.FEATURE_DIM
    assert q.feature_vector[:3] == [0.5, 0.25, 0.1]
    assert set(q.feature_vector[3:]) == {-1}
    assert "docid=A" in q.description
    e = lists[1][1].feature_vector
    assert len(e) == mq.FEATURE_DIM and e[:3] == [0.2, 0.1, -1]
    for form in ("pairwise", "pointwise", "listwise"):
        same(list(mq.train(form)()),
             list(jdatasets.mq2007.train(form)()))
    one, hi, lo = next(iter(mq.train("pairwise")()))
    assert one == [1.0]
    rel, feat = next(iter(mq.train("pointwise")()))
    assert feat.ndim == 1
    rels, feats = next(iter(mq.train("listwise")()))
    assert feats.shape[0] == len(rels)


def test_mq2007_synthetic_fallback(data_home):
    mq = tdatasets.mq2007
    rel, feat = next(iter(mq.test("pointwise")()))
    same((rel, feat), next(iter(jdatasets.mq2007.test("pointwise")())))
    assert feat.shape == (mq.FEATURE_DIM,) and rel in (0, 1, 2)
    with pytest.raises(ValueError):
        mq.train("bogus")
    with pytest.raises(RuntimeError):
        mq.fetch()


def test_voc2012_synthetic(data_home):
    img, lbl = next(iter(tdatasets.voc2012.train()()))
    same((img, lbl), next(iter(jdatasets.voc2012.train()())))
    assert img.shape[0] == 3 and img.dtype == np.uint8
    assert lbl.shape == img.shape[1:] and lbl.dtype == np.uint8
    assert 1 <= lbl.max() < tdatasets.voc2012.N_CLASSES


def test_voc2012_real_tar_decoding(data_home):
    from PIL import Image
    voc = tdatasets.voc2012
    img = (np.random.RandomState(0).rand(24, 24, 3) * 255).astype(np.uint8)
    lbl = np.zeros((24, 24), np.uint8)
    lbl[4:12, 4:12] = 7

    def add(tf, name, data):
        info = tarfile.TarInfo(name)
        info.size = len(data)
        tf.addfile(info, _io.BytesIO(data))

    def enc(arr, fmt):
        buf = _io.BytesIO()
        Image.fromarray(arr).save(buf, format=fmt)
        return buf.getvalue()

    with tarfile.open(data_home / voc.VOC_TAR, "w") as tf:
        add(tf, voc._SETS_DIR + "trainval.txt", b"2007_000001\n")
        add(tf, voc._IMG_DIR + "2007_000001.jpg", enc(img, "JPEG"))
        add(tf, voc._LBL_DIR + "2007_000001.png", enc(lbl, "PNG"))
    out = list(voc.train()())
    same(out, list(jdatasets.voc2012.train()()))
    assert len(out) == 1
    got_img, got_lbl = out[0]
    assert got_img.shape == (3, 24, 24)
    np.testing.assert_array_equal(got_lbl, lbl)


def test_dataset_surface_round4(tmp_path, monkeypatch):
    for ds in (jdatasets, tdatasets):
        monkeypatch.setattr(ds.common, "DATA_HOME", str(tmp_path))
        mi, ui = ds.movielens.movie_info(), ds.movielens.user_info()
        assert len(mi) == ds.movielens.MAX_MOVIE_ID
        assert len(ui) == ds.movielens.MAX_USER_ID
        assert mi[7].value()[0] == 7 and len(ui[3].value()) == 4
        d = ds.wmt16.get_dict("en", 60)
        assert d["<s>"] == 0 and d["<e>"] == 1 and len(d) == 60
        assert ds.wmt16.get_dict("en", 60, reverse=True)[2] == "<unk>"
        src, trg = ds.wmt14.get_dict(40)
        assert src[0] == "<s>" and trg[39].startswith("trg")
        assert len(ds.imdb.build_dict("*", 3)) == ds.imdb.WORD_DICT_SIZE
        emb = np.loadtxt(ds.conll05.get_embedding())
        assert emb.shape == (ds.conll05.WORD_DICT_LEN, 32)
        work = tmp_path / ds.__name__.split(".")[0]
        work.mkdir()
        monkeypatch.chdir(work)
        ds.common.split(ds.movielens.test(), 300, suffix="ml-%05d.pickle")
        files = sorted(os.listdir(work))
        assert len(files) == 4
        pattern = str(work / "ml-*.pickle")
        assert sum(1 for _ in ds.common.cluster_files_reader(
            pattern, 1, 0)()) == 1024
        assert sum(1 for _ in ds.common.cluster_files_reader(
            pattern, 2, 0)()) + sum(1 for _ in ds.common.cluster_files_reader(
                pattern, 2, 1)()) == 1024
        assert len(ds.common.md5file(files[0])) == 32
        with pytest.raises(RuntimeError, match="egress"):
            ds.common.download("http://host/file.tgz", "mod", "md5")
    same(list(tdatasets.movielens.test()()),
         list(jdatasets.movielens.test()()))
