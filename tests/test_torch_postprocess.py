"""The port's host detection postprocess (``inference/postprocess.py``,
``csrc/nms.cc`` built by ``utils/native.py``) against the JAX package's,
on the CPU: twins of the five tests of ``tests/ops/test_native_nms.py``
(the library builds; the native kernel equals the numpy form; a brute
oracle case; keep_top_k and the LoD offsets; the survivor set of the
in-graph ``multiclass_nms`` op), each also held against JAX's
``multiclass_nms_host`` on the same inputs. Where the JAX package falls
back to numpy when g++ fails, the port raises: a test breaks the build
and sees the error. The numpy form runs only when the result overflows
the buffer; a test drives that case and reads ``PATHS``.
"""

import numpy as np
import pytest

from paddle_tpu.inference import postprocess as jpost

from paddle_tpu_torch.inference import postprocess
from paddle_tpu_torch.utils import native

from test_torch_seq2seq import run_layers


def _rand_problem(rng, n=2, m=40, c=4):
    base = rng.uniform(0, 80, (n, m, 2)).astype(np.float32)
    wh = rng.uniform(4, 24, (n, m, 2)).astype(np.float32)
    return np.concatenate([base, base + wh], axis=-1), \
        rng.uniform(0, 1, (n, c, m)).astype(np.float32)


def _as_jax(boxes, scores, **kw):
    """The port's result, held equal to JAX's on the same inputs."""
    dets, lod = postprocess.multiclass_nms_host(boxes, scores, **kw)
    jdets, jlod = jpost.multiclass_nms_host(boxes, scores, **kw)
    np.testing.assert_array_equal(lod, jlod)
    np.testing.assert_array_equal(dets, jdets)
    return dets, lod


def test_native_library_builds():
    assert postprocess._load_library() is not None


def test_native_matches_numpy_form():
    """test_native_nms.py:24: the native kernel and the numpy form keep
    the same rows in the same order."""
    boxes, scores = _rand_problem(np.random.default_rng(0))
    kw = dict(score_threshold=0.3, nms_threshold=0.4, keep_top_k=20)
    before = postprocess.PATHS["native"]
    dets, lod = _as_jax(boxes, scores, **kw)
    assert postprocess.PATHS["native"] == before + 1
    pieces = [postprocess.nms_numpy_image(
        boxes[i], scores[i], 0.3, 0.4, 1.0, -1, 20, 0, True)
        for i in range(2)]
    np.testing.assert_array_equal(np.diff(lod), [len(p) for p in pieces])
    np.testing.assert_allclose(dets, np.concatenate(pieces), rtol=1e-6,
                               atol=1e-6)


def test_simple_oracle_case():
    """test_native_nms.py:43: box 1 suppressed by box 0 (IoU ~0.68), the
    distant box kept."""
    boxes = np.array([[[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60]]],
                     np.float32)
    scores = np.array([[[0.0, 0.0, 0.0], [0.9, 0.8, 0.7]]], np.float32)
    dets, lod = _as_jax(boxes, scores, score_threshold=0.5,
                        nms_threshold=0.5)
    assert lod.tolist() == [0, 2]
    np.testing.assert_allclose(dets[0], [1, 0.9, 0, 0, 10, 10], atol=1e-6)
    np.testing.assert_allclose(dets[1], [1, 0.7, 50, 50, 60, 60], atol=1e-6)


def test_keep_top_k_and_lod_offsets():
    """test_native_nms.py:58: at most keep_top_k rows an image, best
    first, the offsets covering every row."""
    boxes, scores = _rand_problem(np.random.default_rng(1), n=3)
    dets, lod = _as_jax(boxes, scores, score_threshold=0.2,
                        nms_threshold=0.5, keep_top_k=5)
    assert lod.shape == (4,) and lod[0] == 0 and lod[-1] == len(dets)
    assert (np.diff(lod) <= 5).all()
    for i in range(3):
        assert (np.diff(dets[lod[i]:lod[i + 1], 1]) <= 1e-6).all()


def test_matches_device_op_survivor_set():
    """test_native_nms.py:74: the port's in-graph multiclass_nms (through
    its layer and Executor) keeps the host's (class, score) set; the
    device rows equal JAX's."""
    boxes, scores = _rand_problem(np.random.default_rng(2), n=1, m=16, c=3)
    (jdev,), (dev,) = run_layers(
        lambda L, b, s: L.multiclass_nms(b, s, background_label=0,
                                         score_threshold=0.3,
                                         nms_threshold=0.4, nms_top_k=16,
                                         keep_top_k=10),
        {"b": boxes, "s": scores})
    np.testing.assert_allclose(dev, jdev, rtol=1e-6)
    dev = dev[0][dev[0, :, 0] >= 0]
    host, _ = _as_jax(boxes, scores, score_threshold=0.3, nms_threshold=0.4,
                      nms_top_k=16, keep_top_k=10)
    assert sorted((int(r[0]), round(float(r[1]), 4)) for r in dev) == \
        sorted((int(r[0]), round(float(r[1]), 4)) for r in host)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails is an error (the JAX package would fall back
    to numpy): the build's stderr comes back in the RuntimeError."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "CXXFLAGS",
                        native.CXXFLAGS + ("-fno-such-flag-anywhere",))
    monkeypatch.setattr(postprocess, "_lib", None)
    boxes, scores = _rand_problem(np.random.default_rng(3), n=1)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on nms.cc"):
        postprocess.multiclass_nms_host(boxes, scores)
    assert not list(tmp_path.glob("*.so"))


def test_overflow_takes_the_numpy_form():
    """3000 disjoint boxes, two classes, no top-k limits: 6000 kept rows
    overflow the 4096-row buffer, the numpy form answers (counted), and
    the rows equal JAX's."""
    g = np.arange(60, dtype=np.float32) * 10
    xy = np.stack(np.meshgrid(g, g[:50]), -1).reshape(1, -1, 2)
    boxes = np.concatenate([xy, xy + 5], -1)
    scores = np.random.default_rng(4).uniform(0.1, 1, (1, 3, 3000)) \
        .astype(np.float32)
    before = postprocess.PATHS["numpy_overflow"]
    dets, lod = _as_jax(boxes, scores, score_threshold=0.05)
    assert postprocess.PATHS["numpy_overflow"] == before + 1
    assert lod.tolist() == [0, 6000]
