"""Host-side detection postprocess: variable-length multiclass NMS.

Parity: paddle/fluid/operators/detection/multiclass_nms_op.cc and the
inference engine's CPU postprocess; the counterpart of
``paddle_tpu/inference/postprocess.py``. The in-graph ``multiclass_nms``
op is the static-shape padded form; this is the predictor's: dense
(boxes, scores) leave the card, and ``csrc/nms.cc``
(``pt_multiclass_nms_batch``, built at first use by
``utils/native.build_and_load``) prunes them into per-image
variable-length results, the LoD-shaped output the reference returns.

Where the JAX package falls back to numpy when the build fails, the port
raises: a host without a compiler is an error, not a slower path. The
numpy form stays for the one case that is part of the contract, an
output larger than the buffer sized from nms_top_k / keep_top_k.
``PATHS`` counts which path ran: "native" or "numpy_overflow".
"""

import ctypes
import threading

import numpy as np

from ..utils.native import build_and_load

PATHS = {"native": 0, "numpy_overflow": 0}

_lib = None
_lib_lock = threading.Lock()


def _load_library():
    """The built ``csrc/nms.cc`` with its ctypes signature (built once a
    process); a failed build raises with the compiler's output."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build_and_load("nms.cc")
            f32p = ctypes.POINTER(ctypes.c_float)
            i32p = ctypes.POINTER(ctypes.c_int)
            lib.pt_multiclass_nms_batch.restype = ctypes.c_int
            lib.pt_multiclass_nms_batch.argtypes = [
                f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                f32p, ctypes.c_int, i32p]
            _lib = lib
        return _lib


def _iou(a, b, normalized):
    off = 0.0 if normalized else 1.0
    ix1 = np.maximum(a[0], b[:, 0])
    iy1 = np.maximum(a[1], b[:, 1])
    ix2 = np.minimum(a[2], b[:, 2])
    iy2 = np.minimum(a[3], b[:, 3])
    inter = np.maximum(ix2 - ix1 + off, 0) * np.maximum(iy2 - iy1 + off, 0)
    aa = (a[2] - a[0] + off) * (a[3] - a[1] + off)
    ab = (b[:, 2] - b[:, 0] + off) * (b[:, 3] - b[:, 1] + off)
    union = aa + ab - inter
    return np.where(union <= 0, 0.0, inter / np.maximum(union, 1e-30))


def nms_numpy_image(boxes, scores, score_thresh, nms_thresh, eta,
                    nms_top_k, keep_top_k, background, normalized):
    """One image in numpy, the native kernel's greedy order: each class's
    candidates above score_thresh best first (stable), the first
    nms_top_k, kept unless a kept box overlaps above the (adaptive)
    threshold; then the keep_top_k best over the classes. (K, 6) rows
    [class, score, x1, y1, x2, y2]."""
    dets = []
    for cls in range(scores.shape[0]):
        if cls == background:
            continue
        idx = np.nonzero(scores[cls] > score_thresh)[0]
        idx = idx[np.argsort(-scores[cls][idx], kind="stable")]
        if nms_top_k > -1:
            idx = idx[:nms_top_k]
        kept = []
        adaptive = nms_thresh
        for i in idx:
            if kept and _iou(boxes[i], boxes[np.array(kept)],
                             normalized).max() > adaptive:
                continue
            kept.append(i)
            if eta < 1.0 and adaptive > 0.5:
                adaptive *= eta
        dets += [(float(scores[cls][i]), cls, i) for i in kept]
    dets.sort(key=lambda d: -d[0])
    if keep_top_k > -1:
        dets = dets[:keep_top_k]
    return np.array([[cls, sc, *boxes[i]] for sc, cls, i in dets],
                    np.float32).reshape(-1, 6)


def multiclass_nms_host(bboxes, scores, score_threshold=0.01,
                        nms_threshold=0.3, nms_eta=1.0, nms_top_k=-1,
                        keep_top_k=-1, background_label=0, normalized=True):
    """bboxes (N, M, 4), scores (N, C, M) (numpy, or tensors on any
    device) -> (detections (total, 6), lod offsets (N+1,)). Rows are
    [class, score, x1, y1, x2, y2], best first within each image: the
    reference's LoD output."""
    def host(a):
        if hasattr(a, "detach"):
            a = a.detach().cpu().numpy()
        return np.ascontiguousarray(a, np.float32)

    bboxes, scores = host(bboxes), host(scores)
    n, m, _ = bboxes.shape
    _, c, m2 = scores.shape
    if m != m2:
        raise ValueError(f"boxes M={m} vs scores M={m2}")
    lib = _load_library()
    # the most rows an image can keep, without holding m (c - 1) rows at
    # detector scale; a larger result overflows into the numpy path
    cap_per = keep_top_k if keep_top_k > -1 else (
        nms_top_k * max(c - 1, 1) if nms_top_k > -1
        else min(m * max(c - 1, 1), 4096))
    cap = max(n * max(cap_per, 1), 1)
    out = np.empty((cap, 6), np.float32)
    counts = np.empty(n, np.int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int)
    total = lib.pt_multiclass_nms_batch(
        bboxes.ctypes.data_as(f32p), scores.ctypes.data_as(f32p),
        n, m, c, score_threshold, nms_threshold, nms_eta, nms_top_k,
        keep_top_k, background_label, int(normalized),
        out.ctypes.data_as(f32p), cap, counts.ctypes.data_as(i32p))
    if total >= 0:
        PATHS["native"] += 1
        lod = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        return out[:total].copy(), lod
    PATHS["numpy_overflow"] += 1
    pieces = [nms_numpy_image(bboxes[i], scores[i], score_threshold,
                              nms_threshold, nms_eta, nms_top_k, keep_top_k,
                              background_label, normalized)
              for i in range(n)]
    lod = np.concatenate([[0], np.cumsum([len(p) for p in pieces])]
                         ).astype(np.int64)
    return np.concatenate(pieces, axis=0), lod
