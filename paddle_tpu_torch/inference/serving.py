"""Micro-batching serving loop over the native request queue
(csrc/serve_queue.cc).

Parity: the reference's C++ inference server (paddle/fluid/inference/api,
AnalysisPredictor behind a request-grouping service loop); the port of
``paddle_tpu/inference/serving.py``. The engine is a Predictor whose
``predict_batch`` pads to its batch buckets, so grouping concurrent
requests into buckets is what keeps the card busy: singles would run one
walk of the whole Program each.

The latency/throughput contract is the standard pair: a batch launches
when `max_batch` requests are queued OR the oldest has waited
`max_delay_ms`. All waiting happens in C++ off the GIL; request payloads
stay in Python (the queue moves int64 ticket ids only). The queue's
library is built with ``g++`` at first use by the port's
``utils/native.build_and_load``.

    server = BatchingServer(predictor, max_batch=8, max_delay_ms=2.0)
    fut = server.submit({"x": np.array([[...]])})   # any thread
    out = fut.result()                              # this request's rows
    server.close()

``backend="auto"`` takes the native queue where it builds and the
pure-Python queue (the same contract) where it does not, and reports the
choice in ``.backend``. Generation workloads with ragged lengths belong
to ``serving.GenerationServer`` instead; this loop batches fixed-shape
one-shot predicts.
"""

import ctypes
import threading
import time
from concurrent.futures import Future

import numpy as np

from ..utils.native import build_and_load

_lib = None
_lib_lock = threading.Lock()


def load_library():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = build_and_load("serve_queue.cc")
        lib.sq_create.restype = ctypes.c_void_p
        lib.sq_create.argtypes = [ctypes.c_int64, ctypes.c_int64]
        lib.sq_submit.restype = ctypes.c_int
        lib.sq_submit.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.sq_next_batch.restype = ctypes.c_int64
        lib.sq_next_batch.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int64),
                                      ctypes.c_int64, ctypes.c_int64]
        lib.sq_pending.restype = ctypes.c_int64
        lib.sq_pending.argtypes = [ctypes.c_void_p]
        lib.sq_close.argtypes = [ctypes.c_void_p]
        lib.sq_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available():
    try:
        load_library()
        return True
    except Exception:
        return False


class _PyQueue:
    """Pure-Python counterpart of csrc/serve_queue.cc, with the same
    contract (a batch launches at max_batch OR when the oldest request
    has waited max_delay), built on a Condition instead of the off-GIL
    C++ wait. ``backend="python"`` selects it; ``"auto"`` takes it only
    where the native queue does not build, and ``.backend`` says which
    queue runs."""

    def __init__(self, max_batch, max_delay_us):
        self._max_batch = int(max_batch)
        self._max_delay_s = max_delay_us / 1e6
        self._cv = threading.Condition()
        self._items = []                    # (rid, enqueue_time)
        self._closed = False

    def submit(self, rid):
        with self._cv:
            if self._closed:
                return -1
            self._items.append((rid, time.monotonic()))
            self._cv.notify_all()
            return 0

    def next_batch(self, max_n, poll_timeout_us):
        """-> list of rids ([] on poll timeout), or None once closed
        AND drained — mirrors sq_next_batch's n / 0 / -1."""
        poll_deadline = time.monotonic() + poll_timeout_us / 1e6
        with self._cv:
            while True:
                now = time.monotonic()
                if self._items:
                    oldest = self._items[0][1]
                    if (len(self._items) >= self._max_batch
                            or now - oldest >= self._max_delay_s
                            or self._closed):
                        n = min(len(self._items), max_n,
                                self._max_batch)
                        out = [rid for rid, _ in self._items[:n]]
                        del self._items[:n]
                        return out
                    wait = min(oldest + self._max_delay_s,
                               poll_deadline) - now
                elif self._closed:
                    return None             # closed and drained
                else:
                    wait = poll_deadline - now
                if now >= poll_deadline:
                    return []               # poll timeout — caller loops
                self._cv.wait(timeout=max(wait, 0.0))

    def pending(self):
        with self._cv:
            return len(self._items)

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def destroy(self):
        pass


class _NativeQueue:
    """ctypes adapter giving csrc/serve_queue.cc the same Python-level
    interface as _PyQueue (all waiting stays in C++ off the GIL)."""

    def __init__(self, max_batch, max_delay_us):
        self._lib = load_library()
        self._q = self._lib.sq_create(int(max_batch), int(max_delay_us))
        self._max_batch = int(max_batch)
        self._ids = (ctypes.c_int64 * self._max_batch)()

    def submit(self, rid):
        return self._lib.sq_submit(self._q, rid)

    def next_batch(self, max_n, poll_timeout_us):
        n = self._lib.sq_next_batch(self._q, self._ids,
                                    min(max_n, self._max_batch),
                                    poll_timeout_us)
        if n < 0:
            return None
        return [self._ids[i] for i in range(n)]

    def pending(self):
        return int(self._lib.sq_pending(self._q))

    def close(self):
        self._lib.sq_close(self._q)

    def destroy(self):
        self._lib.sq_destroy(self._q)


def _feed_sig(feeds):
    """(keys, per-key trailing dims + dtype) — everything a batch
    np.concatenate over axis 0 requires to agree across requests."""
    return tuple(sorted(
        (k, tuple(v.shape[1:]), v.dtype.str) for k, v in feeds.items()))


class BatchingServer:
    """Group concurrent single-request predicts into bucket-sized
    batches. One worker thread owns the predictor (one stream of eager
    walks on the card); any number of client threads submit.

    backend: "native" (csrc serve_queue), "python" (fallback), or
    "auto" — native when the toolchain can build it, python otherwise."""

    def __init__(self, predictor, max_batch=8, max_delay_ms=2.0,
                 backend="auto"):
        if backend == "auto":
            backend = "native" if available() else "python"
        if backend == "native":
            self._q = _NativeQueue(max_batch, int(max_delay_ms * 1000))
        elif backend == "python":
            self._q = _PyQueue(max_batch, int(max_delay_ms * 1000))
        else:
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self._pred = predictor
        self._reqs = {}
        self._reqs_lock = threading.Lock()
        self._next_id = 0
        self._max_batch = int(max_batch)
        self._closed = False
        self._worker = threading.Thread(target=self._serve, daemon=True)
        self._worker.start()

    def submit(self, feeds):
        """feeds: dict name -> (1, ...) or (k, ...) array. Returns a
        Future resolving to this request's output rows (list, one array
        per model output).

        The feed signature (key set + trailing dims + dtype) must match
        every request currently queued: co-batched feeds concatenate on
        axis 0, so a mismatch is THIS caller's error and raises here,
        instead of poisoning the whole batch and fanning one confusing
        concatenate exception to every co-batched future."""
        feeds = {k: np.asarray(v) for k, v in feeds.items()}
        sig = _feed_sig(feeds)
        fut = Future()
        # queue submit runs INSIDE the lock (it never blocks) so close()
        # cannot destroy the native handle between our closed-check and
        # the call
        with self._reqs_lock:
            if self._closed or self._q is None:
                raise RuntimeError("BatchingServer is closed")
            if self._reqs:
                first_sig = next(iter(self._reqs.values()))[2]
                if sig != first_sig:
                    raise ValueError(
                        "feed signature mismatch with the queued batch: "
                        f"queued {first_sig} vs submitted {sig} — keys, "
                        "trailing dims and dtypes must agree for "
                        "requests to co-batch")
            rid = self._next_id
            self._next_id += 1
            self._reqs[rid] = (feeds, fut, sig)
            if self._q.submit(rid) != 0:
                self._reqs.pop(rid, None)
                raise RuntimeError("BatchingServer is closed")
        return fut

    def _serve(self):
        while True:
            rids = self._q.next_batch(self._max_batch, 200_000)
            if rids is None:
                return                      # closed and drained
            if not rids:
                continue                    # poll timeout — loop
            batch = []
            with self._reqs_lock:
                for rid in rids:
                    feeds_i, fut, _sig = self._reqs.pop(rid)
                    # a client may have cancelled while queued; claiming
                    # the future here also makes a later set_result safe
                    if fut.set_running_or_notify_cancel():
                        batch.append((rid, feeds_i, fut))
            if not batch:
                continue
            try:
                feeds = {
                    k: np.concatenate([f[k] for _, f, _ in batch])
                    for k in batch[0][1]
                }
                outs = self._pred.predict_batch(feeds)
                row = 0
                for _, f, fut in batch:
                    k = next(iter(f))
                    rows = f[k].shape[0]
                    fut.set_result([o[row:row + rows] for o in outs])
                    row += rows
            except Exception as e:          # noqa: BLE001 — fan the error out
                for _, _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)

    def pending(self):
        with self._reqs_lock:
            if self._q is None:
                return 0
            return self._q.pending()

    def close(self, join_timeout=30):
        """Drain and stop. The native queue is freed ONLY once the
        worker thread has exited — if the worker is stuck inside a long
        engine call (a first call builds the kernels' libraries) the
        handle is deliberately leaked instead of freed under its feet."""
        with self._reqs_lock:
            if self._closed:
                return
            self._closed = True
        self._q.close()
        self._worker.join(timeout=join_timeout)
        if self._worker.is_alive():
            import warnings
            warnings.warn("BatchingServer worker still busy after "
                          f"{join_timeout}s — leaking the native queue "
                          "handle rather than freeing it mid-use")
            return
        with self._reqs_lock:
            self._q.destroy()
            self._q = None
