"""The port's micro-batching server (``paddle_tpu_torch.inference.
serving``: ``csrc/serve_queue.cc`` built by the port's
``utils/native.build_and_load``, and the pure-Python queue) on the CPU.

Twins of ``tests/io/test_batching_server.py`` and
``tests/io/test_serving_fallback.py``, test for test, against the same
stand-in engine, with the port's Predictor in place of JAX's in the
real-predictor test (its tp-Predictor test is in
``tests/test_torch_inference_tp.py``): the JAX package exports the fc net
and its training-time forward is the reference (rtol 1e-5, atol 1e-6).

Behavioral contract:
- concurrent submits group into one engine call (throughput knob works)
- a lone request still completes within ~max_delay (latency knob works)
- per-request outputs are the request's own rows, in order
- engine errors fan out to every future in the batch
- close() drains and further submits raise
- the pure-Python queue honors the same contract; ``backend="auto"``
  picks the native queue where it builds and reports its choice
- submit() validates the feed signature against the queued batch.
"""

import threading
import time

import numpy as np
import pytest

from paddle_tpu_torch.inference import serving

needs_native = pytest.mark.skipif(not serving.available(),
                                  reason="native serve_queue unavailable")


class _CountingEngine:
    """Stand-in predictor: output = input + 1; records batch sizes."""

    def __init__(self, delay_s=0.0):
        self.batch_sizes = []
        self.delay_s = delay_s
        self.calls = 0

    def predict_batch(self, feeds):
        self.calls += 1
        x = feeds["x"]
        self.batch_sizes.append(x.shape[0])
        if self.delay_s:
            time.sleep(self.delay_s)
        return [x + 1.0]


@needs_native
def test_concurrent_submits_group_into_batches():
    eng = _CountingEngine(delay_s=0.05)
    srv = serving.BatchingServer(eng, max_batch=8, max_delay_ms=50.0)
    try:
        futs = []
        for i in range(16):
            futs.append(srv.submit(
                {"x": np.full((1, 4), float(i), np.float32)}))
        outs = [f.result(timeout=30) for f in futs]
        for i, out in enumerate(outs):
            np.testing.assert_allclose(out[0], np.full((1, 4), i + 1.0))
        # grouping actually happened: strictly fewer engine calls than
        # requests (16 singles would be 16 calls)
        assert eng.calls < 16, eng.batch_sizes
        assert max(eng.batch_sizes) > 1, eng.batch_sizes
    finally:
        srv.close()


@needs_native
def test_lone_request_released_by_deadline():
    eng = _CountingEngine()
    srv = serving.BatchingServer(eng, max_batch=64, max_delay_ms=30.0)
    try:
        t0 = time.perf_counter()
        out = srv.submit({"x": np.ones((1, 2), np.float32)}).result(
            timeout=30)
        dt = time.perf_counter() - t0
        np.testing.assert_allclose(out[0], 2.0 * np.ones((1, 2)))
        # released by the 30ms deadline, not stuck waiting for 64 peers
        assert dt < 5.0, dt
        assert eng.batch_sizes == [1]
    finally:
        srv.close()


@needs_native
def test_multi_row_requests_get_their_own_rows():
    eng = _CountingEngine(delay_s=0.02)
    srv = serving.BatchingServer(eng, max_batch=16, max_delay_ms=40.0)
    try:
        f1 = srv.submit({"x": np.zeros((2, 3), np.float32)})
        f2 = srv.submit({"x": np.full((3, 3), 9.0, np.float32)})
        np.testing.assert_allclose(f1.result(30)[0],
                                   np.ones((2, 3), np.float32))
        np.testing.assert_allclose(f2.result(30)[0],
                                   np.full((3, 3), 10.0, np.float32))
    finally:
        srv.close()


@needs_native
def test_engine_error_fans_out():
    class Boom:
        def predict_batch(self, feeds):
            raise ValueError("engine exploded")

    srv = serving.BatchingServer(Boom(), max_batch=4, max_delay_ms=10.0)
    try:
        futs = [srv.submit({"x": np.ones((1, 1), np.float32)})
                for _ in range(3)]
        for f in futs:
            with pytest.raises(ValueError, match="engine exploded"):
                f.result(timeout=30)
    finally:
        srv.close()


@needs_native
def test_close_then_submit_raises():
    srv = serving.BatchingServer(_CountingEngine(), max_batch=4,
                                 max_delay_ms=10.0)
    srv.close()
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit({"x": np.ones((1, 1), np.float32)})


@needs_native
def test_many_threads_many_requests():
    eng = _CountingEngine()
    srv = serving.BatchingServer(eng, max_batch=8, max_delay_ms=5.0)
    results = {}
    lock = threading.Lock()

    def client(tid):
        out = srv.submit(
            {"x": np.full((1, 2), float(tid), np.float32)}).result(30)
        with lock:
            results[tid] = out[0]

    try:
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(32)]
        [t.start() for t in threads]
        [t.join(timeout=60) for t in threads]
        assert len(results) == 32
        for tid, out in results.items():
            np.testing.assert_allclose(out, np.full((1, 2), tid + 1.0))
    finally:
        srv.close()


@needs_native
def test_batching_server_over_real_predictor(tmp_path):
    """End to end: the JAX package's save_inference_model -> the port's
    create_predictor with batch buckets -> BatchingServer groups
    concurrent client requests and every client gets its own
    training-forward rows back."""
    import paddle_tpu as jfluid
    from paddle_tpu import layers as jlayers
    from paddle_tpu.core import framework as jframework
    from paddle_tpu_torch import inference

    main, startup = jframework.Program(), jframework.Program()
    with jframework.program_guard(main, startup):
        x = jfluid.data(name="x", shape=[-1, 8], dtype="float32")
        pred = jlayers.fc(jlayers.fc(x, size=16, act="relu"), size=3,
                          act="softmax")
    exe = jfluid.Executor()
    with jfluid.scope_guard(jfluid.Scope()):
        exe.run(startup)
        jfluid.io.save_inference_model(str(tmp_path / "m"), ["x"], [pred],
                                       exe, main_program=main)
        xs = np.random.default_rng(1).standard_normal(
            (8, 8)).astype(np.float32)
        ref = np.asarray(exe.run(main, feed={"x": xs},
                                 fetch_list=[pred])[0])

    cfg = inference.AnalysisConfig(str(tmp_path / "m")).disable_gpu() \
        .set_batch_buckets([4, 8])
    predictor = inference.create_predictor(cfg)
    srv = serving.BatchingServer(predictor, max_batch=8, max_delay_ms=20.0)
    try:
        assert srv.backend == "native"
        futs = [srv.submit({"x": xs[i:i + 1]}) for i in range(8)]
        for i, f in enumerate(futs):
            np.testing.assert_allclose(f.result(60)[0], ref[i:i + 1],
                                       rtol=1e-5, atol=1e-6)
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# pure-Python fallback queue
# ---------------------------------------------------------------------------

def test_python_backend_selected_and_reported():
    srv = serving.BatchingServer(_CountingEngine(), max_batch=4,
                                 max_delay_ms=10.0, backend="python")
    try:
        assert srv.backend == "python"
    finally:
        srv.close()


def test_python_backend_groups_concurrent_submits():
    eng = _CountingEngine(delay_s=0.05)
    srv = serving.BatchingServer(eng, max_batch=8, max_delay_ms=50.0,
                                 backend="python")
    try:
        futs = [srv.submit({"x": np.full((1, 4), float(i), np.float32)})
                for i in range(16)]
        outs = [f.result(timeout=30) for f in futs]
        for i, out in enumerate(outs):
            np.testing.assert_allclose(out[0], np.full((1, 4), i + 1.0))
        assert eng.calls < 16, eng.batch_sizes
        assert max(eng.batch_sizes) > 1, eng.batch_sizes
    finally:
        srv.close()


def test_python_backend_lone_request_released_by_deadline():
    eng = _CountingEngine()
    srv = serving.BatchingServer(eng, max_batch=64, max_delay_ms=30.0,
                                 backend="python")
    try:
        t0 = time.perf_counter()
        out = srv.submit({"x": np.ones((1, 2), np.float32)}).result(
            timeout=30)
        dt = time.perf_counter() - t0
        np.testing.assert_allclose(out[0], 2.0 * np.ones((1, 2)))
        assert dt < 5.0, dt          # deadline fired, not max_batch
        assert eng.batch_sizes == [1]
    finally:
        srv.close()


def test_python_backend_error_fans_out_and_close_drains():
    class Boom:
        def predict_batch(self, feeds):
            raise ValueError("engine exploded")

    srv = serving.BatchingServer(Boom(), max_batch=4, max_delay_ms=10.0,
                                 backend="python")
    try:
        futs = [srv.submit({"x": np.ones((1, 1), np.float32)})
                for _ in range(3)]
        for f in futs:
            with pytest.raises(ValueError, match="engine exploded"):
                f.result(timeout=30)
    finally:
        srv.close()
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit({"x": np.ones((1, 1), np.float32)})


def test_python_backend_many_threads():
    eng = _CountingEngine()
    srv = serving.BatchingServer(eng, max_batch=8, max_delay_ms=5.0,
                                 backend="python")
    results = {}
    lock = threading.Lock()

    def client(tid):
        out = srv.submit(
            {"x": np.full((1, 2), float(tid), np.float32)}).result(30)
        with lock:
            results[tid] = out[0]

    try:
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(24)]
        [t.start() for t in threads]
        [t.join(timeout=60) for t in threads]
        assert len(results) == 24
        for tid, out in results.items():
            np.testing.assert_allclose(out, np.full((1, 2), tid + 1.0))
    finally:
        srv.close()


def test_auto_backend_never_fails():
    """auto picks native when the toolchain builds it, python
    otherwise — constructing a server must work either way."""
    srv = serving.BatchingServer(_CountingEngine(), max_batch=2,
                                 max_delay_ms=5.0, backend="auto")
    try:
        assert srv.backend in ("native", "python")
        out = srv.submit({"x": np.zeros((1, 2), np.float32)}).result(30)
        np.testing.assert_allclose(out[0], np.ones((1, 2)))
    finally:
        srv.close()


def test_unknown_backend_rejected():
    with pytest.raises(ValueError, match="backend"):
        serving.BatchingServer(_CountingEngine(), backend="cuda")


# ---------------------------------------------------------------------------
# submit-time feed signature validation
# ---------------------------------------------------------------------------

def _slow_server(eng=None):
    # long delay + big batch: submits stay queued long enough for the
    # validation to see them (deterministic — the worker cannot launch
    # until max_delay passes)
    return serving.BatchingServer(eng or _CountingEngine(delay_s=0.01),
                                  max_batch=64, max_delay_ms=200.0,
                                  backend="python")


def test_mismatched_trailing_dims_rejected_at_submit():
    srv = _slow_server()
    try:
        ok = srv.submit({"x": np.ones((1, 4), np.float32)})
        with pytest.raises(ValueError, match="feed signature mismatch"):
            srv.submit({"x": np.ones((1, 5), np.float32)})
        # the queued batch is NOT poisoned: the first request completes
        np.testing.assert_allclose(ok.result(timeout=30)[0],
                                   2.0 * np.ones((1, 4)))
    finally:
        srv.close()


def test_mismatched_keys_rejected_at_submit():
    srv = _slow_server()
    try:
        srv.submit({"x": np.ones((1, 4), np.float32)})
        with pytest.raises(ValueError, match="feed signature mismatch"):
            srv.submit({"x": np.ones((1, 4), np.float32),
                        "y": np.ones((1, 1), np.float32)})
    finally:
        srv.close()


def test_mismatched_dtype_rejected_at_submit():
    srv = _slow_server()
    try:
        srv.submit({"x": np.ones((1, 4), np.float32)})
        with pytest.raises(ValueError, match="feed signature mismatch"):
            srv.submit({"x": np.ones((1, 4), np.float64)})
    finally:
        srv.close()


def test_different_row_counts_still_cobatch():
    """Row count (axis 0) is NOT part of the signature — multi-row
    requests co-batch with single-row ones by design."""
    srv = _slow_server()
    try:
        f1 = srv.submit({"x": np.zeros((2, 3), np.float32)})
        f2 = srv.submit({"x": np.full((3, 3), 9.0, np.float32)})
        np.testing.assert_allclose(f1.result(30)[0], np.ones((2, 3)))
        np.testing.assert_allclose(f2.result(30)[0], np.full((3, 3), 10.0))
    finally:
        srv.close()


def test_signature_resets_once_queue_drains():
    """Validation compares against requests CURRENTLY queued: after the
    batch flushes, a new shape is a fresh first request, not an error."""
    eng = _CountingEngine()
    srv = serving.BatchingServer(eng, max_batch=2, max_delay_ms=5.0,
                                 backend="python")
    try:
        srv.submit({"x": np.ones((1, 4), np.float32)}).result(timeout=30)
        out = srv.submit({"x": np.ones((1, 7), np.float32)}).result(
            timeout=30)
        np.testing.assert_allclose(out[0], 2.0 * np.ones((1, 7)))
    finally:
        srv.close()
