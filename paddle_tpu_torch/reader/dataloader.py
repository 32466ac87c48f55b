"""DataLoader: host batching, and the host-to-device copy overlapped with
the device's compute.

Parity: fluid.io.DataLoader / py_reader (python/paddle/fluid/reader.py +
the C++ double-buffered reader ops); the counterpart of
``paddle_tpu/reader/dataloader.py``. The native prefetch ring (``csrc/``
via reader/native.py) overlaps host batching with the consumer; the
python fallback is a bounded background thread. ``DataLoader.ring`` says
which one the last iteration used ("native" or "python").

`device_prefetch` is the device half of the reference's double-buffered
reader (buffered_reader.cc keeps a CUDA-pinned staging slot a batch): each
batch is staged in pinned host memory and copied with ``non_blocking=True``
on a copy stream of its own, and an event recorded after the copy is what
the compute stream waits on before the step that reads it, so the copy of
batch k+1 runs under step k. On the CPU (``device="cpu"``, as the tests
pass) it converts each batch to tensors and nothing overlaps.
"""

import collections
import queue
import threading

import numpy as np
import torch


class DataLoader:
    def __init__(self, feed_list=None, capacity=4, use_double_buffer=True,
                 iterable=True, return_list=False, use_native=True):
        self.feed_list = feed_list or []
        self.capacity = capacity
        self._generator = None
        self._places = None
        self._batch_reader = None
        # native C++ ring (csrc/prefetch.cc) when buildable; else thread+queue
        self._use_native = use_native and use_double_buffer
        self.ring = None            # "native" | "python", set by __iter__

    @staticmethod
    def from_generator(feed_list=None, capacity=4, use_double_buffer=True,
                       iterable=True, return_list=False):
        return DataLoader(feed_list, capacity, use_double_buffer, iterable,
                          return_list)

    def set_batch_generator(self, reader, places=None):
        self._batch_reader = reader
        self._places = places
        return self

    def set_sample_list_generator(self, reader, places=None):
        from ..core.data_feeder import DataFeeder
        feeder = DataFeeder(self.feed_list)

        def batch_reader():
            for samples in reader():
                yield feeder.feed(samples)
        self._batch_reader = batch_reader
        self._places = places
        return self

    def __iter__(self):
        if self._batch_reader is None:
            raise RuntimeError("no generator set on DataLoader")
        from . import native
        if self._use_native and native.available():
            self.ring = "native"
            return iter(native.native_buffered(self._batch_reader,
                                               self.capacity)())
        self.ring = "python"
        return iter(_Prefetcher(self._batch_reader, self.capacity))


def _resolve_device(device):
    if device is None:
        from ..core.place import CUDAPlace
        return CUDAPlace(0).torch_device()
    if hasattr(device, "torch_device"):
        return device.torch_device()
    return torch.device(device)


def _map(batch, fn):
    if isinstance(batch, dict):
        return {k: fn(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(fn(v) for v in batch)
    return fn(batch)


def _host_tensor(value):
    if isinstance(value, torch.Tensor):
        return value
    return torch.from_numpy(np.array(value, copy=True))


def device_prefetch(batch_iter, depth=2, device=None, transform=None,
                    copy_events=None):
    """Overlap the host-to-device copy with the device's compute: while
    step k runs, batch k+1 is already on its way to the card.

    `device` is where the batches go: None means the card
    (``CUDAPlace(0)``, which raises without CUDA); the tests pass
    ``"cpu"``. `transform` is a host-side hook applied to each batch
    BEFORE the upload: the seam ``Executor.run_pipelined`` uses for the
    feed canonicalization and FeedBucketer padding (padding a device
    tensor would round-trip the host, so it must happen here). `depth`
    batches are in flight at once. With `copy_events` (a list) each
    batch's copy appends its (start, end) CUDA events, recorded on the
    copy stream, for a caller that measures the overlap.

    Works on dict or list batches of numpy arrays (or host tensors);
    yields the same structure holding tensors on `device`. On CUDA a
    batch is yielded only after the current stream was told to wait for
    its copy, and its tensors are recorded as used by that stream, so
    the caching allocator never hands their memory to a later copy while
    a step still reads them.
    """
    device = _resolve_device(device)

    def gen():
        buf = collections.deque()
        it = iter(batch_iter() if callable(batch_iter) else batch_iter)
        if device.type != "cuda":
            for batch in it:
                if transform is not None:
                    batch = transform(batch)
                yield _map(batch, lambda v: _host_tensor(v).to(device))
            return
        copy_stream = torch.cuda.Stream(device)

        def upload(batch):
            pinned = _map(batch, lambda v: _host_tensor(v).pin_memory())
            with torch.cuda.stream(copy_stream):
                start = end = None
                if copy_events is not None:
                    start = torch.cuda.Event(enable_timing=True)
                    start.record(copy_stream)
                out = _map(pinned, lambda t: t.to(device,
                                                  non_blocking=True))
                done = torch.cuda.Event(enable_timing=copy_events
                                        is not None)
                done.record(copy_stream)
                if copy_events is not None:
                    copy_events.append((start, done))
            return out, done

        def hand_over(item):
            out, done = item
            compute = torch.cuda.current_stream(device)
            compute.wait_event(done)
            _map(out, lambda t: t.record_stream(compute))
            return out

        try:
            for batch in it:
                if transform is not None:
                    batch = transform(batch)
                buf.append(upload(batch))
                if len(buf) >= depth:
                    yield hand_over(buf.popleft())
            while buf:
                yield hand_over(buf.popleft())
        finally:
            buf.clear()

    return gen()


class _Prefetcher:
    """Bounded background-thread prefetch; keeps the accelerator fed while
    the host assembles the next batch (double buffering)."""

    def __init__(self, batch_reader, capacity):
        self._reader = batch_reader
        self._capacity = max(2, capacity)

    def __iter__(self):
        q = queue.Queue(maxsize=self._capacity)
        END = object()

        def producer():
            try:
                for item in self._reader():
                    q.put(item)
            finally:
                q.put(END)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is END:
                return
            yield item
