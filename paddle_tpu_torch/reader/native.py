"""ctypes binding for the C++ prefetch ring (csrc/prefetch.cc).

Parity: the reference's C++ reader stack (buffered_reader.cc /
blocking_queue.h behind py_reader): batches cross the Python/producer ->
consumer boundary through a native fixed-slot ring with real backpressure,
instead of a GIL-bound queue.Queue. Arrays are framed in a flat binary
format (no pickle) so a batch is one memcpy in and one memcpy out of the
ring.

The port's own copy of ``paddle_tpu/reader/native.py``, over the same
sources. Build: compiled on first use with g++ by ``utils/native.py``
into ``paddle_tpu_torch/csrc/build/``; `available()` lets callers gate
on it (``DataLoader.ring`` records which ring a loader used).
"""

import ctypes
import struct
import threading

import numpy as np

from ..utils.native import build_and_load

_lib = None
_lib_lock = threading.Lock()


def load_library():
    """Load (building if needed) the native ring library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = build_and_load("prefetch.cc")
        lib.pt_ring_create.restype = ctypes.c_void_p
        lib.pt_ring_create.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
        lib.pt_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.pt_ring_push.restype = ctypes.c_int
        lib.pt_ring_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_size_t]
        lib.pt_ring_peek_len.restype = ctypes.c_int64
        lib.pt_ring_peek_len.argtypes = [ctypes.c_void_p]
        lib.pt_ring_pop.restype = ctypes.c_int64
        lib.pt_ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_size_t]
        lib.pt_ring_close.argtypes = [ctypes.c_void_p]
        lib.pt_ring_count.restype = ctypes.c_size_t
        lib.pt_ring_count.argtypes = [ctypes.c_void_p]
        lib.pt_ring_closed.restype = ctypes.c_int
        lib.pt_ring_closed.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available():
    try:
        load_library()
        return True
    except Exception:
        return False


# --------------------------------------------------------------------------
# batch (de)serialization: [n:u32] then per entry
#   [klen:u16][key][dtype_len:u8][dtype][ndim:u8][dims:i64*ndim][raw bytes]
# Keys are empty for positional (list/tuple) batches.
# --------------------------------------------------------------------------

def serialize_batch(batch):
    if isinstance(batch, dict):
        items = list(batch.items())
    else:
        items = [("", a) for a in batch]
    parts = [struct.pack("<I", len(items))]
    for key, arr in items:
        a = np.ascontiguousarray(arr)
        kb = key.encode()
        db = str(a.dtype).encode()
        parts.append(struct.pack("<H", len(kb)))
        parts.append(kb)
        parts.append(struct.pack("<B", len(db)))
        parts.append(db)
        parts.append(struct.pack("<B", a.ndim))
        parts.append(struct.pack(f"<{a.ndim}q", *a.shape) if a.ndim else b"")
        parts.append(a.tobytes())
    return b"".join(parts)


def deserialize_batch(buf):
    off = 0
    (n,) = struct.unpack_from("<I", buf, off); off += 4
    keys, arrs = [], []
    for _ in range(n):
        (klen,) = struct.unpack_from("<H", buf, off); off += 2
        key = bytes(buf[off:off + klen]).decode(); off += klen
        (dlen,) = struct.unpack_from("<B", buf, off); off += 1
        dtype = np.dtype(bytes(buf[off:off + dlen]).decode()); off += dlen
        (ndim,) = struct.unpack_from("<B", buf, off); off += 1
        shape = struct.unpack_from(f"<{ndim}q", buf, off) if ndim else ()
        off += 8 * ndim
        nbytes = dtype.itemsize * int(np.prod(shape, dtype=np.int64)) \
            if ndim else dtype.itemsize
        arr = np.frombuffer(buf, dtype=dtype, count=nbytes // dtype.itemsize,
                            offset=off).reshape(shape)
        off += nbytes
        keys.append(key)
        arrs.append(arr)
    if any(keys):
        return dict(zip(keys, arrs))
    return arrs


class NativeRing:
    """Thin OO wrapper over the C ring."""

    def __init__(self, slots=8, slot_bytes=1 << 20):
        self._lib = load_library()
        self._ptr = self._lib.pt_ring_create(slots, slot_bytes)

    def push(self, data: bytes):
        return self._lib.pt_ring_push(self._ptr, data, len(data)) == 0

    def pop(self):
        """Returns a writable buffer (memoryview over a fresh ctypes
        allocation — deserialized arrays stay mutable, matching the python
        queue path), or None on EOF (closed + drained)."""
        ln = self._lib.pt_ring_peek_len(self._ptr)
        if ln < 0:
            return None
        buf = ctypes.create_string_buffer(ln)
        got = self._lib.pt_ring_pop(self._ptr, buf, ln)
        if got < 0:
            return None
        return memoryview(buf).cast("B")[:got]

    def close(self):
        self._lib.pt_ring_close(self._ptr)

    def __len__(self):
        return self._lib.pt_ring_count(self._ptr)

    def __del__(self):
        try:
            if getattr(self, "_ptr", None):
                self._lib.pt_ring_close(self._ptr)
                self._lib.pt_ring_destroy(self._ptr)
                self._ptr = None
        except Exception:
            pass


_pool_lib = None


def load_pool_library():
    """Load (building if needed) the native loader-pool library."""
    global _pool_lib
    with _lib_lock:
        if _pool_lib is not None:
            return _pool_lib
        lib = build_and_load("loader_pool.cc")
        lib.pl_pool_create.restype = ctypes.c_void_p
        lib.pl_pool_create.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_void_p, ctypes.c_int]
        lib.pl_pool_add_source.restype = ctypes.c_int
        lib.pl_pool_add_source.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int32, ctypes.c_int64]
        lib.pl_pool_start.restype = ctypes.c_int64
        lib.pl_pool_start.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_uint64, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.pl_pool_join.argtypes = [ctypes.c_void_p]
        lib.pl_pool_destroy.argtypes = [ctypes.c_void_p]
        _pool_lib = lib
        return _pool_lib


class NativeLoaderPool:
    """Multi-worker C++ batch assembler over in-memory arrays.

    N native threads gather rows (deterministic per-epoch shuffle), stack
    them into framed batches (the serialize_batch format) and push into the
    prefetch ring — the whole inner loop runs off the GIL. Parity: the
    reference's open_files / MultiFileReader thread pool feeding
    buffered_reader (csrc/loader_pool.cc has the map).

    arrays: dict name->ndarray (feed-dict batches) or list/tuple of
    ndarrays (positional batches); all must share dim 0 (dataset length).
    `ordered=True` guarantees the consumer sees batches in batch-id order
    even with many workers, so a seeded run is fully deterministic.
    """

    def __init__(self, arrays, batch_size, epochs=1, shuffle_seed=None,
                 drop_last=False, ordered=True, n_workers=2, slots=8):
        self._ringlib = load_library()
        self._lib = load_pool_library()
        if isinstance(arrays, dict):
            items = list(arrays.items())
        else:
            items = [("", a) for a in arrays]
        # keep contiguous refs alive for the pool's lifetime (C++ reads
        # the raw pointers until destroy)
        self._arrays = [(k, np.ascontiguousarray(v)) for k, v in items]
        rows = {a.shape[0] for _, a in self._arrays}
        if len(rows) != 1:
            raise ValueError(f"sources disagree on dataset length: {rows}")
        n = rows.pop()
        batch_bytes = sum(
            int(np.prod(a.shape[1:], dtype=np.int64)) * a.dtype.itemsize
            for _, a in self._arrays) * batch_size
        # 4 fixed bytes per source frame header: u16 klen + u8 dlen +
        # u8 ndim (loader_pool.cc write_frame) — matches the C++ layout
        # so the ring slot never reallocs
        header = 4 + sum(4 + len(k.encode()) + len(str(a.dtype)) +
                         8 * a.ndim for k, a in self._arrays)
        self._ring = NativeRing(slots=slots,
                                slot_bytes=batch_bytes + header)
        self._ptr = self._lib.pl_pool_create(
            self._ring._ptr,
            ctypes.cast(self._ringlib.pt_ring_push, ctypes.c_void_p),
            ctypes.cast(self._ringlib.pt_ring_close, ctypes.c_void_p),
            int(n_workers))
        for k, a in self._arrays:
            dims = (ctypes.c_int64 * max(1, a.ndim - 1))(*a.shape[1:])
            rc = self._lib.pl_pool_add_source(
                self._ptr, k.encode(), str(a.dtype).encode(),
                a.ctypes.data_as(ctypes.c_void_p), n, dims, a.ndim - 1,
                int(np.prod(a.shape[1:], dtype=np.int64)) * a.dtype.itemsize)
            if rc != 0:
                raise RuntimeError(f"pl_pool_add_source failed rc={rc}")
        self.total_batches = self._lib.pl_pool_start(
            self._ptr, batch_size, epochs,
            0 if shuffle_seed is None else int(shuffle_seed),
            0 if shuffle_seed is None else 1,
            1 if drop_last else 0, 1 if ordered else 0)
        if self.total_batches < 0:
            raise RuntimeError("pl_pool_start rejected the config")

    def __iter__(self):
        while True:
            raw = self._ring.pop()
            if raw is None:
                return
            yield deserialize_batch(raw)

    def close(self):
        if getattr(self, "_ptr", None):
            self._lib.pl_pool_destroy(self._ptr)
            self._ptr = None

    def __del__(self):
        try:
            self.close()  # joins workers, so the ring outlives every push
        except Exception:
            pass


def pool_reader(arrays, batch_size, **kw):
    """Reader-decorator facade over NativeLoaderPool (same call shape as
    paddle.batch(paddle.reader.shuffle(...)) chains, but native)."""

    def reader_fn():
        pool = NativeLoaderPool(arrays, batch_size, **kw)
        try:
            yield from pool
        finally:
            pool.close()

    return reader_fn


def native_buffered(reader, size=8):
    """Decorator parity with reader.buffered(), but the buffer is the C++
    ring: the producer thread serializes+pushes while the consumer pops.
    Use for numpy-array batches (samples pass through serialize_batch)."""

    def reader_fn():
        ring = NativeRing(slots=size)
        exc = []

        def produce():
            try:
                for item in reader():
                    if not ring.push(serialize_batch(item)):
                        break
            except Exception as e:  # surfaced on the consumer side
                exc.append(e)
            finally:
                ring.close()

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                raw = ring.pop()
                if raw is None:
                    break
                yield deserialize_batch(raw)
        finally:
            # abandoning the iterator (break / GeneratorExit) must unblock
            # the producer's pt_ring_push wait, or the thread leaks
            ring.close()
            t.join()
        if exc:
            raise exc[0]

    return reader_fn
