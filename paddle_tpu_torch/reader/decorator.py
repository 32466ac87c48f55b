"""Reader decorators.

Parity: python/paddle/reader/decorator.py (batch, shuffle, buffered, cache,
chain, compose, map_readers, firstn, xmap_readers, multiprocess_reader,
Fake, PipeReader, ComposeNotAligned); the port's own copy of
``paddle_tpu/reader/decorator.py``.
"""

import itertools
import queue
import random
import threading


def batch(reader, batch_size, drop_last=False):
    def batch_reader():
        b = []
        for item in reader():
            b.append(item)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b
    return batch_reader


def shuffle(reader, buf_size):
    def shuffle_reader():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                yield from buf
                buf = []
        random.shuffle(buf)
        yield from buf
    return shuffle_reader


def buffered(reader, size):
    """Background-thread prefetch with a bounded queue."""
    class _End:
        pass

    def buffered_reader():
        q = queue.Queue(maxsize=size)

        def producer():
            try:
                for item in reader():
                    q.put(item)
            finally:
                q.put(_End)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is _End:
                break
            yield item
    return buffered_reader


def cache(reader):
    all_data = []
    filled = []

    def cache_reader():
        if not filled:
            all_data.extend(reader())
            filled.append(True)
        yield from all_data
    return cache_reader


def chain(*readers):
    def chain_reader():
        for r in readers:
            yield from r()
    return chain_reader


class ComposeNotAligned(ValueError):
    """Raised when composed readers yield different lengths
    (parity: paddle.reader.ComposeNotAligned)."""


def compose(*readers, check_alignment=True):
    def compose_reader():
        its = [r() for r in readers]
        if check_alignment:
            sentinel = object()
            zipped = itertools.zip_longest(*its, fillvalue=sentinel)
        else:
            zipped = zip(*its)      # reference semantics: stop at shortest
        for items in zipped:
            # identity checks only: `in`/== would invoke ndarray.__eq__
            if check_alignment and any(it is sentinel for it in items):
                raise ComposeNotAligned(
                    "composed readers have different lengths")
            out = ()
            for item in items:
                out += item if isinstance(item, tuple) else (item,)
            yield out
    return compose_reader


def map_readers(func, *readers):
    def map_reader():
        its = [r() for r in readers]
        for items in zip(*its):
            yield func(*items)
    return map_reader


def firstn(reader, n):
    def firstn_reader():
        yield from itertools.islice(reader(), n)
    return firstn_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Thread-pool mapper (the reference uses processes; threads suffice for
    numpy transforms and avoid fork issues with a live CUDA context)."""
    def xmap_reader():
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(process_num) as pool:
            window = []
            for item in reader():
                window.append(pool.submit(mapper, item))
                if len(window) >= buffer_size:
                    yield window.pop(0).result()
            for fut in window:
                yield fut.result()
    return xmap_reader


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    return chain(*readers)


class Fake:
    """Caches the first sample and replays it forever-per-call (parity:
    paddle.reader.Fake — pipeline debugging with constant data)."""

    def __init__(self):
        self.data = None
        self.yield_num = 0

    def __call__(self, reader, max_num):
        def fake_reader():
            if self.data is None:
                self.data = next(reader())
            # reset on entry, not exhaustion — an abandoned generator must
            # not shorten the next call's stream
            self.yield_num = 0
            while self.yield_num < max_num:
                self.yield_num += 1
                yield self.data
        return fake_reader


class PipeReader:
    """Stream lines from a shell command's stdout (parity:
    paddle.reader.PipeReader — e.g. `cat x.gz | gzip -d`). The
    subprocess replaces the reference's hadoop/streaming use; batches are
    buffered bytes split on newlines."""

    def __init__(self, command, bufsize=8192, file_type="plain"):
        import subprocess
        self.process = subprocess.Popen(
            command.split(" "), bufsize=bufsize, stdout=subprocess.PIPE)
        self.bufsize = bufsize
        if file_type == "gzip":
            import zlib
            self.dec = zlib.decompressobj(32 + zlib.MAX_WBITS)
        else:
            self.dec = None

    def get_line(self, cut_lines=True, line_break="\n"):
        remained = b""
        while True:
            buf = self.process.stdout.read(self.bufsize)
            if not buf:
                break
            if self.dec is not None:
                buf = self.dec.decompress(buf)
            if not cut_lines:
                yield buf
                continue
            buf = remained + buf
            lines = buf.split(line_break.encode())
            remained = lines.pop()
            for line in lines:
                yield line.decode(errors="replace")
        if self.dec is not None:
            # drain the decompressor's internal tail: without flush()
            # bytes buffered past the last read are silently dropped
            # (latent bug in the reference's PipeReader, fixed here)
            tail = self.dec.flush()
            if tail:
                if not cut_lines:
                    yield tail
                else:
                    lines = (remained + tail).split(line_break.encode())
                    remained = lines.pop()
                    for line in lines:
                        yield line.decode(errors="replace")
        if remained:
            yield remained.decode(errors="replace")
