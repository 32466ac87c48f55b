"""Readers of the port (``paddle_tpu/reader``'s counterpart): the reader
decorators (``decorator.py``), the DataLoader over the native prefetch
ring and the pinned, copy-stream ``device_prefetch`` (``dataloader.py``,
``native.py``), and the host-side sequence packing (``packing.py``)."""

from .decorator import (batch, shuffle, buffered, cache, chain, compose,
                        map_readers, firstn, xmap_readers,
                        multiprocess_reader, ComposeNotAligned, Fake,
                        PipeReader)
from .dataloader import DataLoader, device_prefetch
from .packing import pack_sequences, packing_efficiency

__all__ = ["batch", "shuffle", "buffered", "cache", "chain", "compose",
           "map_readers", "firstn", "xmap_readers", "multiprocess_reader",
           "ComposeNotAligned", "Fake", "PipeReader", "DataLoader",
           "device_prefetch", "pack_sequences", "packing_efficiency"]
