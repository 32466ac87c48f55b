"""Readers of the port: the host-side sequence packing of
``paddle_tpu/reader/packing.py``. The reader decorators, the DataLoader
and the datasets are not ported yet."""

from .packing import pack_sequences, packing_efficiency

__all__ = ["pack_sequences", "packing_efficiency"]
