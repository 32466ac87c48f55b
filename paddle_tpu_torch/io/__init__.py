"""Checkpoint I/O of the port (``paddle_tpu/io``'s checkpoint part):
``save_checkpoint`` / ``load_checkpoint`` in the JAX package's format 2,
atomic writes and a CRC32 manifest."""

from .checkpoint import (CHECKPOINT_FORMAT, CheckpointCorruptError,
                         load_checkpoint, save_checkpoint,
                         set_write_fault_hook)

__all__ = ["CHECKPOINT_FORMAT", "CheckpointCorruptError",
           "save_checkpoint", "load_checkpoint", "set_write_fault_hook"]
