"""Parity shim: python/paddle/fluid/communicator.py:22, a documented
non-port of the async / geo-SGD parameter-server communicator; the
counterpart of ``paddle_tpu/communicator.py``.

The reference Communicator is a C++ background thread pool that pushes
gradients to, and pulls parameters from, pservers asynchronously (the
DistributeTranspiler's async mode). The port has no pservers: optimizer
state shards over the mesh (ZeRO-1 / FSDP, ``parallel/transpiler.py``)
and the gradient exchange is the walk's collectives inside the step,
synchronous and without staleness.

The class imports and constructs (so transpiled code paths survive);
start() and stop() only flip a flag, with a warning at construction.
"""

import warnings

__all__ = ["Communicator"]


class Communicator:
    def __init__(self, program=None):
        self._running = False
        warnings.warn(
            "Communicator is a no-op in paddle_tpu_torch: the gradients "
            "ride the walk's collectives inside the step (no async pserver "
            "push / pull). See parallel/transpiler.py.", stacklevel=2)

    def start(self):
        self._running = True

    def stop(self):
        self._running = False

    def is_running(self):
        return self._running
