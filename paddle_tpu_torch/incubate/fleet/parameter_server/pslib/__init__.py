"""Parity shim: incubate/fleet/parameter_server/pslib, the Downpour
pserver runtime (PSLib, DownpourOptimizer, DistributedAdam, the Server /
Worker node descriptors); not ported, see parameter_server/__init__.py."""

_MSG = ("{name}: the pslib Downpour parameter-server runtime is not "
        "ported; sparse tables shard over the mesh as ordinary parameters "
        "and the push / pull is the walk's collectives. Use "
        "paddle_tpu_torch.incubate.fleet.collective.fleet; see "
        "parallel/transpiler.py.")

__all__ = ["PSLib", "DownpourOptimizer", "DistributedAdam",
           "Server", "Worker", "DownpourServer", "DownpourWorker"]


def _shim(name):
    class _Shim:
        def __init__(self, *a, **k):
            raise NotImplementedError(_MSG.format(name=name))
    _Shim.__name__ = _Shim.__qualname__ = name
    return _Shim


PSLib = _shim("PSLib")
DownpourOptimizer = _shim("DownpourOptimizer")
DistributedAdam = _shim("DistributedAdam")
Server = _shim("Server")
Worker = _shim("Worker")
DownpourServer = _shim("DownpourServer")
DownpourWorker = _shim("DownpourWorker")
