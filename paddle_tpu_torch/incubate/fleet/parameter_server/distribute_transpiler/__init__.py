"""Parity shim: incubate/fleet/parameter_server/distribute_transpiler,
the pserver fleet mode; see parameter_server/__init__.py for why it is
not ported."""

_MSG = ("{name}: the parameter-server fleet mode is not ported; "
        "optimizer state shards over the mesh instead (ZeRO / FSDP). Use "
        "paddle_tpu_torch.incubate.fleet.collective.fleet with a "
        "DistributedStrategy; see parallel/transpiler.py.")

__all__ = ["DistributedTranspiler", "TranspilerOptimizer"]


class DistributedTranspiler:
    def __init__(self, *a, **k):
        raise NotImplementedError(_MSG.format(name="DistributedTranspiler"))


class TranspilerOptimizer:
    def __init__(self, *a, **k):
        raise NotImplementedError(_MSG.format(name="TranspilerOptimizer"))
