"""Parity shims: python/paddle/fluid/incubate/fleet/parameter_server/, a
documented non-port of the parameter-server fleet modes (the counterpart
of ``paddle_tpu/incubate/fleet/parameter_server/``).

Both halves (the distribute_transpiler mode and the pslib Downpour
runtime) spread a sparse or async CPU training job over pserver
processes. The port has no pserver tier: parameters, large embeddings
included, shard over the mesh as ordinary values, optimizer state shards
with ZeRO-1 / FSDP (``parallel/transpiler.py``), and the push / pull
becomes the walk's collectives. Use

    from paddle_tpu_torch.incubate.fleet.collective import fleet

with a DistributedStrategy instead. The classes here import and raise
with that guidance when constructed (the launch half is
``distributed/launch_ps.py``).
"""

from . import distribute_transpiler  # noqa: F401
from . import pslib  # noqa: F401
