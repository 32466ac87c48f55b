"""Parity shim: python/paddle/fluid/distributed/downpour.py:24
(``DownpourSGD``), a documented non-port of the Downpour async-SGD
parameter-server trainer; the counterpart of
``paddle_tpu/distributed/downpour.py``.

Downpour splits a model into dense parameters (synced by pserver push /
pull) and sparse embedding tables sharded over pservers. The port
reaches the same scale synchronously: embeddings shard over the mesh,
optimizer state shards with ZeRO-1 / FSDP (``parallel/transpiler.py``),
and the gradients ride the walk's collectives. Use

    from paddle_tpu_torch.incubate.fleet.collective import fleet

with ``DistributedStrategy`` (zero_stage / use_fsdp) instead.
"""

__all__ = ["DownpourSGD"]


class DownpourSGD:
    def __init__(self, learning_rate=0.001, window=1):
        raise NotImplementedError(
            "DownpourSGD is a pserver async-SGD trainer with no analog in "
            "the port: shard embeddings and optimizer state over the mesh "
            "instead (fleet + DistributedStrategy(zero_stage=1 or "
            "use_fsdp=True)). See distributed/downpour.py.")
