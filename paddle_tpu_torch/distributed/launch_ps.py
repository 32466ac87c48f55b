"""Parameter-server launcher: a documented non-port.

Parity target: python/paddle/distributed/launch_ps.py, which spawns
pserver and trainer process groups for the async / geo-SGD
parameter-server mode; the counterpart of
``paddle_tpu/distributed/launch_ps.py``. The port has no parameter
servers: optimizer state shards over the mesh (ZeRO-1 / FSDP, see
``parallel/transpiler.py``), and the gradients ride the walk's
collectives. Launch collective workers with
``python -m paddle_tpu_torch.distributed.launch`` instead.
"""


def launch(argv=None):
    raise RuntimeError(
        "paddle_tpu_torch has no parameter-server mode: training shards "
        "optimizer state over the mesh (ZeRO / FSDP) instead of hosting it "
        "on pservers. Use `python -m paddle_tpu_torch.distributed.launch` "
        "with fleet's DistributedStrategy (see parallel/transpiler.py).")


if __name__ == "__main__":
    launch()
