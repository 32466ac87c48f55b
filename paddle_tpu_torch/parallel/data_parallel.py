"""Data-parallel step builder (functional API).

The counterpart of ``paddle_tpu/parallel/data_parallel.py``: JAX jits
``step_fn(state, batch)`` with the batch laid out over the mesh's batch
axis and the state replicated, so GSPMD computes the whole batch's step;
every process passes the global batch. The port runs ``step_fn`` once on
the whole batch, which is those numerics: on a local mesh on the mesh's
device, over a ``torch.distributed`` world (gloo or NCCL, one rank a
process) on each rank's own device, every rank computing the same step
from the same global batch, so the replicas stay equal. The compute is
not split: an arbitrary torch ``step_fn`` gives the port no place to put
the batch's reductions (a Program does: ``CompiledProgram.
with_data_parallel`` splits the rows and reduces over the world). Eager
torch donates nothing: ``donate_state`` is kept for the signature.
"""

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["data_parallel_step"]


def _to_device(x, device):
    if isinstance(x, dict):
        return {k: _to_device(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_device(v, device) for v in x)
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.array(x, copy=True)).to(device)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return x


def data_parallel_step(step_fn, mesh, batch_axis="dp", donate_state=True,
                       device=None):
    """Wrap step_fn(state, batch) -> (state', metrics) for `mesh`: the
    returned run(state, batch) moves the batch (tensors or numpy arrays,
    nested in dicts, lists or tuples; in a world every rank passes the
    global batch, as JAX's processes do) to the device and runs step_fn
    once on the whole batch. The device is the local mesh's, or in a
    world `device` (None: the card; "cpu" for a gloo world on the
    CPU)."""
    if batch_axis not in mesh.shape:
        raise ValueError(f"{mesh} has no axis '{batch_axis}'")
    dev = resolve_device(device) if mesh.world else mesh.devices.flat[0]

    def run(state, batch):
        return step_fn(state, _to_device(batch, dev))

    return run
