"""Data-parallel step builder (functional API).

The counterpart of ``paddle_tpu/parallel/data_parallel.py``: JAX jits
``step_fn(state, batch)`` with the batch laid out over the mesh's batch
axis and the state replicated, so GSPMD computes the whole batch's step.
On a local mesh the port runs ``step_fn`` on the whole batch on the
mesh's device, which is those numerics; a world mesh (one rank a
process) raises. Eager torch donates nothing: ``donate_state`` is kept
for the signature.
"""

import numpy as np
import torch

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


def data_parallel_step(step_fn, mesh, batch_axis="dp", donate_state=True):
    """Wrap step_fn(state, batch) -> (state', metrics) for `mesh`: the
    returned run(state, batch) moves the batch (tensors or numpy arrays,
    nested in dicts, lists or tuples) to the mesh's device and runs
    step_fn once on the whole batch."""
    if mesh.world:
        raise NotImplementedError(
            "data_parallel_step over a torch.distributed world is not "
            "ported (ROADMAP queue A item 10c); use a local mesh, or "
            "CompiledProgram.with_data_parallel for a Program")
    if batch_axis not in mesh.shape:
        raise ValueError(f"{mesh} has no axis '{batch_axis}'")
    device = mesh.devices.flat[0]

    def run(state, batch):
        return step_fn(state, _to_device(batch, device))

    return run
