"""Save/load parameters & persistables.

Parity: python/paddle/fluid/io.py (save_vars/save_params/save_persistables,
load_*); the port's own copy of ``paddle_tpu/io/state.py``, writing the
same files. Storage format: one .npy per var under dirname, or a single
combined .npz when filename is given — a portable host-side format (the
reference writes LoDTensor protobufs; io/fluid_format.py reads and
writes those). The .npy files are byte-identical to the JAX package's;
an .npz differs only in its zip entries' timestamps.

Loads place each value on the executor's device (``executor.device``):
the card for ``Executor()``, the CPU for ``Executor(CPUPlace())``.

Robustness: every file save_vars writes lands ATOMICALLY (temp file +
fsync + os.replace) — a crash mid-save leaves the previous file intact,
never a torn .npy/.npz that numpy would half-load. `scope=` selects the
variable store (checkpoint rollback restores into a GuardedTrainer's
private scope, not whatever the global scope happens to be).
"""

import os

import numpy as np
import torch

from ..core.framework import Parameter, default_main_program
from ..core.executor import global_scope


def host_array(value):
    """A scope value (a tensor on any device, a sharded value, or
    array-like) as a host numpy array of its own (a copy even for a CPU
    tensor, whose ``.numpy()`` would share memory the optimizers update
    in place); the device-to-host copy happens here, on the caller's
    thread. A sharded value on a local mesh gives its global array, as
    ``np.asarray`` of a JAX array does. In a ``torch.distributed`` world
    its other blocks live in other processes, and, as ``np.asarray`` of a
    JAX array that spans other processes' devices, this raises
    RuntimeError at once: a gather here would wait for ranks that may
    never call (Fluid's ``if trainer_id == 0: save_persistables(...)``).
    Every rank calls ``save_checkpoint_sharded``, or ``full()``."""
    from ..parallel.sharded import ShardedTensor, is_replicated
    if isinstance(value, ShardedTensor):
        if value.mesh.world and not is_replicated(value.spec):
            raise RuntimeError(
                f"a value sharded as {value.spec} over a torch.distributed "
                f"world spans other processes: this process holds only "
                f"its block. Save it with io.save_checkpoint_sharded from "
                f"every rank, or gather it with ShardedTensor.full() on "
                f"every rank")
        value = value.full()
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", copy=True).numpy()
    return np.array(value)


def target_device(executor):
    """Where a load puts its tensors: the executor's device, or the card
    (``CUDAPlace(0)``, which raises without CUDA) without one."""
    dev = getattr(executor, "device", None)
    if dev is not None:
        return dev
    from ..core.place import CUDAPlace
    return CUDAPlace(0).torch_device()


def device_tensor(arr, device):
    """A host array as a tensor of its own on `device`."""
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def is_parameter(var):
    return isinstance(var, Parameter)


def is_persistable(var):
    return bool(getattr(var, "persistable", False))


def _fsync_dir(dirname):
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _atomic_save(path, writer):
    """temp + fsync + os.replace: the destination either keeps its old
    bytes or atomically becomes the complete new file."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            writer(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(os.path.dirname(path) or ".")


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, scope=None):
    program = main_program or default_main_program()
    scope = scope or global_scope()
    if vars is None:
        vars = [v for v in program.list_vars() if (predicate or is_persistable)(v)]
    os.makedirs(dirname, exist_ok=True)
    arrays = {}
    for v in vars:
        name = v.name if not isinstance(v, str) else v
        val = scope.get(name)
        if val is None:
            continue
        arrays[name] = host_array(val)
    if filename is not None:
        _atomic_save(os.path.join(dirname, filename),
                     lambda f: np.savez(f, **arrays))
    else:
        for name, arr in arrays.items():
            _atomic_save(
                os.path.join(dirname, name.replace("/", "__") + ".npy"),
                lambda f, a=arr: np.save(f, a))


def save_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    return save_vars(executor, dirname, main_program,
                     predicate=is_parameter, filename=filename, scope=scope)


def save_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None):
    return save_vars(executor, dirname, main_program,
                     predicate=is_persistable, filename=filename,
                     scope=scope)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, scope=None):
    program = main_program or default_main_program()
    scope = scope or global_scope()
    dev = target_device(executor)
    if vars is None:
        vars = [v for v in program.list_vars() if (predicate or is_persistable)(v)]
    if filename is not None:
        data = np.load(os.path.join(dirname, filename)
                       if not filename.endswith(".npz")
                       else os.path.join(dirname, filename), allow_pickle=False)
        for v in vars:
            name = v.name if not isinstance(v, str) else v
            if name in data:
                scope.set(name, device_tensor(data[name], dev))
        return
    for v in vars:
        name = v.name if not isinstance(v, str) else v
        path = os.path.join(dirname, name.replace("/", "__") + ".npy")
        if os.path.exists(path):
            scope.set(name, device_tensor(np.load(path), dev))


def load_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    return load_vars(executor, dirname, main_program,
                     predicate=is_parameter, filename=filename, scope=scope)


def load_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None):
    return load_vars(executor, dirname, main_program,
                     predicate=is_persistable, filename=filename,
                     scope=scope)


def get_parameter_value(para, executor=None):
    return host_array(global_scope().get(para.name))


def get_parameter_value_by_name(name, executor=None, program=None):
    return host_array(global_scope().get(name))
