"""Device mesh: named axes over ranks.

The counterpart of ``paddle_tpu/parallel/mesh.py``'s ``MeshConfig``,
``make_mesh``, ``set_mesh``/``get_mesh`` and ``mesh_axes``, with the part
the ring attention needs. A mesh lays its ranks out as JAX's does, on
five named axes ordered ("dp", "pp", "ep", "sp", "tp"), tp innermost:

    dp    data parallel (batch)
    tp    tensor (megatron) parallel (heads)
    pp    pipeline stages
    sp    sequence/context parallel (ring attention)
    ep    expert parallel (MoE)

A mesh has one of two forms:

- over a ``torch.distributed`` world (``make_mesh`` after
  ``init_process_group``, no ``devices``): one rank is one process, which
  holds its own shard; the mesh makes the ``sp`` sub-groups (the ranks
  that differ only along sp), over which the ring's K/V rotate;
- *local* (``devices=`` a list of torch devices, or no world): every rank
  lives in this process, and a sharded function runs each rank's part in
  turn on the tensors' device. It plays the part of the JAX tests'
  virtual 8-device CPU mesh, and it is the form one card runs, since one
  H100 cannot hold two NCCL ranks.

``with mesh:`` activates the mesh for the ops of a Program, as JAX's
``with mesh:`` sets the physical mesh that ``ops/attention_ops.py`` reads
(``active_mesh``). The hybrid DCN mesh, ``host_domains``,
``multihost_initialize`` and the sharding helpers are not ported.
"""

import threading

import numpy as np
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["MeshConfig", "Mesh", "make_mesh", "set_mesh", "get_mesh",
           "mesh_axes", "active_mesh"]

# the layout's order: slower-varying outermost, tp innermost
ORDER = ("dp", "pp", "ep", "sp", "tp")

_current_mesh = None
_active = threading.local()


class MeshConfig:
    def __init__(self, dp=1, tp=1, pp=1, sp=1, ep=1):
        self.dp, self.tp, self.pp, self.sp, self.ep = dp, tp, pp, sp, ep

    @property
    def shape(self):
        return {"dp": self.dp, "tp": self.tp, "pp": self.pp, "sp": self.sp,
                "ep": self.ep}

    def size(self):
        return self.dp * self.tp * self.pp * self.sp * self.ep


class Mesh:
    """Ranks on the named axes ``ORDER``. ``devices`` is the array of
    mesh positions: torch devices for a local mesh, process ranks for a
    world mesh. ``rank`` is this process's rank (None when local)."""

    axis_names = ORDER

    def __init__(self, sizes, devices, world=False):
        self.shape = dict(zip(ORDER, sizes))
        self.devices = np.empty(len(devices), dtype=object)
        self.devices[:] = list(devices)
        self.devices = self.devices.reshape(sizes)
        self.world = bool(world)
        self.rank = dist.get_rank() if self.world else None
        self._sp_line = self._make_sp_groups() if self.world else None

    @property
    def size(self):
        return int(self.devices.size)

    @property
    def empty(self):
        return self.size == 0

    def coords(self, rank=None):
        """{axis: coordinate} of a world rank (this process's by
        default)."""
        rank = self.rank if rank is None else rank
        pos = np.argwhere(self.devices == rank)[0]
        return dict(zip(ORDER, (int(c) for c in pos)))

    def _make_sp_groups(self):
        """Every sp line's process group (new_group is collective over the
        world: every process makes every group, in one order); returns
        this process's line."""
        lines = np.moveaxis(self.devices, ORDER.index("sp"), -1).reshape(
            -1, self.shape["sp"])
        mine = None
        for line in lines:
            ranks = [int(r) for r in line]
            group = dist.new_group(ranks) if len(ranks) > 1 else None
            if self.rank in ranks:
                mine = (ranks, group)
        return mine

    def sp_line(self):
        """(the world ranks of this process's sp ring, in sp order, their
        process group)."""
        return self._sp_line

    def __enter__(self):
        stack = getattr(_active, "stack", None)
        if stack is None:
            stack = _active.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _active.stack.pop()
        return False

    def __repr__(self):
        form = "world" if self.world else "local"
        return f"Mesh({form}, {self.shape})"


def active_mesh():
    """The mesh of the innermost ``with mesh:`` of this thread, or
    None."""
    stack = getattr(_active, "stack", None)
    return stack[-1] if stack else None


def make_mesh(dp=None, tp=1, pp=1, sp=1, ep=1, devices=None):
    """Build a Mesh; dp defaults to 'whatever is left'. With `devices`
    (one torch device per rank, repeats allowed) the mesh is local; without
    them it spans the ``torch.distributed`` world when one is initialized,
    and is otherwise local on the card with dp 1 by default."""
    rest = tp * pp * sp * ep
    world = devices is None and dist.is_available() and \
        dist.is_initialized()
    if world:
        devices = list(range(dist.get_world_size()))
    elif devices is None:
        devices = [resolve_device(None)] * ((dp or 1) * rest)
    else:
        devices = [resolve_device(d) for d in devices]
    n = len(devices)
    if dp is None:
        if n % rest:
            raise ValueError(f"{n} devices not divisible by "
                             f"tp*pp*sp*ep={rest}")
        dp = n // rest
    if dp * rest != n:
        raise ValueError(f"mesh {dp}x{tp}x{pp}x{sp}x{ep} != {n} devices")
    sizes = {"dp": dp, "tp": tp, "pp": pp, "sp": sp, "ep": ep}
    return Mesh(tuple(sizes[a] for a in ORDER), devices, world=world)


def set_mesh(mesh):
    global _current_mesh
    _current_mesh = mesh
    return mesh


def get_mesh():
    global _current_mesh
    if _current_mesh is None:
        _current_mesh = make_mesh()
    return _current_mesh


def mesh_axes(mesh=None):
    return tuple((mesh or get_mesh()).axis_names)
