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

``make_named_mesh`` builds a mesh over axes of the caller's naming, as
``jax.sharding.Mesh(devices, axis_names)`` does: tensor-parallel serving
takes a 1-D ``("tp",)`` mesh. A sharded body runs over the ranks this
process holds along an axis (``held``: every rank of a local mesh, the
process's own in a world), and ``reduce_fn(axis)`` finishes a
row-parallel product from their partials: the sum in rank order on a
local mesh, one ``all_reduce`` over the axis's sub-group in a world,
whatever backend ``init_process_group`` chose. ``reductions`` counts the
reductions made, the port's stand-in for the psums JAX compiles.

The data-parallel walk (``core/compiler.py``) finishes its global
reductions with ``all_sum`` (``reduce_fn``'s sum, differentiable),
gathers a sharded source with ``all_concat`` (rank-order concatenation;
in a world an ``all_gather`` whose backward is a reduce-scatter) and, in
a world, sums the gradients over dp with ``all_reduce_grads`` (one
all-reduce of the flattened gradients, or one a gradient). Each counts
in ``reductions``. In a world a replicated value's gradient is held as
every rank's partial (the walk seeds 1/dp of the loss's), so the
backward of both collectives all-reduces what it is handed.
"""

import threading

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["MeshConfig", "Mesh", "make_mesh", "make_named_mesh", "set_mesh",
           "get_mesh", "mesh_axes", "active_mesh"]

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
    """Ranks on named axes (``ORDER`` unless the mesh was built with
    ``make_named_mesh``). ``devices`` is the array of mesh positions:
    torch devices for a local mesh, process ranks for a world mesh.
    ``rank`` is this process's rank (None when local)."""

    def __init__(self, sizes, devices, world=False, axis_names=ORDER):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, sizes))
        self.devices = np.empty(len(devices), dtype=object)
        self.devices[:] = list(devices)
        self.devices = self.devices.reshape(sizes)
        self.world = bool(world)
        self.rank = dist.get_rank() if self.world else None
        self.reductions = 0
        # every axis line's process group (new_group is collective over
        # the world: every process makes every group, in one order)
        self._lines = ({a: self._make_line(a) for a in self.axis_names}
                       if self.world else {})

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
        return dict(zip(self.axis_names, (int(c) for c in pos)))

    def _make_line(self, axis):
        """Every line along `axis` gets its process group; returns this
        process's line (its world ranks in axis order, their group)."""
        lines = np.moveaxis(self.devices, self.axis_names.index(axis),
                            -1).reshape(-1, self.shape[axis])
        mine = None
        for line in lines:
            ranks = [int(r) for r in line]
            group = dist.new_group(ranks) if len(ranks) > 1 else None
            if self.rank in ranks:
                mine = (ranks, group)
        return mine

    def line(self, axis):
        """(the world ranks of this process's line along `axis`, in axis
        order, their process group)."""
        return self._lines[axis]

    def held(self, axis):
        """The coordinates along `axis` whose part this process computes:
        all of them on a local mesh, its own in a world."""
        if self.world:
            return [self.coords()[axis]]
        return list(range(self.shape[axis]))

    def reduce_fn(self, axis):
        """The finishing reduction of a row-parallel product over `axis`:
        fn(partials) is ``all_sum(partials, axis)``."""
        return lambda parts: self.all_sum(parts, axis)

    def _group(self, axis):
        return self.line(axis)[1] if self.world else None

    def all_sum(self, parts, axis):
        """The sum over `axis` of the held ranks' partials (``held``
        order): a local mesh adds them in rank order; a world
        all-reduces its one partial over the axis's sub-group, whatever
        backend ``init_process_group`` chose, and differentiably: the
        backward all-reduces the gradient partials it is handed, so each
        rank's partial takes the whole gradient. Counts one in
        ``reductions``."""
        self.reductions += 1
        if not self.world:
            out = parts[0]
            for part in parts[1:]:
                out = out + part
            return out
        (part,) = parts
        group = self._group(axis)
        return part if group is None else _AllReduce.apply(group, part)

    def all_concat(self, parts, axis):
        """The held ranks' rows concatenated along dim 0 in rank order
        over `axis`, differentiable: a local mesh concatenates them; a
        world all-gathers its one part, and the backward sums every
        rank's gradient of the whole and keeps this rank's rows (a
        reduce-scatter). Counts one in ``reductions``."""
        self.reductions += 1
        if not self.world:
            return torch.cat(parts) if len(parts) > 1 else parts[0]
        (part,) = parts
        group = self._group(axis)
        if group is None:
            return part
        ranks = self.line(axis)[0]
        return _AllGather.apply(group, len(ranks), ranks.index(self.rank),
                                part)

    def gather_rows(self, part, axis):
        """A world rank's rows -> the whole, concatenated in rank order
        over `axis`, outside autograd (a fetch). Not counted."""
        group = self._group(axis)
        if group is None:
            return part
        return _all_gather(group, len(self.line(axis)[0]), part)

    def all_reduce_grads(self, grads, axis, fuse=True):
        """A world's gradients summed over `axis`, in place: with `fuse`
        one all-reduce of the flattened gradients (one a dtype), else one
        a gradient. Counts one in ``reductions`` for each all-reduce."""
        group = self._group(axis)
        if group is None or not grads:
            return grads
        buckets = [[g] for g in grads]
        if fuse:
            by_dtype = {}
            for g in grads:
                by_dtype.setdefault(g.dtype, []).append(g)
            buckets = list(by_dtype.values())
        for bucket in buckets:
            flat = torch.cat([g.reshape(-1) for g in bucket])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
            self.reductions += 1
            offset = 0
            for g in bucket:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()
        return grads

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


class _AllReduce(torch.autograd.Function):
    """The sum of every rank's tensor; backward: the sum of every rank's
    gradient partial (the whole gradient of the sum, which each rank's
    summand takes)."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return None, g


def _all_gather(group, n, x):
    """The n ranks' `x` concatenated along dim 0 in rank order."""
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


class _AllGather(torch.autograd.Function):
    """Every rank's rows concatenated in rank order; backward: every
    rank's gradient of the whole summed, this rank's rows kept (a
    reduce-scatter, as an all-reduce: gloo has no reduce-scatter)."""

    @staticmethod
    def forward(ctx, group, n, index, x):
        ctx.group, ctx.index, ctx.rows = group, index, x.shape[0]
        return _all_gather(group, n, x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        lo = ctx.index * ctx.rows
        return None, None, None, g[lo:lo + ctx.rows]


def active_mesh():
    """The mesh of the innermost ``with mesh:`` of this thread, or
    None."""
    stack = getattr(_active, "stack", None)
    return stack[-1] if stack else None


def _mesh_devices(devices, n_default):
    """(the mesh positions, world?): the world's ranks when `devices` is
    None and a ``torch.distributed`` world is initialized, the card
    `n_default` times when it is None otherwise, else the given torch
    devices (repeats allowed)."""
    world = devices is None and dist.is_available() and \
        dist.is_initialized()
    if world:
        return list(range(dist.get_world_size())), True
    if devices is None:
        return [resolve_device(None)] * n_default, False
    return [resolve_device(d) for d in devices], False


def make_named_mesh(axis_names, sizes, devices=None):
    """A mesh over the axes `axis_names` with `sizes` ranks each, laid
    out as ``jax.sharding.Mesh(np.array(devices).reshape(sizes),
    axis_names)``: ``make_named_mesh(("tp",), (2,), ["cuda:0"] * 2)`` is
    a local tp 2 mesh on one card; without `devices` it spans the
    ``torch.distributed`` world when one is initialized, and is local on
    the card otherwise."""
    sizes = tuple(int(n) for n in sizes)
    if len(sizes) != len(axis_names):
        raise ValueError(f"{len(axis_names)} axis names, {len(sizes)} "
                         f"sizes")
    devices, world = _mesh_devices(devices, int(np.prod(sizes)))
    if len(devices) != int(np.prod(sizes)):
        raise ValueError(f"mesh {'x'.join(map(str, sizes))} != "
                         f"{len(devices)} devices")
    return Mesh(sizes, devices, world=world, axis_names=axis_names)


def make_mesh(dp=None, tp=1, pp=1, sp=1, ep=1, devices=None):
    """Build a Mesh; dp defaults to 'whatever is left'. With `devices`
    (one torch device per rank, repeats allowed) the mesh is local; without
    them it spans the ``torch.distributed`` world when one is initialized,
    and is otherwise local on the card with dp 1 by default."""
    rest = tp * pp * sp * ep
    devices, world = _mesh_devices(devices, (dp or 1) * rest)
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
