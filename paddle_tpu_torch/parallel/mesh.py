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
(``active_mesh``). ``make_hybrid_mesh`` lays the slow axes across hosts
and the fast ones inside each host's devices (hosts from a world rank's
process, the world's ranks divided into hosts of ``devices_per_host``, or
emulated by chunking with ``hosts=N`` on a local mesh), ``host_domains``
maps each position to its host, ``multihost_initialize`` wraps
``torch.distributed.init_process_group`` for Fluid's endpoint lists, and
``named_sharding`` / ``replicated`` give the port's layout of a value,
a (spec, mesh) pair (``sharded.py``'s ``ShardedTensor`` holds one).

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
gathers a sharded source, or a sharded persistable's global value, with
``all_concat`` (rank-order concatenation along any dimension; in a world
an ``all_gather`` whose backward is a reduce-scatter) and, in a world,
sums the gradients over dp with ``all_reduce_grads`` (one all-reduce of
the flattened gradients, or one a gradient, over one axis or, one line
after another, over several). Each counts in ``reductions``. In a world
a value's gradient is held as every rank's partial along each axis the
value is replicated over (the walk seeds 1/(dp sp tp) of the loss's), so
the backward of both collectives all-reduces what it is handed.

A walk over several axes holds every position (dp, sp, tp) of a local
mesh in turn, and a world rank its own: ``coords`` gives a rank's
coordinate on every axis and ``line(axis)`` its line's process group.
``line_mesh(axis)`` is the one-axis mesh of this process's line (a
world's line keeps its group), which the sequence ring takes inside a
walk that has already split the batch and the heads.
``reduce_scatter`` and ``all_to_all`` are composed from all-reduce and
all-gather where the line's backend is gloo (which lacks both for CUDA
tensors), on the same tensors and device, and are the backend's own
collectives otherwise: the choice follows the backend, never a failure.
"""

import threading

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["MeshConfig", "Mesh", "make_mesh", "make_named_mesh", "set_mesh",
           "get_mesh", "mesh_axes", "active_mesh", "make_hybrid_mesh",
           "host_domains", "multihost_initialize", "named_sharding",
           "replicated"]

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

    def __init__(self, sizes, devices, world=False, axis_names=ORDER,
                 lines=None):
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
        if lines is not None:
            self._lines = dict(lines)
        else:
            self._lines = ({a: self._make_line(a) for a in self.axis_names}
                           if self.world else {})
        # the group the whole mesh spans (None: the default world group)
        self.group = None
        self._line_meshes = {}

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

    def line_mesh(self, axis):
        """The one-axis mesh of this process's line along `axis`: in a
        world over the line's ranks and with its process group (no new
        group is made), on a local mesh over the line's devices."""
        if axis not in self._line_meshes:
            n = self.shape[axis]
            if self.world:
                ranks, group = self.line(axis)
                sub = Mesh((n,), ranks, world=True, axis_names=(axis,),
                           lines={axis: (ranks, group)})
                sub.group = group
            else:
                index = [0] * len(self.axis_names)
                index[self.axis_names.index(axis)] = slice(None)
                sub = Mesh((n,), list(self.devices[tuple(index)]),
                           axis_names=(axis,))
            self._line_meshes[axis] = sub
        return self._line_meshes[axis]

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

    def all_concat(self, parts, axis, dim=0):
        """The held ranks' parts concatenated along `dim` in rank order
        over `axis`, differentiable: a local mesh concatenates them; a
        world all-gathers its one part, and the backward sums every
        rank's gradient of the whole and keeps this rank's block (a
        reduce-scatter). Counts one in ``reductions``."""
        self.reductions += 1
        return self._concat(parts, axis, dim)

    def _concat(self, parts, axis, dim):
        """``all_concat`` uncounted: for a caller that counts one around
        several (``ShardedTensor.gather``, one a value)."""
        if not self.world:
            return torch.cat(parts, dim) if len(parts) > 1 else parts[0]
        (part,) = parts
        group = self._group(axis)
        if group is None:
            return part
        ranks = self.line(axis)[0]
        return _AllGather.apply(group, len(ranks), ranks.index(self.rank),
                                part, dim)

    def gather_rows(self, part, axis):
        """A world rank's rows -> the whole, concatenated in rank order
        over `axis`, outside autograd (a fetch). Not counted."""
        group = self._group(axis)
        if group is None:
            return part
        return _all_gather(group, len(self.line(axis)[0]), part)

    def all_min(self, x, axis):
        """The elementwise minimum of the ranks' `x` over `axis` (a name,
        or several, one line after another), outside autograd: a world
        all-reduces it (MIN) over the axis's sub-group, as int32 (not
        every backend reduces bool); a local mesh, whose process holds
        every rank's value, returns `x`. Counts one in ``reductions`` for
        each all-reduce in a world."""
        out = None
        for a in ((axis,) if isinstance(axis, str) else axis):
            group = self._group(a)
            if group is None:
                continue
            out = x.to(torch.int32) if out is None else out
            dist.all_reduce(out, op=dist.ReduceOp.MIN, group=group)
            self.reductions += 1
        return x if out is None else out.to(x.dtype)

    def reduce_scatter(self, part, axis, dim=0):
        """A world rank's `part` summed over the `axis` line and cut along
        `dim` into the line's blocks, this rank's kept (outside autograd):
        an all-reduce, then the block, which every backend runs (gloo has
        no reduce-scatter). Counts one in ``reductions``."""
        ranks, group = self.line(axis)
        n, i = len(ranks), ranks.index(self.rank)
        rows = part.shape[dim] // n
        self.reductions += 1
        total = part.clone(memory_format=torch.contiguous_format)
        if group is not None:
            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return total.narrow(dim, i * rows, rows).contiguous()

    def all_to_all(self, part, axis, split_dim=0, concat_dim=0):
        """A world rank's `part` cut along `split_dim` into one block a
        rank of the `axis` line; rank j receives every rank's j-th block,
        concatenated in rank order along `concat_dim` (outside autograd):
        an all-gather, then this rank's blocks, which every backend runs
        (gloo has no all-to-all of CUDA tensors). Counts one in
        ``reductions``."""
        ranks, group = self.line(axis)
        n, i = len(ranks), ranks.index(self.rank)
        self.reductions += 1
        every = [part.contiguous()]
        if group is not None:
            every = [torch.empty_like(every[0]) for _ in range(n)]
            dist.all_gather(every, part.contiguous(), group=group)
        return torch.cat([p.chunk(n, split_dim)[i] for p in every],
                         concat_dim)

    def all_reduce_grads(self, grads, axis, fuse=True):
        """A world's gradients summed over `axis` (a name, or several:
        one line after another), in place: with `fuse` one all-reduce of
        the flattened gradients (one a dtype) a line, else one a
        gradient. Counts one in ``reductions`` for each all-reduce."""
        if not isinstance(axis, str):
            for a in axis:
                self.all_reduce_grads(grads, a, fuse)
            return grads
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


def batch_p2p(ops, group):
    """Run point-to-point sends and receives together: `ops` is a list of
    (``dist.isend`` or ``dist.irecv``, tensor, peer world rank, tag). A
    gloo group moves CUDA tensors through host copies (gloo sends host
    memory), a received one copied back into its tensor; any other
    backend sends the tensors as they are."""
    staged = dist.get_backend(group) == "gloo" and any(
        t.is_cuda for _, t, _, _ in ops)
    bufs = [t.cpu() if staged else t for _, t, _, _ in ops]
    works = dist.batch_isend_irecv([
        dist.P2POp(fn, buf, peer, group, tag)
        for (fn, _, peer, tag), buf in zip(ops, bufs)])
    for work in works:
        work.wait()
    if staged:
        for (fn, t, _, _), buf in zip(ops, bufs):
            if fn is dist.irecv:
                t.copy_(buf)


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


def _all_gather(group, n, x, dim=0):
    """The n ranks' `x` concatenated along `dim` in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


class _AllGather(torch.autograd.Function):
    """Every rank's block concatenated along `dim` in rank order;
    backward: every rank's gradient of the whole summed, this rank's
    block kept (a reduce-scatter, as an all-reduce: gloo has no
    reduce-scatter)."""

    @staticmethod
    def forward(ctx, group, n, index, x, dim=0):
        ctx.group, ctx.index, ctx.dim = group, index, dim
        ctx.rows = x.shape[dim]
        return _all_gather(group, n, x, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        lo = ctx.index * ctx.rows
        return None, None, None, g.narrow(ctx.dim, lo, ctx.rows), None


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


def make_hybrid_mesh(dp_dcn=None, *, dp=1, tp=1, pp=1, sp=1, ep=1,
                     pp_dcn=1, devices=None, hosts=None,
                     devices_per_host=None):
    """A DCN-aware mesh, as the JAX package's: dp_dcn x pp_dcn span hosts,
    dp/pp/ep/sp/tp span each host's own devices, so the model axes (sp,
    tp) stay inside one host. The same five-axis Mesh as ``make_mesh``:
    dp is dp_dcn * dp with host-major order, pp is pp_dcn * pp.

    Hosts: in a ``torch.distributed`` world (no `devices`) a rank's host is
    its rank // `devices_per_host` (default: the whole world one host); on
    a local mesh (`devices`, or the card when there is no world) one host
    unless `hosts=N` emulates N host domains by chunking the positions,
    so host-locality layouts are testable in one process."""
    world = devices is None and dist.is_available() and dist.is_initialized()
    if world:
        ranks = list(range(dist.get_world_size()))
        per = devices_per_host or len(ranks)
        groups = [ranks[i:i + per] for i in range(0, len(ranks), per)]
    else:
        n = None if devices is not None else \
            (dp_dcn or hosts or 1) * pp_dcn * dp * pp * ep * sp * tp
        flat, _ = _mesh_devices(devices, n)
        if hosts and hosts > 1:
            if len(flat) % hosts:
                raise ValueError(f"{len(flat)} devices not divisible into "
                                 f"{hosts} emulated hosts")
            per = len(flat) // hosts
            groups = [flat[i * per:(i + 1) * per] for i in range(hosts)]
        else:
            groups = [flat]
    n_hosts, per_host = len(groups), len(groups[0])
    if any(len(g) != per_host for g in groups):
        raise ValueError("hosts hold unequal device counts")
    if dp_dcn is None:
        if n_hosts % pp_dcn:
            raise ValueError(f"{n_hosts} hosts not divisible by "
                             f"pp_dcn={pp_dcn}")
        dp_dcn = n_hosts // pp_dcn
    if dp_dcn * pp_dcn != n_hosts:
        raise ValueError(f"dp_dcn*pp_dcn={dp_dcn * pp_dcn} != {n_hosts} "
                         f"hosts")
    if dp * pp * ep * sp * tp != per_host:
        raise ValueError(f"ici mesh {dp}x{pp}x{ep}x{sp}x{tp} != "
                         f"{per_host} devices/host")
    index = np.arange(n_hosts * per_host).reshape(
        dp_dcn, pp_dcn, dp, pp, ep, sp, tp).transpose(
        0, 2, 1, 3, 4, 5, 6).reshape(dp_dcn * dp, pp_dcn * pp, ep, sp, tp)
    flat = [d for g in groups for d in g]
    mesh = Mesh(index.shape, [flat[i] for i in index.flat], world=world)
    mesh.host_index = index
    return mesh


def host_domains(mesh, per_host):
    """Each mesh position's host index, assuming `per_host` positions a
    host domain (emulated or real): a world rank's rank // per_host, a
    local position's index among the devices it was built from //
    per_host (``make_hybrid_mesh`` keeps that index in ``host_index``)."""
    if mesh.world:
        return np.vectorize(lambda r: int(r) // per_host)(mesh.devices)
    index = getattr(mesh, "host_index", None)
    if index is None:
        index = np.arange(mesh.size).reshape(mesh.devices.shape)
    return index // per_host


def multihost_initialize(coordinator_address=None, num_processes=None,
                         process_id=None, endpoints=None,
                         current_endpoint=None, backend=None):
    """Parity: transpiler endpoints / fleet.init on several hosts. Wraps
    ``torch.distributed.init_process_group(init_method=f"tcp://{addr}")``;
    returns False for one process (nothing to join) and True once the
    world is up (re-entrant: a second call does not join again).

    Takes the JAX package's forms: (coordinator_address, num_processes,
    process_id), or Fluid's endpoint list and current_endpoint, whose
    first endpoint is the coordinator and whose index is the rank.
    `backend` defaults to NCCL with CUDA, gloo without."""
    if endpoints:
        if current_endpoint is None:
            raise ValueError("current_endpoint required with endpoints")
        coordinator_address = coordinator_address or endpoints[0]
        num_processes = len(endpoints)
        process_id = endpoints.index(current_endpoint)
    if num_processes in (None, 1):
        return False
    if dist.is_initialized():
        return True
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    return True


def named_sharding(spec, mesh=None):
    """The layout of a value laid out by `spec` over `mesh` (the current
    mesh by default): the (spec, mesh) pair a ``ShardedTensor`` holds,
    the counterpart of ``NamedSharding(mesh, spec)``."""
    from .tensor_parallel import PartitionSpec
    return PartitionSpec(*spec), mesh or get_mesh()


def replicated(mesh=None):
    """The replicated layout over `mesh`: ``named_sharding(P(), mesh)``."""
    return named_sharding((), mesh)
