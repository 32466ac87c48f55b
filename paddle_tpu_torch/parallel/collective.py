"""Collective communication over a named mesh axis.

Parity: python/paddle/fluid/layers/collective.py (_allreduce, _broadcast,
_c_allgather, _c_reducescatter) and the NCCL wrappers in
paddle/fluid/operators/collective/; the counterpart of
``paddle_tpu/parallel/collective.py``.

JAX runs these as ``lax`` collectives inside ``shard_map``, where each
device's body holds its shard. The port's counterpart takes the held
positions' parts along the axis, as ``Mesh.all_sum`` does: on a local
mesh (every position in this process) a list of the parts in rank order,
and it returns one result a position, in that order; over a
``torch.distributed`` world this process's one part (a tensor), and it
returns its result, the collective running over the process's line of
the axis (``Mesh.line``), whatever backend ``init_process_group`` chose
(``Mesh.reduce_scatter`` and ``Mesh.all_to_all`` compose the two gloo
lacks from all-reduce and all-gather, on every backend).

``mapped(mesh)`` is the port's stand-in for being inside ``shard_map``:
the collective ops of a Program (``ops/collective_ops.py``) are the
collective there and the identity outside one, as JAX's unbound axis
makes them. Every function takes the mesh as ``mesh=``, else the mapped
one, else the active mesh (``with mesh:``), else ``get_mesh()``.

``prod`` gathers and multiplies; it never takes exp of a sum of logs,
which breaks on zeros and negative values. Each collective counts one in
the mesh's ``reductions``, a world's composed forms included.
"""

import contextlib
import threading

import torch
import torch.distributed as dist

from .mesh import active_mesh, batch_p2p, get_mesh

__all__ = ["allreduce", "broadcast", "allgather", "reducescatter",
           "alltoall", "send_recv", "ring_shift", "barrier", "mapped",
           "mapped_mesh"]

_mapped = threading.local()


@contextlib.contextmanager
def mapped(mesh):
    """Run the body as inside ``shard_map`` over `mesh`: the collective
    ops take their X as the held positions' parts and reduce over it."""
    stack = getattr(_mapped, "stack", None)
    if stack is None:
        stack = _mapped.stack = []
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def mapped_mesh():
    """The mesh of the innermost ``mapped`` of this thread, or None."""
    stack = getattr(_mapped, "stack", None)
    return stack[-1] if stack else None


def _mesh(mesh):
    return mesh or mapped_mesh() or active_mesh() or get_mesh()


def _parts(x, mesh, axis):
    """(the parts as a list, whether `x` was one world tensor)."""
    if mesh.world:
        if not torch.is_tensor(x):
            raise ValueError("over a world mesh a collective takes this "
                             "process's one part, a tensor")
        return [x], True
    parts = list(x)
    if len(parts) != mesh.shape[axis]:
        raise ValueError(f"a local mesh's {axis} holds {mesh.shape[axis]} "
                         f"positions; got {len(parts)} parts")
    return parts, False


def _world_gather(mesh, axis, x):
    """Every rank of this process's `axis` line's `x`, in line order."""
    ranks, group = mesh.line(axis)
    if group is None:
        return [x]
    every = [torch.empty_like(x) for _ in ranks]
    dist.all_gather(every, x.contiguous(), group=group)
    return every


def allreduce(x, op="sum", axis_name="dp", mesh=None):
    """Every position gets the reduction of the parts over the axis: sum,
    mean, max, min or prod (gathered, then multiplied)."""
    if op not in ("sum", "mean", "max", "min", "prod"):
        raise ValueError(f"unknown allreduce op {op}")
    mesh = _mesh(mesh)
    parts, single = _parts(x, mesh, axis_name)
    n = mesh.shape[axis_name]
    mesh.reductions += 1
    if single:
        (part,) = parts
        if op == "prod":
            out = torch.stack(_world_gather(mesh, axis_name, part)).prod(0)
            return out
        group = mesh.line(axis_name)[1]
        out = part.clone(memory_format=torch.contiguous_format)
        if group is not None:
            red = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
                   "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[op]
            dist.all_reduce(out, op=red, group=group)
        return out / n if op == "mean" else out
    stacked = torch.stack(parts)
    out = {"sum": lambda t: t.sum(0), "mean": lambda t: t.sum(0) / n,
           "max": lambda t: t.amax(0), "min": lambda t: t.amin(0),
           "prod": lambda t: t.prod(0)}[op](stacked)
    return [out.clone() for _ in parts]


def broadcast(x, root=0, axis_name="dp", mesh=None):
    """Every position gets the root position's part."""
    mesh = _mesh(mesh)
    parts, single = _parts(x, mesh, axis_name)
    mesh.reductions += 1
    if single:
        ranks, group = mesh.line(axis_name)
        out = parts[0].clone(memory_format=torch.contiguous_format)
        if group is not None:
            dist.broadcast(out, src=ranks[root], group=group)
        return out
    return [parts[root].clone() for _ in parts]


def allgather(x, axis_name="dp", axis=0, tiled=True, mesh=None):
    """Every position gets the parts concatenated along `axis` in rank
    order (stacked on a new `axis` without `tiled`)."""
    mesh = _mesh(mesh)
    parts, single = _parts(x, mesh, axis_name)
    mesh.reductions += 1
    every = _world_gather(mesh, axis_name, parts[0]) if single else parts
    out = torch.cat(every, axis) if tiled else torch.stack(every, axis)
    return out if single else [out.clone() for _ in parts]


def reducescatter(x, axis_name="dp", scatter_axis=0, mesh=None):
    """The parts summed, then cut along `scatter_axis` into one block a
    position; position j keeps block j."""
    mesh = _mesh(mesh)
    parts, single = _parts(x, mesh, axis_name)
    if single:
        return mesh.reduce_scatter(parts[0], axis_name, scatter_axis)
    mesh.reductions += 1
    total = torch.stack(parts).sum(0)
    return [b.contiguous() for b in total.chunk(len(parts), scatter_axis)]


def alltoall(x, axis_name="ep", split_axis=0, concat_axis=0, mesh=None):
    """Each part cut along `split_axis` into one block a position;
    position j gets every position's j-th block, concatenated in rank
    order along `concat_axis`."""
    mesh = _mesh(mesh)
    parts, single = _parts(x, mesh, axis_name)
    if single:
        return mesh.all_to_all(parts[0], axis_name, split_axis, concat_axis)
    mesh.reductions += 1
    n = len(parts)
    blocks = [p.chunk(n, split_axis) for p in parts]
    return [torch.cat([blocks[i][j] for i in range(n)], concat_axis)
            for j in range(n)]


def send_recv(x, perm, axis_name="sp", mesh=None):
    """JAX's ppermute: for each (src, dst) pair of `perm`, position dst
    gets position src's part; a position no pair sends to gets zeros."""
    mesh = _mesh(mesh)
    parts, single = _parts(x, mesh, axis_name)
    mesh.reductions += 1
    if not single:
        out = [torch.zeros_like(p) for p in parts]
        for src, dst in perm:
            out[dst] = parts[src].clone()
        return out
    ranks, group = mesh.line(axis_name)
    me = ranks.index(mesh.rank)
    part = parts[0].contiguous()
    out = torch.zeros_like(part)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out = part.clone()
        elif src == me:
            ops.append((dist.isend, part, ranks[dst], 0))
        elif dst == me:
            ops.append((dist.irecv, out, ranks[src], 0))
    if ops:
        batch_p2p(ops, group)
    return out


def ring_shift(x, axis_name="sp", shift=1, mesh=None):
    """Each position's part moves `shift` positions along the ring."""
    mesh = _mesh(mesh)
    n = mesh.shape[axis_name]
    return send_recv(x, [(i, (i + shift) % n) for i in range(n)],
                     axis_name, mesh)


def barrier(axis_name="dp", mesh=None):
    """Every rank of this process's line waits for the others (a world's
    ``dist.barrier`` over the line; a local mesh has nothing to wait
    for). Returns a zero scalar, as JAX's tiny psum."""
    mesh = _mesh(mesh)
    if mesh.world:
        group = mesh.line(axis_name)[1]
        if group is not None:
            dist.barrier(group=group)
            mesh.reductions += 1
    return torch.zeros((), dtype=torch.float32)
