"""Collective communication ops.

Parity: paddle/fluid/operators/collective/{c_allreduce,c_broadcast,
c_allgather,c_reducescatter,c_sync_*}_op.*, the NCCL ring collectives;
the counterpart of ``paddle_tpu/ops/collective_ops.py`` (all of it but
``moe``, which comes with expert parallelism).

Inside a mapped context (``parallel.collective.mapped(mesh)``, the port's
stand-in for ``shard_map``) an op is its collective over the axis its
``ring_id_axis`` / ``axis_name`` attribute names ("dp" by default): X is
the held positions' parts, a list in rank order on a local mesh (the op
returns one result a position) or this process's one part in a world.
Outside one it is the identity, as JAX's ``_maybe`` makes it when no
named axis is bound: a one-card NCCL ring. The JAX Executor binds no
named axis under ``CompiledProgram.with_mesh`` either (pjit lays the
values out; it does not map the step), so there every op is the
identity, and so it is under the port's walk (each dp rank's rows pass
through: ``dp=rows``). ``c_sync_calc_stream`` and ``c_sync_comm_stream``
are the identity everywhere: the port issues its collectives on the
compute stream.
"""

from . import register, rows
from ..parallel import collective


def _axis(ctx):
    return ctx.attr("ring_id_axis", ctx.attr("axis_name", "dp"))


def _maybe(fn, ctx, **kw):
    """`fn` over the mapped mesh's axis, or X itself outside a mapped
    context."""
    x = ctx.in_("X")
    mesh = collective.mapped_mesh()
    if mesh is None:
        return {"Out": x}
    return {"Out": fn(x, axis_name=_axis(ctx), mesh=mesh, **kw)}


@register("c_allreduce_sum", "c_allreduce", "allreduce", dp=rows)
def c_allreduce_sum(ctx):
    return _maybe(collective.allreduce, ctx, op="sum")


@register("c_allreduce_max", dp=rows)
def c_allreduce_max(ctx):
    return _maybe(collective.allreduce, ctx, op="max")


@register("c_allreduce_min", dp=rows)
def c_allreduce_min(ctx):
    return _maybe(collective.allreduce, ctx, op="min")


@register("c_allreduce_prod", dp=rows)
def c_allreduce_prod(ctx):
    """Gathered, then multiplied: exp of a sum of logs would NaN on
    negatives and give -inf on zeros."""
    return _maybe(collective.allreduce, ctx, op="prod")


@register("c_broadcast", "broadcast", dp=rows)
def c_broadcast(ctx):
    return _maybe(collective.broadcast, ctx, root=ctx.attr("root", 0))


@register("c_allgather", dp=rows)
def c_allgather(ctx):
    return _maybe(collective.allgather, ctx, axis=0, tiled=True)


@register("c_reducescatter", dp=rows)
def c_reducescatter(ctx):
    return _maybe(collective.reducescatter, ctx, scatter_axis=0)


@register("alltoall", dp=rows)
def alltoall(ctx):
    return _maybe(collective.alltoall, ctx, split_axis=0, concat_axis=0)


@register("c_sync_calc_stream", "c_sync_comm_stream", dp=rows)
def c_sync(ctx):
    return {"Out": ctx.in_("X")}
