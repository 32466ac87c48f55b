"""Collective communication ops.

Parity: paddle/fluid/operators/collective/{c_allreduce,c_broadcast,
c_allgather,c_reducescatter,c_sync_*}_op.*, the NCCL ring collectives;
the counterpart of ``paddle_tpu/ops/collective_ops.py``, the ``moe`` op
(expert parallelism) included.

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

from . import refuses, register, rows, shard_rule
from ..parallel import collective
from ..parallel.sharded import ShardedTensor


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


# the moe op's capacity counts its tokens: dp's rows would each count
# their own, where JAX's dp step counts the global batch's
_MOE_DP = ("its capacity counts the global batch's tokens, a dp rank's "
           "rows count their own (ROADMAP queue A: MoE under dp)")


@register("moe", dp=refuses(_MOE_DP))
def moe(ctx):
    """Framework-level Mixture-of-Experts FFN (``parallel/moe.py``
    ``moe_apply``): expert-parallel over the walk's mesh (or the active
    one) where its ep axis divides the tokens and the experts, dense
    otherwise."""
    from ..parallel.moe import moe_apply
    mesh = ctx.walk.mesh if ctx.walk is not None else None
    out, aux = moe_apply(
        ctx.in_("X"), ctx.in_("GateW"), ctx.in_("WUp"), ctx.in_("WDown"),
        capacity_factor=ctx.attr("capacity_factor", 1.25), mesh=mesh)
    return {"Out": out, "AuxLoss": aux.reshape(1)}


@shard_rule("moe")
def _moe_ep(impl, ctx, walk):
    """The expert weights laid out over "ep" alone (E / ep experts a
    position): the op on their parts, its tokens split over ep. None
    (the op on the gathered weights, dense) where ep does not divide the
    tokens, or another input is laid out."""
    from ..parallel.moe import _active_ep_mesh
    env, op = ctx.env, ctx.op
    up, down = env[op.input("WUp")[0]], env[op.input("WDown")[0]]
    if not all(isinstance(w, ShardedTensor) and w.axes == ["ep"]
               and w.spec[0] == "ep" for w in (up, down)):
        return None
    if any(isinstance(env[op.input(s)[0]], ShardedTensor)
           for s in ("X", "GateW")):
        return None
    x = env[op.input("X")[0]]
    if _active_ep_mesh(x.numel() // x.shape[-1], up.shape[0],
                       walk.mesh) is None:
        return None
    return impl(ctx)
