"""Pipeline parallelism (GPipe and 1F1B microbatching).

Parity: fluid.optimizer.PipelineOptimizer (python/paddle/fluid/
optimizer.py) and its section workers; the counterpart of
``paddle_tpu/parallel/pipeline.py``. The JAX package runs a stage's
schedule as one ``lax.scan`` inside ``shard_map`` over the mesh's "pp"
axis, the activations moving down a ``ppermute`` ring. The port runs the
same tick table eagerly over the mesh's two forms (``mesh.py``):

- a *local* mesh holds every stage in this process: each tick runs the
  stages' events in stage order, and a stage's output is the next
  stage's input at the next tick;
- over a ``torch.distributed`` world one rank is one stage: a stage's
  output goes down the pp line (``Mesh.line("pp")``) through
  ``mesh.batch_p2p``, inside an autograd function whose backward sends
  the cotangent back up, as ``ring_attention._Rotate`` does for the
  ring.

Bubble slots, where JAX computes a stage on a clamped microbatch and
discards the result, are skipped: no kept loss or gradient depends on
them, and a world sends only what the next tick consumes.

Functional forms, over stacked stage parameters (every leaf's dim 0 is
the stage): ``pipeline_step`` / ``pipeline_apply`` (GPipe forward),
``pipeline_1f1b`` (one forward or one backward per stage per tick over
2M + 2S - 2 ticks, an S-slot residual buffer, the stage rematerialized
in its backward), ``bubble_fraction`` and ``schedule_stats`` (the
schedule's ticks, its per-stage carry bytes and its bubble, from the
port's own tick table and carry, as JAX reads them off the traced scan).

The framework path: ``PipelineOptimizer.minimize`` attaches a
``PipelineConfig`` to the Program; under ``CompiledProgram.with_mesh``
over a mesh with pp > 1 the Executor runs the forward through
``build_pipelined_forward`` (the Program cut into a chain of stages at
the cut tensors, GPipe over microbatches) and differentiates it. Every
parameter, feed and the rng reach every stage replicated, as JAX's
``in_specs=(P(), P(), P())``: a tp-laid parameter is read whole (its
gathered value), so under pp x tp the tp axis only places the state. A
parameter several stages read (GPT's tied word embedding) gets the sum
of every stage's part; in a world every gradient is all-reduced over pp.
"""

import warnings

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from .mesh import active_mesh, batch_p2p, get_mesh

__all__ = ["pipeline_step", "pipeline_apply", "bubble_fraction",
           "schedule_stats", "pipeline_1f1b", "PipelineConfig",
           "partition_forward_ops", "build_pipelined_forward",
           "PipelineOptimizer"]

# the kinds of a tick table's events
FWD, BWD = "F", "B"


def _mesh(mesh):
    return mesh or active_mesh() or get_mesh()


def _stage_of(tree, s):
    return pytree.tree_map(lambda a: a[s], tree)


class _Line:
    """A world rank's neighbours on its pp line: sends and receives of one
    tensor, with host staging under gloo (``batch_p2p``)."""

    def __init__(self, mesh, axis_name):
        self.ranks, self.group = mesh.line(axis_name)
        self.index = self.ranks.index(mesh.rank)
        self.size = len(self.ranks)

    def peer(self, shift):
        return self.ranks[(self.index + shift) % self.size]

    def exchange(self, sends=(), recvs=()):
        """Post `sends` [(tensor, shift, tag)] and `recvs` [(buffer,
        shift, tag)] together; the buffers hold what arrived."""
        ops = [(dist.isend, t.contiguous(), self.peer(sh), tag)
               for t, sh, tag in sends]
        ops += [(dist.irecv, b, self.peer(sh), tag) for b, sh, tag in recvs]
        if ops:
            batch_p2p(ops, self.group)


class _Recv(torch.autograd.Function):
    """A cut tensor received from the previous stage; backward: its
    cotangent sent back. `tie` (one of the stage's parameter leaves, or
    None outside autograd) puts the node on the path the backward walks
    to the parameters; it gets a zero gradient."""

    @staticmethod
    def forward(ctx, line, buf, tie):
        ctx.line = line
        if tie is not None:
            ctx.tie = (tie.shape, tie.dtype, tie.device)
        line.exchange(recvs=[(buf, -1, 0)])
        return buf

    @staticmethod
    def backward(ctx, g):
        ctx.line.exchange(sends=[(g, -1, 1)])
        shape, dtype, device = ctx.tie
        return None, None, torch.zeros(shape, dtype=dtype, device=device)


class _Send(torch.autograd.Function):
    """A stage's output sent to the next stage; returns a zero scalar the
    stage's objective adds, so that the backward receives the next
    stage's cotangent of it."""

    @staticmethod
    def forward(ctx, line, y):
        ctx.line = line
        ctx.meta = (y.shape, y.dtype, y.device)
        line.exchange(sends=[(y, 1, 0)])
        return y.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        shape, dtype, device = ctx.meta
        g = torch.empty(shape, dtype=dtype, device=device)
        ctx.line.exchange(recvs=[(g, 1, 1)])
        return None, g


def _first_leaf_requiring_grad(tree):
    for leaf in pytree.tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.requires_grad:
            return leaf
    return None


# ---------------------------------------------------------------------------
# GPipe forward
# ---------------------------------------------------------------------------

def pipeline_step(stage_fn, params, x_microbatches, axis_name="pp",
                  mesh=None):
    """GPipe over the mesh's `axis_name`: stage s runs microbatch t - s at
    tick t, its output the next stage's input. `params` is the held
    stages' parameters: a list of S stage trees on a local mesh, this
    rank's stage tree in a world. x_microbatches: (M, ...), which only
    stage 0 reads. Returns the last stage's (M, ...) outputs on every
    rank (a world broadcasts them from the last stage)."""
    mesh = _mesh(mesh)
    s_count = mesh.shape[axis_name]
    m = x_microbatches.shape[0]
    if not mesh.world:
        carry = [None] * s_count
        outs = [None] * m
        for t in range(m + s_count - 1):
            nxt = [None] * s_count
            for s in range(s_count):
                k = t - s
                if not 0 <= k < m:
                    continue          # a bubble slot
                x = x_microbatches[k] if s == 0 else carry[s]
                y = stage_fn(params[s], x)
                if s == s_count - 1:
                    outs[k] = y
                else:
                    nxt[s + 1] = y
            carry = nxt
        return torch.stack(outs)
    line = _Line(mesh, axis_name)
    s = line.index
    tie = _first_leaf_requiring_grad(params)
    outs = []
    for k in range(m):
        x = x_microbatches[k] if s == 0 else _Recv.apply(
            line, torch.empty_like(x_microbatches[k]), tie)
        y = stage_fn(params, x)
        outs.append(_Send.apply(line, y) if s < s_count - 1 else y)
    if s == s_count - 1:
        out = torch.stack(outs)
    else:
        # the sends' zeros, so that their backward runs
        out = torch.zeros_like(x_microbatches) + sum(outs)
    return mesh.all_sum([out], axis_name)


def pipeline_apply(stage_fn, params_stacked, x, mesh, microbatches,
                   axis_name="pp"):
    """Split the (B, ...) batch into `microbatches` and run
    ``pipeline_step`` over the stacked stage parameters (every leaf's dim
    0 the stage): a local mesh runs every stage, a world rank its own."""
    b = x.shape[0]
    mb = b // microbatches
    xm = x.reshape((microbatches, mb) + tuple(x.shape[1:]))
    s_count = mesh.shape[axis_name]
    if mesh.world:
        params = _stage_of(params_stacked, mesh.coords()[axis_name])
    else:
        params = [_stage_of(params_stacked, s) for s in range(s_count)]
    ym = pipeline_step(stage_fn, params, xm, axis_name, mesh)
    return ym.reshape((b,) + tuple(ym.shape[2:]))


# ---------------------------------------------------------------------------
# 1F1B
# ---------------------------------------------------------------------------

def bubble_fraction(microbatches, stages):
    """The 1F1B bubble of this scheduler: 2M + 2S - 2 ticks, of which
    each stage works in 2M, so (2S - 2) / (2M + 2S - 2), the classic
    (S - 1) / (M + S - 1)."""
    m, s = int(microbatches), int(stages)
    if m <= 0 or s <= 0:
        raise ValueError(f"need positive M, S; got M={m}, S={s}")
    return (2 * s - 2) / (2 * m + 2 * s - 2)


def tick_table(microbatches, stages):
    """The 1F1B schedule: one list a tick, one entry a stage, each
    (FWD, k), (BWD, k) or None. Stage s runs F of microbatch k at tick
    2k + s and B of it at tick 2k + 2S - 1 - s (opposite parities, so one
    event a stage a tick), over 2M + 2S - 2 ticks."""
    m, s_count = int(microbatches), int(stages)
    table = []
    for t in range(2 * m + 2 * s_count - 2):
        row = []
        for s in range(s_count):
            ev = None
            if (t - s) % 2 == 0 and 0 <= (t - s) // 2 < m:
                ev = (FWD, (t - s) // 2)
            kb = t - 2 * s_count + 1 + s
            if kb % 2 == 0 and 0 <= kb // 2 < m:
                ev = (BWD, kb // 2)
            row.append(ev)
        table.append(row)
    return table


def _new_carry(stage_params, act_shape, dtype, stages, device):
    """One stage's state between ticks: the activation arriving from the
    previous stage, the gradient arriving from the next, the S-slot
    residual buffer, the gradient accumulator and the loss (f32)."""
    return {
        "act_in": torch.zeros(act_shape, dtype=dtype, device=device),
        "grad_in": torch.zeros(act_shape, dtype=dtype, device=device),
        "buf": torch.zeros((stages,) + tuple(act_shape), dtype=dtype,
                           device=device),
        "gacc": pytree.tree_map(
            lambda a: torch.zeros(a.shape, dtype=a.dtype, device=device),
            stage_params),
        "loss": torch.zeros((), dtype=torch.float32, device=device)}


def _carry_bytes(carry):
    return sum(t.numel() * t.element_size()
               for t in pytree.tree_leaves(carry))


def schedule_stats(stage_fn, loss_fn, stacked_params, x_microbatches, aux,
                   mesh, axis_name="pp"):
    """The 1F1B schedule's shape without running it: {"ticks",
    "carry_bytes", "bubble_fraction"} from the port's tick table and its
    per-stage carry (made on the meta device), with JAX's accounting:
    act_in + grad_in + the (S, ...) buffer + the gradient accumulator +
    the loss. The carry does not grow with the microbatch count."""
    stages = mesh.shape[axis_name]
    m = x_microbatches.shape[0]
    ticks = len(tick_table(m, stages))
    carry = _new_carry(_stage_of(stacked_params, 0),
                       tuple(x_microbatches.shape[1:]),
                       x_microbatches.dtype, stages, "meta")
    return {"ticks": ticks, "carry_bytes": _carry_bytes(carry),
            "bubble_fraction": (ticks - 2 * m) / ticks}


def _leaves_like(tree):
    return pytree.tree_map(lambda a: a.detach().requires_grad_(True), tree)


def _stage_backward(stage_fn, loss_fn, params, x_saved, grad_in, aux_k,
                    last, need_dx):
    """The B event: the stage rematerialized from its saved input, then
    its vector-Jacobian product. Returns (loss, dparams, dx)."""
    leaves = _leaves_like(params)
    flat, spec = pytree.tree_flatten(leaves)
    x = x_saved.detach().requires_grad_(need_dx)
    with torch.enable_grad():
        y = stage_fn(leaves, x)
        if last:
            out = loss_fn(y, aux_k)
            cot = torch.ones_like(out)
        else:
            out, cot = y, grad_in
        wrt = flat + ([x] if need_dx else [])
        grads = torch.autograd.grad(out, wrt, cot, allow_unused=True)
    grads = [torch.zeros_like(w) if g is None else g
             for w, g in zip(wrt, grads)]
    dx = grads[-1] if need_dx else None
    dp = pytree.tree_unflatten(grads[:len(flat)], spec)
    return (out.detach() if last else None), dp, dx


def pipeline_1f1b(stage_fn, loss_fn, stacked_params, x_microbatches, aux,
                  mesh, axis_name="pp"):
    """1F1B training step over homogeneous stages (``tick_table``): each
    tick a stage runs one forward (under no_grad, its input kept in the
    S-slot buffer) or one backward (the stage rematerialized from that
    input); activations go down the line and gradients up.

    stage_fn(params, x) -> y (one activation shape at every cut);
    loss_fn(y, aux_k) -> scalar, on the last stage's output;
    stacked_params: leaves (S, ...); x_microbatches: (M, mb, ...) stage 0's
    inputs; aux: (M, ...) per-microbatch extras. Returns (mean loss,
    gradients stacked like stacked_params), on every rank of a world."""
    m = x_microbatches.shape[0]
    stages = mesh.shape[axis_name]
    table = tick_table(m, stages)
    act_shape = tuple(x_microbatches.shape[1:])
    dtype, device = x_microbatches.dtype, x_microbatches.device
    world = mesh.world
    line = _Line(mesh, axis_name) if world else None
    held = [line.index] if world else list(range(stages))
    params = {s: _stage_of(stacked_params, s) for s in held}
    carry = {s: _new_carry(params[s], act_shape, dtype, stages, device)
             for s in held}
    for t, row in enumerate(table):
        act_out, grad_out = {}, {}
        for s in held:
            ev, c = row[s], carry[s]
            if ev is None:
                continue
            kind, k = ev
            if kind == FWD:
                x_in = x_microbatches[k] if s == 0 else c["act_in"]
                c["buf"][k % stages].copy_(x_in)
                with torch.no_grad():
                    y = stage_fn(params[s], x_in)
                if s < stages - 1:
                    act_out[s] = y
                continue
            aux_k = pytree.tree_map(lambda a: a[k], aux)
            lval, dp, dx = _stage_backward(
                stage_fn, loss_fn, params[s], c["buf"][k % stages],
                c["grad_in"], aux_k, s == stages - 1, s > 0)
            c["gacc"] = pytree.tree_map(lambda a, b: a + b, c["gacc"], dp)
            if lval is not None:
                c["loss"] = c["loss"] + lval.float()
            if dx is not None:
                grad_out[s] = dx
        # what a stage sent at this tick is the neighbour's input at the
        # next (``tick_table``: F of k at 2k + s, B of k at 2k + 2S-1-s)
        if world:
            _exchange_1f1b(line, carry[line.index], act_out, grad_out,
                           table, t, stages)
        else:
            for s, y in act_out.items():
                carry[s + 1]["act_in"] = y
            for s, dx in grad_out.items():
                carry[s - 1]["grad_in"] = dx
    last = stages - 1
    if world:
        s = line.index
        loss = carry[s]["loss"] if s == last else \
            torch.zeros((), dtype=torch.float32, device=device)
        loss = _all_reduce_sum(loss, line)
        grads = _gather_stages(carry[s]["gacc"], line)
    else:
        loss = carry[last]["loss"]
        grads = pytree.tree_map(lambda *a: torch.stack(a),
                                *[carry[s]["gacc"] for s in held])
    return loss / m, pytree.tree_map(lambda a: a / m, grads)


def _exchange_1f1b(line, c, act_out, grad_out, table, t, stages):
    """A world rank's sends of tick `t` (its forward's output down, its
    backward's input gradient up) and the receives the next tick's events
    read, posted together."""
    s = line.index
    nxt = table[t + 1] if t + 1 < len(table) else [None] * stages
    sends, recvs = [], []
    if s in act_out:
        sends.append((act_out[s], 1, 0))
    if s in grad_out:
        sends.append((grad_out[s], -1, 1))
    ev = nxt[s]
    if ev is not None and ev[0] == FWD and s > 0:
        c["act_in"] = torch.empty_like(c["act_in"])
        recvs.append((c["act_in"], -1, 0))
    if ev is not None and ev[0] == BWD and s < stages - 1:
        c["grad_in"] = torch.empty_like(c["grad_in"])
        recvs.append((c["grad_in"], 1, 1))
    line.exchange(sends, recvs)


def _all_reduce_sum(x, line):
    x = x.clone()
    if line.group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=line.group)
    return x


def _gather_stages(tree, line):
    """Every stage's tree stacked along a new dim 0, on every rank."""
    def gather(a):
        parts = [torch.empty_like(a) for _ in range(line.size)]
        dist.all_gather(parts, a.contiguous(), group=line.group)
        return torch.stack(parts)
    return pytree.tree_map(gather, tree)


# ---------------------------------------------------------------------------
# Framework (static-graph) path
# ---------------------------------------------------------------------------

class PipelineConfig:
    """Attached to a Program by PipelineOptimizer.minimize; read by the
    Executor when the walk's mesh has pp > 1 (core/executor.py)."""

    def __init__(self, cut_names, num_microbatches):
        self.cut_names = list(cut_names)
        self.num_microbatches = num_microbatches


def partition_forward_ops(block, fwd_ops, cut_names, global_names,
                          feed_names):
    """Split a topologically ordered op list into stages at the ops that
    produce each cut var, and check that only the cut tensor crosses a
    stage boundary (parameters, persistables and feeds may be read
    anywhere): the contract fluid's PipelineOptimizer puts on cut_list."""
    boundaries = []
    for c in cut_names:
        idx = None
        for i, op in enumerate(fwd_ops):
            if c in op.output_names:
                idx = i
        if idx is None:
            raise ValueError(f"cut var '{c}' is not produced by any op")
        boundaries.append((idx, c))
    boundaries.sort()
    segments = []
    start = 0
    for idx, c in boundaries:
        segments.append((fwd_ops[start:idx + 1], c))
        start = idx + 1
    segments.append((fwd_ops[start:], None))

    produced_before = set()
    for si, (seg_ops, _out_cut) in enumerate(segments):
        in_cut = segments[si - 1][1] if si > 0 else None
        local = set()
        for op in seg_ops:
            for name in op.input_names:
                if name in local or name in global_names \
                        or name in feed_names or name == in_cut:
                    continue
                if name in produced_before:
                    raise ValueError(
                        f"stage {si} op '{op.type}' reads '{name}' from an "
                        f"earlier stage; cut_list must separate the program "
                        f"into a chain (only the cut tensor crosses stages)")
            local |= set(op.output_names)
        produced_before |= local
    return segments


def _check_combination(program, mesh, axis_name):
    """The mesh and Program forms the pipelined walk runs: pp alone or pp
    x tp. The others raise, naming their queued item."""
    for axis in ("dp", "sp", "ep"):
        if mesh.shape.get(axis, 1) > 1:
            raise NotImplementedError(
                f"a pipelined Program over a mesh with {axis}="
                f"{mesh.shape[axis]} is not ported (ROADMAP queue A: "
                f"pipeline parallelism beside {axis}, which no JAX test "
                f"holds)")
    if getattr(program, "_recompute", None):
        raise NotImplementedError(
            "a pipelined Program under RecomputeOptimizer is not ported "
            "(ROADMAP queue A: pipeline parallelism under recompute)")
    if any("__amp_dtype__" in op.attrs
           for op in program.global_block().ops):
        raise NotImplementedError(
            "a pipelined Program under amp is not ported (ROADMAP queue "
            "A: pipeline parallelism under amp)")


def _microbatch_seed(seed, k):
    """The program seed microbatch k's random ops fold in: one torch
    generator stream a microbatch, as JAX folds the microbatch into its
    key."""
    from ..ops import _MASK64, _mix64
    return _mix64((int(seed) & _MASK64) ^ _mix64(k + 1))


def build_pipelined_forward(program, marker_idx, pipeline_cfg, mesh,
                            loss_name, is_test=False, axis_name="pp",
                            device=None, live=None, walk=None):
    """The Program's forward section as a GPipe schedule over the mesh's
    pp axis. Returns fwd(env, feeds) -> (objective, loss): `env` holds
    the parameters (autograd leaves) and the other persistables, `feeds`
    the whole batch; `loss` is the mean of the microbatches' losses on
    every rank, `objective` the scalar whose gradient is the step's: the
    loss itself on a local mesh; in a world this rank's part (its stage's
    losses and the cuts it sent), which sums over pp to the whole.

    Checked here, as JAX checks them: one stage a pp position, cut
    tensors of one shape and dtype, no persistable written in the
    forward, a batch-mean loss (else a RuntimeWarning); a batch the
    microbatch count does not divide raises at run time."""
    from .. import ops as ops_registry
    _check_combination(program, mesh, axis_name)
    gb = program.global_block()
    fwd_ops = gb.ops[:marker_idx]
    global_names = {v.name for v in program.list_vars() if v.persistable}
    feed_names = {v.name for v in program.list_vars()
                  if getattr(v, "is_data", False)}
    for op in fwd_ops:
        bad = [n for n in op.output_names
               if n in global_names and n not in feed_names]
        if bad:
            raise NotImplementedError(
                f"forward op '{op.type}' writes persistable var(s) {bad}; "
                f"stateful forward ops (batch-norm stats, counters) are not "
                f"supported inside a pipelined section — move them out or "
                f"use use_global_stats/is_test variants")
    loss_op_types = [op.type for op in fwd_ops if loss_name in op.output_names]
    if loss_op_types and loss_op_types[-1] not in (
            "mean", "reduce_mean", "elementwise_div"):
        warnings.warn(
            f"pipeline loss '{loss_name}' is produced by "
            f"'{loss_op_types[-1]}', not a batch mean; microbatch averaging "
            f"scales a sum-style loss by 1/num_microbatches — normalize the "
            f"loss by batch size", RuntimeWarning, stacklevel=3)
    segments = partition_forward_ops(gb, fwd_ops, pipeline_cfg.cut_names,
                                     global_names, feed_names)
    stages = len(segments)
    pp = mesh.shape[axis_name]
    if stages != pp:
        raise ValueError(f"{stages} pipeline stages but mesh has "
                         f"{axis_name}={pp}")
    cut_vars = [gb.vars[c] for _, c in segments if c is not None]
    shapes = {tuple(v.shape) for v in cut_vars}
    if len(shapes) != 1:
        raise ValueError(f"all cut tensors must share one shape, got "
                         f"{sorted(shapes)} — pad the boundary activations")
    dtypes = {str(v.dtype) for v in cut_vars}
    if len(dtypes) != 1:
        raise ValueError(f"all cut tensors must share one dtype, got "
                         f"{sorted(dtypes)}")
    cut_dtype = ops_registry.torch_dtype(dtypes.pop())
    declared = list(cut_vars[0].shape)
    m = pipeline_cfg.num_microbatches
    rng_key = ops_registry.RNG_KEY

    def run_segment(si, genv, feeds_mb, rng_k, x_in):
        seg_ops, out_cut = segments[si]
        in_cut = segments[si - 1][1] if si > 0 else None
        env = dict(genv)
        env.update(feeds_mb)
        env[rng_key] = rng_k
        if in_cut is not None:
            env[in_cut] = x_in
        for op in seg_ops:
            ops_registry.run_op(op, env, program, is_test, device, live)
        if out_cut is None:
            return env[loss_name].sum()
        return env[out_cut].to(cut_dtype)

    def fwd(env, feeds):
        feeds_m = {}
        for name, v in feeds.items():
            b = v.shape[0]
            if b % m:
                raise ValueError(f"batch {b} of feed '{name}' not divisible "
                                 f"by num_microbatches={m}")
            feeds_m[name] = v.reshape((m, b // m) + tuple(v.shape[1:]))
        genv = {k: v for k, v in env.items()
                if k not in feeds and k != rng_key}
        if walk is not None:
            # every parameter reaches the stages whole (replicated)
            from .sharded import ShardedTensor
            genv = {k: walk.gather(v) if isinstance(v, ShardedTensor) else v
                    for k, v in genv.items()}
        seed, step = env[rng_key]

        def mb(k):
            return ({n: v[k] for n, v in feeds_m.items()},
                    (_microbatch_seed(seed, k), step))

        if not mesh.world:
            # every stage here, tick by tick (stage s runs microbatch t - s)
            carry, losses = [None] * stages, [None] * m
            for t in range(m + stages - 1):
                nxt = [None] * stages
                for s in range(stages):
                    k = t - s
                    if not 0 <= k < m:
                        continue          # a bubble slot
                    out = run_segment(s, genv, *mb(k), carry[s])
                    if s == stages - 1:
                        losses[k] = out
                    else:
                        nxt[s + 1] = out
                carry = nxt
            loss = sum(losses[1:], losses[0]) / m
            return loss, loss
        return _world_forward(mesh, axis_name, stages, m, env, genv, mb,
                              run_segment, declared, cut_dtype, walk)

    return fwd


def _world_forward(mesh, axis_name, stages, m, env, genv, mb, run_segment,
                   declared, cut_dtype, walk):
    """A world rank's stage over the microbatches in order: receive the
    cut from the previous stage, run the segment, send its cut to the
    next (``_Recv`` / ``_Send``: the backward sends the cotangents up).
    The objective is this rank's part, seeded with 1 / the product of the
    other axes a replicated value spans (the walk's rule)."""
    line = _Line(mesh, axis_name)
    s = line.index
    tie = next((v for v in env.values() if isinstance(v, torch.Tensor)
                and v.requires_grad and v.is_leaf), None)
    if tie is None:
        raise RuntimeError("a pipelined world step needs a parameter leaf "
                           "that requires grad")
    device = tie.device
    parts, total = [], None
    shape = None
    for k in range(m):
        feeds_mb, rng_k = mb(k)
        x_in = None
        if s > 0:
            if shape is None:
                shape = _recv_shape(line, len(declared), device)
            x_in = _Recv.apply(line, torch.empty(shape, dtype=cut_dtype,
                                                 device=device), tie)
        out = run_segment(s, genv, feeds_mb, rng_k, x_in)
        if s < stages - 1:
            if k == 0:
                line.exchange(sends=[(torch.tensor(
                    out.shape, dtype=torch.int64, device=device), 1, 2)])
            parts.append(_Send.apply(line, out))
        else:
            total = out if total is None else total + out
    loss_part = (total / m) if total is not None else \
        torch.zeros((), dtype=torch.float32, device=device)
    objective = loss_part + sum(parts) if parts else loss_part
    replicas = walk.replicas(skip=(axis_name,)) if walk is not None else 1
    loss = mesh.all_sum([loss_part.detach()], axis_name)
    return objective / replicas, loss


def check_fetches(program, fetch_names, loss_name, persist_names):
    """Forward intermediates exist only per microbatch inside the
    schedule: a pipelined run fetches the loss, persistables, feeds and
    gradients, and raises ValueError for anything else."""
    data_names = {v.name for v in program.list_vars()
                  if getattr(v, "is_data", False)}
    bad = [f for f in fetch_names
           if f != loss_name and not f.endswith("@GRAD")
           and f not in persist_names and f not in data_names]
    if bad:
        raise ValueError(
            f"cannot fetch forward intermediates {bad} from a pipelined "
            f"program — they exist only per-microbatch inside the pipeline "
            f"schedule; fetch the loss, params or gradients instead")


def _recv_shape(line, ndim, device):
    shape = torch.empty(ndim, dtype=torch.int64, device=device)
    line.exchange(recvs=[(shape, -1, 2)])
    return tuple(int(d) for d in shape.tolist())


class PipelineOptimizer:
    """Parity: fluid.optimizer.PipelineOptimizer. minimize() runs the
    inner optimizer's minimize and attaches a PipelineConfig (the cut
    names, the microbatch count) that the Executor runs as a GPipe
    schedule over the mesh's pp axis (``CompiledProgram.with_mesh(
    make_mesh(pp=...))``). The reference's queue and thread knobs are
    kept for API compatibility."""

    def __init__(self, optimizer, cut_list=None, place_list=None,
                 concurrency_list=None, queue_size=30, sync_steps=1,
                 start_cpu_core_id=0, num_microbatches=None):
        self._optimizer = optimizer
        self.cut_list = cut_list
        self.num_microbatches = num_microbatches or 4

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        ret = self._optimizer.minimize(loss, startup_program,
                                       parameter_list, no_grad_set)
        if self.cut_list:
            cut_names = []
            for c in self.cut_list:
                # fluid's cut_list nests: [[var], [var2]]; a flat list too
                items = c if isinstance(c, (list, tuple)) else [c]
                for it in items:
                    cut_names.append(it if isinstance(it, str) else it.name)
            prog = loss.block.program
            prog._pipeline = PipelineConfig(cut_names, self.num_microbatches)
        return ret
