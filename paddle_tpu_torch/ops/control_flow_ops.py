"""Control-flow ops.

Parity: paddle/fluid/operators/controlflow/* (while_op, conditional_block,
select, tensor_array_read_write, print_op) and py_func_op; the
counterpart of ``paddle_tpu/ops/control_flow_ops.py``, all 21 of its
names: ``select`` / ``where_op`` / ``where_index_select``, ``conditional_select``, ``is_empty``,
the tensor arrays (``create_array``, ``array_write`` /
``write_to_array``, ``array_read`` / ``read_from_array``,
``array_length`` / ``lod_array_length``, ``tensor_array_to_tensor``,
``tensor_array_sizes``), ``py_func``, ``print``, and the structured ops
``while``, ``cond_pair``, ``switch``, ``static_rnn``, ``while_loop`` and
``contrib_beam_search_decoder``.

The JAX package traces each sub-block into the step's one XLA graph. The
port walks a Program eagerly, so a structured op runs its sub-block by
calling ``run_op`` over the block's ops in a copy of the env
(``_run_block``), each op launching its own work:

- ``while`` loops in Python and reads the condition on the host once an
  iteration: one host sync an iteration, which is the semantics;
- ``cond_pair`` reads the predicate on the host once and runs the taken
  branch only, as ``lax.cond`` does (the other branch neither runs nor
  takes a gradient);
- ``switch`` runs every case and merges the targets with ``torch.where``
  under a running ``done`` mask, as the JAX op does: no sync;
- ``static_rnn`` loops over axis 0 in Python and stacks the step outputs;
  autograd is its backward, as ``jax.grad`` through ``lax.scan``: no
  sync;
- ``while_loop`` calls the ``CALLABLE_TABLE`` callables on torch tensors
  and reads ``cond``'s result on the host once an iteration;
- ``py_func`` hands its callable numpy copies (a sync) and puts the
  result on the op's device with the Out variable's shape and dtype;
- ``print`` prints the host copy at once, in the JAX op's text
  (``prefix value= <array>``);
- ``contrib_beam_search_decoder`` runs its sub-block as the ``step_fn``
  of ``inference/decoding.py``'s ``beam_decode``.

A tensor array is a ``TensorArray`` (``ops/__init__.py``), stored whole
under its name. The integer outputs (``array_length``,
``tensor_array_sizes``) are int64, the port's policy, where JAX's are
int32.

Under data parallelism ``select`` runs a rank's rows,
``conditional_select`` does so behind a replicated condition,
``is_empty`` answers from one rank's rows (the shards are equal); the
arrays' bookkeeping runs once over the whole env and keeps a sharded
entry as it is, and ``tensor_array_to_tensor`` joins a rank's entries off
axis 0; ``print`` prints the global value; ``py_func`` and
``while_loop`` take replicated inputs only. The structured ops run once,
with the walk in their context, so each op of a sub-block meets its own
rule: a ``while`` or ``cond`` body may touch sharded rows. Each refuses
what has no single answer: a dp-sharded condition or predicate (no one
host value), a sharded ``switch`` target (the learning-rate schedules'
construct selects whole values), any sharded input of ``static_rnn``
(axis 0 of its step inputs is time, and its stacked outputs' rows are
dim 1) and of the beam-search decoder.
"""

import numpy as np
import torch

from . import (Sharded, TensorArray, refuses, register, replicated, rows,
               rows_if, run_op, whole, whole_context)
from .tensor_ops import host_tensor as _host_tensor


def _unsharded(ctx, value, what):
    """`value` as one tensor: a dp-sharded one refuses (at dp 1 its one
    part is the whole)."""
    if not isinstance(value, Sharded):
        return value
    if ctx.walk.size == 1:
        return value.parts[0]
    raise NotImplementedError(
        f"op '{ctx.op.type}' under data parallelism: {what} is "
        f"dp-sharded, which has no single value for the batch (feed it "
        f"replicated, or reduce it first)")


def _truth(c):
    return c if c.dtype == torch.bool else c != 0


# ---------------------------------------------------------------------------
# selects
# ---------------------------------------------------------------------------

@register("select", "where_op", "where_index_select", dp=rows)
def select(ctx):
    return {"Out": torch.where(_truth(ctx.in_("Condition")), ctx.in_("X"),
                               ctx.in_("Y"))}


def _cond_replicated(ctx, walk):
    if ctx.is_sharded("Cond"):
        return "its condition Cond is dp-sharded (one flag for the batch)"
    return None


@register("conditional_select", dp=rows_if(_cond_replicated))
def conditional_select(ctx):
    cond = _truth(ctx.in_("Cond")).reshape(())
    return {"Out": torch.where(cond, ctx.in_("X"), ctx.in_("Y"))}


def _dp_is_empty(impl, ctxs, walk):
    # the shards are equal: one rank's rows are empty iff the whole is
    return impl(ctxs[0])


@register("is_empty", dp=_dp_is_empty)
def is_empty(ctx):
    x = ctx.in_("X")
    return {"Out": torch.full((), x.numel() == 0, dtype=torch.bool,
                              device=x.device)}


# ---------------------------------------------------------------------------
# tensor arrays: a Python list of static length while the Program runs
# ---------------------------------------------------------------------------

@register("create_array", dp=whole)
def create_array(ctx):
    return {"Out": TensorArray()}


@register("array_write", "write_to_array", dp=whole)
def array_write(ctx):
    arr = TensorArray(ctx.in_("Array")) if ctx.has_in("Array") \
        else TensorArray()
    i = int(ctx.attr("static_index", len(arr)))
    x = ctx.in_("X")
    if i == len(arr):
        arr.append(x)
    elif i < len(arr):
        arr[i] = x
    else:
        raise ValueError(
            f"array_write index {i} skips entries (len={len(arr)}): "
            f"TensorArray writes must be dense")
    return {"Out": arr}


@register("array_read", "read_from_array", dp=whole)
def array_read(ctx):
    return {"Out": ctx.in_("Array")[int(ctx.attr("static_index", 0))]}


@register("array_length", "lod_array_length", dp=whole)
def array_length(ctx):
    return {"Out": torch.full((), len(ctx.in_("Array")), dtype=torch.int64,
                              device=ctx.device)}


def _joins_rows(ctx, walk):
    arr = ctx.env.env[ctx.op.input("X")[0]]
    if not all(isinstance(e, Sharded) for e in arr):
        return "the array mixes dp-sharded and replicated entries"
    ndim = arr[0].parts[0].dim() + bool(ctx.attr("use_stack", False))
    if ctx.attr("axis", 0) % ndim == 0:
        return ("it joins the entries along axis 0, where a rank's rows "
                "lie (a rank's entries would not be the whole's rows)")
    return None


@register("tensor_array_to_tensor", dp=rows_if(_joins_rows))
def tensor_array_to_tensor(ctx):
    arr = ctx.in_("X")
    axis = ctx.attr("axis", 0)
    if ctx.attr("use_stack", False):
        return {"Out": torch.stack(list(arr), dim=axis)}
    return {"Out": torch.cat(list(arr), dim=axis)}


def _dp_array_sizes(impl, ctxs, walk):
    """Each entry's size along axis from one rank's view: a sharded
    entry's rows count dp times along axis 0 (the shards are equal)."""
    c = ctxs[0]
    axis = c.attr("axis", 0)
    arr = c.env.env[c.op.input("X")[0]]
    sizes = [e.parts[0].shape[axis] * (walk.size if axis % e.parts[0].dim()
                                       == 0 else 1)
             if isinstance(e, Sharded) else e.shape[axis] for e in arr]
    return {"Out": _host_tensor(sizes, torch.int64, c.device)}


@register("tensor_array_sizes", dp=_dp_array_sizes)
def tensor_array_sizes(ctx):
    axis = ctx.attr("axis", 0)
    return {"Out": _host_tensor([x.shape[axis] for x in ctx.in_("X")],
                                torch.int64, ctx.device)}


# ---------------------------------------------------------------------------
# host callbacks
# ---------------------------------------------------------------------------

@register("py_func", dp=replicated)
def py_func(ctx):
    """fluid.layers.py_func: the callable on numpy copies of X; its
    result on the op's device with Out's shape and dtype (JAX's
    pure_callback contract). No gradient flows through it."""
    from ..core.framework import Operator
    fn = Operator.CALLABLE_TABLE[ctx.attr("func_id")]
    xs = [x.detach().cpu().numpy() for x in ctx.in_list("X")]
    out_var = ctx.out_var("Out")
    res = np.asarray(fn(*xs)).astype(out_var.dtype).reshape(out_var.shape)
    return {"Out": torch.from_numpy(np.ascontiguousarray(res)).to(
        ctx.device)}


def _print(ctx, x):
    msg = ctx.attr("message", "") or ""
    parts = [ctx.op.input("X")[0]] if ctx.attr("print_tensor_name",
                                               True) else []
    prefix = msg + " ".join(parts)
    if ctx.attr("print_tensor_shape", True):
        prefix += f" shape={tuple(x.shape)}"
    if ctx.attr("print_tensor_value", True):
        print(prefix, "value=", x.detach().cpu().numpy())
    else:
        print(prefix)


def _dp_print(impl, ctxs, walk):
    """The global value printed (the ranks' rows in rank order); Out
    stays sharded."""
    ctx = whole_context(ctxs[0], walk)
    x = ctx.in_("X")
    _print(ctx, walk.fetch(x))
    return {"Out": x}


@register("print", dp=_dp_print)
def print_op(ctx):
    """fluid.layers.Print: the host copy printed at once (a sync), X
    passed through."""
    x = ctx.in_("X")
    _print(ctx, x)
    return {"Out": x}


# ---------------------------------------------------------------------------
# structured control flow: sub-blocks run op by op in a copy of the env
# ---------------------------------------------------------------------------

# the attributes that name a structured op's sub-blocks, and those that
# name what it reads out of them
_BLOCK_ATTRS = ("sub_block", "true_block", "false_block")
_READ_ATTRS = ("carry_names", "true_outs", "false_outs", "target_names",
               "step_outputs", "state_updated_names")
_READ_ATTR = ("cond_name", "scores_name")


def _blocks_of(op):
    idx = [op.attrs[a] for a in _BLOCK_ATTRS if a in op.attrs]
    return idx + [b for _, b in op.attrs.get("cases", ())]


def sub_block_reads(program, op):
    """The names a structured op's sub-blocks read, recursively: their
    ops' inputs, and what the op reads out of them (a carry, a branch's
    results, a memory's update, the step outputs, the scores). The
    Executor adds them to the names something reads, so that an op of a
    sub-block computes every output a later op or the structured op
    takes."""
    blocks = _blocks_of(op)
    if not blocks:
        return set()
    names = {n for a in _READ_ATTRS for n in op.attrs.get(a) or ()}
    names.update(op.attrs[a] for a in _READ_ATTR if a in op.attrs)
    names.update(m[2] for m in op.attrs.get("memories") or ())
    for i in blocks:
        for inner in program.blocks[i].ops:
            names.update(inner.input_names)
            names |= sub_block_reads(program, inner)
    return names


def _run_block(block, env, ctx):
    """Every op of `block` into `env`, through the run's dp walk."""
    for op in block.ops:
        run_op(op, env, ctx.program, ctx.is_test, ctx.device, ctx.live,
               ctx.walk)


def _host_bool(ctx, value, what):
    """A one-element flag read on the host (a sync on the card)."""
    return bool(_truth(_unsharded(ctx, value, what)).reshape(()))


@register("while", dp=whole)
def while_op(ctx):
    """fluid.layers.While: the body in a copy of the env while the
    condition (a carry) holds. Only the carry (the outer variables the
    body writes) passes from one iteration to the next."""
    block = ctx.program.blocks[ctx.attr("sub_block")]
    carry_names = list(ctx.attr("carry_names"))
    cond_name = ctx.attr("cond_name")
    env = dict(ctx.env)
    while _host_bool(ctx, env[cond_name], "its condition"):
        inner = dict(env)
        _run_block(block, inner, ctx)
        env.update((n, inner[n]) for n in carry_names)
    return {"Out": [env[n] for n in carry_names]}


@register("cond_pair", dp=whole)
def cond_pair(ctx):
    """fluid.layers.cond: the predicate read on the host, the taken
    branch run."""
    taken = _host_bool(ctx, ctx.in_("Cond"), "its predicate")
    block = ctx.attr("true_block") if taken else ctx.attr("false_block")
    names = ctx.attr("true_outs") if taken else ctx.attr("false_outs")
    env = dict(ctx.env)
    _run_block(ctx.program.blocks[block], env, ctx)
    return {"Out": [env[n] for n in names]}


def _flag(ctx, value):
    """A case's condition as a device bool of shape ()."""
    return _truth(_unsharded(ctx, value, "a case's condition")).reshape(())


@register("switch", dp=whole)
def switch_op(ctx):
    """fluid.layers.Switch: every case's block run, the first true case's
    values taken, by selects under a running `done` flag on the device
    (no host sync)."""
    targets = list(ctx.attr("target_names"))
    env = dict(ctx.env)
    done = torch.zeros((), dtype=torch.bool, device=ctx.device)
    current = {n: env[n] for n in targets}
    for cond_name, block_idx in ctx.attr("cases"):
        inner = dict(env)
        _run_block(ctx.program.blocks[block_idx], inner, ctx)
        if cond_name is None:
            take = torch.logical_not(done)
        else:
            c = _flag(ctx, env[cond_name])
            take = torch.logical_and(c, torch.logical_not(done))
            done = torch.logical_or(done, c)
        for n in targets:
            if n in inner:
                current[n] = torch.where(
                    take, _unsharded(ctx, inner[n], f"target '{n}'"),
                    _unsharded(ctx, current[n], f"target '{n}'"))
    return {"Out": [current[n] for n in targets]}


@register("static_rnn", dp=refuses(
        "a dp-sharded input of a static RNN has no rows to split: axis 0 "
        "of its step inputs is time (split over dp it would split T), and "
        "its stacked outputs' batch is dim 1; feed it replicated"))
def static_rnn(ctx):
    """fluid.layers.StaticRNN: the sub-block once a step along axis 0 of
    the step inputs. attrs:
    step_inputs:  [[outer_name, inner_name], ...]   sliced on axis 0
    memories:     [[inner_name, init_name, updated_name], ...]
    step_outputs: [inner_name, ...]                  stacked on axis 0
    Out: the stacked step outputs, then each memory's last value."""
    block = ctx.program.blocks[ctx.attr("sub_block")]
    step_inputs = ctx.attr("step_inputs")
    memories = ctx.attr("memories")
    step_outputs = list(ctx.attr("step_outputs"))
    outer = dict(ctx.env)
    xs = [torch.unbind(outer[o], 0) for o, _ in step_inputs]
    carry = [outer[init] for _, init, _ in memories]
    ys = [[] for _ in step_outputs]
    for x_t in zip(*xs):
        env = dict(outer)
        env.update((inner, c) for (inner, _, _), c in zip(memories, carry))
        env.update((inner, x) for (_, inner), x in zip(step_inputs, x_t))
        _run_block(block, env, ctx)
        carry = [env[upd] for _, _, upd in memories]
        for y, o in zip(ys, step_outputs):
            y.append(env[o])
    return {"Out": [torch.stack(y) for y in ys] + carry}


@register("while_loop", dp=replicated)
def while_loop_op(ctx):
    """layers.while_loop: cond and body, Python callables from the
    CALLABLE_TABLE, called on the loop's tensors; cond's result read on
    the host once an iteration. The body's results take the loop
    variables' dtypes and device."""
    from ..core.framework import Operator
    cond = Operator.CALLABLE_TABLE[ctx.attr("cond_fn")]
    body = Operator.CALLABLE_TABLE[ctx.attr("body_fn")]
    vals = ctx.in_list("X")
    while bool(torch.as_tensor(cond(*vals)).reshape(())):
        out = body(*vals)
        out = out if isinstance(out, (list, tuple)) else [out]
        vals = [torch.as_tensor(o, dtype=v.dtype, device=v.device)
                for o, v in zip(out, vals)]
    return {"Out": vals}


@register("contrib_beam_search_decoder", dp=refuses(
        "the beam search reorders its lanes by parent beam across the "
        "whole batch; feed the decoder replicated"))
def contrib_beam_search_decoder(ctx):
    """Beam search over a one-step sub-block (contrib.decoder's
    BeamSearchDecoder): the sub-block maps (previous ids (B*K,),
    states) to (softmax scores (B*K, V), updated states) and is the
    step_fn of inference.decoding.beam_decode, whose lanes are dense
    (B*K) and reordered by parent beam; log(scores + 1e-9) are the
    log-probabilities it takes, as in the JAX op."""
    from ..inference.decoding import beam_decode
    block = ctx.program.blocks[ctx.attr("sub_block")]
    K = ctx.attr("beam_size")
    state_names = list(ctx.attr("state_names"))
    inner_names = list(ctx.attr("state_inner_names"))
    updated_names = list(ctx.attr("state_updated_names"))
    prev_ids_name = ctx.attr("prev_ids_name")
    scores_name = ctx.attr("scores_name")
    init_ids = ctx.in_("InitIds").reshape(-1)
    cache0 = {n: s.repeat_interleave(K, dim=0)
              for n, s in zip(state_names, ctx.in_list("InitStates"))}
    outer = dict(ctx.env)

    def step_fn(ids_t, cache, t):
        env = dict(outer)
        env[prev_ids_name] = ids_t
        env.update((inner, cache[n])
                   for n, inner in zip(state_names, inner_names))
        _run_block(block, env, ctx)
        logits = torch.log(env[scores_name] + 1e-9)
        return logits, {n: env[u] for n, u in zip(state_names,
                                                  updated_names)}

    ids, scores = beam_decode(
        step_fn, cache0, init_ids, ctx.attr("max_len"), K,
        ctx.attr("end_id"), length_penalty=ctx.attr("length_penalty", 0.0))
    return {"Ids": ids, "Scores": scores}

