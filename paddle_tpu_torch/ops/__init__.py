"""Op registry: op type -> eager torch implementation.

Parity: paddle/fluid/operators/* (REGISTER_OPERATOR); the counterpart of
``paddle_tpu/ops/__init__.py`` (``register``, ``OpContext``, ``run_op``),
with torch in place of jnp. The JAX registry's ops run while the Executor
traces a Program under jit; the port's run eagerly, one after another, as
the Executor walks the Program (core/executor.py), so each op launches its
own device work. The registry holds only the ops the ported slice runs;
the modules keep the JAX registry's names.

An op impl has signature ``fn(ctx) -> {output_slot: tensor-or-list}``.

Every op also declares its data-parallel rule (``register(..., dp=)``),
which the dp walk (``core/compiler.py``) consults when an input of the
op is dp-sharded (a ``Sharded`` value: one tensor a held rank, each the
rank's rows along dim 0): ``rows`` runs the op once a held rank on its
rows, ``rows_if(check)`` does so behind a check, ``replicated`` refuses
a sharded input, ``refuses(why)`` does so at dp > 1, ``whole`` runs the
op once over the whole env (the tensor arrays' bookkeeping, the
structured control-flow ops, whose sub-blocks' ops meet their own rules
through the walk the context carries), and an op's own rule finishes a
global reduction with the mesh's dp collective into a replicated value. An op without a rule
refuses a sharded input too: the walk never computes a silently local
answer.

Sharded state (``parallel.sharded.ShardedTensor``: a persistable a
``dist_attr`` lays out over the mesh, its gradient, or an activation a
tp rule leaves split over "tp") meets an op before its dp rule does. An
op with a shard rule (``shard_rule``) may take it as it is: the Megatron
rules over "tp" (``multihead_attention``, ``mul``, ``matmul``,
``lookup_table``, the elementwise ops and the activations, each on the
blocks a rank holds, a row-parallel product finished by the mesh's
``reduce_fn``), and the optimizers' blockwise update. A rule that does
not apply returns None, and so does an op without one: it then reads the
value's global tensor (``walk.gather``: a concatenation of the parts on
a local mesh, an all-gather in a world, counted in the mesh's
``reductions``), and an in-place update of that tensor goes back into
the parts. Under a mesh with dp beside tp the rows are dp-sharded too: a
shard rule then runs once a held dp rank on its rows (its outputs
dp-sharded, a tp-split activation a ``Sharded`` of ``ShardedTensor``
rows), and an op without one reads each rank's gathered rows.

Kernels live in subpackages by route (``ops/cuda/``); the modules here
are plain torch around them.
"""

import torch

from ..core.framework import convert_dtype
from ..parallel.sharded import ShardedTensor

_REGISTRY = {}
_DP_RULES = {}
_SHARD_RULES = {}

# the env key of the step's (program seed, step counter) pair, from which
# OpContext.rng() seeds each random op's generator
RNG_KEY = "@RNG@"

_TORCH_DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool}


class TensorArray(list):
    """The value of a LoDTensorArray variable while the Executor walks a
    Program: a Python list of tensors of static length. A type of its
    own so that run_op stores an array whole under its one output name,
    where it zips a list of several outputs across the names."""


def torch_dtype(dtype):
    """A framework dtype spec -> the torch dtype. Unlike the JAX package
    the port keeps int64 on the device (torch's embedding takes it)."""
    return _TORCH_DTYPES[convert_dtype(dtype)]


def register(*names, dp):
    """Register `fn` under `names` with its data-parallel rule `dp`:
    ``rows``, ``rows_if(check)``, ``replicated``, an op's own rule
    ``dp(impl, ctxs, walk) -> outputs``, or None (no rule)."""
    def deco(fn):
        for n in names:
            _REGISTRY[n] = fn
            _DP_RULES[n] = dp
        return fn
    return deco


def shard_rule(*names):
    """Register `rule(impl, ctx, walk) -> outputs or None` as the shard
    rule of the ops `names`: it runs when an input is a ShardedTensor,
    with `ctx` over the whole env, and returns None where it does not
    apply (the op then reads the global values)."""
    def deco(rule):
        for n in names:
            _SHARD_RULES[n] = rule
        return rule
    return deco


def get(name):
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"op '{name}' is not ported: paddle_tpu_torch.ops registers "
            f"only the ops of the ported slices")
    return _REGISTRY[name]


_MASK64 = (1 << 64) - 1


def _mix64(x):
    """splitmix64's finalizer: a 64-bit integer hash."""
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _MASK64
    return x ^ (x >> 31)


def generator_seed(seed, step, op_seed):
    """The seed of one random op's generator at one step: a hash of
    (program seed, step counter, op seed), as JAX folds the three into
    one key. The streams differ from JAX's by design: torch's generators
    are not JAX's counter-based PRNG."""
    x = _mix64(int(seed) & _MASK64)
    x = _mix64(x ^ (int(step) & _MASK64))
    return _mix64(x ^ (int(op_seed) & _MASK64))


class OpContext:
    """Execution context handed to an op impl while the Executor runs a
    Program: the op, the env of live values, the device the Executor runs
    on, `live`, the names something downstream reads (None: all), and
    `walk`, the run's dp walk (None outside one), which a structured
    control-flow op hands to the ops of its sub-blocks so that each meets
    its own dp rule.

    A white-listed op that ``amp.cast_model_to_bf16`` tagged with
    ``__amp_dtype__`` gets its f32/f64 tensor inputs cast to that dtype
    (bf16) as it reads them; its outputs are left alone, so a bf16
    product meets an f32 bias in the next elementwise op and torch
    promotes the sum back to f32, as jnp does. Parameters and gradients
    stay f32 outside the op (master weights)."""

    __slots__ = ("op", "env", "program", "is_test", "device", "live",
                 "dp_rank", "walk", "block", "_amp")

    def __init__(self, op, env, program, is_test=False, device=None,
                 live=None, dp_rank=None, walk=None, block=None):
        self.op = op
        self.env = env
        self.program = program
        self.is_test = is_test or bool(op.attrs.get("is_test", False))
        self.device = device
        self.live = live
        # the held dp rank whose rows this context reads (None: the op
        # runs once, on replicated inputs)
        self.dp_rank = dp_rank
        self.walk = walk
        # (global shape, index) of the block a shard rule hands this
        # context (None: the op sees whole values)
        self.block = block
        amp = op.attrs.get("__amp_dtype__")
        self._amp = torch_dtype(amp) if amp else None

    # -- inputs -------------------------------------------------------------
    def _maybe_amp(self, v):
        if self._amp is not None and isinstance(v, torch.Tensor) and \
                v.dtype in (torch.float32, torch.float64):
            return v.to(self._amp)
        return v

    def in_list(self, slot):
        return [self._maybe_amp(self.env[n]) for n in self.op.input(slot)]

    def in_(self, slot, default=None):
        names = self.op.input(slot)
        return self._maybe_amp(self.env[names[0]]) if names else default

    def has_in(self, slot):
        return bool(self.op.input(slot))

    def attr(self, name, default=None):
        return self.op.attrs.get(name, default)

    def is_sharded(self, slot):
        """Is this input dp-sharded (the context reads one rank's
        rows)?"""
        names = self.op.input(slot)
        return bool(names) and isinstance(self.env, _RankView) and \
            isinstance(self.env.env[names[0]], Sharded)

    def out_name(self, slot):
        names = self.op.output(slot)
        return names[0] if names else None

    def out_var(self, slot):
        name = self.out_name(slot)
        return self.op.block._find_var_recursive(name) if name else None

    def wants(self, slot):
        """Does anything read this output (a later op, a fetch, the
        scope)? An eager op skips the side outputs nobody reads (the
        softmax beside a cross-entropy, a reshape's XShape), which the JAX
        Executor's jit drops as dead code."""
        name = self.out_name(slot)
        return name is not None and (self.live is None or name in self.live)

    # -- rng ----------------------------------------------------------------
    def rng(self, shared=False):
        """A torch.Generator on the op's device, seeded from (program
        seed, step counter, this op's op_seed): deterministic per op and
        step, as JAX's fold_in keys are. A dp rank r > 0 folds r into
        the seed, so ranks draw different masks for their rows (JAX draws
        one mask over the global shape); rank 0 keeps the single-device
        stream. With `shared` every rank draws rank 0's stream (an op
        whose one draw serves the whole batch, as the samplers' class
        sets do)."""
        seed, step = self.env[RNG_KEY]
        x = generator_seed(seed, step, self.op.attrs.get("op_seed", 0))
        if self.dp_rank and not shared:
            x = _mix64(x ^ int(self.dp_rank))
        # a walk on meta tensors (Executor.explain) draws nothing: its
        # ops take a host generator, which meta tensors accept
        gen = torch.Generator(device=self.device
                              if self.device.type != "meta" else "cpu")
        gen.manual_seed(x)
        return gen


# -- data parallelism ---------------------------------------------------------

class Sharded:
    """A dp-sharded value of the dp walk: one tensor a held rank, in rank
    order, each the rank's rows (dim 0) of the global value."""

    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = list(parts)


def is_sharded_value(v):
    """A dp-sharded value, or a tensor array holding one."""
    return isinstance(v, Sharded) or (
        isinstance(v, TensorArray) and any(isinstance(e, Sharded)
                                           for e in v))


class _RankView:
    """The env as one held rank's op reads it: a sharded value's part (in
    a tensor array, each sharded entry's part)."""

    __slots__ = ("env", "j")

    def __init__(self, env, j):
        self.env, self.j = env, j

    def __getitem__(self, name):
        v = self.env[name]
        if isinstance(v, TensorArray):
            return TensorArray(e.parts[self.j] if isinstance(e, Sharded)
                               else e for e in v)
        return v.parts[self.j] if isinstance(v, Sharded) else v

    def keys(self):
        # dict(view): the rank's whole env (a structured op's copy)
        return self.env.keys()


class PartView:
    """The env as one block's op reads it under a shard rule: the names
    in `picks` read their block, every other name the env's value."""

    __slots__ = ("env", "picks")

    def __init__(self, env, picks):
        self.env, self.picks = env, picks

    def __getitem__(self, name):
        if name in self.picks:
            return self.picks[name]
        return self.env[name]

    def keys(self):
        return self.env.keys()


def part_context(ctx, picks, block=None):
    """`ctx`'s op over a PartView of its env."""
    return OpContext(ctx.op, PartView(ctx.env, picks), ctx.program,
                     ctx.is_test, ctx.device, ctx.live, walk=ctx.walk,
                     block=block)


def tp_split(value, dims):
    """`value` laid out over "tp" on exactly the dimensions `dims`
    (negative counts from the end), as a ShardedTensor over "tp" alone,
    or None. A value laid out over "tp" there and over other axes (dp,
    sp) on other dimensions is first gathered along those
    (``ShardedTensor.over``, counted once)."""
    if not isinstance(value, ShardedTensor) or "tp" not in value.axes:
        return None
    n = len(value.shape)
    want = {d % n for d in dims}
    tp_dims = {d for d, e in enumerate(value.spec) if e == "tp"}
    if tp_dims != want or any(
            "tp" in _axes_of(e) for d, e in enumerate(value.spec)
            if d not in want):
        return None
    return value.over(["tp"])


def _axes_of(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def blockwise(impl, ctx, walk):
    """The shard rule of an op of one input X and one output Out that
    acts elementwise: once a part, its output laid out as X."""
    name = ctx.op.input("X")[0]
    x = ctx.env[name]
    if not isinstance(x, ShardedTensor):
        return None
    outs = [impl(part_context(ctx, {name: p}))["Out"] for p in x.parts]
    return {"Out": x.like(outs)}


def _sharded_slot(vals):
    """One output slot's per-rank values -> Sharded (a list of Sharded
    where the slot holds several names)."""
    if isinstance(vals[0], (list, tuple)) and \
            not isinstance(vals[0], TensorArray):
        return [Sharded(col) for col in zip(*vals)]
    return Sharded(vals)


def rows(impl, ctxs, walk):
    """The op once a held rank, on that rank's rows: its outputs are
    sharded. Right for ops that treat dim 0 as rows (elementwise with
    broadcasting, products against a replicated weight, normalizations
    and softmaxes off dim 0, embeddings, attention, dropout)."""
    outs = [impl(c) or {} for c in ctxs]
    return {slot: _sharded_slot([o[slot] for o in outs]) for slot in outs[0]}


def rows_if(check):
    """``rows`` behind `check(ctx, walk)`, which looks at the op on its
    first held rank and returns why it cannot run row by row (the
    NotImplementedError names the op and the reason), or None."""
    def rule(impl, ctxs, walk):
        why = check(ctxs[0], walk)
        if why:
            raise NotImplementedError(
                f"op '{ctxs[0].op.type}' under data parallelism: {why}")
        return rows(impl, ctxs, walk)
    return rule


def replicated(impl, ctxs, walk):
    """The rule of ops that take replicated inputs only (the optimizer,
    constants, counters, whole-tensor norms)."""
    raise NotImplementedError(
        f"op '{ctxs[0].op.type}' runs on replicated inputs only; under "
        f"data parallelism it got a dp-sharded input")


def refuses(why):
    """The dp rule of an op that cannot take an input sharded over more
    than one rank, and why (at dp 1 a rank's rows are the whole)."""
    def rule(impl, ctxs, walk):
        if walk.size == 1:
            return rows(impl, ctxs, walk)
        raise NotImplementedError(
            f"op '{ctxs[0].op.type}' under data parallelism: {why}")
    return rule


def whole(impl, ctxs, walk):
    """The rule of ops that run once over the whole env, sharded values
    and all (the tensor arrays' bookkeeping, which stores or hands back
    a sharded entry as it is, and the structured control-flow ops, whose
    sub-blocks' ops meet their own rules)."""
    return impl(whole_context(ctxs[0], walk))


def whole_context(ctx, walk):
    """A rank view's context -> the op's context over the whole env."""
    return OpContext(ctx.op, ctx.env.env, ctx.program, ctx.is_test,
                     ctx.device, ctx.live, walk=walk)


def run_op(op, env, program, is_test=False, device=None, live=None,
           walk=None):
    """Execute one op into env. Under the dp walk (`walk`) an op with a
    sharded persistable or activation (a ShardedTensor) goes through its
    shard rule, or reads the global values; then an op with a dp-sharded
    input (or a tensor array holding one) goes through its dp rule, one
    context a held rank; an op whose inputs are all replicated runs
    once, with the walk in its context. A TensorArray output is stored
    whole under its one name."""
    impl = get(op.type)
    if walk is not None:
        names = list(dict.fromkeys(op.input_names))
        laid = [n for n in names if _is_laid(env.get(n))]
        if laid:
            rule = _SHARD_RULES.get(op.type)
            if rule is None:
                outs = None
            elif any(isinstance(env.get(n), Sharded) for n in names):
                outs = _rule_by_rank(rule, op, env, impl, program,
                                     is_test, device, live, walk)
            else:
                outs = rule(impl, OpContext(op, env, program, is_test,
                                            device, live, walk=walk), walk)
            if outs is not None:
                _store(op, env, outs)
                return
            _run_gathered(op, env, laid, impl, program, is_test, device,
                          live, walk)
            return
    _run(op, env, impl, program, is_test, device, live, walk)


def _is_laid(v):
    """A ShardedTensor, or a dp-sharded value whose rows are one (an
    activation a tp rule left split over "tp", on each dp rank)."""
    return isinstance(v, ShardedTensor) or (
        isinstance(v, Sharded) and any(isinstance(p, ShardedTensor)
                                       for p in v.parts))


def _rule_by_rank(rule, op, env, impl, program, is_test, device, live,
                  walk):
    """A shard rule under a dp x tp (or sp) mesh: the rule once a held dp
    rank, on that rank's rows (the ops with a shard rule treat dim 0 as
    rows), its outputs dp-sharded; None where the rule does not apply."""
    outs = []
    for j, r in enumerate(walk.ranks):
        out = rule(impl, OpContext(op, _RankView(env, j), program, is_test,
                                   device, live, dp_rank=r, walk=walk),
                   walk)
        if out is None:
            return None
        outs.append(out)
    return {slot: _sharded_slot([o[slot] for o in outs]) for slot in outs[0]}


def _gather_laid(walk, value):
    if isinstance(value, Sharded):
        return Sharded([walk.gather(p) if isinstance(p, ShardedTensor)
                        else p for p in value.parts])
    return walk.gather(value)


def _run_gathered(op, env, laid, impl, program, is_test, device, live,
                  walk):
    """The op on the global values of its sharded inputs `laid` (a
    dp-sharded value's rows each gathered); a global value it updated in
    place goes back into the parts, and the names keep their sharded
    values unless the op wrote new ones."""
    held = {n: env[n] for n in laid}
    full = {n: _gather_laid(walk, v) for n, v in held.items()}
    versions = {n: t._version for n, t in full.items()
                if isinstance(t, torch.Tensor)}
    env.update(full)
    try:
        _run(op, env, impl, program, is_test, device, live, walk)
    finally:
        for n, value in held.items():
            if env.get(n) is full[n]:
                if n in versions and full[n]._version != versions[n]:
                    value.write(full[n])
                env[n] = value


def _run(op, env, impl, program, is_test, device, live, walk):
    sharded = walk is not None and any(
        is_sharded_value(env.get(n)) for n in op.input_names)
    if sharded:
        rule = _DP_RULES.get(op.type)
        if rule is None:
            raise NotImplementedError(
                f"op '{op.type}' has no data-parallel rule; it cannot run "
                f"on a dp-sharded input")
        outs = rule(impl, [OpContext(op, _RankView(env, j), program,
                                     is_test, device, live, dp_rank=r,
                                     walk=walk)
                           for j, r in enumerate(walk.ranks)], walk)
    else:
        outs = impl(OpContext(op, env, program, is_test, device, live,
                              walk=walk))
    _store(op, env, outs)


def _store(op, env, outs):
    if outs:
        for slot, vals in outs.items():
            names = op.output(slot)
            if not isinstance(vals, (list, tuple)) or \
                    isinstance(vals, TensorArray):
                vals = [vals]
            for name, val in zip(names, vals):
                env[name] = val


# Populate the registry.
from . import math_ops        # noqa: E402,F401
from . import activation_ops  # noqa: E402,F401
from . import tensor_ops      # noqa: E402,F401
from . import nn_ops          # noqa: E402,F401
from . import loss_ops        # noqa: E402,F401
from . import random_ops      # noqa: E402,F401
from . import optimizer_ops   # noqa: E402,F401
from . import attention_ops   # noqa: E402,F401
from . import metric_ops      # noqa: E402,F401
from . import sequence_ops    # noqa: E402,F401
from . import beam_search_ops  # noqa: E402,F401
from . import rnn_ops         # noqa: E402,F401
from . import crf_ops         # noqa: E402,F401
from . import ctc_ops         # noqa: E402,F401
from . import control_flow_ops  # noqa: E402,F401
from . import detection_ops   # noqa: E402,F401
from . import rcnn_ops        # noqa: E402,F401
from . import quant_ops       # noqa: E402,F401
from . import sampling_ops    # noqa: E402,F401
from . import match_ops       # noqa: E402,F401
from . import collective_ops  # noqa: E402,F401
