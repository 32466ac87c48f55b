"""Executor & Scope.

Parity: python/paddle/fluid/executor.py + paddle/fluid/framework/executor.cc;
the counterpart of ``paddle_tpu/core/executor.py``.

The JAX Executor traces the whole Program (forward + ``jax.value_and_grad``
+ optimizer updates) into one jitted step per (program, feed signature).
The port's Executor walks the Program eagerly, op by op, on one torch
device, and eager autograd takes the place of the traced
``value_and_grad``:

- without a backward marker, the ops needed for the fetches (and those
  that write persistables) run under ``torch.no_grad()``;
- with one, the ops before the marker run with the marker's parameters as
  leaves that require grad, ``torch.autograd.grad`` of the summed loss
  fills ``name@GRAD``, and the ops after the marker (the optimizer) run
  under ``torch.no_grad()`` and update the scope's tensors in place. Of
  the forward's results only those read later (by the ops after the
  marker, a fetch or the scope) stay in the env, as the JAX Executor
  returns only those from its ``value_and_grad``; a program that
  ``RecomputeOptimizer`` tagged runs its forward through
  ``optimizer/recompute.py``'s ``run_checkpointed`` with the tag's
  policy (the JAX Executor's ``jax.checkpoint``).

``run`` also takes a ``CompiledProgram`` (``core/compiler.py``): one that
is not data parallel runs its Program on this path; a data-parallel one
runs the dp walk there, the same walk with the feeds split over the
mesh's dp ranks, each op dispatched through its dp rule and, in a
``torch.distributed`` world, the gradients summed over dp before the
ops after the marker. A recompute tag applies there too: each
checkpointed segment runs its ops through the walk, every held rank's,
and re-runs them (their dp collectives included, in the same order on
every rank) when the backward reaches it.

Every run is synchronous: fetches come back as numpy copies (or tensors
with ``return_numpy=False``), and the persistables the run wrote land in
the Scope. One CUDA graph over this fixed-shape step, in place of the
host's per-op launches, is later performance work, not part of this
slice. Not ported yet: ``run_async``, ``run_pipelined``, ``FetchHandle``,
the NaN/Inf guard, ``explain`` and cost analysis, the compile and
recompile statistics, the pipeline, and ``train_from_dataset``.

Random ops draw from a ``torch.Generator`` per op, seeded from
(``program.random_seed``, the executor's step counter, the op's
``op_seed``) as the JAX Executor folds them into its key
(``ops/__init__.py`` ``OpContext.rng``); the streams differ from JAX's.
"""

import contextlib

import numpy as np
import torch

from . import framework
from .framework import (BACKWARD_MARKER, Variable, default_main_program,
                        grad_var_name)
from .place import CUDAPlace
from .. import ops as ops_registry


class Scope:
    """Name -> tensor store for persistable variables.

    Parity: paddle/fluid/framework/scope.h. Flat (no kid scopes): only
    persistables live here."""

    def __init__(self):
        self._vars = {}

    def find_var(self, name):
        return self._vars.get(name)

    def set(self, name, value):
        self._vars[name] = value

    def get(self, name, default=None):
        return self._vars.get(name, default)

    def __contains__(self, name):
        return name in self._vars

    def names(self):
        return list(self._vars)


_global_scope = Scope()


def global_scope():
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    global _global_scope
    old = _global_scope
    _global_scope = scope
    try:
        yield
    finally:
        _global_scope = old


def scope_from_numpy(arrays, device, scope=None):
    """Carry a scope of the JAX package ({name: array}, values as numpy
    arrays or anything np.asarray takes) into the port: each value becomes
    a tensor on `device`, set into `scope` (a new Scope by default), which
    is returned. The weight carry-over of the tests' twins."""
    scope = Scope() if scope is None else scope
    for name, value in arrays.items():
        scope.set(name, torch.from_numpy(np.array(value, copy=True)).to(
            device))
    return scope


def _as_fetch_name(f):
    if isinstance(f, Variable):
        return f.name
    return str(f)


def _slice_ops(block, fetch_names):
    """Backward slice of a block's op list: ops needed for fetches and ops
    that write persistable vars (stat/counter updates keep running)."""
    needed = set(fetch_names)
    keep = []
    for op in reversed(block.ops):
        out_names = set(op.output_names)
        writes_persistable = any(
            (n in block.vars and block.vars[n].persistable)
            for n in out_names)
        if writes_persistable or (out_names & needed):
            keep.append(op)
            needed |= set(op.input_names)
    return list(reversed(keep))


def _feed_tensor(value, device):
    """A feed value -> a tensor on `device`. float64 narrows to float32, as
    the JAX package's feed boundary does; int64 ids stay int64 (the port
    keeps them on the device)."""
    if isinstance(value, torch.Tensor):
        t = value
    else:
        t = torch.from_numpy(np.array(value, copy=True))
    if t.dtype == torch.float64:
        t = t.float()
    return t.to(device)


class Executor:
    """Parity: fluid.Executor. `place` selects the torch device the ops
    run on: None means the card (``CUDAPlace(0)``), which raises without
    CUDA; tests pass ``CPUPlace()``."""

    def __init__(self, place=None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.torch_device()
        self._step_counter = 0

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        """Run `program` (a Program or a CompiledProgram) once: feed ->
        ops -> fetches. Returns the fetches as numpy copies (tensors with
        return_numpy=False)."""
        program = program if program is not None else default_main_program()
        walk = None
        if not isinstance(program, framework.Program):
            from .compiler import CompiledProgram
            if isinstance(program, CompiledProgram):
                walk = program._walk(self.device)
                program = program.program
        scope = scope if scope is not None else global_scope()
        fetch_names = [_as_fetch_name(f) for f in (fetch_list or [])]
        gb = program.global_block()
        marker_idx = next((i for i, op in enumerate(gb.ops)
                           if op.type == BACKWARD_MARKER), None)
        run_ops = gb.ops if marker_idx is not None \
            else _slice_ops(gb, fetch_names)
        feeds = {k: _feed_tensor(v, self.device)
                 for k, v in (feed or {}).items()}
        self._validate(program, run_ops, feeds, fetch_names)
        if walk is not None:
            walk.check_state(program)
            feeds = walk.split_feeds(feeds)

        persist_names = sorted(v.name for v in program.list_vars()
                               if v.persistable)
        env = {n: scope.get(n) for n in persist_names
               if scope.get(n) is not None}
        env.update(feeds)
        seed = program.random_seed or framework.default_seed()
        env[ops_registry.RNG_KEY] = (seed, self._step_counter)
        self._step_counter += 1
        # what something reads: a later op, a fetch, or the scope
        live = set(fetch_names) | set(persist_names)
        for op in run_ops:
            live.update(op.input_names)
        is_test = program._is_test

        def run(ops, env=env):
            for op in ops:
                ops_registry.run_op(op, env, program, is_test, self.device,
                                    live, walk)

        with (walk.active() if walk is not None
              else contextlib.nullcontext()):
            if marker_idx is None:
                with torch.no_grad():
                    run(run_ops)
            else:
                marker = gb.ops[marker_idx]
                live.add(marker.attr("loss"))
                post = gb.ops[marker_idx + 1:]
                keep = set(fetch_names) | set(persist_names)
                for op in post:
                    keep.update(op.input_names)
                policy = (getattr(program, "_recompute", None) or {}).get(
                    "policy")
                if policy == "everything":  # saves everything: no recompute
                    policy = None
                self._backward(marker, env, run, gb.ops[:marker_idx], keep,
                               policy, walk)
                with torch.no_grad():
                    run(post)

        for n in persist_names:
            if n in env:
                if isinstance(env[n], ops_registry.Sharded):
                    raise NotImplementedError(
                        f"persistable '{n}' came out dp-sharded: the dp "
                        f"walk keeps the state replicated")
                scope.set(n, env[n])
        fetches = [env[f] for f in fetch_names]
        if walk is not None:
            fetches = [walk.fetch(f) for f in fetches]
        if return_numpy:
            return [np.array(f.detach().cpu()) for f in fetches]
        return [f.detach() for f in fetches]

    @staticmethod
    def _backward(marker, env, run, ops, keep, policy=None, walk=None):
        """The forward `ops` under autograd with the marker's parameters
        as leaves, in a copy of `env`. Of its results, those named in
        `keep` land in `env`, and the gradients as name@GRAD (zeros for a
        parameter the loss does not reach); the parameters stay the
        scope's tensors, for the optimizer's in-place updates. With a
        recompute `policy` the forward runs through
        ``run_checkpointed``; under the dp walk the loss may be sharded
        and a world sums the gradients over dp."""
        names = [n for n in marker.attr("params") if n in env]
        loss_name = marker.attr("loss")
        leaves = [env[n].detach().requires_grad_(True) for n in names]
        fwd = dict(env)
        fwd.update(zip(names, leaves))
        with torch.enable_grad():
            if policy is None:
                run(ops, fwd)
            else:
                from ..optimizer.recompute import run_checkpointed
                run_checkpointed(ops, fwd, run, keep | {loss_name}, policy)
            loss = (fwd[loss_name].sum() if walk is None
                    else walk.loss(fwd[loss_name]))
            env.update((k, v) for k, v in fwd.items()
                       if k in keep and k not in names)
            # what nothing reads goes before the backward, which then
            # frees the activations as it consumes them
            del fwd
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(leaf) if g is None else g
                 for leaf, g in zip(leaves, grads)]
        if walk is not None:
            grads = walk.reduce_grads(grads)
        for n, g in zip(names, grads):
            env[grad_var_name(n)] = g

    @staticmethod
    def _validate(program, run_ops, feeds, fetch_names):
        """Friendly errors before any op runs (parity: fluid's
        check_feed_shape_type)."""
        gb = program.global_block()
        for f in fetch_names:
            base = f[:-5] if f.endswith("@GRAD") else f
            if not gb.has_var(base):
                raise ValueError(f"fetch target '{f}' is not a variable of "
                                 f"this program")
        needed = {n for op in run_ops for n in op.input_names}
        for v in program.list_vars():
            if v.is_data and not v.persistable and v.name not in feeds \
                    and v.name in needed:
                raise ValueError(
                    f"feed variable '{v.name}' is required by the program "
                    f"but missing from feed={{...}}")


# Convenience mirroring fluid.executor._run helpers -------------------------

def run_startup(startup_program=None, scope=None, place=None):
    from .framework import default_startup_program
    exe = Executor(place)
    exe.run(startup_program or default_startup_program(), scope=scope)
    return exe
