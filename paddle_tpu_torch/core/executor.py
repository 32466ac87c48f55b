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

Sharded state: the walk lays out the persistables a ``dist_attr``
shards (``parallel.sharded.ShardedTensor``), and the scope keeps them
so. Under the walk a sharded parameter's autograd leaves are its parts
(``name@GRAD`` comes out sharded like it), a sharded persistable is
written back as its sharded value, and its fetch is its global value.
A plain run (a Program, or a CompiledProgram without a mesh) reads the
global values of a sharded scope; what it writes goes back whole, and
the next walk cuts it again.

Two dispatch surfaces, as in the JAX package:

- ``run()``: synchronous fluid semantics; fetches come back as numpy
  copies (or tensors with ``return_numpy=False``), and the persistables
  the run wrote land in the Scope;
- ``run_async()``: walks the step's ops (the host's whole share of the
  step) and returns a ``FetchHandle`` at once, while the card works
  through the launches it queued; up to ``async_window`` steps (default
  2) stay in flight. Its feeds are staged in pinned host memory and
  copied with ``non_blocking=True``: a pageable copy would wait for every
  launch already queued, so step k+1's dispatch would wait for step k and
  nothing would overlap. The handle resolves on a CUDA event recorded
  after the step. The port's optimizers update the scope's tensors in
  place (JAX arrays are immutable), so a fetch that aliases a tensor the
  scope holds (a parameter, the LR, ``loss_scaling``) is cloned at
  dispatch, before the next step can overwrite it. An error raised while
  dispatching lands in the handle and re-raises at ``result()`` /
  ``wait()``; a CUDA error surfaces there too, and is sticky: the
  process's CUDA context cannot run another step after it;
- ``run_pipelined()`` drives a feed stream through ``run_async`` with
  ``reader/dataloader.py``'s ``device_prefetch`` (pinned buffers, a copy
  stream, an event the compute stream waits on), yielding results in
  feed order, lagging by the window; ``train_from_dataset()`` /
  ``infer_from_dataset()`` take one step a batch of ``io/dataset.py``'s
  static-shape batches.

``guard=True`` (or ``PADDLE_TPU_GUARD=1``, or a
``robustness.GuardConfig``) computes a NaN/Inf sentinel at the end of
every step, on the device: one ``_foreach_norm`` pass (the largest
magnitude, which a NaN or an Inf propagates into) over the loss, the
parameters' gradients and the float fetches, and ``isfinite`` of the
stacked norms. The vector stays on the device in the step's handle; the
host reads it only where results are observed: ``run()`` raises
``robustness.NonFiniteError`` directly, async steps re-raise it at
``FetchHandle.result()`` / ``wait()`` / ``drain()``. A guarded step's
arithmetic is bitwise the unguarded one's (the sentinel only reads).

One CUDA graph over this fixed-shape step, in place of the host's per-op
launches, is later performance work; it needs the same pinned,
fixed-shape feeds. ``explain()`` and ``static_cost_analysis()`` walk a
step on meta tensors (``observability/compile_insight.py``): nothing
runs, nothing is read or written. Not ported: the compile and recompile
statistics (the port compiles no step).

A Program that ``PipelineOptimizer`` tagged, run through a
``CompiledProgram`` over a mesh with pp > 1, takes the pipelined branch
(the JAX Executor's ``build_pipelined_forward`` branch): the forward runs
as ``parallel/pipeline.py``'s GPipe schedule over microbatches, the loss
is the mean of the microbatches' losses, and the gradients come from
autograd through the schedule. Only the loss, persistables, feeds and
gradients can be fetched there (``ValueError`` otherwise).

A structured control-flow op (``ops/control_flow_ops.py``: ``while``,
``cond_pair``, ``switch``, ``static_rnn``, the beam-search decoder) runs
its sub-blocks' ops through the same ``run_op``, with the run's device,
dp walk and ``live`` set, which holds what the sub-blocks read; a
``print`` op runs even when nothing reads its output
(``SIDE_EFFECT_OPS``).

Random ops draw from a ``torch.Generator`` per op, seeded from
(``program.random_seed``, the executor's step counter, the op's
``op_seed``) as the JAX Executor folds them into its key
(``ops/__init__.py`` ``OpContext.rng``); the streams differ from JAX's.
"""

import collections
import contextlib
import itertools
import os
import time
import weakref

import numpy as np
import torch

from . import framework
from .framework import (BACKWARD_MARKER, Variable, default_main_program,
                        grad_var_name)
from .place import CUDAPlace
from .. import ops as ops_registry
from ..observability import ComponentStats
from ..ops.control_flow_ops import sub_block_reads
from ..parallel.sharded import ShardedTensor


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


def host_array(t):
    """A fetched tensor as a numpy copy on the host. numpy has no bf16:
    a bf16 tensor comes back widened to f32, exactly (the JAX package
    returns an ml_dtypes bf16 array)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return np.array(t.cpu())


def _as_fetch_name(f):
    if isinstance(f, Variable):
        return f.name
    return str(f)


# ops kept for their host-visible side effects even when nothing reads
# their outputs (fluid's Print)
SIDE_EFFECT_OPS = {"print"}


def _slice_ops(block, fetch_names):
    """Backward slice of a block's op list: ops needed for fetches, ops
    that write persistable vars (stat/counter updates keep running), and
    side-effect roots (print)."""
    needed = set(fetch_names)
    keep = []
    for op in reversed(block.ops):
        out_names = set(op.output_names)
        writes_persistable = any(
            (n in block.vars and block.vars[n].persistable)
            for n in out_names)
        if writes_persistable or (out_names & needed) \
                or op.type in SIDE_EFFECT_OPS:
            keep.append(op)
            needed |= set(op.input_names)
    return list(reversed(keep))


def _live_names(program, ops, names):
    """What something reads: `names` (the fetches, the scope's
    persistables, the guard's tensors) and every input of `ops`, with
    what a structured op's sub-blocks read (their own ops' and the op's
    out of them: its attributes name those)."""
    live = set(names)
    for op in ops:
        live.update(op.input_names)
        live.update(sub_block_reads(program, op))
    return live


def _run_ops(program, ops, env, device, is_test, live, walk=None):
    for op in ops:
        ops_registry.run_op(op, env, program, is_test, device, live, walk)


def forward_walk(program, ops, env, device, is_test, live, walk=None):
    """Run `ops` of `program` one by one through ``run_op`` over `env`
    (name -> tensor) without autograd: the step of a Program with no
    backward (``Executor.run``) and the inference walk
    (``inference_walk``)."""
    with torch.no_grad():
        _run_ops(program, ops, env, device, is_test, live, walk)


def inference_walk(program, env, fetch_names, device, is_test=True,
                   rng=(0, 0)):
    """The inference forward of `program`: the ops ``_slice_ops`` keeps
    for `fetch_names`, in test mode, over `env` (the persistables and the
    feeds by name), random ops seeded from `rng` (the (seed, step) pair
    the Executor folds in; (0, 0) as the JAX exporter's ``PRNGKey(0)``).
    Returns the fetch tensors. ``inference/aot.py`` exports it."""
    ops = _slice_ops(program.global_block(), fetch_names)
    env[ops_registry.RNG_KEY] = rng
    live = _live_names(program, ops, list(fetch_names) + [
        v.name for v in program.list_vars() if v.persistable])
    forward_walk(program, ops, env, device, is_test, live)
    return [env[n] for n in fetch_names]


class _Step:
    """What a step of `program` for `fetch_names` walks: the backward
    marker's index (None without one); the ops (all of them with a
    marker, else the forward slice for the fetches); the persistables'
    names; the names the guard watches; and what something reads (a later
    op, a fetch, the scope, the guard; the loss with a marker)."""

    def __init__(self, program, fetch_names, guard=None):
        self.program = program
        self.fetch_names = list(fetch_names)
        gb = program.global_block()
        self.marker_idx = next((i for i, op in enumerate(gb.ops)
                                if op.type == BACKWARD_MARKER), None)
        marker = gb.ops[self.marker_idx] \
            if self.marker_idx is not None else None
        self.ops = gb.ops if marker is not None \
            else _slice_ops(gb, fetch_names)
        self.persist_names = sorted(v.name for v in program.list_vars()
                                    if v.persistable)
        self.guard_names = () if guard is None else guard.candidates(
            marker.attr("loss") if marker is not None else None,
            [grad_var_name(n) for n in marker.attr("params")]
            if marker is not None else [], fetch_names)
        self.live = _live_names(program, self.ops, set(fetch_names)
                                | set(self.persist_names)
                                | set(self.guard_names))
        if marker is not None:
            self.live.add(marker.attr("loss"))


def _walk_step(step, env, device, walk=None, pipe=None):
    """Run `step` (a ``_Step``) over `env` (name -> tensor) on `device`:
    the forward slice under no_grad; or the forward under autograd (through
    the Program's recompute policy, or the pipelined schedule `pipe`), the
    backward and the ops after the marker. ``Executor._dispatch``'s step
    on the card and ``Executor.explain``'s on meta tensors."""
    program = step.program
    is_test = program._is_test
    if step.marker_idx is None:
        forward_walk(program, step.ops, env, device, is_test, step.live,
                     walk)
        return
    gb = program.global_block()

    def run(ops, env=env):
        _run_ops(program, ops, env, device, is_test, step.live, walk)

    post = gb.ops[step.marker_idx + 1:]
    keep = set(step.fetch_names) | set(step.persist_names) \
        | set(step.guard_names)
    for op in post:
        keep.update(op.input_names)
    policy = (getattr(program, "_recompute", None) or {}).get("policy")
    if policy == "everything":      # saves everything: no recompute
        policy = None
    Executor._backward(gb.ops[step.marker_idx], env, run,
                       gb.ops[:step.marker_idx], keep, policy, walk, pipe)
    with torch.no_grad():
        run(post)


def _canon_host(value):
    """The host half of the port's feed policy, on a numpy value: float64
    narrows to float32, as the JAX package's feed boundary does; int64
    ids stay int64 (the port keeps them on the device, where the JAX
    package narrows them to int32)."""
    a = np.asarray(value)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return a


def _feed_tensor(value, device, pinned=False):
    """A feed value -> a tensor on `device`, under the port's feed policy
    (`_canon_host`; a float64 tensor narrows too). With `pinned` a host
    value bound for CUDA is staged in pinned memory and copied with
    ``non_blocking=True``: the copy is queued on the stream, and the host
    does not wait for the launches queued before it."""
    if isinstance(value, torch.Tensor):
        t = value.float() if value.dtype == torch.float64 else value
        return t.to(device)
    t = torch.from_numpy(np.array(_canon_host(value), copy=True))
    if pinned and device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _canon_feeds(feed, device, pinned=False):
    """Canonicalize a whole feed dict. The same host object fed under
    several names (tied inputs, a shared mask) is canonicalized and
    uploaded once: every name resolves to the same tensor."""
    out, seen = {}, {}
    for k, v in feed.items():
        hit = seen.get(id(v))
        if hit is not None and hit[0] is v:
            out[k] = out[hit[1]]
            continue
        seen[id(v)] = (v, k)
        out[k] = _feed_tensor(v, device, pinned)
    return out


def _guard_vector(env, names):
    """The NaN/Inf sentinel on the device: (flags, names) where flags[i]
    is True when every element of the tensor under names[i] is finite. One
    ``_foreach_norm`` pass with ord inf over the monitored float tensors
    (a NaN or an Inf anywhere makes a tensor's largest magnitude non-
    finite; an overflow cannot) and ``isfinite`` of the stacked norms: a
    few launches a step, not two reductions a tensor. A dp-sharded value,
    or a sharded persistable or gradient, contributes each part it holds
    under its name (``_dispatch`` ANDs a world's flags over its ranks)."""
    tensors, owners = [], []
    for n in names:
        v = env.get(n)
        parts = v.parts if isinstance(v, (ops_registry.Sharded,
                                          ShardedTensor)) else (v,)
        for t in parts:
            if isinstance(t, torch.Tensor) and t.is_floating_point():
                tensors.append(t.detach())
                owners.append(n)
    if not tensors:
        return None, ()
    norms = torch._foreach_norm(tensors, ord=float("inf"))
    if len({t.dtype for t in norms}) > 1:
        norms = [t.float() for t in norms]
    return torch.isfinite(torch.stack(norms)), tuple(owners)


_EXECUTOR_SEQ = itertools.count()


class FetchHandle:
    """Future for one in-flight `Executor.run_async` step.

    The step's launches were queued when the handle was created; a CUDA
    event recorded after them says when they finished, while the host
    keeps running. `result()` blocks until this step's fetches are ready
    and returns them (numpy by default, matching `exe.run`); `wait()`
    blocks without converting. An exception — raised at dispatch (bad
    feed, unknown fetch) or surfaced by the device when the step ran —
    re-raises HERE, at resolution, not inside the dispatching
    `run_async` call. Handles resolve independently and in any order;
    each carries exactly the fetches of its own step (a fetch that
    aliased the scope's state was cloned at dispatch).
    """

    __slots__ = ("_exe", "_fetches", "_error", "_finished", "step",
                 "_guard", "_event")

    def __init__(self, exe, step, fetches=None, error=None, guard=None,
                 event=None):
        self._exe = exe
        self.step = step            # executor-wide async sequence number
        self._fetches = fetches
        self._error = error
        self._finished = error is not None
        self._guard = guard         # (flags, names, step_id) on the device
        self._event = event         # CUDA event after the step, or None

    def done(self):
        """True once the step's launches finished (never blocks; a CPU
        step is done when its dispatch returns)."""
        if self._finished or self._event is None:
            return True
        return self._event.query()

    def wait(self):
        """Block until the step completed; re-raise its error if it
        failed. Retires the handle from the executor's in-flight
        window. Idempotent — a failed handle re-raises every time."""
        if not self._finished:
            t0 = time.perf_counter()
            try:
                if self._event is not None:
                    self._event.synchronize()
            except Exception as e:      # device-side failure surfaces here
                self._error = e
                self._exe._stats.count("executor.async.errors")
            else:
                if self._guard is not None:
                    # the sentinel's flags were computed on the device
                    # with the step; the host reads them HERE (and at
                    # result()/drain()), never inside dispatch
                    g, self._guard = self._guard, None
                    try:
                        self._exe._check_guard(g)
                    except Exception as e:
                        self._error = e
            self._finished = True
            self._event = None
            self._exe._stats.observe("executor.async.host_sync_wait_ms",
                                     (time.perf_counter() - t0) * 1e3)
            self._exe._retire(self)
        if self._error is not None:
            raise self._error
        return self

    def result(self, return_numpy=True):
        """Blocking resolution to the step's fetch list (exe.run's
        return shape): numpy copies by default, the tensors with
        return_numpy=False."""
        self.wait()
        with self._exe._stats.span("executor.fetch",
                                   "executor.span.fetch_ms"):
            if return_numpy:
                return [host_array(f) for f in self._fetches]
            return list(self._fetches)


class Executor:
    """Parity: fluid.Executor. `place` selects the torch device the ops
    run on: None means the card (``CUDAPlace(0)``), which raises without
    CUDA; tests pass ``CPUPlace()``. `async_window` (default 2, or
    ``PADDLE_TPU_ASYNC_WINDOW``) bounds the steps ``run_async`` keeps in
    flight; `guard` turns the NaN/Inf sentinel on for the executor's
    lifetime (see the module's docstring)."""

    def __init__(self, place=None, async_window=None, guard=None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.torch_device()
        self._step_counter = 0
        self.async_window = int(
            async_window if async_window is not None
            else os.environ.get("PADDLE_TPU_ASYNC_WINDOW", 2))
        self._inflight = collections.deque()
        self._async_seq = 0
        from ..robustness.guard import GuardConfig
        self._guard = GuardConfig.resolve(
            guard if guard is not None
            else os.environ.get("PADDLE_TPU_GUARD"))
        self._exe_id = f"exe{next(_EXECUTOR_SEQ)}"
        self._stats = ComponentStats(gauge_labels={"executor": self._exe_id})
        self._telemetry_server = None   # serve_metrics() mount
        # (program, feed shapes and dtypes, fetch names, a weak reference
        # to the scope) of the latest step, for static_cost_analysis()
        self._last_step = None

    # -- the synchronous and asynchronous surfaces -----------------------
    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        """Run `program` (a Program or a CompiledProgram) once: feed ->
        ops -> fetches. Returns the fetches as numpy copies (tensors with
        return_numpy=False). A guarded step raises NonFiniteError before
        any fetch is converted."""
        t0 = time.perf_counter()
        fetches, guard = self._dispatch(program, feed, fetch_list, scope)
        self._check_guard(guard)
        with self._stats.span("executor.fetch", "executor.span.fetch_ms"):
            if return_numpy:
                out = [host_array(f) for f in fetches]
            else:
                out = [f.detach() for f in fetches]
        self._stats.observe("executor.step_ms",
                            (time.perf_counter() - t0) * 1e3)
        return out

    def run_async(self, program=None, feed=None, fetch_list=None,
                  scope=None, window=None, bucketer=None):
        """Non-blocking run(): dispatch the step and return a
        FetchHandle.

        At most `window` (default: self.async_window) steps stay in
        flight; when the window is full this call first blocks on the
        OLDEST outstanding step. Errors (a bad feed, an unknown fetch, a
        device-side failure) are captured into the returned handle and
        re-raised at its result()/wait(), keeping dispatch order == feed
        order even through a failed step. `bucketer` (a
        core.bucketing.FeedBucketer) pads the feed before dispatch, so a
        dynamic-batch loop sees O(log n) feed shapes.

        State semantics match run(): the scope's persistables hold the
        step's results when this returns (their values materialize on
        the card's stream), so back-to-back dispatches chain on the
        device. A data-parallel CompiledProgram is refused, as in the
        JAX package: its walk places feeds and state synchronously."""
        win = max(1, int(self.async_window if window is None else window))
        if getattr(program, "_data_parallel", False):
            raise NotImplementedError(
                "run_async does not take a data-parallel CompiledProgram "
                "— the dp walk splits feeds and sums gradients "
                "synchronously; use run()")
        program = getattr(program, "program", program)   # CompiledProgram
        while len(self._inflight) >= win:
            self._stats.count("executor.async.window_waits")
            self._wait_oldest()
        t0 = time.perf_counter()
        step = self._async_seq
        self._async_seq += 1
        try:
            if bucketer is not None:
                feed = bucketer.bucket(feed or {})
            fetches, guard = self._dispatch(program, feed, fetch_list,
                                            scope, in_flight=True)
        except Exception as e:
            # the step never reached the device: deliver the error
            # through the handle (the CALLER of result() owns failure
            # handling, not whatever loop happened to dispatch)
            self._stats.count("executor.async.errors")
            return FetchHandle(self, step, error=e)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        handle = FetchHandle(self, step, fetches, guard=guard, event=event)
        self._inflight.append(handle)
        self._update_inflight_gauge()
        self._stats.count("executor.async.dispatches")
        self._stats.observe("executor.async.dispatch_ms",
                            (time.perf_counter() - t0) * 1e3)
        return handle

    def run_pipelined(self, program=None, feed_iter=None, fetch_list=None,
                      scope=None, window=None, prefetch_depth=2,
                      bucketer=None, return_numpy=True, copy_events=None):
        """Drive a whole feed stream through the async pipeline,
        yielding one resolved fetch list per feed, in feed order.

        Three overlapped stages:
          host:   the port's feed policy (float64 -> float32, as run()
                  applies it) and optional FeedBucketer padding,
          copy:   reader.dataloader.device_prefetch — the NEXT batches
                  are staged in pinned memory and copied on a copy
                  stream while the current step computes,
          device: run_async's bounded in-flight window.
        Results lag dispatch by `window` steps; the generator drains the
        window at stream end. A step's error raises at ITS yield point.
        `copy_events` is device_prefetch's (a list of each copy's CUDA
        start and end events)."""
        from ..reader.dataloader import device_prefetch
        win = max(1, int(self.async_window if window is None else window))

        def canon(feed):
            # the feed policy must hold on THIS path too, before the
            # upload: run() applies it to host values, and the tensors
            # device_prefetch hands over are taken as they are
            return {k: _canon_host(v) if not isinstance(v, torch.Tensor)
                    else v for k, v in feed.items()}

        if bucketer is not None:
            def transform(feed, _b=bucketer.bucket):
                return canon(_b(feed))
        else:
            transform = canon
        pending = collections.deque()
        for feed in device_prefetch(feed_iter, depth=prefetch_depth,
                                    device=self.device,
                                    transform=transform,
                                    copy_events=copy_events):
            pending.append(self.run_async(
                program, feed=feed, fetch_list=fetch_list, scope=scope,
                window=win))
            if len(pending) > win:
                yield pending.popleft().result(return_numpy=return_numpy)
        while pending:
            yield pending.popleft().result(return_numpy=return_numpy)

    # -- the async window --------------------------------------------------
    def _update_inflight_gauge(self):
        self._stats.set_gauge("executor.async.inflight",
                              len(self._inflight))

    def _retire(self, handle):
        """Drop a finished handle from the in-flight window (called by
        FetchHandle.wait; resolution order is the caller's choice)."""
        try:
            self._inflight.remove(handle)
        except ValueError:
            return                      # already retired (drain raced)
        self._update_inflight_gauge()

    def _wait_oldest(self):
        """Window admission: block on the OLDEST in-flight step. An
        error it captured stays in ITS handle (re-raised at that
        handle's result()), never in the step being admitted."""
        h = self._inflight[0]
        try:
            h.wait()
        except Exception:
            pass
        if self._inflight and self._inflight[0] is h:
            self._inflight.popleft()
            self._update_inflight_gauge()

    def drain(self, raise_errors=True):
        """Block until every in-flight async step has completed (FIFO).
        The first captured error re-raises AFTER the pipeline is empty
        (raise_errors=False keeps it in its handle instead — close()'s
        mode)."""
        first_err = None
        while self._inflight:
            h = self._inflight[0]
            try:
                h.wait()
            except Exception as e:
                if first_err is None:
                    first_err = e
            if self._inflight and self._inflight[0] is h:
                self._inflight.popleft()
                self._update_inflight_gauge()
        if first_err is not None and raise_errors:
            raise first_err

    def close(self):
        """Drain the window (errors stay in their handles), drop this
        executor's gauges from the process-wide registry and close its
        telemetry endpoint. Handles dispatched before still resolve."""
        self.drain(raise_errors=False)
        self._stats.drop_gauges("executor.async.inflight")
        if self._telemetry_server is not None:
            self._telemetry_server.close()
            self._telemetry_server = None

    # -- NaN/Inf sentinel --------------------------------------------------
    def _check_guard(self, guard):
        """Host half of the sentinel: `guard` is (flags, names, step_id)
        from a guarded step, flags[i] the all-isfinite of names[i]. The
        copy to the host is a small sync where the caller observes
        results anyway."""
        if guard is None:
            return
        flags, names, step_id = guard
        self._stats.count("executor.fault.guard_steps")
        flags = flags.cpu().numpy()
        if not flags.all():
            bad = list(dict.fromkeys(names[i]
                                     for i in np.nonzero(~flags)[0]))
            self._stats.count("executor.fault.nonfinite")
            from ..robustness.guard import NonFiniteError
            raise NonFiniteError(bad[0], step_id, bad)

    # -- observability -----------------------------------------------------
    def serve_metrics(self, port=0, host=None):
        """Mount the stdlib telemetry endpoint (/metrics Prometheus
        exposition of the process-wide registry, /healthz with this
        executor's vitals). Binds loopback by default; idempotent while
        a mount is live, but an explicit port/host that differs from the
        live mount raises; closed with the executor."""
        from ..observability.exporter import (check_remount,
                                              serve_metrics as _serve)
        if self._telemetry_server is not None and \
                not self._telemetry_server.closed:
            check_remount(self._telemetry_server, port, host)
            return self._telemetry_server

        def _health():
            s = self.get_stats()
            return {"executor": s["executor"], "steps": s["steps"],
                    "inflight": s["async"]["inflight"],
                    "guarded": s["fault"]["guarded"]}

        self._telemetry_server = _serve(port=port,
                                        host=host or "127.0.0.1",
                                        health_fn=_health)
        return self._telemetry_server

    def get_stats(self):
        """Structured snapshot of this executor's counters and span
        histograms: the JAX package's keys but for its compile caches
        (the port compiles no step). Cheap; safe to call every step."""
        local = self._stats.local

        def c(name):
            m = local.get(name)
            return int(m.value()) if m is not None else 0

        def h(name):
            m = local.get(name)
            return m.summary() if m is not None else \
                {"count": 0, "sum": 0.0, "min": None, "max": None,
                 "avg": 0.0}

        return {
            "executor": self._exe_id,
            "steps": c("executor.steps"),
            "step_ms": h("executor.step_ms"),
            "spans": {k: h(f"executor.span.{k}_ms")
                      for k in ("execute", "fetch")},
            "fault": {"guard_steps": c("executor.fault.guard_steps"),
                      "nonfinite": c("executor.fault.nonfinite"),
                      "guarded": self._guard is not None},
            "async": {"dispatches": c("executor.async.dispatches"),
                      "errors": c("executor.async.errors"),
                      "window_waits": c("executor.async.window_waits"),
                      "inflight": len(self._inflight),
                      "window": self.async_window,
                      "dispatch_ms": h("executor.async.dispatch_ms"),
                      "host_sync_wait_ms":
                          h("executor.async.host_sync_wait_ms")},
        }

    def reset_stats(self):
        """Zero this executor's local counters/histograms (the process-
        wide registry keeps its cumulative totals)."""
        self._stats.reset()

    # -- the static cost report (compile_insight) -------------------------
    def _meta_step(self, step):
        """fn(state, feeds) -> fetches: `step` (a ``_Step`` of a plain
        Program) walked by ``_walk_step``, as ``_dispatch`` walks it without
        a mesh, over the meta tensors ``compile_insight.analyze_step``
        passes. The step counter does not move."""
        program, fetch_names = step.program, step.fetch_names
        rng = (program.random_seed or framework.default_seed(),
               self._step_counter)

        def fn(state, feeds):
            env = dict(state)
            env.update(feeds)
            env[ops_registry.RNG_KEY] = rng
            _walk_step(step, env, torch.device("meta"))
            return [env[f] for f in fetch_names]

        return fn

    def _explain_args(self, program, feed, scope):
        """(state, feeds) of a step: the scope's persistables (read for
        their shapes and dtypes only) and the feeds as meta tensors under
        the port's feed policy (nothing goes to the device)."""
        from ..observability.compile_insight import to_meta
        state = {}
        for v in program.list_vars():
            t = scope.get(v.name) if v.persistable else None
            if isinstance(t, ShardedTensor):
                raise NotImplementedError(
                    f"explain() reads a plain scope: '{v.name}' is "
                    f"sharded (run the CompiledProgram's walk instead)")
            if t is not None:
                state[v.name] = t
        feeds = {}
        for k, v in (feed or {}).items():
            if isinstance(v, torch.Tensor):
                t = v.float() if v.dtype == torch.float64 else v
                feeds[k] = to_meta(t)
            else:
                feeds[k] = torch.from_numpy(
                    np.ascontiguousarray(_canon_host(v))).to("meta")
        return state, feeds

    def static_cost_analysis(self):
        """Backend-independent cost of the most recent step, walked on
        meta tensors (``compile_insight.analyze_step``): {'flops',
        'per_primitive', 'intermediate_bytes', 'out_bytes', 'eqns'}. The
        JAX Executor's cross-check column beside XLA's cost model; the
        port has only this column."""
        if self._last_step is None:
            raise RuntimeError("no program has been run yet")
        from ..observability.compile_insight import analyze_step
        program, feed, fetch_names, scope = self._last_step
        scope = scope()
        if scope is None:
            raise RuntimeError("the scope of the last step is gone")
        state, feeds = self._explain_args(program, {
            k: torch.empty(shape, dtype=dtype, device="meta")
            for k, (shape, dtype) in feed.items()}, scope)
        return analyze_step(
            self._meta_step(_Step(program, fetch_names, self._guard)),
            state, feeds)

    def explain(self, program=None, feed=None, fetch_list=None,
                scope=None, backend=None):
        """The compile-plane report for (program, feed): FLOPs, bytes
        accessed, peak device memory, per-aten-op and per-op-type
        attribution, parameter vs optimizer-state bytes
        (``compile_insight.explain_entry``).

        Read-free: the step is walked on meta tensors, so no step runs,
        the step counter does not move and no scope tensor is read or
        written. `backend=None` and `backend=False` give the static
        report; `backend=True` raises (the port compiles nothing, so no
        backend reports a cost). ``compile_ms`` is None and
        ``recompiles`` empty for the same reason. The report's peak
        estimate is upserted into the process-wide HBM ledger (kind
        ``peak_hbm``), as the JAX Executor does."""
        from ..observability import compile_insight as _ci
        program = program if program is not None else default_main_program()
        if getattr(program, "_data_parallel", False):
            raise NotImplementedError(
                "explain() takes a plain Program — the data-parallel "
                "CompiledProgram path places state per-mesh at run time")
        program = getattr(program, "program", program)  # CompiledProgram
        scope = scope if scope is not None else global_scope()
        fetch_names = [_as_fetch_name(f) for f in (fetch_list or [])]
        state, feeds = self._explain_args(program, feed, scope)
        step = _Step(program, fetch_names, self._guard)
        self._validate(program, step.ops, feeds, fetch_names)
        labels = {"program": f"program_{id(program):x}",
                  "shapes": ";".join(
                      f"{k}:{'x'.join(map(str, v.shape)) or 'scalar'}:"
                      f"{str(v.dtype).replace('torch.', '')}"
                      for k, v in sorted(feeds.items()))[:160]
                  or "nofeeds"}
        report = _ci.explain_entry(
            self._meta_step(step), (state, feeds),
            program=program, state=state, feeds=feeds, labels=labels,
            backend=backend, device=self.device)
        report["executor"] = self._exe_id
        report["fetches"] = list(fetch_names)
        report["compile_ms"] = None
        report["recompiles"] = []
        _ci.hbm_ledger().register(
            self._exe_id, f"{labels['program']}/{labels['shapes']}/peak",
            "peak_hbm", report["peak_hbm_bytes"],
            detail={"source": report["source"]["peak_hbm"]})
        return report

    # -- the dataset plane -------------------------------------------------
    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        """Consume every sample in `dataset`, one optimizer step per
        batch. Parity: fluid.Executor.train_from_dataset
        (executor.py:894). The reference spawns `thread` HogwildWorkers
        each interpreting the op list against a feed queue; here the
        threads go to the native file PARSER (csrc/dataset_feed.cc),
        and the host loop hands static-shape batches to the device
        through device_prefetch (pinned buffers, a copy stream)."""
        return self._run_from_dataset(program, dataset, scope, thread,
                                      debug, fetch_list, fetch_info,
                                      print_period)

    def infer_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        """Parity: fluid.Executor.infer_from_dataset (executor.py:817).
        Same loop as train_from_dataset; the program decides whether
        anything trains (pass a clone(for_test=True) / optimizer-free
        program, as the reference's examples do)."""
        return self._run_from_dataset(program, dataset, scope, thread,
                                      debug, fetch_list, fetch_info,
                                      print_period)

    def _run_from_dataset(self, program, dataset, scope, thread, debug,
                          fetch_list, fetch_info, print_period):
        if dataset is None:
            raise RuntimeError("dataset is need and should be initialized")
        program = program if program is not None else default_main_program()
        scope = scope if scope is not None else global_scope()
        dataset._prepare_to_run()
        # reference executor.py _prepare_trainer: an explicit thread > 0
        # overrides dataset.thread_num
        nthread = thread if thread > 0 else dataset.thread_num
        names = [f if isinstance(f, str) else f.name
                 for f in (fetch_list or [])]
        infos = list(fetch_info) if fetch_info else names
        step = 0
        t0 = time.perf_counter()
        gb = getattr(program, "program", program).global_block()
        drop = None        # loop-invariant: batch key sets are identical

        def batches():
            nonlocal drop
            for feed in dataset._iter_batches(nthread):
                # drop feed entries the program doesn't declare (e.g. the
                # auto-emitted <name>_seq_len when the program skips it)
                if drop is None:
                    drop = {k for k in feed if not gb.has_var(k)}
                if drop:
                    feed = {k: v for k, v in feed.items()
                            if k not in drop}
                yield feed

        from ..reader.dataloader import device_prefetch
        for feed in device_prefetch(batches(), depth=2, device=self.device,
                                    transform=lambda f: {
                                        k: _canon_host(v)
                                        for k, v in f.items()}):
            out = self.run(program, feed=feed, fetch_list=fetch_list,
                           scope=scope)
            step += 1
            if names and step % print_period == 0:
                msgs = [f"{info}: {np.asarray(v).ravel()[:8]}"
                        for info, v in zip(infos, out)]
                print(f"step {step}: " + ", ".join(msgs))
            if debug:
                dt = (time.perf_counter() - t0) / step
                print(f"step {step}: avg {dt * 1e3:.2f} ms/batch")
        dataset._finish_to_run()
        return None

    # -- one step ----------------------------------------------------------
    def _dispatch(self, program, feed, fetch_list, scope, in_flight=False):
        """The shared front half of run()/run_async(): walk the step's
        ops, write the persistables into the scope, and compute the
        guard's flags on the device. Returns (fetches, guard): the
        fetch tensors, and (flags, names, step_id) for _check_guard
        (None unguarded). With `in_flight` the feeds go through pinned
        memory and every fetch that aliases a tensor the scope holds is
        cloned (a later step updates that tensor in place)."""
        program = program if program is not None else default_main_program()
        walk = None
        if not isinstance(program, framework.Program):
            from .compiler import CompiledProgram
            if isinstance(program, CompiledProgram):
                walk = program._walk(self.device)
                program = program.program
        scope = scope if scope is not None else global_scope()
        fetch_names = [_as_fetch_name(f) for f in (fetch_list or [])]
        step = _Step(program, fetch_names, self._guard)
        feeds = _canon_feeds(feed or {}, self.device, pinned=in_flight)
        self._validate(program, step.ops, feeds, fetch_names)
        # the step's feeds as (shape, dtype) and a weak reference to its
        # scope: static_cost_analysis() reads no more than their metadata
        self._last_step = (program, {k: (tuple(v.shape), v.dtype)
                                     for k, v in feeds.items()},
                           fetch_names, weakref.ref(scope))
        if walk is not None:
            walk.place_state(program, scope)
            feeds = walk.split_feeds(feeds)

        persist_names = step.persist_names
        env = {n: scope.get(n) for n in persist_names
               if scope.get(n) is not None}
        # a plain run reads a sharded scope's global values; what it
        # leaves unchanged keeps its layout in the scope
        whole = {} if walk is not None else {
            n: v.full() for n, v in env.items()
            if isinstance(v, ShardedTensor)}
        versions = {n: t._version for n, t in whole.items()}
        env.update(whole)
        env.update(feeds)
        seed = program.random_seed or framework.default_seed()
        step_id = self._step_counter    # what the RNG folds in; what a
        #                                 NonFiniteError reports
        env[ops_registry.RNG_KEY] = (seed, step_id)
        self._step_counter += 1
        pipe = None
        if walk is not None and walk.pipelined \
                and step.marker_idx is not None:
            pipe = self._pipelined(program, step.marker_idx, fetch_names,
                                   persist_names, feeds, walk, step.live,
                                   program._is_test)
        with self._stats.span("executor.execute",
                              "executor.span.execute_ms"), \
                (walk.active() if walk is not None
                 else contextlib.nullcontext()):
            _walk_step(step, env, self.device, walk, pipe)

        for n in persist_names:
            if n in env:
                v = env[n]
                if isinstance(v, ops_registry.Sharded):
                    raise NotImplementedError(
                        f"persistable '{n}' came out dp-sharded: the dp "
                        f"walk lays state out by its dist_attr, never by "
                        f"the batch's rows")
                if v is whole.get(n) and v._version == versions[n]:
                    continue
                scope.set(n, v)
        self._stats.count("executor.steps")
        guard = None
        if self._guard is not None:
            flags, owners = _guard_vector(env, step.guard_names)
            if owners and walk is not None:
                # a world rank reads only its blocks: every rank trips
                # when any rank's block is non-finite
                flags = walk.mesh.all_min(flags, walk.axes)
            if owners:      # a step with nothing to watch is unguarded
                guard = (flags, owners, step_id)
        fetches = [env[f] for f in fetch_names]
        if walk is not None:
            fetches = [walk.fetch(f) for f in fetches]
        if in_flight:
            state = {t.untyped_storage().data_ptr()
                     for t in (scope.get(n) for n in persist_names)
                     if isinstance(t, torch.Tensor)}
            fetches = [f.detach().clone()
                       if f.untyped_storage().data_ptr() in state
                       else f.detach() for f in fetches]
        return fetches, guard

    def _pipelined(self, program, marker_idx, fetch_names, persist_names,
                   feeds, walk, live, is_test):
        """The pipelined forward of `program` over the walk's pp axis:
        fn(env) -> (objective, mean loss) (``parallel/pipeline.py``)."""
        from ..parallel.pipeline import (build_pipelined_forward,
                                         check_fetches)
        gb = program.global_block()
        loss_name = gb.ops[marker_idx].attr("loss")
        check_fetches(program, fetch_names, loss_name, persist_names)
        fwd = build_pipelined_forward(
            program, marker_idx, program._pipeline, walk.mesh, loss_name,
            is_test=is_test, device=self.device, live=live, walk=walk)
        names = list(feeds)
        return lambda env: fwd(env, {n: env[n] for n in names})

    @staticmethod
    def _backward(marker, env, run, ops, keep, policy=None, walk=None,
                  pipe=None):
        """The forward `ops` under autograd with the marker's parameters
        as leaves, in a copy of `env`. Of its results, those named in
        `keep` land in `env`, and the gradients as name@GRAD (zeros for a
        parameter the loss does not reach); the parameters stay the
        scope's tensors, for the optimizer's in-place updates. With a
        recompute `policy` the forward runs through
        ``run_checkpointed``, with `pipe` through the pipelined schedule
        (``Executor._pipelined``); under the dp walk the loss may be
        sharded and a world sums the gradients over dp. A sharded
        parameter's leaves are its parts, and its gradient a
        ShardedTensor of theirs."""
        names = [n for n in marker.attr("params") if n in env]
        loss_name = marker.attr("loss")
        leaves = [_leaf(env[n]) for n in names]
        fwd = dict(env)
        fwd.update(zip(names, leaves))
        with torch.enable_grad():
            if pipe is not None:
                loss, fwd[loss_name] = pipe(fwd)
            elif policy is None:
                run(ops, fwd)
            else:
                from ..optimizer.recompute import run_checkpointed
                run_checkpointed(ops, fwd, run, keep | {loss_name}, policy)
            if pipe is None:
                loss = (fwd[loss_name].sum() if walk is None
                        else walk.loss(fwd[loss_name]))
            env.update((k, v) for k, v in fwd.items()
                       if k in keep and k not in names)
            # what nothing reads goes before the backward, which then
            # frees the activations as it consumes them
            del fwd
            flat = [t for leaf in leaves for t in _parts(leaf)]
            flat_grads = torch.autograd.grad(loss, flat, allow_unused=True)
        flat_grads = iter([torch.zeros_like(t) if g is None else g
                           for t, g in zip(flat, flat_grads)])
        grads = [leaf.like([next(flat_grads) for _ in leaf.parts])
                 if isinstance(leaf, ShardedTensor) else next(flat_grads)
                 for leaf in leaves]
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


def _leaf(value):
    """An autograd leaf of a parameter's value: a tensor, or a sharded
    value over leaf parts."""
    if isinstance(value, ShardedTensor):
        return value.like([p.detach().requires_grad_(True)
                           for p in value.parts])
    return value.detach().requires_grad_(True)


def _parts(value):
    return value.parts if isinstance(value, ShardedTensor) else (value,)


# Convenience mirroring fluid.executor._run helpers -------------------------

def run_startup(startup_program=None, scope=None, place=None):
    from .framework import default_startup_program
    exe = Executor(place)
    exe.run(startup_program or default_startup_program(), scope=scope)
    return exe
