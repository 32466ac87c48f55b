"""GuardedTrainer: the fault-tolerant training loop.

Drives feeds through the Executor's async window in CHECKPOINT SEGMENTS:
dispatch up to `checkpoint_every` steps (window-pipelined), drain, commit
an atomic checkpoint, repeat. Dispatch never crosses an uncommitted
segment boundary, so a checkpoint always captures exactly the state of
the steps it claims (the in-flight window would otherwise have advanced
the scope past the step being saved).

Fault handling:
- a NonFiniteError surfacing from any handle rolls the scope back to the
  last good checkpoint (CheckpointManager walks past corrupt ones),
  rewinds the executor's RNG step counter, runs the recovery hooks
  (LR backoff / AMP loss-scale reduction), and REPLAYS the segment's
  buffered feeds — bounded by `RecoveryPolicy.max_retries` rollbacks per
  segment, then the fault surfaces;
- checkpoint I/O errors retry with exponential backoff inside the
  manager, then surface as CheckpointError;
- a preemption request (SIGTERM/SIGINT via PreemptionHandler, or the
  chaos injector) drains the window, writes an emergency checkpoint
  through the same atomic path, and returns cleanly with
  `result.preempted`.

Step accounting: steps since the last committed checkpoint are replayed
after a rollback, so `result_callback` delivery is at-least-once within a
segment; checkpoint commits are exactly-once.

The port's own copy of ``paddle_tpu/robustness/trainer.py``. What it does
not recover from, unlike the JAX package on XLA: a CUDA error (an illegal
address, a device-side assert, a launch failure) is sticky, it leaves the
process's CUDA context unusable, so no later step, restore or checkpoint
can run in it. Such an error re-raises from the step's FetchHandle as
the contract says and propagates out of train() untouched; recovery from
it is a new process that calls resume() (the fleet's supervisor does so
for serving). Only NonFiniteError and checkpoint I/O errors are
recovered here. A replay on the card matches the clean run within a
distance, not bitwise: torch's CUDA embedding backward sums in no fixed
order (on the CPU the replay is bitwise).

A segment's commit takes its host snapshot after the window drained
(every handle of the segment resolved), so no step in flight can update
the tensors the checkpoint reads.
"""

import collections
import os
import warnings

import numpy as np
import torch

from ..observability import ComponentStats
from .chaos import CheckpointWriteFault  # noqa: F401  (re-export surface)
from .checkpoint_manager import CheckpointManager
from .guard import NonFiniteError

__all__ = ["GuardedTrainer", "RecoveryPolicy", "TrainResult",
           "lr_backoff"]


def lr_backoff(optimizer_or_name, factor=0.5):
    """Recovery hook: multiply the live learning-rate scope var by
    `factor` on every rollback (the classic divergence response). Takes
    an optimizer (its `_lr_var`) or the LR var name."""

    def hook(scope, fault):
        name = optimizer_or_name
        if not isinstance(name, str):
            lr_var = getattr(optimizer_or_name, "_lr_var", None)
            if lr_var is None:
                return
            name = lr_var.name
        val = scope.get(name)
        if val is not None:
            # a new tensor (the optimizer ops update the old one in
            # place, and a handle in flight may still read it)
            scope.set(name, val * factor if isinstance(val, torch.Tensor)
                      else np.asarray(val) * factor)
    return hook


class RecoveryPolicy:
    """What happens after the sentinel trips.

    max_retries    — rollbacks allowed per checkpoint segment before the
                     fault surfaces to the caller;
    skip_bad_batch — drop the offending feed on rollback instead of
                     retrying it (persistent-poison response; the
                     default retries, which heals transient faults);
    on_rollback    — callables `hook(scope, fault)` run after each
                     restore (e.g. `lr_backoff(...)`,
                     `amp_optimizer.rollback_hook()`).
    """

    def __init__(self, max_retries=2, skip_bad_batch=False,
                 on_rollback=()):
        self.max_retries = max(0, int(max_retries))
        self.skip_bad_batch = bool(skip_bad_batch)
        self.on_rollback = list(on_rollback)


class TrainResult:
    """What a GuardedTrainer.train() call did."""

    def __init__(self):
        self.steps = 0               # optimizer steps committed/resolved
        self.rollbacks = 0
        self.skipped = []            # step indices dropped by the policy
        self.faults = []             # NonFiniteErrors recovered from
        self.preempted = False
        self.emergency_dir = None
        self.checkpoints_written = 0
        self.flight_dumps = []       # flight-<step>.json paths written

    def __repr__(self):
        return (f"TrainResult(steps={self.steps}, "
                f"rollbacks={self.rollbacks}, "
                f"preempted={self.preempted})")


class GuardedTrainer:
    """Fault-tolerant loop over (executor, program, feeds).

    The executor should be constructed with `guard=True` (or
    PADDLE_TPU_GUARD=1): without the in-step sentinel divergence sails
    into the checkpoints. A CUDA error is never rolled back (see the
    module's docstring): it propagates.
    """

    def __init__(self, executor, program, fetch_list=None, scope=None,
                 checkpoint_dir=None, manager=None, checkpoint_every=100,
                 policy=None, chaos=None, preemption=None, window=None,
                 result_callback=None, final_checkpoint=True,
                 flight=True):
        from ..core.executor import global_scope
        if manager is None:
            if checkpoint_dir is None:
                raise ValueError(
                    "GuardedTrainer needs a checkpoint_dir or a "
                    "CheckpointManager — rollback has to restore from "
                    "somewhere")
            manager = CheckpointManager(checkpoint_dir, program=program)
        if manager.program is None:
            manager.program = program
        self.exe = executor
        self.program = program
        self.fetch_list = list(fetch_list or [])
        self.scope = scope if scope is not None else global_scope()
        self.manager = manager
        self.every = max(1, int(checkpoint_every))
        self.policy = policy if policy is not None else RecoveryPolicy()
        self.chaos = chaos
        self.preemption = preemption
        self.window = max(1, int(window if window is not None
                                 else executor.async_window))
        self.result_callback = result_callback
        self.final_checkpoint = bool(final_checkpoint)
        self._step = 0              # committed+resolved optimizer steps
        self._resumed_from = None   # dir resume() restored, if any
        self._stats = ComponentStats()
        # fault flight recorder (observability/serving_telemetry.py):
        # a small ring of recent dispatch/resolve events, dumped as
        # flight-<step>.json into the checkpoint root when the NaN/Inf
        # sentinel trips — the postmortem answers "what was in flight
        # when it went bad" without re-running. flight=False disables;
        # a FlightRecorder instance redirects (e.g. a shared ring).
        if flight is True:
            from ..observability.serving_telemetry import FlightRecorder
            flight = FlightRecorder(capacity=64, out_dir=self.manager.root)
        elif flight is False:
            flight = None
        self.flight = flight
        if getattr(executor, "_guard", None) is None:
            warnings.warn(
                "GuardedTrainer wraps an executor without the NaN/Inf "
                "guard — pass Executor(guard=True) or set "
                "PADDLE_TPU_GUARD=1, or divergence is never rolled back",
                stacklevel=2)

    @property
    def step(self):
        return self._step

    def resume(self):
        """Restore the newest valid checkpoint (if any) and continue
        from its step. Returns the checkpoint meta or None."""
        meta = self.manager.restore(self.exe, scope=self.scope)
        if meta is not None:
            self._step = int(meta.get("step", 0))
            self._resumed_from = meta.get("dir")
        return meta

    # ------------------------------------------------------------------
    def train(self, feeds, num_steps=None):
        it = iter(feeds)
        res = TrainResult()
        pending = collections.deque()    # (idx, FetchHandle), FIFO
        buffer = {}                      # idx -> ORIGINAL feed (replay)
        replay = collections.deque()     # idxs to re-dispatch
        exhausted = False
        preempt = False
        segment_rollbacks = 0
        last_ckpt = self._step
        dispatch_idx = self._step        # next FRESH feed's index
        target = None if num_steps is None \
            else self._step + int(num_steps)

        # a rollback target matching THIS run's current state must exist
        # before the first step runs. Checking `latest() is None` is not
        # enough: a reused retention root from a previous run would make
        # the first rollback restore THAT run's weights and step count —
        # refuse the ambiguous case instead of silently training into it.
        latest = self.manager.latest()
        want = self.manager._dir_for(self._step)
        if latest is not None and \
                os.path.basename(latest) > os.path.basename(want):
            raise RuntimeError(
                f"checkpoint root {self.manager.root!r} already holds "
                f"{os.path.basename(latest)}, newer than this trainer's "
                f"step {self._step} — call resume() to continue from it, "
                f"or point the trainer at a fresh checkpoint_dir")
        if latest != want or latest != self._resumed_from:
            # also OVERWRITES an equal-step checkpoint we did NOT just
            # resume from (a dead previous run's baseline): the rollback
            # target must hold THIS run's live state, not foreign
            # weights that happen to share a step number
            self.manager.save(self.exe, self._step, scope=self.scope)
            res.checkpoints_written += 1

        def save_checkpoint(extra=None):
            nonlocal last_ckpt, segment_rollbacks
            d = self.manager.save(self.exe, self._step, scope=self.scope,
                                  extra=extra)
            res.checkpoints_written += 1
            last_ckpt = self._step
            segment_rollbacks = 0
            for i in [i for i in buffer if i < last_ckpt]:
                buffer.pop(i)
            return d

        def resolve_oldest():
            """Resolve the oldest in-flight step; on a sentinel trip,
            roll back. Any other error propagates."""
            idx, h = pending.popleft()
            try:
                out = h.result()
            except NonFiniteError as e:
                rollback(e, idx)
                return
            self._step = idx + 1
            if self.flight is not None:
                self.flight.record(idx, kind="resolve",
                                   committed_step=self._step,
                                   inflight=len(pending))
            if self.result_callback is not None:
                self.result_callback(idx, out)

        def rollback(fault, fault_idx):
            nonlocal segment_rollbacks, dispatch_idx, target, last_ckpt
            res.faults.append(fault)
            segment_rollbacks += 1
            if self.flight is not None:
                # dump BEFORE restore mutates anything: the ring's last
                # entry is the fault itself, identifying the offending
                # step, the segment base, and the in-flight window
                self.flight.record(
                    fault_idx, kind="fault", var=fault.var,
                    fault_step=fault.step, bad_vars=list(fault.bad_vars),
                    segment_base=last_ckpt,
                    rollbacks_this_segment=segment_rollbacks,
                    inflight=len(pending))
                res.flight_dumps.append(self.flight.dump(
                    "nonfinite_rollback", step=fault_idx,
                    extra={"var": fault.var, "step": fault.step,
                           "bad_vars": list(fault.bad_vars),
                           "segment_base": last_ckpt,
                           "rollbacks_this_segment": segment_rollbacks,
                           "will_surface": segment_rollbacks
                           > self.policy.max_retries}))
            # later in-flight steps ran on poisoned state: retire them
            while pending:
                _i, h = pending.popleft()
                try:
                    h.wait()
                except Exception:
                    pass
            if segment_rollbacks > self.policy.max_retries:
                raise fault              # retry budget spent: surface
            meta = self.manager.restore(self.exe, scope=self.scope)
            if meta is None:
                raise fault
            res.rollbacks += 1
            self._stats.count("executor.fault.rollbacks")
            self._step = int(meta.get("step", 0))
            if self._step < last_ckpt:
                # restore() fell back PAST the segment base (the latest
                # checkpoint was corrupt): the feeds for steps
                # [restored, last_ckpt) were pruned when that checkpoint
                # committed and cannot be replayed — say so loudly and
                # rebase the segment instead of silently mis-counting
                warnings.warn(
                    f"rollback fell back to step {self._step}, past the "
                    f"segment base {last_ckpt}; feeds for steps "
                    f"{self._step}..{last_ckpt - 1} were already "
                    f"consumed and are LOST to the resumed run",
                    stacklevel=2)
                last_ckpt = self._step
            # the restore just UNDID every earlier retry's hook effect
            # (LR, loss scale live in the checkpointed state): compound
            # the hooks once per rollback this segment, so retry n runs
            # at factor**n — otherwise a deterministic fault replays
            # bitwise-identically and extra retries are wasted work
            for _ in range(segment_rollbacks):
                for hook in self.policy.on_rollback:
                    hook(self.scope, fault)
            if self.policy.skip_bad_batch and fault_idx in buffer:
                # drop the offending feed; later buffered feeds (and
                # the not-yet-consumed stream) shift down one index
                res.skipped.append(fault_idx)
                self._stats.count("executor.fault.skipped_batches")
                tail = [buffer.pop(i) for i in sorted(buffer)
                        if i > fault_idx]
                buffer.pop(fault_idx, None)
                for j, f in enumerate(tail):
                    buffer[fault_idx + j] = f
                dispatch_idx -= 1
                if target is not None:
                    target -= 1
            replay.clear()
            replay.extend(i for i in sorted(buffer) if i >= self._step)

        def next_dispatch():
            """-> (idx, feed) or None (boundary / stream end / target)."""
            nonlocal dispatch_idx, exhausted
            if replay:
                # replays are never barrier-blocked: they were admitted
                # into a previous segment attempt, and after a fallback
                # restore their indices can legitimately sit past the
                # rebased boundary (the next checkpoint just covers a
                # longer segment)
                idx = replay.popleft()
                return idx, buffer[idx]
            idx = dispatch_idx
            if idx >= last_ckpt + self.every:
                return None                  # checkpoint barrier
            if target is not None and idx >= target:
                return None
            if exhausted:
                return None
            try:
                f = next(it)
            except StopIteration:
                exhausted = True
                return None
            buffer[idx] = f
            dispatch_idx = idx + 1
            return idx, f

        while True:
            if self.preemption is not None and self.preemption.requested():
                preempt = True
            if preempt:
                break
            # fill the window up to the segment boundary
            while len(pending) < self.window:
                was_replay = bool(replay)
                nidx = replay[0] if replay else dispatch_idx
                if self.chaos is not None \
                        and self.chaos.should_preempt(nidx):
                    preempt = True
                    break
                nd = next_dispatch()
                if nd is None:
                    break
                idx, feed = nd
                if self.chaos is not None:
                    feed = self.chaos.on_dispatch(idx, feed)
                h = self.exe.run_async(self.program, feed=feed,
                                       fetch_list=self.fetch_list,
                                       scope=self.scope,
                                       window=self.window)
                pending.append((idx, h))
                if self.flight is not None:
                    self.flight.record(idx, kind="dispatch",
                                       inflight=len(pending),
                                       segment_base=last_ckpt,
                                       replay=was_replay)
            if preempt:
                continue
            if pending:
                resolve_oldest()
                continue
            # window empty: segment boundary, target, or stream end
            if self._step > last_ckpt \
                    and self._step - last_ckpt >= self.every:
                save_checkpoint()
                continue
            break                            # stream/target exhausted

        if preempt:
            # drain what is in flight (a fault here still rolls back),
            # then commit the emergency checkpoint atomically
            while pending:
                resolve_oldest()
            res.preempted = True
            self._stats.count("executor.fault.preemptions")
            res.emergency_dir = save_checkpoint(extra={"emergency": True})
            self._stats.count("checkpoint.emergency_saves")
            if self.preemption is not None:
                self.preemption.clear()
        elif self.final_checkpoint and self._step > last_ckpt:
            save_checkpoint()

        res.steps = self._step
        return res
