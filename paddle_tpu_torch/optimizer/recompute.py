"""Rematerialization (recompute): trade FLOPs for device memory.

Parity: the counterpart of ``paddle_tpu/optimizer/recompute.py``. There
the Executor wraps the traced forward in ``jax.checkpoint`` with an XLA
remat policy; here ``RecomputeOptimizer.minimize`` tags the program the
same way (``program._recompute``) and the port's Executor runs the
forward section through ``run_checkpointed``: the ops cut into about
sqrt(n) segments of consecutive ops, each under torch's non-reentrant
``torch.utils.checkpoint.checkpoint``, which drops what the backward
would read inside the segment and re-runs the segment for it. XLA
schedules a rematerialized value next to its use; an eager checkpoint
re-runs its whole region at the first use, so one region over the
forward would hold every recomputed activation at once and save
nothing: segments bound what is live to the tensors crossing their
boundaries plus one segment's activations (Chen et al.'s sqrt(n)
checkpointing). Each JAX policy maps to a torch mechanism:

    dots        a selective-checkpoint policy that must-save the outputs
                of ``aten.mm`` / ``aten.addmm`` (the 2-D products of
                fc / mul and the projections, JAX's
                ``dots_with_no_batch_dims_saveable``) and recomputes
                everything else
    nothing     a plain checkpoint: only the inputs are saved
    everything  no recompute: the Executor runs the plain forward
    offload     "dots" with the saved products in host memory (JAX's
                ``offload_dot_with_no_batch_dims``): a plain checkpoint
                whose forward, under a dispatch mode, copies each
                ``aten.mm`` / ``aten.addmm`` output into pinned host
                memory (non-blocking, on the producing stream), and whose
                recompute, under a second mode, returns those copies
                brought back to the device (non-blocking, in order)
                instead of running the products again. Only CUDA
                tensors are pinned and copied; on the CPU the mode keeps
                the outputs as they are. ``OFFLOADED_BYTES`` counts the
                bytes copied to the host.

The recomputed forward re-runs every op, kernels included: the flash
forward is launched again (a fresh output buffer a launch), and dropout
draws the same masks, its generators being seeded by (program seed,
step, op seed) (``ops/__init__.py``).

    opt = fluid.optimizer.RecomputeOptimizer(
        fluid.optimizer.AdamOptimizer(1e-3), policy="dots")
    opt.minimize(loss)
"""

import functools
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_POLICIES = ("dots", "nothing", "everything", "offload")


_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

# bytes of product outputs copied to pinned host memory by "offload"
# segments (cumulative, like the kernels' launch counters)
OFFLOADED_BYTES = 0


def resolve_policy(name):
    """Validate a policy name: ValueError for an unknown one."""
    if name not in _POLICIES:
        raise ValueError(f"unknown remat policy {name!r}; "
                         f"one of {sorted(_POLICIES)}")


class _OffloadSave(TorchDispatchMode):
    """The forward of an "offload" segment: every product's output, a
    host copy appended to `store` (pinned, non-blocking) for a CUDA
    tensor, the tensor itself on the CPU."""

    def __init__(self, store):
        super().__init__()
        self.store = store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        global OFFLOADED_BYTES
        out = func(*args, **(kwargs or {}))
        if func in _PRODUCTS:
            if out.is_cuda:
                host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
                host.copy_(out, non_blocking=True)
                OFFLOADED_BYTES += host.numel() * host.element_size()
                self.store.append((host, out.device))
            else:
                self.store.append((out.detach(), None))
        return out


class _OffloadLoad(TorchDispatchMode):
    """The recompute of an "offload" segment: each product, in the
    forward's order, returns its saved output (brought back to the device
    non-blocking on the current stream, which ordered the copy out
    before it) instead of running."""

    def __init__(self, store):
        super().__init__()
        self.store = store
        self.i = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func not in _PRODUCTS:
            return func(*args, **(kwargs or {}))
        saved, device = self.store[self.i]
        self.i += 1
        if device is None:
            return saved
        return saved.to(device, non_blocking=True)


def _offload_contexts():
    store = []
    return _OffloadSave(store), _OffloadLoad(store)


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    if op in _PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def run_checkpointed(ops, env, run, keep, policy):
    """run(segment, env) for about sqrt(len(ops)) segments of consecutive
    `ops`, on a snapshot of `env` as the segment starts, each under
    torch's non-reentrant checkpoint with `policy` ("dots", "nothing"
    or "offload"). A segment's results go back into `env` only where
    something after it reads them: a later op, or a name in `keep`."""
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    elif policy == "offload":
        kw["context_fn"] = _offload_contexts
    size = max(1, math.ceil(math.sqrt(len(ops))))
    segments = [ops[i:i + size] for i in range(0, len(ops), size)]
    reads, after = set(keep), []
    for seg in reversed(segments):
        after.append(set(reads))
        for op in seg:
            reads.update(op.input_names)
    for seg, need in zip(segments, reversed(after)):
        outs = {n for op in seg for n in op.output_names if n in need}

        def segment(snap=dict(env), seg=seg, outs=outs):
            e = dict(snap)
            run(seg, e)
            return {n: e[n] for n in outs if n in e}
        env.update(checkpoint(segment, use_reentrant=False, **kw))


class RecomputeOptimizer:
    """Wraps an optimizer; minimize() additionally tags the program for
    forward rematerialization (consumed by Executor._backward). The
    policy is checked when the optimizer is built."""

    def __init__(self, optimizer, policy="dots", checkpoints=None):
        # `checkpoints` (manual checkpoint vars) is accepted for API
        # familiarity but unused: the policy says what to save
        self._inner = optimizer
        self._policy = policy
        resolve_policy(policy)

    def __getattr__(self, item):
        return getattr(self._inner, item)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        result = self._inner.minimize(loss, startup_program, parameter_list,
                                      no_grad_set)
        loss.block.program._recompute = {"policy": self._policy}
        return result
