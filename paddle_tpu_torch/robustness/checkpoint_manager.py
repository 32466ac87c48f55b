"""Last-K-good checkpoint retention with retry/backoff and validated,
fall-back restore.

Layout (one retention root per training run):

    root/
      ckpt-00000040/ {state.npz, meta.json}     # meta.json commits it
      ckpt-00000080/ ...

Every save goes through io.checkpoint's atomic write sequence (temp +
fsync + os.replace, manifest with per-array CRC32, meta.json last), so
a directory without a valid meta.json is by construction an aborted
save, never a torn-but-loadable state. Restores walk newest-to-oldest
past corrupt/incomplete candidates. Write errors retry with bounded
deterministic exponential backoff (`sleep_fn` injectable so the chaos
tier never sleeps for real), then surface.

Counterpart of ``paddle_tpu/robustness/checkpoint_manager.py``, kept as
the port's own copy over the port's io/checkpoint.py: the same layout
and format, so a retention root written by the JAX package restores
into the port (and the fleet's resurrection and worker boot restore
from it).
"""

import glob
import os
import shutil
import time

from ..core.framework import default_main_program
from ..observability import ComponentStats
from ..io.checkpoint import (CheckpointCorruptError, load_checkpoint,
                             save_checkpoint)

__all__ = ["CheckpointManager", "CheckpointError"]


class CheckpointError(RuntimeError):
    """A checkpoint write failed after exhausting its retry budget
    (carries the last underlying error as __cause__)."""


class CheckpointManager:
    """Keep the last `keep` good checkpoints under `root`.

    save()/restore() capture and restore the EXECUTOR's step counter
    too (meta.extra["exe_step_counter"]): the in-graph RNG folds that
    counter in, so a rollback that skipped restoring it would replay
    steps with different randomness and break bitwise recovery.
    """

    def __init__(self, root, keep=3, program=None, retries=3,
                 backoff_s=0.1, backoff_factor=2.0, sleep_fn=None):
        self.root = str(root)
        self.keep = max(1, int(keep))
        self.program = program
        self.retries = max(0, int(retries))
        self.backoff_s = float(backoff_s)
        self.backoff_factor = float(backoff_factor)
        self.sleep_fn = sleep_fn if sleep_fn is not None else time.sleep
        self._stats = ComponentStats(
            gauge_labels={"manager": os.path.basename(self.root) or "ckpt"})

    # -- listing -------------------------------------------------------
    def _dir_for(self, step):
        return os.path.join(self.root, f"ckpt-{int(step):08d}")

    def checkpoints(self):
        """Committed checkpoint dirs, oldest first (commit marker =
        meta.json present)."""
        out = []
        for d in sorted(glob.glob(os.path.join(self.root, "ckpt-*"))):
            if os.path.exists(os.path.join(d, "meta.json")):
                out.append(d)
        return out

    def latest(self):
        ck = self.checkpoints()
        return ck[-1] if ck else None

    # -- save ----------------------------------------------------------
    def save(self, executor, step, scope=None, extra=None):
        """Atomically commit a checkpoint for `step`, with bounded
        retry + exponential backoff on I/O errors; prunes to `keep`
        afterwards. Returns the committed directory."""
        meta_extra = dict(extra or {})
        meta_extra.setdefault("exe_step_counter",
                              int(getattr(executor, "_step_counter", 0)))
        dirname = self._dir_for(step)
        delay = self.backoff_s
        last_err = None
        for attempt in range(self.retries + 1):
            try:
                save_checkpoint(executor, dirname,
                                main_program=self.program, step=step,
                                extra=meta_extra, scope=scope)
                break
            except OSError as e:
                last_err = e
                self._stats.count("checkpoint.write_failures")
                if attempt == self.retries:
                    raise CheckpointError(
                        f"checkpoint write for step {step} failed after "
                        f"{self.retries + 1} attempts: {e}") from e
                self.sleep_fn(delay)
                delay *= self.backoff_factor
        self._prune()
        return dirname

    def _prune(self):
        ck = self.checkpoints()
        while len(ck) > self.keep:
            victim = ck.pop(0)
            shutil.rmtree(victim, ignore_errors=True)
            self._stats.count("checkpoint.evictions")
        self._stats.set_gauge("checkpoint.retained", len(ck))

    # -- restore -------------------------------------------------------
    def restore(self, executor, scope=None, restore_step_counter=True):
        """Load the newest VALID checkpoint (walking back past corrupt
        or incomplete ones, counting fallbacks) into `scope` and — by
        default — wind the executor's step counter back to the saved
        value so replayed steps reuse their original RNG folds.
        Returns the meta dict, or None when the root holds nothing."""
        candidates = self.checkpoints()
        if not candidates:
            return None
        last_err = None
        for dirname in reversed(candidates):
            try:
                meta = load_checkpoint(executor, dirname,
                                       main_program=self.program,
                                       scope=scope)
            except (OSError, ValueError, CheckpointCorruptError) as e:
                last_err = e
                self._stats.count("checkpoint.fallbacks")
                continue
            if restore_step_counter and hasattr(executor, "_step_counter"):
                counter = meta.get("extra", {}).get("exe_step_counter")
                if counter is not None:
                    executor._step_counter = int(counter)
            meta["dir"] = dirname
            return meta
        raise CheckpointCorruptError(
            f"{self.root}: no loadable checkpoint among "
            f"{len(candidates)} candidates") from last_err
