"""Full-training-state checkpoint/resume (the synchronous, unsharded
layout).

Counterpart of ``paddle_tpu/io/checkpoint.py`` (its single-file format,
``CHECKPOINT_FORMAT`` 2), kept as the port's own copy: persistables
include optimizer accumulators and LR counters, so save/load round-trips
a training run, and the fleet's resurrection and its worker processes
boot replicas from it. The directory is byte-compatible with the JAX
package's: ``state.npz`` (numpy arrays by variable name) and
``meta.json`` (step, extra, format, a CRC32 manifest), so a checkpoint
written by either package restores into the other.

Durability contract: every checkpoint write is ATOMIC. Payload files
land via temp file + fsync + os.replace, and the manifest/commit marker
(meta.json) is written LAST, so a crash at any byte leaves either the
previous complete checkpoint or an obviously incomplete directory,
never a loadable-looking torn one. Load validates each array's CRC32
and raises CheckpointCorruptError instead of resuming from silently
corrupt state.

``save_checkpoint_async`` takes the host snapshot on the calling thread
(the device-to-host copy happens before it returns, after whatever the
caller drained) and writes the files in a non-daemon thread; its
``CheckpointHandle`` re-raises a write error at ``wait()``, and writers
never waited on are joined at interpreter exit. The sharded layout
(``save_checkpoint_sharded``) is ROADMAP item 10d, with the sharded state
it saves.
"""

import atexit
import glob
import json
import os
import threading
import time
import warnings
import zlib

import numpy as np
import torch

from ..core.executor import global_scope
from ..core.framework import default_main_program
from ..observability import ComponentStats
from .state import _atomic_save, host_array

__all__ = ["CHECKPOINT_FORMAT", "CheckpointCorruptError",
           "CheckpointHandle", "save_checkpoint", "save_checkpoint_async",
           "load_checkpoint", "set_write_fault_hook"]

_stats = ComponentStats()

CHECKPOINT_FORMAT = 2


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed manifest/CRC validation (torn write, bit rot,
    or a partial copy). Callers with a retention directory should fall
    back to the previous good checkpoint (CheckpointManager does)."""


# ---------------------------------------------------------------------------
# write-fault hook: called before every physical checkpoint file write so
# a fault injector can fail the Nth write deterministically on the real
# write path
# ---------------------------------------------------------------------------

_WRITE_FAULT_HOOK = None


def set_write_fault_hook(hook):
    """Install `hook(kind, path)` to run before each physical checkpoint
    write (kinds: 'state', 'meta'). Raising from the hook makes that
    write fail. Pass None to uninstall. Test-only."""
    global _WRITE_FAULT_HOOK
    _WRITE_FAULT_HOOK = hook


def _fault(kind, path):
    if _WRITE_FAULT_HOOK is not None:
        _WRITE_FAULT_HOOK(kind, path)


# ---------------------------------------------------------------------------
# atomic write primitive: the temp+fsync+os.replace sequence lives in
# io/state.py (one copy); checkpoint writes add the fault hook
# ---------------------------------------------------------------------------

def _atomic_write(path, writer, kind):
    """temp file + fsync + os.replace: `path` either keeps its old
    content or atomically becomes the complete new content."""
    _fault(kind, path)
    _atomic_save(path, writer)


def _crc32(arr):
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _manifest_entry(arr):
    return {"crc32": _crc32(arr), "shape": [int(s) for s in arr.shape],
            "dtype": str(arr.dtype)}


def _snapshot(scope, program):
    """Persistables as host numpy: the device-to-host copy happens
    here, on the caller's thread (the next step updates the tensors in
    place), never inside a writer."""
    names = [v.name for v in program.list_vars() if v.persistable]
    return {n: host_array(scope.get(n)) for n in sorted(set(names))
            if scope.get(n) is not None}


def _write_state(dirname, snapshot, meta):
    """The single-file layout's committed write sequence: state.npz
    first, then meta.json (manifest + commit marker) LAST."""
    os.makedirs(dirname, exist_ok=True)
    t0 = time.perf_counter()
    _atomic_write(os.path.join(dirname, "state.npz"),
                  lambda f: np.savez(f, **snapshot), "state")
    meta = dict(meta)
    meta["format"] = CHECKPOINT_FORMAT
    meta["manifest"] = {n: _manifest_entry(a) for n, a in snapshot.items()}
    _atomic_write(os.path.join(dirname, "meta.json"),
                  lambda f: f.write(json.dumps(meta).encode()), "meta")
    _stats.count("checkpoint.saves")
    _stats.observe("checkpoint.save_ms", (time.perf_counter() - t0) * 1e3)


def save_checkpoint(executor, dirname, main_program=None, step=0,
                    extra=None, scope=None):
    scope = scope or global_scope()
    program = main_program or default_main_program()
    _write_state(dirname, _snapshot(scope, program),
                 {"step": int(step), "extra": extra or {}})


def load_checkpoint(executor, dirname, main_program=None, scope=None,
                    validate=True):
    """Restore a checkpoint directory into `scope`, as tensors on the
    executor's device (the CPU without an executor). Validates the meta.json manifest (per-array
    CRC32) before touching the scope and raises CheckpointCorruptError
    on mismatch. When `dirname` is a retention root holding `ckpt-*`
    subdirectories (CheckpointManager layout), the newest VALID
    checkpoint is loaded, falling back past corrupt or incomplete ones
    with a warning."""
    scope = scope or global_scope()
    program = main_program or default_main_program()
    meta_path = os.path.join(dirname, "meta.json")
    if not os.path.exists(meta_path):
        subs = sorted(glob.glob(os.path.join(dirname, "ckpt-*")),
                      reverse=True)
        if subs:
            last_err = None
            for sub in subs:
                # a ckpt-* dir without meta.json is an ABORTED save
                # (the marker is written last): it must not reach the
                # single-dir path below, where a bare state.npz would
                # load as a fake committed step-0 checkpoint
                if not os.path.exists(os.path.join(sub, "meta.json")):
                    _stats.count("checkpoint.fallbacks")
                    warnings.warn(
                        f"checkpoint {sub} has no commit marker "
                        f"(aborted save); falling back to the previous "
                        f"one", stacklevel=2)
                    continue
                try:
                    return load_checkpoint(executor, sub, main_program,
                                           scope=scope, validate=validate)
                except (OSError, ValueError, CheckpointCorruptError) as e:
                    _stats.count("checkpoint.fallbacks")
                    warnings.warn(
                        f"checkpoint {sub} unusable ({e}); falling back "
                        f"to the previous one", stacklevel=2)
                    last_err = e
            raise CheckpointCorruptError(
                f"{dirname}: no loadable checkpoint among "
                f"{len(subs)} candidates") from last_err
    t0 = time.perf_counter()
    state_path = os.path.join(dirname, "state.npz")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    else:
        meta = {"step": 0, "extra": {}}
    wanted = {v.name for v in program.list_vars() if v.persistable}
    staged = []
    manifest = meta.get("manifest") if validate else None
    # ONE read of the archive: validate every array against the
    # manifest, then place the already-decompressed copies straight
    # into the scope
    try:
        with np.load(state_path, allow_pickle=False) as data:
            for n in data.files:
                arr = data[n]
                if manifest is not None:
                    entry = manifest.get(n)
                    if entry is None or _crc32(arr) != entry["crc32"]:
                        _stats.count("checkpoint.crc_failures")
                        raise CheckpointCorruptError(
                            f"{dirname}: CRC mismatch for '{n}': "
                            f"torn or corrupt checkpoint")
                if n in wanted:
                    staged.append((n, arr))
            if manifest is not None:
                missing = set(manifest) - set(data.files)
                if missing:
                    _stats.count("checkpoint.crc_failures")
                    raise CheckpointCorruptError(
                        f"{dirname}: manifest lists {sorted(missing)} "
                        f"but state.npz lacks them")
    except CheckpointCorruptError:
        raise
    except Exception as e:
        if not validate:
            raise
        # a torn .npz fails INSIDE numpy/zipfile (BadZipFile, EOF, bad
        # zip CRC) before the manifest check even runs
        _stats.count("checkpoint.crc_failures")
        raise CheckpointCorruptError(
            f"{dirname}: state.npz unreadable ({e}): torn or corrupt "
            f"checkpoint") from e
    # validation passed over the WHOLE archive before any mutation
    dev = getattr(executor, "device", None) or torch.device("cpu")
    for n, arr in staged:
        scope.set(n, torch.from_numpy(np.array(arr, copy=True)).to(dev))
    _stats.count("checkpoint.restores")
    _stats.observe("checkpoint.restore_ms",
                   (time.perf_counter() - t0) * 1e3)
    return meta


# ---------------------------------------------------------------------------
# async writers: non-daemon + error box + join-at-exit
# ---------------------------------------------------------------------------

_LIVE_WRITERS = []          # CheckpointHandles with a running thread
_writers_lock = threading.Lock()


def _track(handle):
    with _writers_lock:
        _LIVE_WRITERS.append(handle)


def _untrack(handle):
    with _writers_lock:
        try:
            _LIVE_WRITERS.remove(handle)
        except ValueError:
            pass


@atexit.register
def _join_writers_at_exit():
    """A daemon writer dying mid-write at interpreter exit is exactly
    the torn-checkpoint bug; join every outstanding writer instead and
    surface swallowed errors as a warning (raising is useless here)."""
    with _writers_lock:
        pending = list(_LIVE_WRITERS)
    for h in pending:
        try:
            h.wait()
        except BaseException as e:          # noqa: BLE001 — exit path
            warnings.warn(f"async checkpoint write failed: {e!r}")


class CheckpointHandle:
    """Completion barrier for an (async) checkpoint save. `wait()` joins
    the writer and RE-RAISES anything the write path threw — an async
    save error is never silently swallowed."""

    def __init__(self, thread=None, error_box=None):
        self._thread = thread
        # `error_box or []` would DROP the writer's box while it is
        # still empty — the exact silently-swallowed-error bug this
        # handle exists to fix
        self._error_box = error_box if error_box is not None else []

    def wait(self):
        if self._thread is not None:
            self._thread.join()
        _untrack(self)
        if self._error_box:
            raise self._error_box[0]
        return True

    result = wait
    join = wait         # Thread-API compat (save_checkpoint_async < fmt 2)

    def done(self):
        return self._thread is None or not self._thread.is_alive()


def save_checkpoint_async(executor, dirname, main_program=None, step=0,
                          extra=None, scope=None):
    """Async save: snapshot to host on the CALLING thread (the next step
    updates the scope's tensors in place, so the writer must never read
    them), file I/O in a non-daemon background thread. Returns a
    CheckpointHandle — `wait()` is the completion barrier and re-raises
    any write error; un-waited handles are joined at interpreter exit."""
    scope = scope or global_scope()
    program = main_program or default_main_program()
    snapshot = _snapshot(scope, program)
    meta = {"step": int(step), "extra": extra or {}}
    err_box = []
    handle = CheckpointHandle(None, err_box)

    def _write():
        try:
            _write_state(dirname, snapshot, meta)
        except BaseException as e:      # surfaced at .wait()/atexit
            _stats.count("checkpoint.write_failures")
            err_box.append(e)

    t = threading.Thread(target=_write, daemon=False,
                         name=f"ckpt-writer-{os.path.basename(dirname)}")
    handle._thread = t
    _track(handle)
    t.start()
    return handle
