"""Parent-side proxy for an out-of-process replica worker.

Counterpart of ``paddle_tpu/serving/remote.py``, kept as the port's own
copy. `WorkerProxy` presents the SAME surface a `FleetRouter` (and the
robustness supervisor) touches on an in-process `GenerationServer`:
submit/step/pending/health/get_stats/check_slo, the scheduler view
(`_sched`), the prefix index (`_prefix`), the telemetry plane
(`telemetry.slo` digests, windowed burn fractions, tenant ledger). Every
read either answers from the state snapshot the last "step" RPC carried
or makes one RPC to the worker (serving/worker.py). The router and the
whole self-healing stack run UNCHANGED against process boundaries
because the proxy translates transport failures into the existing death
taxonomy:

- connection loss (refused/reset/EOF after bounded backoff retries):
  the worker is DEAD: all outstanding futures fail RequestCancelled,
  the router's failover re-admits them, the supervisor resurrects the
  slot (a fresh process through the same spawn path);
- RPC timeout: the worker is HUNG-suspect: the proxy stops issuing
  step RPCs, its cached progress mark freezes with work pending, and
  the watchdog's stale-heartbeat verdict fires exactly as it does for
  an in-process stall (teardown then SIGKILLs the wedged pid);
- a worker-side engine fault (NonFiniteError) travels back
  structurally (var/step/bad_vars/bad_rids) and is re-raised so the
  poison-quarantine lineage accounting sees the same exception shape
  in-process serving produces.

`make_subprocess_spawn` is the `make_checkpoint_spawn` twin for
processes: each call boots `python -m paddle_tpu_torch.serving.worker`
with a JSON boot spec (checkpoint dir + config + engine kwargs + poison
chaos mirror), waits for the ready handshake, and returns a connected
proxy: the SAME spawn_fn signature the supervisor's resurrection path
calls, so a SIGKILLed worker resurrects as a brand-new process. Each
worker is a fresh interpreter with its own CUDA context; a killed one
is waited for (`_reap`) so its context is released before the slot
respawns. `live_workers()` lists the workers still running, for a test
fixture's teardown sweep.
"""

import json
import os
import select
import signal
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import Future

import numpy as np

from .transport import RpcClient, RpcTimeout, TransportError

# every live worker Popen, for the `proc` test fixture's
# kill-on-teardown sweep — a wedged worker must never outlive its test
_LIVE_WORKERS = []
_LIVE_LOCK = threading.Lock()


def live_workers():
    with _LIVE_LOCK:
        return [p for p in _LIVE_WORKERS if p.poll() is None]


def _track(proc):
    with _LIVE_LOCK:
        _LIVE_WORKERS.append(proc)
        if len(_LIVE_WORKERS) > 256:
            _LIVE_WORKERS[:] = [p for p in _LIVE_WORKERS
                                if p.poll() is None]


def _cfg_dict(cfg):
    """A GPTConfig as JSON (class defaults + instance overrides)."""
    out = {}
    for klass in reversed(type(cfg).__mro__):
        for k, v in vars(klass).items():
            if not k.startswith("_") and not callable(v):
                out[k] = v
    out.update(vars(cfg))
    return out


class RemoteFuture(Future):
    """The proxy-local future for one remote request; request_id is
    the WORKER-side rid (so engine-fault bad_rids lineage checks match
    without translation). cancel() forwards over the wire, then
    cancels locally — same contract as GenerationFuture."""

    def __init__(self, proxy, request_id):
        super().__init__()
        self._proxy = proxy
        self.request_id = request_id

    def cancel(self):
        if self.done():
            return False
        try:
            self._proxy._client.call("cancel",
                                     {"rid": self.request_id})
        except TransportError:
            pass                # a dead worker cancelled it the hard way
        if not super().cancel():
            return False
        self.set_running_or_notify_cancel()
        return True


class _RemoteSched:
    """The scheduler view the router reads between pumps, fed by each
    step RPC's state snapshot. `_lock` is a local RLock — the worker
    serializes for real; this lock only satisfies the with-statement
    call sites."""

    def __init__(self, state, num_slots):
        self._lock = threading.RLock()
        self.num_slots = int(num_slots)
        self.iteration = 0
        self.counts = {}
        self._has_work = False
        self._load = (0, 0, 0)
        self.apply(state)

    def apply(self, st):
        self.iteration = int(st["iteration"])
        self.counts = dict(st["counts"])
        self._has_work = bool(st["has_work"])
        self._load = tuple(int(v) for v in st["load"])

    def has_work(self):
        return self._has_work

    def load_snapshot(self):
        return self._load


class _RemotePrefix:
    """Affinity probes against the worker's prefix index."""

    def __init__(self, proxy):
        self._proxy = proxy

    def match(self, prompt, keys):
        try:
            rh, _ = self._proxy._client.call(
                "prefix_match", {"keys": list(keys)},
                blobs=[np.asarray(prompt, np.int32)])
            return range(int(rh["depth"]))
        except TransportError:
            return range(0)

    def stats(self):
        try:
            rh, _ = self._proxy._client.call("prefix_stats")
            return rh["stats"] or {}
        except TransportError:
            return {}

    def __len__(self):
        try:
            rh, _ = self._proxy._client.call("prefix_stats")
            return int(rh["len"])
        except TransportError:
            return 0


class _RemoteSLO:
    def __init__(self, proxy):
        self._proxy = proxy

    def digest(self, metric):
        from ..observability.sketch import QuantileSketch
        try:
            rh, _ = self._proxy._client.call("slo_digest",
                                             {"metric": metric})
        except TransportError:
            return QuantileSketch()
        d = rh.get("digest")
        return (QuantileSketch.from_dict(d) if d is not None
                else QuantileSketch())

    def window_frac_over(self, metric, target):
        try:
            rh, _ = self._proxy._client.call(
                "window_frac_over",
                {"metric": metric, "target": float(target)})
            return rh.get("frac"), int(rh.get("n", 0))
        except TransportError:
            return None, 0


class _RemoteTenants:
    def __init__(self, proxy):
        self._proxy = proxy

    def snapshot(self):
        try:
            rh, _ = self._proxy._client.call("tenants")
            return rh.get("snapshot") or {}
        except TransportError:
            return {}       # a dead worker's billing froze with it


class _RemoteTelemetry:
    """Telemetry facade: SLO digests and tenant billing answer over
    RPC; `series` is None (the worker's own store serves /series on
    its HTTP port — cross-process attach would mean polling, and the
    router's fleet store already carries the burn-rate series)."""

    def __init__(self, proxy):
        self.slo = _RemoteSLO(proxy)
        self.tenants = _RemoteTenants(proxy)
        self.series = None
        self._proxy = proxy

    def stats(self):
        try:
            rh, _ = self._proxy._client.call("slo_stats")
            return rh.get("stats") or {}
        except TransportError:
            return {}

    def set_recorder(self, recorder):
        # span trees stay in the worker process; fleet tracing sees
        # this replica through the router-side hop records (pid field)
        pass


class _RemoteCacheInfo:
    """The cache facts the router reads without touching pools."""

    def __init__(self, hello):
        self.quantized = bool(hello["quantized"])
        self.num_blocks = int(hello["num_blocks"])
        self._pool_bytes = int(hello["pool_bytes"])
        self.geometry = dict(hello["geometry"])

    def pool_bytes(self):
        return self._pool_bytes


class WorkerProxy:
    """One subprocess replica, driven over the socket RPC."""

    remote = True

    def __init__(self, proc, client, hello, spec_path=None):
        self._proc = proc
        self._client = client
        self._spec_path = spec_path
        self.pid = int(hello["pid"])
        self.http_port = hello.get("http_port")
        self.block_size = int(hello["block_size"])
        self.max_context = int(hello["max_context"])
        self.mesh = None
        self._worker = None         # manual-drive, like start=False
        self._fault = None
        self._closed = False
        self._suspect_hung = False
        self._lock = threading.RLock()
        self._futs = {}             # worker rid -> RemoteFuture
        self._streams = {}          # worker rid -> client stream cb
        self._sched = _RemoteSched(hello["state"], hello["num_slots"])
        self._pending = int(hello["state"]["pending"])
        self._health = dict(hello["state"]["health"])
        self._prefix = (_RemotePrefix(self) if hello["prefix"]
                        else None)
        self.telemetry = (_RemoteTelemetry(self) if hello["telemetry"]
                          else None)
        self.cache = _RemoteCacheInfo(hello)

    # -- death classification ------------------------------------------
    def _mark_dead(self, reason):
        """Connection-level death: fail every outstanding future (the
        router's done callbacks enqueue their failover) and latch
        closed — the slot reads dead to alive() and the supervisor
        resurrects it with a fresh process."""
        from .scheduler import RequestCancelled
        with self._lock:
            if self._closed:
                return
            self._closed = True
            futs = list(self._futs.values())
            self._futs.clear()
            self._streams.clear()
            self._health = dict(self._health, status="closed",
                                engine_fault=None)
        err = RequestCancelled(
            f"worker pid {self.pid} connection lost: {reason}")
        for f in futs:
            if not f.done():
                f.set_exception(err)
        self._reap(kill=True)

    def _reap(self, kill=False, timeout=5.0):
        self._client.close()
        if self._proc is None:
            return
        if kill and self._proc.poll() is None:
            try:
                self._proc.kill()
            except OSError:
                pass
        try:
            self._proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            pass
        if self._spec_path is not None:
            try:
                os.unlink(self._spec_path)
            except OSError:
                pass
            self._spec_path = None

    # -- the GenerationServer surface ----------------------------------
    def submit(self, prompt_ids, max_new_tokens=32, eos_id=None,
               priority=0, deadline_ms=None, stream=None,
               trace_ctx=None, tenant=None, n=1, sampling=None,
               beam=None, guided=None):
        if n != 1 or sampling is not None or beam is not None \
                or guided is not None:
            raise NotImplementedError(
                "forked generation is not wired through the subprocess "
                "transport: fork groups need GroupFuture lane plumbing "
                "in the wire protocol — use in-process replicas")
        if self._closed:
            raise RuntimeError("GenerationServer is closed")
        header = {"max_new_tokens": int(max_new_tokens),
                  "eos_id": eos_id, "priority": int(priority),
                  "deadline_ms": deadline_ms, "tenant": tenant,
                  "stream": stream is not None}
        if trace_ctx is not None:
            header["trace"] = {"trace_id": trace_ctx.trace_id,
                               "hop": trace_ctx.hop,
                               "sampled": trace_ctx.sampled}
        deadline_s = (float(deadline_ms) / 1e3
                      if deadline_ms is not None else None)
        try:
            rh, _ = self._client.call(
                "submit", header,
                blobs=[np.asarray(prompt_ids, np.int32)],
                deadline_s=deadline_s)
        except RpcTimeout:
            self._suspect_hung = True
            raise RuntimeError(
                f"worker pid {self.pid} submit timed out") from None
        except TransportError as e:
            self._mark_dead(e)
            raise RuntimeError(
                f"worker pid {self.pid} died during submit: "
                f"{e}") from None
        rid = int(rh["rid"])
        fut = RemoteFuture(self, rid)
        with self._lock:
            self._futs[rid] = fut
            if stream is not None:
                self._streams[rid] = stream
        # the cached between-pumps view must show the work NOW: the
        # router's step() gates on has_work() before ever pumping, so
        # waiting for the first step RPC to refresh it would deadlock
        # manual-drive (nobody steps an "idle" fleet)
        self._sched._has_work = True
        self._pending += 1
        return fut

    def step(self):
        if self._closed or self._suspect_hung:
            # hung-suspect: stop calling a wedged worker — the cached
            # progress mark freezes with work pending and the watchdog
            # takes it from here
            return False
        try:
            rh, _ = self._client.call("step")
        except RpcTimeout:
            self._suspect_hung = True
            return False
        except TransportError as e:
            self._mark_dead(e)
            return False
        return self._apply_step(rh)

    def _apply_step(self, rh):
        from ..robustness.guard import NonFiniteError
        self._sched.apply(rh)
        self._pending = int(rh["pending"])
        self._health = dict(rh["health"])
        with self._lock:
            streams = dict(self._streams)
        for rid, tok in rh.get("tokens", ()):
            cb = streams.get(int(rid))
            if cb is not None:
                cb(int(rid), int(tok))
        fault = rh.get("fault")
        err = None
        if fault is not None:
            err = NonFiniteError(fault["var"], fault["step"],
                                 fault.get("bad_vars"))
            err.bad_rids = set(int(r) for r in
                               fault.get("bad_rids") or ())
            if fault.get("flight_dump") is not None:
                err.flight_dump = fault["flight_dump"]
        self._resolve_done(rh.get("done", ()), fault_err=err)
        if err is not None:
            # the in-process engine-fault contract: every in-flight
            # future fails with THE fault, then step raises it — the
            # replica pump catches it and the slot reads dead
            with self._lock:
                self._fault = err
                self._closed = True
                futs = list(self._futs.values())
                self._futs.clear()
                self._streams.clear()
                self._health = dict(self._health, status="fault",
                                    engine_fault=repr(err))
            for f in futs:
                if not f.done():
                    f.set_exception(err)
            self._reap(kill=True)
            raise err
        return bool(rh["stepped"])

    def _resolve_done(self, entries, fault_err=None):
        from ..robustness.guard import NonFiniteError
        from .scheduler import (DeadlineExceeded, GenerationResult,
                                RequestCancelled)
        for entry in entries:
            rid = int(entry["rid"])
            with self._lock:
                fut = self._futs.pop(rid, None)
                self._streams.pop(rid, None)
            if fut is None or fut.done():
                continue
            res = entry.get("result")
            if res is not None:
                fut.set_result(GenerationResult(
                    rid, list(res["token_ids"]), res["score"],
                    res["finish_reason"], res["prompt_len"],
                    res["ttft_ms"]))
                continue
            einfo = entry.get("error") or {}
            etype = einfo.get("type")
            msg = einfo.get("message", "")
            if etype == "NonFiniteError":
                if fault_err is not None:
                    exc = fault_err
                else:
                    nf = einfo.get("nonfinite") or {}
                    exc = NonFiniteError(nf.get("var", "remote"),
                                         nf.get("step", 0),
                                         nf.get("bad_vars"))
                    exc.bad_rids = set(int(r) for r in
                                       nf.get("bad_rids") or ())
            elif etype == "DeadlineExceeded":
                exc = DeadlineExceeded(msg)
            elif etype == "RequestCancelled":
                exc = RequestCancelled(msg)
            else:
                exc = RuntimeError(f"{etype}: {msg}")
            fut.set_exception(exc)

    def run_until_idle(self, max_iterations=100000):
        for _ in range(max_iterations):
            if self._closed or self._suspect_hung:
                return
            if not self.step() and not self._sched.has_work():
                return

    def pending(self):
        return self._pending

    def health(self):
        return dict(self._health)

    def get_stats(self):
        try:
            rh, _ = self._client.call("get_stats")
            return rh["stats"]
        except TransportError:
            return {"kernel": None, "dead": True, "pid": self.pid}

    def check_slo(self, targets):
        try:
            rh, _ = self._client.call("check_slo",
                                      {"targets": targets})
            return rh["result"]
        except TransportError:
            return {"ok": None, "checks": []}

    # -- chain handoff over the wire -----------------------------------
    def export_chain(self, prompt, keys):
        rh, blobs = self._client.call(
            "export_chain", {"keys": list(keys)},
            blobs=[np.asarray(prompt, np.int32)])
        return rh.get("chunks") or [], blobs

    def import_chain(self, chunks, arrays):
        rh, _ = self._client.call("import_chain",
                                  {"chunks": chunks}, blobs=arrays)
        return int(rh["moved"])

    # -- lifecycle ------------------------------------------------------
    def notify_preempt(self):
        """Forward the fleet preempt drain: the worker finishes its
        in-flight work and closes its engine (blocking this call),
        then a "sync" pulls the drain's completions so every local
        future resolves. The process itself exits on the router
        teardown's close() — exiting here would race the parent out
        of its final state pull."""
        try:
            self._client.call("preempt")
            rh, _ = self._client.call("sync")
            self._apply_step(rh)
        except TransportError as e:
            self._mark_dead(e)

    def kill_process(self):
        """SIGKILL the worker pid — the chaos `kill_process_at` path.
        Nothing proxy-side is touched: the parent discovers the death
        the same way it would a real crash, via the next RPC."""
        try:
            os.kill(self.pid, signal.SIGKILL)
            return True
        except (OSError, ProcessLookupError):
            return False

    def close(self, drain=True):
        from .scheduler import RequestCancelled
        with self._lock:
            if self._closed and self._proc is None:
                return
            already_dead = self._closed
            self._closed = True
            futs = list(self._futs.values())
            self._futs.clear()
            self._streams.clear()
            if self._health.get("status") == "ok":
                self._health["status"] = "closed"
        if not already_dead:
            try:
                self._client.call("close", {"drain": bool(drain)})
            except TransportError:
                pass
        err = RequestCancelled("replica closed")
        for f in futs:
            if not f.done():
                f.set_exception(err)
        self._reap(kill=not drain)
        # a drained worker exits on its own; don't leave a zombie
        if self._proc is not None and self._proc.poll() is None:
            try:
                self._proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                self._reap(kill=True)
        self._proc = None


def _repo_root():
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def spawn_worker(spec, *, chaos=None, spawn_timeout_s=180.0,
                 rpc_timeout_s=30.0, retries=3, backoff_s=0.02,
                 env=None):
    """Boot one worker process from a boot spec and return a connected
    WorkerProxy. Raises RuntimeError when the worker dies or misses
    the ready handshake within `spawn_timeout_s` — the supervisor's
    crash-loop breaker counts that exactly like a failed in-process
    spawn."""
    from .worker import READY_PREFIX
    fd, spec_path = tempfile.mkstemp(prefix="ptworker_",
                                     suffix=".json")
    with os.fdopen(fd, "w") as f:
        json.dump(spec, f)
    wenv = dict(os.environ if env is None else env)
    pypath = wenv.get("PYTHONPATH", "")
    root = _repo_root()
    if root not in pypath.split(os.pathsep):
        wenv["PYTHONPATH"] = (root + (os.pathsep + pypath
                                      if pypath else ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.worker",
         spec_path],
        stdout=subprocess.PIPE, stderr=None, env=wenv)
    _track(proc)
    deadline = time.monotonic() + float(spawn_timeout_s)
    line = ""
    try:
        while True:
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"worker spawn timed out after {spawn_timeout_s}s "
                    f"waiting for the ready handshake (pid "
                    f"{proc.pid})")
            if proc.poll() is not None:
                raise RuntimeError(
                    f"worker exited rc={proc.returncode} before the "
                    f"ready handshake — boot failure (bad checkpoint "
                    f"or spec?)")
            ready, _, _ = select.select([proc.stdout], [], [], 0.2)
            if not ready:
                continue
            line = proc.stdout.readline().decode("utf-8",
                                                 "replace").strip()
            if line.startswith(READY_PREFIX):
                break
    except Exception:
        try:
            proc.kill()
        except OSError:
            pass
        try:
            os.unlink(spec_path)
        except OSError:
            pass
        raise
    info = json.loads(line[len(READY_PREFIX):])
    client = RpcClient("127.0.0.1", info["port"],
                       timeout_s=rpc_timeout_s, retries=retries,
                       backoff_s=backoff_s, chaos=chaos)
    rh, _ = client.call("hello")
    rh["http_port"] = info.get("http_port")
    return WorkerProxy(proc, client, rh, spec_path=spec_path)


def make_subprocess_spawn(ckpt_dir, cfg, *, seq_len=8,
                          program_seed=13, chaos=None, http=True,
                          spawn_timeout_s=180.0, rpc_timeout_s=30.0,
                          retries=3, backoff_s=0.02, dtype=None,
                          **server_kwargs):
    """A spawn_fn over worker PROCESSES: `make_checkpoint_spawn`'s
    out-of-process twin, same (index) -> server-like signature, so the
    supervisor resurrects SIGKILLed workers without knowing the backend
    changed. The parent chaos injector's poison-prompt plans mirror
    into every spawned worker (a resurrected replica must fault on a
    poison replay exactly like its predecessor), and the same injector
    arms the RPC clients' drop_connection_at hook.

    `server_kwargs` travel as JSON to the worker's GenerationServer:
    its `device` (None: the card) is where the worker restores the
    checkpoint and serves. `dtype` ("float32", "bfloat16" or the torch
    dtype; None keeps the checkpoint's) casts the worker's model."""
    kw = dict(server_kwargs)
    if kw.get("device") is not None:
        kw["device"] = str(kw["device"])
    if dtype is not None and not isinstance(dtype, str):
        dtype = str(dtype).removeprefix("torch.")
    spec = {"ckpt_dir": str(ckpt_dir), "cfg": _cfg_dict(cfg),
            "seq_len": int(seq_len),
            "program_seed": int(program_seed),
            "server_kwargs": kw, "http": bool(http), "dtype": dtype}
    if chaos is not None and getattr(chaos, "_prompt_poisons", None):
        spec["chaos"] = {"poison_prompts": [
            {"prompt": np.asarray(p, np.int32).tolist(),
             "layer": int(layer)}
            for p, layer in chaos._prompt_poisons]}

    def spawn(index):
        return spawn_worker(spec, chaos=chaos,
                            spawn_timeout_s=spawn_timeout_s,
                            rpc_timeout_s=rpc_timeout_s,
                            retries=retries, backoff_s=backoff_s)

    return spawn
