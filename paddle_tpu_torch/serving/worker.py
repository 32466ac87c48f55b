"""Replica worker process: one GenerationServer behind the socket RPC.

Counterpart of ``paddle_tpu/serving/worker.py``, kept as the port's own
copy. ``python -m paddle_tpu_torch.serving.worker <spec.json>`` boots
one engine in its own process, the out-of-process half of the
`Replica` transport seam (serving/remote.py is the parent half):

- weights rebuild through the `make_checkpoint_spawn` path: a
  CheckpointManager restore of the newest CRC-valid checkpoint into a
  fresh scope (the worker never receives weights over a pipe; the
  checkpoint IS the spawn artifact, same as resurrection); the engine
  serves on the card unless the spec's server kwargs say
  ``device: "cpu"``, and a worker without a card that was not asked
  for the CPU exits non-zero before its ready line;
- the engine is manual-drive (start=False): the PARENT's router pumps
  it one iteration per "step" RPC, so router iterations stay the only
  clock and the chaos-storm determinism contract survives the process
  boundary;
- the existing HTTP endpoint schemas (/metrics /healthz /slo /series
  /tenants) mount on an ephemeral localhost port; /healthz adds the
  worker's `pid`, its device and the paged kernel's launch count, and
  ``get_stats()["kernel"]["launches"]`` carries the same count over the
  RPC, so the parent sees that the kernel ran in the child;
- SIGTERM drains gracefully (finish in-flight work, close, exit 0):
  the PreemptionHandler's fleet-wide drain reaches child processes
  both ways: the router forwards a "preempt" RPC, and a SIGTERM sent
  straight to the worker does the same thing.

`WorkerHost` is the RPC surface itself, constructable over any
in-process engine: the wire-schema tests exercise the full frame
protocol against an in-thread host without paying a process boot.
"""

import json
import os
import signal
import sys
import threading
import time

import numpy as np
import torch

from .transport import RpcServer

READY_PREFIX = "PTWORKER_READY "


def _jsonable(obj):
    """Recursively coerce numpy scalars/arrays so a stats payload
    survives json.dumps on the way back to the parent."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


# -- chain handoff halves (shared with the parent's in-process side) -------
def export_chain(server, prompt, keys):
    """Serialize the prompt's cached chunk KV out of `server`: the
    source half of a cross-process `adopt_block_from`. Walks the chain
    exactly like the in-process transfer (peek — the handoff manifest
    — lifting spilled chunks back first), PINS each block with a ref
    while its rows are copied to host numpy, and unrefs in a finally:
    whether the receiving process lives or dies mid-handoff, the
    donor's refcounts and ledger are consistent by construction.
    Returns (chunks, arrays): chunks[i] = {key, parent, tokens, meta},
    arrays = the per-(layer, pool-entry) blobs, concatenated in chunk
    order."""
    bs = server.block_size
    prompt = np.asarray(prompt, np.int32)
    pinned = []                 # (key, block, tokens)
    with server._sched._lock:
        if server._prefix is None:
            return [], []
        for i, key in enumerate(keys):
            got = server._prefix.peek(key)
            if got is None and \
                    server._prefix.materialize_key(key) is not None:
                got = server._prefix.peek(key)
            if got is None:
                break
            block, tokens, _parent = got
            if not np.array_equal(tokens,
                                  prompt[i * bs:(i + 1) * bs]):
                break           # collision-sentinel chain: not ours
            server.cache.ref(block)
            pinned.append((key, block,
                           np.array(tokens, np.int32, copy=True)))
    chunks, arrays = [], []
    try:
        parent = None
        for key, block, tokens in pinned:
            meta, arrs = server.cache.serialize_block(block)
            chunks.append({"key": key, "parent": parent,
                           "tokens": tokens.tolist(), "meta": meta})
            arrays.extend(arrs)
            parent = key
    finally:
        with server._sched._lock:
            for _k, b, _t in pinned:
                server.cache.unref(b)
    return chunks, arrays


def import_chain(server, chunks, arrays):
    """Write an export_chain payload into `server`'s pool + prefix
    index: the destination half of a cross-process adopt. Geometry is
    validated per block (deserialize_block); chunks the index already
    holds are skipped; pool exhaustion ends the walk — the rest
    re-prefills, same partial-transfer-is-safe contract as the
    in-process path. Returns blocks moved."""
    if server._prefix is None or not chunks:
        return 0
    names = list(chunks[0]["meta"].get("names", ()))
    nper = server.cache.num_layers * len(names)
    moved = 0
    with server._sched._lock:
        parent = None
        for ci, ch in enumerate(chunks):
            key = ch["key"]
            if server._prefix.peek(key) is not None:
                parent = key
                continue
            got = server.cache.allocate(1)
            if got is None:
                server._prefix.evict_for(1)
                got = server.cache.allocate(1)
            if got is None:
                break
            nb = got[0]
            try:
                server.cache.deserialize_block(
                    nb, ch["meta"], arrays[ci * nper:(ci + 1) * nper])
            except ValueError:
                server.cache.free([nb])
                raise
            tokens = np.asarray(ch["tokens"], np.int32)
            if server._prefix.register(key, parent, tokens, nb):
                server.cache.unref(nb)      # index ref keeps it
                moved += 1
                parent = key
            else:                           # raced an identical entry
                server.cache.free([nb])
                parent = key
    return moved


class WorkerHost:
    """The RPC method table over ONE GenerationServer.

    The parent drives everything: each router pump is one "step" call
    whose response carries the whole observable delta (tokens in
    emission order, completed futures, scheduler counts, health) so
    the proxy's cached view stays consistent between pumps without
    extra round-trips. Handler bodies run under the RpcServer's
    process lock — the engine keeps its single-driver contract."""

    def __init__(self, server):
        self.server = server
        self._futs = {}             # worker rid -> GenerationFuture
        self._tokens = []           # (rid, token) in emission order
        self._done = []             # completion entries for the parent
        self._lock = threading.Lock()
        self.exit_event = threading.Event()
        self.rpc = RpcServer(self._handlers())

    # -- bookkeeping ---------------------------------------------------
    def _on_stream(self, rid, tok):
        with self._lock:
            self._tokens.append((rid, int(tok)))

    def _on_fut_done(self, rid, fut):
        from ..robustness.guard import NonFiniteError
        from .scheduler import DeadlineExceeded, RequestCancelled
        entry = {"rid": rid}
        if fut.cancelled():
            entry["error"] = {"type": "RequestCancelled",
                              "message": f"request {rid} cancelled"}
        else:
            exc = fut.exception()
            if exc is None:
                r = fut.result()
                entry["result"] = {
                    "request_id": r.request_id,
                    "token_ids": [int(t) for t in r.token_ids],
                    "score": (float(r.score)
                              if r.score is not None else None),
                    "finish_reason": r.finish_reason,
                    "prompt_len": int(r.prompt_len),
                    "ttft_ms": (float(r.ttft_ms)
                                if r.ttft_ms is not None else None)}
            else:
                err = {"type": type(exc).__name__, "message": str(exc)}
                if isinstance(exc, NonFiniteError):
                    err["nonfinite"] = {
                        "var": exc.var, "step": exc.step,
                        "bad_vars": list(exc.bad_vars),
                        "bad_rids": sorted(
                            getattr(exc, "bad_rids", ()) or ())}
                elif not isinstance(exc, (RequestCancelled,
                                          DeadlineExceeded)):
                    err["type"] = type(exc).__name__
                entry["error"] = err
        with self._lock:
            self._done.append(entry)
            self._futs.pop(rid, None)

    def _drain_updates(self):
        with self._lock:
            tokens, self._tokens = self._tokens, []
            done, self._done = self._done, []
        return tokens, done

    def _state(self):
        srv = self.server
        sched = srv._sched
        return {"iteration": int(sched.iteration),
                "counts": _jsonable(dict(sched.counts)),
                "has_work": bool(sched.has_work()),
                "load": [int(v) for v in sched.load_snapshot()],
                "pending": int(srv.pending()),
                "health": _jsonable(srv.health())}

    # -- handlers ------------------------------------------------------
    def _handlers(self):
        return {"hello": self._h_hello, "submit": self._h_submit,
                "step": self._h_step, "cancel": self._h_cancel,
                "sync": self._h_sync,
                "prefix_match": self._h_prefix_match,
                "prefix_stats": self._h_prefix_stats,
                "slo_digest": self._h_slo_digest,
                "window_frac_over": self._h_window_frac_over,
                "tenants": self._h_tenants,
                "slo_stats": self._h_slo_stats,
                "get_stats": self._h_get_stats,
                "check_slo": self._h_check_slo,
                "export_chain": self._h_export_chain,
                "import_chain": self._h_import_chain,
                "preempt": self._h_preempt, "close": self._h_close}

    def _h_hello(self, h, blobs):
        srv = self.server
        cache = srv.cache
        return {"pid": os.getpid(),
                "block_size": int(srv.block_size),
                "num_slots": int(srv._sched.num_slots),
                "max_context": int(srv.max_context),
                "quantized": bool(getattr(cache, "quantized", False)),
                "num_blocks": int(cache.num_blocks),
                "pool_bytes": int(cache.pool_bytes()),
                "geometry": cache.wire_geometry(),
                "prefix": srv._prefix is not None,
                "telemetry": srv.telemetry is not None,
                "state": self._state()}, ()

    def _h_submit(self, h, blobs):
        from ..observability.fleet_trace import TraceContext
        kw = {}
        for k in ("max_new_tokens", "eos_id", "priority",
                  "deadline_ms", "tenant"):
            if h.get(k) is not None:
                kw[k] = h[k]
        tc = h.get("trace")
        if tc is not None:
            kw["trace_ctx"] = TraceContext(
                tc["trace_id"], tc.get("hop", 0),
                tc.get("sampled", True))
        if h.get("stream"):
            kw["stream"] = self._on_stream
        fut = self.server.submit(np.asarray(blobs[0], np.int32), **kw)
        rid = fut.request_id
        with self._lock:
            self._futs[rid] = fut
        fut.add_done_callback(
            lambda f, rid=rid: self._on_fut_done(rid, f))
        return {"rid": rid}, ()

    def _h_step(self, h, blobs):
        from ..robustness.guard import NonFiniteError
        fault = None
        stepped = False
        try:
            stepped = bool(self.server.step())
        except NonFiniteError as e:
            fault = {"var": e.var, "step": e.step,
                     "bad_vars": list(e.bad_vars),
                     "bad_rids": sorted(
                         getattr(e, "bad_rids", ()) or ()),
                     "flight_dump": _jsonable(
                         getattr(e, "flight_dump", None))}
        tokens, done = self._drain_updates()
        resp = self._state()
        resp.update(stepped=stepped, fault=fault,
                    tokens=[[r, t] for r, t in tokens], done=done)
        return resp, ()

    def _h_sync(self, h, blobs):
        """State + pending completions without stepping — the proxy's
        run_until_idle tail and post-fault reconciliation."""
        tokens, done = self._drain_updates()
        resp = self._state()
        resp.update(stepped=False, fault=None,
                    tokens=[[r, t] for r, t in tokens], done=done)
        return resp, ()

    def _h_cancel(self, h, blobs):
        fut = self._futs.get(int(h["rid"]))
        if fut is not None:
            fut.cancel()
        return {}, ()

    def _h_prefix_match(self, h, blobs):
        srv = self.server
        if srv._prefix is None:
            return {"depth": 0}, ()
        prompt = np.asarray(blobs[0], np.int32)
        with srv._sched._lock:
            depth = len(srv._prefix.match(prompt, h.get("keys") or []))
        return {"depth": int(depth)}, ()

    def _h_prefix_stats(self, h, blobs):
        srv = self.server
        if srv._prefix is None:
            return {"stats": None, "len": 0}, ()
        with srv._sched._lock:
            return {"stats": _jsonable(srv._prefix.stats()),
                    "len": len(srv._prefix)}, ()

    def _h_slo_digest(self, h, blobs):
        tel = self.server.telemetry
        if tel is None:
            return {"digest": None}, ()
        return {"digest": tel.slo.digest(h["metric"]).to_dict()}, ()

    def _h_window_frac_over(self, h, blobs):
        tel = self.server.telemetry
        if tel is None:
            return {"frac": None, "n": 0}, ()
        # rotation rides the engine step loop; an idle worker's stale
        # window must still age out for the router's burn series
        tel.slo.maybe_roll()
        fo, n = tel.slo.window_frac_over(h["metric"],
                                         float(h["target"]))
        return {"frac": fo, "n": int(n)}, ()

    def _h_tenants(self, h, blobs):
        tel = self.server.telemetry
        return {"snapshot": _jsonable(tel.tenants.snapshot())
                if tel is not None else {}}, ()

    def _h_slo_stats(self, h, blobs):
        tel = self.server.telemetry
        return {"stats": _jsonable(tel.stats())
                if tel is not None else {}}, ()

    def _h_get_stats(self, h, blobs):
        return {"stats": _jsonable(self.server.get_stats())}, ()

    def _h_check_slo(self, h, blobs):
        return {"result": _jsonable(
            self.server.check_slo(h["targets"]))}, ()

    def _h_export_chain(self, h, blobs):
        chunks, arrays = export_chain(
            self.server, np.asarray(blobs[0], np.int32),
            h.get("keys") or [])
        return {"chunks": chunks}, arrays

    def _h_import_chain(self, h, blobs):
        moved = import_chain(self.server, h.get("chunks") or [],
                             blobs)
        return {"moved": int(moved)}, ()

    def _h_preempt(self, h, blobs):
        # drain + close the engine but DON'T exit yet: the parent
        # follows with a "sync" (collecting the drain's completions)
        # and then a "close" that ends the process — exiting here
        # would race the parent out of its final state pull
        self._graceful(drain=True, exit=False)
        return {"draining": True}, ()

    def _h_close(self, h, blobs):
        self._graceful(drain=bool(h.get("drain", True)))
        return {"closed": True}, ()

    def _graceful(self, drain, exit=True):
        srv = self.server
        if drain and not srv._closed and srv._fault is None:
            srv.run_until_idle()
        try:
            srv.close(drain=False)
        except Exception:       # noqa: BLE001 — exit must not wedge
            pass
        if exit:
            self.exit_event.set()

    def close(self):
        self.rpc.close()


def _mount_http(server):
    """The engine's serve_metrics mount with a worker-aware /healthz:
    the pid, the device and the paged kernel's launch count ride the
    payload, so the parent sees from outside the process which device
    the worker serves on and that its steps went through the kernel."""
    from ..observability.exporter import serve_metrics as _serve
    from ..ops.cuda import paged
    tel = server.telemetry

    def health():
        h = server.health()
        h["pid"] = os.getpid()
        h["device"] = str(server.device)
        h["paged_launches"] = int(paged.LAUNCHES)
        return h

    return _serve(
        port=0, host="127.0.0.1",
        slo_fn=lambda: (tel.stats() if tel is not None else {}),
        health_fn=health,
        series_fn=lambda: (tel.series.payload()
                           if tel is not None and tel.series
                           is not None else None),
        tenants_fn=lambda: (tel.tenants.snapshot()
                            if tel is not None else {}))


def build_server(spec):
    """Rebuild the replica engine from a boot spec: program + config
    reconstructed locally (the port's GPT Program, ``gpt.build_lm_net``,
    whose persistable names the checkpoint restores by), weights
    restored through CheckpointManager (the make_checkpoint_spawn
    recipe: the checkpoint is the spawn artifact), chaos poison plans
    re-armed so a resurrected worker faults on a poison replay exactly
    like its predecessor. The engine serves on
    ``server_kwargs["device"]`` (None: the card, which raises without
    CUDA before the ready line is printed); ``dtype`` casts the model
    ("float32", "bfloat16"; None keeps the checkpoint's)."""
    import torch

    from ..core import framework
    from ..core.executor import Executor, Scope
    from ..core.place import CPUPlace, CUDAPlace
    from ..device import resolve_device
    from ..models import gpt
    from ..robustness.chaos import ChaosInjector
    from ..robustness.checkpoint_manager import (CheckpointError,
                                                 CheckpointManager)
    from .engine import GenerationServer, GPTServingModel

    kw = dict(spec.get("server_kwargs") or {})
    device = resolve_device(kw.get("device"))
    cfg = gpt.GPTConfig(**spec["cfg"])
    main_p, startup = framework.Program(), framework.Program()
    seed = int(spec.get("program_seed", 13))
    main_p.random_seed = startup.random_seed = seed
    with framework.program_guard(main_p, startup):
        gpt.build_lm_net(cfg, seq_len=int(spec.get("seq_len", 8)))
    scope = Scope()
    exe = Executor(CPUPlace() if device.type == "cpu"
                   else CUDAPlace(device.index or 0))
    manager = CheckpointManager(spec["ckpt_dir"], program=main_p)
    meta = manager.restore(exe, scope=scope,
                           restore_step_counter=False)
    if meta is None:
        raise CheckpointError(
            f"worker boot: no checkpoint under {spec['ckpt_dir']}")
    poisons = (spec.get("chaos") or {}).get("poison_prompts") or []
    if poisons:
        chaos = ChaosInjector()
        for p in poisons:
            chaos.poison_prompt(np.asarray(p["prompt"], np.int32),
                                layer=int(p.get("layer", 0)))
        kw["chaos"] = chaos
    kw.setdefault("start", False)       # the parent's router pumps
    dtype = spec.get("dtype")
    model = GPTServingModel(gpt.load_params(scope, cfg), cfg,
                            device=device,
                            dtype=getattr(torch, dtype) if dtype else None)
    return GenerationServer(model, **kw)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    with open(argv[0]) as f:
        spec = json.load(f)
    server = build_server(spec)
    host = WorkerHost(server)
    http_port = None
    if spec.get("http", True):
        http_port = _mount_http(server).port
    host.rpc.start()

    def _on_term(signum, frame):
        # SIGTERM = the fleet preempt drain reaching this child: finish
        # in-flight work, close, exit 0 — off the signal frame so the
        # drain can step the engine
        threading.Thread(target=host._graceful, kwargs={"drain": True},
                         name="sigterm-drain", daemon=True).start()

    signal.signal(signal.SIGTERM, _on_term)
    print(READY_PREFIX + json.dumps(
        {"pid": os.getpid(), "port": host.rpc.port,
         "http_port": http_port}), flush=True)
    host.exit_event.wait()
    # let the in-flight RPC response (close/preempt ack) flush before
    # the listener goes away
    time.sleep(0.2)
    host.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
