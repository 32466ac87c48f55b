"""Length-prefixed localhost-socket RPC for out-of-process replicas.

Counterpart of ``paddle_tpu/serving/transport.py``, kept as the port's
own copy with the same frame, so a JAX fleet's frames and the port's
interchange. Blobs are numpy arrays or torch tensors; a bf16 tensor
travels under the numpy dtype string "bfloat16" (the string ml_dtypes'
bfloat16 prints as) and is read back as a torch tensor, so neither side
needs a numpy bfloat16 dtype.

The out-of-process fleet keeps
the HTTP endpoints (/metrics /healthz /slo /trace /series) for humans
and scrapers, but the router's hot path — submit / step / cancel /
serialized KV block handoff — needs a call-response channel with binary
array payloads and deadline-propagating timeouts. This module is that
channel: a deliberately tiny frame protocol over a localhost TCP
socket.

Frame layout (all integers big-endian):

    magic   4 bytes   b"PTRP"
    version u16       WIRE_VERSION
    hlen    u32       length of the JSON header
    header  hlen      UTF-8 JSON object; header["blobs"] is a list of
                      {"dtype": str, "shape": [..]} describing the
                      binary payloads that follow
    per blob:
      blen  u32       byte length
      data  blen      raw C-contiguous array bytes

Why localhost-only: the socket binds 127.0.0.1 and carries no auth —
it is an intra-host control channel between a router and the worker
processes it spawned, not a network service. Anything crossing a host
boundary should go through a real RPC stack with authn/z; this seam's
job is process isolation, not network transparency.

Failure taxonomy at this layer (the proxy maps it onto the fleet's
dead/hung/slow taxonomy, serving/remote.py):

- connection refused/reset/EOF → bounded exponential-backoff retries,
  then ``TransportError``  → the replica is DEAD;
- socket timeout → ``RpcTimeout`` immediately (no retry — re-calling a
  wedged worker just blocks again) → the replica is HUNG-suspect;
- worker-side exception → ``RemoteError`` carrying the peer's exception
  type + message (re-raised as the matching builtin when unambiguous).
"""

import json
import socket
import struct
import threading
import time

import numpy as np
import torch

MAGIC = b"PTRP"
WIRE_VERSION = 1
MAX_HEADER_BYTES = 1 << 26      # 64 MiB: a header bigger than this is
MAX_BLOB_BYTES = 1 << 30        # corruption, not a request
_HDR = struct.Struct(">4sHI")   # magic, version, header length
_U32 = struct.Struct(">I")


class TransportError(RuntimeError):
    """Base class for RPC channel failures (connection-level)."""


class FrameError(TransportError):
    """Malformed or truncated frame on the wire."""


class VersionMismatch(TransportError):
    """Peer speaks a different wire version."""


class RpcTimeout(TransportError):
    """The peer did not answer within the deadline."""


class RemoteError(TransportError):
    """The peer raised; carries its exception type and message."""

    def __init__(self, type_name, message):
        super().__init__(f"{type_name}: {message}")
        self.type_name = type_name
        self.remote_message = message


# builtin exception types a worker may legitimately raise on a request
# (submit validation, closed-server races); anything else surfaces as
# RemoteError so a worker bug can't be mistaken for a local one
_RAISABLE = {"ValueError": ValueError, "RuntimeError": RuntimeError,
             "KeyError": KeyError, "TypeError": TypeError}


def raise_remote(err):
    """Re-raise a worker-side error payload client-side."""
    cls = _RAISABLE.get(err.get("type"))
    if cls is not None:
        raise cls(err.get("message", ""))
    raise RemoteError(err.get("type", "Exception"),
                      err.get("message", ""))


def _blob_spec_and_bytes(b):
    """-> (dtype string, shape, raw C-order bytes) of one blob: a torch
    tensor (copied to the host; its dtype string is numpy's name for it,
    "bfloat16" as ml_dtypes prints it, and bf16 goes out as its int16
    bits, so numpy never needs a bfloat16 dtype) or anything np.asarray
    takes."""
    if isinstance(b, torch.Tensor):
        t = b.detach().to("cpu").contiguous()
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16
               else t).numpy().tobytes()
        return str(t.dtype).removeprefix("torch."), list(t.shape), raw
    a = np.ascontiguousarray(b)
    return str(a.dtype), list(a.shape), a.tobytes()


def pack_frame(header, blobs=()):
    """Serialize ``header`` (JSON-able dict) + ``blobs`` (numpy arrays
    or torch tensors)."""
    specs = [_blob_spec_and_bytes(b) for b in blobs]
    header = dict(header)
    header["blobs"] = [{"dtype": dt, "shape": shape}
                       for dt, shape, _raw in specs]
    hraw = json.dumps(header).encode("utf-8")
    parts = [_HDR.pack(MAGIC, WIRE_VERSION, len(hraw)), hraw]
    for _dt, _shape, raw in specs:
        parts.append(_U32.pack(len(raw)))
        parts.append(raw)
    return b"".join(parts)


def _decode_blob(raw, spec):
    """One blob's bytes -> a numpy array, or a CPU torch tensor for
    "bfloat16" (numpy has no such dtype without an extension; the
    receiving cache copies it into its pools either way)."""
    if spec["dtype"] == "bfloat16":
        t = torch.frombuffer(bytearray(raw), dtype=torch.bfloat16)
        return t.reshape(spec["shape"])
    arr = np.frombuffer(raw, dtype=np.dtype(spec["dtype"]))
    return arr.reshape(spec["shape"])


def _read_exact(reader, n, what):
    chunks, got = [], 0
    while got < n:
        chunk = reader.read(n - got)
        if not chunk:
            raise FrameError(
                f"truncated frame: expected {n} bytes of {what}, got "
                f"{got} before the stream ended (peer died or wrote a "
                f"short frame)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def read_frame(reader):
    """Read one frame from a file-like ``reader``; returns
    ``(header, blobs)``. Raises FrameError/VersionMismatch with
    messages naming what went wrong."""
    raw = _read_exact(reader, _HDR.size, "frame header")
    magic, version, hlen = _HDR.unpack(raw)
    if magic != MAGIC:
        raise FrameError(
            f"bad magic {magic!r} (expected {MAGIC!r}): peer is not "
            f"speaking the paddle_tpu fleet RPC protocol")
    if version != WIRE_VERSION:
        raise VersionMismatch(
            f"wire version mismatch: peer speaks v{version}, this "
            f"process speaks v{WIRE_VERSION} — upgrade both sides of "
            f"the fleet together")
    if hlen > MAX_HEADER_BYTES:
        raise FrameError(
            f"frame header claims {hlen} bytes (cap "
            f"{MAX_HEADER_BYTES}): corrupt or hostile stream")
    try:
        header = json.loads(_read_exact(reader, hlen, "JSON header"))
    except json.JSONDecodeError as e:
        raise FrameError(f"frame header is not valid JSON: {e}") from None
    blobs = []
    for spec in header.get("blobs", ()):
        (blen,) = _U32.unpack(_read_exact(reader, _U32.size,
                                          "blob length"))
        if blen > MAX_BLOB_BYTES:
            raise FrameError(
                f"blob claims {blen} bytes (cap {MAX_BLOB_BYTES}): "
                f"corrupt stream")
        raw = _read_exact(reader, blen, "blob payload")
        blobs.append(_decode_blob(raw, spec))
    return header, blobs


class RpcServer:
    """Dispatch loop over a listening localhost socket.

    ``handlers`` maps method name -> fn(header, blobs) returning
    (header, blobs). One thread per connection; calls on a connection
    are serialized, and a process-wide lock serializes handler bodies
    (the worker hosts ONE engine — concurrent steps would violate the
    scheduler's single-driver contract)."""

    def __init__(self, handlers, host="127.0.0.1", port=0):
        self.handlers = handlers
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(8)
        self.host, self.port = self._sock.getsockname()
        self._lock = threading.Lock()
        self._closed = False
        self._threads = []

    def start(self):
        """Accept loop in a daemon thread (in-process tests)."""
        t = threading.Thread(target=self.serve_forever,
                             name="rpc-accept", daemon=True)
        t.start()
        return t

    def serve_forever(self):
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return                      # closed under us
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name="rpc-conn", daemon=True)
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn):
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        reader = conn.makefile("rb")
        try:
            while not self._closed:
                try:
                    header, blobs = read_frame(reader)
                except (FrameError, VersionMismatch) as e:
                    # answer malformed frames when we still can — the
                    # peer gets a friendly reject instead of a hangup
                    try:
                        conn.sendall(pack_frame(
                            {"ok": False,
                             "error": {"type": type(e).__name__,
                                       "message": str(e)}}))
                    except OSError:
                        pass
                    return
                resp = self._dispatch(header, blobs)
                conn.sendall(resp)
        except (OSError, ValueError):
            pass                            # peer went away mid-frame
        finally:
            try:
                reader.close()
                conn.close()
            except OSError:
                pass

    def _dispatch(self, header, blobs):
        method = header.get("method")
        fn = self.handlers.get(method)
        if fn is None:
            return pack_frame(
                {"ok": False,
                 "error": {"type": "KeyError",
                           "message": f"unknown RPC method {method!r}"}})
        try:
            with self._lock:
                rh, rb = fn(header, blobs)
        except BaseException as e:  # noqa: BLE001 — must cross the wire
            return pack_frame(
                {"ok": False,
                 "error": {"type": type(e).__name__, "message": str(e)}})
        rh = dict(rh or {})
        rh.setdefault("ok", True)
        return pack_frame(rh, rb or ())

    def close(self):
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass


class RpcClient:
    """Client side: one persistent connection, deadline-propagating
    timeouts, bounded exponential-backoff reconnect-retries, and the
    ``drop_connection_at`` chaos hook for deterministic fault tests."""

    def __init__(self, host, port, *, timeout_s=30.0, retries=3,
                 backoff_s=0.02, chaos=None):
        from ..observability import _help
        from ..observability.metrics import global_registry
        self.host, self.port = host, port
        self.timeout_s = float(timeout_s)
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.chaos = chaos
        self._sock = None
        self._reader = None
        self._lock = threading.RLock()
        self._ncalls = 0
        reg = global_registry()
        self._m_requests = reg.counter("serving.fleet.rpc.requests",
                                       _help("serving.fleet.rpc.requests"))
        self._m_retries = reg.counter("serving.fleet.rpc.retries",
                                      _help("serving.fleet.rpc.retries"))
        self._m_timeouts = reg.counter("serving.fleet.rpc.timeouts",
                                       _help("serving.fleet.rpc.timeouts"))

    # -- connection management ---------------------------------------------
    def _connect(self, timeout):
        s = socket.create_connection((self.host, self.port),
                                     timeout=timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = s
        self._reader = s.makefile("rb")

    def _drop_conn(self):
        for obj in (self._reader, self._sock):
            if obj is not None:
                try:
                    obj.close()
                except OSError:
                    pass
        self._sock = self._reader = None

    def close(self):
        with self._lock:
            self._drop_conn()

    # -- calls ---------------------------------------------------------------
    def call(self, method, header=None, blobs=(), deadline_s=None):
        """One RPC. ``deadline_s`` (seconds remaining) caps the socket
        timeout below the client default so a request-level deadline
        propagates into every hop it takes."""
        header = dict(header or {})
        header["method"] = method
        timeout = self.timeout_s
        if deadline_s is not None:
            if deadline_s <= 0:
                raise RpcTimeout(
                    f"rpc {method!r}: deadline already exceeded before "
                    f"the call was made")
            timeout = min(timeout, float(deadline_s))
        payload = pack_frame(header, blobs)
        with self._lock:
            self._ncalls += 1
            self._m_requests.inc()
            fault = None
            if self.chaos is not None:
                fault = self.chaos.conn_drop_for(self._ncalls)
            attempt = 0
            while True:
                try:
                    if fault is not None:
                        kind, fault = fault, None
                        self._drop_conn()
                        if kind == "timeout":
                            raise socket.timeout(
                                "chaos: injected rpc timeout")
                        raise ConnectionResetError(
                            "chaos: injected connection drop")
                    if self._sock is None:
                        self._connect(timeout)
                    self._sock.settimeout(timeout)
                    self._sock.sendall(payload)
                    rh, rb = read_frame(self._reader)
                except socket.timeout:
                    self._m_timeouts.inc()
                    self._drop_conn()
                    raise RpcTimeout(
                        f"rpc {method!r} to {self.host}:{self.port} "
                        f"timed out after {timeout:.3f}s (worker hung "
                        f"or overloaded)") from None
                except VersionMismatch:
                    self._drop_conn()
                    raise
                except (OSError, FrameError) as e:
                    self._drop_conn()
                    attempt += 1
                    if attempt > self.retries:
                        raise TransportError(
                            f"rpc {method!r} to {self.host}:"
                            f"{self.port} failed after "
                            f"{self.retries} retries: {e}") from None
                    self._m_retries.inc()
                    time.sleep(self.backoff_s * (2 ** (attempt - 1)))
                    continue
                if not rh.get("ok", False):
                    raise_remote(rh.get("error", {}))
                return rh, rb
