"""Twins of tests/api/test_transport.py on the port
(paddle_tpu_torch), on the CPU, with the interchange of the port's
frames and the JAX package's: a frame the JAX transport packs (an
ml_dtypes bfloat16 blob among them) reads into the port bitwise and
re-packs to the same bytes, the reverse too, and a bf16 KV block
crosses the wire bitwise in both directions. The port reads bf16 blobs
as torch tensors, without ml_dtypes.

Wire protocol + socket RPC for the out-of-process fleet
(serving/transport.py, serving/worker.py handler table).

Everything here runs in-process: frames round-trip through BytesIO,
the RPC channel through an in-thread RpcServer on a localhost port,
and the wire-schema e2e drives a REAL WorkerHost (one GenerationServer
behind the RPC method table) without ever spawning a process — the
frame bytes are identical either way, so this stays tier-1 fast while
pinning the schemas a subprocess worker speaks.

The contract under test:

- frames preserve dtype/shape bitwise (int8 codes next to f32 scales —
  the KV handoff payload mix);
- truncated frames, bad magic, and non-JSON headers fail with a
  FrameError that NAMES what went wrong; a peer speaking a different
  WIRE_VERSION gets a friendly VersionMismatch (both raw and as an
  error frame from a live server — never a silent hangup);
- worker-side exceptions re-raise client-side as the matching builtin
  when unambiguous, RemoteError otherwise; unknown methods are
  KeyError;
- ``drop_connection_at`` injects exactly ONE transport fault on the
  nth RPC: "reset" is retried (bounded backoff, retries counter),
  "timeout" surfaces RpcTimeout immediately (no retry — the hung
  taxonomy), and a dead peer exhausts retries into TransportError;
- the submit/stream/cancel wire schemas reproduce the in-process
  GenerationServer bitwise, and the serialized KV block handoff
  (serialize_block/deserialize_block + export_chain/import_chain over
  the wire) preserves int8+scale payloads and GQA geometry while
  rejecting mismatched pools with the adopt_block_from error contract.
"""

import io
import socket
import struct
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import framework
from paddle_tpu_torch.core.executor import Scope, scope_guard
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.observability.metrics import global_registry
from paddle_tpu_torch.robustness import ChaosInjector
from paddle_tpu_torch.serving import GenerationServer, GPTServingModel
from paddle_tpu_torch.serving.kv_cache import PagedKVCache
from paddle_tpu_torch.serving.prefix_cache import prompt_chain_keys
from paddle_tpu_torch.serving.transport import (MAGIC, WIRE_VERSION, FrameError,
                                          RemoteError, RpcClient, RpcServer,
                                          RpcTimeout, TransportError,
                                          VersionMismatch, pack_frame,
                                          read_frame)
from paddle_tpu_torch.serving.worker import WorkerHost, export_chain

pytestmark = [pytest.mark.fleet]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module: the suite runs
    several pytest workers at once, and torch's default of one thread a
    core in each worker oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_HDR = struct.Struct(">4sHI")

SERVER_KW = dict(num_slots=3, block_size=8, max_context=64, chunk=4,
                 start=False, prefix_cache=True)


@pytest.fixture(scope="module")
def tiny_gpt():
    cfg = gpt.gpt_tiny()
    main, startup = framework.Program(), framework.Program()
    main.random_seed = startup.random_seed = 13
    with framework.program_guard(main, startup):
        gpt.build_lm_net(cfg, seq_len=8)
    scope = Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with scope_guard(scope):
        exe.run(startup)
    return cfg, gpt.load_params(scope, cfg)


def _server(params, cfg, **kw):
    merged = dict(SERVER_KW)
    merged.update(kw)
    return GenerationServer(GPTServingModel(params, cfg, device="cpu"),
                            device="cpu", **merged)


# ---------------------------------------------------------------------------
# frame layer
# ---------------------------------------------------------------------------

def test_frame_round_trip_preserves_dtypes_and_shapes():
    rng = np.random.default_rng(0)
    codes = rng.integers(-128, 128, (2, 8, 2, 4)).astype(np.int8)
    scales = rng.random((2, 8, 2)).astype(np.float32)
    toks = np.arange(7, dtype=np.int32)
    raw = pack_frame({"method": "echo", "rid": 3, "nested": {"a": [1, 2]}},
                     [codes, scales, toks])
    header, blobs = read_frame(io.BytesIO(raw))
    assert header["method"] == "echo" and header["rid"] == 3
    assert header["nested"] == {"a": [1, 2]}
    assert [b.dtype for b in blobs] == [np.int8, np.float32, np.int32]
    for got, want in zip(blobs, (codes, scales, toks)):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_truncated_frame_names_what_was_cut():
    raw = pack_frame({"method": "x"}, [np.ones(4, np.float32)])
    with pytest.raises(FrameError, match="truncated frame"):
        read_frame(io.BytesIO(raw[:-3]))       # short blob payload
    with pytest.raises(FrameError, match="truncated frame"):
        read_frame(io.BytesIO(raw[:5]))        # short frame header


def test_bad_magic_is_rejected_loudly():
    raw = b"HTTP" + pack_frame({"method": "x"})[4:]
    with pytest.raises(FrameError, match="bad magic"):
        read_frame(io.BytesIO(raw))


def test_non_json_header_is_a_frame_error():
    junk = b"\xff\xfenot json"
    raw = _HDR.pack(MAGIC, WIRE_VERSION, len(junk)) + junk
    with pytest.raises(FrameError, match="not valid JSON"):
        read_frame(io.BytesIO(raw))


def test_version_mismatch_tells_both_versions():
    good = pack_frame({"method": "x"})
    raw = _HDR.pack(MAGIC, WIRE_VERSION + 1, 0) + good[_HDR.size:]
    with pytest.raises(VersionMismatch,
                       match="upgrade both sides of the fleet"):
        read_frame(io.BytesIO(raw))


# ---------------------------------------------------------------------------
# RPC channel (in-thread server)
# ---------------------------------------------------------------------------

@pytest.fixture()
def echo_rpc():
    def echo(header, blobs):
        if header.get("boom") == "value":
            raise ValueError("submit rejected: prompt too long")
        if header.get("boom") == "weird":
            raise ZeroDivisionError("worker bug")
        return {"echoed": header.get("payload")}, blobs
    srv = RpcServer({"echo": echo})
    srv.start()
    yield srv
    srv.close()


def test_rpc_echo_round_trip_and_request_counter(echo_rpc):
    m = global_registry().counter("serving.fleet.rpc.requests")
    before = m.value()
    client = RpcClient(echo_rpc.host, echo_rpc.port, timeout_s=5.0)
    arr = np.arange(6, dtype=np.int8).reshape(2, 3)
    rh, rb = client.call("echo", {"payload": "hi"}, [arr])
    assert rh["ok"] is True and rh["echoed"] == "hi"
    np.testing.assert_array_equal(rb[0], arr)
    assert m.value() == before + 1
    client.close()


def test_unknown_method_and_remote_errors(echo_rpc):
    client = RpcClient(echo_rpc.host, echo_rpc.port, timeout_s=5.0)
    with pytest.raises(KeyError, match="unknown RPC method"):
        client.call("no_such_method")
    # a builtin the worker may legitimately raise re-raises as itself
    with pytest.raises(ValueError, match="prompt too long"):
        client.call("echo", {"boom": "value"})
    # anything else stays RemoteError so a worker bug can't be
    # mistaken for a local one
    with pytest.raises(RemoteError, match="ZeroDivisionError"):
        client.call("echo", {"boom": "weird"})
    client.close()


def test_server_answers_bad_version_with_friendly_error_frame(echo_rpc):
    with socket.create_connection((echo_rpc.host, echo_rpc.port),
                                  timeout=5) as s:
        good = pack_frame({"method": "echo"})
        s.sendall(_HDR.pack(MAGIC, WIRE_VERSION + 1, 0) + good[_HDR.size:])
        reader = s.makefile("rb")
        rh, _ = read_frame(reader)
    assert rh["ok"] is False
    assert rh["error"]["type"] == "VersionMismatch"
    assert "upgrade both sides" in rh["error"]["message"]


def test_conn_drop_reset_is_retried_once(echo_rpc):
    reg = global_registry()
    retries = reg.counter("serving.fleet.rpc.retries")
    before = retries.value()
    chaos = ChaosInjector().drop_connection_at(2, kind="reset")
    client = RpcClient(echo_rpc.host, echo_rpc.port, timeout_s=5.0,
                       backoff_s=0.001, chaos=chaos)
    client.call("echo", {"payload": 1})
    rh, _ = client.call("echo", {"payload": 2})   # faulted, then retried
    assert rh["echoed"] == 2
    rh, _ = client.call("echo", {"payload": 3})   # fault fired only once
    assert rh["echoed"] == 3
    assert chaos.fired["conn_drop"] == 1
    assert retries.value() == before + 1
    client.close()


def test_conn_drop_timeout_surfaces_rpc_timeout_no_retry(echo_rpc):
    reg = global_registry()
    timeouts = reg.counter("serving.fleet.rpc.timeouts")
    before = timeouts.value()
    chaos = ChaosInjector().drop_connection_at(1, kind="timeout")
    client = RpcClient(echo_rpc.host, echo_rpc.port, timeout_s=5.0,
                       backoff_s=0.001, chaos=chaos)
    with pytest.raises(RpcTimeout, match="timed out"):
        client.call("echo", {"payload": 1})
    assert chaos.fired["conn_drop"] == 1
    assert timeouts.value() == before + 1
    # the channel recovers on the next call (reconnect)
    rh, _ = client.call("echo", {"payload": 2})
    assert rh["echoed"] == 2
    client.close()


def test_drop_connection_rejects_unknown_kind():
    with pytest.raises(ValueError, match="kind"):
        ChaosInjector().drop_connection_at(1, kind="meteor")


def test_exceeded_deadline_raises_before_touching_the_wire():
    client = RpcClient("127.0.0.1", 1, timeout_s=5.0)   # never connects
    with pytest.raises(RpcTimeout, match="deadline already exceeded"):
        client.call("echo", deadline_s=0.0)


def test_dead_peer_exhausts_retries_into_transport_error():
    # bind-then-close: the port is real but nobody is listening
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    client = RpcClient("127.0.0.1", port, timeout_s=1.0, retries=2,
                       backoff_s=0.001)
    with pytest.raises(TransportError, match="failed after 2 retries"):
        client.call("echo")
    client.close()


# ---------------------------------------------------------------------------
# wire schemas against a REAL WorkerHost (no process spawn)
# ---------------------------------------------------------------------------

def test_submit_stream_cancel_wire_schema_round_trip(tiny_gpt):
    """The exact frames a subprocess worker speaks, served in-thread:
    submit returns a rid, step responses carry tokens in emission
    order + completion entries, cancel lands as a RequestCancelled
    done entry — and the token ids are bitwise identical to the same
    prompts on a plain in-process server."""
    cfg, params = tiny_gpt
    rng = np.random.default_rng(11)
    prompts = [rng.integers(3, cfg.vocab_size,
                            int(rng.integers(9, 20))).astype(np.int32)
               for _ in range(2)]
    ref = _server(params, cfg)
    futs = [ref.submit(p, max_new_tokens=5) for p in prompts]
    ref.run_until_idle()
    want = [list(f.result(timeout=5).token_ids) for f in futs]
    ref.close()

    host = WorkerHost(_server(params, cfg))
    host.rpc.start()
    client = RpcClient(host.rpc.host, host.rpc.port, timeout_s=10.0)
    try:
        hello, _ = client.call("hello")
        assert hello["block_size"] == 8 and hello["prefix"] is True
        assert hello["geometry"]["block_size"] == 8

        rids = []
        for p in prompts:
            rh, _ = client.call("submit",
                                {"max_new_tokens": 5, "stream": True}, [p])
            rids.append(rh["rid"])
        # a third request we cancel before it finishes
        rh, _ = client.call("submit", {"max_new_tokens": 40}, [prompts[0]])
        victim = rh["rid"]
        client.call("cancel", {"rid": victim})

        tokens, done = {}, {}
        for _ in range(200):
            rh, _ = client.call("step")
            for rid, tok in rh["tokens"]:
                tokens.setdefault(rid, []).append(tok)
            for entry in rh["done"]:
                done[entry["rid"]] = entry
            if len(done) == 3 and not rh["has_work"]:
                break
        assert set(done) == set(rids) | {victim}
        got = [done[r]["result"]["token_ids"] for r in rids]
        assert got == want                      # bitwise across the wire
        for r, w in zip(rids, want):
            assert tokens[r] == w               # stream order preserved
        assert done[victim]["error"]["type"] == "RequestCancelled"
    finally:
        client.close()
        host.rpc.close()
        host.server.close()


def test_chain_handoff_over_the_wire_preserves_kv(tiny_gpt):
    """export_chain on the donor, the frames over a real socket,
    import_chain on the receiver: the receiver's prefix index adopts
    the chunks and a replayed prompt HITS them — and the donor's
    refcounts/free list are exactly what they were (the pin/unref
    finally-contract)."""
    cfg, params = tiny_gpt
    rng = np.random.default_rng(12)
    prompt = rng.integers(3, cfg.vocab_size, 24).astype(np.int32)

    donor = _server(params, cfg)
    donor.submit(prompt, max_new_tokens=4)
    donor.run_until_idle()
    keys = prompt_chain_keys(prompt, 8)
    free_before = len(donor.cache._free)
    refs_before = dict(donor.cache._ref)

    host = WorkerHost(_server(params, cfg))
    host.rpc.start()
    client = RpcClient(host.rpc.host, host.rpc.port, timeout_s=10.0)
    try:
        chunks, arrays = export_chain(donor, prompt, keys)
        assert chunks, "donor should have the prompt's chain cached"
        assert len(donor.cache._free) == free_before
        assert dict(donor.cache._ref) == refs_before
        rh, _ = client.call("import_chain", {"chunks": chunks}, arrays)
        assert rh["moved"] == len(chunks)
        rh, _ = client.call("prefix_match", {"keys": keys}, [prompt])
        assert rh["depth"] >= len(chunks)
    finally:
        client.close()
        host.rpc.close()
        host.server.close()
        donor.close()


# ---------------------------------------------------------------------------
# serialized KV block payloads (the handoff bytes themselves)
# ---------------------------------------------------------------------------

def _quantized_gqa_cache():
    return PagedKVCache(num_layers=2, num_heads=4, head_dim=4,
                        num_blocks=6, block_size=8, kv_dtype="int8",
                        num_kv_heads=2, device="cpu")


def test_serialize_block_round_trip_int8_gqa():
    rng = np.random.default_rng(5)
    a, b = _quantized_gqa_cache(), _quantized_gqa_cache()
    (blk_a,) = a.allocate(1)
    meta, zeros = a.serialize_block(blk_a)
    assert meta["geometry"]["num_kv_heads"] == 2
    assert meta["names"] == ["k", "k_scale", "v", "v_scale"]
    # fill the block with random codes+scales of the wire shapes,
    # then round-trip: cache A -> bytes -> cache B -> bytes
    payload = []
    for z in zeros:
        if z.dtype == torch.int8:
            payload.append(rng.integers(-128, 128, z.shape).astype(np.int8))
        else:
            assert z.dtype == torch.float32
            payload.append(rng.random(z.shape).astype(np.float32))
    a.deserialize_block(blk_a, meta, payload)
    meta2, out_a = a.serialize_block(blk_a)
    for got, want in zip(out_a, payload):
        np.testing.assert_array_equal(got.numpy(), want)
    (blk_b,) = b.allocate(1)
    b.deserialize_block(blk_b, meta2, out_a)
    _, out_b = b.serialize_block(blk_b)
    for got, want in zip(out_b, payload):
        np.testing.assert_array_equal(got.numpy(), want)


def test_deserialize_rejects_mismatched_pools():
    a = _quantized_gqa_cache()
    (blk,) = a.allocate(1)
    meta, arrays = a.serialize_block(blk)

    other_geo = PagedKVCache(num_layers=2, num_heads=4, head_dim=8,
                             num_blocks=6, block_size=8, kv_dtype="int8",
                             num_kv_heads=2, device="cpu")
    (dst,) = other_geo.allocate(1)
    with pytest.raises(ValueError, match="matching pool geometry"):
        other_geo.deserialize_block(dst, meta, arrays)

    dense = PagedKVCache(num_layers=2, num_heads=4, head_dim=4,
                         num_blocks=6, block_size=8, num_kv_heads=2, device="cpu")
    (dst,) = dense.allocate(1)
    with pytest.raises(ValueError, match="int8 codes are meaningless"):
        dense.deserialize_block(dst, meta, arrays)

    b = _quantized_gqa_cache()
    (dst,) = b.allocate(1)
    with pytest.raises(ValueError, match="truncated handoff payload"):
        b.deserialize_block(dst, meta, arrays[:-1])


# ---------------------------------------------------------------------------
# the port's frames against the JAX package's: one wire format
# ---------------------------------------------------------------------------

def _bits(x):
    """A bf16 blob's raw int16 bits, from a torch tensor (the port's
    read) or an ml_dtypes array (the JAX package's read)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def test_frames_interchange_with_jax_transport_bitwise():
    """A frame the JAX package packs (an ml_dtypes bfloat16 blob beside
    f32, int8 and int32 ones) is read by the port with every blob's bits
    intact, bf16 as a torch tensor; the port re-packs it to the same
    bytes; and a frame the port packs from torch tensors is read by the
    JAX package bitwise, bf16 under the dtype string "bfloat16"."""
    import ml_dtypes
    from paddle_tpu.serving import transport as jt
    rng = np.random.default_rng(9)
    bf = rng.standard_normal((2, 3, 8, 4)).astype(ml_dtypes.bfloat16)
    f32 = rng.standard_normal((5, 7)).astype(np.float32)
    i8 = rng.integers(-128, 128, (3, 4)).astype(np.int8)
    i32 = np.arange(6, dtype=np.int32).reshape(2, 3)
    frame = jt.pack_frame({"method": "x", "n": 3}, [bf, f32, i8, i32])
    header, blobs = read_frame(io.BytesIO(frame))
    assert [b["dtype"] for b in header["blobs"]] == \
        ["bfloat16", "float32", "int8", "int32"]
    assert isinstance(blobs[0], torch.Tensor)
    assert blobs[0].dtype == torch.bfloat16
    assert blobs[0].shape == bf.shape
    np.testing.assert_array_equal(_bits(blobs[0]), _bits(bf))
    for got, want in zip(blobs[1:], (f32, i8, i32)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    h2 = {k: v for k, v in header.items() if k != "blobs"}
    assert pack_frame(h2, blobs) == frame
    # the reverse, from torch tensors
    tb = torch.from_numpy(f32).bfloat16()
    frame2 = pack_frame({"method": "y"}, [tb, torch.from_numpy(i8),
                                          torch.from_numpy(f32)])
    jh, jb = jt.read_frame(io.BytesIO(frame2))
    assert jb[0].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(_bits(jb[0]), _bits(tb))
    np.testing.assert_array_equal(jb[1], i8)
    np.testing.assert_array_equal(jb[2], f32)
    assert jt.pack_frame({"method": "y"}, jb) == frame2


def test_bf16_block_over_the_wire_equals_donor_bitwise():
    """A bf16 KV block serialized by the port, framed, read back by both
    packages: the bits equal the donor block's; deserialized into
    another port cache (and into an f32 one, a cast) the rows are the
    donor's exactly; a JAX bf16 block serialized by the JAX cache lands
    in the port bitwise."""
    import jax.numpy as jnp
    from paddle_tpu.serving import kv_cache as jkvc
    from paddle_tpu.serving import transport as jt
    g = torch.Generator().manual_seed(3)
    a = PagedKVCache(2, 4, 8, 5, block_size=4, device="cpu",
                     kv_dtype="bf16", num_kv_heads=2)
    (blk,) = a.allocate(1)
    for layer in a.pools:
        for name in ("k", "v"):
            layer[name][blk] = torch.randn((2, 4, 8), generator=g) \
                .bfloat16()
    meta, arrays = a.serialize_block(blk)
    assert all(x.dtype == torch.bfloat16 for x in arrays)
    frame = pack_frame({"meta": meta}, arrays)
    h, blobs = read_frame(io.BytesIO(frame))
    _jh, jblobs = jt.read_frame(io.BytesIO(frame))
    for got, jgot, want in zip(blobs, jblobs, arrays):
        np.testing.assert_array_equal(_bits(got), _bits(want))
        np.testing.assert_array_equal(_bits(jgot), _bits(want))
    b = PagedKVCache(2, 4, 8, 7, block_size=4, device="cpu",
                     kv_dtype="bf16", num_kv_heads=2)
    c = PagedKVCache(2, 4, 8, 7, block_size=4, device="cpu",
                     num_kv_heads=2)
    b.deserialize_block(3, h["meta"], blobs)
    # the JAX package's read gives ml_dtypes arrays: their bits, as the
    # port's transport would have read them
    c.deserialize_block(3, h["meta"], [
        torch.from_numpy(_bits(x)).view(torch.bfloat16) for x in jblobs])
    for la, lb, lc in zip(a.pools, b.pools, c.pools):
        for name in ("k", "v"):
            assert torch.equal(lb[name][3], la[name][blk])
            assert torch.equal(lc[name][3], la[name][blk].float())
    # a block the JAX cache serializes lands in the port bitwise
    j = jkvc.PagedKVCache(2, 4, 8, 5, block_size=4, dtype=jnp.bfloat16,
                          num_kv_heads=2)
    rows = np.asarray(jnp.asarray(
        np.random.default_rng(4).standard_normal((2, 4, 8)),
        jnp.bfloat16))
    for li in range(2):
        for name in ("k", "v"):
            j.pools[li][name] = j.pools[li][name].at[2].set(rows)
    jmeta, jarr = j.serialize_block(2)
    jframe = jt.pack_frame({"meta": jmeta}, jarr)
    h3, blobs3 = read_frame(io.BytesIO(jframe))
    b.deserialize_block(4, h3["meta"], blobs3)
    for li in range(2):
        for name in ("k", "v"):
            np.testing.assert_array_equal(_bits(b.pools[li][name][4]),
                                          _bits(rows))
