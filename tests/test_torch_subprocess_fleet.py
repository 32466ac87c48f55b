"""Twins of tests/api/test_subprocess_fleet.py on the port
(paddle_tpu_torch), on the CPU: REAL worker processes
(``python -m paddle_tpu_torch.serving.worker``) behind the transport
seam (serving/remote.py spawn + proxy, serving/worker.py host loop),
each restoring the module's checkpoint and serving with
``device="cpu"``, on one torch thread (``OMP_NUM_THREADS=1`` in the
environment the workers inherit).

`proc`-marked: every test spawns actual subprocess workers (at most two
at a time) and the chaos kills are REAL ``os.kill(pid, SIGKILL)``. The
module's own ``port_workers`` fixture SIGKILLs any port worker still
alive on teardown (the shared ``proc_fleet`` fixture sweeps the JAX
package's workers only). No test sleeps: process exits are awaited with
``Popen.wait``. The contract under test:

- a subprocess replica reproduces the in-process engine BITWISE (same
  checkpoint, same prompts, same streams) and reports its pid, its
  device and the paged kernel's launch count (0 on the CPU) on its own
  /healthz HTTP endpoint and through ``get_stats()``. The reference's
  other half, one fused jit signature for the process lifetime, is a
  JAX compile-count fact with no counterpart in the port's eager step;
- the SIGKILL storm: a real process death mid-decode plus a poison
  prompt on a 2-worker fleet; failover, the crash-loop breaker,
  resurrection with re-warm and the poison quarantine run unchanged
  over the wire; non-poison requests complete bitwise against a clean
  in-process reference, the poison is quarantined within 2 process
  deaths, and the fleet returns to full strength on new pids;
- SIGTERM (PreemptionHandler) propagates: workers drain in-flight
  requests and their processes EXIT 0;
- a receiver dying mid-handoff surfaces TransportError while the
  donor's refcounts and free list stay exactly consistent;
- a worker asked for the card on a machine without one exits non-zero
  before its ready line.

The reference tests of this file have failed in full-suite runs under
six workers (each of its four, in one run or another); their twins are
held to the port's own in-process server and to counts derived from the
storm's script, not to the JAX run.
"""

import json
import os
import signal
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import framework
from paddle_tpu_torch.core.executor import Scope, scope_guard
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.robustness import (ChaosInjector, CheckpointManager,
                                         PoisonRequestError,
                                         PreemptionHandler,
                                         SupervisorConfig)
from paddle_tpu_torch.serving import (FleetRouter, GenerationServer,
                                      GPTServingModel, TransportError)
from paddle_tpu_torch.serving import remote
from paddle_tpu_torch.serving.prefix_cache import prompt_chain_keys
from paddle_tpu_torch.serving.remote import make_subprocess_spawn
from paddle_tpu_torch.serving.worker import export_chain

pytestmark = [pytest.mark.fleet, pytest.mark.chaos, pytest.mark.proc]

SERVER_KW = dict(num_slots=3, block_size=8, max_context=64, chunk=4,
                 start=False, prefix_cache=True)
WORKER_KW = dict(SERVER_KW, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module: the suite runs several pytest workers at
    once, and torch's default of one thread a core oversubscribes the
    CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def port_workers(monkeypatch):
    """Workers inherit OMP_NUM_THREADS=1 (one torch thread each, for the
    same reason as this module's); at teardown every port worker still
    alive is SIGKILLed and reaped, so a test that fails mid-storm leaks
    no process. Yields ``remote.live_workers`` for assertions."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield remote.live_workers
    for p in remote.live_workers():
        try:
            p.send_signal(signal.SIGKILL)
        except OSError:
            pass
        p.wait(timeout=30)


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
    return cfg, gpt.load_params(scope, cfg), main, scope, exe


@pytest.fixture(scope="module")
def ckpt_dir(tiny_gpt, tmp_path_factory):
    """One checkpoint for every spawn in the module."""
    cfg, params, main, scope, exe = tiny_gpt
    root = str(tmp_path_factory.mktemp("fleet_ckpt"))
    CheckpointManager(root, program=main).save(exe, step=0, scope=scope)
    return root


def _server(params, cfg, **kw):
    return GenerationServer(GPTServingModel(params, cfg, device="cpu"),
                            device="cpu", **dict(SERVER_KW, **kw))


def _reference_ids(params, cfg, prompts, n_new):
    srv = _server(params, cfg)
    futs = [srv.submit(p, max_new_tokens=n_new) for p in prompts]
    srv.run_until_idle()
    ids = [list(f.result(timeout=5).token_ids) for f in futs]
    srv.close()
    return ids


def test_subprocess_worker_is_bitwise_and_reports_its_device(
        tiny_gpt, ckpt_dir, port_workers):
    """Same checkpoint, same prompts: the subprocess backend is
    indistinguishable from the in-process engine (token ids bitwise,
    stream callbacks in emission order), and its /healthz (over real
    HTTP) and get_stats() report its pid, the CPU and 0 kernel
    launches."""
    cfg, params, *_ = tiny_gpt
    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, cfg.vocab_size,
                            int(rng.integers(9, 20))).astype(np.int32)
               for _ in range(3)]
    ref = _reference_ids(params, cfg, prompts, 6)

    w = make_subprocess_spawn(ckpt_dir, cfg, **WORKER_KW)(0)
    try:
        assert w.remote and w.pid != os.getpid()
        toks = {}
        futs = [w.submit(p, max_new_tokens=6,
                         stream=lambda r, t: toks.setdefault(r, [])
                         .append(t))
                for p in prompts]
        w.run_until_idle()
        got = [list(f.result(timeout=30).token_ids) for f in futs]
        assert got == ref
        for f, ids in zip(futs, got):
            assert toks[f.request_id] == ids
        body = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{w.http_port}/healthz", timeout=30).read())
        assert body["pid"] == w.pid
        assert body["device"] == "cpu"
        assert body["paged_launches"] == 0
        st = w.get_stats()
        assert st["device"] == "cpu" and st["kernel"]["launches"] == 0
        assert st["retired"] == 3
    finally:
        w.close()
    assert not port_workers(), "worker process leaked past close()"


def test_sigkill_storm_bitwise_failover_and_poison_quarantine(
        tiny_gpt, ckpt_dir, port_workers, tmp_path):
    """The storm with REAL process deaths: kill@3 on replica 0 (os.kill
    SIGKILL from inside the router step) plus a poison prompt, on a
    2-worker fleet with resurrection. Every non-poison request lands
    bitwise against a clean in-process reference; the poison is
    quarantined within 2 deaths; the fleet ends at full strength with
    slot 0 on a NEW pid."""
    cfg, params, *_ = tiny_gpt
    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, cfg.vocab_size,
                            int(rng.integers(9, 20))).astype(np.int32)
               for _ in range(5)]
    poison = rng.integers(3, cfg.vocab_size, 12).astype(np.int32)
    ref = _reference_ids(params, cfg, prompts, 6)

    chaos = (ChaosInjector()
             .kill_process_at(3, 0)
             .poison_prompt(poison))
    # flight_dir on the WORKERS too: their fault postmortems must land
    # in tmp, not the cwd (server_kwargs ride the spec into each proc)
    spawn = make_subprocess_spawn(ckpt_dir, cfg, chaos=chaos,
                                  flight_dir=str(tmp_path), **WORKER_KW)
    workers = [spawn(i) for i in range(2)]
    pid0 = workers[0].pid
    # the reference's 3-replica fleet allows 3 failovers a request
    # (max_failovers defaults to the replica count); two workers keep
    # that allowance explicitly: an innocent request rides the kill and
    # both poison deaths
    router = FleetRouter(workers, start=False, chaos=chaos,
                         spawn_fn=spawn, flight_dir=str(tmp_path),
                         max_failovers=3,
                         supervisor=SupervisorConfig(backoff_heartbeats=1,
                                                     warm_chains=2))
    futs = [router.submit(p, max_new_tokens=6) for p in prompts[:3]]
    router.step()
    router.step()
    pfut = router.submit(poison, max_new_tokens=6)
    for p in prompts[3:]:
        futs.append(router.submit(p, max_new_tokens=6))
        router.step()
    router.run_until_idle()

    ids = [list(f.result(timeout=30).token_ids) for f in futs]
    assert ids == ref, "failover must be bitwise across process deaths"
    with pytest.raises(PoisonRequestError) as ei:
        pfut.result(timeout=30)
    assert ei.value.deaths <= 2
    assert chaos.fired["process_kill"] == 1

    live = [r for r in router.replicas() if r.accepting()]
    assert len(live) == 2, "fleet must return to full strength"
    r0 = router.replicas()[0]
    assert r0.backend == "subprocess"
    assert r0.generation >= 1 and r0.pid != pid0, \
        "slot 0 must be resurrected as a NEW process"
    assert router.counts["resurrections"] >= 1
    assert router.counts["quarantines"] == 1
    procs = [r.server._proc for r in router.replicas()
             if r.server._proc is not None]
    router.close()
    for p in procs:
        p.wait(timeout=30)
    assert not port_workers(), "worker processes leaked past close()"


def test_preempt_drain_propagates_and_workers_exit_zero(
        tiny_gpt, ckpt_dir, port_workers):
    """SIGTERM (the PreemptionHandler flag) reaches the worker
    PROCESSES: in-flight requests finish, every replica reports
    drained, and the workers exit rc=0, a graceful shutdown, not the
    teardown SIGKILL path."""
    cfg, params, *_ = tiny_gpt
    rng = np.random.default_rng(7)
    spawn = make_subprocess_spawn(ckpt_dir, cfg, **WORKER_KW)
    workers = [spawn(i) for i in range(2)]
    procs = [w._proc for w in workers]
    handler = PreemptionHandler()
    router = FleetRouter(workers, start=False, preemption=handler)
    futs = [router.submit(rng.integers(3, cfg.vocab_size,
                                       12).astype(np.int32),
                          max_new_tokens=8) for _ in range(4)]
    router.step()
    router.step()
    handler.request()
    router.run_until_idle()
    for f in futs:
        assert len(f.result(timeout=30).token_ids) == 8
    assert router.counts["preempt_drains"] == 1
    for r in router.replicas():
        assert r.state == "drained"
    router.close()
    assert [p.wait(timeout=30) for p in procs] == [0, 0], \
        "workers must EXIT cleanly on preempt, not be killed"
    assert not port_workers()


def test_receiver_death_mid_handoff_leaves_donor_consistent(
        tiny_gpt, ckpt_dir, port_workers):
    """Kill the receiving worker between export and import: the wire
    call fails with TransportError, and the donor (whose export pinned,
    serialized, and unreffed in a finally before any bytes traveled)
    keeps exactly its pre-handoff refcounts/free list and still serves
    bitwise."""
    cfg, params, *_ = tiny_gpt
    rng = np.random.default_rng(21)
    prompt = rng.integers(3, cfg.vocab_size, 24).astype(np.int32)
    ref = _reference_ids(params, cfg, [prompt], 4)

    donor = _server(params, cfg)
    donor.submit(prompt, max_new_tokens=4)
    donor.run_until_idle()
    keys = prompt_chain_keys(prompt, 8)
    free_before = len(donor.cache._free)
    refs_before = dict(donor.cache._ref)

    w = make_subprocess_spawn(ckpt_dir, cfg, **WORKER_KW)(0)
    chunks, arrays = export_chain(donor, prompt, keys)
    assert chunks
    assert len(donor.cache._free) == free_before
    assert dict(donor.cache._ref) == refs_before

    os.kill(w.pid, signal.SIGKILL)
    w._proc.wait(timeout=30)
    with pytest.raises(TransportError):
        w.import_chain(chunks, arrays)
    # donor untouched, and still correct
    assert len(donor.cache._free) == free_before
    assert dict(donor.cache._ref) == refs_before
    fut = donor.submit(prompt, max_new_tokens=4)
    donor.run_until_idle()
    assert list(fut.result(timeout=5).token_ids) == ref[0]
    donor.close()
    w.close()
    assert not port_workers()


def test_wire_handoff_between_workers_equals_donor_blocks(
        tiny_gpt, ckpt_dir, port_workers):
    """A disaggregated pair of worker PROCESSES: the prefill worker's
    chain moves to the decode worker over the RPC (export_chain /
    import_chain), the moved blocks' rows are bitwise the donor's, and
    the request's ids equal the in-process server's."""
    cfg, params, *_ = tiny_gpt
    from paddle_tpu_torch.serving import RouterPolicy
    rng = np.random.default_rng(31)
    prompts = [rng.integers(3, cfg.vocab_size, 19).astype(np.int32)
               for _ in range(2)]
    ref = _reference_ids(params, cfg, prompts, 5)
    spawn = make_subprocess_spawn(ckpt_dir, cfg, **WORKER_KW)
    workers = [spawn(i) for i in range(2)]
    router = FleetRouter(workers, start=False, policy=RouterPolicy(
        "disaggregated", prefill=(0,), decode=(1,)))
    futs = [router.submit(p, max_new_tokens=5) for p in prompts]
    router.run_until_idle()
    assert [list(f.result(timeout=30).token_ids) for f in futs] == ref
    assert router.counts["handoff_blocks"] == 2 * len(prompts)
    # the donor's chain, exported again, equals what the receiver holds
    keys = prompt_chain_keys(prompts[0], 8)
    dchunks, darr = workers[0].export_chain(prompts[0], keys)
    rchunks, rarr = workers[1].export_chain(prompts[0], keys)
    assert [c["key"] for c in dchunks] == [c["key"] for c in rchunks]
    assert len(darr) == len(rarr) > 0
    for a, b in zip(darr, rarr):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    procs = [w._proc for w in workers]
    router.close()
    for p in procs:
        p.wait(timeout=30)
    assert not port_workers()


def test_worker_without_a_card_exits_before_ready(tiny_gpt, ckpt_dir,
                                                  port_workers):
    """A worker left at the default device (the card) on a machine
    without CUDA fails its boot and exits non-zero before the ready
    handshake: spawn raises, and no process is left."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    cfg, *_ = tiny_gpt
    spawn = make_subprocess_spawn(ckpt_dir, cfg, **SERVER_KW)
    with pytest.raises(RuntimeError, match="before the ready handshake"):
        spawn(0)
    for p in list(remote._LIVE_WORKERS):
        p.wait(timeout=30)
    assert not port_workers()
