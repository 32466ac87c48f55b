"""The port's asynchronous Executor against the JAX package's, on the CPU.

Twins, case for case, of ``tests/api/test_async_executor.py``: the same
tiny program (fc 4 -> 8, square error, SGD 0.1) built in both packages
under fresh unique-name generators, the JAX startup's weights carried into
the port (``scope_from_numpy`` over the port's own startup, so both
executors' step counters agree), and the same seeded numpy feeds. Within a
package async equals sync bitwise; across packages the losses agree within
LOSS_RTOL. ``FetchHandle`` ordering and resolution, the bounded window,
errors delivered at ``result()``, ``close()`` / ``drain()``, ``@GRAD``
fetches in flight, ``run_pipelined`` with a ``FeedBucketer``, and the
Program uid and shared-feed satellites.

Three cases of the reference check its jit cache, which the port does not
have (its Executor compiles no step); each twin holds the contract the
cache case stands for instead, and says so: a bounded number of bucketed
feed shapes, a Program uid that no clone or new Program reuses, and one
canonicalization of an array fed under two names. The port's feed policy
keeps int64 ids as int64 where the JAX package narrows them to int32 and
raises past 2**31, so the int64 twin holds the pipelined path to the
port's own policy (``run()``'s). On the CPU a step is done when its
dispatch returns; the card's overlap is chip_smoke.py's phase 26.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core.bucketing import FeedBucketer as JBucketer
from paddle_tpu.core.executor import Scope as JScope

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import executor as executor_mod
from paddle_tpu_torch.core import framework
from paddle_tpu_torch.core.bucketing import FeedBucketer
from paddle_tpu_torch.core.executor import FetchHandle
from paddle_tpu_torch.core.framework import grad_var_name

pytestmark = [getattr(pytest.mark, "async")]

CPU = fluid.CPUPlace()
# f32 losses of the tiny fc net, JAX against the port, from one scope:
# the same arithmetic in other kernels
LOSS_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_train.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def train_net(pkg, hidden=8, masked=False):
    """(main, startup, loss) of the tiny train program in `pkg` (the JAX
    package or the port), under a fresh unique-name generator so both
    packages name every variable alike."""
    layers = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = layers.data("x", shape=[4], dtype="float32")
        y = layers.data("y", shape=[1], dtype="float32")
        per = layers.square_error_cost(layers.fc(x, size=hidden), y)
        if masked:
            m = layers.data("batch_mask", shape=[1], dtype="float32")
            loss = layers.elementwise_div(
                layers.reduce_sum(layers.elementwise_mul(per, m)),
                layers.reduce_sum(m))
        else:
            loss = layers.mean(per)
        pkg.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def feed(batch=8, seed=0):
    r = np.random.default_rng(seed)
    return {"x": r.standard_normal((batch, 4)).astype(np.float32),
            "y": r.standard_normal((batch, 1)).astype(np.float32)}


def twin(build=train_net, window=2, guard=None, **kw):
    """The same program in both packages from one set of weights:
    ((jexe, jmain, jloss, jscope), (exe, main, loss, scope))."""
    jmain, jstart, jloss = build(jfluid, **kw)
    jscope = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace(), async_window=window,
                           guard=guard)
    jexe.run(jstart, scope=jscope)
    main, start, loss = build(fluid, **kw)
    scope = fluid.Scope()
    exe = fluid.Executor(CPU, async_window=window, guard=guard)
    exe.run(start, scope=scope)
    fluid.scope_from_numpy({n: np.asarray(jscope.get(n))
                            for n in jscope.names()}, "cpu", scope)
    return (jexe, jmain, jloss, jscope), (exe, main, loss, scope)


def port(build=train_net, window=2, guard=None, **kw):
    """The port's half of twin(): (exe, main, loss, scope)."""
    return twin(build, window, guard, **kw)[1]


# ---------------------------------------------------------------------------
# correctness: async == sync, in order and out of order
# ---------------------------------------------------------------------------

def test_async_losses_match_sync_exactly():
    (jexe, jmain, jloss, jscope), (exe, main, loss, scope) = twin()
    _, (exe_a, main_a, loss_a, scope_a) = twin()
    feeds = [feed(seed=i) for i in range(4)]
    ref = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
           for f in feeds]
    handles = [exe_a.run_async(main_a, feed=f, fetch_list=[loss_a],
                               scope=scope_a) for f in feeds]
    got = [h.result()[0] for h in handles]
    jref = [jexe.run(jmain, feed=f, fetch_list=[jloss], scope=jscope)[0]
            for f in feeds]
    for r, g, j in zip(ref, got, jref):
        np.testing.assert_array_equal(r, g)     # bitwise within the port
        np.testing.assert_allclose(g, j, rtol=LOSS_RTOL)


def test_handles_resolve_out_of_order():
    _, (exe_s, main_s, loss_s, scope_s) = twin()
    (jexe, jmain, jloss, jscope), (exe, main, loss, scope) = twin(window=4)
    feeds = [feed(seed=i) for i in range(3)]
    ref = [exe_s.run(main_s, feed=f, fetch_list=[loss_s], scope=scope_s)[0]
           for f in feeds]
    hs = [exe.run_async(main, feed=f, fetch_list=[loss], scope=scope)
          for f in feeds]
    jhs = [jexe.run_async(jmain, feed=f, fetch_list=[jloss], scope=jscope)
           for f in feeds]
    # resolve newest first: each handle still carries ITS OWN step
    for i in (2, 0, 1, 1):          # the last: a resolved handle again
        np.testing.assert_array_equal(hs[i].result()[0], ref[i])
        np.testing.assert_allclose(hs[i].result()[0], jhs[i].result()[0],
                                   rtol=LOSS_RTOL)
    assert hs[0].done() and exe.get_stats()["async"]["inflight"] == 0


def test_result_return_numpy_false_keeps_device_arrays():
    exe, main, loss, scope = port()
    h = exe.run_async(main, feed=feed(), fetch_list=[loss], scope=scope)
    out = h.result(return_numpy=False)
    assert isinstance(out[0], torch.Tensor)
    assert out[0].device == exe.device


# ---------------------------------------------------------------------------
# the bounded window
# ---------------------------------------------------------------------------

def test_window_bounds_inflight_depth():
    (jexe, jmain, jloss, jscope), (exe, main, loss, scope) = twin(window=2)
    for i in range(6):
        exe.run_async(main, feed=feed(seed=i), fetch_list=[loss],
                      scope=scope)
        jexe.run_async(jmain, feed=feed(seed=i), fetch_list=[jloss],
                       scope=jscope)
        assert len(exe._inflight) <= 2
    s, js = exe.get_stats()["async"], jexe.get_stats()["async"]
    assert s["dispatches"] == js["dispatches"] == 6
    assert s["window"] == js["window"] == 2
    # dispatches past the window admission-blocked on the oldest step
    assert s["window_waits"] == js["window_waits"] >= 4
    assert s["host_sync_wait_ms"]["count"] >= 4
    exe.drain()
    jexe.drain()
    assert exe.get_stats()["async"]["inflight"] == 0


def test_per_call_window_override():
    exe, main, loss, scope = port(window=4)
    for i in range(5):
        exe.run_async(main, feed=feed(seed=i), fetch_list=[loss],
                      scope=scope, window=1)
        assert len(exe._inflight) <= 1


# ---------------------------------------------------------------------------
# error propagation
# ---------------------------------------------------------------------------

def bad_feed(jax_side):
    """A feed each package refuses at dispatch: the JAX package's int64
    policy raises OverflowError past 2**31; the port keeps int64, so its
    twin leaves out the label and meets the missing-feed ValueError."""
    if jax_side:
        return {"x": np.full((8, 4), 2**40, np.int64),
                "y": np.zeros((8, 1), np.float32)}
    return {"x": np.zeros((8, 4), np.float32)}


def test_dispatch_error_raises_at_result_not_dispatch():
    (jexe, jmain, jloss, jscope), (exe, main, loss, scope) = twin()
    h_bad = exe.run_async(main, feed=bad_feed(False), fetch_list=[loss],
                          scope=scope)          # no raise here
    jh_bad = jexe.run_async(jmain, feed=bad_feed(True), fetch_list=[jloss],
                            scope=jscope)
    assert isinstance(h_bad, FetchHandle)
    # the pipeline stays usable: later steps dispatch and resolve
    h_ok = exe.run_async(main, feed=feed(), fetch_list=[loss], scope=scope)
    jh_ok = jexe.run_async(jmain, feed=feed(), fetch_list=[jloss],
                           scope=jscope)
    with pytest.raises(ValueError, match="missing from feed"):
        h_bad.result()
    with pytest.raises(ValueError):
        h_bad.wait()          # failed handles re-raise on every wait
    with pytest.raises(OverflowError):
        jh_bad.result()
    np.testing.assert_allclose(h_ok.result()[0], jh_ok.result()[0],
                               rtol=LOSS_RTOL)
    assert exe.get_stats()["async"]["errors"] == 1
    assert jexe.get_stats()["async"]["errors"] == 1


def test_unknown_fetch_error_lands_in_handle():
    (jexe, jmain, _, jscope), (exe, main, _, scope) = twin()
    h = exe.run_async(main, feed=feed(), fetch_list=["nope"], scope=scope)
    jh = jexe.run_async(jmain, feed=feed(), fetch_list=["nope"],
                        scope=jscope)
    for handle in (h, jh):
        with pytest.raises(ValueError, match="not a variable"):
            handle.result()


def test_drain_empties_pipeline_and_errors_stay_with_their_handle():
    exe, main, loss, scope = port(window=4)
    h0 = exe.run_async(main, feed=feed(), fetch_list=[loss], scope=scope)
    # a dispatch failure never ENTERS the pipeline: its handle owns the
    # error, drain() of the healthy steps is unaffected
    h_bad = exe.run_async(main, feed=bad_feed(False), fetch_list=[loss],
                          scope=scope)
    h2 = exe.run_async(main, feed=feed(seed=1), fetch_list=[loss],
                       scope=scope)
    exe.drain()
    assert exe.get_stats()["async"]["inflight"] == 0
    assert np.isfinite(h0.result()[0]).all()
    assert np.isfinite(h2.result()[0]).all()
    with pytest.raises(ValueError):
        h_bad.result()


# ---------------------------------------------------------------------------
# close() drains the pipeline
# ---------------------------------------------------------------------------

def test_close_drains_pipeline_and_drops_gauges():
    from paddle_tpu_torch.observability import global_registry
    exe, main, loss, scope = port(window=4)
    hs = [exe.run_async(main, feed=feed(seed=i), fetch_list=[loss],
                        scope=scope) for i in range(3)]
    g = global_registry().get("executor.async.inflight")
    assert any(lbl.get("executor") == exe._exe_id for lbl, _ in g.series())
    exe.close()
    assert exe.get_stats()["async"]["inflight"] == 0
    # handles dispatched before close still resolve (the step already ran)
    assert np.isfinite(hs[0].result()[0]).all()
    assert not any(lbl.get("executor") == exe._exe_id
                   for lbl, _ in g.series())


# ---------------------------------------------------------------------------
# var@GRAD and parameter fetches with in-flight steps
# ---------------------------------------------------------------------------

def test_grad_fetch_async_matches_sync():
    (jexe, jmain, jloss, jscope), (exe, main, loss, scope) = twin(window=4)
    _, (exe_a, main_a, loss_a, scope_a) = twin(window=4)
    w = main.all_parameters()[0].name
    fetches = [loss.name, grad_var_name(w)]
    feeds = [feed(seed=i) for i in range(3)]
    ref = [exe.run(main, feed=f, fetch_list=fetches, scope=scope)
           for f in feeds]
    hs = [exe_a.run_async(main_a, feed=f, fetch_list=fetches,
                          scope=scope_a) for f in feeds]
    jref = [jexe.run(jmain, feed=f, fetch_list=fetches, scope=jscope)
            for f in feeds]
    for r, h, j in zip(ref, hs, jref):
        got = h.result()
        np.testing.assert_array_equal(r[0], got[0])
        # each in-flight step's grad belongs to ITS feed, not the last one
        np.testing.assert_array_equal(r[1], got[1])
        np.testing.assert_allclose(got[1], j[1], rtol=1e-5, atol=1e-7)


def test_param_fetch_keeps_value_across_inflight_steps():
    """The port's optimizers update the scope's tensors in place: a
    fetched parameter must be the value after ITS step, not what a later
    in-flight step wrote into the same tensor (run_async clones every
    fetch that aliases the scope's state at dispatch)."""
    (jexe, jmain, jloss, jscope), (exe, main, loss, scope) = twin(window=4)
    _, (exe_a, main_a, loss_a, scope_a) = twin(window=4)
    w = main.all_parameters()[0].name
    feeds = [feed(seed=i) for i in range(3)]
    ref = [exe.run(main, feed=f, fetch_list=[w], scope=scope)[0]
           for f in feeds]
    hs = [exe_a.run_async(main_a, feed=f, fetch_list=[w], scope=scope_a)
          for f in feeds]
    jref = [jexe.run(jmain, feed=f, fetch_list=[w], scope=jscope)[0]
            for f in feeds]
    assert not np.array_equal(ref[0], ref[1])
    for r, h, j in zip(ref, hs, jref):
        np.testing.assert_array_equal(h.result()[0], r)
        np.testing.assert_allclose(r, j, rtol=1e-6, atol=1e-7)
    live = scope_a.get(w)
    assert all(h.result(return_numpy=False)[0].data_ptr()
               != live.data_ptr() for h in hs)


# ---------------------------------------------------------------------------
# run_pipelined + FeedBucketer
# ---------------------------------------------------------------------------

def test_pipelined_dynamic_batches_bounded_cache(monkeypatch):
    """The reference bounds its jit cache; the port has none, so this
    twin holds the contract the bound stands for: 32 distinct batch
    sizes reach the step as at most log2(32)+1 = 6 feed shapes (what a
    CUDA graph a step, or the caching allocator, sees), with losses
    finite and equal to the JAX package's on the same bucketed feeds."""
    (jexe, jmain, jloss, jscope), (exe, main, loss, scope) = twin(
        masked=True)
    shapes = set()
    real = executor_mod._canon_feeds

    def spy(f, *a, **kw):
        out = real(f, *a, **kw)
        if "x" in out:
            shapes.add(tuple(out["x"].shape))
        return out

    monkeypatch.setattr(executor_mod, "_canon_feeds", spy)
    bucketer = FeedBucketer(mask_name="batch_mask")
    jbucketer = JBucketer(mask_name="batch_mask")
    sizes = list(range(1, 33))                        # 32 DISTINCT sizes
    outs = list(exe.run_pipelined(main, (feed(batch=n, seed=n)
                                         for n in sizes),
                                  fetch_list=[loss], scope=scope,
                                  bucketer=bucketer))
    jouts = list(jexe.run_pipelined(jmain, (feed(batch=n, seed=n)
                                            for n in sizes),
                                    fetch_list=[jloss], scope=jscope,
                                    bucketer=jbucketer))
    assert len(outs) == len(sizes)
    assert all(np.isfinite(o[0]).all() for o in outs)
    assert len(shapes) <= 6
    assert bucketer.get_stats()["shapes"] <= 6
    assert bucketer.get_stats() == jbucketer.get_stats()
    assert exe.get_stats()["async"]["dispatches"] == len(sizes)
    for o, j in zip(outs, jouts):
        np.testing.assert_allclose(o[0], j[0], rtol=1e-5)


def ids_net(pkg):
    layers = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        ids = layers.data("ids", shape=[4], dtype="int64")
        x = layers.data("x", shape=[4], dtype="float32")
        out = layers.scale(x, scale=2.0)
    return main, startup, (ids, out)


def test_pipelined_enforces_int64_policy():
    """The pipelined path canonicalizes feeds exactly as run() does, before
    the upload, under the port's own policy: int64 ids stay int64 (2**40
    arrives exact, never wrapped) and float64 narrows to float32. The JAX
    package's policy raises on the same ids (checked beside it)."""
    main, startup, (ids, out) = ids_net(fluid)
    exe = fluid.Executor(CPU)
    scope = fluid.Scope()
    f = {"ids": np.full((8, 4), 2**40, np.int64),
         "x": np.ones((8, 4), np.float64)}
    piped = list(exe.run_pipelined(main, [f], fetch_list=[ids, out],
                                   scope=scope, return_numpy=False))[0]
    ran = exe.run(main, feed=f, fetch_list=[ids, out], scope=scope,
                  return_numpy=False)
    for p, r in zip(piped, ran):
        assert p.dtype == r.dtype
        torch.testing.assert_close(p, r, rtol=0, atol=0)
    assert piped[0].dtype == torch.int64 and int(piped[0][0, 0]) == 2**40
    assert piped[1].dtype == torch.float32
    jmain, _, (jids, jout) = ids_net(jfluid)
    with pytest.raises(OverflowError, match="Integer dtypes"):
        list(jfluid.Executor(jfluid.CPUPlace()).run_pipelined(
            jmain, [f], fetch_list=[jids, jout], scope=JScope()))


def test_pipelined_results_in_feed_order():
    (jexe, jmain, jloss, jscope), (exe, main, loss, scope) = twin()
    _, (exe_r, main_r, loss_r, scope_r) = twin()
    feeds = [feed(seed=i) for i in range(5)]
    ref = [exe_r.run(main_r, feed=f, fetch_list=[loss_r], scope=scope_r)[0]
           for f in feeds]
    outs = list(exe.run_pipelined(main, feeds, fetch_list=[loss],
                                  scope=scope))
    jouts = list(jexe.run_pipelined(jmain, feeds, fetch_list=[jloss],
                                    scope=jscope))
    for r, o, j in zip(ref, outs, jouts):
        np.testing.assert_array_equal(r, o[0])
        np.testing.assert_allclose(o[0], j[0], rtol=LOSS_RTOL)


def test_async_refuses_data_parallel_program():
    """run_async refuses a data-parallel CompiledProgram, as the JAX
    package's does (its dp path places feeds and state synchronously)."""
    exe, main, loss, scope = port()
    comp = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, places=[CPU] * 2)
    with pytest.raises(NotImplementedError, match="data-parallel"):
        exe.run_async(comp, feed=feed(), fetch_list=[loss], scope=scope)


# ---------------------------------------------------------------------------
# satellites: Program.uid, the per-step feed identity cache
# ---------------------------------------------------------------------------

def test_program_uid_monotonic_and_survives_clone():
    p1, p2 = framework.Program(), framework.Program()
    assert p2.uid > p1.uid > 0
    c = p1.clone()
    assert c.uid not in (p1.uid, p2.uid)
    # uid is id()-recycling-proof by construction: a fresh Program never
    # reuses a dead Program's uid, so (uid, version) can't alias
    assert framework.Program().uid > c.uid


def test_jit_cache_keys_use_uid_not_id():
    """No jit cache in the port: the contract the reference's key check
    stands for is that a Program's identity is its uid, never id(). A
    Program built where a collected one lived (the same id() is likely)
    gets a uid no Program had, and a clone(for_test=True) of the train
    program runs on the same executor and scope without touching the
    train program's state."""
    exe, main, loss, scope = port()
    seen = set()
    for _ in range(8):
        p = framework.Program()
        assert p.uid not in seen
        seen.add(p.uid)
        del p
    test_prog = main.clone(for_test=True)
    assert test_prog.uid != main.uid
    w = main.all_parameters()[0].name
    before = scope.get(w).clone()
    exe.run(test_prog, feed=feed(), fetch_list=[loss], scope=scope)
    torch.testing.assert_close(scope.get(w), before, rtol=0, atol=0)
    exe.run(main, feed=feed(), fetch_list=[loss], scope=scope)
    assert not torch.equal(scope.get(w), before)


def test_feed_identity_cache_canonicalizes_shared_array_once(monkeypatch):
    """No jit cache in the port; its feed boundary keeps the reference's
    per-step identity cache: an array fed under two names is
    canonicalized and uploaded once, and both names hold one tensor."""
    calls = []
    real = executor_mod._canon_host

    def counting(a):
        calls.append(a)
        return real(a)

    monkeypatch.setattr(executor_mod, "_canon_host", counting)
    shared = np.ones((8, 4), np.float32)
    out = executor_mod._canon_feeds({"a": shared, "b": shared,
                                     "c": np.ones((8, 1), np.float32)},
                                    torch.device("cpu"))
    assert sum(c is shared for c in calls) == 1
    assert out["a"] is out["b"]
    assert tuple(out["c"].shape) == (8, 1)
