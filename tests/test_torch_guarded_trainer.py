"""The port's NaN/Inf guard, GuardedTrainer and CheckpointManager against
the JAX package's, on the CPU.

Twins, case for case, of ``tests/api/test_robustness.py``: the same tiny
program (``test_torch_async_executor.train_net``) in both packages, the
JAX startup's weights carried into the port, the same seeded feeds, and the
same deterministic faults (``ChaosInjector``: a poisoned step, a SIGTERM
at a step, failed checkpoint writes; injected clocks and backoff sleeps,
no real timing). Each case runs the scenario through both packages: the
counts (rollbacks, retries, skipped batches, steps, guard statistics) are
equal, the final weights agree within STATE_RTOL across packages, and
within the port the reference's bitwise claims hold bitwise (a rollback
and its replay, a resume, guarded against unguarded). One small BERT (2
layers, H 64) trains under GuardedTrainer with a poisoned step in both
packages: the port's losses match the JAX package's within BERT_RTOL.
"""

import os
import signal

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.io.checkpoint as jckpt
import paddle_tpu.robustness as jrob
from paddle_tpu.core.executor import Scope as JScope
from paddle_tpu.models import bert as jbert

import paddle_tpu_torch as fluid
import paddle_tpu_torch.io.checkpoint as tckpt
import paddle_tpu_torch.robustness as trob
from paddle_tpu_torch.models import bert as tbert

from test_torch_async_executor import train_net

pytestmark = [pytest.mark.chaos]

CPU = fluid.CPUPlace()
# the final weights of up to 10 SGD steps on the tiny net, port against
# JAX: f32, the same arithmetic in other kernels
STATE_RTOL, STATE_ATOL = 1e-5, 1e-7
# the small BERT's losses under GuardedTrainer (a rollback and its replay
# among the 6 steps), port against JAX, each step
BERT_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_train.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Side:
    """One package's surface under one name: the twins run each
    scenario once through each Side."""

    def __init__(self, name, pkg, rob, scope_cls, ckpt):
        self.name, self.pkg, self.rob = name, pkg, rob
        self.Scope, self.ckpt = scope_cls, ckpt
        self.place = pkg.CPUPlace()

    def host(self, value):
        """A copy on the host: the port's optimizers update the scope's
        tensors in place, so a view would change under the caller."""
        return value.detach().cpu().numpy().copy() \
            if isinstance(value, torch.Tensor) else np.asarray(value)

    def zeros_like(self, value):
        if isinstance(value, torch.Tensor):
            return torch.zeros_like(value)
        import jax.numpy as jnp
        return jnp.zeros_like(value)


JAX = Side("jax", jfluid, jrob, JScope, jckpt)
PORT = Side("port", fluid, trob, fluid.Scope, tckpt)
SIDES = (JAX, PORT)


def _weights():
    """The JAX startup's weights of train_net, once a call."""
    main, startup, _ = train_net(jfluid)
    scope = JScope()
    jfluid.Executor(jfluid.CPUPlace()).run(startup, scope=scope)
    return {n: np.asarray(scope.get(n)) for n in scope.names()}


def fresh(side, weights, guard=True, build=train_net):
    """(exe, main, loss, scope) of `side` from `weights`: its own
    startup (so step counters agree), then the carried values."""
    main, startup, loss = build(side.pkg)
    scope = side.Scope()
    exe = side.pkg.Executor(side.place, guard=guard)
    exe.run(startup, scope=scope)
    for n, v in weights.items():
        scope.set(n, torch.from_numpy(v.copy()) if side is PORT
                  else jfluid_asarray(v))
    return exe, main, loss, scope


def jfluid_asarray(v):
    import jax.numpy as jnp
    return jnp.asarray(v)


def feeds_of(n, batch=8, seed=0):
    r = np.random.default_rng(seed)
    return [{"x": r.standard_normal((batch, 4)).astype(np.float32),
             "y": r.standard_normal((batch, 1)).astype(np.float32)}
            for _ in range(n)]


def state(side, scope):
    return {n: side.host(scope.get(n)) for n in scope.names()}


def run_clean(side, weights, feeds, guard=True):
    exe, main, loss, scope = fresh(side, weights, guard)
    for f in feeds:
        exe.run(main, feed=f, fetch_list=[loss], scope=scope)
    return state(side, scope)


def assert_states(got, want, bitwise=False):
    assert sorted(got) == sorted(want)
    for n in want:
        if bitwise:
            np.testing.assert_array_equal(got[n], want[n], err_msg=n)
        else:
            np.testing.assert_allclose(got[n], want[n], rtol=STATE_RTOL,
                                       atol=STATE_ATOL, err_msg=n)


def poisoned(feed):
    bad = dict(feed)
    x = feed["x"].copy()
    x[0, 0] = np.nan
    bad["x"] = x
    return bad


def sticky_poison(chaos, target_feed):
    """Make `chaos` poison every dispatch of `target_feed` (original and
    replays) — a PERSISTENT fault, unlike poison_grad_at's fire-once
    transient."""
    orig = chaos.on_dispatch

    def sticky(step, feed):
        if feed is target_feed:
            chaos.poison_grad_at(step)      # arm for THIS dispatch
        return orig(step, feed)
    chaos.on_dispatch = sticky
    return chaos


@pytest.fixture(scope="module")
def weights():
    return _weights()


# ---------------------------------------------------------------------------
# sentinel: sync, async, structure
# ---------------------------------------------------------------------------

def test_sync_guard_raises_structured_error(weights):
    out = {}
    for side in SIDES:
        exe, main, loss, scope = fresh(side, weights)
        feeds = feeds_of(2)
        exe.run(main, feed=feeds[0], fetch_list=[loss], scope=scope)
        with pytest.raises(side.rob.NonFiniteError) as ei:
            exe.run(main, feed=poisoned(feeds[1]), fetch_list=[loss],
                    scope=scope)
        err = ei.value
        assert err.var == loss.name
        assert err.step == 2                 # startup=0, clean=1, bad=2
        assert any(b.endswith("@GRAD") for b in err.bad_vars)
        out[side.name] = (err.bad_vars, exe.get_stats()["fault"])
    assert out["port"] == out["jax"]
    assert out["port"][1] == {"guard_steps": 2, "nonfinite": 1,
                              "guarded": True}


def test_async_guard_raises_at_result_not_dispatch(weights):
    for side in SIDES:
        exe, main, loss, scope = fresh(side, weights)
        feeds = feeds_of(3)
        hs = [exe.run_async(main, feed=f, fetch_list=[loss], scope=scope,
                            window=4)
              for f in (feeds[0], poisoned(feeds[1]), feeds[2])]
        hs[0].result()                       # clean step resolves fine
        with pytest.raises(side.rob.NonFiniteError):
            hs[1].result()
        with pytest.raises(side.rob.NonFiniteError):
            hs[1].wait()                     # idempotent re-raise
        # the NaN flowed through the updated state: the NEXT step's own
        # sentinel trips too (each handle reports its own step)
        with pytest.raises(side.rob.NonFiniteError) as ei:
            hs[2].wait()
        assert ei.value.step == 3
        exe.drain()
        assert exe.get_stats()["async"]["inflight"] == 0


def test_drain_reraises_first_guard_error(weights):
    for side in SIDES:
        exe, main, loss, scope = fresh(side, weights)
        feeds = feeds_of(2)
        exe.run_async(main, feed=poisoned(feeds[0]), fetch_list=[loss],
                      scope=scope, window=4)
        exe.run_async(main, feed=feeds[1], fetch_list=[loss], scope=scope,
                      window=4)
        with pytest.raises(side.rob.NonFiniteError):
            exe.drain()
        assert exe.get_stats()["async"]["inflight"] == 0


def test_unguarded_executor_sails_through_nan(weights):
    for side in SIDES:
        exe, main, loss, scope = fresh(side, weights, guard=False)
        out = exe.run(main, feed=poisoned(feeds_of(1)[0]),
                      fetch_list=[loss], scope=scope)
        assert np.isnan(out[0]).any()
        assert exe.get_stats()["fault"]["guarded"] is False


def test_guard_env_var_opt_in(monkeypatch):
    for side in SIDES:
        monkeypatch.setenv("PADDLE_TPU_GUARD", "1")
        assert side.pkg.Executor(side.place)._guard is not None
        monkeypatch.setenv("PADDLE_TPU_GUARD", "0")
        assert side.pkg.Executor(side.place)._guard is None


def log_net(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[4], dtype="float32")
        out = pkg.layers.log(x)              # log(-1) = nan, no optimizer
    return main, startup, out


def test_guard_checks_fetches_on_forward_only_program():
    for side in SIDES:
        main, startup, out = log_net(side.pkg)
        scope = side.Scope()
        exe = side.pkg.Executor(side.place, guard=True)
        exe.run(startup, scope=scope)
        ok = exe.run(main, feed={"x": np.ones((2, 4), np.float32)},
                     fetch_list=[out], scope=scope)
        assert np.isfinite(ok[0]).all()
        with pytest.raises(side.rob.NonFiniteError) as ei:
            exe.run(main, feed={"x": -np.ones((2, 4), np.float32)},
                    fetch_list=[out], scope=scope)
        assert ei.value.var == out.name


def test_guarded_matches_unguarded_bitwise(weights):
    # the sentinel only reads: it must not change a single bit of the
    # training arithmetic
    feeds = feeds_of(4)
    for side in SIDES:
        assert_states(run_clean(side, weights, feeds, guard=True),
                      run_clean(side, weights, feeds, guard=False),
                      bitwise=True)
    assert_states(run_clean(PORT, weights, feeds),
                  run_clean(JAX, weights, feeds))


# ---------------------------------------------------------------------------
# poisoned grad at step k + one failed checkpoint write -> one rollback,
# the clean run's finish (bitwise within a package)
# ---------------------------------------------------------------------------

def test_rollback_resumes_bitwise_with_failed_checkpoint_write(tmp_path,
                                                               weights):
    n = 10
    feeds = feeds_of(n)
    finals = {}
    for side in SIDES:
        ref = run_clean(side, weights, feeds)
        exe, main, loss, scope = fresh(side, weights)
        manager = side.rob.CheckpointManager(
            str(tmp_path / side.name), keep=3, program=main,
            sleep_fn=lambda s: None)
        chaos = side.rob.ChaosInjector().poison_grad_at(5) \
            .fail_checkpoint_write(nth=3)
        with chaos:
            trainer = side.rob.GuardedTrainer(
                exe, main, fetch_list=[loss], scope=scope, manager=manager,
                checkpoint_every=2, chaos=chaos, window=2)
            res = trainer.train(feeds)
        assert res.steps == n
        assert res.rollbacks == 1
        assert len(res.faults) == 1 and res.faults[0].var == loss.name
        assert chaos.fired["poison"] == 1
        assert chaos.fired["write_fault"] == 1
        finals[side.name] = state(side, scope)
        assert_states(finals[side.name], ref, bitwise=True)
    assert_states(finals["port"], finals["jax"])


def test_rollback_retries_exhaust_then_surface(tmp_path, weights):
    for side in SIDES:
        feeds = feeds_of(8)
        exe, main, loss, scope = fresh(side, weights)
        chaos = sticky_poison(side.rob.ChaosInjector(), feeds[3])
        trainer = side.rob.GuardedTrainer(
            exe, main, fetch_list=[loss], scope=scope,
            checkpoint_dir=str(tmp_path / side.name), checkpoint_every=4,
            chaos=chaos, window=2,
            policy=side.rob.RecoveryPolicy(max_retries=2))
        with pytest.raises(side.rob.NonFiniteError):
            trainer.train(feeds)
        assert trainer._stats.local.get(
            "executor.fault.rollbacks").value() == 2


def test_skip_bad_batch_policy_drops_offender(tmp_path, weights):
    n = 8
    feeds = feeds_of(n)
    finals = {}
    for side in SIDES:
        ref = run_clean(side, weights, feeds[:3] + feeds[4:])
        exe, main, loss, scope = fresh(side, weights)
        chaos = sticky_poison(side.rob.ChaosInjector(), feeds[3])
        trainer = side.rob.GuardedTrainer(
            exe, main, fetch_list=[loss], scope=scope,
            checkpoint_dir=str(tmp_path / side.name), checkpoint_every=4,
            chaos=chaos, window=2,
            policy=side.rob.RecoveryPolicy(max_retries=2,
                                           skip_bad_batch=True))
        res = trainer.train(feeds)
        assert res.steps == n - 1
        assert res.skipped == [3]
        finals[side.name] = state(side, scope)
        assert_states(finals[side.name], ref, bitwise=True)
    assert_states(finals["port"], finals["jax"])


def test_lr_backoff_hook_halves_lr_on_rollback(tmp_path, weights):
    for side in SIDES:
        feeds = feeds_of(6)
        exe, main, loss, scope = fresh(side, weights)
        lr_name = [n for n in scope.names() if "learning_rate" in n][0]
        chaos = side.rob.ChaosInjector().poison_grad_at(2)
        trainer = side.rob.GuardedTrainer(
            exe, main, fetch_list=[loss], scope=scope,
            checkpoint_dir=str(tmp_path / side.name), checkpoint_every=2,
            chaos=chaos, window=1,
            policy=side.rob.RecoveryPolicy(
                on_rollback=[side.rob.lr_backoff(lr_name, 0.5)]))
        res = trainer.train(feeds)
        assert res.rollbacks == 1
        assert side.host(scope.get(lr_name)) == pytest.approx(0.05)


def amp_net(pkg, decorate):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[4], dtype="float32")
        y = pkg.layers.data("y", shape=[1], dtype="float32")
        loss = pkg.layers.mean(pkg.layers.square_error_cost(
            pkg.layers.fc(x, size=8), y))
        opt = decorate(pkg.optimizer.SGDOptimizer(learning_rate=0.1),
                       init_loss_scaling=128.0)
        opt.minimize(loss)
    return main, startup, opt


def test_amp_rollback_hook_reduces_loss_scaling():
    from paddle_tpu.amp.decorator import decorate as jdecorate
    from paddle_tpu_torch.amp.decorator import decorate as tdecorate
    for side, decorate in ((JAX, jdecorate), (PORT, tdecorate)):
        main, startup, opt = amp_net(side.pkg, decorate)
        scope = side.Scope()
        side.pkg.Executor(side.place).run(startup, scope=scope)
        hook = opt.rollback_hook()           # default: decr_ratio (0.8)
        name = opt.get_loss_scaling().name
        before = float(side.host(scope.get(name)))
        hook(scope, None)
        assert float(side.host(scope.get(name))) \
            == pytest.approx(before * 0.8)


# ---------------------------------------------------------------------------
# preemption: chaos SIGTERM mid-window + real signal; emergency save
# ---------------------------------------------------------------------------

def test_chaos_preemption_drains_and_saves_then_resumes(tmp_path, weights):
    n = 10
    feeds = feeds_of(n)
    finals = {}
    for side in SIDES:
        ref = run_clean(side, weights, feeds)
        root = str(tmp_path / side.name)
        exe, main, loss, scope = fresh(side, weights)
        chaos = side.rob.ChaosInjector().sigterm_at(6)
        trainer = side.rob.GuardedTrainer(
            exe, main, fetch_list=[loss], scope=scope, checkpoint_dir=root,
            checkpoint_every=4, chaos=chaos, window=2)
        res = trainer.train(feeds)
        assert res.preempted and res.emergency_dir is not None
        assert res.steps == 6                # in-flight steps drained
        meta = side.ckpt.load_checkpoint(exe, res.emergency_dir,
                                         main_program=main,
                                         scope=side.Scope())
        assert meta["extra"]["emergency"] is True and meta["step"] == 6
        trainer2 = side.rob.GuardedTrainer(
            exe, main, fetch_list=[loss], scope=scope, checkpoint_dir=root,
            checkpoint_every=4, window=2)
        assert trainer2.resume()["step"] == 6
        res2 = trainer2.train(iter(feeds[6:]))
        assert res2.steps == n
        finals[side.name] = state(side, scope)
        assert_states(finals[side.name], ref, bitwise=True)
    assert_states(finals["port"], finals["jax"])


def test_real_sigterm_honored_between_steps(tmp_path, weights):
    for side in SIDES:
        feeds = feeds_of(10)
        exe, main, loss, scope = fresh(side, weights)
        handler = side.rob.PreemptionHandler(
            signals=(signal.SIGTERM,)).install()
        try:
            fired = []

            def cb(idx, out):
                if idx == 3 and not fired:
                    fired.append(1)
                    os.kill(os.getpid(), signal.SIGTERM)
            trainer = side.rob.GuardedTrainer(
                exe, main, fetch_list=[loss], scope=scope,
                checkpoint_dir=str(tmp_path / side.name),
                checkpoint_every=4, window=2, preemption=handler,
                result_callback=cb)
            res = trainer.train(feeds)
        finally:
            handler.uninstall()
        assert res.preempted and res.emergency_dir is not None
        assert 4 <= res.steps < 10
        assert not handler.requested()


# ---------------------------------------------------------------------------
# CheckpointManager: backoff, retention, fallback restore
# ---------------------------------------------------------------------------

def test_manager_write_retries_backoff_then_succeed(tmp_path, weights):
    for side in SIDES:
        exe, main, loss, scope = fresh(side, weights, guard=False)
        delays = []
        m = side.rob.CheckpointManager(
            str(tmp_path / side.name), program=main, retries=3,
            backoff_s=0.1, backoff_factor=2.0, sleep_fn=delays.append)
        with side.rob.ChaosInjector().fail_checkpoint_write(nth=1, times=2):
            d = m.save(exe, 1, scope=scope)
        assert os.path.exists(os.path.join(d, "meta.json"))
        assert delays == [0.1, 0.2]


def test_manager_write_retries_exhaust_then_surface(tmp_path, weights):
    for side in SIDES:
        exe, main, loss, scope = fresh(side, weights, guard=False)
        delays = []
        m = side.rob.CheckpointManager(str(tmp_path / side.name),
                                       program=main, retries=2,
                                       sleep_fn=delays.append)
        with side.rob.ChaosInjector().fail_checkpoint_write(nth=1,
                                                            times=99):
            with pytest.raises(side.rob.CheckpointError):
                m.save(exe, 1, scope=scope)
        assert len(delays) == 2


def test_manager_retention_keeps_last_k(tmp_path, weights):
    for side in SIDES:
        exe, main, loss, scope = fresh(side, weights, guard=False)
        m = side.rob.CheckpointManager(str(tmp_path / side.name), keep=2,
                                       program=main)
        for step in (1, 2, 3, 4):
            m.save(exe, step, scope=scope)
        kept = [os.path.basename(d) for d in m.checkpoints()]
        assert kept == ["ckpt-00000003", "ckpt-00000004"]


def test_manager_restore_falls_back_past_corrupt(tmp_path, weights):
    for side in SIDES:
        exe, main, loss, scope = fresh(side, weights, guard=False)
        m = side.rob.CheckpointManager(str(tmp_path / side.name), keep=3,
                                       program=main)
        m.save(exe, 1, scope=scope)
        w1 = side.host(scope.get("fc_0.w_0")).copy()
        exe.run(main, feed=feeds_of(1, seed=7)[0], fetch_list=[loss],
                scope=scope)
        d2 = m.save(exe, 2, scope=scope)
        with open(os.path.join(d2, "state.npz"), "r+b") as f:
            f.seek(100)
            f.write(b"\x00" * 8)
        s2 = side.Scope()
        meta = m.restore(exe, scope=s2)
        assert meta["step"] == 1
        np.testing.assert_array_equal(side.host(s2.get("fc_0.w_0")), w1)


def test_reused_checkpoint_root_without_resume_refused(tmp_path, weights):
    for side in SIDES:
        root = str(tmp_path / side.name)
        feeds = feeds_of(4)
        exe, main, loss, scope = fresh(side, weights)
        side.rob.GuardedTrainer(exe, main, fetch_list=[loss], scope=scope,
                                checkpoint_dir=root, checkpoint_every=2,
                                window=1).train(feeds)
        exe2, _, _, scope2 = fresh(side, weights)
        t2 = side.rob.GuardedTrainer(exe2, main, fetch_list=[loss],
                                     scope=scope2, checkpoint_dir=root,
                                     checkpoint_every=2, window=1)
        with pytest.raises(RuntimeError, match="resume"):
            t2.train(feeds)
        t2.resume()
        assert t2.step == 4


def test_fallback_past_segment_base_warns_and_continues(tmp_path, weights):
    for side in SIDES:
        n = 4
        feeds = feeds_of(n)
        exe, main, loss, scope = fresh(side, weights)
        root = tmp_path / side.name
        chaos = side.rob.ChaosInjector().poison_grad_at(3)

        def corrupt_latest(idx, out, root=root):
            if idx == 2:     # ckpt-00000002 committed before this resolved
                p = root / "ckpt-00000002" / "state.npz"
                with open(p, "r+b") as f:
                    f.seek(100)
                    f.write(b"\x00" * 8)
        trainer = side.rob.GuardedTrainer(
            exe, main, fetch_list=[loss], scope=scope,
            checkpoint_dir=str(root), checkpoint_every=2, chaos=chaos,
            window=1, result_callback=corrupt_latest)
        with pytest.warns(UserWarning, match="LOST"):
            res = trainer.train(feeds)
        assert res.rollbacks == 1
        assert res.steps == n


def test_equal_step_foreign_baseline_is_overwritten(tmp_path, weights):
    for side in SIDES:
        root = str(tmp_path / side.name)
        exe1, main1, loss1, scope1 = fresh(side, weights)
        side.rob.GuardedTrainer(exe1, main1, fetch_list=[loss1],
                                scope=scope1, checkpoint_dir=root,
                                checkpoint_every=2, window=1).train([])
        exe2, main2, loss2, scope2 = fresh(side, weights)
        w_name = [n for n in scope2.names() if n.endswith("w_0")][0]
        scope2.set(w_name, side.zeros_like(scope2.get(w_name)))
        seen = []
        chaos = side.rob.ChaosInjector().poison_grad_at(0)
        t2 = side.rob.GuardedTrainer(
            exe2, main2, fetch_list=[loss2], scope=scope2,
            checkpoint_dir=root, checkpoint_every=2, chaos=chaos, window=1,
            policy=side.rob.RecoveryPolicy(on_rollback=[
                lambda s, f: seen.append(side.host(s.get(w_name)))]))
        res = t2.train(feeds_of(2))
        assert res.rollbacks == 1 and res.steps == 2
        assert seen and not seen[0].any()


def test_rollback_hooks_compound_across_retries(tmp_path, weights):
    for side in SIDES:
        feeds = feeds_of(8)
        exe, main, loss, scope = fresh(side, weights)
        lr_name = [n for n in scope.names() if "learning_rate" in n][0]
        chaos = sticky_poison(side.rob.ChaosInjector(), feeds[2])
        trainer = side.rob.GuardedTrainer(
            exe, main, fetch_list=[loss], scope=scope,
            checkpoint_dir=str(tmp_path / side.name), checkpoint_every=4,
            chaos=chaos, window=1,
            policy=side.rob.RecoveryPolicy(
                max_retries=2, skip_bad_batch=False,
                on_rollback=[side.rob.lr_backoff(lr_name, 0.5)]))
        with pytest.raises(side.rob.NonFiniteError):
            trainer.train(feeds)
        # restore undoes the previous retry's decay: after the 2nd (last)
        # rollback LR = 0.1 * 0.5^2
        assert side.host(scope.get(lr_name)) == pytest.approx(0.025)


def test_manager_restores_executor_step_counter(tmp_path, weights):
    for side in SIDES:
        exe, main, loss, scope = fresh(side, weights, guard=False)
        for f in feeds_of(3):
            exe.run(main, feed=f, fetch_list=[loss], scope=scope)
        m = side.rob.CheckpointManager(str(tmp_path / side.name),
                                       program=main)
        m.save(exe, 3, scope=scope)
        counter = exe._step_counter
        exe.run(main, feed=feeds_of(1, seed=9)[0], fetch_list=[loss],
                scope=scope)
        assert exe._step_counter == counter + 1
        m.restore(exe, scope=scope)
        assert exe._step_counter == counter


# ---------------------------------------------------------------------------
# GuardConfig surface
# ---------------------------------------------------------------------------

def test_guard_config_resolution():
    for side in SIDES:
        G = side.rob.GuardConfig
        assert G.resolve(None) is None
        assert G.resolve(False) is None
        assert G.resolve("0") is None
        assert G.resolve("") is None
        assert isinstance(G.resolve(True), G)
        assert isinstance(G.resolve("1"), G)
        cfg = G(check_fetches=False, extra_vars=("v",))
        assert G.resolve(cfg) is cfg
        assert cfg.candidates("l", ["g1"], ["f1"]) == ["l", "g1", "v"]


def test_guard_vector_flags_one_bad_element():
    """The port's device-side sentinel (one _foreach_norm pass, ord inf):
    a single NaN or Inf anywhere in a large tensor flags that tensor and
    no other; huge finite values do not (the largest magnitude cannot
    overflow); integer tensors are not watched."""
    from paddle_tpu_torch.core.executor import _guard_vector
    env = {"a": torch.zeros(1000), "b": torch.zeros(1000),
           "c": torch.full((7,), 3e38), "d": torch.zeros(4, 4),
           "i": torch.zeros(3, dtype=torch.int64)}
    env["a"][517] = float("nan")
    env["d"][3, 2] = float("-inf")
    flags, owners = _guard_vector(env, ["a", "b", "c", "d", "i", "x"])
    assert owners == ("a", "b", "c", "d")
    assert flags.tolist() == [False, True, True, False]


# ---------------------------------------------------------------------------
# a small BERT under GuardedTrainer, poisoned step, against JAX
# ---------------------------------------------------------------------------

def small_bert_net(pkg, bert):
    cfg = bert.BertConfig(vocab_size=256, hidden_size=64,
                          num_hidden_layers=2, num_attention_heads=2,
                          intermediate_size=128, max_position_embeddings=32,
                          max_predictions_per_seq=4, hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0)
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        _f, loss, _mlm, _acc = bert.build_pretrain_net(cfg, seq_len=16)
        pkg.optimizer.AdamOptimizer(1e-3).minimize(loss)
    return cfg, main, startup, loss


def test_small_bert_guarded_rollback_matches_jax(tmp_path):
    cfg, jmain, jstart, jloss = small_bert_net(jfluid, jbert)
    _, tmain, tstart, tloss = small_bert_net(fluid, tbert)
    jscope = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace(), guard=True)
    jexe.run(jstart, scope=jscope)
    tscope = fluid.Scope()
    texe = fluid.Executor(CPU, guard=True)
    texe.run(tstart, scope=tscope)
    fluid.scope_from_numpy({n: np.asarray(jscope.get(n))
                            for n in jscope.names()}, "cpu", tscope)
    feeds = [tbert.make_pretrain_feed(cfg, 16, 4, seed=i)
             for i in range(6)]
    losses = {}
    for name, exe, main, loss, scope, rob in (
            ("jax", jexe, jmain, jloss, jscope, jrob),
            ("port", texe, tmain, tloss, tscope, trob)):
        got = {}
        # NaN in the first float feed (input_mask): the padding bias, the
        # attention, the loss and every gradient go non-finite
        chaos = rob.ChaosInjector().poison_grad_at(3)
        trainer = rob.GuardedTrainer(
            exe, main, fetch_list=[loss], scope=scope,
            checkpoint_dir=str(tmp_path / name), checkpoint_every=2,
            chaos=chaos, window=2,
            result_callback=lambda i, out, got=got: got.__setitem__(
                i, float(np.asarray(out[0]).reshape(()))))
        res = trainer.train(feeds)
        assert res.rollbacks == 1 and res.steps == 6
        losses[name] = np.array([got[i] for i in range(6)])
    assert np.isfinite(losses["port"]).all()
    np.testing.assert_allclose(losses["port"], losses["jax"],
                               rtol=BERT_RTOL)
