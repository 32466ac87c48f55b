"""Pipeline and expert parallelism over a ``torch.distributed`` world,
started through the port's launcher, on the CPU (gloo).

The twin of ``tests/parallel/_mh_pp_worker.py`` (run by
``tests/parallel/test_multihost_process.py``): there 2 processes x 2
virtual devices form a pp 4 mesh whose ppermute ring crosses the process
boundary, ``pipeline_1f1b`` is held against the reference every process
computes locally, and the schedule's bubble and carry are pinned at M 8
and M 16. The port has one rank a process, so the same mesh is four gloo
ranks (``DistributedStrategy(pp_degree=4)``), each one stage, the
activations and gradients moving between processes. A second world of
two ranks trains the 2-stage MLP of ``tests/test_torch_pipeline.py``
through ``PipelineOptimizer`` at pp 2 (one stage a rank, the cut sent
down and its cotangent back up) and the MoE Program of
``tests/test_torch_moe.py`` at ep 2 (one expert block a rank, the
tokens dispatched by all-to-all); each is held to its local form. Both
launchers run side by side, each under its own timeout.

Tolerances: 1F1B's loss within 1e-5 relative and its gradients within
1e-4 (+ 1e-5) of the reference, as the JAX worker; the world forms'
losses within 1e-6 relative of the local forms' (the same sums, each on
its rank), their first @GRADs and the parameters after the steps within
1e-5 of each tensor's scale.
"""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu_torch as fluid
from paddle_tpu_torch.parallel import make_mesh

from test_torch_collectives import free_port
from test_torch_moe import GRADS as MOE_GRADS, _build as moe_build, \
    _port as moe_port
from test_torch_pipeline import (_build_mlp, _mlp_feed, _port_run, _start,
                                 _1f1b_inputs, reference_1f1b, tlayers, tun)

TESTS = os.path.dirname(os.path.abspath(__file__))
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5
F1B_RTOL, F1B_GRAD_TOL, F1B_GRAD_ATOL = 1e-5, 1e-4, 1e-5
MLP_STEPS = 3

WORKER = r'''
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
import paddle_tpu_torch as fluid
from paddle_tpu_torch.parallel import ShardedTensor, make_mesh
from paddle_tpu_torch.parallel import fleet as fleet_mod
from paddle_tpu_torch.parallel import pipeline as pp_mod

form, inputs, out = sys.argv[1], sys.argv[2], sys.argv[3]
rank = int(os.environ["PADDLE_TRAINER_ID"])
data = np.load(inputs)
res = {}


def stage_fn(w, x):
    return torch.tanh(x @ w)


def loss_fn(y, a):
    return torch.mean((y - a) ** 2)


def host(v):
    return (v.full() if isinstance(v, ShardedTensor) else v).numpy()


if form == "pp4":
    s = fleet_mod.DistributedStrategy()
    s.pp_degree = 4
    flt = fleet_mod.Fleet().init(strategy=s)
    mesh = flt.mesh()
    assert flt.backend == "gloo" and dict(mesh.shape)["pp"] == 4, mesh
    assert mesh.coords()["pp"] == rank
    ws, xm, aux = (torch.tensor(data[k]) for k in ("ws", "xm", "aux"))
    loss, grads = pp_mod.pipeline_1f1b(stage_fn, loss_fn, ws, xm, aux, mesh)
    res["loss"], res["grads"] = loss.numpy(), grads.numpy()
    # the GPipe forward over the processes
    res["apply"] = pp_mod.pipeline_apply(
        stage_fn, ws, xm.reshape(-1, xm.shape[-1]), mesh,
        microbatches=xm.shape[0]).numpy()
    S, mb, d = ws.shape[0], xm.shape[1], xm.shape[2]
    for m in (8, 16):
        st = pp_mod.schedule_stats(stage_fn, loss_fn, ws, torch.zeros(
            m, mb, d), torch.zeros(m, mb, d), mesh)
        res["stats%d" % m] = np.array([st["ticks"], st["carry_bytes"],
                                       st["bubble_fraction"]])
        # the schedule as it runs over the processes, at this M
        l_m, g_m = pp_mod.pipeline_1f1b(
            stage_fn, loss_fn, ws, torch.tensor(data["xm%d" % m]),
            torch.tensor(data["aux%d" % m]), mesh)
        res["loss%d" % m] = l_m.numpy()
else:
    from test_torch_pipeline import _build_mlp, tlayers, tun
    from test_torch_moe import GRADS, _build as moe_build, _feed as moe_feed
    s = fleet_mod.DistributedStrategy()
    s.pp_degree = 2
    flt = fleet_mod.Fleet().init(strategy=s)
    assert flt.backend == "gloo"
    main, _s, loss = _build_mlp(fluid, tun, tlayers, True)
    init = {k[4:]: data[k] for k in data.files if k.startswith("mlp/")}
    feed = {k[5:]: data[k] for k in data.files if k.startswith("feed/")}
    scope = fluid.scope_from_numpy(init, "cpu")
    comp = fluid.CompiledProgram(main).with_mesh(flt.mesh())
    exe = fluid.Executor(fluid.CPUPlace())
    names = [p.name + "@GRAD" for p in main.all_parameters()]
    with fluid.scope_guard(scope):
        for i in range(@STEPS@):
            got = exe.run(comp, feed=feed, fetch_list=[loss] + (
                names if i == 0 else []))
            res["pp2/loss%d" % i] = got[0]
            if i == 0:
                for n, g in zip(names, got[1:]):
                    res["pp2/" + n] = g
        res["pp2/w"] = host(scope.get("pipe_fc1_w"))
    # ep 2 in the same world: the MoE Program, one expert block a rank
    main, _s, aux, loss = moe_build(fluid, tun, tlayers)
    init = {k[4:]: data[k] for k in data.files if k.startswith("moe/")}
    scope = fluid.scope_from_numpy(init, "cpu")
    comp = fluid.CompiledProgram(main).with_mesh(make_mesh(ep=2))
    with fluid.scope_guard(scope):
        for i in range(5):
            got = exe.run(comp, feed=moe_feed(), fetch_list=[loss, aux] + (
                GRADS if i == 0 else []))
            res["ep2/loss%d" % i] = got[0]
            if i == 0:
                for n, g in zip(GRADS, got[2:]):
                    res["ep2/" + n] = g
        w = scope.get("moe_w_up")
        assert isinstance(w, ShardedTensor) and len(w.parts) == 1
        res["ep2/part"] = np.array(w.parts[0].shape)
        res["ep2/w"] = host(w)
np.savez(os.path.join(out, "rank%d.npz" % rank), **res)
dist.barrier()
print("PIPELINE_WORLD_OK", rank)
'''.replace("@STEPS@", str(MLP_STEPS))


def _launch(script, form, inputs, base, nproc):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([TESTS, os.path.dirname(TESTS),
                                         env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    out = base / form
    out.mkdir()
    return out, subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         f"--nproc_per_node={nproc}", f"--started_port={free_port()}",
         f"--log_dir={out / 'log'}", str(script), form, str(inputs),
         str(out)], env=env, cwd=str(out), start_new_session=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _logs(out, nproc):
    return "\n".join((out / "log" / f"workerlog.{r}").read_text()[-2000:]
                     for r in range(nproc)
                     if (out / "log" / f"workerlog.{r}").exists())


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The 4-rank pp world and the 2-rank pp / ep world, side by side."""
    base = tmp_path_factory.mktemp("pipeline_world")
    script = base / "pipeline_worker.py"
    script.write_text(WORKER)
    ws, xm, aux = _1f1b_inputs(s=4, m=4, mb=2, d=8)
    rs = np.random.RandomState(12)
    sched = {f"{k}{m}": rs.randn(m, 2, 8).astype(np.float32)
             for m in (8, 16) for k in ("xm", "aux")}
    np.savez(base / "pp4.npz", ws=ws, xm=xm, aux=aux, **sched)
    main, startup, _l = _build_mlp(fluid, tun, tlayers, False)
    mlp_init = _start(startup)
    _m, mstart, _a, _l = moe_build(fluid, tun, tlayers)
    moe_init = _start(mstart)
    np.savez(base / "pair.npz",
             **{"mlp/" + k: v for k, v in mlp_init.items()},
             **{"moe/" + k: v for k, v in moe_init.items()},
             **{"feed/" + k: v for k, v in _mlp_feed().items()})
    runs = [("pp4", 4), ("pair", 2)]
    procs = [(_launch(script, form, base / f"{form}.npz", base, n), n)
             for form, n in runs]
    results = {}
    try:
        for (form, n), ((out, proc), _n) in zip(runs, procs):
            proc.communicate(timeout=150)
            assert proc.returncode == 0, _logs(out, n)
            results[form] = [np.load(out / f"rank{r}.npz") for r in range(n)]
    finally:
        for (_out, proc), _n in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
    results["inputs"] = (ws, xm, aux, sched, mlp_init, moe_init)
    return results


def test_1f1b_over_four_processes_matches_the_local_reference(worlds):
    """_mh_pp_worker.py's checks on four gloo ranks, one stage each: the
    loss and stacked gradients on every rank equal the reference the test
    computes locally; at M 8 and M 16 the schedule's bubble is the
    analytic one, shrinking with M, and its carry the same at both, and
    the schedule runs at both over the processes. pipeline_apply's GPipe
    forward over the same ranks gives the stages' product in sequence on
    every rank."""
    ws, xm, aux, sched, _mi, _oi = worlds["inputs"]
    ref_loss, ref_grads = reference_1f1b(ws, xm, aux)
    from paddle_tpu_torch.parallel import pipeline as tpp
    for got in worlds["pp4"]:
        assert float(got["loss"]) == pytest.approx(ref_loss, rel=F1B_RTOL)
        np.testing.assert_allclose(got["grads"], ref_grads,
                                   rtol=F1B_GRAD_TOL, atol=F1B_GRAD_ATOL)
        for m in (8, 16):
            ticks, carry, frac = got[f"stats{m}"]
            assert ticks == 2 * m + 2 * 4 - 2
            assert frac == tpp.bubble_fraction(m, 4)
            want, _g = reference_1f1b(ws, sched[f"xm{m}"], sched[f"aux{m}"])
            assert float(got[f"loss{m}"]) == pytest.approx(want,
                                                           rel=F1B_RTOL)
        assert got["stats8"][1] == got["stats16"][1]
        assert got["stats16"][2] < got["stats8"][2]
        h = xm.reshape(-1, xm.shape[-1])
        for w in ws:
            h = np.tanh(h @ w)
        np.testing.assert_allclose(got["apply"], h, rtol=F1B_GRAD_TOL,
                                   atol=F1B_GRAD_ATOL)


def _scale_close(got, want, tol, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), name


def test_framework_pp2_world_matches_the_local_form(worlds):
    """PipelineOptimizer at pp 2 over two processes (fleet's
    DistributedStrategy(pp_degree=2)): the losses, first @GRADs and fc1's
    weight after the steps equal the local pp 2 form's on both ranks."""
    _ws, _xm, _aux, _s, mlp_init, _oi = worlds["inputs"]
    main, _st, loss = _build_mlp(fluid, tun, tlayers, True)
    names = [p.name + "@GRAD" for p in main.all_parameters()]
    losses, scope, grads = _port_run(
        main, loss, mlp_init, _mlp_feed(),
        make_mesh(pp=2, devices=["cpu"] * 2), steps=MLP_STEPS, fetch=names)
    for got in worlds["pair"]:
        for i in range(MLP_STEPS):
            assert float(got[f"pp2/loss{i}"].ravel()[0]) == pytest.approx(
                losses[i], rel=LOSS_RTOL)
        for n, g in zip(names, grads):
            _scale_close(got["pp2/" + n], g, GRAD_TOL, n)
        _scale_close(got["pp2/w"], scope.get("pipe_fc1_w").numpy(),
                     GRAD_TOL)


def test_ep2_world_matches_the_local_form(worlds):
    """The MoE Program at ep 2 over two processes (each holding two of
    the four experts, the dispatch an all-to-all between them): the
    losses, first @GRADs and w_up after five SGD steps equal the local ep
    2 form's."""
    _ws, _xm, _aux, _s, _mi, moe_init = worlds["inputs"]
    losses, grads, w = moe_port(moe_init, make_mesh(ep=2,
                                                    devices=["cpu"] * 2))
    for got in worlds["pair"]:
        assert tuple(got["ep2/part"]) == (2, 8, 16)
        for i in range(5):
            assert float(got[f"ep2/loss{i}"].ravel()[0]) == pytest.approx(
                losses[i], rel=LOSS_RTOL)
        for n, g in zip(MOE_GRADS, grads):
            _scale_close(got["ep2/" + n], g, GRAD_TOL, n)
        _scale_close(got["ep2/w"], w.full().numpy(), GRAD_TOL)
