"""Data parallelism beyond the Program walk's own twins, on the CPU.

- ``Executor.train_from_dataset`` under a data-parallel
  ``CompiledProgram`` (a local dp 2 mesh): each batch of the files is split
  over dp as ``run()``'s walk splits a feed. DeepFM (test_torch_dataset.py's
  cell) from the JAX startup's weights: the parameters equal those of
  ``run()`` at dp 2 over the same batches bitwise, and the JAX package's
  ``train_from_dataset`` on its dp 2 mesh to PARAM_RTOL / PARAM_ATOL (f32
  in another summation order).
- ``parallel.data_parallel_step`` over a two-process gloo world (a
  ``file://`` rendezvous under a temporary directory): each rank passes the
  global batch, as JAX's processes do, and computes the global batch's
  step; two SGD steps of a least-squares model equal, on both ranks, the
  local dp 2 mesh's bitwise and JAX's ``data_parallel_step`` to 1e-6.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu.io import dataset as jds
from paddle_tpu.models import deepfm as jdeepfm
from paddle_tpu.parallel import data_parallel as jdp
from paddle_tpu.parallel.mesh import make_mesh as jmake_mesh

import paddle_tpu_torch as fluid
from paddle_tpu_torch.io import dataset as tds
from paddle_tpu_torch.models import deepfm as tdeepfm
from paddle_tpu_torch.parallel import data_parallel_step
from paddle_tpu_torch.parallel.mesh import make_mesh
from test_torch_dataset import (PARAM_ATOL, PARAM_RTOL, deepfm_lines,
                                deepfm_program, write_files)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = fluid.CPUPlace()
DP = 2
BATCH = 8
STEP_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (the suite runs
    several pytest workers at once; see tests/test_torch_bert.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _dataset(ds, main, files):
    gb = main.global_block()
    d = ds.DatasetFactory().create_dataset("QueueDataset")
    d.set_batch_size(BATCH)
    d.set_use_var([gb.var("feat_ids"), gb.var("feat_vals"),
                   gb.var("label")])
    d.set_filelist(files)
    d.set_thread(2)
    return d


def test_train_from_dataset_under_data_parallel(tmp_path):
    lines, ids, vals, lab = deepfm_lines(np.random.default_rng(4), 32)
    files = write_files(tmp_path, lines)
    jmain, jstart, _jl = deepfm_program(jfluid, jdeepfm)
    jscope, jexe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    weights = {n: np.asarray(jscope.get(n)) for n in jscope.names()}
    jcomp = jfluid.CompiledProgram(jmain).with_mesh(
        jmake_mesh(dp=DP, devices=jax.devices()[:DP]))
    jexe.train_from_dataset(program=jcomp, dataset=_dataset(jds, jmain,
                                                            files),
                            scope=jscope)
    want = {n: np.asarray(jscope.get(n)) for n in jscope.names()}

    main, _startup, loss = deepfm_program(fluid, tdeepfm)
    got = {}
    for how in ("dataset", "run"):
        comp = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, places=[CPU] * DP)
        scope = fluid.scope_from_numpy(weights, "cpu")
        exe = fluid.Executor(CPU)
        exe._step_counter = 1               # as after the startup
        if how == "dataset":
            d = _dataset(tds, main, files)
            exe.train_from_dataset(program=comp, dataset=d, scope=scope)
            assert d.parser == "native"
        else:
            for b0 in range(0, 32, BATCH):
                sl = slice(b0, b0 + BATCH)
                exe.run(comp, feed={"feat_ids": ids[sl].astype(np.int64),
                                    "feat_vals": vals[sl],
                                    "label": lab[sl].reshape(-1, 1)},
                        fetch_list=[loss], scope=scope)
        assert comp.mesh.shape["dp"] == DP and comp.mesh.reductions > 0
        got[how] = {n: scope.get(n).numpy().copy() for n in scope.names()}
    assert set(got["dataset"]) == set(got["run"]) == set(want)
    for n in want:
        np.testing.assert_array_equal(got["dataset"][n], got["run"][n],
                                      err_msg=n)
        np.testing.assert_allclose(got["dataset"][n], want[n],
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=n)


def _problem():
    rs = np.random.RandomState(3)
    return (rs.randn(8, 5).astype(np.float32),
            rs.randn(8, 1).astype(np.float32),
            rs.randn(5, 1).astype(np.float32))


def tstep(state, batch):
    w = state["w"].clone().requires_grad_(True)
    val = ((batch["x"] @ w - batch["y"]) ** 2).mean()
    (g,) = torch.autograd.grad(val, w)
    return {"w": (w - 0.1 * g).detach()}, val.detach()


WORKER = r'''
import datetime, sys
import numpy as np
import torch
import torch.distributed as dist
from test_torch_dp_extras import _problem, tstep

rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=60))
try:
    from paddle_tpu_torch.parallel import data_parallel_step
    from paddle_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(dp=2)
    assert mesh.world and mesh.held("dp") == [rank]
    run = data_parallel_step(tstep, mesh, device="cpu")
    x, y, w0 = _problem()
    state, losses = {"w": torch.from_numpy(w0)}, []
    for _ in range(2):
        state, val = run(state, {"x": x, "y": y})
        losses.append(float(val))
    np.savez(out + "/rank%d.npz" % rank, w=state["w"].numpy(),
             losses=np.array(losses))
finally:
    dist.destroy_process_group()
'''


def test_data_parallel_step_over_a_gloo_world(tmp_path):
    script = tmp_path / "dps_worker.py"
    script.write_text(WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, os.path.join(REPO, "tests"), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    init = "file://" + str(tmp_path / "rdv")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), init, str(tmp_path)],
        env=env, cwd=str(tmp_path), stderr=subprocess.PIPE, text=True)
        for r in range(DP)]
    errs = [p.communicate(timeout=120)[1] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], errs

    x, y, w0 = _problem()
    local = data_parallel_step(tstep, make_mesh(dp=DP, devices=["cpu"] * DP))
    state, losses = {"w": torch.from_numpy(w0)}, []
    for _ in range(2):
        state, val = local(state, {"x": x, "y": y})
        losses.append(float(val))

    def jstep(s, batch):
        def f(w):
            return jnp.mean((batch["x"] @ w - batch["y"]) ** 2)
        val, g = jax.value_and_grad(f)(s["w"])
        return {"w": s["w"] - 0.1 * g}, val

    jrun = jdp.data_parallel_step(
        jstep, jmake_mesh(dp=DP, devices=jax.devices()[:DP]),
        donate_state=False)
    js = {"w": jnp.asarray(w0)}
    for _ in range(2):
        js, _jl = jrun(js, {"x": x, "y": y})
    for r in range(DP):
        got = np.load(tmp_path / f"rank{r}.npz")
        np.testing.assert_array_equal(got["w"], state["w"].numpy())
        assert list(got["losses"]) == losses
        np.testing.assert_allclose(got["w"], np.asarray(js["w"]),
                                   rtol=STEP_TOL, atol=STEP_TOL)
