"""Fleet collective training over a ``torch.distributed`` world, started
through the port's launcher, on the CPU.

The twin of ``tests/parallel/test_multihost_process.py::
test_two_process_fleet_cluster`` / ``_mh_worker.py``: there two
processes of 4 virtual devices each join a jax.distributed cluster
through ``paddle_tpu.distributed.launch``, fleet builds dp 4 x tp 2 with
each tp pair inside one process, a psum over dp crosses the processes,
and ``InMemoryDataset.global_shuffle`` redistributes two files. The port
has one rank a process, so the same layout is four gloo processes on two
emulated nodes (two launchers, ``--cluster_node_ips=127.0.0.1,127.0.0.2``,
two ranks each): fleet's hybrid mesh is dp 2 x tp 2 with each tp pair on
one node, the dp sum over the processes is 1 + 2, and the shuffle's union
is the whole set. The same world then trains the narrow BERT of
``tests/test_torch_mixed_mesh.py`` at dp 2 x tp 2 (fleet's mesh) and dp
2 x sp 2 (a second mesh over the world), round-trips a value laid out
over dp and tp, and checks each rank's scope holds the dist_attrs'
shares; a 2-process world trains it at tp 2 and at sp 2 (the ring's K/V
rotating between the processes). Every world form is held to the local
form of the same mesh and to dp 1 with the tolerances of
``tests/test_torch_mixed_mesh.py`` (losses 1e-6 relative, @GRADs 1e-5 of
their scale plus 1e-3 of the largest's), which holds the local forms
against JAX. Each launch has its own timeout and kills its process group.
"""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest

from paddle_tpu_torch.parallel import make_mesh

from test_torch_collectives import free_port, logs, run_launcher
from test_torch_mixed_mesh import _Twin, grads_close, losses_close

TESTS = os.path.dirname(os.path.abspath(__file__))

WORKER = r'''
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers
from paddle_tpu_torch.core import framework
from paddle_tpu_torch.core import unique_name as tun
from paddle_tpu_torch.io import dataset as ds
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.parallel import (ShardedTensor, collective,
                                       host_domains, make_mesh)
from paddle_tpu_torch.parallel import fleet as fleet_mod
from paddle_tpu_torch.parallel.sharded import placement_spec
from test_torch_mixed_mesh import SEQ, narrow_cfg

form, inputs, out = sys.argv[1], sys.argv[2], sys.argv[3]
rank = int(os.environ["PADDLE_TRAINER_ID"])
s = fleet_mod.DistributedStrategy()
s.tp_degree = 2
flt = fleet_mod.Fleet().init(strategy=s)
n = flt.worker_num()
assert dist.get_world_size() == n and flt.worker_index() == rank
assert flt.backend == "gloo"
res = {}
data = np.load(inputs)
cfg = narrow_cfg(tbert)
main, startup = fluid.Program(), fluid.Program()
main.random_seed = startup.random_seed = 7
with tun.guard(), fluid.program_guard(main, startup):
    _f, loss, _m, _a = tbert.build_pretrain_net(cfg, seq_len=SEQ)
    flt.distributed_optimizer(fluid.optimizer.AdamOptimizer(1e-3)).minimize(
        loss)
state = {k[6:]: data[k] for k in data.files if k.startswith("scope/")}
feed = {k[5:]: data[k] for k in data.files if k.startswith("feed/")}
names = [p.name for p in main.all_parameters()]


def train(tag, mesh):
    """Two steps from the carried state; the first's @GRADs; each rank's
    scope elements against the dist_attrs' shares over the mesh."""
    scope = fluid.scope_from_numpy(state, "cpu")
    comp = fluid.CompiledProgram(main).with_mesh(mesh)
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        for i in range(2):
            got = exe.run(comp, feed=feed, fetch_list=[loss] + (
                [p + "@GRAD" for p in names] if i == 0 else []))
            res[tag + "/loss%d" % i] = got[0]
            if i == 0:
                for p, g in zip(names, got[1:]):
                    res[tag + "/grad/" + p] = g
        attrs = {v.name: getattr(v, "dist_attr", None)
                 for v in main.list_vars()}
        held = share = 0
        for name in scope.names():
            v = scope.get(name)
            held += v.numel()
            spec = placement_spec(attrs.get(name), tuple(v.shape), mesh)
            ways = int(np.prod([mesh.shape[a] for e in spec
                                if e is not None for a in
                                (e if isinstance(e, tuple) else (e,))]))
            share += int(np.prod(v.shape)) // ways
        res[tag + "/elements"] = np.array([held, share])
        q = scope.get("enc0_attn_q")
        res[tag + "/q_laid"] = np.array(isinstance(q, ShardedTensor))


mesh = flt.mesh()
if form == "nodes":
    # fleet's hybrid mesh: dp across the two nodes, each tp pair on one
    shape = dict(mesh.shape)
    assert shape["dp"] == 2 and shape["tp"] == 2, shape
    doms = host_domains(mesh, per_host=2)
    for pair, dom in zip(mesh.devices.reshape(-1, 2),
                         doms.reshape(-1, 2)):
        assert len(set(dom.tolist())) == 1, (pair, dom)
    res["tp_pair"] = np.array(mesh.line("tp")[0])
    c = mesh.coords()
    total = collective.allreduce(torch.tensor(float(c["dp"] + 1)), "sum",
                                 "dp", mesh=mesh)
    res["dp_sum"] = total.numpy()
    # global_shuffle over the processes: each rank loads its own file
    with framework.program_guard(framework.Program(), framework.Program()):
        xvar = layers.data("x", shape=[1], dtype="int64")
    tmp = os.path.join(out, "ds_rank%d.txt" % rank)
    with open(tmp, "w") as fh:
        for v in range(rank * 4, rank * 4 + 4):
            fh.write("1 %d\n" % v)
    d = ds.InMemoryDataset()
    d.set_batch_size(2)
    d.set_use_var([xvar])
    d.set_filelist([tmp])
    d.set_shuffle_seed(11)
    d.load_into_memory()
    d.global_shuffle(fleet=flt)
    mine = sorted(int(b["x"][r, 0]) for b in d._iter_batches()
                  for r in range(b["x"].shape[0]))
    every = [None] * n
    dist.all_gather_object(every, mine)
    res["union"] = np.array(sorted(v for m in every for v in m))
    # a value laid out over dp and tp round-trips over the world
    value = torch.arange(48, dtype=torch.float32).reshape(8, 6)
    for i, spec in enumerate([("dp", "tp"), (("dp", "tp"), None)]):
        st = ShardedTensor.cut(value, spec, mesh)
        (part,) = st.parts
        res["two_axes%d" % i] = np.array([
            torch.equal(part, value[st.blocks()[0]]),
            torch.equal(st.full(), value),
            torch.equal(st.over(["tp"]).full(), value),
            torch.equal(st.over(["tp"]).parts[0],
                        value[st.over(["tp"]).blocks()[0]])])
    train("dp2_tp2", mesh)
    train("dp2_sp2", make_mesh(dp=2, sp=2))
else:
    assert dict(mesh.shape)["tp"] == 2 and n == 2
    train("tp2", mesh)
    train("sp2", make_mesh(sp=2))
flt.barrier_worker()
np.savez(os.path.join(out, "rank%d.npz" % rank), **res)
print("FLEET_WORLD_OK", rank)
'''


@pytest.fixture(scope="module")
def twin():
    return _Twin()


def _inputs(twin, base):
    path = base / "inputs.npz"
    np.savez(path, **{"scope/" + n: v for n, v in twin.init.items()},
             **{"feed/" + k: v for k, v in twin.feed.items()})
    return path


def _launch_nodes(script, args, base, port):
    """Two launchers, one an emulated node of two ranks, side by side;
    each killed with its group at its timeout."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([TESTS, os.path.dirname(TESTS),
                                         env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    procs = []
    for node in ("127.0.0.1", "127.0.0.2"):
        log = base / f"log_{node}"
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--nproc_per_node=2", "--cluster_node_ips=127.0.0.1,127.0.0.2",
             f"--node_ip={node}", f"--started_port={port}",
             f"--log_dir={log}", str(script)] + list(args), env=env,
            cwd=str(base), start_new_session=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    rcs = []
    for p in procs:
        try:
            p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                os.killpg(q.pid, signal.SIGKILL)
            raise
        rcs.append(p.returncode)
    return rcs


def _node_logs(base):
    out = []
    for node in ("127.0.0.1", "127.0.0.2"):
        for r in range(2):
            f = base / f"log_{node}" / f"workerlog.{r}"
            if f.exists():
                out.append(f.read_text()[-2000:])
    return "\n".join(out)


@pytest.fixture(scope="module")
def nodes(twin, tmp_path_factory):
    base = tmp_path_factory.mktemp("fleet_nodes")
    script = base / "fleet_worker.py"
    script.write_text(WORKER)
    rcs = _launch_nodes(script, ["nodes", str(_inputs(twin, base)),
                                 str(base)], base, free_port())
    assert rcs == [0, 0], _node_logs(base)
    return [np.load(base / f"rank{r}.npz") for r in range(4)]


@pytest.fixture(scope="module")
def pair(twin, tmp_path_factory):
    base = tmp_path_factory.mktemp("fleet_pair")
    script = base / "fleet_worker.py"
    script.write_text(WORKER)
    rc = run_launcher(script, ["pair", str(_inputs(twin, base)), str(base)],
                      base, 2, free_port(), pythonpath=TESTS)
    assert rc == 0, logs(base, 2)
    return [np.load(base / f"rank{r}.npz") for r in range(2)]


@pytest.fixture(scope="module")
def local(twin):
    """The local forms of every world mesh, and dp 1."""
    forms = {"dp1": dict(dp=1), "dp2_tp2": dict(dp=2, tp=2),
             "dp2_sp2": dict(dp=2, sp=2), "tp2": dict(tp=2),
             "sp2": dict(sp=2)}
    return {k: twin.port(make_mesh(**kw, devices=["cpu"] * int(
        np.prod(list(kw.values())))))[0] for k, kw in forms.items()}


def _ranked(got, tag, names):
    return [[got[tag + "/loss0"]] + [got[f"{tag}/grad/{n}"] for n in names],
            [got[tag + "/loss1"]]]


def test_two_node_fleet_cluster(nodes):
    """_mh_worker.py's checks: fleet's mesh dp 2 x tp 2 with each tp pair
    inside one emulated node (ranks 0-1 and 2-3), the dp sum across the
    processes 1 + 2 on every rank, global_shuffle's union the 16 records
    the four ranks loaded, and the barrier passed (every rank wrote)."""
    for r, got in enumerate(nodes):
        assert list(got["tp_pair"]) == [r - r % 2, r - r % 2 + 1]
        assert float(got["dp_sum"]) == 1.0 + 2.0
        assert list(got["union"]) == list(range(16))


def test_world_value_over_two_axes_round_trips(nodes):
    """A value laid out over dp on one dimension and tp on the other,
    and over both on one: each rank's part is its block, ``full()`` the
    value bitwise, and ``over(["tp"])`` the tp-only layout's block."""
    for got in nodes:
        assert got["two_axes0"].all() and got["two_axes1"].all()


@pytest.mark.parametrize("tag", ["dp2_tp2", "dp2_sp2"])
def test_four_process_world_matches_the_local_form(twin, nodes, local,
                                                   tag):
    """dp 2 x tp 2 (fleet's mesh) and dp 2 x sp 2 over the 4-rank world:
    every rank's losses and first @GRADs equal the local form's and dp
    1's, and its scope holds exactly the dist_attrs' shares (a tp form's
    Megatron weights in halves)."""
    for got in nodes:
        ranked = _ranked(got, tag, twin.names)
        for ref in (local[tag], local["dp1"]):
            losses_close(ranked, ref)
            grads_close(ranked[0][1:], ref[0][1:], twin.names)
        held, share = got[tag + "/elements"]
        assert held == share
        assert bool(got[tag + "/q_laid"]) == ("tp" in tag)


@pytest.mark.parametrize("tag", ["tp2", "sp2"])
def test_two_process_world_matches_the_local_form(twin, pair, local, tag):
    """tp 2 (fleet's mesh) and sp 2 over a 2-rank world: both ranks'
    losses and first @GRADs equal the local form's and dp 1's; the scope
    holds the shares."""
    for got in pair:
        ranked = _ranked(got, tag, twin.names)
        for ref in (local[tag], local["dp1"]):
            losses_close(ranked, ref)
            grads_close(ranked[0][1:], ref[0][1:], twin.names)
        held, share = got[tag + "/elements"]
        assert held == share


def test_launcher_exports_the_layout_and_fails_fast(tmp_path):
    """The launcher exports every rank's selected device round-robin
    (PADDLE_SELECTED_DEVICES) and the node's layout (PADDLE_NODE_DEVICES),
    writes workerlog.N, and at the first non-zero exit stops the other
    ranks and exits non-zero itself, well before the survivor's own
    end."""
    import time
    script = tmp_path / "env_worker.py"
    script.write_text(
        "import os, sys, time\n"
        "rank = int(os.environ['PADDLE_TRAINER_ID'])\n"
        "print('ENV', rank, os.environ['PADDLE_SELECTED_DEVICES'],\n"
        "      os.environ['PADDLE_NODE_DEVICES'],\n"
        "      os.environ['PADDLE_TRAINERS_NUM'], flush=True)\n"
        "if sys.argv[1] == 'fail':\n"
        "    if rank == 1:\n"
        "        sys.exit(3)\n"
        "    time.sleep(120)\n")
    rc = run_launcher(script, ["ok"], tmp_path, 3, free_port(),
                      selected="0,1,0")
    assert rc == 0, logs(tmp_path, 3)
    lines = [(tmp_path / "log" / f"workerlog.{r}").read_text().split()
             for r in range(3)]
    assert [ln[2] for ln in lines] == ["0", "1", "0"]
    assert all(ln[3] == "0,1,0" and ln[4] == "3" for ln in lines)
    t0 = time.monotonic()
    rc = run_launcher(script, ["fail"], tmp_path, 2, free_port(),
                      timeout=100, selected="0,0")
    assert rc != 0 and time.monotonic() - t0 < 60
