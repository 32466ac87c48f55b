"""dp, sp and tp on one mesh under the port's ``CompiledProgram``, against
the JAX package and the port's dp 1, on the CPU.

A 2-layer narrow BERT (hidden 64, 4 heads, FFN 128, seq 64, batch 4,
dropout 0) with ``apply_shard_rules`` runs one Adam step and a second
under ``with_mesh`` at dp 2 x tp 2, dp 2 x sp 2 and dp 2 x sp 2 x tp 2 on
local CPU meshes: each rank's heads and products inside its dp rank's
rows, the attention taking the ring over its sp line. Both packages build
the same Program under fresh unique-name generators; the port's startup
state is carried into JAX's scope as numpy, and JAX runs the same mesh
over the 8 virtual CPU devices of ``tests/conftest.py``.

Tolerances: the losses within 1e-6 relative of the port's dp 1 (the tp
partial sums and the ring's online softmax add in another order) and of
JAX's; the first step's @GRADs within 1e-5 of each tensor's scale plus
1e-3 of the largest @GRAD's (a key bias's exact gradient is 0 and both
hold rounding noise there, as tests/test_torch_sharded_state.py sets
out), against the port's dp 1 and JAX's. The scope keeps the tp layouts
and the ZeRO-1 accumulators. A ``ShardedTensor`` laid out over two axes
(dp and tp on two dimensions, and both on one) cuts, assembles and
narrows to tp alone exactly. The world form of dp 2 x sp 2 x tp 2, eight
gloo processes through the port's launcher, gives the local form's
numbers.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu.core import unique_name as jun
from paddle_tpu.core.executor import Scope as JScope, scope_guard as jguard
from paddle_tpu.models import bert as jbert
from paddle_tpu.parallel.mesh import make_mesh as jmake_mesh
from paddle_tpu.parallel.tensor_parallel import \
    apply_shard_rules as japply_shard_rules

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import unique_name as tun
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.parallel import (ShardedTensor,
                                       apply_shard_rules, make_mesh)

from test_torch_collectives import free_port, logs, run_launcher

CPU = fluid.CPUPlace()
SEQ, BATCH = 64, 4
LOSS_RTOL = 1e-6
GRAD_TOL, GRAD_FLOOR = 1e-5, 1e-3
MESHES = {"dp2_tp2": dict(dp=2, tp=2), "dp2_sp2": dict(dp=2, sp=2),
          "dp2_sp2_tp2": dict(dp=2, sp=2, tp=2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_bert.py: concurrent pytest workers oversubscribe the
    CPU otherwise)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def narrow_cfg(bert):
    cfg = bert.bert_tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    cfg.num_hidden_layers = 2
    cfg.hidden_size = 64
    cfg.num_attention_heads = 4
    cfg.intermediate_size = 128
    return cfg


def build(pkg, un, bert):
    cfg = narrow_cfg(bert)
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with un.guard(), pkg.program_guard(main, startup):
        _f, loss, _m, _a = bert.build_pretrain_net(cfg, seq_len=SEQ)
        pkg.optimizer.AdamOptimizer(1e-3).minimize(loss)
    return cfg, main, startup, loss


class _Twin:
    def __init__(self):
        self.cfg, self.tmain, tstart, self.tloss = build(fluid, tun, tbert)
        _c, self.jmain, _s, self.jloss = build(jfluid, jun, jbert)
        apply_shard_rules(self.tmain)
        japply_shard_rules(self.jmain)
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            fluid.Executor(CPU).run(tstart)
        self.init = {n: scope.get(n).numpy().copy() for n in scope.names()}
        self.feed = tbert.make_pretrain_feed(self.cfg, SEQ, BATCH, seed=5)
        self.names = [p.name for p in self.tmain.all_parameters()]
        self.fetch = [n + "@GRAD" for n in self.names]

    def port(self, mesh, steps=2):
        scope = fluid.scope_from_numpy(self.init, "cpu")
        prog = fluid.CompiledProgram(self.tmain).with_mesh(mesh)
        exe, outs = fluid.Executor(CPU), []
        with fluid.scope_guard(scope):
            for i in range(steps):
                outs.append(exe.run(prog, feed=self.feed, fetch_list=[
                    self.tloss] + (self.fetch if i == 0 else [])))
        return outs, scope

    def jax(self, mesh, steps=2):
        scope = JScope()
        for n, v in self.init.items():
            scope.set(n, jnp.asarray(v))
        prog = jfluid.CompiledProgram(self.jmain).with_mesh(mesh)
        exe, outs = jfluid.Executor(), []
        with jguard(scope):
            for i in range(steps):
                outs.append(exe.run(prog, feed=self.feed, fetch_list=[
                    self.jloss] + (self.fetch if i == 0 else [])))
        return outs


@pytest.fixture(scope="module")
def twin():
    return _Twin()


@pytest.fixture(scope="module")
def dp1(twin):
    return twin.port(make_mesh(dp=1, devices=["cpu"]))[0]


def scalar(v):
    return float(np.asarray(v).reshape(-1)[0])


def losses_close(got, want):
    for a, b in zip(got, want):
        assert abs(scalar(a[0]) - scalar(b[0])) <= LOSS_RTOL * abs(
            scalar(b[0])), (scalar(a[0]), scalar(b[0]))


def grads_close(got, want, names):
    floor = GRAD_FLOOR * max(np.abs(np.asarray(w)).max() for w in want)
    for n, a, b in zip(names, got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, n
        assert np.abs(a - b).max() <= GRAD_TOL * np.abs(b).max() + floor, n


@pytest.mark.parametrize("form", sorted(MESHES))
def test_mixed_mesh_matches_dp1_and_jax(twin, dp1, form):
    """The mesh form's two losses and first @GRADs against the port's dp
    1 and JAX's run at the same mesh; the scope keeps the Megatron
    layouts over tp (a tp mesh) and the walk makes the tp rules'
    reductions once a dp rank."""
    kw = MESHES[form]
    n = int(np.prod(list(kw.values())))
    mesh = make_mesh(**kw, devices=["cpu"] * n)
    got, scope = twin.port(mesh)
    want = twin.jax(jmake_mesh(**kw, devices=jax.devices()[:n]))
    losses_close(got, dp1)
    losses_close(got, want)
    grads_close(got[0][1:], dp1[0][1:], twin.names)
    grads_close(got[0][1:], want[0][1:], twin.names)
    q = scope.get("enc0_attn_q")
    if kw.get("tp", 1) > 1:
        assert isinstance(q, ShardedTensor) and q.axes == ["tp"]
        assert [list(p.shape) for p in q.parts] == [[64, 32]] * 2
    else:
        assert isinstance(q, torch.Tensor)


def test_dp2_tp2_zero1_matches_dp1(twin, dp1):
    """ZeRO-1 beside tp (the fleet strategy tp_degree=2, zero_stage=1):
    the moments of word_embedding laid out over dp, the parameter over
    tp, the two losses and first @GRADs those of dp 1."""
    from paddle_tpu_torch.parallel import shard_optimizer_state
    shard_optimizer_state(twin.tmain)
    try:
        got, scope = twin.port(make_mesh(dp=2, tp=2, devices=["cpu"] * 4))
    finally:
        for v in twin.tmain.list_vars():
            if v.name not in twin.names:
                v.dist_attr = None
    losses_close(got, dp1)
    grads_close(got[0][1:], dp1[0][1:], twin.names)
    moments = [n for n in scope.names()
               if "moment" in n and n.startswith("word_embedding")]
    assert moments and all(scope.get(n).axes == ["dp"] for n in moments)
    assert scope.get("word_embedding").axes == ["tp"]


@pytest.mark.parametrize("spec", [("dp", "tp"), (("dp", "tp"), None),
                                  (None, ("tp", "dp"))])
def test_sharded_tensor_over_two_axes_round_trips(spec):
    """A (8, 6) value laid out over dp 2 x tp 2 (on two dimensions, or
    both on one, in either order): the parts are the blocks of the
    placement rule, ``full()`` assembles the value bitwise, and
    ``over(["tp"])`` gives the tp-only layout's parts."""
    mesh = make_mesh(dp=2, tp=2, devices=["cpu"] * 4)
    value = torch.arange(48, dtype=torch.float32).reshape(8, 6)
    if spec == (None, ("tp", "dp")):
        value = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    st = ShardedTensor.cut(value, spec, mesh)
    assert len(st.parts) == 4 and st.numel() == value.numel()
    for part, ix in zip(st.parts, st.blocks()):
        assert torch.equal(part, value[ix])
    assert torch.equal(st.full(), value)
    tp_only = st.over(["tp"])
    for part, ix in zip(tp_only.parts, tp_only.blocks()):
        assert torch.equal(part, value[ix])
    assert torch.equal(tp_only.full(), value)


# ---------------------------------------------------------------------------
# the world: dp 2 x sp 2 x tp 2 over eight gloo processes
# ---------------------------------------------------------------------------

WORKER = r'''
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)
import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import unique_name as tun
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.parallel import ShardedTensor
from paddle_tpu_torch.parallel import fleet as fleet_mod
from test_torch_mixed_mesh import SEQ, narrow_cfg

inputs, out = sys.argv[1], sys.argv[2]
s = fleet_mod.DistributedStrategy()
s.tp_degree, s.sp_degree = 2, 2
flt = fleet_mod.Fleet().init(strategy=s)
mesh = flt.mesh()
assert mesh.world and dict(mesh.shape) == {"dp": 2, "pp": 1, "ep": 1,
                                           "sp": 2, "tp": 2}
data = np.load(inputs)
cfg = narrow_cfg(tbert)
main, startup = fluid.Program(), fluid.Program()
main.random_seed = startup.random_seed = 7
with tun.guard(), fluid.program_guard(main, startup):
    _f, loss, _m, _a = tbert.build_pretrain_net(cfg, seq_len=SEQ)
    flt.distributed_optimizer(fluid.optimizer.AdamOptimizer(1e-3)).minimize(
        loss)
scope = fluid.scope_from_numpy(
    {k[6:]: data[k] for k in data.files if k.startswith("scope/")}, "cpu")
feed = {k[5:]: data[k] for k in data.files if k.startswith("feed/")}
names = [p.name for p in main.all_parameters()]
comp = fluid.CompiledProgram(main).with_mesh(mesh)
exe = fluid.Executor(fluid.CPUPlace())
res = {}
with fluid.scope_guard(scope):
    for i in range(2):
        got = exe.run(comp, feed=feed, fetch_list=[loss] + (
            [n + "@GRAD" for n in names] if i == 0 else []))
        res["loss%d" % i] = got[0]
        if i == 0:
            for n, g in zip(names, got[1:]):
                res["grad/" + n] = g
    q = scope.get("enc0_attn_q")
    res["q_part"] = np.array(list(q.parts[0].shape))
res["coords"] = np.array([mesh.coords()[a] for a in ("dp", "sp", "tp")])
np.savez(os.path.join(out, "rank%d.npz" % flt.worker_index()), **res)
print("MIXED_OK", flt.worker_index())
'''


def test_world_dp2_sp2_tp2_matches_the_local_form(twin, tmp_path):
    """Eight gloo processes through the launcher, fleet's strategy tp 2 x
    sp 2 on a world of 8 (dp 2): every rank's two losses and first
    @GRADs equal the local dp 2 x sp 2 x tp 2 run's and dp 1's within
    the tolerances above; each rank holds its tp part of the Megatron
    weights, and its coordinates run over the mesh row-major."""
    np.savez(tmp_path / "inputs.npz",
             **{"scope/" + n: v for n, v in twin.init.items()},
             **{"feed/" + k: v for k, v in twin.feed.items()})
    script = tmp_path / "mixed_worker.py"
    script.write_text(WORKER)
    tests = os.path.dirname(os.path.abspath(__file__))
    rc = run_launcher(script, [str(tmp_path / "inputs.npz"), str(tmp_path)],
                      tmp_path, 8, free_port(), timeout=240,
                      pythonpath=tests)
    assert rc == 0, logs(tmp_path, 8)
    local, _ = twin.port(make_mesh(dp=2, sp=2, tp=2, devices=["cpu"] * 8))
    for r in range(8):
        got = np.load(tmp_path / f"rank{r}.npz")
        assert list(got["coords"]) == [r // 4, (r // 2) % 2, r % 2]
        assert list(got["q_part"]) == [64, 32]
        ranked = [[got["loss0"]] + [got["grad/" + n] for n in twin.names],
                  [got["loss1"]]]
        losses_close(ranked, local)
        grads_close(ranked[0][1:], local[0][1:], twin.names)
