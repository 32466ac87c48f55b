"""Ring and blockwise attention over the port's sequence-parallel mesh,
against the JAX package, on the CPU.

Twins of ``tests/parallel/test_ring_attention.py`` (its non-slow cases,
at their own sp: a local mesh holds all its ranks in one process, so sp
8 costs no processes), ``tests/parallel/test_ring_flash.py`` (all three,
``test_flash_lse_gradient_path`` included) and
``tests/parallel/test_sp_framework.py`` (the key-side bias, the per-query
rejection and the dispatch guards; the BERT Program under an sp mesh).
The same numpy inputs go through JAX's function on its 8-device CPU mesh
and the port's; both are held to the dense oracle at the JAX tests'
tolerances, and to each other. On the CPU each ring step takes the plain
version of the flash kernels (``flash_attention_reference``), which
``flash_attention_with_lse`` picks for CPU tensors.

One test runs the ring over a ``torch.distributed`` world (gloo, sp 2
and 4, one process a rank): the only test of the rotation's
``batch_isend_irecv``, its results held to JAX's.
"""

import importlib
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.parallel.mesh import make_mesh as jmake_mesh
from paddle_tpu.ops.attention_ops import _xla_attention as jxla
from paddle_tpu.ops.pallas import flash as jflash

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import unique_name as tun
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops import attention_ops as tattn
from paddle_tpu_torch.ops import flash as tflash
from paddle_tpu_torch.parallel import (MeshConfig, blockwise_attention,
                                       get_mesh, make_mesh, mesh_axes,
                                       set_mesh)

jra = importlib.import_module("paddle_tpu.parallel.ring_attention")
tra = importlib.import_module("paddle_tpu_torch.parallel.ring_attention")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module: the suite runs
    several pytest workers at once, and torch's default of one thread a
    core in each worker oversubscribes the CPU, where the small eager ops
    of these tests then wait on each other's threads (six concurrent
    80-step tiny-BERT runs took 1448 s each at 8 threads, 4 s at one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _local(sp=1, tp=1, dp=None, n=None):
    n = n if n is not None else (dp or 1) * sp * tp
    return make_mesh(dp=dp, tp=tp, sp=sp, devices=["cpu"] * n)


def _qkv(b=2, h=2, t=32, d=8, seed=0):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(b, h, t, d).astype(np.float32) for _ in range(3))


def _full(q, k, v, causal=False):
    """test_ring_attention.py's golden, plain softmax attention in f32."""
    q, k, v = (jnp.asarray(x) for x in (q, k, v))
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) / jnp.sqrt(q.shape[-1]).astype(
        q.dtype)
    if causal:
        t = q.shape[2]
        s = jnp.where(jnp.tril(jnp.ones((t, t), bool)), s, -jnp.inf)
    return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, axis=-1), v)


def _t(*xs, grad=False):
    return tuple(torch.tensor(x, requires_grad=grad) for x in xs)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# tests/parallel/test_ring_attention.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_blockwise_matches_full(causal):
    q, k, v = _qkv()
    got = blockwise_attention(*_t(q, k, v), block_size=8, causal=causal)
    jgot = jra.blockwise_attention(q, k, v, block_size=8, causal=causal)
    _close(got, _full(q, k, v, causal), 2e-5)
    _close(got, jgot, 2e-5)


def test_blockwise_ragged_block():
    # T not a multiple of block_size exercises the pad+mask path
    q, k, v = _qkv(t=19)
    got = blockwise_attention(*_t(q, k, v), block_size=8)
    _close(got, _full(q, k, v), 2e-5)
    _close(got, jra.blockwise_attention(q, k, v, block_size=8), 2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_full(causal):
    # 2dp x 2tp x 2sp: JAX shards batch, heads and sequence; the local
    # mesh runs the two sp rings over the whole batch and all heads
    q, k, v = _qkv(b=2, h=2, t=32, d=8)
    mesh = _local(tp=2, sp=2, n=8)
    assert mesh.shape["dp"] == 2
    got = tra.ring_attention_sharded(*_t(q, k, v), mesh, causal=causal)
    jgot = jra.ring_attention_sharded(q, k, v, jmake_mesh(tp=2, sp=2),
                                      causal=causal)
    _close(got, _full(q, k, v, causal), 2e-5)
    _close(got, jgot, 2e-5)


@pytest.mark.parametrize("t,seed", [(64, 1), (2048, 3)],
                         ids=["sp8", "sp8_long_sequence"])
def test_ring_sp8(t, seed):
    """All 8 ranks on the sequence axis, causal; at 2048 tokens (256 a
    rank) the online log-sum-exp combine over 8 hops must stay tight."""
    q, k, v = _qkv(b=1, h=1, t=t, d=4, seed=seed)
    got = tra.ring_attention_sharded(*_t(q, k, v), _local(sp=8),
                                     causal=True, batch_axis="dp",
                                     seq_axis="sp", head_axis="tp")
    jgot = jra.ring_attention_sharded(q, k, v, jmake_mesh(sp=8),
                                      causal=True)
    _close(got, _full(q, k, v, True), 2e-5)
    _close(got, jgot, 2e-5)


def _grads(fn, q, k, v):
    tq, tk, tv = _t(q, k, v, grad=True)
    return [g.numpy() for g in torch.autograd.grad(
        (fn(tq, tk, tv) ** 2).sum(), (tq, tk, tv))]


@pytest.mark.parametrize("sp,b,t,d,seed,causal,tol", [
    (8, 1, 1024, 4, 4, True, 2e-4), (2, 4, 16, 4, 2, False, 1e-4)],
    ids=["sp8_long_sequence_grads", "grads_match_full"])
def test_ring_grads(sp, b, t, d, seed, causal, tol):
    """Backward through the ring (the rotation's inverse carries the K/V
    cotangents home) == full attention's, and == JAX's jax.grad of its
    ring."""
    q, k, v = _qkv(b=b, h=1, t=t, d=d, seed=seed)
    mesh = _local(sp=sp)
    got = _grads(lambda a, b_, c: tra.ring_attention_sharded(
        a, b_, c, mesh, causal=causal), q, k, v)
    jmesh = jmake_mesh(sp=sp, devices=jax.devices()[:sp])
    jring = jax.grad(lambda a, b_, c: jnp.sum(jra.ring_attention_sharded(
        a, b_, c, jmesh, causal=causal) ** 2), argnums=(0, 1, 2))(q, k, v)
    jfull = jax.grad(lambda a, b_, c: jnp.sum(_full(a, b_, c, causal) ** 2),
                     argnums=(0, 1, 2))(q, k, v)
    for g, jr, jf in zip(got, jring, jfull):
        _close(g, jf, tol)
        _close(g, jr, tol)


# ---------------------------------------------------------------------------
# tests/parallel/test_ring_flash.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_matches_full(causal, monkeypatch):
    """Out, loss and gradients of sum(sin(ring)) on an sp 4 mesh against
    the dense oracle; the JAX side runs its ring through the Pallas flash
    kernels (interpret mode), the port's steps through the plain flash
    versions."""
    b, h, t, d = 1, 2, 64, 16
    q, k, v = _qkv(b, h, t, d, seed=9)
    scale = 1.0 / d ** 0.5
    mesh = _local(sp=4)
    tq, tk, tv = _t(q, k, v, grad=True)
    o = tra.ring_attention_sharded(tq, tk, tv, mesh, causal=causal)
    loss = torch.sin(o).sum()
    grads = torch.autograd.grad(loss, (tq, tk, tv))
    of = tflash.flash_attention(*_t(q, k, v), scale=scale, causal=causal)

    monkeypatch.setenv("PADDLE_TPU_FORCE_FLASH", "1")
    jmesh = jmake_mesh(sp=4, devices=jax.devices()[:4])

    def ring_loss(a, b_, c):
        out = jra.ring_attention_sharded(a, b_, c, jmesh, causal=causal)
        return jnp.sum(jnp.sin(out)), out

    def full_loss(a, b_, c):
        out = jflash._xla_ref(a, b_, c, scale, causal)
        return jnp.sum(jnp.sin(out)), out

    (jl, jo), jg = jax.value_and_grad(ring_loss, argnums=(0, 1, 2),
                                      has_aux=True)(q, k, v)
    (fl, fo), fg = jax.value_and_grad(full_loss, argnums=(0, 1, 2),
                                      has_aux=True)(q, k, v)
    _close(o.detach(), fo, 2e-5)
    _close(o.detach(), jo, 2e-5)
    _close(of, fo, 2e-5)
    np.testing.assert_allclose(loss.item(), float(fl), rtol=1e-5)
    for a, jr, f in zip(grads, jg, fg):
        _close(a, f, 5e-5)
        _close(a, jr, 5e-5)


def test_flash_lse_gradient_path():
    """Differentiating THROUGH the lse output (the ring combine path)
    matches the oracle and JAX's Pallas kernels (interpret mode): the
    loss uses both out and lse."""
    b, h, t, d = 1, 2, 32, 8
    q, k, v = _qkv(b, h, t, d, seed=1)
    scale = 1.0 / d ** 0.5
    tq, tk, tv = _t(q, k, v, grad=True)
    o, lse = tflash.flash_attention_with_lse(tq, tk, tv, scale=scale)
    got = torch.autograd.grad(torch.sin(o).sum() + torch.cos(lse).sum(),
                              (tq, tk, tv))

    def loss_flash(a, b_, c):
        out, l_ = jflash.flash_attention_with_lse(a, b_, c, scale=scale,
                                                  block_q=16, block_k=16)
        return jnp.sum(jnp.sin(out)) + jnp.sum(jnp.cos(l_))

    def loss_oracle(a, b_, c):
        s = jnp.einsum("bhqd,bhkd->bhqk", a, b_).astype(jnp.float32) * scale
        l_ = jax.scipy.special.logsumexp(s, axis=-1)
        p = jnp.exp(s - l_[..., None])
        out = jnp.einsum("bhqk,bhkd->bhqd", p, c)
        return jnp.sum(jnp.sin(out)) + jnp.sum(jnp.cos(l_))

    gf = jax.grad(loss_flash, argnums=(0, 1, 2))(q, k, v)
    go = jax.grad(loss_oracle, argnums=(0, 1, 2))(q, k, v)
    for a, f, o_ in zip(got, gf, go):
        _close(a, o_, 3e-5)
        _close(a, f, 3e-5)


# ---------------------------------------------------------------------------
# tests/parallel/test_sp_framework.py
# ---------------------------------------------------------------------------

def test_ring_bias_matches_dense_functional():
    """ring_attention_sharded with a key-side padding bias == the dense
    oracle and JAX's ring, on an sp 4 mesh."""
    q, k, v = _qkv(b=2, h=2, t=32, d=8)
    bias = np.zeros((2, 1, 1, 32), np.float32)
    bias[1, :, :, -5:] = -1e9
    got = tra.ring_attention_sharded(*_t(q, k, v), _local(sp=4),
                                     bias=torch.from_numpy(bias))
    jgot = jra.ring_attention_sharded(
        q, k, v, jmake_mesh(sp=4, devices=jax.devices()[:4]), bias=bias)
    want = tattn._xla_attention(*_t(q, k, v), bias=torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jxla(
        q, k, v, bias=bias)), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=2e-4,
                               atol=2e-5)


def test_ring_bias_rejects_per_query():
    x = torch.zeros((1, 1, 8, 4))
    with pytest.raises(ValueError):
        tra.ring_attention_sharded(x, x, x, _local(sp=2),
                                   bias=torch.zeros((1, 1, 8, 8)))


def test_sp_dispatch_needs_an_active_mesh():
    """No mesh activated (``with mesh:``): None, also with a global mesh
    set. The reference's PADDLE_TPU_DISABLE_RING switch is not ported."""
    q = torch.zeros((1, 1, 8, 4))
    assert tattn._active_sp_mesh(q, q, None) is None
    old = set_mesh(_local(sp=2))
    try:
        assert get_mesh().shape["sp"] == 2
        assert tattn._active_sp_mesh(q, q, None) is None
    finally:
        set_mesh(old)


def test_sp_dispatch_guards_cross_attention_and_odd_bias():
    """Shapes the ring can't decompose fall back (return None), never
    raise: cross-attention Tk not divisible, a rank-2 bias, a per-query
    bias, dp not dividing the batch."""
    q = torch.zeros((1, 1, 8, 4))
    k_bad = torch.zeros((1, 1, 9, 4))       # 9 % 2 != 0
    mesh = _local(sp=2)
    with mesh:
        assert tattn._active_sp_mesh(q, k_bad, None) is None
        assert tattn._active_sp_mesh(q, q, torch.zeros((8, 8))) is None
        assert tattn._active_sp_mesh(q, q, torch.zeros((1, 1, 8, 8))) is None
        assert tattn._active_sp_mesh(q, q, None) is mesh
        assert tattn._active_sp_mesh(q, q, torch.zeros((1, 1, 1, 8))) is mesh
    with _local(dp=2, sp=2):
        assert tattn._active_sp_mesh(q, q, None) is None
    assert tattn._active_sp_mesh(q, q, None) is None


def test_packed_inputs_warn_once_and_take_the_dense_path(monkeypatch):
    """Segment ids under an sp mesh: the reference's one-time
    RuntimeWarning, and the dense path's result (no ring step runs)."""
    monkeypatch.setattr(tattn, "_ring_seg_warned", False)
    steps = []
    monkeypatch.setattr(tra, "_ring_step_flash",
                        lambda *a, **kw: steps.append(1))
    q, k, v = _t(*_qkv(b=1, h=2, t=8, d=4))
    seg = torch.tensor([[1, 1, 1, 2, 2, 2, 0, 0]])
    dense = tattn.dot_product_attention(q, k, v, segment_ids=seg)
    with _local(sp=2):
        with pytest.warns(RuntimeWarning, match="segment_ids"):
            a = tattn.dot_product_attention(q, k, v, segment_ids=seg)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            b = tattn.dot_product_attention(q, k, v, segment_ids=seg)
    assert not steps
    assert torch.equal(a, dense) and torch.equal(b, dense)


@pytest.mark.parametrize("sp,causal,want", [(4, True, 10), (4, False, 16),
                                            (8, True, 36)])
def test_ring_launches_one_flash_step_per_visible_block(sp, causal, want,
                                                        monkeypatch):
    """A causal ring of sp ranks runs sp(sp+1)/2 flash steps (a future
    owner launches nothing), a non-causal one sp**2; each step's backward
    is one dQ and one dK/dV launch on the card."""
    calls = []
    real = tra.flash_attention_with_lse

    def count(*a, **kw):
        calls.append(kw["causal"])
        return real(*a, **kw)

    monkeypatch.setattr(tra, "flash_attention_with_lse", count)
    q, k, v = _t(*_qkv(b=1, h=1, t=8 * sp, d=4), grad=True)
    out = tra.ring_attention_sharded(q, k, v, _local(sp=sp), causal=causal)
    out.sum().backward()
    assert len(calls) == want
    assert sum(calls) == (sp if causal else 0)


def test_mesh_layout_and_config():
    """make_mesh lays ranks out as JAX's (dp, pp, ep, sp, tp), dp is what
    is left of the devices, and MeshConfig/mesh_axes as the reference."""
    mesh = _local(tp=2, sp=2, n=8)
    jmesh = jmake_mesh(tp=2, sp=2)
    assert mesh_axes(mesh) == tuple(jmesh.axis_names)
    assert mesh.shape == dict(jmesh.shape)
    assert mesh.devices.shape == jmesh.devices.shape
    with pytest.raises(ValueError):
        make_mesh(tp=3, devices=["cpu"] * 8)
    cfg = MeshConfig(dp=2, sp=4)
    assert cfg.size() == 8 and cfg.shape["sp"] == 4


def _bert_program(cfg, seq_len):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with tun.guard(), fluid.program_guard(main, startup):
        _f, total, _m, _a = tbert.build_pretrain_net(cfg, seq_len=seq_len)
        fluid.optimizer.AdamOptimizer(learning_rate=1e-3).minimize(total)
    return main, startup, total


def test_sp_framework_program_matches_single_device():
    """The BERT Program run under a local sp=2 mesh (``with mesh:``: every
    layer's attention takes the ring, its padding bias rotating with K/V)
    gives the single-device run's losses over two Adam steps. The
    reference's dp=2 x sp=2 twin needs the data-parallel
    ``CompiledProgram.with_mesh``, which waits for the data-parallel
    port."""
    seq_len, batch = 32, 4
    cfg = tbert.bert_tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    feed = tbert.make_pretrain_feed(cfg, seq_len, batch)
    feed["input_mask"][2, 23:] = 0.0
    main, startup, loss = _bert_program(cfg, seq_len)
    exe = fluid.Executor(fluid.CPUPlace())
    base = fluid.Scope()
    with fluid.scope_guard(base):
        exe.run(startup)
    steps = []
    monkey = tra._ring_step_flash

    def counted(*a, **kw):
        steps.append(1)
        return monkey(*a, **kw)

    def run(mesh):
        scope = fluid.Scope()
        for n in base.names():
            scope.set(n, base.get(n).clone())
        losses = []
        with fluid.scope_guard(scope):
            for _ in range(2):
                if mesh is None:
                    out, = exe.run(main, feed=feed, fetch_list=[loss])
                else:
                    with mesh:
                        out, = exe.run(main, feed=feed, fetch_list=[loss])
                losses.append(float(np.asarray(out).reshape(-1)[0]))
        return losses

    ref = run(None)
    tra._ring_step_flash = counted
    try:
        got = run(_local(sp=2))
    finally:
        tra._ring_step_flash = monkey
    assert len(steps) == 2 * cfg.num_hidden_layers * 4
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the ring over a torch.distributed world (gloo, one process a rank)
# ---------------------------------------------------------------------------

WORKER = r'''
import datetime
import importlib
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def rank_main(rank, world, init, out, inputs):
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        from paddle_tpu_torch.parallel.mesh import make_mesh
        ra = importlib.import_module(
            "paddle_tpu_torch.parallel.ring_attention")
        data = np.load(inputs)
        mesh = make_mesh(sp=world)
        assert mesh.world and mesh.coords()["sp"] == rank
        res = {}
        for tag, causal in (("bias", False), ("causal", True)):
            q, k, v = (torch.tensor(data[n], requires_grad=True)
                       for n in "qkv")
            bias = None if causal else torch.tensor(data["bias"])
            o = ra.ring_attention_sharded(q, k, v, mesh, causal=causal,
                                          bias=bias)
            grads = torch.autograd.grad((o ** 2).sum(), (q, k, v))
            res[tag + "_out"] = o.detach().numpy()
            for n, g in zip("qkv", grads):
                res[tag + "_d" + n] = g.numpy()
        np.savez(out + "/rank%d.npz" % rank, **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    world, init, out, inputs = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                sys.argv[4])
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, world, init, out,
                                                 inputs))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(100)
    codes = [p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    sys.exit(0 if codes == [0] * world else 1)
'''


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_over_gloo_world_matches_jax(sp, tmp_path):
    """sp processes joined by gloo (``file://`` rendezvous under tmp_path,
    so parallel test workers never race for a port) run
    ring_attention_sharded over a world mesh, non-causal with a key-side
    padding bias and causal: every rank's output and d q/k/v equal JAX's
    ring on its sp-device CPU mesh (the tolerances of test_sp_framework /
    test_ring_attention). Every wait is bounded: the process group's 60 s,
    the launcher's joins and the run's 120 s."""
    q, k, v = _qkv(b=2, h=2, t=16 * sp, d=8, seed=11)
    bias = np.zeros((2, 1, 1, 16 * sp), np.float32)
    bias[0, :, :, -7:] = -1e9
    inputs = tmp_path / "inputs.npz"
    np.savez(inputs, q=q, k=k, v=v, bias=bias)
    script = tmp_path / "ring_worker.py"
    script.write_text(WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, str(script), str(sp),
         "file://" + str(tmp_path / "rendezvous"), str(tmp_path),
         str(inputs)], env=env, cwd=str(tmp_path), capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-4000:]
    jmesh = jmake_mesh(sp=sp, devices=jax.devices()[:sp])
    want = {}
    for tag, causal, b in (("bias", False, bias), ("causal", True, None)):
        def loss(a, b_, c):
            return jnp.sum(jra.ring_attention_sharded(
                a, b_, c, jmesh, causal=causal, bias=b) ** 2)
        want[tag + "_out"] = jra.ring_attention_sharded(
            q, k, v, jmesh, causal=causal, bias=b)
        for n, g in zip("qkv", jax.grad(loss, argnums=(0, 1, 2))(q, k, v)):
            want[tag + "_d" + n] = g
    for rank in range(sp):
        got = np.load(tmp_path / f"rank{rank}.npz")
        for key, w in want.items():
            tol = 2e-5 if key.endswith("_out") else 1e-4
            np.testing.assert_allclose(got[key], np.asarray(w), rtol=tol,
                                       atol=tol,
                                       err_msg=f"rank {rank} {key}")
