"""The port's DCN-aware hybrid mesh (``parallel/mesh.py``), against the
JAX package, on the CPU.

Twins of ``tests/parallel/test_hybrid_mesh.py:19,32,44,53,74``: 8
positions emulating 2 hosts x 4 devices (``hosts=2`` on a local mesh,
as JAX's chunks its 8 virtual CPU devices); the model axes (sp, tp) stay
inside one host while dp (or a pipeline split over DCN) crosses hosts,
laid out position for position as JAX's mesh is. JAX's collectives case
(``shard_map`` with a psum over tp) becomes the port's row-parallel
product over the hybrid mesh's tp axis, finished by ``reduce_fn``, within
1e-5 of the dense product. ``multihost_initialize`` keeps Fluid's
endpoint forms: one endpoint is no world, a missing current endpoint
raises.
"""

import numpy as np
import pytest
import torch

import jax

from paddle_tpu.parallel import mesh as jmesh_mod

from paddle_tpu_torch.parallel import mesh as mesh_mod


def _hybrid(**kw):
    return mesh_mod.make_hybrid_mesh(devices=["cpu"] * 8, **kw)


def _same_layout_as_jax(m, jm):
    """The port's positions are JAX's device ids, position for position
    (``host_index`` keeps each position's index among the devices)."""
    assert m.axis_names == tuple(jm.axis_names)
    assert m.devices.shape == jm.devices.shape
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    np.testing.assert_array_equal(m.host_index, ids)


def test_hybrid_mesh_keeps_model_axes_host_local():
    m = _hybrid(dp_dcn=2, tp=2, sp=2, hosts=2)
    assert m.shape == {"dp": 2, "pp": 1, "ep": 1, "sp": 2, "tp": 2}
    _same_layout_as_jax(m, jmesh_mod.make_hybrid_mesh(dp_dcn=2, tp=2, sp=2,
                                                      hosts=2))
    doms = mesh_mod.host_domains(m, per_host=4)
    for d in range(2):
        assert len(np.unique(doms[d, 0, 0, :, :])) == 1, doms
    assert doms[0].ravel()[0] != doms[1].ravel()[0]


def test_hybrid_mesh_pp_over_dcn():
    m = _hybrid(dp_dcn=1, pp_dcn=2, tp=4, hosts=2)
    assert m.shape == {"dp": 1, "pp": 2, "ep": 1, "sp": 1, "tp": 4}
    _same_layout_as_jax(m, jmesh_mod.make_hybrid_mesh(dp_dcn=1, pp_dcn=2,
                                                      tp=4, hosts=2))
    doms = mesh_mod.host_domains(m, per_host=4)
    assert len(np.unique(doms[:, 0])) == 1
    assert len(np.unique(doms[:, 1])) == 1
    assert doms[0, 0, 0, 0, 0] != doms[0, 1, 0, 0, 0]


@pytest.mark.parametrize("kw", [dict(dp_dcn=2, tp=8, hosts=2),
                                dict(dp_dcn=3, tp=4, hosts=2),
                                dict(tp=4, hosts=3)])
def test_hybrid_mesh_validation_errors(kw):
    """8 > 4 devices a host; 3 != 2 hosts; 8 % 3 != 0: both packages
    raise ValueError."""
    with pytest.raises(ValueError):
        _hybrid(**kw)
    with pytest.raises(ValueError):
        jmesh_mod.make_hybrid_mesh(**kw)


def test_row_parallel_product_under_hybrid_mesh_matches_dense():
    """The batch over dp, the contraction over tp: each (dp, tp) position
    multiplies its rows' block of x by its rows of w, reduce_fn('tp')
    finishes each dp row block, within 1e-5 of x @ w; one reduction a dp
    block."""
    m = _hybrid(dp_dcn=2, tp=2, sp=2, hosts=2)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 12)).astype(np.float32))
    dp, tp = m.shape["dp"], m.shape["tp"]
    rows = []
    for d in m.held("dp"):
        xb = x.chunk(dp)[d]
        partials = [xb.chunk(tp, dim=1)[t] @ w.chunk(tp)[t]
                    for t in m.held("tp")]
        rows.append(m.reduce_fn("tp")(partials))
    np.testing.assert_allclose(torch.cat(rows).numpy(), (x @ w).numpy(),
                               rtol=1e-5, atol=1e-5)
    assert m.reductions == dp


def test_multihost_initialize_endpoint_parity():
    """A single endpoint is one process: no world, False, as JAX's; an
    endpoint list without current_endpoint raises ValueError."""
    assert mesh_mod.multihost_initialize(
        endpoints=["10.0.0.1:7164"],
        current_endpoint="10.0.0.1:7164") is False
    assert jmesh_mod.multihost_initialize(
        endpoints=["10.0.0.1:7164"],
        current_endpoint="10.0.0.1:7164") is False
    with pytest.raises(ValueError):
        mesh_mod.multihost_initialize(endpoints=["a:1", "b:2"])
    assert not torch.distributed.is_initialized()


def test_named_sharding_and_replicated_layouts():
    """named_sharding / replicated give the (spec, mesh) a ShardedTensor
    holds; a value cut by it over the hybrid mesh's tp axis has JAX's
    shard shapes."""
    from paddle_tpu_torch.parallel import PartitionSpec, ShardedTensor
    m = _hybrid(dp_dcn=2, tp=2, sp=2, hosts=2)
    spec, mesh = mesh_mod.named_sharding(PartitionSpec(None, "tp"), m)
    assert mesh is m and spec == PartitionSpec(None, "tp")
    assert mesh_mod.replicated(m) == (PartitionSpec(), m)
    v = ShardedTensor.cut(torch.arange(48.).reshape(4, 12), spec, mesh)
    jm = jmesh_mod.make_hybrid_mesh(dp_dcn=2, tp=2, sp=2, hosts=2)
    jv = jax.device_put(np.arange(48.).reshape(4, 12),
                        jmesh_mod.named_sharding(
                            jax.sharding.PartitionSpec(None, "tp"), jm))
    assert {tuple(p.shape) for p in v.parts} == {
        tuple(s.data.shape) for s in jv.addressable_shards}
    np.testing.assert_array_equal(v.full().numpy(), np.asarray(jv))
