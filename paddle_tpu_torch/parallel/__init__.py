"""Distributed / parallel execution: the counterpart of
``paddle_tpu/parallel/`` with the device mesh (``mesh.py``: a
``torch.distributed`` world or a local mesh), ring attention over its
sequence-parallel axis (``ring_attention.py``), the functional
data-parallel step (``data_parallel.py``; Programs take
``CompiledProgram.with_data_parallel``) and the tensor-parallel shard
rules (``tensor_parallel.py``). Pipeline and expert parallelism, the
collectives, the transpiler and fleet are not ported yet."""

from .mesh import MeshConfig, get_mesh, set_mesh, make_mesh, mesh_axes
from .ring_attention import ring_attention, blockwise_attention
from .data_parallel import data_parallel_step
from .tensor_parallel import (PartitionSpec, ShardRules, apply_shard_rules,
                              column_parallel_spec, row_parallel_spec,
                              shard_params_spec, shard_state)

__all__ = ["MeshConfig", "get_mesh", "set_mesh", "make_mesh", "mesh_axes",
           "ring_attention", "blockwise_attention", "data_parallel_step",
           "PartitionSpec", "ShardRules", "apply_shard_rules",
           "column_parallel_spec", "row_parallel_spec", "shard_params_spec",
           "shard_state"]
