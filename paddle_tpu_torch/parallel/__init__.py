"""Distributed / parallel execution: the counterpart of
``paddle_tpu/parallel/`` with the device mesh (``mesh.py``: a
``torch.distributed`` world or a local mesh, the hybrid DCN mesh,
``multihost_initialize``), ring attention over its sequence-parallel
axis (``ring_attention.py``), the functional data-parallel step
(``data_parallel.py``; Programs take ``CompiledProgram.
with_data_parallel``), the tensor-parallel shard rules
(``tensor_parallel.py``), sharded state (``sharded.py``:
``ShardedTensor``, which ``CompiledProgram`` lays persistables out as by
their ``dist_attr``) and the transpiler's ZeRO-1 / FSDP annotations
(``transpiler.py``), the collectives over a named axis
(``collective.py``) and fleet (``fleet.py``: the role makers,
``DistributedStrategy``, ``fleet.init`` over a ``torch.distributed``
world), pipeline parallelism (``pipeline.py``: GPipe, 1F1B,
``PipelineOptimizer``) and expert parallelism (``moe.py``: top-1 gating,
the all-to-all dispatch over the mesh's "ep" axis, ``MoELayer``)."""

from .mesh import (MeshConfig, get_mesh, set_mesh, make_mesh, mesh_axes,
                   make_hybrid_mesh, host_domains, multihost_initialize,
                   named_sharding, replicated)
from .collective import (allreduce, broadcast, allgather, reducescatter,
                         alltoall, barrier, send_recv)
from .ring_attention import ring_attention, blockwise_attention
from .data_parallel import data_parallel_step
from .tensor_parallel import (PartitionSpec, ShardRules, apply_shard_rules,
                              column_parallel_spec, row_parallel_spec,
                              shard_params_spec, shard_state)
from .sharded import ShardedTensor
from .transpiler import (DistributeTranspiler, DistributeTranspilerConfig,
                         shard_optimizer_state, shard_params_fsdp)
from .pipeline import (pipeline_step, pipeline_apply, pipeline_1f1b,
                       bubble_fraction, schedule_stats, PipelineOptimizer)
from .moe import (top1_gating, expert_parallel_dispatch,
                  expert_parallel_combine, moe_apply, MoELayer)
from . import fleet

__all__ = ["MeshConfig", "get_mesh", "set_mesh", "make_mesh", "mesh_axes",
           "make_hybrid_mesh", "host_domains", "multihost_initialize",
           "named_sharding", "replicated", "allreduce", "broadcast",
           "allgather", "reducescatter", "alltoall", "barrier", "send_recv",
           "ring_attention", "blockwise_attention", "data_parallel_step",
           "PartitionSpec", "ShardRules", "apply_shard_rules",
           "column_parallel_spec", "row_parallel_spec", "shard_params_spec",
           "shard_state", "ShardedTensor", "DistributeTranspiler",
           "DistributeTranspilerConfig", "shard_optimizer_state",
           "shard_params_fsdp", "pipeline_step", "pipeline_apply",
           "pipeline_1f1b", "bubble_fraction", "schedule_stats",
           "PipelineOptimizer", "top1_gating", "expert_parallel_dispatch",
           "expert_parallel_combine", "moe_apply", "MoELayer", "fleet"]
