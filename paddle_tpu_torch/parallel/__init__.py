"""Distributed / parallel execution: the counterpart of
``paddle_tpu/parallel/`` with the device mesh (``mesh.py``: a
``torch.distributed`` world or a local mesh) and ring attention over its
sequence-parallel axis (``ring_attention.py``). Data, tensor, pipeline
and expert parallelism, the collectives and fleet are not ported yet."""

from .mesh import MeshConfig, get_mesh, set_mesh, make_mesh, mesh_axes
from .ring_attention import ring_attention, blockwise_attention

__all__ = ["MeshConfig", "get_mesh", "set_mesh", "make_mesh", "mesh_axes",
           "ring_attention", "blockwise_attention"]
