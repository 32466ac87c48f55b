"""I/O of the port (``paddle_tpu/io``'s counterpart, its own copy):
parameters and persistables (``state.py``), inference models
(``inference_io.py``), Fluid 1.5's LoDTensor files and ``__model__``
protobuf (``fluid_format.py``, ``fluid_proto.py``), checkpoints with their
async writer (``checkpoint.py``: format 2, atomic writes, a CRC32
manifest), and the dataset plane (``dataset.py``). Every file format is
the JAX package's, so what one package writes the other reads; the
sharded checkpoint (``save_checkpoint_sharded`` / ``load_checkpoint_
sharded``: one file a distinct shard of a sharded value, ``index.json``
the commit marker, a restore onto any mesh or none)."""

from .state import (save_vars, save_params, save_persistables, load_vars,
                    load_params, load_persistables, is_parameter,
                    is_persistable, get_parameter_value,
                    get_parameter_value_by_name)
from .inference_io import save_inference_model, load_inference_model
from .checkpoint import (CHECKPOINT_FORMAT, CheckpointCorruptError,
                         CheckpointHandle, load_checkpoint,
                         load_checkpoint_sharded, save_checkpoint,
                         save_checkpoint_async, save_checkpoint_sharded,
                         set_write_fault_hook)
from .fluid_format import (load_fluid_vars, save_fluid_vars,
                           load_fluid_persistables)
from .fluid_proto import (parse_program_desc, encode_program_desc,
                          load_fluid_inference_model,
                          save_fluid_inference_model)

__all__ = ["save_vars", "save_params", "save_persistables", "load_vars",
           "load_params", "load_persistables", "is_parameter",
           "is_persistable", "get_parameter_value",
           "get_parameter_value_by_name", "save_inference_model",
           "load_inference_model", "CHECKPOINT_FORMAT",
           "CheckpointCorruptError", "CheckpointHandle", "save_checkpoint",
           "load_checkpoint", "save_checkpoint_async",
           "save_checkpoint_sharded", "load_checkpoint_sharded",
           "set_write_fault_hook", "load_fluid_vars", "save_fluid_vars",
           "load_fluid_persistables", "parse_program_desc",
           "encode_program_desc", "load_fluid_inference_model",
           "save_fluid_inference_model"]
