"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The JAX package (``paddle_tpu``) stays the reference; this package mirrors
its layout module for module, imports ``torch`` and never ``jax`` or
``paddle_tpu``, and runs its kernels as hand-written CUDA for Hopper
(``csrc/``), built at first use. Entry points run on the card unless the
caller asks for the CPU (``device="cpu"``, ``Executor(CPUPlace())``).

Ported so far: continuous-batching GPT serving (``serving/``,
``models/gpt.py``), dense or int8 KV pools, MHA or grouped-query heads,
optionally int8 weights, with the paged-attention kernel
(``ops/cuda/paged.py``); prompt-conditioned decoding with the
flash-attention forward (``ops/flash.py``); and static-graph GPT training
through the Fluid entry points (``core/``, ``layers/``, ``optimizer/``,
``ops/``), whose attention backward runs the flash-attention backward
kernels; BERT/ERNIE-1.0 pretraining, padded or packed, through the same
entry points (``models/bert.py``, ``models/ernie.py``,
``reader/packing.py``), with the training recipe: bf16 mixed precision
and loss scaling (``amp/``), the learning-rate schedules
(``layers/learning_rate_scheduler.py``), gradient clipping and weight
decay (``optimizer/clip.py``, ``optimizer/regularizer.py``), the other
optimizers and recompute (``optimizer/recompute.py``); ring attention
over a sequence-parallel mesh (``parallel/``); and data-parallel
training through ``CompiledProgram(main).with_data_parallel(...)`` /
``with_mesh(mesh)`` and ``ParallelExecutor`` (``core/compiler.py``),
with the global batch's loss and gradients; convolutional nets
(``models/resnet.py``, ``models/mnist.py``), Transformer-base translation
(``models/transformer.py``) and the CTR models DeepFM, Wide&Deep and DIN
(``models/deepfm.py``, ``models/ctr_models.py``) through the same entry
points; guarded asynchronous training (``Executor.run_async``,
``FetchHandle``, the NaN/Inf guard, ``robustness.GuardedTrainer``), the
Fluid file formats and inference models (``io/``), and the input
pipeline (``reader/``, ``core/bucketing.py``, ``io/dataset.py`` under
``Executor.train_from_dataset``); the optimizer wrappers (EMA,
ModelAverage, Lookahead, gradient merge: ``optimizer/wrappers.py``), DGC
(``optimizer/dgc.py``) and decoupled weight decay (``contrib/``);
every op of the JAX registry but the collectives, with the layers over
them (``layers.tensor``, ``layers.loss``, the streaming ``layers.auc``
and ``layers.mean_iou``, ``layers.distributions``, the large-vocabulary
heads ``layers.nce`` / ``hsigmoid`` /
``sampled_softmax_with_cross_entropy``, the matching layers) and every
initializer; and quantization-aware training and post-training
quantization (``quant/``), pruning and distillation (``slim/``, but its
NAS search), also under ``contrib.quantize`` / ``contrib.slim``; and
sharded state under ``CompiledProgram``: tensor-parallel Programs
(``parallel.apply_shard_rules``), ZeRO-1 and FSDP (the transpiler's
``shard_optimizer_state`` / ``shard_params_fsdp``, ``DistributeTranspiler``)
and the sharded checkpoint (``io.save_checkpoint_sharded``); and Fluid's
collective training: ``python -m paddle_tpu_torch.distributed.launch``,
``fleet.init`` / ``fleet.distributed_optimizer`` (``parallel/fleet.py``,
``incubate.fleet``) and the collective ops, with tp, sp and dp in any mix
over one mesh, local or a ``torch.distributed`` world; and Fluid's
inference entry point (``inference/``): ``create_predictor`` over a
saved model with batch buckets, bf16, int8, tensor parallelism and
``generation_server``, the ``torch.export`` artifact
(``save_aot_model`` / ``load_aot_model``), the batching server and the
paged decode adapter, with ``Executor.explain``'s static cost report.
The top
level is the ``fluid`` namespace of that recipe::

    import paddle_tpu_torch as fluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        tokens, loss, logits = gpt.build_lm_net(cfg, seq_len=512)
        fluid.optimizer.AdamOptimizer(1e-4).minimize(loss)
    exe = fluid.Executor()            # the card; CPUPlace() for the CPU
    exe.run(startup)
    exe.run(main, feed={"tokens": ids}, fetch_list=[loss])
"""

from . import amp, initializer, layers, optimizer
from .optimizer import clip, regularizer
from .core import unique_name
from .core.backward import append_backward, gradients
from .core.bucketing import FeedBucketer
from .core.compiler import (BuildStrategy, CompiledProgram,
                            ExecutionStrategy, ParallelExecutor)
from .core.data_feeder import DataFeeder
from .core.executor import (Executor, FetchHandle, Scope, global_scope,
                            scope_from_numpy, scope_guard)
from .core.lod import (LoDTensor, create_lod_tensor,
                       create_random_int_lodtensor)
from .core.framework import (Program, Variable, Parameter, program_guard,
                             default_main_program, default_startup_program)
from .core.param_attr import ParamAttr
from .core.place import CPUPlace, CUDAPlace
from .device import resolve_device
from . import contrib, dataset, incubate, io, reader, robustness
# the inference entry point (paddle_tpu/__init__.py:68 imports it too)
from . import inference
from . import communicator
from .communicator import Communicator
from .layers.io import fluid_data as data
from .io.state import (save_params, save_persistables, save_vars,
                       load_params, load_persistables, load_vars)
from .io.inference_io import save_inference_model, load_inference_model
from .io.dataset import (DatasetFactory, InMemoryDataset, QueueDataset,
                         FileInstantDataset, BoxPSDataset, DataFeedDesc)
from . import parallel, transpiler
# fluid exposes the transpiler surface at the top level (the reference's
# fluid/__init__.py pulls in transpiler.__all__), as the JAX package does
from .transpiler import (DistributeTranspiler, DistributeTranspilerConfig,
                         memory_optimize, release_memory)

__all__ = ["Executor", "Scope", "global_scope", "scope_guard",
           "scope_from_numpy", "Program", "Variable", "Parameter",
           "program_guard", "default_main_program", "default_startup_program",
           "ParamAttr", "CPUPlace", "CUDAPlace", "data", "append_backward",
           "gradients", "layers", "optimizer", "initializer", "unique_name",
           "resolve_device", "amp", "clip", "regularizer",
           "CompiledProgram", "ParallelExecutor", "BuildStrategy",
           "ExecutionStrategy", "FetchHandle", "FeedBucketer", "DataFeeder",
           "LoDTensor", "create_lod_tensor", "create_random_int_lodtensor",
           "contrib", "dataset", "incubate", "io", "reader", "robustness",
           "inference",
           "save_params", "save_persistables",
           "save_vars", "load_params", "load_persistables", "load_vars",
           "save_inference_model", "load_inference_model",
           "DatasetFactory", "InMemoryDataset", "QueueDataset",
           "FileInstantDataset", "BoxPSDataset", "DataFeedDesc",
           "parallel", "transpiler", "DistributeTranspiler",
           "DistributeTranspilerConfig", "memory_optimize",
           "release_memory", "communicator", "Communicator"]
