"""Slim: pruning, distillation and the quantization strategies.

Parity: the reference's contrib/slim; the counterpart of
``paddle_tpu/slim/``: the functional core (prune.py, distill.py) and the
class surface (core.py's Compressor / Strategy / ConfigFactory, graph.py's
GraphWrapper, the strategies, the quantization passes of ``quant/``).
Not ported yet (ROADMAP item 11): the light-NAS search (``nas.py``:
SearchSpace, EvolutionaryController, SAController, ControllerServer,
SearchAgent, LightNASStrategy), and with it AutoPruneStrategy, which
raises.
"""

from .prune import (Pruner, sensitivity_prune_ratios,  # noqa: F401
                    StructurePruner, PruneStrategy,
                    UniformPruneStrategy, SensitivePruneStrategy,
                    AutoPruneStrategy)
from .distill import (soft_label_loss, l2_hint_loss, fsp_loss,  # noqa: F401
                      merge_programs, L2Distiller, SoftLabelDistiller,
                      FSPDistiller, DistillationStrategy)
from .core import (Context, Strategy, Compressor,  # noqa: F401
                   ConfigFactory)
from .graph import (GraphWrapper, VarWrapper, OpWrapper,  # noqa: F401
                    SlimGraphExecutor)
from ..quant.passes import (  # noqa: F401
    QuantizationTransformPass, QuantizationFreezePass, ConvertToInt8Pass,
    TransformForMobilePass, ScaleForTrainingPass, ScaleForInferencePass,
    AddQuantDequantPass, QuantizationStrategy,
    MKLDNNPostTrainingQuantStrategy, TransformForMkldnnPass)
