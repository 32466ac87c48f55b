"""Optimizers package.

Parity: python/paddle/fluid/optimizer.py + regularizer.py + clip.py; the
counterpart of ``paddle_tpu/optimizer/`` with the static-graph
optimizers, the gradient clips, the weight-decay regularizers,
RecomputeOptimizer, ``DGCMomentumOptimizer`` and the wrappers
(ExponentialMovingAverage, ModelAverage, LookaheadOptimizer,
GradientMergeOptimizer) and ``PipelineOptimizer``, which lives with the
pipeline machinery (``parallel/pipeline.py``).
"""

from .optimizers import (Optimizer, SGDOptimizer, MomentumOptimizer,
                         LarsMomentumOptimizer, AdagradOptimizer,
                         DecayedAdagradOptimizer, AdadeltaOptimizer,
                         AdamOptimizer, AdamaxOptimizer, RMSPropOptimizer,
                         FtrlOptimizer, LambOptimizer,
                         SGD, Momentum, Adagrad, Adam, Adamax, RMSProp,
                         Ftrl, Lamb)
from .dgc import DGCMomentumOptimizer

# short aliases the reference's optimizer.py __all__ also exports
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
LarsMomentum = LarsMomentumOptimizer
from .wrappers import (ExponentialMovingAverage, ModelAverage,  # noqa: E402
                       LookaheadOptimizer, GradientMergeOptimizer)
from .recompute import RecomputeOptimizer  # noqa: E402
from .regularizer import (L1Decay, L2Decay, L1DecayRegularizer,  # noqa: E402
                          L2DecayRegularizer, WeightDecayRegularizer)
from . import clip  # noqa: E402
from .clip import (GradientClipByValue, GradientClipByNorm,  # noqa: E402
                   GradientClipByGlobalNorm, ErrorClipByValue,
                   set_gradient_clip)

# PipelineOptimizer lives with the pipeline machinery but is an optimizer
# in the reference's namespace (ref optimizer.py:2683)
from ..parallel.pipeline import PipelineOptimizer  # noqa: E402,F401
