"""Optimizers package.

Parity: python/paddle/fluid/optimizer.py; the counterpart of
``paddle_tpu/optimizer/`` with SGD and Adam. Regularization and gradient
clipping are not ported yet.
"""

from .optimizers import (Optimizer, SGDOptimizer, AdamOptimizer, SGD,
                         Adam)
