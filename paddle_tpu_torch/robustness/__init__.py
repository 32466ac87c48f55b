"""Robustness of the port: deterministic fault injection and the
non-finite fail-stop's error.

Counterpart of ``paddle_tpu/robustness`` (its serving half): the
``ChaosInjector`` a ``GenerationServer`` consumes through ``chaos=``, and
``NonFiniteError``, which the engine raises when a fused step's logits
go non-finite on a live lane.
"""

from .chaos import ChaosInjector
from .guard import NonFiniteError

__all__ = ["ChaosInjector", "NonFiniteError"]
