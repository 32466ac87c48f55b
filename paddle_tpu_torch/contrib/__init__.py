"""contrib: API-compatible extras (parity: python/paddle/fluid/contrib).

The counterpart of ``paddle_tpu/contrib/``, so far its
``extend_optimizer`` (decoupled weight decay), the static half of
``layers`` (``basic_gru``, ``basic_lstm``), ``decoder`` (``InitState``,
``StateCell``, ``TrainingDecoder``, ``BeamSearchDecoder``), ``quantize``
(``QuantizeTranspiler``) and ``slim`` (``paddle_tpu_torch.slim`` under
the reference's path). The rest of the JAX package's ``contrib/`` (the
other layers, reader, the memory calculator, mixed precision's shim, op
frequencies, the inferencer and trainer) is not ported yet.
"""

from . import decoder  # noqa: F401
from . import extend_optimizer  # noqa: F401
from .extend_optimizer import extend_with_decoupled_weight_decay  # noqa: F401
from . import layers  # noqa: F401
from .layers import basic_gru, basic_lstm  # noqa: F401
from . import quantize  # noqa: F401
from . import slim  # noqa: F401

__all__ = ["decoder", "extend_optimizer", "extend_with_decoupled_weight_decay",
           "layers", "basic_gru", "basic_lstm", "quantize", "slim"]
