"""contrib.layers: the static basic RNN builders.

Parity: python/paddle/fluid/contrib/layers/__init__.py; the counterpart of
``paddle_tpu/contrib/layers/``'s ``rnn_impl`` static half (``basic_gru``,
``basic_lstm``). Its ``nn`` (fused elementwise activation, ...) and
``metric_op`` (the CTR metric bundle) are not ported.
"""

from . import rnn_impl  # noqa: F401
from .rnn_impl import basic_gru, basic_lstm  # noqa: F401

__all__ = list(rnn_impl.__all__)
