"""Parity: python/paddle/fluid/contrib/slim/: the slim surface of
paddle_tpu_torch.slim under the reference's import path."""

from ...slim import *  # noqa: F401,F403
from ...slim import Compressor  # noqa: F401

__all__ = ["Compressor"]
