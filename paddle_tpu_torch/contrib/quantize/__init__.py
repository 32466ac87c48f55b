"""Parity: python/paddle/fluid/contrib/quantize/: the older
program-level QAT transpiler, from quant/passes.py."""

from ...quant.passes import QuantizeTranspiler  # noqa: F401

__all__ = ["QuantizeTranspiler"]
