"""Quantization (QAT and PTQ).

Parity: the reference's contrib/slim quantization passes
(QuantizationTransformPass, QuantizationFreezePass, post-training
calibration); the counterpart of ``paddle_tpu/quant/``, every name of
it. The transforms rewrite the port's Program IR (pure Python over the
op list) into the fake-quant ops of ``ops/quant_ops.py``.
"""

from .qat import quantize_program, QuantizationTransform  # noqa: F401
from .ptq import calibrate_program, apply_ptq  # noqa: F401
from .passes import (  # noqa: F401
    QuantizationTransformPass, QuantizationFreezePass, ConvertToInt8Pass,
    TransformForMobilePass, ScaleForTrainingPass, ScaleForInferencePass,
    AddQuantDequantPass, QuantizationStrategy, QuantizeTranspiler)
