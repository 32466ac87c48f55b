"""Automatic mixed precision.

Parity: python/paddle/fluid/contrib/mixed_precision/ (decorate, fp16
lists, dynamic loss scaling); the counterpart of ``paddle_tpu/amp/``.
The native mode is bf16: ``cast_model_to_bf16`` tags the white-listed
ops (matmul, mul, conv), whose inputs the op context casts to bf16, while
parameters, gradients and optimizer state stay f32. The loss-scaling
optimizer of ``decorate`` runs on the device with no host sync.
"""

from .decorator import decorate, CustomOpLists, AutoMixedPrecisionLists
from .policy import cast_model_to_bf16, bf16_guard, get_compute_dtype
