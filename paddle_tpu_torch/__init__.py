"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The JAX package (``paddle_tpu``) stays the reference; this package mirrors
its layout module for module, imports ``torch`` and never ``jax`` or
``paddle_tpu``, and runs its kernels as hand-written CUDA for Hopper
(``csrc/``), built at first use. Entry points run on the card unless the
caller passes ``device="cpu"``.

Ported so far: continuous-batching GPT serving (``serving/``,
``models/gpt.py``), dense or int8 KV pools, MHA or grouped-query heads,
optionally int8 weights, with the paged-attention kernel
(``ops/cuda/paged.py``; dense and int8 variants).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
