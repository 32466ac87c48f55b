"""bf16 compute policy.

A copy of ``paddle_tpu/amp/policy.py``: the global compute-dtype switch
(``get_compute_dtype`` / ``set_compute_dtype`` / ``bf16_guard``) and
``cast_model_to_bf16``, which tags a program's white-listed ops with
``__amp_dtype__``. The op context (``ops/__init__.py``) casts a tagged
op's f32/f64 inputs to bf16 as it reads them; on the card the product is
then one cuBLAS bf16 GEMM (f32 accumulation inside its tiles; whether
split-K partials are summed in bf16 follows torch's
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``,
which chip_smoke.py turns off to reduce in f32 as XLA does).
"""

import contextlib

_compute_dtype = "float32"


def get_compute_dtype():
    return _compute_dtype


def set_compute_dtype(dtype):
    global _compute_dtype
    _compute_dtype = dtype


@contextlib.contextmanager
def bf16_guard():
    """Sets the compute dtype to bf16 inside the block. Nothing reads it,
    here or in the JAX package: the name is kept for API parity, and
    ``cast_model_to_bf16``'s white-list tags decide the precision."""
    old = _compute_dtype
    set_compute_dtype("bfloat16")
    try:
        yield
    finally:
        set_compute_dtype(old)


def cast_model_to_bf16(program, amp_lists=None):
    """Flip matmul-path op inputs to bf16 by tagging ops; the op context
    applies the cast when the op runs (white-list ops only)."""
    from .decorator import AutoMixedPrecisionLists
    lists = amp_lists or AutoMixedPrecisionLists()
    for block in program.blocks:
        for op in block.ops:
            if op.type in lists.white_list:
                op.attrs["__amp_dtype__"] = "bfloat16"
    return program
