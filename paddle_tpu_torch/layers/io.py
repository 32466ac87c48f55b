"""Data input layers.

Parity: python/paddle/fluid/layers/io.py; the counterpart of
``paddle_tpu/layers/io.py``'s ``data``: a plain feed slot of the program.
"""

from ..core.framework import default_main_program


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         stop_gradient=True):
    """Declare a feed variable. append_batch_size prepends -1 (fluid 1.x)."""
    shape = list(shape)
    if append_batch_size:
        if len(shape) == 0 or shape[0] != -1:
            shape = [-1] + shape
    block = default_main_program().global_block()
    return block.create_var(name=name, shape=shape, dtype=dtype,
                            lod_level=lod_level, stop_gradient=stop_gradient,
                            is_data=True)
