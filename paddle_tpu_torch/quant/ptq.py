"""Post-training quantization: calibration and the static-scale rewrite.

Parity: the reference's post-training calibration flow; the counterpart
of ``paddle_tpu/quant/ptq.py``: run the float program over a calibration
set, record each quantizable op's activation input's abs-max, then
rewrite the inference program with fixed-scale quantize-dequantize ops
(``apply_ptq``), the JAX package's rewrite op for op.
"""

import numpy as np

from ..core.framework import Operator, Parameter
from .qat import QUANTIZABLE_OP_TYPES, _ACT_SLOTS, _CONV_OPS, _WEIGHT_SLOTS


def collect_activation_names(program,
                             quantizable_op_types=QUANTIZABLE_OP_TYPES):
    """The activation inputs of the quantizable ops, in op order, each
    once."""
    names = []
    for op in program.global_block().ops:
        if op.type in quantizable_op_types:
            for slot in _ACT_SLOTS.get(op.type, ()):
                names.extend(op.input(slot))
    return list(dict.fromkeys(names))


def calibrate_program(exe, program, feed_list,
                      quantizable_op_types=QUANTIZABLE_OP_TYPES):
    """Run the calibration batches; returns {var_name: abs_max_scale},
    each the largest |value| of the fetched (host) activations over the
    batches."""
    act_names = collect_activation_names(program, quantizable_op_types)
    scales = {n: 0.0 for n in act_names}
    for feed in feed_list:
        outs = exe.run(program, feed=feed, fetch_list=list(act_names))
        for name, val in zip(act_names, outs):
            scales[name] = max(scales[name], float(np.max(np.abs(val))))
    return scales


def apply_ptq(program, scales, weight_bits=8, activation_bits=8,
              quantizable_op_types=QUANTIZABLE_OP_TYPES,
              weight_granularity="tensor"):
    """Insert fixed-scale quantize-dequantize on the calibrated
    activations and abs-max quantization on the weights, in place;
    returns the program.

    `weight_granularity`: "tensor" keeps the reference's fallback
    (per-tensor abs_max on mul / matmul Y weights, channel-wise on conv
    filters only); "channel" quantizes mul / matmul weights per output
    column too (quant_axis 1 of the (in, out) Y)."""
    if weight_granularity not in ("tensor", "channel"):
        raise ValueError(
            f"weight_granularity {weight_granularity!r}: expected "
            f"'tensor' or 'channel'")
    block = program.global_block()
    quantized = {}
    new_ops = []
    for op in list(block.ops):
        if op.type in quantizable_op_types:
            for slot in _WEIGHT_SLOTS.get(op.type, ()):
                names = op.input(slot)
                if not names:
                    continue
                name = names[0]
                var = block._find_var_recursive(name)
                if not isinstance(var, Parameter):
                    continue
                if name not in quantized:
                    qname = f"{name}.quantized"
                    block.create_var(name=qname, shape=var.shape,
                                     dtype=var.dtype)
                    sname = f"{name}.quant_scale"
                    if op.type in _CONV_OPS:
                        qtype = "fake_channel_wise_quantize_dequantize_abs_max"
                        out_c, qaxis = var.shape[0], 0
                    elif weight_granularity == "channel":
                        qtype = "fake_channel_wise_quantize_dequantize_abs_max"
                        out_c, qaxis = var.shape[-1], len(var.shape) - 1
                    else:
                        qtype = "fake_quantize_dequantize_abs_max"
                        out_c, qaxis = 1, 0
                    block.create_var(name=sname, shape=[out_c],
                                     dtype="float32")
                    new_ops.append(Operator(
                        block, qtype,
                        {"X": [name]}, {"Out": [qname], "OutScale": [sname]},
                        {"bit_length": weight_bits, "quant_axis": qaxis}))
                    quantized[name] = qname
                op.inputs[slot] = [quantized[name]]
            for slot in _ACT_SLOTS.get(op.type, ()):
                names = op.input(slot)
                if not names or names[0] not in scales:
                    continue
                name = names[0]
                if name not in quantized:
                    var = block._find_var_recursive(name)
                    qname = f"{name}.quantized"
                    block.create_var(name=qname,
                                     shape=getattr(var, "shape", ()),
                                     dtype=getattr(var, "dtype", "float32"))
                    new_ops.append(Operator(
                        block, "quantize_dequantize_static_scale",
                        {"X": [name]}, {"Out": [qname]},
                        {"bit_length": activation_bits,
                         "scale": float(scales[name])}))
                    quantized[name] = qname
                op.inputs[slot] = [quantized[name]]
        new_ops.append(op)
    block.ops = new_ops
    program._bump_version()
    return program
