"""Quantization-aware training as a Program transform.

Parity: fluid contrib QuantizationTransformPass
(python/paddle/fluid/contrib/slim/quantization/quantization_pass.py); the
counterpart of ``paddle_tpu/quant/qat.py``: fake quantize-dequantize ops
go in front of the weight and activation inputs of the quantizable ops,
so training sees the int8 rounding error while the gradients pass the
rounding straight through (``ops/quant_ops.py``). The rewrite is the JAX
package's, op for op, over the port's Program IR.
"""

import torch

from ..core.framework import Operator, Parameter

QUANTIZABLE_OP_TYPES = ("conv2d", "depthwise_conv2d", "mul", "matmul")
_CONV_OPS = ("conv2d", "depthwise_conv2d")

# which input slots carry weights and which activations, per op type
_WEIGHT_SLOTS = {"conv2d": ("Filter",), "depthwise_conv2d": ("Filter",),
                 "mul": ("Y",), "matmul": ("Y",)}
_ACT_SLOTS = {"conv2d": ("Input",), "depthwise_conv2d": ("Input",),
              "mul": ("X",), "matmul": ("X",)}


def _scope_device(scope, program):
    """The device of the program's persistables already in `scope` (the
    first found), or None where the scope holds none of them."""
    for v in program.list_vars():
        t = scope.get(v.name) if v.persistable else None
        if isinstance(t, torch.Tensor):
            return t.device
    return None


class QuantizationTransform:
    def __init__(self, weight_bits=8, activation_bits=8,
                 activation_quantize_type="moving_average_abs_max",
                 weight_quantize_type="channel_wise_abs_max",
                 moving_rate=0.9,
                 quantizable_op_types=QUANTIZABLE_OP_TYPES,
                 skip_pattern=("skip_quant",)):
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.activation_quantize_type = activation_quantize_type
        self.weight_quantize_type = weight_quantize_type
        self.moving_rate = moving_rate
        self.quantizable_op_types = tuple(quantizable_op_types)
        self.skip_pattern = tuple(skip_pattern)

    def apply(self, program, startup_program=None, scope=None):
        """Rewrite `program` in place and return it. Call after building
        the forward and before ``minimize`` / ``append_backward``.

        With `scope`, the new moving-average scales are set to 1.0 in it
        at once, on the device of the program's persistables there:
        running the startup again would re-draw every weight. A scope
        that holds none of them is left alone (the startup sets the
        scales)."""
        self._startup_block = (startup_program.global_block()
                               if startup_program is not None else None)
        self._scope = scope
        self._device = _scope_device(scope, program) \
            if scope is not None else None
        block = program.global_block()
        quantized = {}   # original var name -> quantized var name
        new_ops = []
        for op in list(block.ops):
            if op.type in self.quantizable_op_types and \
                    not self._skipped(op):
                for slot in _WEIGHT_SLOTS.get(op.type, ()):
                    self._quant_input(block, op, slot, new_ops, quantized,
                                      is_weight=True)
                for slot in _ACT_SLOTS.get(op.type, ()):
                    self._quant_input(block, op, slot, new_ops, quantized,
                                      is_weight=False)
            new_ops.append(op)
        block.ops = new_ops
        program._bump_version()
        return program

    __call__ = apply

    def _skipped(self, op):
        return any(op.attrs.get(p) for p in self.skip_pattern)

    def _quant_input(self, block, op, slot, new_ops, quantized, is_weight):
        names = op.input(slot)
        if not names:
            return
        name = names[0]
        var = block._find_var_recursive(name)
        if var is None:
            return
        if is_weight and not isinstance(var, Parameter):
            return
        if name in quantized:
            op.inputs[slot] = [quantized[name]]
            return
        qname = f"{name}.quantized"
        block.create_var(name=qname, shape=var.shape, dtype=var.dtype)
        scale_name = f"{name}.quant_scale"
        if is_weight:
            # channel-wise only on conv filters (dim 0 the output
            # channels); mul / matmul Y weights (in, out) take the
            # reference pass's per-tensor abs_max
            if self.weight_quantize_type == "channel_wise_abs_max" and \
                    op.type in _CONV_OPS:
                op_type = "fake_channel_wise_quantize_dequantize_abs_max"
                out_c = var.shape[0] if len(var.shape) else 1
            else:
                op_type = "fake_quantize_dequantize_abs_max"
                out_c = 1
            block.create_var(name=scale_name, shape=[out_c],
                             dtype="float32")
            qop = Operator(block, op_type, {"X": [name]},
                           {"Out": [qname], "OutScale": [scale_name]},
                           {"bit_length": self.weight_bits,
                            "quant_axis": 0})
        else:
            from .. import initializer as init_mod
            scale = block.create_parameter(
                name=scale_name, shape=[1], dtype="float32",
                trainable=False)
            # the moving-average scale starts at 1.0
            init_mod.ConstantInitializer(1.0)(scale, self._startup_block)
            if self._device is not None and \
                    self._scope.get(scale_name) is None:
                self._scope.set(scale_name, torch.ones(
                    [1], dtype=torch.float32, device=self._device))
            qop = Operator(
                block, "fake_quantize_dequantize_moving_average_abs_max",
                {"X": [name], "InScale": [scale_name]},
                {"Out": [qname], "OutScale": [scale_name]},
                {"bit_length": self.activation_bits,
                 "moving_rate": self.moving_rate})
        new_ops.append(qop)
        quantized[name] = qname
        op.inputs[slot] = [qname]


def quantize_program(program, startup_program=None, **kwargs):
    """One-shot helper: quantize_program(main) before minimize()."""
    return QuantizationTransform(**kwargs).apply(program, startup_program)
