"""The reference's quantization passes over the QAT / PTQ machinery.

Parity: python/paddle/fluid/contrib/slim/quantization/quantization_pass.py
(QuantizationTransformPass, QuantizationFreezePass, ConvertToInt8Pass,
TransformForMobilePass, ScaleForTrainingPass, ScaleForInferencePass,
AddQuantDequantPass), quantization_strategy.py (QuantizationStrategy) and
contrib/quantize/quantize_transpiler.py:29 (QuantizeTranspiler); the
counterpart of ``paddle_tpu/quant/passes.py``, every name of its
``__all__``. Each delegates to the Program transforms of qat.py /
ptq.py. The scope holds torch tensors: a learned scale is read to the
host as the JAX package reads its arrays, and ``ConvertToInt8Pass``
stores int8 tensors beside each weight, on its device. The paddle-mobile
and MKLDNN passes are not ported (engine-specific) and raise.
"""

import numpy as np
import torch

from .qat import QuantizationTransform
from . import ptq as _ptq

__all__ = ["QuantizationTransformPass", "QuantizationFreezePass",
           "ConvertToInt8Pass", "TransformForMobilePass",
           "ScaleForTrainingPass", "ScaleForInferencePass",
           "AddQuantDequantPass", "QuantizationStrategy",
           "QuantizeTranspiler", "MKLDNNPostTrainingQuantStrategy",
           "TransformForMkldnnPass"]


def _program_of(graph):
    """A Program, or a slim GraphWrapper's."""
    return getattr(graph, "program", graph)


def _abs_max(value):
    """max |value| of a scope entry (a tensor or an array), on the
    host."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return float(np.max(np.abs(value)))


class QuantizationTransformPass:
    """Insert trainable fake quantize-dequantize (QAT). The reference's
    constructor takes (scope, place, bits, quantize types...); the scope
    takes the new scales (qat.QuantizationTransform.apply)."""

    def __init__(self, scope=None, place=None, weight_bits=8,
                 activation_bits=8, window_size=10000, moving_rate=0.9,
                 skip_pattern="skip_quant",
                 activation_quantize_type="moving_average_abs_max",
                 weight_quantize_type="abs_max", quantizable_op_type=None):
        kwargs = dict(weight_bits=weight_bits,
                      activation_bits=activation_bits,
                      activation_quantize_type=activation_quantize_type,
                      weight_quantize_type=weight_quantize_type,
                      moving_rate=moving_rate,
                      skip_pattern=(skip_pattern,)
                      if isinstance(skip_pattern, str) else skip_pattern)
        if quantizable_op_type:
            kwargs["quantizable_op_types"] = tuple(quantizable_op_type)
        self._transform = QuantizationTransform(**kwargs)
        self._scope = scope

    def apply(self, graph, startup_program=None):
        from ..core.executor import global_scope
        self._transform.apply(_program_of(graph), startup_program,
                              scope=self._scope or global_scope())
        return graph


class AddQuantDequantPass(QuantizationTransformPass):
    """Quantize-dequantize on further op inputs (elementwise_add, pool2d)
    for full-int8 deployment: the same transform over a wider op set."""

    def __init__(self, scope=None, place=None, moving_rate=0.9,
                 quant_bits=8, skip_pattern="skip_quant",
                 quantizable_op_type=("elementwise_add", "pool2d")):
        super().__init__(scope=scope, place=place,
                         activation_bits=quant_bits,
                         moving_rate=moving_rate, skip_pattern=skip_pattern,
                         quantizable_op_type=quantizable_op_type)


class QuantizationFreezePass:
    """Freeze a QAT-trained program for inference: drop the fake
    quantize-dequantize ops, collect the learned scales (the activations'
    moving averages from the scope, the weights' recomputed from the
    weights), and re-install static-scale quantize-dequantize through the
    PTQ rewrite. The frozen program still computes in float (the int8
    rounding baked into the values)."""

    def __init__(self, scope, place=None, weight_bits=8, activation_bits=8,
                 weight_quantize_type="abs_max"):
        self._scope = scope
        self._weight_bits = weight_bits
        self._activation_bits = activation_bits
        self._weight_quantize_type = weight_quantize_type

    def apply(self, graph):
        program = _program_of(graph)
        block = program.global_block()
        scales = {}
        kept = []
        for op in block.ops:
            if op.type.startswith("fake_quantize_dequantize"):
                src = op.input("X")[0]
                learned = self._scope.get(op.output("OutScale")[0])
                if learned is not None:
                    scales[src] = _abs_max(learned)
                else:
                    w = self._scope.get(src)
                    if w is not None:
                        scales[src] = _abs_max(w)
                continue
            # the consumers read X.quantized; point them back at X
            for slot, names in op.inputs.items():
                op.inputs[slot] = [n[:-len(".quantized")]
                                   if n.endswith(".quantized") else n
                                   for n in names]
            kept.append(op)
        block.ops = kept
        program._bump_version()
        _ptq.apply_ptq(program, scales,
                       weight_bits=self._weight_bits,
                       activation_bits=self._activation_bits)
        return graph


class ConvertToInt8Pass:
    """Store the quantized weights as int8 in the scope: `{name}.int8`
    = clip(round(w / max|w| x 127), -128, 127) (half to even) and
    `{name}.int8_scale` = [max|w|] (1.0 for an all-zero weight), computed
    on the weight's device. The program still computes through the
    dequantized path."""

    def __init__(self, scope, place=None, quantizable_op_type=None):
        self._scope = scope

    def apply(self, graph):
        program = _program_of(graph)
        from ..core.framework import Parameter
        block = program.global_block()
        for op in block.ops:
            if "quantize_dequantize" not in op.type or not op.input("X"):
                continue
            name = op.input("X")[0]
            if not isinstance(block.vars.get(name), Parameter):
                continue
            w = self._scope.get(name)
            if w is None:
                continue
            if not isinstance(w, torch.Tensor):
                w = torch.from_numpy(np.asarray(w))
            w = w.detach().float()
            scale = torch.amax(torch.abs(w))
            scale = torch.where(scale > 0, scale, torch.ones_like(scale))
            q = torch.clamp(torch.round(w / scale * 127.0), -128, 127)
            self._scope.set(name + ".int8", q.to(torch.int8))
            self._scope.set(name + ".int8_scale", scale.reshape(1))
        return graph


class ScaleForTrainingPass:
    """Moving-average scale tracking on the activations during training
    (the reference records each op's output scale for inference): the
    same insertion as QuantizationTransformPass."""

    def __init__(self, scope=None, place=None, moving_rate=0.9):
        self._pass = QuantizationTransformPass(
            scope=scope, place=place, moving_rate=moving_rate)

    def apply(self, graph, startup_program=None):
        return self._pass.apply(graph, startup_program)


class ScaleForInferencePass:
    """Copy the learned scales into the ops' `out_threshold` attrs for
    inference."""

    def __init__(self, scope=None):
        self._scope = scope

    def apply(self, graph):
        program = _program_of(graph)
        for op in program.global_block().ops:
            for name in op.output_names:
                s = self._scope.get(f"{name}.quant_scale") \
                    if self._scope else None
                if s is not None:
                    op._set_attr("out_threshold", _abs_max(s))
        return graph


class TransformForMobilePass:
    """Not ported: it renames the quantization ops into paddle-mobile's
    `quantize` / `dequantize` for that engine's loader, and there is no
    paddle-mobile engine here."""

    def __init__(self, *a, **k):
        raise NotImplementedError(
            "TransformForMobilePass targets the paddle-mobile engine; "
            "freeze the program (QuantizationFreezePass, ConvertToInt8Pass) "
            "and save it with save_inference_model instead. See "
            "MIGRATION.md.")


class MKLDNNPostTrainingQuantStrategy:
    """Not ported: MKLDNN (the x86 CPU engine) INT8 calibration. PTQ
    here is engine-neutral: quant.calibrate_program + apply_ptq."""

    def __init__(self, *a, **k):
        raise NotImplementedError(
            "MKLDNNPostTrainingQuantStrategy is x86-MKLDNN specific; "
            "use paddle_tpu_torch.quant.calibrate_program + apply_ptq for "
            "engine-neutral PTQ. See MIGRATION.md.")


class TransformForMkldnnPass:
    """Not ported (as MKLDNNPostTrainingQuantStrategy)."""

    def __init__(self, *a, **k):
        raise NotImplementedError(
            "TransformForMkldnnPass is x86-MKLDNN specific; the port's "
            "programs run on torch's CUDA and CPU devices. See "
            "MIGRATION.md.")


class QuantizationStrategy:
    """Parity: slim/quantization/quantization_strategy.py: QAT between
    start_epoch and end_epoch inside a Compressor pipeline: the
    transform at the start, the freeze (and int8 weights where a save
    path is set) at the end."""

    def __init__(self, start_epoch=0, end_epoch=0, weight_bits=8,
                 activation_bits=8,
                 activation_quantize_type="moving_average_abs_max",
                 weight_quantize_type="abs_max", save_in_nodes=None,
                 save_out_nodes=None, int8_model_save_path=None,
                 float_model_save_path=None, mobile_model_save_path=None):
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.activation_quantize_type = activation_quantize_type
        self.weight_quantize_type = weight_quantize_type
        self.int8_model_save_path = int8_model_save_path

    def on_compression_begin(self, context):
        pass

    def on_epoch_begin(self, context):
        if context.epoch_id == self.start_epoch:
            QuantizationTransformPass(
                scope=context.scope,
                weight_bits=self.weight_bits,
                activation_bits=self.activation_bits,
                activation_quantize_type=self.activation_quantize_type,
                weight_quantize_type=self.weight_quantize_type,
            ).apply(context.train_graph)

    def on_epoch_end(self, context):
        if context.epoch_id == max(self.end_epoch, self.start_epoch):
            QuantizationFreezePass(
                context.scope, weight_bits=self.weight_bits,
                activation_bits=self.activation_bits,
                weight_quantize_type=self.weight_quantize_type,
            ).apply(context.train_graph)
            if self.int8_model_save_path:
                ConvertToInt8Pass(context.scope).apply(context.train_graph)

    def on_batch_begin(self, context):
        pass

    def on_batch_end(self, context):
        pass

    def on_compression_end(self, context):
        pass


class QuantizeTranspiler:
    """Parity: contrib/quantize/quantize_transpiler.py:29, the older
    program-level QAT API: training_transpile / freeze_program /
    convert_to_int8 over the same machinery."""

    def __init__(self, weight_bits=8, activation_bits=8,
                 activation_quantize_type="abs_max",
                 weight_quantize_type="abs_max", window_size=10000,
                 moving_rate=0.9):
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        # the older transpiler's plain abs_max activations are served by
        # the moving average, as in the JAX package
        self.activation_quantize_type = (
            "moving_average_abs_max"
            if activation_quantize_type == "abs_max"
            else activation_quantize_type)
        self.weight_quantize_type = weight_quantize_type
        self.moving_rate = moving_rate

    def training_transpile(self, program=None, startup_program=None,
                           scope=None):
        from ..core.framework import default_main_program
        from ..core.executor import global_scope
        program = program or default_main_program()
        QuantizationTransform(
            weight_bits=self.weight_bits,
            activation_bits=self.activation_bits,
            activation_quantize_type=self.activation_quantize_type,
            weight_quantize_type=self.weight_quantize_type,
            moving_rate=self.moving_rate).apply(
                program, startup_program, scope=scope or global_scope())
        return program

    def freeze_program(self, program, place=None, scope=None):
        from ..core.executor import global_scope
        QuantizationFreezePass(
            scope or global_scope(), place,
            weight_bits=self.weight_bits,
            activation_bits=self.activation_bits,
            weight_quantize_type=self.weight_quantize_type).apply(program)
        return program

    def convert_to_int8(self, program, place=None, scope=None):
        from ..core.executor import global_scope
        ConvertToInt8Pass(scope or global_scope(), place).apply(program)
        return program
