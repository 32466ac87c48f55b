"""AMP optimizer decorator with dynamic loss scaling.

Parity: python/paddle/fluid/contrib/mixed_precision/decorator.py
(decorate, OptimizerWithMixedPrecision) and fp16_lists.py; the
counterpart of ``paddle_tpu/amp/decorator.py``, appending the same op
sequence with one deliberate difference (ROADMAP C8): on a step whose
gradients hold an inf or a NaN, the JAX package multiplies every
gradient by the finite flag (0), which turns an inf or NaN gradient into
NaN and the update into NaN parameters; the port selects zeros instead
(``select_finite``), so the parameters stay finite while the scale
decays and the good-step count resets as in JAX. On a finite step the
two are the same (g * 1 = g). Every op runs on the device: no op of the
pipeline reads a value back to the host.
"""

from ..core.layer_helper import LayerHelper
from .. import initializer as init_mod
from ..core import unique_name


class AutoMixedPrecisionLists:
    """Parity: fp16_lists.AutoMixedPrecisionLists — ops safe in low precision
    (white), ops kept fp32 (black)."""

    def __init__(self, custom_white_list=None, custom_black_list=None):
        self.white_list = {"matmul", "mul", "conv2d", "conv3d",
                           "depthwise_conv2d", "conv2d_transpose"}
        self.black_list = {"softmax_with_cross_entropy", "cross_entropy",
                           "mean", "reduce_mean", "layer_norm", "batch_norm",
                           "exp", "log", "softmax"}
        if custom_white_list:
            self.white_list |= set(custom_white_list)
        if custom_black_list:
            self.black_list |= set(custom_black_list)
            self.white_list -= set(custom_black_list)


CustomOpLists = AutoMixedPrecisionLists


class OptimizerWithMixedPrecision:
    """Wraps an optimizer: casts the white-listed ops to bf16, scales the
    loss, unscales the gradients, zeroes them on inf/nan, and adapts the
    loss scale, all as ops of the program (branch-free selects on the
    device), matching the reference's update_loss_scaling pipeline."""

    def __init__(self, optimizer, amp_lists, init_loss_scaling,
                 use_dynamic_loss_scaling, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, incr_ratio=2.0, decr_ratio=0.8):
        self._optimizer = optimizer
        self._amp_lists = amp_lists
        self._init_loss_scaling = init_loss_scaling
        self._use_dynamic = use_dynamic_loss_scaling
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._loss_scaling = None
        self._good_steps = None

    def get_loss_scaling(self):
        return self._loss_scaling

    def rollback_hook(self, factor=None):
        """Recovery hook for a rollback (robustness.RecoveryPolicy's
        on_rollback in the JAX package): multiply the live loss-scaling
        scope var by `factor` (default: this optimizer's decr_ratio). A
        rollback restores the pre-fault scale from the checkpoint;
        without this hook the retry replays at exactly the scale that
        just overflowed."""
        factor = self._decr_ratio if factor is None else float(factor)

        def hook(scope, fault):
            if self._loss_scaling is None:
                return
            val = scope.get(self._loss_scaling.name)
            if val is not None:
                scope.set(self._loss_scaling.name, val * factor)
        return hook

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from .policy import cast_model_to_bf16
        helper = LayerHelper("amp")
        program = loss.block.program
        cast_model_to_bf16(program, self._amp_lists)
        block = program.global_block()
        scale_var = helper.create_global_variable(
            persistable=True, name=unique_name.generate("loss_scaling"),
            shape=(), dtype="float32")
        scale_var.stop_gradient = True
        init_mod.ConstantInitializer(self._init_loss_scaling)(scale_var)
        self._loss_scaling = scale_var
        scaled_loss = helper.create_variable_for_type_inference(
            loss.dtype, loss.shape)
        block.append_op("elementwise_mul", {"X": loss, "Y": scale_var},
                        {"Out": scaled_loss}, {"axis": -1})
        params_grads = self._optimizer.backward(
            scaled_loss, startup_program, parameter_list, no_grad_set)
        # unscale grads + detect inf/nan
        finite_flags = []
        for p, g in params_grads:
            block.append_op("elementwise_div", {"X": g, "Y": scale_var},
                            {"Out": g}, {"axis": -1})
            fin = helper.create_variable_for_type_inference("bool", ())
            block.append_op("isfinite", {"X": g}, {"Out": fin})
            finf = helper.create_variable_for_type_inference("float32", ())
            block.append_op("cast", {"X": fin}, {"Out": finf},
                            {"out_dtype": "float32"})
            finite_flags.append(finf)
        all_fin = helper.create_variable_for_type_inference("float32", ())
        block.append_op("sum", {"X": finite_flags}, {"Out": all_fin})
        is_finite = helper.create_variable_for_type_inference("float32", ())
        # is_finite = 1.0 iff every flag is 1
        block.append_op("scale", {"X": all_fin}, {"Out": is_finite},
                        {"scale": 1.0 / max(len(finite_flags), 1)})
        floor_fin = helper.create_variable_for_type_inference("float32", ())
        block.append_op("floor", {"X": is_finite}, {"Out": floor_fin})
        # zero grads when any inf/nan (skip update), else keep: a select,
        # where the JAX package multiplies by floor_fin (C8)
        for p, g in params_grads:
            block.append_op("select_finite", {"X": g, "Finite": floor_fin},
                            {"Out": g})
        if self._use_dynamic:
            self._append_loss_scaling_update(helper, block, scale_var,
                                             floor_fin)
        optimize_ops = self._optimizer.apply_optimize(
            scaled_loss, startup_program, params_grads)
        return optimize_ops, params_grads

    def _append_loss_scaling_update(self, helper, block, scale_var, finite):
        good = helper.create_global_variable(
            persistable=True, name=unique_name.generate("good_steps"),
            shape=(), dtype="float32")
        good.stop_gradient = True
        init_mod.ConstantInitializer(0.0)(good)
        self._good_steps = good
        # good' = (good + 1) * finite   (reset on overflow)
        g1 = helper.create_variable_for_type_inference("float32", ())
        block.append_op("scale", {"X": good}, {"Out": g1},
                        {"scale": 1.0, "bias": 1.0})
        block.append_op("elementwise_mul", {"X": g1, "Y": finite},
                        {"Out": good}, {"axis": -1})
        # hit = 1 when good >= incr_every_n_steps
        thresh = helper.create_variable_for_type_inference("float32", ())
        block.append_op("fill_constant", {}, {"Out": thresh},
                        {"shape": [], "dtype": "float32",
                         "value": float(self._incr_every_n_steps)})
        hit_b = helper.create_variable_for_type_inference("bool", ())
        block.append_op("greater_equal", {"X": good, "Y": thresh},
                        {"Out": hit_b})
        hit = helper.create_variable_for_type_inference("float32", ())
        block.append_op("cast", {"X": hit_b}, {"Out": hit},
                        {"out_dtype": "float32"})
        # scale' = scale * incr^hit * (finite ? 1 : decr)
        incr = helper.create_variable_for_type_inference("float32", ())
        block.append_op("fill_constant", {}, {"Out": incr},
                        {"shape": [], "dtype": "float32",
                         "value": self._incr_ratio})
        incr_f = helper.create_variable_for_type_inference("float32", ())
        block.append_op("elementwise_pow", {"X": incr, "Y": hit},
                        {"Out": incr_f}, {"axis": -1})
        block.append_op("elementwise_mul", {"X": scale_var, "Y": incr_f},
                        {"Out": scale_var}, {"axis": -1})
        # overflow decay: scale *= decr when !finite
        inv = helper.create_variable_for_type_inference("float32", ())
        block.append_op("scale", {"X": finite}, {"Out": inv},
                        {"scale": -1.0, "bias": 1.0})
        decr_amt = helper.create_variable_for_type_inference("float32", ())
        block.append_op("scale", {"X": inv}, {"Out": decr_amt},
                        {"scale": self._decr_ratio - 1.0, "bias": 1.0})
        block.append_op("elementwise_mul", {"X": scale_var, "Y": decr_amt},
                        {"Out": scale_var}, {"axis": -1})
        # reset good on hit
        keep = helper.create_variable_for_type_inference("float32", ())
        block.append_op("scale", {"X": hit}, {"Out": keep},
                        {"scale": -1.0, "bias": 1.0})
        block.append_op("elementwise_mul", {"X": good, "Y": keep},
                        {"Out": good}, {"axis": -1})


def decorate(optimizer, amp_lists=None, init_loss_scaling=1.0,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.8,
             use_dynamic_loss_scaling=False):
    """Parity: fluid.contrib.mixed_precision.decorate — defaults match
    the 1.5 reference (decorator.py:205): STATIC loss scale 1.0 unless
    use_dynamic_loss_scaling is opted in, decr_ratio 0.8."""
    if amp_lists is None:
        amp_lists = AutoMixedPrecisionLists()
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists, init_loss_scaling, use_dynamic_loss_scaling,
        incr_every_n_steps, decr_every_n_nan_or_inf, incr_ratio, decr_ratio)
