"""Optimizers (declarative API).

Parity: python/paddle/fluid/optimizer.py; the counterpart of
``paddle_tpu/optimizer/optimizers.py``'s static-graph optimizers (its
dygraph ``minimize`` is not ported). Each optimizer appends its update
ops after the backward marker, behind the gradient clip and the
regularization ops (``apply_gradients``, in the JAX package's order); the
Executor runs them after the autograd pass, and the accumulators are
persistable Scope vars (fluid semantics) updated in place on the device.
"""

from ..core import unique_name
from ..core.framework import (Variable, default_startup_program,
                              program_guard)
from ..core.backward import append_backward
from ..core.layer_helper import LayerHelper
from .. import initializer as init_mod
from .clip import append_gradient_clip_ops
from .regularizer import append_regularization_ops


class Optimizer:
    """Base. Parity: fluid.optimizer.Optimizer."""

    def __init__(self, learning_rate, regularization=None, name=None):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._name = name
        self._accumulators = {}  # acc_name -> {param_name: var}
        self._lr_var = None
        self.type = getattr(self, "type", "optimizer")

    # -- learning rate ------------------------------------------------------
    def _create_global_learning_rate(self, program):
        if isinstance(self._learning_rate, Variable):
            self._lr_var = self._learning_rate
            return
        if self._lr_var is not None:
            return
        helper = LayerHelper("learning_rate")
        name = unique_name.generate("learning_rate")
        self._lr_var = helper.create_global_variable(
            persistable=True, name=name, shape=(), dtype="float32")
        self._lr_var.stop_gradient = True
        init_mod.ConstantInitializer(float(self._learning_rate))(self._lr_var)

    def _global_learning_rate(self):
        return self._lr_var

    current_step_lr = _global_learning_rate

    def set_lr(self, value):
        """Set the rate the next step uses: the learning-rate scope var is
        filled in place on its device (one fill, no host tensor for a
        later step to upload). Run the startup program first; a schedule's
        var is recomputed by its ops each step."""
        from ..core.executor import global_scope
        if self._lr_var is None:
            return
        t = global_scope().get(self._lr_var.name)
        if t is None:
            raise RuntimeError(
                f"set_lr: '{self._lr_var.name}' is not in the scope; run "
                f"the startup program first")
        t.fill_(float(value))

    # -- accumulators -------------------------------------------------------
    def _add_accumulator(self, name, param, fill_value=0.0, shape=None,
                         dtype="float32"):
        if name not in self._accumulators:
            self._accumulators[name] = {}
        if param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        helper = LayerHelper("accumulator")
        var = helper.create_global_variable(
            persistable=True,
            name=unique_name.generate(f"{param.name}_{name}"),
            shape=shape if shape is not None else param.shape, dtype=dtype)
        var.stop_gradient = True
        init_mod.ConstantInitializer(float(fill_value))(var)
        self._accumulators[name][param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # -- core ---------------------------------------------------------------
    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _create_accumulators(self, block, parameters):
        pass

    def _finish_update(self, block, params_grads):
        pass

    def _param_lr(self, param_and_grad):
        """The global rate, or a scale op of it for a parameter whose
        ParamAttr sets learning_rate."""
        param = param_and_grad[0]
        lr_scale = param.optimize_attr.get("learning_rate", 1.0)
        if lr_scale == 1.0:
            return self._lr_var
        from ..layers import nn as nn_layers
        return nn_layers.scale(self._lr_var, scale=float(lr_scale))

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        with program_guard(loss.block.program,
                           startup_program or default_startup_program()):
            return append_backward(loss, parameter_list, no_grad_set)

    def apply_gradients(self, params_grads):
        program = params_grads[0][0].block.program
        block = program.global_block()
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        self._create_accumulators(block, [p for p, _ in params_grads])
        optimize_ops = [self._append_optimize_op(block, pg)
                        for pg in params_grads]
        self._finish_update(block, params_grads)
        return optimize_ops

    def apply_optimize(self, loss, startup_program, params_grads):
        with program_guard(loss.block.program,
                           startup_program or default_startup_program()):
            self._create_global_learning_rate(loss.block.program)
            return self.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, grad_clip=None):
        if grad_clip is not None:
            # Fluid 1.5 applies minimize's grad_clip in dygraph mode only,
            # and the JAX package drops it: refuse it rather than train
            # unclipped
            raise ValueError(
                "minimize(grad_clip=) is not applied to a static program; "
                "set the clip with fluid.clip.set_gradient_clip(...) or a "
                "ParamAttr's gradient_clip")
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        optimize_ops = self.apply_optimize(loss, startup_program, params_grads)
        return optimize_ops, params_grads


class SGDOptimizer(Optimizer):
    type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "sgd",
            {"Param": p, "Grad": g, "LearningRate": self._param_lr(param_and_grad)},
            {"ParamOut": p})


class MomentumOptimizer(Optimizer):
    type = "momentum"

    def __init__(self, learning_rate, momentum, use_nesterov=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            "momentum",
            {"Param": p, "Grad": g, "Velocity": v,
             "LearningRate": self._param_lr(param_and_grad)},
            {"ParamOut": p, "VelocityOut": v},
            {"mu": self._momentum, "use_nesterov": self._use_nesterov})


class LarsMomentumOptimizer(Optimizer):
    type = "lars_momentum"

    def __init__(self, learning_rate, momentum, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            "lars_momentum",
            {"Param": p, "Grad": g, "Velocity": v,
             "LearningRate": self._param_lr(param_and_grad)},
            {"ParamOut": p, "VelocityOut": v},
            {"mu": self._momentum, "lars_coeff": self._lars_coeff,
             "lars_weight_decay": self._lars_weight_decay})


class AdagradOptimizer(Optimizer):
    type = "adagrad"

    def __init__(self, learning_rate, epsilon=1e-6, initial_accumulator_value=0.0,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p, fill_value=self._initial)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        return block.append_op(
            "adagrad",
            {"Param": p, "Grad": g, "Moment": m,
             "LearningRate": self._param_lr(param_and_grad)},
            {"ParamOut": p, "MomentOut": m}, {"epsilon": self._epsilon})


class DecayedAdagradOptimizer(Optimizer):
    type = "decayed_adagrad"

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._decay = decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        return block.append_op(
            "decayed_adagrad",
            {"Param": p, "Grad": g, "Moment": m,
             "LearningRate": self._param_lr(param_and_grad)},
            {"ParamOut": p, "MomentOut": m},
            {"decay": self._decay, "epsilon": self._epsilon})


class AdadeltaOptimizer(Optimizer):
    type = "adadelta"

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._epsilon = epsilon
        self._rho = rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("avg_squared_grad", p)
            self._add_accumulator("avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "adadelta",
            {"Param": p, "Grad": g,
             "AvgSquaredGrad": self._get_accumulator("avg_squared_grad", p),
             "AvgSquaredUpdate": self._get_accumulator("avg_squared_update", p)},
            {"ParamOut": p,
             "AvgSquaredGradOut": self._get_accumulator("avg_squared_grad", p),
             "AvgSquaredUpdateOut": self._get_accumulator("avg_squared_update", p)},
            {"rho": self._rho, "epsilon": self._epsilon})


class AdamOptimizer(Optimizer):
    type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=())
            self._add_accumulator("beta2_pow_acc", p, fill_value=self._beta2,
                                  shape=())

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "adam",
            {"Param": p, "Grad": g,
             "Moment1": self._get_accumulator("moment1", p),
             "Moment2": self._get_accumulator("moment2", p),
             "Beta1Pow": self._get_accumulator("beta1_pow_acc", p),
             "Beta2Pow": self._get_accumulator("beta2_pow_acc", p),
             "LearningRate": self._param_lr(param_and_grad)},
            {"ParamOut": p,
             "Moment1Out": self._get_accumulator("moment1", p),
             "Moment2Out": self._get_accumulator("moment2", p),
             "Beta1PowOut": self._get_accumulator("beta1_pow_acc", p),
             "Beta2PowOut": self._get_accumulator("beta2_pow_acc", p)},
            {"beta1": self._beta1, "beta2": self._beta2,
             "epsilon": self._epsilon})


class AdamaxOptimizer(Optimizer):
    type = "adamax"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=())

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "adamax",
            {"Param": p, "Grad": g,
             "Moment": self._get_accumulator("moment", p),
             "InfNorm": self._get_accumulator("inf_norm", p),
             "Beta1Pow": self._get_accumulator("beta1_pow_acc", p),
             "LearningRate": self._param_lr(param_and_grad)},
            {"ParamOut": p,
             "MomentOut": self._get_accumulator("moment", p),
             "InfNormOut": self._get_accumulator("inf_norm", p),
             "Beta1PowOut": self._get_accumulator("beta1_pow_acc", p)},
            {"beta1": self._beta1, "beta2": self._beta2,
             "epsilon": self._epsilon})


class RMSPropOptimizer(Optimizer):
    type = "rmsprop"

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("mean_square", p)
            self._add_accumulator("moment", p)
            if self._centered:
                self._add_accumulator("mean_grad", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        inputs = {"Param": p, "Grad": g,
                  "MeanSquare": self._get_accumulator("mean_square", p),
                  "Moment": self._get_accumulator("moment", p),
                  "LearningRate": self._param_lr(param_and_grad)}
        outputs = {"ParamOut": p,
                   "MeanSquareOut": self._get_accumulator("mean_square", p),
                   "MomentOut": self._get_accumulator("moment", p)}
        if self._centered:
            inputs["MeanGrad"] = self._get_accumulator("mean_grad", p)
            outputs["MeanGradOut"] = self._get_accumulator("mean_grad", p)
        return block.append_op(
            "rmsprop", inputs, outputs,
            {"decay": self._rho, "epsilon": self._epsilon,
             "momentum": self._momentum, "centered": self._centered})


class FtrlOptimizer(Optimizer):
    type = "ftrl"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._l1 = l1
        self._l2 = l2
        self._lr_power = lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "ftrl",
            {"Param": p, "Grad": g,
             "SquaredAccumulator": self._get_accumulator("squared", p),
             "LinearAccumulator": self._get_accumulator("linear", p),
             "LearningRate": self._param_lr(param_and_grad)},
            {"ParamOut": p,
             "SquaredAccumOut": self._get_accumulator("squared", p),
             "LinearAccumOut": self._get_accumulator("linear", p)},
            {"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power})


class LambOptimizer(AdamOptimizer):
    type = "lamb"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6,
                 exclude_from_weight_decay_fn=None, **kwargs):
        super().__init__(learning_rate, beta1, beta2, epsilon, **kwargs)
        self._weight_decay = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        wd = self._weight_decay
        if self._exclude_fn is not None and self._exclude_fn(p):
            wd = 0.0
        return block.append_op(
            "lamb",
            {"Param": p, "Grad": g,
             "Moment1": self._get_accumulator("moment1", p),
             "Moment2": self._get_accumulator("moment2", p),
             "Beta1Pow": self._get_accumulator("beta1_pow_acc", p),
             "Beta2Pow": self._get_accumulator("beta2_pow_acc", p),
             "LearningRate": self._param_lr(param_and_grad)},
            {"ParamOut": p,
             "Moment1Out": self._get_accumulator("moment1", p),
             "Moment2Out": self._get_accumulator("moment2", p),
             "Beta1PowOut": self._get_accumulator("beta1_pow_acc", p),
             "Beta2PowOut": self._get_accumulator("beta2_pow_acc", p)},
            {"beta1": self._beta1, "beta2": self._beta2,
             "epsilon": self._epsilon, "weight_decay": wd})


# 2.x-style aliases
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
Lamb = LambOptimizer
