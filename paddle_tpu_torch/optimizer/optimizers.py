"""Optimizers (declarative API).

Parity: python/paddle/fluid/optimizer.py; the counterpart of
``paddle_tpu/optimizer/optimizers.py``'s ``Optimizer``, ``SGDOptimizer``
and ``AdamOptimizer``. Each optimizer appends its update ops after the
backward marker; the Executor runs them after the autograd pass, and the
accumulators are persistable Scope vars (fluid semantics) updated in place
on the device.
"""

from ..core import unique_name
from ..core.framework import (Variable, default_startup_program,
                              program_guard)
from ..core.backward import append_backward
from ..core.layer_helper import LayerHelper
from .. import initializer as init_mod


class Optimizer:
    """Base. Parity: fluid.optimizer.Optimizer. ``regularization`` is
    accepted only as None: regularizers are not ported yet."""

    def __init__(self, learning_rate, regularization=None, name=None):
        if regularization is not None:
            raise NotImplementedError("regularization is not ported yet")
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

    def _param_lr(self, param_and_grad):
        param = param_and_grad[0]
        if param.optimize_attr.get("learning_rate", 1.0) != 1.0:
            raise NotImplementedError(
                "a per-parameter learning-rate scale needs the scale op, "
                "which is not ported yet")
        return self._lr_var

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        with program_guard(loss.block.program,
                           startup_program or default_startup_program()):
            return append_backward(loss, parameter_list, no_grad_set)

    def apply_gradients(self, params_grads):
        program = params_grads[0][0].block.program
        block = program.global_block()
        self._create_accumulators(block, [p for p, _ in params_grads])
        return [self._append_optimize_op(block, pg) for pg in params_grads]

    def apply_optimize(self, loss, startup_program, params_grads):
        with program_guard(loss.block.program,
                           startup_program or default_startup_program()):
            self._create_global_learning_rate(loss.block.program)
            return self.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, grad_clip=None):
        if grad_clip is not None:
            raise NotImplementedError("gradient clipping is not ported yet")
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


# fluid aliases
SGD = SGDOptimizer
Adam = AdamOptimizer
