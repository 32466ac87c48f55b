"""Parity: python/paddle/fluid/contrib/extend_optimizer/
extend_optimizer_with_weight_decay.py:102; the counterpart of the JAX
package's file of that name: a class decorator giving any optimizer
decoupled (AdamW-style) weight decay, which applies to the parameter as
it was before the update, outside the adaptive rescaling.

The ops: an ``assign`` snapshot of each parameter before the base
optimizer's ops (a copy: those ops update the parameter in place), and a
``decoupled_weight_decay`` op after them, p -= coeff snapshot.
"""

from ...optimizer.optimizers import Optimizer

__all__ = ["extend_with_decoupled_weight_decay"]


def extend_with_decoupled_weight_decay(base_optimizer):
    if not (isinstance(base_optimizer, type)
            and issubclass(base_optimizer, Optimizer)):
        raise TypeError(
            "input 'base_optimizer' should be an Optimizer subclass")

    class OptimizerWithDecoupledWeightDecay(base_optimizer):
        """base_optimizer + decoupled decay; the coefficient is the first
        argument, as in the reference:
        OptimizerWithDecoupledWeightDecay(coeff, ...)."""

        def __init__(self, weight_decay, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self._decoupled_coeff = float(weight_decay)

        def apply_gradients(self, params_grads):
            from ... import layers
            block = params_grads[0][0].block.program.global_block()
            # the snapshot before the base update's ops
            snaps = [(p, layers.assign(p)) for p, _ in params_grads]
            ops = super().apply_gradients(params_grads)
            if self._decoupled_coeff:
                for p, snap in snaps:
                    ops.append(block.append_op(
                        "decoupled_weight_decay",
                        {"Param": p, "PrevParam": snap},
                        {"ParamOut": p},
                        {"coeff": self._decoupled_coeff}))
            return ops

    return OptimizerWithDecoupledWeightDecay
