"""Parameter initializers.

Parity: python/paddle/fluid/initializer.py; the counterpart of
``paddle_tpu/initializer.py``, with the initializers the GPT startup
program reaches: Constant, Uniform, Normal and Xavier. Each initializer
appends an init op to the *startup program*; running the startup program
through the Executor materializes the parameters into the Scope (fluid
semantics preserved). Random inits draw from a ``torch.Generator`` seeded
per (program seed, step, op seed) (``ops/__init__.py`` ``OpContext.rng``):
deterministic, but not the JAX package's numbers.
"""

import math

from .core import framework
from .core.framework import default_startup_program


class Initializer:
    def __call__(self, var, block=None):
        raise NotImplementedError

    def _startup_block(self, block):
        if block is not None:
            return block
        return default_startup_program().global_block()

    def _ensure_startup_var(self, block, var):
        if var.name not in block.vars:
            v = framework.Variable(block, name=var.name, shape=var.shape,
                                   dtype=var.dtype, persistable=True)
            block.vars[var.name] = v
        return block.vars[var.name]


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self.value = value

    def __call__(self, var, block=None):
        block = self._startup_block(block)
        out = self._ensure_startup_var(block, var)
        return block.append_op(
            "fill_constant", outputs={"Out": out},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "value": float(self.value)})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block=None):
        block = self._startup_block(block)
        out = self._ensure_startup_var(block, var)
        return block.append_op(
            "uniform_random", outputs={"Out": out},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "min": float(self.low), "max": float(self.high),
                   "op_seed": block.program.next_op_seed()})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block=None):
        block = self._startup_block(block)
        out = self._ensure_startup_var(block, var)
        return block.append_op(
            "gaussian_random", outputs={"Out": out},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "mean": float(self.loc), "std": float(self.scale),
                   "op_seed": block.program.next_op_seed()})


def _fan_in_out(var):
    shape = var.shape
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = 1
    for s in shape[2:]:
        receptive *= s
    return shape[1] * receptive, shape[0] * receptive


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = uniform, fan_in, fan_out, seed

    def __call__(self, var, block=None):
        fi, fo = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            return UniformInitializer(-limit, limit, self.seed)(var, block)
        std = math.sqrt(2.0 / (fi + fo))
        return NormalInitializer(0.0, std, self.seed)(var, block)


# fluid aliases
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer


def _global_weight_initializer():
    return XavierInitializer()


def _global_bias_initializer():
    return ConstantInitializer(0.0)
