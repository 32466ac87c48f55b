"""Op registry: op type -> eager torch implementation.

Parity: paddle/fluid/operators/* (REGISTER_OPERATOR); the counterpart of
``paddle_tpu/ops/__init__.py`` (``register``, ``OpContext``, ``run_op``),
with torch in place of jnp. The JAX registry's ops run while the Executor
traces a Program under jit; the port's run eagerly, one after another, as
the Executor walks the Program (core/executor.py), so each op launches its
own device work. The registry holds only the ops the ported slice runs;
the modules keep the JAX registry's names.

An op impl has signature ``fn(ctx) -> {output_slot: tensor-or-list}``.

Kernels live in subpackages by route (``ops/cuda/``); the modules here
are plain torch around them.
"""

import torch

from ..core.framework import convert_dtype

_REGISTRY = {}

# the env key of the step's (program seed, step counter) pair, from which
# OpContext.rng() seeds each random op's generator
RNG_KEY = "@RNG@"

_TORCH_DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool}


def torch_dtype(dtype):
    """A framework dtype spec -> the torch dtype. Unlike the JAX package
    the port keeps int64 on the device (torch's embedding takes it)."""
    return _TORCH_DTYPES[convert_dtype(dtype)]


def register(*names):
    def deco(fn):
        for n in names:
            _REGISTRY[n] = fn
        return fn
    return deco


def get(name):
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"op '{name}' is not ported: paddle_tpu_torch.ops registers "
            f"only the ops of the ported slices")
    return _REGISTRY[name]


_MASK64 = (1 << 64) - 1


def _mix64(x):
    """splitmix64's finalizer: a 64-bit integer hash."""
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _MASK64
    return x ^ (x >> 31)


def generator_seed(seed, step, op_seed):
    """The seed of one random op's generator at one step: a hash of
    (program seed, step counter, op seed), as JAX folds the three into
    one key. The streams differ from JAX's by design: torch's generators
    are not JAX's counter-based PRNG."""
    x = _mix64(int(seed) & _MASK64)
    x = _mix64(x ^ (int(step) & _MASK64))
    return _mix64(x ^ (int(op_seed) & _MASK64))


class OpContext:
    """Execution context handed to an op impl while the Executor runs a
    Program: the op, the env of live values, the device the Executor runs
    on, and `live`, the names something downstream reads (None: all)."""

    __slots__ = ("op", "env", "program", "is_test", "device", "live")

    def __init__(self, op, env, program, is_test=False, device=None,
                 live=None):
        self.op = op
        self.env = env
        self.program = program
        self.is_test = is_test or bool(op.attrs.get("is_test", False))
        self.device = device
        self.live = live

    # -- inputs -------------------------------------------------------------
    def in_(self, slot, default=None):
        names = self.op.input(slot)
        return self.env[names[0]] if names else default

    def attr(self, name, default=None):
        return self.op.attrs.get(name, default)

    def out_name(self, slot):
        names = self.op.output(slot)
        return names[0] if names else None

    def wants(self, slot):
        """Does anything read this output (a later op, a fetch, the
        scope)? An eager op skips the side outputs nobody reads (the
        softmax beside a cross-entropy, a reshape's XShape), which the JAX
        Executor's jit drops as dead code."""
        name = self.out_name(slot)
        return name is not None and (self.live is None or name in self.live)

    # -- rng ----------------------------------------------------------------
    def rng(self):
        """A torch.Generator on the op's device, seeded from (program
        seed, step counter, this op's op_seed): deterministic per op and
        step, as JAX's fold_in keys are."""
        seed, step = self.env[RNG_KEY]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(generator_seed(seed, step,
                                       self.op.attrs.get("op_seed", 0)))
        return gen


def run_op(op, env, program, is_test=False, device=None, live=None):
    """Execute one op into env."""
    impl = get(op.type)
    outs = impl(OpContext(op, env, program, is_test, device, live))
    if outs:
        for slot, vals in outs.items():
            names = op.output(slot)
            if not isinstance(vals, (list, tuple)):
                vals = [vals]
            for name, val in zip(names, vals):
                env[name] = val


# Populate the registry.
from . import math_ops        # noqa: E402,F401
from . import activation_ops  # noqa: E402,F401
from . import tensor_ops      # noqa: E402,F401
from . import nn_ops          # noqa: E402,F401
from . import loss_ops        # noqa: E402,F401
from . import random_ops      # noqa: E402,F401
from . import optimizer_ops   # noqa: E402,F401
from . import attention_ops   # noqa: E402,F401
from . import metric_ops      # noqa: E402,F401
