"""Probability distributions.

Parity: python/paddle/fluid/layers/distributions.py (Uniform:113,
Normal:246, Categorical:401, MultivariateNormalDiag:494); the counterpart
of ``paddle_tpu/layers/distributions.py``: the same math and API
(``sample``, ``entropy``, ``log_prob``, ``kl_divergence``), built from
the port's layers, so each call appends ops to the current Program.
Constant parameters become ``assign_value`` ops. Samples come from the
random ops' generators (``OpContext.rng()``, seeded per program seed,
step and op), so no sample equals ``jax.random``'s; ``Categorical.sample``
is a Gumbel-max draw, ``log_prob`` of a value outside ``Uniform``'s
support is log(0) = -inf, as in the reference.
"""

import math

import numpy as np

from ..core.framework import Variable
from . import control_flow, nn, ops, tensor

__all__ = ["Uniform", "Normal", "Categorical", "MultivariateNormalDiag"]


def _to_var(value, dtype="float32"):
    """A Variable as it is; a number, list or array as an assign_value
    constant (at least 1-D)."""
    if isinstance(value, Variable):
        return value
    arr = np.asarray(value, dtype=dtype)
    return tensor.assign(arr.reshape(1) if arr.ndim == 0 else arr)


class Distribution:
    """The abstract base (layers/distributions.py:28)."""

    def sample(self, shape, seed=0):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def kl_divergence(self, other):
        raise NotImplementedError

    @staticmethod
    def _is_float_like(*args):
        return all(isinstance(a, (float, int)) for a in args)


class Uniform(Distribution):
    """U(low, high)."""

    def __init__(self, low, high):
        self.all_arg_is_float = self._is_float_like(low, high)
        self.low = _to_var(low)
        self.high = _to_var(high)

    def sample(self, shape, seed=0):
        """`shape` + the batch shape of (low, high) draws; a plain
        `shape` where both parameters are numbers."""
        batch_shape = list((self.low + self.high).shape)
        u = ops.uniform_random(list(shape) + batch_shape, min=0.0, max=1.0,
                               seed=seed)
        out = u * (self.high - self.low) + self.low
        if self.all_arg_is_float:
            return nn.reshape(out, list(shape))
        return out

    def log_prob(self, value):
        lb = nn.cast(control_flow.less_than(self.low, value), value.dtype)
        ub = nn.cast(control_flow.less_than(value, self.high), value.dtype)
        return ops.log(lb * ub) - ops.log(self.high - self.low)

    def entropy(self):
        return ops.log(self.high - self.low)


class Normal(Distribution):
    """N(loc, scale)."""

    def __init__(self, loc, scale):
        self.all_arg_is_float = self._is_float_like(loc, scale)
        self.loc = _to_var(loc)
        self.scale = _to_var(scale)

    def sample(self, shape, seed=0):
        batch_shape = list((self.loc + self.scale).shape)
        z = ops.gaussian_random(list(shape) + batch_shape, mean=0.0,
                                std=1.0, seed=seed)
        out = z * self.scale + self.loc
        if self.all_arg_is_float:
            return nn.reshape(out, list(shape))
        return out

    def entropy(self):
        return 0.5 + 0.5 * math.log(2 * math.pi) + ops.log(self.scale)

    def log_prob(self, value):
        var = self.scale * self.scale
        return (value - self.loc) * (value - self.loc) / (var * -2.0) \
            - ops.log(self.scale) - math.log(math.sqrt(2.0 * math.pi))

    def kl_divergence(self, other):
        assert isinstance(other, Normal), \
            "another distribution must be Normal"
        var_ratio = self.scale / other.scale
        var_ratio = var_ratio * var_ratio
        t1 = (self.loc - other.loc) / other.scale
        t1 = t1 * t1
        return (var_ratio + t1 - 1.0 - ops.log(var_ratio)) * 0.5


class Categorical(Distribution):
    """Categorical over unnormalized logits (the last axis)."""

    def __init__(self, logits):
        self.logits = _to_var(logits)

    @staticmethod
    def _norm(logits):
        """(logits - their max, exp of that, its sum over the last axis)."""
        shifted = logits - nn.reduce_max(logits, dim=-1, keep_dim=True)
        e = ops.exp(shifted)
        return shifted, e, nn.reduce_sum(e, dim=-1, keep_dim=True)

    def entropy(self):
        logits, e, z = self._norm(self.logits)
        return nn.reduce_sum((e / z) * (logits - ops.log(z)), dim=-1,
                             keep_dim=True) * -1.0

    def kl_divergence(self, other):
        assert isinstance(other, Categorical)
        logits, e, z = self._norm(self.logits)
        o_logits, _, o_z = self._norm(other.logits)
        return nn.reduce_sum(
            (e / z) * (logits - ops.log(z) - o_logits + ops.log(o_z)),
            dim=-1, keep_dim=True)

    def sample(self, shape, seed=0):
        """The JAX package's extension (the reference left it out): a
        Gumbel-max draw over the last axis, int64 class indices."""
        logits = self.logits
        u = ops.uniform_random(list(shape) + list(logits.shape),
                               min=1e-6, max=1.0 - 1e-6, seed=seed)
        g = ops.log(ops.log(u) * -1.0) * -1.0
        return nn.argmax(logits + g, axis=-1)

    def log_prob(self, value):
        """The JAX package's extension: log p(value) of int class
        indices."""
        logits, _, z = self._norm(self.logits)
        oh = nn.one_hot(value, depth=int(self.logits.shape[-1]))
        return nn.reduce_sum((logits - ops.log(z)) * oh, dim=-1)


class MultivariateNormalDiag(Distribution):
    """The multivariate normal with a diagonal covariance given as a
    (k, k) diagonal matrix."""

    def __init__(self, loc, scale):
        self.loc = _to_var(loc)
        self.scale = _to_var(scale)

    @staticmethod
    def _eye_ones(value):
        shape = list(value.shape)
        return (tensor.ones(shape, "float32"),
                tensor.diag(tensor.ones([shape[0]], "float32")))

    def _det(self, value):
        """The product of the diagonal (the off-diagonal zeros made 1)."""
        ones_all, eye = self._eye_ones(value)
        return nn.reduce_prod(value + ones_all - eye)

    def _inv(self, value):
        """The diagonal inverted elementwise (x^-1 on it, x^1 off it)."""
        ones_all, eye = self._eye_ones(value)
        return nn.elementwise_pow(value, ones_all - eye * 2.0)

    def entropy(self):
        k = int(self.scale.shape[0])
        return (ops.log(self._det(self.scale))
                + k * (1.0 + math.log(2 * math.pi))) * 0.5

    def kl_divergence(self, other):
        assert isinstance(other, MultivariateNormalDiag)
        tr = nn.reduce_sum(self._inv(other.scale) * self.scale)
        diff = other.loc - self.loc
        quad = nn.matmul(nn.matmul(diff, self._inv(other.scale)), diff)
        k = int(self.scale.shape[0])
        ln_cov = ops.log(self._det(other.scale)) \
            - ops.log(self._det(self.scale))
        return (tr + quad - float(k) + ln_cov) * 0.5
