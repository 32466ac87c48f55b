"""Learning-rate schedulers (graph-side).

Parity: python/paddle/fluid/layers/learning_rate_scheduler.py; a copy of
``paddle_tpu/layers/learning_rate_scheduler.py``. Each scheduler builds
ops on a persistable global step counter, bumped by an ``increment`` op
at the head of the program; the port's Executor runs them eagerly at the
start of every step (a handful of scalar ops on the device), where the
JAX Executor traces them into its step.
"""

import math

from ..core.framework import default_main_program
from ..core.layer_helper import LayerHelper
from . import tensor
from . import nn
from . import ops as ops_layers
from .control_flow import autoincreased_step_counter, less_than


LR_COUNTER_NAME = "@LR_DECAY_COUNTER@"


def _decay_step_counter(begin=0):
    """Float mirror of the shared @LR_DECAY_COUNTER@ (reference
    learning_rate_scheduler.py:45 — delegate to autoincreased_step_counter
    so the init-to-begin-minus-step rule lives in ONE place; the first
    executed step observes `begin`).

    NOTE reference-parity caveat: the counter is shared per program, so
    `begin` only takes effect for the FIRST scheduler built — mixing
    noam_decay (begin=1) with another schedule (begin=0) in one program
    follows whichever was built first, exactly like fluid."""
    helper = LayerHelper("global_step_counter")
    gb = default_main_program().global_block()
    if LR_COUNTER_NAME in gb.vars:
        return gb.vars[LR_COUNTER_NAME + ".float"]
    counter = autoincreased_step_counter(LR_COUNTER_NAME, begin=begin,
                                         step=1)
    fcounter = helper.create_or_get_global_variable(
        LR_COUNTER_NAME + ".float", shape=(), dtype="float32")
    helper.append_op("cast", {"X": counter}, {"Out": fcounter},
                     {"out_dtype": "float32"})
    fcounter.stop_gradient = True
    return fcounter


def noam_decay(d_model, warmup_steps):
    step = _decay_step_counter(1)
    a = nn.elementwise_pow(step, tensor.fill_constant((), "float32", -0.5))
    b = nn.elementwise_mul(step, tensor.fill_constant(
        (), "float32", warmup_steps ** -1.5))
    lr = nn.elementwise_min(a, b)
    return nn.scale(lr, scale=d_model ** -0.5)


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _decay_step_counter()
    div = nn.scale(step, scale=1.0 / decay_steps)
    if staircase:
        div = ops_layers.floor(div)
    factor = nn.elementwise_pow(
        tensor.fill_constant((), "float32", decay_rate), div)
    return nn.scale(factor, scale=float(learning_rate))


def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _decay_step_counter()
    div = nn.scale(step, scale=1.0 / decay_steps)
    if staircase:
        div = ops_layers.floor(div)
    return nn.scale(ops_layers.exp(nn.scale(div, scale=-decay_rate)),
                    scale=float(learning_rate))


def inverse_time_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _decay_step_counter()
    div = nn.scale(step, scale=1.0 / decay_steps)
    if staircase:
        div = ops_layers.floor(div)
    denom = nn.scale(div, scale=decay_rate, bias=1.0)
    return nn.elementwise_div(
        tensor.fill_constant((), "float32", float(learning_rate)), denom)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    step = _decay_step_counter()
    if cycle:
        div = nn.elementwise_max(
            ops_layers.ceil(nn.scale(step, scale=1.0 / decay_steps)),
            tensor.fill_constant((), "float32", 1.0))
        decay_steps_var = nn.scale(div, scale=float(decay_steps))
        frac = nn.elementwise_div(step, decay_steps_var)
    else:
        capped = nn.elementwise_min(
            step, tensor.fill_constant((), "float32", float(decay_steps)))
        frac = nn.scale(capped, scale=1.0 / decay_steps)
    base = nn.elementwise_pow(
        nn.scale(frac, scale=-1.0, bias=1.0),
        tensor.fill_constant((), "float32", power))
    return nn.scale(base, scale=float(learning_rate) - end_learning_rate,
                    bias=end_learning_rate)


def piecewise_decay(boundaries, values):
    step = _decay_step_counter()
    lr = tensor.fill_constant((), "float32", values[-1])
    # evaluate from the last boundary back so earlier ranges win
    for b, v in zip(reversed(boundaries), reversed(values[:-1])):
        cond = nn.cast(
            less_than(step, tensor.fill_constant((), "float32", float(b))),
            "float32")
        lr = nn.elementwise_add(
            nn.elementwise_mul(cond, tensor.fill_constant((), "float32", v)),
            nn.elementwise_mul(nn.scale(cond, scale=-1.0, bias=1.0), lr))
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    step = _decay_step_counter()
    epoch = ops_layers.floor(nn.scale(step, scale=1.0 / step_each_epoch))
    cos_arg = nn.scale(epoch, scale=math.pi / epochs)
    decayed = nn.scale(ops_layers.cos(cos_arg), scale=0.5, bias=0.5,
                       bias_after_scale=True)
    return nn.scale(decayed, scale=float(learning_rate))


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    step = _decay_step_counter()
    if not hasattr(learning_rate, "name"):
        learning_rate = tensor.fill_constant((), "float32", float(learning_rate))
    warm = nn.scale(step, scale=(end_lr - start_lr) / warmup_steps,
                    bias=start_lr)
    in_warmup = nn.cast(
        less_than(step, tensor.fill_constant((), "float32",
                                             float(warmup_steps))),
        "float32")
    return nn.elementwise_add(
        nn.elementwise_mul(in_warmup, warm),
        nn.elementwise_mul(nn.scale(in_warmup, scale=-1.0, bias=1.0),
                           learning_rate))
