"""Autodiff: append_backward / gradients.

Parity: python/paddle/fluid/backward.py; a copy of
``paddle_tpu/core/backward.py``. The reference walks the op list in reverse
and appends a `*_grad` OpDesc per forward op. Here differentiation is left
to the Executor: a single BACKWARD_MARKER op carrying (loss, params) is all
the program needs, and the port's Executor runs the ops before it under
torch autograd (``torch.autograd.grad``), where the JAX one wraps them in
``jax.value_and_grad``. Grad tensors still materialize in the env under
fluid's `name@GRAD` convention, so fetch_list=['w@GRAD'] and optimizer ops
keep their fluid shape.
"""

from .framework import (BACKWARD_MARKER, Parameter, Variable, grad_var_name,
                        default_main_program)


def _find_param_names(program, parameter_list=None, no_grad_set=None):
    no_grad = set()
    for item in (no_grad_set or []):
        no_grad.add(item.name if isinstance(item, Variable) else item)
    if parameter_list is not None:
        names = [p.name if isinstance(p, Variable) else p for p in parameter_list]
    else:
        names = [p.name for p in program.all_parameters() if p.trainable]
    return [n for n in names if n not in no_grad]


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    """Plant the backward marker; returns [(param, grad_var)] like fluid."""
    program = loss.block.program
    if program.backward_marker() is not None:
        raise RuntimeError("append_backward called twice on one program")
    param_names = _find_param_names(program, parameter_list, no_grad_set)
    block = program.global_block()
    block.append_op(BACKWARD_MARKER, attrs={"loss": loss.name,
                                            "params": param_names})
    params_and_grads = []
    for n in param_names:
        p = block.var(n)
        g = block.create_var(name=grad_var_name(n), shape=p.shape,
                             dtype=p.dtype)
        params_and_grads.append((p, g))
    return params_and_grads


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """Parity: fluid.gradients — grads of targets w.r.t. arbitrary inputs.

    Implemented by treating the requested inputs as the marker's param list;
    the Executor then exposes `input@GRAD` env entries for fetching.
    """
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    loss = targets[0]
    program = loss.block.program
    if program.backward_marker() is not None:
        raise RuntimeError("gradients/append_backward called twice")
    names = [v.name if isinstance(v, Variable) else v for v in inputs]
    block = program.global_block()
    block.append_op(BACKWARD_MARKER, attrs={"loss": loss.name, "params": names})
    grads = []
    for v in inputs:
        v = block.var(v) if not isinstance(v, Variable) else v
        grads.append(block.create_var(name=grad_var_name(v.name),
                                      shape=v.shape, dtype=v.dtype))
    return grads
