"""Layer-function codegen helpers.

Parity: python/paddle/fluid/layers/layer_function_generator.py
(``generate_layer_fn``, ``generate_activation_fn``, ``deprecated``,
``autodoc``, ``templatedoc``); the counterpart of
``paddle_tpu/layers/layer_function_generator.py``. The reference
generates Python layer functions from C++ OpProtos; here they generate
from the port's op registry, with the same calling convention for the
simple one-in / one-out ops they cover (everything richer has a
hand-written layer).
"""

import functools
import re
import warnings

from ..core.layer_helper import LayerHelper

__all__ = ["deprecated", "generate_layer_fn", "generate_activation_fn",
           "autodoc", "templatedoc"]


def _register_exists(op_type):
    from .. import ops as ops_registry
    return op_type in ops_registry._REGISTRY


def generate_layer_fn(op_type):
    """A layer fn for a registered one-X-in / one-Out op: positional or
    x= input, remaining kwargs become op attrs (ref :119)."""
    if not _register_exists(op_type):
        raise ValueError(f"no registered op {op_type!r}")

    def layer_fn(x=None, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(
            getattr(x, "dtype", "float32"),
            getattr(x, "shape", None))
        ins = {"X": x} if x is not None else {}
        helper.append_op(op_type, ins, {"Out": out}, attrs)
        return out

    layer_fn.__name__ = op_type
    layer_fn.__doc__ = f"Generated layer for the `{op_type}` op."
    return layer_fn


def generate_activation_fn(op_type):
    """A layer fn for a registered elementwise activation (ref :255)."""
    fn = generate_layer_fn(op_type)
    fn.__doc__ = f"Generated activation layer for `{op_type}`: " \
                 f"Out = {op_type}(X)."
    return fn


def deprecated(func_or_class):
    """Mark an API deprecated: wraps it with a DeprecationWarning
    (ref :42)."""

    @functools.wraps(func_or_class)
    def wrapped(*args, **kwargs):
        warnings.warn(f"{func_or_class.__name__} is deprecated",
                      DeprecationWarning, stacklevel=2)
        return func_or_class(*args, **kwargs)

    return wrapped


def autodoc(comment=""):
    """Prepend a comment to the function's docstring (ref :378)."""

    def deco(func):
        func.__doc__ = comment + (func.__doc__ or "")
        return func

    return deco


_TEMPLATE = re.compile(r"\$\{([a-z0-9_]+)(_comment|_type)?\}")


def templatedoc(op_type=None):
    """Substitute ``${x_comment}``-style placeholders in the docstring
    with the op name (ref :400; the reference pulls OpProto comments,
    here the op type itself, which keeps docs renderable)."""

    def deco(func):
        nm = op_type or func.__name__
        if func.__doc__:
            func.__doc__ = _TEMPLATE.sub(
                lambda m: m.group(1) if m.group(2) else nm, func.__doc__)
        return func

    return deco
