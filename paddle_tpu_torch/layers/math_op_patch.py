"""Monkey-patch arithmetic operators onto Variable.

Parity: python/paddle/fluid/layers/math_op_patch.py; a copy of
``paddle_tpu/layers/math_op_patch.py``, so that ``a * 2`` or ``i < n``
on a Program variable appends the same ops, under the same names, as in
the JAX package: a scalar added, subtracted, multiplied or divided goes
through ``scale`` (a reversed division through ``fill_constant`` and
``elementwise_div``), everything else through the elementwise and
comparison ops, a scalar operand becoming a ``fill_constant`` of the
variable's shape and dtype. ``==`` is left alone (Variables stay
hashable).
"""

from ..core.framework import Variable
from ..core.layer_helper import LayerHelper
from . import tensor as tensor_layers


def _to_var(other, ref):
    if isinstance(other, Variable):
        return other
    return tensor_layers.fill_constant(ref.shape if ref.shape else (),
                                       ref.dtype, float(other))


def _binary(op_type, reverse=False):
    def impl(self, other):
        if not isinstance(other, Variable) and op_type in (
                "elementwise_add", "elementwise_sub", "elementwise_mul",
                "elementwise_div"):
            # scalar fast path via scale op
            helper = LayerHelper("scale")
            out = helper.create_variable_for_type_inference(self.dtype, self.shape)
            v = float(other)
            if op_type == "elementwise_add":
                helper.append_op("scale", {"X": self}, {"Out": out},
                                 {"scale": 1.0, "bias": v})
            elif op_type == "elementwise_sub":
                if reverse:
                    helper.append_op("scale", {"X": self}, {"Out": out},
                                     {"scale": -1.0, "bias": v})
                else:
                    helper.append_op("scale", {"X": self}, {"Out": out},
                                     {"scale": 1.0, "bias": -v})
            elif op_type == "elementwise_mul":
                helper.append_op("scale", {"X": self}, {"Out": out},
                                 {"scale": v, "bias": 0.0})
            else:
                if reverse:
                    other_var = _to_var(other, self)
                    return _append(op_type, other_var, self)
                helper.append_op("scale", {"X": self}, {"Out": out},
                                 {"scale": 1.0 / v, "bias": 0.0})
            return out
        other_var = _to_var(other, self)
        if reverse:
            return _append(op_type, other_var, self)
        return _append(op_type, self, other_var)
    return impl


def _append(op_type, x, y):
    helper = LayerHelper(op_type)
    dtype = x.dtype
    if op_type in ("less_than", "less_equal", "greater_than", "greater_equal",
                   "equal", "not_equal"):
        dtype = "bool"
    shape = x.shape if len(x.shape) >= len(y.shape) else y.shape
    out = helper.create_variable_for_type_inference(dtype, shape)
    attrs = {"axis": -1} if op_type.startswith("elementwise") else {}
    helper.append_op(op_type, {"X": x, "Y": y}, {"Out": out}, attrs)
    return out


def _neg(self):
    helper = LayerHelper("scale")
    out = helper.create_variable_for_type_inference(self.dtype, self.shape)
    helper.append_op("scale", {"X": self}, {"Out": out},
                     {"scale": -1.0, "bias": 0.0})
    return out


def monkey_patch_variable():
    Variable.__add__ = _binary("elementwise_add")
    Variable.__radd__ = _binary("elementwise_add")
    Variable.__sub__ = _binary("elementwise_sub")
    Variable.__rsub__ = _binary("elementwise_sub", reverse=True)
    Variable.__mul__ = _binary("elementwise_mul")
    Variable.__rmul__ = _binary("elementwise_mul")
    Variable.__truediv__ = _binary("elementwise_div")
    Variable.__rtruediv__ = _binary("elementwise_div", reverse=True)
    Variable.__pow__ = _binary("elementwise_pow")
    Variable.__mod__ = _binary("elementwise_mod")
    Variable.__floordiv__ = _binary("elementwise_floordiv")
    Variable.__lt__ = _binary("less_than")
    Variable.__le__ = _binary("less_equal")
    Variable.__gt__ = _binary("greater_than")
    Variable.__ge__ = _binary("greater_equal")
    Variable.__neg__ = _neg
