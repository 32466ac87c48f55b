"""Comparison layers.

Parity: python/paddle/fluid/layers/control_flow.py; the counterpart of
``paddle_tpu/layers/control_flow.py``'s ``equal`` and ``greater_than``
(the packed GPT net's pair weights). The control-flow constructs of that
file are not ported.
"""

from ..core.layer_helper import LayerHelper


def _cmp(op_type, x, y, cond=None):
    helper = LayerHelper(op_type)
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool", x.shape)
    helper.append_op(op_type, {"X": x, "Y": y}, {"Out": cond})
    return cond


def greater_than(x, y, cond=None):
    return _cmp("greater_than", x, y, cond)


def equal(x, y, cond=None):
    return _cmp("equal", x, y, cond)
