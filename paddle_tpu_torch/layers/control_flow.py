"""Comparison layers and the step counter.

Parity: python/paddle/fluid/layers/control_flow.py; the counterpart of
``paddle_tpu/layers/control_flow.py``'s ``equal``, ``greater_than`` and
``less_than`` and ``autoincreased_step_counter``
(the learning-rate schedules' counter). The control-flow constructs of
that file are not ported.
"""

from ..core.layer_helper import LayerHelper
from .. import initializer as init_mod


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


def less_than(x, y, force_cpu=None, cond=None):
    return _cmp("less_than", x, y, cond)


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """Parity: fluid.layers.autoincreased_step_counter — persistable int64
    counter bumped once per Executor.run (the @LR_DECAY_COUNTER@
    mechanism): started at begin - step, incremented by an op at the
    head of the program, so the first run reads `begin`."""
    helper = LayerHelper("global_step_counter")
    name = counter_name or "@STEP_COUNTER@"
    counter = helper.create_or_get_global_variable(
        name, dtype="int64", shape=(1,), persistable=True)
    if counter.op is None:
        init_mod.ConstantInitializer(float(begin - step))(counter)
        helper.main_program.global_block().prepend_op(
            "increment", {"X": counter}, {"Out": counter},
            {"step": float(step)})
        counter.op = helper.main_program.global_block().ops[0]
        counter.stop_gradient = True
    return counter
