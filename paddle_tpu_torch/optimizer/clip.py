"""Gradient clipping.

Parity: python/paddle/fluid/clip.py (GradientClipByValue / ByNorm /
ByGlobalNorm, set_gradient_clip, ErrorClipByValue); a copy of
``paddle_tpu/optimizer/clip.py``. Clip ops rewrite `param@GRAD` in place
in the env before the optimizer's update ops; the global-norm clip is
square / reduce_sum a gradient, one sum, sqrt, and a mul a gradient by
clip_norm / max(norm, clip_norm), each an eager op on the device (no
host sync).
"""

from ..core.layer_helper import LayerHelper
from ..core.framework import default_main_program


class BaseErrorClipAttr:
    pass


class ErrorClipByValue(BaseErrorClipAttr):
    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max


class BaseGradientClipAttr:
    def _clip(self, params_grads):
        raise NotImplementedError


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip(self, params_grads):
        for p, g in params_grads:
            block = p.block.program.global_block()
            block.append_op("clip", {"X": g}, {"Out": g},
                            {"min": self.min, "max": self.max})
        return params_grads


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip(self, params_grads):
        for p, g in params_grads:
            block = p.block.program.global_block()
            block.append_op("clip_by_norm", {"X": g}, {"Out": g},
                            {"max_norm": self.clip_norm})
        return params_grads


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _clip(self, params_grads):
        if not params_grads:
            return params_grads
        helper = LayerHelper("global_norm_clip")
        block = params_grads[0][0].block.program.global_block()
        sq_sums = []
        for p, g in params_grads:
            sq = helper.create_variable_for_type_inference("float32", g.shape)
            block.append_op("square", {"X": g}, {"Out": sq})
            ssum = helper.create_variable_for_type_inference("float32", ())
            block.append_op("reduce_sum", {"X": sq}, {"Out": ssum},
                            {"reduce_all": True, "dim": [0], "keep_dim": False})
            sq_sums.append(ssum)
        total = helper.create_variable_for_type_inference("float32", ())
        block.append_op("sum", {"X": sq_sums}, {"Out": total})
        gnorm = helper.create_variable_for_type_inference("float32", ())
        block.append_op("sqrt", {"X": total}, {"Out": gnorm})
        # scale = clip_norm / max(gnorm, clip_norm)
        clip_c = helper.create_variable_for_type_inference("float32", ())
        block.append_op("fill_constant", {}, {"Out": clip_c},
                        {"shape": [], "dtype": "float32",
                         "value": self.clip_norm})
        denom = helper.create_variable_for_type_inference("float32", ())
        block.append_op("elementwise_max", {"X": gnorm, "Y": clip_c},
                        {"Out": denom}, {"axis": -1})
        factor = helper.create_variable_for_type_inference("float32", ())
        block.append_op("elementwise_div", {"X": clip_c, "Y": denom},
                        {"Out": factor}, {"axis": -1})
        for p, g in params_grads:
            block.append_op("elementwise_mul", {"X": g, "Y": factor},
                            {"Out": g}, {"axis": -1})
        return params_grads


_gradient_clip_attr = None


def set_gradient_clip(clip, param_list=None, program=None):
    """The clip that every later minimize() appends (process-global, as
    in fluid: set None to clear it), or with `param_list` the clip of
    those parameters only."""
    global _gradient_clip_attr
    _gradient_clip_attr = clip
    if param_list is not None:
        program = program or default_main_program()
        for p in param_list:
            name = p if isinstance(p, str) else p.name
            program.global_block().var(name).gradient_clip_attr = clip


def append_gradient_clip_ops(params_grads):
    # per-param attr wins, else the global clip
    global_clip = _gradient_clip_attr
    with_attr = []
    rest = []
    for p, g in params_grads:
        attr = getattr(p, "gradient_clip_attr", None)
        if attr is not None:
            with_attr.append((p, g, attr))
        else:
            rest.append((p, g))
    for p, g, attr in with_attr:
        attr._clip([(p, g)])
    if global_clip is not None and rest:
        global_clip._clip(rest)
    return params_grads
