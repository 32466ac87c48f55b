"""LayerHelper: shared machinery for all fluid-style layer functions.

Parity: python/paddle/fluid/layer_helper.py + layer_helper_base.py; a copy
of ``paddle_tpu/core/layer_helper.py`` without its dygraph branches
(dygraph is not ported). Creates parameters (appending their init ops to
the startup program), temp variables, and appends ops to the current block
of the default main program.
"""

from . import unique_name
from .framework import default_main_program
from .param_attr import ParamAttr
from .. import initializer as init_mod


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name if name is not None else unique_name.generate(layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def block(self):
        return self.main_program.current_block()

    # -- params -------------------------------------------------------------
    @property
    def param_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        attr = self.kwargs.get("bias_attr")
        if attr is False:
            return False
        return ParamAttr._to_attr(attr)

    def create_parameter(self, attr, shape, dtype="float32", is_bias=False,
                         default_initializer=None):
        if attr is False:
            return None
        attr = ParamAttr._to_attr(attr)
        if default_initializer is None:
            default_initializer = (init_mod._global_bias_initializer() if is_bias
                                   else init_mod._global_weight_initializer())
        attr._with_initializer(default_initializer)
        name = attr.name if attr.name else unique_name.generate(
            ".".join([self.name, "b" if is_bias else "w"]))
        param = self.block.create_parameter(
            name=name, shape=shape, dtype=dtype, trainable=attr.trainable,
            optimize_attr={"learning_rate": attr.learning_rate},
            regularizer=attr.regularizer,
            gradient_clip_attr=attr.gradient_clip,
            do_model_average=attr.do_model_average)
        # init op goes to the startup program
        attr.initializer(param)
        return param

    # -- vars ---------------------------------------------------------------
    def create_variable_for_type_inference(self, dtype="float32", shape=None):
        return self.block.create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype, shape=shape or ())

    def create_variable(self, **kwargs):
        return self.block.create_var(**kwargs)

    def create_global_variable(self, persistable=False, **kwargs):
        return self.main_program.global_block().create_var(
            persistable=persistable, **kwargs)

    def create_or_get_global_variable(self, name, **kwargs):
        gb = self.main_program.global_block()
        if name in gb.vars:
            return gb.vars[name]
        return gb.create_var(name=name, **kwargs)

    # -- ops ----------------------------------------------------------------
    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        return self.block.append_op(type, inputs, outputs, attrs)

    def append_activation(self, out_var):
        act = self.kwargs.get("act")
        if act is None:
            return out_var
        if isinstance(act, str):
            act = {"type": act}
        act_type = act.pop("type")
        tmp = self.create_variable_for_type_inference(out_var.dtype,
                                                      out_var.shape)
        self.append_op(act_type, inputs={"X": [out_var]},
                       outputs={"Out": [tmp]}, attrs=act)
        return tmp

    def next_op_seed(self):
        return self.main_program.next_op_seed()
