"""Activation / simple unary layers and the random layers.

Parity: python/paddle/fluid/layers/ops.py (layer_function_generator-
produced wrappers around activation_op.cc kernels); the counterpart of
``paddle_tpu/layers/ops.py``, every layer of it: the unary activations
(``_UNARY``), the activations with attributes (``elu``, ``relu6``,
``pow``, ``stanh``, ``hard_sigmoid``, ``swish``, ``hard_swish``,
``thresholded_relu``, ``hard_shrink``, ``softshrink``, ``soft_relu``,
``brelu``), ``uniform_random``, ``gaussian_random`` and their
``*_batch_size_like`` forms, ``sampling_id``, ``random_crop`` and
``cumsum``. (``relu`` is in ``nn.py``, as in the JAX package.)
"""

from ..core.layer_helper import LayerHelper

_UNARY = [
    "sigmoid", "logsigmoid", "exp", "tanh", "tanh_shrink", "softplus",
    "softsign", "sqrt", "rsqrt", "abs", "ceil", "floor", "cos", "sin",
    "round", "reciprocal", "square", "acos", "asin", "atan", "gelu", "erf",
    "log_softmax", "selu", "log", "mish",
]


def _make_unary(op_type):
    def fn(x, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype, x.shape)
        helper.append_op(op_type, {"X": x}, {"Out": out})
        return out
    fn.__name__ = op_type
    fn.__doc__ = f"Parity: fluid.layers.{op_type} (activation_op.cc)."
    return fn


for _name in _UNARY:
    globals()[_name] = _make_unary(_name)


def _make_attr_unary(op_type, attr_names_defaults):
    def fn(x, *args, **kwargs):
        attrs = dict(attr_names_defaults)
        for (k, _), v in zip(attr_names_defaults.items(), args):
            attrs[k] = v
        for k, v in kwargs.items():
            if k in attrs:
                attrs[k] = v
        helper = LayerHelper(op_type, name=kwargs.get("name"))
        out = helper.create_variable_for_type_inference(x.dtype, x.shape)
        helper.append_op(op_type, {"X": x}, {"Out": out}, attrs)
        return out
    fn.__name__ = op_type
    return fn


elu = _make_attr_unary("elu", {"alpha": 1.0})
relu6 = _make_attr_unary("relu6", {"threshold": 6.0})
pow = _make_attr_unary("pow", {"factor": 1.0})
stanh = _make_attr_unary("stanh", {"scale_a": 0.67, "scale_b": 1.7159})
hard_sigmoid = _make_attr_unary("hard_sigmoid", {"slope": 0.2, "offset": 0.5})
swish = _make_attr_unary("swish", {"beta": 1.0})
hard_swish = _make_attr_unary("hard_swish", {"threshold": 6.0, "scale": 6.0,
                                             "offset": 3.0})
thresholded_relu = _make_attr_unary("thresholded_relu", {"threshold": 1.0})
hard_shrink = _make_attr_unary("hard_shrink", {"threshold": 0.5})
softshrink = _make_attr_unary("softshrink", {"lambda": 0.5})
soft_relu = _make_attr_unary("soft_relu", {"threshold": 40.0})
brelu = _make_attr_unary("brelu", {"t_min": 0.0, "t_max": 24.0})


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random")
    out = helper.create_variable_for_type_inference(dtype, tuple(shape))
    helper.append_op("uniform_random", {}, {"Out": out},
                     {"shape": list(shape), "dtype": dtype, "min": float(min),
                      "max": float(max), "op_seed": helper.next_op_seed()})
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random")
    out = helper.create_variable_for_type_inference(dtype, tuple(shape))
    helper.append_op("gaussian_random", {}, {"Out": out},
                     {"shape": list(shape), "dtype": dtype,
                      "mean": float(mean), "std": float(std),
                      "op_seed": helper.next_op_seed()})
    return out


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0,
                                    output_dim_idx=0, mean=0.0, std=1.0,
                                    seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype, tuple(shape))
    helper.append_op("gaussian_random_batch_size_like", {"Input": input},
                     {"Out": out},
                     {"shape": list(shape), "input_dim_idx": input_dim_idx,
                      "output_dim_idx": output_dim_idx, "mean": float(mean),
                      "std": float(std), "op_seed": helper.next_op_seed()})
    return out


def uniform_random_batch_size_like(input, shape, dtype="float32",
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype, tuple(shape))
    helper.append_op("uniform_random", {"Input": input}, {"Out": out},
                     {"shape": list(shape), "input_dim_idx": input_dim_idx,
                      "output_dim_idx": output_dim_idx, "min": float(min),
                      "max": float(max), "op_seed": helper.next_op_seed()})
    return out


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("sampling_id")
    out = helper.create_variable_for_type_inference("int64", (x.shape[0],))
    helper.append_op("sampling_id", {"X": x}, {"Out": out},
                     {"op_seed": helper.next_op_seed()})
    return out


def random_crop(x, shape, seed=None):
    helper = LayerHelper("random_crop")
    out_shape = tuple(x.shape[:x.ndim - len(shape)]) + tuple(shape)
    out = helper.create_variable_for_type_inference(x.dtype, out_shape)
    helper.append_op("random_crop", {"X": x}, {"Out": out},
                     {"shape": list(shape), "op_seed": helper.next_op_seed()})
    return out


def cumsum(x, axis=None, exclusive=None, reverse=None):
    from .nn import cumsum as _cumsum
    return _cumsum(x, axis, exclusive, reverse)


__all__ = _UNARY + [
    "elu", "relu6", "pow", "stanh", "hard_sigmoid", "swish", "hard_swish",
    "thresholded_relu", "hard_shrink", "softshrink", "soft_relu", "brelu",
    "uniform_random", "gaussian_random", "gaussian_random_batch_size_like",
    "uniform_random_batch_size_like", "sampling_id", "random_crop",
    "cumsum"]
