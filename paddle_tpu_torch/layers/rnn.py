"""Recurrent layers.

Parity: python/paddle/fluid/layers/nn.py dynamic_lstm / dynamic_gru /
lstm / gru_unit / lstm_unit / dynamic_lstmp and the cuDNN-backed
fluid.layers.lstm; the counterpart of ``paddle_tpu/layers/rnn.py``, all
of it, with its parameter names (``_suffixed``'s ``_wx`` / ``_wh`` /
``_wp``), so that a JAX scope carries over by name.

Ragged inputs follow the JAX package's convention: ``(batch, max_len,
...)`` padded data and an optional lengths tensor in place of LoD
offsets; the ops (ops/rnn_ops.py) hoist the input projection out of a
loop over the padded T.
"""

import copy

from ..core.layer_helper import LayerHelper

__all__ = ["dynamic_lstm", "dynamic_gru", "lstm", "gru", "lstm_unit",
           "gru_unit", "dynamic_lstmp"]


def _suffixed(attr, nm):
    """A named ParamAttr must not collapse WeightX/WeightH onto one name."""
    if attr is False or attr is None or getattr(attr, "name", None) is None:
        return attr
    a = copy.copy(attr)
    a.name = f"{attr.name}_{nm}"
    return a


def dynamic_lstm(input, size, length=None, h_0=None, c_0=None,
                 param_attr=None, bias_attr=None, use_peepholes=True,
                 is_reverse=False, gate_activation="sigmoid",
                 cell_activation="tanh", candidate_activation="tanh",
                 dtype="float32", name=None):
    """Parity: fluid.layers.dynamic_lstm (ref layers/nn.py:dynamic_lstm).

    input: (B, T, D). size = 4 * hidden (fluid convention). Unlike the
    reference (which takes pre-projected input from an fc), this takes raw
    input and owns both weights: WeightX (D, 4H) and WeightH (H, 4H), the
    input projection hoisted out of the time loop as one product.
    Returns (hidden (B, T, H), cell (B, T, H)).
    """
    helper = LayerHelper("dynamic_lstm", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    hidden = size // 4
    d = input.shape[-1]
    w_x = helper.create_parameter(_suffixed(helper.param_attr, "wx"),
                                  [d, 4 * hidden], dtype)
    w_h = helper.create_parameter(_suffixed(helper.param_attr, "wh"),
                                  [hidden, 4 * hidden], dtype)
    bias_len = 7 * hidden if use_peepholes else 4 * hidden
    bias = helper.create_parameter(helper.bias_attr, [bias_len], dtype,
                                   is_bias=True)
    hs = helper.create_variable_for_type_inference(
        dtype, tuple(input.shape[:2]) + (hidden,))
    cs = helper.create_variable_for_type_inference(
        dtype, tuple(input.shape[:2]) + (hidden,))
    h_last = helper.create_variable_for_type_inference(
        dtype, (input.shape[0], hidden))
    c_last = helper.create_variable_for_type_inference(
        dtype, (input.shape[0], hidden))
    inputs = {"Input": input, "WeightX": w_x, "WeightH": w_h, "Bias": bias}
    if length is not None:
        inputs["Length"] = length
    if h_0 is not None:
        inputs["H0"] = h_0
    if c_0 is not None:
        inputs["C0"] = c_0
    helper.append_op("lstm", inputs,
                     {"Hidden": hs, "Cell": cs, "LastH": h_last,
                      "LastC": c_last},
                     {"use_peepholes": use_peepholes,
                      "is_reverse": is_reverse})
    return hs, cs


def lstm(input, init_h=None, init_c=None, max_len=None, hidden_size=None,
         num_layers=1, length=None, dropout_prob=0.0, is_bidirec=False,
         is_test=False, param_attr=None, bias_attr=None, dtype="float32",
         name=None):
    """Parity: fluid.layers.lstm (the cuDNN multi-layer LSTM). Stacked
    (optionally bidirectional) scan LSTMs. Returns (out, last_h, last_c)
    with out (B, T, H * num_directions)."""
    from . import nn as nn_layers
    from .sequence import sequence_last_step, sequence_first_step
    x = input
    for layer in range(num_layers):
        lp = _suffixed(param_attr, f"l{layer}")
        lb = _suffixed(bias_attr, f"l{layer}")
        fwd, fwd_c = dynamic_lstm(x, 4 * hidden_size, length=length,
                                  use_peepholes=False, param_attr=lp,
                                  bias_attr=lb, dtype=dtype)
        if is_bidirec:
            bwd, bwd_c = dynamic_lstm(x, 4 * hidden_size, length=length,
                                      use_peepholes=False, is_reverse=True,
                                      param_attr=_suffixed(lp, "rev"),
                                      bias_attr=_suffixed(lb, "rev"),
                                      dtype=dtype)
            x = nn_layers.concat([fwd, bwd], axis=-1)
        else:
            x = fwd
        if dropout_prob and not is_test and layer < num_layers - 1:
            x = nn_layers.dropout(x, dropout_prob)
    # Final states from the LAST layer. A reversed LSTM's sequence output is
    # stored in input order, so its final state sits at t=0.
    if is_bidirec:
        last_h = nn_layers.concat(
            [sequence_last_step(fwd, length=length),
             sequence_first_step(bwd, length=length)], axis=-1)
        last_c = nn_layers.concat(
            [sequence_last_step(fwd_c, length=length),
             sequence_first_step(bwd_c, length=length)], axis=-1)
    else:
        last_h = sequence_last_step(fwd, length=length)
        last_c = sequence_last_step(fwd_c, length=length)
    return x, last_h, last_c


def dynamic_gru(input, size, length=None, h_0=None, param_attr=None,
                bias_attr=None, is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", origin_mode=False,
                dtype="float32", name=None):
    """Parity: fluid.layers.dynamic_gru. input (B, T, D); size = hidden.
    Owns WeightX (D, 3H) + WeightH (H, 3H); returns hidden (B, T, H)."""
    helper = LayerHelper("dynamic_gru", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    d = input.shape[-1]
    w_x = helper.create_parameter(_suffixed(helper.param_attr, "wx"),
                                  [d, 3 * size], dtype)
    w_h = helper.create_parameter(_suffixed(helper.param_attr, "wh"),
                                  [size, 3 * size], dtype)
    bias = helper.create_parameter(helper.bias_attr, [3 * size], dtype,
                                   is_bias=True)
    hs = helper.create_variable_for_type_inference(
        dtype, tuple(input.shape[:2]) + (size,))
    h_last = helper.create_variable_for_type_inference(
        dtype, (input.shape[0], size))
    inputs = {"Input": input, "WeightX": w_x, "WeightH": w_h, "Bias": bias}
    if length is not None:
        inputs["Length"] = length
    if h_0 is not None:
        inputs["H0"] = h_0
    helper.append_op("gru", inputs, {"Hidden": hs, "LastH": h_last},
                     {"is_reverse": is_reverse,
                      "origin_mode": origin_mode})
    return hs


gru = dynamic_gru


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """Parity: fluid.layers.lstm_unit — one step; projects [x, h_prev] to
    4H gates with an fc then applies the cell. Returns (hidden, cell)."""
    from . import nn as nn_layers
    helper = LayerHelper("lstm_unit", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    size = cell_t_prev.shape[-1]
    concat = nn_layers.concat([x_t, hidden_t_prev], axis=-1)
    gates = nn_layers.fc(concat, 4 * size, param_attr=param_attr,
                         bias_attr=bias_attr)
    h = helper.create_variable_for_type_inference(x_t.dtype,
                                                  (x_t.shape[0], size))
    c = helper.create_variable_for_type_inference(x_t.dtype,
                                                  (x_t.shape[0], size))
    helper.append_op("lstm_unit", {"X": gates, "C_prev": cell_t_prev},
                     {"Hidden": h, "Cell": c},
                     {"forget_bias": float(forget_bias)})
    return h, c


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid",
             origin_mode=False, name=None):
    """Parity: fluid.layers.gru_unit — one step. input (B, 3H) is the
    pre-projected x (fluid convention: caller fc's x to 3H); size = 3 * H.
    Returns (hidden, reset_hidden_prev, gate).

    Documented divergence: the reference ACCEPTS origin_mode here but
    silently drops it (only dynamic_gru forwards it, nn.py:1260); we
    honor the flag — passing True gives the original-paper blend
    instead of reproducing the reference's silent-drop quirk."""
    helper = LayerHelper("gru_unit", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    h_size = size // 3
    w = helper.create_parameter(helper.param_attr, [h_size, 3 * h_size],
                                input.dtype)
    bias = helper.create_parameter(helper.bias_attr, [3 * h_size],
                                   input.dtype, is_bias=True)
    h = helper.create_variable_for_type_inference(input.dtype,
                                                  (input.shape[0], h_size))
    gate = helper.create_variable_for_type_inference(
        input.dtype, (input.shape[0], 3 * h_size))
    rhp = helper.create_variable_for_type_inference(
        input.dtype, (input.shape[0], h_size))
    inputs = {"Input": input, "HiddenPrev": hidden, "Weight": w}
    if bias is not None:
        inputs["Bias"] = bias
    helper.append_op("gru_unit", inputs,
                     {"Hidden": h, "Gate": gate, "ResetHiddenPrev": rhp},
                     {"origin_mode": origin_mode})
    return h, rhp, gate


def dynamic_lstmp(input, size, proj_size, length=None, h_0=None, c_0=None,
                  param_attr=None, bias_attr=None, use_peepholes=True,
                  is_reverse=False, gate_activation="sigmoid",
                  cell_activation="tanh", candidate_activation="tanh",
                  proj_activation="tanh", dtype="float32", name=None):
    """Parity: fluid.layers.dynamic_lstmp — LSTM with recurrent
    projection. size = 4 * hidden. Returns (projection (B, T, P),
    cell (B, T, H))."""
    helper = LayerHelper("dynamic_lstmp", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    hidden = size // 4
    d = input.shape[-1]
    w_x = helper.create_parameter(_suffixed(helper.param_attr, "wx"),
                                  [d, 4 * hidden], dtype)
    w_h = helper.create_parameter(_suffixed(helper.param_attr, "wh"),
                                  [proj_size, 4 * hidden], dtype)
    w_p = helper.create_parameter(_suffixed(helper.param_attr, "wp"),
                                  [hidden, proj_size], dtype)
    bias_len = 7 * hidden if use_peepholes else 4 * hidden
    bias = helper.create_parameter(helper.bias_attr, [bias_len], dtype,
                                   is_bias=True)
    proj = helper.create_variable_for_type_inference(
        dtype, tuple(input.shape[:2]) + (proj_size,))
    cell = helper.create_variable_for_type_inference(
        dtype, tuple(input.shape[:2]) + (hidden,))
    r_last = helper.create_variable_for_type_inference(
        dtype, (input.shape[0], proj_size))
    c_last = helper.create_variable_for_type_inference(
        dtype, (input.shape[0], hidden))
    inputs = {"Input": input, "WeightX": w_x, "WeightH": w_h,
              "ProjWeight": w_p, "Bias": bias}
    if length is not None:
        inputs["Length"] = length
    if h_0 is not None:
        inputs["H0"] = h_0
    if c_0 is not None:
        inputs["C0"] = c_0
    helper.append_op("lstmp", inputs,
                     {"Projection": proj, "Cell": cell, "LastH": r_last,
                      "LastC": c_last},
                     {"use_peepholes": use_peepholes,
                      "is_reverse": is_reverse,
                      "gate_activation": gate_activation,
                      "cell_activation": cell_activation,
                      "candidate_activation": candidate_activation,
                      "proj_activation": proj_activation})
    return proj, cell
