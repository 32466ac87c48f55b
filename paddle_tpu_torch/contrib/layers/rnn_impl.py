"""Basic (composable) GRU / LSTM builders, their static half.

Parity: python/paddle/fluid/contrib/layers/rnn_impl.py's ``basic_gru``
and ``basic_lstm``; the counterpart of
``paddle_tpu/contrib/layers/rnn_impl.py`` without its dygraph units
(``BasicGRUUnit``, ``BasicLSTMUnit``), which wait for the port's
``dygraph/`` (ROADMAP item 11).

The reference unrolls the recurrence one timestep at a time with
``StaticRNN``. Here, as in the JAX package, each (layer, direction) is one
``basic_gru`` / ``basic_lstm`` op (ops/rnn_ops.py), its input projection
hoisted out of the time loop. Data stays batch-major inside;
``batch_first=False`` transposes at the boundary only. The JAX package's
two deliberate departures from the reference's code hold here too: the
GRU candidate reads ``r * h_prev`` (the documented math, where the
reference 1.5 code leaves the reset gate dead), and the unidirectional
time-major path transposes (the reference misspells the call).
"""

from ...core.layer_helper import LayerHelper
from ...layers.rnn import _suffixed
from ... import layers

__all__ = ["basic_gru", "basic_lstm"]


_KERNEL_ACTS = ("sigmoid", "tanh", "relu", "identity")


def _act_name(act, default):
    """Reference accepts activation callables; the kernel takes names.
    Validate at build time — an unknown name would otherwise surface as a
    bare KeyError deep in the kernel at exe.run."""
    if act is None:
        return default
    name = act if isinstance(act, str) else getattr(act, "__name__", str(act))
    if name not in _KERNEL_ACTS:
        raise ValueError(
            f"basic_gru/basic_lstm: unsupported activation {name!r}; "
            f"supported: {_KERNEL_ACTS}")
    return name


def _stack_lasts(lasts, num_layers, hidden_size):
    # list of per-layer (B, H) -> (num_layers, B, H), reference's
    # concat-then-reshape (rnn_impl.py:311-315)
    out = layers.concat(lasts, axis=0)
    return layers.reshape(out, [num_layers, -1, hidden_size])


def _init_state_slice(state, layer_i, direc, hidden_size):
    # (L, D, B, H) -> (B, H) for one (layer, direction)
    s = layers.slice(state, axes=[0, 1], starts=[layer_i, direc],
                     ends=[layer_i + 1, direc + 1])
    return layers.reshape(s, [-1, hidden_size])


def basic_gru(input, init_hidden, hidden_size, num_layers=1,
              sequence_length=None, dropout_prob=0.0, bidirectional=False,
              batch_first=True, param_attr=None, bias_attr=None,
              gate_activation=None, activation=None, dtype="float32",
              name="basic_gru"):
    """Multi-layer (optionally bidirectional) GRU from basic operators.

    Parity: contrib/layers/rnn_impl.py:139-351. Returns (rnn_out,
    last_hidden); last_hidden is (num_layers*D, B, H) with fw/bw
    interleaved per layer exactly like the reference's axis-1 concat +
    reshape (rnn_impl.py:333-337). Dropout applies after EVERY layer
    (including the top, so rnn_out sees it; last_hidden does not —
    rnn_impl.py:295-301).
    """
    helper = LayerHelper(name or "basic_gru", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    if not batch_first:
        input = layers.transpose(input, [1, 0, 2])
    direc_num = 2 if bidirectional else 1
    if init_hidden is not None:
        init_hidden = layers.reshape(
            init_hidden, [num_layers, direc_num, -1, hidden_size])
    act_g = _act_name(gate_activation, "sigmoid")
    act_c = _act_name(activation, "tanh")

    def run_direction(direc):
        cur, lasts = input, []
        for i in range(num_layers):
            sfx = ("_reverse" if direc else "") + f"_layers_{i}"
            # intermediate hiddens carry no static shape; width is known
            d = int(input.shape[-1]) if i == 0 else hidden_size
            gate_w = helper.create_parameter(
                _suffixed(helper.param_attr, "gate_w" + sfx),
                [d + hidden_size, 2 * hidden_size], dtype)
            gate_b = helper.create_parameter(
                _suffixed(helper.bias_attr, "gate_b" + sfx),
                [2 * hidden_size], dtype, is_bias=True)
            cand_w = helper.create_parameter(
                _suffixed(helper.param_attr, "cand_w" + sfx),
                [d + hidden_size, hidden_size], dtype)
            cand_b = helper.create_parameter(
                _suffixed(helper.bias_attr, "cand_b" + sfx),
                [hidden_size], dtype, is_bias=True)
            ins = {"Input": cur, "GateW": gate_w, "GateB": gate_b,
                   "CandW": cand_w, "CandB": cand_b}
            if init_hidden is not None:
                ins["H0"] = _init_state_slice(init_hidden, i, direc,
                                              hidden_size)
            if sequence_length is not None:
                ins["Length"] = sequence_length
            # annotate static output shapes so downstream layers (incl.
            # another basic_gru/basic_lstm chained on this output) can
            # size their parameters
            in_shape = tuple(input.shape)
            hid_shape = ((in_shape[0], in_shape[1], hidden_size)
                         if len(in_shape) == 3 else None)
            last_shape = ((in_shape[0], hidden_size)
                          if len(in_shape) == 3 else None)
            hid = helper.create_variable_for_type_inference(dtype, hid_shape)
            last = helper.create_variable_for_type_inference(dtype,
                                                             last_shape)
            helper.append_op("basic_gru", ins,
                             {"Hidden": hid, "LastH": last},
                             {"gate_activation": act_g, "activation": act_c,
                              "is_reverse": bool(direc)})
            lasts.append(last)
            cur = hid
            if dropout_prob is not None and dropout_prob > 0.0:
                cur = layers.dropout(cur, dropout_prob)
        return cur, _stack_lasts(lasts, num_layers, hidden_size)

    fw_out, fw_last = run_direction(0)
    if bidirectional:
        bw_out, bw_last = run_direction(1)
        rnn_out = layers.concat([fw_out, bw_out], axis=2)
        last_hidden = layers.reshape(
            layers.concat([fw_last, bw_last], axis=1),
            [num_layers * direc_num, -1, hidden_size])
    else:
        rnn_out, last_hidden = fw_out, fw_last
    if not batch_first:
        rnn_out = layers.transpose(rnn_out, [1, 0, 2])
    return rnn_out, last_hidden


def basic_lstm(input, init_hidden, init_cell, hidden_size, num_layers=1,
               sequence_length=None, dropout_prob=0.0, bidirectional=False,
               batch_first=True, param_attr=None, bias_attr=None,
               gate_activation=None, activation=None, forget_bias=1.0,
               dtype="float32", name="basic_lstm"):
    """Multi-layer (optionally bidirectional) LSTM from basic operators.

    Parity: contrib/layers/rnn_impl.py:353-619. Returns (rnn_out,
    last_hidden, last_cell). LSTM inter-layer dropout uses
    upscale_in_train (rnn_impl.py:566-570), unlike the GRU path which
    keeps the fluid default.
    """
    helper = LayerHelper(name or "basic_lstm", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    if not batch_first:
        input = layers.transpose(input, [1, 0, 2])
    direc_num = 2 if bidirectional else 1
    if init_hidden is not None:
        init_hidden = layers.reshape(
            init_hidden, [num_layers, direc_num, -1, hidden_size])
    if init_cell is not None:
        init_cell = layers.reshape(
            init_cell, [num_layers, direc_num, -1, hidden_size])
    act_g = _act_name(gate_activation, "sigmoid")
    act_c = _act_name(activation, "tanh")

    def run_direction(direc):
        cur, lasts_h, lasts_c = input, [], []
        for i in range(num_layers):
            sfx = ("_reverse" if direc else "") + f"_layers_{i}"
            d = int(input.shape[-1]) if i == 0 else hidden_size
            w = helper.create_parameter(
                _suffixed(helper.param_attr, "w" + sfx),
                [d + hidden_size, 4 * hidden_size], dtype)
            b = helper.create_parameter(
                _suffixed(helper.bias_attr, "b" + sfx),
                [4 * hidden_size], dtype, is_bias=True)
            ins = {"Input": cur, "Weight": w, "Bias": b}
            if init_hidden is not None:
                ins["H0"] = _init_state_slice(init_hidden, i, direc,
                                              hidden_size)
            if init_cell is not None:
                ins["C0"] = _init_state_slice(init_cell, i, direc,
                                              hidden_size)
            if sequence_length is not None:
                ins["Length"] = sequence_length
            in_shape = tuple(input.shape)
            hid_shape = ((in_shape[0], in_shape[1], hidden_size)
                         if len(in_shape) == 3 else None)
            last_shape = ((in_shape[0], hidden_size)
                          if len(in_shape) == 3 else None)
            hid = helper.create_variable_for_type_inference(dtype, hid_shape)
            last_h = helper.create_variable_for_type_inference(dtype,
                                                               last_shape)
            last_c = helper.create_variable_for_type_inference(dtype,
                                                               last_shape)
            helper.append_op("basic_lstm", ins,
                             {"Hidden": hid, "LastH": last_h,
                              "LastC": last_c},
                             {"gate_activation": act_g, "activation": act_c,
                              "forget_bias": float(forget_bias),
                              "is_reverse": bool(direc)})
            lasts_h.append(last_h)
            lasts_c.append(last_c)
            cur = hid
            if dropout_prob is not None and dropout_prob > 0.0:
                cur = layers.dropout(
                    cur, dropout_prob,
                    dropout_implementation="upscale_in_train")
        return (cur, _stack_lasts(lasts_h, num_layers, hidden_size),
                _stack_lasts(lasts_c, num_layers, hidden_size))

    fw_out, fw_lh, fw_lc = run_direction(0)
    if bidirectional:
        bw_out, bw_lh, bw_lc = run_direction(1)
        rnn_out = layers.concat([fw_out, bw_out], axis=2)
        last_hidden = layers.reshape(
            layers.concat([fw_lh, bw_lh], axis=1),
            [num_layers * direc_num, -1, hidden_size])
        last_cell = layers.reshape(
            layers.concat([fw_lc, bw_lc], axis=1),
            [num_layers * direc_num, -1, hidden_size])
    else:
        rnn_out, last_hidden, last_cell = fw_out, fw_lh, fw_lc
    if not batch_first:
        rnn_out = layers.transpose(rnn_out, [1, 0, 2])
    return rnn_out, last_hidden, last_cell
