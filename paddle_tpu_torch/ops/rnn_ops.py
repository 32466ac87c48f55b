"""Recurrent ops: LSTM / GRU cells and full sequences.

Parity: paddle/fluid/operators/lstm_op.cc, gru_op.cc, lstm_unit_op.cc,
gru_unit_op.cc, lstmp_op.cc and contrib's rnn_impl.py; the counterpart of
``paddle_tpu/ops/rnn_ops.py``: ``lstm``, ``gru``, ``lstm_unit``,
``gru_unit``, ``lstmp``, ``basic_gru`` and ``basic_lstm``.

The JAX package runs each full-sequence op as one ``lax.scan``. Here the
input projection is hoisted out of the time loop as one product
(B*T, D) x (D, 4H), and a Python loop over the padded T does one
(B, H) x (H, 4H) product and the gates at each step; autograd gives the
backward. No hand-written kernel stands behind them, as no Pallas kernel
stands behind the JAX scan.

The recurrences copy the JAX package's:

- the LSTM gate order is i, f, c, o (``_lstm_scan``), so weights carried
  over by name need no permutation; ``basic_lstm`` maps contrib's
  (i, j, f, o) onto it and adds ``forget_bias`` (1.0) to the f bias;
- the GRU's ``origin_mode`` picks the blend u h + (1 - u) c (True) or
  (1 - u) h + u c (False, the default);
- a 7H LSTM bias carries the peephole weights in its 3H tail;
- a step past a row's length carries the state through with the
  arithmetic blend ``m * new + (1 - m) * prev``, so a padded position's
  Hidden is the carried state, not 0 (and a padded step that overflows
  gives what the blend gives, as in JAX);
- ``is_reverse`` walks the whole padded T backwards, which reaches each
  row's own end with the initial state.

Under data parallelism every op here runs a rank's rows (the weights
replicated, the data, its lengths and initial states sharded).
"""

import torch

from . import register
from .sequence_ops import rows_with

_ROWS = rows_with("Input", "Length", "H0", "C0")

_ACTS = {"sigmoid": torch.sigmoid, "tanh": torch.tanh,
         "relu": torch.relu, "identity": lambda v: v}


def _step_masks(lengths, t, dtype):
    """(T, B, 1) 1/0: step s is inside row b's length (None: no
    lengths)."""
    if lengths is None:
        return None
    steps = torch.arange(t, device=lengths.device)[:, None]
    return (steps < lengths.reshape(1, -1)).to(dtype)[..., None]


def _order(t, reverse):
    return range(t - 1, -1, -1) if reverse else range(t)


def _lstm_scan(xw, h0, c0, w_h, bias, lengths, w_peep=None,
               gate_act=torch.sigmoid, cell_act=torch.tanh,
               cand_act=torch.tanh, reverse=False):
    """The LSTM recurrence over xw (B, T, 4H), the pre-projected inputs,
    gate order i, f, c, o. Returns (hs, cs (B, T, H), h_last, c_last)."""
    t = xw.shape[1]
    h = xw.shape[2] // 4
    if bias is not None:
        xw = xw + bias[: 4 * h]
    xs = xw.transpose(0, 1)
    masks = _step_masks(lengths, t, xw.dtype)
    if w_peep is not None:
        wi, wf, wo = torch.chunk(w_peep, 3)
    hs, cs = [None] * t, [None] * t
    h_prev, c_prev = h0, c0
    for s in _order(t, reverse):
        gates = xs[s] + h_prev @ w_h
        i, f, c_hat, o = torch.chunk(gates, 4, dim=-1)
        if w_peep is not None:
            i = i + c_prev * wi
            f = f + c_prev * wf
        i, f = gate_act(i), gate_act(f)
        c_new = f * c_prev + i * cand_act(c_hat)
        if w_peep is not None:
            o = o + c_new * wo
        h_new = gate_act(o) * cell_act(c_new)
        if masks is not None:
            m = masks[s]
            h_new = m * h_new + (1 - m) * h_prev
            c_new = m * c_new + (1 - m) * c_prev
        hs[s], cs[s] = h_new, c_new
        h_prev, c_prev = h_new, c_new
    return torch.stack(hs, 1), torch.stack(cs, 1), h_prev, c_prev


def _state(ctx, slot, b, width, like):
    s = ctx.in_(slot)
    return like.new_zeros((b, width)) if s is None else s


@register("lstm", dp=_ROWS)
def lstm(ctx):
    """Full-sequence (possibly ragged) LSTM.

    Inputs: Input (B, T, D), WeightX (D, 4H), WeightH (H, 4H), Bias (4H,)
    [+ peephole tail (3H,)], optional H0/C0 (B, H), optional Length (B,).
    Outputs: Hidden (B, T, H), Cell (B, T, H), LastH, LastC."""
    x = ctx.in_("Input")
    w_h = ctx.in_("WeightH")
    bias = ctx.in_("Bias")
    h = w_h.shape[0]
    w_peep = None
    if bias is not None and ctx.attr("use_peepholes", False) and \
            bias.shape[0] == 7 * h:
        bias, w_peep = bias[: 4 * h], bias[4 * h:]
    b = x.shape[0]
    hs, cs, h_last, c_last = _lstm_scan(
        x @ ctx.in_("WeightX"), _state(ctx, "H0", b, h, x),
        _state(ctx, "C0", b, h, x), w_h, bias, ctx.in_("Length"),
        w_peep=w_peep, reverse=bool(ctx.attr("is_reverse", False)))
    return {"Hidden": hs, "Cell": cs, "LastH": h_last, "LastC": c_last}


@register("gru", dp=_ROWS)
def gru(ctx):
    """Full-sequence GRU, gate order update u, reset r, candidate c; the
    candidate reads (r * h_prev) @ W_c. origin_mode False (the default):
    h = (1 - u) h_prev + u c; True: h = u h_prev + (1 - u) c.

    Inputs: Input (B, T, D), WeightX (D, 3H), WeightH (H, 3H), Bias (3H,),
    optional H0 (B, H), Length (B,). Outputs: Hidden (B, T, H), LastH."""
    x = ctx.in_("Input")
    w_h = ctx.in_("WeightH")
    bias = ctx.in_("Bias")
    h = w_h.shape[0]
    b, t = x.shape[0], x.shape[1]
    xw = x @ ctx.in_("WeightX")
    if bias is not None:
        xw = xw + bias
    w_h_gates, w_h_cand = w_h[:, : 2 * h], w_h[:, 2 * h:]
    xs = xw.transpose(0, 1)
    masks = _step_masks(ctx.in_("Length"), t, xw.dtype)
    origin_mode = bool(ctx.attr("origin_mode", False))
    hs = [None] * t
    h_prev = _state(ctx, "H0", b, h, x)
    for s in _order(t, bool(ctx.attr("is_reverse", False))):
        x_t = xs[s]
        ur = torch.sigmoid(x_t[:, : 2 * h] + h_prev @ w_h_gates)
        u, r = ur[:, :h], ur[:, h:]
        c = torch.tanh(x_t[:, 2 * h:] + (r * h_prev) @ w_h_cand)
        h_new = (u * h_prev + (1 - u) * c) if origin_mode \
            else ((1 - u) * h_prev + u * c)
        if masks is not None:
            m = masks[s]
            h_new = m * h_new + (1 - m) * h_prev
        hs[s] = h_prev = h_new
    return {"Hidden": torch.stack(hs, 1), "LastH": h_prev}


@register("lstm_unit", dp=rows_with("X", "C_prev"))
def lstm_unit(ctx):
    """One LSTM step. X (B, 4H) are the pre-projected gates (x Wx + h Wh,
    done by the caller's fc), C_prev (B, H)."""
    c_prev = ctx.in_("C_prev")
    i, f, c_hat, o = torch.chunk(ctx.in_("X"), 4, dim=-1)
    i = torch.sigmoid(i)
    f = torch.sigmoid(f + ctx.attr("forget_bias", 0.0))
    o = torch.sigmoid(o)
    c = f * c_prev + i * torch.tanh(c_hat)
    return {"Hidden": o * torch.tanh(c), "Cell": c}


@register("gru_unit", dp=rows_with("Input", "HiddenPrev"))
def gru_unit(ctx):
    """One GRU step. Input (B, 3H) = x Wx (+ Bias), HiddenPrev (B, H),
    Weight (H, 3H). Outputs Hidden, Gate (u, r, c) and ResetHiddenPrev
    (r * h_prev)."""
    x = ctx.in_("Input")
    h_prev = ctx.in_("HiddenPrev")
    w = ctx.in_("Weight")
    bias = ctx.in_("Bias")
    if bias is not None:
        x = x + bias
    h = h_prev.shape[-1]
    ur = torch.sigmoid(x[:, : 2 * h] + h_prev @ w[:, : 2 * h])
    u, r = ur[:, :h], ur[:, h:]
    c = torch.tanh(x[:, 2 * h:] + (r * h_prev) @ w[:, 2 * h:])
    if bool(ctx.attr("origin_mode", False)):
        h_new = u * h_prev + (1 - u) * c
    else:
        h_new = (1 - u) * h_prev + u * c
    return {"Hidden": h_new, "Gate": torch.cat([ur, c], -1),
            "ResetHiddenPrev": r * h_prev}


@register("lstmp", dp=_ROWS)
def lstmp(ctx):
    """LSTM with a recurrent projection: the recurrent state is
    r_t = proj_act(h_t @ ProjWeight) (B, P), and WeightH is (P, 4H).
    Outputs Projection (B, T, P), Cell (B, T, H), LastH, LastC."""
    x = ctx.in_("Input")
    w_h = ctx.in_("WeightH")
    w_proj = ctx.in_("ProjWeight")
    bias = ctx.in_("Bias")
    h = ctx.in_("WeightX").shape[1] // 4
    p = w_proj.shape[1]
    w_peep = None
    if bias is not None and ctx.attr("use_peepholes", False) and \
            bias.shape[0] == 7 * h:
        bias, w_peep = bias[: 4 * h], bias[4 * h:]
    b, t, _ = x.shape
    r_prev = _state(ctx, "H0", b, p, x)
    if r_prev.shape[-1] == h and ctx.in_("H0") is not None:
        r_prev = r_prev @ w_proj                 # H0 given in cell space
    c_prev = _state(ctx, "C0", b, h, x)
    gate_act = _ACTS[ctx.attr("gate_activation", "sigmoid")]
    cell_act = _ACTS[ctx.attr("cell_activation", "tanh")]
    cand_act = _ACTS[ctx.attr("candidate_activation", "tanh")]
    proj_act = _ACTS[ctx.attr("proj_activation", "tanh")]
    xw = x @ ctx.in_("WeightX")
    if bias is not None:
        xw = xw + bias
    xs = xw.transpose(0, 1)
    masks = _step_masks(ctx.in_("Length"), t, xw.dtype)
    if w_peep is not None:
        wi, wf, wo = torch.chunk(w_peep, 3)
    rs, cs = [None] * t, [None] * t
    for s in _order(t, bool(ctx.attr("is_reverse", False))):
        i, f, c_hat, o = torch.chunk(xs[s] + r_prev @ w_h, 4, dim=-1)
        if w_peep is not None:
            i = i + c_prev * wi
            f = f + c_prev * wf
        i, f = gate_act(i), gate_act(f)
        c_new = f * c_prev + i * cand_act(c_hat)
        if w_peep is not None:
            o = o + c_new * wo
        r_new = proj_act((gate_act(o) * cell_act(c_new)) @ w_proj)
        if masks is not None:
            m = masks[s]
            r_new = m * r_new + (1 - m) * r_prev
            c_new = m * c_new + (1 - m) * c_prev
        rs[s], cs[s] = r_new, c_new
        r_prev, c_prev = r_new, c_new
    return {"Projection": torch.stack(rs, 1), "Cell": torch.stack(cs, 1),
            "LastH": r_prev, "LastC": c_prev}


@register("basic_gru", dp=_ROWS)
def basic_gru(ctx):
    """One direction of one layer of contrib's basic_gru over the whole
    sequence. GateW (D+H, 2H) gives (r, u) in that order, CandW (D+H, H);
    the candidate reads (r * h_prev) (the unit's documented math, as the
    JAX package has it); the blend is u h + (1 - u) c.

    Inputs: Input (B, T, D), GateW, GateB (2H,), CandW, CandB (H,),
    optional H0 (B, H), Length (B,). Outputs: Hidden (B, T, H), LastH."""
    x = ctx.in_("Input")
    gate_w, cand_w = ctx.in_("GateW"), ctx.in_("CandW")
    d = x.shape[-1]
    h = cand_w.shape[-1]
    b, t = x.shape[0], x.shape[1]
    act_g = _ACTS[ctx.attr("gate_activation", "sigmoid")]
    act_c = _ACTS[ctx.attr("activation", "tanh")]
    xs_g = (x @ gate_w[:d] + ctx.in_("GateB")).transpose(0, 1)
    xs_c = (x @ cand_w[:d] + ctx.in_("CandB")).transpose(0, 1)
    wh_g, wh_c = gate_w[d:], cand_w[d:]
    masks = _step_masks(ctx.in_("Length"), t, x.dtype)
    hs = [None] * t
    h_prev = _state(ctx, "H0", b, h, x)
    for s in _order(t, bool(ctx.attr("is_reverse", False))):
        gates = act_g(xs_g[s] + h_prev @ wh_g)
        r, u = gates[:, :h], gates[:, h:]
        c = act_c(xs_c[s] + (r * h_prev) @ wh_c)
        h_new = u * h_prev + (1 - u) * c
        if masks is not None:
            m = masks[s]
            h_new = m * h_new + (1 - m) * h_prev
        hs[s] = h_prev = h_new
    return {"Hidden": torch.stack(hs, 1), "LastH": h_prev}


@register("basic_lstm", dp=_ROWS)
def basic_lstm(ctx):
    """One direction of one layer of contrib's basic_lstm over the whole
    sequence: Weight (D+H, 4H) in contrib's gate order (i, j, f, o) is
    mapped onto the LSTM's (i, f, c, o) and forget_bias is added to the f
    bias, then the LSTM recurrence runs.

    Inputs: Input (B, T, D), Weight, Bias (4H,), optional H0/C0 (B, H),
    Length (B,). Outputs: Hidden (B, T, H), LastH, LastC."""
    x = ctx.in_("Input")
    w = ctx.in_("Weight")
    bias = ctx.in_("Bias")
    d = x.shape[-1]
    h = w.shape[-1] // 4
    b = x.shape[0]
    act_g = _ACTS[ctx.attr("gate_activation", "sigmoid")]
    act_c = _ACTS[ctx.attr("activation", "tanh")]

    def ifco(m):
        return torch.cat([m[..., :h], m[..., 2 * h:3 * h], m[..., h:2 * h],
                          m[..., 3 * h:]], dim=-1)

    bp = ifco(bias)
    bp = torch.cat([bp[:h], bp[h:2 * h] + ctx.attr("forget_bias", 1.0),
                    bp[2 * h:]])
    hs, _cs, h_last, c_last = _lstm_scan(
        ifco(x @ w[:d]), _state(ctx, "H0", b, h, x),
        _state(ctx, "C0", b, h, x), ifco(w[d:]), bp, ctx.in_("Length"),
        gate_act=act_g, cell_act=act_c, cand_act=act_c,
        reverse=bool(ctx.attr("is_reverse", False)))
    return {"Hidden": hs, "LastH": h_last, "LastC": c_last}
