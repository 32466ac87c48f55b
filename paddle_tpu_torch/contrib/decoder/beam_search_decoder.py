"""Declarative seq2seq decoder API: StateCell / TrainingDecoder /
BeamSearchDecoder.

Parity: `python/paddle/fluid/contrib/decoder/beam_search_decoder.py`
(InitState:43, StateCell:159, TrainingDecoder:384, BeamSearchDecoder:523);
a copy of ``paddle_tpu/contrib/decoder/beam_search_decoder.py``, with its
``emb_param_attr`` / ``score_param_attr`` / ``score_bias_attr``
extension. The user contract is the reference's: declare the per-step
recurrence once on a StateCell, train with TrainingDecoder, generate with
BeamSearchDecoder. The lowering:

* TrainingDecoder rides `layers.StaticRNN`: the teacher-forced decode is
  one ``static_rnn`` op over time-major (T, B, ...) step inputs, a loop
  over T on the card with no host sync (padded sequences, no LoD).
* BeamSearchDecoder builds one decode step into a sub-block, which the
  ``contrib_beam_search_decoder`` op runs as the step function of
  ``inference.decoding.beam_decode``: dense beam lanes (B*K), the
  reorder by parent beam a gather. The reference's
  `sequence_expand`/`lod_reset` beam bookkeeping has no counterpart;
  the lanes replace it.
"""

import contextlib

from ...core import unique_name
from ...core.layer_helper import LayerHelper
from ... import layers

__all__ = ["InitState", "StateCell", "TrainingDecoder", "BeamSearchDecoder"]


class InitState:
    """Initial value of one decoder state (ref beam_search_decoder.py:43).

    Either wraps an existing Variable (e.g. encoder final state) or
    describes a constant (shape/value/dtype). `need_reorder` is accepted
    for parity; dense-lane beam search reorders every state by parent lane
    unconditionally, which subsumes it.
    """

    def __init__(self, init=None, shape=None, value=0.0,
                 init_boot=None, need_reorder=False, dtype="float32"):
        if init is not None:
            self._init = init
        elif init_boot is None:
            raise ValueError("init_boot must be provided for no-init InitState")
        else:
            self._init = layers.fill_constant_batch_size_like(
                input=init_boot, value=value, shape=shape, dtype=dtype)
        self._shape = shape
        self._value = value
        self._need_reorder = need_reorder
        self._dtype = dtype

    @property
    def value(self):
        return self._init

    @property
    def need_reorder(self):
        return self._need_reorder


class StateCell:
    """Recurrence declared once, lowered by whichever decoder runs it
    (ref beam_search_decoder.py:159).

    `inputs` maps input names to placeholder vars (or None — bound per
    step by the decoder); `states` maps state names to InitState;
    `out_state` names the state the score head reads.
    """

    def __init__(self, inputs, states, out_state, name=None):
        self.helper = LayerHelper("state_cell", name=name)
        self._inputs = dict(inputs)
        self._init_states = dict(states)
        self._state_names = list(states)
        self._out_state_name = out_state
        self._cur_states = {}
        self._next_states = {}
        self._updater = None
        self._in_decoder = False

    def state_updater(self, updater):
        """Decorator registering fn(state_cell) that reads get_input/
        get_state and calls set_state for every state."""
        self._updater = updater
        return updater

    def get_input(self, input_name):
        if input_name not in self._inputs or self._inputs[input_name] is None:
            raise ValueError("Input %s not found or not bound" % input_name)
        return self._inputs[input_name]

    def get_state(self, state_name):
        if state_name not in self._cur_states:
            raise ValueError("state %s not bound (use inside a decoder "
                             "block)" % state_name)
        return self._cur_states[state_name]

    def set_state(self, state_name, state_value):
        if state_name not in self._state_names:
            raise ValueError("Unknown state %s" % state_name)
        self._next_states[state_name] = state_value

    def _bind_states(self, bindings):
        self._cur_states = dict(bindings)

    def compute_state(self, inputs):
        """Run the updater with `inputs` bound; commits set_state values
        (the reference defers to update_states — dense-lane beam reorder
        makes deferral unnecessary, see module docstring)."""
        if self._updater is None:
            raise ValueError("state_updater not registered")
        for name, value in inputs.items():
            if name not in self._inputs:
                raise ValueError("Unknown input %s" % name)
            self._inputs[name] = value
        self._updater(self)
        self.update_states()

    def update_states(self):
        self._cur_states.update(self._next_states)
        self._next_states = {}

    def out_state(self):
        return self._cur_states[self._out_state_name]


class TrainingDecoder:
    """Teacher-forced decoding as one static_rnn op
    (ref beam_search_decoder.py:384, through layers.StaticRNN).

    Step inputs are time-major (T, B, ...); `decoder()` returns outputs
    stacked (T, B, ...).
    """

    def __init__(self, state_cell, name=None):
        self._rnn = layers.StaticRNN(name=name or "training_decoder")
        self._cell = state_cell
        self._mems = {}

    @contextlib.contextmanager
    def block(self):
        with self._rnn.step():
            bindings = {}
            for sname in self._cell._state_names:
                mem = self._rnn.memory(init=self._cell._init_states[sname].value)
                bindings[sname] = mem
                self._mems[sname] = mem
            self._cell._bind_states(bindings)
            yield
            for sname, mem in self._mems.items():
                self._rnn.update_memory(mem, self._cell.get_state(sname))

    def step_input(self, x):
        return self._rnn.step_input(x)

    def static_input(self, x):
        # captured unchanged each step: a free var of the step block
        return x

    def output(self, *outputs):
        self._rnn.output(*outputs)

    def __call__(self):
        return self._rnn()


class BeamSearchDecoder:
    """Beam-search generation from the same StateCell
    (ref beam_search_decoder.py:523).

    `decode()` builds one step of the recurrence — embed previous ids,
    compute_state, softmax score head — into a sub-block; the
    `contrib_beam_search_decoder` op runs it under
    `inference.decoding.beam_decode` (dense lanes, a loop over max_len,
    parent-lane gather reorder). Calling the decoder returns
    (translation_ids (B, beam, max_len), translation_scores (B, beam)).
    """

    def __init__(self, state_cell, init_ids, init_scores, target_dict_dim,
                 word_dim, input_var_dict=None, topk_size=50,
                 sparse_emb=True, max_len=100, beam_size=1, end_id=1,
                 length_penalty=0.0, emb_param_attr=None,
                 score_param_attr=None, score_bias_attr=None, name=None):
        self.helper = LayerHelper("beam_search_decoder", name=name)
        self._cell = state_cell
        self._init_ids = init_ids
        self._init_scores = init_scores  # parity; lane-0 init is implicit
        self._target_dict_dim = target_dict_dim
        self._word_dim = word_dim
        self._input_var_dict = dict(input_var_dict or {})
        self._topk_size = topk_size  # parity; dense lanes keep full vocab
        self._sparse_emb = sparse_emb
        self._max_len = max_len
        self._beam_size = beam_size
        self._end_id = end_id
        self._length_penalty = length_penalty
        # extension over the reference signature: name the decoder's own
        # params so a separately-built training program can share them
        self._emb_param_attr = emb_param_attr
        self._score_param_attr = score_param_attr
        self._score_bias_attr = score_bias_attr
        self._outputs = None

    def decode(self):
        if self._outputs is not None:
            raise ValueError("decode() can only be invoked once.")
        program = self.helper.main_program
        parent = program.current_block()
        block = program._create_block()
        try:
            # --- one decode step, built into the sub-block --------------
            prev_ids = block.create_var(
                name=unique_name.generate("beam_prev_ids"),
                dtype="int64", shape=(-1,))
            emb = layers.embedding(
                prev_ids, size=[self._target_dict_dim, self._word_dim],
                is_sparse=self._sparse_emb, param_attr=self._emb_param_attr)
            bindings, inner_names = {}, {}
            for sname in self._cell._state_names:
                init = self._cell._init_states[sname].value
                inner = block.create_var(
                    name=unique_name.generate("beam_state_" + sname),
                    dtype=init.dtype, shape=tuple(init.shape))
                bindings[sname] = inner
                inner_names[sname] = inner.name
            self._cell._bind_states(bindings)
            feed = {}
            for in_name, var in self._input_var_dict.items():
                if in_name not in self._cell._inputs:
                    raise ValueError(
                        "Variable %s not found in StateCell!" % in_name)
                feed[in_name] = var
            for in_name in self._cell._inputs:
                if in_name not in feed:
                    feed[in_name] = emb
            self._cell.compute_state(inputs=feed)
            scores = layers.fc(self._cell.out_state(),
                               size=self._target_dict_dim, act="softmax",
                               param_attr=self._score_param_attr,
                               bias_attr=self._score_bias_attr)
            updated_names = {s: self._cell.get_state(s).name
                             for s in self._cell._state_names}
        finally:
            program._rollback()

        # --- the decode op in the parent block --------------------------
        from ...layers.control_flow import _free_vars
        state_order = list(self._cell._state_names)
        init_states = [self._cell._init_states[s].value for s in state_order]
        batch = self._init_ids.shape[0] if self._init_ids.shape else -1
        ids_out = parent.create_var(
            name=unique_name.generate("beam_decode_ids"), dtype="int64",
            shape=(batch, self._beam_size, self._max_len))
        scores_out = parent.create_var(
            name=unique_name.generate("beam_decode_scores"), dtype="float32",
            shape=(batch, self._beam_size))
        parent.append_op(
            "contrib_beam_search_decoder",
            {"InitIds": self._init_ids, "InitScores": self._init_scores,
             "InitStates": init_states,
             "Free": _free_vars([block], parent)},
            {"Ids": ids_out, "Scores": scores_out},
            {"sub_block": block.idx,
             "prev_ids_name": prev_ids.name,
             "state_names": state_order,
             "state_inner_names": [inner_names[s] for s in state_order],
             "state_updated_names": [updated_names[s] for s in state_order],
             "scores_name": scores.name,
             "beam_size": self._beam_size,
             "end_id": self._end_id,
             "max_len": self._max_len,
             "length_penalty": self._length_penalty})
        self._outputs = (ids_out, scores_out)

    def __call__(self):
        if self._outputs is None:
            raise ValueError("decode() has not been invoked.")
        return self._outputs
