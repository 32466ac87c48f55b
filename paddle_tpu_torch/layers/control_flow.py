"""Control-flow layers.

Parity: python/paddle/fluid/layers/control_flow.py; the counterpart of
``paddle_tpu/layers/control_flow.py``, every name of its ``__all__`` and
of ``paddle_tpu/layers/__init__.py``'s control-flow import: ``While``,
``cond``, ``case``, ``switch_case``, ``Switch``, ``IfElse``,
``StaticRNN``, ``DynamicRNN``, ``while_loop``, ``Print``,
``reorder_lod_tensor_by_rank``, the tensor arrays (``create_array``,
``array_write``, ``array_read``, ``array_length``), ``increment``, the
comparisons and ``is_empty``, and ``autoincreased_step_counter``.

The layers build the same Programs as the JAX package's: each construct
is a sub-block and one structured op (``ops/control_flow_ops.py``). The
JAX Executor traces that op into the step's XLA graph with a ``lax``
primitive; the port's runs the sub-block eagerly, op by op, and pays in
host syncs where the construct's semantics read a value on the host:

  While        -> a Python loop; the condition read on the host once an
                  iteration (one sync an iteration)
  cond / case /   the predicate read on the host once (one sync); only
  switch_case  -> the taken branch runs
  Switch       -> every case runs, selects under a running done flag
                  (no sync: the learning-rate schedules' construct)
  IfElse       -> both blocks on the whole batch, rows merged by select
                  (no sync)
  StaticRNN    -> a Python loop over axis 0, outputs stacked (no sync;
                  autograd is the backward)
  DynamicRNN   -> StaticRNN over the padded batch, memories frozen and
                  outputs zeroed past each row's length (no sync)
  while_loop   -> the callables on torch tensors, cond read on the host
                  once an iteration
  Print        -> the host copy printed at once (a sync)

A gradient flows through an eager ``While`` where the loss depends on
its outputs; ``jax.grad`` cannot reverse-differentiate
``lax.while_loop``, so the JAX Executor raises there (ROADMAP C15).
"""

import contextlib

from ..core.framework import Variable
from ..core.layer_helper import LayerHelper
from .. import initializer as init_mod
from . import tensor as tensor_layers

__all__ = [
    "While", "Switch", "IfElse", "StaticRNN", "cond", "case", "switch_case",
    "increment", "array_write", "array_read", "array_length", "create_array",
    "less_than", "less_equal", "greater_than", "greater_equal", "equal",
    "not_equal", "is_empty", "autoincreased_step_counter",
]


# -- scalar helpers ---------------------------------------------------------

def increment(x, value=1.0, in_place=True):
    """Parity: fluid.layers.increment (ref layers/control_flow.py)."""
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(
        x.dtype, x.shape)
    helper.append_op("increment", {"X": x}, {"Out": out}, {"step": float(value)})
    return out


def _cmp(op_type, x, y, cond=None):
    helper = LayerHelper(op_type)
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool", x.shape)
    helper.append_op(op_type, {"X": x, "Y": y}, {"Out": cond})
    return cond


def less_than(x, y, force_cpu=None, cond=None):
    return _cmp("less_than", x, y, cond)


def less_equal(x, y, cond=None):
    return _cmp("less_equal", x, y, cond)


def greater_than(x, y, cond=None):
    return _cmp("greater_than", x, y, cond)


def greater_equal(x, y, cond=None):
    return _cmp("greater_equal", x, y, cond)


def equal(x, y, cond=None):
    return _cmp("equal", x, y, cond)


def not_equal(x, y, cond=None):
    return _cmp("not_equal", x, y, cond)


def is_empty(x, cond=None):
    helper = LayerHelper("is_empty")
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool", ())
    helper.append_op("is_empty", {"X": x}, {"Out": cond})
    return cond


# -- TensorArray ------------------------------------------------------------

def create_array(dtype="float32"):
    """Parity: fluid.layers.create_array (LoDTensorArray): a Python list
    of static length while the Program runs (ops/control_flow_ops.py)."""
    helper = LayerHelper("create_array")
    arr = helper.create_variable_for_type_inference(dtype)
    helper.append_op("create_array", {}, {"Out": arr})
    arr._is_array = True
    return arr


def array_write(x, i, array=None):
    """i must be a python int or a fill_constant var with static value
    (the array's length is static; a Variable index without one appends,
    as in the JAX package)."""
    helper = LayerHelper("array_write")
    if array is None:
        array = create_array(x.dtype)
    idx = i if isinstance(i, int) else getattr(i, "_static_value", None)
    helper.append_op("array_write", {"Array": array, "X": x}, {"Out": array},
                     {"static_index": idx} if idx is not None else {})
    return array


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference(array.dtype)
    idx = i if isinstance(i, int) else getattr(i, "_static_value", 0)
    helper.append_op("array_read", {"Array": array}, {"Out": out},
                     {"static_index": int(idx)})
    return out


def array_length(array):
    helper = LayerHelper("array_length")
    out = helper.create_variable_for_type_inference("int64", ())
    helper.append_op("array_length", {"Array": array}, {"Out": out})
    return out


def _free_vars(blocks, parent_block):
    """Names a set of sub-blocks read from enclosing scope. Needed so the
    executor's dead-code slicer keeps the producing ops: sub-block bodies
    run only inside the structured op, so their reads must surface as
    inputs of the structured op itself. Nested constructs already list
    their own frees as inputs (built inner-first), so one level suffices."""
    free = []
    for block in blocks:
        local = set(block.vars)
        for op in block.ops:
            for n in op.input_names:
                if n not in local and n not in free:
                    free.append(n)
            local |= set(op.output_names)
    return [v for v in (parent_block._find_var_recursive(n) for n in free)
            if v is not None]


# -- While ------------------------------------------------------------------

class While:
    """Parity: fluid.layers.While.

    with while_op.block(): body layers. Vars that exist BEFORE the loop and
    are written inside the body (via layers.assign etc.) become loop carry;
    the condition var must be re-assigned in the body.
    """

    def __init__(self, cond, is_test=False, name=None):
        self.helper = LayerHelper("while", name=name)
        if cond.dtype != "bool":
            raise TypeError("While condition must be a bool Variable")
        self.cond_var = cond
        self.is_test = is_test

    @contextlib.contextmanager
    def block(self):
        program = self.helper.main_program
        parent_block = program.current_block()
        sub_block = program._create_block()
        try:
            yield
        finally:
            program._rollback()
        # carry = parent vars written in the body (+ the condition var)
        carry = []
        for op in sub_block.ops:
            for name in op.output_names:
                if name in sub_block.vars:
                    continue  # block-local temp
                v = parent_block._find_var_recursive(name)
                if v is not None and name not in carry:
                    carry.append(name)
        if self.cond_var.name not in carry:
            carry.append(self.cond_var.name)
        out_vars = [parent_block._find_var_recursive(n) for n in carry]
        parent_block.append_op(
            "while",
            {"Cond": self.cond_var,
             "X": out_vars + _free_vars([sub_block], parent_block)},
            {"Out": out_vars},
            {"sub_block": sub_block.idx, "carry_names": carry,
             "cond_name": self.cond_var.name})


# -- cond / case / switch_case ---------------------------------------------

def cond(pred, true_fn=None, false_fn=None, name=None):
    """Parity: fluid.layers.cond — functional two-branch conditional.
    Both branches must return the same number of values."""
    helper = LayerHelper("cond", name=name)
    program = helper.main_program

    def trace(fn):
        block = program._create_block()
        try:
            rets = fn() if fn is not None else None
        finally:
            program._rollback()
        if rets is None:
            rets = []
        if isinstance(rets, Variable):
            rets = [rets]
        return block, list(rets)

    t_block, t_rets = trace(true_fn)
    f_block, f_rets = trace(false_fn)
    if len(t_rets) != len(f_rets):
        raise ValueError("cond: true_fn and false_fn must return the same "
                         f"number of values ({len(t_rets)} vs {len(f_rets)})")
    outs = [helper.create_variable_for_type_inference(v.dtype, v.shape)
            for v in t_rets]
    parent = program.current_block()
    helper.append_op(
        "cond_pair",
        {"Cond": pred, "X": _free_vars([t_block, f_block], parent)},
        {"Out": outs},
        {"true_block": t_block.idx, "false_block": f_block.idx,
         "true_outs": [v.name for v in t_rets],
         "false_outs": [v.name for v in f_rets]})
    if not outs:
        return None
    return outs[0] if len(outs) == 1 else outs


def case(pred_fn_pairs, default=None, name=None):
    """Parity: fluid.layers.case — first true predicate wins."""
    if not pred_fn_pairs:
        raise ValueError("case: pred_fn_pairs must be non-empty")
    pred, fn = pred_fn_pairs[0]
    rest = pred_fn_pairs[1:]
    if rest:
        return cond(pred, fn, lambda: case(rest, default), name=name)
    if default is None:
        return cond(pred, fn, fn, name=name)
    return cond(pred, fn, default, name=name)


def switch_case(branch_index, branch_fns, default=None, name=None):
    """Parity: fluid.layers.switch_case."""
    if isinstance(branch_fns, dict):
        pairs = sorted(branch_fns.items())
    else:
        pairs = list(enumerate(branch_fns))
    pred_fn_pairs = []
    for idx, fn in pairs:
        idx_var = tensor_layers.fill_constant((), "int64", int(idx))
        pred_fn_pairs.append((equal(branch_index, idx_var), fn))
    if default is None:
        default = pairs[-1][1]
    return case(pred_fn_pairs, default, name=name)


class Switch:
    """Parity: fluid.layers.Switch (used by LR schedules). Sequential
    guarded assignment blocks; first true case wins."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self.cases = []          # [(cond_name or None, block_idx)]
        self.target_names = []   # parent vars assigned in any case
        self._inside = False

    @contextlib.contextmanager
    def _case_block(self, condition):
        program = self.helper.main_program
        parent = program.current_block()
        block = program._create_block()
        try:
            yield
        finally:
            program._rollback()
        for op in block.ops:
            for name in op.output_names:
                if name in block.vars:
                    continue
                if parent._find_var_recursive(name) is not None \
                        and name not in self.target_names:
                    self.target_names.append(name)
        self.cases.append(
            [condition.name if condition is not None else None, block.idx])

    def case(self, condition):
        return self._case_block(condition)

    def default(self):
        return self._case_block(None)

    @contextlib.contextmanager
    def block(self):
        self.cases = []
        self.target_names = []
        try:
            yield self
        finally:
            parent = self.helper.main_program.current_block()
            out_vars = [parent._find_var_recursive(n) for n in self.target_names]
            cond_vars = [parent._find_var_recursive(c)
                         for c, _ in self.cases if c is not None]
            program = self.helper.main_program
            case_blocks = [program.blocks[i] for _, i in self.cases]
            self.helper.append_op(
                "switch",
                {"Cond": cond_vars,
                 "X": out_vars + _free_vars(case_blocks, parent)},
                {"Out": out_vars},
                {"cases": self.cases, "target_names": self.target_names})


class IfElse:
    """Parity: fluid.layers.IfElse. The reference physically splits the
    batch by the bool mask and runs each sub-batch through its block
    (split_lod_tensor/merge_lod_tensor). Here both blocks run on the
    FULL batch and output() merges rows with where(cond) — identical
    results for row-wise computation, with no dynamic shapes."""

    def __init__(self, cond, name=None):
        self.helper = LayerHelper("ifelse", name=name)
        self.cond = cond
        self._true_outs = []
        self._false_outs = []
        self._in_true = None

    @contextlib.contextmanager
    def true_block(self):
        self._in_true = True
        yield
        self._in_true = None

    @contextlib.contextmanager
    def false_block(self):
        self._in_true = False
        yield
        self._in_true = None

    def input(self, x):
        return x

    def output(self, *outs):
        target = self._true_outs if self._in_true else self._false_outs
        target.extend(outs)

    def __call__(self):
        merged = []
        for t, f in zip(self._true_outs, self._false_outs):
            helper = LayerHelper("ifelse_merge")
            out = helper.create_variable_for_type_inference(t.dtype, t.shape)
            helper.append_op("select",
                             {"Condition": self.cond, "X": t, "Y": f},
                             {"Out": out})
            merged.append(out)
        return merged


# -- StaticRNN --------------------------------------------------------------

class StaticRNN:
    """Parity: fluid.layers.StaticRNN — unrolled RNN over axis 0 of its
    step inputs, run by ONE static_rnn op (ops/control_flow_ops.py), a
    loop over the step inputs' axis 0, not T copies of the cell."""

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self._block = None
        self._step_inputs = []   # [outer_name, inner_name]
        self._memories = []      # [inner_name, init_name, updated_name]
        self._step_outputs = []  # inner names
        self._out_vars = []
        self._seq_len = None

    @contextlib.contextmanager
    def step(self):
        program = self.helper.main_program
        self._parent = program.current_block()
        self._block = program._create_block()
        try:
            yield
        finally:
            program._rollback()
            self._finalize()

    def step_input(self, x):
        """x: (T, B, ...) — sliced along axis 0 each step."""
        if self._seq_len is None:
            self._seq_len = x.shape[0] if x.shape else None
        inner = self._block.create_var(
            name=self.helper.name + ".in." + x.name, dtype=x.dtype,
            shape=tuple(x.shape[1:]))
        self._step_inputs.append([x.name, inner.name])
        return inner

    def memory(self, init=None, shape=None, batch_ref=None, value=0.0,
               dtype="float32"):
        if init is None:
            if shape is None:
                raise ValueError("StaticRNN.memory needs init or shape")
            # The init constant belongs OUTSIDE the step block: swap the
            # program's current block to the parent while building it.
            program = self.helper.main_program
            saved = program.current_block_idx
            program.current_block_idx = self._parent.idx
            try:
                init = tensor_layers.fill_constant(shape, dtype, value)
            finally:
                program.current_block_idx = saved
        inner = self._block.create_var(
            name=self.helper.name + ".mem." + init.name, dtype=init.dtype,
            shape=tuple(init.shape))
        self._memories.append([inner.name, init.name, None])
        return inner

    def update_memory(self, mem, var):
        for m in self._memories:
            if m[0] == mem.name:
                m[2] = var.name
                return
        raise ValueError(f"{mem.name} is not a memory of this StaticRNN")

    def step_output(self, o):
        self._step_outputs.append(o.name)
        ov = self._parent.create_var(
            name=self.helper.name + ".out." + o.name, dtype=o.dtype,
            shape=(self._seq_len,) + tuple(o.shape))
        self._out_vars.append(ov)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _finalize(self):
        for m in self._memories:
            if m[2] is None:
                raise ValueError("StaticRNN memory never updated "
                                 "(call update_memory)")
        last_vars = []
        for inner, init_n, _ in self._memories:
            iv = self._parent._find_var_recursive(init_n)
            lv = self._parent.create_var(
                name=self.helper.name + ".last." + inner, dtype=iv.dtype,
                shape=tuple(iv.shape))
            last_vars.append(lv)
        self._last_vars = last_vars
        in_vars = [self._parent._find_var_recursive(n)
                   for n, _ in self._step_inputs]
        init_vars = [self._parent._find_var_recursive(n)
                     for _, n, _ in self._memories]
        self._parent.append_op(
            "static_rnn",
            {"X": in_vars, "Init": init_vars,
             "Free": _free_vars([self._block], self._parent)},
            {"Out": self._out_vars + last_vars},
            {"sub_block": self._block.idx,
             "step_inputs": self._step_inputs,
             "memories": self._memories,
             "step_outputs": self._step_outputs})

    def __call__(self):
        if len(self._out_vars) == 1:
            return self._out_vars[0]
        return self._out_vars


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


def while_loop(cond, body, loop_vars, is_test=False, name=None):
    """Functional while loop (cond and body are Python callables on the
    loop's tensors, kept in Operator.CALLABLE_TABLE; the 1.5-era `While`
    block above is the op-graph form)."""
    helper = LayerHelper("while_loop", name=name)
    n = len(loop_vars)
    outs = [helper.create_variable_for_type_inference(
        getattr(v, "dtype", "float32"), getattr(v, "shape", None))
        for v in loop_vars]
    from ..core.framework import Operator
    cond_id = Operator.CALLABLE_TABLE
    key_c = f"while_cond_{id(cond)}"
    key_b = f"while_body_{id(body)}"
    cond_id[key_c] = cond
    cond_id[key_b] = body
    helper.append_op("while_loop", {"X": list(loop_vars)},
                     {"Out": outs}, {"cond_fn": key_c, "body_fn": key_b,
                                     "n_vars": n})
    return outs


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """Parity: fluid.layers.Print: prints the tensor's host copy when the
    op runs (a sync on the card), in the JAX op's text. Returns the input
    unchanged so it composes like the reference op."""
    helper = LayerHelper("print")
    # the executor's dead-code slicer treats print as a side-effect root
    # (executor.SIDE_EFFECT_OPS), so the common return-value-dropped usage
    # still logs without making the sink var scope state
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op("print", {"X": input}, {"Out": out},
                     {"message": message or "",
                      "print_tensor_name": print_tensor_name,
                      "print_tensor_shape": print_tensor_shape,
                      "print_tensor_value": True})
    return input


class DynamicRNN:
    """Parity: fluid.layers.DynamicRNN (ref layers/control_flow.py).

    The reference walks LoD sequences with a shrinking batch (sorted by
    length); here this is the padded-batch form of the same
    contract (SURVEY.md design decision 4): step inputs are (B, T, ...)
    batch-major plus an explicit `length` tensor, the whole loop is
    ONE static_rnn op via StaticRNN, and memory updates freeze once a row's
    length is passed — exactly the LoD semantics, at fixed shapes.
    Outputs come back (B, T, ...) zero-padded past each row's length.
    """

    def __init__(self, name=None):
        self._rnn = StaticRNN(name=name or "dynamic_rnn")
        self._lengths = None
        self._mask_inner = None
        self._maxlen = None
        self._outputs = []

    @contextlib.contextmanager
    def block(self):
        with self._rnn.step():
            yield

    @contextlib.contextmanager
    def _in_parent_block(self):
        # prep ops (transpose, mask) belong OUTSIDE the step block — same
        # block-switch trick as StaticRNN.memory's init constants
        program = self._rnn.helper.main_program
        saved = program.current_block_idx
        program.current_block_idx = self._rnn._parent.idx
        try:
            yield
        finally:
            program.current_block_idx = saved

    def step_input(self, x, level=0, length=None):
        """x: (B, T, ...); `length` (B,) must accompany the first step
        input (the padded replacement for LoD lod levels)."""
        from . import nn as nn_layers
        from . import sequence as seq_layers
        with self._in_parent_block():
            perm = [1, 0] + list(range(2, len(x.shape)))
            xt = nn_layers.transpose(x, perm=perm)  # (T, B, ...)
            mt = None
            if length is not None and self._mask_inner is None:
                self._lengths = length
                self._maxlen = x.shape[1]
                m = seq_layers.sequence_mask(length, maxlen=self._maxlen,
                                             dtype="float32")   # (B, T)
                mt = nn_layers.transpose(m, perm=[1, 0])         # (T, B)
        inner = self._rnn.step_input(xt)
        if mt is not None:
            self._mask_inner = self._rnn.step_input(mt)
        return inner

    def static_input(self, x):
        return x

    def memory(self, init=None, shape=None, value=0.0, need_reorder=False,
               dtype="float32", batch_ref=None):
        return self._rnn.memory(init=init, shape=shape, value=value,
                                dtype=dtype, batch_ref=batch_ref)

    def update_memory(self, ex_mem, new_mem):
        from . import nn as nn_layers
        from .. import layers as L
        if self._mask_inner is not None:
            # new = ex + m * (new - ex): frozen once the row's length passes
            m = nn_layers.unsqueeze(self._mask_inner, axes=[-1])  # (B, 1)
            diff = L.elementwise_sub(new_mem, ex_mem)
            new_mem = L.elementwise_add(ex_mem, L.elementwise_mul(diff, m))
        self._rnn.update_memory(ex_mem, new_mem)

    def output(self, *outputs):
        self._outputs.extend(outputs)
        self._rnn.output(*outputs)

    def __call__(self):
        from . import nn as nn_layers
        from . import sequence as seq_layers
        from .. import layers as L
        outs = self._rnn()
        outs = outs if isinstance(outs, list) else [outs]
        fixed = []
        for o in outs[:len(self._outputs)]:
            perm = [1, 0] + list(range(2, len(o.shape)))
            ob = nn_layers.transpose(o, perm=perm)  # (B, T, ...)
            if self._lengths is not None:
                m = seq_layers.sequence_mask(
                    self._lengths, maxlen=self._maxlen, dtype="float32")
                for _ in range(len(ob.shape) - 2):
                    m = nn_layers.unsqueeze(m, axes=[-1])
                ob = L.elementwise_mul(ob, m)
            fixed.append(ob)
        return fixed[0] if len(fixed) == 1 else fixed


def reorder_lod_tensor_by_rank(x, rank_table):
    """Parity shim: fluid.layers.reorder_lod_tensor_by_rank. The
    length-sorted shrinking-batch execution it supported does not exist
    here (padded batches + masks run every row in lockstep), so no
    reorder is ever needed; returns x unchanged."""
    return x
