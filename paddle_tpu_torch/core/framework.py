"""Graph IR: Program / Block / Operator / Variable / Parameter.

Parity: python/paddle/fluid/framework.py (Program, Block, Operator, Variable,
Parameter, program_guard, default_{main,startup}_program) and the C++
ProgramDesc/BlockDesc/OpDesc protobufs (paddle/fluid/framework/framework.proto).

A copy of ``paddle_tpu/core/framework.py`` (pure Python, no JAX), kept
in the port so that it imports nothing of the JAX package. The Program is a
lightweight, JSON-serializable recipe; the port's Executor runs its ops
eagerly with torch, the forward section under autograd (see
core/executor.py). ``Program.to_json`` / ``from_json`` write and read the
JAX package's JSON form (io/inference_io.py's ``__model__.json``), and
``_prune`` is its backward slice. Dropped from the copy, for want of the
modules that use them: ``Variable.astype`` and byte sizes, name scopes
and the dygraph flag.
"""

import contextlib
import copy
import itertools
import json

import numpy as np

from . import unique_name

# ---------------------------------------------------------------------------
# dtype handling
# ---------------------------------------------------------------------------

_DTYPE_ALIASES = {
    "float32": "float32", "fp32": "float32", "float": "float32",
    "float64": "float64", "fp64": "float64", "double": "float64",
    "float16": "float16", "fp16": "float16", "half": "float16",
    "bfloat16": "bfloat16", "bf16": "bfloat16",
    "int8": "int8", "uint8": "uint8", "int16": "int16",
    "int32": "int32", "int": "int32", "int64": "int64", "long": "int64",
    "bool": "bool",
}


def convert_dtype(dtype):
    """Normalize any dtype spec (str, numpy) to a canonical string."""
    if dtype is None:
        return "float32"
    if isinstance(dtype, str):
        key = dtype.lower()
        if key in _DTYPE_ALIASES:
            return _DTYPE_ALIASES[key]
        raise ValueError(f"unsupported dtype string: {dtype}")
    name = np.dtype(dtype).name
    if name in _DTYPE_ALIASES:
        return _DTYPE_ALIASES[name]
    raise ValueError(f"unsupported dtype: {dtype!r}")


_global_seed = 0


def default_seed():
    return _global_seed


def set_default_seed(seed):
    """Parity: fluid's global random seed (Program.random_seed default)."""
    global _global_seed
    _global_seed = int(seed)


# ---------------------------------------------------------------------------
# Variable
# ---------------------------------------------------------------------------


class Variable:
    """A named tensor slot in a Block.

    Parity: fluid.framework.Variable / VarDesc. LoD (ragged) information is
    represented by static shapes + an optional companion length tensor;
    lod_level is retained for API compatibility.
    """

    def __init__(self, block, name=None, shape=None, dtype="float32",
                 lod_level=0, persistable=False, stop_gradient=False,
                 is_data=False, need_check_feed=False):
        self.block = block
        self.name = name if name is not None else unique_name.generate("_generated_var")
        self.shape = tuple(int(s) for s in shape) if shape is not None else ()
        self.dtype = convert_dtype(dtype)
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.op = None  # producing op (last writer), set by Block.append_op

    # -- introspection ------------------------------------------------------
    @property
    def grad_name(self):
        return grad_var_name(self.name)

    def __repr__(self):
        return (f"Variable(name={self.name}, shape={self.shape}, "
                f"dtype={self.dtype}, persistable={self.persistable})")

    __str__ = __repr__

    def to_desc(self):
        return {
            "kind": "Parameter" if isinstance(self, Parameter) else "Variable",
            "name": self.name, "shape": list(self.shape), "dtype": self.dtype,
            "lod_level": self.lod_level, "persistable": self.persistable,
            "stop_gradient": self.stop_gradient, "is_data": self.is_data,
        }

    # numpy-style sugar -----------------------------------------------------
    @property
    def ndim(self):
        return len(self.shape)



def grad_var_name(name):
    return name + "@GRAD"


class Parameter(Variable):
    """Trainable persistable variable.

    Parity: fluid.framework.Parameter. Carries its initializer spec so that
    the startup program can materialize it, plus optimizer/regularizer attrs.
    """

    def __init__(self, block, name, shape, dtype, trainable=True,
                 optimize_attr=None, regularizer=None, gradient_clip_attr=None,
                 do_model_average=True, **kwargs):
        super().__init__(block, name=name, shape=shape, dtype=dtype,
                         persistable=True, stop_gradient=not trainable, **kwargs)
        self.trainable = trainable
        self.optimize_attr = optimize_attr or {"learning_rate": 1.0}
        self.regularizer = regularizer
        self.gradient_clip_attr = gradient_clip_attr
        self.do_model_average = do_model_average
        # sharding hint of the tensor-parallel slice (not ported yet)
        self.dist_attr = None


# ---------------------------------------------------------------------------
# Operator
# ---------------------------------------------------------------------------

class Operator:
    """A single op node: type + named input/output slots + attrs.

    Parity: fluid.framework.Operator / OpDesc. Attrs must be JSON-able;
    callables (py_func) are kept in a side table keyed by id.
    """

    CALLABLE_TABLE = {}

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs = {k: [v.name if isinstance(v, Variable) else v for v in _as_list(vs)]
                       for k, vs in (inputs or {}).items()}
        self.outputs = {k: [v.name if isinstance(v, Variable) else v for v in _as_list(vs)]
                        for k, vs in (outputs or {}).items()}
        self.attrs = dict(attrs or {})

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    @property
    def input_names(self):
        return [n for vs in self.inputs.values() for n in vs]

    @property
    def output_names(self):
        return [n for vs in self.outputs.values() for n in vs]

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def has_attr(self, name):
        return name in self.attrs

    def _set_attr(self, name, val):
        self.attrs[name] = val

    def __repr__(self):
        ins = {k: v for k, v in self.inputs.items()}
        outs = {k: v for k, v in self.outputs.items()}
        return f"{{Op {self.type}: {ins} -> {outs}}}"

    def to_desc(self):
        return {"type": self.type, "inputs": self.inputs,
                "outputs": self.outputs,
                "attrs": {k: v for k, v in self.attrs.items()
                          if _json_safe(v)}}


def _as_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _json_safe(v):
    try:
        json.dumps(v)
        return True
    except (TypeError, ValueError):
        return False


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------

class Block:
    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = {}        # name -> Variable
        self.ops = []         # list[Operator]

    @property
    def parent_block(self):
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    # -- vars ---------------------------------------------------------------
    def create_var(self, **kwargs):
        var = Variable(self, **kwargs)
        self.vars[var.name] = var
        self.program._bump_version()
        return var

    def create_parameter(self, **kwargs):
        # Parameters always live in the global block (parity with fluid).
        gblock = self.program.global_block()
        param = Parameter(gblock, **kwargs)
        gblock.vars[param.name] = param
        self.program._bump_version()
        return param

    def var(self, name):
        v = self._find_var_recursive(name)
        if v is None:
            raise ValueError(f"Variable {name} not found in block {self.idx}")
        return v

    def has_var(self, name):
        return self._find_var_recursive(name) is not None

    def _find_var_recursive(self, name):
        blk = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = blk.parent_block
        return None

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    # -- ops ----------------------------------------------------------------
    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        for vs in (outputs or {}).values():
            for v in _as_list(vs):
                if isinstance(v, Variable):
                    v.op = op
        self.program._bump_version()
        return op

    def prepend_op(self, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(0, op)
        self.program._bump_version()
        return op

    def to_desc(self):
        return {"idx": self.idx, "parent_idx": self.parent_idx,
                "vars": [v.to_desc() for v in self.vars.values()],
                "ops": [op.to_desc() for op in self.ops]}


# ---------------------------------------------------------------------------
# Program
# ---------------------------------------------------------------------------

BACKWARD_MARKER = "backward_marker"

# Monotonic process-wide Program ids: unlike id(), never recycled by the
# allocator, so a cache keyed by them cannot alias a collected Program.
_PROGRAM_UID = itertools.count(1)


class Program:
    """A whole computation graph (possibly with sub-blocks for control flow).

    Parity: fluid.framework.Program / ProgramDesc.
    """

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = default_seed()
        self._version = 0           # bumped on any mutation
        self._uid = next(_PROGRAM_UID)
        self._seed_counter = 0      # per-program op seed allocator
        self._is_test = False

    # -- blocks -------------------------------------------------------------
    def global_block(self):
        return self.blocks[0]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def _create_block(self, parent_idx=None):
        parent = self.current_block_idx if parent_idx is None else parent_idx
        blk = Block(self, len(self.blocks), parent)
        self.blocks.append(blk)
        self.current_block_idx = blk.idx
        self._bump_version()
        return blk

    def _rollback(self):
        self.current_block_idx = self.current_block().parent_idx

    def _bump_version(self):
        self._version += 1

    @property
    def version(self):
        return self._version

    @property
    def uid(self):
        """Never-recycled process-unique id (unlike id(self))."""
        return self._uid

    def next_op_seed(self):
        self._seed_counter += 1
        return self._seed_counter

    # -- introspection ------------------------------------------------------
    def list_vars(self):
        for blk in self.blocks:
            yield from blk.vars.values()

    def all_parameters(self):
        return [v for v in self.list_vars() if isinstance(v, Parameter)]

    def num_ops(self):
        return sum(len(b.ops) for b in self.blocks)

    def backward_marker(self):
        for op in self.global_block().ops:
            if op.type == BACKWARD_MARKER:
                return op
        return None

    # -- clone / prune ------------------------------------------------------
    def clone(self, for_test=False):
        """Deep-copy. for_test=True prunes backward/optimize ops and flips
        is_test attrs (dropout off, batch_norm uses running stats)."""
        p = copy.deepcopy(self)
        if for_test:
            gb = p.global_block()
            keep = []
            for op in gb.ops:
                if op.type == BACKWARD_MARKER:
                    break
                keep.append(op)
            gb.ops = keep
            p._is_test = True
            for blk in p.blocks:
                for op in blk.ops:
                    if "is_test" in op.attrs:
                        op.attrs["is_test"] = True
        p._bump_version()
        return p

    def __deepcopy__(self, memo):
        cls = self.__class__
        p = cls.__new__(cls)
        memo[id(self)] = p
        p.blocks = []
        p.current_block_idx = self.current_block_idx
        p.random_seed = self.random_seed
        p._version = self._version
        p._uid = next(_PROGRAM_UID)   # a clone is a distinct cache identity
        p._seed_counter = self._seed_counter
        p._is_test = self._is_test
        for blk in self.blocks:
            nb = Block(p, blk.idx, blk.parent_idx)
            for v in blk.vars.values():
                if isinstance(v, Parameter):
                    nv = Parameter(nb, v.name, v.shape, v.dtype,
                                   trainable=v.trainable,
                                   optimize_attr=v.optimize_attr,
                                   regularizer=v.regularizer)
                    nv.dist_attr = v.dist_attr
                else:
                    nv = Variable(nb, name=v.name, shape=v.shape, dtype=v.dtype,
                                  lod_level=v.lod_level, persistable=v.persistable,
                                  stop_gradient=v.stop_gradient, is_data=v.is_data)
                nb.vars[nv.name] = nv
            for op in blk.ops:
                nb.ops.append(Operator(nb, op.type, None, None, copy.deepcopy(op.attrs)))
                nb.ops[-1].inputs = copy.deepcopy(op.inputs)
                nb.ops[-1].outputs = copy.deepcopy(op.outputs)
            p.blocks.append(nb)
        return p

    def _prune(self, targets):
        """Backward-slice the global block to the ops needed for `targets`
        (parity: Program._prune used by save_inference_model). Ops that
        write persistable vars (optimizer/stat updates) are preserved."""
        names = set()
        for t in targets:
            names.add(t.name if isinstance(t, Variable) else t)
        gb = self.global_block()
        keep = []
        for op in reversed(gb.ops):
            out_names = set(op.output_names)
            writes_persistable = any(
                (n in gb.vars and gb.vars[n].persistable) for n in out_names)
            if op.type == BACKWARD_MARKER or writes_persistable or \
                    (out_names & names):
                keep.append(op)
                names |= set(op.input_names)
                if op.type == BACKWARD_MARKER:
                    names |= set(op.attr("params", []))
                    names.add(op.attr("loss"))
        gb.ops = list(reversed(keep))
        self._bump_version()
        return self

    # -- serialization ------------------------------------------------------
    def to_json(self):
        return json.dumps({"random_seed": self.random_seed,
                           "is_test": self._is_test,
                           "blocks": [b.to_desc() for b in self.blocks]},
                          indent=1)

    @classmethod
    def from_json(cls, text):
        desc = json.loads(text)
        p = cls()
        p.random_seed = desc.get("random_seed", 0)
        p._is_test = desc.get("is_test", False)
        p.blocks = []
        for bdesc in desc["blocks"]:
            blk = Block(p, bdesc["idx"], bdesc["parent_idx"])
            for vdesc in bdesc["vars"]:
                kind = vdesc.pop("kind", "Variable")
                if kind == "Parameter":
                    v = Parameter(blk, vdesc["name"], vdesc["shape"], vdesc["dtype"])
                else:
                    v = Variable(blk, name=vdesc["name"], shape=vdesc["shape"],
                                 dtype=vdesc["dtype"], lod_level=vdesc.get("lod_level", 0),
                                 persistable=vdesc.get("persistable", False),
                                 stop_gradient=vdesc.get("stop_gradient", False),
                                 is_data=vdesc.get("is_data", False))
                blk.vars[v.name] = v
            for odesc in bdesc["ops"]:
                op = Operator(blk, odesc["type"], None, None, odesc.get("attrs", {}))
                op.inputs = odesc.get("inputs", {})
                op.outputs = odesc.get("outputs", {})
                blk.ops.append(op)
            p.blocks.append(blk)
        if not p.blocks:
            p.blocks = [Block(p, 0)]
        return p

    def __repr__(self):
        lines = [f"Program(version={self._version})"]
        for blk in self.blocks:
            lines.append(f" Block {blk.idx} (parent {blk.parent_idx}):")
            for op in blk.ops:
                lines.append(f"  {op}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# default programs / guards
# ---------------------------------------------------------------------------

_main_program_ = Program()
_startup_program_ = Program()


def default_main_program():
    return _main_program_


def default_startup_program():
    return _startup_program_


def switch_main_program(program):
    global _main_program_
    old = _main_program_
    _main_program_ = program
    return old


def switch_startup_program(program):
    global _startup_program_
    old = _startup_program_
    _startup_program_ = program
    return old


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)

