"""Reference `__model__` interop: decode Fluid ProgramDesc protobufs.

Parity: paddle/fluid/framework/framework.proto (ProgramDesc/BlockDesc/
OpDesc/VarDesc wire schema) and fluid.io.load_inference_model — the
`__model__` file `save_inference_model` exported; the port's own copy of
``paddle_tpu/io/fluid_proto.py``, encoding the same bytes. A user
switching from the reference serves their exported graphs directly:

    prog, feeds, fetches = io.load_fluid_inference_model(dirname, exe)
    out = exe.run(prog, feed={feeds[0]: x}, fetch_list=fetches)

The tiny proto2 wire reader is hand-rolled (like io/fluid_format.py): the
format is fixed by the reference's wire compatibility. Ops decode onto
our registry under their fluid names, so anything the surface audit
covers executes; unknown op types raise with a clear message.
"""

import os
import struct

import numpy as np

from .fluid_format import (_DTYPE_BY_ENUM, _read_varint, load_fluid_vars,
                           parse_tensor_desc_wire)


def _fields(buf):
    """Yield (field_number, wire_type, value) from a proto2 blob.
    wire 0 -> int, 2 -> bytes, 5 -> 4 raw bytes, 1 -> 8 raw bytes."""
    off = 0
    while off < len(buf):
        tag, off = _read_varint(buf, off)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, off = _read_varint(buf, off)
        elif wire == 2:
            ln, off = _read_varint(buf, off)
            val = buf[off:off + ln]
            off += ln
        elif wire == 5:
            val = buf[off:off + 4]
            off += 4
        elif wire == 1:
            val = buf[off:off + 8]
            off += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _signed(v, bits=64):
    return v - (1 << bits) if v >= (1 << (bits - 1)) else v


def _i32(v):
    # proto int32 negatives arrive as 64-bit two's-complement varints
    return _signed(v & 0xFFFFFFFFFFFFFFFF, 64) if v >= (1 << 31) else v


def _parse_attr(buf):
    """OpDesc.Attr -> (name, python value)."""
    name, atype = None, None
    scalars = {}
    ints, floats, strings, bools, longs, blocks_idx = [], [], [], [], [], []
    for field, wire, val in _fields(buf):
        if field == 1:
            name = val.decode()
        elif field == 2:
            atype = val
        elif field == 3:
            scalars["i"] = _i32(val)
        elif field == 4:
            scalars["f"] = struct.unpack("<f", val)[0]
        elif field == 5:
            scalars["s"] = val.decode()
        elif field == 6:
            if wire == 2:      # packed
                off = 0
                while off < len(val):
                    v, off = _read_varint(val, off)
                    ints.append(_i32(v))
            else:
                ints.append(_i32(val))
        elif field == 7:
            if wire == 2:
                floats.extend(np.frombuffer(val, "<f4").tolist())
            else:
                floats.append(struct.unpack("<f", val)[0])
        elif field == 8:
            strings.append(val.decode())
        elif field == 10:
            scalars["b"] = bool(val)
        elif field == 11:
            if wire == 2:
                bools.extend(bool(b) for b in val)
            else:
                bools.append(bool(val))
        elif field == 12:
            scalars["block"] = _i32(val)
        elif field == 13:
            scalars["l"] = _signed(val)
        elif field == 14:
            blocks_idx.append(_i32(val))
        elif field == 15:
            if wire == 2:
                off = 0
                while off < len(val):
                    v, off = _read_varint(val, off)
                    longs.append(_signed(v))
            else:
                longs.append(_signed(val))
    # AttrType: INT FLOAT STRING INTS FLOATS STRINGS BOOLEAN BOOLEANS
    #           BLOCK LONG BLOCKS LONGS
    by_type = {0: scalars.get("i"), 1: scalars.get("f"),
               2: scalars.get("s"), 3: ints, 4: floats, 5: strings,
               6: scalars.get("b"), 7: bools, 8: scalars.get("block"),
               9: scalars.get("l"), 10: blocks_idx, 11: longs}
    return name, by_type.get(atype)


def _parse_op_var(buf):
    """OpDesc.Var -> (slot_name, [arg names])."""
    slot, args = None, []
    for field, _wire, val in _fields(buf):
        if field == 1:
            slot = val.decode()
        elif field == 2:
            args.append(val.decode())
    return slot, args


def _parse_op(buf):
    inputs, outputs, attrs = {}, {}, {}
    op_type = None
    for field, _wire, val in _fields(buf):
        if field == 1:
            k, v = _parse_op_var(val)
            inputs[k] = v
        elif field == 2:
            k, v = _parse_op_var(val)
            outputs[k] = v
        elif field == 3:
            op_type = val.decode()
        elif field == 4:
            k, v = _parse_attr(val)
            attrs[k] = v
    return op_type, inputs, outputs, attrs


def _parse_var_type(buf):
    """VarType -> (kind enum, dtype str or None, dims or None)."""
    kind, dtype, dims = None, None, None
    for field, _wire, val in _fields(buf):
        if field == 1:
            kind = val
        elif field in (3, 4):            # LoDTensorDesc / TensorArrayDesc
            for f2, _w2, v2 in _fields(val):
                if f2 == 1:              # inner TensorDesc
                    enum, dims = parse_tensor_desc_wire(bytes(v2))
                    if enum in _DTYPE_BY_ENUM:
                        dtype = np.dtype(_DTYPE_BY_ENUM[enum]).name
        elif field == 2:                 # selected_rows TensorDesc
            enum, dims = parse_tensor_desc_wire(bytes(val))
            if enum in _DTYPE_BY_ENUM:
                dtype = np.dtype(_DTYPE_BY_ENUM[enum]).name
    return kind, dtype, dims


def _parse_var(buf):
    name, persistable = None, False
    kind, dtype, dims = None, None, None
    for field, _wire, val in _fields(buf):
        if field == 1:
            name = val.decode()
        elif field == 2:
            kind, dtype, dims = _parse_var_type(val)
        elif field == 3:
            persistable = bool(val)
    return name, kind, dtype, dims, persistable


def parse_program_desc(raw):
    """ProgramDesc bytes -> framework.Program."""
    from ..core.framework import Program, Block, Variable, Operator

    program = Program()
    program.blocks = []
    for field, _wire, val in _fields(raw):
        if field != 1:                   # blocks
            continue
        idx, parent_idx, vars_raw, ops_raw = 0, -1, [], []
        for f2, _w2, v2 in _fields(val):
            if f2 == 1:
                idx = _i32(v2)
            elif f2 == 2:
                parent_idx = _i32(v2)
            elif f2 == 3:
                vars_raw.append(v2)
            elif f2 == 4:
                ops_raw.append(v2)
        blk = Block(program, idx, parent_idx)
        for vb in vars_raw:
            name, kind, dtype, dims, persistable = _parse_var(vb)
            if name in ("feed", "fetch") or kind in (9, 10):
                continue                 # feed/fetch plumbing: not needed
            var = Variable(blk, name=name, shape=dims or [],
                           dtype=dtype or "float32",
                           persistable=persistable)
            blk.vars[name] = var
        for ob in ops_raw:
            op_type, inputs, outputs, attrs = _parse_op(ob)
            op = Operator(blk, op_type, None, None, attrs)
            op.inputs = inputs
            op.outputs = outputs
            blk.ops.append(op)
        program.blocks.append(blk)
    if not program.blocks:
        program.blocks = [Block(program, 0)]
    program._is_test = True
    program._bump_version()
    return program


def _strip_feed_fetch(program):
    """Remove feed/fetch ops; return (feed_names, fetch_names) in col
    order — our Executor feeds/fetches by name directly."""
    gb = program.global_block()
    feeds, fetches = [], []
    kept = []
    for op in gb.ops:
        if op.type == "feed":
            col = op.attr("col", len(feeds))
            name = op.output("Out")[0]
            feeds.append((col, name))
            if name in gb.vars:
                # feed targets validate like layers.data vars: Executor.run
                # raises a clear missing-feed error instead of a trace error
                gb.vars[name].is_data = True
        elif op.type == "fetch":
            col = op.attr("col", len(fetches))
            fetches.append((col, op.input("X")[0]))
        else:
            kept.append(op)
    gb.ops = kept
    program._bump_version()
    return ([n for _, n in sorted(feeds)], [n for _, n in sorted(fetches)])


# ---------------------------------------------------------------------------
# Encoding: our Program -> reference ProgramDesc bytes (the reverse path,
# so models trained here serve on the original PaddlePaddle).
# ---------------------------------------------------------------------------

# the ONE wire writer / dtype map, shared with fluid_format
from .fluid_format import _write_varint as _wvint, _ENUM_BY_DTYPE


def _wtag(out, field, wire):
    _wvint(out, (field << 3) | wire)


def _wbytes(out, field, payload):
    _wtag(out, field, 2)
    _wvint(out, len(payload))
    out.extend(payload)


def _wstr(out, field, s):
    _wbytes(out, field, s.encode())


def _wvarint_field(out, field, v):
    _wtag(out, field, 0)
    _wvint(out, v)


def _encode_attr(name, value):
    """OpDesc.Attr bytes for a python attr value; None for unencodable."""
    out = bytearray()
    _wstr(out, 1, name)
    if name == "sub_block" and isinstance(value, int):
        # control-flow block reference: framework.proto AttrType BLOCK,
        # not INT — While/cond would fail the reference's type check
        _wvarint_field(out, 2, 8)
        _wvarint_field(out, 12, value)
    elif name in ("sub_blocks", "blocks") and isinstance(
            value, (list, tuple)) and all(
            isinstance(v, int) and not isinstance(v, bool) for v in value):
        _wvarint_field(out, 2, 10)                    # BLOCKS
        for v in value:
            _wvarint_field(out, 14, v)
    elif isinstance(value, bool):                     # before int!
        _wvarint_field(out, 2, 6)
        _wvarint_field(out, 10, int(value))
    elif isinstance(value, int):
        if -(1 << 31) <= value < (1 << 31):
            _wvarint_field(out, 2, 0)
            _wvarint_field(out, 3, value)
        else:
            _wvarint_field(out, 2, 9)                 # LONG
            _wvarint_field(out, 13, value)
    elif isinstance(value, float):
        _wvarint_field(out, 2, 1)
        _wtag(out, 4, 5)
        out.extend(struct.pack("<f", value))
    elif isinstance(value, str):
        _wvarint_field(out, 2, 2)
        _wstr(out, 5, value)
    elif isinstance(value, (list, tuple)):
        vals = list(value)
        if not vals:
            # an empty list carries no element-type evidence; emitting a
            # guessed AttrType would fail the reference's C++ type check —
            # omit it (op defaults apply) via the caller's warning path
            return None
        if all(isinstance(v, bool) for v in vals):
            _wvarint_field(out, 2, 7)
            for v in vals:
                _wvarint_field(out, 11, int(v))
        elif all(isinstance(v, int) for v in vals):
            if all(-(1 << 31) <= v < (1 << 31) for v in vals):
                _wvarint_field(out, 2, 3)             # INTS
                for v in vals:
                    _wvarint_field(out, 6, v)
            else:
                _wvarint_field(out, 2, 11)            # LONGS
                for v in vals:
                    _wvarint_field(out, 15, v)
        elif all(isinstance(v, (int, float)) for v in vals):
            # mixed int/float (e.g. aspect_ratios=[1, 2, 0.5]): FLOATS —
            # dropping the attr would silently serve with op defaults
            _wvarint_field(out, 2, 4)
            for v in vals:
                _wtag(out, 7, 5)
                out.extend(struct.pack("<f", float(v)))
        elif all(isinstance(v, str) for v in vals):
            _wvarint_field(out, 2, 5)
            for v in vals:
                _wstr(out, 8, v)
        else:
            return None
    else:
        return None
    return bytes(out)


def _encode_op(op_type, inputs, outputs, attrs):
    out = bytearray()
    for slot, args in inputs.items():
        var = bytearray()
        _wstr(var, 1, slot)
        for a in args:
            _wstr(var, 2, a)
        _wbytes(out, 1, var)
    for slot, args in outputs.items():
        var = bytearray()
        _wstr(var, 1, slot)
        for a in args:
            _wstr(var, 2, a)
        _wbytes(out, 2, var)
    _wstr(out, 3, op_type)
    for name, value in attrs.items():
        enc = _encode_attr(name, value)
        if enc is not None:
            _wbytes(out, 4, enc)
        else:
            import warnings
            if isinstance(value, (list, tuple)) and not value:
                reason = ("is an empty list (no element-type evidence; "
                          "the op default applies on the reference)")
            else:
                reason = f"has unencodable type {type(value).__name__}"
            warnings.warn(
                f"attr '{name}' of op '{op_type}' {reason}; omitted from "
                "the exported ProgramDesc", RuntimeWarning, stacklevel=2)
    return bytes(out)


def _encode_var(name, dtype, dims, persistable, kind=7):
    td = bytearray()
    np_dtype = np.dtype("float32" if dtype in (None, "") else dtype)
    if np_dtype not in _ENUM_BY_DTYPE:
        # e.g. bfloat16: the fluid 1.5 format has no enum for it; writing
        # FP32 silently would make the reference execute wrong numerics
        raise ValueError(
            f"var '{name}' dtype {dtype} has no fluid enum; cast the "
            "program to a supported dtype before exporting")
    _wvarint_field(td, 1, _ENUM_BY_DTYPE[np_dtype])
    for d in dims:
        _wvarint_field(td, 2, int(d))
    lod = bytearray()
    _wbytes(lod, 1, td)
    vtype = bytearray()
    _wvarint_field(vtype, 1, kind)
    if kind == 7:
        _wbytes(vtype, 3, lod)
    out = bytearray()
    _wstr(out, 1, name)
    _wbytes(out, 2, vtype)
    if persistable:
        _wvarint_field(out, 3, 1)
    return bytes(out)


def _slice_for_inference(program, fetch_names):
    """Backward-slice the global block to ops the fetches need, WITHOUT
    Program._prune's keep-persistable-writers rule (that rule preserves
    optimizer/stat updates — training semantics; an inference export must
    shed them, matching the reference's save_inference_model pruning)."""
    gb = program.global_block()
    need = set(fetch_names)
    keep = []
    for op in reversed(gb.ops):
        if set(op.output_names) & need:
            keep.append(op)
            need |= set(op.input_names)
    gb.ops = list(reversed(keep))
    program._bump_version()
    return program


def encode_program_desc(program, feed_names=(), fetch_names=(),
                        only_vars=None):
    """Program -> reference ProgramDesc bytes, with the feed/
    fetch plumbing the reference's load_inference_model expects.
    `only_vars`: restrict global-block var descs to these names (the
    inference exporter passes the referenced-var set so grad/optimizer
    vars stay out of __model__)."""
    out = bytearray()
    for blk in program.blocks:
        b = bytearray()
        _wvarint_field(b, 1, blk.idx)
        _wvarint_field(b, 2, blk.parent_idx)
        if blk.idx == 0:
            _wbytes(b, 3, _encode_var("feed", "float32", [], True, kind=9))
            _wbytes(b, 3, _encode_var("fetch", "float32", [], True, kind=10))
        for v in blk.vars.values():
            if blk.idx == 0 and only_vars is not None \
                    and v.name not in only_vars:
                continue
            _wbytes(b, 3, _encode_var(
                v.name, getattr(v, "dtype", "float32") or "float32",
                list(getattr(v, "shape", None) or []),
                bool(getattr(v, "persistable", False))))
        if blk.idx == 0:
            for col, name in enumerate(feed_names):
                _wbytes(b, 4, _encode_op(
                    "feed", {"X": ["feed"]}, {"Out": [name]}, {"col": col}))
        for op in blk.ops:
            _wbytes(b, 4, _encode_op(op.type, op.inputs, op.outputs,
                                     op.attrs))
        if blk.idx == 0:
            for col, name in enumerate(fetch_names):
                _wbytes(b, 4, _encode_op(
                    "fetch", {"X": [name]}, {"Out": ["fetch"]},
                    {"col": col}))
        _wbytes(out, 1, b)
    return bytes(out)


def save_fluid_inference_model(dirname, feed_names, fetch_vars, executor,
                               main_program=None, model_filename=None,
                               params_filename=None, scope=None):
    """Export in the REFERENCE's save_inference_model layout (`__model__`
    ProgramDesc + weights), so models trained here serve on the
    original PaddlePaddle. Contract mirrors our save_inference_model."""
    from ..core import framework
    from ..core.executor import global_scope
    from .fluid_format import save_fluid_vars
    from .state import host_array

    program = main_program or framework.default_main_program()
    scope = scope or global_scope()
    fetch_names = [v.name if hasattr(v, "name") else v for v in fetch_vars]
    pruned = _slice_for_inference(program.clone(for_test=True), fetch_names)
    gb = pruned.global_block()
    referenced = set(feed_names) | set(fetch_names)
    for op in gb.ops:
        referenced |= set(op.input_names) | set(op.output_names)
    # validate EVERYTHING (params present, dtypes encodable) before any
    # write — a partial export (dangling __model__) would flip Predictor's
    # format dispatch for the whole dir
    persist, missing = {}, []
    for v in gb.vars.values():
        if v.persistable and v.name in referenced \
                and v.name not in ("feed", "fetch"):
            val = scope.get(v.name)
            if val is None:
                missing.append(v.name)
            else:
                arr = host_array(val)
                if arr.dtype not in _ENUM_BY_DTYPE:
                    raise ValueError(
                        f"param '{v.name}' dtype {arr.dtype} has no fluid "
                        "enum; cast (e.g. bf16 -> fp32) before exporting")
                persist[v.name] = arr
    if missing:
        raise ValueError(
            f"persistables have no value in the scope (did startup run "
            f"here?): {missing}")
    raw = encode_program_desc(pruned, feed_names, fetch_names,
                              only_vars=referenced)
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, model_filename or "__model__"),
              "wb") as f:
        f.write(raw)
    save_fluid_vars(dirname, persist, filename=params_filename)
    return list(persist)


def load_fluid_inference_model(dirname, executor=None, model_filename=None,
                               params_filename=None, scope=None):
    """Load a model exported by the REFERENCE's save_inference_model.

    Reads `__model__` (or model_filename), builds the Program on our op
    registry, loads the per-var (or combined params_filename) weights
    into the scope (as tensors on `executor`'s device, the card without
    one), and returns (program, feed_names, fetch_names) — the same
    contract as our load_inference_model.
    """
    from ..core.executor import global_scope
    from .state import device_tensor, target_device

    path = os.path.join(dirname, model_filename or "__model__")
    with open(path, "rb") as f:
        program = parse_program_desc(f.read())
    feed_names, fetch_names = _strip_feed_fetch(program)

    gb = program.global_block()
    persist = [v.name for v in gb.vars.values() if v.persistable]
    loaded = load_fluid_vars(
        dirname,
        var_names=persist if params_filename else None,
        filename=params_filename)
    scope = scope or global_scope()
    dev = target_device(executor)
    for name in persist:
        if name in loaded:
            scope.set(name, device_tensor(loaded[name], dev))
    missing = [n for n in persist if n not in loaded]
    if missing:
        raise ValueError(f"inference model params missing: {missing}")
    return program, feed_names, fetch_names
