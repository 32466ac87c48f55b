"""Reference-binary checkpoint interop: read/write Fluid's LoDTensor files.

Parity: paddle/fluid/framework/lod_tensor.cc SerializeToStream:219 /
DeserializeFromStream and tensor_util.cc TensorToStream — the on-disk
format `fluid.io.save_params/save_persistables` produced; the port's own
copy of ``paddle_tpu/io/fluid_format.py``, byte for byte the same files.
A user switching from the reference brings their trained weights as-is:

    n, missing = io.load_fluid_persistables("/path/to/saved_model",
                                            main_program=main,
                                            executor=exe)
    # or raw: params = io.load_fluid_vars("/path/to/saved_model")

Layout (little-endian):
  u32 lod_version(0) | u64 lod_levels | per level: u64 nbytes + u64 data[]
  u32 tensor_version(0) | i32 desc_size | TensorDesc proto | raw data
TensorDesc proto (framework.proto VarType.TensorDesc): field 1 varint
data_type enum, field 2 repeated int64 dims (unpacked tags 0x10; packed
0x12 accepted on read). The tiny proto codec is hand-rolled here — the
format is fixed by the reference's wire compatibility, not its code.
"""

import os
import struct

import numpy as np

# framework.proto VarType.Type enum values for POD tensor dtypes
_DTYPE_BY_ENUM = {0: np.bool_, 1: np.int16, 2: np.int32, 3: np.int64,
                  4: np.float16, 5: np.float32, 6: np.float64,
                  20: np.uint8, 21: np.int8}
_ENUM_BY_DTYPE = {np.dtype(v): k for k, v in _DTYPE_BY_ENUM.items()}


def _read_varint(buf, off):
    result, shift = 0, 0
    while True:
        b = buf[off]
        off += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, off
        shift += 7


def _write_varint(out, value):
    if value < 0:                    # proto2: two's-complement 64-bit
        value += 1 << 64
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _signed64(v):
    return v - (1 << 64) if v >= (1 << 63) else v


def parse_tensor_desc_wire(buf):
    """(data_type enum, signed dims) from a VarType.TensorDesc blob —
    the ONE wire parser shared by fluid_format and fluid_proto."""
    off, dtype_enum, dims = 0, None, []
    while off < len(buf):
        tag, off = _read_varint(buf, off)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 0:          # data_type
            dtype_enum, off = _read_varint(buf, off)
        elif field == 2 and wire == 0:        # dims, unpacked
            d, off = _read_varint(buf, off)
            dims.append(_signed64(d))
        elif field == 2 and wire == 2:        # dims, packed
            ln, off = _read_varint(buf, off)
            end = off + ln
            while off < end:
                d, off = _read_varint(buf, off)
                dims.append(_signed64(d))
        elif wire == 0:
            _, off = _read_varint(buf, off)
        elif wire == 2:
            ln, off = _read_varint(buf, off)
            off += ln
        else:
            raise ValueError(f"unsupported wire type {wire} in TensorDesc")
    return dtype_enum, dims


def _parse_tensor_desc(buf):
    """(np dtype, dims) from a VarType.TensorDesc proto blob."""
    dtype_enum, dims = parse_tensor_desc_wire(buf)
    if dtype_enum not in _DTYPE_BY_ENUM:
        raise ValueError(f"unsupported fluid data_type enum {dtype_enum}")
    return np.dtype(_DTYPE_BY_ENUM[dtype_enum]), dims


def _build_tensor_desc(arr):
    out = bytearray()
    _write_varint(out, (1 << 3) | 0)              # field 1, varint
    _write_varint(out, _ENUM_BY_DTYPE[arr.dtype])
    for d in arr.shape:
        _write_varint(out, (2 << 3) | 0)          # field 2, unpacked
        _write_varint(out, d)
    return bytes(out)


def read_lod_tensor(stream):
    """-> (ndarray, lod) from a reference-format stream (file object)."""
    (lod_version,) = struct.unpack("<I", stream.read(4))
    if lod_version != 0:
        raise ValueError(f"unsupported LoDTensor version {lod_version}")
    (lod_levels,) = struct.unpack("<Q", stream.read(8))
    lod = []
    for _ in range(lod_levels):
        (nbytes,) = struct.unpack("<Q", stream.read(8))
        level = np.frombuffer(stream.read(nbytes), dtype=np.uint64)
        lod.append([int(x) for x in level])
    (tensor_version,) = struct.unpack("<I", stream.read(4))
    if tensor_version != 0:
        raise ValueError(f"unsupported tensor version {tensor_version}")
    (desc_size,) = struct.unpack("<i", stream.read(4))
    dtype, dims = _parse_tensor_desc(stream.read(desc_size))
    count = int(np.prod(dims, dtype=np.int64)) if dims else 1
    data = stream.read(count * dtype.itemsize)
    arr = np.frombuffer(data, dtype=dtype, count=count).reshape(dims)
    return arr.copy(), lod


def write_lod_tensor(stream, arr, lod=None):
    """Write one array in the reference LoDTensor stream format."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in _ENUM_BY_DTYPE:
        raise ValueError(f"dtype {arr.dtype} has no fluid enum")
    stream.write(struct.pack("<I", 0))
    lod = lod or []
    stream.write(struct.pack("<Q", len(lod)))
    for level in lod:
        level = np.asarray(level, dtype=np.uint64)
        stream.write(struct.pack("<Q", level.nbytes))
        stream.write(level.tobytes())
    stream.write(struct.pack("<I", 0))
    desc = _build_tensor_desc(arr)
    stream.write(struct.pack("<i", len(desc)))
    stream.write(desc)
    stream.write(arr.tobytes())


def load_fluid_vars(dirname, var_names=None, filename=None):
    """Read reference-saved persistables -> {name: ndarray}.

    Per-var layout (save_persistables with filename=None): one file per
    variable, named by the variable. Combined layout (save_combine):
    `filename` holds the tensors concatenated in `var_names` order —
    var_names is required then, exactly like the reference's load_combine.
    """
    out = {}
    if filename is not None:
        if not var_names:
            raise ValueError("combined-file loading needs var_names order")
        with open(os.path.join(dirname, filename), "rb") as f:
            for name in var_names:
                arr, _lod = read_lod_tensor(f)
                out[name] = arr
            if f.read(1):
                raise ValueError("trailing bytes: var_names incomplete?")
        return out
    explicit = var_names is not None
    names = var_names if explicit else sorted(os.listdir(dirname))
    for name in names:
        path = os.path.join(dirname, name)
        if not os.path.isfile(path):
            if explicit:
                raise FileNotFoundError(
                    f"requested var '{name}' has no file in {dirname}")
            continue
        try:
            with open(path, "rb") as f:
                arr, _lod = read_lod_tensor(f)
        except (ValueError, struct.error, IndexError, EOFError):
            if explicit:
                raise       # explicitly requested: surface the parse error
            continue        # directory scan: skip non-tensor/corrupt files
        out[name] = arr
    return out


def save_fluid_vars(dirname, vars_dict, filename=None, var_order=None):
    """Write {name: array or tensor} in the reference binary format
    (round-trip to the original PaddlePaddle — migration works in both
    directions)."""
    from .state import host_array
    os.makedirs(dirname, exist_ok=True)
    if filename is not None:
        # default to INSERTION order (callers build vars_dict in program
        # declaration order — what the reference's save_combine writes and
        # what load_fluid_persistables reads back); sorting here would
        # silently permute same-shaped tensors on the round trip
        order = var_order if var_order is not None else list(vars_dict)
        with open(os.path.join(dirname, filename), "wb") as f:
            for name in order:
                write_lod_tensor(f, host_array(vars_dict[name]))
        return
    for name, arr in vars_dict.items():
        with open(os.path.join(dirname, name), "wb") as f:
            write_lod_tensor(f, host_array(arr))


def load_fluid_persistables(dirname, main_program=None, filename=None,
                            scope=None, executor=None):
    """Reference-checkpoint -> live scope: reads every persistable var of
    `main_program` (default main) from a reference-format save dir and
    sets it, shape-checked, as tensors on `executor`'s device (the card
    without one). The migration entry point."""
    from ..core import framework
    from ..core.executor import global_scope
    from .state import device_tensor, target_device

    program = main_program or framework.default_main_program()
    scope = scope or global_scope()
    dev = target_device(executor)
    names = [v.name for v in program.list_vars()
             if v.persistable and v.name not in ("feed", "fetch")]
    loaded = load_fluid_vars(dirname, var_names=names if filename else None,
                             filename=filename)
    missing, set_count = [], 0
    for v in program.list_vars():
        if not v.persistable or v.name in ("feed", "fetch"):
            continue
        if v.name not in loaded:
            missing.append(v.name)
            continue
        arr = loaded[v.name]
        want = tuple(int(d) for d in v.shape)
        if want:
            ok = len(arr.shape) == len(want) and all(
                w == -1 or int(a) == w for a, w in zip(arr.shape, want))
        else:
            # scalar-declared var: accept () or a single element, reject
            # real tensors (silently storing one breaks far from here)
            ok = arr.ndim == 0 or arr.size == 1
        if not ok:
            raise ValueError(
                f"shape mismatch for '{v.name}': checkpoint "
                f"{tuple(arr.shape)} vs program {want or '()'}")
        scope.set(v.name, device_tensor(arr, dev))
        set_count += 1
    return set_count, missing
