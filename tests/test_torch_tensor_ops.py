"""The port's tensor and math ops against the JAX package, on the CPU:
the 45 names of ``ops/tensor_ops.py`` and the 8 of ``math_ops.py`` that
ROADMAP item 10c.6e ports, each forward and, where it is
differentiable, with the gradient of one seeded cotangent
(``test_torch_seq2seq.op_twin``), and the layers over them
(``layers.tensor``'s rest, ``layers.nn``'s tensor layers) through both
Executors.

Cases mirror ``tests/ops/test_uncovered_ops.py``, ``_r4.py``, ``_r4b.py``,
``_r4c.py``, ``test_op_numerics.py``, ``test_extended_ops.py``,
``test_audit_gap_ops.py`` and ``tests/api/test_semantic_parity.py``,
``test_semantic_parity2.py``, ``test_layer_gaps_r4.py`` and
``test_int64_policy.py``, with each trouble point of the slice: indices
out of range (XLA wraps a negative index once, clamps a gather's and
drops a scatter's; the port masks them to give the same answer, where
a CUDA gather or scatter would assert), duplicate scatter indices, the
fixed-size padding of ``where`` and ``unique``, ``hash`` on negative
ids and ids past 2^31, ties and signed zeros in ``argsort``, negative
strides, every pad mode, crops at attr and tensor offsets. Integer
outputs are int64 where the JAX package's are int32 (C12's policy,
ROADMAP C18); the twins compare values.

The registry test lists the JAX op names the port still lacks, by name;
the layer-surface test lists the ``fluid.layers`` names it lacks. The dp
cases run small Programs at dp 2 on a local CPU mesh against the plain
Executor, and each refusal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu.ops import _REGISTRY as JREG

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.core import unique_name as tun
from paddle_tpu_torch.ops import _REGISTRY as TREG, _DP_RULES

from test_torch_detection_ops import both
from test_torch_seq2seq import _JCtx, _TCtx, op_twin, run_layers

CPU = fluid.CPUPlace()
# f32 outputs within 1e-6 relative, with an absolute floor of 1e-6 of
# the output's largest entry (the sums of dot, the norms and the
# losses in another order than XLA's); integer and bool outputs equal.
# The gradients of a seeded cotangent within 1e-5 of the gradient's
# largest entry.
RTOL = 1e-6
GRAD_TOL = 1e-5
# dp 2 against dp 1: the same numbers but each rank's summation order,
# within 1e-6 of their scale
DP_TOL = 1e-6

RS = np.random.RandomState(24)

# the JAX op names the port does not register: none. Item 11's moe
# (expert parallelism) and 13 collectives and 10c.6f's quant (11),
# sampling (3) and match (5) ops are ported
NOT_PORTED = {
    "10c.6f": [],
    "11": []}

# the fluid.layers names the port does not have: layers.io's six readers
# (item 11c) and the JAX modules' own imports; item 11a's layers.moe and
# 10c.6f's eight layers are ported
LAYERS_NOT_PORTED = {
    "10c.6f": [],
    "11": ["py_reader", "PyReader", "double_buffer", "read_file",
           "load", "create_py_reader_by_data"],
    "imports": ["np", "Variable", "LayerHelper", "builtins_sum",
                "init_mod"]}

THE_SLICE = [
    "shape", "rank", "size", "split", "transpose", "flatten", "flatten2",
    "stack", "unstack", "strided_slice", "gather_nd", "scatter",
    "scatter_nd_add", "expand_as", "tile", "pad", "pad2d",
    "pad_constant_like", "arg_max", "arg_min", "argsort", "where",
    "where_index_select", "reverse", "linspace", "eye", "diag", "embedding",
    "lookup_table_v2", "unique_with_counts", "unique", "shard_index",
    "space_to_depth", "pixel_shuffle", "shuffle_channel", "assign_value",
    "scatter_nd", "multiplex", "crop", "crop_tensor", "hash", "lod_reset",
    "lod_append", "merge_selected_rows", "get_tensor_from_selected_rows",
    "has_inf", "has_nan", "dot", "minus", "l1_norm", "squared_l2_norm",
    "fill", "conv_shift"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_bert.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _r(*shape, lo=-1.0, hi=1.0):
    return RS.uniform(lo, hi, shape).astype(np.float32)


def close(got, want, rtol=RTOL, name=""):
    """`got` against `want`: the shape, then the values (exactly for
    integers and bools, within rtol and rtol x the largest entry for
    floats, non-finite entries where they are)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    finite = np.isfinite(want)
    scale = float(np.abs(want[finite]).max()) if finite.any() else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=name)


def grads_close(grads):
    for k, (jg, tg) in grads.items():
        jg, tg = np.asarray(jg), np.asarray(tg)
        scale = max(float(np.abs(jg).max()), 1e-12)
        err = float(np.abs(tg - jg).max())
        assert err <= GRAD_TOL * scale, (k, err, scale)


def check(op, ins, attrs, slot, grad=()):
    """The op's `slot` and the gradients of `grad` against JAX's; the
    port's output (numpy)."""
    jout, tout, grads = op_twin(op, ins, attrs, slot, grad=grad)
    close(tout, jout, name=f"{op}.{slot}")
    grads_close(grads)
    return tout


def same(op, ins, attrs, slots):
    """Each of `slots` of the op in both packages held; the port's as
    numpy."""
    j, t = both(op, ins, attrs)
    out = {}
    for s in slots:
        if isinstance(j[s], list):
            assert len(j[s]) == len(t[s])
            for a, b in zip(j[s], t[s]):
                close(b.numpy(), a, name=s)
            out[s] = [b.numpy() for b in t[s]]
        else:
            close(t[s].detach().numpy(), j[s], name=s)
            out[s] = t[s].detach().numpy()
    return out


# ---------------------------------------------------------------------------
# the registry and the layer surface
# ---------------------------------------------------------------------------

def test_the_registry_lacks_only_10c6f_and_item_11():
    """The port registers every JAX op name: item 11's moe (expert
    parallelism) and 13 collective ops are ported, and 10c.6f lacks none
    (quant 11, sampling 3, match 5 ported); besides them it has its own
    select_finite (C8): 374, the JAX package's 373 and that one."""
    missing = sorted(set(JREG) - set(TREG))
    assert NOT_PORTED["10c.6f"] == []
    want = sorted(NOT_PORTED["11"])
    assert len(want) == 0
    assert missing == want
    assert sorted(set(TREG) - set(JREG)) == ["select_finite"]
    assert len(JREG) == 373
    assert len(TREG) == 374


def test_the_slice_registers_every_op_with_a_dp_rule():
    assert len(THE_SLICE) == 53
    for name in THE_SLICE:
        assert name in TREG and _DP_RULES[name] is not None, name


def test_the_layer_surface_lacks_only_named_names():
    """sorted(set(dir(paddle_tpu.layers)) - set(dir(the port's))) holds
    only layers.io's six readers (item 11c) and the JAX modules' own
    imports, by name (none of 10c.6f's, no layers.moe); layers.tensor,
    layers.loss, layers.metric_op and layers.sequence lack none of the
    JAX modules' public names."""
    missing = sorted(set(dir(jfluid.layers)) - set(dir(tlayers)))
    assert LAYERS_NOT_PORTED["10c.6f"] == []
    assert missing == sorted(sum(LAYERS_NOT_PORTED.values(), []))
    for mod in ("tensor", "loss", "metric_op", "sequence"):
        lack = {n for n in set(dir(getattr(jfluid.layers, mod)))
                - set(dir(getattr(tlayers, mod))) if not n.startswith("_")}
        assert lack <= {"Variable", "np"}, (mod, lack)
    from paddle_tpu_torch.layers import tensor
    for name in ("cast", "concat", "argmin", "argmax", "argsort"):
        assert getattr(tensor, name) is getattr(tlayers.nn, name)


# ---------------------------------------------------------------------------
# shapes, splits and joins
# ---------------------------------------------------------------------------

def test_shape_rank_size():
    """shape (int32), rank (int32) and size (int64 here, JAX's int32)."""
    x = _r(3, 4, 5)
    assert same("shape", {"Input": x}, {}, ["Out"])["Out"].dtype == np.int32
    same("rank", {"Input": x}, {}, ["Out"])
    assert same("size", {"Input": x}, {}, ["Out"])["Out"] == 60


@pytest.mark.parametrize("attrs", [
    {"axis": 1, "num": 2}, {"axis": 2, "sections": [1, 3, 1]},
    {"axis": 0, "num": 3}])
def test_split(attrs):
    same("split", {"X": _r(3, 4, 5)}, attrs, ["Out"])


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_stack_unstack(axis):
    xs = [_r(3, 4) for _ in range(3)]
    y = same("stack", {"X": xs}, {"axis": axis}, ["Y"])["Y"]
    same("unstack", {"X": y}, {"axis": axis}, ["Y"])
    check("stack", {"X": xs}, {"axis": axis}, "Y", grad=("X",))


@pytest.mark.parametrize("op,axis", [("flatten", 1), ("flatten2", 2),
                                     ("flatten", 0)])
def test_flatten(op, axis):
    check(op, {"X": _r(2, 3, 4, 5)}, {"axis": axis}, "Out", grad=("X",))


def test_transpose_alias():
    check("transpose", {"X": _r(2, 3, 4)}, {"axis": [2, 0, 1]}, "Out",
          grad=("X",))


@pytest.mark.parametrize("axes,starts,ends,strides", [
    ([0, 2], [1, 0], [3, 5], [1, 2]),
    ([1], [-1], [-5], [-1]),
    ([0, 1], [3, 4], [0, -100], [-2, -3]),
    ([2], [-100], [100], [3]),
    ([1], [2], [2], [-1])])
def test_strided_slice(axes, starts, ends, strides):
    """Python's slice rules: negative strides walk back, ends past the
    dim clamp, an empty range gives an empty axis."""
    check("strided_slice", {"Input": _r(4, 5, 6)},
          {"axes": axes, "starts": starts, "ends": ends, "strides": strides},
          "Out", grad=("Input",))


def test_expand_as_and_tile():
    check("expand_as", {"X": _r(2, 1, 3), "target_tensor": _r(4, 5, 3)}, {},
          "Out", grad=("X",))
    for reps in ([2, 3], [2, 1, 2], [3, 1, 2, 2]):
        check("tile", {"X": _r(2, 3)[None]}, {"repeat_times": reps}, "Out",
              grad=("X",))


# ---------------------------------------------------------------------------
# gathers and scatters by index: out-of-range and duplicate indices
# ---------------------------------------------------------------------------

def test_gather_nd_wraps_and_clamps():
    """Full and partial index tuples with in-range, negative and
    out-of-range entries: XLA wraps a negative index once and clamps
    the result, which the port copies (the gradient lands where the
    clamped index points)."""
    x = _r(4, 3, 2)
    idx = np.array([[5, 1], [-1, 4], [-7, 0], [2, -1], [1, 2]], np.int64)
    check("gather_nd", {"X": x, "Index": idx}, {}, "Out", grad=("X",))
    idx3 = np.array([[[0, 1, 1], [3, 2, 0]], [[-1, -1, -1], [9, 9, 9]]])
    check("gather_nd", {"X": x, "Index": idx3}, {}, "Out", grad=("X",))
    check("gather_nd", {"X": x, "Index": np.array([[2], [-3], [6]])}, {},
          "Out", grad=("X",))


def test_scatter_add_drops_out_of_range_and_sums_duplicates():
    """overwrite=False: duplicate ids add up; an id past the end (and
    one below -n) is dropped, -1 wraps to the last row, as XLA's
    scatter reads them."""
    x = _r(5, 3)
    ids = np.array([1, 1, -1, 7, -9, 0], np.int64)
    check("scatter", {"X": x, "Ids": ids, "Updates": _r(6, 3)},
          {"overwrite": False}, "Out", grad=("X", "Updates"))


def test_scatter_overwrite_unique_ids():
    x = _r(6, 2)
    ids = np.array([4, 0, -3, 9], np.int64)
    check("scatter", {"X": x, "Ids": ids, "Updates": _r(4, 2)},
          {"overwrite": True}, "Out", grad=("X", "Updates"))


def test_scatter_overwrite_duplicates_take_one_update():
    """Duplicate ids with overwrite: XLA leaves the winner unspecified
    and torch's CUDA index_copy is nondeterministic, so JAX is no oracle
    here; the expectation is derived independently: each duplicated row
    equals one of its group's updates, every other row is X's or its one
    update."""
    x = _r(5, 3)
    upd = _r(5, 3)
    ids = np.array([2, 4, 2, 2, 0], np.int64)
    _, t = both("scatter", {"X": x, "Ids": ids, "Updates": upd},
                {"overwrite": True})
    out = t["Out"].numpy()
    assert any(np.array_equal(out[2], upd[k]) for k in (0, 2, 3))
    np.testing.assert_array_equal(out[4], upd[1])
    np.testing.assert_array_equal(out[0], upd[4])
    np.testing.assert_array_equal(out[[1, 3]], x[[1, 3]])


def test_scatter_nd_add_and_scatter_nd():
    """Tuples with duplicates add up; a tuple with any index out of
    range is dropped, a negative one wraps."""
    x = _r(3, 4, 2)
    idx = np.array([[0, 1], [0, 1], [2, -1], [3, 0], [1, 5], [-4, 0]])
    check("scatter_nd_add", {"X": x, "Index": idx, "Updates": _r(6, 2)},
          {}, "Out", grad=("X", "Updates"))
    check("scatter_nd", {"Index": idx, "Updates": _r(6, 2)},
          {"shape": [3, 4, 2]}, "Out", grad=("Updates",))
    full = np.array([[1, 1, 1], [1, 1, 1], [0, 3, 0], [2, 0, 2]])
    check("scatter_nd_add", {"X": x, "Index": full, "Updates": _r(4)}, {},
          "Out", grad=("X", "Updates"))


def test_multiplex_picks_rows_and_fills_out_of_range():
    """Row b of X[Ids[b]]; Ids -1 wraps to the last candidate, an id past
    the end gives take_along_axis's NaN row."""
    xs = [_r(5, 3) for _ in range(3)]
    ids = np.array([[0], [2], [-1], [1], [4]], np.int64)
    out = same("multiplex", {"X": xs, "Ids": ids}, {}, ["Out"])["Out"]
    assert np.isnan(out[4]).all() and np.isfinite(out[:4]).all()
    ok = np.array([[0], [2], [1], [1], [0]], np.int64)
    check("multiplex", {"X": xs, "Ids": ok}, {}, "Out", grad=("X",))


# ---------------------------------------------------------------------------
# pads, crops and channel orders
# ---------------------------------------------------------------------------

def test_pad_and_pad_constant_like():
    check("pad", {"X": _r(2, 3, 4)},
          {"paddings": [1, 0, 0, 2, 3, 1], "pad_value": 0.5}, "Out",
          grad=("X",))
    check("pad_constant_like", {"X": _r(4, 5, 3), "Y": _r(2, 5, 1)},
          {"pad_value": -1.5}, "Out", grad=("Y",))


@pytest.mark.parametrize("mode", ["constant", "reflect", "edge"])
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_pad2d_modes(mode, fmt):
    """reflect leaves the edge out, edge repeats it (jnp.pad's modes)."""
    x = _r(2, 3, 4, 5)
    check("pad2d", {"X": x}, {"paddings": [1, 2, 3, 0], "mode": mode,
                              "pad_value": 0.7, "data_format": fmt}, "Out",
          grad=("X",))


@pytest.mark.parametrize("shape,offsets", [
    ([2, 2, 3], [1, 0, 2]), ([-1, 3, 0], [1, 1, 2]), ([3, 4, 5], None)])
def test_crop_static_offsets(shape, offsets):
    check("crop_tensor", {"X": _r(3, 4, 5)},
          {"shape": shape, "offsets": offsets}, "Out", grad=("X",))


def test_crop_tensor_offsets_clamp_as_dynamic_slice():
    """Offsets as an input tensor: a negative one wraps and the window is
    clamped to fit, as lax.dynamic_slice reads its start; -1 sizes
    refuse."""
    x = _r(4, 6, 5)
    for off in ([1, 2, 0], [3, 5, 4], [-2, 0, 1]):
        check("crop", {"X": x, "Offsets": np.array(off, np.int32)},
              {"shape": [2, 3, 4]}, "Out", grad=("X",))
    with pytest.raises(NotImplementedError, match="dynamic"):
        both("crop", {"X": x, "Offsets": np.array([0, 0, 0], np.int32)},
             {"shape": [-1, 3, 4]})


def test_space_to_depth_pixel_shuffle_shuffle_channel():
    """The JAX package's channel orders, and pixel_shuffle undoing
    nothing it should not: each against JAX, forward and backward."""
    check("space_to_depth", {"X": _r(2, 3, 4, 6)}, {"blocksize": 2}, "Out",
          grad=("X",))
    check("pixel_shuffle", {"X": _r(2, 8, 3, 2)}, {"upscale_factor": 2},
          "Out", grad=("X",))
    check("shuffle_channel", {"X": _r(2, 6, 3, 2)}, {"group": 3}, "Out",
          grad=("X",))


# ---------------------------------------------------------------------------
# sorts, arg-reductions and the fixed-size scans
# ---------------------------------------------------------------------------

def _ties():
    x = np.array([[3.0, 1.0, 3.0, -0.0, 0.0, 1.0, np.nan, 0.0],
                  [2.0, 2.0, -1.0, 2.0, -0.0, -1.0, 5.0, 0.0]], np.float32)
    return x


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("axis", [-1, 0])
def test_argsort_ties_signed_zeros_nan(descending, axis):
    """A stable sort of x (of -x when descending): equal values keep
    their order, 0.0 and -0.0 tie, NaN sorts last; values and int64
    indices equal to JAX's."""
    x = _ties()
    out = same("argsort", {"X": x}, {"axis": axis, "descending": descending},
               ["Out", "Indices"])
    assert out["Indices"].dtype == np.int64
    check("argsort", {"X": _r(3, 7)}, {"axis": axis,
                                       "descending": descending}, "Out",
          grad=("X",))


@pytest.mark.parametrize("op", ["arg_max", "arg_min"])
def test_arg_max_min_take_the_first_extreme(op):
    x = np.array([[1, 5, 5, 0], [2, 2, -3, -3], [7, 7, 7, 7]], np.float32)
    for axis in (-1, 0, 1):
        out = same(op, {"X": x}, {"axis": axis}, ["Out"])["Out"]
        assert out.dtype == np.int64


def test_where_pads_with_minus_one():
    """The flat positions of the true entries, in order, then -1: (n, 1)
    for n entries, whatever the count (none, some, all)."""
    for c in (np.zeros((2, 3), bool), RS.rand(3, 4) > 0.5,
              np.ones(5, bool), np.array([0, 2, 0, -1], np.int32)):
        out = same("where", {"Condition": c}, {}, ["Out"])["Out"]
        assert out.shape == (c.size, 1) and out.dtype == np.int64


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_unique_with_counts_pads_with_zero(dtype):
    """The sorted distinct values padded with 0 to x's size, each entry's
    index among them in x's shape, each value's count padded with 0;
    Index and Count follow `dtype` (int64 kept here, where the JAX
    package narrows it to int32)."""
    x = np.array([[3, 1, 7], [3, -2, 1]], np.int64)
    out = same("unique_with_counts", {"X": x}, {"dtype": dtype},
               ["Out", "Index", "Count"])
    assert out["Index"].shape == (2, 3)
    assert out["Index"].dtype == np.dtype(dtype)
    same("unique", {"X": _r(7).round(1)}, {}, ["Out", "Index", "Count"])
    same("unique", {"X": np.full(4, 2.5, np.float32)}, {},
         ["Out", "Index", "Count"])


# ---------------------------------------------------------------------------
# constants and small tables
# ---------------------------------------------------------------------------

def test_reverse_linspace_eye_diag():
    check("reverse", {"X": _r(3, 4, 2)}, {"axis": [0, -1]}, "Out",
          grad=("X",))
    same("linspace", {}, {"start": -1.0, "stop": 2.0, "num": 7}, ["Out"])
    same("linspace", {}, {"start": 0.0, "stop": 10.0, "num": 4,
                          "dtype": "int32"}, ["Out"])
    same("linspace", {}, {"start": 3.0, "stop": 3.0, "num": 1}, ["Out"])
    same("eye", {}, {"num_rows": 3, "num_columns": 5}, ["Out"])
    check("diag", {"Diagonal": _r(4)}, {}, "Out", grad=("Diagonal",))
    same("diag", {"Diagonal": _r(3, 3)}, {}, ["Out"])


def test_assign_value_and_fill():
    vals = _r(6)
    same("assign_value", {}, {"shape": [2, 3], "dtype": "float32",
                              "values": vals.tolist()}, ["Out"])
    same("assign_value", {}, {"shape": [3], "dtype": "int32",
                              "values": [4, -1, 7]}, ["Out"])
    same("fill", {}, {"shape": [2, 2], "value": [1.5, 2, 3, 4],
                      "dtype": "float32"}, ["Out"])


def test_lookup_aliases_and_where_index_select():
    w, ids = _r(7, 3), np.array([[1], [6], [0]], np.int64)
    for op in ("embedding", "lookup_table_v2"):
        check(op, {"W": w, "Ids": ids}, {}, "Out", grad=("W",))
    c = RS.rand(3, 4) > 0.5
    check("where_index_select", {"Condition": c, "X": _r(3, 4),
                                 "Y": _r(3, 4)}, {}, "Out", grad=("X", "Y"))


def test_shard_index():
    """Floor division by index_num // nshards (the tail ids of an uneven
    split map to ignore_value in every shard); nshards > index_num
    raises, as the JAX op does."""
    x = np.array([[0], [4], [9], [12], [19], [20]], np.int64)
    for shard in range(3):
        same("shard_index", {"X": x}, {"index_num": 20, "nshards": 3,
                                       "shard_id": shard,
                                       "ignore_value": -5}, ["Out"])
    with pytest.raises(ValueError, match="shard_size"):
        both("shard_index", {"X": x}, {"index_num": 2, "nshards": 3,
                                       "shard_id": 0})


def test_hash_negative_ids_and_ids_past_two_to_the_31():
    """The uint32 product wraps mod 2^32 for every id: a negative id and
    one at or past 2^31 (which JAX, narrowing int64 to int32, reads mod
    2^32 too) hash to JAX's buckets; (..., num_hash x L) int64."""
    x = np.array([[0, 1, -1], [2 ** 31 - 1, -2 ** 31, 123456789],
                  [2 ** 31, 2 ** 32 + 5, 2 ** 40 + 77]], np.int64)
    jx = (x & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    for num_hash, mod_by in ((1, 100000007), (4, 1000), (3, 2 ** 31 - 1)):
        attrs = {"num_hash": num_hash, "mod_by": mod_by}
        j = np.asarray(JREG["hash"](_JCtx({"X": jnp.asarray(jx)},
                                          attrs))["Out"])
        t = TREG["hash"](_TCtx({"X": torch.from_numpy(x)}, attrs))["Out"]
        assert t.dtype == torch.int64 and t.shape == j.shape
        np.testing.assert_array_equal(t.numpy(), j)


def test_identities():
    x = _r(3, 4)
    for op in ("lod_reset", "lod_append", "merge_selected_rows",
               "get_tensor_from_selected_rows"):
        check(op, {"X": x}, {}, "Out", grad=("X",))


# ---------------------------------------------------------------------------
# math_ops
# ---------------------------------------------------------------------------

def test_has_inf_has_nan():
    """One bool of shape () each (no host read on the card)."""
    for x in (_r(3, 4), np.array([1.0, np.inf], np.float32),
              np.array([np.nan, 0.0], np.float32),
              np.array([-np.inf, np.nan], np.float32)):
        for op in ("has_inf", "has_nan"):
            out = same(op, {"X": x}, {}, ["Out"])["Out"]
            assert out.shape == () and out.dtype == np.bool_


def test_dot_minus_norms_conv_shift():
    x, y = _r(4, 6), _r(4, 6)
    check("dot", {"X": x, "Y": y}, {}, "Out", grad=("X", "Y"))
    check("minus", {"X": x, "Y": y}, {}, "Out", grad=("X", "Y"))
    check("l1_norm", {"X": x}, {}, "Out", grad=("X",))
    check("squared_l2_norm", {"X": x}, {}, "Out", grad=("X",))
    check("conv_shift", {"X": _r(3, 7), "Y": _r(3, 3)}, {}, "Out",
          grad=("X", "Y"))


# ---------------------------------------------------------------------------
# the layers through both Executors
# ---------------------------------------------------------------------------

def test_assign_of_a_numpy_value():
    """layers.assign of numpy values (f32, int32) through both
    Executors: the values, shapes and dtypes; the port keeps int64."""
    f = _r(2, 3)
    i = np.array([[4, -1], [0, 9]], np.int32)
    j, t = run_layers(lambda L, v: [L.assign(f) + v, L.assign(i)],
                      {"v": _r(2, 3)})
    for a, b in zip(t, j):
        close(a, b)
    main = fluid.Program()
    with tun.guard(), fluid.program_guard(main, fluid.Program()):
        out = tlayers.assign(np.arange(3, dtype=np.int64))
    got, = fluid.Executor(CPU).run(main, fetch_list=[out],
                                   scope=fluid.Scope())
    assert got.dtype == np.int64 and got.tolist() == [0, 1, 2]


def test_tensor_layers_through_both_executors():
    def build(L, x, c):
        u, idx = L.unique(L.cast(c, "int32"))
        pairs = L.slice(c, axes=[1], starts=[0], ends=[2])
        return [L.zeros([2, 3], "float32"), L.ones([3], "int32"),
                L.linspace(0, 1, 5), L.eye(3, 4), L.diag(L.reduce_sum(x, 1)),
                L.reverse(x, [1]), L.has_inf(x), L.has_nan(x),
                L.isfinite(x), L.strided_slice(x, [1], [4], [0], [-2]), u,
                idx, L.shard_index(L.cast(c, "int64"), 10, 2, 1),
                L.pad_constant_like(L.concat([x, x], 0), x, 1.0),
                L.scatter_nd(pairs, L.reduce_sum(x, 1), [6, 6]),
                L.argmax(x, 1), L.argmin(x, 0), L.argsort(x, 1, True)[1],
                L.where(L.cast(c, "bool")), L.shape(x), L.rank(x),
                L.size(x), L.sign(x), L.flatten(L.unsqueeze(x, [1]), 2),
                L.pad(x, [0, 1, 2, 0], 0.5), L.gather_nd(x, pairs),
                L.mul(x, L.transpose(x, [1, 0])), L.clip(x, -0.2, 0.3),
                L.clip_by_norm(x, 0.5), L.sum([x, x]), L.tile(x, [2, 1])]

    x = _r(3, 5)
    c = np.array([[1, 0, 1, 2, 0], [0, 0, 3, 1, 1], [2, 4, 0, 0, 1]],
                 np.int64)
    j, t = run_layers(build, {"x": x, "c": c})
    for k, (a, b) in enumerate(zip(t, j)):
        close(a, b, name=str(k))


def test_split_stack_unstack_layers():
    def build(L, x):
        a, b = L.split(x, [1, 2], dim=1)
        parts = L.unstack(x, axis=1)
        return [a, b, L.stack(parts, axis=0), L.scatter(
            x, L.assign(np.array([2, 0], np.int64)), L.ones([2, 3],
                                                           "float32")),
            L.scatter_nd_add(x, L.assign(np.array([[1], [1]], np.int64)),
                             L.ones([2, 3], "float32"))]

    j, t = run_layers(build, {"x": _r(3, 3)})
    for a, b in zip(t, j):
        close(a, b)


def test_crop_pixel_shuffle_and_ctr_layers():
    def build(L, x, ids, tags):
        out, w, im = L.filter_by_instag(L.reshape(x, [8, 6]), tags,
                                        L.assign(np.array([3], np.int64)))
        return [L.crop(x, [2, 2, 2, 2], [1, 1, 0, 1]),
                L.crop_tensor(x, [2, 2, 2, 2], L.assign(
                    np.array([0, 1, 1, 1], np.int32))),
                L.pixel_shuffle(L.reshape(x, [2, 8, 1, 3]), 2),
                L.space_to_depth(L.reshape(x, [2, 3, 2, 4]), 2),
                L.shuffle_channel(L.reshape(x, [2, 4, 3, 2]), 2),
                L.hash(ids, 1000, 2), out, w, im,
                L.continuous_value_model(L.reshape(x, [8, 6]),
                                         L.reshape(x, [8, 6]), True),
                L.lod_reset(x, target_lod=[0, 2]), L.merge_selected_rows(x),
                L.multiplex([L.reshape(x, [8, 6]), L.reshape(x, [8, 6]) * 2],
                            L.assign(np.array([[1], [0], [1], [0]] * 2,
                                              np.int64)))]

    j, t = run_layers(build, {"x": _r(2, 2, 3, 4),
                              "ids": np.array([[3], [-4], [2 ** 20]],
                                              np.int64),
                              "tags": np.array([[1, 3], [2, 0], [0, 0],
                                                [3, 3]] * 2, np.int64)})
    for k, (a, b) in enumerate(zip(t, j)):
        close(a, b, name=str(k))


# ---------------------------------------------------------------------------
# data parallelism
# ---------------------------------------------------------------------------

def _dp_program(build):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with tun.guard(), fluid.program_guard(main, startup):
        outs = build(tlayers)
    return main, startup, outs


def _run(main, startup, outs, feed, places):
    scope, exe = fluid.Scope(), fluid.Executor(CPU)
    exe.run(startup, scope=scope)
    prog = main if places is None else fluid.CompiledProgram(
        main).with_data_parallel(loss_name=outs[0].name, places=places)
    return exe.run(prog, feed=feed, fetch_list=outs, scope=scope)


def _dp_equal(build, feed):
    main, startup, outs = _dp_program(build)
    want = _run(main, startup, outs, feed, None)
    got = _run(main, startup, outs, feed, [CPU] * 2)
    for a, b in zip(got, want):
        close(np.asarray(a), np.asarray(b), rtol=DP_TOL)
    return got


def test_tensor_ops_at_dp2_equal_dp1():
    """Rows through the slice's per-row tensor ops off dim 0, the
    global shape / size, and the global flags and norms, at dp 2 on a
    local mesh against the plain Executor."""
    def build(L):
        x = L.data("x", shape=[4, 6], dtype="float32")
        c = L.data("c", shape=[4], dtype="int64")
        a, b = L.split(x, 2, dim=1)
        h = L.stack([a, b], axis=1)
        h = L.flatten(L.reverse(h, [2]), 1)
        h = L.pad(L.strided_slice(h, [1], [0], [48], [2]), [0, 0, 1, 1])
        s, idx = L.argsort(h, axis=1)
        loss = L.mean(L.elementwise_mul(s, s))
        return [loss, s, idx, L.argmax(h, 1), L.shape(x), L.size(x),
                L.has_nan(x), L.has_inf(L.log(x)),
                L.hash(c, 97, 2),
                L.shard_index(c, 20, 2, 0)]

    feed = {"x": _r(8, 4, 6, lo=0.1, hi=2.0),
            "c": RS.randint(0, 20, (8, 4)).astype(np.int64)}
    got = _dp_equal(build, feed)
    assert list(got[4]) == [8, 4, 6] and int(got[5]) == 8 * 24


def test_norms_and_flags_count_the_global_tensor():
    """l1_norm / squared_l2_norm of a sharded tensor sum every rank's
    part; has_nan finds a NaN in either rank's rows."""
    from paddle_tpu_torch.core.layer_helper import LayerHelper

    def build(L):
        x = L.data("x", shape=[3], dtype="float32")
        outs = []
        for op in ("l1_norm", "squared_l2_norm", "has_nan"):
            helper = LayerHelper(op)
            out = helper.create_variable_for_type_inference(
                "bool" if op == "has_nan" else "float32", ())
            helper.append_op(op, {"X": x}, {"Out": out})
            outs.append(out)
        return [L.mean(x)] + outs

    x = _r(4, 3)
    x[3, 1] = np.nan
    got = _dp_equal(build, {"x": np.nan_to_num(x)})
    assert not bool(got[3])
    main, startup, outs = _dp_program(build)
    assert bool(_run(main, startup, outs, {"x": x}, [CPU] * 2)[3])


@pytest.mark.parametrize("layer,why", [
    (lambda L, x: L.split(x, 2, dim=0)[0], "dim 0"),
    (lambda L, x: L.stack([x, x], axis=0), "dim 0"),
    (lambda L, x: L.unstack(x, axis=0, num=4)[0], "dim 0"),
    (lambda L, x: L.reverse(x, [0]), "dim 0"),
    (lambda L, x: L.strided_slice(x, [0], [0], [4], [2]), "dim 0"),
    (lambda L, x: L.argsort(x, axis=0)[0], "dim 0"),
    (lambda L, x: L.argmax(x, 0), "dim 0"),
    (lambda L, x: L.cast(L.where(L.cast(x, "bool")), "float32"),
     "whole flattened"),
    (lambda L, x: L.cast(L.unique(x)[0], "float32"), "whole tensor"),
    (lambda L, x: L.scatter(x, L.assign(np.array([0], np.int64)),
                            L.ones([1, 3], "float32")), "global ids"),
    (lambda L, x: L.crop(x, [2, 3], [1, 0]), "dim 0")])
def test_dim0_and_whole_tensor_ops_refuse_sharded_rows(layer, why):
    """Where JAX's GSPMD would compute the global answer, these ops
    refuse a dp-sharded input at dp 2 (ROADMAP C18); at dp 1 they run."""
    def build(L):
        x = L.data("x", shape=[3], dtype="float32")
        return [L.mean(L.cast(layer(L, x), "float32"))]

    main, startup, outs = _dp_program(build)
    feed = {"x": _r(4, 3)}
    with pytest.raises(NotImplementedError, match=why):
        _run(main, startup, outs, feed, [CPU] * 2)
    close(_run(main, startup, outs, feed, [CPU])[0],
          _run(main, startup, outs, feed, None)[0])
