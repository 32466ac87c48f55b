"""Ragged paged attention on Hopper: the CUDA kernel, its wrapper, and
its plain PyTorch version.

Replaces the Pallas kernels of ``paddle_tpu/ops/pallas/paged.py``:
``_paged_kernel`` (``:134``, launcher ``ragged_paged_attention`` ``:306``)
with its int8 branch (``:151-219``, launch ``:282``), and
``_paged_kernel_v2`` (``:333``, launcher ``ragged_paged_attention_v2``
``:505``) with its int8 dequant (``:435-437``). One kernel,
``csrc/paged_attention.cu``, templated on the q type, the pool element
type and the head dim, serves all four, and f32 q over bf16 pools (an
f32 model serving bf16 KV): the function of ``paged_attention_reference``
computed in the v2 style, one streaming pass with an online softmax
whose running max, sum and accumulator are f32. It takes head dims
``HEAD_DIMS`` (32, 64, 128) and the (q, pool) dtype pairs ``_PAIRS``;
any other head dim raises ``ValueError``.

What bounds it: the bytes of the live K/V blocks read from device
memory (decode reads every live block of every lane once per layer and
does ~2 flops per byte). The design keeps those bytes in flight on every
SM and takes the per-row work off the loop:

- bf16 q: each warp owns a 16-row group of the (lane, KV head)'s rows
  (H/H_kv heads x C columns; decode pads its 1 or 3 rows with masked
  ones) and computes S = Q K^T and O += P V with tensor-core
  ``mma.sync`` m16n8k16 products, the online softmax on the fragments,
  and P split into bf16 hi + lo parts so that P V keeps f32 accuracy.
  About four warps share a block: the m-tiles times key groups that
  take turns at the ring's tiles and merge in shared memory at the end.
- int8 pools: the per-row scales factor out of both products (k_scale
  scales S's columns, v_scale rides on P), so the ring holds the codes
  as int8; each stage's codes become exact bf16 once per block, shared
  by the m-tiles of a key group (three under GQA).
- f32 q (over f32, bf16 or int8 pools) keeps f32 arithmetic on the CUDA
  cores, with the same grid, loads and softmax: rounding q to bf16
  would break the 1e-5 agreement of ``TOLERANCE[torch.float32]``.
- loads: each block compacts its table slice's live (non-NULL) entries
  once and gathers 16-key K/V tiles by 16-byte ``cp.async`` into a
  3-stage ring; no copy is issued for a NULL block.
- split-K: the grid is (lane x KV head, split, row group); each split
  walks a contiguous range of the table up to the lane's early stop. The
  split count comes from the shapes alone (``paged_attention_plan``),
  never from a device tensor, so the wrapper does not sync. Partials go
  to f32 scratch and the last split of each (lane, KV head) to finish
  merges them in the same launch, by an atomic ticket that it resets;
  the scratch and the zeroed int32 tickets are one workspace kept per
  device (allocated once, ``torch.empty`` / ``torch.zeros``), so
  launches on one device must not overlap on two streams. One launch
  per call, one count in ``LAUNCHES``.

The output takes the pool dtype for dense pools and q's dtype for int8
pools, as JAX's ``out_dtype`` does (``paged.py:488``).

Numerics, keyed by the output dtype in ``TOLERANCE``: the kernel, like
v2, accumulates PV in f32. The plain version, like the JAX reference,
casts the probabilities to the value dtype before PV
(``kv_cache.py:261``): dense bf16 pools under bf16 q also score in bf16,
f32 q over bf16 pools scores in f32, and int8 pools with bf16 q round
the dequantized values to bf16. So the two agree to
``TOLERANCE[torch.float32]`` for an f32 output (only the summation order
differs) and to ``TOLERANCE[torch.bfloat16]`` absolute for a bf16 one; a
bf16 kernel output is also held, row by row, to
``BF16_ROW_REL_TOLERANCE`` of the plain version computed with q and the
dense pools in f32.

The plain version gathers every table entry below the early stop, the
NULL block included (as v1 does); the kernel skips NULL entries (as v2
does). The two agree wherever a lane's table has no NULL entry inside
its live range, which is how the cache fills it.

The shared library is built at first use, from the repository's source,
into ``paddle_tpu_torch/csrc/build/`` with ``nvcc`` for ``sm_90a`` and
loaded with ctypes. Nothing here imports or builds anything at import
time, so the module imports on a machine without CUDA.
"""

import ctypes
import math
import threading

import torch

from ._build import build_library

NULL_BLOCK = 0          # mirrors serving.kv_cache.NULL_BLOCK
NEG_INF = -1e9          # mirrors serving.kv_cache.NEG_INF

# max-abs tolerance of kernel vs plain version, per output dtype (the
# pool dtype for dense pools, q's for int8): f32 differ only in summation
# order; bf16 differ by the plain version's bf16 scores (dense under bf16
# q), its bf16 dequantized values (int8) and its bf16 probabilities before
# PV
TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 2e-2}

# bf16 kernel vs the plain version run with q in f32 on the same pools,
# per output row (lane, head, column): max-abs error over the row's
# max |ref|. The kernel computes in f32 and rounds only its output to
# bf16 (at most 2**-8 of a value), so a one-key mask error at a context
# of hundreds (~1e-2 of a row's scale) fails where 2e-2 absolute would not
BF16_ROW_REL_TOLERANCE = 5e-3

HEAD_DIMS = (32, 64, 128)

# kernel launches in this process since the last reset: the wrapper adds
# one per launch, and it is the only count of them
LAUNCHES = 0
_launches_lock = threading.Lock()

# dtype codes of the C entry point: q takes the first two, pools all
# three
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# (q, pool) dtype pairs the kernel is instantiated for
_PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.float32, torch.bfloat16), (torch.float32, torch.int8),
          (torch.bfloat16, torch.int8)}

_lib = None
_lib_lock = threading.Lock()
# per (device, shapes, dtypes): (splits, scratch floats, tickets)
_plans = {}
# per device: the split-K workspace, (f32 partials, int32 tickets); every
# launch writes the partials it reads and leaves the tickets at 0
_workspaces = {}


# ---------------------------------------------------------------------------
# plain PyTorch version (the semantic spec)
# ---------------------------------------------------------------------------

def gather_block_kv(pool, block_table):
    """pool (N, H, bs, D) gathered by table (B, M) -> dense
    (B, H, M*bs, D) view in logical-position order."""
    b, m = block_table.shape
    _, h, bs, d = pool.shape
    g = pool[block_table.reshape(-1).long()].reshape(b, m, h, bs, d)
    return g.movedim(2, 1).reshape(b, h, m * bs, d)


def gather_block_kv_pair(k_pool, v_pool, block_table):
    """Both pools gathered with one index plan (see gather_block_kv)."""
    b, m = block_table.shape
    _, h, bs, d = k_pool.shape
    flat = block_table.reshape(-1).long()

    def _take(pool):
        g = pool[flat].reshape(b, m, h, bs, d)
        return g.movedim(2, 1).reshape(b, h, m * bs, d)

    return _take(k_pool), _take(v_pool)


def gather_block_scales(scale_pool, block_table):
    """scale pool (N, H, bs) gathered by table (B, M) -> dense
    (B, H, M*bs) view aligned with gather_block_kv's rows."""
    b, m = block_table.shape
    _, h, bs = scale_pool.shape
    g = scale_pool[block_table.reshape(-1).long()].reshape(b, m, h, bs)
    return g.movedim(2, 1).reshape(b, h, m * bs)


def paged_attention_reference(q, k_pool, v_pool, block_table,
                              q_positions, k_scale=None, v_scale=None):
    """Plain paged attention: gather blocks by table, mask keys beyond
    each query's position, softmax in f32, weighted sum.

    q (B, H, C, D); k/v_pool (N, H_kv, bs, D) with H % H_kv == 0; table
    (B, M) int; positions (B, C) int; k/v_scale (N, H_kv, bs) f32 per-row
    scales, required for int8 pools and refused otherwise -> (B, H, C, D)
    in v_pool's dtype (int8 pools: in q's dtype, the model's activation
    dtype).

    Dense pools: scores in q's dtype (in f32 when q and the pools differ,
    as JAX promotes f32 q x bf16 keys), the softmax in f32, probabilities
    cast back to the value dtype before PV, as in the JAX reference. int8
    pools: the gathered codes are dequantized (code * row scale in f32);
    keys go straight into f32 scores against q in f32, values are cast to
    q's dtype, and so are the probabilities before PV. GQA repeats the
    gathered (and dequantized) KV rows across each group of H/H_kv query
    heads."""
    d = q.shape[-1]
    h, hp = q.shape[1], k_pool.shape[1]
    if hp > h or h % hp:
        raise ValueError(
            f"pool heads {hp} do not match q heads {h} (GQA needs q "
            f"heads a multiple of pool heads)")
    rep = h // hp
    if k_pool.dtype != torch.int8 and (k_scale is not None
                                       or v_scale is not None):
        raise ValueError(
            f"scale pools passed with non-int8 pools ({k_pool.dtype}) "
            f"— scales only mean something for quantized KV")
    gk, gv = gather_block_kv_pair(k_pool, v_pool, block_table)
    if k_pool.dtype == torch.int8:
        if k_scale is None or v_scale is None:
            raise ValueError(
                "int8 pools need k_scale/v_scale (the per-row f32 "
                "scale pools stored beside the blocks)")
        # keys dequantize straight into f32 scores against q in f32;
        # values (and so the probabilities and the output) take q's dtype
        gk = gk.float() * gather_block_scales(k_scale, block_table)[..., None]
        gv = (gv.float() * gather_block_scales(v_scale, block_table)
              [..., None]).to(q.dtype)
        q = q.float()
    elif q.dtype != gk.dtype:
        q, gk = q.float(), gk.float()
    if rep > 1:
        gk = gk.repeat_interleave(rep, dim=1)
        gv = gv.repeat_interleave(rep, dim=1)
    # the JAX reference divides by a numpy float64 scalar, which promotes
    # bf16 scores to f32 before the scale: do the same
    s = torch.einsum("bhcd,bhtd->bhct", q, gk).float() / math.sqrt(d)
    key_pos = torch.arange(gk.shape[2], device=q.device)
    mask = key_pos[None, None, None, :] <= q_positions[:, None, :, None]
    s = torch.where(mask, s, torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1).to(gv.dtype)
    return torch.einsum("bhct,bhtd->bhcd", p, gv)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def build():
    """Compile csrc/paged_attention.cu for sm_90a into csrc/build/ (once
    per source content) and load it; the library is kept for the
    process."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = build_library("paged_attention.cu")
        # q, k/v pools, k/v scales, table, positions, out, scratch,
        # tickets; B, H, H_kv, C, D, bs, M, q dtype, pool dtype; stream
        lib.paged_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        lib.paged_attention_fwd.restype = ctypes.c_int
        # B, H, H_kv, C, D, bs, M, q dtype, pool dtype; plan out (4 x i64)
        lib.paged_attention_plan.argtypes = (
            [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_longlong)])
        lib.paged_attention_plan.restype = ctypes.c_int
        _lib = lib
        return lib


def _check(q, k_pool, v_pool, block_table, q_positions, k_scale, v_scale):
    tensors = [q, k_pool, v_pool, block_table, q_positions]
    quantized = k_pool.dtype == torch.int8
    if quantized:
        if k_scale is None or v_scale is None:
            raise ValueError("int8 pools need k_scale/v_scale (N, H_kv, bs) "
                             "f32 scale pools")
        tensors += [k_scale, v_scale]
    elif k_scale is not None or v_scale is not None:
        raise ValueError(f"scale pools passed with non-int8 pools "
                         f"({k_pool.dtype}): scales only mean something "
                         f"for quantized KV")
    if q.dim() != 4 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"q {tuple(q.shape)} / pools {tuple(k_pool.shape)}"
                         f" {tuple(v_pool.shape)}: want 4-D, equal pools")
    if (q.dtype, k_pool.dtype) not in _PAIRS or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"dtypes q {q.dtype}, pools {k_pool.dtype}/"
                         f"{v_pool.dtype}: want q f32 or bf16 with pools "
                         f"of q's dtype or int8, or q f32 over bf16 pools")
    b, h, c, d = q.shape
    n, hp, bs, dp = k_pool.shape
    if dp != d or d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} (pool {dp}): the kernel takes "
                         f"{HEAD_DIMS}")
    if hp > h or h % hp:
        raise ValueError(f"pool heads {hp} do not divide q heads {h}")
    if quantized and not (tuple(k_scale.shape) == tuple(v_scale.shape)
                          == (n, hp, bs)
                          and k_scale.dtype == v_scale.dtype
                          == torch.float32):
        raise ValueError(f"scale pools {tuple(k_scale.shape)} "
                         f"{k_scale.dtype} / {tuple(v_scale.shape)} "
                         f"{v_scale.dtype}: want f32 {(n, hp, bs)}")
    if block_table.dim() != 2 or block_table.shape[0] != b \
            or tuple(q_positions.shape) != (b, c):
        raise ValueError(f"table {tuple(block_table.shape)} / positions "
                         f"{tuple(q_positions.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if block_table.dtype != torch.int32 or q_positions.dtype != torch.int32:
        raise ValueError("table and positions must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged attention kernel: operands must be "
                         "contiguous")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged attention kernel: pools must be 16-byte "
                         "aligned (the kernel reads them in 16-byte "
                         "vectors)")
    # last, so that operands the kernel takes fail here alone off the card
    if not all(t.is_cuda for t in tensors):
        raise ValueError("paged attention kernel: every operand must be a "
                         "CUDA tensor")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("paged attention kernel: operands on different "
                         "devices")


def _plan(lib, key):
    """(splits, scratch floats, tickets) at these shapes on the current
    device, from the library's plan (shapes only; kept per key)."""
    plan = _plans.get(key)
    if plan is None:
        out = (ctypes.c_longlong * 4)()
        if lib.paged_attention_plan(*key[1:], out) != 0:
            _, h, hp, c, d, bs, _, _, _ = key[1:]
            raise ValueError(f"H/H_kv={h // hp}, C={c}, D={d}, bs={bs}: a "
                             f"block's shared memory exceeds the card's "
                             f"227 KB")
        plan = _plans[key] = (out[0], out[1], out[2])
    return plan


def _workspace(device, n_scratch, n_tickets):
    """At least n_scratch f32 partials and n_tickets int32 tickets (all
    0) on `device`: kept per device (static addresses, no allocation per
    call), grown, never shrunk. Launches on one stream run in order, so
    they may share it."""
    ws = _workspaces.get(device)
    if ws is None or ws[0].numel() < n_scratch or ws[1].numel() < n_tickets:
        ws = _workspaces[device] = (
            torch.empty(max(n_scratch, 1 << 16), dtype=torch.float32,
                        device=device),
            torch.zeros(max(n_tickets, 1024), dtype=torch.int32,
                        device=device))
    return ws


def paged_attention_cuda(q, k_pool, v_pool, block_table, q_positions,
                         k_scale=None, v_scale=None):
    """Launch the kernel on the current stream; (B, H, C, D) out in the
    pool dtype for dense pools, in q's for int8 pools. Head dims 32, 64
    and 128 (``HEAD_DIMS``); the (q, pool) dtype pairs of ``_PAIRS``.
    int8 pools need their f32 k/v_scale pools, dense pools refuse them.
    One launch per call, split-K partials merged inside it; the split
    count depends on the shapes alone, so nothing is read back from the
    card. Raises on operands it does not take and on a refused launch;
    never falls back."""
    global LAUNCHES
    _check(q, k_pool, v_pool, block_table, q_positions, k_scale, v_scale)
    lib = build()
    b, h, c, d = q.shape
    _, hp, bs, _ = k_pool.shape
    m = block_table.shape[1]
    qd, pd = _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pool.dtype]
    dev = q.device
    with torch.cuda.device(dev):
        splits, n_scratch, n_tickets = _plan(
            lib, (dev.index, b, h, hp, c, d, bs, m, qd, pd))
        out = torch.empty(q.shape, dtype=(q.dtype if pd == 2
                                          else k_pool.dtype), device=dev)
        ws = (tuple(t.data_ptr() for t in _workspace(dev, n_scratch,
                                                     n_tickets))
              if splits > 1 else (None, None))
        stream = torch.cuda.current_stream(dev).cuda_stream
        scales = ((k_scale.data_ptr(), v_scale.data_ptr())
                  if k_scale is not None else (None, None))
        rc = lib.paged_attention_fwd(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), *scales,
            block_table.data_ptr(), q_positions.data_ptr(), out.data_ptr(),
            *ws, b, h, hp, c, d, bs, m, qd, pd, stream)
    if rc != 0:
        raise RuntimeError(f"paged attention kernel launch failed: CUDA "
                           f"error {rc}")
    with _launches_lock:
        LAUNCHES += 1
    return out
