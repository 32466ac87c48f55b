"""Flash attention on Hopper: the forward and backward CUDA kernels, their
wrappers, and their plain PyTorch versions.

The forward replaces the Pallas forward kernels of
``paddle_tpu/ops/pallas/flash.py``: ``_fwd_kernel`` (``:168``, launcher
``_flash_fwd``; K/V resident in VMEM) and ``_fwd_kernel_kgrid`` (``:318``,
launcher ``_flash_fwd_kgrid``; K/V streamed by the grid for long
contexts). Both compute one function, and one kernel,
``csrc/flash_attention.cu``, serves both: a thread block owns one (batch x
head, 64-row query tile) and streams 64-key K/V tiles through shared memory
with an f32 online softmax, so any key length fits.

The backward replaces ``_dq_kernel`` / ``_dkv_kernel`` (``:465`` / ``:519``,
launcher ``_flash_bwd``) and ``_dq_kernel_kgrid`` / ``_dkv_kernel_kgrid``
(``:579`` / ``:629``, launcher ``_flash_bwd_kgrid``) the same way: one pair
of kernels, ``csrc/flash_attention_bwd.cu``, a dQ kernel over q tiles and a
dK/dV kernel over key tiles, each streaming the other side through shared
memory and recomputing the probabilities from the saved lse. ``delta``
stays a torch reduction, as in JAX, where it is computed outside Pallas.

The function (``flash_attention_reference``), with the semantics of the
JAX kernels:

- scores in f32, q scaled in f32 before the product
  (``flash.py:176``), an additive bias added in f32;
- a causal mask aligned bottom-right, key j visible to query i iff
  ``j <= i + (Tk - Tq)`` (``:95``); segment ids visible iff
  ``seg_q == seg_k`` (``:97``);
- the finite ``NEG_INF = -1e30`` (``:28``) and the ``max(l, 1e-30)``
  guard (``:221-222``): a row with no visible key (causal with Tq > Tk)
  outputs exactly 0, and its lse is ``NEG_INF + log(1e-30)`` (``:101``);
- ``out`` in q's dtype, ``lse`` (B, H, Tq) f32.

Its gradient (``flash_attention_bwd_reference``, after ``_flash_bwd``,
``flash.py:805-912``): ``delta = sum(do * out, -1) - dlse`` in f32,
``P = visible ? exp(s - lse) : 0`` under the forward's masks,
``dS = P (dO V^T - delta)``, ``dQ = scale dS K``, ``dK = scale dS^T Q``,
``dV = P^T dO``, each in its input's dtype. ``flash_dbias`` is the bias
cotangent (``_dbias_xla``, ``:915``), a plain torch op on the card too.
Both plain versions also take float64 (computing in float64), so that
``torch.autograd.gradcheck`` can hold them.

Where a row has visible keys the kernels and the plain versions give no
weight to masked keys: probabilities are where(visible, exp(...), 0).
That is what the JAX kernels give as well, except in one degenerate
corner (a row whose visible keys all score at -1e30, or a row with no
visible key in a tile another row needs), where JAX's tiling decides.

What bounds the kernels on this card: the forward at the prefill shape
(B 8, H 12, T 512, D 64, causal, bf16) the bytes (q, k, v read once, out
and lse written once: 25.4 MB, 7.6 us at 3.35 TB/s) against 3.2 GFLOP of
products (3.3 us at the bf16 peak); at long causal shapes (T 16384) the
operations. The backward at the training shape (the same, f32) moves
~101 MB (30 us) and needs 8.1e9 flops (0.12 ms at the f32 CUDA-core
peak). These first kernels compute their products with scalar f32 FMAs
from shared memory and are far from either bound; PERF.md has their times.

Numerics, keyed by q's dtype in ``TOLERANCE`` (forward) and
``BWD_TOLERANCE`` (dq, dk, dv): both sides compute in f32 from the same
inputs and differ only in summation order (f32; the backward's sums run
over up to Tq or Tk terms, hence its looser f32 bound) and, for bf16, in
the rounding of values that straddle a bf16 step once the outputs are
cast. The error is measured element-wise as ``|out - ref| / max(1,
|ref|)``; lse is f32 on both sides and held to the f32 tolerance. A bf16
output is also held, row by row, to ``BF16_ROW_REL_TOLERANCE`` of the
plain version computed in f32.

The shared libraries are built at first use, from the repository's
sources, into ``paddle_tpu_torch/csrc/build/`` with ``nvcc`` for
``sm_90a`` and loaded with ctypes. Nothing here builds anything at import
time.
"""

import ctypes
import math
import threading

import torch

from ._build import build_library

NEG_INF = -1e30         # the JAX kernels' finite mask value
L_FLOOR = 1e-30         # max(l, 1e-30): an empty row gives 0, not NaN

# error of kernel vs plain version, |out - ref| / max(1, |ref|), per q
# dtype: f32 differ only in summation order; bf16 outputs also by one
# bf16 step (2**-8 relative) where the f32 values straddle a rounding
# boundary
TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 2e-2}

# the same measure for dq, dk and dv: each is a sum over Tk (dq) or Tq
# (dk, dv) products of recomputed probabilities, taken in another order
# than the plain version's matmuls, so f32 differs by more rounding steps
# than the forward's out; bf16 as the forward
BWD_TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

# bf16 kernel vs the plain version run in f32 on the same inputs, per
# output row: max-abs error over the row's max |ref|. The kernel rounds
# only its output to bf16 (at most 2**-9 of a value)
BF16_ROW_REL_TOLERANCE = 5e-3

HEAD_DIMS = (32, 64, 128)

# kernel launches in this process since the last reset: each wrapper adds
# one per launch of its kernel, and these are the only counts of them
LAUNCHES = 0            # the forward
DQ_LAUNCHES = 0         # the backward's dQ kernel
DKV_LAUNCHES = 0        # the backward's dK/dV kernel
_launches_lock = threading.Lock()

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_libs = {}
_lib_lock = threading.Lock()


# ---------------------------------------------------------------------------
# plain PyTorch versions (the semantic spec)
# ---------------------------------------------------------------------------

def _visible_mask(tq, tk, causal, segq=None, segk=None, device=None):
    """(B|1, 1, Tq, Tk) bool: key j visible to query i. Causal is aligned
    bottom-right (j <= i + Tk - Tq); segment ids must be equal."""
    qi = torch.arange(tq, device=device)[:, None]
    kj = torch.arange(tk, device=device)[None, :]
    vis = torch.ones((tq, tk), dtype=torch.bool, device=device)
    if causal:
        vis = kj <= qi + (tk - tq)
    vis = vis[None, None]
    if segq is not None:
        vis = vis & (segq[:, None, :, None] == segk[:, None, None, :])
    return vis


def _compute_dtype(x):
    """f32, or f64 for f64 inputs (gradcheck)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def _scores(q, k, bias, segq, segk, scale, causal):
    """(scaled scores with the bias added, visibility mask), in the
    compute dtype; masked scores hold NEG_INF."""
    ct = _compute_dtype(q)
    s = torch.matmul(q.to(ct) * scale, k.to(ct).transpose(-1, -2))
    if bias is not None:
        s = s + bias.to(ct)
    vis = _visible_mask(q.shape[2], k.shape[2], causal, segq, segk,
                        device=q.device)
    s = torch.where(vis, s, torch.tensor(NEG_INF, dtype=ct, device=q.device))
    return s, vis


def _probs(s, vis, lse):
    """P = visible ? exp(s - lse) : 0, from the saved lse."""
    return torch.where(vis, torch.exp(s - lse.to(s.dtype)[..., None]),
                       torch.zeros((), dtype=s.dtype, device=s.device))


def flash_attention_reference(q, k, v, bias=None, segq=None, segk=None,
                              scale=None, causal=False):
    """Plain attention with the flash kernels' semantics.

    q (B, H, Tq, D); k/v (B, H, Tk, D), q's dtype; bias None or
    broadcastable to (B, H, Tq, Tk) (from (B|1, H|1, Tq|1, Tk)); segq
    (B, Tq) / segk (B, Tk) int or None; scale None means 1/sqrt(D) ->
    (out (B, H, Tq, D) in q's dtype, lse (B, H, Tq) f32; f64 for f64
    inputs)."""
    scale = _scale(q, scale)
    s, vis = _scores(q, k, bias, segq, segk, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(vis, torch.exp(s - m), torch.zeros((), dtype=s.dtype,
                                                       device=q.device))
    l = p.sum(dim=-1, keepdim=True).clamp_min(L_FLOOR)
    out = torch.matmul(p, v.to(s.dtype)) / l
    lse = (m + torch.log(l))[..., 0]
    return out.to(q.dtype), lse


def _delta(out, do, dlse, ct=torch.float32):
    """delta = sum(do * out, -1) - dlse, (B, H, Tq) in `ct`: the lse
    cotangent enters every kernel as dS = P (dP - (delta - dlse))."""
    delta = (do.to(ct) * out.to(ct)).sum(dim=-1)
    if dlse is not None:
        delta = delta - dlse.to(ct)
    return delta


def flash_attention_bwd_reference(q, k, v, bias, segq, segk, out, lse, do,
                                  dlse=None, scale=None, causal=False):
    """The gradient of flash_attention_reference, from its saved out and
    lse: (dq, dk, dv) in their inputs' dtypes and delta (B, H, Tq) f32 (f64
    for f64 inputs). `do` is the cotangent of out, `dlse` that of lse (or
    None)."""
    scale = _scale(q, scale)
    ct = _compute_dtype(q)
    delta = _delta(out, do, dlse, ct)
    s, vis = _scores(q, k, bias, segq, segk, scale, causal)
    p = _probs(s, vis, lse)
    dof = do.to(ct)
    ds = p * (torch.matmul(dof, v.to(ct).transpose(-1, -2))
              - delta[..., None])
    dq = torch.matmul(ds, k.to(ct)) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.to(ct)) * scale
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), delta


def flash_dbias(q, k, v, bias, lse, do, delta, scale=None, causal=False,
                segq=None, segk=None):
    """Bias cotangent, dS = P (dP - delta), summed over the dimensions
    the bias was broadcast along; in the bias's dtype. O(Tq Tk): it runs
    only when the bias requires grad (``_dbias_xla``, ``flash.py:915``),
    as plain torch on the card too."""
    scale = _scale(q, scale)
    s, vis = _scores(q, k, bias, segq, segk, scale, causal)
    p = _probs(s, vis, lse)
    dp = torch.matmul(do.to(s.dtype), v.to(s.dtype).transpose(-1, -2))
    ds = p * (dp - delta.to(s.dtype)[..., None])
    dims = [i for i in range(4) if bias.shape[i] == 1 and ds.shape[i] > 1]
    db = ds.sum(dim=dims, keepdim=True) if dims else ds
    return db.to(bias.dtype)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _build_lib(source, name, argtypes):
    """Build and load csrc/<source> once per process and declare the
    argument types of its entry point `name`."""
    with _lib_lock:
        lib = _libs.get(source)
        if lib is None:
            lib = build_library(source)
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[source] = lib
        return lib


def build():
    """Compile csrc/flash_attention.cu for sm_90a into csrc/build/ (once
    per source content) and load it; the library is kept for the
    process."""
    # q, k, v, bias, segq, segk, out, lse; strides (13 int64); B, H, Tq,
    # Tk, D; scale; causal, dtype; stream
    return _build_lib(
        "flash_attention.cu", "flash_attention_fwd",
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float]
        + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def build_bwd():
    """The same for csrc/flash_attention_bwd.cu (both backward kernels)."""
    # which; q, k, v, do, bias, segq, segk, lse, delta, dq, dk, dv;
    # strides (16 int64); B, H, Tq, Tk, D; scale; causal, dtype; stream
    return _build_lib(
        "flash_attention_bwd.cu", "flash_attention_bwd",
        [ctypes.c_int] + [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
        + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def _check(q, k, v, bias, segq, segk, *more):
    """Raise on operands the kernels do not take; `more` are further
    tensors that must lie on q's device. Returns the bias as an f32
    (B, H, Tq, Tk) view (broadcast dimensions get stride 0)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)}: want 4-D, k and v equal")
    b, h, tq, d = q.shape
    if k.shape[0] != b or k.shape[1] != h or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if tq < 1 or k.shape[2] < 1 or b * h < 1:
        raise ValueError("flash attention kernel: empty operands")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d}: the kernel takes {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"dtypes q {q.dtype}, k {k.dtype}, v {v.dtype}: "
                         f"want one of f32, bf16")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash attention kernel: q/k/v need a unit stride "
                         "along D")
    tensors = [q, k, v, *more]
    if bias is not None:
        bias = bias.float().expand(b, h, tq, k.shape[2])
        tensors.append(bias)
    if (segq is None) != (segk is None):
        raise ValueError("segment ids come as a (segq, segk) pair")
    if segq is not None:
        if tuple(segq.shape) != (b, tq) or tuple(segk.shape) != \
                (b, k.shape[2]):
            raise ValueError(f"segment ids {tuple(segq.shape)}/"
                             f"{tuple(segk.shape)} do not match q/k")
        if segq.dtype != torch.int32 or segk.dtype != torch.int32 \
                or not (segq.is_contiguous() and segk.is_contiguous()):
            raise ValueError("segment ids must be contiguous int32")
        tensors += [segq, segk]
    # last, so that operands the kernel takes fail here alone off the card
    if not all(t.is_cuda for t in tensors):
        raise ValueError("flash attention kernel: every operand must be a "
                         "CUDA tensor")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("flash attention kernel: operands on different "
                         "devices")
    return bias


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _strides(tensors, bias):
    """The (batch, head, time) strides of each tensor, then the bias's
    four (0 without a bias), as a ctypes int64 array."""
    vals = [s for t in tensors for s in t.stride()[:3]]
    vals += list(bias.stride()) if bias is not None else [0] * 4
    return (ctypes.c_int64 * len(vals))(*vals)


def flash_attention_cuda(q, k, v, bias=None, segq=None, segk=None,
                         scale=None, causal=False):
    """Launch the forward kernel on the current stream; the contract of
    flash_attention_reference. q/k/v may be strided views (a unit stride
    along D), such as the prefill's head-transposed projections; out is
    (B, H, Tq, D) contiguous in q's dtype, lse (B, H, Tq) f32. Raises on
    operands it does not take and on a refused launch; never falls
    back."""
    global LAUNCHES
    bias = _check(q, k, v, bias, segq, segk)
    lib = build()
    b, h, tq, d = q.shape
    out = torch.empty((b, h, tq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), _ptr(segq),
            _ptr(segk), out.data_ptr(), lse.data_ptr(),
            _strides((q, k, v), bias), b, h, tq, k.shape[2], d,
            _scale(q, scale), int(bool(causal)), _DTYPE_CODE[q.dtype],
            stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {rc}")
    with _launches_lock:
        LAUNCHES += 1
    return out, lse


def flash_attention_bwd_cuda(q, k, v, bias, segq, segk, out, lse, do,
                             dlse=None, scale=None, causal=False):
    """Launch the dQ kernel, then the dK/dV kernel, on the current
    stream; the contract of flash_attention_bwd_reference. q/k/v/do may be
    strided views with a unit stride along D; dq, dk, dv come back
    contiguous in q's dtype, delta (B, H, Tq) f32. Raises on operands the
    kernels do not take and on a refused launch; never falls back."""
    global DQ_LAUNCHES, DKV_LAUNCHES
    b, h, tq, d = q.shape
    tk = k.shape[2]
    for name, t, shape in (("out", out, q.shape), ("do", do, q.shape),
                           ("lse", lse, (b, h, tq))):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} {tuple(t.shape)}: want {tuple(shape)}")
    if do.dtype != q.dtype or do.stride(-1) != 1:
        raise ValueError(f"do {do.dtype} with stride {do.stride(-1)} along "
                         f"D: want q's dtype and a unit stride")
    if lse.dtype != torch.float32 or (
            dlse is not None and tuple(dlse.shape) != (b, h, tq)):
        raise ValueError("lse must be f32 and dlse (B, H, Tq)")
    more = [out, do, lse] + ([dlse] if dlse is not None else [])
    bias = _check(q, k, v, bias, segq, segk, *more)
    lib = build_bwd()
    delta = _delta(out, do, dlse).contiguous()
    lse = lse.contiguous()
    dq = torch.empty((b, h, tq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, h, tk, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, h, tk, d), dtype=q.dtype, device=q.device)
    strides = _strides((q, k, v, do), bias)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    for which, name in ((0, "dq"), (1, "dkv")):
        with torch.cuda.device(q.device):
            rc = lib.flash_attention_bwd(
                which, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                do.data_ptr(), _ptr(bias), _ptr(segq), _ptr(segk),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), strides, b, h, tq, tk, d,
                _scale(q, scale), int(bool(causal)), _DTYPE_CODE[q.dtype],
                stream)
        if rc != 0:
            raise RuntimeError(f"flash attention backward kernel ({name}) "
                               f"launch failed: CUDA error {rc}")
        with _launches_lock:
            if which == 0:
                DQ_LAUNCHES += 1
            else:
                DKV_LAUNCHES += 1
    return dq, dk, dv, delta
