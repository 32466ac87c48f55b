"""Flash attention on Hopper: the forward and backward CUDA kernels, their
wrappers, and their plain PyTorch versions.

The forward replaces the Pallas forward kernels of
``paddle_tpu/ops/pallas/flash.py``: ``_fwd_kernel`` (``:168``, launcher
``_flash_fwd``; K/V resident in VMEM) and ``_fwd_kernel_kgrid`` (``:318``,
launcher ``_flash_fwd_kgrid``; K/V streamed by the grid for long
contexts). Both compute one function, and one entry point of
``csrc/flash_attention.cu`` serves both, streaming K/V through shared
memory with an f32 online softmax so that any key length fits. It holds two
kernels, chosen by dtype: bf16 takes the tensor-core kernel (a block owns
128 query rows of one batch x head; a producer warp feeds 128-key K/V
tiles through a three-stage TMA ring, two consumer warpgroups compute
both products with ``wgmma`` and take turns at the tensor cores), f32 the
SIMT kernel (a block per 64-row query tile, scalar f32 products from
shared memory).

The backward replaces ``_dq_kernel`` / ``_dkv_kernel`` (``:465`` / ``:519``,
launcher ``_flash_bwd``) and ``_dq_kernel_kgrid`` / ``_dkv_kernel_kgrid``
(``:579`` / ``:629``, launcher ``_flash_bwd_kgrid``) the same way: one pair
of kernels, ``csrc/flash_attention_bwd.cu``, a dQ kernel over q tiles and a
dK/dV kernel over key tiles, each streaming the other side through a
``cp.async`` ring in shared memory and recomputing the probabilities from
the saved lse, every product on the tensor cores (``mma.sync``: f32 as
three TF32 passes, bf16 with P and dS as bf16 hi + lo). JAX computes
``delta`` outside Pallas; here the dQ kernel computes it, by the same
tensor-core products as dP, so that a query whose only visible key is the
one its output copied gets a gradient of exactly 0, as the exact function
has, not the rounding difference of two summation orders.

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
operations. In f32 the operations bound both at the training shape (the
same, f32): an f32-accurate product can run on the tensor cores as three
TF32 passes (494.7 / 3 = 164.9 TFLOP/s, the rate the bounds use), so the
forward's 3.2e9 flops take at least 0.0196 ms and the backward's 8.1e9
(its ~101 MB take 30 us) 0.049 ms. The f32 forward still computes its
products with scalar f32 FMAs from shared memory, the f32 backward as
three TF32 passes on the tensor cores; PERF.md has every kernel's times.

Numerics, keyed by q's dtype in ``TOLERANCE`` (forward) and
``BWD_TOLERANCE`` (dq, dk, dv): both sides compute in f32 from the same
inputs and differ only in summation order (f32; the backward's sums run
over up to Tq or Tk terms, hence its looser f32 bound) and, for bf16, in
the rounding of values that straddle a bf16 step once the outputs are
cast; the bf16 kernel also rounds the probabilities to bf16 before the
P V product. The error is measured element-wise as ``|out - ref| / max(1,
|ref|)``; lse is f32 on both sides and held to the f32 tolerance. A bf16
output is also held, row by row, to ``BF16_FWD_ROW_REL_TOLERANCE``
(forward) or ``BF16_ROW_REL_TOLERANCE`` (backward) of the plain version
computed in f32.

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

# bf16 kernel vs the plain version run in f32 (the backward's: in f64,
# where rows whose exact gradient is 0 are exactly 0) on the same inputs,
# per output row: max-abs error over the row's max |ref|. The backward
# kernels carry P and dS into their second products as bf16 hi + lo and
# round only their outputs to bf16
BF16_ROW_REL_TOLERANCE = 5e-3

# the same measure for the bf16 forward (the tensor-core kernel), which
# rounds twice: each probability to bf16 before the P V product (half a
# bf16 step, up to 2**-8 relative, errors of both signs weighted over the
# row's keys) and then the output (up to 2**-8 of a value). Each can
# reach ~2**-8 of the row's scale, hence 2 x 2**-8 = 7.8e-3 and this
# bound; tests/test_torch_flash.py measures the two roundings on the CPU
# (up to 5.5e-3), an H100 up to 6.7e-3 at T 16384
BF16_FWD_ROW_REL_TOLERANCE = 1e-2

HEAD_DIMS = (32, 64, 128)

# kernel launches in this process since the last reset: each wrapper adds
# one per launch of its kernel, and these are the only counts of them
LAUNCHES = 0            # the forward, both kernels
TC_LAUNCHES = 0         # the forward's tensor-core (bf16) kernel
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
    # which; q, k, v, do, out, bias, segq, segk, lse, dlse, delta, dq, dk,
    # dv; strides (19 int64); B, H, Tq, Tk, D; scale; causal, dtype; stream
    return _build_lib(
        "flash_attention_bwd.cu", "flash_attention_bwd",
        [ctypes.c_int] + [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5
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


def tma_aligned(t):
    """Whether a (B, H, T, D) view meets the 16-byte rule of the kernels'
    bulk copies (the bf16 forward's TMA, the backward's ``cp.async``): a
    16-byte-aligned base and batch, head and time strides that are
    positive multiples of 16 bytes (the unit stride along D aside)."""
    nbytes = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        s > 0 and s * nbytes % 16 == 0 for s in t.stride()[:3])


def _aligned(t):
    """t, or a contiguous copy of it where it breaks ``tma_aligned``."""
    return t if tma_aligned(t) else t.clone(
        memory_format=torch.contiguous_format)


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
    flash_attention_reference. bf16 launches the tensor-core kernel, f32
    the SIMT kernel. q/k/v may be strided views (a unit stride along D),
    such as the prefill's head-transposed projections; a bf16 view that
    does not meet TMA's rule (``tma_aligned``) is first copied into a
    contiguous tensor (the prefill's views meet it and are never copied),
    and so is a bias without a unit stride along keys.
    out is (B, H, Tq, D) contiguous in q's dtype, lse (B, H, Tq) f32.
    Raises on operands it does not take and on a refused launch; never
    falls back."""
    global LAUNCHES, TC_LAUNCHES
    bias = _check(q, k, v, bias, segq, segk)
    tc = q.dtype == torch.bfloat16
    if tc:
        q, k, v = (_aligned(t) for t in (q, k, v))
        if bias is not None and bias.stride(3) != 1:
            bias = bias.contiguous()    # the kernel reads bias rows whole
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
        raise RuntimeError(f"flash attention kernel launch failed: error "
                           f"{rc} (a cudaError_t; 9000: no "
                           f"cuTensorMapEncodeTiled, 10000 + n: CUresult "
                           f"n making a tensor map)")
    with _launches_lock:
        LAUNCHES += 1
        TC_LAUNCHES += tc
    return out, lse


def flash_attention_bwd_cuda(q, k, v, bias, segq, segk, out, lse, do,
                             dlse=None, scale=None, causal=False):
    """Launch the dQ kernel, then the dK/dV kernel, on the current
    stream; the contract of flash_attention_bwd_reference. q/k/v/do/out
    may be strided views with a unit stride along D; one that breaks the
    16-byte rule of the kernels' copies (``tma_aligned``) is first copied
    into a contiguous tensor (the training step's views meet it and are
    never copied). dq, dk, dv come back contiguous in q's dtype, delta
    (B, H, Tq) f32. delta = sum(do * out, -1) - dlse is computed by the dQ
    kernel, with the tensor-core products that give dP (so that a row whose
    only visible key is the one its output copied gets dS = 0 exactly), and
    read by the dK/dV kernel. Raises on operands the kernels do not take
    and on a refused launch; never falls back."""
    global DQ_LAUNCHES, DKV_LAUNCHES
    b, h, tq, d = q.shape
    tk = k.shape[2]
    for name, t, shape in (("out", out, q.shape), ("do", do, q.shape),
                           ("lse", lse, (b, h, tq))):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} {tuple(t.shape)}: want {tuple(shape)}")
    for name, t in (("do", do), ("out", out)):
        if t.dtype != q.dtype or t.stride(-1) != 1:
            raise ValueError(f"{name} {t.dtype} with stride {t.stride(-1)} "
                             f"along D: want q's dtype and a unit stride")
    if lse.dtype != torch.float32 or (
            dlse is not None and tuple(dlse.shape) != (b, h, tq)):
        raise ValueError("lse must be f32 and dlse (B, H, Tq)")
    more = [out, do, lse] + ([dlse] if dlse is not None else [])
    bias = _check(q, k, v, bias, segq, segk, *more)
    lib = build_bwd()
    q, k, v, do, out = (_aligned(t) for t in (q, k, v, do, out))
    lse = lse.contiguous()
    if dlse is not None:
        dlse = dlse.float().contiguous()
    delta = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    dq = torch.empty((b, h, tq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, h, tk, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, h, tk, d), dtype=q.dtype, device=q.device)
    strides = _strides((q, k, v, do, out), bias)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    for which, name in ((0, "dq"), (1, "dkv")):
        with torch.cuda.device(q.device):
            rc = lib.flash_attention_bwd(
                which, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                do.data_ptr(), out.data_ptr(), _ptr(bias), _ptr(segq),
                _ptr(segk), lse.data_ptr(), _ptr(dlse), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), strides, b, h,
                tq, tk, d, _scale(q, scale), int(bool(causal)),
                _DTYPE_CODE[q.dtype], stream)
        if rc != 0:
            raise RuntimeError(f"flash attention backward kernel ({name}) "
                               f"launch failed: CUDA error {rc}")
        with _launches_lock:
            if which == 0:
                DQ_LAUNCHES += 1
            else:
                DKV_LAUNCHES += 1
    return dq, dk, dv, delta
