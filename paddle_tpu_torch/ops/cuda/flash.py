"""Flash-attention forward on Hopper: the CUDA kernel, its wrapper, and
its plain PyTorch version.

Replaces the Pallas forward kernels of ``paddle_tpu/ops/pallas/flash.py``:
``_fwd_kernel`` (``:168``, launcher ``_flash_fwd``; K/V resident in VMEM)
and ``_fwd_kernel_kgrid`` (``:318``, launcher ``_flash_fwd_kgrid``; K/V
streamed by the grid for long contexts). Both compute one function, and
one kernel, ``csrc/flash_attention.cu``, serves both: a thread block owns
one (batch x head, 64-row query tile) and streams 64-key K/V tiles
through shared memory with an f32 online softmax, so any key length fits.

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

Where a row has visible keys the kernel and the plain version give no
weight to masked keys: probabilities are where(visible, exp(s - m), 0).
That is what the JAX kernels give as well, except in one degenerate
corner (a row whose visible keys all score at -1e30, or a row with no
visible key in a tile another row needs), where JAX's tiling decides.

What bounds the kernel on this card: at the prefill shape (B 8, H 12,
T 512, D 64, causal, bf16) the bytes (q, k, v read once, out and lse
written once: 25.4 MB, 7.6 us at 3.35 TB/s) against 3.2 GFLOP of
products (3.3 us at the bf16 peak); at long causal shapes (T 16384) the
operations. This first kernel computes its products with scalar f32 FMAs
from shared memory and is far from either bound; PERF.md has its times.

Numerics, keyed by q's dtype in ``TOLERANCE``: both sides compute in f32
from the same inputs and differ only in summation order (f32) and, for
bf16, in the rounding of values that straddle a bf16 step once the
outputs are cast. The error is measured element-wise as
``|out - ref| / max(1, |ref|)``; lse is f32 on both sides and held to the
f32 tolerance. A bf16 output is also held, row by row, to
``BF16_ROW_REL_TOLERANCE`` of the plain version computed in f32.

The shared library is built at first use, from the repository's source,
into ``paddle_tpu_torch/csrc/build/`` with ``nvcc`` for ``sm_90a`` and
loaded with ctypes. Nothing here builds anything at import time.
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

# bf16 kernel vs the plain version run in f32 on the same inputs, per
# output row: max-abs error over the row's max |ref|. The kernel rounds
# only its output to bf16 (at most 2**-9 of a value)
BF16_ROW_REL_TOLERANCE = 5e-3

HEAD_DIMS = (32, 64, 128)

# kernel launches in this process since the last reset: the wrapper adds
# one per launch, and it is the only count of them
LAUNCHES = 0
_launches_lock = threading.Lock()

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lib = None
_lib_lock = threading.Lock()


# ---------------------------------------------------------------------------
# plain PyTorch version (the semantic spec)
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


def flash_attention_reference(q, k, v, bias=None, segq=None, segk=None,
                              scale=None, causal=False):
    """Plain attention with the flash kernels' semantics.

    q (B, H, Tq, D); k/v (B, H, Tk, D), q's dtype; bias None or
    broadcastable to (B, H, Tq, Tk) (from (B|1, H|1, Tq|1, Tk)); segq
    (B, Tq) / segk (B, Tk) int or None; scale None means 1/sqrt(D) ->
    (out (B, H, Tq, D) in q's dtype, lse (B, H, Tq) f32)."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    tq, tk = q.shape[2], k.shape[2]
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if bias is not None:
        s = s + bias.float()
    vis = _visible_mask(tq, tk, causal, segq, segk, device=q.device)
    s = torch.where(vis, s, torch.tensor(NEG_INF, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(vis, torch.exp(s - m), torch.zeros((), device=q.device))
    l = p.sum(dim=-1, keepdim=True).clamp_min(L_FLOOR)
    out = torch.matmul(p, v.float()) / l
    lse = (m + torch.log(l))[..., 0]
    return out.to(q.dtype), lse


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def build():
    """Compile csrc/flash_attention.cu for sm_90a into csrc/build/ (once
    per source content) and load it; the library is kept for the
    process."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = build_library("flash_attention.cu")
        # q, k, v, bias, segq, segk, out, lse; strides (13 int64); B, H,
        # Tq, Tk, D; scale; causal, dtype; stream
        lib.flash_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float]
            + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.flash_attention_fwd.restype = ctypes.c_int
        _lib = lib
        return lib


def _check(q, k, v, bias, segq, segk):
    """Raise on operands the kernel does not take. Returns the bias as an
    f32 (B, H, Tq, Tk) view (broadcast dimensions get stride 0)."""
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
    tensors = [q, k, v]
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


def flash_attention_cuda(q, k, v, bias=None, segq=None, segk=None,
                         scale=None, causal=False):
    """Launch the kernel on the current stream; the contract of
    flash_attention_reference. q/k/v may be strided views (a unit stride
    along D), such as the prefill's head-transposed projections; out is
    (B, H, Tq, D) contiguous in q's dtype, lse (B, H, Tq) f32. Raises on
    operands it does not take and on a refused launch; never falls
    back."""
    global LAUNCHES
    bias = _check(q, k, v, bias, segq, segk)
    lib = build()
    b, h, tq, d = q.shape
    tk = k.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    out = torch.empty((b, h, tq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    strides += list(bias.stride()) if bias is not None else [0] * 4
    strides = (ctypes.c_int64 * 13)(*strides)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            segq.data_ptr() if segq is not None else None,
            segk.data_ptr() if segk is not None else None,
            out.data_ptr(), lse.data_ptr(), strides, b, h, tq, tk, d,
            scale, int(bool(causal)), _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {rc}")
    with _launches_lock:
        LAUNCHES += 1
    return out, lse
