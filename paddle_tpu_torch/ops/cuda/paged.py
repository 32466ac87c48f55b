"""Ragged paged attention on Hopper: the CUDA kernel, its wrapper, and
its plain PyTorch version.

Replaces the Pallas kernels of ``paddle_tpu/ops/pallas/paged.py``:
``_paged_kernel`` (launcher ``ragged_paged_attention``) and
``_paged_kernel_v2`` (launcher ``ragged_paged_attention_v2``), dense
f32/bf16 pools. One kernel, ``csrc/paged_attention.cu``, serves both:
the function of ``paged_attention_reference`` computed in the v2 style,
one streaming pass with an online softmax whose running max, sum and
accumulator are f32. The int8 variants wait for a later slice.

What bounds it: the bytes of the live K/V blocks read from device
memory (decode reads every live block of every lane once per layer and
does ~2 flops per byte). The design reads each live (bs, D) tile once
per (lane, KV head) into shared memory and reuses it for every query
row of the head group (H/H_kv heads x C columns), stops at each lane's
highest live block, and never touches a NULL block, so the bytes moved
are those of the live blocks and nothing else. Within a block the warps
split the lane's blocks between them (each with its own online-softmax
state, merged at the end), load one tile ahead, and skip the rows that a
tile masks entirely. The kernel is still far from its bound; PERF.md has
its times.

Numerics: the kernel, like v2, accumulates PV in f32. The plain version,
like the JAX reference, casts the probabilities to the value dtype
before PV (``kv_cache.py:261``), and computes bf16 scores in bf16. So the
two agree to ``TOLERANCE[torch.float32]`` in f32 and to
``TOLERANCE[torch.bfloat16]`` absolute in bf16; a bf16 kernel output is
also held, row by row, to ``BF16_ROW_REL_TOLERANCE`` of the plain version
computed in f32 from the same bf16 inputs.

The shared library is built at first use, from the repository's source,
into ``paddle_tpu_torch/csrc/build/`` with ``nvcc`` for ``sm_90a`` and
loaded with ctypes. Nothing here imports or builds anything at import
time, so the module imports on a machine without CUDA.
"""

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading

import torch

NULL_BLOCK = 0          # mirrors serving.kv_cache.NULL_BLOCK
NEG_INF = -1e9          # mirrors serving.kv_cache.NEG_INF

# max-abs tolerance of kernel vs plain version, per pool dtype: f32 differ
# only in summation order; bf16 differ by the plain version's bf16 scores
# and its bf16 probabilities before PV
TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 2e-2}

# bf16 kernel vs the plain version run in f32 on the same bf16 inputs,
# per output row (lane, head, column): max-abs error over the row's
# max |ref|. The kernel computes in f32 and rounds only its output to
# bf16 (at most 2**-8 of a value), so a one-key mask error at a context
# of hundreds (~1e-2 of a row's scale) fails where 2e-2 absolute would not
BF16_ROW_REL_TOLERANCE = 5e-3

HEAD_DIMS = (32, 64)
MAX_SMEM_BYTES = 227 * 1024     # dynamic shared memory one block may use

# kernel launches in this process since the last reset: the wrapper adds
# one per launch, and it is the only count of them
LAUNCHES = 0
_launches_lock = threading.Lock()

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
_SOURCE = os.path.join(_CSRC, "paged_attention.cu")
_BUILD_DIR = os.path.join(_CSRC, "build")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lib = None
_lib_lock = threading.Lock()


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


def paged_attention_reference(q, k_pool, v_pool, block_table,
                              q_positions):
    """Plain paged attention: gather blocks by table, mask keys beyond
    each query's position, softmax in f32, weighted sum.

    q (B, H, C, D); k/v_pool (N, H_kv, bs, D) with H % H_kv == 0; table
    (B, M) int; positions (B, C) int -> (B, H, C, D) in v_pool's dtype.
    Scores are computed in q's dtype, the softmax in f32, and the
    probabilities are cast back to the value dtype before PV, as in the
    JAX reference. GQA repeats the gathered KV rows across each group of
    H/H_kv query heads."""
    d = q.shape[-1]
    h, hp = q.shape[1], k_pool.shape[1]
    if hp > h or h % hp:
        raise ValueError(
            f"pool heads {hp} do not match q heads {h} (GQA needs q "
            f"heads a multiple of pool heads)")
    gk, gv = gather_block_kv_pair(k_pool, v_pool, block_table)
    if hp < h:
        gk = gk.repeat_interleave(h // hp, dim=1)
        gv = gv.repeat_interleave(h // hp, dim=1)
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

def _nvcc():
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the paged "
            "attention kernel is built from source at first use")
    return found


def build():
    """Compile csrc/paged_attention.cu for sm_90a into csrc/build/ (once
    per source content) and load it; the library is kept for the
    process."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        with open(_SOURCE, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:12]
        os.makedirs(_BUILD_DIR, exist_ok=True)
        so = os.path.join(_BUILD_DIR, f"libpaged_attention_{digest}.so")
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-o", tmp, _SOURCE]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({res.returncode}):\n{res.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        lib.paged_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.paged_attention_fwd.restype = ctypes.c_int
        lib.paged_attention_smem_bytes.argtypes = [ctypes.c_int] * 5
        lib.paged_attention_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
        return lib


def _check(q, k_pool, v_pool, block_table, q_positions):
    tensors = (q, k_pool, v_pool, block_table, q_positions)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("paged attention kernel: every operand must be a "
                         "CUDA tensor")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("paged attention kernel: operands on different "
                         "devices")
    if q.dim() != 4 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"q {tuple(q.shape)} / pools {tuple(k_pool.shape)}"
                         f" {tuple(v_pool.shape)}: want 4-D, equal pools")
    if not (q.dtype == k_pool.dtype == v_pool.dtype) \
            or q.dtype not in _DTYPE_CODE:
        raise ValueError(f"dtypes q {q.dtype}, pools {k_pool.dtype}/"
                         f"{v_pool.dtype}: want one of f32, bf16 for all")
    b, h, c, d = q.shape
    _, hp, bs, dp = k_pool.shape
    if dp != d or d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} (pool {dp}): the kernel takes "
                         f"{HEAD_DIMS}")
    if hp > h or h % hp:
        raise ValueError(f"pool heads {hp} do not divide q heads {h}")
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


def paged_attention_cuda(q, k_pool, v_pool, block_table, q_positions):
    """Launch the kernel on the current stream; (B, H, C, D) out in the
    pool dtype. Raises on operands it does not take and on a refused
    launch; never falls back."""
    global LAUNCHES
    _check(q, k_pool, v_pool, block_table, q_positions)
    lib = build()
    b, h, c, d = q.shape
    _, hp, bs, _ = k_pool.shape
    m = block_table.shape[1]
    if lib.paged_attention_smem_bytes(h, hp, c, d, bs) == 0:
        raise ValueError(f"H/H_kv={h // hp}, C={c}, D={d}, bs={bs}: one "
                         f"warp's state exceeds the card's "
                         f"{MAX_SMEM_BYTES} bytes of shared memory")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.paged_attention_fwd(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_table.data_ptr(), q_positions.data_ptr(), out.data_ptr(),
            b, h, hp, c, d, bs, m, _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"paged attention kernel launch failed: CUDA "
                           f"error {rc}")
    with _launches_lock:
        LAUNCHES += 1
    return out
