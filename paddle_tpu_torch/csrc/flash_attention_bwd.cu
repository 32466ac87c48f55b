// Flash-attention backward for Hopper (sm_90a): a dQ kernel and a dK/dV
// kernel.
//
// Replaces the Pallas backward kernels of paddle_tpu/ops/pallas/flash.py:
// `_dq_kernel` / `_dkv_kernel` (flash.py:465 / :519, launcher `_flash_bwd`:
// K/V or Q/dO resident in VMEM) and `_dq_kernel_kgrid` / `_dkv_kernel_kgrid`
// (flash.py:579 / :629, launcher `_flash_bwd_kgrid`: the other operand
// streamed by the TPU grid, the accumulators carried in VMEM scratch across
// grid steps). Both pairs compute one function,
// flash_attention_bwd_reference of ops/cuda/flash.py; here the streamed
// operand walks through shared memory in an inner loop of each thread block,
// so one pair of kernels covers both at any length, with nothing carried
// between blocks.
//
// Contract:
//   q, do      (B, H, Tq, D)    f32 or bf16, any strides with unit stride
//                               along D (the training step passes
//                               transposed views of (B, T, H, D) tensors)
//   k, v       (B, H, Tk, D)    q's type, the same stride rule
//   bias       f32 or null      element (b, h, i, j) at the four strides
//                               given (0 along a broadcast dimension)
//   segq/segk  (B, Tq)/(B, Tk)  int32 contiguous, or both null
//   lse, delta (B, H, Tq)       f32 contiguous: the forward's logsumexp and
//                               delta = sum(do * out, -1) - dlse
//   dq         (B, H, Tq, D)    q's type, contiguous
//   dk, dv     (B, H, Tk, D)    q's type, contiguous
//   scale      f32; causal 0/1, aligned bottom-right: key j is visible to
//              query i iff j <= i + (Tk - Tq)
//
// Both kernels recompute the probabilities from the saved lse,
// P = visible ? exp(scale q.k + bias - lse) : 0, and dS = P (dO.v - delta),
// then
//   dQ  = scale dS K            (one block per (b * H + h, 64-row q tile);
//                                it walks the 64-key K/V tiles up to the
//                                tile's last visible key: `_last_visible_kb`)
//   dK  = scale dS^T Q, dV = P^T dO
//                               (one block per (b * H + h, 64-key tile); it
//                                walks the 64-row Q/dO tiles from the first
//                                that sees one of its keys:
//                                `_first_visible_qb`)
// With segment ids a tile pair in which no (query, key) pair shares an id is
// skipped whole (`_seg_overlap`). Both prunings are exact: such tiles give
// P = 0 everywhere. Each block writes only its own output rows, so there are
// no atomics and the result is the same from run to run.
//
// Layout inside a block of 256 threads (ty = tid / 16, tx = tid % 16), as
// in the forward (csrc/flash_attention.cu): q is scaled in f32 as it lands
// in shared memory, tiles are f32 with rows padded to D + 1 floats so that
// the 16 rows a half-warp reads fall in 16 banks. In the dQ kernel a thread
// owns rows ty + 16 i and keys tx + 16 j of the 64 x 64 score tile and the
// dQ elements (ty + 16 i, tx + 16 c); dS goes through shared memory to the
// dS K product. In the dK/dV kernel a thread owns keys ty + 16 i and rows
// tx + 16 j of the transposed tile, and the dK, dV elements
// (ty + 16 i, tx + 16 c); P^T and dS^T go through shared memory to the
// P^T dO and dS^T Q products. Rows and keys past Tq and Tk are zero in
// shared memory and masked.
//
// What bounds it on this card: at the training shape (B 8, H 12, T 512,
// D 64, causal) the function moves q, k, v, out, do, dq, dk, dv once
// (~101 MB in f32: 30 us at 3.35 TB/s) and needs 5 products of 2 D flops
// over each of the 12.6 M visible pairs (S, dP, dQ, dK, dV: 8.1e9 flops,
// 0.12 ms at the f32 CUDA-core peak, 8 us at the bf16 tensor-core peak), so
// the operations bound it. These first kernels do 7 (S and dP in both
// kernels), as scalar f32 FMAs from shared memory, as the forward does;
// wgmma on TMA-fed bf16 tiles is the way down.
//
// Traps carried over from flash.py:
//   * NEG_INF is finite (-1e30) and a row with no visible key has
//     lse = -1e30 + log(1e-30), so exp(s - lse) of a masked entry would be
//     1: probabilities come from visible ? exp(s - lse) : 0, never the bare
//     exp. Such rows give dQ = 0 exactly and add nothing to dK, dV.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;  // query rows of a tile
constexpr int kBK = 64;  // keys of a tile
constexpr int kThreads = 256;
constexpr int kRows = kBQ / 16;  // rows (dQ) or keys (dK/dV) a thread owns
constexpr int kKeys = kBK / 16;  // the other side of its score-tile cells

// dtype codes of the C entry point
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* bias;
  const int* segq;
  const int* segk;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int64_t qs[3], ks[3], vs[3], ds[3];  // batch, head, time strides
  int64_t bs[4];                       // bias batch, head, query, key
  int B, H, Tq, Tk;
  float scale;
  int causal;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// rows [t0, t0 + 64) of a (T, D) operand at time stride `st` into f32
// shared memory (rows padded to kD + 1), times `mul`; rows past T are 0
template <typename T, int kD>
__device__ __forceinline__ void load_tile(float* sm, const T* g, int64_t st,
                                          int t0, int len, float mul) {
  constexpr int kDp = kD + 1;
  for (int i = threadIdx.x; i < 64 * kD; i += kThreads) {
    const int r = i / kD;
    const int d = i - r * kD;
    const int t = t0 + r;
    sm[r * kDp + d] = t < len ? to_f32(g[t * st + d]) * mul : 0.f;
  }
}

// shared memory of either kernel: four (64, D + 1) f32 tiles, two
// (64, 65) f32 score tiles, then lse and delta of 64 rows and the tile
// pair's segment ids
__host__ __device__ constexpr size_t smem_bytes(int D) {
  return ((size_t)4 * 64 * (D + 1) + (size_t)2 * 64 * (kBK + 1) + 2 * 64) *
             sizeof(float) +
         (size_t)(kBQ + kBK) * sizeof(int);
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const Params p) {
  extern __shared__ float smem[];
  constexpr int kDp = kD + 1;
  constexpr int kPp = kBK + 1;
  constexpr int kCols = kD / 16;
  float* q_sm = smem;
  float* do_sm = q_sm + kBQ * kDp;
  float* k_sm = do_sm + kBQ * kDp;
  float* v_sm = k_sm + kBK * kDp;
  float* ds_sm = v_sm + kBK * kDp;      // 64 x kPp; the second score tile
  float* lse_sm = ds_sm + 2 * kBQ * kPp;  // of the layout is unused here
  float* dlt_sm = lse_sm + kBQ;
  int* sq_sm = reinterpret_cast<int*>(dlt_sm + kBQ);
  int* sk_sm = sq_sm + kBQ;

  const int nqb = (p.Tq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x / nqb;
  // tiles of the same head heaviest (last rows, under causal) first
  const int qb = nqb - 1 - (blockIdx.x - bh * nqb);
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = qb * kBQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const bool has_seg = p.segq != nullptr;
  const bool has_bias = p.bias != nullptr;
  const int shift = p.Tk - p.Tq;

  const T* qg = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const T* dog = static_cast<const T*>(p.dout) + b * p.ds[0] + h * p.ds[1];
  const T* kg = static_cast<const T*>(p.k) + b * p.ks[0] + h * p.ks[1];
  const T* vg = static_cast<const T*>(p.v) + b * p.vs[0] + h * p.vs[1];
  const float* bg =
      has_bias ? p.bias + b * p.bs[0] + h * p.bs[1] : nullptr;
  const int64_t row0 = (int64_t)bh * p.Tq;

  load_tile<T, kD>(q_sm, qg, p.qs[2], q0, p.Tq, p.scale);
  load_tile<T, kD>(do_sm, dog, p.ds[2], q0, p.Tq, 1.f);
  for (int r = tid; r < kBQ; r += kThreads) {
    const bool in = q0 + r < p.Tq;
    lse_sm[r] = in ? p.lse[row0 + q0 + r] : 0.f;
    dlt_sm[r] = in ? p.delta[row0 + q0 + r] : 0.f;
    if (has_seg) sq_sm[r] = in ? p.segq[(int64_t)b * p.Tq + q0 + r] : 0;
  }

  int nkb = (p.Tk + kBK - 1) / kBK;
  if (p.causal) {
    // the last key any row of this tile sees (_last_visible_kb)
    const int last = min(q0 + kBQ, p.Tq) - 1 + shift;
    nkb = last < 0 ? 0 : min(nkb, last / kBK + 1);
  }

  float acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();  // the previous tile is consumed; q, do are stored
    load_tile<T, kD>(k_sm, kg, p.ks[2], k0, p.Tk, 1.f);
    load_tile<T, kD>(v_sm, vg, p.vs[2], k0, p.Tk, 1.f);
    if (has_seg)
      for (int c = tid; c < kBK; c += kThreads)
        sk_sm[c] = k0 + c < p.Tk ? p.segk[(int64_t)b * p.Tk + k0 + c] : 0;
    __syncthreads();
    if (has_seg) {
      // skip a tile in which no (query, key) pair shares a segment
      int overlap = 0;
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          const int r = ty + 16 * i;
          const int c = tx + 16 * j;
          overlap |= q0 + r < p.Tq && k0 + c < p.Tk && sq_sm[r] == sk_sm[c];
        }
      if (!__syncthreads_or(overlap)) continue;
    }

    // S = (scale q) k^T and dP = dO v^T over the tile, in one walk of D
    float s[kRows][kKeys], dp[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < kD; ++d) {
      float qv[kRows], ov[kRows], kv[kKeys], vv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qv[i] = q_sm[(ty + 16 * i) * kDp + d];
        ov[i] = do_sm[(ty + 16 * i) * kDp + d];
      }
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        kv[j] = k_sm[(tx + 16 * j) * kDp + d];
        vv[j] = v_sm[(tx + 16 * j) * kDp + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + 16 * i;
      const int tq = q0 + r;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int c = tx + 16 * j;
        const int tk = k0 + c;
        bool ok = tq < p.Tq && tk < p.Tk;
        if (p.causal) ok = ok && tk <= tq + shift;
        if (has_seg) ok = ok && sq_sm[r] == sk_sm[c];
        float x = s[i][j];
        if (ok && has_bias) x += bg[tq * p.bs[2] + tk * p.bs[3]];
        const float pr = ok ? expf(x - lse_sm[r]) : 0.f;
        ds_sm[r * kPp + c] = pr * (dp[i][j] - dlt_sm[r]);
      }
    }
    __syncthreads();  // every row's dS is stored
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float dsv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) dsv[i] = ds_sm[(ty + 16 * i) * kPp + c];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const float kk = k_sm[c * kDp + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          acc[i][cc] = fmaf(dsv[i], kk, acc[i][cc]);
      }
    }
  }

  T* dqg = static_cast<T*>(p.dq) + row0 * kD;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int tq = q0 + ty + 16 * i;
    if (tq >= p.Tq) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      store_out(dqg + (int64_t)tq * kD + tx + 16 * c, acc[i][c] * p.scale);
  }
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const Params p) {
  extern __shared__ float smem[];
  constexpr int kDp = kD + 1;
  constexpr int kPp = kBQ + 1;
  constexpr int kCols = kD / 16;
  float* q_sm = smem;
  float* do_sm = q_sm + kBQ * kDp;
  float* k_sm = do_sm + kBQ * kDp;
  float* v_sm = k_sm + kBK * kDp;
  float* pt_sm = v_sm + kBK * kDp;   // P^T: 64 keys x kPp
  float* dst_sm = pt_sm + kBK * kPp;  // dS^T
  float* lse_sm = dst_sm + kBK * kPp;
  float* dlt_sm = lse_sm + kBQ;
  int* sq_sm = reinterpret_cast<int*>(dlt_sm + kBQ);
  int* sk_sm = sq_sm + kBQ;

  const int nkb = (p.Tk + kBK - 1) / kBK;
  const int bh = blockIdx.x / nkb;
  // under causal the first key tiles are the heaviest: natural order
  const int kb = blockIdx.x - bh * nkb;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int k0 = kb * kBK;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const bool has_seg = p.segq != nullptr;
  const bool has_bias = p.bias != nullptr;
  const int shift = p.Tk - p.Tq;

  const T* qg = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const T* dog = static_cast<const T*>(p.dout) + b * p.ds[0] + h * p.ds[1];
  const T* kg = static_cast<const T*>(p.k) + b * p.ks[0] + h * p.ks[1];
  const T* vg = static_cast<const T*>(p.v) + b * p.vs[0] + h * p.vs[1];
  const float* bg =
      has_bias ? p.bias + b * p.bs[0] + h * p.bs[1] : nullptr;
  const int64_t row0 = (int64_t)bh * p.Tq;

  load_tile<T, kD>(k_sm, kg, p.ks[2], k0, p.Tk, 1.f);
  load_tile<T, kD>(v_sm, vg, p.vs[2], k0, p.Tk, 1.f);
  if (has_seg)
    for (int c = tid; c < kBK; c += kThreads)
      sk_sm[c] = k0 + c < p.Tk ? p.segk[(int64_t)b * p.Tk + k0 + c] : 0;

  const int nqb = (p.Tq + kBQ - 1) / kBQ;
  int qb_lo = 0;
  if (p.causal) {
    // the first query that sees key k0 is k0 - shift (_first_visible_qb)
    const int first = k0 - shift;
    qb_lo = first <= 0 ? 0 : min(nqb, first / kBQ);
  }

  float dk_acc[kRows][kCols], dv_acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int qb = qb_lo; qb < nqb; ++qb) {
    const int q0 = qb * kBQ;
    __syncthreads();  // the previous tile is consumed; k, v are stored
    load_tile<T, kD>(q_sm, qg, p.qs[2], q0, p.Tq, p.scale);
    load_tile<T, kD>(do_sm, dog, p.ds[2], q0, p.Tq, 1.f);
    for (int r = tid; r < kBQ; r += kThreads) {
      const bool in = q0 + r < p.Tq;
      lse_sm[r] = in ? p.lse[row0 + q0 + r] : 0.f;
      dlt_sm[r] = in ? p.delta[row0 + q0 + r] : 0.f;
      if (has_seg) sq_sm[r] = in ? p.segq[(int64_t)b * p.Tq + q0 + r] : 0;
    }
    __syncthreads();
    if (has_seg) {
      int overlap = 0;
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          const int c = ty + 16 * i;
          const int r = tx + 16 * j;
          overlap |= q0 + r < p.Tq && k0 + c < p.Tk && sq_sm[r] == sk_sm[c];
        }
      if (!__syncthreads_or(overlap)) continue;
    }

    // S^T = k (scale q)^T and dP^T = v dO^T, keys by rows
    float s[kRows][kKeys], dp[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < kD; ++d) {
      float kv[kRows], vv[kRows], qv[kKeys], ov[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        kv[i] = k_sm[(ty + 16 * i) * kDp + d];
        vv[i] = v_sm[(ty + 16 * i) * kDp + d];
      }
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        qv[j] = q_sm[(tx + 16 * j) * kDp + d];
        ov[j] = do_sm[(tx + 16 * j) * kDp + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int c = ty + 16 * i;
      const int tk = k0 + c;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int r = tx + 16 * j;
        const int tq = q0 + r;
        bool ok = tq < p.Tq && tk < p.Tk;
        if (p.causal) ok = ok && tk <= tq + shift;
        if (has_seg) ok = ok && sq_sm[r] == sk_sm[c];
        float x = s[i][j];
        if (ok && has_bias) x += bg[tq * p.bs[2] + tk * p.bs[3]];
        const float pr = ok ? expf(x - lse_sm[r]) : 0.f;
        pt_sm[c * kPp + r] = pr;
        dst_sm[c * kPp + r] = pr * (dp[i][j] - dlt_sm[r]);
      }
    }
    __syncthreads();  // P^T and dS^T are stored
#pragma unroll 4
    for (int r = 0; r < kBQ; ++r) {
      float pv[kRows], dsv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        pv[i] = pt_sm[(ty + 16 * i) * kPp + r];
        dsv[i] = dst_sm[(ty + 16 * i) * kPp + r];
      }
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const float ov = do_sm[r * kDp + tx + 16 * cc];
        const float qv = q_sm[r * kDp + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          dv_acc[i][cc] = fmaf(pv[i], ov, dv_acc[i][cc]);
          dk_acc[i][cc] = fmaf(dsv[i], qv, dk_acc[i][cc]);
        }
      }
    }
  }

  // q was scaled as it landed, so dS^T (scale q) is dK already
  T* dkg = static_cast<T*>(p.dk) + (int64_t)bh * p.Tk * kD;
  T* dvg = static_cast<T*>(p.dv) + (int64_t)bh * p.Tk * kD;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int tk = k0 + ty + 16 * i;
    if (tk >= p.Tk) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      store_out(dkg + (int64_t)tk * kD + tx + 16 * c, dk_acc[i][c]);
      store_out(dvg + (int64_t)tk * kD + tx + 16 * c, dv_acc[i][c]);
    }
  }
}

template <typename Kernel>
int launch_one(Kernel kernel, int64_t blocks, size_t smem,
               const Params& p, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int kD>
int launch(const Params& p, int which, cudaStream_t stream) {
  const size_t smem = smem_bytes(kD);
  const int64_t bh = (int64_t)p.B * p.H;
  if (which == 0)
    return launch_one(flash_bwd_dq_kernel<T, kD>,
                      bh * ((p.Tq + kBQ - 1) / kBQ), smem, p, stream);
  return launch_one(flash_bwd_dkv_kernel<T, kD>,
                    bh * ((p.Tk + kBK - 1) / kBK), smem, p, stream);
}

template <typename T>
int launch_d(int D, const Params& p, int which, cudaStream_t stream) {
  if (D == 32) return launch<T, 32>(p, which, stream);
  if (D == 64) return launch<T, 64>(p, which, stream);
  return launch<T, 128>(p, which, stream);
}

}  // namespace

extern "C" {

// which: 0 = the dQ kernel, 1 = the dK/dV kernel. strides: q, k, v, do
// (batch, head, time each) then bias (batch, head, query, key), in
// elements. dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError()
// after the launch (0 on success); the wrapper raises on anything else.
int flash_attention_bwd(int which, const void* q, const void* k,
                        const void* v, const void* dout, const void* bias,
                        const void* segq, const void* segk, const void* lse,
                        const void* delta, void* dq, void* dk, void* dv,
                        const int64_t* strides, int B, int H, int Tq, int Tk,
                        int D, float scale, int causal, int dtype,
                        void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || (which != 0 && which != 1) ||
      (D != 32 && D != 64 && D != 128) || (segq == nullptr) != (segk == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.bias = static_cast<const float*>(bias);
  p.segq = static_cast<const int*>(segq);
  p.segk = static_cast<const int*>(segk);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.ds[i] = strides[9 + i];
  }
  for (int i = 0; i < 4; ++i) p.bs[i] = strides[12 + i];
  p.B = B;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.scale = scale;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_d<float>(D, p, which, s);
  if (dtype == kBF16) return launch_d<__nv_bfloat16>(D, p, which, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
