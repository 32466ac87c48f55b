// Streaming flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas forward kernels of paddle_tpu/ops/pallas/flash.py:
// `_fwd_kernel` (flash.py:168, launcher `_flash_fwd`: K/V resident in VMEM)
// and `_fwd_kernel_kgrid` (flash.py:318, launcher `_flash_fwd_kgrid`: K/V
// streamed by the TPU grid for long contexts). Both compute one function,
// flash_attention_reference of ops/cuda/flash.py; this one kernel streams
// K/V through shared memory in an inner loop, so it covers both: any key
// length fits, with nothing carried between thread blocks.
//
// Contract:
//   q          (B, H, Tq, D)    f32 or bf16, any strides with unit stride
//                               along D (the prefill passes transposed
//                               views of its (B, T, H, D) projections)
//   k, v       (B, H, Tk, D)    q's type, the same stride rule
//   bias       f32 or null      element (b, h, i, j) at the four strides
//                               given (0 along a broadcast dimension):
//                               key-only, per-query, per-head or full
//   segq/segk  (B, Tq)/(B, Tk)  int32 contiguous, or both null
//   out        (B, H, Tq, D)    q's type, contiguous
//   lse        (B, H, Tq)       f32, contiguous
//   scale      f32; causal 0/1, aligned bottom-right: key j is visible to
//              query i iff j <= i + (Tk - Tq)
//
// Design. One thread block of 256 threads per (b * H + h, 64-row q tile);
// tiles of the same head are launched heaviest (last rows) first. The
// block scales its q tile in f32 into shared memory once, then walks
// 64-key tiles: K and V land in f32 shared memory (rows beyond Tk as 0),
// the 64 x 64 score tile is computed with each thread owning 4 rows x 4
// keys (rows ty + 16 i, keys tx + 16 j: the K rows are padded to D + 1
// floats so the 16 keys of a half-warp fall in 16 banks), the bias is
// added in f32 and the mask applied; each row's max and sum are reduced
// over the 16 threads that share it with shuffles, and the running max m,
// sum l and the 4 x D/16 accumulator elements each thread owns stay in
// registers. The probabilities go through shared memory to the P V
// product. Causal pruning stops the walk after the tile's last visible key
// (`_last_visible_kb`), and with segment ids a tile in which no (query,
// key) pair shares an id is skipped whole (`_seg_overlap`): both are exact,
// since such tiles give every row probability 0.
//
// What bounds it on this card: at the prefill shape (B 8, H 12, T 512,
// D 64, causal, bf16) the bytes, q/k/v read once and out/lse written once
// (25.4 MB: 7.6 us at 3.35 TB/s) against 3.2 GFLOP (3.3 us at 989 TFLOP/s);
// at T 16384 the operations (4.1e11 FLOP at H 12). The products here are
// scalar f32 FMAs from shared memory, which is what holds this first
// kernel far from both bounds; wgmma with TMA-fed tiles is the way down.
//
// Traps carried over from flash.py:
//   * NEG_INF is finite (-1e30): where no key of a row is visible yet,
//     m == NEG_INF and exp(s - m) would be 1, so probabilities come from
//     visible ? exp(s - m) : 0, never the bare exp.
//   * A row with no visible key ends with l == 0: out = acc / max(l, 1e-30)
//     = 0 exactly and lse = m + log(1e-30), as the pruned JAX loop gives.
//   * q rows >= Tq are computed on zeros and never written; keys >= Tk are
//     masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLFloor = 1e-30f;
constexpr int kBQ = 64;  // query rows of a tile
constexpr int kBK = 64;  // keys of a tile
constexpr int kThreads = 256;
constexpr int kRows = kBQ / 16;  // query rows a thread owns
constexpr int kKeys = kBK / 16;  // keys of a score tile a thread owns
constexpr unsigned kFull = 0xffffffffu;

// dtype codes of the C entry point
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  const int* segq;
  const int* segk;
  void* out;
  float* lse;
  int64_t qs[3], ks[3], vs[3];  // batch, head, time strides (elements)
  int64_t bs[4];                // bias batch, head, query, key strides
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

// max / sum over the 16 threads (tx = 0..15) that share a row: lanes
// 0-15 and 16-31 of a warp are two rows' groups
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// shared memory: q tile (rows padded to D + 1), K tile (padded), V tile,
// probabilities (rows padded to kBK + 1), then the tile's segment ids
__host__ __device__ constexpr size_t smem_floats(int D) {
  return (size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) + (size_t)kBK * D +
         (size_t)kBQ * (kBK + 1);
}
__host__ __device__ constexpr size_t smem_bytes(int D) {
  return smem_floats(D) * sizeof(float) + (size_t)(kBQ + kBK) * sizeof(int);
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Params p) {
  extern __shared__ float smem[];
  constexpr int kDp = kD + 1;
  constexpr int kPp = kBK + 1;
  constexpr int kCols = kD / 16;  // output columns a thread owns
  float* q_sm = smem;
  float* k_sm = q_sm + kBQ * kDp;
  float* v_sm = k_sm + kBK * kDp;
  float* p_sm = v_sm + kBK * kD;
  int* sq_sm = reinterpret_cast<int*>(p_sm + kBQ * kPp);
  int* sk_sm = sq_sm + kBQ;

  const int nqb = (p.Tq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x / nqb;
  const int qb = nqb - 1 - (blockIdx.x - bh * nqb);
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = qb * kBQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const bool has_seg = p.segq != nullptr;
  const bool has_bias = p.bias != nullptr;
  const int shift = p.Tk - p.Tq;  // causal: key j visible iff j <= i + shift

  const T* qg = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const T* kg = static_cast<const T*>(p.k) + b * p.ks[0] + h * p.ks[1];
  const T* vg = static_cast<const T*>(p.v) + b * p.vs[0] + h * p.vs[1];
  const float* bg =
      has_bias ? p.bias + b * p.bs[0] + h * p.bs[1] : nullptr;

  for (int i = tid; i < kBQ * kD; i += kThreads) {
    const int r = i / kD;
    const int d = i - r * kD;
    const int t = q0 + r;
    q_sm[r * kDp + d] =
        t < p.Tq ? to_f32(qg[t * p.qs[2] + d]) * p.scale : 0.f;
  }
  if (has_seg)
    for (int r = tid; r < kBQ; r += kThreads)
      sq_sm[r] = q0 + r < p.Tq ? p.segq[(int64_t)b * p.Tq + q0 + r] : 0;

  int nkb = (p.Tk + kBK - 1) / kBK;
  if (p.causal) {
    // the last key any row of this tile sees (_last_visible_kb)
    const int last = min(q0 + kBQ, p.Tq) - 1 + shift;
    nkb = last < 0 ? 0 : min(nkb, last / kBK + 1);
  }

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();  // the previous tile is consumed; q is stored
    for (int i = tid; i < kBK * kD; i += kThreads) {
      const int c = i / kD;
      const int d = i - c * kD;
      const int t = k0 + c;
      const bool in = t < p.Tk;
      k_sm[c * kDp + d] = in ? to_f32(kg[t * p.ks[2] + d]) : 0.f;
      v_sm[c * kD + d] = in ? to_f32(vg[t * p.vs[2] + d]) : 0.f;
    }
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

    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kD; ++d) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = q_sm[(ty + 16 * i) * kDp + d];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kv[j] = k_sm[(tx + 16 * j) * kDp + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + 16 * i;
      const int tq = q0 + r;
      bool vis[kKeys];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int c = tx + 16 * j;
        const int tk = k0 + c;
        bool ok = tq < p.Tq && tk < p.Tk;
        if (p.causal) ok = ok && tk <= tq + shift;
        if (has_seg) ok = ok && sq_sm[r] == sk_sm[c];
        float x = s[i][j];
        if (ok && has_bias) x += bg[tq * p.bs[2] + tk * p.bs[3]];
        x = ok ? x : kNegInf;
        s[i][j] = x;
        vis[j] = ok;
        mx = fmaxf(mx, x);
      }
      mx = group_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float pr = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        p_sm[r * kPp + tx + 16 * j] = pr;
        sum += pr;
      }
      sum = group_sum(sum);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // every row's probabilities are stored
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = p_sm[(ty + 16 * i) * kPp + c];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const float vv = v_sm[c * kD + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          acc[i][cc] = fmaf(pv[i], vv, acc[i][cc]);
      }
    }
  }

  T* og = static_cast<T*>(p.out) + (int64_t)bh * p.Tq * kD;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int tq = q0 + ty + 16 * i;
    if (tq >= p.Tq) continue;
    const float lf = fmaxf(l[i], kLFloor);
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      store_out(og + (int64_t)tq * kD + tx + 16 * c, acc[i][c] / lf);
    if (tx == 0) p.lse[(int64_t)bh * p.Tq + tq] = m[i] + logf(lf);
  }
}

template <typename T, int kD>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(kD);
  auto kernel = flash_fwd_kernel<T, kD>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t blocks =
      (int64_t)p.B * p.H * ((p.Tq + kBQ - 1) / kBQ);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const Params& p, cudaStream_t stream) {
  if (D == 32) return launch<T, 32>(p, stream);
  if (D == 64) return launch<T, 64>(p, stream);
  return launch<T, 128>(p, stream);
}

}  // namespace

extern "C" {

// strides: q, k, v (batch, head, time each) then bias (batch, head, query,
// key), in elements. dtype: 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError() after the launch (0 on success); the wrapper raises on
// anything else.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* bias, const void* segq, const void* segk,
                        void* out, void* lse, const int64_t* strides, int B,
                        int H, int Tq, int Tk, int D, float scale, int causal,
                        int dtype, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 ||
      (D != 32 && D != 64 && D != 128) || (segq == nullptr) != (segk == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.segq = static_cast<const int*>(segq);
  p.segk = static_cast<const int*>(segk);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
  }
  for (int i = 0; i < 4; ++i) p.bs[i] = strides[9 + i];
  p.B = B;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.scale = scale;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_d<float>(D, p, s);
  if (dtype == kBF16) return launch_d<__nv_bfloat16>(D, p, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
