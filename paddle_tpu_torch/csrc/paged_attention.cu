// Ragged paged attention for Hopper (sm_90a): the serving hot-loop kernel.
//
// Replaces the Pallas kernels `_paged_kernel` (ragged_paged_attention) and
// `_paged_kernel_v2` (ragged_paged_attention_v2) of
// paddle_tpu/ops/pallas/paged.py, dense f32/bf16 pools. One kernel serves
// both: it computes the function of paged_attention_reference in the v2
// style, streaming the lane's live blocks through an online softmax whose
// running max, sum and accumulator are f32.
//
// Contract (the same as the Pallas launchers):
//   q          (B, H, C, D)        pool dtype, D = 32 or 64
//   k/v_pool   (N, H_kv, bs, D)    f32 or bf16, H % H_kv == 0
//   table      (B, M)  int32       NULL_BLOCK (0) padded
//   positions  (B, C)  int32       logical position of each query column
//   out        (B, H, C, D)        pool dtype
//
// Design. One thread block per (lane, KV head); the block reads its own
// table and positions rows (a GPU has no scalar prefetch) and walks
// j < min(max_pos / bs + 1, M). Rows are the H/H_kv query heads of the
// group times the C columns (query head h reads KV head h / (H/H_kv));
// they are contiguous in q and out, so the GQA repeat is never
// materialized. Each warp of the block takes every NW-th live block and
// keeps its own online-softmax state (m, l, acc) in shared memory, so the
// loop needs warp barriers only; one block barrier at the end merges the
// NW partial states (split-K inside the block). A warp loads a block's
// (bs, D) K and V tiles with 16-byte loads into registers one tile ahead,
// so they fly while the current tile is computed, and never loads a NULL
// block. It then folds the tile into each row with a live key in it, all
// 32 lanes on one row at a time: lanes split the keys (and, when bs divides 32,
// the D dimension, summed with shuffles), the max and the sum are warp
// reductions, and the PV update spreads D over the lanes. Rows whose
// position lies below the tile are skipped (the fused step's decode lanes
// feed one valid column and C-1 masked ones at position 0).
//
// What bounds it: the bytes of the live K/V blocks read from device
// memory. Each live tile is read once per (lane, KV head) and reused by
// every row of the head group.
//
// Traps carried over from paged.py:
//   * NEG_INF is finite (-1e9): on an all-masked prefix exp(s - m) == 1,
//     so probabilities come from where(mask, exp(s - m), 0), never the
//     bare exp; a merge weight exp(m_w - M) of a warp that saw nothing is
//     exp(-1e9) == 0 unless every warp saw nothing (then l == 0).
//   * An idle lane ends with l == 0 and writes an exact 0, not NaN.
//   * The NULL block may hold NaN and is never read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNullBlock = 0;
constexpr float kNegInf = -1e9f;
constexpr int kMaxWarps = 8;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// Per-warp shared memory in floats: accumulator, running max / sum,
// scores, and the K (rows padded to D + 1 against bank conflicts) and V
// tiles.
__host__ __device__ inline size_t warp_floats(int R, int D, int bs) {
  return (size_t)R * D + 2 * (size_t)R + (size_t)bs +
         (size_t)bs * (D + 1) + (size_t)bs * D;
}

__host__ __device__ inline size_t smem_bytes(int nw, int R, int C, int D,
                                             int bs) {
  return ((size_t)R * D + (size_t)nw * warp_floats(R, D, bs)) *
             sizeof(float) +
         (size_t)C * sizeof(int);
}

// Most warps (<= kMaxWarps) whose shared memory fits; 0 if none does.
inline int pick_warps(int R, int C, int D, int bs) {
  for (int nw = kMaxWarps; nw >= 1; nw /= 2)
    if (smem_bytes(nw, R, C, D, bs) <= kMaxSmem) return nw;
  return 0;
}

// A warp's K and V tiles in flight: up to kRegVec 16-byte vectors of each
// per lane (a 4 KB tile: bs 16 x D 64 in f32); a larger tile's remainder
// is loaded when the tile is stored.
constexpr int kRegVec = 8;

struct TileRegs {
  uint4 k[kRegVec];
  uint4 v[kRegVec];
};

// Start the 16-byte loads of the tile at pool offset `off`.
template <typename T>
__device__ __forceinline__ void fetch_tile(TileRegs& regs,
                                           const T* __restrict__ k_pool,
                                           const T* __restrict__ v_pool,
                                           int64_t off, int n, int lane) {
  const uint4* k4 = reinterpret_cast<const uint4*>(k_pool + off);
  const uint4* v4 = reinterpret_cast<const uint4*>(v_pool + off);
#pragma unroll
  for (int u = 0; u < kRegVec; ++u) {
    const int i = lane + 32 * u;
    if (i < n) {
      regs.k[u] = __ldg(k4 + i);
      regs.v[u] = __ldg(v4 + i);
    }
  }
}

template <typename T, int kD>
__device__ __forceinline__ void put_vec(const uint4& raw, float* dst, int i,
                                        int stride) {
  constexpr int kVec = 16 / sizeof(T);
  const T* v = reinterpret_cast<const T*>(&raw);
  const int e = i * kVec;
  float* row = dst + (e / kD) * stride + (e % kD);
#pragma unroll
  for (int k = 0; k < kVec; ++k) row[k] = to_f32(v[k]);
}

// Land the fetched tile in f32 shared memory (K rows padded to D + 1).
template <typename T, int kD>
__device__ __forceinline__ void store_tile(const TileRegs& regs,
                                           const T* __restrict__ k_pool,
                                           const T* __restrict__ v_pool,
                                           int64_t off, int n, float* k_w,
                                           float* v_w, int lane) {
#pragma unroll
  for (int u = 0; u < kRegVec; ++u) {
    const int i = lane + 32 * u;
    if (i < n) {
      put_vec<T, kD>(regs.k[u], k_w, i, kD + 1);
      put_vec<T, kD>(regs.v[u], v_w, i, kD);
    }
  }
  const uint4* k4 = reinterpret_cast<const uint4*>(k_pool + off);
  const uint4* v4 = reinterpret_cast<const uint4*>(v_pool + off);
  for (int i = lane + 32 * kRegVec; i < n; i += 32) {
    put_vec<T, kD>(__ldg(k4 + i), k_w, i, kD + 1);
    put_vec<T, kD>(__ldg(v4 + i), v_w, i, kD);
  }
}

template <typename T, int kD>
__global__ void paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ table,
    const int* __restrict__ positions, T* __restrict__ out, int H, int Hkv,
    int C, int bs, int M) {
  extern __shared__ float smem[];
  constexpr int kDk = kD + 1;
  const int nw = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x / Hkv;
  const int kh = blockIdx.x - b * Hkv;
  const int g = H / Hkv;
  const int R = g * C;  // rows: the group's query heads x columns
  const size_t wf = warp_floats(R, kD, bs);
  float* q_s = smem;
  float* base = q_s + R * kD;  // the warps' states, wf floats each
  int* pos_s = reinterpret_cast<int*>(base + nw * wf);
  float* acc_w = base + warp * wf;
  float* m_w = acc_w + R * kD;
  float* l_w = m_w + R;
  float* p_w = l_w + R;  // one row's scores, then probabilities
  float* k_w = p_w + bs;
  float* v_w = k_w + bs * kDk;

  // rows r = gi * C + c of query head kh * g + gi are contiguous in q/out
  const int64_t qoff = ((int64_t)b * H + (int64_t)kh * g) * C * kD;
  for (int i = threadIdx.x; i < R * kD; i += blockDim.x)
    q_s[i] = to_f32(q[qoff + i]);
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    pos_s[c] = positions[(int64_t)b * C + c];
  for (int i = lane; i < R * kD; i += 32) acc_w[i] = 0.f;
  for (int r = lane; r < R; r += 32) {
    m_w[r] = kNegInf;
    l_w[r] = 0.f;
  }
  __syncthreads();
  int mp = pos_s[0];
  for (int c = 1; c < C; ++c) mp = max(mp, pos_s[c]);
  const int n_live = min(mp / bs + 1, M);  // per-lane early stop
  const float scale = sqrtf((float)kD);
  const int* trow = table + (int64_t)b * M;
  const int n_vec = bs * kD * (int)sizeof(T) / 16;  // 16-byte vectors a tile
  // key layout of the score pass: `parts` lanes share a key and split D
  // when bs divides 32; otherwise each lane walks keys lane, lane + 32, ...
  const int parts = (bs <= 32 && 32 % bs == 0) ? 32 / bs : 1;
  const int kstep = parts > 1 ? bs : 32;
  const int dpart = kD / parts;
  const int t_lane = parts > 1 ? lane % bs : lane;
  const int d0 = parts > 1 ? (lane / bs) * dpart : 0;

  // this warp's next live block at or after j (NULL blocks are never read:
  // they contribute nothing)
  auto next_live = [&](int j) {
    while (j < n_live && trow[j] == kNullBlock) j += nw;
    return j;
  };
  auto tile_off = [&](int j) {
    return ((int64_t)trow[j] * Hkv + kh) * bs * kD;
  };
  TileRegs regs;
  int j = next_live(warp);
  if (j < n_live) fetch_tile(regs, k_pool, v_pool, tile_off(j), n_vec, lane);

  while (j < n_live) {
    store_tile<T, kD>(regs, k_pool, v_pool, tile_off(j), n_vec, k_w, v_w,
                      lane);
    __syncwarp();
    // the next tile's loads fly while this one is computed
    const int jn = next_live(j + nw);
    if (jn < n_live)
      fetch_tile(regs, k_pool, v_pool, tile_off(jn), n_vec, lane);
    const int k0 = j * bs;  // logical position of the tile's first key
    for (int r = 0; r < R; ++r) {
      const int qp = pos_s[r % C];
      if (k0 > qp) continue;  // every key of this tile is masked for r
      const float* qr = q_s + r * kD + d0;
      // scores, masked with the finite NEG_INF exactly like the reference
      float mx = kNegInf;
      for (int t0 = 0; t0 < bs; t0 += kstep) {
        const int t = t0 + t_lane;
        float s = 0.f;
        if (t < bs) {
          const float* kt = k_w + t * kDk + d0;
          for (int dd = 0; dd < dpart; ++dd) s = fmaf(qr[dd], kt[dd], s);
        }
        for (int off = bs; off < 32 && parts > 1; off <<= 1)
          s += __shfl_xor_sync(kFull, s, off);
        s = (t < bs && k0 + t <= qp) ? s / scale : kNegInf;
        if (t < bs && lane < kstep) p_w[t] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      const float m_old = m_w[r];
      const float m_new = fmaxf(m_old, mx);
      const float corr = expf(m_old - m_new);
      __syncwarp();
      float sum = 0.f;
      for (int t = lane; t < bs; t += 32) {
        const float p = (k0 + t <= qp) ? expf(p_w[t] - m_new) : 0.f;
        p_w[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      __syncwarp();
      // rescale the f32 accumulator and add this tile's PV partial
      float* ar = acc_w + r * kD;
      for (int d = lane; d < kD; d += 32) {
        float pv = 0.f;
        for (int t = 0; t < bs; ++t) pv = fmaf(p_w[t], v_w[t * kD + d], pv);
        ar[d] = ar[d] * corr + pv;
      }
      if (lane == 0) {
        l_w[r] = l_w[r] * corr + sum;
        m_w[r] = m_new;
      }
      __syncwarp();  // the next row overwrites the scores
    }
    j = jn;
  }
  __syncthreads();
  // merge the warps' partial states; an idle lane (l == 0) writes 0
  for (int e = threadIdx.x; e < R * kD; e += blockDim.x) {
    const int r = e / kD;
    float m = kNegInf;
    for (int w = 0; w < nw; ++w) m = fmaxf(m, base[w * wf + R * kD + r]);
    float l = 0.f, a = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float* pw = base + w * wf;
      const float f = expf(pw[R * kD + r] - m);
      l += pw[R * kD + R + r] * f;
      a += pw[e] * f;
    }
    store_out(out + qoff + e, a / (l > 0.f ? l : 1.f));
  }
}

template <typename T, int kD>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* table, const int* positions, void* out, int B, int H,
           int Hkv, int C, int bs, int M, cudaStream_t stream) {
  const int R = (H / Hkv) * C;
  const int nw = pick_warps(R, C, kD, bs);
  if (nw == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(nw, R, C, kD, bs);
  auto kernel = paged_attention_kernel<T, kD>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<B * Hkv, nw * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), table, positions, static_cast<T*>(out),
      H, Hkv, C, bs, M);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k_pool, const void* v_pool,
             const int* table, const int* positions, void* out, int B,
             int H, int Hkv, int C, int bs, int M, cudaStream_t stream) {
  if (D == 32)
    return launch<T, 32>(q, k_pool, v_pool, table, positions, out, B, H,
                         Hkv, C, bs, M, stream);
  return launch<T, 64>(q, k_pool, v_pool, table, positions, out, B, H, Hkv,
                       C, bs, M, stream);
}

}  // namespace

extern "C" {

// Shared-memory bytes one block takes at these shapes (with the most
// warps that fit); 0 when even one warp's state exceeds 227 KB.
size_t paged_attention_smem_bytes(int H, int Hkv, int C, int D, int bs) {
  const int R = (H / Hkv) * C;
  const int nw = pick_warps(R, C, D, bs);
  return nw ? smem_bytes(nw, R, C, D, bs) : 0;
}

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success); the wrapper raises on anything else.
int paged_attention_fwd(const void* q, const void* k_pool, const void* v_pool,
                        const void* table, const void* positions, void* out,
                        int B, int H, int Hkv, int C, int D, int bs, int M,
                        int dtype, void* stream) {
  if (B < 1 || Hkv < 1 || H % Hkv != 0 || C < 1 || bs < 1 || M < 1 ||
      (D != 32 && D != 64))
    return (int)cudaErrorInvalidValue;
  const int* tbl = static_cast<const int*>(table);
  const int* pos = static_cast<const int*>(positions);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, q, k_pool, v_pool, tbl, pos, out, B, H, Hkv,
                           C, bs, M, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k_pool, v_pool, tbl, pos, out, B,
                                   H, Hkv, C, bs, M, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
