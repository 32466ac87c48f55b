// Ragged paged attention for Hopper (sm_90a): the serving hot-loop kernel.
//
// Replaces the Pallas kernels `_paged_kernel` (ragged_paged_attention) and
// `_paged_kernel_v2` (ragged_paged_attention_v2) of
// paddle_tpu/ops/pallas/paged.py, both their dense f32/bf16 branches and
// their int8 (`quantized=True`) branches. One kernel, templated on the q
// type and the pool element type, serves all four, and f32 q over bf16 pools
// (an f32 model serving bf16 KV): it computes the function of
// paged_attention_reference in the v2 style, streaming the lane's live
// blocks through an online softmax whose running max, sum and accumulator
// are f32.
//
// Contract (the same as the Pallas launchers):
//   q          (B, H, C, D)        f32 or bf16, D = 32 or 64
//   k/v_pool   (N, H_kv, bs, D)    q's type, bf16 under f32 q, or int8
//                                  codes; H % H_kv == 0
//   k/v_scale  (N, H_kv, bs)  f32  per-row scales, int8 pools only
//   table      (B, M)  int32       NULL_BLOCK (0) padded
//   positions  (B, C)  int32       logical position of each query column
//   out        (B, H, C, D)        the pool's type for dense pools, q's
//                                  for int8 pools (JAX's out_dtype)
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
// int8 pools. A 16-byte vector holds 16 codes of one key row (D is a
// multiple of 16), so each vector's row scale is loaded beside it, one tile
// ahead like the codes: the block's bs K and V scales at (blk, kh, :). The
// tile is dequantized where it lands in f32 shared memory, code * scale in
// f32, exactly the reference's product; nothing after the store changes.
// The tiles in shared memory stay f32, so the shared memory a block takes
// does not depend on the pool type. The NULL block's codes and scales are
// never read (a chaos NaN-poison of a block lands in its scales).
//
// What bounds it: the bytes of the live K/V blocks read from device
// memory. Each live tile is read once per (lane, KV head) and reused by
// every row of the head group. Per live key row and KV head that is 2 * D
// * 4 bytes for f32 pools, 2 * D * 2 for bf16 and 2 * (D + 4) for int8
// codes and scales: 0.53x of bf16 at D = 64.
//
// Numerics. Against the plain version, an f32 output differs only in
// summation order. For a bf16 output the plain version rounds the
// dequantized V (int8) and the probabilities to bf16 before PV (as the JAX
// reference does), while the kernel keeps both in f32 and rounds only its
// output.
//
// Traps carried over from paged.py:
//   * NEG_INF is finite (-1e9): on an all-masked prefix exp(s - m) == 1,
//     so probabilities come from where(mask, exp(s - m), 0), never the
//     bare exp; a merge weight exp(m_w - M) of a warp that saw nothing is
//     exp(-1e9) == 0 unless every warp saw nothing (then l == 0).
//   * An idle lane ends with l == 0 and writes an exact 0, not NaN.
//   * The NULL block may hold NaN (codes or scales) and is never read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kNullBlock = 0;
constexpr float kNegInf = -1e9f;
constexpr int kMaxWarps = 8;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// dtype codes of the C entry point
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kInt8 = 2;

template <typename TP>
constexpr bool kQuant = std::is_same<TP, int8_t>::value;

// the output type: the pool's for dense pools, q's for int8 codes
template <typename TQ, typename TP>
using OutT = typename std::conditional<kQuant<TP>, TQ, TP>::type;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
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
// per lane (a 4 KB tile: bs 16 x D 64 in f32), and for int8 pools the row
// scale of each vector; a larger tile's remainder is loaded when the tile
// is stored.
constexpr int kRegVec = 8;

struct TileRegs {
  uint4 k[kRegVec];
  uint4 v[kRegVec];
  float ks[kRegVec];  // int8 pools only
  float vs[kRegVec];
};

// One layer's pools: values (or int8 codes) and, for int8, the row scales.
template <typename TP>
struct Pools {
  const TP* k;
  const TP* v;
  const float* k_scale;
  const float* v_scale;
};

// Load 16-byte vector i of the tile whose first key row is pool row `row0`
// (block * H_kv + KV head, times bs) and, for int8 pools, its row's scales.
template <typename TP, int kD>
__device__ __forceinline__ void load_vec(const Pools<TP>& p, int64_t row0,
                                         int i, uint4& k, uint4& v,
                                         float& ks, float& vs) {
  constexpr int kVec = 16 / sizeof(TP);
  static_assert(kD % kVec == 0, "a 16-byte vector lies in one key row");
  const int64_t off = row0 * kD;
  k = __ldg(reinterpret_cast<const uint4*>(p.k + off) + i);
  v = __ldg(reinterpret_cast<const uint4*>(p.v + off) + i);
  if constexpr (kQuant<TP>) {
    const int64_t r = row0 + i * kVec / kD;
    ks = __ldg(p.k_scale + r);
    vs = __ldg(p.v_scale + r);
  }
}

// Start the loads of the tile whose first key row is pool row `row0`.
template <typename TP, int kD>
__device__ __forceinline__ void fetch_tile(TileRegs& regs, const Pools<TP>& p,
                                           int64_t row0, int n, int lane) {
#pragma unroll
  for (int u = 0; u < kRegVec; ++u) {
    const int i = lane + 32 * u;
    if (i < n)
      load_vec<TP, kD>(p, row0, i, regs.k[u], regs.v[u], regs.ks[u],
                       regs.vs[u]);
  }
}

// Land vector i in f32 shared memory; int8 codes are dequantized on the
// way, code * row scale in f32 (the reference's product).
template <typename TP, int kD>
__device__ __forceinline__ void put_vec(const uint4& raw, float scale,
                                        float* dst, int i, int stride) {
  constexpr int kVec = 16 / sizeof(TP);
  const TP* v = reinterpret_cast<const TP*>(&raw);
  const int e = i * kVec;
  float* row = dst + (e / kD) * stride + (e % kD);
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    if constexpr (kQuant<TP>)
      row[k] = to_f32(v[k]) * scale;
    else
      row[k] = to_f32(v[k]);
  }
}

// Land the fetched tile in f32 shared memory (K rows padded to D + 1).
template <typename TP, int kD>
__device__ __forceinline__ void store_tile(const TileRegs& regs,
                                           const Pools<TP>& p, int64_t row0,
                                           int n, float* k_w, float* v_w,
                                           int lane) {
#pragma unroll
  for (int u = 0; u < kRegVec; ++u) {
    const int i = lane + 32 * u;
    if (i < n) {
      put_vec<TP, kD>(regs.k[u], regs.ks[u], k_w, i, kD + 1);
      put_vec<TP, kD>(regs.v[u], regs.vs[u], v_w, i, kD);
    }
  }
  for (int i = lane + 32 * kRegVec; i < n; i += 32) {
    uint4 k, v;
    float ks = 1.f, vs = 1.f;
    load_vec<TP, kD>(p, row0, i, k, v, ks, vs);
    put_vec<TP, kD>(k, ks, k_w, i, kD + 1);
    put_vec<TP, kD>(v, vs, v_w, i, kD);
  }
}

// TQ: q (float or bf16); TP: pool elements (TQ, bf16 under float q, or
// int8_t codes); the output is OutT<TQ, TP>.
template <typename TQ, typename TP, int kD>
__global__ void paged_attention_kernel(
    const TQ* __restrict__ q, const Pools<TP> pools,
    const int* __restrict__ table, const int* __restrict__ positions,
    OutT<TQ, TP>* __restrict__ out, int H, int Hkv, int C, int bs, int M) {
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
  const int n_vec = bs * kD * (int)sizeof(TP) / 16;  // 16-byte vectors
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
  auto tile_row = [&](int j) {  // the pool row of the tile's first key
    return ((int64_t)trow[j] * Hkv + kh) * bs;
  };
  TileRegs regs = {};
  int j = next_live(warp);
  if (j < n_live) fetch_tile<TP, kD>(regs, pools, tile_row(j), n_vec, lane);

  while (j < n_live) {
    store_tile<TP, kD>(regs, pools, tile_row(j), n_vec, k_w, v_w, lane);
    __syncwarp();
    // the next tile's loads fly while this one is computed
    const int jn = next_live(j + nw);
    if (jn < n_live)
      fetch_tile<TP, kD>(regs, pools, tile_row(jn), n_vec, lane);
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

template <typename TQ, typename TP, int kD>
int launch(const void* q, const Pools<TP>& pools, const int* table,
           const int* positions, void* out, int B, int H, int Hkv, int C,
           int bs, int M, cudaStream_t stream) {
  const int R = (H / Hkv) * C;
  const int nw = pick_warps(R, C, kD, bs);
  if (nw == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(nw, R, C, kD, bs);
  auto kernel = paged_attention_kernel<TQ, TP, kD>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<B * Hkv, nw * 32, smem, stream>>>(
      static_cast<const TQ*>(q), pools, table, positions,
      static_cast<OutT<TQ, TP>*>(out), H, Hkv, C, bs, M);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TP>
int launch_d(int D, const void* q, const void* k_pool, const void* v_pool,
             const void* k_scale, const void* v_scale, const int* table,
             const int* positions, void* out, int B, int H, int Hkv, int C,
             int bs, int M, cudaStream_t stream) {
  const Pools<TP> pools{static_cast<const TP*>(k_pool),
                        static_cast<const TP*>(v_pool),
                        static_cast<const float*>(k_scale),
                        static_cast<const float*>(v_scale)};
  if (D == 32)
    return launch<TQ, TP, 32>(q, pools, table, positions, out, B, H, Hkv, C,
                              bs, M, stream);
  return launch<TQ, TP, 64>(q, pools, table, positions, out, B, H, Hkv, C,
                            bs, M, stream);
}

}  // namespace

extern "C" {

// Shared-memory bytes one block takes at these shapes (with the most
// warps that fit); 0 when even one warp's state exceeds 227 KB. Tiles land
// in f32 shared memory whatever the pool type, so the pool type does not
// enter.
size_t paged_attention_smem_bytes(int H, int Hkv, int C, int D, int bs) {
  const int R = (H / Hkv) * C;
  const int nw = pick_warps(R, C, D, bs);
  return nw ? smem_bytes(nw, R, C, D, bs) : 0;
}

// q_dtype: 0 = float32, 1 = bfloat16; pool_dtype: the same codes, or
// 2 = int8 codes with f32 k/v_scale (null for dense pools). Dense pools
// take q in their own type, and bf16 pools also f32 q (the output is then
// bf16); int8 pools take f32 or bf16 q. Returns
// cudaGetLastError() after the launch (0 on success); the wrapper raises
// on anything else.
int paged_attention_fwd(const void* q, const void* k_pool, const void* v_pool,
                        const void* k_scale, const void* v_scale,
                        const void* table, const void* positions, void* out,
                        int B, int H, int Hkv, int C, int D, int bs, int M,
                        int q_dtype, int pool_dtype, void* stream) {
  if (B < 1 || Hkv < 1 || H % Hkv != 0 || C < 1 || bs < 1 || M < 1 ||
      (D != 32 && D != 64))
    return (int)cudaErrorInvalidValue;
  const bool scaled = k_scale != nullptr && v_scale != nullptr;
  if ((pool_dtype == kInt8) != scaled ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const int* tbl = static_cast<const int*>(table);
  const int* pos = static_cast<const int*>(positions);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pool_dtype == kF32 && q_dtype == kF32)
    return launch_d<float, float>(D, q, k_pool, v_pool, k_scale, v_scale,
                                  tbl, pos, out, B, H, Hkv, C, bs, M, s);
  if (pool_dtype == kBF16 && q_dtype == kBF16)
    return launch_d<__nv_bfloat16, __nv_bfloat16>(
        D, q, k_pool, v_pool, k_scale, v_scale, tbl, pos, out, B, H, Hkv, C,
        bs, M, s);
  if (pool_dtype == kBF16 && q_dtype == kF32)
    return launch_d<float, __nv_bfloat16>(D, q, k_pool, v_pool, k_scale,
                                          v_scale, tbl, pos, out, B, H, Hkv,
                                          C, bs, M, s);
  if (pool_dtype == kInt8 && q_dtype == kF32)
    return launch_d<float, int8_t>(D, q, k_pool, v_pool, k_scale, v_scale,
                                   tbl, pos, out, B, H, Hkv, C, bs, M, s);
  if (pool_dtype == kInt8 && q_dtype == kBF16)
    return launch_d<__nv_bfloat16, int8_t>(D, q, k_pool, v_pool, k_scale,
                                           v_scale, tbl, pos, out, B, H, Hkv,
                                           C, bs, M, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
