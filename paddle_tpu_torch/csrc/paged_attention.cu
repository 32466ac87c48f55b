// Ragged paged attention for Hopper (sm_90a): the serving hot-loop kernel.
//
// Replaces the Pallas kernels of paddle_tpu/ops/pallas/paged.py:
// `_paged_kernel` (:134, launcher ragged_paged_attention :306) with its
// int8 branch (:151-219, launch :282), and `_paged_kernel_v2` (:333,
// launcher ragged_paged_attention_v2 :505) with its int8 dequant
// (:435-437). One kernel, templated on the q type, the pool element type
// and the head dim, serves all four, and f32 q over bf16 pools (an f32
// model serving bf16 KV): it computes the function of
// paged_attention_reference in the v2 style, streaming the lane's live
// blocks through an online softmax whose running max, sum and accumulator
// are f32 (NULL blocks inside the live range are skipped, as v2 does).
//
// Contract (the same as the Pallas launchers):
//   q          (B, H, C, D)        f32 or bf16, D = 32, 64 or 128
//   k/v_pool   (N, H_kv, bs, D)    q's type, bf16 under f32 q, or int8
//                                  codes; H % H_kv == 0; any bs >= 1
//   k/v_scale  (N, H_kv, bs)  f32  per-row scales, int8 pools only
//   table      (B, M)  int32       NULL_BLOCK (0) padded
//   positions  (B, C)  int32       logical position of each query column
//   out        (B, H, C, D)        the pool's type for dense pools, q's
//                                  for int8 pools (JAX's out_dtype)
//   scratch    f32, counters int32 split-K partials and tickets (below)
//
// What bounds it: the bytes of the live K/V blocks, read once. Decode and
// the fused step do ~2 flops a byte (the rows of a KV head share each
// tile), far below the ~295 a byte where the tensor cores would bind. The
// design's job is to keep enough of those bytes in flight on all 132 SMs
// and to take the per-row work and the serial chains out of the loop:
//
// * Rows. A (lane, KV head) has R = (H/H_kv) * C query rows (the group's
//   heads times the columns, contiguous in q and out, so the GQA repeat is
//   never made). Each warp owns one 16-row m-tile of them; a block holds
//   up to 8 m-tiles and a longer row set takes more blocks along grid z.
//   Decode (R 1, or 3 under GQA) pads its tile with masked rows: the
//   kernel is bytes-bound, so the padded products cost nothing that
//   matters. wgmma would be the wrong size: its 64-row tile is 3/4 padding
//   at R 16 and 15/16 at decode.
// * Key groups. A block has kw warps per m-tile (about 4 warps in all):
//   each ring stage holds kw tiles, and key group k folds tile k of every
//   stage into its own online-softmax state. After the walk the groups'
//   states merge in shared memory. One warp per block walking every tile
//   alone was a serial chain of dependent products and reductions.
// * bf16 q: products on the tensor cores, mma.sync m16n8k16 bf16 -> f32.
//   S = Q K^T per 16-key tile (K fragments by ldmatrix), the mask by each
//   row's position, the online softmax on the accumulator fragments (quad
//   shuffles), then O += P V (V fragments by ldmatrix.trans). P is split
//   into bf16 hi + lo parts and goes through two products, so P V is exact
//   to ~2^-17 of P and the only bf16 rounding is the output's.
// * int8 pools. Codes in [-127, 127] are exact in bf16 and the scale is
//   per key row, so it factors out of both products: s_t = k_scale_t *
//   (q . code_t) is applied to S's columns after Q K^T, and v_scale_t is
//   folded into P before P V. The ring holds the codes as int8 (a quarter
//   of an f32 tile). Each stage's codes become exact bf16 once, by all the
//   block's threads (integer tricks, no conversion instructions), in one
//   bf16 tile per key group that the m-tiles share (three under GQA), and
//   the products read it by ldmatrix like a bf16 pool.
// * f32 q (over f32, bf16 or int8 pools) stays exact on the CUDA cores:
//   rounding q to bf16 would break the 1e-5 agreement the f32 serving
//   path and its checks hold. It shares the grid, the ring, the fragment
//   layout and the softmax; only its products are scalar FMAs.
// * Loads: the block reads its split's table slice once (beside the
//   positions and q, so their latencies overlap), compacts the live
//   (non-NULL) entries in shared memory, and gathers each live block's
//   16-key K and V tiles (with their f32 scales for int8) by 16-byte
//   cp.async into a 3-stage ring, two stages in flight while one is
//   computed. No copy is ever issued for a NULL block.
// * Split-K over the lane's blocks, so decode fills the SMs: the grid is
//   (lane * KV head, split, row group). Each split walks a contiguous
//   range of the table, stopping at max(q_pos) / bs. The split count is a
//   function of the shapes only (paged_attention_plan), never of positions
//   or table contents. Splits write partial (m, l, acc) to f32 scratch; a
//   split with nothing live writes m = NEG_INF, l = 0 only. The last split
//   of a (lane, KV head, row group) to finish (an atomic ticket after a
//   __threadfence) merges them in the same launch with exp(m_s - M)
//   weights, all its threads at once, and resets its ticket to 0. One
//   split writes the output directly.
//
// Traps carried over from paged.py:
//   * NEG_INF is finite (-1e9): on an all-masked prefix exp(s - m) == 1,
//     so probabilities come from where(mask, exp(s - m), 0), never the
//     bare exp, and the merge skips any split whose l is 0.
//   * A NaN key (a NaN k row, or a NaN k_scale in an int8 pool) makes
//     the l of every partial that sees it NaN. The merges gate on
//     l != 0, never l > 0, so such a partial is merged and the NaN
//     reaches the row's output, as in the plain version: serving's
//     non-finite guard depends on it. Only a partial with no visible
//     key (l exactly 0) is left out.
//   * An idle lane ends with l == 0 and writes an exact 0, not NaN.
//   * The NULL block may hold NaN (codes or scales) and is never read;
//     tile rows past bs are masked, and their shared memory holds zeros or
//     an earlier live tile's finite values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kNullBlock = 0;
constexpr float kNegInf = -1e9f;
constexpr int kTileKeys = 16;       // keys of one tile (one k-step)
constexpr int kStages = 3;          // ring stages, each a tile per key group
constexpr int kMaxMTiles = 8;       // 16-row m-tiles of one block
constexpr int kBlockWarps = 4;      // warps a block aims at (key groups)
constexpr int kMaxWarps = 8;
constexpr int kMaxSplits = 8;
constexpr int kWarpsPerSM = 16;     // the split count aims at this many
constexpr size_t kMaxSmem = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// dtype codes of the C entry points
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kInt8 = 2;

template <typename TP>
constexpr bool kQuant = std::is_same<TP, int8_t>::value;
template <typename TQ>
constexpr bool kTensorCores = std::is_same<TQ, __nv_bfloat16>::value;

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

// ---------------------------------------------------------------------------
// host and device: the launch plan
// ---------------------------------------------------------------------------

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// bytes of one tile row in shared memory: D elements and 16 bytes of pad,
// which puts consecutive rows 4 banks apart (conflict-free fragments)
__host__ __device__ inline int row_bytes(int D, int elem) {
  return D * elem + 16;
}
__host__ __device__ inline int stage_bytes(int D, int elem, bool quant) {
  return 2 * kTileKeys * row_bytes(D, elem) +
         (quant ? 2 * kTileKeys * (int)sizeof(float) : 0);
}

struct Plan {
  int mt;       // m-tiles of a block
  int kw;       // key groups of a block: warps = mt * kw
  int groups;   // row groups along grid z
  int splits;   // splits of the table along grid y
  int per;      // table entries a split walks
  size_t smem;  // dynamic shared memory of a block
};

// bytes of the shared ring (kStages stages of kw tiles), or of the key
// groups' partial states that reuse it after the loop, whichever is more
__host__ __device__ inline size_t ring_bytes(int mt, int kw, int D, int elem,
                                              bool quant) {
  const size_t ring = (size_t)kStages * kw * stage_bytes(D, elem, quant);
  const size_t states = kw > 1 ? (size_t)kw * mt * 16 * (D + 2) * 4 : 0;
  return ring > states ? ring : states;
}

inline size_t smem_bytes(const Plan& p, int C, int D, bool f32_q,
                         int elem, bool quant) {
  size_t smem = ring_bytes(p.mt, p.kw, D, elem, quant);
  if (quant && !f32_q)  // the stage's codes as bf16, for ldmatrix
    smem += (size_t)p.kw * 2 * kTileKeys * row_bytes(D, 2);
  if (f32_q)  // q rows in f32 and each warp's probability tile
    smem += (size_t)p.mt * 16 * D * 4 + (size_t)p.mt * p.kw * 16 * 16 * 4;
  smem += (size_t)kMaxSplits * p.mt * 16 * 4;  // merge weights
  smem += (size_t)p.mt * 16 * 4;                // merge sums
  // positions, the table slice, the live list
  smem += (size_t)C * 4 + 3 * (size_t)p.per * 4;
  return smem;
}

// A block holds mt 16-row m-tiles (one warp each) times kw key groups
// that take turns at the ring's tiles, at least kBlockWarps warps in all
// (at most kMaxWarps: kw is 1 from 4 m-tiles on).
// The split count is a function of the shapes alone: enough blocks for
// kWarpsPerSM warps on every SM, at most kMaxSplits, and no split shorter
// than the table blocks whose K/V bytes outweigh its partial twice (the
// partial is R x D f32, written and read back once).
inline Plan make_plan(int B, int H, int Hkv, int C, int D, int bs, int M,
                      bool f32_q, int pool_elem, bool quant, int sms) {
  Plan p;
  const int R = (H / Hkv) * C;
  const int tiles = cdiv(R, 16);
  p.mt = tiles < kMaxMTiles ? tiles : kMaxMTiles;
  p.kw = cdiv(kBlockWarps, p.mt);  // 3 m-tiles (GQA C 16): 2 groups
  p.groups = cdiv(tiles, kMaxMTiles);
  const int blocks = B * Hkv * p.groups;
  const long long kv_block =
      2LL * bs * D * pool_elem + (quant ? 2LL * bs * 4 : 0);
  const long long partial =
      (long long)(R < p.mt * 16 ? R : p.mt * 16) * D * 4;
  long long min_blocks = (2 * partial + kv_block - 1) / kv_block;
  if (min_blocks < 2) min_blocks = 2;
  int cap = (int)(M / min_blocks);
  if (cap > kMaxSplits) cap = kMaxSplits;
  if (cap < 1) cap = 1;
  for (;;) {
    const int want = cdiv(kWarpsPerSM * sms, blocks * p.mt * p.kw);
    p.splits = want < 1 ? 1 : (want > cap ? cap : want);
    p.per = cdiv(M, p.splits);
    p.smem = smem_bytes(p, C, D, f32_q, pool_elem, quant);
    if (p.smem <= kMaxSmem || p.kw == 1) break;
    p.kw /= 2;
  }
  return p;
}

// ---------------------------------------------------------------------------
// device helpers: copies, fragments, products
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as a bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
// the residual of x after its bf16 rounding
__device__ __forceinline__ float bf16_rest(float x) {
  return x - __bfloat162float(__float2bfloat16_rn(x));
}
// One layer's pools: values (or int8 codes) and, for int8, the row scales.
template <typename TP>
struct Pools {
  const TP* k;
  const TP* v;
  const float* k_scale;
  const float* v_scale;
};

template <typename TQ, typename TP>
struct Args {
  const TQ* q;
  Pools<TP> pools;
  const int* table;
  const int* positions;
  OutT<TQ, TP>* out;
  float* part_acc;   // (B * H_kv, splits, R, D) unnormalized accumulators
  float* part_ml;    // (B * H_kv, splits, R, 2) running max and sum
  int* counters;     // (B * H_kv * groups) tickets, 0 between launches
  int H, Hkv, C, bs, M, splits, per, kw;
};

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// four int8 codes (one 32-bit word) as two exact bf16 pairs: c + 128 is
// the code's byte xor 0x80; the float with that as its low mantissa byte
// over 2^23 is 2^23 + c + 128, and minus (2^23 + 128) it is c, exactly.
// An integer below 2^8 has zero low 16 bits in f32, so its bf16 is the
// float's high half.
__device__ __forceinline__ uint2 codes4_bf16(uint32_t w) {
  const uint32_t x = w ^ 0x80808080u;
  const float bias = 8388736.f;  // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540)) - bias;
  const float f1 = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7541)) - bias;
  const float f2 = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7542)) - bias;
  const float f3 = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7543)) - bias;
  return make_uint2(
      __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632),
      __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632));
}

// TQ: q (float or bf16); TP: pool elements (TQ, bf16 under float q, or
// int8_t codes); the output is OutT<TQ, TP>. Block: mt m-tiles x kw key
// groups, one warp each (warp = key group * mt + m-tile); grid (B * H_kv,
// splits, row groups).
template <typename TQ, typename TP, int kD>
__global__ void __launch_bounds__(kMaxWarps * 32)
    paged_attention_kernel(const Args<TQ, TP> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sh_live;
  __shared__ int sh_last;
  constexpr int kElem = sizeof(TP);
  constexpr int kRow = kD * kElem + 16;
  constexpr int kTile = 2 * kTileKeys * kRow +
                        (kQuant<TP> ? 2 * kTileKeys * (int)sizeof(float) : 0);
  constexpr int kChunks = kD * kElem / 16;  // 16-byte copies a key row
  constexpr int kN = kD / 8;                // 8-wide output column tiles
  constexpr bool kTC = kTensorCores<TQ>;
  constexpr bool kStaged = kTC && kQuant<TP>;  // codes -> bf16 tile
  constexpr int kRowB = kD + 8;             // bf16 tile row, in elements

  const int Hkv = a.Hkv, C = a.C, bs = a.bs, M = a.M, kw = a.kw;
  const int pair = blockIdx.x;
  const int b = pair / Hkv;
  const int kh = pair - b * Hkv;
  const int split = blockIdx.y;
  const int group = blockIdx.z;
  const int nthreads = blockDim.x;
  const int mt = nthreads / (32 * kw);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int mi = warp % mt;  // this warp's m-tile
  const int kg = warp / mt;  // and key group
  const int g = a.H / Hkv;
  const int R = g * C;
  const int row0 = group * kMaxMTiles * 16;  // this block's first row
  const int rows = min(R - row0, mt * 16);
  const int stage_bytes_all = kw * kTile;

  // shared memory: ring (after the loop: the key groups' states),
  // [bf16 codes tile], [q rows f32, probabilities], merge weights and
  // sums, positions, table slice, live list (table index, block id)
  unsigned char* ring = smem;
  const size_t ring_size =
      ring_bytes(mt, kw, kD, kElem, kQuant<TP>);
  unsigned char* rest = smem + ring_size;
  __nv_bfloat16* codes_s = reinterpret_cast<__nv_bfloat16*>(rest);
  if constexpr (kStaged) rest += kw * 2 * kTileKeys * kRowB * 2;
  float* q_s = reinterpret_cast<float*>(rest);
  float* p_s = q_s;
  if constexpr (!kTC) {
    p_s = q_s + mt * 16 * kD;
    rest = reinterpret_cast<unsigned char*>(p_s + mt * kw * 16 * 16);
  }
  float* w_s = reinterpret_cast<float*>(rest);
  float* lsum_s = w_s + kMaxSplits * mt * 16;
  int* pos_s = reinterpret_cast<int*>(lsum_s + mt * 16);
  int* live_j = pos_s + C;
  int* live_b = live_j + a.per;
  int* raw_s = live_b + a.per;  // the split's table slice as read

  // positions, the split's table slice and q are independent: load them
  // all before the first barrier, so their latencies overlap
  const int j0 = split * a.per;
  const int jn = max(0, min(j0 + a.per, M) - j0);
  for (int c = threadIdx.x; c < C; c += nthreads)
    pos_s[c] = a.positions[(int64_t)b * C + c];
  for (int i = threadIdx.x; i < jn; i += nthreads)
    raw_s[i] = a.table[(int64_t)b * M + j0 + i];

  // this thread's two rows of its warp's m-tile (fragment rows lane / 4
  // and lane / 4 + 8)
  const int fr = lane / 4;
  const int fc = (lane % 4) * 2;
  const int ra = row0 + mi * 16 + fr, rb = ra + 8;
  const bool va = ra < row0 + rows, vb = rb < row0 + rows;
  const int64_t qoff = ((int64_t)b * a.H + (int64_t)kh * g) * C * kD;

  uint32_t qa[kTC ? kD / 16 : 1][4];
  if constexpr (kTC) {
    // element by element: q need only be 2-byte aligned
    const unsigned short* q16 =
        reinterpret_cast<const unsigned short*>(a.q + qoff);
    auto pair16 = [&](int r, int d) {
      const unsigned short* p = q16 + (int64_t)r * kD + d;
      return (uint32_t)p[0] | ((uint32_t)p[1] << 16);
    };
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks) {
      const int d = ks * 16 + fc;
      qa[ks][0] = va ? pair16(ra, d) : 0u;
      qa[ks][1] = vb ? pair16(rb, d) : 0u;
      qa[ks][2] = va ? pair16(ra, d + 8) : 0u;
      qa[ks][3] = vb ? pair16(rb, d + 8) : 0u;
    }
  } else {
    for (int i = threadIdx.x; i < mt * 16 * kD; i += nthreads) {
      const int r = row0 + i / kD;
      q_s[i] = r < row0 + rows ? to_f32(a.q[qoff + (int64_t)r * kD + i % kD])
                               : 0.f;
    }
  }
  // tile rows past bs are read (masked) from stage memory: give them
  // finite values before the first copy lands
  if (bs % kTileKeys != 0)
    for (int i = threadIdx.x; i < kStages * stage_bytes_all / 16;
         i += nthreads)
      reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  int mp = pos_s[0];
  for (int c = 1; c < C; ++c) mp = max(mp, pos_s[c]);
  const int n_live = min(mp / bs + 1, M);  // per-lane early stop
  const int j1 = min(min(j0 + a.per, M), n_live);
  // the rows' positions (-1: a padded row, all masked)
  const int pa = va ? pos_s[ra % C] : -1;
  const int pb = vb ? pos_s[rb % C] : -1;

  // the live (non-NULL) entries of this split's table slice, in order
  if (warp == 0) {
    int count = 0;
    for (int base = j0; base < j1; base += 32) {
      const int j = base + lane;
      const int blk = j < j1 ? raw_s[j - j0] : kNullBlock;
      const unsigned live = __ballot_sync(kFull, blk != kNullBlock);
      if (blk != kNullBlock) {
        const int at = count + __popc(live & ((1u << lane) - 1u));
        live_j[at] = j;
        live_b[at] = blk;
      }
      count += __popc(live);
    }
    if (lane == 0) sh_live = count;
  }
  __syncthreads();
  const int nt_per_block = cdiv(bs, kTileKeys);
  const int n_tiles = sh_live * nt_per_block;
  const int n_steps = cdiv(n_tiles, kw);  // ring stages to walk

  // gather tile t (live entry t / nt, keys (t % nt) * 16 + [0, 16)) into
  // slot `slot` of stage s: K rows, V rows and, for int8, their scales
  auto load_tile = [&](int t, int s, int slot) {
    const int li = t / nt_per_block;
    const int sub = t - li * nt_per_block;
    const int nk = min(kTileKeys, bs - sub * kTileKeys);
    const int64_t row =
        ((int64_t)live_b[li] * Hkv + kh) * bs + sub * kTileKeys;
    const unsigned char* ks =
        reinterpret_cast<const unsigned char*>(a.pools.k + row * kD);
    const unsigned char* vs =
        reinterpret_cast<const unsigned char*>(a.pools.v + row * kD);
    unsigned char* st = ring + s * stage_bytes_all + slot * kTile;
    for (int c = threadIdx.x; c < nk * kChunks; c += nthreads) {
      const int r = c / kChunks;
      const int cc = c - r * kChunks;
      cp_async16(st + r * kRow + cc * 16, ks + (r * kChunks + cc) * 16);
      cp_async16(st + (kTileKeys + r) * kRow + cc * 16,
                 vs + (r * kChunks + cc) * 16);
    }
    if constexpr (kQuant<TP>) {
      float* sc = reinterpret_cast<float*>(st + 2 * kTileKeys * kRow);
      for (int c = threadIdx.x; c < nk; c += nthreads) {
        cp_async4(sc + c, a.pools.k_scale + row + c);
        cp_async4(sc + kTileKeys + c, a.pools.v_scale + row + c);
      }
    }
  };
  auto load_stage = [&](int step, int s) {
    for (int slot = 0; slot < kw; ++slot) {
      const int t = step * kw + slot;
      if (t < n_tiles) load_tile(t, s, slot);
    }
  };

  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this thread's columns; quad-summed last
  float acc[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float inv_scale = 1.f / sqrtf((float)kD);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) load_stage(s, s);
    cp_async_commit();
  }

  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    {
      const int nx = step + kStages - 1;  // into the stage step - 1 left
      if (nx < n_steps) load_stage(nx, nx % kStages);
      cp_async_commit();
    }
    const unsigned char* stage = ring + (step % kStages) * stage_bytes_all;
    if constexpr (kStaged) {
      // every code of the stage becomes bf16 once, for all the block's
      // warps (the m-tiles of a key group share each tile)
      constexpr int kWords = kD / 4;  // 32-bit words of codes a key row
      for (int i = threadIdx.x; i < kw * 2 * kTileKeys * kWords;
           i += nthreads) {
        const int r = i / kWords;  // slot * 32 + (K: 0-15, V: 16-31)
        const int wd = i - r * kWords;
        const int slot = r / (2 * kTileKeys);
        const int rr = r - slot * 2 * kTileKeys;
        const uint32_t w = *reinterpret_cast<const uint32_t*>(
            stage + slot * kTile + rr * kRow + wd * 4);
        *reinterpret_cast<uint2*>(codes_s + (size_t)r * kRowB + wd * 4) =
            codes4_bf16(w);
      }
      __syncthreads();
    }
    const int t = step * kw + kg;  // this key group's tile
    if (t >= n_tiles) continue;
    const int li = t / nt_per_block;
    const int sub = t - li * nt_per_block;
    const int k0 = live_j[li] * bs + sub * kTileKeys;
    const int nk = min(kTileKeys, bs - sub * kTileKeys);
    if (k0 > mp) continue;  // every key of the tile is masked for every row
    const unsigned char* st = stage + kg * kTile;
    const TP* k_t = reinterpret_cast<const TP*>(st);
    const TP* v_t = reinterpret_cast<const TP*>(st + kTileKeys * kRow);
    const float* ksc =
        reinterpret_cast<const float*>(st + 2 * kTileKeys * kRow);
    const float* vsc = ksc + kTileKeys;
    constexpr int kRowE = kRow / kElem;  // row stride in elements

    // S (16 rows x 16 keys) as two 16x8 fragments: s[n][e] is row
    // (e < 2 ? ra : rb), key n * 8 + fc + (e & 1)
    float s[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    // bf16 tiles for the products: the pool's, or the codes made bf16
    const __nv_bfloat16* kb16 =
        kStaged ? codes_s + (size_t)kg * 2 * kTileKeys * kRowB
                : reinterpret_cast<const __nv_bfloat16*>(k_t);
    const __nv_bfloat16* vb16 =
        kStaged ? kb16 + kTileKeys * kRowB
                : reinterpret_cast<const __nv_bfloat16*>(v_t);
    if constexpr (kTC) {
#pragma unroll
      for (int ks = 0; ks < kD / 16; ++ks) {
        uint32_t kb[4];
        // matrices: keys 0-7 / 8-15 x d ks*16 + 0-7 / 8-15
        const int key = (lane / 16) * 8 + lane % 8;
        const int d = ks * 16 + ((lane / 8) % 2) * 8;
        ldmatrix_x4(kb, kb16 + key * kRowB + d);
        mma_bf16(s[0], qa[ks], kb[0], kb[1]);
        mma_bf16(s[1], qa[ks], kb[2], kb[3]);
      }
    } else {
      const float* qra = q_s + (mi * 16 + fr) * kD;
      const float* qrb = qra + 8 * kD;
      const TP* kr[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kr[c] = k_t + ((c / 2) * 8 + fc + (c & 1)) * kRowE;
      for (int d = 0; d < kD; ++d) {
        const float x = qra[d], y = qrb[d];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float kv = to_f32(kr[c][d]);
          s[c / 2][c & 1] = fmaf(x, kv, s[c / 2][c & 1]);
          s[c / 2][2 + (c & 1)] = fmaf(y, kv, s[c / 2][2 + (c & 1)]);
        }
      }
    }

    // scale, mask and fold into the online softmax, row by row
    bool vis[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = n * 8 + fc + (e & 1);
        float v = s[n][e];
        if constexpr (kQuant<TP>) v *= ksc[kk];
        vis[n][e] = kk < nk && k0 + kk <= (e < 2 ? pa : pb);
        s[n][e] = vis[n][e] ? v * inv_scale : kNegInf;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]),
                       fmaxf(s[1][2 * h], s[1][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m_run[h], mx);
      const float corr = expf(m_run[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          const float p = vis[n][e] ? expf(s[n][e] - m_new) : 0.f;
          s[n][e] = p;
          sum += p;
        }
      l_run[h] = l_run[h] * corr + sum;
      m_run[h] = m_new;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        acc[n][2 * h] *= corr;
        acc[n][2 * h + 1] *= corr;
      }
    }
    // int8: the value scale rides on P (after l took the bare P)
    if constexpr (kQuant<TP>) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= vsc[n * 8 + fc + (e & 1)];
    }

    // O += P V
    if constexpr (kTC) {
      // P as the A operand: hi and lo bf16 parts
      const uint32_t ph[4] = {pack_bf16(s[0][0], s[0][1]),
                              pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]),
                              pack_bf16(s[1][2], s[1][3])};
      const uint32_t pl[4] = {
          pack_bf16(bf16_rest(s[0][0]), bf16_rest(s[0][1])),
          pack_bf16(bf16_rest(s[0][2]), bf16_rest(s[0][3])),
          pack_bf16(bf16_rest(s[1][0]), bf16_rest(s[1][1])),
          pack_bf16(bf16_rest(s[1][2]), bf16_rest(s[1][3]))};
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        uint32_t vb[4];
        // matrices: keys 0-7 / 8-15 x d dp*16 + 0-7, then + 8-15
        const int key = ((lane / 8) % 2) * 8 + lane % 8;
        const int d = dp * 16 + (lane / 16) * 8;
        ldmatrix_x4_trans(vb, vb16 + key * kRowB + d);
        mma_bf16(acc[2 * dp], ph, vb[0], vb[1]);
        mma_bf16(acc[2 * dp], pl, vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], ph, vb[2], vb[3]);
        mma_bf16(acc[2 * dp + 1], pl, vb[2], vb[3]);
      }
    } else {
      float* pw = p_s + warp * 256;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pw[(fr + (e < 2 ? 0 : 8)) * 16 + n * 8 + fc + (e & 1)] = s[n][e];
      __syncwarp();
      const float* pra = pw + fr * 16;
      const float* prb = pra + 8 * 16;
      for (int kk = 0; kk < kTileKeys; ++kk) {
        const float xa = pra[kk], xb = prb[kk];
        const TP* vr = v_t + kk * kRowE + fc;
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          const float v0 = to_f32(vr[n * 8]), v1 = to_f32(vr[n * 8 + 1]);
          acc[n][0] = fmaf(xa, v0, acc[n][0]);
          acc[n][1] = fmaf(xa, v1, acc[n][1]);
          acc[n][2] = fmaf(xb, v0, acc[n][2]);
          acc[n][3] = fmaf(xb, v1, acc[n][3]);
        }
      }
      __syncwarp();
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(kFull, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(kFull, l_run[h], 2);
  }

  // the key groups' states merge into key group 0 through shared memory
  // (the ring is free now): weights exp(m_g - M) over the groups that
  // saw a visible key of the row (l_g != 0: a NaN l is merged)
  if (kw > 1) {
    __syncthreads();
    float* st_acc = reinterpret_cast<float*>(ring);  // [kw][mt][16][kD]
    float* st_ml = st_acc + kw * mt * 16 * kD;       // [kw][mt][16][2]
    const int base = (kg * mt + mi) * 16;
    if (kg > 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = base + fr + 8 * h;
        if (lane % 4 == 0) {
          st_ml[r * 2] = m_run[h];
          st_ml[r * 2 + 1] = l_run[h];
        }
#pragma unroll
        for (int n = 0; n < kN; ++n)
          *reinterpret_cast<float2*>(st_acc + r * kD + n * 8 + fc) =
              make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
      }
    }
    __syncthreads();
    if (kg == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float m = l_run[h] != 0.f ? m_run[h] : kNegInf;
        for (int o = 1; o < kw; ++o) {
          const int r = (o * mt + mi) * 16 + fr + 8 * h;
          if (st_ml[r * 2 + 1] != 0.f) m = fmaxf(m, st_ml[r * 2]);
        }
        const float w0 = l_run[h] != 0.f ? expf(m_run[h] - m) : 0.f;
        float l = l_run[h] * w0;
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          acc[n][2 * h] *= w0;
          acc[n][2 * h + 1] *= w0;
        }
        for (int o = 1; o < kw; ++o) {
          const int r = (o * mt + mi) * 16 + fr + 8 * h;
          const float lo = st_ml[r * 2 + 1];
          if (lo == 0.f) continue;
          const float w = expf(st_ml[r * 2] - m);
          l += lo * w;
#pragma unroll
          for (int n = 0; n < kN; ++n) {
            const float2 x =
                *reinterpret_cast<const float2*>(st_acc + r * kD + n * 8 + fc);
            acc[n][2 * h] = fmaf(w, x.x, acc[n][2 * h]);
            acc[n][2 * h + 1] = fmaf(w, x.y, acc[n][2 * h + 1]);
          }
        }
        m_run[h] = m;
        l_run[h] = l;
      }
    }
  }
  const int64_t obase = qoff;  // rows of this (lane, KV head) in out

  if (a.splits == 1) {  // the whole table: normalize and write
    if (kg != 0) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = h ? rb : ra;
      if ((h ? pb : pa) < 0) continue;
      const float inv = 1.f / (l_run[h] > 0.f ? l_run[h] : 1.f);
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        OutT<TQ, TP>* o = a.out + obase + (int64_t)r * kD + n * 8 + fc;
        store_out(o, acc[n][2 * h] * inv);
        store_out(o + 1, acc[n][2 * h + 1] * inv);
      }
    }
    return;
  }

  // a split's partial state; an idle split writes m and l only
  const int64_t pbase = ((int64_t)pair * a.splits + split) * R;
  if (kg == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = h ? rb : ra;
      if ((h ? pb : pa) < 0) continue;
      if (lane % 4 == 0)
        *reinterpret_cast<float2*>(a.part_ml + (pbase + r) * 2) =
            make_float2(m_run[h], l_run[h]);
      if (n_tiles > 0) {
#pragma unroll
        for (int n = 0; n < kN; ++n)
          *reinterpret_cast<float2*>(a.part_acc + (pbase + r) * kD +
                                     n * 8 + fc) =
              make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
      }
    }
  }
  __threadfence();
  __syncthreads();
  int* ticket = a.counters + (int64_t)pair * gridDim.z + group;
  if (threadIdx.x == 0)
    sh_last = atomicAdd(ticket, 1) == a.splits - 1;
  __syncthreads();
  if (!sh_last) return;
  __threadfence();

  // the last split merges, with every thread of the block: per row the
  // weights exp(m_s - M) of the splits that saw a visible key (l_s != 0,
  // so a NaN l_s is merged and makes the row NaN through l)
  // and 1 / sum, then the weighted accumulators (each split's loads of
  // a row or an element issued together)
  const int64_t pair0 = (int64_t)pair * a.splits * R;
  for (int r = threadIdx.x; r < rows; r += nthreads) {
    const int row = row0 + r;
    float2 ml[kMaxSplits];
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      ml[sp] = sp < a.splits
                   ? __ldcg(reinterpret_cast<const float2*>(
                         a.part_ml + (pair0 + (int64_t)sp * R + row) * 2))
                   : make_float2(kNegInf, 0.f);
    float m = kNegInf;
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      if (ml[sp].y != 0.f) m = fmaxf(m, ml[sp].x);
    float l = 0.f;
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) {
      const float w = ml[sp].y != 0.f ? expf(ml[sp].x - m) : 0.f;
      w_s[sp * mt * 16 + r] = w;
      l += ml[sp].y * w;
    }
    lsum_s[r] = 1.f / (l != 0.f ? l : 1.f);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < rows * kD / 4; e += nthreads) {
    const int r = e / (kD / 4);
    const int d = (e - r * (kD / 4)) * 4;
    const int row = row0 + r;
    // a split with no visible key (or a weight that underflows) is not
    // read: its accumulator may never have been written
    float4 x[kMaxSplits];
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      x[sp] = sp < a.splits && w_s[sp * mt * 16 + r] != 0.f
                  ? __ldcg(reinterpret_cast<const float4*>(
                        a.part_acc + (pair0 + (int64_t)sp * R + row) * kD +
                        d))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) {
      const float w = w_s[sp * mt * 16 + r];
      o.x = fmaf(w, x[sp].x, o.x);
      o.y = fmaf(w, x[sp].y, o.y);
      o.z = fmaf(w, x[sp].z, o.z);
      o.w = fmaf(w, x[sp].w, o.w);
    }
    const float inv = lsum_s[r];
    OutT<TQ, TP>* out = a.out + obase + (int64_t)row * kD + d;
    store_out(out, o.x * inv);
    store_out(out + 1, o.y * inv);
    store_out(out + 2, o.z * inv);
    store_out(out + 3, o.w * inv);
  }
  if (threadIdx.x == 0) *ticket = 0;  // ready for the next launch
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;
  return n;
}

int elem_size(int dtype) { return dtype == kF32 ? 4 : dtype == kBF16 ? 2 : 1; }

bool valid_pair(int q_dtype, int pool_dtype) {
  return (q_dtype == kF32 && pool_dtype == kF32) ||
         (q_dtype == kBF16 && pool_dtype == kBF16) ||
         (q_dtype == kF32 && pool_dtype == kBF16) ||
         (q_dtype == kF32 && pool_dtype == kInt8) ||
         (q_dtype == kBF16 && pool_dtype == kInt8);
}

bool valid_shape(int B, int H, int Hkv, int C, int D, int bs, int M) {
  return B >= 1 && Hkv >= 1 && H >= Hkv && H % Hkv == 0 && C >= 1 &&
         bs >= 1 && M >= 1 && (D == 32 || D == 64 || D == 128);
}

template <typename TQ, typename TP, int kD>
int launch(const Args<TQ, TP>& args, const Plan& plan, int B, int Hkv,
           cudaStream_t stream) {
  auto kernel = paged_attention_kernel<TQ, TP, kD>;
  if (plan.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(B * Hkv, plan.splits, plan.groups);
  kernel<<<grid, plan.mt * plan.kw * 32, plan.smem, stream>>>(args);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TP>
int launch_d(int D, const void* q, const void* k_pool, const void* v_pool,
             const void* k_scale, const void* v_scale, const int* table,
             const int* positions, void* out, float* scratch, int* counters,
             int B, int H, int Hkv, int C, int bs, int M, const Plan& plan,
             cudaStream_t stream) {
  Args<TQ, TP> args;
  args.q = static_cast<const TQ*>(q);
  args.pools = Pools<TP>{static_cast<const TP*>(k_pool),
                         static_cast<const TP*>(v_pool),
                         static_cast<const float*>(k_scale),
                         static_cast<const float*>(v_scale)};
  args.table = table;
  args.positions = positions;
  args.out = static_cast<OutT<TQ, TP>*>(out);
  const int64_t R = (int64_t)(H / Hkv) * C;
  args.part_acc = scratch;
  args.part_ml =
      scratch ? scratch + (int64_t)B * Hkv * plan.splits * R * D : nullptr;
  args.counters = counters;
  args.H = H;
  args.Hkv = Hkv;
  args.C = C;
  args.bs = bs;
  args.M = M;
  args.splits = plan.splits;
  args.per = plan.per;
  args.kw = plan.kw;
  if (D == 32) return launch<TQ, TP, 32>(args, plan, B, Hkv, stream);
  if (D == 64) return launch<TQ, TP, 64>(args, plan, B, Hkv, stream);
  return launch<TQ, TP, 128>(args, plan, B, Hkv, stream);
}

}  // namespace

extern "C" {

// The launch plan at these shapes on the current device: plan[0] the
// split count, plan[1] the f32 scratch floats (0 for one split), plan[2]
// the int32 tickets (0 for one split; they must be 0 before the first
// launch and are left at 0), plan[3] the dynamic shared memory of a
// block. Returns 0, or cudaErrorInvalidValue for shapes or dtypes the
// kernel does not take (shared memory over 227 KB included).
int paged_attention_plan(int B, int H, int Hkv, int C, int D, int bs, int M,
                         int q_dtype, int pool_dtype, long long* plan) {
  if (!valid_shape(B, H, Hkv, C, D, bs, M) || !valid_pair(q_dtype, pool_dtype))
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(B, H, Hkv, C, D, bs, M, q_dtype == kF32,
                           elem_size(pool_dtype), pool_dtype == kInt8,
                           sm_count());
  if (p.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const long long R = (long long)(H / Hkv) * C;
  const bool split = p.splits > 1;
  plan[0] = p.splits;
  plan[1] = split ? (long long)B * Hkv * p.splits * R * (D + 2) : 0;
  plan[2] = split ? (long long)B * Hkv * p.groups : 0;
  plan[3] = (long long)p.smem;
  return 0;
}

// q_dtype: 0 = float32, 1 = bfloat16; pool_dtype: the same codes, or
// 2 = int8 codes with f32 k/v_scale (null for dense pools). Dense pools
// take q in their own type, and bf16 pools also f32 q (the output is then
// bf16); int8 pools take f32 or bf16 q. scratch and counters are sized by
// paged_attention_plan (null when it gives one split). Returns
// cudaGetLastError() after the launch (0 on success); the wrapper raises
// on anything else.
int paged_attention_fwd(const void* q, const void* k_pool, const void* v_pool,
                        const void* k_scale, const void* v_scale,
                        const void* table, const void* positions, void* out,
                        void* scratch, void* counters, int B, int H, int Hkv,
                        int C, int D, int bs, int M, int q_dtype,
                        int pool_dtype, void* stream) {
  if (!valid_shape(B, H, Hkv, C, D, bs, M) || !valid_pair(q_dtype, pool_dtype))
    return (int)cudaErrorInvalidValue;
  const bool scaled = k_scale != nullptr && v_scale != nullptr;
  if ((pool_dtype == kInt8) != scaled ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const Plan plan = make_plan(B, H, Hkv, C, D, bs, M, q_dtype == kF32,
                              elem_size(pool_dtype), pool_dtype == kInt8,
                              sm_count());
  if (plan.smem > kMaxSmem ||
      (plan.splits > 1 && (scratch == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int* tbl = static_cast<const int*>(table);
  const int* pos = static_cast<const int*>(positions);
  float* scr = static_cast<float*>(scratch);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pool_dtype == kF32)
    return launch_d<float, float>(D, q, k_pool, v_pool, k_scale, v_scale,
                                  tbl, pos, out, scr, cnt, B, H, Hkv, C, bs,
                                  M, plan, s);
  if (pool_dtype == kBF16 && q_dtype == kBF16)
    return launch_d<__nv_bfloat16, __nv_bfloat16>(
        D, q, k_pool, v_pool, k_scale, v_scale, tbl, pos, out, scr, cnt, B,
        H, Hkv, C, bs, M, plan, s);
  if (pool_dtype == kBF16)
    return launch_d<float, __nv_bfloat16>(D, q, k_pool, v_pool, k_scale,
                                          v_scale, tbl, pos, out, scr, cnt,
                                          B, H, Hkv, C, bs, M, plan, s);
  if (q_dtype == kF32)
    return launch_d<float, int8_t>(D, q, k_pool, v_pool, k_scale, v_scale,
                                   tbl, pos, out, scr, cnt, B, H, Hkv, C, bs,
                                   M, plan, s);
  return launch_d<__nv_bfloat16, int8_t>(D, q, k_pool, v_pool, k_scale,
                                         v_scale, tbl, pos, out, scr, cnt, B,
                                         H, Hkv, C, bs, M, plan, s);
}

}  // extern "C"
