// Streaming flash-attention forward for Hopper (sm_90a): two kernels behind
// one entry point, chosen by dtype.
//
// Replaces the Pallas forward kernels of paddle_tpu/ops/pallas/flash.py:
// `_fwd_kernel` (flash.py:168, launcher `_flash_fwd` :294: K/V resident in
// VMEM) and `_fwd_kernel_kgrid` (flash.py:318, launcher `_flash_fwd_kgrid`
// :423: K/V streamed by the TPU grid for long contexts). Both compute one
// function, flash_attention_reference of ops/cuda/flash.py; each kernel here
// streams K/V through shared memory in an inner loop, so it covers both: any
// key length fits, with nothing carried between thread blocks.
//
// Contract:
//   q          (B, H, Tq, D)    f32 or bf16, strides with a unit stride
//                               along D (the prefill and the training step
//                               pass transposed views of their (B, T, H,
//                               D) projections), a 16-byte-aligned base
//                               and batch, head and time strides that are
//                               multiples of 16 bytes (the rule of TMA and
//                               cp.async; the wrapper copies otherwise)
//   k, v       (B, H, Tk, D)    q's type, the same stride rules
//   bias       f32 or null      element (b, h, i, j) at the four strides
//                               given (0 along a broadcast dimension):
//                               key-only, per-query, per-head or full
//   segq/segk  (B, Tq)/(B, Tk)  int32 contiguous, or both null
//   out        (B, H, Tq, D)    q's type, contiguous
//   lse        (B, H, Tq)       f32, contiguous
//   scale      f32; causal 0/1, aligned bottom-right: key j is visible to
//              query i iff j <= i + (Tk - Tq)
//
// bf16: the tensor-core kernel (flash_fwd_tc_kernel). What bounds it: at
// the prefill shape (B 8, H 12, T 512, D 64, causal) the bytes, q/k/v read
// once and out/lse written once (25.4 MB: 7.6 us at 3.35 TB/s) against 3.2
// GFLOP (3.3 us at 989 TFLOP/s); at T 16384 the operations (4.1e11 FLOP at
// H 12: 0.42 ms), and beside them the exponentials: one per (query, key)
// pair on the special function unit (16 a clock per SM), as long again at
// D 64. Design: a block of 384 threads owns 128 query rows of one
// (b * H + h): warpgroup 0 is the producer (one thread issues every copy;
// setmaxnreg gives its registers to the consumers, 24 against 240),
// warpgroups 1 and 2 are consumers of 64 rows each. TMA copies the q tile
// once and the 128-key K/V tiles through a ring of three stages, 128-byte
// swizzled (64-byte at D 32; at D 128 a row takes two 64-wide boxes), from
// 4-D tensor maps over the strided (D, T, H, B) views; rows past Tq or Tk
// arrive as zeros. mbarriers say when a stage is full (the copy's bytes)
// and when it is free (all 256 consumer threads). Shared memory: q 16 KB +
// 3 x (K 16 KB + V 16 KB) at D 64, 224 KB of the 227 at D 128. Both
// products are wgmma.mma_async with f32 accumulators: S = Q K^T as
// m64n128k16 from swizzled shared memory (K stored [key][d] is K-major),
// O += P V as m64nDk16 with P in registers (the S accumulator converts in
// place to the bf16 A fragment: the same thread owns the same (row, key))
// and V read through the transpose bit. The softmax runs on the
// accumulator fragments: a row lives in a quad of 4 threads, so its max
// and sum are shuffles over lanes xor 1 and 2; m, l and the rescale of O
// stay f32 in registers. The scale is applied to S in f32 after the
// product, in the base-2 domain (scale * log2 e in one multiply, the bias
// times log2 e), and ex2 gives the probabilities; l is summed from them in
// f32 before P is rounded to bf16 for its product. The exponentials are
// hidden under products twice over: each consumer issues tile j's S = Q K^T
// and then tile j-1's P V, and computes tile j's softmax while P V runs;
// and the two consumers take turns at the tensor cores (named barriers),
// so that one's softmax runs under the other's products. A tile's copy
// overlaps the two tiles before it. Masks cost only where they can bite:
// a tile fully below the causal diagonal and inside Tk takes no mask
// arithmetic, and the bias and segment ids are template switches, so the
// main path carries no code for either. Causal pruning stops the ring
// after the block's last visible key tile (`_last_visible_kb`), and each
// consumer skips the tiles past its own; with segment ids a consumer skips
// a tile in which none of its (query, key) pairs shares an id by a vote
// over its 128 threads (`_seg_overlap`), before the tile's wgmma is
// issued. Blocks are launched heaviest (last rows) first over all heads.
//
// f32: the tensor-core kernel (flash_fwd_kernel), for the f32 paths (the
// training step, the f32 agreement checks). What bounds it: at the
// training shape (B 8, H 12, T 512, D 64, causal) the operations, 3.2 GFLOP
// over the visible pairs, where an f32-accurate product runs on the tensor
// cores as three TF32 passes (494.7 / 3 = 164.9 TFLOP/s): 0.0196 ms,
// against 0.015 ms for its bytes (q, k, v read once, out and lse written
// once: 50.5 MB at 3.35 TB/s); at T 16384 (H 12) 4.1e11 FLOP, 2.5 ms. The
// CUDA cores' f32 rate (67 TFLOP/s) would bound it at 2.5 times that.
// wgmma takes TF32 operands K-major only, and V in P V is not, so the
// products are mma.sync. Design: a block of 4 warps owns 64 query rows of
// one (b * H + h), each warp 16 of them, and walks the key tiles (64 keys,
// 32 at D 128). K and V arrive with their keys' segment ids by cp.async
// (16 bytes, 4 for the ids) through a two-stage ring, rows past Tk
// zero-filled by the copy, so that the next tile's copy runs under this
// tile's products. Both products are m16n8k8 TF32 -> f32 in three passes,
// big.big' + big.small' + small.big', split in registers by integer
// rounding (flash_common.cuh): S = Q K^T, with Q's big and small fragments
// split once and held in registers through the key loop at D 32 and 64 (at
// D 128 they would take 128 registers a thread, so they are read and split
// from shared memory at every tile), and O += P V with P split too (one
// TF32 pass would cost ~2^-11 of a term, 70 times the f32 tolerance). The
// softmax runs on the accumulator fragments: a row lives in a quad of 4
// threads, so its max is two shuffles (lanes xor 1 and 2); the scale and
// log2 e are one multiply and exp2 gives the probabilities; m and the
// thread's part of l stay f32 in registers. P's accumulator fragment is
// the A fragment of P V as it stands (the permuted k slots), so P never
// goes through shared memory; V is read along its time axis through the
// row swizzle, without bank conflicts (32-bit operands have no ldmatrix
// .trans). The tensor cores truncate as they accumulate: each tile's P V
// is summed in fresh fragments and folded in as O = O alpha + tile by one
// round-to-nearest fma, so that no truncating chain runs longer than a
// tile (T 16384 has 256 of them). Masks cost only where they can bite: a
// warp whose 16 x N slice is visible whole (inside Tk, under the diagonal,
// no bias, no segment ids) takes no per-element mask, and a warp skips the
// tiles past its rows' last visible key; the block stops after its last
// visible tile (`_last_visible_kb`), and with segment ids it skips a tile
// in which none of its (query, key) pairs shares an id by a vote over its
// threads (`_seg_overlap`). Blocks are launched heaviest (last rows) first
// over all heads. Shared memory: q 16 KB + 2 x (K 16 KB + V 16 KB) at
// D 64, 96 KB at D 128, 40 KB at D 32; registers (ptxas -v, sm_90a;
// chip_smoke.py prints them) 165 / 211 / 237 at D 32 / 64 / 128, no
// spills, so the training shape runs two blocks (8 warps) an SM. Blocks of
// 8 warps (128 rows) and a third ring stage measured no faster at the
// training shape (tools/flash_fwd_variants.py).
//
// Traps carried over from flash.py, kept by both kernels:
//   * NEG_INF is finite (-1e30): where no key of a row is visible yet,
//     m == NEG_INF and exp(s - m) would be 1, so probabilities come from
//     visible ? exp(s - m) : 0, never the bare exp (the bf16 kernel stores
//     a masked score as -inf, whose exp2 is exactly 0, while m starts at
//     NEG_INF).
//   * A row with no visible key ends with l == 0: out = acc / max(l, 1e-30)
//     = 0 exactly and lse = m + log(1e-30), as the pruned JAX loop gives.
//   * q rows >= Tq are computed on zeros and never written; keys >= Tk are
//     masked.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLFloor = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// the 16-byte rule of both kernels' copies (TMA, cp.async) for a (B, H, T,
// D) view of `elem`-byte values: a 16-byte-aligned base and batch, head
// and time strides (elements) that are positive multiples of 16 bytes
bool aligned16(const void* ptr, const int64_t* st, int elem) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  for (int i = 0; i < 3; ++i)
    if (st[i] <= 0 || st[i] * elem % 16 != 0) return false;
  return true;
}

// ---------------------------------------------------------------------------
// f32: the tensor-core kernel (mma.sync, three TF32 passes)
// ---------------------------------------------------------------------------

constexpr int kFwdWarps = 4;                 // 16 q rows a warp
constexpr int kFwdRows = 16 * kFwdWarps;     // q rows of a block
constexpr int kFwdThreads = 32 * kFwdWarps;
// keys of a K/V tile: 32 at D 128, where O and a tile's P V sum take 96
// registers a thread
template <int kD>
constexpr int kFwdN = kD == 128 ? 32 : 64;
constexpr int kFwdStages = 2;  // ring stages of K/V
// Q's TF32 fragments stay in registers through the key loop (64 a thread
// at D 64); at D 128 they are read from shared memory at every tile
template <int kD>
constexpr bool kQInRegs = kD <= 64;

// the q tile, the ring (stage s: K tile, then V tile), the q rows' segment
// ids, then each stage's key segment ids
template <int kD>
constexpr size_t kFwdSmem =
    (size_t)(kFwdRows + 2 * kFwdStages * kFwdN<kD>) * kD * sizeof(float) +
    (size_t)(kFwdRows + kFwdStages * kFwdN<kD>) * sizeof(int);

// one tile of the online softmax on a warp's score fragments (base 2):
// the rows' max m and this thread's part of their sums l are updated, the
// scores become probabilities, alpha[hh] = exp2(m_old - m_new) rescales
// row r0 + g + 8 hh. With kMasked, bit 4 j + e of vis says whether element
// (j, e) is visible: where(visible, exp2(x - m), 0), since m may still be
// the finite NEG_INF, where exp2 of a masked score would be 1
template <int kNT, bool kMasked>
__device__ __forceinline__ void online_softmax(float (&sc)[kNT][4],
                                               uint32_t vis, float (&m)[2],
                                               float (&l)[2],
                                               float (&alpha)[2]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx = m[hh];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      mx = fmaxf(mx, fmaxf(sc[j][2 * hh], sc[j][2 * hh + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    alpha[hh] = exp2f(m[hh] - mx);
    m[hh] = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
        float& x = sc[j][e];
        if constexpr (kMasked)
          x = (vis >> (4 * j + e)) & 1u ? exp2f(x - mx) : 0.f;
        else
          x = exp2f(x - mx);
        sum += x;
      }
    l[hh] = l[hh] * alpha[hh] + sum;
  }
}

template <int kD>
__global__ void __launch_bounds__(kFwdThreads)
    flash_fwd_kernel(const Params p) {
  constexpr int kN = kFwdN<kD>;
  constexpr int kNT = kN / 8;  // n fragments of a score tile
  constexpr int kS = kFwdStages;
  constexpr int kTile = kN * kD;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_sm = reinterpret_cast<float*>(smem);
  float* ring = q_sm + kFwdRows * kD;  // stage s: K at ring + 2 s kTile,
                                       // V after it
  int* sq_sm = reinterpret_cast<int*>(ring + 2 * kS * kTile);
  int* sk_ring = sq_sm + kFwdRows;  // stage s: the key ids at s kN

  const int bhs = p.B * p.H;
  const int nqb = (p.Tq + kFwdRows - 1) / kFwdRows;
  // the heaviest q tiles (the last rows, under causal) first
  const int qb = nqb - 1 - static_cast<int>(blockIdx.x) / bhs;
  const int bh = static_cast<int>(blockIdx.x) % bhs;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = qb * kFwdRows;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (threadIdx.x >> 5);
  const bool has_seg = p.segq != nullptr;
  const int shift = p.Tk - p.Tq;  // causal: key j visible iff j <= i + shift

  const float* qg = static_cast<const float*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const float* kg = static_cast<const float*>(p.k) + b * p.ks[0] + h * p.ks[1];
  const float* vg = static_cast<const float*>(p.v) + b * p.vs[0] + h * p.vs[1];
  const float* bg =
      p.bias != nullptr ? p.bias + b * p.bs[0] + h * p.bs[1] : nullptr;

  int nkb = (p.Tk + kN - 1) / kN;
  if (p.causal) {
    // the last key any row of this tile sees (_last_visible_kb)
    const int last = min(q0 + kFwdRows, p.Tq) - 1 + shift;
    nkb = last < 0 ? 0 : min(nkb, last / kN + 1);
  }
  // the last key any of this warp's rows sees (-1: none of them is < Tq)
  const int wq = q0 + r0;
  const int w_last = wq >= p.Tq ? -1
                     : p.causal ? min(p.Tk - 1, min(wq + 15, p.Tq - 1) + shift)
                                : p.Tk - 1;

  auto issue = [&](int i) {
    const int s = i % kS;
    const int k0 = i * kN;
    float* ks = ring + 2 * s * kTile;
    copy_tile<float, kD, kN, kFwdThreads>(ks, kg, p.ks[2], k0, p.Tk);
    copy_tile<float, kD, kN, kFwdThreads>(ks + kTile, vg, p.vs[2], k0, p.Tk);
    if (has_seg)
      copy_vec<kFwdThreads>(sk_ring + s * kN, p.segk + (int64_t)b * p.Tk, k0,
                            kN, p.Tk);
  };

  // the q tile (its own group), then the first kS - 1 K/V tiles
  copy_tile<float, kD, kFwdRows, kFwdThreads>(q_sm, qg, p.qs[2], q0, p.Tq);
  if (has_seg)
    copy_vec<kFwdThreads>(sq_sm, p.segq + (int64_t)b * p.Tq, q0, kFwdRows,
                          p.Tq);
  cp_async_commit();
  for (int i = 0; i < kS - 1; ++i) {
    if (i < nkb) issue(i);
    cp_async_commit();
  }
  cp_async_wait<kS - 1>();
  __syncthreads();  // q landed

  // Q's big and small fragments, k-step kk: slot t holds d = 8 kk + 2t,
  // slot t + 4 d = 8 kk + 2t + 1 (rows r0 + g, r0 + g + 8)
  uint32_t qbig[kQInRegs<kD> ? kD / 8 : 1][4];
  uint32_t qsml[kQInRegs<kD> ? kD / 8 : 1][4];
  if constexpr (kQInRegs<kD>) {
#pragma unroll
    for (int kk = 0; kk < kD / 8; ++kk) {
      const int c = 8 * kk + 2 * t;
      const float2 u = ld2(q_sm + at<float, kD>(r0 + g, c));
      const float2 w = ld2(q_sm + at<float, kD>(r0 + g + 8, c));
      split(u.x, qbig[kk][0], qsml[kk][0]);
      split(w.x, qbig[kk][1], qsml[kk][1]);
      split(u.y, qbig[kk][2], qsml[kk][2]);
      split(w.y, qbig[kk][3], qsml[kk][3]);
    }
  }

  const float c1 = p.scale * kLog2e;
  float o[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  // rows r0 + g and r0 + g + 8: the running max (base 2) and this
  // thread's part of the row sum
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  for (int i = 0; i < nkb; ++i) {
    __syncthreads();  // the stage issue(i + kS - 1) refills was read at i - 1
    if (i + kS - 1 < nkb) issue(i + kS - 1);
    cp_async_commit();
    cp_async_wait<kS - 1>();
    __syncthreads();  // tile i landed for every thread
    const int s = i % kS;
    const int k0 = i * kN;
    const float* ks = ring + 2 * s * kTile;
    const float* vs = ks + kTile;
    const int* sk = sk_ring + s * kN;
    if (has_seg &&
        !seg_overlap<kFwdThreads>(sq_sm, q0, kFwdRows, sk, k0, kN, p))
      continue;
    if (k0 > w_last) continue;  // nothing of the tile is visible here

    // S = Q K^T over the warp's 16 rows x kN keys
    float sc[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 8; ++kk) {
      const int c = 8 * kk + 2 * t;
      uint32_t ab[4], as[4];
      if constexpr (kQInRegs<kD>) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ab[e] = qbig[kk][e];
          as[e] = qsml[kk][e];
        }
      } else {
        const float2 u = ld2(q_sm + at<float, kD>(r0 + g, c));
        const float2 w = ld2(q_sm + at<float, kD>(r0 + g + 8, c));
        split(u.x, ab[0], as[0]);
        split(w.x, ab[1], as[1]);
        split(u.y, ab[2], as[2]);
        split(w.y, ab[3], as[3]);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float2 x = ld2(ks + at<float, kD>(8 * j + g, c));
        mma3(sc[j], ab, as, x.x, x.y);
      }
    }

    // scores in the base-2 domain, s * scale * log2 e (+ bias * log2 e);
    // element (j, e) is row r0 + g + 8 (e >> 1), key k0 + 8 j + 2t + (e & 1)
    float alpha[2];
    const int k_hi = k0 + kN - 1;
    if (bg == nullptr && !has_seg && k_hi < p.Tk &&
        (!p.causal || k_hi <= wq + shift)) {
      // every pair of the warp's slice is visible: no per-element mask
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] *= c1;
      online_softmax<kNT, false>(sc, 0u, m, l, alpha);
    } else {
      // bit 4 j + e: element (j, e) is visible
      uint32_t vis = 0u;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rl = r0 + g + ((e & 2) << 2);
          const int cl = 8 * j + 2 * t + (e & 1);
          const int tq = q0 + rl;
          const int tk = k0 + cl;
          bool ok = tq < p.Tq && tk < p.Tk;
          if (p.causal) ok = ok && tk <= tq + shift;
          if (has_seg) ok = ok && sq_sm[rl] == sk[cl];
          float x = sc[j][e] * c1;
          if (ok && bg != nullptr)
            x = fmaf(bg[tq * p.bs[2] + tk * p.bs[3]], kLog2e, x);
          sc[j][e] = ok ? x : kNegInf;
          vis |= static_cast<uint32_t>(ok) << (4 * j + e);
        }
      online_softmax<kNT, true>(sc, vis, m, l, alpha);
    }

    // O = O alpha + P V: the tile's sum in fresh fragments, kChunk d
    // fragments a pass, folded in with one round-to-nearest fma
    constexpr int kChunk = kD < 64 ? kD / 8 : 8;
#pragma unroll
    for (int n0 = 0; n0 < kD / 8; n0 += kChunk) {
      float part[kChunk][4];
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kNT; ++kk) {
        // accumulator (g, 2t), (g, 2t + 1), (g + 8, ..) as A slots t, t + 4
        uint32_t ab[4], as[4];
        split(sc[kk][0], ab[0], as[0]);
        split(sc[kk][2], ab[1], as[1]);
        split(sc[kk][1], ab[2], as[2]);
        split(sc[kk][3], ab[3], as[3]);
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const int col = 8 * (n0 + j) + g;
          mma3(part[j], ab, as, vs[at<float, kD>(8 * kk + 2 * t, col)],
               vs[at<float, kD>(8 * kk + 2 * t + 1, col)]);
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[n0 + j][e] = fmaf(o[n0 + j][e], alpha[e >> 1], part[j][e]);
    }
  }
  cp_async_wait<0>();

  float* og = static_cast<float*>(p.out) + (int64_t)bh * p.Tq * kD;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float li = l[hh];
    li += __shfl_xor_sync(kFull, li, 1);
    li += __shfl_xor_sync(kFull, li, 2);
    const int tq = wq + g + 8 * hh;
    if (tq >= p.Tq) continue;
    const float lf = fmaxf(li, kLFloor);
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      *reinterpret_cast<float2*>(og + (int64_t)tq * kD + 8 * j + 2 * t) =
          make_float2(o[j][2 * hh] / lf, o[j][2 * hh + 1] / lf);
    if (t == 0)
      p.lse[(int64_t)bh * p.Tq + tq] =
          (m[hh] == kNegInf ? kNegInf : m[hh] * kLn2) + logf(lf);
  }
}

template <int kD>
int launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = kFwdSmem<kD>;
  auto kernel = flash_fwd_kernel<kD>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t blocks =
      (int64_t)p.B * p.H * ((p.Tq + kFwdRows - 1) / kFwdRows);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kFwdThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int launch_d(int D, const Params& p, cudaStream_t stream) {
  if (!aligned16(p.q, p.qs, 4) || !aligned16(p.k, p.ks, 4) ||
      !aligned16(p.v, p.vs, 4))
    return (int)cudaErrorInvalidValue;
  if (D == 32) return launch<32>(p, stream);
  if (D == 64) return launch<64>(p, stream);
  return launch<128>(p, stream);
}


// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kTcRows = 128;     // query rows of a block: 2 consumers x 64
constexpr int kTcKeys = 128;     // keys of a K/V tile
constexpr int kStages = 3;       // depth of the K/V ring
constexpr int kTcThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kConsumers = 2 * 128;

// Shared memory of the tensor-core kernel at head dim kD, in bytes from a
// 1024-byte-aligned base: the q tile, kStages K tiles, kStages V tiles, then
// the mbarriers. A tile is kTcRows (= kTcKeys) rows of kD bf16, stored as
// kBoxes TMA boxes of kBox columns, each box's rows kRowBytes long and
// swizzled in atoms of 8 rows.
template <int kD>
struct TcLayout {
  static constexpr int kBox = kD < 64 ? kD : 64;
  static constexpr int kRowBytes = kBox * 2;       // 64 or 128: the swizzle
  static constexpr int kBoxes = kD / kBox;
  static constexpr int kBoxBytes = kTcRows * kRowBytes;
  static constexpr int kTileBytes = kBoxes * kBoxBytes;
  static constexpr uint32_t kAtom = 8 * kRowBytes;  // one swizzle atom
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 2 = 64-byte
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTileBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  // full[kStages], empty[kStages], q; plus the slack to align the base
  static constexpr int kSmem = kBar + 8 * (2 * kStages + 1) + 1024;
  static_assert(kSmem <= 232448, "over the 227 KB a block can use");
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// waits until the barrier's phase `parity` has completed. The spin loop
// lives inside the asm, so that the compiler sees no divergent branch
// around the wgmma code that follows
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one TMA box of a 4-D (D, T, H, B) map into shared memory at `dst`; its
// bytes count against the mbarrier `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int t, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(t),
      "r"(h), "r"(b)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (all >> 4), swizzle layout type in bits 62-63
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// S (+)= A B^T, m64n128k16: A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D += A B, m64n32k16: A (bf16 pairs) in registers, B MN-major in
// shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// D += A B, m64n64k16: A (bf16 pairs) in registers, B MN-major in
// shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// D += A B, m64n128k16: A (bf16 pairs) in registers, B MN-major in
// shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}


template <int kD>
__device__ __forceinline__ void wgmma_pv(float (&o)[kD / 2],
                                         const uint32_t* a, uint64_t db) {
  if constexpr (kD == 32) {
    wgmma_rs_n32(o, a, db);
  } else if constexpr (kD == 64) {
    wgmma_rs_n64(o, a, db);
  } else {
    wgmma_rs_n128(o, a, db);
  }
}

// O += P V over one 128-key tile: P in registers (pa[4 kk ..] for the
// keys of k-step kk), V the stage at shared address sv; one commit group
template <int kD>
__device__ __forceinline__ void issue_pv(float (&o)[kD / 2],
                                         uint32_t (&pa)[kTcKeys / 4],
                                         uint32_t sv) {
  using L = TcLayout<kD>;
  fence_regs(pa);
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kTcKeys / 16; ++kk)
    wgmma_pv<kD>(o, &pa[4 * kk],
                 smem_desc(sv + kk * 16 * L::kRowBytes, L::kBoxBytes,
                           L::kAtom, L::kLayout));
  wgmma_commit();
  fence_regs(o);
  fence_regs(pa);
}

// S = Q K^T over one 128-key tile: the warpgroup's 64 q rows at shared
// address qa, the K stage at sk; one commit group
template <int kD>
__device__ __forceinline__ void issue_qk(float (&sc)[kTcKeys / 2],
                                         uint32_t qa, uint32_t sk) {
  using L = TcLayout<kD>;
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint32_t off =
        (kk * 16 / L::kBox) * L::kBoxBytes + (kk * 16 % L::kBox) * 2;
    wgmma_ss_n128(sc, smem_desc(qa + off, 16, L::kAtom, L::kLayout),
                  smem_desc(sk + off, 16, L::kAtom, L::kLayout), kk > 0);
  }
  wgmma_commit();
  fence_regs(sc);
}

// *ptr if `ok`, else 0, from a predicated load that the compiler keeps
// where it is written (volatile asm, ordered with the wgmma asm): the bias
// and segment id reads stay inside the score loops, at a row's base
// pointer plus a constant, instead of living in registers across products
__device__ __forceinline__ float load_if(const float* ptr, bool ok) {
  float v;
  asm volatile(
      "{\n.reg .pred q;\n"
      "setp.ne.u32 q, %2, 0;\n"
      "mov.f32 %0, 0f00000000;\n"
      "@q ld.global.nc.f32 %0, [%1];\n}\n"
      : "=f"(v)
      : "l"(ptr), "r"(static_cast<uint32_t>(ok)));
  return v;
}
__device__ __forceinline__ int load_if(const int* ptr, bool ok) {
  int v;
  asm volatile(
      "{\n.reg .pred q;\n"
      "setp.ne.u32 q, %2, 0;\n"
      "mov.b32 %0, 0;\n"
      "@q ld.global.nc.b32 %0, [%1];\n}\n"
      : "=r"(v)
      : "l"(ptr), "r"(static_cast<uint32_t>(ok)));
  return v;
}

// 2^x on the special function unit (max relative error 2^-22; results
// below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// OR of `x` over the 128 threads of consumer warpgroup `c` (named barrier
// 1 + c; barrier 0 is __syncthreads)
__device__ __forceinline__ bool warpgroup_any(bool x, int c) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred pi, po;\n"
      "setp.ne.u32 pi, %1, 0;\n"
      "bar.red.or.pred po, %2, 128, pi;\n"
      "selp.u32 %0, 1, 0, po;\n}\n"
      : "=r"(r)
      : "r"(static_cast<uint32_t>(x)), "r"(1 + c)
      : "memory");
  return r != 0;
}

// named barriers over both consumer warpgroups (256 threads): one waits
// for its turn, the other signals it
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// key tiles of kTcKeys that rows [r0, r_end) need: all of Tk, or under
// causal up to the last row's last visible key (_last_visible_kb)
__device__ __forceinline__ int tc_key_tiles(const Params& p, int r_end) {
  const int all = (p.Tk + kTcKeys - 1) / kTcKeys;
  if (!p.causal) return all;
  const int last = min(r_end, p.Tq) - 1 + (p.Tk - p.Tq);
  return last < 0 ? 0 : min(all, last / kTcKeys + 1);
}

template <int kD, bool kBias, bool kSeg>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const Params p) {
  using L = TcLayout<kD>;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle atoms need a 1024-byte-aligned shared-space address
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base + L::kQ;
  const uint32_t bar = base + L::kBar;
  // mbarriers: full[s] at bar + 8 s, empty[s] at bar + 8 (kStages + s),
  // the q tile's at bar + 16 kStages
  const uint32_t q_bar = bar + 16 * kStages;

  const int bhs = p.B * p.H;
  const int nqb = (p.Tq + kTcRows - 1) / kTcRows;
  const int qb = nqb - 1 - static_cast<int>(blockIdx.x) / bhs;
  const int bh = static_cast<int>(blockIdx.x) % bhs;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = qb * kTcRows;
  const int nkb = tc_key_tiles(p, q0 + kTcRows);
  // the warpgroup, broadcast from lane 0 so that the compiler knows every
  // branch on it is uniform over a warp (or it serializes the wgmmas)
  const int wg = __shfl_sync(kFull, static_cast<int>(threadIdx.x) / 128, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar + 8 * s, 1);
      mbar_init(bar + 8 * (kStages + s), kConsumers);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_bar, L::kTileBytes);
      for (int i = 0; i < L::kBoxes; ++i)
        tma_load(sq + i * L::kBoxBytes, &tm_q, q_bar, i * L::kBox, q0, h, b);
      for (int kb = 0; kb < nkb; ++kb) {
        const int s = kb % kStages;
        const uint32_t full = bar + 8 * s;
        // the stage's previous tile (kb - kStages) has been consumed
        if (kb >= kStages)
          mbar_wait(bar + 8 * (kStages + s), ((kb / kStages) - 1) & 1);
        mbar_expect_tx(full, 2 * L::kTileBytes);
        const uint32_t sk = base + L::kK + s * L::kTileBytes;
        const uint32_t sv = base + L::kV + s * L::kTileBytes;
        for (int i = 0; i < L::kBoxes; ++i) {
          tma_load(sk + i * L::kBoxBytes, &tm_k, full, i * L::kBox,
                   kb * kTcKeys, h, b);
          tma_load(sv + i * L::kBoxBytes, &tm_v, full, i * L::kBox,
                   kb * kTcKeys, h, b);
        }
      }
    }
  } else {
    // consumers: warpgroup c owns rows r0 .. r0 + 63; this thread the rows
    // row_a and row_a + 8, and in every 8-column group the columns
    // col_t and col_t + 1 (the wgmma accumulator fragment)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;
    const int t = threadIdx.x - 128 * wg;
    const int lane = t % 32;
    const int r0 = q0 + 64 * c;
    const int row_a = r0 + 16 * (t / 32) + lane / 4;
    const int col_t = 2 * (lane % 4);
    const int nkb_wg = r0 < p.Tq ? tc_key_tiles(p, r0 + 64) : 0;
    const int shift = p.Tk - p.Tq;
    const float sl2 = p.scale * kLog2e;
    // the last key each of this thread's rows sees (Tk, and under causal
    // the diagonal), and the least of them over the warpgroup's rows
    int lim[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      lim[i] = p.causal ? min(p.Tk - 1, row_a + 8 * i + shift) : p.Tk - 1;
    const int lim_wg = p.causal ? min(p.Tk - 1, r0 + shift) : p.Tk - 1;
    // the bias rows (unit stride along keys) and segment ids of this
    // thread's rows, read at clamped rows (rows >= Tq are never written);
    // keys >= Tk are not read
    const float* brow[2] = {nullptr, nullptr};
    const int* sgk = nullptr;
    int sgq[2] = {0, 0};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int tqc = min(row_a + 8 * i, p.Tq - 1);
      if constexpr (kBias)
        brow[i] = p.bias + b * p.bs[0] + h * p.bs[1] + tqc * p.bs[2];
      if constexpr (kSeg)
        sgq[i] = p.segq[static_cast<int64_t>(b) * p.Tq + tqc];
    }
    if constexpr (kSeg) sgk = p.segk + static_cast<int64_t>(b) * p.Tk;

    float o[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};  // this thread's part of the row sums
    const uint32_t qa = sq + c * 64 * L::kRowBytes;
    // P of the last tile whose P V product is not issued yet, as bf16
    // pairs in the A fragment's order (k-step kk: pa[4 kk .. 4 kk + 3]),
    // and the V stage it multiplies
    uint32_t pa[kTcKeys / 4];
    bool pending = false;
    int sp = 0;

    // the consumers take turns at the tensor cores (named barriers 3 + c):
    // warpgroup c issues its products after the other has issued its own,
    // so that one's softmax runs under the other's products. Each waits
    // once and signals once a tile; warpgroup 1 opens with a signal and
    // leaves out its last, so that every wait is matched
    const int my_turn = 3 + c;
    const int their_turn = 4 - c;
    if (c == 1 && nkb > 0) named_arrive(their_turn);

    mbar_wait(q_bar, 0);
    for (int kb = 0; kb < nkb; ++kb) {
      const int s = kb % kStages;
      const int k0 = kb * kTcKeys;
      // this thread's key of column 8 j + e of the tile is k0 + col_t +
      // 8 j + e: in range up to kin, visible to row i up to rel[i]
      const int kin = p.Tk - 1 - k0 - col_t;
      const int rel[2] = {lim[0] - k0 - col_t, lim[1] - k0 - col_t};
      bool run = kb < nkb_wg;
      // with segment ids: bit 2 j + e of same[i] says that row i shares
      // the id of column 8 j + e (a key in range)
      uint32_t same[2] = {0u, 0u};
      if constexpr (kSeg) {
        if (run) {
          // skip the tile if none of this warpgroup's pairs shares an id
          bool any = false;
#pragma unroll
          for (int j = 0; j < kTcKeys / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool in = 8 * j + e <= kin;
              const int id = load_if(sgk + k0 + col_t + 8 * j + e, in);
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                const bool eq = in & (sgq[i] == id);
                same[i] |= static_cast<uint32_t>(eq) << (2 * j + e);
                any |= eq & (8 * j + e <= rel[i]) & (row_a + 8 * i < p.Tq);
              }
            }
          run = __shfl_sync(kFull, warpgroup_any(any, c), 0);
        }
      }
      mbar_wait(bar + 8 * s, (kb / kStages) & 1);
      const bool signal = c == 0 || kb + 1 < nkb;
      named_sync(my_turn);
      if (!run) {
        // nothing of this tile is visible to this warpgroup's rows; a
        // pending product goes first, so that its stage is freed
        if (pending) {
          issue_pv<kD>(o, pa, base + L::kV + sp * L::kTileBytes);
          if (signal) named_arrive(their_turn);
          wgmma_wait<0>();
          fence_regs(o);
          mbar_arrive(bar + 8 * (kStages + sp));
          pending = false;
        } else if (signal) {
          named_arrive(their_turn);
        }
        mbar_arrive(bar + 8 * (kStages + s));
        continue;
      }

      // S = Q K^T, then the previous tile's P V behind it: on the main
      // path the softmax below runs while the tensor cores do P V (with a
      // bias or segment ids both are waited for first, which keeps P's
      // registers free for the loads)
      float sc[kTcKeys / 2];
      issue_qk<kD>(sc, qa, base + L::kK + s * L::kTileBytes);
      if (pending) {
        issue_pv<kD>(o, pa, base + L::kV + sp * L::kTileBytes);
        if (signal) named_arrive(their_turn);
        if constexpr (kBias || kSeg) {
          wgmma_wait<0>();
        } else {
          wgmma_wait<1>();
        }
      } else {
        if (signal) named_arrive(their_turn);
        wgmma_wait<0>();
      }
      fence_regs(sc);

      // scores in the base-2 domain: s * scale * log2 e (+ bias * log2 e);
      // hidden keys -inf, masked only where the tile can hide one
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < kTcKeys / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * i + e];
            x *= sl2;
            if constexpr (kBias)
              x = fmaf(load_if(brow[i] + k0 + col_t + 8 * j + e,
                               8 * j + e <= kin),
                       kLog2e, x);
          }
      if (kSeg || k0 + kTcKeys - 1 > lim_wg) {
#pragma unroll
        for (int j = 0; j < kTcKeys / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              bool ok = 8 * j + e <= rel[i];
              if constexpr (kSeg) ok &= (same[i] >> (2 * j + e)) & 1u;
              float& x = sc[4 * j + 2 * i + e];
              x = ok ? x : -INFINITY;
            }
          }
      }

      // the online softmax: m and the row sums in f32, probabilities
      // ex2(x - m) in place (ex2(-inf) = 0 for hidden keys; m starts at
      // the finite NEG_INF, so a row with nothing visible yet stays 0)
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = m[i];
#pragma unroll
        for (int j = 0; j < kTcKeys / 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        alpha[i] = ex2(m[i] - mx);
        m[i] = mx;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kTcKeys / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * i + e];
            x = ex2(x - mx);
            sum += x;
          }
        l[i] = l[i] * alpha[i] + sum;
      }

      // the previous tile's P V is done (the wait is unconditional, so
      // that the compiler sees no path reading o with a product in flight)
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(sc);
      if (pending) mbar_arrive(bar + 8 * (kStages + sp));
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];
      // P rounded to bf16 for its product (l summed the f32 values)
#pragma unroll
      for (int j = 0; j < kTcKeys / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          pa[2 * j + i] = pack_bf16(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]);
      pending = true;
      sp = s;
    }
    if (pending) {
      issue_pv<kD>(o, pa, base + L::kV + sp * L::kTileBytes);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(bar + 8 * (kStages + sp));
    }

    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.out) +
                        static_cast<int64_t>(bh) * p.Tq * kD;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[i];
      li += __shfl_xor_sync(kFull, li, 1);
      li += __shfl_xor_sync(kFull, li, 2);
      const int tq = row_a + 8 * i;
      if (tq >= p.Tq) continue;
      const float lf = fmaxf(li, kLFloor);
      const float inv = 1.f / lf;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(
            og + static_cast<int64_t>(tq) * kD + 8 * j + col_t) =
            __floats2bfloat162_rn(o[4 * j + 2 * i] * inv,
                                  o[4 * j + 2 * i + 1] * inv);
      if (lane % 4 == 0)
        p.lse[static_cast<int64_t>(bh) * p.Tq + tq] =
            (m[i] == kNegInf ? kNegInf : m[i] * kLn2) + logf(lf);
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point (the
// library links no -lcuda); null if the driver does not give it
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// a 4-D map over the (D, T, H, B) view with strides st (batch, head, time
// elements), boxes of kBox x kTcRows, swizzled, rows past T read as zeros
template <int kD>
CUresult encode_map(EncodeTiledFn fn, CUtensorMap* map, const void* ptr,
                    const int64_t* st, int T, int H, int B) {
  using L = TcLayout<kD>;
  cuuint64_t dims[4] = {(cuuint64_t)kD, (cuuint64_t)T, (cuuint64_t)H,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                           (cuuint64_t)st[0] * 2};
  cuuint32_t box[4] = {(cuuint32_t)L::kBox, (cuuint32_t)kTcRows, 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            L::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// error codes of the tensor-core launch beyond cudaError_t's: the driver
// gives no cuTensorMapEncodeTiled, or refuses a map (+ its CUresult)
constexpr int kErrNoEncode = 9000;
constexpr int kErrEncode = 10000;

template <int kD, bool kBias, bool kSeg>
int launch_tc(const Params& p, cudaStream_t stream) {
  using L = TcLayout<kD>;
  if (!aligned16(p.q, p.qs, 2) || !aligned16(p.k, p.ks, 2) ||
      !aligned16(p.v, p.vs, 2) || (p.bias != nullptr && p.bs[3] != 1))
    return (int)cudaErrorInvalidValue;
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncode;
  CUtensorMap mq, mk, mv;
  CUresult r = encode_map<kD>(fn, &mq, p.q, p.qs, p.Tq, p.H, p.B);
  if (r == CUDA_SUCCESS)
    r = encode_map<kD>(fn, &mk, p.k, p.ks, p.Tk, p.H, p.B);
  if (r == CUDA_SUCCESS)
    r = encode_map<kD>(fn, &mv, p.v, p.vs, p.Tk, p.H, p.B);
  if (r != CUDA_SUCCESS) return kErrEncode + (int)r;
  auto kernel = flash_fwd_tc_kernel<kD, kBias, kSeg>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks =
      (int64_t)p.B * p.H * ((p.Tq + kTcRows - 1) / kTcRows);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kTcThreads, L::kSmem, stream>>>(mq, mk, mv, p);
  return (int)cudaGetLastError();
}

// one instantiation per head dim and feature set: the main path (no bias,
// no segment ids) carries no per-element code for either
template <bool kBias, bool kSeg>
int launch_tc_d(int D, const Params& p, cudaStream_t stream) {
  if (D == 32) return launch_tc<32, kBias, kSeg>(p, stream);
  if (D == 64) return launch_tc<64, kBias, kSeg>(p, stream);
  return launch_tc<128, kBias, kSeg>(p, stream);
}

int launch_tc_any(int D, const Params& p, cudaStream_t stream) {
  const bool bias = p.bias != nullptr;
  if (p.segq == nullptr)
    return bias ? launch_tc_d<true, false>(D, p, stream)
                : launch_tc_d<false, false>(D, p, stream);
  return bias ? launch_tc_d<true, true>(D, p, stream)
              : launch_tc_d<false, true>(D, p, stream);
}

}  // namespace

extern "C" {

// strides: q, k, v (batch, head, time each) then bias (batch, head, query,
// key), in elements. dtype: 0 = float32 (flash_fwd_kernel, mma.sync), 1 =
// bfloat16 (flash_fwd_tc_kernel, wgmma). Returns cudaGetLastError() after
// the launch (0 on success), cudaErrorInvalidValue for operands off the
// 16-byte rule, kErrNoEncode or kErrEncode + the CUresult when the tensor
// maps cannot be made; the wrapper raises on anything but 0.
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
  if (dtype == kF32) return launch_d(D, p, s);
  if (dtype == kBF16) return launch_tc_any(D, p, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
