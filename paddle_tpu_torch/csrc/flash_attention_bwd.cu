// Flash-attention backward for Hopper (sm_90a): a dQ kernel and a dK/dV
// kernel, every product on the tensor cores.
//
// Replaces the Pallas backward kernels of paddle_tpu/ops/pallas/flash.py:
// `_dq_kernel` / `_dkv_kernel` (flash.py:465 / :519, launcher `_flash_bwd`
// :854 / :895: K/V or Q/dO resident in VMEM) and `_dq_kernel_kgrid` /
// `_dkv_kernel_kgrid` (flash.py:579 / :629, launcher `_flash_bwd_kgrid`
// :741 / :783: the other operand streamed by the TPU grid, the accumulators
// carried in VMEM scratch across grid steps). Both pairs compute one
// function, flash_attention_bwd_reference of ops/cuda/flash.py; here the
// streamed operand walks through a shared-memory ring in an inner loop of
// each thread block, so one pair of kernels covers both at any length, with
// nothing carried between blocks.
//
// Contract:
//   q, do, out (B, H, Tq, D)    f32 or bf16, D 32, 64 or 128, strides with
//                               a unit stride along D whose batch, head and
//                               time strides and base are multiples of 16
//                               bytes (the wrapper copies a view that is
//                               not; the training step's transposed views
//                               of (B, T, H, D) tensors are)
//   k, v       (B, H, Tk, D)    q's type, the same stride rule
//   bias       f32 or null      element (b, h, i, j) at the four strides
//                               given (0 along a broadcast dimension)
//   segq/segk  (B, Tq)/(B, Tk)  int32 contiguous, or both null
//   lse        (B, H, Tq)       f32 contiguous: the forward's logsumexp
//   dlse       (B, H, Tq)       f32 contiguous, or null: lse's cotangent
//   delta      (B, H, Tq)       f32, written by the dQ kernel:
//                               sum(do * out, -1) - dlse
//   dq         (B, H, Tq, D)    q's type, contiguous
//   dk, dv     (B, H, Tk, D)    q's type, contiguous
//   scale      f32; causal 0/1, aligned bottom-right: key j is visible to
//              query i iff j <= i + (Tk - Tq)
//
// Both kernels recompute the probabilities from the saved lse,
// P = visible ? exp(scale q.k + bias - lse) : 0, and dS = P (dO.v - delta),
// then
//   dQ  = scale dS K            (one block per (b * H + h, 64-row q tile);
//                                it walks the key tiles up to the tile's
//                                last visible key: `_last_visible_kb`)
//   dK  = scale dS^T Q, dV = P^T dO
//                               (one block per (b * H + h, 64-key tile); it
//                                walks the q tiles from the first that sees
//                                one of its keys: `_first_visible_qb`)
// With segment ids a tile pair in which no (query, key) pair shares an id is
// skipped whole (`_seg_overlap`). Both prunings are exact: such tiles give
// P = 0 everywhere. Each block writes only its own output rows, so there are
// no atomics and the result is the same, bit for bit, from run to run; the
// price is that S and dP are computed in both kernels (seven products where
// a kernel with atomic dQ would do five). The heaviest blocks start first
// (under causal: the last q tiles, the first key tiles), which shortens the
// tail the mask leaves. The dQ kernel runs first and writes delta, which
// the dK/dV kernel reads.
//
// What bounds it on this card: at the training shape (B 8, H 12, T 512,
// D 64, causal, f32) the function moves q, k, v, out, do, dq, dk, dv once
// (~101 MB: 30 us at 3.35 TB/s) and needs 5 products of 2 D flops over each
// of the 12.6 M visible pairs (8.1e9 flops). An f32-accurate product on the
// tensor cores takes three TF32 passes, so the least time is 8.1e9 / (494.7
// / 3 TFLOP/s) = 0.049 ms: the operations bound it. In bf16 the bytes do
// (~51 MB, 0.015 ms).
//
// The design:
// * Products on the tensor cores with mma.sync. A block has 4 warps; each
//   owns 16 rows of the block's own 64-row tile (keys in the dK/dV kernel,
//   queries in the dQ kernel) and computes its 16 x N slice of the score
//   tile against the N streamed rows (N = 64, or 32 at D 128).
//   - f32: m16n8k8 TF32 -> f32 in three passes, big.big' + big.small' +
//     small.big', big = x rounded to TF32 (to nearest, ties away: what
//     cvt.rna.tf32.f32 gives, here by two integer operations, which issue
//     at several times a conversion's rate), small = x - big truncated to
//     TF32 (one operation; it keeps a NaN operand NaN), split in registers
//     as each fragment is loaded, so shared memory holds one f32 copy of
//     each tile. Each partial product is exact in f32; the dropped
//     small.small' and the truncation of small are ~2^-21 of a term, of
//     either sign. All five operand kinds go through it, P and dS
//     included (one TF32 pass would cost ~2^-11 a term).
//   - bf16: m16n8k16 bf16 -> f32; the score products read their bf16
//     operands as they are, P and dS enter the second products as bf16 hi
//     + lo (two products each), since a bf16 P or dS alone costs up to 7e-3
//     of an output row against the 5e-3 row bound (tests/
//     test_torch_flash_bwd.py measures both on the CPU).
// * The k index of a product may be permuted as long as both operands
//   follow it. Slot t of an m16n8k8 A fragment holds column 2t and slot
//   t + 4 column 2t + 1, so the accumulator fragments of P and dS (columns
//   2t, 2t + 1 of each 8) are A fragments as they stand, with no shuffle,
//   and a row's two d values of a score product load as one float2.
// * f32 tiles are D floats a row with the 8-word groups XOR-swizzled by
//   row (swz): both access patterns of a tile, rows g and columns 2t of an
//   A or B fragment, and rows 2t (2t + 1) and column g of a B fragment read
//   along the time axis (dO and Q in dK/dV, K in dQ: 32-bit operands have
//   no ldmatrix .trans), fall in 32 distinct banks. bf16 tiles are padded
//   by 16 bytes a row and read by ldmatrix (.trans for the time axis).
// * Copies: the own tiles, and each streamed tile with its rows' lse,
//   delta and segment ids, arrive by 16-byte (4-byte for the vectors)
//   cp.async into a two-stage ring; rows past T are zero-filled by the
//   copy. The next tile's copy is in flight while a tile is computed.
// * delta: JAX computes sum(dO * out) outside the kernels. Here the dQ
//   kernel computes it with the very products that give dP (product(),
//   the same fragments in the same order), so that a query whose only
//   visible key is the one its output copied (the first row under causal,
//   the first of each segment) gets dP - delta = 0 and a gradient of
//   exactly 0, as the exact function has; a sum in another order leaves
//   the rounding difference of the two orders there.
// * Probabilities by exp2 in the base-2 domain; a warp whose 16 x N slice
//   is visible whole (inside the lengths, under the diagonal, no bias, no
//   segments) skips the per-element mask.
// * Rounding: the tensor cores truncate as they accumulate, and a chain of
//   thousands of truncating mma steps (T 16384) would drift past the f32
//   tolerance; in f32 each streamed tile's contribution is summed in its
//   own fragments (24 steps at most) and added to the running dQ, dK or dV
//   with round-to-nearest. bf16 accumulates in place.
// * Shared memory (f32): 2 own + 2 x 2 streamed tiles: 98 KB at D 64 (2
//   blocks an SM), 129 KB at D 128 (32-row streamed tiles), 49 KB at D 32;
//   bf16 about half of that.
// * Registers and spills (ptxas -v, sm_90a; chip_smoke.py prints them):
//   f32 dK/dV 167 / 254 / 255 at D 32 / 64 / 128 (132 bytes spilled at
//   D 128), dQ 164 / 166 / 168; bf16 dK/dV 175 / 221 / 255 (184 bytes
//   spilled at D 128), dQ 124 / 158 / 162. The training shape's f32 D 64
//   runs without spills, two blocks (8 warps) an SM.
//
// Traps carried over from flash.py:
//   * NEG_INF is finite (-1e30) and a row with no visible key has
//     lse = -1e30 + log(1e-30), so exp(s - lse) of a masked entry would be
//     1: probabilities come from visible ? exp(s - lse) : 0, never the bare
//     exp. Such rows give dQ = 0 exactly and add nothing to dK, dV.
//   * NaN: a row whose forward came out NaN has a NaN lse and delta, so its
//     visible P and dS are NaN; a hidden pair's P and dS are 0 exactly,
//     also where delta is NaN, as the plain version's masks give. The f32
//     products keep a NaN operand (`split`), so the row's dQ and the dK, dV
//     of every key it sees come out NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// dtype codes of the C entry point
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const void* out;
  const float* bias;
  const int* segq;
  const int* segk;
  const float* lse;
  const float* dlse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  int64_t qs[3], ks[3], vs[3], ds[3], os[3];  // batch, head, time strides
  int64_t bs[4];                              // bias batch, head, query, key
  int B, H, Tq, Tk;
  float scale;
  int causal;
};

// rows of a streamed tile: 32 at D 128, where dK and dV alone hold 128 f32
// registers a thread
template <int kD>
constexpr int kN = kD == 128 ? 32 : 64;

constexpr int kStages = 2;  // ring stages of the streamed side

// elements of one tile row in shared memory
template <typename T, int kD>
constexpr int kRow = kIsF32<T> ? kD : kD + 8;

// two own tiles, the ring (each stage two streamed tiles; the dQ kernel
// first lands out's tile in the last stage), and the rows' vectors
template <typename T, int kD>
constexpr size_t kSmem =
    (size_t)(2 * kM + 2 * kStages * kN<kD>) * kRow<T, kD> * sizeof(T) +
    (size_t)(3 * kM + 3 * kStages * kN<kD>) * 4;

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
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
// a bf16 pair (the first in the low half) and the pair of its residuals
__device__ __forceinline__ void hi_lo(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 r = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - r.x, x1 - r.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// acc[j] += A B_j^T over D: A the warp's rows r0 .. r0 + 15 of tile a,
// B_j rows 8 j .. 8 j + 7 of tile b. S, dP and delta all come from here,
// so that equal operands give equal sums, bit for bit
template <typename T, int kD, int kNT>
__device__ __forceinline__ void product(float (&acc)[kNT][4], const T* a,
                                        const T* b, int r0, int lane) {
  if constexpr (kIsF32<T>) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
    for (int kk = 0; kk < kD / 8; ++kk) {
      // slot t holds d = 8 kk + 2t, slot t + 4 d = 8 kk + 2t + 1
      const int c = 8 * kk + 2 * t;
      const float2 u = ld2(a + at<T, kD>(r0 + g, c));
      const float2 w = ld2(a + at<T, kD>(r0 + g + 8, c));
      uint32_t ab[4], as[4];
      split(u.x, ab[0], as[0]);
      split(w.x, ab[1], as[1]);
      split(u.y, ab[2], as[2]);
      split(w.y, ab[3], as[3]);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float2 x = ld2(b + at<T, kD>(8 * j + g, c));
        mma3(acc[j], ab, as, x.x, x.y);
      }
    }
  } else {
    const int ar = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int br = (lane >> 4) * 8 + (lane & 7);
#pragma unroll 2
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t af[4];
      ldmatrix_x4(af, a + at<T, kD>(ar, 16 * kk + (lane >> 4) * 8));
      const int bc = 16 * kk + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int jj = 0; jj < kNT / 2; ++jj) {
        uint32_t bf[4];
        ldmatrix_x4(bf, b + at<T, kD>(16 * jj + br, bc));
        mma_bf16(acc[2 * jj], af, bf[0], bf[1]);
        mma_bf16(acc[2 * jj + 1], af, bf[2], bf[3]);
      }
    }
  }
}

// acc (the warp's 16 rows x D) += C X over the 8 kNT streamed rows: C the
// warp's (16, 8 kNT) P or dS fragments, X a streamed (8 kNT, D) tile read
// along its time axis. In f32 the tile's sum is taken in its own fragments
// and added to acc with round-to-nearest (the tensor cores truncate as
// they accumulate); bf16 accumulates in place, its drift far inside its
// tolerance
template <typename T, int kD, int kNT>
__device__ __forceinline__ void accumulate(float (&acc)[kD / 8][4],
                                           const float (&c)[kNT][4],
                                           const T* x, int lane) {
  if constexpr (kIsF32<T>) {
    constexpr int kChunk = kD < 64 ? kD / 8 : 8;  // d fragments of one pass
    const int g = lane >> 2, t = lane & 3;
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
        split(c[kk][0], ab[0], as[0]);
        split(c[kk][2], ab[1], as[1]);
        split(c[kk][1], ab[2], as[2]);
        split(c[kk][3], ab[3], as[3]);
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const int col = 8 * (n0 + j) + g;
          mma3(part[j], ab, as, x[at<T, kD>(8 * kk + 2 * t, col)],
               x[at<T, kD>(8 * kk + 2 * t + 1, col)]);
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n0 + j][e] += part[j][e];
    }
  } else {
    const int xr = ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
    for (int kk = 0; kk < kNT / 2; ++kk) {
      uint32_t ah[4], al[4];
      hi_lo(c[2 * kk][0], c[2 * kk][1], ah[0], al[0]);
      hi_lo(c[2 * kk][2], c[2 * kk][3], ah[1], al[1]);
      hi_lo(c[2 * kk + 1][0], c[2 * kk + 1][1], ah[2], al[2]);
      hi_lo(c[2 * kk + 1][2], c[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
      for (int jj = 0; jj < kD / 16; ++jj) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, x + at<T, kD>(16 * kk + xr,
                                            16 * jj + (lane >> 4) * 8));
        mma_bf16(acc[2 * jj], al, bf[0], bf[1]);
        mma_bf16(acc[2 * jj], ah, bf[0], bf[1]);
        mma_bf16(acc[2 * jj + 1], al, bf[2], bf[3]);
        mma_bf16(acc[2 * jj + 1], ah, bf[2], bf[3]);
      }
    }
  }
}

// the warp's score fragments s (q.k, unscaled) and dp (dO.v) become P and
// dS. Fragment rows are the own tile's r0 + g (+ 8), columns the streamed
// tile's 8 j + 2t (+ 1); kKeyRows: rows are keys (the dK/dV kernel), else
// queries. lse and dlt are indexed by the query's row in its tile, sq and
// sk by the query's and the key's
template <bool kKeyRows, int kNT>
__device__ __forceinline__ void probs(float (&s)[kNT][4], float (&dp)[kNT][4],
                                      const Params& p, const float* bg,
                                      int q0, int k0, int r0,
                                      const float* lse, const float* dlt,
                                      const int* sq, const int* sk,
                                      int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int shift = p.Tk - p.Tq;
  // every pair of the warp's slice visible: no per-element mask
  const int tq_lo = q0 + (kKeyRows ? 0 : r0);
  const int tq_hi = q0 + (kKeyRows ? 8 * kNT : r0 + 16) - 1;
  const int tk_hi = k0 + (kKeyRows ? r0 + 16 : 8 * kNT) - 1;
  if (bg == nullptr && p.segq == nullptr && tq_hi < p.Tq && tk_hi < p.Tk &&
      (!p.causal || tk_hi <= tq_lo + shift)) {
    const float c1 = p.scale * kLog2e;
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qr = kKeyRows ? 8 * j + 2 * t + (e & 1)
                                : r0 + g + ((e & 2) << 2);
        const float pr = exp2f(fmaf(s[j][e], c1, -lse[qr] * kLog2e));
        s[j][e] = pr;
        dp[j][e] = pr * (dp[j][e] - dlt[qr]);
      }
    return;
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rl = r0 + g + ((e & 2) << 2);
      const int cl = 8 * j + 2 * t + (e & 1);
      const int qr = kKeyRows ? cl : rl;
      const int kc = kKeyRows ? rl : cl;
      const int tq = q0 + qr;
      const int tk = k0 + kc;
      bool ok = tq < p.Tq && tk < p.Tk;
      if (p.causal) ok = ok && tk <= tq + shift;
      if (p.segq != nullptr) ok = ok && sq[qr] == sk[kc];
      float x = s[j][e] * p.scale;
      if (ok && bg != nullptr) x += bg[tq * p.bs[2] + tk * p.bs[3]];
      const float pr = ok ? exp2f((x - lse[qr]) * kLog2e) : 0.f;
      s[j][e] = pr;
      // a hidden pair's dS is 0 even where delta is NaN
      dp[j][e] = ok ? pr * (dp[j][e] - dlt[qr]) : 0.f;
    }
}

__device__ __forceinline__ void store2(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

// the warp's rows r0 .. r0 + 15 of a (T, D) output from t0, times mul
template <typename T, int kD>
__device__ __forceinline__ void store_rows(T* out,
                                           const float (&acc)[kD / 8][4],
                                           int t0, int len, float mul,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = t0 + g + 8 * h;
    if (row >= len) continue;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      store2(out + (int64_t)row * kD + 8 * j + 2 * t, acc[j][2 * h] * mul,
             acc[j][2 * h + 1] * mul);
  }
}

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const Params p) {
  constexpr int kNr = kN<kD>;
  constexpr int kNT = kNr / 8;
  constexpr int kS = kStages;
  constexpr int kOwn = kM * kRow<T, kD>;
  constexpr int kStr = kNr * kRow<T, kD>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_sm = reinterpret_cast<T*>(smem);
  T* do_sm = q_sm + kOwn;
  T* ring = do_sm + kOwn;  // stage s: k at ring + 2 s kStr, v after it
  float* lse_sm = reinterpret_cast<float*>(ring + 2 * kS * kStr);
  float* dlt_sm = lse_sm + kM;
  int* sq_sm = reinterpret_cast<int*>(dlt_sm + kM);
  int* svec = sq_sm + kM;  // stage s: kNr key segment ids at s * 3 kNr

  const int bhs = p.B * p.H;
  const int nqb = (p.Tq + kM - 1) / kM;
  // the heaviest q tiles (the last rows, under causal) first
  const int qb = nqb - 1 - (int)(blockIdx.x / bhs);
  const int bh = blockIdx.x % bhs;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = qb * kM;
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (threadIdx.x >> 5);
  const bool has_seg = p.segq != nullptr;
  const int shift = p.Tk - p.Tq;

  const T* qg = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const T* dog = static_cast<const T*>(p.dout) + b * p.ds[0] + h * p.ds[1];
  const T* og = static_cast<const T*>(p.out) + b * p.os[0] + h * p.os[1];
  const T* kg = static_cast<const T*>(p.k) + b * p.ks[0] + h * p.ks[1];
  const T* vg = static_cast<const T*>(p.v) + b * p.vs[0] + h * p.vs[1];
  const float* bg =
      p.bias != nullptr ? p.bias + b * p.bs[0] + h * p.bs[1] : nullptr;
  const int64_t row0 = (int64_t)bh * p.Tq;

  int nkb = (p.Tk + kNr - 1) / kNr;
  if (p.causal) {
    // the last key any row of this tile sees (_last_visible_kb)
    const int last = min(q0 + kM, p.Tq) - 1 + shift;
    nkb = last < 0 ? 0 : min(nkb, last / kNr + 1);
  }

  auto issue = [&](int i) {
    const int s = i % kS;
    const int k0 = i * kNr;
    T* ks = ring + 2 * s * kStr;
    copy_tile<T, kD, kNr>(ks, kg, p.ks[2], k0, p.Tk);
    copy_tile<T, kD, kNr>(ks + kStr, vg, p.vs[2], k0, p.Tk);
    if (has_seg)
      copy_vec(svec + s * 3 * kNr, p.segk + (int64_t)b * p.Tk, k0, kNr, p.Tk);
  };

  // the own tiles, out's tile in the last stage, the first kS - 1 K/V tiles
  T* o_sm = ring + 2 * (kS - 1) * kStr;
  copy_tile<T, kD, kM>(q_sm, qg, p.qs[2], q0, p.Tq);
  copy_tile<T, kD, kM>(do_sm, dog, p.ds[2], q0, p.Tq);
  copy_tile<T, kD, kM>(o_sm, og, p.os[2], q0, p.Tq);
  copy_vec(lse_sm, p.lse + row0, q0, kM, p.Tq);
  if (has_seg) copy_vec(sq_sm, p.segq + (int64_t)b * p.Tq, q0, kM, p.Tq);
  for (int i = 0; i < kS - 1; ++i) {
    if (i < nkb) issue(i);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();

  // delta = dO . out - dlse of the warp's rows, by the products that give
  // dP: a row whose only visible key is the one its output copied gets
  // dP - delta = 0 exactly. Written for the dK/dV kernel too
  {
    float x[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
    product<T, kD, 2>(x, do_sm, o_sm + r0 * kRow<T, kD>, r0, lane);
    const int g = lane >> 2;
    if ((lane & 3) == g >> 1) {  // the diagonal: column g of rows g, g + 8
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + g + 8 * hh;
        const int tq = q0 + r;
        float d = x[hh][2 * hh + (g & 1)];
        if (tq < p.Tq) {
          if (p.dlse != nullptr) d -= p.dlse[row0 + tq];
          p.delta[row0 + tq] = d;
        }
        dlt_sm[r] = d;
      }
    }
  }

  float acc[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int i = 0; i < nkb; ++i) {
    __syncthreads();  // the stage issue(i + kS - 1) refills was read at i - 1
    if (i + kS - 1 < nkb) issue(i + kS - 1);
    cp_async_commit();
    cp_async_wait<kS - 1>();
    __syncthreads();  // tile i landed for every thread
    const int s = i % kS;
    const int k0 = i * kNr;
    const T* ks = ring + 2 * s * kStr;
    const int* sk = svec + s * 3 * kNr;
    if (has_seg && !seg_overlap(sq_sm, q0, kM, sk, k0, kNr, p)) continue;
    float sc[kNT][4], dp[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    product<T, kD, kNT>(sc, q_sm, ks, r0, lane);          // S = Q K^T
    product<T, kD, kNT>(dp, do_sm, ks + kStr, r0, lane);  // dP = dO V^T
    probs<false, kNT>(sc, dp, p, bg, q0, k0, r0, lse_sm, dlt_sm, sq_sm, sk,
                      lane);
    accumulate<T, kD, kNT>(acc, dp, ks, lane);  // dS K
  }
  cp_async_wait<0>();

  store_rows<T, kD>(static_cast<T*>(p.dq) + row0 * kD, acc, q0 + r0, p.Tq,
                    p.scale, lane);
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const Params p) {
  constexpr int kNr = kN<kD>;
  constexpr int kNT = kNr / 8;
  constexpr int kS = kStages;
  constexpr int kOwn = kM * kRow<T, kD>;
  constexpr int kStr = kNr * kRow<T, kD>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_sm = reinterpret_cast<T*>(smem);
  T* v_sm = k_sm + kOwn;
  T* ring = v_sm + kOwn;  // stage s: q at ring + 2 s kStr, do after it
  int* sk_sm = reinterpret_cast<int*>(ring + 2 * kS * kStr);
  // stage s at s * 3 kNr: lse, delta, query segment ids (kNr each)
  float* svec = reinterpret_cast<float*>(sk_sm + 3 * kM);

  const int bhs = p.B * p.H;
  // the heaviest key tiles (the first keys, under causal) first
  const int kb = blockIdx.x / bhs;
  const int bh = blockIdx.x % bhs;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int k0 = kb * kM;
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (threadIdx.x >> 5);
  const bool has_seg = p.segq != nullptr;
  const int shift = p.Tk - p.Tq;

  const T* qg = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const T* dog = static_cast<const T*>(p.dout) + b * p.ds[0] + h * p.ds[1];
  const T* kg = static_cast<const T*>(p.k) + b * p.ks[0] + h * p.ks[1];
  const T* vg = static_cast<const T*>(p.v) + b * p.vs[0] + h * p.vs[1];
  const float* bg =
      p.bias != nullptr ? p.bias + b * p.bs[0] + h * p.bs[1] : nullptr;
  const int64_t row0 = (int64_t)bh * p.Tq;

  const int nqb = (p.Tq + kNr - 1) / kNr;
  int qb_lo = 0;
  if (p.causal) {
    // the first query that sees key k0 is k0 - shift (_first_visible_qb)
    const int first = k0 - shift;
    qb_lo = first <= 0 ? 0 : min(nqb, first / kNr);
  }
  const int n = nqb - qb_lo;

  auto issue = [&](int i) {
    const int s = i % kS;
    const int q0 = (qb_lo + i) * kNr;
    T* qs = ring + 2 * s * kStr;
    float* sv = svec + s * 3 * kNr;
    copy_tile<T, kD, kNr>(qs, qg, p.qs[2], q0, p.Tq);
    copy_tile<T, kD, kNr>(qs + kStr, dog, p.ds[2], q0, p.Tq);
    copy_vec(sv, p.lse + row0, q0, kNr, p.Tq);
    copy_vec(sv + kNr, p.delta + row0, q0, kNr, p.Tq);
    if (has_seg)
      copy_vec(sv + 2 * kNr, p.segq + (int64_t)b * p.Tq, q0, kNr, p.Tq);
  };

  copy_tile<T, kD, kM>(k_sm, kg, p.ks[2], k0, p.Tk);
  copy_tile<T, kD, kM>(v_sm, vg, p.vs[2], k0, p.Tk);
  if (has_seg) copy_vec(sk_sm, p.segk + (int64_t)b * p.Tk, k0, kM, p.Tk);
  for (int i = 0; i < kS - 1; ++i) {
    if (i < n) issue(i);
    cp_async_commit();
  }

  float dk[kD / 8][4], dv[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int i = 0; i < n; ++i) {
    __syncthreads();  // the stage issue(i + kS - 1) refills was read at i - 1
    if (i + kS - 1 < n) issue(i + kS - 1);
    cp_async_commit();
    cp_async_wait<kS - 1>();
    __syncthreads();  // tile i (and K, V) landed for every thread
    const int s = i % kS;
    const int q0 = (qb_lo + i) * kNr;
    const T* qs = ring + 2 * s * kStr;
    const float* sv = svec + s * 3 * kNr;
    const int* sq = reinterpret_cast<const int*>(sv + 2 * kNr);
    if (has_seg && !seg_overlap(sq, q0, kNr, sk_sm, k0, kM, p)) continue;
    float st[kNT][4], dst[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dst[j][e] = 0.f;
    product<T, kD, kNT>(st, k_sm, qs, r0, lane);          // S^T = K Q^T
    product<T, kD, kNT>(dst, v_sm, qs + kStr, r0, lane);  // dP^T = V dO^T
    probs<true, kNT>(st, dst, p, bg, q0, k0, r0, sv, sv + kNr, sq, sk_sm,
                     lane);
    accumulate<T, kD, kNT>(dv, st, qs + kStr, lane);  // P^T dO
    accumulate<T, kD, kNT>(dk, dst, qs, lane);        // dS^T Q
  }
  cp_async_wait<0>();

  const int64_t out0 = (int64_t)bh * p.Tk * kD;
  store_rows<T, kD>(static_cast<T*>(p.dk) + out0, dk, k0 + r0, p.Tk,
                    p.scale, lane);
  store_rows<T, kD>(static_cast<T*>(p.dv) + out0, dv, k0 + r0, p.Tk, 1.f,
                    lane);
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
  const int64_t bh = (int64_t)p.B * p.H;
  if (which == 0)
    return launch_one(flash_bwd_dq_kernel<T, kD>,
                      bh * ((p.Tq + kM - 1) / kM), kSmem<T, kD>, p, stream);
  return launch_one(flash_bwd_dkv_kernel<T, kD>,
                    bh * ((p.Tk + kM - 1) / kM), kSmem<T, kD>, p, stream);
}

template <typename T>
int launch_d(int D, const Params& p, int which, cudaStream_t stream) {
  if (D == 32) return launch<T, 32>(p, which, stream);
  if (D == 64) return launch<T, 64>(p, which, stream);
  return launch<T, 128>(p, which, stream);
}

}  // namespace

extern "C" {

// which: 0 = the dQ kernel (it also writes delta), 1 = the dK/dV kernel
// (it reads that delta: launch it after the dQ kernel, on the same
// stream). strides: q, k, v, do, out (batch, head, time each) then bias
// (batch, head, query, key), in elements. dlse may be null. dtype: 0 =
// float32, 1 = bfloat16. Returns cudaGetLastError() after the launch (0 on
// success); the wrapper raises on anything else.
int flash_attention_bwd(int which, const void* q, const void* k,
                        const void* v, const void* dout, const void* out,
                        const void* bias, const void* segq, const void* segk,
                        const void* lse, const void* dlse, void* delta,
                        void* dq, void* dk, void* dv, const int64_t* strides,
                        int B, int H, int Tq, int Tk, int D, float scale,
                        int causal, int dtype, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || (which != 0 && which != 1) ||
      (D != 32 && D != 64 && D != 128) || (segq == nullptr) != (segk == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.out = out;
  p.bias = static_cast<const float*>(bias);
  p.segq = static_cast<const int*>(segq);
  p.segk = static_cast<const int*>(segk);
  p.lse = static_cast<const float*>(lse);
  p.dlse = static_cast<const float*>(dlse);
  p.delta = static_cast<float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.ds[i] = strides[9 + i];
    p.os[i] = strides[12 + i];
  }
  for (int i = 0; i < 4; ++i) p.bs[i] = strides[15 + i];
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
