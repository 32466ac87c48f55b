// Pieces shared by the f32 flash forward (flash_attention.cu) and the flash
// backward (flash_attention_bwd.cu): the block geometry of their mma.sync
// kernels, the row-swizzled f32 tile layout, the cp.async copies, and the
// f32-accurate product on the tensor cores as three TF32 passes.
//
// Each warp of these kernels owns 16 rows of its block's own tile (the
// backward's blocks are kWarps warps over kM rows; the copies take the
// block's thread count as a template argument). The k index of an m16n8k8
// product may be permuted as long as both operands follow it: slot t of an
// A fragment holds column 2t and slot t + 4 column 2t + 1, so an
// accumulator fragment (columns 2t, 2t + 1 of each 8) is an A fragment as
// it stands, and a row's two values of a score product load as one float2.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kM = 64;                  // rows of a block's own tile
constexpr int kWarps = kM / 16;         // 16 rows a warp
constexpr int kThreads = 32 * kWarps;

template <typename T>
constexpr bool kIsF32 = std::is_same<T, float>::value;

// f32 tiles: the word of column c in row r is c ^ swz(r). swz takes the
// values 0, 8, 16, 24 once on each of rows {0..3}, {4..7}, {0, 2, 4, 6}
// and {1, 3, 5, 7} (mod 8), so a fragment read by rows g or by rows 2t
// (2t + 1) hits 32 banks; it keeps 4-float chunks whole for cp.async
__device__ __forceinline__ int swz(int r) {
  return ((r & 2) << 3) | (((r ^ (r >> 2)) & 1) << 3);
}
template <typename T, int kD>
__device__ __forceinline__ int at(int r, int c) {
  if constexpr (kIsF32<T>)
    return r * kD + (c ^ swz(r));
  else
    return r * (kD + 8) + c;
}

// ---------------------------------------------------------------------------
// copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes, or 16 zero bytes when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [t0, t0 + kRows) of a (T, D) operand at time stride st into a
// shared tile, by a block of kNThreads threads; rows past len are zeros
template <typename T, int kD, int kRows, int kNThreads = kThreads>
__device__ __forceinline__ void copy_tile(T* sm, const T* g, int64_t st,
                                          int t0, int len) {
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kChunks = kD / kPer;
  for (int i = threadIdx.x; i < kRows * kChunks; i += kNThreads) {
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * kPer;
    const bool in = t0 + r < len;
    cp_async16(sm + at<T, kD>(r, c), in ? g + (t0 + r) * st + c : g, in);
  }
}

// n 4-byte values of a row vector from t0; zeros past len
template <int kNThreads = kThreads>
__device__ __forceinline__ void copy_vec(void* sm, const void* g, int t0,
                                         int n, int len) {
  for (int i = threadIdx.x; i < n; i += kNThreads) {
    const bool in = t0 + i < len;
    cp_async4(static_cast<uint32_t*>(sm) + i,
              in ? static_cast<const uint32_t*>(g) + t0 + i : g, in);
  }
}

// whether any (query, key) pair of a tile pair shares a segment id: sq the
// nq query ids from q0, sk the nk key ids from k0 (p gives the lengths); a
// barrier for the whole block of kNThreads threads
template <int kNThreads = kThreads, typename P>
__device__ __forceinline__ bool seg_overlap(const int* sq, int q0, int nq,
                                            const int* sk, int k0, int nk,
                                            const P& p) {
  int overlap = 0;
  for (int e = threadIdx.x; e < nq * nk; e += kNThreads) {
    const int r = e / nk;
    const int c = e - r * nk;
    overlap |= q0 + r < p.Tq && k0 + c < p.Tk && sq[r] == sk[c];
  }
  return __syncthreads_or(overlap);
}

// ---------------------------------------------------------------------------
// f32 products on the tensor cores
// ---------------------------------------------------------------------------

// x rounded to TF32's 10-bit mantissa, to nearest with ties away from
// zero (what cvt.rna.tf32.f32 gives), by two integer operations: a
// conversion instruction issues at a fraction of their rate
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = big + small (+ ~2^-22 x), both TF32
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_bits(x);
  small = tf32_bits(x - __uint_as_float(big));
}

// c (16x8 f32) += a (16x8 tf32, row) * b (8x8 tf32, col)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// the three passes of an f32-accurate product, small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], float b0,
                                     float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split(b0, bb0, bs0);
  split(b1, bb1, bs1);
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

}  // namespace
