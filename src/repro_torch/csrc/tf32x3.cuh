// f32-accurate products on Hopper's tensor cores (3xTF32), and the
// cp.async tile loader, shared by flash_attention.cu and ssd_scan.cu.
//
// An f32 operand a is split as a = hi + lo with hi = cvt.rna.tf32.f32(a)
// (round to nearest, ties away) and lo the exact f32 remainder a - hi,
// itself rounded to TF32 when it is handed to the tensor core (the tensor
// core would otherwise truncate its low 13 bits).  hi*hi + hi*lo + lo*hi,
// accumulated in f32, misses the f32 product only by the lo*lo term and
// lo's rounding, ~2^-22 of |a b|; plain TF32 (hi*hi) is off by ~2^-11.
// A bf16 value is a TF32 value already (8 mantissa bits of 10): it needs no
// split, and a product with one bf16 operand takes two passes, one with
// two bf16 operands one.  tests/test_torch_tf32_split.py emulates both
// designs on the CPU.
//
// The products are warp-level mma.sync.m16n8k8 (TF32 in, f32 accumulate).
// With g = lane / 4 and t = lane % 4, the fragments are
//   A (16 x 8, row-major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, k x n):      b0 (t, g), b1 (t + 4, g)
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// A product's k order is free, so a kernel that feeds an accumulator C of
// one product to the next as A reads k column t as index 2t and column
// t + 4 as 2t + 1 (a = {c0, c2, c1, c3}), and loads B's rows in the same
// order: no shuffle between the two products.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// cvt.rna.tf32.f32 on a finite value or an infinity: add half of the 13
// dropped bits to the magnitude and clear them (a carry moves into the
// exponent, as the rounding's does).  ptxas lowers cvt.rna to the same add
// and mask behind a finiteness test and a select; the inputs here are finite.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// a = hi + lo: hi = tf32(a); lo = tf32(a - hi), a - hi exact in f32.  lo is
// handed to the tensor core only, which ignores its low 13 bits: adding half
// of them is the rounding, and the mask is left out (as ptxas does for cvt.rna).
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(a);
  lo = __float_as_uint(a - __uint_as_float(hi)) + 0x1000u;
}

// the lo operand of an exact f32 remainder kept in shared memory, rounded
// for the tensor core as split() rounds it
__device__ __forceinline__ uint32_t lo_operand(float lo) { return __float_as_uint(lo) + 0x1000u; }

__device__ __forceinline__ void split4(const float (&a)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a[i], hi[i], lo[i]);
}

__device__ __forceinline__ void split2(const float (&a)[2], uint32_t (&hi)[2],
                                       uint32_t (&lo)[2]) {
  split(a[0], hi[0], lo[0]);
  split(a[1], hi[1], lo[1]);
}

// d += a b, one m16n8k8 TF32 product
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in f32 accuracy, both operands split: the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(d, al, bh);
  mma(d, ah, bl);
  mma(d, ah, bh);
}

// d += a b in f32 accuracy with each pass in an accumulator of its own
// (d[0] takes hi*hi): an mma.sync's result is ready long after its issue,
// so three independent chains cut mma3's latency threefold
__device__ __forceinline__ void mma3x(float (&d)[3][4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                      const uint32_t (&bl)[2]) {
  mma(d[1], al, bh);
  mma(d[2], ah, bl);
  mma(d[0], ah, bh);
}

// the sum of mma3x's accumulators, the small terms first
__device__ __forceinline__ void sum3(const float (&d)[3][4], float (&out)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) out[e] = d[0][e] + (d[1][e] + d[2][e]);
}

// d += a b with b a TF32 value already (bf16 input): two passes
__device__ __forceinline__ void mma2(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&b)[2]) {
  mma(d, al, b);
  mma(d, ah, b);
}

// d += a b with a a TF32 value already (bf16 input) and b split: two passes
__device__ __forceinline__ void mma2b(float (&d)[4], const uint32_t (&a)[4],
                                      const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
  mma(d, a, bl);
  mma(d, a, bh);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A rows_p x cols_p tile of T into shared memory (row pitch dpitch) from
// rows of src at stride sstride: element (r, c) is src[r * sstride + c] for
// r < rows and c < cols, else 0.  With vec (cols and cols_p multiples of
// 16 bytes, src and its rows 16-byte aligned) every thread issues 16-byte
// cp.async copies, zero-filled past the edges, and the caller commits and
// waits; otherwise it copies one element at a time, synchronously.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int dpitch, const T* __restrict__ src,
                                          long long sstride, int rows, int rows_p, int cols,
                                          int cols_p, bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int cpr = cols_p / E;            // 16-byte chunks a row
    // chunk (r, k) for k < cpr, stepping blockDim.x chunks: one division
    int r = threadIdx.x / cpr, k = threadIdx.x - r * cpr;
    const int dr = blockDim.x / cpr, dk = blockDim.x - dr * cpr;
    for (; r < rows_p; r += dr, k += dk) {
      if (k >= cpr) {
        k -= cpr;
        ++r;
        if (r >= rows_p) break;
      }
      const int c = k * E;
      const bool ok = r < rows && c < cols;
      cp_async16(dst + r * dpitch + c, ok ? src + r * sstride + c : src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows_p * cols_p; i += blockDim.x) {
      const int r = i / cols_p, c = i - r * cols_p;
      dst[r * dpitch + c] = r < rows && c < cols ? src[r * sstride + c] : zero<T>();
    }
  }
}

}  // namespace tf32x3
