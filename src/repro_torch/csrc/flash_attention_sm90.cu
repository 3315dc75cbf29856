// Flash attention on Hopper tensor cores (sm_90a), the bf16 route.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py:
// flash_attention_bhsd (:103, body _kernel :53, window start _k_start :42).  Same
// function: scores in f32 with a running max and denominator, keys at or past Sk
// masked, causal and causal sliding window (keys in (row - window, row]), GQA with
// query head h reading K/V head h / (H / Hkv), the (B, S, H, D) layout read in
// place, every head_dim D <= 256 that is a multiple of 8 (TMA moves rows of 16
// bytes).  The f32 route is flash_attention.cu (3xTF32 on mma.sync).
//
// What bounds it.  At the DiT's self-attention shapes (1024 x 1024 tokens, D = 72)
// the operations: 4 * B * H * Sq * Sk * D against 989 TFLOP/s of bf16 tensor
// cores, hundreds of operations per byte.  At D = 72 the softmax is close behind:
// one ex2 per score against 2 * 80 multiply-adds, and the special-function units
// run 16 ex2 a clock per SM against 2048 bf16 multiply-adds.  At the
// cross-attention shapes (Sk = 77) the bytes: q and o are 13x the size of k and v.
//
// What the design does about it.
// - Both products run on tensor cores with wgmma: S = Q K^T with A and B from
//   shared memory (64 x 64 x 16 per instruction), O += P V with P from registers
//   as the A operand (the S accumulator's layout is the A fragment's, so P is
//   rounded to bf16 in place and never goes through shared memory) and V as a
//   transposed (N-major) B from shared memory.  Softmax statistics stay in
//   registers, combined over the 4 lanes of a quad; the max is taken on the
//   raw scores, so each probability is one FMA (scale * log2(e) folded in)
//   into one ex2.  That needs scale > 0: the wrapper maps a negative or zero
//   scale onto it exactly (-q, or q * 0 at scale 1).
// - Inside a warpgroup the key loop is pipelined: S_j = Q K_j^T is issued
//   before O += P_{j-1} V_{j-1}, and the softmax of tile j runs on the FP32 and
//   special-function units while the tensor cores finish P_{j-1} V_{j-1}.
// - A producer warpgroup (one thread issuing, the registers of the rest handed
//   to the consumers with setmaxnreg) streams tiles with TMA: Q into 2 slots,
//   K/V in 64-key tiles into a ring of up to 4 stages, each slot and stage with
//   a full and an empty mbarrier, so the loads of later tiles are in flight
//   while tile j is multiplied.  Q is loaded once per work tile.
// - Each K/V tile read from L2 serves as many query rows as the registers
//   allow: two consumer warpgroups of two 64-row blocks each (256 rows) up to
//   D = 80, two of one block (128 rows) up to 128, one (64 rows) above.
// - The grid is persistent: as many CTAs as fit on the card, each walking the
//   work tiles (query tile, batch x head; query tiles of a head fastest, so a
//   head's K/V is shared in L2), so the next tile's Q and K/V load while this
//   one computes and stores; at Sk = 77 that hides the loads behind the math.
// - D is padded in shared memory only.  Each tile is laid out as D_pad / 16
//   panels of 16 values (32-byte rows, 32-byte swizzle), wgmma's canonical
//   layout for K-major and N-major operands alike; a 4-D tensor map (D, H, S, B)
//   with a box of (16, 1, rows, 1) per panel reads the tensor in place, and TMA
//   fills the columns past D and the rows past S with zeros.  D = 72 pads to 80
//   (11% more MMA work than the function's); the wrapper picks the width
//   (32, 64, 80, 128, 192 or 256) at run time from D and passes it in.  Padded
//   key rows are masked to -inf before the max; padded columns add 0 to S and
//   are never written to O.
// - A query tile visits only the key tiles it can see under causal / window.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

using bf16 = __nv_bfloat16;

template <int DP>
struct Cfg {
  static constexpr int NP = DP / 16;                 // 32-byte panels per row
  static constexpr int NWG = DP <= 128 ? 2 : 1;      // consumer warpgroups
  static constexpr int MB = DP <= 80 ? 2 : 1;        // 64-row blocks per warpgroup
  static constexpr int BQ = 64 * MB * NWG;           // query rows per work tile
  static constexpr int BK = 64;                      // keys per K/V tile
  static constexpr int NT = (NWG + 1) * 128;         // + one producer warpgroup
  static constexpr int Q_BYTES = NP * BQ * 32;       // one of 2 Q slots
  static constexpr int KV_BYTES = NP * BK * 32;      // K or V, one stage
  // K/V ring depth: as many stages as fit beside the 2 Q slots, at most 4
  static constexpr int STAGES = (220 * 1024 - 2 * Q_BYTES) / (2 * KV_BYTES) < 4
                                    ? (220 * 1024 - 2 * Q_BYTES) / (2 * KV_BYTES)
                                    : 4;
  static constexpr int BAR_OFF = 2 * Q_BYTES + 2 * STAGES * KV_BYTES;
  // barriers after the tiles, and 1 KB of slack to align the base to 1 KB
  static constexpr int SMEM = BAR_OFF + 8 * (2 * STAGES + 4) + 1024;
};

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box of a 4-D tensor map into shared memory, counted on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 32-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (3ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from touching wgmma operands while the product is in flight
template <int M, int N>
__device__ __forceinline__ void reg_fence(float (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int e = 0; e < N; ++e) asm volatile("" : "+f"(r[i][e])::"memory");
}
template <int M, int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[M][N][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int u = 0; u < N; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][u][e])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ------------------------------------------------------------ wgmma wrappers
// 64 x N x 16, bf16 in, f32 accumulate.  SS: A and B from shared memory, both
// K-major (N = the 64-key tile); `acc` = 0 overwrites d.  RS: A from registers
// (4 x bf16x2 a thread), B from shared memory N-major (transposed).  The operand
// lists are written out in full, as PTX requires.

template <int N> struct SS;
template <int N> struct RS;

template <> struct SS<64> {
  __device__ static void mma(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
  }
};
template <> struct RS<32> {
  __device__ static void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct RS<64> {
  __device__ static void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct RS<80> {
  __device__ static void mma(float (&d)[40], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct RS<128> {
  __device__ static void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
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
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct RS<192> {
  __device__ static void mma(float (&d)[96], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95"
        "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct RS<256> {
  __device__ static void mma(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// ------------------------------------------------------------------- kernel

// A work tile is one query tile of one (batch, head): BQ rows, the key tiles
// it can see.
struct Tile {
  int b, h, hk, q0, t0, n_kv;
};

template <int DP>
__device__ __forceinline__ Tile make_tile(int tile, int n_qt, int Sk, int H, int Hkv, int causal,
                                          int window) {
  using C = Cfg<DP>;
  Tile t;
  const int bh = tile / n_qt;
  t.q0 = (tile - bh * n_qt) * C::BQ;
  t.b = bh / H;
  t.h = bh - t.b * H;
  t.hk = t.h / (H / Hkv);
  int k_lo = 0, k_hi = Sk;   // the keys rows q0 .. q0 + BQ - 1 can see
  if (causal) {
    k_hi = min(Sk, t.q0 + C::BQ);
    if (window > 0) k_lo = max(0, t.q0 - window + 1);
  }
  t.t0 = k_lo / C::BK;
  t.n_kv = max(0, (k_hi - t.t0 * C::BK + C::BK - 1) / C::BK);
  return t;
}

// S = Q K^T for one K tile: D_pad / 16 steps of 64 x BK x 16, both K-major
template <int DP>
__device__ __forceinline__ void qk(float (&s_acc)[Cfg<DP>::BK / 2], uint32_t q, uint32_t k) {
  using C = Cfg<DP>;
#pragma unroll
  for (int p = 0; p < C::NP; ++p)
    SS<C::BK>::mma(s_acc, smem_desc(q + p * C::BQ * 32, 16, 256),
                   smem_desc(k + p * C::BK * 32, 16, 256), p > 0);
}

// O += P V for one V tile: BK / 16 steps of 64 x D_pad x 16, P from registers,
// V N-major: 16-column panels BK * 32 bytes apart, 8-key groups 256 bytes apart
template <int DP>
__device__ __forceinline__ void pv(float (&o_acc)[DP / 2], const uint32_t (&pa)[Cfg<DP>::BK / 16][4],
                                   uint32_t v) {
  using C = Cfg<DP>;
#pragma unroll
  for (int u = 0; u < C::BK / 16; ++u)
    RS<DP>::mma(o_acc, pa[u], smem_desc(v + u * 16 * 32, C::BK * 32, 256));
}

// P (f32, in the layout of S's accumulator) to bf16 A fragments in place: the
// accumulator's columns 16u .. 16u + 15 are the A fragment of key step u
template <int N>
__device__ __forceinline__ void to_bf16(const float (&s)[N], uint32_t (&pa)[N / 8][4]) {
#pragma unroll
  for (int e = 0; e < N / 4; ++e) {
    pa[e / 2][(e & 1) * 2] = pack_bf16(s[4 * e], s[4 * e + 1]);
    pa[e / 2][(e & 1) * 2 + 1] = pack_bf16(s[4 * e + 2], s[4 * e + 3]);
  }
}

// The two query rows a consumer thread holds (r and r + 8): their running max
// and denominator share, the online softmax and the output.
template <int DP>
struct Rows {
  static constexpr int BK = Cfg<DP>::BK;
  int r, c;
  float m0, m1, l0, l1;

  __device__ __forceinline__ void init(int row, int col) {
    r = row;
    c = col;
    m0 = m1 = -INFINITY;
    l0 = l1 = 0.f;
  }

  // scores of keys k0 .. k0 + BK - 1 in place to probabilities: keys past Sk
  // (TMA's zero rows) and, causal, keys outside the window to -inf; the max is
  // taken on the raw scores and scaled once, which needs scale_log2 > 0, so
  // each probability is one FMA into one ex2; returns the factors that rescale
  // O's two rows
  __device__ __forceinline__ float2 softmax(float (&s)[BK / 2], float scale_log2, int k0, int Sk,
                                            int causal, int window) {
    if (causal || k0 + BK > Sk) {
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int col = k0 + 8 * (e / 4) + c + (e & 1);
        const int row = r + ((e >> 1) & 1) * 8;
        bool ok = col < Sk;
        if (causal) ok = ok && col <= row && (window <= 0 || col > row - window);
        if (!ok) s[e] = -INFINITY;
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;   // a quad's 4 lanes share a row
#pragma unroll
    for (int e = 0; e < BK / 8; ++e) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * e], s[4 * e + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * e + 2], s[4 * e + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float n0 = fmaxf(m0, mx0 * scale_log2), n1 = fmaxf(m1, mx1 * scale_log2);
    const float u0 = n0 == -INFINITY ? 0.f : n0;   // every key masked so far
    const float u1 = n1 == -INFINITY ? 0.f : n1;
    const float2 a = make_float2(ex2(m0 - u0), ex2(m1 - u1));
    m0 = n0;
    m1 = n1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int e = 0; e < BK / 8; ++e) {
      s[4 * e] = ex2(fmaf(s[4 * e], scale_log2, -u0));
      s[4 * e + 1] = ex2(fmaf(s[4 * e + 1], scale_log2, -u0));
      s[4 * e + 2] = ex2(fmaf(s[4 * e + 2], scale_log2, -u1));
      s[4 * e + 3] = ex2(fmaf(s[4 * e + 3], scale_log2, -u1));
      rs0 += s[4 * e] + s[4 * e + 1];
      rs1 += s[4 * e + 2] + s[4 * e + 3];
    }
    l0 = l0 * a.x + rs0;   // this lane's share; summed over the quad in store()
    l1 = l1 * a.y + rs1;
    return a;
  }

  __device__ __forceinline__ void rescale(float (&o)[DP / 2], float2 a) const {
#pragma unroll
    for (int e = 0; e < DP / 8; ++e) {
      o[4 * e] *= a.x;
      o[4 * e + 1] *= a.x;
      o[4 * e + 2] *= a.y;
      o[4 * e + 3] *= a.y;
    }
  }

  // O / l to (B, Sq, H, D) bf16: rows past Sq and columns past D are not written
  __device__ __forceinline__ void store(const float (&o)[DP / 2], bf16* out, const Tile& t, int Sq,
                                        int H, int D) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float i0 = l0 > 0.f ? 1.f / l0 : 0.f, i1 = l1 > 0.f ? 1.f / l1 : 0.f;
    const long long pitch = (long long)H * D;   // between sequence positions
    bf16* o0 = out + ((long long)t.b * Sq + r) * pitch + (long long)t.h * D;
    bf16* o1 = o0 + 8 * pitch;
#pragma unroll
    for (int e = 0; e < DP / 8; ++e) {
      const int col = 8 * e + c;   // D is a multiple of 8: col < D covers col + 1
      if (col < D) {
        if (r < Sq)
          *reinterpret_cast<__nv_bfloat162*>(o0 + col) =
              __floats2bfloat162_rn(o[4 * e] * i0, o[4 * e + 1] * i0);
        if (r + 8 < Sq)
          *reinterpret_cast<__nv_bfloat162*>(o1 + col) =
              __floats2bfloat162_rn(o[4 * e + 2] * i1, o[4 * e + 3] * i1);
      }
    }
  }
};

template <int DP>
__global__ void __launch_bounds__(Cfg<DP>::NT, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, int n_tiles,
                  int n_qt, int Sq, int Sk, int H, int Hkv, int D, float scale_log2, int causal,
                  int window) {
  using C = Cfg<DP>;
  constexpr int BQ = C::BQ, BK = C::BK, NP = C::NP, ST = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  // 32-byte swizzle repeats every 256 bytes of shared address: align tiles to 1 KB
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;   // slot i: sQ + i * Q_BYTES
  const uint32_t sK = sQ + 2 * C::Q_BYTES;                       // stage s: sK + s * KV_BYTES
  const uint32_t sV = sK + ST * C::KV_BYTES;
  const uint32_t kv_full = sQ + C::BAR_OFF;   // ST barriers: K/V tile landed
  const uint32_t kv_empty = kv_full + 8 * ST; // ST barriers: K/V tile consumed
  const uint32_t q_full = kv_empty + 8 * ST;  // 2 barriers: Q tile landed
  const uint32_t q_empty = q_full + 16;       // 2 barriers: Q tile consumed

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(kv_full + 8 * s, 1);
      mbar_init(kv_empty + 8 * s, C::NWG * 4);   // one arrival per consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(q_full + 8 * s, 1);
      mbar_init(q_empty + 8 * s, C::NWG * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= C::NWG * 4) {
    // producer warpgroup: one thread streams each work tile's Q, then its K/V
    // tiles through the ring; the next tile's loads overlap this one's math
    // two consumer warpgroups take the registers the producer does not need
    if constexpr (C::NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == C::NWG * 128) {
      int kv = 0;   // K/V tiles issued so far
      for (int i = 0, tile = blockIdx.x; tile < n_tiles; ++i, tile += gridDim.x) {
        const Tile t = make_tile<DP>(tile, n_qt, Sk, H, Hkv, causal, window);
        const int qs = i & 1;
        if (i >= 2) mbar_wait(q_empty + 8 * qs, ((i >> 1) - 1) & 1);
        mbar_expect_tx(q_full + 8 * qs, C::Q_BYTES);
#pragma unroll
        for (int p = 0; p < NP; ++p)
          tma_load(sQ + qs * C::Q_BYTES + p * BQ * 32, &tq, q_full + 8 * qs, 16 * p, t.h, t.q0,
                   t.b);
        for (int j = 0; j < t.n_kv; ++j, ++kv) {
          const int s = kv % ST;
          if (kv >= ST) mbar_wait(kv_empty + 8 * s, ((kv / ST) - 1) & 1);
          const uint32_t full = kv_full + 8 * s;
          mbar_expect_tx(full, 2 * C::KV_BYTES);
          const int k0 = (t.t0 + j) * BK;
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            tma_load(sK + s * C::KV_BYTES + p * BK * 32, &tk, full, 16 * p, t.hk, k0, t.b);
            tma_load(sV + s * C::KV_BYTES + p * BK * 32, &tv, full, 16 * p, t.hk, k0, t.b);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns MB blocks of 64 query rows of a tile; in
  // each, this thread holds rows r and r + 8 and, in each 8-column block,
  // columns c and c + 1
  if constexpr (C::NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  constexpr int MB = C::MB;
  const int wg = warp >> 2;
  const int c = (lane & 3) * 2;
  float o_acc[MB][DP / 2], s_acc[MB][BK / 2];
  uint32_t pa[MB][BK / 16][4];   // P as wgmma's A fragments, one set per 16 keys
  Rows<DP> rows[MB];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) s_acc[mb][e] = 0.f;
  int kv = 0;   // K/V tiles consumed so far
  for (int i = 0, tile = blockIdx.x; tile < n_tiles; ++i, tile += gridDim.x) {
    const Tile t = make_tile<DP>(tile, n_qt, Sk, H, Hkv, causal, window);
    const int qs = i & 1;
    const uint32_t q_wg = sQ + qs * C::Q_BYTES + wg * MB * 64 * 32;
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      rows[mb].init(t.q0 + (wg * MB + mb) * 64 + (warp & 3) * 16 + (lane >> 2), c);
#pragma unroll
      for (int e = 0; e < DP / 2; ++e) o_acc[mb][e] = 0.f;
    }
    mbar_wait(q_full + 8 * qs, (i >> 1) & 1);
    if (t.n_kv > 0) {
      // key tile 0: S_0 = Q K_0^T, its softmax
      int s = kv % ST;
      mbar_wait(kv_full + 8 * s, (kv / ST) & 1);
      reg_fence(s_acc);
      wg_fence();
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) qk<DP>(s_acc[mb], q_wg + mb * 64 * 32, sK + s * C::KV_BYTES);
      wg_commit();
      wg_wait<0>();
      reg_fence(s_acc);
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        rows[mb].softmax(s_acc[mb], scale_log2, t.t0 * BK, Sk, causal, window);
        to_bf16(s_acc[mb], pa[mb]);
      }
      // key tiles 1 ..: S_j = Q K_j^T is issued before O += P_{j-1} V_{j-1},
      // so the softmax of tile j runs while the tensor cores finish tile j - 1
      for (int j = 1; j < t.n_kv; ++j) {
        const int s_prev = s;
        s = (kv + j) % ST;
        mbar_wait(kv_full + 8 * s, ((kv + j) / ST) & 1);
        reg_fence(s_acc);
        reg_fence(o_acc);
        reg_fence(pa);
        wg_fence();
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
          qk<DP>(s_acc[mb], q_wg + mb * 64 * 32, sK + s * C::KV_BYTES);
        wg_commit();
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) pv<DP>(o_acc[mb], pa[mb], sV + s_prev * C::KV_BYTES);
        wg_commit();
        wg_wait<1>();
        reg_fence(s_acc);
        float2 a[MB];
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
          a[mb] = rows[mb].softmax(s_acc[mb], scale_log2, (t.t0 + j) * BK, Sk, causal, window);
        wg_wait<0>();
        reg_fence(o_acc);
        reg_fence(pa);
        if (lane == 0) mbar_arrive(kv_empty + 8 * s_prev);
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          rows[mb].rescale(o_acc[mb], a[mb]);
          to_bf16(s_acc[mb], pa[mb]);
        }
      }
      // O += P V of the last key tile
      reg_fence(o_acc);
      reg_fence(pa);
      wg_fence();
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) pv<DP>(o_acc[mb], pa[mb], sV + s * C::KV_BYTES);
      wg_commit();
      wg_wait<0>();
      reg_fence(o_acc);
      reg_fence(pa);
      if (lane == 0) mbar_arrive(kv_empty + 8 * s);
      kv += t.n_kv;
    }
    if (lane == 0) mbar_arrive(q_empty + 8 * qs);   // Q slot free for tile i + 2
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) rows[mb].store(o_acc[mb], o, t, Sq, H, D);
  }
}

// ------------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: fetched once through the runtime
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// (B, S, heads, D) bf16 read as a 4-D map (D, heads, S, B); one box is one
// 16-column panel of `rows` positions of one head
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, int D, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {16, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int H,
           int Hkv, int D, float scale, int causal, int window, cudaStream_t st) {
  using C = Cfg<DP>;
  auto kern = flash_sm90_kernel<DP>;
  static const cudaError_t opted =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (opted != cudaSuccess) return (int)opted;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, B, Sq, H, D, C::BQ) || !make_map(&mk, k, B, Sk, Hkv, D, C::BK) ||
      !make_map(&mv, v, B, Sk, Hkv, D, C::BK))
    return (int)cudaErrorInvalidValue;
  const int n_qt = (Sq + C::BQ - 1) / C::BQ;
  const long long n_tiles = (long long)n_qt * B * H;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // persistent grid: as many CTAs as fit on the card at once, each walking
  // the work tiles at a stride of the grid, query tiles of a head fastest
  static int per_sm = 0;
  if (!per_sm) {
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, C::NT, C::SMEM);
    if (e != cudaSuccess || per_sm == 0) return (int)(e != cudaSuccess ? e : cudaErrorInvalidConfiguration);
  }
  int dev = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int grid = (int)std::min<long long>(n_tiles, (long long)per_sm * n_sm);
  kern<<<grid, C::NT, C::SMEM, st>>>(mq, mk, mv, static_cast<bf16*>(o), (int)n_tiles, n_qt, Sq,
                                     Sk, H, Hkv, D, scale * 1.4426950408889634f, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of the kernel built for padded width W, in bytes (0: none).
extern "C" int sage_flash_attention_sm90_smem(int W) {
  switch (W) {
    case 32: return Cfg<32>::SMEM;
    case 64: return Cfg<64>::SMEM;
    case 80: return Cfg<80>::SMEM;
    case 128: return Cfg<128>::SMEM;
    case 192: return Cfg<192>::SMEM;
    case 256: return Cfg<256>::SMEM;
  }
  return 0;
}

// q, o: (B, Sq, H, D); k, v: (B, Sk, Hkv, D); contiguous bf16 (dtype 1), 16-byte
// aligned, D a multiple of 8, scale > 0.  W is the width D is padded to in shared
// memory, as kernels/flash_attention/ops.py::route picks it (D <= W); a W that no
// instantiation has is refused.
extern "C" int sage_flash_attention_sm90(const void* q, const void* k, const void* v, void* o,
                                         int B, int Sq, int Sk, int H, int Hkv, int D, int W,
                                         float scale, int causal, int window, int dtype,
                                         void* stream) {
  if (dtype != 1 || B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || D <= 0 ||
      D % 8 || D > W || !(scale > 0.f))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 32: return launch<32>(q, k, v, o, B, Sq, Sk, H, Hkv, D, scale, causal, window, st);
    case 64: return launch<64>(q, k, v, o, B, Sq, Sk, H, Hkv, D, scale, causal, window, st);
    case 80: return launch<80>(q, k, v, o, B, Sq, Sk, H, Hkv, D, scale, causal, window, st);
    case 128: return launch<128>(q, k, v, o, B, Sq, Sk, H, Hkv, D, scale, causal, window, st);
    case 192: return launch<192>(q, k, v, o, B, Sq, Sk, H, Hkv, D, scale, causal, window, st);
    case 256: return launch<256>(q, k, v, o, B, Sq, Sk, H, Hkv, D, scale, causal, window, st);
  }
  return (int)cudaErrorInvalidValue;
}
