// Fused CFG + DDIM sampler update for Hopper (sm_90a), with the schedule
// gathers folded in.
//
// Replaces the TPU kernel src/repro/kernels/ddim_step/ddim_step.py:_kernel,
// launched there by ddim_step_2d (one scalar row for the whole batch) and
// ddim_step_rows (one scalar row per batch element).
//
//   a_t = alphas[t],  s_t = sigmas[t],  a_n = alphas[t'],  s_n = sigmas[t']
//   eps = eu + w (ec - eu)
//   z0  = (z - s_t eps) / max(a_t, 1e-6)      clipped to +-clip when clip > 0
//   z'  = a_n z0 + s_n eps
//
// What bounds it: memory.  Per element it reads z, eps_u, eps_c and writes
// z' (16 bytes in f32, 8 in bf16) for about ten flops, far below the
// ~295 flop/byte at which the H100 stops being memory-bound, so the floor is
// bytes / 3.35 TB/s: 0.63 us for the branch stack of 8 rows of 64x64x4 f32
// latents.  That lies under the card's own cost of a launch (~1.1 us), so
// the design is about latency: one launch, and one round trip to memory.
//
// What held the first design back: a flat grid-stride loop of 128 x 256
// threads, a 64-bit division per chunk to find its row, and four schedule
// values that PyTorch gathered in four kernels of their own before every
// launch (Schedule.alpha / sigma), where the JAX package's jitted runner
// fuses the gathers into its scalar block.  In a replayed step the update
// was five kernels, and the serving segment built t_prev and the warm-up
// flag, which DDIM never reads, in four more.
//
// What this design does: the kernel takes the schedule's tables (alphas,
// sigmas: f32, (T+1,)) and the step's timesteps t and t' (int64, one for the
// stack or one a row) and gathers a_t, s_t, a_n, s_n itself, so a DDIM
// update is one kernel node.  The wrapper cuts each row into slices of 256
// elements (kernels/_tiles.py: launch_plan), one 16-byte vector a thread, so
// the grid covers the card's 132 SMs at both stacks of the serving path (8
// rows: 512 blocks of 2 warps in f32; the shared phase's 2 trunks: 128).
// The grid is (slices a row, rows): a block reads its row from blockIdx.y,
// so its schedule values are one row's and no division finds the row (the
// row's division and the index math around it put dozens of instructions
// before the first load).  Every thread writes its three 16-byte tile loads
// first in the source, then the row's two-hop gather (t[row], then the
// tables at t), then computes and writes z' with one 16-byte store.  ptxas
// issues the timestep loads first and the tile loads with the table loads,
// once t has arrived (inline PTX loads in source order compile to the same
// SASS), so the gather's two round trips to L2 are the kernel's critical
// path, one more than the first design's: the kernel alone is not faster;
// what the update saves is the kernels around it (PERF.md §6).  A
// misaligned pointer or a row length that is not a multiple of the vector
// takes the one-element instantiation (256 threads), chosen by the
// wrapper's alignment test, never as a fallback on a failure.
//
// Indices: as PyTorch's indexing, a negative t counts from the end of the
// table; a t outside the table, where PyTorch raises, gives NaN rows.
//
// Rounding: every operation is rounded on its own (__fmul_rn etc., no fused
// multiply-add, a correctly rounded division), so in f32 the result is
// bit-for-bit the plain PyTorch version's; in bf16 the kernel keeps eps in
// f32 where the plain version rounds it to bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

struct ScheduleArgs {   // the schedule's tables and the step's timesteps, on the device
  const float* alphas;  // f32, n_table entries
  const float* sigmas;
  const long long* t;       // int64, read at row * t_stride
  const long long* t_next;  // int64, read at row * tn_stride
  long long n_table;
  long long t_stride;
  long long tn_stride;
};

struct Step {           // one row's terms of the update
  float w, s_t, a_div, a_n, s_n, clip;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// an index into a table of n entries as PyTorch takes it (negative from the
// end), or -1 outside the table
__device__ __forceinline__ long long wrap(long long i, long long n) {
  i = i < 0 ? i + n : i;
  return (i >= 0 && i < n) ? i : -1;
}

// the row's schedule values: t[row], then the tables at t (two hops).  An
// index outside the table makes a_n and s_n NaN, so that every element of
// the row is NaN whatever the clip and the max() guard do with a NaN
__device__ __forceinline__ Step gather(const ScheduleArgs& s, unsigned row, float w, float clip) {
  const long long t = wrap(__ldg(s.t + row * s.t_stride), s.n_table);
  const long long tn = wrap(__ldg(s.t_next + row * s.tn_stride), s.n_table);
  const bool ok = t >= 0 && tn >= 0;
  const long long i = ok ? t : 0, in = ok ? tn : 0;
  const float a_t = __ldg(s.alphas + i), s_t = __ldg(s.sigmas + i);
  const float a_n = __ldg(s.alphas + in), s_n = __ldg(s.sigmas + in);
  const float nan = __int_as_float(0x7fc00000);
  return Step{w, s_t, fmaxf(a_t, 1e-6f), ok ? a_n : nan, ok ? s_n : nan, clip};
}

__device__ __forceinline__ float ddim(float z, float eu, float ec, const Step& s) {
  const float eps = __fadd_rn(eu, __fmul_rn(s.w, __fsub_rn(ec, eu)));
  float z0 = __fdiv_rn(__fsub_rn(z, __fmul_rn(s.s_t, eps)), s.a_div);
  if (s.clip > 0.f) z0 = fminf(fmaxf(z0, -s.clip), s.clip);
  return __fadd_rn(__fmul_rn(s.a_n, z0), __fmul_rn(s.s_n, eps));
}

// N elements of T: 16 bytes when N * sizeof(T) == 16
template <typename T, int N>
__device__ __forceinline__ void load(const T* __restrict__ p, T (&r)[N]) {
  if constexpr (N * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(r) = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = p[i];
  }
}

template <typename T, int N>
__device__ __forceinline__ void store(T* __restrict__ p, const T (&r)[N]) {
  if constexpr (N * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(r);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = r[i];
  }
}

// Grid (blocks_per_row, rows): block (j, r) covers the slice [j * blockDim.x
// * N, ...) of row row0 + r, of n_per_row elements (the last slice of a row
// may be shorter), one vector of N elements a thread.  The row comes from
// blockIdx.y, so no division finds it.
template <typename T, int N>
__global__ void __launch_bounds__(kMaxThreads)
ddim_step_kernel(const T* __restrict__ z, const T* __restrict__ eu,
                 const T* __restrict__ ec, T* __restrict__ out, ScheduleArgs sa, float w,
                 float clip, long long n_per_row, unsigned row0) {
  const unsigned row = row0 + blockIdx.y;
  const long long e = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * N;   // in the row
  if (e >= n_per_row) return;
  const long long o = (long long)row * n_per_row + e;
  alignas(16) T zv[N];
  alignas(16) T uv[N];
  alignas(16) T cv[N];
  alignas(16) T ov[N];
  load<T, N>(z + o, zv);                           // the tiles first,
  load<T, N>(eu + o, uv);
  load<T, N>(ec + o, cv);
  const Step s = gather(sa, row, w, clip);         // then the row's schedule
#pragma unroll
  for (int i = 0; i < N; ++i)
    ov[i] = from_f32<T>(ddim(to_f32(zv[i]), to_f32(uv[i]), to_f32(cv[i]), s));
  store<T, N>(out + o, ov);
}

// at most kMaxRows rows a launch (the grid's y limit); more take more launches
constexpr long long kMaxRows = 65535;

template <typename T, int N>
void launch(const void* z, const void* eu, const void* ec, void* out, const ScheduleArgs& sa,
            float w, float clip, long long n_per_row, long long rows,
            long long blocks_per_row, int threads, cudaStream_t stream) {
  for (long long r0 = 0; r0 < rows; r0 += kMaxRows) {
    const dim3 grid((unsigned)blocks_per_row, (unsigned)(rows - r0 < kMaxRows ? rows - r0
                                                                               : kMaxRows));
    ddim_step_kernel<T, N><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(z), static_cast<const T*>(eu), static_cast<const T*>(ec),
        static_cast<T*>(out), sa, w, clip, n_per_row, (unsigned)r0);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  alphas, sigmas: the schedule's f32
// tables of n_table entries on the device; t, t_next: int64 timesteps on the
// device, read at row * t_stride and row * tn_stride (a stride of 0: one
// timestep for every row).  A row is n_per_row elements (n for a broadcast
// launch).  threads and vec (16 bytes' worth of elements, or 1) come from
// kernels/_tiles.py: launch_plan; a block covers a slice of threads * vec
// elements of a row, on a grid of (slices a row, rows), one launch per
// 65535 rows (kernels/ddim_step/ops.py: launches).  A plan the kernel cannot
// take (a vector on a misaligned pointer or row) returns
// cudaErrorInvalidValue.
extern "C" int sage_ddim_step(const void* z, const void* eu, const void* ec, void* out,
                              const void* alphas, const void* sigmas, long long n_table,
                              const void* t, const void* t_next, long long t_stride,
                              long long tn_stride, float w, float clip, long long n,
                              long long n_per_row, int threads, int vec, int dtype,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ScheduleArgs sa{static_cast<const float*>(alphas), static_cast<const float*>(sigmas),
                        static_cast<const long long*>(t), static_cast<const long long*>(t_next),
                        n_table, t_stride, tn_stride};
  const int full = dtype == 0 ? 4 : 8;
  if ((dtype != 0 && dtype != 1) || n_table < 1 || t_stride < 0 || tn_stride < 0 ||
      n_per_row < 1 || n % n_per_row || threads < 32 || threads > kMaxThreads ||
      threads % 32 || (vec != 1 && vec != full))
    return (int)cudaErrorInvalidValue;
  const bool al = aligned16(z) && aligned16(eu) && aligned16(ec) && aligned16(out);
  if (vec == full && !(al && n_per_row % vec == 0)) return (int)cudaErrorInvalidValue;
  const long long slice = (long long)threads * vec;
  const long long blocks_per_row = (n_per_row + slice - 1) / slice;
  const long long rows = n / n_per_row;
  if (blocks_per_row > 0x7fffffffLL || rows > 0xffffffffLL) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
#define SAGE_DDIM_LAUNCH(T, N) \
  launch<T, N>(z, eu, ec, out, sa, w, clip, n_per_row, rows, blocks_per_row, threads, st)
  if (dtype == 0) {
    if (vec == 1)
      SAGE_DDIM_LAUNCH(float, 1);
    else
      SAGE_DDIM_LAUNCH(float, 4);
  } else {
    if (vec == 1)
      SAGE_DDIM_LAUNCH(__nv_bfloat16, 1);
    else
      SAGE_DDIM_LAUNCH(__nv_bfloat16, 8);
  }
#undef SAGE_DDIM_LAUNCH
  return (int)cudaGetLastError();
}
