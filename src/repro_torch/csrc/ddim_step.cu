// Fused CFG + DDIM sampler update for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ddim_step/ddim_step.py:_kernel,
// launched there by ddim_step_2d (one scalar row for the whole batch) and
// ddim_step_rows (one scalar row per batch element).
//
//   eps = eu + w (ec - eu)
//   z0  = (z - s_t eps) / max(a_t, 1e-6)      clipped to +-clip when clip > 0
//   z'  = a_n z0 + s_n eps
//
// What bounds it: memory.  Per element it reads z, eps_u, eps_c and writes
// z' (16 bytes in f32, 8 in bf16) for about ten flops, far below the
// ~295 flop/byte at which the H100 stops being memory-bound, so the floor is
// bytes / 3.35 TB/s.
//
// What the design does about it: one flat grid-stride pass that touches each
// byte once.  Every thread moves 16 bytes per tensor per iteration (float4,
// or 8 bf16), neighbouring threads on neighbouring addresses, and computes
// in f32.  The TPU's two launch shapes collapse into one kernel: w and clip
// are launch arguments, and a_t, s_t, a_n, s_n are read from four f32
// arrays at index (element / n_per_row) * row_stride, where row_stride 0
// broadcasts one value and 1 gives each batch row its own (the schedule
// gathers are passed as they are, so the launch needs no host-to-device
// copy).
// Nothing is padded to tiles; a latent whose row length is not a multiple of
// the vector width (or a misaligned pointer) takes the one-element-per-thread
// instantiation of the same kernel.  Every operation is rounded on its own
// (__fmul_rn etc., no fused multiply-add), so in f32 the result is
// bit-for-bit the plain PyTorch version's; in bf16 the kernel keeps eps in
// f32 where the plain version rounds it to bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Scalars {
  float w, a_t, s_t, a_n, s_n, clip;
};

struct RowScalars {   // per-row (or broadcast) schedule values, f32 on the device
  const float* a_t;
  const float* s_t;
  const float* a_n;
  const float* s_n;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float ddim(float z, float eu, float ec, const Scalars& s) {
  const float eps = __fadd_rn(eu, __fmul_rn(s.w, __fsub_rn(ec, eu)));
  float z0 = __fdiv_rn(__fsub_rn(z, __fmul_rn(s.s_t, eps)), fmaxf(s.a_t, 1e-6f));
  if (s.clip > 0.f) z0 = fminf(fmaxf(z0, -s.clip), s.clip);
  return __fadd_rn(__fmul_rn(s.a_n, z0), __fmul_rn(s.s_n, eps));
}

// N elements of T per thread per iteration: 16 bytes when N * sizeof(T) == 16
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

template <typename T, int N>
__global__ void __launch_bounds__(256)
ddim_step_kernel(const T* __restrict__ z, const T* __restrict__ eu,
                 const T* __restrict__ ec, T* __restrict__ out, RowScalars rs,
                 float w, float clip, long long n_chunks, long long chunks_per_row,
                 int row_stride) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x; c < n_chunks;
       c += step) {
    const long long r = (c / chunks_per_row) * row_stride;
    const Scalars s{w, __ldg(rs.a_t + r), __ldg(rs.s_t + r), __ldg(rs.a_n + r),
                    __ldg(rs.s_n + r), clip};
    alignas(16) T zv[N];
    alignas(16) T uv[N];
    alignas(16) T cv[N];
    alignas(16) T ov[N];
    load<T, N>(z + c * N, zv);
    load<T, N>(eu + c * N, uv);
    load<T, N>(ec + c * N, cv);
#pragma unroll
    for (int i = 0; i < N; ++i)
      ov[i] = from_f32<T>(ddim(to_f32(zv[i]), to_f32(uv[i]), to_f32(cv[i]), s));
    store<T, N>(out + c * N, ov);
  }
}

template <typename T, int N>
void launch(const void* z, const void* eu, const void* ec, void* out, RowScalars rs,
            float w, float clip, long long n, long long n_per_row, int row_stride,
            cudaStream_t stream) {
  const long long n_chunks = n / N;
  const int threads = 256;
  long long blocks = (n_chunks + threads - 1) / threads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;   // grid-stride beyond 16 waves
  ddim_step_kernel<T, N><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(z), static_cast<const T*>(eu), static_cast<const T*>(ec),
      static_cast<T*>(out), rs, w, clip, n_chunks, n_per_row / N, row_stride);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  a_t, s_t, a_n, s_n: f32 arrays on the device,
// read at (element / n_per_row) * row_stride; row_stride is 0 (one value for
// all elements) or 1 (one value per batch row of n_per_row elements).
extern "C" int sage_ddim_step(const void* z, const void* eu, const void* ec, void* out,
                              const void* a_t, const void* s_t, const void* a_n,
                              const void* s_n, float w, float clip, long long n,
                              long long n_per_row, int row_stride, int dtype,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const RowScalars rs{static_cast<const float*>(a_t), static_cast<const float*>(s_t),
                      static_cast<const float*>(a_n), static_cast<const float*>(s_n)};
  const bool al = aligned16(z) && aligned16(eu) && aligned16(ec) && aligned16(out);
  if (dtype == 0) {
    if (al && n_per_row % 4 == 0 && n % 4 == 0)
      launch<float, 4>(z, eu, ec, out, rs, w, clip, n, n_per_row, row_stride, st);
    else
      launch<float, 1>(z, eu, ec, out, rs, w, clip, n, n_per_row, row_stride, st);
  } else if (dtype == 1) {
    if (al && n_per_row % 8 == 0 && n % 8 == 0)
      launch<__nv_bfloat16, 8>(z, eu, ec, out, rs, w, clip, n, n_per_row, row_stride, st);
    else
      launch<__nv_bfloat16, 1>(z, eu, ec, out, rs, w, clip, n, n_per_row, row_stride, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
