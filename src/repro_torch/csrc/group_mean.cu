// Masked group mean over the member axis for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/group_mean/group_mean.py:_kernel,
// launched there by group_mean_knf.
//
//   out[k, f] = sum_n mask[k, n] x[k, n, f] / max(sum_n mask[k, n], 1e-6)
//
// x (K, N, F) in f32 or bf16, mask (K, N) f32, out (K, F) in x's dtype.  On
// the serving path it is the group-mean latent of the shared-uncond CFG
// option: x is the branch stack (K groups x N members of 64x64x4 latents),
// once per branch step.
//
// What bounds it: memory.  It reads x once (N values per output element)
// and writes out once, with one multiply and one add per value read, so the
// floor is bytes / 3.35 TB/s: 0.19 us for x (2, 4, 16384) f32.
//
// What the design does about it: one thread per vector of output elements
// (16 bytes: float4, or 8 bf16), neighbouring threads on neighbouring
// addresses, with a loop over the N members in registers and an f32
// accumulator.  Block (i, k) covers a slice of group k's features, so the
// mask row of group k is read once per block, into shared memory, and its
// count is clamped there.  Unlike the TPU kernel nothing pads F to a block
// width: the ragged edge is masked, and a row length that is not a multiple
// of the vector width (or a misaligned pointer) takes the one-element
// instantiation.  The sums run member by member in order, each product and
// sum rounded on its own, as the plain PyTorch version writes them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxMembers = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int V>
__device__ __forceinline__ void load(const T* __restrict__ p, T (&r)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(r) = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) r[i] = p[i];
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* __restrict__ p, const T (&r)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(r);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = r[i];
  }
}

// grid (ceil(F / V / kThreads), K); F % V == 0
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
group_mean_kernel(const T* __restrict__ x, const float* __restrict__ mask, T* __restrict__ out,
                  int N, long long F) {
  __shared__ float m[kMaxMembers];
  __shared__ float cnt;
  const int k = blockIdx.y;
  if (threadIdx.x < N) m[threadIdx.x] = __ldg(mask + (long long)k * N + threadIdx.x);
  __syncthreads();
  if (threadIdx.x == 0) {
    float c = 0.f;
    for (int n = 0; n < N; ++n) c = __fadd_rn(c, m[n]);
    cnt = fmaxf(c, 1e-6f);
  }
  __syncthreads();
  const long long f = ((long long)blockIdx.x * kThreads + threadIdx.x) * V;
  if (f >= F) return;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  const T* xk = x + (long long)k * N * F + f;
  for (int n = 0; n < N; ++n) {
    alignas(16) T xv[V];
    load<T, V>(xk + (long long)n * F, xv);
    const float w = m[n];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(to_f32(xv[i]), w));
  }
  alignas(16) T ov[V];
#pragma unroll
  for (int i = 0; i < V; ++i) ov[i] = from_f32<T>(__fdiv_rn(acc[i], cnt));
  store<T, V>(out + (long long)k * F + f, ov);
}

template <typename T, int V>
void launch(const void* x, const float* mask, void* out, int K, int N, long long F,
            cudaStream_t stream) {
  const long long vecs = F / V;
  const dim3 grid((unsigned)((vecs + kThreads - 1) / kThreads), (unsigned)K);
  group_mean_kernel<T, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), mask, static_cast<T*>(out), N, F);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x (K, N, F) and out (K, F) contiguous in
// that dtype, mask (K, N) contiguous f32, all on the device; 1 <= N <= 64.
extern "C" int sage_group_mean(const void* x, const void* mask, void* out, int K, int N,
                               long long F, int dtype, void* stream) {
  if (N < 1 || N > kMaxMembers || K < 1 || K > 65535 || F < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  const bool al = aligned16(x) && aligned16(out);
  if (dtype == 0) {
    if (al && F % 4 == 0)
      launch<float, 4>(x, m, out, K, N, F, st);
    else
      launch<float, 1>(x, m, out, K, N, F, st);
  } else if (dtype == 1) {
    if (al && F % 8 == 0)
      launch<__nv_bfloat16, 8>(x, m, out, K, N, F, st);
    else
      launch<__nv_bfloat16, 1>(x, m, out, K, N, F, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
