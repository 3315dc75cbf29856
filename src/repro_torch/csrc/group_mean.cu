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
// floor is bytes / 3.35 TB/s: 0.19 us for x (2, 4, 16384) f32.  At that size
// the launch and one round trip to memory are most of the time, so the
// design is about latency.
//
// What held the first design back: a grid of 256-thread blocks, 32 blocks
// at the path's shape on a card of 132 SMs; each block loaded the mask row
// into shared memory, waited at a barrier, summed the count in one thread,
// waited at a second barrier, and only then requested x, one member after
// the other in a loop to a runtime N: 2.05 us against a 0.20 us bound.
//
// What this design does (the plan is kernels/group_mean/ops.py:
// launch_plan): block (i, k) covers one slice of group k's features, one
// 16-byte vector (float4, or 8 bf16) a thread, with blocks small enough that
// the grid fills the card (64 threads, 128 blocks at the path's shape).
// Every thread requests all N members of its slice before anything else,
// then reads the N mask values itself (one line of L2) and sums the count:
// no barrier precedes the first load.  N in {1, 2, 4, 8} is a template
// parameter, so each thread's N 16-byte loads into registers are unrolled
// ahead of the adds.  (One TMA bulk copy a member into shared memory on one
// mbarrier, the mask read meanwhile, measured slower in every case on the
// H100: the mbarrier's init, a block barrier and one more hop for a kernel
// that moves one vector a thread; PERF.md §6.)
// Other N (up to 64) and a row length that is not a multiple of the vector
// (or a misaligned pointer, the one-element instantiation) loop over the
// members at run time.  The sums run member by member in order, each
// product and sum rounded on its own, divided by the clamped count, as the
// plain PyTorch version writes them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
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

// acc[i] += x[i] * m, each product and sum rounded on its own
template <typename T, int V>
__device__ __forceinline__ void accumulate(float (&acc)[V], const T (&x)[V], float m) {
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(to_f32(x[i]), m));
}

// grid (ceil(F / V / blockDim.x), K); F % V == 0.  kN > 0: N == kN, the
// member loads unrolled ahead of the adds; kN == 0: any N <= kMaxMembers, a
// loop at run time.
template <typename T, int V, int kN>
__global__ void __launch_bounds__(kMaxThreads)
group_mean_kernel(const T* __restrict__ x, const float* __restrict__ mask, T* __restrict__ out,
                  int N, long long F) {
  const int k = blockIdx.y;
  const long long f = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (f >= F) return;
  const T* xk = x + (long long)k * N * F;
  const float* mk = mask + (long long)k * N;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  float cnt = 0.f;
  if constexpr (kN == 0) {
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      alignas(16) T xv[V];
      load<T, V>(xk + (long long)n * F + f, xv);
      const float m = __ldg(mk + n);
      cnt = __fadd_rn(cnt, m);
      accumulate<T, V>(acc, xv, m);
    }
  } else {
    alignas(16) T xv[kN][V];
#pragma unroll
    for (int n = 0; n < kN; ++n) load<T, V>(xk + (long long)n * F + f, xv[n]);
    float m[kN];
#pragma unroll
    for (int n = 0; n < kN; ++n) m[n] = __ldg(mk + n);
#pragma unroll
    for (int n = 0; n < kN; ++n) cnt = __fadd_rn(cnt, m[n]);
#pragma unroll
    for (int n = 0; n < kN; ++n) accumulate<T, V>(acc, xv[n], m[n]);
  }
  cnt = fmaxf(cnt, 1e-6f);
  alignas(16) T ov[V];
#pragma unroll
  for (int i = 0; i < V; ++i) ov[i] = from_f32<T>(__fdiv_rn(acc[i], cnt));
  store<T, V>(out + (long long)k * F + f, ov);
}

template <typename T, int V, int kN>
void launch(const void* x, const float* mask, void* out, int K, int N, long long F,
            int threads, cudaStream_t stream) {
  const long long vecs = F / V;
  const dim3 grid((unsigned)((vecs + threads - 1) / threads), (unsigned)K);
  group_mean_kernel<T, V, kN><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), mask, static_cast<T*>(out), N, F);
}

// the vector instantiations: N unrolled for 1, 2, 4 and 8, else a loop at
// run time
template <typename T, int V>
void launch_vec(const void* x, const float* m, void* out, int K, int N, long long F,
                int threads, cudaStream_t st) {
  switch (N) {
    case 1: return launch<T, V, 1>(x, m, out, K, N, F, threads, st);
    case 2: return launch<T, V, 2>(x, m, out, K, N, F, threads, st);
    case 4: return launch<T, V, 4>(x, m, out, K, N, F, threads, st);
    case 8: return launch<T, V, 8>(x, m, out, K, N, F, threads, st);
    default: return launch<T, V, 0>(x, m, out, K, N, F, threads, st);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x (K, N, F) and out (K, F) contiguous in
// that dtype, mask (K, N) contiguous f32, all on the device; 1 <= N <= 64.
// threads a block and vec (16 bytes' worth of elements, or 1) come from
// kernels/group_mean/ops.py:launch_plan; the vector path unrolls N of 1, 2,
// 4 and 8.  A plan the kernel cannot take returns cudaErrorInvalidValue.
extern "C" int sage_group_mean(const void* x, const void* mask, void* out, int K, int N,
                               long long F, int threads, int vec, int dtype, void* stream) {
  const int full = dtype == 0 ? 4 : 8;
  if (N < 1 || N > kMaxMembers || K < 1 || K > 65535 || F < 1 || (dtype != 0 && dtype != 1) ||
      threads < 32 || threads > kMaxThreads || threads % 32 || (vec != 1 && vec != full))
    return (int)cudaErrorInvalidValue;
  if (vec == full && !(aligned16(x) && aligned16(out) && F % vec == 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  if (dtype == 0) {
    if (vec == 1)
      launch<float, 1, 0>(x, m, out, K, N, F, threads, st);
    else
      launch_vec<float, 4>(x, m, out, K, N, F, threads, st);
  } else {
    if (vec == 1)
      launch<__nv_bfloat16, 1, 0>(x, m, out, K, N, F, threads, st);
    else
      launch_vec<__nv_bfloat16, 8>(x, m, out, K, N, F, threads, st);
  }
  return (int)cudaGetLastError();
}
