// Fused CFG + DPM-Solver++(2M) sampler update for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/dpmpp_step/dpmpp_step.py:_kernel,
// launched there by dpmpp_step_2d (one scalar row for the whole batch) and
// dpmpp_step_rows (one scalar row per batch element).
//
//   eps  = eu + w (ec - eu)
//   ep   = first ? eps : eps_prev                     (history warm-up)
//   h    = lam_n - lam,  r = (lam - lam_p) / (|h| > 1e-8 ? h : 1e-8)
//   x0   = (z - s_t eps) / max(a_t, 1e-6),  x0p likewise from ep
//          (both clipped to +-clip when clip > 0)
//   D    = x0 + (x0 - x0p) / (2 max(r, 1e-8))
//   z'   = (s_n / max(s_t, 1e-8)) z - (a_n expm1(-h)) D
//
// It writes z' and eps: the combined eps is the next step's history carry,
// so the solver's history costs no extra pass.
//
// What bounds it: memory.  Per element it reads z, eps_u, eps_c, eps_prev and
// writes z' and eps (24 bytes in f32, 12 in bf16) for about 25 flops, far
// below the ~295 flop/byte at which the H100 stops being memory-bound, so
// the floor is bytes / 3.35 TB/s: 0.94 us for the branch stack of 8 rows of
// 64x64x4 f32 latents.
//
// What the design does about it: one flat grid-stride pass that touches each
// byte once, as csrc/ddim_step.cu does.  Every thread moves 16 bytes per
// tensor per iteration (float4, or 8 bf16), neighbouring threads on
// neighbouring addresses, and computes in f32.  The TPU's two launch shapes
// collapse into one kernel: w and clip are launch arguments, and the eight
// step scalars (a_t, s_t, a_n, s_n, lam, lam_p, lam_n, first) are read from
// f32 device arrays at index (element / n_per_row) * row_stride, where
// row_stride 0 broadcasts one value and 1 gives each batch row its own, so a
// launch needs no host-to-device copy.  A vector of elements never crosses a
// row, so the scalar terms (h, r, the two coefficients) are computed once
// per vector.
//
// The warm-up flag: the TPU kernel multiplies the history term by
// (1 - first), which agrees with the plain version's where(first, eps,
// eps_prev) only while that term is finite.  Here first != 0 selects eps as
// the history, exactly as the plain version does, so the term is an exact 0
// whatever eps_prev holds (zeros after a fork, where lam_p may equal lam).
//
// Rounding: every operation is rounded on its own (__fmul_rn etc., no fused
// multiply-add) in the plain version's order, so in f32 the result follows
// the plain PyTorch version op for op; expm1f is CUDA's, as torch.expm1 on a
// CUDA tensor is.  Both outputs are rounded once to bf16 for bf16 inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct StepArrays {   // per-row (or broadcast) step scalars, f32 on the device
  const float* a_t;
  const float* s_t;
  const float* a_n;
  const float* s_n;
  const float* lam;
  const float* lam_p;
  const float* lam_n;
  const float* first;
};

struct Coef {         // the per-row terms of one update
  float w, s_t, a_div, c_z, c_d, two_r, clip;
  bool first;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ Coef coef(const StepArrays& a, long long r, float w, float clip) {
  const float a_t = __ldg(a.a_t + r), s_t = __ldg(a.s_t + r);
  const float a_n = __ldg(a.a_n + r), s_n = __ldg(a.s_n + r);
  const float lam = __ldg(a.lam + r), lam_p = __ldg(a.lam_p + r);
  const float lam_n = __ldg(a.lam_n + r);
  const float h = __fsub_rn(lam_n, lam);
  const float hs = fabsf(h) > 1e-8f ? h : 1e-8f;
  const float rr = __fdiv_rn(__fsub_rn(lam, lam_p), hs);
  Coef c;
  c.w = w;
  c.s_t = s_t;
  c.a_div = fmaxf(a_t, 1e-6f);                       // divisor of x0
  c.c_z = __fdiv_rn(s_n, fmaxf(s_t, 1e-8f));
  c.c_d = __fmul_rn(a_n, expm1f(-h));
  c.two_r = __fmul_rn(2.f, fmaxf(rr, 1e-8f));
  c.clip = clip;
  c.first = __ldg(a.first + r) != 0.f;
  return c;
}

__device__ __forceinline__ float pred_x0(float z, float e, const Coef& c) {
  float x0 = __fdiv_rn(__fsub_rn(z, __fmul_rn(c.s_t, e)), c.a_div);
  if (c.clip > 0.f) x0 = fminf(fmaxf(x0, -c.clip), c.clip);
  return x0;
}

// one element: returns z', writes the combined eps
__device__ __forceinline__ float dpmpp(float z, float eu, float ec, float ep, const Coef& c,
                                       float& eps) {
  eps = __fadd_rn(eu, __fmul_rn(c.w, __fsub_rn(ec, eu)));
  const float x0 = pred_x0(z, eps, c);
  const float x0p = pred_x0(z, c.first ? eps : ep, c);
  const float d = __fadd_rn(x0, __fdiv_rn(__fsub_rn(x0, x0p), c.two_r));
  return __fsub_rn(__fmul_rn(c.c_z, z), __fmul_rn(c.c_d, d));
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
dpmpp_step_kernel(const T* __restrict__ z, const T* __restrict__ eu,
                  const T* __restrict__ ec, const T* __restrict__ ep,
                  T* __restrict__ out, T* __restrict__ eps_out, StepArrays sa, float w,
                  float clip, long long n_chunks, long long chunks_per_row, int row_stride) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x; c < n_chunks;
       c += step) {
    const Coef k = coef(sa, (c / chunks_per_row) * row_stride, w, clip);
    alignas(16) T zv[N];
    alignas(16) T uv[N];
    alignas(16) T cv[N];
    alignas(16) T pv[N];
    alignas(16) T ov[N];
    alignas(16) T ev[N];
    load<T, N>(z + c * N, zv);
    load<T, N>(eu + c * N, uv);
    load<T, N>(ec + c * N, cv);
    load<T, N>(ep + c * N, pv);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float e;
      ov[i] = from_f32<T>(dpmpp(to_f32(zv[i]), to_f32(uv[i]), to_f32(cv[i]), to_f32(pv[i]),
                                k, e));
      ev[i] = from_f32<T>(e);
    }
    store<T, N>(out + c * N, ov);
    store<T, N>(eps_out + c * N, ev);
  }
}

template <typename T, int N>
void launch(const void* z, const void* eu, const void* ec, const void* ep, void* out,
            void* eps_out, const StepArrays& sa, float w, float clip, long long n,
            long long n_per_row, int row_stride, cudaStream_t stream) {
  const long long n_chunks = n / N;
  const int threads = 256;
  long long blocks = (n_chunks + threads - 1) / threads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;   // grid-stride beyond 16 waves
  dpmpp_step_kernel<T, N><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(z), static_cast<const T*>(eu), static_cast<const T*>(ec),
      static_cast<const T*>(ep), static_cast<T*>(out), static_cast<T*>(eps_out), sa, w, clip,
      n_chunks, n_per_row / N, row_stride);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  scal: 8 pointers to f32 device arrays in
// the order a_t, s_t, a_n, s_n, lam, lam_p, lam_n, first, each read at
// (element / n_per_row) * row_stride; row_stride is 0 (one value for all
// elements) or 1 (one value per batch row of n_per_row elements).
extern "C" int sage_dpmpp_step(const void* z, const void* eu, const void* ec, const void* ep,
                               void* out, void* eps_out, const void* a_t, const void* s_t,
                               const void* a_n, const void* s_n, const void* lam,
                               const void* lam_p, const void* lam_n, const void* first,
                               float w, float clip, long long n, long long n_per_row,
                               int row_stride, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const StepArrays sa{static_cast<const float*>(a_t),   static_cast<const float*>(s_t),
                      static_cast<const float*>(a_n),   static_cast<const float*>(s_n),
                      static_cast<const float*>(lam),   static_cast<const float*>(lam_p),
                      static_cast<const float*>(lam_n), static_cast<const float*>(first)};
  const bool al = aligned16(z) && aligned16(eu) && aligned16(ec) && aligned16(ep) &&
                  aligned16(out) && aligned16(eps_out);
  if (dtype == 0) {
    if (al && n_per_row % 4 == 0 && n % 4 == 0)
      launch<float, 4>(z, eu, ec, ep, out, eps_out, sa, w, clip, n, n_per_row, row_stride, st);
    else
      launch<float, 1>(z, eu, ec, ep, out, eps_out, sa, w, clip, n, n_per_row, row_stride, st);
  } else if (dtype == 1) {
    if (al && n_per_row % 8 == 0 && n % 8 == 0)
      launch<__nv_bfloat16, 8>(z, eu, ec, ep, out, eps_out, sa, w, clip, n, n_per_row,
                               row_stride, st);
    else
      launch<__nv_bfloat16, 1>(z, eu, ec, ep, out, eps_out, sa, w, clip, n, n_per_row,
                               row_stride, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
