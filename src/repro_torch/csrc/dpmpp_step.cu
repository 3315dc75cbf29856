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
// 64x64x4 f32 latents.  At that size the launch itself and one round trip
// to memory are most of the time, so the design is about latency.
//
// What held the first design back: one flat grid-stride pass in which every
// thread rebuilt its row's coefficients (8 row-indexed loads of step
// scalars, expm1f, two correctly rounded divisions with their slow-path
// branches) before it requested its tiles, so the tile loads waited behind
// a dependent round trip and the divisions' branches; and the warm-up flag
// had to be converted to f32 by a PyTorch kernel before every launch.
//
// What this design does: the wrapper cuts the flat range into slices of
// 256 elements that never cross a batch row (kernels/dpmpp_step/ops.py:
// launch_plan), one 16-byte vector a thread, so the grid covers the card's
// 132 SMs at both stacks of the serving path (8 rows: 512 blocks of 2 warps
// in f32; the shared phase's 2 trunks: 128).  A block reads its row and
// slice from blockIdx, so its step scalars are one row's, and the flag is
// read as the caller's bool tensor.  Every thread issues its four 16-byte
// loads of z, eps_u, eps_c and eps_prev into registers before anything
// else, then computes the row's coefficients itself (no barrier at all),
// and writes z' and eps with 16-byte stores.  (TMA bulk copies into shared
// memory on one mbarrier, with the coefficients computed once a block
// while the copies flew, measured slower in every case on the H100: the
// mbarrier's init, a block barrier and one more hop for a kernel that
// moves one vector a thread; PERF.md §6.)  A zero dividend sends a
// correctly rounded division down its slow path, and the history term's
// dividend x0 - x0p is exactly 0 at every warm-up row and wherever both x0
// are clipped to one bound: such a quotient is the zero itself (see
// dpmpp()), and a warm-up row's x0p is its x0 without a second division.
// A misaligned pointer or a row length that is not a multiple of the
// vector takes the one-element instantiation (256 threads), chosen by
// the wrapper's alignment test, never as a fallback on a failure.
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

constexpr int kMaxThreads = 256;

struct StepArrays {   // per-row (or broadcast) step scalars on the device
  const float* a_t;   // f32, read at row * row_stride
  const float* s_t;
  const float* a_n;
  const float* s_n;
  const float* lam;
  const float* lam_p;
  const float* lam_n;
  const bool* first;  // the warm-up flag as the caller's bool tensor, read at
                      // row * first_stride
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

// r, rf: the row's index into the f32 arrays and into the flag
__device__ __forceinline__ Coef coef(const StepArrays& a, long long r, long long rf, float w,
                                     float clip) {
  // every load first, the flag too: a load after a division's slow-path
  // branch would wait for it
  const bool first = __ldg(reinterpret_cast<const unsigned char*>(a.first) + rf) != 0;
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
  c.first = first;
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
  // a warm-up row's history is eps itself, so its x0p is x0, bit for bit
  const float x0p = c.first ? x0 : pred_x0(z, ep, c);
  const float diff = __fsub_rn(x0, x0p);
  // diff / two_r: two_r > 0, so a zero diff is its own quotient, sign and
  // all.  A zero dividend sends the division down its slow path (warm-up
  // rows, and both x0 clipped to one bound), so it divides 1 instead and
  // the zero is selected
  const float q = __fdiv_rn(diff == 0.f ? 1.f : diff, c.two_r);
  const float d = __fadd_rn(x0, diff == 0.f ? diff : q);
  return __fsub_rn(__fmul_rn(c.c_z, z), __fmul_rn(c.c_d, d));
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

// ---------------------------------------------------------------- kernel

// one vector of N elements: z' and the combined eps from the four tiles
template <typename T, int N>
__device__ __forceinline__ void step_vector(const T (&zv)[N], const T (&uv)[N], const T (&cv)[N],
                                            const T (&pv)[N], const Coef& k, T* __restrict__ out,
                                            T* __restrict__ eps_out) {
  alignas(16) T ov[N];
  alignas(16) T evv[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float e;
    ov[i] = from_f32<T>(dpmpp(to_f32(zv[i]), to_f32(uv[i]), to_f32(cv[i]), to_f32(pv[i]), k, e));
    evv[i] = from_f32<T>(e);
  }
  store<T, N>(out, ov);
  store<T, N>(eps_out, evv);
}

// One block per slice of blockDim.x * N elements of one row of n_per_row
// elements (the last slice of a row may be shorter), one vector of N a
// thread; blocks_per_row slices a row.
template <typename T, int N>
__global__ void __launch_bounds__(kMaxThreads)
dpmpp_step_kernel(const T* __restrict__ z, const T* __restrict__ eu,
                  const T* __restrict__ ec, const T* __restrict__ ep,
                  T* __restrict__ out, T* __restrict__ eps_out, StepArrays sa, float w,
                  float clip, long long n_per_row, long long blocks_per_row, int row_stride,
                  int first_stride) {
  const long long slice = (long long)blockDim.x * N;
  const long long row = blockIdx.x / blocks_per_row;
  const long long j = blockIdx.x - row * blocks_per_row;
  const long long start = row * n_per_row + j * slice;
  const int nv = (int)(min(slice, n_per_row - j * slice) / N);   // vectors in the slice
  const long long r = row * row_stride, rf = row * first_stride;
  alignas(16) T zv[N];
  alignas(16) T uv[N];
  alignas(16) T cv[N];
  alignas(16) T pv[N];
  // one pass (blockDim.x vectors in the slice); written as a loop, the
  // block's index math stays in uniform registers, which ran faster
  for (int v = threadIdx.x; v < nv; v += blockDim.x) {
    const long long o = start + (long long)v * N;
    load<T, N>(z + o, zv);                         // the tiles first,
    load<T, N>(eu + o, uv);
    load<T, N>(ec + o, cv);
    load<T, N>(ep + o, pv);
    const Coef k = coef(sa, r, rf, w, clip);       // then the row's terms
    step_vector<T, N>(zv, uv, cv, pv, k, out + o, eps_out + o);
  }
}

template <typename T, int N>
void launch(const void* z, const void* eu, const void* ec, const void* ep, void* out,
            void* eps_out, const StepArrays& sa, float w, float clip, long long n_per_row,
            long long blocks, long long blocks_per_row, int threads, int row_stride,
            int first_stride, cudaStream_t stream) {
  dpmpp_step_kernel<T, N><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(z), static_cast<const T*>(eu), static_cast<const T*>(ec),
      static_cast<const T*>(ep), static_cast<T*>(out), static_cast<T*>(eps_out), sa, w, clip,
      n_per_row, blocks_per_row, row_stride, first_stride);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  scal: 7 pointers to f32 device arrays in
// the order a_t, s_t, a_n, s_n, lam, lam_p, lam_n, each read at
// row * row_stride, then the warm-up flag, a bool device array read at
// row * first_stride; a stride is 0 (one value for all elements) or 1 (one
// value per batch row of n_per_row elements).  The flag is read as the
// caller's bool tensor, so a launch converts nothing.  threads and vec (16
// bytes' worth of elements, or 1) come from kernels/dpmpp_step/ops.py:
// launch_plan; a block covers a slice of threads * vec elements of a row.
// A plan the kernel cannot take (a vector on a misaligned pointer or row)
// returns cudaErrorInvalidValue.
extern "C" int sage_dpmpp_step(const void* z, const void* eu, const void* ec, const void* ep,
                               void* out, void* eps_out, const void* a_t, const void* s_t,
                               const void* a_n, const void* s_n, const void* lam,
                               const void* lam_p, const void* lam_n, const void* first,
                               float w, float clip, long long n, long long n_per_row,
                               int row_stride, int first_stride, int threads, int vec,
                               int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const StepArrays sa{static_cast<const float*>(a_t),   static_cast<const float*>(s_t),
                      static_cast<const float*>(a_n),   static_cast<const float*>(s_n),
                      static_cast<const float*>(lam),   static_cast<const float*>(lam_p),
                      static_cast<const float*>(lam_n), static_cast<const bool*>(first)};
  const int full = dtype == 0 ? 4 : 8;
  if ((dtype != 0 && dtype != 1) || n_per_row < 1 || n % n_per_row || threads < 32 ||
      threads > kMaxThreads || threads % 32 || (vec != 1 && vec != full))
    return (int)cudaErrorInvalidValue;
  const bool al = aligned16(z) && aligned16(eu) && aligned16(ec) && aligned16(ep) &&
                  aligned16(out) && aligned16(eps_out);
  if (vec == full && !(al && n_per_row % vec == 0)) return (int)cudaErrorInvalidValue;
  const long long slice = (long long)threads * vec;
  const long long blocks_per_row = (n_per_row + slice - 1) / slice;
  const long long blocks = n / n_per_row * blocks_per_row;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
#define SAGE_DPMPP_LAUNCH(T, N)                                                          \
  launch<T, N>(z, eu, ec, ep, out, eps_out, sa, w, clip, n_per_row, blocks, blocks_per_row, \
               threads, row_stride, first_stride, st)
  if (dtype == 0) {
    if (vec == 1)
      SAGE_DPMPP_LAUNCH(float, 1);
    else
      SAGE_DPMPP_LAUNCH(float, 4);
  } else {
    if (vec == 1)
      SAGE_DPMPP_LAUNCH(__nv_bfloat16, 1);
    else
      SAGE_DPMPP_LAUNCH(__nv_bfloat16, 8);
  }
#undef SAGE_DPMPP_LAUNCH
  return (int)cudaGetLastError();
}
