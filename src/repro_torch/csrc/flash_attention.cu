// Blocked online-softmax attention (FlashAttention-style) on CUDA cores: the
// f32 route.  kernels/flash_attention/ops.py sends every f32 CUDA call here
// (the text tower's causal attention on the serving path) and every bf16 call
// to the tensor-core kernel, flash_attention_sm90.cu; this kernel still takes
// bf16, which chip_smoke.py times beside the sm90 kernel.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py:
// flash_attention_bhsd (body _kernel, window start _k_start).  Same function:
// scores in f32, running max and denominator, keys at or past Sk masked,
// causal, causal sliding window (keys in (row - window, row]), GQA with query
// head h reading K/V head h / (H / Hkv), head_dim D <= 256 at run time.
//
// What bounds it: bytes, at the text tower's shape (77 x 77 tokens, 4 heads of
// 192, causal): 4 * pairs * D flops per head against (2 Sq + 2 Sk) * D * 4
// bytes is ~10 flops a byte, under f32's ridge of 20 (67 TFLOP/s outside the
// tensor cores against 3.35 TB/s).
//
// What this version does about it: it is written to be right, simple and
// free of the TPU's layout, not yet to reach that floor.  One block of 128
// threads owns a 64-row query tile of one (batch, head); it walks the key
// axis in 64-key tiles staged in shared memory as f32 and never writes scores
// to device memory.  Each thread computes a 4 x 8 patch of the score tile
// with f32 FMAs, the softmax statistics of its 4 rows are combined across the
// 8 lanes that share them with warp shuffles, and the probabilities go
// through shared memory into a 4 x ceil(D/8) patch of the output accumulator
// held in registers.  Rows of the shared tiles have an odd pitch (D + 1) so
// the lanes of a warp hit distinct banks.  There is no padding of D to 128
// lanes and no sequential-grid scratch: the key loop runs inside the block,
// and a causal or windowed query tile visits only the key tiles it can see.
// An f32-accurate tensor-core version (3xTF32) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int NT = 128;       // threads per block: 16 row groups x 8 column groups
constexpr int PP = BK + 1;    // pitch of the probability tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// DCH = output columns per thread = ceil(D / 8) rounded up to the instantiation.
template <typename T, int DCH>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                       int H, int Hkv, int D, float scale, int causal, int window) {
  extern __shared__ float smem[];
  const int Dp = D + 1;
  float* sQ = smem;              // BQ x Dp
  float* sK = sQ + BQ * Dp;      // BK x Dp
  float* sV = sK + BK * Dp;      // BK x Dp
  float* sP = sV + BK * Dp;      // BQ x PP

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int rg = tid >> 3;       // rows rg*4 .. rg*4+3 of the tile
  const int cg = tid & 7;        // key columns cg + 8j, output columns cg + 8jj

  // element (b, s, h, d) of a (B, S, H, D) tensor: ((b * S + s) * H + h) * D + d
  const long long q_pitch = (long long)H * D;
  const long long kv_pitch = (long long)Hkv * D;
  const T* qb = q + ((long long)b * Sq * H + h) * D;
  const T* kb = k + ((long long)b * Sk * Hkv + hk) * D;
  const T* vb = v + ((long long)b * Sk * Hkv + hk) * D;
  T* ob = o + ((long long)b * Sq * H + h) * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i - r * D;
    const int s = q0 + r;
    sQ[r * Dp + d] = s < Sq ? to_f32(qb[s * q_pitch + d]) : 0.f;
  }

  float m[4], l[4], acc[4][DCH];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DCH; ++jj) acc[i][jj] = 0.f;
  }

  // key range this query tile can see: rows q0 .. q0+BQ-1
  int k_lo = 0, k_hi = Sk;
  if (causal) {
    k_hi = min(Sk, q0 + BQ);
    if (window > 0) k_lo = max(0, q0 - window + 1);
  }
  k_lo = (k_lo / BK) * BK;

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();   // Q staged / previous tile's K, V, P no longer read
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, d = i - r * D;
      const int s = k0 + r;
      const bool ok = s < Sk;
      sK[r * Dp + d] = ok ? to_f32(kb[s * kv_pitch + d]) : 0.f;
      sV[r * Dp + d] = ok ? to_f32(vb[s * kv_pitch + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(rg * 4 + i) * Dp + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = sK[(cg + 8 * j) * Dp + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + cg + 8 * j;
        bool ok = col < Sk;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && col > row - window;
        sc[i][j] = ok ? sc[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
      // the 8 lanes of a row group are adjacent: reduce over lane bits 0..2
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;   // all masked so far
      const float alpha = expf(m[i] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(sc[i][j] - m_use);
        sP[(rg * 4 + i) * PP + cg + 8 * j] = p;
        rs += p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DCH; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(rg * 4 + i) * PP + c];
#pragma unroll
      for (int jj = 0; jj < DCH; ++jj) {
        const int d = cg + 8 * jj;
        const float vv = d < D ? sV[c * Dp + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= Sq) continue;
    const float den = l[i];
#pragma unroll
    for (int jj = 0; jj < DCH; ++jj) {
      const int d = cg + 8 * jj;
      if (d < D) ob[row * q_pitch + d] = from_f32<T>(den > 0.f ? acc[i][jj] / den : 0.f);
    }
  }
}

template <typename T, int DCH>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
           int H, int Hkv, int D, float scale, int causal, int window, cudaStream_t st) {
  const size_t smem = sizeof(float) * ((size_t)(BQ + 2 * BK) * (D + 1) + (size_t)BQ * PP);
  auto kern = flash_attention_kernel<T, DCH>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + BQ - 1) / BQ));
  kern<<<grid, NT, smem, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                               static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, Hkv,
                               D, scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
             int H, int Hkv, int D, float scale, int causal, int window, cudaStream_t st) {
  if (D <= 32) return launch<T, 4>(q, k, v, o, B, Sq, Sk, H, Hkv, D, scale, causal, window, st);
  if (D <= 64) return launch<T, 8>(q, k, v, o, B, Sq, Sk, H, Hkv, D, scale, causal, window, st);
  if (D <= 96) return launch<T, 12>(q, k, v, o, B, Sq, Sk, H, Hkv, D, scale, causal, window, st);
  if (D <= 128) return launch<T, 16>(q, k, v, o, B, Sq, Sk, H, Hkv, D, scale, causal, window, st);
  if (D <= 192) return launch<T, 24>(q, k, v, o, B, Sq, Sk, H, Hkv, D, scale, causal, window, st);
  if (D <= 256) return launch<T, 32>(q, k, v, o, B, Sq, Sk, H, Hkv, D, scale, causal, window, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, o: (B, Sq, H, D); k, v: (B, Sk, Hkv, D); contiguous.  dtype: 0 = f32, 1 = bf16.
extern "C" int sage_flash_attention(const void* q, const void* k, const void* v, void* o,
                                    int B, int Sq, int Sk, int H, int Hkv, int D,
                                    float scale, int causal, int window, int dtype,
                                    void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || D <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, B, Sq, Sk, H, Hkv, D, scale, causal, window, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, Hkv, D, scale, causal, window,
                                   st);
  return (int)cudaErrorInvalidValue;
}
