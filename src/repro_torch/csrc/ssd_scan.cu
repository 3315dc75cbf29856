// Mamba2 SSD intra-chunk tile for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/ssd_scan.py:_kernel,
// launched there by ssd_intra_chunk (through kernels/ssd_scan/ops.py:
// ssd_chunked_kernel).  For one (batch b, chunk c, head h) tile of Q tokens:
//
//   cum    = inclusive cumsum of dA over the chunk          (Q)
//   L[i,j] = exp(cum_i - cum_j) for j <= i, else 0          (Q, Q)
//   y_diag = ((C B^T) o L) x                                (Q, P)
//   state  = (x * exp(cum[Q-1] - cum))^T B                  (P, N)
//
// Inputs lie in the model's own layout and are read in place: x (b, l, h, P)
// and B, C (b, l, N) in f32 or bf16, dA (b, l, h) f32, with l = chunks * Q
// (the wrapper pads a ragged tail).  B and C are shared by all heads
// (n_groups = 1): every head's block reads the one (b, c) tile, so nothing
// is copied per head.  Outputs are f32: y_diag (b, l, h, P), in x's layout,
// and the chunk states (b, chunks, h, P, N).
//
// What bounds it: operations.  A tile needs the Q(Q+1)/2 causal pairs of S
// and y, Q(Q+1)(N + P) operations, plus 2QPN for the state: 5.3 M on
// 2QN + QP + Q values (Q = N = 128, P = 64).  At the shared prefill's 384
// tiles that is 2.0 GFLOP, 30 us at 67 TFLOP/s f32 on CUDA cores, against
// 12 us for its bytes at 3.35 TB/s (each input read once).
//
// What the design does about it, simply: one block of 256 threads per tile,
// all in f32 FMA on CUDA cores (tensor cores are later work).  The B and x
// tiles and the cumulative sum stay in shared memory (130 KB at the path's
// shape, dynamic shared memory); the (Q, Q) score matrix is never formed
// whole: S is computed in strips of 32 rows, each strip's C rows loaded
// beside it, and multiplied into y before the next strip.  Column blocks of
// 32 that lie wholly above a strip's diagonal are not read, which saves 3/8
// of the S loads and the y work.  Each thread keeps a 4 x 4 (S), 8 x 1 (y,
// P <= 64) or 16 x 4 (state) register tile of outputs.  The S loop reads C
// and B four values at a time (16-byte loads); B rows are padded to N + 4
// floats, so that 8 lanes reading 8 rows cover the 32 banks once.  Every
// output is summed in the plain version's order (n, j or q ascending).
//
// The upper triangle is selected, never multiplied: for j > i, cum_i - cum_j
// is positive and large at full width (|cum| reaches thousands), its exp is
// inf, and inf * 0 would be NaN.  Exponents are taken as the reference takes
// them: exp(cum_i - cum_j) from the inclusive cumsum, and the state decay as
// exp(cum[Q-1] - cum_q).  The cumsum runs in f64 and is rounded to f32 once,
// as the plain version's is: an f32 cumsum's last bits depend on the order of
// its additions, and y_diag, a sum of terms far larger than itself, carries
// those bits to 1e-3 at full width; the f64 sum rounds to the same f32 in any
// order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 128;
constexpr int kMaxP = 128;
constexpr int kMaxN = 128;
constexpr int kStrip = 32;   // rows of S computed at a time
constexpr int kLoads = 8;    // global loads in flight per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__host__ __device__ constexpr size_t smem_floats(int Q, int P, int N) {
  return (size_t)Q * (N + 4)     // B tile, rows padded to N + 4
         + (size_t)kStrip * N    // C rows of the strip
         + (size_t)kStrip * Q    // S strip
         + (size_t)Q * P         // x tile (later scaled by the state decay)
         + (size_t)Q;            // cumsum of dA
}

// rows x cols values, (r, c) at src[r * src_stride + c], into shared memory
// at dst[r * dst_stride + c] as f32; each thread keeps kLoads loads in
// flight before it stores them
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int dst_stride, const T* __restrict__ src,
                                          long long src_stride, int rows, int cols) {
  const int total = rows * cols;
  for (int e0 = threadIdx.x; e0 < total; e0 += kThreads * kLoads) {
    float v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * kThreads;
      const int r = e / cols, c = e - r * cols;
      v[u] = e < total ? to_f32(src[r * src_stride + c]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * kThreads;
      const int r = e / cols, c = e - r * cols;
      if (e < total) dst[r * dst_stride + c] = v[u];
    }
  }
}

// y rows of one strip: y[r, p] = sum_{j < jend} S[r, j] x[j, p]; 64 column
// lanes (p) x 4 row lanes, 8 x KP outputs a thread; yb points at y of the
// strip's first row and this head
template <int KP>
__device__ __forceinline__ void y_strip(const float* xs, const float* Ss, float* yb, int H,
                                        int Q, int P, int rows, int jend, int lp, int lq) {
  float ya[8][KP];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int k = 0; k < KP; ++k) ya[m][k] = 0.f;
  int sr[8], pc[KP];
#pragma unroll
  for (int m = 0; m < 8; ++m) sr[m] = min(lq + 4 * m, rows - 1) * Q;
#pragma unroll
  for (int k = 0; k < KP; ++k) pc[k] = min(lp + 64 * k, P - 1);
#pragma unroll 4
  for (int j = 0; j < jend; ++j) {
    float xv[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) xv[k] = xs[j * P + pc[k]];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const float s = Ss[sr[m] + j];
#pragma unroll
      for (int k = 0; k < KP; ++k) ya[m][k] = fmaf(s, xv[k], ya[m][k]);
    }
  }
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int r = lq + 4 * m;
    if (r >= rows) continue;
#pragma unroll
    for (int k = 0; k < KP; ++k)
      if (lp + 64 * k < P) yb[(long long)r * H * P + lp + 64 * k] = ya[m][k];
  }
}

// grid (heads, chunks, batch), kThreads threads, smem_floats(Q, P, N) floats
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_intra_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dA,
                       const T* __restrict__ Bm, const T* __restrict__ Cm,
                       float* __restrict__ y, float* __restrict__ states, int H, int Q,
                       int P, int N) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int NB = N + 4;           // N % 4 == 0: B and C rows are float4-aligned
  float* Bs = smem;
  float* Cs = Bs + Q * NB;
  float* Ss = Cs + kStrip * N;
  float* xs = Ss + kStrip * Q;
  float* cum = xs + Q * P;
  const int tid = threadIdx.x;
  const long long L = (long long)gridDim.y * Q;
  const long long t0 = (long long)b * L + (long long)c * Q;  // first token of the chunk

  load_tile(Bs, NB, Bm + t0 * N, N, Q, N);
  load_tile(xs, P, x + t0 * H * P + (long long)h * P, (long long)H * P, Q, P);
  if (tid < Q) cum[tid] = dA[(t0 + tid) * H + h];
  __syncthreads();
  if (tid == 0) {                 // inclusive cumsum in f64, rounded once
    double s = 0.0;
    for (int q = 0; q < Q; ++q) {
      s += (double)cum[q];
      cum[q] = (float)s;
    }
  }
  __syncthreads();

  // S strip: 32 column lanes x 8 row lanes, 4 x 4 outputs a thread
  const int lj = tid & 31, lr = tid >> 5;
  // y strip: 64 column lanes (p) x 4 row lanes
  const int lp = tid & 63, lq = tid >> 6;
  const int kps = (P + 63) / 64;

  for (int i0 = 0; i0 < Q; i0 += kStrip) {
    const int rows = min(kStrip, Q - i0);
    const int jend = i0 + rows;               // only columns j < jend are visible
    const int kjs = (jend + 31) / 32;         // column blocks at or below the diagonal
    load_tile(Cs, N, Cm + (t0 + i0) * N, N, rows, N);
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[m][k] = 0.f;
    int rc[4], jc[4];             // clamped rows / columns: always a valid read
#pragma unroll
    for (int m = 0; m < 4; ++m) rc[m] = min(lr + 8 * m, rows - 1) * N;
#pragma unroll
    for (int k = 0; k < 4; ++k) jc[k] = min(lj + 32 * k, Q - 1) * NB;
#pragma unroll 2
    for (int n = 0; n < N; n += 4) {   // four n at a time: 16-byte loads
      float4 cv[4], bv[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) cv[m] = *reinterpret_cast<const float4*>(Cs + rc[m] + n);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        bv[k] = k < kjs ? *reinterpret_cast<const float4*>(Bs + jc[k] + n)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float a = fmaf(cv[m].x, bv[k].x, acc[m][k]);
          a = fmaf(cv[m].y, bv[k].y, a);
          a = fmaf(cv[m].z, bv[k].z, a);
          acc[m][k] = fmaf(cv[m].w, bv[k].w, a);
        }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int r = lr + 8 * m;
      if (r >= rows) continue;
      const int i = i0 + r;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = lj + 32 * k;
        if (j >= jend) continue;
        // select: exp of the upper triangle's segment sum may be inf
        Ss[r * Q + j] = j <= i ? acc[m][k] * expf(cum[i] - cum[j]) : 0.f;
      }
    }
    __syncthreads();

    if (kps > 1)
      y_strip<2>(xs, Ss, y + (t0 + i0) * H * P + h * P, H, Q, P, rows, jend, lp, lq);
    else
      y_strip<1>(xs, Ss, y + (t0 + i0) * H * P + h * P, H, Q, P, rows, jend, lp, lq);
    __syncthreads();              // the next strip overwrites Cs and Ss
  }

  // chunk state: x rows scaled by their decay to the chunk's end, then x^T B
  const float last = cum[Q - 1];
  for (int e = tid; e < Q * P; e += kThreads) {
    const int q = e / P;
    xs[e] = xs[e] * expf(last - cum[q]);
  }
  __syncthreads();
  // 32 column lanes (n) x 8 row lanes (p), up to 16 x 4 outputs a thread
  const int ln = tid & 31, lpp = tid >> 5;
  const int mps = (P + 7) / 8, kns = (N + 31) / 32;
  float sa[16][4];
#pragma unroll
  for (int m = 0; m < 16; ++m)
#pragma unroll
    for (int k = 0; k < 4; ++k) sa[m][k] = 0.f;
  int pc[16], nc[4];
#pragma unroll
  for (int m = 0; m < 16; ++m) pc[m] = min(lpp + 8 * m, P - 1);
#pragma unroll
  for (int k = 0; k < 4; ++k) nc[k] = min(ln + 32 * k, N - 1);
#pragma unroll 4
  for (int q = 0; q < Q; ++q) {
    float bv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) bv[k] = k < kns ? Bs[q * NB + nc[k]] : 0.f;
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      if (m >= mps) break;
      const float xv = xs[q * P + pc[m]];
#pragma unroll
      for (int k = 0; k < 4; ++k) sa[m][k] = fmaf(xv, bv[k], sa[m][k]);
    }
  }
  float* st = states + (((long long)b * gridDim.y + c) * H + h) * (long long)P * N;
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const int p = lpp + 8 * m;
    if (p >= P) break;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int n = ln + 32 * k;
      if (n < N) st[(long long)p * N + n] = sa[m][k];
    }
  }
}

template <typename T>
int launch(const void* x, const void* dA, const void* B, const void* C, void* y, void* states,
           int batch, int chunks, int heads, int Q, int P, int N, cudaStream_t stream) {
  // raise the block's dynamic shared-memory limit once, to the largest tile
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_intra_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(smem_floats(kMaxQ, kMaxP, kMaxN) * sizeof(float)));
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const size_t bytes = smem_floats(Q, P, N) * sizeof(float);
  ssd_intra_chunk_kernel<T><<<dim3(heads, chunks, batch), kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dA), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<float*>(y), static_cast<float*>(states), heads, Q,
      P, N);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of x, B and C): 0 = float32, 1 = bfloat16.  x (batch, chunks*Q,
// heads, P), B and C (batch, chunks*Q, N) contiguous in that dtype; dA
// (batch, chunks*Q, heads) contiguous f32; y (batch, chunks*Q, heads, P) and
// states (batch, chunks, heads, P, N) contiguous f32; all on the device.
// Q <= 128, P <= 128, N <= 128 with N % 4 == 0.
extern "C" int sage_ssd_intra_chunk(const void* x, const void* dA, const void* B, const void* C,
                                    void* y, void* states, int batch, int chunks, int heads,
                                    int Q, int P, int N, int dtype, void* stream) {
  if (batch < 1 || batch > 65535 || chunks < 1 || chunks > 65535 || heads < 1 || Q < 1 ||
      Q > kMaxQ || P < 1 || P > kMaxP || N < 4 || N > kMaxN || N % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dA, B, C, y, states, batch, chunks, heads, Q, P, N, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dA, B, C, y, states, batch, chunks, heads, Q, P, N, st);
  return (int)cudaErrorInvalidValue;
}
