// Blocked online-softmax attention (FlashAttention-style) in f32 on Hopper's
// tensor cores, 3xTF32: the f32 route.  kernels/flash_attention/ops.py sends
// every f32 CUDA call here (the text tower's causal attention on the
// serving path) and every bf16 call to flash_attention_sm90.cu.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py:
// flash_attention_bhsd (body _kernel, window start _k_start).  Same function:
// scores in f32, running max and denominator, keys at or past Sk masked,
// causal, causal sliding window (keys in (row - window, row]), GQA with query
// head h reading K/V head h / (H / Hkv), any head_dim D <= 256, any scale.
//
// What bounds it: bytes, at the text tower's shape (8 x 77 x 77, 4 heads of
// 192, causal): q, k, v, o once is 1.9 MB, 0.57 us at 3.35 TB/s, against
// 3 passes of 4 * pairs * D operations at 494.7 TFLOP/s dense TF32, 0.19 us.
// At that size a kernel is bound by its latency: 32 heads of 77 rows.
//
// What the design does about it.  Both products run on the tensor cores as
// 3xTF32 (tf32x3.cuh): each f32 operand is split into two TF32 values and
// three m16n8k8 products are summed in f32, which holds the f32 tolerance
// (plain TF32 misses it ~20x).  P, an f32 value made here, is split again
// before P V.  A row group of 16 query rows walks the key axis in 32-key
// tiles; its score tile (16 x 32) and output (16 x D) stay in registers,
// and S's accumulator is P V's A operand as it lies (keys read in the
// order 2t, 2t + 1).  Where 64-row blocks give two blocks an SM, a block
// is 4 row groups of one warp (the DiT's shapes); else (the text tower) a
// block is 2 row groups of 4 warps that split D: each warp takes a quarter
// of Q K^T's K steps and the group sums the partial scores in shared
// memory, then each takes a quarter of P V's columns.  An mma.sync's
// result is ready long after its issue, so the three passes go to three
// accumulators where the registers allow, and no product runs under a
// branch where D fills the tiles (a branch fences it off from its
// neighbours for the warp's reconvergence).  K/V tiles are double-buffered
// with cp.async (16-byte copies where D % 4 == 0, 4-byte ones otherwise),
// zero-filled past Sk and past D up to the product's K step of 8, and rows
// have a pitch of D + 4 (mod 8) so that the fragments' loads hit 32
// distinct banks.  Padded keys are masked to -inf before the max, causal
// and windowed tiles a row group cannot see are skipped, and a row with no
// visible key writes 0.

#include <math.h>

#include <type_traits>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int BK = 32;          // keys per tile
constexpr int kRed = 16 * 32;   // floats of a warp's partial scores

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

// rows s0 .. s0 + rows - 1 of a (S, D) operand at row stride ld into a
// rows x Dk tile (pitch Dk + 4), zero past S and past D
__device__ __forceinline__ void load_rows(float* dst, int pitch, const float* __restrict__ src,
                                          long long ld, int s0, int S, int rows, int D, int Dk,
                                          bool vec) {
  if (vec) {   // past S: src itself, a valid address that is not read
    load_tile(dst, pitch, s0 < S ? src + (long long)s0 * ld : src, ld, max(0, min(rows, S - s0)),
              rows, D, Dk, true);
    return;
  }
  for (int i = threadIdx.x; i < rows * Dk; i += blockDim.x) {
    const int r = i / Dk, c = i - r * Dk;
    const bool ok = s0 + r < S && c < D;
    cp_async4(dst + r * pitch + c, ok ? src + (long long)(s0 + r) * ld + c : src, ok ? 4 : 0);
  }
}

// DN = output column tiles of 8 (8 DN >= D).  The block's R S warps are R
// row groups of 16 query rows; the S warps of a group split D: warp
// sp takes the K steps sp, sp + S, ... of Q K^T, whose partial scores the
// group sums in shared memory (in a fixed order, so each of its warps holds
// the same S), and the output column tiles sp, sp + S, ... of P V.
template <int DN, int S, int R>
__global__ void __launch_bounds__(32 * R * S)
flash_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk, int H,
                    int Hkv, int D, float scale, int causal, int window, int vec) {
  constexpr int NS = (DN + S - 1) / S;   // output column tiles a warp
  extern __shared__ __align__(16) float smem[];
  const int Dk = (D + 7) & ~7;           // the product's K step
  const int pitch = Dk + 4;
  float* sQ = smem;                      // 16 R x pitch
  float* sK = sQ + 16 * R * pitch;       // 2 stages x BK x pitch
  float* sV = sK + 2 * BK * pitch;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.y * 16 * R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp / S, sp = warp - rg * S;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 16 * rg;           // this warp's first query row

  // element (b, s, h, d) of a (B, S, H, D) tensor: ((b * S + s) * H + h) * D + d
  const long long q_ld = (long long)H * D, kv_ld = (long long)Hkv * D;
  const float* qb = q + ((long long)b * Sq * H + h) * D;
  const float* kb = k + ((long long)b * Sk * Hkv + hk) * D;
  const float* vb = v + ((long long)b * Sk * Hkv + hk) * D;
  float* ob = o + ((long long)b * Sq * H + h) * D;

  // key tiles the block's rows q0 .. q0 + 16 R - 1 can see
  int k_lo = 0, k_hi = Sk;
  if (causal) {
    k_hi = min(Sk, q0 + 16 * R);
    if (window > 0) k_lo = max(0, q0 - window + 1);
  }
  k_lo = (k_lo / BK) * BK;
  const int tiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  load_rows(sQ, pitch, qb, q_ld, q0, Sq, 16 * R, D, Dk, vec);
  if (tiles > 0) {
    load_rows(sK, pitch, kb, kv_ld, k_lo, Sk, BK, D, Dk, vec);
    load_rows(sV, pitch, vb, kv_ld, k_lo, Sk, BK, D, Dk, vec);
  }
  cp_async_commit();

  float acc[NS][4];
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int row[2] = {r0 + g, r0 + g + 8};
  const float* qw = sQ + 16 * rg * pitch;

  for (int it = 0; it < tiles; ++it) {
    const int k0 = k_lo + it * BK;
    const int stage = it & 1;
    if (it + 1 < tiles) {                // prefetch the next tile into the other stage
      load_rows(sK + (stage ^ 1) * BK * pitch, pitch, kb, kv_ld, k0 + BK, Sk, BK, D, Dk, vec);
      load_rows(sV + (stage ^ 1) * BK * pitch, pitch, vb, kv_ld, k0 + BK, Sk, BK, D, Dk, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float* cK = sK + stage * BK * pitch;
    const float* cV = sV + stage * BK * pitch;

    // a row group whose rows are all past Sq, or that sees no key of this
    // tile, skips it (its warps still meet every barrier)
    bool live = r0 < Sq;
    if (causal) {
      live = live && k0 <= r0 + 15;
      if (window > 0) live = live && k0 + BK - 1 > r0 - window;
    }
    float s[BK / 8][4], s3[BK / 8][3][4];   // S, and its three passes
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 0.f;
        s3[j][0][e] = s3[j][1][e] = s3[j][2][e] = 0.f;
      }
    // where D fills the warp's K steps and column tiles (Dk = 8 S NS), the
    // products run under no condition: a product under a branch is fenced
    // off from its neighbours for the warp's reconvergence
    const bool full = Dk == 8 * S * NS;
    if (live) {
      // this warp's K steps of S = Q K^T: 16 x 32, four column tiles of 8 keys
      const auto qk_step = [&](int kk) {
        const float a[4] = {qw[g * pitch + kk + t], qw[(g + 8) * pitch + kk + t],
                            qw[g * pitch + kk + t + 4], qw[(g + 8) * pitch + kk + t + 4]};
        uint32_t ah[4], al[4];
        split4(a, ah, al);
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const float* kr = cK + (8 * j + g) * pitch + kk + t;
          const float bv[2] = {kr[0], kr[4]};
          uint32_t bh[2], bl[2];
          split2(bv, bh, bl);
          mma3x(s3[j], ah, al, bh, bl);
        }
      };
      if (full) {
#pragma unroll
        for (int i = 0; i < NS; ++i) qk_step(8 * (i * S + sp));
      } else {
#pragma unroll 2
        for (int kk = 8 * sp; kk < Dk; kk += 8 * S) qk_step(kk);
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) sum3(s3[j], s[j]);
    }
    if constexpr (S > 1) {
      // sum the group's partial scores in shared memory: in this stage's K
      // tile, which no warp reads any more, where it is large enough, else
      // past the V tiles; warp w's 16 values a lane at red[w][i][lane]
      float* red = BK * pitch >= R * S * kRed ? cK : sV + 2 * BK * pitch;
      __syncthreads();
      if (live) {
#pragma unroll
        for (int i = 0; i < 16; ++i) red[(warp * 16 + i) * 32 + lane] = s[i >> 2][i & 3];
      }
      __syncthreads();
      if (live) {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          float sum = 0.f;
#pragma unroll
          for (int w = 0; w < S; ++w) sum += red[((rg * S + w) * 16 + i) * 32 + lane];
          s[i >> 2][i & 3] = sum;
        }
      }
    }

    if (live) {
      // scale, mask, online softmax: this thread's rows g and g + 8
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = k0 + 8 * j + 2 * t + e;
            bool ok = col < Sk;
            if (causal) ok = ok && col <= row[rr];
            if (window > 0) ok = ok && col > row[rr] - window;
            const float sv = ok ? s[j][2 * rr + e] * scale : -INFINITY;
            s[j][2 * rr + e] = sv;
            mx = fmaxf(mx, sv);
          }
        // the 4 lanes of a row are adjacent: reduce over lane bits 0..1
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[rr], mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;   // all masked so far
        const float alpha = expf(m[rr] - m_use);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = expf(s[j][2 * rr + e] - m_use);
            s[j][2 * rr + e] = p;
            rs += p;
          }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        l[rr] = l[rr] * alpha + rs;
        m[rr] = m_new;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          acc[n][2 * rr] *= alpha;
          acc[n][2 * rr + 1] *= alpha;
        }
      }

      // O += P V on this warp's column tiles: S's accumulator is the A
      // operand, keys 2t and 2t + 1
      // (a few column tiles a warp: each pass into a fresh accumulator of
      // its own, added to O once a tile; many: straight into O)
      constexpr bool kPasses = NS <= 8;
      float o3[kPasses ? NS : 1][3][4];
#pragma unroll
      for (int n = 0; n < (kPasses ? NS : 1); ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o3[n][0][e] = o3[n][1][e] = o3[n][2][e] = 0.f;
      const auto pv = [&](auto full) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const float a[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
          uint32_t ah[4], al[4];
          split4(a, ah, al);
          const float* v0 = cV + (8 * j + 2 * t) * pitch + 8 * sp + g;
#pragma unroll
          for (int n = 0; n < NS; ++n) {
            if (decltype(full)::value || 8 * (n * S + sp) < Dk) {
              const float bv[2] = {v0[8 * S * n], v0[pitch + 8 * S * n]};
              uint32_t bh[2], bl[2];
              split2(bv, bh, bl);
              if constexpr (kPasses)
                mma3x(o3[n], ah, al, bh, bl);
              else
                mma3(acc[n], ah, al, bh, bl);
            }
          }
        }
      };
      if (full)
        pv(std::true_type{});
      else
        pv(std::false_type{});
      if constexpr (kPasses) {
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          float sum[4];
          sum3(o3[n], sum);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] += sum[e];
        }
      }
    }
    __syncthreads();                     // the next prefetch overwrites this stage
  }
  cp_async_wait<0>();                    // with no visible key, Q's copy is still in flight

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (row[rr] >= Sq) continue;
    const float inv = l[rr] > 0.f ? 1.f / l[rr] : 0.f;
    float* orow = ob + (long long)row[rr] * q_ld;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const int d = 8 * (n * S + sp) + 2 * t;
      if (d < D) orow[d] = l[rr] > 0.f ? acc[n][2 * rr] * inv : 0.f;
      if (d + 1 < D) orow[d + 1] = l[rr] > 0.f ? acc[n][2 * rr + 1] * inv : 0.f;
    }
  }
}

size_t smem_bytes(int S, int R, int D) {
  const int pitch = ((D + 7) & ~7) + 4;
  const int red = S > 1 && BK * pitch < R * S * kRed ? R * S * kRed : 0;
  return sizeof(float) * ((size_t)(16 * R + 4 * BK) * pitch + red);
}

// R row groups of S warps a block
template <int DN, int S, int R>
int launch_s(const float* q, const float* k, const float* v, float* o, int B, int Sq, int Sk,
             int H, int Hkv, int D, float scale, int causal, int window, int vec,
             cudaStream_t st) {
  auto kern = flash_tf32x3_kernel<DN, S, R>;
  const size_t smem = smem_bytes(S, R, D);
  static size_t opted_in = 48 * 1024;    // the block's dynamic shared-memory limit
  if (smem > opted_in) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + 16 * R - 1) / (16 * R)));
  kern<<<grid, 32 * R * S, smem, st>>>(q, k, v, o, Sq, Sk, H, Hkv, D, scale, causal, window,
                                       vec);
  return (int)cudaGetLastError();
}

template <int DN>
int launch(const float* q, const float* k, const float* v, float* o, int B, int Sq, int Sk,
           int H, int Hkv, int D, float scale, int causal, int window, cudaStream_t st) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const auto aligned = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const int vec = D % 4 == 0 && aligned(q) && aligned(k) && aligned(v);
  const auto blocks = [&](int rows) { return (long long)B * H * ((Sq + rows - 1) / rows); };
  // 64 query rows a block, a warp each 16, where that gives two blocks for
  // each of the card's SMs; else 32 rows, 4 warps each 16 (the text
  // tower's 8 x 77 rows: 96 blocks of 8 warps; 16 rows a block ran slower,
  // each K/V tile then read by twice as many blocks)
  if (blocks(64) >= 2LL * sms)
    return launch_s<DN, 1, 4>(q, k, v, o, B, Sq, Sk, H, Hkv, D, scale, causal, window, vec, st);
  return launch_s<DN, 4, 2>(q, k, v, o, B, Sq, Sk, H, Hkv, D, scale, causal, window, vec, st);
}

}  // namespace

// q, o: (B, Sq, H, D); k, v: (B, Sk, Hkv, D); contiguous f32 on the device.
// dtype must be 0 (f32): bf16 goes to sage_flash_attention_sm90.
extern "C" int sage_flash_attention(const void* q, const void* k, const void* v, void* o,
                                    int B, int Sq, int Sk, int H, int Hkv, int D,
                                    float scale, int causal, int window, int dtype,
                                    void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || D <= 0 || D > 256 ||
      dtype != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
#define SAGE_FLASH_LAUNCH(DN) \
  launch<DN>(qf, kf, vf, of, B, Sq, Sk, H, Hkv, D, scale, causal, window, st)
  if (D <= 32) return SAGE_FLASH_LAUNCH(4);
  if (D <= 64) return SAGE_FLASH_LAUNCH(8);
  if (D <= 96) return SAGE_FLASH_LAUNCH(12);
  if (D <= 128) return SAGE_FLASH_LAUNCH(16);
  if (D <= 192) return SAGE_FLASH_LAUNCH(24);
  return SAGE_FLASH_LAUNCH(32);
#undef SAGE_FLASH_LAUNCH
}
