// Mamba2 SSD intra-chunk tile for Hopper (sm_90a), on the tensor cores.
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
// (the wrapper pads a ragged tail).  Outputs are f32: y_diag (b, l, h, P),
// in x's layout, and the chunk states (b, chunks, h, P, N).
//
// What bounds it: bytes.  B and C are shared by all heads (n_groups = 1), so
// the function needs C B^T once per (b, c): b c Q(Q+1) N operations on the
// causal pairs, plus G (Q(Q+1) P + 2QPN) for the heads' y and states (G =
// b c h tiles).  At the shared prefill's 384 tiles (Q = N = 128, P = 64)
// that is 1.23 G operations, 7.4 us as three TF32 passes at 494.7 TFLOP/s
// (bf16 inputs: one pass for C B^T, two for the rest, 4.9 us), against 11.6
// us (9.6 in bf16) for its bytes at 3.35 TB/s, each input read once.
//
// What the design does about it.  A block of 8 warps takes kHeads heads of
// one (b, c): it forms C B^T once and applies each head's L to it, and the
// grid (h / kHeads, chunks, batch) still fills the card at b = 1, c = 8
// (128 blocks).  All three products run on the tensor cores (tf32x3.cuh):
// with f32 inputs as 3xTF32; with bf16 inputs, which are TF32 values, C B^T
// in one pass (a bf16 x bf16 product is exact in f32) and S_h x_h and
// x_h^T (decay_h o B) in two, splitting the f32 operand.  An mma.sync's
// result is ready long after its issue, so the design is about keeping
// independent products in flight:
//  - the causal pairs are shared out evenly: each warp takes 9 column tiles
//    of C B^T (a row tile m with 2m + 2 of them pairs with row tile 7 - m),
//    and keeps them in registers for all heads; the warp whose row tile is
//    split adds its partner's part of y after a barrier;
//  - no product runs under a branch (a branch fences it off from its
//    neighbours for the warp's reconvergence): tiles are zero-filled to
//    whole fragments, a unit outside the causal pairs selects zeros, and a
//    warp's second row tile is selected, not branched to;
//  - f32 B and x are split once into hi and lo tiles in shared memory
//    (lo kept exact), so the products load their fragments split;
//  - each K step of C B^T goes to a fresh accumulator and then into the
//    running sum with one rounded add: the tensor core truncates as it
//    accumulates, and 16 steps of that into a running sum moved y past
//    the SSD tolerance at full width.
// S_h, a value made here, is the y product's A operand as it lies (keys
// read in the order 2t, 2t + 1, x's rows in the same order).  Shared memory
// holds B, one head's x (C's raw tile until C B^T is done) and the heads'
// cumsums: 203 KB in f32, 71 KB in bf16.  y is stored straight from
// registers; a warp's state tile (P x 16 of N) too.
//
// The upper triangle is selected, never multiplied: for j > i, cum_i - cum_j
// is positive and large at full width (|cum| reaches thousands), its exp is
// inf, and inf * 0 would be NaN.  Exponents are taken as the reference takes
// them: exp(cum_i - cum_j) from the inclusive cumsum, and the state decay as
// exp(cum[Q-1] - cum_q).  The cumsum runs in f64 and is rounded to f32 once,
// as the plain version's is (an f32 cumsum's last bits depend on the order
// of its additions, and y_diag, a sum of terms far larger than itself,
// carries those bits to 1e-3 at full width); here a warp scans a head's Q
// values with shuffles, four a lane.

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kHeads = 3;      // heads a block
constexpr int kMaxQ = 128;     // 8 warps of 16 rows; cumsum 4 values a lane
constexpr int kMaxP = 128;
constexpr int kMaxN = 128;     // 8 warps of two 8-column state tiles

// shared-memory rows are padded by 4 words (f32) or 8 bf16 values: the
// fragments' loads then hit distinct banks and rows stay 16-byte aligned
template <typename T> __host__ __device__ constexpr int row_pad() { return sizeof(T) == 4 ? 4 : 8; }

// The shared tiles are zero-filled out to 8 PT columns of x and kMaxN of B
// (16 row tiles of 8 columns, two for each warp of the state product), so
// that no product runs under a condition that varies with P or N: a
// product under a branch is fenced off from its neighbours for the warp's
// reconvergence, which serialises the tensor core's latency.
struct Dims {
  int Q, P, N;        // the tile
  int Qp, Pc, Nc;     // rounded up: rows to 16; x columns to 8 PT; B columns to kMaxN
};

__host__ __device__ inline Dims dims(int Q, int P, int N, int PT) {
  return {Q, P, N, (Q + 15) & ~15, 8 * PT, kMaxN};
}

// f32 B and x tiles are kept split (hi and the exact lo), x only for P <=
// 64 (both split at P = 128 would not fit); bf16 ones as they are
template <typename T> constexpr bool kSplitB = sizeof(T) == 4;
template <typename T, int PT> constexpr bool kSplitX = sizeof(T) == 4 && PT <= 8;

// C's raw tile shares x's region: C B^T is done before the first x lands
template <typename T, int PT>
__host__ __device__ inline size_t x_region(const Dims& d) {
  const size_t nb = (size_t)d.Qp * (d.Nc + row_pad<T>()), nx = (size_t)d.Qp * (d.Pc + row_pad<T>());
  const size_t xb = (kSplitX<T, PT> ? 8 : sizeof(T)) * nx, cbytes = sizeof(T) * nb;
  return xb > cbytes ? xb : cbytes;
}

template <typename T, int PT>
__host__ __device__ inline size_t smem_bytes(const Dims& d) {
  const size_t nb = (size_t)d.Qp * (d.Nc + row_pad<T>());
  return (kSplitB<T> ? 8 : sizeof(T)) * nb + x_region<T, PT>(d) +
         sizeof(float) * 2 * kHeads * d.Qp;
}

template <typename T> __device__ __forceinline__ uint32_t bits(T v) {
  return __float_as_uint(to_f32(v));
}

// f32 tile in shared memory as hi (TF32) and the exact remainder lo, in
// place: the raw values were loaded into lo
__device__ __forceinline__ void split_tile(uint32_t* hi, float* lo, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float v = lo[i];
    const uint32_t h = tf32_rna(v);
    hi[i] = h;
    lo[i] = v - __uint_as_float(h);
  }
}

// PT = column tiles of 8 over P for y (8 for P <= 64, 16 up to 128); the
// state takes PT / 2 row tiles of 16 over P
template <typename T, int PT>
__global__ void __launch_bounds__(kThreads)
ssd_tc_kernel(const T* __restrict__ x, const float* __restrict__ dA, const T* __restrict__ Bm,
              const T* __restrict__ Cm, float* __restrict__ y, float* __restrict__ states, int H,
              int Q, int P, int N, int vec_b, int vec_x) {
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Dims d = dims(Q, P, N, PT);
  const int pb = d.Nc + row_pad<T>(), px = d.Pc + row_pad<T>();
  constexpr bool kSB = kSplitB<T>, kSX = kSplitX<T, PT>;
  const int nb = d.Qp * pb, nx = d.Qp * px;
  // B: split as Bh, Bl (f32) or Bs; then x: split as xh, xl or xs; then the
  // cumsums and decays
  uint32_t* Bh = reinterpret_cast<uint32_t*>(smem_raw);
  float* Bl = reinterpret_cast<float*>(Bh + nb);
  T* Bs = reinterpret_cast<T*>(smem_raw);
  unsigned char* after_b = smem_raw + (kSB ? 8 : sizeof(T)) * nb;
  uint32_t* xh = reinterpret_cast<uint32_t*>(after_b);
  float* xl = reinterpret_cast<float*>(xh + nx);
  T* xs = reinterpret_cast<T*>(after_b);
  T* Cs = reinterpret_cast<T*>(after_b);       // C, until the first x lands
  float* cum = reinterpret_cast<float*>(after_b + x_region<T, PT>(d));  // kHeads x Qp
  float* dec = cum + kHeads * d.Qp;             // kHeads x Qp: exp(cum[Q-1] - cum)
  T* Braw = kSB ? reinterpret_cast<T*>(Bl) : Bs;   // where the raw tiles land
  T* xraw = kSX ? reinterpret_cast<T*>(xl) : xs;

  const int h0 = blockIdx.x * kHeads, nh = min(kHeads, H - h0);
  const int c = blockIdx.y, b = blockIdx.z, chunks = gridDim.y;
  const long long t0 = ((long long)b * chunks + c) * Q;      // first token of the chunk
  const long long x_ld = (long long)H * P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  load_tile(Braw, pb, Bm + t0 * N, N, Q, d.Qp, N, d.Nc, vec_b);
  load_tile(Cs, pb, Cm + t0 * N, N, Q, d.Qp, N, d.Nc, vec_b);
  cp_async_commit();

  // each head's cumsum in f64, rounded once: warp w scans head h0 + w
  if (warp < nh) {
    double v[4], run = 0.0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = 4 * lane + e;
      run += q < Q ? (double)dA[(t0 + q) * H + h0 + warp] : 0.0;
      v[e] = run;
    }
    double incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    const double excl = incl - run;
    float cq[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) cq[e] = (float)(excl + v[e]);
    float mine = cq[0];                  // lane (Q - 1) / 4 holds cum[Q - 1]
#pragma unroll
    for (int e = 1; e < 4; ++e)
      if (e == ((Q - 1) & 3)) mine = cq[e];
    const float last = __shfl_sync(0xffffffffu, mine, (Q - 1) >> 2);
    float* cw = cum + warp * d.Qp;
    float* dw = dec + warp * d.Qp;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = 4 * lane + e;
      if (q < d.Qp) {
        cw[q] = q < Q ? cq[e] : last;
        dw[q] = q < Q ? expf(last - cq[e]) : 0.f;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (kSB) {
    split_tile(Bh, Bl, nb);
    __syncthreads();
  }

  // B's fragment at (row r, column cidx) and (r, cidx + off)
  const auto b_frag = [&](int idx, int off, uint32_t (&hi)[2], uint32_t (&lo)[2]) {
    if constexpr (kF32) {
      hi[0] = Bh[idx];
      hi[1] = Bh[idx + off];
      lo[0] = lo_operand(Bl[idx]);
      lo[1] = lo_operand(Bl[idx + off]);
    } else {
      hi[0] = bits(Bs[idx]);
      hi[1] = bits(Bs[idx + off]);
    }
  };
  const auto x_frag = [&](int idx, int off, uint32_t (&hi)[2], uint32_t (&lo)[2]) {
    if constexpr (kSX) {
      hi[0] = xh[idx];
      hi[1] = xh[idx + off];
      lo[0] = lo_operand(xl[idx]);
      lo[1] = lo_operand(xl[idx + off]);
    } else if constexpr (kF32) {
      const float v[2] = {to_f32(xs[idx]), to_f32(xs[idx + off])};
      split2(v, hi, lo);
    } else {
      hi[0] = bits(xs[idx]);
      hi[1] = bits(xs[idx + off]);
    }
  };

  // The causal pairs of the tile lie in column tiles j <= 2m + 1 of row
  // tile m (tiles of 16 rows, 8 columns).  They are shared out evenly:
  // of M row tiles, m and M - 1 - m (m < M / 2) hold 2M + 2 column tiles,
  // M + 1 for each of warps m and M - 1 - m.  Warp m takes row tile m whole
  // and the first M - 1 - 2m column tiles of row tile M - 1 - m; warp
  // M - 1 - m takes the rest of its own row tile (a middle row tile, for M
  // odd, is its own warp's whole).  A warp's unit u is the column tile j of
  // a row tile: (m0, jb0 + u) for u < len0, then (m1, u - len0).
  const int M = d.Qp / 16, mirror = M - 1 - warp;
  const bool shares_out = warp < mirror;       // a second segment, in row tile mirror
  const bool completes = warp < M && warp > mirror;   // adds warp mirror's part
  const int m0 = warp, m1 = mirror;
  const int jb0 = completes ? M - 1 - 2 * mirror : 0;
  const int len0 = warp < M ? 2 * warp + 2 - jb0 : 0;
  const int len1 = shares_out ? M - 1 - 2 * warp : 0;
  constexpr int kUnits = kMaxQ / 16 + 1;
  // C B^T on this warp's units, once for all heads
  float cb[kUnits][4];
#pragma unroll
  for (int u = 0; u < kUnits; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) cb[u][e] = 0.f;
  if (len0 > 0) {
    const auto c_frag = [&](int m, int k, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
      const T* c0 = Cs + (16 * m + g) * pb + k + t;   // zero past Q and N
      const float a[4] = {to_f32(c0[0]), to_f32(c0[8 * pb]), to_f32(c0[4]),
                          to_f32(c0[8 * pb + 4])};
      if constexpr (kF32) {
        split4(a, hi, lo);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) hi[e] = __float_as_uint(a[e]);
      }
    };
#pragma unroll 2
    for (int k = 0; k < d.Nc; k += 8) {
      uint32_t ah0[4] = {}, al0[4] = {}, ah1[4] = {}, al1[4] = {};
      c_frag(m0, k, ah0, al0);
      if (len1 > 0) c_frag(m1, k, ah1, al1);
      // every unit, with no product under a branch: a unit past the warp's
      // last (M < 8) multiplies the zero fragments ah1 with column tile 0
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        const bool first = u < len0;
        const int j = first ? jb0 + u : u < len0 + len1 ? u - len0 : 0;
        uint32_t bh[2], bl[2];
        b_frag((8 * j + g) * pb + k + t, 4, bh, bl);
        uint32_t ah[4], al[4];           // selected, not branched on
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ah[e] = first ? ah0[e] : ah1[e];
          al[e] = first ? al0[e] : al1[e];
        }
        // each K step's product into a fresh accumulator, then one rounded
        // f32 add: the tensor core truncates as it accumulates, and 16
        // steps of that into a running sum missed the SSD tolerance
        float step[4] = {0.f, 0.f, 0.f, 0.f};
        if constexpr (kF32)
          mma3(step, ah, al, bh, bl);
        else
          mma(step, ah, bh);
#pragma unroll
        for (int e = 0; e < 4; ++e) cb[u][e] += step[e];
      }
    }
  }

  __syncthreads();                       // every warp is done with C
  load_tile(xraw, px, x + t0 * x_ld + (long long)h0 * P, x_ld, Q, d.Qp, P, d.Pc, vec_x);
  cp_async_commit();

  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    const float* ch = cum + hh * d.Qp;
    const float* dh = dec + hh * d.Qp;
    cp_async_wait<0>();                  // this head's x, issued after the last head
    __syncthreads();
    if constexpr (kSX) {
      split_tile(xh, xl, nx);
      __syncthreads();
    }

    // y over the warp's units in one pass, with no product under a branch:
    // ya runs over segment 0, is set aside in done at its end (u = len0,
    // an even unit for a warp with two segments) and restarts for segment
    // 1.  S_h = (C B^T) o L_h with the upper triangle selected; a unit past
    // the warp's last (M < 8) selects 0.
    float ya[PT][4], done[PT][4];
#pragma unroll
    for (int n = 0; n < PT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) ya[n][e] = done[n][e] = 0.f;
    if (len0 > 0) {
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        if (u > 0 && u % 2 == 0) {
          const bool cut = u == len0 && len1 > 0;
#pragma unroll
          for (int n = 0; n < PT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              done[n][e] = cut ? ya[n][e] : done[n][e];
              ya[n][e] = cut ? 0.f : ya[n][e];
            }
        }
        const bool first = u < len0, valid = u < len0 + len1;
        const int m = first || !valid ? m0 : m1;
        const int j = first ? jb0 + u : valid ? u - len0 : 0;
        const int i0 = 16 * m + g, i1 = i0 + 8;
        const int j0 = 8 * j + 2 * t, j1 = j0 + 1;
        const float ci0 = ch[i0], ci1 = ch[i1], cj0 = ch[j0], cj1 = ch[j1];
        const float a[4] = {valid && j0 <= i0 ? cb[u][0] * expf(ci0 - cj0) : 0.f,
                            valid && j0 <= i1 ? cb[u][2] * expf(ci1 - cj0) : 0.f,
                            valid && j1 <= i0 ? cb[u][1] * expf(ci0 - cj1) : 0.f,
                            valid && j1 <= i1 ? cb[u][3] * expf(ci1 - cj1) : 0.f};
        uint32_t ah[4], al[4];
        split4(a, ah, al);
#pragma unroll
        for (int n = 0; n < PT; ++n) {
          uint32_t bh[2], bl[2];
          x_frag(j0 * px + 8 * n + g, px, bh, bl);
          if constexpr (kF32)
            mma3(ya[n], ah, al, bh, bl);
          else
            mma2(ya[n], ah, al, bh);
        }
      }
    }
    // v into row tile m of y; with add, onto the part already there
    const auto y_store = [&](const float (&v)[PT][4], int m, bool add) {
      const int i0 = 16 * m + g, i1 = i0 + 8;
      float* y0 = y + (t0 + i0) * x_ld + (long long)h * P;
      float* y1 = y0 + 8 * x_ld;
#pragma unroll
      for (int n = 0; n < PT; ++n) {
        const int p = 8 * n + 2 * t;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (p + e < P) {
            if (i0 < Q) y0[p + e] = add ? y0[p + e] + v[n][e] : v[n][e];
            if (i1 < Q) y1[p + e] = add ? y1[p + e] + v[n][2 + e] : v[n][2 + e];
          }
        }
      }
    };
    if (len0 > 0) {
      if (len1 > 0) {                    // row tile m0 done; m1's part, completed
        y_store(done, m0, false);        // by warp mirror after the barrier
        y_store(ya, m1, false);
      } else if (!completes) {
        y_store(ya, m0, false);
      }
    }

    // state = x^T (decay o B): column tiles 2w, 2w + 1 of N, all row tiles
    // of P; k runs over the chunk's tokens in the order 2t, 2t + 1
    const int nt0 = 2 * warp;
    {
      float sa[PT / 2][2][4];
#pragma unroll
      for (int m = 0; m < PT / 2; ++m)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int f = 0; f < 4; ++f) sa[m][e][f] = 0.f;
#pragma unroll 2
      for (int k = 0; k < d.Qp; k += 8) {
        const int q0 = k + 2 * t, q1 = q0 + 1;
        const float d0 = dh[q0], d1 = dh[q1];
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 8 * (nt0 + e) + g;
          float bv[2];
          if constexpr (kF32) {
            bv[0] = (__uint_as_float(Bh[q0 * pb + n]) + Bl[q0 * pb + n]) * d0;
            bv[1] = (__uint_as_float(Bh[q1 * pb + n]) + Bl[q1 * pb + n]) * d1;
          } else {
            bv[0] = to_f32(Bs[q0 * pb + n]) * d0;
            bv[1] = to_f32(Bs[q1 * pb + n]) * d1;
          }
          split2(bv, bh[e], bl[e]);
        }
#pragma unroll
        for (int m = 0; m < PT / 2; ++m) {
          // A = x^T: (p, q) at x[q][p]
          uint32_t ah[4], al[4];
          const int ia = q0 * px + 16 * m + g;
          if constexpr (kSX) {
            ah[0] = xh[ia];
            ah[1] = xh[ia + 8];
            ah[2] = xh[ia + px];
            ah[3] = xh[ia + px + 8];
            al[0] = lo_operand(xl[ia]);
            al[1] = lo_operand(xl[ia + 8]);
            al[2] = lo_operand(xl[ia + px]);
            al[3] = lo_operand(xl[ia + px + 8]);
          } else if constexpr (kF32) {
            const float v[4] = {to_f32(xs[ia]), to_f32(xs[ia + 8]), to_f32(xs[ia + px]),
                                to_f32(xs[ia + px + 8])};
            split4(v, ah, al);
          } else {
            ah[0] = bits(xs[ia]);
            ah[1] = bits(xs[ia + 8]);
            ah[2] = bits(xs[ia + px]);
            ah[3] = bits(xs[ia + px + 8]);
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if constexpr (kF32)
              mma3(sa[m][e], ah, al, bh[e], bl[e]);
            else
              mma2b(sa[m][e], ah, bh[e], bl[e]);
          }
        }
      }
      float* st = states + (((long long)b * chunks + c) * H + h) * (long long)P * N;
#pragma unroll
      for (int m = 0; m < PT / 2; ++m)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p0 = 16 * m + g, p1 = p0 + 8, n = 8 * (nt0 + e) + 2 * t;
          if (n < N) {                   // N % 4 == 0: n + 1 < N too
            if (p0 < P) {
              st[(long long)p0 * N + n] = sa[m][e][0];
              st[(long long)p0 * N + n + 1] = sa[m][e][1];
            }
            if (p1 < P) {
              st[(long long)p1 * N + n] = sa[m][e][2];
              st[(long long)p1 * N + n + 1] = sa[m][e][3];
            }
          }
        }
    }

    // every warp is done with this head's x, and the parts of y its warps
    // wrote are visible to the block: the warps that complete a row tile add
    // theirs, and the next head's x is issued
    __syncthreads();
    if (completes) y_store(ya, m0, true);
    if (hh + 1 < nh) {
      load_tile(xraw, px, x + t0 * x_ld + (long long)(h + 1) * P, x_ld, Q, d.Qp, P, d.Pc, vec_x);
      cp_async_commit();
    }
  }
}

template <typename T, int PT>
int launch_pt(const void* x, const void* dA, const void* B, const void* C, void* y,
              void* states, int batch, int chunks, int heads, int Q, int P, int N,
              cudaStream_t stream) {
  auto kern = ssd_tc_kernel<T, PT>;
  // raise the block's dynamic shared-memory limit once, to the largest tile
  static bool opted_in = false;
  if (!opted_in) {
    const int most = (int)smem_bytes<T, PT>(dims(kMaxQ, 8 * PT, kMaxN, PT));
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  constexpr int E = 16 / sizeof(T);
  const auto aligned = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const int vec_b = N % E == 0 && aligned(B) && aligned(C);
  const int vec_x = P % E == 0 && aligned(x);
  const Dims d = dims(Q, P, N, PT);
  const dim3 grid((unsigned)((heads + kHeads - 1) / kHeads), (unsigned)chunks, (unsigned)batch);
  kern<<<grid, kThreads, smem_bytes<T, PT>(d), stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dA), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<float*>(y), static_cast<float*>(states), heads, Q, P,
      N, vec_b, vec_x);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* dA, const void* B, const void* C, void* y, void* states,
           int batch, int chunks, int heads, int Q, int P, int N, cudaStream_t stream) {
  if (P <= 64)
    return launch_pt<T, 8>(x, dA, B, C, y, states, batch, chunks, heads, Q, P, N, stream);
  return launch_pt<T, 16>(x, dA, B, C, y, states, batch, chunks, heads, Q, P, N, stream);
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
