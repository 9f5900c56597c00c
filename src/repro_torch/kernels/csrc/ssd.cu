// Mamba-2 SSD scan (scalar-identity state space), forward: a chunked
// kernel on the tensor cores for prefill and a streaming kernel for a
// decode step.
//
// Replaces repro/kernels/ssd.py::ssd_pallas (_ssd_kernel, the pl.pallas_call
// at ssd.py:61).  Per (batch, head) and chunk of Q = 64 rows, with the log
// decay a_t = dt_t * A and cum its inclusive cumsum over the chunk:
//   y_t   = e^{cum_t} C_t . h0  +  sum_{s <= t} (C_t . B_s) e^{cum_t - cum_s} dt_s x_s  +  D x_t
//   h_end = e^{cum_end} h0  +  sum_s e^{cum_end - cum_s} dt_s x_s (x) B_s
// The TPU kernel walks the chunks as a sequential grid axis with the (P, N)
// state in VMEM scratch.  Blocks on Hopper run in no order, so one block
// owns one (batch, head) and loops over its chunks with the fp32 state in
// shared memory.
//
// Inputs: x (B, S, H, P) and B, C (B, S, G, N), any G that divides H (head h
// reads group h / (H / G)), given as base pointers with batch and position
// strides, so x, B and C may be views of the Mamba2 block's conv output
// (B, S, H P + 2 G N) with no copy.  Heads (groups) are packed and the last
// dim is contiguous; fp32 rows are 16-byte aligned (cp.async).
//
// Bound on the H100, prefill (zamba2-7b: B = 8, S = 512, H = 112, G = 1,
// P = N = 64): 11.5 GFLOP of fp32 work against 253.5 MB moved.  The four
// chunk products run on the TF32 tensor cores (mma.sync.m16n8k8) in the
// 3xTF32 split of common.cuh (big = x rounded to TF32, small = x − big passed
// raw; big·big + big·small + small·big), as accurate as fp32: one TF32
// product per chunk product errs by about 8e-4 of max|y| against the 1e-3
// bound, the split by about 1e-6.  At 495 / 3 TFLOP/s that is 0.070 ms, the
// bytes 0.076 ms: the two bounds are close.  What limits the kernel is the
// work around the MMAs (the splits, shared-memory loads and addresses), so
// the design keeps that small:
//   * four warps; warp w owns rows 16w .. 16w + 15 of the chunk for
//     y = (C h0ᵀ) e^{cum} + G x + D x, G = C Bᵀ decayed and masked.  Its
//     rows of C are split once per chunk and kept in registers as the A
//     fragments of both C·h0ᵀ and C·Bᵀ;
//   * the causal s-tiles (2w + 2 of the 8) go two at a time through a loop
//     whose trip count is the warp's: C·Bᵀ for the pair (each tile's k range
//     summed in two halves, for shorter chains of dependent MMAs), the decay
//     e^{cum_t − cum_s} dt_s and the mask applied in registers with a select
//     (e^x above the diagonal may be inf, and inf · 0 is NaN), then G·x with
//     G as the A fragment: the MMA's k = t and k = t + 4 carry s = 2t and
//     2t + 1 within each 8-step, which is where the C layout left them.  No
//     MMA sits under a per-tile condition: ptxas would fence each one with a
//     warp barrier;
//   * a chunk has two barriers: after the copies land, and after C·h0ᵀ, the
//     only reader of the old state.  The rest (the causal part, y out, and
//     the state update h = e^{cum_end} h + (w x)ᵀ B, w_s = e^{cum_end −
//     cum_s} dt_s) is one phase, in which the state's (16-row, 32-column)
//     units go to the warps with the fewest causal tiles, so that the four
//     warps finish together (warp 3 has four times warp 0's causal tiles);
//   * cum is a shuffle scan that every warp runs for itself; a lane fetches
//     the cum and w it needs by shuffle, so there is no scan phase.  The
//     scan is in fp64 and every exponent is a difference taken in fp64
//     before it is rounded to fp32 for exp2: in fp32 a difference of two
//     running sums keeps only their absolute rounding, and at zamba2-7b's
//     decays (A down to −16, cum down to about −1000 in log2 units in a
//     chunk) the decay between neighbouring rows erred by up to 4e-5;
//   * the split (common.cuh) rounds with an integer add and mask, as
//     cvt.rna.tf32 rounds a finite x: sm_90 emulates cvt.rna in five
//     instructions;
//   * the next chunk's x, B, C (16-byte cp.async.cg) and dt (4-byte
//     cp.async.ca) fly into a second buffer while this chunk computes (one
//     buffer where two would not fit: P = N = 128); rows past S are
//     zero-filled, so dt = 0 there and they change neither y nor the state;
//   * tiles have no padding: the 16-byte column chunk of row r is stored at
//     chunk ^ (r & 7), so every fragment read of the four products hits 32
//     distinct banks.  At P = N = 64 a block takes 115,200 B, and two blocks
//     (8 warps) fit an SM;
//   * bf16 inputs are converted to fp32 by plain loads.
//
// For the backward (csrc/ssd_bwd.cu) the chunked kernel also writes each
// chunk's start state to hc (B, H, nchunks, P, N) fp32 where hc is not
// null, as flash.cu writes lse: one copy of the state a chunk, between the
// chunk's first barrier and its state update (a block-uniform branch on a
// kernel argument; nothing else changes).
//
// Decode (S == 1) takes its own kernel: h' = e^{dt A} h + dt x_p B,
// y_p = C . h' + D x_p, where the work is reading and writing the state
// (29.8 MB at zamba2-7b, 0.0089 ms at 3.35 TB/s).  N / 8 lanes own one state
// row (b, h, p), move it as 16-byte loads and stores, and sum C . h' by warp
// shuffle; 8 · 112 · 64 rows at zamba2-7b fill 1792 blocks.  Both kernels
// read a (b, h) state before they write it and no two blocks share one, so
// the new state may overwrite the old in place.
#include "common.cuh"

namespace {

constexpr int Q = 64;                  // rows per chunk
constexpr int WARPS = 4;               // each owns 16 rows of a chunk
constexpr int THREADS = 32 * WARPS;
constexpr int KS = Q / 8;              // 8-row steps of a chunk
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

// A row-major tile of width W floats, unpadded, with the 16-byte chunk c of
// row r stored at c ^ (r & 7): a warp reading (row g + 8i, column 4j + t) or
// (row 2t + 8i, column g + 8j), g = lane / 4, t = lane % 4, touches 32
// distinct banks.
template <int W>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int M = W / 4 < 8 ? W / 4 - 1 : 7;
  return r * W + ((((c >> 2) ^ (r & M))) << 2) + (c & 3);
}

template <int P, int N>
struct Layout {                        // in floats
  static constexpr int X = Q * P;      // one buffer: x, B, C tiles and dt
  static constexpr int BC = Q * N;
  static constexpr int BUF = X + 2 * BC + Q;
  static constexpr int STATE = P * N;
  static constexpr int NBUF =
      sizeof(float) * (2 * BUF + STATE) <= 227 * 1024 ? 2 : 1;
  static constexpr size_t bytes = sizeof(float) * (NBUF * BUF + STATE);
};

// The state update is cut into units of 16 rows of p by UW 8-wide column
// tiles of n, numbered p-major.  Warp w's work after the chunk's second
// barrier is counted in 3xTF32 MMA steps: its causal pairs of s-tiles (w + 1
// of them, C·Bᵀ and G·x on two tiles each, weighted 5/4 for their decay and
// their shorter chains, as measured on the card) and UW steps per 8 rows of
// s per unit; units go one by one to the least loaded warp, and each warp
// takes a contiguous run of them.
template <int P, int N>
struct StateUnits {
  static constexpr int UW = N / 8 < 4 ? N / 8 : 4;    // column tiles per unit
  static constexpr int PER_ROW = (N / 8) / UW;
  static constexpr int COUNT = (P / 16) * PER_ROW;
};

template <int P, int N>
__host__ __device__ constexpr int units_before(int w) {
  int cost[WARPS] = {}, count[WARPS] = {};
  for (int i = 0; i < WARPS; ++i) cost[i] = (i + 1) * 5 * (N / 8 + P / 8) / 2;
  for (int u = 0; u < StateUnits<P, N>::COUNT; ++u) {
    int best = 0;
    for (int i = 1; i < WARPS; ++i)
      if (cost[i] < cost[best]) best = i;
    cost[best] += KS * StateUnits<P, N>::UW;
    ++count[best];
  }
  int first = 0;
  for (int i = 0; i < w; ++i) first += count[i];
  return first;
}

template <int P, int N, int W>
struct UnitsBefore {
  static constexpr int value = units_before<P, N>(W);
};

// an A fragment (rows g, g + 8 at k = t; rows g, g + 8 at k = t + 4), split
__device__ __forceinline__ void split4(float a0, float a1, float a2, float a3,
                                       uint32_t (&big)[4], uint32_t (&small)[4]) {
  split(a0, big[0], small[0]);
  split(a1, big[1], small[1]);
  split(a2, big[2], small[2]);
  split(a3, big[3], small[3]);
}

// c[j] += a · b[j] for a row of NT tiles, fp32-exact (3xTF32): every B
// fragment is split first, then the small terms, then big·big, tile after
// tile, so that no MMA waits on the one just issued
template <int NT>
__device__ __forceinline__ void mma3_row(float (&c)[NT][4], const uint32_t (&a_big)[4],
                                         const uint32_t (&a_small)[4], const float2 (&b)[NT]) {
  uint32_t big[NT][2], small[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    split(b[j].x, big[j][0], small[j][0]);
    split(b[j].y, big[j][1], small[j][1]);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) mma(c[j], a_small, big[j]);
#pragma unroll
  for (int j = 0; j < NT; ++j) mma(c[j], a_big, small[j]);
#pragma unroll
  for (int j = 0; j < NT; ++j) mma(c[j], a_big, big[j]);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0));
}

// Q rows of W elements, row r at src + (row0 + r) * stride, into a swizzled
// tile as fp32; rows at or past S are zeros.  fp32 by 16-byte cp.async,
// other types by plain loads.  A thread copies the same 16-byte column chunk
// of every THREADS / (W / 4)-th row, so where that step is a multiple of 8
// rows its swizzled column is the same in each, and the loop only adds.
template <typename T, int W>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long stride,
                                          int row0, int S) {
  constexpr int CH = W / 4;                    // 16-byte chunks per row
  constexpr int STEP = THREADS / CH;           // rows between a thread's copies
  static_assert(THREADS % CH == 0 && Q % STEP == 0, "a tile is whole steps of rows");
  const int r0 = threadIdx.x / CH, c = (threadIdx.x % CH) * 4;
  const T* p = src + (row0 + r0) * stride + c;
  const T* p_in = src + c;                     // a valid address for rows past S
#pragma unroll
  for (int i = 0; i < Q / STEP; ++i) {
    const int r = r0 + i * STEP;
    const bool in = row0 + r < S;
    float* d = dst + (STEP % 8 == 0 ? swz<W>(r0, c) + i * STEP * W : swz<W>(r, c));
    if constexpr (std::is_same_v<T, float>) {
      cp_async16(d, in ? p : p_in, in);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) d[k] = in ? to_f(p[k]) : 0.f;
    }
    p += STEP * stride;
  }
}

template <typename T, int P, int N>
struct Chunk {                         // where one (batch, head) reads its chunks
  const T* x;
  const T* b;
  const T* c;
  const float* dt;
  long long sx, sb, sc, sdt;           // between positions
  int S;

  __device__ __forceinline__ void load(float* buf, int chunk) const {
    using L = Layout<P, N>;
    const int row0 = chunk * Q;
    load_tile<T, P>(buf, x, sx, row0, S);
    load_tile<T, N>(buf + L::X, b, sb, row0, S);
    load_tile<T, N>(buf + L::X + L::BC, c, sc, row0, S);
    if (threadIdx.x < Q) {
      const int r = row0 + threadIdx.x;
      cp_async4(buf + L::X + 2 * L::BC + threadIdx.x, dt + (r < S ? r : 0) * sdt, r < S);
    }
    cp_async_commit();
  }
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ D,
               const float* s0, T* __restrict__ y, float* sf, float* __restrict__ hc,
               int S, int H, int heads_per_group, long long sxb, long long sxs,
               long long sbb, long long sbs, long long scb, long long scs) {
  static_assert(P % 16 == 0 && N % 8 == 0 && N >= 16, "P, N: multiples of 16");
  using L = Layout<P, N>;
  constexpr int NT = N / 8;            // 8-wide tiles of n
  constexpr int PT = P / 8;            // 8-wide tiles of p
  extern __shared__ __align__(16) float smem[];
  float* Hs = smem + L::NBUF * L::BUF; // the state, P x N, swizzled

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;       // fragment row and column
  const float a_log2 = A[h] * kLog2e;          // cum kept in log2 units
  const float d_h = D[h];
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int grp = h / heads_per_group;
  const Chunk<T, P, N> in{x + b * sxb + static_cast<long long>(h) * P,
                          Bm + b * sbb + static_cast<long long>(grp) * N,
                          Cm + b * scb + static_cast<long long>(grp) * N,
                          dt + static_cast<size_t>(b) * S * H + h,
                          sxs, sbs, scs, H, S};
  T* yb = y + (static_cast<size_t>(b) * S * H + h) * P;
  const size_t y_stride = static_cast<size_t>(H) * P;

  const int t0 = 16 * warp + g, t1 = t0 + 8;   // this lane's rows of a chunk
  using SU = StateUnits<P, N>;
  int u_lo = 0, u_hi = 0;                      // this warp's state units
  if (warp == 0) { u_lo = 0; u_hi = UnitsBefore<P, N, 1>::value; }
  if (warp == 1) { u_lo = UnitsBefore<P, N, 1>::value; u_hi = UnitsBefore<P, N, 2>::value; }
  if (warp == 2) { u_lo = UnitsBefore<P, N, 2>::value; u_hi = UnitsBefore<P, N, 3>::value; }
  if (warp == 3) { u_lo = UnitsBefore<P, N, 3>::value; u_hi = SU::COUNT; }
  for (int e = threadIdx.x; e < P * N / 4; e += THREADS) {
    const int r = e / (N / 4), c = (e % (N / 4)) * 4;
    *reinterpret_cast<float4*>(Hs + swz<N>(r, c)) =
        s0 ? reinterpret_cast<const float4*>(s0 + bh * P * N)[e] : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int nchunks = (S + Q - 1) / Q;
  in.load(smem, 0);
  for (int ci = 0; ci < nchunks; ++ci) {
    const int c0 = ci * Q;
    const int qn = min(Q, S - c0);             // rows of this chunk
    const int ks = (qn + 7) / 8;               // 8-row steps that hold them
    cp_async_wait<0>();
    __syncthreads();   // chunk ci visible; chunk ci-1 consumed; the state updated
    if (L::NBUF == 2 && ci + 1 < nchunks) in.load(smem + ((ci + 1) & 1) * L::BUF, ci + 1);
    if (hc) {                                  // this chunk's start state, for the backward
      float4* dst = reinterpret_cast<float4*>(hc + (bh * nchunks + ci) * P * N);
      for (int e = threadIdx.x; e < P * N / 4; e += THREADS) {
        const int r = e / (N / 4), c = (e % (N / 4)) * 4;
        dst[e] = *reinterpret_cast<const float4*>(Hs + swz<N>(r, c));
      }
    }
    const float* Xs = smem + (L::NBUF == 2 ? (ci & 1) * L::BUF : 0);
    const float* Bs = Xs + L::X;
    const float* Cs = Bs + L::BC;
    const float* dts = Cs + L::BC;

    // cum (log2 units, fp64) at rows 2 lane and 2 lane + 1, and the state
    // weights
    const float2 dtl = *reinterpret_cast<const float2*>(dts + 2 * lane);
    const double l0 = dtl.x * a_log2, l1 = dtl.y * a_log2;
    double incl = l0 + l1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    const double cum_lo = incl - l1, cum_hi = incl;
    const double cum_end = __shfl_sync(kFull, incl, 31);
    const float w_lo = exp2f(static_cast<float>(cum_end - cum_lo)) * dtl.x;
    const float w_hi = exp2f(static_cast<float>(cum_end - cum_hi)) * dtl.y;

    // phase 1: y = (C h0ᵀ) e^{cum_t}, the only reader of the old state
    const bool rows = 16 * warp < qn;          // warp-uniform
    // cum at rows t0 and t1 (one parity): every lane shuffles, then selects
    const double lo0 = __shfl_sync(kFull, cum_lo, t0 >> 1);
    const double hi0 = __shfl_sync(kFull, cum_hi, t0 >> 1);
    const double lo1 = __shfl_sync(kFull, cum_lo, t1 >> 1);
    const double hi1 = __shfl_sync(kFull, cum_hi, t1 >> 1);
    const double ct0 = (g & 1) ? hi0 : lo0, ct1 = (g & 1) ? hi1 : lo1;
    uint32_t c_big[NT][4], c_small[NT][4];     // this warp's rows of C, split once:
    float ya[PT][4];                           // the A fragments of C·h0ᵀ and C·Bᵀ
    if (rows) {
#pragma unroll
      for (int d = 0; d < NT; ++d) {
        const int n = 8 * d + tq;
        split4(Cs[swz<N>(t0, n)], Cs[swz<N>(t1, n)], Cs[swz<N>(t0, n + 4)],
               Cs[swz<N>(t1, n + 4)], c_big[d], c_small[d]);
      }
#pragma unroll
      for (int j = 0; j < PT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) ya[j][i] = 0.f;
#pragma unroll
      for (int d = 0; d < NT; ++d) {
        const int n = 8 * d + tq;
        float2 b[PT];
#pragma unroll
        for (int j = 0; j < PT; ++j)
          b[j] = make_float2(Hs[swz<N>(8 * j + g, n)], Hs[swz<N>(8 * j + g, n + 4)]);
        mma3_row<PT>(ya, c_big[d], c_small[d], b);
      }
    }
    __syncthreads();                           // every read of the old state is done

    // phase 2: the causal part, y out, and this warp's units of the new state
    if (rows) {
      const float e0 = exp2f(static_cast<float>(ct0)), e1 = exp2f(static_cast<float>(ct1));
#pragma unroll
      for (int j = 0; j < PT; ++j) {
        ya[j][0] *= e0;
        ya[j][1] *= e0;
        ya[j][2] *= e1;
        ya[j][3] *= e1;
      }

      // the causal s-tiles 0 .. 2 warp + 1, two at a time: G = C Bᵀ (k over
      // n in KC interleaved parts, for short chains of dependent MMAs), its
      // decay and mask in registers, then y += G x with G as the A fragment
      // (k = tq and tq + 4 carry s = 2 tq and 2 tq + 1).  Tiles past the
      // chunk's rows are zeros and are skipped (a warp-uniform trip count).
      constexpr int KC = NT < 4 ? NT : 4;
      const int pairs = (min(2 * warp + 2, ks) + 1) / 2;
      for (int jp = 0; jp < pairs; ++jp) {
        float gpart[KC][2][4];
#pragma unroll
        for (int c = 0; c < KC; ++c)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) gpart[c][i][e] = 0.f;
        const int s_row = 16 * jp + g;         // B rows of the two tiles: s_row, s_row + 8
#pragma unroll
        for (int d = 0; d < NT; ++d) {
          const int n = 8 * d + tq;
          float2 b[2];
          b[0] = make_float2(Bs[swz<N>(s_row, n)], Bs[swz<N>(s_row, n + 4)]);
          b[1] = make_float2(Bs[swz<N>(s_row + 8, n)], Bs[swz<N>(s_row + 8, n + 4)]);
          mma3_row<2>(gpart[d % KC], c_big[d], c_small[d], b);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int j = 2 * jp + i;
          const double cs0 = __shfl_sync(kFull, cum_lo, 4 * j + tq);
          const double cs1 = __shfl_sync(kFull, cum_hi, 4 * j + tq);
          const int s = 8 * j + 2 * tq;
          const float2 dtv = *reinterpret_cast<const float2*>(dts + s);
          float gs[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            gs[e] = gpart[0][i][e];
#pragma unroll
            for (int c = 1; c < KC; ++c) gs[e] += gpart[c][i][e];
          }
          const float g00 = s <= t0 ? gs[0] * exp2f(static_cast<float>(ct0 - cs0)) * dtv.x : 0.f;
          const float g01 = s + 1 <= t0 ? gs[1] * exp2f(static_cast<float>(ct0 - cs1)) * dtv.y
                                        : 0.f;
          const float g10 = s <= t1 ? gs[2] * exp2f(static_cast<float>(ct1 - cs0)) * dtv.x : 0.f;
          const float g11 = s + 1 <= t1 ? gs[3] * exp2f(static_cast<float>(ct1 - cs1)) * dtv.y
                                        : 0.f;
          uint32_t a_big[4], a_small[4];
          split4(g00, g10, g01, g11, a_big, a_small);
          float2 b[PT];
#pragma unroll
          for (int pj = 0; pj < PT; ++pj)
            b[pj] = make_float2(Xs[swz<P>(s, 8 * pj + g)], Xs[swz<P>(s + 1, 8 * pj + g)]);
          mma3_row<PT>(ya, a_big, a_small, b);
        }
      }

      // y = ... + D x, two adjacent columns per store
#pragma unroll
      for (int pj = 0; pj < PT; ++pj) {
        const int p = 8 * pj + 2 * tq;
        if (t0 < qn) {
          const float2 xv = *reinterpret_cast<const float2*>(Xs + swz<P>(t0, p));
          store2(yb + static_cast<size_t>(c0 + t0) * y_stride + p,
                 ya[pj][0] + d_h * xv.x, ya[pj][1] + d_h * xv.y);
        }
        if (t1 < qn) {
          const float2 xv = *reinterpret_cast<const float2*>(Xs + swz<P>(t1, p));
          store2(yb + static_cast<size_t>(c0 + t1) * y_stride + p,
                 ya[pj][2] + d_h * xv.x, ya[pj][3] + d_h * xv.y);
        }
      }
    }

    // h = e^{cum_end} h + (w x)ᵀ B on this warp's units, k over s as in G x
    // (rows past the chunk's are zeros: w = 0 there); a warp-uniform loop
    const float decay = exp2f(static_cast<float>(cum_end));
    for (int u = u_lo; u < u_hi; ++u) {
      const int m = u / SU::PER_ROW, nt0 = (u % SU::PER_ROW) * SU::UW;
      const int p0 = 16 * m + g, p1 = p0 + 8;
      float acc[SU::UW][4];
#pragma unroll
      for (int j = 0; j < SU::UW; ++j) {
        const int n = 8 * (nt0 + j) + 2 * tq;
        const float2 h0 = *reinterpret_cast<const float2*>(Hs + swz<N>(p0, n));
        const float2 h1 = *reinterpret_cast<const float2*>(Hs + swz<N>(p1, n));
        acc[j][0] = decay * h0.x;
        acc[j][1] = decay * h0.y;
        acc[j][2] = decay * h1.x;
        acc[j][3] = decay * h1.y;
      }
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        const float ws0 = __shfl_sync(kFull, w_lo, 4 * k + tq);
        const float ws1 = __shfl_sync(kFull, w_hi, 4 * k + tq);
        const int s = 8 * k + 2 * tq;
        uint32_t a_big[4], a_small[4];
        split4(ws0 * Xs[swz<P>(s, p0)], ws0 * Xs[swz<P>(s, p1)], ws1 * Xs[swz<P>(s + 1, p0)],
               ws1 * Xs[swz<P>(s + 1, p1)], a_big, a_small);
        float2 b[SU::UW];
#pragma unroll
        for (int j = 0; j < SU::UW; ++j) {
          const int n = 8 * (nt0 + j) + g;
          b[j] = make_float2(Bs[swz<N>(s, n)], Bs[swz<N>(s + 1, n)]);
        }
        mma3_row<SU::UW>(acc, a_big, a_small, b);
      }
#pragma unroll
      for (int j = 0; j < SU::UW; ++j) {
        const int n = 8 * (nt0 + j) + 2 * tq;
        *reinterpret_cast<float2*>(Hs + swz<N>(p0, n)) = make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(Hs + swz<N>(p1, n)) = make_float2(acc[j][2], acc[j][3]);
      }
    }
    if (L::NBUF == 1 && ci + 1 < nchunks) {
      __syncthreads();                         // the one buffer is consumed
      in.load(smem, ci + 1);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < P * N / 4; e += THREADS) {
    const int r = e / (N / 4), c = (e % (N / 4)) * 4;
    reinterpret_cast<float4*>(sf + bh * P * N)[e] =
        *reinterpret_cast<const float4*>(Hs + swz<N>(r, c));
  }
}

constexpr int STEP_THREADS = 256;

template <typename T>
__device__ __forceinline__ void load8(float (&v)[8], const T* p) {
  if constexpr (std::is_same_v<T, float>) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = to_f(p[i]);
  }
}

// One decode step: N / 8 lanes own the state row (b, h, p), 8 floats each.
template <typename T, int N>
__global__ void __launch_bounds__(STEP_THREADS)
ssd_step_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ D,
                const float* s0, T* __restrict__ y, float* sf, int rows, int H,
                int P, int heads_per_group, long long sxb, long long sbb, long long scb) {
  constexpr int LPR = N / 8;                   // lanes per row
  const int row = blockIdx.x * (STEP_THREADS / LPR) + threadIdx.x / LPR;
  const int part = threadIdx.x % LPR;
  const bool valid = row < rows;
  const int r = valid ? row : 0;               // every lane stays for the shuffles
  const int p = r % P, bh = r / P, h = bh % H, b = bh / H;
  const int grp = h / heads_per_group;
  const float dtv = dt[bh];                    // dt (B, 1, H)
  const float decay = expf(dtv * A[h]);
  const float xv = to_f(x[b * sxb + static_cast<long long>(h) * P + p]);
  float bv[8], cv[8], st[8];
  load8(bv, Bm + b * sbb + static_cast<long long>(grp) * N + 8 * part);
  load8(cv, Cm + b * scb + static_cast<long long>(grp) * N + 8 * part);
  const size_t off = static_cast<size_t>(r) * N + 8 * part;
  if (s0) {
    load8(st, s0 + off);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) st[i] = 0.f;
  }
  const float coef = dtv * xv;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    st[i] = decay * st[i] + coef * bv[i];
    acc += cv[i] * st[i];
  }
  if (valid) {
    reinterpret_cast<float4*>(sf + off)[0] = make_float4(st[0], st[1], st[2], st[3]);
    reinterpret_cast<float4*>(sf + off)[1] = make_float4(st[4], st[5], st[6], st[7]);
  }
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
  if (valid && part == 0) y[static_cast<size_t>(bh) * P + p] = from_f<T>(acc + D[h] * xv);
}

struct Args {
  const void* x; const float* dt; const float* A; const void* Bm; const void* Cm;
  const float* D; const float* s0; void* y; float* sf; float* hc;
  int B, S, H, G, P, N;
  long long sxb, sxs, sbb, sbs, scb, scs;
};

template <typename T, int P, int N>
int launch_fwd(const Args& a, cudaStream_t stream) {
  auto kernel = ssd_fwd_kernel<T, P, N>;
  constexpr size_t smem = Layout<P, N>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(a.H, a.B), THREADS, smem, stream>>>(
      static_cast<const T*>(a.x), a.dt, a.A, static_cast<const T*>(a.Bm),
      static_cast<const T*>(a.Cm), a.D, a.s0, static_cast<T*>(a.y), a.sf, a.hc, a.S, a.H,
      a.H / a.G, a.sxb, a.sxs, a.sbb, a.sbs, a.scb, a.scs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int N>
int launch_step(const Args& a, cudaStream_t stream) {
  const long long rows = static_cast<long long>(a.B) * a.H * a.P;
  constexpr int per_block = STEP_THREADS / (N / 8);
  const long long blocks = (rows + per_block - 1) / per_block;
  if (rows > 0x7fffffffLL) return RT_UNSUPPORTED;
  ssd_step_kernel<T, N><<<static_cast<unsigned>(blocks), STEP_THREADS, 0, stream>>>(
      static_cast<const T*>(a.x), a.dt, a.A, static_cast<const T*>(a.Bm),
      static_cast<const T*>(a.Cm), a.D, a.s0, static_cast<T*>(a.y), a.sf,
      static_cast<int>(rows), a.H, a.P, a.H / a.G, a.sxb, a.sbb, a.scb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
int launch_n(const Args& a, cudaStream_t s) {
  switch (a.N) {
    case 16: return a.S == 1 ? launch_step<T, 16>(a, s) : launch_fwd<T, P, 16>(a, s);
    case 32: return a.S == 1 ? launch_step<T, 32>(a, s) : launch_fwd<T, P, 32>(a, s);
    case 64: return a.S == 1 ? launch_step<T, 64>(a, s) : launch_fwd<T, P, 64>(a, s);
    case 128: return a.S == 1 ? launch_step<T, 128>(a, s) : launch_fwd<T, P, 128>(a, s);
  }
  return RT_UNSUPPORTED;
}

template <typename T>
int launch_pn(const Args& a, cudaStream_t s) {
  switch (a.P) {
    case 16: return launch_n<T, 16>(a, s);
    case 32: return launch_n<T, 32>(a, s);
    case 64: return launch_n<T, 64>(a, s);
    case 128: return launch_n<T, 128>(a, s);
  }
  return RT_UNSUPPORTED;
}

template <int P>
int smem_n(int N) {
  switch (N) {
    case 16: return static_cast<int>(Layout<P, 16>::bytes);
    case 32: return static_cast<int>(Layout<P, 32>::bytes);
    case 64: return static_cast<int>(Layout<P, 64>::bytes);
    case 128: return static_cast<int>(Layout<P, 128>::bytes);
  }
  return RT_UNSUPPORTED;
}

}  // namespace

// The dynamic shared memory of a block of the chunked kernel at (P, N), in
// bytes, or RT_UNSUPPORTED: what the build reports beside ptxas's counts.
extern "C" int rt_ssd_smem_bytes(int P, int N) {
  switch (P) {
    case 16: return smem_n<16>(N);
    case 32: return smem_n<32>(N);
    case 64: return smem_n<64>(N);
    case 128: return smem_n<128>(N);
  }
  return RT_UNSUPPORTED;
}

// x (B, S, H, P) and Bm, Cm (B, S, G, N) in dtype `dtype` (fp32 or bf16),
// each with the last dim contiguous, heads (groups) packed, and the given
// batch and position strides in elements (fp32: base and strides 16-byte
// aligned); dt (B, S, H), A, D (H,), s0 (may be null: zeros) and
// sf (B, H, P, N) fp32 and contiguous, s0 and sf 16-byte aligned; sf may be
// s0.  y (B, S, H, P) contiguous.  S == 1 runs the decode kernel, S > 1 the
// chunked one, which also writes each chunk's start state to hc (B, H,
// ceil(S / 64), P, N) fp32, contiguous and 16-byte aligned, where hc is not
// null (the decode kernel does not: at S == 1 that state is s0).  Returns a
// cudaError_t, or RT_UNSUPPORTED for what the kernels do not take (P or N
// outside {16, 32, 64, 128}, G not dividing H, another dtype, a grid
// dimension over its limit).
extern "C" int rt_ssd(const void* x, const void* dt, const void* A, const void* Bm,
                      const void* Cm, const void* D, const void* s0, void* y, void* sf,
                      void* hc, int B, int S, int H, int G, int P, int N, long long sxb,
                      long long sxs, long long sbb, long long sbs, long long scb,
                      long long scs, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || B > 65535) return RT_UNSUPPORTED;
  const Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A), Bm, Cm,
               static_cast<const float*>(D), static_cast<const float*>(s0), y,
               static_cast<float*>(sf), static_cast<float*>(hc), B, S, H, G, P, N,
               sxb, sxs, sbb, sbs, scb, scs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case RT_F32: return launch_pn<float>(a, s);
    case RT_BF16: return launch_pn<__nv_bfloat16>(a, s);
  }
  return RT_UNSUPPORTED;
}
