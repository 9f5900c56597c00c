// Mamba-2 SSD scan, backward: the gradients of the chunked scan of ssd.cu
// with respect to x, dt, A, B, C, D and the initial state, given those of
// y and of the final state.
//
// Replaces no TPU kernel: repro/kernels/ssd.py has a forward Pallas kernel
// only, and the reference trains through jax.grad of its jnp scans
// (repro/kernels/ref.py::ssd_chunked_ref, the default "chunked" backend).
// Its plain version is kernels/ref.py::ssd_chunked_bwd_ref, the same
// algorithm in PyTorch.  Per (batch, head) and chunk of Q = 64 rows, with
// a_t = dt_t A, cum its inclusive cumsum, u_s = dt_s x_s, L[t,s] =
// e^{cum_t − cum_s} (s <= t), h0 the chunk's start state (which the forward
// wrote, ssd.cu's hc) and dh the gradient of its end state:
//   dh0  = sum_t e^{cum_t} dy_t (x) C_t + e^{cum_end} dh          (the next dh)
//   dC_t = e^{cum_t} h0ᵀ dy_t + sum_{s<=t} L[t,s] (dy_t . u_s) B_s
//   dB_s = sum_{t>=s} L[t,s] (dy_t . u_s) C_t + e^{cum_end − cum_s} dhᵀ u_s
//   du_s = sum_{t>=s} L[t,s] (C_t . B_s) dy_t + e^{cum_end − cum_s} dh B_s
//   dx_s = dt_s du_s + D dy_s,  ddt_s = x_s . du_s + A da_s,  dD = sum dy . x,
//   dA = sum dt da
// with da the reverse in-chunk cumsum of dcum, the derivative of every
// e^{...} above (+ at t and − at s for L[t,s], + at cum_end and − at s for
// e^{cum_end − cum_s}, + at t for e^{cum_t}, + at cum_end for e^{cum_end}).
//
// Bound on the H100 (zamba2-7b's training shape, B = 4, S = 2048, H = 112,
// G = 1, P = N = 64): nine chunk products a chunk, 50.5 GFLOP of fp32 work
// over the causal pairs (kernels/work.py::ssd_bwd_flops), against 0.96 GB
// moved (x, dy and dx, and the chunks' start states, 235 MB each): 0.75 ms
// at the fp32 CUDA cores' 67 TFLOP/s, 0.29 ms at 3.35 TB/s.  This first
// kernel is simple and right, on the CUDA cores (it computes the Q x Q
// products whole, the zeros above the diagonal too):
//   * one block of 256 threads owns one (batch, head) and walks its chunks
//     from the last to the first with dh (P x N, fp32) in shared memory, as
//     the forward walks them the other way with h;
//   * a chunk's tiles (x, dy, B, C, h0, dh and the two Q x Q matrices
//     M1 = L (dy_t . u_s) and M2 = L (C_t . B_s)) sit in shared memory with
//     an odd row pitch (W + 1 floats), so that a warp reading a row or a
//     column of any of them touches distinct banks;
//   * each product is one pass of `mac`: the 16 x 16 threads own rows
//     ty + 16 i and columns tx + 16 j of the output, in registers, and read
//     one value of each operand a step (a broadcast of two addresses for
//     the rows, 16 distinct banks for the columns);
//   * cum is summed in fp64, and every exponent is a difference taken in
//     fp64 before it is rounded to fp32 for exp: in fp32 a difference of two
//     running sums keeps only their absolute rounding, and at zamba2-7b's
//     decays (A down to −16, cum down to about −700 in a chunk) the decay
//     between neighbouring rows erred by up to 4e-5.  dcum's terms, their
//     reverse cumsum da and dA are summed in fp64 too: they cancel, and in
//     fp32 dA erred by 1.7e-5 of max|dA| at zamba2-7b's decays;
//   * the exponent of L is masked before exp (above the diagonal e^x may be
//     inf); rows past S are zeros (dt = 0), change nothing, and their dx,
//     ddt, dB and dC are not written;
//   * every sum is taken in a fixed order (row sums by shuffles within a
//     half warp, column sums through shared memory, block sums by warp in
//     order), so a rerun gives the same bits.  dB and dC are written per
//     head; where a group has several heads, a second kernel sums them in
//     order (no atomics).  dA and dD are written per (batch, head).
#include "common.cuh"

namespace {

constexpr int Q = 64;                  // rows per chunk, as in ssd.cu
constexpr int TG = 16;                 // threads a side of an output tile
constexpr int THREADS = TG * TG;
constexpr int WARPS = THREADS / 32;
constexpr unsigned kFull = 0xffffffffu;

template <int P, int N>
struct BwdLayout {                     // in floats; every row pitch odd
  static constexpr int PX = P + 1, PN = N + 1, PQ = Q + 1;
  // fp64 first (8-byte aligned): cum, dcum's row terms, the column
  // partials and one partial sum a warp
  static constexpr int CUM = 0;                    // Q doubles: cum
  static constexpr int ROWV = CUM + 2 * Q;         // Q doubles each: the row terms
  static constexpr int TERM1 = ROWV + 2 * Q;
  static constexpr int WST = TERM1 + 2 * Q;
  static constexpr int RED = WST + 2 * Q;          // TG x Q doubles: column partials
  static constexpr int WRED = RED + 2 * TG * Q;    // WARPS doubles
  static constexpr int X = WRED + 2 * WARPS;       // Q x P: x
  static constexpr int DY = X + Q * PX;            // Q x P: dy
  static constexpr int BS = DY + Q * PX;           // Q x N: B
  static constexpr int CS = BS + Q * PN;           // Q x N: C
  static constexpr int H0 = CS + Q * PN;           // P x N: the chunk's start state
  static constexpr int DH = H0 + P * PN;           // P x N: dh
  static constexpr int M1 = DH + P * PN;           // Q x Q: L (dy_t . u_s)
  static constexpr int M2 = M1 + Q * PQ;           // Q x Q: L (C_t . B_s)
  static constexpr int VEC = M2 + Q * PQ;          // Q each: dt, x_s . du_s
  static constexpr int TOTAL = VEC + 2 * Q;
  static constexpr size_t bytes = sizeof(float) * TOTAL;
};

// A thread's part of an M x W product: rows ty + TG i, columns tx + TG j.
template <int M, int W>
struct Tile {
  static constexpr int R = M / TG, C = W / TG;
  static_assert(M % TG == 0 && W % TG == 0, "tiles are whole 16 x 16 steps");
  float v[R][C];
};

// t[i][j] += sum_k a[row * RA + k * KA] * b[k * KB + col * CB]
template <int K, int RA, int KA, int KB, int CB, int M, int W>
__device__ __forceinline__ void mac(Tile<M, W>& t, const float* a, const float* b, int ty,
                                    int tx) {
  constexpr int R = Tile<M, W>::R, C = Tile<M, W>::C;
  const float* ap = a + ty * RA;
  const float* bp = b + tx * CB;
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    float av[R], bv[C];
#pragma unroll
    for (int i = 0; i < R; ++i) av[i] = ap[i * TG * RA + k * KA];
#pragma unroll
    for (int j = 0; j < C; ++j) bv[j] = bp[k * KB + j * TG * CB];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) t.v[i][j] = fmaf(av[i], bv[j], t.v[i][j]);
  }
}

template <int M, int W>
__device__ __forceinline__ void zero(Tile<M, W>& t) {
#pragma unroll
  for (int i = 0; i < Tile<M, W>::R; ++i)
#pragma unroll
    for (int j = 0; j < Tile<M, W>::C; ++j) t.v[i][j] = 0.f;
}

__device__ __forceinline__ double warp_sum_d(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// the sum over the 16 lanes of a half warp (one row's owners), on every lane
template <typename T>
__device__ __forceinline__ T row_sum16(T v) {
  v += __shfl_xor_sync(kFull, v, 8);
  v += __shfl_xor_sync(kFull, v, 4);
  v += __shfl_xor_sync(kFull, v, 2);
  v += __shfl_xor_sync(kFull, v, 1);
  return v;
}

// one block an SM (its shared memory allows no second): every register is
// this block's to use, which keeps ptxas from capping them and spilling
template <int P, int N>
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ D,
               const float* __restrict__ hc, const float* __restrict__ dy,
               const float* __restrict__ dse, float* __restrict__ dx,
               float* __restrict__ ddt, float* __restrict__ dB, float* __restrict__ dC,
               float* __restrict__ dAp, float* __restrict__ dDp, float* __restrict__ ds0,
               int S, int H, int heads_per_group, long long sxb, long long sxs,
               long long sbb, long long sbs, long long scb, long long scs) {
  static_assert(P % TG == 0 && N % TG == 0, "P, N: multiples of 16");
  using L = BwdLayout<P, N>;
  constexpr int PX = L::PX, PN = L::PN, PQ = L::PQ;
  using QQ = Tile<Q, Q>;
  extern __shared__ float sm[];
  float* Xs = sm + L::X;
  float* DYs = sm + L::DY;
  float* Bs = sm + L::BS;
  float* Cs = sm + L::CS;
  float* H0s = sm + L::H0;
  float* DHs = sm + L::DH;
  float* M1s = sm + L::M1;
  float* M2s = sm + L::M2;
  double* cums = reinterpret_cast<double*>(sm + L::CUM);
  double* rowv = reinterpret_cast<double*>(sm + L::ROWV);   // sum_s L (dy_t . u_s)(C_t . B_s)
  double* term1 = reinterpret_cast<double*>(sm + L::TERM1); // C_t . e^{cum_t} h0ᵀ dy_t
  double* wst = reinterpret_cast<double*>(sm + L::WST);     // u_s . e^{cum_end − cum_s} dh B_s
  double* red = reinterpret_cast<double*>(sm + L::RED);
  double* wred = reinterpret_cast<double*>(sm + L::WRED);
  float* dts = sm + L::VEC;            // dt of the chunk's rows (0 past S)
  float* xdu = dts + Q;                // x_s . du_s

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / TG, tx = tid % TG;
  const int warp = tid / 32, lane = tid % 32;
  const float a_h = A[h], d_h = D[h];
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int grp = h / heads_per_group;
  const float* xb = x + b * sxb + static_cast<long long>(h) * P;
  const float* bb = Bm + b * sbb + static_cast<long long>(grp) * N;
  const float* cb = Cm + b * scb + static_cast<long long>(grp) * N;
  const size_t row_p = static_cast<size_t>(H) * P;       // dy, dx: between positions
  const float* dyb = dy + static_cast<size_t>(b) * S * row_p + static_cast<size_t>(h) * P;
  float* dxb = dx + static_cast<size_t>(b) * S * row_p + static_cast<size_t>(h) * P;
  const float* dtb = dt + static_cast<size_t>(b) * S * H + h;
  float* ddtb = ddt + static_cast<size_t>(b) * S * H + h;
  const size_t row_n = static_cast<size_t>(H) * N;       // dB, dC per head (B, S, H, N)
  float* dBb = dB + static_cast<size_t>(b) * S * row_n + static_cast<size_t>(h) * N;
  float* dCb = dC + static_cast<size_t>(b) * S * row_n + static_cast<size_t>(h) * N;
  const int nchunks = (S + Q - 1) / Q;

  for (int e = tid; e < P * N; e += THREADS)
    DHs[(e / N) * PN + e % N] = dse ? dse[bh * P * N + e] : 0.f;
  double dA_acc = 0.0;
  float dD_acc = 0.f;

  for (int ci = nchunks - 1; ci >= 0; --ci) {
    const int c0 = ci * Q;
    for (int e = tid; e < Q * P; e += THREADS) {
      const int t = e / P, p = e % P;
      const bool in = c0 + t < S;
      Xs[t * PX + p] = in ? xb[(c0 + t) * sxs + p] : 0.f;
      DYs[t * PX + p] = in ? dyb[(c0 + t) * row_p + p] : 0.f;
    }
    for (int e = tid; e < Q * N; e += THREADS) {
      const int t = e / N, n = e % N;
      const bool in = c0 + t < S;
      Bs[t * PN + n] = in ? bb[(c0 + t) * sbs + n] : 0.f;
      Cs[t * PN + n] = in ? cb[(c0 + t) * scs + n] : 0.f;
    }
    const float* h0 = hc + (bh * nchunks + ci) * P * N;
    for (int e = tid; e < P * N; e += THREADS) H0s[(e / N) * PN + e % N] = h0[e];
    if (tid < Q) dts[tid] = c0 + tid < S ? dtb[static_cast<size_t>(c0 + tid) * H] : 0.f;
    __syncthreads();
    if (warp == 0) {                   // cum: an inclusive scan in fp64, two rows a lane
      const double l0 = dts[2 * lane] * a_h, l1 = dts[2 * lane + 1] * a_h;
      double incl = l0 + l1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double v = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += v;
      }
      cums[2 * lane] = incl - l1;
      cums[2 * lane + 1] = incl;
    }
    __syncthreads();
    const double cum_end = cums[Q - 1];

    // M1 = L (dy_t . u_s) and M2 = L (C_t . B_s); the row and column sums of
    // M1 (C_t . B_s), the intra-chunk part of dcum (+ at t, − at s)
    {
      QQ cbt, dyx;
      zero(cbt);
      zero(dyx);
      mac<N, PN, 1, 1, PN>(cbt, Cs, Bs, ty, tx);
      mac<P, PX, 1, 1, PX>(dyx, DYs, Xs, ty, tx);
      double rp[QQ::R], cp[QQ::C];
#pragma unroll
      for (int j = 0; j < QQ::C; ++j) cp[j] = 0.0;
#pragma unroll
      for (int i = 0; i < QQ::R; ++i) {
        const int t = ty + TG * i;
        rp[i] = 0.0;
#pragma unroll
        for (int j = 0; j < QQ::C; ++j) {
          const int s = tx + TG * j;
          const bool on = s <= t;
          const float l = on ? expf(static_cast<float>(on ? cums[t] - cums[s] : 0.0)) : 0.f;
          const float m1 = l * dts[s] * dyx.v[i][j];
          const float m2 = l * cbt.v[i][j];
          const double v = static_cast<double>(m1) * cbt.v[i][j];
          rp[i] += v;
          cp[j] += v;
          M1s[t * PQ + s] = m1;
          M2s[t * PQ + s] = m2;
        }
      }
#pragma unroll
      for (int i = 0; i < QQ::R; ++i) {
        const double r = row_sum16(rp[i]);
        if (tx == 0) rowv[ty + TG * i] = r;
      }
#pragma unroll
      for (int j = 0; j < QQ::C; ++j) red[ty * Q + tx + TG * j] = cp[j];
    }
    __syncthreads();

    // dC = e^{cum_t} dy h0 + M1 B; term1 = C_t . (its first part)
    {
      Tile<Q, N> t;
      zero(t);
      mac<P, PX, 1, PN, 1>(t, DYs, H0s, ty, tx);
#pragma unroll
      for (int i = 0; i < Tile<Q, N>::R; ++i) {
        const int r = ty + TG * i;
        const float ec = expf(static_cast<float>(cums[r]));
        double part = 0.0;
#pragma unroll
        for (int j = 0; j < Tile<Q, N>::C; ++j) {
          t.v[i][j] *= ec;
          part += static_cast<double>(Cs[r * PN + tx + TG * j]) * t.v[i][j];
        }
        part = row_sum16(part);
        if (tx == 0) term1[r] = part;
      }
      mac<Q, PQ, 1, PN, 1>(t, M1s, Bs, ty, tx);
#pragma unroll
      for (int i = 0; i < Tile<Q, N>::R; ++i) {
        const int r = ty + TG * i;
        if (c0 + r < S) {
#pragma unroll
          for (int j = 0; j < Tile<Q, N>::C; ++j)
            dCb[static_cast<size_t>(c0 + r) * row_n + tx + TG * j] = t.v[i][j];
        }
      }
    }
    // dB = e^{cum_end − cum_s} dt_s x dh + M1ᵀ C
    {
      Tile<Q, N> t;
      zero(t);
      mac<P, PX, 1, PN, 1>(t, Xs, DHs, ty, tx);
#pragma unroll
      for (int i = 0; i < Tile<Q, N>::R; ++i) {
        const int r = ty + TG * i;
        const float w = expf(static_cast<float>(cum_end - cums[r])) * dts[r];
#pragma unroll
        for (int j = 0; j < Tile<Q, N>::C; ++j) t.v[i][j] *= w;
      }
      mac<Q, 1, PQ, PN, 1>(t, M1s, Cs, ty, tx);
#pragma unroll
      for (int i = 0; i < Tile<Q, N>::R; ++i) {
        const int r = ty + TG * i;
        if (c0 + r < S) {
#pragma unroll
          for (int j = 0; j < Tile<Q, N>::C; ++j)
            dBb[static_cast<size_t>(c0 + r) * row_n + tx + TG * j] = t.v[i][j];
        }
      }
    }
    // du = e^{cum_end − cum_s} B dhᵀ + M2ᵀ dy; wst = u_s . (its first part);
    // dx = dt du + D dy; xdu = x_s . du_s; dD += dy . x
    {
      Tile<Q, P> t;
      zero(t);
      mac<N, PN, 1, 1, PN>(t, Bs, DHs, ty, tx);
#pragma unroll
      for (int i = 0; i < Tile<Q, P>::R; ++i) {
        const int r = ty + TG * i;
        const float ee = expf(static_cast<float>(cum_end - cums[r]));
        double part = 0.0;
#pragma unroll
        for (int j = 0; j < Tile<Q, P>::C; ++j) {
          t.v[i][j] *= ee;
          part += static_cast<double>(Xs[r * PX + tx + TG * j]) * t.v[i][j];
        }
        part = row_sum16(part);
        if (tx == 0) wst[r] = dts[r] * part;
      }
      mac<Q, 1, PQ, PX, 1>(t, M2s, DYs, ty, tx);
#pragma unroll
      for (int i = 0; i < Tile<Q, P>::R; ++i) {
        const int r = ty + TG * i;
        const bool in = c0 + r < S;
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < Tile<Q, P>::C; ++j) {
          const int p = tx + TG * j;
          const float xv = Xs[r * PX + p], dyv = DYs[r * PX + p];
          part += xv * t.v[i][j];
          dD_acc += dyv * xv;
          if (in) dxb[static_cast<size_t>(c0 + r) * row_p + p] = dts[r] * t.v[i][j] + d_h * dyv;
        }
        part = row_sum16(part);
        if (tx == 0) xdu[r] = part;
      }
    }
    __syncthreads();                   // every read of C, dh as they were is done

    // C_t scaled by e^{cum_t} in place (for dh0), and dh . h0
    for (int e = tid; e < Q * N; e += THREADS)
      Cs[(e / N) * PN + e % N] *= expf(static_cast<float>(cums[e / N]));
    {
      double hd = 0.0;
      for (int e = tid; e < P * N; e += THREADS) {
        const int o = (e / N) * PN + e % N;
        hd += static_cast<double>(DHs[o]) * H0s[o];
      }
      hd = warp_sum_d(hd);
      if (lane == 0) wred[warp] = hd;
    }
    __syncthreads();

    // dh = e^{cum_end} dh + dyᵀ (e^{cum} C); each thread rewrites only the
    // elements it owns, and nothing else reads dh in this phase
    {
      Tile<P, N> t;
      zero(t);
      mac<Q, 1, PX, PN, 1>(t, DYs, Cs, ty, tx);
      const float decay = expf(static_cast<float>(cum_end));
#pragma unroll
      for (int i = 0; i < Tile<P, N>::R; ++i)
#pragma unroll
        for (int j = 0; j < Tile<P, N>::C; ++j) {
          const int o = (ty + TG * i) * PN + tx + TG * j;
          DHs[o] = decay * DHs[o] + t.v[i][j];
        }
    }
    // dcum, da (its reverse cumsum), ddt and dA: warp 0, two rows a lane
    if (warp == 0) {
      double dc[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int t = 2 * lane + k;
        double col = 0.0;
#pragma unroll
        for (int y = 0; y < TG; ++y) col += red[y * Q + t];
        dc[k] = rowv[t] - col + term1[t] - wst[t];
      }
      const double ws = warp_sum_d(wst[2 * lane] + wst[2 * lane + 1]);
      double hd = 0.0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) hd += wred[w];
      if (lane == 31) dc[1] += expf(static_cast<float>(cum_end)) * hd + ws;   // at row Q − 1
      double suf = dc[0] + dc[1];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double v = __shfl_down_sync(kFull, suf, o);
        if (lane + o < 32) suf += v;
      }
      const double da[2] = {suf, suf - dc[0]};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int t = 2 * lane + k;
        if (c0 + t < S)
          ddtb[static_cast<size_t>(c0 + t) * H] = static_cast<float>(xdu[t] + a_h * da[k]);
      }
      dA_acc += warp_sum_d(dts[2 * lane] * da[0] + dts[2 * lane + 1] * da[1]);
    }
    __syncthreads();                   // the chunk's tiles are consumed
  }

  if (ds0)
    for (int e = tid; e < P * N; e += THREADS) ds0[bh * P * N + e] = DHs[(e / N) * PN + e % N];
  const float dd = warp_sum(dD_acc);
  if (lane == 0) wred[warp] = dd;
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += wred[w];
    dDp[bh] = static_cast<float>(s);
    dAp[bh] = static_cast<float>(dA_acc);
  }
}

// out (rows, G, N) = the sum over each group's heads of part (rows, H, N),
// head by head in order
__global__ void __launch_bounds__(256)
ssd_bwd_group_sum(const float* __restrict__ part_b, const float* __restrict__ part_c,
                  float* __restrict__ out_b, float* __restrict__ out_c, long long total,
                  int G, int N, int heads_per_group) {
  const float* part = blockIdx.y ? part_c : part_b;
  float* out = blockIdx.y ? out_c : out_b;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * 256) {
    const int n = static_cast<int>(i % N);
    const long long rg = i / N;                  // row * G + g
    const float* p = part + rg * heads_per_group * N + n;
    float s = 0.f;
    for (int j = 0; j < heads_per_group; ++j) s += p[static_cast<long long>(j) * N];
    out[i] = s;
  }
}

struct BwdArgs {
  const float* x; const float* dt; const float* A; const float* Bm; const float* Cm;
  const float* D; const float* hc; const float* dy; const float* dse;
  float* dx; float* ddt; float* dBp; float* dCp; float* dB; float* dC; float* dAp;
  float* dDp; float* ds0;
  int B, S, H, G;
  long long sxb, sxs, sbb, sbs, scb, scs;
};

template <int P, int N>
int launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  auto kernel = ssd_bwd_kernel<P, N>;
  constexpr size_t smem = BwdLayout<P, N>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool grouped = a.G != a.H;             // per-head partials, then their sum
  kernel<<<dim3(a.H, a.B), THREADS, smem, stream>>>(
      a.x, a.dt, a.A, a.Bm, a.Cm, a.D, a.hc, a.dy, a.dse, a.dx, a.ddt,
      grouped ? a.dBp : a.dB, grouped ? a.dCp : a.dC, a.dAp, a.dDp, a.ds0, a.S, a.H,
      a.H / a.G, a.sxb, a.sxs, a.sbb, a.sbs, a.scb, a.scs);
  err = cudaGetLastError();
  if (err != cudaSuccess || !grouped) return static_cast<int>(err);
  const long long total = static_cast<long long>(a.B) * a.S * a.G * N;
  const long long blocks = (total + 255) / 256;
  ssd_bwd_group_sum<<<dim3(static_cast<unsigned>(blocks < 65535 ? blocks : 65535), 2), 256, 0,
                      stream>>>(a.dBp, a.dCp, a.dB, a.dC, total, a.G, N, a.H / a.G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The dynamic shared memory of a block of the backward kernel at (P, N), in
// bytes, or RT_UNSUPPORTED: what the build reports beside ptxas's counts.
extern "C" int rt_ssd_bwd_smem_bytes(int P, int N) {
  if (P == 64 && N == 64) return static_cast<int>(BwdLayout<64, 64>::bytes);
  if (P == 128 && N == 16) return static_cast<int>(BwdLayout<128, 16>::bytes);
  return RT_UNSUPPORTED;
}

// fp32 only.  x (B, S, H, P) and Bm, Cm (B, S, G, N), G dividing H, each
// with the last dim contiguous, heads (groups) packed and the given batch
// and position strides in elements (the forward's inputs, as ssd.cu reads
// them); dt, ddt (B, S, H), dy, dx (B, S, H, P) contiguous; A, D (H,); hc
// (B, H, ceil(S / 64), P, N), the chunks' start states that rt_ssd wrote;
// dse (B, H, P, N), the final state's gradient, or null (zeros); dB, dC
// (B, S, G, N) contiguous; dBp, dCp (B, S, H, N) scratch for the per-head
// partials where G < H (unread where G == H, may be null); dAp, dDp (B, H);
// ds0 (B, H, P, N), the initial state's gradient, or null (not written).
// (P, N) is (64, 64) or (128, 16).  Returns a cudaError_t, or
// RT_UNSUPPORTED for what the kernels do not take.
extern "C" int rt_ssd_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                          const void* Cm, const void* D, const void* hc, const void* dy,
                          const void* dse, void* dx, void* ddt, void* dBp, void* dCp,
                          void* dB, void* dC, void* dAp, void* dDp, void* ds0, int B, int S,
                          int H, int G, int P, int N, long long sxb, long long sxs,
                          long long sbb, long long sbs, long long scb, long long scs,
                          int dtype, void* stream) {
  if (dtype != RT_F32 || B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || B > 65535 ||
      (G != H && (dBp == nullptr || dCp == nullptr)))
    return RT_UNSUPPORTED;
  const BwdArgs a{static_cast<const float*>(x), static_cast<const float*>(dt),
                  static_cast<const float*>(A), static_cast<const float*>(Bm),
                  static_cast<const float*>(Cm), static_cast<const float*>(D),
                  static_cast<const float*>(hc), static_cast<const float*>(dy),
                  static_cast<const float*>(dse), static_cast<float*>(dx),
                  static_cast<float*>(ddt), static_cast<float*>(dBp),
                  static_cast<float*>(dCp), static_cast<float*>(dB), static_cast<float*>(dC),
                  static_cast<float*>(dAp), static_cast<float*>(dDp),
                  static_cast<float*>(ds0), B, S, H, G, sxb, sxs, sbb, sbs, scb, scs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P == 64 && N == 64) return launch_bwd<64, 64>(a, s);
  if (P == 128 && N == 16) return launch_bwd<128, 16>(a, s);
  return RT_UNSUPPORTED;
}
