// Mamba-2 SSD chunked scan (scalar-identity state space), forward.
//
// Port of repro/kernels/ssd.py::ssd_pallas (_ssd_kernel).  Per (batch, head)
// and chunk of Q = 64 rows, with the log decay a_t = dt_t * A and cum its
// inclusive cumsum over the chunk:
//   y_t   = e^{cum_t} C_t . h0  +  sum_{s <= t} (C_t . B_s) e^{cum_t - cum_s} dt_s x_s  +  D x_t
//   h_end = e^{cum_end} h0  +  sum_s e^{cum_end - cum_s} dt_s x_s (x) B_s
// The TPU kernel walks the chunks as a sequential grid axis with the (P, N)
// state in VMEM scratch.  Blocks on Hopper run in no order, so here one block
// owns one (batch, head) and loops over its chunks itself:
//   * the (P, N) fp32 state stays in shared memory for the whole sequence
//     (16 KB at P = N = 64); each chunk's x, B and C tiles are staged in
//     shared memory as fp32, with the Q x Q matrix G, cum, dt and the state
//     weights e^{cum_end - cum_s} dt_s beside them;
//   * cum is one warp's shuffle scan over the chunk;
//   * the three products (G = C B^T masked, y = G x + (C h0^T) e^{cum} + D x,
//     h = e^{cum_end} h + (w x)^T B) each give every thread a register tile of
//     outputs on a 16 x 16 thread grid, with rows padded where lanes walk
//     down a column so that shared-memory reads do not conflict;
//   * the causal decay is applied with a select, not a multiply: for s > t
//     the exponent is positive and e^x may be inf, and inf * 0 is NaN;
//   * S need not be a chunk multiple.  Rows past S are zero in shared memory
//     (dt = 0 there, so they change neither y nor the state, as the
//     reference's zero padding does), and the loops stop at the chunk's last
//     row, so decode's S = 1 costs one row, not 64.
//
// Bound on the H100: at zamba2-7b prefill (B = 8, S = 512, H = 112,
// P = N = 64) the four chunk products are about 15 GFLOP against about
// 486 MB moved (x, B, C, y of 117 MB each), some 31 flops a byte, above the
// card's ~20 fp32 flops per byte: operations, at the 67 TFLOP/s fp32 rate,
// since this first version runs on the CUDA cores.  Tensor cores (wgmma on
// the chunk products) come later.  At decode (S = 1) it reads and writes
// the state: bytes.
#include "common.cuh"

namespace {

constexpr int Q = 64;              // rows per chunk
constexpr int THREADS = 256;       // a 16 x 16 grid over each output tile
constexpr int TG = 16;

template <int P, int N>
struct Layout {                    // shared memory, in floats
  static constexpr int LDX = P;          // lanes walk along p
  static constexpr int LDB = N + 1;      // lanes walk down s (G): padded
  static constexpr int LDC = N + 1;
  static constexpr int LDH = N + 1;      // lanes walk down p (y): padded
  static constexpr int LDG = Q + 1;
  static constexpr int X = 0;
  static constexpr int B = X + Q * LDX;
  static constexpr int C = B + Q * LDB;
  static constexpr int H = C + Q * LDC;
  static constexpr int G = H + P * LDH;
  static constexpr int CUM = G + Q * LDG;
  static constexpr int DT = CUM + Q;
  static constexpr int W = DT + Q;
  static constexpr int TOTAL = W + Q;
  static constexpr size_t bytes = sizeof(float) * TOTAL;
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ D,
               const float* __restrict__ s0, T* __restrict__ y,
               float* __restrict__ sf, int S, int H) {
  static_assert(P % TG == 0 && N % TG == 0, "P and N must be multiples of 16");
  using Lay = Layout<P, N>;
  extern __shared__ float smem[];
  float* Xs = smem + Lay::X;
  float* Bs = smem + Lay::B;
  float* Cs = smem + Lay::C;
  float* Hs = smem + Lay::H;
  float* Gs = smem + Lay::G;
  float* cum = smem + Lay::CUM;
  float* dts = smem + Lay::DT;
  float* ws = smem + Lay::W;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / TG, tx = tid % TG;
  const float a_h = A[h], d_h = D[h];
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t row_x = static_cast<size_t>(H) * P;     // between positions
  const size_t row_n = static_cast<size_t>(H) * N;
  const T* xb = x + static_cast<size_t>(b) * S * row_x + static_cast<size_t>(h) * P;
  const T* bb = Bm + static_cast<size_t>(b) * S * row_n + static_cast<size_t>(h) * N;
  const T* cb = Cm + static_cast<size_t>(b) * S * row_n + static_cast<size_t>(h) * N;
  T* yb = y + static_cast<size_t>(b) * S * row_x + static_cast<size_t>(h) * P;
  const float* dtb = dt + static_cast<size_t>(b) * S * H + h;

  for (int e = tid; e < P * N; e += THREADS) {
    const int p = e / N, n = e % N;
    Hs[p * Lay::LDH + n] = s0 ? s0[bh * P * N + e] : 0.f;
  }

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int qn = min(Q, S - c0);       // rows of this chunk
    __syncthreads();                     // the previous chunk is consumed
    for (int e = tid; e < Q * P; e += THREADS) {
      const int r = e / P, p = e % P;
      Xs[r * Lay::LDX + p] = r < qn ? to_f(xb[(c0 + r) * row_x + p]) : 0.f;
    }
    for (int e = tid; e < Q * N; e += THREADS) {
      const int r = e / N, n = e % N;
      const bool in = r < qn;
      Bs[r * Lay::LDB + n] = in ? to_f(bb[(c0 + r) * row_n + n]) : 0.f;
      Cs[r * Lay::LDC + n] = in ? to_f(cb[(c0 + r) * row_n + n]) : 0.f;
    }
    if (tid < Q) dts[tid] = tid < qn ? dtb[static_cast<size_t>(c0 + tid) * H] : 0.f;
    __syncthreads();

    if (tid < 32) {                      // cum: inclusive scan of dt * A
      const float a0 = dts[2 * tid] * a_h, a1 = dts[2 * tid + 1] * a_h;
      float incl = a0 + a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += v;
      }
      const float c_lo = incl - a1, c_hi = incl;
      const float c_end = __shfl_sync(0xffffffffu, incl, 31);
      cum[2 * tid] = c_lo;
      cum[2 * tid + 1] = c_hi;
      ws[2 * tid] = expf(c_end - c_lo) * dts[2 * tid];
      ws[2 * tid + 1] = expf(c_end - c_hi) * dts[2 * tid + 1];
    }
    __syncthreads();

    // G[t][s] = (C_t . B_s) e^{cum_t - cum_s} dt_s for s <= t, else 0
    if (ty < qn) {
      float g[Q / TG][Q / TG] = {};
      for (int n = 0; n < N; ++n) {
        float cv[Q / TG], bv[Q / TG];
#pragma unroll
        for (int i = 0; i < Q / TG; ++i) cv[i] = Cs[(ty + TG * i) * Lay::LDC + n];
#pragma unroll
        for (int j = 0; j < Q / TG; ++j) bv[j] = Bs[(tx + TG * j) * Lay::LDB + n];
#pragma unroll
        for (int i = 0; i < Q / TG; ++i)
#pragma unroll
          for (int j = 0; j < Q / TG; ++j) g[i][j] += cv[i] * bv[j];
      }
#pragma unroll
      for (int i = 0; i < Q / TG; ++i) {
        const int t = ty + TG * i;
#pragma unroll
        for (int j = 0; j < Q / TG; ++j) {
          const int s = tx + TG * j;
          Gs[t * Lay::LDG + s] = s <= t ? g[i][j] * expf(cum[t] - cum[s]) * dts[s] : 0.f;
        }
      }
    }
    __syncthreads();

    // y[t][p] = sum_s G[t][s] x[s][p] + e^{cum_t} (C_t . h0[p]) + D x[t][p]
    if (ty < qn) {
      float acc[Q / TG][P / TG] = {}, inter[Q / TG][P / TG] = {};
      for (int s = 0; s < qn; ++s) {
        float gv[Q / TG], xv[P / TG];
#pragma unroll
        for (int i = 0; i < Q / TG; ++i) gv[i] = Gs[(ty + TG * i) * Lay::LDG + s];
#pragma unroll
        for (int j = 0; j < P / TG; ++j) xv[j] = Xs[s * Lay::LDX + tx + TG * j];
#pragma unroll
        for (int i = 0; i < Q / TG; ++i)
#pragma unroll
          for (int j = 0; j < P / TG; ++j) acc[i][j] += gv[i] * xv[j];
      }
      for (int n = 0; n < N; ++n) {
        float cv[Q / TG], hv[P / TG];
#pragma unroll
        for (int i = 0; i < Q / TG; ++i) cv[i] = Cs[(ty + TG * i) * Lay::LDC + n];
#pragma unroll
        for (int j = 0; j < P / TG; ++j) hv[j] = Hs[(tx + TG * j) * Lay::LDH + n];
#pragma unroll
        for (int i = 0; i < Q / TG; ++i)
#pragma unroll
          for (int j = 0; j < P / TG; ++j) inter[i][j] += cv[i] * hv[j];
      }
#pragma unroll
      for (int i = 0; i < Q / TG; ++i) {
        const int t = ty + TG * i;
        if (t >= qn) continue;
        const float et = expf(cum[t]);
#pragma unroll
        for (int j = 0; j < P / TG; ++j) {
          const int p = tx + TG * j;
          const float v = acc[i][j] + et * inter[i][j] + d_h * Xs[t * Lay::LDX + p];
          yb[(c0 + t) * row_x + p] = from_f<T>(v);
        }
      }
    }
    __syncthreads();                     // every read of h0 is done

    // h[p][n] = e^{cum_end} h[p][n] + sum_s w_s x[s][p] B[s][n]
    {
      float acc[P / TG][N / TG] = {};
      for (int s = 0; s < qn; ++s) {
        const float w = ws[s];
        float xv[P / TG], bv[N / TG];
#pragma unroll
        for (int i = 0; i < P / TG; ++i) xv[i] = w * Xs[s * Lay::LDX + ty + TG * i];
#pragma unroll
        for (int j = 0; j < N / TG; ++j) bv[j] = Bs[s * Lay::LDB + tx + TG * j];
#pragma unroll
        for (int i = 0; i < P / TG; ++i)
#pragma unroll
          for (int j = 0; j < N / TG; ++j) acc[i][j] += xv[i] * bv[j];
      }
      const float decay = expf(cum[Q - 1]);
#pragma unroll
      for (int i = 0; i < P / TG; ++i)
#pragma unroll
        for (int j = 0; j < N / TG; ++j) {
          float* hp = Hs + (ty + TG * i) * Lay::LDH + tx + TG * j;
          *hp = decay * *hp + acc[i][j];
        }
    }
  }
  __syncthreads();
  for (int e = tid; e < P * N; e += THREADS) {
    const int p = e / N, n = e % N;
    sf[bh * P * N + e] = Hs[p * Lay::LDH + n];
  }
}

template <typename T, int P, int N>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* D, const float* s0, void* y, float* sf,
           int B, int S, int H, cudaStream_t stream) {
  auto kernel = ssd_fwd_kernel<T, P, N>;
  constexpr size_t smem = Layout<P, N>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(H, B), THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), D, s0, static_cast<T*>(y), sf, S, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
int launch_n(const void* x, const float* dt, const float* A, const void* Bm,
             const void* Cm, const float* D, const float* s0, void* y, float* sf,
             int B, int S, int H, int N, cudaStream_t s) {
  switch (N) {
    case 16: return launch<T, P, 16>(x, dt, A, Bm, Cm, D, s0, y, sf, B, S, H, s);
    case 32: return launch<T, P, 32>(x, dt, A, Bm, Cm, D, s0, y, sf, B, S, H, s);
    case 64: return launch<T, P, 64>(x, dt, A, Bm, Cm, D, s0, y, sf, B, S, H, s);
    case 128: return launch<T, P, 128>(x, dt, A, Bm, Cm, D, s0, y, sf, B, S, H, s);
  }
  return RT_UNSUPPORTED;
}

template <typename T>
int launch_pn(const void* x, const float* dt, const float* A, const void* Bm,
              const void* Cm, const float* D, const float* s0, void* y, float* sf,
              int B, int S, int H, int P, int N, cudaStream_t s) {
  switch (P) {
    case 16: return launch_n<T, 16>(x, dt, A, Bm, Cm, D, s0, y, sf, B, S, H, N, s);
    case 32: return launch_n<T, 32>(x, dt, A, Bm, Cm, D, s0, y, sf, B, S, H, N, s);
    case 64: return launch_n<T, 64>(x, dt, A, Bm, Cm, D, s0, y, sf, B, S, H, N, s);
    case 128: return launch_n<T, 128>(x, dt, A, Bm, Cm, D, s0, y, sf, B, S, H, N, s);
  }
  return RT_UNSUPPORTED;
}

}  // namespace

// x, y: (B, S, H, P) and Bm, Cm: (B, S, H, N), contiguous, dtype `dtype`
// (fp32 or bf16); dt: (B, S, H), A, D: (H,), s0 (may be null: zeros) and
// sf: (B, H, P, N), all fp32 and contiguous.  Returns a cudaError_t, or
// RT_UNSUPPORTED for what the kernel does not take (P or N outside
// {16, 32, 64, 128}, another dtype, a grid dimension over its limit).
extern "C" int rt_ssd(const void* x, const void* dt, const void* A, const void* Bm,
                      const void* Cm, const void* D, const void* s0, void* y, void* sf,
                      int B, int S, int H, int P, int N, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535) return RT_UNSUPPORTED;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  const float* s0f = static_cast<const float*>(s0);
  float* sff = static_cast<float*>(sf);
  switch (dtype) {
    case RT_F32: return launch_pn<float>(x, dtf, Af, Bm, Cm, Df, s0f, y, sff, B, S, H, P, N, s);
    case RT_BF16: return launch_pn<__nv_bfloat16>(x, dtf, Af, Bm, Cm, Df, s0f, y, sff, B, S, H, P, N, s);
  }
  return RT_UNSUPPORTED;
}
